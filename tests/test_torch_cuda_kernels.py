"""The paged flash-decode and flash-prefill CUDA kernels of the port against
their plain versions, on the card: block sizes 8 and 16, shuffled physical
block ids, a poisoned null block and poisoned unmapped pages, ragged
positions (past the table, as a dead slot's stale position can be, so a
row may see no key and average every logical row, null block included),
G 1 and 5, a sliding window, float32 (atol 2e-5) and bfloat16 (atol 2e-2).

Every test here needs a CUDA device and skips without one; the file imports
no JAX, so it runs on a machine that has only the port's dependencies:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _paged_case(gen, dev, dt, b, mb, bs, kvh, g, hd, c):
    """Pools with shuffled physical ids; table entries past each slot's
    mapped pages stay 0 (the null block) and the null block holds large
    values, so a kernel that reads it unmasked fails the comparison (3.0
    keeps bf16 outputs below 4, where one bf16 step is under the bf16
    tolerance)."""
    nb = b * mb + 1
    q = torch.randn((b, c, kvh * g, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((nb, bs, kvh, hd), generator=gen, device=dev)
    v = torch.randn((nb, bs, kvh, hd), generator=gen, device=dev)
    k[0], v[0] = 3.0, -3.0
    ids = torch.randperm(nb - 1, generator=gen, device=dev)[: b * mb] + 1
    table = ids.reshape(b, mb).to(torch.int32)
    table[0, mb // 2:] = 0  # slot 0 maps only its first half: unmapped pages
    return q, k.to(dt), v.to(dt), table.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
def test_paged_kernels_match_plain_versions(dtype, bs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(bs)
    for b, tokens, kvh, g, hd, c, pos, window in [
        (4, 1024, 16, 1, 128, 1, [63, 300, 700, 1023], None),
        (4, 1024, 16, 1, 128, 32, [0, 200, 640, 992], None),
        (4, 1024, 8, 5, 128, 1, [0, 513, 64, 1000], 256),
        (4, 1024, 8, 5, 128, 32, [100, 960, 0, 431], 256),
        (2, 200, 4, 2, 32, 3, [5, 197], None),
        (3, 96, 2, 4, 64, 1, [96 + 300, 40, 95], 16),  # stale pos 396: sees no key
    ]:
        mb = tokens // bs
        q, k, v, table = _paged_case(gen, dev, dt, b, mb, bs, kvh, g, hd, c)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        op = dec_ops.paged_decode_attention if c == 1 else pre_ops.paged_prefill_attention
        before = op.launches
        got = op(q, k, v, table, pos_t, window=window)
        torch.cuda.synchronize()
        assert op.launches == before + 1
        want = op(q.cpu(), k.cpu(), v.cpu(), table.cpu(), pos_t.cpu(), window=window)
        err = (got.float().cpu() - want.float()).abs().max().item()
        assert torch.isfinite(got.float()).all()
        assert err <= TOL[dtype], (b, tokens, bs, kvh, g, hd, c, pos, window, err)


@pytest.mark.cuda
def test_paged_kernels_raise_on_bad_tables():
    """A CUDA tensor that reaches a paged op launches the kernel or raises:
    a table of the wrong dtype or on the wrong device never launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q = torch.zeros((2, 1, 4, 64), device=dev)
    pool = torch.zeros((5, 8, 4, 64), device=dev)
    good = torch.ones((2, 2), dtype=torch.int32, device=dev)
    before = dec_ops.paged_decode_attention.launches
    with pytest.raises(TypeError, match="int32"):
        dec_ops.paged_decode_attention(q, pool, pool, good.long(), 3)
    with pytest.raises(ValueError, match="lies on"):
        dec_ops.paged_decode_attention(q, pool, pool, good.cpu(), 3)
    with pytest.raises(ValueError, match="CUDA device"):
        dec_ops.paged_decode_attention(q, pool.cpu(), pool.cpu(), good, 3)
    assert dec_ops.paged_decode_attention.launches == before
