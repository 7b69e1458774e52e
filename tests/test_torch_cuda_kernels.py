"""The paged flash-decode and flash-prefill CUDA kernels of the port against
their plain versions, on the card: block sizes 8 and 16, shuffled physical
block ids, a poisoned null block and poisoned unmapped pages, ragged
positions (past the table, as a dead slot's stale position can be, so a
row may see no key and average every logical row, null block included),
G 1 and 5, a sliding window, float32 (atol 2e-5) and bfloat16 (atol 2e-2).
The graph-mix kernel against its plain version: ragged m and d (vector and
scalar loads), NaN beyond the operands' ends, float32 (atol 1e-4, rtol
1e-5) and bfloat16 (atol = rtol = 1e-2 against the f32 plain result
rounded to bf16), one launch per dtype group of a tree, and its refusals.
The dense and paged flash-decode kernels against their plain versions at
forced split counts (1, 3, one per key tile and the wrapper's own), at the
decode shapes above, multitask-LM's (G 4, hd 64), Mixtral-8x22B's (G 6,
window 4096 over S 8192), Zamba2-7B's (hd 112, the first head dim that is
no power of two), Pixtral-12B's (hd 160, padded to 256 in the decode
block: two groups of 4 dims a lane) and S 2048 (64 splits, merged in two
groups), a
stale position, block sizes 8 and 16 with out-of-pool ids. The dense and
paged flash-prefill kernels against their plain versions at forced split
counts (1, 3 and the wrapper's own), at C * G of 3, 32, 128, 160, 192 and
200 (a ragged m16 tile, rows over several m16 tiles, several row tiles) and
at hd 112 and 160 (Pixtral: 128 rows in four row tiles in f32, two in
bf16, the combine kernel's 6-row blocks crossing them), both decode and
prefill launching at 160 and refusing hd 96, which no kernel instantiates,
with a window, a slot at pos 0 beside one at 992, a row that sees no key,
and, paged, block sizes 8 and 16 with a poisoned null block and
out-of-pool ids.

Every test here needs a CUDA device and skips without one; the file imports
no JAX, so it runs on a machine that has only the port's dependencies:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.graph_mix import ops as mix_ops  # noqa: E402
from repro_torch.kernels.graph_mix.ref import graph_mix_reference  # noqa: E402
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


# (B, S logical rows, KVH, G, hd, C, pos, window): C * G = 32 (OLMo-1B), 128
# (multitask-LM: eight m16 tiles in one block), 160 (Qwen2.5-14B: two row
# tiles of 80 rows in bf16, four of 48 in f32), 3 (a ragged m16 tile), 200
# (two row tiles at hd 128 in bf16, five in f32), 192 (Mixtral-8x22B: G 6,
# the 4096 window over 8192 rows); pos 0 beside 992; the (110, window 3)
# slot's last row sees no key
_PREFILL_CASES = [
    (4, 1024, 16, 1, 128, 32, [0, 200, 640, 992], None),
    (4, 1024, 4, 4, 64, 32, [0, 200, 640, 992], None),
    (4, 1024, 8, 5, 128, 32, [0, 992, 431, 100], 256),
    (2, 304, 2, 3, 64, 1, [10, 297], 64),
    (1, 112, 1, 1, 64, 5, [110], 3),
    (2, 208, 4, 2, 32, 8, [0, 190], None),
    (2, 96, 2, 5, 128, 40, [10, 50], None),
    (4, 8192, 8, 6, 128, 32, [0, 4480, 8160, 4000], 4096),
    # Zamba2-7B: hd 112 (MHA, G 1), its serving shape and a ragged S with the
    # chunk's last row at the cache's last row
    (4, 2048, 32, 1, 112, 32, [0, 700, 1500, 2016], None),
    (3, 304, 2, 1, 112, 32, [0, 131, 272], None),
    # Pixtral-12B: hd 160 (G 4), its serving shape (128 slab rows) and a
    # ragged S with a window
    (4, 2048, 8, 4, 160, 32, [0, 700, 1500, 2016], None),
    (3, 304, 2, 4, 160, 8, [0, 131, 290], 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nsplit", [1, 3, None])
@pytest.mark.parametrize("block", [None, 8, 16])
def test_prefill_kernels_match_plain_versions_at_forced_splits(dtype, nsplit, block):
    """Through the private launch helper at a forced split count (None: the
    wrapper's own choice): splits with no visible key, splits whose keys are
    all masked for some rows, and rows that see no key at all must merge to
    the plain version's answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    for b, s, kvh, g, hd, c, pos, window in _PREFILL_CASES:
        if block is None:
            q = torch.randn((b, c, kvh * g, hd), generator=gen, device=dev).to(dt)
            k = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
            v = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
            table = None
        else:
            q, k, v, table = _paged_case(gen, dev, dt, b, s // block, block, kvh, g, hd, c)
            table[-1, 0] = k.shape[0] + 5  # out of the pool: clamped to the last block
            if b > 1:
                table[0, 0] = -3  # clamped to the null block
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        n = nsplit or pre_ops.num_splits(q, kvh, s)
        got = pre_ops._launch(q, k, v, table, runtime.pos_vector(pos_t, b, dev),
                              runtime.window_arg(window), n)
        torch.cuda.synchronize()
        if table is None:
            want = pre_ops.prefill_attention(q.cpu(), k.cpu(), v.cpu(), pos_t.cpu(),
                                             window=window)
        else:
            want = pre_ops.paged_prefill_attention(q.cpu(), k.cpu(), v.cpu(), table.cpu(),
                                                   pos_t.cpu(), window=window)
        err = (got.float().cpu() - want.float()).abs().max().item()
        assert torch.isfinite(got.float()).all()
        assert err <= TOL[dtype], (b, s, kvh, g, hd, c, pos, window, block, n, err)


# (B, S logical rows, KVH, G, hd, pos, window): the decode cases of
# test_paged_kernels_match_plain_versions (OLMo-1B; Qwen2.5-14B with a
# window; a stale pos 396 whose slot sees no key), multitask-LM's decode
# shape (G 4, hd 64), S 2048, whose 64 tiles the merge takes in two
# groups of 32 splits, and Mixtral-8x22B's (G 6, the 4096 window masking
# positions past 4096)
_DECODE_CASES = [
    (4, 1024, 16, 1, 128, [63, 300, 700, 1023], None),
    (4, 1024, 8, 5, 128, [0, 513, 64, 1000], 256),
    (3, 96, 2, 4, 64, [96 + 300, 40, 95], 16),
    (4, 1024, 4, 4, 64, [63, 300, 700, 1023], None),
    (2, 2048, 2, 3, 64, [2047, 1500], None),  # "largest": 64 splits, two groups of 32 to merge
    (4, 8192, 8, 6, 128, [4500, 8191, 100, 4095], 4096),
    # Zamba2-7B: hd 112, at its serving shape and at a ragged S with pos at 0
    # and at the last row
    (4, 2048, 32, 1, 112, [63, 700, 1500, 2047], None),
    (3, 304, 2, 1, 112, [0, 150, 303], None),
    # Pixtral-12B: hd 160 (G 4), at its serving shape and at a ragged S with
    # a window
    (4, 2048, 8, 4, 160, [63, 700, 1500, 2047], None),
    (3, 304, 2, 4, 160, [0, 150, 303], 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nsplit", [1, 3, "largest", None])
@pytest.mark.parametrize("block", [None, 8, 16])
def test_decode_kernels_match_plain_versions_at_forced_splits(dtype, nsplit, block):
    """Through the private launch helper at a forced split count
    ("largest": one split per key tile; None: the wrapper's own choice):
    empty splits, splits whose keys are all masked, and a slot that sees no
    key at all must merge to the plain version's answer, dense and paged
    (poisoned null block, out-of-pool ids)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    for b, s, kvh, g, hd, pos, window in _DECODE_CASES:
        if block is None:
            q = torch.randn((b, 1, kvh * g, hd), generator=gen, device=dev).to(dt)
            k = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
            v = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
            table = None
        else:
            q, k, v, table = _paged_case(gen, dev, dt, b, s // block, block, kvh, g, hd, 1)
            table[-1, 0] = k.shape[0] + 5  # out of the pool: clamped to the last block
            table[0, 0] = -3  # clamped to the null block
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        if nsplit == "largest":
            n = -(-s // dec_ops.geometry(dt, hd, block is not None)[0])
        else:
            n = nsplit or dec_ops.num_splits(q, kvh, s, paged=block is not None)
        got = dec_ops._launch(q, k, v, table, runtime.pos_vector(pos_t, b, dev),
                              runtime.window_arg(window), n)
        torch.cuda.synchronize()
        if table is None:
            want = dec_ops.decode_attention(q.cpu(), k.cpu(), v.cpu(), pos_t.cpu(),
                                            window=window)
        else:
            want = dec_ops.paged_decode_attention(q.cpu(), k.cpu(), v.cpu(), table.cpu(),
                                                  pos_t.cpu(), window=window)
        err = (got.float().cpu() - want.float()).abs().max().item()
        assert torch.isfinite(got.float()).all()
        assert err <= TOL[dtype], (b, s, kvh, g, hd, pos, window, block, n, err)


@pytest.mark.cuda
def test_attention_kernels_refuse_head_dims_they_do_not_instantiate():
    """hd 112 and 160 (Pixtral) launch; hd 96 is in no instantiation and
    raises before any launch, dense and paged, decode and prefill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    pos = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    table = torch.ones((2, 2), dtype=torch.int32, device=dev)
    ops = (dec_ops.decode_attention, dec_ops.paged_decode_attention,
           pre_ops.prefill_attention, pre_ops.paged_prefill_attention)
    for hd, ok in ((112, True), (160, True), (96, False)):
        before = [op.launches for op in ops]
        for c in (1, 4):
            q = torch.zeros((2, c, 4, hd), device=dev)
            cache = torch.zeros((2, 16, 4, hd), device=dev)
            pool = torch.zeros((5, 8, 4, hd), device=dev)
            dense = dec_ops.decode_attention if c == 1 else pre_ops.prefill_attention
            paged = (dec_ops.paged_decode_attention if c == 1
                     else pre_ops.paged_prefill_attention)
            for call in (lambda: dense(q, cache, cache, pos),
                         lambda: paged(q, pool, pool, table, pos)):
                if ok:
                    call()
                else:
                    with pytest.raises(ValueError, match="head_dim 96"):
                        call()
        torch.cuda.synchronize()
        want = [n + 1 if ok else n for n in before]
        assert [op.launches for op in ops] == want


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_mix_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, d in [(1, 1000), (12, 1000), (12, 4099), (100, 1000), (100, 4099),
                 (256, 4096), (256, 131), (9, 3)]:
        # operands cut from larger NaN-filled buffers: a kernel that reads
        # past either end turns live outputs into NaN
        mu_buf = torch.full((m * m + 64,), float("nan"), device=dev)
        th_buf = torch.full((m * d + 64,), float("nan"), device=dev, dtype=dt)
        mu = mu_buf[: m * m].view(m, m)
        theta = th_buf[: m * d].view(m, d)
        mu.copy_(torch.rand((m, m), generator=gen, device=dev) / m)
        theta.copy_(torch.randn((m, d), generator=gen, device=dev).to(dt))
        before = mix_ops.graph_mix.launches
        got = mix_ops.graph_mix(mu, theta)
        torch.cuda.synchronize()
        assert mix_ops.graph_mix.launches == before + 1
        assert got.dtype == dt and got.shape == (m, d)
        want = graph_mix_reference(mu.cpu(), theta.cpu().float())
        tol = (1e-4, 1e-5) if dtype == "float32" else (1e-2, 1e-2)
        torch.testing.assert_close(got.cpu().float(), want.to(dt).float(),
                                   atol=tol[0], rtol=tol[1])


@pytest.mark.cuda
def test_graph_mix_tree_launches_once_per_dtype_and_kernel_refusals():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    m = 16
    tree = {"a": torch.randn(m, 3, 5, device=dev), "b": torch.randn(m, 7, device=dev),
            "c": torch.randn(m, 4, device=dev).bfloat16()}
    mu = torch.rand(m, m, device=dev)
    before = mix_ops.graph_mix.launches
    got = mix_ops.graph_mix_tree(mu, tree)
    torch.cuda.synchronize()
    assert mix_ops.graph_mix.launches == before + 2
    for k, t in tree.items():
        want = graph_mix_reference(mu.cpu(), t.cpu().reshape(m, -1)).reshape(t.shape)
        torch.testing.assert_close(got[k].cpu().float(), want.float(), atol=1e-2, rtol=1e-2)
    before = mix_ops.graph_mix.launches
    with pytest.raises(TypeError, match="dtype"):
        mix_ops.graph_mix(mu, torch.zeros(m, 8, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        mix_ops.graph_mix(mu, torch.zeros(8, m, device=dev).t())
    with pytest.raises(ValueError, match="CUDA device"):
        mix_ops.graph_mix(mu.cpu(), torch.zeros(m, 8, device=dev))
    assert mix_ops.graph_mix.launches == before
