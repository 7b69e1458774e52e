"""Parity of the port's attention (repro_torch.kernels.*, repro_torch.models
.attention) with the JAX package's: the plain decode / prefill versions
against the Pallas kernels (interpret mode) and their jnp references,
mirroring the sweeps of tests/test_kernels.py — GQA shapes, cache lengths
not divisible by the block, sliding windows, ragged positions, chunk
widths 1/3/8 — on the CPU in float32, atol 3e-5.

The hand-written CUDA kernels run only on a GPU: the ``cuda``-marked test
at the end holds them against the plain versions there and skips on a
machine without one."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_reference  # noqa: E402
from repro.kernels.prefill_attention.kernel import prefill_attention_pallas  # noqa: E402
from repro.kernels.prefill_attention.ref import prefill_attention_reference  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_reference as t_decode_ref,
)
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402
from repro_torch.kernels.prefill_attention.ref import (  # noqa: E402
    prefill_attention_reference as t_prefill_ref,
)
from repro_torch.models import attention as tattn  # noqa: E402

ATOL = 3e-5


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(), atol=atol, rtol=0)


# ------------------------------------------------------------- decode
@pytest.mark.parametrize("kvh,g", [(1, 4), (2, 8), (8, 1), (4, 4)])
@pytest.mark.parametrize("s", [256, 300])
def test_decode_plain_matches_jax_reference(kvh, g, s):
    rng = np.random.default_rng(kvh * 10 + g)
    b, hd = 3, 64
    q, k, v = _arrays(rng, (b, kvh, g, hd), (b, s, kvh, hd), (b, s, kvh, hd))
    pos = np.array([s - 5, 0, s // 2], np.int32)  # ragged per-slot positions
    want = decode_attention_reference(*map(jnp.asarray, (q, k, v, pos)))
    got = t_decode_ref(*map(torch.from_numpy, (q, k, v, pos)))
    _close(want, got)


@pytest.mark.parametrize("kvh,g,s,window", [(2, 4, 300, None), (8, 1, 256, 100), (1, 5, 300, 64)])
def test_decode_plain_matches_pallas_interpret(kvh, g, s, window):
    rng = np.random.default_rng(5)
    b, hd = 2, 64
    q, k, v = _arrays(rng, (b, kvh, g, hd), (b, s, kvh, hd), (b, s, kvh, hd))
    pos = np.array([s - 1, 37], np.int32)
    want = decode_attention_pallas(
        *map(jnp.asarray, (q, k, v, pos)), block_s=128, window=window, interpret=True
    )
    got = t_decode_ref(*map(torch.from_numpy, (q, k, v, pos)), window=window)
    _close(want, got)


# ------------------------------------------------------------ prefill
def _prefill_case(seed, b, s, kvh, g, cq, hd=64):
    rng = np.random.default_rng(seed)
    q, k, v = _arrays(rng, (b, kvh, cq, g, hd), (b, s, kvh, hd), (b, s, kvh, hd))
    pos = rng.integers(0, s - cq + 1, (b,)).astype(np.int32)  # ragged offsets
    return q, k, v, pos


@pytest.mark.parametrize("cq", [1, 3, 8])
@pytest.mark.parametrize("kvh,g", [(1, 4), (2, 2), (4, 1)])
@pytest.mark.parametrize("s", [256, 300])
def test_prefill_plain_matches_jax_reference(cq, kvh, g, s):
    q, k, v, pos = _prefill_case(cq * 10 + kvh, 2, s, kvh, g, cq)
    want = prefill_attention_reference(*map(jnp.asarray, (q, k, v, pos)))
    got = t_prefill_ref(*map(torch.from_numpy, (q, k, v, pos)))
    _close(want, got)


@pytest.mark.parametrize("cq,kvh,g,window", [(8, 2, 2, None), (3, 1, 5, None), (5, 2, 2, 64)])
def test_prefill_plain_matches_pallas_interpret(cq, kvh, g, window):
    q, k, v, pos = _prefill_case(7, 2, 300, kvh, g, cq)
    want = prefill_attention_pallas(
        *map(jnp.asarray, (q, k, v, pos)), block_s=128, window=window, interpret=True
    )
    got = t_prefill_ref(*map(torch.from_numpy, (q, k, v, pos)), window=window)
    _close(want, got)


# --------------------------------------------------- model-layout ops
@pytest.mark.parametrize("c,window", [(1, None), (1, 40), (6, None), (6, 40)])
def test_cached_attend_backends_match_jax(c, window):
    """cached_attend on CPU tensors: the "kernel" backend (ops -> plain
    version) and the "plain" backend (masked softmax) both equal JAX's
    jnp decode_attend on the model layout (B, C, H, hd)."""
    rng = np.random.default_rng(11)
    b, s, kvh, g, hd = 3, 96, 2, 3, 32
    q, k, v = _arrays(rng, (b, c, kvh * g, hd), (b, s, kvh, hd), (b, s, kvh, hd))
    pos = np.array([0, 50, s - c], np.int32)
    want = jattn.decode_attend(*map(jnp.asarray, (q, k, v, pos)), sliding_window=window)
    t = list(map(torch.from_numpy, (q, k, v, pos)))
    launches = (dec_ops.decode_attention.launches, pre_ops.prefill_attention.launches)
    for backend in ("kernel", "plain"):
        got = tattn.cached_attend(*t, sliding_window=window, backend=backend)
        _close(want, got)
    # CPU tensors run the plain version: no kernel launch is counted
    assert (dec_ops.decode_attention.launches, pre_ops.prefill_attention.launches) == launches


def test_gqa_project_with_bias_matches_jax():
    rng = np.random.default_rng(12)
    d, h, kvh, hd = 48, 4, 2, 16
    names = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd),
             "bq": (h * hd,), "bk": (kvh * hd,), "bv": (kvh * hd,)}
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2 for n, s in names.items()}
    (x,) = _arrays(rng, (2, 5, d))
    want = jattn.gqa_project({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), h, kvh, hd)
    got = tattn.gqa_project({n: torch.from_numpy(a) for n, a in p.items()},
                            torch.from_numpy(x), h, kvh, hd)
    for w, t in zip(want, got):
        _close(w, t, atol=1e-5)


def test_kernel_launcher_input_checks():
    """What the CUDA launchers do not take raises before any launch."""
    x = torch.zeros(1, 1, 2, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        runtime.check_kernel_inputs("op", {"q": x})
    with pytest.raises(ValueError, match="window"):
        runtime.window_arg(0)
    assert runtime.window_arg(None) == 0 and runtime.window_arg(5) == 5
    with pytest.raises(ValueError, match="KVH"):
        dec_ops.decode_attention(torch.zeros(1, 2, 4, 64), x, x, 0)  # C != 1
    with pytest.raises(ValueError, match="KVH"):
        pre_ops.prefill_attention(torch.zeros(1, 2, 3, 64), x, x, 0)  # 2 does not divide 3


def test_scale_matches_jax_float32():
    for hd in (32, 64, 128):
        want = 1.0 / jnp.sqrt(jnp.asarray(hd, jnp.float32))
        assert np.float32(runtime.scale_for(hd)) == np.asarray(want)


# --------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_cuda_kernels_match_plain_versions(dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, s, kvh, g, hd, c, pos, window in [
        (4, 1024, 16, 1, 128, 1, [63, 300, 700, 1023], None),
        (4, 1024, 8, 5, 128, 32, [0, 992, 500, 17], None),
        (2, 300, 2, 4, 64, 3, [10, 297], 64),
        (2, 200, 4, 2, 32, 1, [150, 199], 50),
    ]:
        q = torch.randn((b, c, kvh * g, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        op = dec_ops.decode_attention if c == 1 else pre_ops.prefill_attention
        before = op.launches
        got = op(q, k, v, pos_t, window=window)
        torch.cuda.synchronize()
        assert op.launches == before + 1
        want = op(q.cpu(), k.cpu(), v.cpu(), pos_t.cpu(), window=window)
        err = (got.float().cpu() - want.float()).abs().max().item()
        assert err <= atol, (b, s, kvh, g, hd, c, err)
