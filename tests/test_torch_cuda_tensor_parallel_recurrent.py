"""The recurrent families' tensor-parallel steps on the card, and a mixed
block stack's (tests/test_torch_tensor_parallel_recurrent.py and
tests/test_torch_tensor_parallel_mixed.py on the CPU): W =
torch.cuda.device_count() ranks over NCCL, one per card; the smoke configs
of Zamba2's Mamba2 hybrid and of xLSTM, and a mamba / attention /
shared-block stack, each trained three AdamW steps through
``sharding.sharded_step`` on a (W, 1) and a (1, W) mesh with the residual
stream and the logits constrained to ("data", None, "model"), against the
plain step on the card: losses within 1e-5 relative, parameters
elementwise at W = 1 and by leaf norm over more ranks
(``test_torch_cuda_distributed.train_on_the_card``). Needs a CUDA device
and skips without one; imports no JAX: ``PYTHONPATH=src python -m pytest
-q -m cuda tests/test_torch_cuda_tensor_parallel_recurrent.py``."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_cuda_distributed import train_on_the_card  # noqa: E402
from torch_dist import run_ranks  # noqa: E402

pytestmark = pytest.mark.cuda
CASES = {
    "zamba2": ("zamba2_7b", None),
    "xlstm": ("xlstm_350m", None),
    "mamba-attn-shared_attn": ("zamba2_7b", {"pattern": ("mamba", "attn", "shared_attn"),
                                             "num_layers": 3}),
}


@pytest.fixture
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


@pytest.mark.parametrize("orientation", ["data", "model"])
@pytest.mark.parametrize("case", list(CASES))
def test_recurrent_tensor_parallel_step_matches_the_plain_step(world, tmp_path, case,
                                                               orientation):
    arch, overrides = CASES[case]
    for r in run_ranks(train_on_the_card, world, tmp_path, arch, ("data", None, "model"),
                       orientation, overrides, device="cuda", timeout=300):
        assert all(r.values()), r
