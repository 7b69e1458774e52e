"""Phase 18 of ``chip_smoke.py`` alone on the card, then the card tests of the
examples and the full Figure 2 sweep, in one process tree:

    python3 scripts/experiments_chip.py [--out build/reports/full_sweep.txt]

It builds the kernels (phase 1), runs phase 9 (whose f* phase 18 checks)
and phase 18 with TF32 off, then ``pytest -m cuda
tests/test_torch_cuda_experiments.py`` and ``python -m repro_torch.experiments
--full``, whose output it writes to ``--out`` beside the card's name and
power limit. Exits non-zero if any of the three fails. Needs one CUDA
device; about 6 minutes on an NVIDIA H100.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "reports" / "full_sweep.txt",
                    help="where the full sweep's output goes")
    args = ap.parse_args()
    import numpy as np
    import torch

    import repro_torch.examples.consensus_vs_multitask  # noqa: F401
    import repro_torch.examples.learn_the_graph  # noqa: F401
    import repro_torch.examples.quickstart  # noqa: F401
    import repro_torch.examples.serve_batched  # noqa: F401
    import repro_torch.examples.train_multitask_lm  # noqa: F401
    import repro_torch.experiments.ablation_mtl_lm  # noqa: F401
    import repro_torch.experiments.delay_bench  # noqa: F401
    import repro_torch.experiments.fig2_erm  # noqa: F401
    import repro_torch.experiments.fig3_stochastic  # noqa: F401
    import repro_torch.experiments.run  # noqa: F401
    import repro_torch.experiments.table1_complexity  # noqa: F401
    from repro_torch import convert, core, data, examples, experiments
    from repro_torch.configs import get
    from repro_torch.kernels import runtime
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.graph_mix import ops as mix_ops
    from repro_torch.kernels.prefill_attention import ops as pre_ops
    from repro_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    smoke.log(smi)
    ops = {"decode_attention": dec_ops.decode_attention,
           "prefill_attention": pre_ops.prefill_attention,
           "paged_decode_attention": dec_ops.paged_decode_attention,
           "paged_prefill_attention": pre_ops.paged_prefill_attention,
           "graph_mix": mix_ops.graph_mix}
    t0 = time.perf_counter()
    smoke.phase_build(runtime)
    paper = smoke.phase_paper(torch, np, core, data)
    rc = 0
    try:
        exps = smoke.phase_experiments(experiments, examples, convert, TransformerLM, get, ops,
                                       smi, paper["f_star"]["card"])
        smoke.log(json.dumps({"experiments": exps}, default=str))
    except AssertionError as e:
        smoke.log(f"phase 18 failed: {e}")
        rc = 1
    smoke.log(f"phases 1, 9 and 18 in {time.perf_counter() - t0:.1f} s")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t1 = time.perf_counter()
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "cuda",
                            "-p", "no:cacheprovider", "tests/test_torch_cuda_experiments.py"],
                           cwd=ROOT, env=env, capture_output=True, text=True)
    smoke.log(tests.stdout[-1500:], tests.stderr[-1500:])
    smoke.log(f"cuda tests rc {tests.returncode} in {time.perf_counter() - t1:.1f} s")
    out = args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    t1 = time.perf_counter()
    with open(out, "w") as f:
        f.write(smi + "\n")
        f.flush()
        sweep = subprocess.run([sys.executable, "-m", "repro_torch.experiments", "--full"],
                               cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT, text=True)
    smoke.log(f"full sweep rc {sweep.returncode} in {time.perf_counter() - t1:.1f} s")
    smoke.log(out.read_text()[-6000:])
    return rc or tests.returncode or sweep.returncode


if __name__ == "__main__":
    sys.exit(main())
