"""The check that decides ``correct`` fails when the timed path is broken
underneath (the harness's look for a chip skipped: ``--rehearse``), and
when the lower-precision control stands in for the program."""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SEED = 2**31 + 23


def run_cell(capsys, monkeypatch, workload, *extra):
    from h100bench import run
    from h100bench.lib import common

    # other test files of this worker may have loaded the JAX package; the
    # guard holds the run to what it loads itself
    loaded = set(common.forbidden_modules())
    guard = common.forbidden_modules
    monkeypatch.setattr(common, "forbidden_modules",
                        lambda: [m for m in guard() if m not in loaded])
    monkeypatch.chdir(ROOT)
    rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", "6",
                   "--trace", "0", "--rehearse", *extra])
    captured = capsys.readouterr()
    assert rc == 0, captured.err[-2000:]
    return json.loads(captured.out.strip().splitlines()[-1])


def test_a_token_altered_where_it_is_produced_fails(capsys, monkeypatch):
    from repro_torch.serve import batching

    emit = batching.ContinuousBatcher._emit

    def altered(self, req, row=None, greedy=None):
        if greedy is not None and len(req.out) == 1:
            greedy = (int(greedy) + 1) % self.model.cfg.vocab_size
        return emit(self, req, row, greedy)

    monkeypatch.setattr(batching.ContinuousBatcher, "_emit", altered)
    for cell in ("mtlm.tenants-online", "olmo1b.longgen"):
        res = run_cell(capsys, monkeypatch, cell)
        assert res["correct"] is False, res["checks"]


def test_a_store_update_that_leaves_the_adapters_unchanged_fails(capsys, monkeypatch):
    from repro_torch.serve import adapters

    def stuck(self):
        self.updates += 1

    monkeypatch.setattr(adapters.TaskAdapterStore, "update", stuck)
    res = run_cell(capsys, monkeypatch, "mtlm.tenants-online")
    assert res["correct"] is False, res["checks"]


def test_a_store_serving_its_iterate_unmixed_fails(capsys, monkeypatch):
    """``refresh`` publishes the raw iterate without the mix by ``mu^T``."""
    from repro_torch.serve import adapters

    def unmixed(self):
        m = self.num_tasks
        for dst, t in zip(_leaves(self.serving), _leaves(self.raw)):
            dst[:m].copy_(t)

    monkeypatch.setattr(adapters.TaskAdapterStore, "refresh", unmixed)
    res = run_cell(capsys, monkeypatch, "mtlm.tenants-online")
    assert res["correct"] is False
    assert res["checks"]["store_rel"]["value"] > res["checks"]["store_rel"]["limit"]


def test_a_store_mixing_one_iterate_too_stale_fails(capsys, monkeypatch):
    """The store's ring is one iterate longer than the cell states: each
    update mixes the iterate ``max_delay + 1`` updates back."""
    from repro_torch.serve import adapters

    init = adapters.TaskAdapterStore.__init__

    def stale(self, *a, max_delay=0, **k):
        init(self, *a, max_delay=max_delay + 1, **k)

    monkeypatch.setattr(adapters.TaskAdapterStore, "__init__", stale)
    res = run_cell(capsys, monkeypatch, "mtlm.tenants-online")
    assert res["correct"] is False
    assert res["checks"]["store_rel"]["value"] > res["checks"]["store_rel"]["limit"]


def test_the_store_faults_the_reference_plays_read_above_the_limit(capsys, monkeypatch):
    res = run_cell(capsys, monkeypatch, "mtlm.tenants-online", "--control")
    assert res["correct"] is True
    chk = res["checks"]
    for k in ("fault_stale_store_rel", "fault_unmixed_store_rel"):
        assert chk[k]["value"] > chk["store_rel"]["limit"], chk


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_a_train_step_that_returns_its_state_unchanged_fails(capsys, monkeypatch):
    from repro_torch.optim import optimizers

    adamw = optimizers.adamw

    def frozen(*a, **k):
        opt = adamw(*a, **k)
        return optimizers.Optimizer(opt.init, lambda g, s, p, step: (p, s))

    monkeypatch.setattr(optimizers, "adamw", frozen)
    res = run_cell(capsys, monkeypatch, "mtlm.train")
    assert res["correct"] is False
    assert res["checks"]["change_rel"]["value"] > res["checks"]["change_rel"]["limit"]


def test_half_of_the_batch_left_out_fails(capsys, monkeypatch):
    from repro_torch.train import trainer

    to_device = trainer.batch_to_device

    def half(batch, device):
        b = len(batch["task_ids"])
        return to_device({k: v[: b // 2] for k, v in batch.items()}, device)

    monkeypatch.setattr(trainer, "batch_to_device", half)
    res = run_cell(capsys, monkeypatch, "mtlm.train")
    assert res["correct"] is False


def test_the_tf32_control_fails_the_training_check(capsys, monkeypatch):
    res = run_cell(capsys, monkeypatch, "mtlm.train", "--control")
    assert res["correct"] is True
    chk = res["checks"]
    assert any(chk[f"control_{k}"]["value"] > chk[k]["limit"]
               for k in ("loss_rel", "grad_rel", "change_rel"))
    assert any(chk[f"half_batch_{k}"]["value"] > chk[k]["limit"]
               for k in ("loss_rel", "grad_rel", "change_rel"))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from h100bench.reference.decoder import round_tf32

    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-9 - 2**-12, 1e-30])
    r = round_tf32(x)
    assert r[0] == 1.0 + 2**-10 or r[0] == 1.0  # a tie rounds to either neighbour
    assert r[1] == 1.0 + 2**-10
    assert r[2] == -3.0 - 2**-9
    bits = r.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()


def test_the_tf32_control_fails_the_serving_check():
    """At a size a CPU test holds (d 1024, vocab 8192, 1,024 compared
    positions), the control (every product's operands rounded to TF32)
    puts first tokens whose float32 logit lies below the best by more than
    every serving cell's limit."""
    import numpy as np

    from h100bench.reference import serve

    limit = max(json.loads(p.read_text())["check"]["limits"]["logit_gap"]
                for p in (ROOT / "h100bench" / "cells").glob("*.json")
                if json.loads(p.read_text())["kind"] == "serve")
    c = {"num_layers": 2, "d_model": 1024, "num_heads": 8, "num_kv_heads": 2, "head_dim": 128,
         "d_ff": 2048, "vocab_size": 8192, "norm_kind": "rmsnorm", "tie_embeddings": False,
         "num_tasks": 4, "rope_theta": 1e4}
    for seed in (1, 2, 3):
        rng = np.random.default_rng(seed)
        reqs = [{"prompt": rng.integers(0, 8192, 64).astype(np.int32),
                 "out": rng.integers(0, 8192, 256).astype(np.int32), "task": j}
                for j in range(4)]
        r = serve.gaps(c, seed, torch.device("cpu"), reqs, None, tf32_control=True)
        assert r["control_gap"] > limit, (seed, r)
