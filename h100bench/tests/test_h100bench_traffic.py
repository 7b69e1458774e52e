"""The traffic generator: deterministic per seed, the same sizes for every
seed (in another order), Poisson arrivals, clips, popularity, mean rate."""
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench.lib import traffic  # noqa: E402


def mix(name):
    return json.loads((ROOT / "h100bench" / "traffic" / f"{name}.json").read_text())


def key(s):
    return (s.uid, round(s.due, 12), s.prompt.tobytes(), s.max_new, s.task)


def test_serve_stream_is_deterministic_per_seed():
    p = mix("tenants-online")
    a = traffic.source(p, 2**31 + 5, 32000, 256, 20.0).specs
    b = traffic.source(p, 2**31 + 5, 32000, 256, 20.0).specs
    c = traffic.source(p, 6, 32000, 256, 20.0).specs
    assert [key(s) for s in a] == [key(s) for s in b]
    assert [key(s) for s in a] != [key(s) for s in c]


def test_every_seed_gets_the_same_sizes_in_the_window_in_its_own_order():
    p = mix("tenants-online")
    a = traffic.source(p, 1, 32000, 256, 30.0).specs
    b = traffic.source(p, 99, 32000, 256, 30.0).specs
    rate = p["arrival"]["rate"]
    assert len(a) == len(b) == round(rate * 30.0)
    assert sorted(len(s.prompt) for s in a) == sorted(len(s.prompt) for s in b)
    assert sorted(s.max_new for s in a) == sorted(s.max_new for s in b)
    assert [len(s.prompt) for s in a] != [len(s.prompt) for s in b]


def test_arrivals_are_poisson_within_the_window():
    """Counts per second scatter as a Poisson process's (variance about the
    mean), gaps are exponential (their coefficient of variation about 1),
    and the lengths in order are uncorrelated."""
    p = mix("tenants-online")
    rate = p["arrival"]["rate"]
    disp, cvs = [], []
    for seed in range(20):
        specs = traffic.source(p, seed, 32000, 256, 60.0).specs
        due = np.array([s.due for s in specs])
        assert (np.diff(due) >= 0).all() and due[0] >= 0 and due[-1] < 60.0
        counts = np.bincount(due.astype(int), minlength=60)
        disp.append(counts.var() / counts.mean())
        gaps = np.diff(due)
        cvs.append(gaps.std() / gaps.mean())
        assert abs(gaps.mean() * rate - 1) < 0.05
    assert 0.75 < np.mean(disp) < 1.25
    assert 0.9 < np.mean(cvs) < 1.1
    lens = np.array([len(s.prompt) for s in specs], float)
    assert abs(np.corrcoef(lens[:-1], lens[1:])[0, 1]) < 0.1


def test_lengths_keep_their_clips_and_medians():
    for name in ("tenants-online", "longgen"):
        p = mix(name)
        specs = traffic.ServeStream(p, 3, 50304, 256, pool=400).take(800)
        for part, vals in (("prompt", [len(s.prompt) for s in specs]),
                           ("output", [s.max_new for s in specs])):
            lo, hi = p[part]["min"], p[part]["max"]
            assert min(vals) >= lo and max(vals) <= hi
            assert abs(np.median(vals) - p[part]["median"]) <= 0.05 * p[part]["median"] + 1


def test_tenant_popularity_follows_zipf():
    p = mix("tenants-online")
    specs = traffic.source(p, 4, 32000, 256, 180.0).specs
    tmap = traffic.tenant_map(4, 256)
    counts = np.bincount([s.task for s in specs], minlength=256)
    probs = traffic.zipf_probs(256, p["tenants"]["zipf_s"])
    n = len(specs)
    for rank in (0, 1, 5):
        expect = probs[rank] * n
        assert abs(counts[tmap[rank]] - expect) < 4 * np.sqrt(expect)


def test_train_batches_are_deterministic_and_tilted_per_task():
    p = dict(mix("train-zipf"), batch=8, seq=64)
    s1 = traffic.TrainStream(p, 7, 500, 16)
    s2 = traffic.TrainStream(p, 7, 500, 16)
    b1, b2 = s1.batch(3), s2.batch(3)
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    assert b1["tokens"].shape == (8, 64) and b1["labels"].shape == (8, 64)
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert b1["tokens"].max() < 500 and b1["task_ids"].max() < 16
    assert not np.array_equal(s1.batch(4)["tokens"], b1["tokens"])
    # rows of one task follow its own unigram: the empirical frequencies of
    # many draws match the task's probabilities
    big = traffic.TrainStream(dict(p, batch=4, seq=4096), 7, 500, 16).batch(0)
    t, row = int(big["task_ids"][0]), big["tokens"][0]
    probs = np.diff(np.concatenate([[0.0], s1.cdf[t]]))
    freq = np.bincount(row, minlength=500) / row.size
    assert np.abs(freq - probs).max() < 0.02


def test_a_backlog_serves_its_pool_in_each_seeds_order():
    p = mix("longgen")
    k = p["pool"]
    a = traffic.source(p, 3, 50304, 16, 45.0)
    b = traffic.source(p, 4, 50304, 16, 45.0)
    first_a, first_b = a.start(), b.start()
    assert len(first_a) == p["arrival"]["outstanding"] and a.due(1e9) == []
    sizes_a = [(len(s.prompt), s.max_new) for s in first_a]
    sizes_b = [(len(s.prompt), s.max_new) for s in first_b]
    assert sizes_a != sizes_b
    # a completion sends the next request, due then; a pool's sizes are
    # every seed's
    nxt = a.done(first_a[0].uid, 7.5, None)
    assert len(nxt) == 1 and nxt[0].due == 7.5
    pa = traffic.ServeStream(p, 3, 50304, 16).take(k)
    pb = traffic.ServeStream(p, 4, 50304, 16).take(k)
    assert sorted(len(s.prompt) for s in pa) == sorted(len(s.prompt) for s in pb)
    assert sorted(s.max_new for s in pa) == sorted(s.max_new for s in pb)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(pa, pb))
