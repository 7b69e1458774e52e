"""The port's TaskAdapterStore (repro_torch.serve.adapters) against the JAX
package's on the multitask_lm smoke config, CPU, float32: the raw and
serving trees' paths, shapes and dtypes; ``set_raw`` validation; the zero
null row through randomize and update; the serving tree equal to the plain
mix; and the delayed updates — same seed, same pushed gradients,
max_delay 2, resampled and fixed delays — giving the JAX store's raw and
serving trees within 1e-5 after every update, with ``randomize``'s draw
from the store's numpy generator keeping the two delay streams in step."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.serve import TaskAdapterStore as JaxStore  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import adapters_from_numpy  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.kernels.graph_mix import graph_mix_tree_reference  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import TaskAdapterStore  # noqa: E402
from repro_torch.serve.adapters import MIXINGS  # noqa: E402

_CACHE = {}
_paths = tree_lib.paths


def _models():
    """(JAX model, port model on the CPU); the store reads only the config."""
    if not _CACHE:
        _CACHE["jm"] = JaxLM(jax_get("multitask_lm", smoke=True))
        _CACHE["tm"] = TransformerLM(get("multitask_lm", smoke=True), device="cpu")
    return _CACHE["jm"], _CACHE["tm"]


def _np(tree):
    return jax.tree.map(lambda t: np.asarray(t, np.float32), tree)


def _assert_trees_close(ttree, jtree, atol=1e-5):
    got = list(_paths(tree_lib.map_(lambda t: t.float().numpy(), ttree)))
    want = list(_paths(_np(jtree)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_equals_jax_store(dtype):
    jm, tm = _models()
    m = tm.cfg.num_tasks
    js = JaxStore(jm, jgraph.ring_graph(m), dtype=getattr(jax.numpy, dtype))
    ts = TaskAdapterStore(tm, graph.ring_graph(m), dtype=getattr(torch, dtype))
    for t_tree, j_tree in ((ts.raw, js.raw), (ts.serving, js.serving)):
        got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for p, t in _paths(t_tree)]
        want = [(p, tuple(t.shape), np.asarray(t).dtype.name) for p, t in _paths(j_tree)]
        assert got == want
    assert ts.null_task == js.null_task == m
    assert ts.rank == js.rank == tm.cfg.adapter_rank
    assert MIXINGS == ("bsr", "bol", "consensus")
    z = ts.zeros_like_task()
    assert [(p, tuple(t.shape)) for p, t in _paths(z)] == [
        (p, np.shape(t)) for p, t in _paths(js.zeros_like_task())
    ]


def test_store_rejects_bad_arguments_and_layouts():
    _, tm = _models()
    m = tm.cfg.num_tasks
    with pytest.raises(ValueError, match="tasks"):
        TaskAdapterStore(tm, graph.ring_graph(m + 1))
    with pytest.raises(ValueError, match="rank"):
        TaskAdapterStore(tm, graph.ring_graph(m), rank=0)
    with pytest.raises(ValueError, match="max_delay"):
        TaskAdapterStore(tm, graph.ring_graph(m), max_delay=-1)
    with pytest.raises(ValueError, match="update_every"):
        TaskAdapterStore(tm, graph.ring_graph(m), update_every=0)
    with pytest.raises(ValueError, match="mixing"):
        TaskAdapterStore(tm, graph.ring_graph(m), mixing="admm")
    store = TaskAdapterStore(tm, graph.ring_graph(m))
    bad_shape = tree_lib.map_(lambda t: t[:, None] if t.ndim == 2 else t, store.raw)
    bad_dtype = tree_lib.map_(lambda t: t.double(), store.raw)
    bad_keys = {"stages": store.raw["stages"],
                "task": {"head_bias": store.raw["task"]["head_bias"]}}
    for bad in (bad_shape, bad_dtype, bad_keys):
        with pytest.raises(ValueError, match="set_raw"):
            store.set_raw(bad)
    with pytest.raises(ValueError, match="task_id"):
        store.push_grads(m, store.zeros_like_task())


def test_null_row_stays_zero_and_serving_is_the_plain_mix():
    _, tm = _models()
    m = tm.cfg.num_tasks
    store = TaskAdapterStore(tm, graph.ring_graph(m), mixing="bol", eta=0.3, tau=0.5,
                             alpha=0.1, max_delay=1)
    store.randomize(scale=0.5)
    g = tree_lib.map_(torch.ones_like, store.zeros_like_task())
    store.push_grads(2, g)
    store.update()
    ref = graph_mix_tree_reference(store.mu, store.raw)
    for got, want in zip(tree_lib.leaves(store.serving), tree_lib.leaves(ref)):
        assert got.shape[0] == m + 1
        torch.testing.assert_close(got[:m], want, rtol=0, atol=1e-6)
        assert torch.count_nonzero(got[m]) == 0


def test_set_raw_copies_and_resets_history():
    _, tm = _models()
    store = TaskAdapterStore(tm, graph.ring_graph(tm.cfg.num_tasks), max_delay=2)
    store.update()
    store.update()
    assert len(store._hist) == 3
    tree = tree_lib.map_(torch.ones_like, store.raw)
    store.set_raw(tree)
    assert len(store._hist) == 1
    tree["task"]["head_bias"].zero_()  # the store holds its own copy
    assert torch.all(store.raw["task"]["head_bias"] == 1)


def _grads(rng, zeros):
    return jax.tree.map(lambda t: rng.standard_normal(np.shape(t)).astype(np.float32), zeros)


@pytest.mark.parametrize("mixing,fixed", [("bsr", False), ("bsr", True), ("bol", False),
                                          ("consensus", False)])
def test_delayed_updates_match_jax_store(mixing, fixed):
    jm, tm = _models()
    m = tm.cfg.num_tasks
    kw = dict(mixing=mixing, eta=0.5, tau=1.0, alpha=0.2 if mixing == "bol" else 1.0,
              lr=0.1, max_delay=2, fixed_delay=fixed, seed=7)
    js = JaxStore(jm, jgraph.band_graph(m, 2), **kw)
    ts = TaskAdapterStore(tm, graph.band_graph(m, 2), **kw)
    serving, ptrs = ts.serving, _pointers(ts.serving)
    js.randomize(scale=0.1)
    ts.randomize(scale=0.1)  # one draw of the numpy generator on each side
    adapters_from_numpy(ts, _np(js.raw))
    _assert_trees_close(ts.serving, js.serving)
    rng = np.random.default_rng(3)
    zeros = _np(js.zeros_like_task())
    for step in range(5):
        for task in (step % m, (3 * step + 1) % m):
            g = _grads(rng, zeros)
            js.push_grads(task, g)
            ts.push_grads(task, g)
        js.update()
        ts.update()
        assert ts.updates == js.updates == step + 1
        assert len(ts._hist) == len(js._hist) == min(step + 2, 3)
        _assert_trees_close(ts.raw, js.raw)
        _assert_trees_close(ts.serving, js.serving)
        # published in place: the tree a captured serving graph reads
        assert ts.serving is serving and _pointers(ts.serving) == ptrs


def _pointers(tree):
    return [t.data_ptr() for t in tree_lib.leaves(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_tree_is_republished_in_place(dtype):
    """update(), set_raw() and randomize() write the mixed rows into the
    serving tree allocated with the store: every leaf keeps its storage,
    the null row stays zero, rows [0, m) equal the plain mix."""
    _, tm = _models()
    m = tm.cfg.num_tasks
    store = TaskAdapterStore(tm, graph.ring_graph(m), max_delay=1,
                             dtype=getattr(torch, dtype))
    serving, ptrs = store.serving, _pointers(store.serving)
    g = tree_lib.map_(torch.ones_like, store.zeros_like_task())
    for step in (lambda: store.randomize(scale=0.5),
                 lambda: store.push_grads(1, g) or store.update(),
                 lambda: store.set_raw(tree_lib.map_(lambda t: t + 1, store.raw)),
                 store.update):
        step()
        assert store.serving is serving and _pointers(store.serving) == ptrs
        ref = graph_mix_tree_reference(store.mu, store.raw)
        for got, want in zip(tree_lib.leaves(store.serving), tree_lib.leaves(ref)):
            assert got.shape[0] == m + 1 and got.is_contiguous()
            torch.testing.assert_close(got[:m], want, rtol=0, atol=1e-6)
            assert torch.count_nonzero(got[m]) == 0


def test_note_request_runs_update_every_n_finishes():
    _, tm = _models()
    store = TaskAdapterStore(tm, graph.ring_graph(tm.cfg.num_tasks), update_every=3)
    for _ in range(7):
        store.note_request(None)
    assert store.updates == 2


def test_identity_mixing_isolates_the_gradient_step():
    """Disconnected graph, bsr with alpha 1: mu = I, so update() applies
    ``raw - lr * grads`` to the pushed task only and consumes the grads;
    a fixed delay of 1 rebuilds from the previous iterate."""
    _, tm = _models()
    m = tm.cfg.num_tasks
    store = TaskAdapterStore(tm, graph.disconnected_graph(m), lr=0.5, max_delay=1,
                             fixed_delay=True)
    store.randomize(scale=0.1)
    r_hb = store.raw["task"]["head_bias"].clone()
    g = store.zeros_like_task()
    g["task"]["head_bias"] = torch.ones_like(g["task"]["head_bias"])
    store.push_grads(3, g)
    store.update()  # bound 0: new = R - 0.5 e3
    stepped = store.raw["task"]["head_bias"]
    torch.testing.assert_close(stepped[3], r_hb[3] - 0.5, rtol=0, atol=1e-6)
    others = [t for t in range(m) if t != 3]
    torch.testing.assert_close(stepped[others], r_hb[others], rtol=0, atol=1e-6)
    store.update()  # bound 1, fixed: mixes the stale R, grads consumed
    torch.testing.assert_close(store.raw["task"]["head_bias"], r_hb, rtol=0, atol=1e-6)


def test_backend_selects_the_mix(monkeypatch):
    """cfg.attn_backend == "plain" mixes through the plain tree version,
    "kernel" through graph_mix_tree (the CUDA kernel on a card)."""
    from repro_torch.serve import adapters as adapters_mod

    _, tm = _models()
    used = []
    monkeypatch.setattr(adapters_mod, "graph_mix_tree",
                        lambda mu, t: used.append("kernel") or graph_mix_tree_reference(mu, t))
    monkeypatch.setattr(adapters_mod, "graph_mix_tree_reference",
                        lambda mu, t: used.append("plain") or graph_mix_tree_reference(mu, t))
    TaskAdapterStore(tm, graph.ring_graph(tm.cfg.num_tasks))
    plain = TransformerLM(dataclasses.replace(tm.cfg, attn_backend="plain"), device="cpu")
    TaskAdapterStore(plain, graph.ring_graph(tm.cfg.num_tasks))
    assert used == ["kernel", "plain"]
