"""Per-task serving adapters, graph-mixed over the task-relatedness graph.

Counterpart of ``repro.serve.adapters``: the paper's weighted neighbour
averaging lifted into the serving stack. Every task (tenant) owns a stack
of low-rank deltas — one ``(d, r) x (r, d)`` factor pair per layer branch
plus per-task head-bias, final-gain and (MoE) router-bias deltas — stored
task-leading, so the whole store is one tree of ``(num_tasks, ...)``
leaves. The store re-mixes ALL leaves with the graph's averaging weights
``mu`` (``TaskGraph.bsr_mixing`` / ``bol_mixing`` / ``consensus_mixing``)
in one ``graph_mix_tree`` call — one kernel launch per leaf dtype — and publishes
a ``serving`` tree with a terminal ZERO null row (index ``num_tasks``) that
dead batcher lanes gather. The serving tree is allocated once, with the
store, and every refresh writes the mixed rows into it in place: a CUDA
graph of the serving steps, captured with its tensors, reads each
refresh's values at its next replay.

The batcher passes ``store.serving`` to every dispatch, where
``TransformerLM._gather_adapters`` picks each batch row's factors by task
id: multi-LoRA serving of a mixed-task batch in the same dispatches as
single-task serving.

Online adaptation follows Appendix G (Theorem 7): the store keeps a ring of
the last ``max_delay + 1`` stacked iterates; each ``update()`` mixes STALE
neighbour views (one bounded delay per source task, ``per_source_stale``)
and takes a gradient step on the per-task gradients that finished requests
pushed since the last update. ``note_request`` is the batcher's finish
hook: it counts retired requests and runs ``update()`` every
``update_every`` finishes, on the host, between dispatches.

The mix runs through the hand-written kernel or its plain version as the
model's ``cfg.attn_backend`` says (``"kernel"`` / ``"plain"``), read at
each mix. Random factors come from a ``torch.Generator`` seeded by a draw
of the store's numpy generator, so the delay stream that follows stays in
step with the JAX store's for the same seed (the factors themselves
differ).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tracing
from repro_torch import tree as tree_lib
from repro_torch.core.delayed import per_source_stale
from repro_torch.core.graph import TaskGraph
from repro_torch.kernels.graph_mix import graph_mix_tree, graph_mix_tree_reference
from repro_torch.models.model import ATTN_KINDS

MIXINGS = ("bsr", "bol", "consensus")


def _mixing_matrix(graph: TaskGraph, mixing: str, eta: float, tau: float,
                   alpha: float) -> np.ndarray:
    if mixing == "bsr":
        return graph.bsr_mixing(eta, tau, alpha)
    if mixing == "bol":
        return graph.bol_mixing(eta, tau, alpha)
    if mixing == "consensus":
        return graph.consensus_mixing()
    raise ValueError(f"mixing must be one of {MIXINGS}, got {mixing!r}")


class TaskAdapterStore:
    """Graph-mixed stacked low-rank adapters for multi-task serving.

    Layout (all leaves task-leading, ``m = num_tasks``, ``P`` = periods of
    the stage, ``r`` = rank, ``d`` = d_model, ``E`` = experts), the JAX
    store's: one dict per stage of the model's JAX layout (the stacked
    periods, then the remainder), one entry per slot of the stage's
    pattern — an "attn" and an "mlp" pair for an attention kind (a hybrid's
    shared-attention slot too: each invocation has its own; the "mlp" pair
    adds to the MoE branch), one "out" pair, added after the mixer, for a
    recurrent kind (mamba, mlstm, slstm)::

        raw = {
          "stages": [{
            "slot<j>": {"attn": {"a": (m,P,d,r), "b": (m,P,r,d)},
                        "mlp":  {"a": (m,P,d,r), "b": (m,P,r,d)}}   # attention
                     | {"out":  {"a": (m,P,d,r), "b": (m,P,r,d)}}   # recurrent
          }, ...],
          "task": {"head_bias": (m, V * K) [, "final_gain": (m, d)]
                   [, "router_bias": (m, E)]},
        }

    An ("attn",) model has one stage of one slot with P = num_layers; K is
    an audio model's codebook count (its head bias spans every codebook's
    vocabulary), 1 otherwise.

    ``serving`` is the graph-mixed copy with one extra ZERO row appended to
    every leaf — row ``null_task == num_tasks`` — gathered by dead lanes.
    Its tensors never change: ``update``, ``set_raw`` and ``randomize``
    republish through ``refresh``, which writes rows ``[0, num_tasks)`` in
    place.
    """

    def __init__(
        self,
        model,
        graph: TaskGraph,
        *,
        rank: int | None = None,
        mixing: str = "bsr",
        eta: float = 1.0,
        tau: float = 1.0,
        alpha: float = 1.0,
        lr: float = 0.01,
        max_delay: int = 0,
        fixed_delay: bool = False,
        update_every: int = 1,
        seed: int = 0,
        dtype=None,
    ):
        cfg = model.cfg
        if graph.m != cfg.num_tasks:
            raise ValueError(
                f"task graph has {graph.m} tasks but the model serves "
                f"num_tasks={cfg.num_tasks}"
            )
        rank = rank if rank is not None else cfg.adapter_rank
        if rank <= 0:
            raise ValueError(
                "adapter rank must be positive — pass rank= or set cfg.adapter_rank"
            )
        if max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {max_delay}")
        if update_every <= 0:
            raise ValueError(f"update_every must be >= 1, got {update_every}")
        self.model = model
        self.graph = graph
        self.rank = rank
        self.mixing = mixing
        self.lr = lr
        self.max_delay = max_delay
        self.fixed_delay = fixed_delay
        self.update_every = update_every
        self.device = model.device
        self.dtype = dtype if dtype is not None else model.dtype
        self.null_task = cfg.num_tasks
        self.mu = torch.as_tensor(
            _mixing_matrix(graph, mixing, eta, tau, alpha), dtype=torch.float32,
            device=self.device,
        )
        self._rng = np.random.default_rng(seed)
        self.raw = self._zeros_raw()
        self._grads = tree_lib.map_(torch.zeros_like, self.raw)
        self._hist: list = [self.raw]  # newest first, len <= max_delay + 1
        self._finished = 0
        self.updates = 0
        self.serving = tree_lib.map_(
            lambda t: torch.zeros((t.shape[0] + 1,) + t.shape[1:], dtype=t.dtype,
                                  device=t.device),
            self.raw,
        )
        self.refresh()

    # ------------------------------------------------------------ structure
    @property
    def num_tasks(self) -> int:
        return self.model.cfg.num_tasks

    def _zeros_raw(self):
        cfg = self.model.cfg
        m, r, d = cfg.num_tasks, self.rank, cfg.d_model

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        def pair(reps):
            return {"a": zeros(m, reps, d, r), "b": zeros(m, reps, r, d)}

        stages = [
            {f"slot{j}": ({"attn": pair(reps), "mlp": pair(reps)} if kind in ATTN_KINDS
                          else {"out": pair(reps)})
             for j, kind in enumerate(kinds)}
            for kinds, reps, _ in cfg.stages()
        ]
        task = {"head_bias": zeros(m, cfg.vocab_size * cfg.num_codebooks)}
        if cfg.norm_kind != "nonparam_ln":
            task["final_gain"] = zeros(m, d)
        if cfg.uses_moe:
            task["router_bias"] = zeros(m, cfg.num_experts)
        return {"stages": stages, "task": task}

    def zeros_like_task(self):
        """A zero gradient tree for ONE task (leaves without the leading
        task axis) — the shape ``push_grads`` expects."""
        return tree_lib.map_(lambda t: torch.zeros_like(t[0]), self.raw)

    def _mix(self, tree):
        if self.model.cfg.attn_backend == "plain":
            return graph_mix_tree_reference(self.mu, tree)
        return graph_mix_tree(self.mu, tree)

    # -------------------------------------------------------------- content
    def set_raw(self, tree) -> None:
        """Replace the raw per-task parameters (tests, checkpoint load) with
        a tree of tensors of the store's structure, shapes and dtypes,
        copied to the store's device. Resets the delay history — the new
        iterate is the only one — and republishes ``serving``."""
        def layout(t):
            return [(p, tuple(x.shape), x.dtype) for p, x in tree_lib.paths(t)]

        if layout(tree) != layout(self.raw):
            raise ValueError(
                "set_raw: tree structure/shapes/dtypes must match the store's layout"
            )
        self.raw = tree_lib.map_(lambda t: t.to(self.device, copy=True), tree)
        self._hist = [self.raw]
        self.refresh()

    def randomize(self, scale: float = 1e-2) -> None:
        """Fill the raw store with gaussian factors times ``scale`` (tests
        and benchmarks that need NONZERO per-task adapters quickly)."""
        gen = torch.Generator(device=self.device).manual_seed(
            int(self._rng.integers(2**31))
        )
        self.set_raw(tree_lib.map_(
            lambda t: (torch.randn(t.shape, generator=gen, dtype=torch.float32,
                                   device=self.device) * scale).to(t.dtype),
            self.raw,
        ))

    def refresh(self) -> None:
        """Re-mix every leaf with ``mu`` (one kernel launch per dtype) and
        publish it IN PLACE: each serving leaf's rows ``[0, num_tasks)`` (a
        contiguous view) take the mixed rows; the zero null row and the
        tensors themselves stay."""
        m = self.num_tasks
        tree_lib.map_(lambda dst, t: dst[:m].copy_(t), self.serving, self._mix(self.raw))

    # ------------------------------------------------- delayed adaptation
    def push_grads(self, task_id: int, grads) -> None:
        """Accumulate a gradient signal for one task (a tree shaped like
        ``zeros_like_task()``), consumed by the next ``update()``."""
        if not 0 <= task_id < self.num_tasks:
            raise ValueError(f"task_id {task_id} outside [0, {self.num_tasks})")

        def add(g_all, g):
            g_all[task_id] += torch.as_tensor(g, dtype=g_all.dtype, device=g_all.device)

        tree_lib.map_(add, self._grads, grads)

    def note_request(self, req) -> None:
        """Batcher finish hook: every ``update_every`` retired requests, run
        one delayed mixing + gradient update (on the host, between
        dispatches)."""
        self._finished += 1
        if self._finished % self.update_every == 0:
            self.update()

    def update(self) -> None:
        """One delayed BOL-style update (Appendix G semantics):

        ``raw <- graph_mix(mu, stale) - lr * pending_grads``

        where ``stale`` picks each SOURCE task's iterate from the history
        ring at a bounded delay <= min(max_delay, len(hist) - 1) —
        resampled per update, or pinned to the bound with fixed_delay."""
        with tracing.span("store.update"):
            m = self.num_tasks
            bound = min(self.max_delay, len(self._hist) - 1)
            with tracing.span("store.delays"):
                if self.fixed_delay:
                    delays = np.full(m, bound, np.int32)
                else:
                    delays = self._rng.integers(0, bound + 1, size=m).astype(np.int32)
                if bound > 0:
                    # from pageable memory: the copy waits for the stream
                    with tracing.span(".wait"):
                        d = torch.as_tensor(delays, device=self.device)
            if bound == 0:
                stale = self._hist[0]
            else:
                with tracing.span("store.stale"):
                    stale = tree_lib.map_(
                        lambda *hs: per_source_stale(torch.stack(hs), d), *self._hist
                    )
            with tracing.span("store.mix"):
                mixed = self._mix(stale)
            with tracing.span("store.step"):
                new = tree_lib.map_(lambda t, g: t - self.lr * g.to(t.dtype), mixed, self._grads)
                self._grads = tree_lib.map_(torch.zeros_like, self._grads)
            self.raw = new
            self._hist = [new] + self._hist[: self.max_delay]
            self.updates += 1
            with tracing.span("store.refresh"):
                self.refresh()
