"""Deterministic fault injection for the serving engine (chaos harness).

Copy of ``repro.serve.faults`` (numpy only). ``FaultPlan`` is a seeded
schedule of faults fired at named SEAMS inside ``repro_torch.serve.
ContinuousBatcher`` / ``ServeEngine``:

  ========  ===============================================================
  seam      fires at
  ========  ===============================================================
  alloc     block reservation in ``_try_bind`` — simulated allocator
            exhaustion: the bind reports backpressure exactly as if the
            free list were empty, and admission stops for the round
  incref    prefix-cache chain pinning at admission (sharing path only)
  dispatch  immediately BEFORE a step dispatch (and before its CUDA graph
            is captured); ``where`` narrows the site to ``"decode"`` /
            ``"prefill"`` / ``"mixed"`` / ``"cow"`` / ``"swap"`` (None
            matches any). Raises ``FaultError``. Because the fault fires
            before the call, no device state has been mutated, no kernel
            has launched, and the executor can retry.
  nan       poisons one (tick, slot) lane's host copy of its logits with
            NaN at an emission point — the lane-quarantine trigger. The
            seam is evaluated where logits are emitted, so a scripted event
            should target a tick at which the lane emits.
  adapter   the adapter store's between-tick update hook
            (``note_request``) for a finishing request
  free      block release inside ``_retire_expired`` — the retirement is
            skipped this round (slot stays bound, blocks stay held, the
            allocator stays reconcilable) and retried next round
  clock     permanent forward clock skew of ``skew_s`` seconds starting
            at ``tick`` — every deadline the scheduler checks sees the
            skewed time (timeout storms)
  ========  ===============================================================

Every seam is guarded by ``if self.faults is not None`` in the executor,
so ``faults=None`` (the default) takes no branches, reads no logits it
would not otherwise read, and issues no extra dispatch.

Scripted events fire when every given constraint matches::

    plan = FaultPlan()
    plan.script("dispatch", where="decode", tick=3)     # 3rd decode tick
    plan.script("nan", uid=7, count=1)                  # poison request 7
    plan.script("clock", tick=5, skew_s=60.0)           # jump time +60s

Probabilistic events draw from the plan's seeded generator, so a
(seed, call-sequence) pair replays identically — and, since the executor
evaluates the seams at the same points in the same order as the JAX
package's, a plan and its JAX counterpart built from one seed fire alike::

    plan = FaultPlan(seed=42)
    plan.probabilistic("alloc", p=0.2)

Every firing is appended to ``plan.log`` as ``(tick, seam, slot, uid,
where)`` for test introspection.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SEAMS = ("alloc", "incref", "dispatch", "nan", "adapter", "free", "clock")
DISPATCH_SITES = ("decode", "prefill", "mixed", "cow", "swap")


class FaultError(RuntimeError):
    """An injected fault. Transient by contract: the executor retries the
    affected work (bounded by ``max_retries``) instead of crashing — only
    retry exhaustion turns it into a terminal ``Request.failed``."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault. ``None`` constraints match anything; ``count``
    bounds total firings (None = unlimited); ``p`` draws per evaluation
    from the plan's seeded generator (None = always fire on match)."""

    seam: str
    tick: int | None = None
    slot: int | None = None
    uid: int | None = None
    where: str | None = None
    count: int | None = 1
    p: float | None = None
    skew_s: float = 0.0
    fired: int = 0


class FaultPlan:
    """A seeded, replayable schedule of faults for the serving executor."""

    def __init__(self, seed: int = 0):
        self.events: list[FaultEvent] = []
        self.log: list[tuple] = []
        self._rng = np.random.default_rng(seed)
        self._tick = 0

    # ----------------------------------------------------------- authoring
    def _add(self, ev: FaultEvent) -> "FaultPlan":
        if ev.seam not in SEAMS:
            raise ValueError(
                f"unknown fault seam {ev.seam!r}; valid seams: {SEAMS}"
            )
        if ev.where is not None and ev.where not in DISPATCH_SITES:
            raise ValueError(
                f"unknown dispatch site {ev.where!r}; valid sites: "
                f"{DISPATCH_SITES}"
            )
        if ev.seam == "clock" and ev.tick is None:
            raise ValueError("clock skew events need a tick to start at")
        self.events.append(ev)
        return self

    def script(
        self,
        seam: str,
        tick: int | None = None,
        slot: int | None = None,
        uid: int | None = None,
        where: str | None = None,
        count: int | None = 1,
        skew_s: float = 0.0,
    ) -> "FaultPlan":
        """Schedule a deterministic fault; chainable. Fires whenever the
        seam is evaluated with matching (tick, slot, uid, where), at most
        ``count`` times."""
        return self._add(FaultEvent(
            seam=seam, tick=tick, slot=slot, uid=uid, where=where,
            count=count, skew_s=skew_s,
        ))

    def probabilistic(
        self,
        seam: str,
        p: float,
        where: str | None = None,
        count: int | None = None,
    ) -> "FaultPlan":
        """Schedule a fault firing with probability ``p`` per evaluation,
        drawn from the plan's seeded generator (replayable)."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be a probability, got {p}")
        return self._add(FaultEvent(seam=seam, where=where, count=count, p=p))

    # ----------------------------------------------------------- execution
    def set_tick(self, tick: int) -> None:
        """Called by the executor at the start of every scheduling round so
        tick-constrained events can match."""
        self._tick = int(tick)

    def fires(self, seam: str, slot=None, uid=None, where=None) -> bool:
        """Evaluate the seam: does a scheduled event fire here? At most one
        event fires per evaluation; every firing is logged."""
        for ev in self.events:
            if ev.seam != seam or ev.seam == "clock":
                continue
            if ev.count is not None and ev.fired >= ev.count:
                continue
            if ev.tick is not None and ev.tick != self._tick:
                continue
            if ev.slot is not None and slot is not None and ev.slot != slot:
                continue
            if ev.slot is not None and slot is None:
                continue
            if ev.uid is not None and ev.uid != uid:
                continue
            if ev.where is not None and ev.where != where:
                continue
            if ev.p is not None and self._rng.random() >= ev.p:
                continue
            ev.fired += 1
            self.log.append((self._tick, seam, slot, uid, where))
            return True
        return False

    def skew(self) -> float:
        """Total clock skew active at the current tick (sum of every clock
        event whose start tick has passed). The executor wraps the
        scheduler's clock with ``now() + skew()``."""
        total = 0.0
        for ev in self.events:
            if ev.seam != "clock" or ev.tick is None or ev.tick > self._tick:
                continue
            if not ev.fired:
                ev.fired = 1
                self.log.append((self._tick, "clock", None, None, None))
            total += ev.skew_s
        return total

    @property
    def fired(self) -> int:
        """Total faults fired so far (clock activations included)."""
        return len(self.log)
