"""SlotMap: pure host-side slot/position/live-mask bookkeeping.

Copy of ``repro.serve.slots`` (numpy only), without its reconciliation
check, which belongs with the fault-tolerance slice: which request occupies
which decode slot, each slot's next write position, and the masks/vectors
the serving steps consume. It holds no device tensors and knows nothing
about the KV layout or the model; the executor (``ContinuousBatcher``) owns
the device side.
"""
from __future__ import annotations

import numpy as np


class SlotMap:
    """Slot ↔ request binding plus per-slot positions, all host-side.

    ``pos[s]`` is slot ``s``'s NEXT write position (the number of tokens —
    prompt + generated — already written to its cache). A slot with no
    bound request keeps ``pos`` at its last value until rebound; ``bind``
    zeroes it, and the executor's reset flag restores the per-slot cache
    state inside the next prefill dispatch.
    """

    def __init__(self, num_slots: int):
        # typed errors, not asserts: slot invariants must survive `python -O`
        if num_slots <= 0:
            raise ValueError(f"num_slots must be positive, got {num_slots}")
        self.num_slots = num_slots
        self.pos = np.zeros(num_slots, np.int32)
        self.reqs: list = [None] * num_slots

    # ------------------------------------------------------------ queries
    def free_slots(self) -> list[int]:
        """Ascending ids of unbound slots (deterministic admission order)."""
        return [s for s, r in enumerate(self.reqs) if r is None]

    def live(self) -> np.ndarray:
        """(num_slots,) bool — True where a request is bound."""
        return np.array([r is not None for r in self.reqs])

    def any_live(self) -> bool:
        return any(r is not None for r in self.reqs)

    def live_items(self):
        """[(slot, request)] for every bound slot, in slot order."""
        return [(s, r) for s, r in enumerate(self.reqs) if r is not None]

    def task_ids(self, null_task: int = 0) -> np.ndarray:
        """(num_slots,) int32 task ids; unbound slots ride along as
        ``null_task``. The executor passes ``num_tasks``, one past the
        task tables; the model clamps it, and dead lanes' outputs are
        discarded."""
        return np.array(
            [r.task_id if r is not None else null_task for r in self.reqs],
            np.int32,
        )

    def slot_of(self, uid) -> int | None:
        """Slot currently bound to request ``uid`` (None if not bound)."""
        for s, r in enumerate(self.reqs):
            if r is not None and r.uid == uid:
                return s
        return None

    # ------------------------------------------------------------ updates
    def bind(self, slot: int, req, pos: int = 0) -> None:
        """Bind a request, starting at write position ``pos`` (0 for a
        fresh prompt)."""
        if self.reqs[slot] is not None:
            # binding over a live request would silently interleave two
            # requests' tokens through one cache stripe
            raise RuntimeError(f"slot {slot} already bound")
        if pos < 0:
            raise ValueError(f"bind position must be >= 0, got {pos}")
        self.reqs[slot] = req
        self.pos[slot] = pos

    def release(self, slot: int):
        """Unbind and return the slot's request (position left as-is — the
        next ``bind`` zeroes it and the reset flag clears cache state)."""
        req = self.reqs[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} is not bound")
        self.reqs[slot] = None
        return req

    def set_positions(self, positions) -> None:
        """Adopt the position vector a serving dispatch returned (copied —
        np.asarray of a device array is a read-only view)."""
        self.pos = np.array(positions, np.int32)

    def advance_live(self) -> None:
        """Advance every bound slot's position by one (a decode tick)."""
        self.pos = self.pos + self.live().astype(np.int32)
