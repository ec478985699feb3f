"""Log-structured (LSM) multi-level count store for long streams.

The flat CountStore pays an O(capacity) merge every `merge_every` batches;
once the table is much larger than a flush, that pass over mostly idle rows
dominates.  The LSM layout keeps a geometric cascade of stores L0..Lm
(|L_{i+1}| = growth * |L_i|, the top one the full capacity): each flush
folds into L0, and level i is absorbed into level i+1 (CountStore.absorb,
one kernel-3 merge with the counts summed) every fill * growth^i flushes,
where L0 holds `fill` flushes.  Absorbing is an exact sorted merge, so
counts stay exact.

Two geometries share the cascade, each its JAX counter's: the single-GPU
counter's L0 holds `growth` flushes (fill = growth), the sharded
counter's one flush rounded up to the routing alignment
(`level_capacities(..., align=)`).

The cascade schedule is host-side integer math (no device read), and it is
the JAX package's (`tsxcount_tpu/core/lsm.py`), so both packages hold the
same level states after every flush.  Reads either sum the levels
(`lookup`) or first `collapse()` everything into the top level.

The state is a list of CountStore states, one a level, behind the store
interface of core/store.py: reads see the top level (`read_state`), folds
go into L0 and cascade, and the spill recovery's `merge_read` goes into the
top level, as the JAX sharded counter's does.  The folds and collapse
update that list in place (and return it), so a level's old tensors go as
soon as its new state exists: a cascade never holds two copies of the
levels on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from tsxcount_tpu_torch.config import KmerSpec
from tsxcount_tpu_torch.core.store import CountStore, StoreBase, StoreState
from tsxcount_tpu_torch.ops.count import UniqueCounts


class LSMStore(StoreBase):
    """Geometric cascade of CountStores with exact cross-level merges.

    capacity: distinct keys of the top level.  flush_rows: rows of one
    flush (merge_every * positions; sharded: merge_every * n_shards *
    route_cap).  align None: L0 holds `growth` flushes (flush_rows *
    growth rows), as the JAX counter builds it; else L0 is one flush
    rounded up to `align`, as the JAX sharded counter builds it.  The
    schedule counts flushes, not rows, so a short first flush changes
    nothing (the JAX counters pad every flush to merge_every histograms
    instead).
    """

    def __init__(self, spec: KmerSpec, capacity: int, flush_rows: int,
                 growth: int = 8, device: str | torch.device = "cuda",
                 align: int | None = None):
        if growth < 2:
            raise ValueError("growth must be >= 2")
        self.spec = spec
        self.growth = int(growth)
        caps = self.level_capacities(capacity, flush_rows, growth, align)
        self.levels = [CountStore(spec, c, device) for c in caps]
        self.fill = max(1, caps[0] // int(flush_rows))  # flushes L0 holds
        self.n_ops = self.levels[0].n_ops
        self._flushes = 0  # L0 merges, which drive the cascade
        self.absorbs = 0   # absorb merges run (for reports)

    @staticmethod
    def level_capacities(capacity: int, flush_rows: int, growth: int,
                         align: int | None = None) -> list[int]:
        """Rows of each level: L0 = flush_rows * growth (align None) or
        flush_rows rounded up to `align`, each next one `growth` times
        larger, the top one `capacity`."""
        caps = [int(flush_rows) * growth if align is None
                else -(-int(flush_rows) // align) * align]
        while caps[-1] * growth < capacity:
            caps.append(caps[-1] * growth)
        return caps + [int(capacity)]

    def init_state(self) -> list[StoreState]:
        """Empty levels, and the cascade restarted."""
        self.reset_schedule()
        return [lvl.init_state() for lvl in self.levels]

    def read_state(self, states: list[StoreState]) -> StoreState:
        return states[-1]

    def reset_schedule(self) -> None:
        """Restart the cascade counter (a fresh state on the same store)."""
        self._flushes = 0

    @property
    def capacity(self) -> int:
        return self.levels[-1].capacity

    def _absorb(self, states: list, i: int) -> None:
        """Level i into level i+1; level i starts empty again."""
        states[i + 1] = self.levels[i + 1].absorb(states[i + 1], states[i])
        states[i] = self.levels[i].init_state()
        self.absorbs += 1

    def merge_stacked(self, states: list[StoreState], ukeys: torch.Tensor,
                      ucounts: torch.Tensor, uvalid: torch.Tensor
                      ) -> list[StoreState]:
        """Fold R stacked batch histograms into L0 (CountStore.pack_runs),
        then cascade as merge_runs does."""
        return self.merge_runs(
            states, self.levels[0].pack_runs(ukeys, ucounts, uvalid))

    def merge_runs(self, states: list[StoreState], runs: list[tuple]
                   ) -> list[StoreState]:
        """Fold R runs (CountStore.merge_runs) into L0, then cascade full
        levels upward: level i absorbs into level i+1 every fill *
        growth^i flushes, checked bottom-up (carry-style), so level i+1
        takes at most `growth` images of level i between its own
        cascades.  No host synchronisation.  Updates `states` in place."""
        states[0] = self.levels[0].merge_runs(states[0], runs)
        self._flushes += 1
        period = self.fill
        for i in range(len(self.levels) - 1):
            if self._flushes % period:
                break  # higher levels cascade only when lower ones did
            self._absorb(states, i)
            period *= self.growth
        return states

    def merge_read(self, states: list[StoreState], uc: UniqueCounts
                   ) -> list[StoreState]:
        """Fold one deduplicated row histogram into the top level (the
        JAX sharded counter's spill recovery).  Updates `states` in
        place."""
        states[-1] = self.levels[-1].merge_read(states[-1], uc)
        return states

    def full_flag(self, states: list[StoreState]) -> torch.Tensor:
        """Whether any level overflowed."""
        return torch.stack([st.overflowed for st in states]).any()

    def collapse(self, states: list[StoreState]) -> list[StoreState]:
        """Absorb every level into the top level (for exports), as the JAX
        package does.  No host read.  Updates `states` in place."""
        for i in range(len(self.levels) - 1):
            self._absorb(states, i)
        return states

    def lookup(self, states: list[StoreState], queries: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Counts summed over the levels (no collapse needed): (counts
        int64 [N], found bool [N])."""
        counts = found = None
        for lvl, st in zip(self.levels, states):
            c, f = lvl.lookup(st, queries)
            counts = c if counts is None else counts + c
            found = f if found is None else found | f
        return counts, found

    def _top(self, states: list[StoreState]) -> StoreState:
        ns = torch.stack([st.n for st in states[:-1]]).cpu()
        if bool(ns.any()):
            raise RuntimeError("call collapse() first: the lower levels "
                               "hold keys")
        return states[-1]

    def export(self, states: list[StoreState]
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The top level's device-side export; raises unless the lower
        levels are empty (collapse first)."""
        return self.levels[-1].export(self._top(states))

    def to_host(self, states: list[StoreState], key_map=None
                ) -> tuple[np.ndarray, np.ndarray, int]:
        """The top level's export; raises unless the lower levels are
        empty (collapse first)."""
        return self.levels[-1].to_host(self._top(states), key_map)

    def state_from_reference(self, ref) -> list[StoreState]:
        """Empty lower levels and the top level from a JAX store state (a
        checkpoint keeps the collapsed top level only)."""
        states = [lvl.init_state() for lvl in self.levels]
        states[-1] = self.levels[-1].state_from_reference(ref)
        return states

    def state_to_reference(self, states: list[StoreState]
                           ) -> dict[str, np.ndarray]:
        """The top level's JAX store-state fields; raises unless the lower
        levels are empty (collapse first)."""
        return self.levels[-1].state_to_reference(self._top(states))
