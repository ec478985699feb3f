"""Device-resident sorted count store (the sort backend's table).

Exact per-kmer counts held as a sorted array of (key, count) rows, merged
batch by batch.  The state keeps the keys already packed as the msb-first
operands the merge kernels compare (ops/count.py pack_flag_key), one int32
column per operand, and the counts as ONE int64 column: the JAX package's
base-2^20 digit triples exist for the TPU's int32 lanes and have no job
here (`state_to_reference` rebuilds them).

Two invariants, both of which once broke the JAX package's store:
  * rows [n, capacity) hold the invalid constant (flag only) with count 0
    after every merge — compaction leaves real-looking keys past the
    frontier, and left in place they would repack as many unsorted
    "invalid" rows on the next merge;
  * so the unused rows form ONE constant run at the end, which sorts after
    every real key and which the merge-dedupe kernel reports apart.

The store interface.  CountStore, LSMStore (core/lsm.py) and QuotientTable
(core/table.py) answer the same calls, so that a counter decides its
backend once, when it builds the store, and then calls:
  * `init_state()`: a fresh state (the LSM restarts its cascade, the table
    its host counts);
  * `read_state(state)` and `collapse(state)`: the state reads see, and
    the fold a read needs first (the LSM's top level and absorb-all; the
    identity here and on the table); `reset_schedule()` restarts the LSM's
    cascade (the sharded counter's, after a collapse);
  * the folds: `merge_batches` (the plain counter's batch histograms, as
    count_unique_ops made them), `merge_runs` (the one-shard hand-off's
    runs), `merge_stacked` (the routed runs as rows) and `merge_read` (one
    deduplicated histogram into the read state: the spill recovery);
  * `full_flag(state)`: the device flag that `finish` reads (nonzero: the
    store is full, `FULL` says how);
  * `counts_of(state, queries)`: int64 counts on the device, 0 if absent;
  * `export`, `to_host`, `state_to_reference`, `state_from_reference`
    (`reference_fields`: the JAX state's fields a checkpoint holds);
  * `inserts`, `residue_launches`, `rounds`, `split_rounds`,
    `max_reprobes` and `state_stats(state)`: the table's values in a
    counter's stats and checkpoint, 0 and empty here.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from tsxcount_tpu_torch._build import resolve_device
from tsxcount_tpu_torch.config import (
    COUNT_DIGIT_BITS,
    COUNT_DIGIT_MASK,
    COUNT_DIGITS,
    KmerSpec,
)
from tsxcount_tpu_torch.ops.count import (
    UniqueCounts,
    flag_ops,
    histogram_run,
    invalid_constants,
    pack_flag_key,
    unique_run,
    unpack_flag_key,
)
from tsxcount_tpu_torch.ops.lanes import keys_equal, keys_less
from tsxcount_tpu_torch.ops.merge import merge_sorted
from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted

REFERENCE_FIELDS = ("keys", "digits", "used", "n", "overflowed")


class StoreState(NamedTuple):
    keys: torch.Tensor        # int32 [n_ops, cap]: packed operands, msb first
    counts: torch.Tensor      # int64 [cap]
    n: torch.Tensor           # int64 0-d: distinct keys held
    overflowed: torch.Tensor  # bool 0-d: capacity was ever exceeded


class StoreBase:
    """The store interface's defaults (see the module docstring): a store
    that reads the state it folds into, and that keeps no host counts."""

    reference_fields = REFERENCE_FIELDS
    FULL = "distinct kmers exceeded the capacity"
    inserts = residue_launches = rounds = split_rounds = max_reprobes = 0

    def read_state(self, state):
        return state

    def collapse(self, state):
        return state

    def reset_schedule(self) -> None:
        pass

    def state_stats(self, state) -> dict:
        return {}

    def merge_batches(self, state, uos: list):
        """Fold the batch histograms of count_unique_ops (ops/count.py
        UniqueOps) as runs (`unique_run`)."""
        return self.merge_runs(state, [unique_run(uo, self.spec)
                                       for uo in uos])

    def counts_of(self, state, queries: torch.Tensor) -> torch.Tensor:
        """int64 [N] counts of (N, lanes) int32 keys, 0 where absent."""
        return self.lookup(state, queries)[0]


class CountStore(StoreBase):
    """Fixed-capacity sorted (key -> count) map on one device."""

    def __init__(self, spec: KmerSpec, capacity: int,
                 device: str | torch.device = "cuda"):
        self.spec = spec
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.n_ops = flag_ops(spec)
        self.inv_consts = invalid_constants(spec)
        self.inv_min = self.inv_consts[0]
        # on the device once: a masked fold writes them with no host copy
        self._inv_dev = torch.tensor(self.inv_consts, dtype=torch.int32,
                                     device=self.device)

    def _tail_masked(self, keys, counts, n) -> tuple:
        """Rows >= n of (keys [n_ops, cap], counts [cap]) set to the invalid
        constant and 0.  Each masked column is written straight into its
        row of the new [n_ops, cap] tensor (no stacking copy)."""
        used = torch.arange(self.capacity, device=counts.device) < n
        out = counts.new_empty((self.n_ops, self.capacity),
                               dtype=torch.int32)
        for row, col, const in zip(out, keys, self._inv_dev):
            torch.where(used, col, const, out=row)
        return out, torch.where(used, counts, 0)

    def init_state(self) -> StoreState:
        cap, dev = self.capacity, self.device
        return StoreState(
            keys=self._inv_dev[:, None].expand(self.n_ops, cap).contiguous(),
            counts=torch.zeros(cap, dtype=torch.int64, device=dev),
            n=torch.zeros((), dtype=torch.int64, device=dev),
            overflowed=torch.zeros((), dtype=torch.bool, device=dev),
        )

    def merge(self, state: StoreState, ukeys: torch.Tensor,
              ucounts: torch.Tensor, uvalid: torch.Tensor) -> StoreState:
        """Fold one batch histogram (count_unique's keys [P, lanes],
        counts [P], valid [P]) into the store: merge_stacked of one."""
        return self.merge_stacked(state, ukeys[None], ucounts[None],
                                  uvalid[None])

    def merge_stacked(self, state: StoreState, ukeys: torch.Tensor,
                      ucounts: torch.Tensor, uvalid: torch.Tensor
                      ) -> StoreState:
        """Fold R batch histograms (count_unique outputs stacked:
        ukeys [R, P, lanes], ucounts [R, P], uvalid [R, P]) into the
        store: pack_runs, then merge_runs.  No host synchronisation."""
        return self.merge_runs(state, self.pack_runs(ukeys, ucounts, uvalid))

    def merge_read(self, state: StoreState, uc: UniqueCounts) -> StoreState:
        """Fold one deduplicated row histogram (count_unique) into the
        store."""
        return self.merge_stacked(state, uc.keys[None], uc.counts[None],
                                  uc.valid[None])

    def full_flag(self, state: StoreState) -> torch.Tensor:
        return state.overflowed

    def pack_runs(self, ukeys: torch.Tensor, ucounts: torch.Tensor,
                  uvalid: torch.Tensor) -> list[tuple]:
        """R stacked row histograms as R runs of merge_runs: each one's
        valid prefix is a sorted run; its invalid rows become the invalid
        constant with count 0 (ops/count.py histogram_run)."""
        spec = self.spec
        return [
            histogram_run(pack_flag_key(ukeys[i], ~uvalid[i], spec),
                          ucounts[i], uvalid[i], spec)
            for i in range(ukeys.shape[0])
        ]

    def merge_runs(self, state: StoreState, runs: list[tuple]
                   ) -> StoreState:
        """Fold R ascending runs of (operands..., int32 count), whose
        invalid rows hold the invalid constant with count 0, into the
        store.  A balanced tree of stable merges (kernel 2) joins them,
        then one merge-dedupe (kernel 3) folds them into the store,
        summing the counts of equal keys.  No host synchronisation.
        """
        n_keys = self.n_ops
        while len(runs) > 1:
            nxt = [
                merge_sorted(runs[i], runs[i + 1], n_keys=n_keys)
                for i in range(0, len(runs) - 1, 2)
            ]
            if len(runs) % 2:
                nxt.append(runs[-1])
            runs = nxt
        acc = runs[0][:n_keys] + (runs[0][n_keys].to(torch.int64),)
        return self._fold(state, acc, state.overflowed)

    def absorb(self, state: StoreState, other: StoreState) -> StoreState:
        """Merge another store's contents into this one, summing the counts
        of keys held by both (the LSM cascade step).  `other` may have
        another capacity but holds keys of the same spec.  Its rows already
        form one sorted run with the invalid constant and count 0 past its
        n, so kernel 3 takes it as it is: no merge tree."""
        run = tuple(other.keys.unbind(0)) + (other.counts,)
        return self._fold(state, run, state.overflowed | other.overflowed)

    def _fold(self, state: StoreState, run: tuple,
              overflowed: torch.Tensor) -> StoreState:
        """One merge-dedupe (kernel 3) of the store with a sorted run of
        (operands, int64 count) whose invalid rows hold the invalid
        constant, cut back to capacity with the tail invariant kept."""
        n_keys = self.n_ops
        store_run = tuple(state.keys.unbind(0)) + (state.counts,)
        cols, _, n_valid = merge_dedupe_sorted(
            store_run, run, n_keys=n_keys, inv_min=self.inv_min
        )
        cap = self.capacity
        n_kept = torch.clamp(n_valid, max=cap)
        keys, counts = self._tail_masked(
            [c[:cap] for c in cols[:n_keys]], cols[n_keys][:cap], n_kept
        )
        return StoreState(
            keys=keys,
            counts=counts,
            n=n_kept,
            overflowed=overflowed | (n_valid > cap),
        )

    def lookup(self, state: StoreState, queries: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Binary-search counts for (N, lanes) int32 query keys.
        Returns (counts int64 [N], found bool [N])."""
        cap = self.capacity
        q_ops = pack_flag_key(
            queries, torch.zeros(queries.shape[0], dtype=torch.bool,
                                 device=queries.device), self.spec,
        )
        # keys_less/keys_equal take little-endian lanes: reverse the ops
        q = torch.stack(q_ops[::-1], dim=-1)
        cols = state.keys.unbind(0)[::-1]
        rows = lambda idx: torch.stack([col[idx] for col in cols], dim=-1)
        hi = state.n.expand(queries.shape[0]).clone()
        lo = torch.zeros_like(hi)
        for _ in range(cap.bit_length() + 1):
            active = lo < hi
            mid = (lo + hi) >> 1
            lt = keys_less(rows(mid.clamp(max=cap - 1)), q)
            lo = torch.where(active & lt, mid + 1, lo)
            hi = torch.where(active & ~lt, mid, hi)
        idx = lo.clamp(max=cap - 1)
        found = (lo < state.n) & keys_equal(rows(idx), q)
        return torch.where(found, state.counts[idx], 0), found

    def export(self, state: StoreState
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(keys int32 [n, lanes], counts int64 [n]) of the held keys, in
        the store's order, on the state's device."""
        n = int(state.n)
        keys, _ = unpack_flag_key(list(state.keys[:, :n]), self.spec)
        return keys, state.counts[:n]

    def to_host(self, state: StoreState, key_map=None
                ) -> tuple[np.ndarray, np.ndarray, int]:
        """(keys uint32 [n, lanes], counts int64 [n], n) on the host, in
        the store's order.  key_map: the bijection whose images the store
        holds (ops/mix.py LaneMixBijection); the keys are mapped back on
        the device before the copy."""
        keys, counts = self.export(state)
        n = counts.shape[0]
        if key_map is not None and n:
            keys = key_map.inv_apply(keys)
        return keys.cpu().numpy().view(np.uint32), counts.cpu().numpy(), n

    # --- exchange with the JAX package's StoreState ---

    def state_from_reference(self, ref) -> StoreState:
        """Port state from the JAX package's store state, given as numpy
        arrays (a mapping or an object with fields keys uint32
        [cap, lanes], digits int32 [cap, 3], used bool [cap], n,
        overflowed).  Its used rows must be the prefix [0, n).  The
        arrays are copied to the store's device and converted there."""
        get = ref.__getitem__ if isinstance(ref, Mapping) else (
            lambda f: getattr(ref, f))
        keys, digits, used, n, over = (np.asarray(get(f))
                                       for f in REFERENCE_FIELDS)
        n = int(n)
        cap, lanes = self.capacity, self.spec.lanes
        if keys.shape != (cap, lanes) or digits.shape != (cap, COUNT_DIGITS):
            raise ValueError(
                f"reference state shapes {keys.shape}/{digits.shape} do not "
                f"fit capacity {cap} and {lanes} lanes"
            )
        if not np.array_equal(used, np.arange(cap) < n):
            raise ValueError("reference state: used rows must be [0, n)")
        dev = self.device
        # astype copies: the arrays may be read-only views (np.asarray of
        # a JAX array), which torch.from_numpy refuses to share
        keys = torch.from_numpy(keys.astype(np.uint32).view(np.int32)).to(dev)
        d = torch.from_numpy(digits.astype(np.int64)).to(dev)
        counts = d[:, 0] + (d[:, 1] << COUNT_DIGIT_BITS) + (
            d[:, 2] << 2 * COUNT_DIGIT_BITS)
        invalid = torch.arange(cap, device=dev) >= n
        packed, counts = self._tail_masked(
            torch.stack(pack_flag_key(keys, invalid, self.spec)), counts, n)
        return StoreState(
            keys=packed,
            counts=counts,
            n=torch.tensor(n, dtype=torch.int64, device=dev),
            overflowed=torch.tensor(bool(over), device=dev),
        )

    def state_to_reference(self, state: StoreState) -> dict[str, np.ndarray]:
        """The JAX package's store-state fields, as numpy arrays (converted
        on the state's device, then copied).  Rows past n hold zero keys
        and digits, as the JAX fused merge leaves them."""
        n = int(state.n)
        keys, _ = unpack_flag_key(list(state.keys), self.spec)
        used = torch.arange(self.capacity, device=keys.device) < n
        keys = torch.where(used[:, None], keys, 0)
        c = torch.where(used, state.counts, 0)
        digits = torch.stack([
            c & COUNT_DIGIT_MASK,
            (c >> COUNT_DIGIT_BITS) & COUNT_DIGIT_MASK,
            c >> 2 * COUNT_DIGIT_BITS,
        ], dim=1).to(torch.int32)
        return {
            "keys": keys.cpu().numpy().view(np.uint32),
            "digits": digits.cpu().numpy(),
            "used": used.cpu().numpy(),
            "n": np.int32(n),
            "overflowed": np.bool_(bool(state.overflowed)),
        }
