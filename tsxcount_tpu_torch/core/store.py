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
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from tsxcount_tpu_torch.config import (
    COUNT_DIGIT_BITS,
    COUNT_DIGIT_MASK,
    COUNT_DIGITS,
    KmerSpec,
)
from tsxcount_tpu_torch.ops.count import (
    flag_ops,
    invalid_constants,
    pack_flag_key,
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


class CountStore:
    """Fixed-capacity sorted (key -> count) map on one device."""

    def __init__(self, spec: KmerSpec, capacity: int,
                 device: str | torch.device = "cpu"):
        self.spec = spec
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.n_ops = flag_ops(spec)
        self.inv_consts = invalid_constants(spec)
        self.inv_min = self.inv_consts[0]

    def _tail_masked(self, keys, counts, n) -> tuple:
        """Rows >= n of (keys [n_ops, cap], counts [cap]) set to the invalid
        constant and 0."""
        used = torch.arange(self.capacity, device=counts.device) < n
        keys = torch.stack([
            torch.where(used, col, const)
            for col, const in zip(keys, self.inv_consts)
        ])
        return keys, torch.where(used, counts, 0)

    def init_state(self) -> StoreState:
        cap, dev = self.capacity, self.device
        keys = torch.tensor(self.inv_consts, dtype=torch.int32, device=dev)
        return StoreState(
            keys=keys[:, None].expand(self.n_ops, cap).contiguous(),
            counts=torch.zeros(cap, dtype=torch.int64, device=dev),
            n=torch.zeros((), dtype=torch.int64, device=dev),
            overflowed=torch.zeros((), dtype=torch.bool, device=dev),
        )

    def merge_stacked(self, state: StoreState, ukeys: torch.Tensor,
                      ucounts: torch.Tensor, uvalid: torch.Tensor
                      ) -> StoreState:
        """Fold R batch histograms (count_unique outputs stacked:
        ukeys [R, P, lanes], ucounts [R, P], uvalid [R, P]) into the store.

        Each histogram's valid prefix is a sorted run; invalid rows become
        the invalid constant with count 0 so every run stays ascending.  A
        balanced tree of stable merges (kernel 2) joins the R runs, then
        one merge-dedupe (kernel 3) folds them into the store, summing the
        counts of equal keys.  No host synchronisation.
        """
        spec = self.spec
        runs = []
        for i in range(ukeys.shape[0]):
            ops = pack_flag_key(ukeys[i], ~uvalid[i], spec)
            ops = [
                torch.where(uvalid[i], op, const)
                for op, const in zip(ops, self.inv_consts)
            ]
            cnt = torch.where(uvalid[i], ucounts[i].to(torch.int32), 0)
            runs.append(tuple(ops) + (cnt,))
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
        store_run = tuple(state.keys.unbind(0)) + (state.counts,)
        cols, _, n_valid = merge_dedupe_sorted(
            store_run, acc, n_keys=n_keys, inv_min=self.inv_min
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
            overflowed=state.overflowed | (n_valid > cap),
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

    def to_host(self, state: StoreState
                ) -> tuple[np.ndarray, np.ndarray, int]:
        """(keys uint32 [n, lanes], counts int64 [n], n) on the host."""
        n = int(state.n)
        keys, _ = unpack_flag_key(list(state.keys[:, :n].cpu()), self.spec)
        counts = state.counts[:n].cpu().numpy()
        return keys.numpy().view(np.uint32), counts, n

    # --- exchange with the JAX package's StoreState ---

    def state_from_reference(self, ref) -> StoreState:
        """Port state from the JAX package's store state, given as numpy
        arrays (a mapping or an object with fields keys uint32
        [cap, lanes], digits int32 [cap, 3], used bool [cap], n,
        overflowed).  Its used rows must be the prefix [0, n)."""
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
        d = digits.astype(np.int64)
        counts = d[:, 0] + (d[:, 1] << COUNT_DIGIT_BITS) + (
            d[:, 2] << 2 * COUNT_DIGIT_BITS)
        dev = self.device
        ops = pack_flag_key(
            torch.from_numpy(keys.astype(np.uint32).view(np.int32)),
            torch.from_numpy(~used), self.spec,
        )
        packed, counts_t = self._tail_masked(
            torch.stack(ops), torch.from_numpy(counts), n
        )
        return StoreState(
            keys=packed.to(dev),
            counts=counts_t.to(dev),
            n=torch.tensor(n, dtype=torch.int64, device=dev),
            overflowed=torch.tensor(bool(over), device=dev),
        )

    def state_to_reference(self, state: StoreState) -> dict[str, np.ndarray]:
        """The JAX package's store-state fields, as numpy arrays.  Rows past
        n hold zero keys and digits, as the JAX fused merge leaves them."""
        n = int(state.n)
        cap = self.capacity
        keys, _ = unpack_flag_key(list(state.keys.cpu()), self.spec)
        used = np.arange(cap) < n
        keys = np.where(used[:, None], keys.numpy().view(np.uint32), 0)
        c = np.where(used, state.counts.cpu().numpy(), 0)
        digits = np.stack([
            c & COUNT_DIGIT_MASK,
            (c >> COUNT_DIGIT_BITS) & COUNT_DIGIT_MASK,
            c >> 2 * COUNT_DIGIT_BITS,
        ], axis=1).astype(np.int32)
        return {
            "keys": keys.astype(np.uint32),
            "digits": digits,
            "used": used,
            "n": np.int32(n),
            "overflowed": np.bool_(bool(state.overflowed)),
        }
