"""Quotient/reprobe hash table: the jellyfish-style table backend.

Semantics (the JAX package's `core/table.py`, which mirrors the reference's
TSXHashMap):

  * the slot of reprobe attempt r is (hash mod 2^L + r(r+1)/2) mod 2^L
    (triangular reprobing);
  * a slot stores [func bits | r] where func = hash >> L, so the low L
    hash bits are recoverable from the slot index, and the bijective GF(2)
    hash (ops/gf2.py) makes the whole k-mer recoverable from the table;
  * counts are exact: 3 base-2^20 digits per slot, renormalised after each
    insert.

STATE LAYOUT, kept exactly as in the JAX package so that the two states
compare word for word: one flat int32 array (uint32 bit patterns) in
column-major order.  Column c of slot i is element c * 2^L + i; the columns
are [key lanes | 3 count digits | used flag].

A batch of distinct keys is inserted in reprobe rounds.  A round sorts the
rows by probed slot (stable), reads every active row's slot (kernel 5; the
JAX package gathers at run heads only, as its TPU gather needs distinct
addresses, and fills the value forward), and arbitrates: a row whose key
is in the slot matches, and an empty slot goes to the LAST contender of
its run.  Kernel 4 then adds one combined row per resolved contender into
every column, in one launch per round, and kernel 1 compacts the
unresolved rows to a prefix whose size the host reads to size the next
round.  The narrow tail of an insert (`residue_phase`), where the lowest
original index wins an empty slot as in the JAX package, runs every one of
its rounds in one launch of ops/table_residue.py's kernel on a CUDA state,
with no host sync; a CPU state takes the plain rounds, one host check a
round.

The widths of the rounds are the JAX package's host schedule
(`insert_histogram`): the table, not the counter, decides them, and the
counters reach it through the store interface of core/store.py.  A
counter's dedupe hands the table its batch histogram as rows
(`merge_batches`, `merge_read`) or as runs that may repeat a key, which
the table re-dedupes with their counts as weights first (`merge_runs`,
`merge_stacked`: the sharded counter's).

The slot array is updated IN PLACE by every round, the tail and the
renormalisation: a returned TableState shares the array of the state it
was made from, which is no longer to be used.

Host counts for a counter's stats: `inserts` (batch histograms), `rounds`
(reprobe rounds: the split rounds and plain tail rounds the host counts,
plus the kernel's tail rounds, which it adds into a device counter that
`rounds` reads), `split_rounds` (the split rounds alone) and
`residue_launches` (tails that took the kernel).  While a torch profiler
runs, each split round of `insert_histogram` is a `table_split` span
(utils/profiling.py), nested in the counter's `fold`.
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
from tsxcount_tpu_torch.core.store import StoreBase
from tsxcount_tpu_torch.ops.apply import apply_sorted_unique, gather_sorted
from tsxcount_tpu_torch.ops.compact import compact_flagged
from tsxcount_tpu_torch.ops.count import (
    UniqueCounts,
    count_unique,
    unique_rows,
    unpack_flag_key_cols,
)
from tsxcount_tpu_torch.ops.gf2 import GF2Hash
from tsxcount_tpu_torch.ops.lanes import i32
from tsxcount_tpu_torch.ops.table_residue import (
    bump_hist,
    table_residue,
    table_residue_plain,
    triangular,
)
from tsxcount_tpu_torch.utils.profiling import span

DEAD = 1 << 30  # dst2 of inactive rows: even, past every doubled address
REFERENCE_FIELDS = ("slots", "n", "spilled", "probe_hist")
_RESIDUE_ELEMS = 1 << 18  # w * slot_cols at or below: the tail


class TableState(NamedTuple):
    slots: torch.Tensor       # int32 [cols * slots], column-major
    n: torch.Tensor           # int64 0-d: distinct k-mers
    spilled: torch.Tensor     # int64 0-d: k-mers dropped after max reprobes
    probe_hist: torch.Tensor  # int64 [max_reprobes]: k-mers resolved at r


def _digit_counts(d0, d1, d2) -> torch.Tensor:
    """int64 counts of the three base-2^20 digit columns."""
    return (d0.to(torch.int64) + (d1.to(torch.int64) << COUNT_DIGIT_BITS)
            + (d2.to(torch.int64) << 2 * COUNT_DIGIT_BITS))


class QuotientTable(StoreBase):
    """2^L-slot reprobing table over GF(2)-hashed multi-lane keys."""

    _EXPORT_CHUNK = 1 << 20  # slots per export chunk
    reference_fields = REFERENCE_FIELDS
    FULL = "kmers unresolved after max_reprobes reprobes"

    def __init__(self, spec: KmerSpec, l_bits: int, hash_fn: GF2Hash,
                 max_reprobes: int = 64,
                 device: str | torch.device = "cuda"):
        if not 1 <= l_bits <= 31:
            raise ValueError("l_bits must be in [1, 31]")
        if 2 * spec.k <= l_bits:
            raise ValueError(
                f"2k={2*spec.k} must exceed l={l_bits} (func field would be empty)"
            )
        self.spec = spec
        self.l_bits = l_bits
        self.slots = 1 << l_bits
        self.hash_fn = hash_fn
        self.device = resolve_device(device)
        # the reference's bound is 2^L - 1 reprobes
        self.max_reprobes = min(max_reprobes, self.slots - 1)
        self._low_mask = (1 << l_bits) - 1
        # counts for an owner's stats (the module docstring); init_state
        # restarts them
        self.inserts = self.residue_launches = self._host_rounds = 0
        self.split_rounds = 0
        self._kernel_rounds = torch.zeros((), dtype=torch.int64,
                                          device=self.device)
        # kernels 4 and 5 take a round's columns as separate regions and
        # an int32 doubled SLOT address, which must stay below DEAD (the
        # JAX package's flat element addresses cap 2^L x columns, which
        # refuses the upstream's 2^26 slots at k = 256)
        if 2 * self.slots > DEAD:
            raise ValueError(
                f"table too large: 2^{l_bits} slots exceed the int32 "
                f"doubled slot address (at most 2^29 slots)"
            )

    @property
    def slot_cols(self) -> int:
        """Columns of a slot: key lanes + digits + used."""
        return self.spec.lanes + COUNT_DIGITS + 1

    @property
    def rounds(self) -> int:
        """Reprobe rounds run since init_state (a host read of the kernel's
        device count)."""
        return self._host_rounds + int(self._kernel_rounds)

    def init_state(self) -> TableState:
        """An empty table; the counts restart."""
        self.inserts = self.residue_launches = self._host_rounds = 0
        self.split_rounds = 0
        self._kernel_rounds.zero_()
        dev = self.device
        return TableState(
            slots=torch.zeros(self.slot_cols * self.slots, dtype=torch.int32,
                              device=dev),
            n=torch.zeros((), dtype=torch.int64, device=dev),
            spilled=torch.zeros((), dtype=torch.int64, device=dev),
            probe_hist=torch.zeros(self.max_reprobes, dtype=torch.int64,
                                   device=dev),
        )

    # --- column views (1-D slices of the flat array) -----------------------

    def _col(self, slots_flat: torch.Tensor, c: int) -> torch.Tensor:
        s = self.slots
        return slots_flat[c * s : (c + 1) * s]

    def state_keys(self, state: TableState) -> torch.Tensor:
        """int32 [slots, lanes] slot keys ((func << L) | reprobe)."""
        return torch.stack(
            [self._col(state.slots, j) for j in range(self.spec.lanes)], dim=1
        )

    def state_digits(self, state: TableState) -> torch.Tensor:
        """int32 [slots, 3] count digits."""
        lanes = self.spec.lanes
        return torch.stack(
            [self._col(state.slots, lanes + j) for j in range(COUNT_DIGITS)],
            dim=1,
        )

    def state_used(self, state: TableState) -> torch.Tensor:
        """bool [slots]."""
        return self._col(state.slots, self.slot_cols - 1) != 0

    def renorm(self, state: TableState) -> TableState:
        """Base-2^20 digit renormalisation, in place: carries d0 -> d1 ->
        d2 over the three digit column regions."""
        lanes = self.spec.lanes
        d0 = self._col(state.slots, lanes)
        d1 = self._col(state.slots, lanes + 1)
        d2 = self._col(state.slots, lanes + 2)
        c0 = d0 >> COUNT_DIGIT_BITS
        d0 &= COUNT_DIGIT_MASK
        d1 += c0
        c1 = d1 >> COUNT_DIGIT_BITS
        d1 &= COUNT_DIGIT_MASK
        d2.copy_(i32(d2.to(torch.int64) + c1))  # wraps as the TPU's int32
        return state

    # --- probe-state derivation --------------------------------------------

    def _hash_cols(self, ukeys: torch.Tensor):
        """(pos0 int32 [P], cleared lane columns): cleared is the hash with
        its low L bits zeroed, (func << L); OR-ing the reprobe count into
        lane 0 gives the stored slot key."""
        h = self.hash_fn.apply(ukeys)
        pos0 = h[:, 0] & self._low_mask
        cleared = (h[:, 0] & ~self._low_mask,) + tuple(
            h[:, j].contiguous() for j in range(1, self.spec.lanes)
        )
        return pos0, cleared

    def round0_args(self, ukeys, ucounts, uvalid):
        """(pos0, cleared columns, counts, active) for split_round r=0."""
        pos0, cleared = self._hash_cols(ukeys)
        return pos0, cleared, ucounts.to(torch.int32), uvalid

    # --- the split round ----------------------------------------------------

    def split_round(self, state: TableState, r: int, pos0, cleared, counts,
                    active):
        """One reprobe round at index `r` (see the module docstring).

        cleared: tuple of lane columns.  Returns (state', carry=(pos0_c,
        cleared_c, counts_c, active_c), n_enter, n_left), the carry rows
        compacted so that the active ones are exactly the first n_left.
        """
        self._host_rounds += 1
        self.split_rounds += 1
        s = self.slots
        lanes = self.spec.lanes
        cols = self.slot_cols
        width = pos0.shape[0]
        dev = pos0.device
        pos = (pos0.to(torch.int64) + triangular(r)) % s
        # inactive rows sort last; the sort is stable, as the layout needs
        ckey = torch.where(active, pos, s)
        ckey_s, perm = torch.sort(ckey, stable=True)
        pos0_s, counts_s = pos0[perm], counts[perm]
        cleared_s = tuple(c[perm] for c in cleared)
        active_s = ckey_s < s
        run_end = torch.ones_like(active_s)
        run_end[:-1] = ckey_s[1:] != ckey_s[:-1]
        safe_pos = torch.where(active_s, ckey_s, 0)

        # slot contents (key lanes + used flag): kernel 5 reads every
        # active row's slot (the rows of a run read the same word), every
        # probed column in one launch
        probe_cols = list(range(lanes)) + [cols - 1]
        dstg = torch.where(active_s, (safe_pos << 1) | 1, DEAD).to(torch.int32)
        g_cols, ov = gather_sorted(
            [self._col(state.slots, c) for c in probe_cols], dstg)
        spilled = state.spilled + ov

        used_s = g_cols[-1] != 0
        slotkey0_s = cleared_s[0] | r
        key_eq = g_cols[0] == slotkey0_s
        for j in range(1, lanes):
            key_eq &= g_cols[j] == cleared_s[j]
        match_s = active_s & used_s & key_eq
        winner = active_s & ~used_s & run_end
        resolved = match_s | winner

        # one combined add-row per resolved contender, every column in one
        # launch (kernel 4, in place); the digit-2 column would only add
        # zeros, so it is left out
        val_cols = (
            [torch.where(winner, slotkey0_s, 0)]
            + [torch.where(winner, cleared_s[j], 0) for j in range(1, lanes)]
            + [counts_s & COUNT_DIGIT_MASK,
               (counts_s >> COUNT_DIGIT_BITS) & COUNT_DIGIT_MASK,
               winner.to(torch.int32)]
        )
        dsta = torch.where(
            active_s,
            torch.where(resolved, (safe_pos << 1) | 1, safe_pos << 1),
            DEAD,
        ).to(torch.int32)
        _, ov = apply_sorted_unique(
            [self._col(state.slots, c) for c in range(cols) if c != lanes + 2],
            dsta, [v.contiguous() for v in val_cols])
        spilled = spilled + ov

        new_state = TableState(
            slots=state.slots,
            n=state.n + winner.sum(),
            spilled=spilled,
            probe_hist=bump_hist(state.probe_hist, r, resolved.sum()),
        )

        # compact the surviving rows to an exact prefix (kernel 1)
        active_next = active_s & ~resolved
        n_left = active_next.sum()
        comp = compact_flagged(active_next, (pos0_s, counts_s) + cleared_s)
        active_c = torch.arange(width, device=dev) < n_left
        carry = (comp[0], tuple(comp[2:]), comp[1], active_c)
        return new_state, carry, active.sum(), n_left

    def residue_phase(self, state: TableState, carry, r_start: int,
                      width2: int) -> TableState:
        """Finish an insert from the compacted carry (pos0, cleared lane
        columns, counts, active) at width `width2`, then renormalise: the
        rounds from r_start (ops/table_residue.py), where an empty slot
        goes to the lowest original index among its contenders.  Rows
        active beyond width2 are counted spilled, which cannot happen when
        width2 covers the round's n_left.  A CUDA state takes the kernel
        (one launch, no host sync), a CPU state the plain rounds (one host
        check a round)."""
        args = (state.slots, self.slots, carry, r_start, width2,
                self.max_reprobes, state.n, state.spilled, state.probe_hist)
        if state.slots.is_cuda:
            self.residue_launches += 1
            n, spilled, hist = table_residue(*args, self._kernel_rounds)
        else:
            n, spilled, hist, rounds = table_residue_plain(*args)
            self._host_rounds += rounds
        return self.renorm(TableState(slots=state.slots, n=n,
                                      spilled=spilled, probe_hist=hist))

    def insert_histogram(self, state: TableState, uc: UniqueCounts
                         ) -> TableState:
        """Insert a batch histogram (keys unique where valid) with the JAX
        package's host schedule, which decides which arbitration each row
        meets and so the table's layout: round 0 at the narrowest of P/4,
        P/2 (at least 256) that holds the batch's distinct keys, else P;
        each later round at the next power of two >= the rows left (at
        least 256); the plain tail once w * slot_cols <= 2^18 or from
        round 6 on.  One host read of the distinct count and one of each
        round's rows left, each a `sync` span; each split round a
        `table_split` span."""
        self.inserts += 1
        p = uc.keys.shape[0]
        with span("sync"):
            n = int(uc.n_unique)
        width = p
        for w in (p // 4, p // 2):
            if 256 <= w and n <= w:
                width = w
                break
        with span("table_split"):  # round 0 with its keys' hash
            st, carry, _, n_left = self.split_round(
                state, 0, *self.round0_args(
                    uc.keys[:width], uc.counts[:width], uc.valid[:width]))
        r = 1
        while True:
            with span("sync"):
                f = int(n_left)
            if f == 0:
                return self.renorm(st)
            w = min(width, max(256, 1 << (f - 1).bit_length()))
            # the carry's rows past n_left <= w are inactive: cut to w
            p0, cl, c, a = carry
            carry = (p0[:w], tuple(x[:w] for x in cl), c[:w], a[:w])
            if w * self.slot_cols <= _RESIDUE_ELEMS or r >= 6:
                return self.residue_phase(st, carry, r, w)
            with span("table_split"):
                st, carry, _, n_left = self.split_round(st, r, *carry)
            r += 1

    merge_read = insert_histogram

    def merge_batches(self, state: TableState, uos: list) -> TableState:
        """Insert the one batch histogram of count_unique_ops (the table's
        counters fold every batch) from its key rows."""
        (uo,) = uos
        return self.insert_histogram(state, unique_rows(uo, self.spec))

    def merge_runs(self, state: TableState, runs: list[tuple]
                   ) -> TableState:
        """Insert the one-shard hand-off's one run (operands..., counts):
        re-deduped with its counts as weights, from its operand columns."""
        (run,) = runs
        cols, invalid = unpack_flag_key_cols(run[:-1], self.spec)
        return self.insert_histogram(
            state, count_unique(cols, ~invalid, self.spec, weights=run[-1]))

    def merge_stacked(self, state: TableState, ukeys: torch.Tensor,
                      ucounts: torch.Tensor, uvalid: torch.Tensor
                      ) -> TableState:
        """Insert R stacked runs of rows ([R, P, lanes], [R, P], [R, P]),
        which may hold a key more than once: re-deduped with their counts
        as weights."""
        return self.insert_histogram(state, count_unique(
            ukeys.reshape(-1, self.spec.lanes), uvalid.reshape(-1),
            self.spec, weights=ucounts.reshape(-1)))

    def full_flag(self, state: TableState) -> torch.Tensor:
        """The k-mers spilled past max_reprobes (nonzero: full)."""
        return state.spilled

    def insert(self, state: TableState, ukeys: torch.Tensor,
               ucounts: torch.Tensor, uvalid: torch.Tensor) -> TableState:
        """Insert a deduplicated batch histogram (keys unique where uvalid)
        through the tail's rounds from round 0 at the batch's width
        (residue_phase).  The counters use the host-driven split rounds
        first (insert_histogram)."""
        pos0, cleared = self._hash_cols(ukeys)
        carry = (pos0, cleared, ucounts.to(torch.int32).contiguous(),
                 uvalid.contiguous())
        return self.residue_phase(state, carry, 0, ukeys.shape[0])

    # --- queries -----------------------------------------------------------

    def _probe(self, state: TableState, queries: torch.Tensor, on_match):
        """Walk each query's probe sequence until it matches, meets an empty
        slot (slots are never freed, so that proves absence) or runs out of
        reprobes; on_match(match, r, pos) is called once per round."""
        lanes = self.spec.lanes
        cols = self.slot_cols
        s = self.slots
        pos0, cleared = self._hash_cols(queries)
        pos0 = pos0.to(torch.int64)
        active = torch.ones(queries.shape[0], dtype=torch.bool,
                            device=queries.device)
        found = torch.zeros_like(active)
        r = 0
        while r < self.max_reprobes and bool(active.any()):
            pos = (pos0 + triangular(r)) % s
            used_g = state.slots[(cols - 1) * s + pos] != 0
            key_eq = state.slots[pos] == (cleared[0] | r)
            for j in range(1, lanes):
                key_eq &= state.slots[j * s + pos] == cleared[j]
            match = active & used_g & key_eq
            on_match(match, r, pos)
            found |= match
            active &= used_g & ~match
            r += 1
        return found

    def lookup(self, state: TableState, queries: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Probe-walk lookup of (N, lanes) int32 keys.  Returns (digits
        int32 [N, 3], found bool [N])."""
        s = self.slots
        lanes = self.spec.lanes
        out = torch.zeros((queries.shape[0], COUNT_DIGITS), dtype=torch.int32,
                          device=queries.device)

        def take(match, r, pos):
            digits = torch.stack(
                [state.slots[(lanes + j) * s + pos]
                 for j in range(COUNT_DIGITS)], dim=1)
            out.copy_(torch.where(match[:, None], digits, out))

        found = self._probe(state, queries, take)
        return out, found

    def counts_of(self, state: TableState, queries: torch.Tensor
                  ) -> torch.Tensor:
        """int64 [N] counts of (N, lanes) int32 keys, 0 where absent: the
        digits combined on the device."""
        digits, found = self.lookup(state, queries)
        return torch.where(found, _digit_counts(*digits.unbind(1)), 0)

    def get_positions(self, state: TableState, queries: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Debug API: the slot and reprobe count where each query resides.
        Returns (pos int32 [N], reprobe int32 [N], found bool [N]); pos and
        reprobe are -1 when absent."""
        n_q = queries.shape[0]
        out_pos = torch.full((n_q,), -1, dtype=torch.int64,
                             device=queries.device)
        out_r = torch.full_like(out_pos, -1)

        def take(match, r, pos):
            out_pos.copy_(torch.where(match, pos, out_pos))
            out_r.masked_fill_(match, r)

        found = self._probe(state, queries, take)
        return out_pos.to(torch.int32), out_r.to(torch.int32), found

    def _unhash(self, state: TableState, slot_idx: torch.Tensor
                ) -> torch.Tensor:
        """k-mers (int32 [N, lanes]) stored at slots `slot_idx`: the missing
        low L hash bits of slot i holding (func << L) | r are
        (i - r(r+1)/2) mod 2^L."""
        key0 = self._col(state.slots, 0)[slot_idx]
        r = (key0 & self._low_mask).to(torch.int64)
        missing = (slot_idx - triangular(r)) % self.slots
        hashed = torch.stack(
            [(key0 & ~self._low_mask) | missing.to(torch.int32)]
            + [self._col(state.slots, j)[slot_idx]
               for j in range(1, self.spec.lanes)],
            dim=1,
        )
        return self.hash_fn.inv_apply(hashed)

    def reconstruct_all(self, state: TableState
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """Rebuild every slot's k-mer (debug path; the export works in
        chunks of used slots).  Returns (kmers int32 [slots, lanes], used
        bool [slots])."""
        i = torch.arange(self.slots, device=state.slots.device)
        return self._unhash(state, i), self.state_used(state)

    def export(self, state: TableState, device=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(kmers int32 [n, lanes], counts int64 [n]) of the used slots in
        slot order, reconstructed one chunk of slots at a time (device work
        in proportion to the used slots), each chunk moved to `device`
        (default: the state's)."""
        lanes = self.spec.lanes
        used_col = self._col(state.slots, self.slot_cols - 1)
        kmer_parts, count_parts = [], []
        for start in range(0, self.slots, self._EXPORT_CHUNK):
            used = used_col[start : start + self._EXPORT_CHUNK] != 0
            idx = torch.nonzero(used).squeeze(1) + start
            if idx.numel() == 0:
                continue
            d = [self._col(state.slots, lanes + j)[idx]
                 for j in range(COUNT_DIGITS)]
            kmer_parts.append(self._unhash(state, idx).to(device))
            count_parts.append(_digit_counts(*d).to(device))
        if not kmer_parts:
            dev = device if device is not None else state.slots.device
            return (torch.zeros((0, lanes), dtype=torch.int32, device=dev),
                    torch.zeros(0, dtype=torch.int64, device=dev))
        return torch.cat(kmer_parts), torch.cat(count_parts)

    def to_host(self, state: TableState, key_map=None
                ) -> tuple[np.ndarray, np.ndarray, int]:
        """(kmer keys uint32 [n, lanes], counts int64 [n], n), used slots
        in slot order (`export`, each chunk copied to the host as it is
        made).  key_map: as CountStore's (the table's own hash is undone
        by the export already)."""
        kmers, counts = self.export(state, device="cpu")
        if key_map is not None and len(counts):
            kmers = key_map.inv_apply(kmers)
        return kmers.numpy().view(np.uint32), counts.numpy(), len(counts)

    def fill_factor(self, state: TableState) -> float:
        """Occupancy ratio."""
        return int(state.n) / self.slots

    def state_stats(self, state: TableState) -> dict:
        """Occupancy, spilled k-mers and the reprobe-depth histogram
        (trailing zeros trimmed)."""
        hist = state.probe_hist.cpu().tolist()
        while hist and hist[-1] == 0:
            hist.pop()
        return {"fill_factor": self.fill_factor(state),
                "spilled": int(state.spilled), "probe_histogram": hist}

    # --- exchange with the JAX package's TableState ---

    def state_from_reference(self, ref) -> TableState:
        """Port state from the JAX package's table state, given as numpy
        arrays (a mapping or an object with fields slots uint32
        [cols * slots], n, spilled, probe_hist [max_reprobes])."""
        get = ref.__getitem__ if isinstance(ref, Mapping) else (
            lambda f: getattr(ref, f))
        slots, n, spilled, hist = (np.asarray(get(f))
                                   for f in REFERENCE_FIELDS)
        if slots.shape != (self.slot_cols * self.slots,) or hist.shape != (
                self.max_reprobes,):
            raise ValueError(
                f"reference table shapes {slots.shape}/{hist.shape} do not "
                f"fit 2^{self.l_bits} slots x {self.slot_cols} columns and "
                f"{self.max_reprobes} reprobes"
            )
        dev = self.device
        return TableState(
            slots=torch.from_numpy(
                slots.astype(np.uint32).view(np.int32)).to(dev),
            n=torch.tensor(int(n), dtype=torch.int64, device=dev),
            spilled=torch.tensor(int(spilled), dtype=torch.int64, device=dev),
            probe_hist=torch.from_numpy(hist.astype(np.int64)).to(dev),
        )

    @staticmethod
    def state_to_reference(state: TableState) -> dict[str, np.ndarray]:
        """The JAX package's table-state fields, as numpy arrays."""
        return {
            "slots": state.slots.cpu().numpy().view(np.uint32),
            "n": np.int32(int(state.n)),
            "spilled": np.int32(int(state.spilled)),
            "probe_hist": state.probe_hist.cpu().numpy().astype(np.int32),
        }
