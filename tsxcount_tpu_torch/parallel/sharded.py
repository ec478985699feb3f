"""Sharded counting: hash-prefix routing over all_to_all, one shard a rank.

The port of `tsxcount_tpu/parallel/sharded.py`.  Each rank of the shard
group (parallel/mesh.py) owns one disjoint range of the hashed key space
and holds that shard's store on its own device.  A step takes one packed
batch on every rank:

  * extract the windows, fold them to canonical if asked, and map them
    through the routing bijection (`routing_hash`: the lane mix,
    ops/mix.py, one kernel; or the seeded GF(2) matrix, ops/gf2.py, a
    float32 matmul on bit planes) BEFORE the dedupe, so that the dedupe
    sort (kernel 1 compacts its runs) orders the rows by hashed key: the
    owner of a row, a range partition of the top hash bits
    (`owner_of_hash`), is then a prefix structure of the sorted rows, and
    each destination's rows are one contiguous slice;
  * cut `route_cap` rows a destination (one gather of [n, route_cap]
    rows) and exchange keys, counts and lengths with one
    `all_to_all_single` each (int32 words; equal splits);
  * keep the received runs, and every `merge_every` steps fold them into
    the shard's store with `merge_stacked`: kernels 2 and 3 into the flat
    store or the LSM's L0 (core/lsm.py; absorbs: kernel 3), or the
    table's weighted re-dedupe of the runs and an insert in split rounds
    (kernels 5, 4 and 1).

Which module decides what: this counter decides the backend once, in its
constructor, when it builds the shard's store, and owns the routing, the
spill carry and the collectives (`_sum`, `_max`, `_gather_rows`,
`_exchange`: each the identity at one shard with no group).  The store
(core/store.py's interface) decides how a fold runs, what reads see and
what "full" means; the user surface (reads, check, stats, the recount
after a prefix collision) is core/counter.py's BaseCounter.

At one shard with no spill carry the route is the identity, and a step
takes the one-shard hand-off instead: the dedupe's compacted operand
columns (ops/count.py `count_unique_ops`) become the store merge's run
as they are (`histogram_run`, one masked pass), with no [P, lanes] rows,
padding, slice gather or exchange; `merge_runs` folds the runs, and the
table re-dedupes its one run from the same columns.  `stats()`
counts those steps (`route_direct_batches`).

Rows past `route_cap` of a destination are appended to a per-destination
spill carry, exchanged and folded at the next `flush`; rows past the
carry too are counted as hard spill.  The hard spill and the dedupe's
prefix-collision flag accumulate on the device and are summed over the
ranks once, at `finish`, so that every rank raises the same error at the
same point (the JAX package keeps one health vector a step).

Every read (distinct, get_counts, items, stats, a checkpoint) is a
collective: every rank calls it at the same point with the same
arguments.  Ingest is one too: `count_file` and `add_reads` run their
steps in rounds whose length is agreed by one all_reduce(MAX), ranks
short of batches stepping empty ones (parallel/distributed.py), so no
rank waits in a collective that another never enters.

Stores hold HASHED keys (the bijective image) at n_shards > 1, on the
table backend at any n_shards, and from 8 lanes up under the lane mix;
queries are hashed on the way in and exports mapped back on the way out.
A single sort shard otherwise stores raw keys and counts what
`KmerCounter` counts.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from tsxcount_tpu_torch.config import BatchSpec, KmerSpec, route_capacity
from tsxcount_tpu_torch.core.counter import MODE_TO_BACKEND, BaseCounter
from tsxcount_tpu_torch.core.lsm import LSMStore
from tsxcount_tpu_torch.core.store import CountStore
from tsxcount_tpu_torch.core.table import QuotientTable
from tsxcount_tpu_torch.io.packer import PackedBatch, PackStats
from tsxcount_tpu_torch.ops.canonical import canonicalize, canonicalize_cols
from tsxcount_tpu_torch.ops.count import (
    count_unique,
    count_unique_ops,
    unique_run,
)
from tsxcount_tpu_torch.ops.gf2 import DEFAULT_SEED, GF2Hash
from tsxcount_tpu_torch.ops.mix import LaneMixBijection
from tsxcount_tpu_torch.ops.window import extract_kmer_cols, intervals_to_valid
from tsxcount_tpu_torch.parallel.mesh import init_shard_group
from tsxcount_tpu_torch.utils.profiling import span
from tsxcount_tpu_torch.utils.sequence import strings_to_kmers

_STATS_FIELDS = ("reads", "reads_skipped", "bases", "n_bases", "windows",
                 "batches")


def owner_of_hash(top: torch.Tensor, spec: KmerSpec, n_shards: int
                  ) -> torch.Tensor:
    """Owner shard (int64) of each hashed key, from its top lane (int32
    bit patterns): a balanced range partition of the top 16 hash bits,
    monotone in the lane, for any n_shards."""
    b = min(16, spec.top_lane_bits)
    bucket = (top.to(torch.int64) & 0xFFFFFFFF) >> (spec.top_lane_bits - b)
    return (bucket * n_shards) >> b


def _owner_starts(owner_eff: torch.Tensor, n_shards: int) -> torch.Tensor:
    """starts[o] = first index with owner_eff >= o, for o in [0, n_shards]
    (int64 [n_shards + 1]); owner_eff is nondecreasing."""
    targets = torch.arange(n_shards + 1, dtype=owner_eff.dtype,
                           device=owner_eff.device)
    return torch.searchsorted(owner_eff, targets)


class ShardedKmerCounter(BaseCounter):
    """KmerCounter-compatible API over a group of n_shards ranks, this
    process holding shard `rank`.  The keywords are the JAX package's, in
    its order; `device` (default: the rank's own card) takes the place of
    `devices`, and `dist_backend` picks the process group's backend
    ("nccl" on the card by default, "gloo" with device="cpu"; one shard
    with no group joins none, parallel/mesh.py)."""

    def __init__(
        self,
        k: int,
        n_shards: int,
        l: int = 26,
        s: int = 4,
        backend: str = "sort",
        batch_words: int = 1 << 16,
        n_policy: str = "drop",
        hash_seed: int = DEFAULT_SEED,
        identity_hash: bool = False,
        capacity_factor: float = 2.0,
        seed: int = 0,
        device: str | torch.device | None = None,
        max_reprobes: int = 64,
        canonical: bool = False,
        merge_every: int = 4,
        lsm: bool | None = None,
        lsm_growth: int = 8,
        threads: int = 0,
        prefetch_depth: int = 3,
        read_len_hint: int = 0,
        collapse_homopolymers: bool = False,
        progress_every: int = 0,
        routing_hash: str = "mix",
        dist_backend: str | None = None,
    ):
        backend = MODE_TO_BACKEND.get(backend, backend)
        if backend not in ("sort", "table"):
            raise ValueError(f"unknown backend {backend}")
        if routing_hash not in ("mix", "gf2"):
            raise ValueError("routing_hash must be 'mix' or 'gf2'")
        if lsm_growth < 2:
            raise ValueError("lsm_growth must be >= 2")
        self.group = init_shard_group(n_shards, device, dist_backend)
        self.device = self.group.device
        self.rank = self.group.rank
        self.progress_every = max(0, progress_every)
        self.threads = max(1, threads)
        self.prefetch_depth = max(1, prefetch_depth)
        self.spec = KmerSpec(k)
        self._auto_hint = read_len_hint == 0
        self.batch = BatchSpec(self.spec, batch_words, read_len_hint or 384)
        self.l = l
        self.s = s
        self.backend = backend
        self.n_shards = n_shards
        self.n_policy = n_policy
        self.seed = seed
        self.canonical = canonical
        self.collapse_hp = collapse_homopolymers
        # the routing bijection: the lane mix, or the seeded GF(2) matrix
        # (what files written before the mix hold); identity_hash forces
        # GF(2) with the identity matrix, whose image is the raw key
        self.hash_fn = GF2Hash(self.spec, seed=hash_seed,
                               identity=identity_hash)
        if identity_hash:
            routing_hash = "gf2"
        self.routing_hash = routing_hash
        self.route_map = (LaneMixBijection(self.spec)
                          if routing_hash == "mix" else self.hash_fn)
        # one sort shard below 8 lanes stores raw keys (every row is its
        # own); the table's slot addressing needs uniform low bits, and
        # from 8 lanes the mix image's prefix sort beats the full one
        self.hashed_store = (n_shards > 1 or backend == "table"
                             or (routing_hash == "mix"
                                 and self.spec.lanes >= 8))
        self.merge_every = max(1, merge_every) if backend == "sort" else 1
        l_local = max(1, l - max(0, n_shards.bit_length() - 1))
        cap_per_shard = max(1, (1 << l) // n_shards)
        self.capacity_factor = capacity_factor
        self.route_cap, align = route_capacity(self.batch.positions,
                                               n_shards, capacity_factor)
        # a batch can overflow a destination: its sorted tail past
        # route_cap goes to the spill carry, folded at the next flush
        self._carry_enabled = self.route_cap < self.batch.positions
        # one shard and no carry: the route is the identity, so a batch's
        # histogram goes to the fold as it leaves the dedupe
        self._direct_route = n_shards == 1 and not self._carry_enabled
        self.lsm = False
        self.lsm_growth = lsm_growth
        if backend == "sort":
            flush_rows = self.merge_every * n_shards * self.route_cap
            auto = (cap_per_shard * (lsm_growth - 1)
                    > lsm_growth ** 2 * flush_rows)
            if ((auto if lsm is None else lsm)
                    and cap_per_shard > flush_rows * lsm_growth):
                # the JAX package's sharded cascade: L0 one flush rounded
                # up to the routing alignment
                self.store = LSMStore(self.spec, cap_per_shard, flush_rows,
                                      lsm_growth, self.device, align=align)
                self.lsm = True
            else:
                self.store = CountStore(self.spec, cap_per_shard,
                                        self.device)
        else:
            # the stream is hashed already: the shard table runs an
            # identity mapping, and its export maps back through route_map
            self.store = self.table = QuotientTable(
                self.spec, l_local, GF2Hash(self.spec, identity=True),
                max_reprobes=max_reprobes, device=self.device)
        self._mix_full_sort = False  # set after a detected collision
        self._empty = None  # (batch spec, device buffer of an empty batch)
        self.reset()

    # --- state ---

    def _init_carry(self):
        """Zeroed spill carry (keys, counts, rows used) a destination, or
        None where a batch cannot overflow one."""
        if not self._carry_enabled:
            return None
        n, lanes, dev = self.n_shards, self.spec.lanes, self.device
        rows = 2 * self.route_cap
        return (torch.zeros((n, rows, lanes), dtype=torch.int32, device=dev),
                torch.zeros((n, rows), dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev))

    def reset(self) -> None:
        """Clear all counts and ingest stats (every rank together)."""
        super().reset()
        self._carry = self._init_carry()
        self._spill_recovered = 0
        self._route_direct_batches = 0  # this rank's one-shard hand-offs
        self._pending: list[PackedBatch] = []

    # --- collectives (local where one shard runs with no group) ---

    def _sum(self, values) -> list[int]:
        """Element-wise sum over the ranks of a list of ints (or an int64
        tensor on this rank's device)."""
        t = torch.as_tensor(values, dtype=torch.int64, device=self.device)
        if self.group.joined:
            # a copy: the all_reduce works in place (values may be a view
            # of the state)
            t = t.clone()
            dist.all_reduce(t)
        return super()._sum(t)

    def _max(self, value: int) -> int:
        if not self.group.joined:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        with span("sync"):
            return int(t.item())

    def _exchange(self, t: torch.Tensor) -> torch.Tensor:
        """Block o of t's leading axis to rank o; block j of the result
        came from rank j."""
        if not self.group.joined:
            return t
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous())
        return out

    def _gather_rows(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's t (rows of any number, the other axes equal), in
        rank order, on every rank: the lengths first, then rows padded to
        the longest."""
        if not self.group.joined:
            return [t]
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=self.device)
        lens = [torch.empty_like(n) for _ in range(self.n_shards)]
        dist.all_gather(lens, n)
        lens = [int(x) for x in lens]
        width = max(lens)
        pad = t.new_zeros((width,) + tuple(t.shape[1:]))
        pad[: t.shape[0]] = t
        out = [torch.empty_like(pad) for _ in range(self.n_shards)]
        dist.all_gather(out, pad)
        return [o[:m] for o, m in zip(out, lens)]

    def _global_stats(self) -> PackStats:
        """Ingest stats summed over the ranks (each packs only its share
        of the input).  Collective."""
        st = self.packer.stats
        if not self.group.joined:
            return st
        tot = self._sum([getattr(st, f) for f in _STATS_FIELDS]
                        + list(st.hp_bonus)
                        + [st.hp_collapsed_bases, st.packed_words])
        return PackStats(**dict(zip(_STATS_FIELDS, tot[:6])),
                         hp_bonus=tuple(tot[6:10]),
                         hp_collapsed_bases=tot[10], packed_words=tot[11])

    # the read-time homopolymer bonus owed by the whole stream
    _hp_stats = _global_stats

    # --- the routing step ---

    def _empty_buf(self) -> torch.Tensor:
        """The device buffer of an empty batch, which a rank short of
        batches steps in a round."""
        if self._empty is None or self._empty[0] != self.batch:
            self._empty = (self.batch,
                           self._put(PackedBatch.empty(self.batch)))
        return self._empty[1]

    @property
    def _prefix_sort(self) -> bool:
        """The dedupe sorts on the hashed keys' uniform prefix; the
        identity image is the raw key: not uniform, full sort."""
        return (self.hashed_store and not self._mix_full_sort
                and not self.hash_fn.identity)

    def _batch_keys(self, buf: torch.Tensor) -> tuple:
        """extract -> (canonical) -> hash: the batch's keys (lane columns,
        or rows from the GF(2) product) and their validity."""
        batch, spec = self.batch, self.spec
        keys = extract_kmer_cols(buf[: batch.total_words], batch)
        if self.canonical:  # before the hash, as in the JAX package
            keys = canonicalize_cols(keys, spec)
        if self.hashed_store and self.routing_hash == "mix":
            keys = self.route_map.apply_cols(keys)
        elif self.hashed_store:  # the GF(2) product takes stacked rows
            keys = self.route_map.apply(torch.stack(keys, dim=-1))
        return keys, intervals_to_valid(buf[batch.total_words :], batch)

    def _route_direct(self, buf: torch.Tensor) -> tuple:
        """One batch where the route is the identity (one shard, no
        carry): extract -> (canonical) -> hash -> dedupe, and kernel 1's
        operand columns masked into one run of the store merge.  Returns
        that run (operands..., int32 counts)."""
        uo = count_unique_ops(*self._batch_keys(buf), self.spec,
                              uniform_prefix=self._prefix_sort)
        if uo.collided is not None:
            self._health[1] += uo.collided.to(torch.int64)
        self._route_direct_batches += 1
        return unique_run(uo, self.spec)

    def _route(self, buf: torch.Tensor):
        """One batch: extract -> (canonical) -> hash -> dedupe -> slices
        -> spill carry -> exchange.  Returns this rank's received runs
        (keys [n, route_cap, lanes], counts [n, route_cap], lens [n])."""
        spec = self.spec
        n, cap, lanes = self.n_shards, self.route_cap, spec.lanes
        dev = buf.device
        uc = count_unique(*self._batch_keys(buf), spec,
                          uniform_prefix=self._prefix_sort)
        owner = owner_of_hash(uc.keys[:, -1], spec, n)
        starts = _owner_starts(torch.where(uc.valid, owner, n), n)
        lens = starts[1:] - starts[:-1]
        # each destination's rows are one slice of the sorted rows; the
        # padding keeps every slice (and the spill tail) in bounds
        pad = cap * (2 if self._carry_enabled else 1)
        keys_pad = torch.cat([uc.keys, uc.keys.new_zeros(pad, lanes)])
        counts_pad = torch.cat([uc.counts, uc.counts.new_zeros(pad)])
        rows = starts[:n, None] + torch.arange(cap, device=dev)
        send_keys, send_counts = keys_pad[rows], counts_pad[rows]
        spill = (lens - cap).clamp(min=0)
        if self._carry_enabled:
            # append each destination's tail [starts+cap, starts+lens) at
            # its carry's row cl; an append that would not fit whole
            # captures nothing and counts as hard spill (finish raises)
            ck, cc, cl = self._carry
            room = ck.shape[1] - cap
            clobber = cl > room
            off = cl.clamp(max=room).to(torch.int64)
            captured = torch.where(clobber, 0, spill.clamp(max=cap))
            ar = torch.arange(cap, device=dev)
            tail = starts[:n, None] + cap + ar
            dst = (torch.arange(n, device=dev)[:, None], off[:, None] + ar)
            ck[dst] = keys_pad[tail]
            cc[dst] = counts_pad[tail]
            cl += captured.to(torch.int32)
            spill = spill - captured
        self._health[0] += spill.sum()
        if uc.collided is not None:
            self._health[1] += uc.collided.to(torch.int64)
        send_lens = lens.clamp(max=cap).to(torch.int32)
        return (self._exchange(send_keys), self._exchange(send_counts),
                self._exchange(send_lens))

    def _step_buf(self, buf: torch.Tensor) -> None:
        """Route one batch (every rank steps together) and fold the
        received runs every merge_every steps."""
        route = self._route_direct if self._direct_route else self._route
        with span("step"):
            self._to_fold.append(route(buf))
        self.batches_processed += self.n_shards
        self._maybe_progress(getattr(self, "_live_stats_fn", None))
        if len(self._to_fold) >= self.merge_every:
            self._flush_merges()

    # --- folding into the shard store ---

    def _flush_merges(self, force: bool = False) -> None:
        pend = self._to_fold
        if not pend or (len(pend) < self.merge_every and not force):
            return
        self._to_fold = []
        with span("fold"):
            if self._direct_route:  # the hand-off's runs, as they are
                self.state = self.store.merge_runs(self.state, pend)
                return
            keys = torch.cat([p[0] for p in pend])      # [R*n, cap, lanes]
            counts = torch.cat([p[1] for p in pend])    # [R*n, cap]
            lens = torch.cat([p[2] for p in pend])      # [R*n]
            valid = (torch.arange(self.route_cap, device=self.device)
                     < lens[:, None])
            self.state = self.store.merge_stacked(self.state, keys, counts,
                                                  valid)

    def _recover_spill(self) -> None:
        """Exchange the spill carry as a step exchanges its slices,
        re-dedupe the received rows with their counts as weights (tails of
        different batches are sorted each, not together) and fold them
        into the read state; then clear the carry.  Collective."""
        with span("fold"):
            ck, cc, cl = self._carry
            rk, rc, rl = map(self._exchange, (ck, cc, cl))
            valid = (torch.arange(ck.shape[1], device=self.device)
                     < rl[:, None])
            lanes = self.spec.lanes
            uc = count_unique(rk.reshape(-1, lanes), valid.reshape(-1),
                              self.spec, weights=rc.reshape(-1))
            self.state = self.store.merge_read(self.state, uc)
            self._carry = self._init_carry()

    # --- ingestion ---

    def _dispatch_pending(self, force: bool = False) -> None:
        """Step the packed batches.  One rank steps each batch as it
        comes; several step them in one round (parallel/distributed.py
        `run_round`) when forced, at the end of add_reads and at flush."""
        from tsxcount_tpu_torch.parallel.distributed import run_round

        if self.n_shards > 1 and not force:
            return
        if self.n_shards == 1 and not self._pending:
            return
        # several ranks: a rank with nothing to step still joins the round
        t0 = time.perf_counter()
        pend, self._pending = self._pending, []
        run_round(self, pend, self._put)
        self.elapsed += time.perf_counter() - t0

    def add_reads(self, reads: Iterable[str | bytes]) -> None:
        """Pack and count this rank's reads.  With several ranks this is a
        collective: every rank calls it (a rank without reads with an
        empty iterable), and the steps run in one round at its end."""
        for seq in self._hinted(reads):
            self._pending.extend(self.packer.feed(seq))
            if self.n_shards == 1:
                self._dispatch_pending()
        self._dispatch_pending(force=True)

    def flush(self) -> None:
        """Count the last partial batch, fold every pending run and the
        spill carry into the stores (before a checkpoint; finish adds the
        capacity checks).  Collective."""
        self._pending.extend(self.packer.finish())
        self._dispatch_pending(force=True)
        self._flush_merges(force=True)
        if self._carry_enabled:
            carry_n = self._sum(self._carry[2].sum().reshape(1))[0]
            if carry_n:
                self._recover_spill()
                self._spill_recovered += carry_n

    def _count_file(self, path: str | Path,
                    use_native: bool | None) -> None:
        """This rank's share of the file (parallel/distributed.py)."""
        from tsxcount_tpu_torch.parallel.distributed import (
            count_file_distributed,
        )

        count_file_distributed(self, path, use_native=use_native)

    # --- reads (BaseCounter's; collectives) ---

    def _prepare(self) -> None:
        """Fold the pending runs, then absorb every LSM level into the top
        one (reads see one store); the cascade restarts, as the JAX
        sharded counter's does."""
        self._flush_merges(force=True)
        self.state = self.store.collapse(self.state)
        self.store.reset_schedule()

    def _query_keys(self, kmers: list[str]) -> torch.Tensor:
        """The stored form of the query k-mers on this rank's device; each
        rank looks them up in its shard, and `_sum` joins the answers."""
        self._prepare()
        keys = torch.from_numpy(
            strings_to_kmers(kmers, self.spec).view(np.int32)).to(self.device)
        if self.canonical:
            keys = canonicalize(keys, self.spec)
        if self.hashed_store:
            keys = self.route_map.apply(keys)
        return keys

    def _shard_export(self) -> tuple[torch.Tensor, torch.Tensor]:
        """This shard's (stored keys int32 [n, lanes], counts int64 [n])
        on its device: hashed keys where the store holds images."""
        return self.store.export(self.state)

    def _export_parts(self) -> Iterator[tuple]:
        """Each shard's rows, gathered to every rank and mapped back
        through the routing bijection on the device."""
        keys, counts = self._shard_export()
        for k_sh, c_sh in zip(self._gather_rows(keys),
                              self._gather_rows(counts)):
            if self.hashed_store and k_sh.shape[0]:
                k_sh = self.route_map.inv_apply(k_sh)
            yield k_sh.cpu().numpy().view(np.uint32), c_sh.cpu()

    def _own_stats(self) -> dict:
        self._prepare()
        ns = torch.cat(self._gather_rows(
            self.store.read_state(self.state).n.reshape(1))).cpu().numpy()
        return dict(
            n_shards=self.n_shards,
            distinct_kmers=int(ns.sum()),
            total_kmers=self.total_kmers,
            batches=self.batches_processed,
            device_seconds=round(self.elapsed, 4),
            shard_distinct=[int(x) for x in ns],
            shard_imbalance=round(float(ns.max()) / max(1.0, float(ns.mean())),
                                  4),
            spill_recovered=self._spill_recovered,
            route_direct_batches=self._route_direct_batches,
        )
