"""Device-memory footprint model of one counting run, and a preflight check.

The counterpart of `tsxcount_tpu/utils/hbm.py`, rewritten for the port's
own buffers (the JAX model's digit triples, TPU tile padding and XLA sort
factors do not apply).  Bytes per row are read off the code, not measured:

  * store state (core/store.py): n_ops int32 operand words + one int64
    count a row, per level of the LSM store (core/lsm.py);
  * a store merge (CountStore._fold): kernel 3's output over store + run
    rows, then the tail-masked copy of the kept rows (the operand columns
    twice while they are stacked, the counts, the `used` mask), beside
    the old state, the pending histograms (as the counter holds them and
    stacked once more) and the merge tree's last run with its int64
    counts;
  * the batch dedupe (ops/window.py, ops/count.py): the int64 window
    stream, the packed operands, the int64 sort words with torch.sort's
    values, indices and working space, kernel 1's output, the unpacked
    [P, lanes] keys; canonical mode adds its int64 lane temporaries, the
    lane mix its output columns;
  * mix_prefix (ops/mix.py): the state, the dedupe's operands, sort and
    keys, the pending histograms and the merges all hold the EXTENDED
    key, lanes + 2 columns (+ the flag operand, the top lane being full),
    and mix_cols adds its int64 accumulators and products;
  * the GF(2) product (ops/gf2.py; hash_first="gf2", the sharded GF(2)
    routing, and the plain table's hash at its insert): the stacked keys
    in and out, and one 2^20-row chunk of bit planes, 32 B a bit (int32
    and float32 planes in, float32 and int32 out, pack_bits' two int64
    copies);
  * the table (core/table.py): its flat slot array, a split round's sort
    and columns at full width, and the digit renormalisation's int64
    temporaries over every slot;
  * ingest: the device copies of the packed batches in flight;
  * the sharded counter (n_shards >= 1, parallel/sharded.py): ONE
    shard's device, as the JAX model counts it: its share of the table
    (2^l / n_shards rows; the table 2^(l - log2 n) slots), the routing
    step's padded rows, send and receive blocks and gather indices, the
    spill carry, the received runs that wait for a flush (merge_every x
    n_shards x route_cap rows, which replace the pending histograms),
    and a flush of that many rows into the store (the table: their
    weighted re-dedupe and split rounds at that width).

Every term is summed, as if the dedupe, the merge and the renormalisation
peaked at once: an upper bound for `torch.cuda.max_memory_allocated()`,
which the card run of chip_smoke.py holds the estimate against.
"""

from __future__ import annotations

import dataclasses

from tsxcount_tpu_torch.config import BatchSpec, KmerSpec, route_capacity
from tsxcount_tpu_torch.core.lsm import LSMStore
from tsxcount_tpu_torch.ops.gf2 import _CHUNK_ROWS as GF2_CHUNK_ROWS
from tsxcount_tpu_torch.ops.mix import make_ext_spec

MB = 1 << 20


@dataclasses.dataclass
class HbmEstimate:
    state_mb: float
    dedupe_peak_mb: float
    merge_peak_mb: float
    ingest_mb: float
    total_mb: float

    def as_dict(self) -> dict:
        return {k: round(v, 1) for k, v in dataclasses.asdict(self).items()}


def estimate_hbm(
    k: int,
    l: int,
    batch_words: int,
    backend: str = "sort",
    merge_every: int = 4,
    lsm: bool = False,
    lsm_growth: int = 8,
    hash_first: bool | str = False,
    canonical: bool = False,
    prefetch_depth: int = 3,
    n_shards: int = 0,
    capacity_factor: float = 2.0,
    mix_prefix: bool = False,
) -> HbmEstimate:
    """Peak device bytes of one counting run of the port, in MiB: of the
    KmerCounter (n_shards 0), or of one shard's device of the sharded
    counter (n_shards >= 1; hash_first then names the routing bijection
    where its store holds images, else False).  hash_first: False, "mix"
    (True aliases it) or "gf2"."""
    spec = KmerSpec(k)
    p = BatchSpec(spec, batch_words).positions
    raw_lanes = spec.lanes
    gf2 = (8 * raw_lanes * p  # the stacked keys in and out, and a chunk
           + 32 * 32 * raw_lanes * min(p, GF2_CHUNK_ROWS))  # of planes
    if mix_prefix:  # everything past the extraction holds lanes + 2
        spec = make_ext_spec(spec)
    lanes = spec.lanes
    n_ops = lanes if spec.top_lane_bits < 32 else lanes + 1
    cap = 1 << l
    # extraction (three int64 streams), operands, the sort words with
    # values, indices and working space, kernel 1's output, the keys
    dedupe = p * (96 + 16 * n_ops + 8 * lanes)
    if hash_first == "gf2":
        dedupe += gf2
    elif hash_first:
        dedupe += p * 4 * lanes  # the lane mix's output columns
    if mix_prefix:
        dedupe += p * 48  # mix_cols' int64 accumulators and products
    if canonical:
        dedupe += p * 32 * raw_lanes  # forward, reverse and select, int64
    pending_row = 4 * lanes + 5  # a histogram row: keys, count, valid
    flush = max(1, merge_every) * p
    routing = 0
    align = None  # the single-GPU LSM's L0: growth flushes
    if n_shards:
        route_cap, align = route_capacity(p, n_shards, capacity_factor)
        run_row = 4 * lanes + 4  # a routed row: keys, count
        flush = max(1, merge_every if backend == "sort" else 1) * (
            n_shards * route_cap)
        # padded rows, the send and receive blocks with the gather's
        # int64 indices, the spill carry, and the runs waiting to fold
        routing = ((p + 2 * route_cap) * run_row
                   + n_shards * route_cap * (2 * run_row + 8)
                   + (2 * n_shards * route_cap * run_row
                      if route_cap < p else 0)
                   + flush * run_row)
        pending_row = run_row + 1  # and their valid mask at the fold
        if backend == "table":
            cap = 1 << max(1, l - max(0, n_shards.bit_length() - 1))
        else:
            cap = max(1, cap // n_shards)
    if backend == "table":
        state = 4 * (lanes + 4) * cap
        # the batch histogram (sharded: the weighted re-dedupe of a
        # flush), a full-width split round, and the digit
        # renormalisation's temporaries over every slot
        width = flush if n_shards else p
        merge = width * (pending_row + 120 + 24 * lanes) + 40 * cap
        if n_shards:
            merge += width * (96 + 16 * n_ops + 8 * lanes)
        else:  # the table's own GF(2) hash of the batch's keys
            merge += gf2
    else:
        row = 4 * n_ops + 8  # a store row: operands + int64 count
        fold = 12 * n_ops + 25  # kernel 3's output, tail copies, mask
        batch_side = flush * (2 * pending_row + 4 * (n_ops + 1) + 8 + row)
        if lsm:
            caps = LSMStore.level_capacities(cap, flush, lsm_growth, align)
            state = row * sum(caps)
            # the largest of the L0 merge and the absorbs into each level
            merge = max([caps[0] * fold + batch_side]
                        + [caps[i + 1] * fold + caps[i] * row
                           for i in range(len(caps) - 1)])
        else:
            state = row * cap
            merge = cap * fold + batch_side
    # packed batches on the device: in the queue, in flight, in use (the
    # interval budget at its largest, one read a word)
    batch = BatchSpec(spec, batch_words, read_len_hint=1)
    ingest = 4 * batch.buf_words * (prefetch_depth + 2)
    ingest += routing
    total = state + dedupe + merge + ingest
    return HbmEstimate(state_mb=state / MB, dedupe_peak_mb=dedupe / MB,
                       merge_peak_mb=merge / MB, ingest_mb=ingest / MB,
                       total_mb=total / MB)


def estimate_for(counter) -> HbmEstimate:
    """estimate_hbm of a built KmerCounter or ShardedKmerCounter (one
    shard's device): its own geometry and options (the LSM as its rule
    chose it), not the flags that asked for them."""
    sharded = hasattr(counter, "n_shards")
    return estimate_hbm(
        k=counter.spec.k, l=counter.l,
        batch_words=counter.batch.capacity_words, backend=counter.backend,
        merge_every=counter.merge_every, lsm=counter.lsm,
        lsm_growth=counter.lsm_growth,
        hash_first=((counter.hashed_store and counter.routing_hash)
                    if sharded else counter.hash_first),
        canonical=counter.canonical, prefetch_depth=counter.prefetch_depth,
        n_shards=counter.n_shards if sharded else 0,
        capacity_factor=counter.capacity_factor if sharded else 2.0,
        mix_prefix=getattr(counter, "mix_prefix", False))


def device_hbm_capacity_mb() -> float:
    """Memory of the current CUDA device (MiB); raises without a GPU, where
    the caller passes a capacity instead."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass capacity_mb")
    return torch.cuda.mem_get_info()[1] / MB


def preflight_check(est: HbmEstimate, capacity_mb: float | None = None,
                    headroom: float = 0.9) -> str | None:
    """A warning when the estimate exceeds `headroom` of the device's
    memory, else None.  Callers print it and go on: the model is an
    estimate, not an allocator."""
    cap = capacity_mb if capacity_mb is not None else device_hbm_capacity_mb()
    if est.total_mb > headroom * cap:
        return (
            f"estimated device footprint {est.total_mb / 1024:.1f} GB "
            f"exceeds {headroom:.0%} of device memory ({cap / 1024:.2f} "
            f"GB): expect an out-of-memory error — reduce --l or "
            f"--batch-words (state {est.state_mb / 1024:.1f} G, dedupe "
            f"peak {est.dedupe_peak_mb / 1024:.1f} G, merge peak "
            f"{est.merge_peak_mb / 1024:.1f} G)"
        )
    return None
