"""Count-state checkpoints (save and resume), in the JAX package's format.

One .npz file holds a JSON `meta` record, the state arrays as `state_*`
(the JAX package's StoreState or TableState fields, converted by
`state_to_reference` / `state_from_reference`) and the GF(2) hash's
`hash_matrix` / `hash_inverse`, which define the layout of a table and
of a GF(2) store image (`hash_first="gf2"`, the sharded
`routing_hash="gf2"`) and are restored on every backend.  The keys,
dtypes and layouts are those of `tsxcount_tpu/core/checkpoint.py` format
3, so a file written by either package loads in the other.  An LSM
counter saves its collapsed top level.  The port writes the archive
without compression (np.load reads either), so saving a GB-sized state
costs the disk write and no zlib pass on one host core; the state is
converted to and from the JAX layout on the counter's device.

A sharded counter (parallel/sharded.py; `n_shards` >= 1 in the file,
0 for KmerCounter) writes the JAX package's stacked arrays: every field
the shards' states concatenated in rank order (scalars become vectors of
n_shards).  Saving and loading are collectives: rank 0 gathers the
shards' states and writes the file; on load every rank reads the file and
takes its own shard's row.

Older files load as the JAX package loads them: `hash_first: true` (the
GF(2) image, before "mix" existed) as "gf2", and a sharded file without
`routing_hash` (written before the lane mix) as the GF(2) routing.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from tsxcount_tpu_torch.io.packer import PackStats

FORMAT_VERSION = 3
_SHARD_SCALARS = ("n", "overflowed", "spilled")  # one value a shard


def _is_sharded(counter) -> bool:
    return hasattr(counter, "n_shards")


def save_counter(counter, path: str | Path) -> None:
    """Serialize a KmerCounter or ShardedKmerCounter (either backend, flat
    or LSM) to .npz.  Sharded: every rank calls it, rank 0 writes."""
    if _is_sharded(counter):
        _save_sharded(counter, path)
        return
    # the packer's partial batch and the pending merges first (the LSM:
    # everything in the top level), so that the file's state, stats and
    # batches_processed all include every read fed
    ref = counter._shard_reference()
    # n_shards 0 = unsharded, with the JAX package's routing_hash
    meta = _meta(counter, counter.packer.stats, 0, "gf2",
                 counter.hash_first, counter.mix_prefix)
    _write(path, meta, ref, counter.hash_fn)


def _meta(counter, stats, n_shards: int, routing_hash: str, hash_first,
          mix_prefix: bool) -> dict:
    """The file's meta record: the counter's options, the whole stream's
    ingest stats, and the fields where the two counters differ."""
    return {
        "format": FORMAT_VERSION,
        "k": counter.spec.k,
        "l": counter.l,
        "s": counter.s,
        "backend": counter.backend,
        "n_policy": counter.n_policy,
        "identity_hash": counter.hash_fn.identity,
        "canonical": counter.canonical,
        "collapse_hp": counter.collapse_hp,
        "hash_first": hash_first,
        "mix_prefix": mix_prefix,
        "stats": dataclasses.asdict(stats),
        "batches_processed": counter.batches_processed,
        "lsm": counter.lsm,
        "lsm_growth": counter.lsm_growth,
        "merge_every": counter.merge_every,
        "n_shards": n_shards,
        "routing_hash": routing_hash,
        "max_reprobes": counter.store.max_reprobes,
    }


def _write(path, meta: dict, state: dict, hash_fn) -> None:
    arrays = {f"state_{name}": val for name, val in state.items()}
    arrays["hash_matrix"] = hash_fn.matrix
    arrays["hash_inverse"] = hash_fn.inverse
    np.savez(path, meta=json.dumps(meta), **arrays)


def _save_sharded(counter, path: str | Path) -> None:
    arrays = shard_states_to_reference(counter)
    stats = counter._global_stats()
    if counter.rank == 0:
        meta = _meta(counter, stats, counter.n_shards, counter.routing_hash,
                     False, False)
        _write(path, meta, arrays, counter.hash_fn)
    counter._sum([0])  # no rank returns before the file is whole


def shard_states_to_reference(counter) -> dict[str, np.ndarray] | None:
    """Every shard's state as the JAX package's stacked state fields: the
    shards' numpy arrays (`state_to_reference`) concatenated in rank order,
    a scalar field becoming a vector of n_shards.  On rank 0; None on the
    others.  Folds every pending batch, run and spill carry first.
    Collective."""
    rows = {name: _gather_shards(np.atleast_1d(arr), counter)
            for name, arr in counter._shard_reference().items()}
    if counter.rank:
        return None
    return {name: np.concatenate(parts) for name, parts in rows.items()}


def shard_states_from_reference(counter, arrays) -> None:
    """Load this rank's row of the JAX package's stacked state fields (a
    mapping of numpy arrays, as a checkpoint holds them) into the sharded
    counter's shard."""
    n, rank = counter.n_shards, counter.rank

    def row(name):
        arr = np.asarray(arrays[name])
        if name in _SHARD_SCALARS:
            return arr[rank]
        return np.split(arr, n)[rank]

    counter._load_shard_reference(
        {name: row(name) for name in counter.store.reference_fields})


def _gather_shards(arr: np.ndarray, counter) -> list[np.ndarray] | None:
    """Every rank's `arr` (one shape on every rank), in rank order, on
    rank 0 (None elsewhere), through the counter's process group."""
    import torch.distributed as dist

    if counter.n_shards == 1:
        return [arr]
    t = torch.from_numpy(np.ascontiguousarray(arr).view(
        np.uint8)).to(counter.device)
    parts = ([torch.empty_like(t) for _ in range(counter.n_shards)]
             if counter.rank == 0 else None)
    dist.gather(t, parts, dst=0)
    if parts is None:
        return None
    return [p.cpu().numpy().view(arr.dtype).reshape(arr.shape)
            for p in parts]


def _state_array(name: str, data) -> np.ndarray:
    """One state field, migrating old table layouts: files that stored
    keys/digits/used as three arrays, or the combined rows as [slots, C],
    become the flat column-major `slots` array."""
    key = f"state_{name}"
    if key in data:
        arr = data[key]
        if name == "slots" and arr.ndim == 2:
            arr = np.ascontiguousarray(arr.T).reshape(-1)
        return arr
    if name == "slots" and "state_keys" in data:
        keys = np.asarray(data["state_keys"])
        digits = np.asarray(data["state_digits"]).view(np.uint32)
        used = np.asarray(data["state_used"]).astype(np.uint32)[:, None]
        return np.ascontiguousarray(
            np.concatenate([keys, digits, used], axis=1).T
        ).reshape(-1)
    raise KeyError(f"checkpoint missing state field {name}")


def load_counter(path: str | Path, batch_words: int = 1 << 16,
                 device: str | torch.device | None = "cuda"):
    """Rebuild a KmerCounter, or a ShardedKmerCounter (every rank of a
    group of the file's n_shards calls it), from an .npz checkpoint,
    ready to resume.

    The file's shape (shards, backend, k, l, options) wins; only the
    ingest batch size, which is not part of the state, and the device
    (sharded: None is the rank's own card) are the caller's; a sharded
    load joins the process group that exists (one shard needs none).
    """
    from tsxcount_tpu_torch.core.counter import KmerCounter

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        if meta["format"] > FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint format {meta['format']}")
        if meta.get("n_shards", 0):
            return _load_sharded(meta, data, batch_words, device)
        counter = KmerCounter(
            k=meta["k"], l=meta["l"], s=meta["s"], backend=meta["backend"],
            batch_words=batch_words, n_policy=meta["n_policy"],
            identity_hash=meta["identity_hash"],
            canonical=meta.get("canonical", False),
            collapse_homopolymers=meta.get("collapse_hp", True),
            # older files wrote True for the GF(2) image ("mix" came later)
            hash_first=("gf2" if meta.get("hash_first", False) is True
                        else meta.get("hash_first", False)),
            mix_prefix=meta.get("mix_prefix", False),
            lsm=meta.get("lsm", False),
            lsm_growth=meta.get("lsm_growth", 8),
            merge_every=meta.get("merge_every", 4),
            max_reprobes=meta.get("max_reprobes") or 64,
            device=device,
        )
        # the matrix defines a table's or a GF(2) image's layout: the file's
        counter.hash_fn.load(data["hash_matrix"], data["hash_inverse"])
        counter.load_store_state({name: _state_array(name, data)
                                  for name in counter.store.reference_fields})
        counter.packer.stats = PackStats(**meta["stats"])
        counter.batches_processed = meta["batches_processed"]
    return counter


def _load_sharded(meta, data, batch_words, device):
    """Rebuild this rank's shard: its row of every stacked array."""
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

    if meta["format"] < 3:
        raise ValueError(
            "sharded checkpoints written before format 3 store raw keys; "
            "this version shards by hashed key — re-count to regenerate")
    n = meta["n_shards"]
    counter = ShardedKmerCounter(
        k=meta["k"], n_shards=n, l=meta["l"], s=meta["s"],
        backend=meta["backend"], batch_words=batch_words,
        n_policy=meta["n_policy"], identity_hash=meta["identity_hash"],
        canonical=meta.get("canonical", False),
        collapse_homopolymers=meta.get("collapse_hp", True),
        lsm=meta.get("lsm", False) or None,  # False: the counter's rule
        lsm_growth=meta.get("lsm_growth", 8),
        merge_every=meta.get("merge_every", 4),
        max_reprobes=meta.get("max_reprobes") or 64,
        # files written before the lane mix routed through GF(2)
        routing_hash=meta.get("routing_hash", "gf2"),
        device=device,
    )
    # the GF(2) routing image's layout: the file's matrix
    counter.hash_fn.load(data["hash_matrix"], data["hash_inverse"])
    shard_states_from_reference(counter, {
        name: _state_array(name, data)
        for name in counter.store.reference_fields})
    # the file's ingest stats are the whole stream's: one rank holds them
    if counter.rank == 0:
        counter.packer.stats = PackStats(**meta["stats"])
    counter.batches_processed = meta["batches_processed"]
    return counter
