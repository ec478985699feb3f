"""tsxcount_tpu_torch — exact k-mer counting in PyTorch with hand-written
CUDA kernels for one NVIDIA Hopper GPU (H100).

The port of `tsxcount_tpu` (JAX/Pallas on a TPU), which stays the reference
it is tested against.  This package imports neither JAX nor `tsxcount_tpu`.
It covers the single-GPU surface of the JAX package: the sort backend for
k <= 256 (from k = 113 through the lane-mix bijection) with the flat or the
LSM count store, the quotient-table backend for k <= 256, canonical
counting, homopolymer collapse, progress lines, checkpoints that load in
either package, a device-memory preflight, the command line
(`python -m tsxcount_tpu_torch count`) and the sharded counter over
torch.distributed ranks, one shard and one device each (the command
line's default at one shard).

Public surface:
    KmerSpec                   — k-mer geometry (lanes, masks)
    KmerCounter                — end-to-end streaming counter (file -> counts)
    ShardedKmerCounter         — the same API over n_shards ranks
    CountStore                 — sorted-unique device count table
    LSMStore                   — geometric cascade of CountStores
    QuotientTable              — jellyfish-style reprobing hash table
    GF2Hash                    — bijective GF(2) matrix hash of k-mers
    canonicalize               — min(kmer, reverse complement) of key rows
    save_counter / load_counter — .npz checkpoints (JAX package's format)
    read_golden / write_golden — `kmer\tcount` TSV IO (reference .count format)
"""

from tsxcount_tpu_torch.config import KmerSpec
from tsxcount_tpu_torch.utils.sequence import (
    encode_bases,
    decode_bases,
    kmer_to_string,
    string_to_kmer,
)
from tsxcount_tpu_torch.utils.goldenfile import read_golden, write_golden
from tsxcount_tpu_torch.core.store import CountStore
from tsxcount_tpu_torch.core.lsm import LSMStore
from tsxcount_tpu_torch.core.table import QuotientTable
from tsxcount_tpu_torch.ops.canonical import canonicalize
from tsxcount_tpu_torch.ops.gf2 import GF2Hash
from tsxcount_tpu_torch.core.counter import KmerCounter
from tsxcount_tpu_torch.core.checkpoint import load_counter, save_counter
from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

__version__ = "0.1.0"

__all__ = [
    "KmerSpec",
    "KmerCounter",
    "ShardedKmerCounter",
    "CountStore",
    "LSMStore",
    "QuotientTable",
    "GF2Hash",
    "canonicalize",
    "save_counter",
    "load_counter",
    "encode_bases",
    "decode_bases",
    "kmer_to_string",
    "string_to_kmer",
    "read_golden",
    "write_golden",
]
