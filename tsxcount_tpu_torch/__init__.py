"""tsxcount_tpu_torch — exact k-mer counting in PyTorch with hand-written
CUDA kernels for one NVIDIA Hopper GPU (H100).

The port of `tsxcount_tpu` (JAX/Pallas on a TPU), which stays the reference
it is tested against.  This package imports neither JAX nor `tsxcount_tpu`.
It covers the sort backend through the flat count store for k <= 256
(from k = 113 through the lane-mix bijection) and the quotient-table
backend for k <= 127; see ROADMAP.md for what is still to come.

Public surface:
    KmerSpec                   — k-mer geometry (lanes, masks)
    KmerCounter                — end-to-end streaming counter (file -> counts)
    CountStore                 — sorted-unique device count table
    QuotientTable              — jellyfish-style reprobing hash table
    GF2Hash                    — bijective GF(2) matrix hash of k-mers
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
from tsxcount_tpu_torch.core.table import QuotientTable
from tsxcount_tpu_torch.ops.gf2 import GF2Hash
from tsxcount_tpu_torch.core.counter import KmerCounter

__version__ = "0.1.0"

__all__ = [
    "KmerSpec",
    "KmerCounter",
    "CountStore",
    "QuotientTable",
    "GF2Hash",
    "encode_bases",
    "decode_bases",
    "kmer_to_string",
    "string_to_kmer",
    "read_golden",
    "write_golden",
]
