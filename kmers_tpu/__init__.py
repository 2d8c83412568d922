"""kmers_tpu: a bit-packed 2-bit DNA k-mer engine in JAX.

A from-scratch JAX/XLA framework with the capabilities (and bit-level
semantics) of the Rust crate COMBINE-lab/kmers, plus a sharded
counting/minimizer pipeline the reference does not have.

Layers (bottom-up):
  * ``kmers_tpu.core``     -- KmerSpec config; u64-as-2xu32 lane arithmetic.
  * ``kmers_tpu.ops``      -- batched jnp ops: encoding, k-mer windows,
                              canonical, hashing, minimizers, packed storage.
  * ``kmers_tpu.parallel`` -- mesh setup, hash-routed all_to_all, sharded
                              counting (new scope vs the reference).
  * ``kmers_tpu.oracle``   -- scalar NumPy oracle: the normative model of the
                              reference semantics, also a drop-in scalar API
                              (Kmer / CanonicalKmer / CanonicalKmerIterator /
                              SeqVector / encodings).
  * ``kmers_tpu.io``       -- FASTA/FASTQ ingest and read batching.
"""

from . import utils
from .core.spec import KmerSpec
from .core import u64, u128, wideint
from .ops import encoding, generic, hash, kmer, minimizer, seqvector
from .ops.generic import GenericSpec
from .ops.kmer import kmer_windows, kmer_windows_wide, canonical_word
from .ops.minimizer import MappedMinimizer, minimizer_stream
from .ops.seqvector import SeqVecKmerIterator, SeqVecMinimizerIter, SeqVector

__version__ = "0.1.0"

__all__ = [
    "KmerSpec",
    "GenericSpec",
    "u64",
    "u128",
    "wideint",
    "utils",
    "encoding",
    "generic",
    "hash",
    "kmer",
    "minimizer",
    "seqvector",
    "kmer_windows",
    "kmer_windows_wide",
    "canonical_word",
    "minimizer_stream",
    "MappedMinimizer",
    "SeqVector",
    "SeqVecKmerIterator",
    "SeqVecMinimizerIter",
    "__version__",
]
