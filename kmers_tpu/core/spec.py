"""Static configuration resolved before jit.

The reference fixes k/word-width/encoding at compile time via const generics
and cargo features (src/kmer.rs:12-14, Cargo.toml:15-16).  The analog here is
this frozen dataclass: everything that determines shapes, dtypes, or shift
amounts lives here, so every jitted function specializes on it.  It is the
one config object consumed by parallel.pipeline.count_reads*,
parallel.stream's counters, and the CLI.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KmerSpec:
    """Compile-time k-mer configuration.

    Attributes:
      k: k-mer length in bases.  k <= 32 uses one u64 (one uint32 pair);
         33 <= k <= 64 uses two u64s (naive_impl supports only k <= 32,
         naive_impl/kmer.rs:236-238; the multi-word path mirrors the generic
         layer's word_for_k, src/kmer.rs:67-69).
      w: minimizer width (None if minimizers unused).
      seed: seed for the default mixer hash (routing owners, minimizer
         selection order).
    """

    k: int
    w: int | None = None
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.k <= 64):
            raise ValueError(f"k={self.k} out of supported range [1, 64]")
        if self.w is not None and not (1 <= self.w <= min(self.k, 32)):
            raise ValueError(f"w={self.w} invalid for k={self.k}")

    @property
    def wide(self) -> bool:
        """Whether keys are 128-bit (33 <= k <= 64)."""
        return self.k > 32

    @property
    def aggregate(self) -> str:
        """Streaming per-batch table form: "unit" whenever the spare flag
        bit exists (k != 32, 64), else the run-length fallback (see
        parallel.count.UnitTable)."""
        return ("unit" if (self.k <= 31 or 33 <= self.k <= 63)
                else "runlength")

    @property
    def words_per_kmer(self) -> int:
        """Number of u64 words (uint32 pairs) per k-mer."""
        return (self.k + 31) // 32

    @property
    def mask(self) -> int:
        """Low-2k-bit mask of the (single-word) k-mer.  Note: unlike
        MASK_TABLE[32] (which is 0 -- the from_u64 quirk), windows built by
        the framework use the true mask; the quirk is honored only in the
        from_u64 compat path."""
        return (1 << (2 * self.k)) - 1 if self.k < 32 else (1 << 64) - 1
