"""Batched k-mer hashing (device analog of src/naive_impl/hash.rs).

Two hashers, as in the reference:
  * ``lex_hash(words, k)`` -- LexHasher: the base-reversal ladder, a
    lexicographic-order-preserving "hash" (hash.rs:51-72).  Bit-exact parity
    target.
  * ``mix_hash(words, seed)`` -- the framework's stable seedable mixer for
    bucketing/routing (the reference's default is Rust's RandomState, which
    is keyed randomly per-process and therefore not a parity target; the
    contract is only that hashing is a function of the raw u64 word,
    hash.rs:4-8).

Both operate on U64 pairs and are bit-identical to the oracle.
"""

from __future__ import annotations

from typing import Callable

from ..core import u64 as u
from ..core.u64 import U64


def lex_hash(words: U64, k: int) -> U64:
    return u.lex_hash(words, k)


def mix_hash(words: U64, seed: int = 0) -> U64:
    return u.mix_hash(words, seed)


def lex_hash_fn(k: int) -> Callable[[U64], U64]:
    """BuildHasher analog of LexHasherState(k) (hash.rs:22-36)."""
    return lambda w: u.lex_hash(w, k)


def mix_hash_fn(seed: int = 0) -> Callable[[U64], U64]:
    return lambda w: u.mix_hash(w, seed)


def mix32_hash_fn(seed: int = 0) -> Callable[[U64], U64]:
    """32-bit minimizer-selection order (hi = 0): see core.u64.mix32_order.
    A cheaper compare key for the minimizer window scan."""
    return lambda w: u.mix32_order(w, seed)


def mix16_hash_fn(seed: int = 0) -> Callable[[U64], U64]:
    """16-bit minimizer-selection order (top half of mix32_order, hi = 0).

    The super-k-mer partition's selection order: 16 order bits leave
    room to PACK the window position into the same uint32 compare plane
    ((order16 << 12) | pos), so a window scan carries one compare+select
    plane fewer.  A selection order may collide (any fixed order is a
    valid minimizer scheme; the reference takes an arbitrary BuildHasher,
    kmer.rs:170-192); leftmost-tie resolves collisions deterministically."""
    import jax.numpy as jnp

    def fn(w: U64) -> U64:
        o = u.mix32_order(w, seed)
        return U64(o.hi, o.lo >> jnp.uint32(16))

    return fn
