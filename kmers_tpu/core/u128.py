"""u128 emulation as a pair of U64 lane pairs (i.e. 4 uint32 lanes).

The multi-word k-mer path (33 <= k <= 64, BASELINE config 3): the reference
reaches long k through const-generic [P; B] arrays (src/kmer.rs:12-14);
kmers_tpu represents the same 128-bit LSB-first 2-bit layout as
``value = hi * 2**64 + lo`` with hi/lo each a core.u64.U64.

All ops mirror core.u64: elementwise, static shift amounts.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import u64 as u
from .u64 import U64


class U128(NamedTuple):
    """A u128 value as (hi, lo) U64 pairs (a JAX pytree)."""

    hi: U64
    lo: U64

    @property
    def shape(self):
        return self.lo.lo.shape


def from_scalar(value: int, shape=()) -> U128:
    value &= (1 << 128) - 1
    return U128(u.from_scalar(value >> 64, shape),
                u.from_scalar(value & ((1 << 64) - 1), shape))


def from_u64(x: U64) -> U128:
    z = jnp.zeros_like(x.lo)
    return U128(U64(z, z), x)


def to_python_ints(x: U128):
    """Materialize to a host list of Python ints (tests / host API)."""
    import numpy as np

    hi = u.to_numpy(x.hi).reshape(-1)
    lo = u.to_numpy(x.lo).reshape(-1)
    return [int(h) << 64 | int(l) for h, l in zip(hi, lo)]


def from_python_ints(vals, shape=None) -> U128:
    import numpy as np

    vals = list(vals)
    hi = np.array([(v >> 64) & ((1 << 64) - 1) for v in vals], dtype=np.uint64)
    lo = np.array([v & ((1 << 64) - 1) for v in vals], dtype=np.uint64)
    out = U128(u.from_numpy(hi), u.from_numpy(lo))
    if shape is not None:
        out = U128(
            U64(out.hi.hi.reshape(shape), out.hi.lo.reshape(shape)),
            U64(out.lo.hi.reshape(shape), out.lo.lo.reshape(shape)))
    return out


# -- bitwise ----------------------------------------------------------------

def and_(a: U128, b: U128) -> U128:
    return U128(u.and_(a.hi, b.hi), u.and_(a.lo, b.lo))


def or_(a: U128, b: U128) -> U128:
    return U128(u.or_(a.hi, b.hi), u.or_(a.lo, b.lo))


def xor(a: U128, b: U128) -> U128:
    return U128(u.xor(a.hi, b.hi), u.xor(a.lo, b.lo))


def not_(a: U128) -> U128:
    return U128(u.not_(a.hi), u.not_(a.lo))


def and_const(a: U128, c: int) -> U128:
    c &= (1 << 128) - 1
    return U128(u.and_const(a.hi, c >> 64), u.and_const(a.lo, c & ((1 << 64) - 1)))


def or_const(a: U128, c: int) -> U128:
    c &= (1 << 128) - 1
    return U128(u.or_const(a.hi, c >> 64), u.or_const(a.lo, c & ((1 << 64) - 1)))


# -- shifts (static amounts) -------------------------------------------------

def shl(a: U128, n: int) -> U128:
    assert 0 <= n <= 128, n
    if n == 0:
        return a
    if n >= 128:
        z = jnp.zeros_like(a.lo.lo)
        return U128(U64(z, z), U64(z, z))
    if n >= 64:
        return U128(u.shl(a.lo, n - 64), U64(*[jnp.zeros_like(a.lo.lo)] * 2))
    hi = u.or_(u.shl(a.hi, n), u.shr(a.lo, 64 - n))
    return U128(hi, u.shl(a.lo, n))


def shr(a: U128, n: int) -> U128:
    assert 0 <= n <= 128, n
    if n == 0:
        return a
    if n >= 128:
        z = jnp.zeros_like(a.lo.lo)
        return U128(U64(z, z), U64(z, z))
    if n >= 64:
        return U128(U64(*[jnp.zeros_like(a.lo.lo)] * 2), u.shr(a.hi, n - 64))
    lo = u.or_(u.shr(a.lo, n), u.shl(a.hi, 64 - n))
    return U128(u.shr(a.hi, n), lo)


# -- comparisons --------------------------------------------------------------

def eq(a: U128, b: U128) -> jnp.ndarray:
    return u.eq(a.hi, b.hi) & u.eq(a.lo, b.lo)


def ne(a: U128, b: U128) -> jnp.ndarray:
    return ~eq(a, b)


def lt(a: U128, b: U128) -> jnp.ndarray:
    return u.lt(a.hi, b.hi) | (u.eq(a.hi, b.hi) & u.lt(a.lo, b.lo))


def le(a: U128, b: U128) -> jnp.ndarray:
    return u.lt(a.hi, b.hi) | (u.eq(a.hi, b.hi) & u.le(a.lo, b.lo))


def min_(a: U128, b: U128) -> U128:
    take_a = lt(a, b)
    return where(take_a, a, b)


def where(pred: jnp.ndarray, a: U128, b: U128) -> U128:
    return U128(u.where(pred, a.hi, b.hi), u.where(pred, a.lo, b.lo))


# -- bit ladders ---------------------------------------------------------------

def reverse_bases(a: U128) -> U128:
    """Reverse all 64 base slots: per-u64 ladders + the stride-64 swap."""
    return U128(u.reverse_bases(a.lo), u.reverse_bases(a.hi))


def reverse_complement(a: U128, k: int) -> U128:
    """128-bit analog of the naive_impl revcomp ladder (k <= 64)."""
    assert 1 <= k <= 64
    return shr(reverse_bases(not_(a)), 2 * (64 - k))


def lex_hash(a: U128, k: int) -> U128:
    """Order-preserving base reversal (LexHasher extended to k <= 64)."""
    assert 1 <= k <= 64
    return shr(reverse_bases(a), 2 * (64 - k))


def mix_hash(a: U128, seed: int = 0) -> U64:
    """128-bit word -> 64-bit bucketing hash; bit-identical to
    oracle.mix_hash_wide."""
    inner = u.mix_hash(a.hi, seed ^ 0xA5A5A5A5)
    return u.mix_hash(u.xor(a.lo, inner), seed)
