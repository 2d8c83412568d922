"""u64 emulation as (hi, lo) uint32 lane pairs.

The framework represents a packed k-mer word ``w = hi * 2**32 + lo`` as a
pair of uint32 arrays: it runs without JAX's x64 mode, and every op here is
elementwise, broadcastable, and works identically under jit on any backend.
(The layout was chosen for an accelerator with 32-bit vector units; whether
the counting layer should key on one native u64 on the GPU is ROADMAP C5.)

Shift amounts are **static Python ints** -- k is a compile-time constant in
this framework (KmerSpec), so all shifts resolve at trace time to plain lane
ops, exactly like the reference's const-generic code (src/kmer.rs:12-14).

The reverse-complement / base-reversal ladders mirror the reference's 5-step
swap ladder (naive_impl/kmer.rs:124-136, hash.rs:51-72): strides 2/4/8/16
stay within a u32 lane; the stride-32 step is a (hi, lo) swap.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax.numpy as jnp

U32_MASK = 0xFFFFFFFF


class U64(NamedTuple):
    """A u64 value as a pair of uint32 arrays (a JAX pytree)."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return self.lo.shape

    def astuple(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        return (self.hi, self.lo)


def u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def from_scalar(value: int, shape=()) -> U64:
    """Broadcast a Python int to a U64 of the given shape."""
    value &= (1 << 64) - 1
    hi = jnp.full(shape, (value >> 32) & U32_MASK, dtype=jnp.uint32)
    lo = jnp.full(shape, value & U32_MASK, dtype=jnp.uint32)
    return U64(hi, lo)


def from_u32(lo: jnp.ndarray) -> U64:
    lo = lo.astype(jnp.uint32)
    return U64(jnp.zeros_like(lo), lo)


def make(hi, lo) -> U64:
    return U64(u32(hi), u32(lo))


def to_numpy(x: U64):
    """Materialize to a host numpy uint64 array (for tests / host API)."""
    import numpy as np

    return (np.asarray(x.hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        x.lo, dtype=np.uint64
    )


def from_numpy(arr) -> U64:
    import numpy as np

    arr = np.asarray(arr, dtype=np.uint64)
    return U64(
        jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


# -- bitwise ----------------------------------------------------------------

def and_(a: U64, b: U64) -> U64:
    return U64(a.hi & b.hi, a.lo & b.lo)


def or_(a: U64, b: U64) -> U64:
    return U64(a.hi | b.hi, a.lo | b.lo)


def xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def not_(a: U64) -> U64:
    return U64(~a.hi, ~a.lo)


def and_const(a: U64, c: int) -> U64:
    c &= (1 << 64) - 1
    return U64(a.hi & u32((c >> 32) & U32_MASK), a.lo & u32(c & U32_MASK))


def or_const(a: U64, c: int) -> U64:
    c &= (1 << 64) - 1
    return U64(a.hi | u32((c >> 32) & U32_MASK), a.lo | u32(c & U32_MASK))


def xor_const(a: U64, c: int) -> U64:
    c &= (1 << 64) - 1
    return U64(a.hi ^ u32((c >> 32) & U32_MASK), a.lo ^ u32(c & U32_MASK))


# -- shifts (static amounts) -------------------------------------------------

def shl(a: U64, n: int) -> U64:
    """Logical shift left by a static amount 0 <= n <= 64."""
    assert 0 <= n <= 64, n
    if n == 0:
        return a
    if n == 32:
        return U64(a.lo, jnp.zeros_like(a.lo))
    if n >= 64:
        z = jnp.zeros_like(a.lo)
        return U64(z, z)
    if n < 32:
        hi = (a.hi << n) | (a.lo >> (32 - n))
        lo = a.lo << n
        return U64(hi, lo)
    # 32 < n < 64
    return U64(a.lo << (n - 32), jnp.zeros_like(a.lo))


def shr(a: U64, n: int) -> U64:
    """Logical shift right by a static amount 0 <= n <= 64."""
    assert 0 <= n <= 64, n
    if n == 0:
        return a
    if n == 32:
        return U64(jnp.zeros_like(a.hi), a.hi)
    if n >= 64:
        z = jnp.zeros_like(a.lo)
        return U64(z, z)
    if n < 32:
        lo = (a.lo >> n) | (a.hi << (32 - n))
        hi = a.hi >> n
        return U64(hi, lo)
    # 32 < n < 64
    return U64(jnp.zeros_like(a.hi), a.hi >> (n - 32))


# -- comparisons (unsigned) ---------------------------------------------------

def eq(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi == b.hi) & (a.lo == b.lo)


def ne(a: U64, b: U64) -> jnp.ndarray:
    return ~eq(a, b)


def lt(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def le(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def min_(a: U64, b: U64) -> U64:
    take_a = lt(a, b)
    return U64(jnp.where(take_a, a.hi, b.hi), jnp.where(take_a, a.lo, b.lo))


def where(pred: jnp.ndarray, a: U64, b: U64) -> U64:
    return U64(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


# -- arithmetic ---------------------------------------------------------------

def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(jnp.uint32)
    return U64(a.hi + b.hi + carry, lo)


def add_const(a: U64, c: int) -> U64:
    return add(a, from_scalar(c, ()))


# -- bit ladders ---------------------------------------------------------------

def _swap_ladder_u32(x: jnp.ndarray) -> jnp.ndarray:
    """In-lane base reversal: swap adjacent 2/4/8/16-bit groups of a u32."""
    x = ((x >> 2) & u32(0x33333333)) | ((x & u32(0x33333333)) << 2)
    x = ((x >> 4) & u32(0x0F0F0F0F)) | ((x & u32(0x0F0F0F0F)) << 4)
    x = ((x >> 8) & u32(0x00FF00FF)) | ((x & u32(0x00FF00FF)) << 8)
    x = (x >> 16) | (x << 16)
    return x


def reverse_bases(a: U64) -> U64:
    """Full 32-base reversal of a u64 word: the reference's 5-step ladder
    (strides 2,4,8,16 in-lane + the stride-32 (hi,lo) swap)."""
    return U64(_swap_ladder_u32(a.lo), _swap_ladder_u32(a.hi))


def reverse_complement(a: U64, k: int) -> U64:
    """naive_impl revcomp: complement-all, reverse, shift down to k bases
    (naive_impl/kmer.rs:124-136)."""
    return shr(reverse_bases(not_(a)), 2 * (32 - k))


def lex_hash(a: U64, k: int) -> U64:
    """LexHasher: reversal ladder without complement, then shift
    (hash.rs:51-72)."""
    return shr(reverse_bases(a), 2 * (32 - k))


# -- mixer hash ---------------------------------------------------------------

def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """32-bit avalanche ('lowbias32'); bit-identical to oracle._mix32."""
    x = x ^ (x >> 16)
    x = x * u32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * u32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def mix_hash(a: U64, seed: int = 0) -> U64:
    """Stable seedable 64-bit mixer built from 32-bit multiplies; the
    framework's default bucketing hash (see oracle.numpy_ref.mix_hash)."""
    s_lo = u32(seed & U32_MASK)
    s_hi = u32((seed >> 32) & U32_MASK)
    out_lo = _mix32(a.lo ^ _mix32(a.hi ^ s_lo))
    out_hi = _mix32(a.hi ^ _mix32(a.lo ^ s_hi ^ u32(0x9E3779B9)))
    return U64(out_hi, out_lo)


def mix32_order(a: U64, seed: int = 0) -> U64:
    """32-bit total order for minimizer SELECTION: exactly the low half of
    mix_hash, hi = 0.  A minimizer scheme only needs a fixed order on
    w-mers (the reference takes any BuildHasher, kmer.rs:170-192); for
    w <= 16 this is a bijection of the w-mer word (mix32 composes
    invertible xor-shifts and odd multiplies), and for w > 16 the
    leftmost-tie rule resolves the rare collisions.  Halves the compare
    planes in the minimizer window scan."""
    s_lo = u32(seed & U32_MASK)
    return U64(jnp.zeros_like(a.lo),
               _mix32(a.lo ^ _mix32(a.hi ^ s_lo)))


def feistel_mix(a: U64, seed: int = 0, rounds: int = 3) -> U64:
    """BIJECTIVE 64-bit mixer (3-round Feistel over _mix32): the routing
    key transform of parallel.route.

    Why a bijection (round 5): the owning shard used to be
    mul_shift(mix_hash(key).hi, D), which made the partition sort carry
    THREE operands (owner, key_hi, key_lo).  With an invertible mix the
    owner is a PREFIX of the mixed key itself -- the partition sorts just
    (f_hi, f_lo), owners fall out of the sorted prefix by binary search,
    the mixed words ship over the all_to_all, and the receiver inverts
    (feistel_unmix) to recover the exact keys.  One fewer sort operand on
    the routing hot path, zero information loss."""
    hi, lo = a.hi, a.lo
    for r in range(rounds):
        hi, lo = lo, hi ^ _mix32(lo + u32((seed + 0x9E3779B9 * (r + 1))
                                          & U32_MASK))
    return U64(hi, lo)


def feistel_unmix(a: U64, seed: int = 0, rounds: int = 3) -> U64:
    """Inverse of feistel_mix (exact, elementwise)."""
    hi, lo = a.hi, a.lo
    for r in reversed(range(rounds)):
        hi, lo = lo ^ _mix32(hi + u32((seed + 0x9E3779B9 * (r + 1))
                                      & U32_MASK)), hi
    return U64(hi, lo)
