"""Arbitrary-width little-endian bit vectors as tuples of uint32 lanes.

Backs the generic k-mer layer (src/kmer.rs's ``Kmer<P, K, B>``): a [P; B]
word array with LSB-first 2-bit bases is exactly a contiguous bitstring of
B*P bits, so the device representation is width-agnostic: ``n32 = B*P/32``
(or 1 for sub-u32 words) uint32 lanes, lane j holding bits [32j, 32j+32).

All shift amounts static; everything elementwise.  The
u64/u128 modules remain the hot-path specializations; this module trades a
little speed for full generality across u8/u16/u32/u64/u128 parity.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp

Lanes = Tuple[jnp.ndarray, ...]   # little-endian uint32 lanes


def n_lanes(total_bits: int) -> int:
    return max(1, (total_bits + 31) // 32)


def zeros_like(a: Lanes) -> Lanes:
    return tuple(jnp.zeros_like(x) for x in a)


def from_scalar(value: int, nl: int, shape=()) -> Lanes:
    return tuple(
        jnp.full(shape, (value >> (32 * j)) & 0xFFFFFFFF, dtype=jnp.uint32)
        for j in range(nl))


def to_python_ints(a: Lanes) -> List[int]:
    import numpy as np

    flats = [np.asarray(x).reshape(-1) for x in a]
    n = flats[0].shape[0]
    return [sum(int(f[i]) << (32 * j) for j, f in enumerate(flats))
            for i in range(n)]


def from_python_ints(vals: Sequence[int], nl: int) -> Lanes:
    import numpy as np

    return tuple(
        jnp.asarray(np.array([(v >> (32 * j)) & 0xFFFFFFFF for v in vals],
                             dtype=np.uint32))
        for j in range(nl))


# -- bitwise -----------------------------------------------------------------

def and_(a: Lanes, b: Lanes) -> Lanes:
    return tuple(x & y for x, y in zip(a, b))


def or_(a: Lanes, b: Lanes) -> Lanes:
    return tuple(x | y for x, y in zip(a, b))


def xor(a: Lanes, b: Lanes) -> Lanes:
    return tuple(x ^ y for x, y in zip(a, b))


def not_(a: Lanes) -> Lanes:
    return tuple(~x for x in a)


def and_const(a: Lanes, c: int) -> Lanes:
    return tuple(x & jnp.uint32((c >> (32 * j)) & 0xFFFFFFFF)
                 for j, x in enumerate(a))


def xor_const(a: Lanes, c: int) -> Lanes:
    return tuple(x ^ jnp.uint32((c >> (32 * j)) & 0xFFFFFFFF)
                 for j, x in enumerate(a))


# -- shifts (static) ----------------------------------------------------------

def shl(a: Lanes, n: int) -> Lanes:
    nl = len(a)
    lane_shift, bit = divmod(n, 32)
    out = []
    for j in range(nl):
        src = j - lane_shift
        x = a[src] if 0 <= src < nl else jnp.zeros_like(a[0])
        if bit:
            carry = a[src - 1] if 0 <= src - 1 < nl else jnp.zeros_like(a[0])
            x = (x << bit) | (carry >> (32 - bit))
        out.append(x)
    return tuple(out)


def shr(a: Lanes, n: int) -> Lanes:
    nl = len(a)
    lane_shift, bit = divmod(n, 32)
    out = []
    for j in range(nl):
        src = j + lane_shift
        x = a[src] if 0 <= src < nl else jnp.zeros_like(a[0])
        if bit:
            carry = a[src + 1] if 0 <= src + 1 < nl else jnp.zeros_like(a[0])
            x = (x >> bit) | (carry << (32 - bit))
        out.append(x)
    return tuple(out)


# -- compares -----------------------------------------------------------------

def eq(a: Lanes, b: Lanes) -> jnp.ndarray:
    r = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        r = r & (x == y)
    return r


def lt(a: Lanes, b: Lanes) -> jnp.ndarray:
    # most-significant lane first
    result = a[-1] < b[-1]
    equal_so_far = a[-1] == b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        result = result | (equal_so_far & (x < y))
        equal_so_far = equal_so_far & (x == y)
    return result


def min_(a: Lanes, b: Lanes) -> Lanes:
    take_a = lt(a, b)
    return tuple(jnp.where(take_a, x, y) for x, y in zip(a, b))


# -- base (2-bit group) ops ----------------------------------------------------

def _ladder32(x: jnp.ndarray) -> jnp.ndarray:
    x = ((x >> 2) & jnp.uint32(0x33333333)) | ((x & jnp.uint32(0x33333333)) << 2)
    x = ((x >> 4) & jnp.uint32(0x0F0F0F0F)) | ((x & jnp.uint32(0x0F0F0F0F)) << 4)
    x = ((x >> 8) & jnp.uint32(0x00FF00FF)) | ((x & jnp.uint32(0x00FF00FF)) << 8)
    return (x >> 16) | (x << 16)


def reverse_bases(a: Lanes) -> Lanes:
    """Reverse all 16*n_lanes base slots: lane-order reversal + in-lane
    ladders (the generic form of the reference's swap ladder)."""
    return tuple(_ladder32(x) for x in reversed(a))


def reverse_bases_k(a: Lanes, k: int) -> Lanes:
    """Reverse the low-k bases, result in the low 2k bits."""
    return shr(reverse_bases(a), 32 * len(a) - 2 * k)


def map2bit(a: Lanes, table: Sequence[int]) -> Lanes:
    """Apply an arbitrary 2-bit -> 2-bit mapping to every base slot.

    table[c] is the image of code c.  Used for permutation-encoding
    complements (encoding/naive.rs:98-109): any of the 24 complements is a
    2-bit LUT.  Branch-free: out = t0 ^ b0*(t1^t0) ^ b1*(t2^t0)
    ^ b0*b1*(t3^t2^t1^t0) evaluated per 2-bit group in parallel.
    """
    t0, t1, t2, t3 = (int(t) & 3 for t in table)
    LO = 0x55555555  # low bit of every group

    def rep(c):
        """Replicate a 2-bit constant over all groups of a u32."""
        r = 0
        if c & 1:
            r |= LO
        if c & 2:
            r |= (LO << 1) & 0xFFFFFFFF
        return jnp.uint32(r)

    def per_lane(x):
        b0 = x & jnp.uint32(LO)                 # low bit of each group
        b1 = (x >> 1) & jnp.uint32(LO)          # high bit, moved to low slot

        def gate(bit_mask, c):
            # expand the per-group condition bit to both group bits, then
            # AND with the replicated constant
            full = bit_mask | (bit_mask << 1)
            return full & rep(c)

        out = rep(t0)
        out = out ^ gate(b0, t0 ^ t1)
        out = out ^ gate(b1, t0 ^ t2)
        out = out ^ gate(b0 & b1, t0 ^ t1 ^ t2 ^ t3)
        return out

    return tuple(per_lane(x) for x in a)
