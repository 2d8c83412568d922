"""Batched ASCII <-> 2-bit base codecs (jnp, jit-able).

Batched replacement for the reference's scalar per-base loops:
  * naive_impl table A=0,C=1,G=2,T=3 (src/naive_impl/mod.rs:19-50) -- the
    normative order used by canonical/hash/minimizer paths.
  * the internal/Xor10 order A=0,C=1,T=2,G=3 = (ascii >> 1) & 3
    (src/encoding/naive.rs:14-16, src/encoding/xor10.rs:17-22).
  * the 24 Naive permutation encodings (src/encoding/naive.rs:49-74).

Instead of a 256-entry lookup table (a gather) we use pure
lane arithmetic:

  internal = (c >> 1) & 3        # A=0, C=1, T=2, G=3 (works upper+lower)
  acgt     = internal ^ (internal >> 1)   # swaps T<->G => A=0,C=1,G=2,T=3

and validity as four lane compares on the lowercased byte.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import u64 as u


def ascii_to_internal(ascii_u8: jnp.ndarray) -> jnp.ndarray:
    """ASCII bytes -> internal codes A=0,C=1,T=2,G=3 (uint32).  Garbage for
    non-ACGT bytes; pair with `valid_mask`."""
    c = ascii_u8.astype(jnp.uint32)
    return (c >> 1) & u.u32(3)


def internal_to_acgt(internal: jnp.ndarray) -> jnp.ndarray:
    """Internal order -> naive_impl order (swap codes 2 and 3)."""
    return internal ^ (internal >> 1)


def acgt_to_internal(codes: jnp.ndarray) -> jnp.ndarray:
    """naive_impl order -> internal order (same involution)."""
    return codes ^ (codes >> 1)


def ascii_to_codes(ascii_u8: jnp.ndarray) -> jnp.ndarray:
    """ASCII bytes -> naive_impl 2-bit codes (A=0,C=1,G=2,T=3), uint32.
    Garbage for invalid bytes; pair with `valid_mask`
    (semantics: mod.rs:40-50 without the sentinel -- the sentinel's role is
    played by the mask)."""
    return internal_to_acgt(ascii_to_internal(ascii_u8))


def valid_mask(ascii_u8: jnp.ndarray) -> jnp.ndarray:
    """True where the byte is one of ACGTacgt (mod.rs:40-50)."""
    l = ascii_u8.astype(jnp.uint32) | u.u32(0x20)  # lowercase
    return (l == u.u32(ord("a"))) | (l == u.u32(ord("c"))) | \
           (l == u.u32(ord("g"))) | (l == u.u32(ord("t")))


_ACGT_UPPER = tuple(b"ACGT")
_ACGT_LOWER = tuple(b"acgt")


def codes_to_ascii(codes: jnp.ndarray, lower: bool = True) -> jnp.ndarray:
    """naive_impl codes -> ASCII.  lower=True mirrors Kmer->String's
    lowercase table (naive_impl/kmer.rs:24); upper mirrors SeqVector's
    (seq_vector.rs:174)."""
    tbl = _ACGT_LOWER if lower else _ACGT_UPPER
    c = codes.astype(jnp.uint32) & u.u32(3)
    # branchless 4-way select via arithmetic on the two code bits
    b0 = c & u.u32(1)
    b1 = (c >> 1) & u.u32(1)
    out = (
        u.u32(tbl[0])
        + b0 * u.u32((tbl[1] - tbl[0]) & 0xFFFFFFFF)
        + b1 * (u.u32((tbl[2] - tbl[0]) & 0xFFFFFFFF)
                + b0 * u.u32((tbl[3] - tbl[2] - tbl[1] + tbl[0]) & 0xFFFFFFFF))
    )
    return out.astype(jnp.uint8)


# -- generic-layer encodings (24 Naive permutations + Xor10) -------------------

def perm_encode(ascii_u8: jnp.ndarray, disc: int) -> jnp.ndarray:
    """ASCII -> 2-bit codes under a Naive permutation with discriminant byte
    `disc` (encoding/naive.rs:78-85).  disc is static."""
    internal = ascii_to_internal(ascii_u8)
    # code = (disc >> (6 - 2*internal)) & 3, with traced shift amount
    shift = u.u32(6) - (internal << 1)
    return (u.u32(disc) >> shift) & u.u32(3)


def rev_encoding(disc: int) -> int:
    """Inverse permutation byte (encoding/naive.rs:29-39), computed on host."""
    rev = 0
    rev ^= 0b00 << (6 - ((disc >> 6) & 3) * 2)
    rev ^= 0b01 << (6 - ((disc >> 4) & 3) * 2)
    rev ^= 0b10 << (6 - ((disc >> 2) & 3) * 2)
    rev ^= 0b11 << (6 - (disc & 3) * 2)
    return rev


_rev_disc = rev_encoding


def perm_decode(codes: jnp.ndarray, disc: int) -> jnp.ndarray:
    """2-bit codes -> ASCII under a Naive permutation
    (encoding/naive.rs:88-95)."""
    rev = _rev_disc(disc)
    c = codes.astype(jnp.uint32) & u.u32(3)
    internal = (u.u32(rev) >> (u.u32(6) - (c << 1))) & u.u32(3)
    # INTERNAL2NUC = b"ACTG" (naive.rs:19)
    b0 = internal & u.u32(1)
    b1 = (internal >> 1) & u.u32(1)
    A_, C_, T_, G_ = ord("A"), ord("C"), ord("T"), ord("G")
    out = (
        u.u32(A_)
        + b0 * u.u32((C_ - A_) & 0xFFFFFFFF)
        + b1 * (u.u32((T_ - A_) & 0xFFFFFFFF)
                + b0 * u.u32((G_ - T_ - C_ + A_) & 0xFFFFFFFF))
    )
    return out.astype(jnp.uint8)


def perm_complement(codes: jnp.ndarray, disc: int) -> jnp.ndarray:
    """Complement in a Naive permutation: internal complement is ^0b10
    (encoding/naive.rs:98-109)."""
    rev = _rev_disc(disc)
    c = codes.astype(jnp.uint32) & u.u32(3)
    internal = (u.u32(rev) >> (u.u32(6) - (c << 1))) & u.u32(3)
    comp_internal = internal ^ u.u32(0b10)
    return (u.u32(disc) >> (u.u32(6) - (comp_internal << 1))) & u.u32(3)
