"""Batched k-mer window ops: the device-side heart of the framework.

Where the reference builds one k-mer at a time with a scalar loop
(naive_impl/kmer.rs:234-251) or rolls a window base-by-base
(canonical_kmer_iterator.rs:41-70), this module computes *every* window of a
read batch at once:

  ascii [.., L] --> codes --> log-doubling 16-base u32 words
        --> all L-k+1 window words as (hi, lo) uint32 pairs
        --> revcomp / canonical / hash, all elementwise.

The log-doubling trick: w1[p] = code of base p; w_{2s}[p] = w_s[p] |
w_s[p+s] << 2s.  After 4 steps w16[p] holds bases p..p+15 in one u32
(LSB-first, the reference's bit layout, naive_impl/kmer.rs:219-223).  A
k<=32 window at p is then (w16[p+16] masked, w16[p]).  All shifts static,
all ops VPU lane arithmetic: no gathers, no scalar loops, no dynamic shapes.

N-handling is mask-based (SURVEY §7): a window is valid iff all k bases are
valid; invalid windows carry garbage words and must be filtered by the mask,
which reproduces CanonicalKmerIterator's skip semantics
(canonical_kmer_iterator.rs:41-70) -- emitted (pos, kmer) pairs are
identical.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax.numpy as jnp

from ..core import u64 as u
from ..core.u64 import U64
from . import encoding


def _shift_left(a: jnp.ndarray, s: int) -> jnp.ndarray:
    """a'[.., p] = a[.., p+s], zero-padded at the tail (along last axis)."""
    if s == 0:
        return a
    if s >= a.shape[-1]:
        return jnp.zeros_like(a)
    pad = [(0, 0)] * (a.ndim - 1) + [(0, s)]
    return jnp.pad(a[..., s:], pad)


def pack_u32_words(codes: jnp.ndarray) -> jnp.ndarray:
    """w16[.., p] = bases p..p+15 packed LSB-first in a u32, for every p.

    codes: uint32 array of 2-bit codes, last axis = position in read.
    Positions within 15 of the end contain partial (zero-padded) words.
    """
    w = codes.astype(jnp.uint32) & u.u32(3)
    for s in (1, 2, 4, 8):
        w = w | (_shift_left(w, s) << (2 * s))
    return w


def window_words(codes: jnp.ndarray, k: int) -> U64:
    """All k-mer windows of a code array, as U64 (layout: base i at bits 2i).

    Returns U64 with the same shape as `codes`; entry p is the k-mer starting
    at base p.  Entries with p > L-k contain garbage (mask them).
    """
    assert 1 <= k <= 32
    w16 = pack_u32_words(codes)
    if k <= 16:
        lo = w16 & u.u32((1 << (2 * k)) - 1) if k < 16 else w16
        return U64(jnp.zeros_like(lo), lo)
    hi = _shift_left(w16, 16)
    if k < 32:
        hi = hi & u.u32((1 << (2 * (k - 16))) - 1)
    return U64(hi, w16)


def window_valid(valid: jnp.ndarray, k: int) -> jnp.ndarray:
    """window_valid[p] = AND of valid[p..p+k-1], via log-doubling AND."""
    assert k >= 1
    v = valid
    got = 1  # v[p] currently covers positions p..p+got-1
    s = 1
    while got < k:
        if got * 2 <= k:
            v = v & _shift_left(v, got)
            got *= 2
        else:
            v = v & _shift_left(v, k - got)
            got = k
    return v


class KmerWindows(NamedTuple):
    """All valid k-mer windows of a read batch (the batch analog of
    CanonicalKmerIterator)."""

    fw: U64            # forward words, garbage where ~valid
    rc: U64            # reverse-complement words
    valid: jnp.ndarray  # bool, True where the window contains no invalid base
    n_windows: int      # static: L - k + 1 (valid region of the pos axis)


def reverse_complement(fw: U64, k: int) -> U64:
    return u.reverse_complement(fw, k)


def canonical_word(fw: U64, rc: U64) -> U64:
    """min(fw, rc): the canonical strand (canonical_kmer.rs:112-119)."""
    return u.min_(fw, rc)


def is_fw_canonical(fw: U64, rc: U64) -> jnp.ndarray:
    """fw.data < rc.data (canonical_kmer.rs:66-69)."""
    return u.lt(fw, rc)


def is_canonical(fw: U64, k: int) -> jnp.ndarray:
    """Kmer::is_canonical: self <= rc (<=, naive_impl/kmer.rs:55-58)."""
    return u.le(fw, reverse_complement(fw, k))


def kmer_windows(ascii_u8: jnp.ndarray, k: int) -> KmerWindows:
    """Fused pack + window + canonical over a read batch.

    ascii_u8: [..., L] uint8 reads (pad ragged reads with any non-ACGT byte;
    padding reuses the N machinery).
    """
    L = ascii_u8.shape[-1]
    assert L >= k
    codes = encoding.ascii_to_codes(ascii_u8)
    vmask = encoding.valid_mask(ascii_u8)
    fw = window_words(codes, k)
    rc = reverse_complement(fw, k)
    wv = window_valid(vmask, k)
    # windows starting past L-k are structurally invalid
    n_win = L - k + 1
    idx = jnp.arange(L, dtype=jnp.int32)
    wv = wv & (idx < n_win)
    return KmerWindows(fw=fw, rc=rc, valid=wv, n_windows=n_win)


# -- packed-input windows (device side of the packed ingest path) --------------

def unpack_codes(words: jnp.ndarray, n_bases: int) -> jnp.ndarray:
    """[.., L/16] uint32 code words -> per-base 2-bit codes [.., L].

    Pure shift/mask lane work; XLA fuses it into the downstream
    log-doubling, so windowing from packed input costs no extra HBM pass.
    """
    shifts = jnp.arange(16, dtype=jnp.uint32) * 2
    codes = (words[..., :, None] >> shifts) & u.u32(3)
    return codes.reshape(*words.shape[:-1], n_bases)


def unpack_validbits(validbits: jnp.ndarray, n_bases: int) -> jnp.ndarray:
    """[.., L/32] uint32 validity bitmaps (1 bit/base LSB-first) -> bool
    [.., L]."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (validbits[..., :, None] >> shifts) & u.u32(1)
    return bits.reshape(*validbits.shape[:-1], n_bases).astype(bool)


def kmer_windows_packed(words: jnp.ndarray, validbits: jnp.ndarray,
                        k: int) -> KmerWindows:
    """kmer_windows over PACKED input: [B, L/16] uint32 code words +
    [B, L/32] uint32 validity bitmaps (the read_packed_batches ingest
    layout) instead of [B, L] ASCII -- 0.375 B/base of upload instead of 1.
    """
    L = words.shape[-1] * 16
    assert L >= k
    assert validbits.shape[-1] * 32 == L, (words.shape, validbits.shape)
    codes = unpack_codes(words, L)
    vmask = unpack_validbits(validbits, L)
    fw = window_words(codes, k)
    rc = reverse_complement(fw, k)
    wv = window_valid(vmask, k)
    n_win = L - k + 1
    idx = jnp.arange(L, dtype=jnp.int32)
    wv = wv & (idx < n_win)
    return KmerWindows(fw=fw, rc=rc, valid=wv, n_windows=n_win)


# -- rolling updates (API parity with naive_impl) ------------------------------

def append_base(data: U64, b: jnp.ndarray, k: int) -> Tuple[U64, jnp.ndarray]:
    """Kmer::append_base: shift right, insert at high end; returns
    (new, evicted low base) (naive_impl/kmer.rs:98-102)."""
    evicted = data.lo & u.u32(3)
    b64 = U64(jnp.zeros_like(data.hi), b.astype(jnp.uint32))
    new = u.or_(u.shr(data, 2), u.shl(b64, 2 * k - 2))
    return new, evicted


def prepend_base(data: U64, b: jnp.ndarray, k: int) -> Tuple[U64, jnp.ndarray]:
    """Kmer::prepend_base: shift left, insert at low end, mask; returns
    (new, evicted high base) (naive_impl/kmer.rs:91-95).

    Note the mask is MASK_TABLE[k]: for k == 32 that is 0 (the reference
    quirk), so prepend at k=32 zeroes the word -- replicated deliberately.
    """
    evicted = u.shr(data, 2 * k - 2).lo & u.u32(3)
    b64 = U64(jnp.zeros_like(data.hi), b.astype(jnp.uint32) & u.u32(3))
    mask = 0 if k == 32 else (1 << (2 * k)) - 1
    new = u.and_const(u.or_(u.shl(data, 2), b64), mask)
    return new, evicted


def ck_append_base(fw: U64, rc: U64, b: jnp.ndarray, k: int):
    """CanonicalKmer::append_base: append b to fw, prepend complement to rc
    (canonical_kmer.rs:89-94)."""
    new_fw, evicted = append_base(fw, b, k)
    cb = u.u32(3) - (b.astype(jnp.uint32) & u.u32(3))
    new_rc, _ = prepend_base(rc, cb, k)
    return new_fw, new_rc, evicted


def ck_prepend_base(fw: U64, rc: U64, b: jnp.ndarray, k: int):
    """CanonicalKmer::prepend_base (canonical_kmer.rs:96-101)."""
    new_fw, evicted = prepend_base(fw, b, k)
    cb = u.u32(3) - (b.astype(jnp.uint32) & u.u32(3))
    new_rc, _ = append_base(rc, cb, k)
    return new_fw, new_rc, evicted


# -- sub-kmers and minimizers ---------------------------------------------------

def sub_kmer_word(word: U64, k: int, pos: int, width: int) -> U64:
    """(word >> 2*pos) & mask(width) (naive_impl/kmer.rs:156-162)."""
    assert pos < k and pos + width <= k
    mask = (1 << (2 * width)) - 1 if width < 32 else (1 << 64) - 1
    return u.and_const(u.shr(word, 2 * pos), mask)


def match_type(fw: U64, rc: U64, other: U64) -> jnp.ndarray:
    """MatchType as int: 0 NoMatch, 1 IdentityMatch, 2 TwinMatch
    (canonical_kmer.rs:141-161).  Identity checked first."""
    ident = u.eq(fw, other)
    twin = u.eq(rc, other)
    return jnp.where(ident, 1, jnp.where(twin, 2, 0)).astype(jnp.int32)


def minimizer(
    word: U64,
    k: int,
    width: int,
    hash_fn: Callable[[U64], U64],
) -> Tuple[U64, jnp.ndarray]:
    """Leftmost argmin of hash over all k-width+1 sub-kmers
    (naive_impl/kmer.rs:170-192).  Unrolled static scan with strict-< update
    => leftmost tie wins, matching the reference exactly.

    Returns (minimizer words, offsets int32)."""
    best_mmer = sub_kmer_word(word, k, 0, width)
    best_hash = hash_fn(best_mmer)
    best_pos = jnp.zeros(word.lo.shape, dtype=jnp.int32)
    for pos in range(1, k - width + 1):
        mmer = sub_kmer_word(word, k, pos, width)
        h = hash_fn(mmer)
        take = u.lt(h, best_hash)
        best_mmer = u.where(take, mmer, best_mmer)
        best_hash = u.where(take, h, best_hash)
        best_pos = jnp.where(take, pos, best_pos)
    return best_mmer, best_pos


# -- multi-word k-mers (33 <= k <= 64; BASELINE config 3) ----------------------

from ..core import u128 as u128mod          # noqa: E402
from ..core.u128 import U128                # noqa: E402


def window_words_wide(codes: jnp.ndarray, k: int) -> U128:
    """All k-mer windows for 33 <= k <= 64 as U128 (2xu64 = 4xu32 lanes).

    Same log-doubling pack as the single-word path; a window at p is the
    four 16-base u32 words at p, p+16, p+32, p+48, with the top word masked.
    """
    assert 33 <= k <= 64
    w16 = pack_u32_words(codes)
    lo = U64(_shift_left(w16, 16), w16)
    hi_lo = _shift_left(w16, 32)
    hi_hi = _shift_left(w16, 48)
    rem = k - 32  # bases in the high u64
    if rem <= 16:
        hi_lo = hi_lo & u.u32((1 << (2 * rem)) - 1) if rem < 16 else hi_lo
        hi_hi = jnp.zeros_like(hi_hi)
    elif rem < 32:
        hi_hi = hi_hi & u.u32((1 << (2 * (rem - 16))) - 1)
    return U128(U64(hi_hi, hi_lo), lo)


class KmerWindowsWide(NamedTuple):
    fw: U128
    rc: U128
    valid: jnp.ndarray
    n_windows: int


def canonical_word_wide(fw: U128, rc: U128) -> U128:
    return u128mod.min_(fw, rc)


def kmer_windows_wide(ascii_u8: jnp.ndarray, k: int) -> KmerWindowsWide:
    """Fused pack + window + canonical for multi-word k (33 <= k <= 64)."""
    L = ascii_u8.shape[-1]
    assert L >= k
    codes = encoding.ascii_to_codes(ascii_u8)
    vmask = encoding.valid_mask(ascii_u8)
    fw = window_words_wide(codes, k)
    rc = u128mod.reverse_complement(fw, k)
    wv = window_valid(vmask, k)
    n_win = L - k + 1
    idx = jnp.arange(L, dtype=jnp.int32)
    wv = wv & (idx < n_win)
    return KmerWindowsWide(fw=fw, rc=rc, valid=wv, n_windows=n_win)


def kmer_windows_packed_wide(words: jnp.ndarray, validbits: jnp.ndarray,
                             k: int) -> KmerWindowsWide:
    """kmer_windows_wide over PACKED ingest batches (same layout as
    kmer_windows_packed; 33 <= k <= 64)."""
    L = words.shape[-1] * 16
    assert L >= k
    assert validbits.shape[-1] * 32 == L, (words.shape, validbits.shape)
    codes = unpack_codes(words, L)
    vmask = unpack_validbits(validbits, L)
    fw = window_words_wide(codes, k)
    rc = u128mod.reverse_complement(fw, k)
    wv = window_valid(vmask, k)
    n_win = L - k + 1
    idx = jnp.arange(L, dtype=jnp.int32)
    wv = wv & (idx < n_win)
    return KmerWindowsWide(fw=fw, rc=rc, valid=wv, n_windows=n_win)


def append_base_wide(data: U128, b: jnp.ndarray, k: int):
    """Rolling append for the wide path (shift right, insert at base k-1)."""
    assert 33 <= k <= 64
    evicted = data.lo.lo & u.u32(3)
    b128 = u128mod.from_u64(U64(jnp.zeros_like(data.lo.lo),
                                b.astype(jnp.uint32) & u.u32(3)))
    new = u128mod.or_(u128mod.shr(data, 2), u128mod.shl(b128, 2 * k - 2))
    return new, evicted


def prepend_base_wide(data: U128, b: jnp.ndarray, k: int):
    assert 33 <= k <= 64
    evicted = u128mod.shr(data, 2 * k - 2).lo.lo & u.u32(3)
    b128 = u128mod.from_u64(U64(jnp.zeros_like(data.lo.lo),
                                b.astype(jnp.uint32) & u.u32(3)))
    new = u128mod.and_const(
        u128mod.or_(u128mod.shl(data, 2), b128), (1 << (2 * k)) - 1)
    return new, evicted
