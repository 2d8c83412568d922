"""Batched generic k-mer layer: the device analog of ``Kmer<P, const K, B>``
(src/kmer.rs:12-14) over any word width P in {u8,u16,u32,u64,u128} and any
of the 24 Naive permutation encodings or Xor10 (src/encoding/).

Device representation is width-agnostic (core.wideint): a [P; B] word array
with LSB-first 2-bit bases IS a contiguous bitstring, so all widths share
one uint32-lane layout; P only governs padding semantics (decode emits the
storage-padding bases, the reference's documented quirk,
encoding/naive.rs:126-136) and host-side word formatting.

The reference's broken Xor10 single-word rev_comp fast path (xor10.rs:84,
tests disabled) is NOT reproduced; rev_comp here implements the correct
two-pointer semantics for every encoding (SURVEY.md §2 "known quirks").
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import jax.numpy as jnp
import numpy as np

from ..core import wideint as wi
from ..core.wideint import Lanes
from . import encoding as enc

#: discriminant bytes of the 24 Naive permutations (encoding/naive.rs:49-74)
#: and word_for_k (src/kmer.rs:67-69) -- single source of truth is the
#: oracle spec model (constants ARE the reference semantics)
from ..oracle.numpy_ref import NAIVE_PERMS, word_for_k  # noqa: E402,F401


@dataclasses.dataclass(frozen=True)
class GenericSpec:
    """Static configuration of a generic k-mer type.

    encoding: one of the 24 permutation strings (e.g. "ACGT") or "xor10".
    """

    width_bits: int
    k: int
    encoding: str = "ACTG"

    def __post_init__(self):
        if self.width_bits not in (8, 16, 32, 64, 128):
            raise ValueError(f"unsupported width {self.width_bits}")
        if self.encoding != "xor10" and self.encoding not in NAIVE_PERMS:
            raise ValueError(f"unknown encoding {self.encoding!r}")
        if self.k < 1:
            raise ValueError("k must be >= 1")

    @property
    def n_words(self) -> int:
        return word_for_k(self.width_bits, self.k)

    @property
    def total_bits(self) -> int:
        return self.width_bits * self.n_words

    @property
    def total_bases(self) -> int:
        """Storage base slots incl. padding (decode emits all of them)."""
        return self.total_bits // 2

    @property
    def n_lanes(self) -> int:
        return wi.n_lanes(self.total_bits)

    @property
    def disc(self) -> int:
        return 0b00_01_10_11 if self.encoding == "xor10" \
            else NAIVE_PERMS[self.encoding]

    @property
    def comp_table(self) -> List[int]:
        """code -> complement-code 2-bit LUT for this encoding."""
        if self.encoding == "xor10":
            return [c ^ 0b10 for c in range(4)]
        d = self.disc
        code_of = [(d >> (6 - 2 * i)) & 3 for i in range(4)]
        internal_of = [0] * 4
        for i, c in enumerate(code_of):
            internal_of[c] = i
        return [code_of[internal_of[c] ^ 0b10] for c in range(4)]


def base_codes(spec: GenericSpec, ascii_u8: jnp.ndarray) -> jnp.ndarray:
    """ASCII [.., k] -> per-base 2-bit codes under spec's encoding."""
    if spec.encoding == "xor10":
        return enc.ascii_to_internal(ascii_u8)       # (c>>1)&3
    return enc.perm_encode(ascii_u8, spec.disc)


def pack(spec: GenericSpec, codes: jnp.ndarray) -> Lanes:
    """Per-base codes [.., k] -> uint32 lanes [.., each], LSB-first."""
    k = codes.shape[-1]
    assert k == spec.k
    nl = spec.n_lanes
    pad = nl * 16 - k
    c = codes.astype(jnp.uint32) & jnp.uint32(3)
    if pad:
        c = jnp.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, pad)])
    c = c.reshape(c.shape[:-1] + (nl, 16))
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)
    lanes = (c << shifts).sum(axis=-1, dtype=jnp.uint32)
    return tuple(lanes[..., j] for j in range(nl))


def encode(spec: GenericSpec, ascii_u8: jnp.ndarray) -> Lanes:
    """Kmer::new(seq, &encoder) batched (src/kmer.rs:21-28)."""
    return pack(spec, base_codes(spec, ascii_u8))


def encode_windows(spec: GenericSpec, ascii_u8: jnp.ndarray):
    """Kmer::new over ALL k-windows of [.., L] reads at once: returns
    (lanes, valid) where lanes[j][.., p] is word-lane j of the k-mer
    starting at base p, and valid[p] = (p <= L-k) (the generic encoder
    itself accepts any byte, reference encoding/naive.rs:14-16 -- there
    is no N concept at this layer, so validity is structural only).

    This is the windowed construction VERDICT r3 item 5 asked for: the
    per-kmer layout (encode on [N, k] slices) re-reads every base k
    times; here each base is encoded ONCE and windows are assembled from
    the shared 16-base log-doubling pack (ops.kmer.pack_u32_words), the
    same trick the naive_impl window path uses (ops.kmer).  Bit-identical
    to per-window `encode`
    (reference construct loop, benches/simple_benchmark.rs:14-34) at
    valid positions; lanes at p > L-k are garbage (mask them).
    """
    from . import kmer as kmer_ops

    k = spec.k
    assert k <= ascii_u8.shape[-1]
    L = ascii_u8.shape[-1]
    codes = base_codes(spec, ascii_u8).astype(jnp.uint32)
    w16 = kmer_ops.pack_u32_words(codes)
    lanes = []
    for j in range(spec.n_lanes):
        bits = 2 * k - 32 * j          # payload bits left for this lane
        if bits <= 0:
            lanes.append(jnp.zeros_like(w16))
            continue
        lane = kmer_ops._shift_left(w16, 16 * j)
        if bits < 32:
            lane = lane & jnp.uint32((1 << bits) - 1)
        lanes.append(lane)
    idx = jnp.arange(L, dtype=jnp.int32)
    valid = jnp.broadcast_to(idx <= L - k, ascii_u8.shape)
    return tuple(lanes), valid


def unpack_codes(spec: GenericSpec, lanes: Lanes) -> jnp.ndarray:
    """Lanes -> per-base codes [.., total_bases] (INCLUDING padding slots,
    the decode quirk)."""
    shifts = jnp.arange(16, dtype=jnp.uint32) * 2
    per_lane = [((x[..., None] >> shifts) & jnp.uint32(3))
                for x in lanes]
    codes = jnp.concatenate(per_lane, axis=-1)
    return codes[..., : spec.total_bases]


def decode(spec: GenericSpec, lanes: Lanes) -> jnp.ndarray:
    """Lanes -> ASCII [.., total_bases]; decodes all storage bits incl. the
    padding bases (encoding/naive.rs:126-136)."""
    codes = unpack_codes(spec, lanes)
    if spec.encoding == "xor10":
        # internal order -> b"ACTG"
        internal = codes
        b0 = internal & jnp.uint32(1)
        b1 = (internal >> 1) & jnp.uint32(1)
        A_, C_, T_, G_ = ord("A"), ord("C"), ord("T"), ord("G")
        out = (jnp.uint32(A_)
               + b0 * jnp.uint32((C_ - A_) & 0xFFFFFFFF)
               + b1 * (jnp.uint32((T_ - A_) & 0xFFFFFFFF)
                       + b0 * jnp.uint32((G_ - T_ - C_ + A_) & 0xFFFFFFFF)))
        return out.astype(jnp.uint8)
    return enc.perm_decode(codes, spec.disc)


def rev_comp(spec: GenericSpec, lanes: Lanes) -> Lanes:
    """Two-pointer reverse-complement over the low K bases
    (encoding/naive.rs:138-154 / the corrected xor10 semantics)."""
    comp = wi.map2bit(lanes, spec.comp_table)
    return wi.reverse_bases_k(comp, spec.k)


def get(spec: GenericSpec, lanes: Lanes, index: int) -> jnp.ndarray:
    """Kmer::get(i): the 2-bit code of base i (src/kmer.rs:46-48)."""
    bit = 2 * index
    lane, off = bit // 32, bit % 32
    return (lanes[lane] >> jnp.uint32(off)) & jnp.uint32(3)


def get_prefix(spec: GenericSpec, lanes: Lanes, length: int) -> Lanes:
    """Kmer::get_prefix(len): reads bits 0..=len*2 -- i.e. 2*len+1 bits,
    the reference's inclusive-range off-by-one, replicated exactly
    (src/kmer.rs:50-52)."""
    nbits = 2 * length + 1
    return wi.and_const(lanes, (1 << nbits) - 1)


# -- host-side word formatting (parity / serialization) ------------------------

def lanes_to_words(spec: GenericSpec, lanes: Lanes) -> np.ndarray:
    """Lanes -> host [.., n_words] array of P-width words (object dtype for
    u128)."""
    vals = wi.to_python_ints(lanes)
    shape = np.asarray(lanes[0]).shape
    P = spec.width_bits
    mask = (1 << P) - 1
    out = [[(v >> (P * w)) & mask for w in range(spec.n_words)]
           for v in vals]
    arr = np.array(out, dtype=object)
    return arr.reshape(shape + (spec.n_words,))


def words_to_lanes(spec: GenericSpec, words) -> Lanes:
    """Host [.., n_words] P-width ints -> Lanes."""
    arr = np.array(words, dtype=object)
    if arr.shape[-1] != spec.n_words:
        raise ValueError(
            f"expected last dim {spec.n_words} words for k={spec.k} "
            f"P=u{spec.width_bits}, got {arr.shape[-1]}")
    flat = arr.reshape(-1, spec.n_words)
    P = spec.width_bits
    vals = [sum(int(w) << (P * i) for i, w in enumerate(row)) for row in flat]
    return wi.from_python_ints(vals, spec.n_lanes)


# -- trivial accessors (API parity with src/kmer.rs) ---------------------------

def k_of(spec: GenericSpec) -> int:
    """Kmer::k() (src/kmer.rs:36-38)."""
    return spec.k


def num_bytes(spec: GenericSpec) -> int:
    """Kmer::num_bytes(): storage bytes of the word array
    (src/kmer.rs:41-43)."""
    return spec.total_bits // 8


def default(spec: GenericSpec, shape=()) -> Lanes:
    """Kmer::default(): zeroed storage (src/kmer.rs:55-64)."""
    import jax.numpy as _jnp

    return tuple(_jnp.zeros(shape, dtype=_jnp.uint32)
                 for _ in range(spec.n_lanes))


def with_data(spec: GenericSpec, words) -> Lanes:
    """Kmer::with_data(array) (src/kmer.rs:31-33)."""
    return words_to_lanes(spec, words)
