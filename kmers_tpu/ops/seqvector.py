"""Packed 2-bit sequence storage on device (analog of
src/naive_impl/seq_vector.rs over simple_sds::RawVector).

Layout parity: base i occupies bits [2i mod 32] of uint32 word i // 16; the
little-endian base order is identical to the reference's RawVector u64
layout (a u64 word j of the reference == our words[2j] | words[2j+1] << 32),
so serialized data round-trips bit-exactly (endian-stable, like the
reference's s390x CI guarantee, .github/workflows/main.yml:115-139).

Unaligned k-mer reads (seq_vector.rs:96-99) become vectorized 3-word
funnel shifts: for bit offset b = 2*pos, the 2k <= 64 window bits are

    lo = w[i] >> r  |  w[i+1] << (32-r)
    hi = w[i+1] >> r |  w[i+2] << (32-r)        (i = b >> 5, r = b & 31)

computed for a whole position array at once.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import jax.numpy as jnp
import numpy as np

from ..core import u64 as u
from ..core.u64 import U64
from . import encoding


def pack_ascii_to_words(ascii_u8: np.ndarray) -> np.ndarray:
    """Host-side pack: ASCII bytes -> uint32 words, 16 bases per word,
    LSB-first.  (ops.kmer packs on the device; this is the loader/compat
    path.)"""
    arr = np.asarray(ascii_u8, dtype=np.uint8)
    n = len(arr)
    internal = (arr.astype(np.uint32) >> 1) & 3
    codes = internal ^ (internal >> 1)
    n_words = (n + 15) // 16
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:n] = codes
    padded = padded.reshape(n_words, 16)
    shifts = np.arange(16, dtype=np.uint32) * 2
    return np.bitwise_or.reduce(padded << shifts, axis=1).astype(np.uint32)


def unpack_words_to_codes(words: jnp.ndarray, n_bases: int) -> jnp.ndarray:
    """uint32 words -> per-base 2-bit codes [n_bases] (device)."""
    shifts = jnp.arange(16, dtype=jnp.uint32) * 2
    codes = (words[:, None] >> shifts[None, :]) & u.u32(3)
    return codes.reshape(-1)[:n_bases]


def gather_kmers(words: jnp.ndarray, positions: jnp.ndarray, k: int) -> U64:
    """get_kmer_u64 for an array of base positions (seq_vector.rs:96-99).

    words: [n_words] uint32 (pad with >= 2 zero words at the end).
    positions: int32 array of base offsets.
    """
    assert 1 <= k <= 32
    bit = positions.astype(jnp.uint32) << 1
    wi = (bit >> 5).astype(jnp.int32)
    r = bit & u.u32(31)
    w0 = jnp.take(words, wi, axis=0)
    w1 = jnp.take(words, wi + 1, axis=0)
    w2 = jnp.take(words, wi + 2, axis=0)
    # r may be 0: (x << 32) is undefined; split the funnel shift
    carry1 = jnp.where(r == 0, u.u32(0), w1 << ((u.u32(32) - r) & u.u32(31)))
    carry2 = jnp.where(r == 0, u.u32(0), w2 << ((u.u32(32) - r) & u.u32(31)))
    lo = (w0 >> r) | carry1
    hi = (w1 >> r) | carry2
    out = U64(hi, lo)
    mask = (1 << (2 * k)) - 1 if k < 32 else (1 << 64) - 1
    return u.and_const(out, mask)


class SeqVector:
    """Device-backed 2-bit packed sequence with reference-parity API.

    Construction packs on host (or accepts device words); reads are batched
    device ops.  Scalar accessors exist for API parity but the intended use
    is the batched ``get_kmers`` / ``iter_minimizers`` paths.
    """

    def __init__(self, words: jnp.ndarray, n_bases: int):
        # keep 2 spare zero words so 3-word funnel reads never go OOB
        self.words = jnp.asarray(words, dtype=jnp.uint32)
        self.n_bases = n_bases

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def from_bytes(data: bytes) -> "SeqVector":
        words = pack_ascii_to_words(np.frombuffer(data, dtype=np.uint8))
        words = np.concatenate([words, np.zeros(2, dtype=np.uint32)])
        return SeqVector(jnp.asarray(words), len(data))

    @staticmethod
    def from_str(data: str) -> "SeqVector":
        return SeqVector.from_bytes(data.encode())

    @staticmethod
    def with_capacity(n_bases: int) -> "SeqVector":
        """Empty vector sized for n_bases (seq_vector.rs:135-139); fill with
        push_chars.  Device arrays are immutable, so capacity is a hint."""
        del n_bases
        return SeqVector.from_bytes(b"")

    def push_chars(self, data: bytes) -> None:
        """Append bases (seq_vector.rs:141-161): pack only the NEW bases and
        OR them in at the bit boundary (word-level funnel shift).  O(existing
        words + new bases) -- never decodes or re-packs the existing payload.
        """
        if not data:
            return
        n = self.n_bases
        host = np.asarray(self.words, dtype=np.uint32)
        used = (n + 15) // 16                 # words holding current bases
        nw = pack_ascii_to_words(np.frombuffer(data, dtype=np.uint8))
        total = n + len(data)
        out = np.zeros((total + 15) // 16 + 2, dtype=np.uint32)
        out[:used] = host[:used]
        r = 2 * (n % 16)
        if r == 0:
            out[used:used + len(nw)] = nw
        else:
            ext = np.zeros(len(nw) + 1, dtype=np.uint32)
            ext[:-1] |= nw << np.uint32(r)
            ext[1:] |= nw >> np.uint32(32 - r)
            out[used - 1:used - 1 + len(ext)] |= ext
        self.words = jnp.asarray(out)
        self.n_bases = total

    # -- accessors ------------------------------------------------------------

    def __len__(self) -> int:
        return self.n_bases

    def is_empty(self) -> bool:
        return self.n_bases == 0

    def get_kmers(self, positions: jnp.ndarray, k: int) -> U64:
        return gather_kmers(self.words, positions, k)

    def get_kmer_u64(self, pos: int, k: int) -> int:
        assert pos < self.n_bases
        out = gather_kmers(self.words, jnp.asarray([pos], dtype=jnp.int32), k)
        return int(u.to_numpy(out)[0])

    def get_base(self, pos: int) -> int:
        return self.get_kmer_u64(pos, 1)

    def all_kmers(self, k: int) -> Tuple[U64, int]:
        """All len-k+1 k-mer words (SeqVecKmerIterator's batch form,
        seq_vector.rs:260-300)."""
        n = self.n_bases - k + 1
        pos = jnp.arange(n, dtype=jnp.int32)
        return self.get_kmers(pos, k), n

    def iter_kmers(self, k: int) -> Iterator[Tuple[int, int]]:
        """Scalar-compat iterator yielding (word, k) per position."""
        words, n = self.all_kmers(k)
        host = u.to_numpy(words)
        for i in range(n):
            yield int(host[i]), k

    def iter_minimizers(
        self, k: int, w: int, hash_fn: Callable[[U64], U64]
    ) -> Iterator[Tuple[int, int]]:
        """Scalar-compat (word, pos) per k-mer; see minimizers module for the
        batch path."""
        word, pos = self.minimizers(k, w, hash_fn)
        hw = u.to_numpy(word)
        hp = np.asarray(pos)
        for i in range(self.n_bases - k + 1):
            yield int(hw[i]), int(hp[i])

    def minimizers(self, k: int, w: int, hash_fn) -> Tuple[U64, jnp.ndarray]:
        from .minimizer import minimizer_stream_from_words

        n_pos = self.n_bases - w + 1
        pos = jnp.arange(n_pos, dtype=jnp.int32)
        wmers = self.get_kmers(pos, w)
        word, mpos = minimizer_stream_from_words(wmers, n_pos, k, w, hash_fn)
        n_kmers = self.n_bases - k + 1
        return (
            U64(word.hi[:n_kmers], word.lo[:n_kmers]),
            mpos[:n_kmers],
        )

    def to_string(self) -> str:
        codes = unpack_words_to_codes(self.words, self.n_bases)
        ascii_arr = encoding.codes_to_ascii(codes, lower=False)
        return bytes(np.asarray(ascii_arr)).decode()

    def __str__(self) -> str:
        return self.to_string()

    # -- checkpoint (serde analog, SURVEY §5.4) --------------------------------

    def save(self, path: str) -> None:
        """Endian-stable on-disk layout: uint32 little-endian words of the
        2-bit LSB-first packing + base count."""
        np.savez(path, words=np.asarray(self.words, dtype="<u4"),
                 n_bases=np.int64(self.n_bases))

    @staticmethod
    def load(path: str) -> "SeqVector":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return SeqVector(jnp.asarray(z["words"].astype(np.uint32)),
                         int(z["n_bases"]))

    # -- simple_sds interop (the reference's serialized format) ----------------
    #
    # The reference's SeqVector wraps simple_sds::RawVector
    # (seq_vector.rs:18-22) and builds from RawVector/IntVector with layout
    # asserts (seq_vector.rs:244-258).  simple-sds serializes RawVector as:
    #   u64 LE: length in BITS
    #   u64 LE: number of u64 data words
    #   that many u64 LE words, bits LSB-first
    # and IntVector as: u64 LE element count, u64 LE width, then the
    # RawVector body.  Our uint32 word pairs (lo, hi) concatenate to exactly
    # those u64 words, so the round-trip is bit-exact.

    def to_simple_sds(self) -> bytes:
        """Serialize as a simple_sds RawVector byte stream."""
        n_bits = 2 * self.n_bases
        n64 = (n_bits + 63) // 64
        w32 = np.zeros(2 * n64, dtype=np.uint32)
        host = np.asarray(self.words, dtype=np.uint32)
        w32[:min(len(host), 2 * n64)] = host[:2 * n64]
        data64 = (w32[0::2].astype(np.uint64)
                  | (w32[1::2].astype(np.uint64) << np.uint64(32)))
        head = np.array([n_bits, n64], dtype="<u8")
        return head.tobytes() + data64.astype("<u8").tobytes()

    def save_simple_sds(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_simple_sds())

    @staticmethod
    def from_simple_sds(data: bytes) -> "SeqVector":
        """Deserialize a simple_sds RawVector (From<RawVector> parity:
        asserts even bit length, seq_vector.rs:244-249)."""
        n_bits, n64 = np.frombuffer(data[:16], dtype="<u8")
        n_bits, n64 = int(n_bits), int(n64)
        if n_bits % 2 != 0:
            raise ValueError("RawVector bit length must be even "
                             "(seq_vector.rs:245)")
        if n64 != (n_bits + 63) // 64:
            raise ValueError("corrupt RawVector: word count mismatch")
        d64 = np.frombuffer(data[16:16 + 8 * n64], dtype="<u8")
        if len(d64) != n64:
            raise ValueError("truncated RawVector data")
        w32 = np.zeros(2 * n64 + 2, dtype=np.uint32)   # +2 spare funnel words
        w32[0:2 * n64:2] = (d64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        w32[1:2 * n64:2] = (d64 >> np.uint64(32)).astype(np.uint32)
        return SeqVector(jnp.asarray(w32), n_bits // 2)

    @staticmethod
    def load_simple_sds(path: str) -> "SeqVector":
        with open(path, "rb") as f:
            return SeqVector.from_simple_sds(f.read())

    @staticmethod
    def from_simple_sds_int_vector(data: bytes) -> "SeqVector":
        """Deserialize a simple_sds IntVector (From<IntVector> parity:
        asserts width == 2, seq_vector.rs:251-258)."""
        n_elems, width = np.frombuffer(data[:16], dtype="<u8")
        if int(width) != 2:
            raise ValueError("IntVector width must be 2 (seq_vector.rs:252)")
        sv = SeqVector.from_simple_sds(data[16:])
        if sv.n_bases != int(n_elems):
            raise ValueError("corrupt IntVector: element count mismatch")
        return sv


class SeqVectorSlice:
    """Zero-copy view over a SeqVector (seq_vector.rs:24-81): same device
    words, base offset applied at read time."""

    def __init__(self, sv: "SeqVector", start_pos: int, length: int):
        assert 0 <= start_pos and start_pos + length <= sv.n_bases
        self.sv = sv
        self.start_pos = start_pos
        self.length = length

    def __len__(self) -> int:
        return self.length

    def is_empty(self) -> bool:
        return self.length == 0

    def get_kmers(self, positions: jnp.ndarray, k: int) -> U64:
        return self.sv.get_kmers(positions + self.start_pos, k)

    def get_kmer_u64(self, pos: int, k: int) -> int:
        assert pos + k <= self.length
        return self.sv.get_kmer_u64(pos + self.start_pos, k)

    def get_base(self, pos: int) -> int:
        return self.get_kmer_u64(pos, 1)

    def slice(self, start: int, end: int) -> "SeqVectorSlice":
        assert start <= end <= self.length
        return SeqVectorSlice(self.sv, self.start_pos + start, end - start)

    def iter_kmers(self, k: int):
        n = self.length - k + 1
        pos = jnp.arange(n, dtype=jnp.int32)
        host = u.to_numpy(self.get_kmers(pos, k))
        for i in range(n):
            yield int(host[i]), k

    def to_string(self) -> str:
        codes = unpack_words_to_codes(self.sv.words, self.sv.n_bases)
        codes = codes[self.start_pos:self.start_pos + self.length]
        return bytes(np.asarray(encoding.codes_to_ascii(codes, lower=False))
                     ).decode()

    def __str__(self) -> str:
        return self.to_string()


def _sv_as_slice(self) -> "SeqVectorSlice":
    return SeqVectorSlice(self, 0, self.n_bases)


def _sv_slice(self, start: int, end: int) -> "SeqVectorSlice":
    assert start <= end <= self.n_bases
    return SeqVectorSlice(self, start, end - start)


SeqVector.as_slice = _sv_as_slice
SeqVector.slice = _sv_slice


class SeqVecKmerIterator:
    """Name-parity iterator over all k-mers (seq_vector.rs:260-300).

    Yields (word, k) like ``SeqVector.iter_kmers`` -- one batched device
    gather up front, then host iteration.
    """

    def __init__(self, sv: "SeqVector", k: int):
        self.k = k
        words, self.n = sv.all_kmers(k)
        self._host = u.to_numpy(words)
        self._i = 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> "SeqVecKmerIterator":
        return self

    def __next__(self) -> Tuple[int, int]:
        if self._i >= self.n:
            raise StopIteration
        out = (int(self._host[self._i]), self.k)
        self._i += 1
        return out


class SeqVecMinimizerIter:
    """Name-parity minimizer iterator (minimizers.rs:97-142): one
    MappedMinimizer-equivalent (word, pos) per k-mer, deque-identical
    output incl. the leftmost-tie rule, computed as one batched device op."""

    def __init__(self, sv: "SeqVector", k: int, w: int, hash_fn):
        word, pos = sv.minimizers(k, w, hash_fn)
        self._words = u.to_numpy(word)
        self._pos = np.asarray(pos)
        self.n = len(sv) - k + 1
        self._i = 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> "SeqVecMinimizerIter":
        return self

    def __next__(self):
        from .minimizer import MappedMinimizer

        if self._i >= self.n:
            raise StopIteration
        out = MappedMinimizer(word=int(self._words[self._i]),
                              pos=int(self._pos[self._i]))
        self._i += 1
        return out
