"""Vectorized sliding-window minimizers (device analog of
src/naive_impl/seq_vector/minimizers.rs).

The reference streams a monotone deque -- amortized O(1) per k-mer but
inherently sequential.  The batched design computes, for every k-mer i of a
sequence, the leftmost w-mer with minimal hash among positions
[i, i + k - w]: a static unrolled scan of k-w+1 shifted hash arrays with
strict-< updates.  Output is element-wise identical to the deque
(leftmost-tie rule: minimizers.rs:72-79; per-k-mer emission:
minimizers.rs:124-142), verified in tests against the oracle.

Cost: (k-w+1) vector passes over the position axis -- all VPU lane ops, no
data-dependent control flow, trivially batchable over reads.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax.numpy as jnp

from ..core import u64 as u
from ..core.u64 import U64
from . import encoding
from .kmer import _shift_left, window_valid, window_words


class MappedMinimizer(NamedTuple):
    """Scalar (word, pos) minimizer record (minimizers.rs:20-36)."""

    word: int
    pos: int


class MappedMinimizers(NamedTuple):
    """Per-k-mer minimizers: the batch analog of
    Iterator<Item=MappedMinimizer> (minimizers.rs:20-36)."""

    word: U64            # minimizer w-mer word per k-mer position
    pos: jnp.ndarray     # absolute position of the w-mer in the sequence
    valid: jnp.ndarray   # True where the k-mer window is fully valid
    n_kmers: int         # static: L - k + 1


def _shift_u64(a: U64, s: int) -> U64:
    return U64(_shift_left(a.hi, s), _shift_left(a.lo, s))


def sliding_argmin(
    hashes: U64, window: int
) -> Tuple[U64, jnp.ndarray]:
    """For each position i, (min hash, leftmost offset) over
    hashes[i .. i+window-1].  Strict-< scan => leftmost tie wins."""
    best_hash = hashes
    best_off = jnp.zeros(hashes.lo.shape, dtype=jnp.int32)
    for off in range(1, window):
        h = _shift_u64(hashes, off)
        take = u.lt(h, best_hash)
        best_hash = u.where(take, h, best_hash)
        best_off = jnp.where(take, off, best_off)
    return best_hash, best_off


def minimizer_stream(
    ascii_u8: jnp.ndarray,
    k: int,
    w: int,
    hash_fn: Callable[[U64], U64],
) -> MappedMinimizers:
    """All per-k-mer minimizers of a read batch [..., L].

    Matches SeqVector::iter_minimizers(k, w, bh) element-wise
    (minimizers.rs:97-142): k-mer i yields (wmer word, wmer position) of the
    leftmost minimal-hash w-mer in [i, i + k - w].
    """
    L = ascii_u8.shape[-1]
    assert L >= k >= w >= 1
    codes = encoding.ascii_to_codes(ascii_u8)
    vmask = encoding.valid_mask(ascii_u8)
    wmers = window_words(codes, w)          # w-mer at every position
    hashes = hash_fn(wmers)
    _, best_off = sliding_argmin(hashes, k - w + 1)
    # gather the winning w-mer: word[i] = wmers[i + best_off[i]]
    idx = jnp.arange(L, dtype=jnp.int32)
    src = jnp.minimum(idx + best_off, L - 1)
    word = U64(
        jnp.take_along_axis(wmers.hi, src, axis=-1),
        jnp.take_along_axis(wmers.lo, src, axis=-1),
    )
    n_kmers = L - k + 1
    wv = window_valid(vmask, k) & (idx < n_kmers)
    return MappedMinimizers(word=word, pos=idx + best_off, valid=wv, n_kmers=n_kmers)


def minimizer_stream_from_words(
    wmers: U64,
    n_positions: int,
    k: int,
    w: int,
    hash_fn: Callable[[U64], U64],
) -> Tuple[U64, jnp.ndarray]:
    """Same, but starting from precomputed w-mer words at every position
    (for SeqVector-backed iteration).  Returns (word, pos) arrays over the
    position axis; entries past n_positions - k + w - 1 are garbage."""
    hashes = hash_fn(wmers)
    _, best_off = sliding_argmin(hashes, k - w + 1)
    idx = jnp.arange(wmers.lo.shape[-1], dtype=jnp.int32)
    src = jnp.minimum(idx + best_off, wmers.lo.shape[-1] - 1)
    word = U64(
        jnp.take_along_axis(wmers.hi, src, axis=-1),
        jnp.take_along_axis(wmers.lo, src, axis=-1),
    )
    return word, idx + best_off
