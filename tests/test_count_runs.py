"""Run-length count tables (count_words / count_words_wide with
compact=False) and the key sorts under them (sort_by_word) against NumPy
models, at the lane counts, duplicate densities and invalid-lane mixes of
the segment-count and bitonic-sort kernels this path replaced."""

import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kmers_tpu.core.u64 import U64
from kmers_tpu.core.u128 import U128
from kmers_tpu.parallel import count as count_ops
from kmers_tpu.parallel import pipeline

RNG = np.random.default_rng(4242)


def keys_with_runs(n, n_distinct, invalid_frac=0.1, top_bits=30):
    """n keys drawn from a small universe (long duplicate runs) plus a
    validity mask."""
    uni = ((RNG.integers(0, 1 << top_bits, n_distinct).astype(np.uint64)
            << np.uint64(32))
           | RNG.integers(0, 1 << 32, n_distinct).astype(np.uint64))
    keys = uni[RNG.integers(0, n_distinct, n)]
    return keys, RNG.random(n) >= invalid_frac


def u64_of(keys):
    return U64(jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
               jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def as_u64(x):
    return ((np.asarray(x.hi, np.uint64) << np.uint64(32))
            | np.asarray(x.lo, np.uint64))


def assert_runs_match(table_keys, counts, n_unique, want_sorted):
    """Run-length form: valid keys sorted WITH duplicates first, the run
    length at each run start, zero elsewhere."""
    nv = want_sorted.size
    np.testing.assert_array_equal(table_keys[:nv], want_sorted)
    starts = np.ones(nv, bool)
    starts[1:] = want_sorted[1:] != want_sorted[:-1]
    idx = np.flatnonzero(starts)
    want_counts = np.zeros(counts.size, np.int64)
    want_counts[idx] = np.diff(np.append(idx, nv))
    np.testing.assert_array_equal(counts, want_counts)
    assert int(n_unique) == idx.size


@pytest.mark.parametrize("n,n_distinct", [(1024, 50), (4096, 500),
                                          (5000, 2000), (300, 3),
                                          (8192, 8192), (2048, 1),
                                          (2048, 64)])
def test_runlength_table_matches_model(n, n_distinct):
    keys, valid = keys_with_runs(n, n_distinct)
    t = count_ops.count_words(u64_of(keys), jnp.asarray(valid), max_k=31,
                              compact=False)
    assert_runs_match(as_u64(t.keys), np.asarray(t.counts), t.n_unique,
                      np.sort(keys[valid]))


def test_runlength_counts_conserve_mass():
    keys, valid = keys_with_runs(4096, 11)
    t = count_ops.count_words(u64_of(keys), jnp.asarray(valid), max_k=31,
                              compact=False)
    assert int(np.asarray(t.counts).sum()) == int(valid.sum())


def test_runlength_table_merges_to_exact_counts():
    """The property streaming relies on: a run-length table fed through
    the weighted re-count (merge_many) gives the compact table."""
    keys, valid = keys_with_runs(2048, 37)
    words, v = u64_of(keys), jnp.asarray(valid)
    runs = count_ops.count_words(words, v, max_k=31, compact=False)
    merged = count_ops.merge_many([runs], max_k=31)
    want = count_ops.count_words(words, v, max_k=31, compact=True)
    nu = int(want.n_unique)
    assert int(merged.n_unique) == nu == int(runs.n_unique)
    for a, b in ((merged.keys.hi, want.keys.hi), (merged.keys.lo,
                                                  want.keys.lo),
                 (merged.counts, want.counts)):
        np.testing.assert_array_equal(np.asarray(a)[:nu], np.asarray(b)[:nu])


def wide_keys_with_runs(n, n_distinct, invalid_frac=0.1):
    hi, valid = keys_with_runs(n, n_distinct, invalid_frac)
    lo = (hi * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(12345)
    return hi, lo, valid


def u128_of(hi, lo):
    return U128(u64_of(hi), u64_of(lo))


@pytest.mark.parametrize("n,n_distinct", [(1024, 40), (2048, 40),
                                          (700, 200)])
def test_runlength_table_wide_matches_model(n, n_distinct):
    hi, lo, valid = wide_keys_with_runs(n, n_distinct)
    t = count_ops.count_words_wide(u128_of(hi, lo), jnp.asarray(valid),
                                   max_k=63, compact=False)
    got = [(int(a) << 64) | int(b) for a, b in zip(as_u64(t.keys.hi),
                                                    as_u64(t.keys.lo))]
    want = sorted((int(a) << 64) | int(b)
                  for a, b in zip(hi[valid], lo[valid]))
    nv = len(want)
    assert got[:nv] == want
    counts = np.asarray(t.counts)
    runs = [(w, sum(1 for _ in g)) for w, g in itertools.groupby(want)]
    starts = np.flatnonzero(counts)
    assert [(got[i], int(counts[i])) for i in starts] == runs
    assert int(t.n_unique) == len(runs)


def test_runlength_wide_table_merges_to_exact_counts():
    hi, lo, valid = wide_keys_with_runs(2048, 23)
    words, v = u128_of(hi, lo), jnp.asarray(valid)
    runs = count_ops.count_words_wide(words, v, max_k=63, compact=False)
    merged = count_ops.merge_many_wide([runs], max_k=63)
    want = count_ops.count_words_wide(words, v, max_k=63, compact=True)
    nu = int(want.n_unique)
    assert int(merged.n_unique) == nu
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(want)):
        if np.ndim(a):
            np.testing.assert_array_equal(np.asarray(a)[:nu],
                                          np.asarray(b)[:nu])


def rand_keys(n, top_bits=31):
    keys = ((RNG.integers(0, 1 << top_bits, n).astype(np.uint64)
             << np.uint64(32))
            | RNG.integers(0, 1 << 32, n).astype(np.uint64))
    keys[: n // 4] = keys[n // 4: n // 2]        # equal keys
    return keys


@pytest.mark.parametrize("n", [512, 2048, 1 << 13, 1 << 15])
def test_spare_bit_sort_matches_numpy(n):
    """k <= 31 keys (bit 31 of hi clear) with the invalid flag folded in:
    valid keys come out ascending, then the invalid lanes."""
    keys = rand_keys(n)
    valid = RNG.random(n) < 0.8
    s, sv, _ = count_ops.sort_by_word(u64_of(keys), jnp.asarray(valid),
                                      spare_hi_bit=True)
    nv = int(valid.sum())
    np.testing.assert_array_equal(as_u64(s)[:nv], np.sort(keys[valid]))
    np.testing.assert_array_equal(np.asarray(sv), np.arange(n) < nv)


def test_spare_bit_sort_on_canonical_kmers():
    """The exact layout the counter sorts: canonical k=31 words of reads
    with N, flag folded into bit 31 of hi."""
    reads = RNG.choice(np.frombuffer(b"ACGTN", dtype=np.uint8),
                       size=(8, 128), p=[0.24] * 4 + [0.04])
    canon, valid = pipeline.canonical_kmers(jnp.asarray(reads), 31)
    words = U64(canon.hi.reshape(-1), canon.lo.reshape(-1))
    v = np.asarray(valid).reshape(-1)
    s, sv, _ = count_ops.sort_by_word(words, jnp.asarray(v),
                                      spare_hi_bit=True)
    np.testing.assert_array_equal(as_u64(s)[:v.sum()],
                                  np.sort(as_u64(words)[v]))


def test_sort_carries_payload_stably():
    """Extra operands ride the sort; equal keys keep their input order
    (count_weighted relies on it for the weights plane)."""
    n = 768                                      # not a power of two
    keys = rand_keys(n) & np.uint64(0xF0000000F)  # few distinct keys
    payload = np.arange(n, dtype=np.int32)
    s, _, (p,) = count_ops.sort_by_word(u64_of(keys), jnp.ones(n, bool),
                                        jnp.asarray(payload),
                                        spare_hi_bit=True)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(p), payload[order])
    np.testing.assert_array_equal(as_u64(s), keys[order])


@pytest.mark.parametrize("n", [768, 1000, 5000])
def test_full_word_sort_keeps_all_ones_keys(n):
    """k = 32 keys use every bit, so the sort keeps a separate invalid
    key: u64::MAX words stay valid and sort last among the valid ones."""
    keys = rand_keys(n, top_bits=32)
    keys[-3:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    valid = RNG.random(n) < 0.7
    valid[-3:] = True
    s, sv, _ = count_ops.sort_by_word(u64_of(keys), jnp.asarray(valid))
    nv = int(valid.sum())
    np.testing.assert_array_equal(as_u64(s)[:nv], np.sort(keys[valid]))
    np.testing.assert_array_equal(np.asarray(sv), np.arange(n) < nv)
    assert (as_u64(s)[nv - 3:nv] == np.uint64(0xFFFFFFFFFFFFFFFF)).all()
