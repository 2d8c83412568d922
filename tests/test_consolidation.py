"""Streaming consolidation (stream._merge_bounded / _merge_bounded_wide:
concat + weighted re-count + rank eviction), flagged-lane compaction
inside count_words, and the binary-search lookup -- against NumPy models,
at the table/pending shapes, duplicate densities and eviction regimes of
the merge kernels this path replaced."""

import collections

import numpy as np
import pytest
import jax.numpy as jnp

from kmers_tpu.core.u64 import U64
from kmers_tpu.core.u128 import U128
from kmers_tpu.oracle import numpy_ref as o
from kmers_tpu.parallel import count as count_ops
from kmers_tpu.parallel.count import (CountTable, CountTableWide, UnitTable,
                                      UnitTableWide)
from kmers_tpu.parallel.stream import (StreamingCounter, _merge_bounded,
                                       _merge_bounded_wide)

RNG = np.random.default_rng(420)


def split64(keys):
    keys = np.asarray(keys, dtype=np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def make_table(cap, n_live, bits):
    """Compact key-sorted table of up to n_live unique keys (< 2^bits)."""
    keys = np.sort(RNG.choice(1 << bits, size=min(n_live, 1 << bits),
                              replace=False).astype(np.uint64))
    hi, lo = (np.zeros(cap, np.uint32) for _ in range(2))
    counts = np.zeros(cap, np.int32)
    hi[:keys.size], lo[:keys.size] = split64(keys)
    counts[:keys.size] = RNG.integers(1, 100, keys.size)
    table = CountTable(keys=U64(jnp.asarray(hi), jnp.asarray(lo)),
                       counts=jnp.asarray(counts),
                       n_unique=jnp.int32(keys.size))
    return table, dict(zip(keys.tolist(), counts[:keys.size].tolist()))


def make_units(n_lanes, n_valid, bits):
    """UnitTable with n_valid live lanes drawn from 2^bits keys, in
    random lane order; the rest carry the invalid pattern."""
    keys = RNG.integers(0, 1 << bits, n_valid).astype(np.uint64)
    hi = np.full(n_lanes, 0x80000000, np.uint32)
    lo = np.zeros(n_lanes, np.uint32)
    live = RNG.permutation(n_lanes)[:n_valid]
    hi[live], lo[live] = split64(keys)
    return (UnitTable(keys=U64(jnp.asarray(hi), jnp.asarray(lo))),
            collections.Counter(keys.tolist()))


def bound_model(counts: dict, capacity: int):
    """The documented policy: past capacity, evict the lowest counts
    first, ties evicting the largest keys.  (kept, dropped_unique,
    dropped_kmers)."""
    if len(counts) <= capacity:
        return dict(counts), 0, 0
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    kept, dropped = ranked[:capacity], ranked[capacity:]
    return dict(kept), len(dropped), sum(c for _, c in dropped)


def table_dict(t):
    nu = int(t.n_unique)
    keys = ((np.asarray(t.keys.hi, np.uint64) << np.uint64(32))
            | np.asarray(t.keys.lo, np.uint64))[:nu]
    assert (np.diff(keys.astype(object)) > 0).all()   # sorted, unique
    assert (np.asarray(t.counts)[nu:] == 0).all()
    return dict(zip(keys.tolist(), np.asarray(t.counts)[:nu].tolist()))


@pytest.mark.parametrize("n_live,cap,n_units,lanes,bits", [
    (700, 1024, 900, 1024, 20),
    (0, 512, 300, 512, 8),             # empty table
    (512, 512, 0, 512, 8),             # nothing pending
    (15, 1024, 3000, 4096, 4),         # heavy duplicates across both
    (5000, 8192, 9000, 16384, 11),
])
def test_merge_fits_capacity_matches_model(n_live, cap, n_units, lanes,
                                           bits):
    table, want = make_table(cap, n_live, bits)
    units, add = make_units(lanes, n_units, bits)
    merged, du, dk = _merge_bounded(table, (units,), cap + lanes, max_k=31)
    want = collections.Counter(want) + add
    assert table_dict(merged) == dict(want)
    assert (int(du), int(dk)) == (0, 0)


@pytest.mark.parametrize("n,p_keep", [
    (16384, 0.3), (3 * 16384, 0.9), (4 * 16384, 0.01), (130000, 0.33),
    (16384, 0.0), (16384, 1.0),
])
def test_count_words_keeps_only_flagged_lanes(n, p_keep):
    """Compaction of flagged lanes (the run starts of the weighted
    re-count): only valid lanes count, in key order."""
    keys = RNG.integers(0, 1 << 40, n).astype(np.uint64)
    keys[: n // 3] = keys[n // 3: 2 * (n // 3)]          # duplicates
    keep = RNG.random(n) < p_keep
    hi, lo = split64(keys)
    t = count_ops.count_words(U64(jnp.asarray(hi), jnp.asarray(lo)),
                              jnp.asarray(keep), max_k=31)
    assert table_dict(t) == dict(collections.Counter(keys[keep].tolist()))


@pytest.mark.parametrize("cap,n_live,n_units,valid_frac,bits", [
    (4096, 3000, 8192, 0.8, 16),       # overflows: evicts
    (4096, 0, 8192, 0.5, 8),
    (2048, 64, 4096, 1.0, 6),
    (1024, 512, 16384, 0.3, 30),       # overflows: evicts
    (1024, 100, 2048, 0.0, 10),        # all pending lanes invalid
])
def test_merge_bounded_matches_model(cap, n_live, n_units, valid_frac,
                                     bits):
    table, want = make_table(cap, n_live, bits)
    units, add = make_units(n_units, int(n_units * valid_frac), bits)
    merged, du, dk = _merge_bounded(table, (units,), cap, max_k=31)
    kept, d_unique, d_kmers = bound_model(
        collections.Counter(want) + add, cap)
    assert table_dict(merged) == kept
    assert (int(du), int(dk)) == (d_unique, d_kmers)


def test_streaming_counter_matches_model_with_eviction():
    """StreamingCounter end to end (k=17, merge_every=2): exact when the
    capacity holds every distinct k-mer; with a 64-slot table, every
    consolidation applies the eviction policy to what it merged."""
    rng = np.random.default_rng(7)
    reads = [bytes(rng.choice(list(b"ACGTN"), 60,
                              p=[.24, .24, .24, .24, .04]).astype(np.uint8))
             for _ in range(24)]
    arrs = [jnp.asarray(np.frombuffer(b"".join(reads[i:i + 8]),
                                      dtype=np.uint8).reshape(8, 60))
            for i in range(0, 24, 8)]
    k = 17

    def batch_counts(rs):
        c = collections.Counter()
        for r in rs:
            for _, fw, rc in o.CanonicalKmerIterator(r, k):
                c[min(fw, rc)] += 1
        return c

    sc = StreamingCounter(k, capacity=4096, merge_every=2)
    for a in arrs:
        sc.update(a)
    assert dict(sc.to_pairs()) == dict(batch_counts(reads))

    small = StreamingCounter(k, capacity=64, merge_every=2)
    for a in arrs:
        small.update(a)
    small._consolidate()
    table, du, dk = {}, 0, 0
    for group in (reads[:16], reads[16:]):        # two consolidations
        table, u_, k_ = bound_model(
            collections.Counter(table) + batch_counts(group), 64)
        du, dk = du + u_, dk + k_
    assert dict(small.to_pairs()) == table
    assert (small.dropped_unique, small.dropped_kmers) == (du, dk)
    assert dk > 0


@pytest.mark.parametrize("cap,n_live,nq,bits", [
    (1024, 700, 2048, 12),
    (1024, 1024, 2048, 10),            # full table
    (512, 0, 1024, 8),                 # empty table
    (2048, 1500, 256, 40),             # mostly-absent queries
])
def test_lookup_matches_model(cap, n_live, nq, bits):
    table, want = make_table(cap, n_live, bits)
    queries = RNG.integers(0, 1 << bits, nq).astype(np.uint64)
    hi, lo = split64(queries)
    got = np.asarray(count_ops.lookup(table, U64(jnp.asarray(hi),
                                                 jnp.asarray(lo))))
    assert got.tolist() == [want.get(q, 0) for q in queries.tolist()]


def make_wide(cap, n_live, n_units, valid_frac, bits):
    keys = sorted({int(x) << 70 | int(x) for x in
                   RNG.integers(0, 1 << bits, n_live)})
    planes = np.zeros((4, cap), np.uint32)
    for i, kv in enumerate(keys):
        for j in range(4):
            planes[j, i] = (kv >> (32 * (3 - j))) & 0xFFFFFFFF
    counts = np.zeros(cap, np.int32)
    counts[:len(keys)] = RNG.integers(1, 100, len(keys))
    table = CountTableWide(
        keys=U128(U64(jnp.asarray(planes[0]), jnp.asarray(planes[1])),
                  U64(jnp.asarray(planes[2]), jnp.asarray(planes[3]))),
        counts=jnp.asarray(counts), n_unique=jnp.int32(len(keys)))
    want = collections.Counter(dict(zip(keys, counts[:len(keys)].tolist())))
    up = np.zeros((4, n_units), np.uint32)
    up[0] = 0x80000000
    for i, x in enumerate(RNG.integers(0, 1 << bits, n_units)):
        if RNG.random() < valid_frac:
            kv = int(x) << 70 | int(x)
            for j in range(4):
                up[j, i] = (kv >> (32 * (3 - j))) & 0xFFFFFFFF
            want[kv] += 1
    unit = UnitTableWide(keys=U128(
        U64(jnp.asarray(up[0]), jnp.asarray(up[1])),
        U64(jnp.asarray(up[2]), jnp.asarray(up[3]))))
    return table, unit, want


@pytest.mark.parametrize("cap,n_live,n_units,valid_frac,bits", [
    (2048, 1500, 4096, 0.8, 40),       # overflows: evicts
    (1024, 0, 2048, 0.5, 8),
    (1024, 300, 8192, 1.0, 6),         # heavy duplicates
])
def test_merge_bounded_wide_matches_model(cap, n_live, n_units, valid_frac,
                                          bits):
    table, unit, want = make_wide(cap, n_live, n_units, valid_frac, bits)
    merged, du, dk = _merge_bounded_wide(table, (unit,), cap, max_k=63)
    kept, d_unique, d_kmers = bound_model(want, cap)
    nu = int(merged.n_unique)
    from kmers_tpu.core import u128 as u128mod

    keys = u128mod.to_python_ints(merged.keys)[:nu]
    assert keys == sorted(kept)
    assert dict(zip(keys, np.asarray(merged.counts)[:nu].tolist())) == kept
    assert (int(du), int(dk)) == (d_unique, d_kmers)


def test_streaming_counter_wide_matches_oracle():
    """Wide (k=47) StreamingCounter over four batches, merge_every=2."""
    rng = np.random.default_rng(12)
    arrs = [rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8),
                       size=(8, 96), p=[.24, .24, .24, .24, .04])
            for _ in range(4)]
    k = 47
    sc = StreamingCounter(k, capacity=4096, merge_every=2)
    for a in arrs:
        sc.update(jnp.asarray(a))
    want = collections.Counter(
        c for a in arrs for row in a
        for _, _, c in o.canonical_windows_wide(row.tobytes(), k))
    assert dict(sc.to_pairs()) == dict(want)
    assert sc.kmers == sum(want.values())
