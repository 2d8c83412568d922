"""Counting + routing tests on the 8-device CPU mesh (conftest forces
xla_force_host_platform_device_count=8; SURVEY.md §4 multi-host sim)."""

import collections
import random

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kmers_tpu.core import u64 as u
from kmers_tpu.core.u64 import U64
from kmers_tpu.oracle import numpy_ref as o
from kmers_tpu.parallel import count as count_ops
from kmers_tpu.parallel import mesh as mesh_ops
from kmers_tpu.parallel import pipeline
import kmers_tpu.parallel.route as route_ops

RNG = random.Random(99)

N = 256


def rand_words_with_dups(n=N, pool=40):
    pool_words = [RNG.getrandbits(64) for _ in range(pool)]
    return [RNG.choice(pool_words) for _ in range(n)]


def as_u64(ws):
    return u.from_numpy(np.array(ws, dtype=np.uint64))


def expected_counts(ws, valid):
    c = collections.Counter(w for w, v in zip(ws, valid) if v)
    return sorted(c.items())


def table_to_pairs(table):
    nu = int(table.n_unique)
    keys = u.to_numpy(table.keys)[:nu]
    counts = np.asarray(table.counts)[:nu]
    return [(int(k), int(c)) for k, c in zip(keys, counts)]


@jax.jit
def _count_words_jit(words, valid):
    return count_ops.count_words(words, valid)


def test_count_words_vs_counter():
    ws = rand_words_with_dups()
    valid = [RNG.random() > 0.2 for _ in ws]
    table = _count_words_jit(as_u64(ws), jnp.asarray(np.array(valid)))
    assert table_to_pairs(table) == expected_counts(ws, valid)
    # padding slots are zeroed
    nu = int(table.n_unique)
    assert not np.asarray(table.counts)[nu:].any()
    assert not np.asarray(table.keys.lo)[nu:].any()


def test_count_words_all_T_not_aliased():
    """u64::MAX (32 T's) must count correctly despite invalid lanes
    (sort uses a validity key, not a sentinel)."""
    ws = [o.MASK64] * 5 + [7] * 3 + [o.MASK64] * 4
    valid = [True] * 5 + [True] * 3 + [False] * 4
    table = _count_words_jit(as_u64(ws), jnp.asarray(np.array(valid)))
    assert table_to_pairs(table) == [(7, 3), (o.MASK64, 5)]


def test_count_words_all_invalid():
    ws = rand_words_with_dups(16)
    table = _count_words_jit(as_u64(ws), jnp.zeros(16, dtype=bool))
    assert int(table.n_unique) == 0
    assert not np.asarray(table.counts).any()


def test_count_weighted_and_merge():
    ws_a, ws_b = rand_words_with_dups(64), rand_words_with_dups(64)
    va = [RNG.random() > 0.1 for _ in ws_a]
    vb = [RNG.random() > 0.1 for _ in ws_b]
    ta = _count_words_jit(as_u64(ws_a), jnp.asarray(np.array(va)))
    tb = _count_words_jit(as_u64(ws_b), jnp.asarray(np.array(vb)))
    merged = jax.jit(count_ops.merge_tables)(ta, tb)
    want = collections.Counter(w for w, v in zip(ws_a, va) if v)
    want += collections.Counter(w for w, v in zip(ws_b, vb) if v)
    assert table_to_pairs(merged) == sorted(want.items())


def test_lookup():
    ws = rand_words_with_dups()
    valid = [True] * N
    table = _count_words_jit(as_u64(ws), jnp.asarray(np.array(valid)))
    queries = ws[:10] + [RNG.getrandbits(64) for _ in range(6)]
    got = jax.jit(count_ops.lookup)(table, as_u64(queries))
    c = collections.Counter(ws)
    want = [c.get(q, 0) for q in queries]
    assert list(np.asarray(got)) == want


def _oracle_canonical_counts(reads, k):
    c = collections.Counter()
    for r in reads:
        it = o.CanonicalKmerIterator(r, k)
        for _, fw, rc in it:
            c[min(fw, rc)] += 1
    return sorted(c.items())


def _make_reads(n_reads, L, n_frac=0.05):
    reads = []
    for _ in range(n_reads):
        r = bytearray(RNG.choice(b"ACGT") for _ in range(L))
        for i in range(L):
            if RNG.random() < n_frac:
                r[i] = ord("N")
        reads.append(bytes(r))
    return reads


def reads_to_batch(reads, L):
    batch = np.full((len(reads), L), ord("N"), dtype=np.uint8)
    for i, r in enumerate(reads):
        batch[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
    return jnp.asarray(batch)


def test_count_reads_vs_oracle():
    k, L = 31, 80
    reads = _make_reads(16, L)
    res = jax.jit(lambda a: pipeline.count_reads(a, k))(reads_to_batch(reads, L))
    assert table_to_pairs(res.table) == _oracle_canonical_counts(reads, k)
    n_valid = sum(1 for r in reads for _ in o.CanonicalKmerIterator(r, k))
    assert int(res.metrics["kmers_emitted"]) == n_valid
    assert int(res.metrics["reads"]) == 16


def test_owner_of_range():
    ws = as_u64([RNG.getrandbits(64) for _ in range(512)])
    for d in (2, 3, 8):
        owners = np.asarray(jax.jit(
            lambda w, d=d: route_ops.owner_of(w, d))(ws))
        assert owners.min() >= 0 and owners.max() < d
        # roughly balanced (loose bound)
        h = np.bincount(owners, minlength=d)
        assert h.min() > 512 // d // 4


def test_route_delivers_to_owner():
    requires_8_devices()
    m = mesh_ops.make_mesh(8)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ws = rand_words_with_dups(8 * 64, pool=300)
    valid = np.array([RNG.random() > 0.15 for _ in ws])
    cap = 64  # ample

    def body(hi, lo, v):
        routed = route_ops.route(U64(hi, lo), v, "d", cap)
        return routed.words.hi[None], routed.words.lo[None], \
            routed.valid[None], routed.overflow[None]

    fn = jax.jit(shard_map(
        body, mesh=m, in_specs=(P("d"), P("d"), P("d")),
        out_specs=(P("d"), P("d"), P("d"), P("d"))))
    wa = as_u64(ws)
    rhi, rlo, rv, ovf = fn(wa.hi, wa.lo, jnp.asarray(valid))
    assert int(np.asarray(ovf).sum()) == 0
    got_per_shard = []
    for d in range(8):
        wv = u.to_numpy(U64(rhi[d], rlo[d]))
        mask = np.asarray(rv[d])
        got_per_shard.append(collections.Counter(int(x) for x in wv[mask]))
    # every received word belongs to that shard, and the multiset over all
    # shards equals the valid input multiset
    owners = np.asarray(route_ops.owner_of(wa, 8))
    want_per_shard = [collections.Counter() for _ in range(8)]
    for w, v, own in zip(ws, valid, owners):
        if v:
            want_per_shard[own][w] += 1
    assert got_per_shard == want_per_shard


def test_route_overflow_counted():
    requires_8_devices()
    m = mesh_ops.make_mesh(8)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ws = [RNG.getrandbits(64) for _ in range(8 * 64)]
    cap = 2  # far too small

    def body(hi, lo, v):
        routed = route_ops.route(U64(hi, lo), v, "d", cap)
        return routed.overflow[None]

    fn = jax.jit(shard_map(
        body, mesh=m, in_specs=(P("d"), P("d"), P("d")),
        out_specs=P("d")))
    wa = as_u64(ws)
    ovf = fn(wa.hi, wa.lo, jnp.ones(len(ws), dtype=bool))
    # 64 valid lanes per sender, 8 dests * cap 2 = 16 slots: >= 48 dropped
    assert int(np.asarray(ovf).sum()) >= 8 * (64 - 8 * cap)


def requires_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


def test_sharded_counter_matches_oracle():
    requires_8_devices()
    k, L = 21, 64
    reads = _make_reads(32, L)  # 4 reads per shard
    m = mesh_ops.make_mesh(8)
    counter = pipeline.make_sharded_counter(m, k, route_capacity=256)
    res = counter(reads_to_batch(reads, L))
    assert int(res.metrics["route_overflow"]) == 0
    assert int(res.metrics["reads"]) == 32
    # union of shard tables == oracle counts
    got = collections.Counter()
    t = res.table
    for d in range(8):
        shard = count_ops.CountTable(
            keys=U64(t.keys.hi[d], t.keys.lo[d]),
            counts=t.counts[d], n_unique=t.n_unique[d])
        for w, c in table_to_pairs(shard):
            assert w not in got, "shards must be disjoint"
            got[w] += c
    assert sorted(got.items()) == _oracle_canonical_counts(reads, k)


def test_sharded_lookup_service():
    """Distributed query serving: counts come back to the original query
    lanes; absent kmers 0; invalid query lanes -1."""
    requires_8_devices()
    k, L = 21, 64
    reads = _make_reads(32, L, n_frac=0.0)
    m = mesh_ops.make_mesh(8)
    counter = pipeline.make_sharded_counter(m, k, route_capacity=256)
    res = counter(reads_to_batch(reads, L))
    want = dict(_oracle_canonical_counts(reads, k))
    # queries: 8 per shard = 64 total; mix of present / absent / invalid
    present = list(want.keys())
    queries, qvalid, expect = [], [], []
    for i in range(64):
        if i % 4 == 3:
            queries.append(RNG.getrandbits(64))  # random: almost surely absent
            qvalid.append(True)
            expect.append(want.get(queries[-1], 0))
        elif i % 4 == 2:
            queries.append(0)
            qvalid.append(False)
            expect.append(-1)
        else:
            queries.append(present[i % len(present)])
            qvalid.append(True)
            expect.append(want[queries[-1]])
    qa = as_u64(queries)
    lookup_fn = pipeline.make_sharded_lookup(m, query_capacity=64)
    counts, overflow = lookup_fn(res.table, qa.hi, qa.lo,
                                 jnp.asarray(np.array(qvalid)))
    assert int(overflow) == 0
    assert list(np.asarray(counts)) == expect


def test_route_reroute_exact_under_overflow():
    """Multi-pass routing (SURVEY §7 'count overflow and re-route in a
    second pass'): a skewed load that overflows capacity in one pass is
    delivered exactly with passes=4, and the overflow/rerouted counters
    reflect it."""
    requires_8_devices()
    m = mesh_ops.make_mesh(8)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    # every sender has 64 lanes from a pool of 3 words -> at most 3
    # destinations, heavily loaded; cap=8 overflows, 4*8=32 may still
    # overflow per-word (64/3 ~ 21 lanes/word), so use cap=8, passes=4
    # with pool spread such that per-dest load <= 32.
    pool = [RNG.getrandbits(64) for _ in range(3)]
    ws = [pool[i % 3] for i in range(8 * 64)]
    valid = np.ones(len(ws), dtype=bool)
    cap = 8

    def body(hi, lo, v, passes):
        routed = route_ops.route(U64(hi, lo), v, "d", cap, passes=passes)
        return routed.words.hi[None], routed.words.lo[None], \
            routed.valid[None], routed.overflow[None], routed.rerouted[None]

    def run(passes):
        fn = jax.jit(shard_map(
            lambda hi, lo, v: body(hi, lo, v, passes), mesh=m,
            in_specs=(P("d"), P("d"), P("d")),
            out_specs=(P("d"),) * 5))
        wa = as_u64(ws)
        return fn(wa.hi, wa.lo, jnp.asarray(valid))

    # single pass: overflow, delivered multiset is short
    _, _, rv1, ovf1, rr1 = run(1)
    assert int(np.asarray(ovf1).sum()) > 0
    assert int(np.asarray(rr1).sum()) == 0

    # 4 passes: exact delivery (each sender: <= 22 lanes per word <= 4*8)
    rhi, rlo, rv, ovf, rr = run(4)
    assert int(np.asarray(ovf).sum()) == 0
    assert int(np.asarray(rr).sum()) > 0
    got = collections.Counter()
    for d in range(8):
        wv = u.to_numpy(U64(rhi[d].reshape(-1), rlo[d].reshape(-1)))
        mask = np.asarray(rv[d]).reshape(-1)
        got.update(int(x) for x in wv[mask])
    assert got == collections.Counter(ws)


def test_sharded_counter_reroute_matches_oracle():
    """End-to-end: a capacity that overflows at passes=1 gives exact,
    oracle-equal shard tables at route_passes=3."""
    requires_8_devices()
    k, L = 21, 64
    # skew: all reads identical -> every sender's k-mers hit the same
    # small owner set
    reads = [_make_reads(1, L, n_frac=0.0)[0]] * 32
    m = mesh_ops.make_mesh(8)
    batch = reads_to_batch(reads, L)

    res1 = pipeline.make_sharded_counter(m, k, route_capacity=16)(batch)
    assert int(res1.metrics["route_overflow"]) > 0  # forced overflow

    res3 = pipeline.make_sharded_counter(
        m, k, route_capacity=16, route_passes=12)(batch)
    assert int(res3.metrics["route_overflow"]) == 0
    assert int(res3.metrics["route_rerouted"]) > 0
    got = collections.Counter()
    t = res3.table
    for d in range(8):
        shard = count_ops.CountTable(
            keys=U64(t.keys.hi[d], t.keys.lo[d]),
            counts=t.counts[d], n_unique=t.n_unique[d])
        for w, c in table_to_pairs(shard):
            assert w not in got, "shards must be disjoint"
            got[w] += c
    assert sorted(got.items()) == _oracle_canonical_counts(reads, k)


def test_sharded_minimizer_counter_reroute():
    """The skewed minimizer load from pipeline.py's capacity note: identical
    reads concentrate minimizer words; re-routing makes the tables exact
    (equal to the unrouted single-device minimizer multiset)."""
    requires_8_devices()
    from kmers_tpu.ops import hash as hash_ops
    from kmers_tpu.ops import minimizer as mini_ops

    k, w, L = 21, 7, 64
    reads = [_make_reads(1, L, n_frac=0.0)[0]] * 16
    m = mesh_ops.make_mesh(8)
    batch = reads_to_batch(reads, L)

    res1 = pipeline.make_sharded_minimizer_counter(
        m, k, w, route_capacity=8)(batch)
    assert int(res1.metrics["route_overflow"]) > 0

    res = pipeline.make_sharded_minimizer_counter(
        m, k, w, route_capacity=8, route_passes=16)(batch)
    assert int(res.metrics["route_overflow"]) == 0
    # expected multiset: jnp minimizer stream (deque-equivalent, tested
    # against the oracle elsewhere), counted globally
    mm = mini_ops.minimizer_stream(batch, k, w, hash_ops.mix_hash_fn(0))
    words = u.to_numpy(mm.word).reshape(-1)
    valid = np.asarray(mm.valid).reshape(-1)
    want = collections.Counter(int(x) for x in words[valid])
    got = collections.Counter()
    t = res.table
    for d in range(8):
        shard = count_ops.CountTable(
            keys=U64(t.keys.hi[d], t.keys.lo[d]),
            counts=t.counts[d], n_unique=t.n_unique[d])
        for wd, c in table_to_pairs(shard):
            got[wd] += c
    assert got == want


def test_global_table_merges_shards():
    requires_8_devices()
    k, L = 21, 64
    reads = _make_reads(32, L)
    m = mesh_ops.make_mesh(8)
    res = pipeline.make_sharded_counter(m, k, route_capacity=256)(
        reads_to_batch(reads, L))
    merged = jax.jit(pipeline.global_table)(res)
    assert table_to_pairs(merged) == _oracle_canonical_counts(reads, k)


def test_lookup_sharded_owner_indexed():
    requires_8_devices()
    k, L = 21, 64
    reads = _make_reads(32, L, n_frac=0.0)
    m = mesh_ops.make_mesh(8)
    res = pipeline.make_sharded_counter(m, k, route_capacity=256)(
        reads_to_batch(reads, L))
    want = dict(_oracle_canonical_counts(reads, k))
    queries = list(want.keys())[:20] + [RNG.getrandbits(64) for _ in range(12)]
    got = jax.jit(lambda t, q: pipeline.lookup_sharded(t, q, 8))(
        res.table, as_u64(queries))
    assert list(np.asarray(got)) == [want.get(q, 0) for q in queries]


def test_count_words_runlength_form_equivalent():
    """count_words(compact=False) (run-length form, no compaction sort)
    carries identical information: merging it yields the same compacted
    table, and counts>0 marks exactly the distinct keys."""
    import numpy as np

    from kmers_tpu.core import u64 as u

    rng = np.random.default_rng(99)
    for k in (15, 31, 32):
        reads = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8),
                           size=(12, 80), p=[0.24] * 4 + [0.04])
        canon, valid = pipeline.canonical_kmers(jnp.asarray(reads), k)
        t_c = count_ops.count_words(canon, valid, max_k=k, compact=True)
        t_r = count_ops.count_words(canon, valid, max_k=k, compact=False)
        assert int(t_c.n_unique) == int(t_r.n_unique)
        # same total mass, same distinct count
        assert int(t_c.counts.sum()) == int(t_r.counts.sum())
        assert int((t_r.counts > 0).sum()) == int(t_r.n_unique)
        # merging the run-length form compacts to the identical table
        m = count_ops.merge_many([t_r], max_k=k)
        nu = int(t_c.n_unique)
        assert np.array_equal(u.to_numpy(m.keys)[:nu],
                              u.to_numpy(t_c.keys)[:nu])
        assert np.array_equal(np.asarray(m.counts)[:nu],
                              np.asarray(t_c.counts)[:nu])
        # run-length keys at live lanes are the distinct keys in order
        live = np.asarray(t_r.counts) > 0
        assert np.array_equal(u.to_numpy(t_r.keys)[live],
                              u.to_numpy(t_c.keys)[:nu])


def test_count_words_wide_runlength_form_equivalent():
    import numpy as np

    from kmers_tpu.core import u128 as u128mod

    rng = np.random.default_rng(100)
    k = 63
    reads = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8),
                       size=(6, 100), p=[0.24] * 4 + [0.04])
    canon, valid = pipeline.canonical_kmers_wide(jnp.asarray(reads), k)
    t_c = count_ops.count_words_wide(canon, valid, max_k=k, compact=True)
    t_r = count_ops.count_words_wide(canon, valid, max_k=k, compact=False)
    assert int(t_c.n_unique) == int(t_r.n_unique)
    m = count_ops.merge_many_wide([t_r], max_k=k)
    nu = int(t_c.n_unique)
    assert u128mod.to_python_ints(m.keys)[:nu] == \
        u128mod.to_python_ints(t_c.keys)[:nu]
    assert np.asarray(m.counts)[:nu].tolist() == \
        np.asarray(t_c.counts)[:nu].tolist()


def test_bucket_slices_loop_form_matches_unrolled(monkeypatch):
    """VERDICT r4 item 6: the pod-scale fori_loop form of _bucket_slices
    is byte-identical to the unrolled per-destination slices."""
    rng = np.random.default_rng(5)
    n, d, cap = 4096, 32, 64
    arrs = [jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
            for _ in range(3)]
    counts = rng.multinomial(n, np.ones(d) / d)
    starts = jnp.asarray(np.concatenate(
        [[0], np.cumsum(counts)[:-1]]).astype(np.int32))
    out_loop = route_ops._bucket_slices(arrs, starts, cap, cap)(cap // 2)
    monkeypatch.setattr(route_ops, "_UNROLL_MAX_D", 1 << 30)
    out_unroll = route_ops._bucket_slices(arrs, starts, cap, cap)(cap // 2)
    for a, b in zip(out_loop, out_unroll):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n_dev", [64, 256])
def test_sharded_counter_compiles_at_pod_scale(n_dev):
    """Trace+compile make_sharded_counter at D=64 / D=256 with a graph
    sublinear in D (the fori_loop slice form): runs in a subprocess
    because the virtual device count is fixed at backend init."""
    import subprocess
    import sys

    code = f"NDEV = {n_dev}\n" + """
import numpy as np
import jax, jax.numpy as jnp
from kmers_tpu.parallel import mesh as mesh_ops, pipeline, route
m = mesh_ops.make_mesh(NDEV)
fn = pipeline.make_sharded_counter(m, 15, route_capacity=32,
                                   aggregate="unit")
reads = jnp.asarray(np.frombuffer(
    b"ACGT" * 16 * NDEV, dtype=np.uint8).reshape(NDEV, 64))
lowered = fn.lower(jax.device_put(reads, mesh_ops.batch_sharding(m)))
text = lowered.as_text()
n_dyn = text.count("dynamic_slice")
# unrolled form would carry >= 2 * 64 dynamic slices; the loop form
# keeps a handful (inside one while-loop body)
assert n_dyn < 40, n_dyn
lowered.compile()
print("OK", n_dyn)
"""
    import os

    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS":
           f"--xla_force_host_platform_device_count={n_dev}"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout
