"""Super-k-mer (minimizer-partitioned) distributed counting (VERDICT r3
item 6): emission/expansion invariants and the property that matters --
the minimizer-routed global table is BIT-EXACT vs single-device counting,
while shipping runs of packed bases instead of per-k-mer words."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kmers_tpu.parallel import count as count_ops
from kmers_tpu.parallel import mesh as mesh_ops
from kmers_tpu.parallel import pipeline

RNG = np.random.default_rng(1312)


def genome_reads(n_reads, L, n_rate=0.02, seed=3):
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("ACGT"), size=2000, p=[.4, .3, .2, .1])
    reads = ["".join(genome[s:s + L])
             for s in rng.integers(0, 2000 - L, size=n_reads)]
    rows = np.frombuffer("".join(reads).encode(),
                         dtype=np.uint8).reshape(n_reads, L).copy()
    rows[rng.random(rows.shape) < n_rate] = ord("N")
    return rows


@pytest.mark.parametrize("k,w", [
    (21, 7),    # folded meta layout (6 spare-bit offset)
    (31, 11),   # folded, 4 payload words (the CLI default shape)
    (18, 4),    # NO spare bits (2*(2k-w) = 64): separate meta plane
    (16, 5),    # fold at a high offset (22)
])
def test_emit_expand_roundtrip_single_host(k, w):
    """Expanding the emitted super-k-mers reproduces exactly the k-mer
    multiset of the windows (order aside), including runs cut by Ns."""
    rows = genome_reads(16, 64, n_rate=0.05)
    owner, start, planes, kmers = pipeline.emit_superkmers(
        jnp.asarray(rows), k, w, seed=0)
    # treat every lane as "received" with validity = start
    flat_planes = tuple(p.reshape(-1) for p in planes)
    fw, wv = pipeline.expand_superkmers(flat_planes,
                                        np.asarray(start).reshape(-1), k, w)
    from kmers_tpu.ops import kmer as kmer_ops
    canon = kmer_ops.canonical_word(fw, kmer_ops.reverse_complement(fw, k))
    got = count_ops.count_words(canon, wv, max_k=k, compact=True)
    want_res = pipeline.count_reads(jnp.asarray(rows), k,
                                    aggregate="compact")
    want = want_res.table
    nu = int(want.n_unique)
    assert int(got.n_unique) == nu
    np.testing.assert_array_equal(np.asarray(got.keys.hi)[:nu],
                                  np.asarray(want.keys.hi)[:nu])
    np.testing.assert_array_equal(np.asarray(got.keys.lo)[:nu],
                                  np.asarray(want.keys.lo)[:nu])
    np.testing.assert_array_equal(np.asarray(got.counts)[:nu],
                                  np.asarray(want.counts)[:nu])
    assert int(kmers) == int(np.asarray(want.counts).sum())
    # compression: mean run length > 2 on genomic data
    n_sk = int(np.asarray(start).sum())
    assert int(kmers) / n_sk > 2.0


@pytest.mark.parametrize("aggregate", ["unit", "compact"])
def test_superkmer_mesh_table_bit_exact(aggregate):
    k, w = 21, 7
    rows = genome_reads(64, 64)
    m = mesh_ops.make_mesh(8)
    cnt = pipeline.make_superkmer_counter(m, k, w, route_capacity=512,
                                          route_passes=2,
                                          aggregate=aggregate)
    res = cnt(jax.device_put(jnp.asarray(rows), mesh_ops.batch_sharding(m)))
    assert int(res.metrics["route_overflow"]) == 0
    g = pipeline.global_table(res)
    want = pipeline.count_reads(jnp.asarray(rows), k,
                                aggregate="compact").table
    nu = int(want.n_unique)
    assert int(g.n_unique) == nu
    np.testing.assert_array_equal(np.asarray(g.keys.hi)[:nu],
                                  np.asarray(want.keys.hi)[:nu])
    np.testing.assert_array_equal(np.asarray(g.keys.lo)[:nu],
                                  np.asarray(want.keys.lo)[:nu])
    np.testing.assert_array_equal(np.asarray(g.counts)[:nu],
                                  np.asarray(want.counts)[:nu])
    # the wire win vs per-k-mer routing: fewer routed lanes than k-mers
    assert (int(res.metrics["superkmers"])
            < int(res.metrics["kmers_emitted"]) / 2)


def test_superkmer_overflow_counted_in_kmers():
    """Dropped super-k-mers are accounted meta-weighted: the global table
    mass + route_overflow (in K-MERS) always equals kmers_emitted."""
    k, w = 21, 7
    rows = genome_reads(64, 64)
    m = mesh_ops.make_mesh(8)
    cnt = pipeline.make_superkmer_counter(m, k, w, route_capacity=8,
                                          route_passes=1)
    res = cnt(jax.device_put(jnp.asarray(rows), mesh_ops.batch_sharding(m)))
    assert int(res.metrics["route_overflow"]) > 0
    g = pipeline.global_table(res)
    mass = int(np.asarray(g.counts).sum())
    assert mass + int(res.metrics["route_overflow"]) == int(
        res.metrics["kmers_emitted"])


def test_superkmer_reverse_complement_pairs_exact():
    """ADVICE r4: forward-strand minimizer selection means a canonical
    k-mer seen as a reverse complement in another read can route to a
    DIFFERENT shard -- per-shard tables are not key-disjoint.  The global
    table must still be exact because global_table re-counts across
    shards.  Drive the pipeline with explicit RC read pairs (the case no
    prior test generated)."""
    k, w = 21, 7
    fwd = genome_reads(32, 64, n_rate=0.0)
    comp = {ord("A"): ord("T"), ord("T"): ord("A"),
            ord("C"): ord("G"), ord("G"): ord("C")}
    rc = np.vectorize(comp.get)(fwd[:, ::-1]).astype(np.uint8)
    rows = np.concatenate([fwd, rc], axis=0)
    m = mesh_ops.make_mesh(8)
    cnt = pipeline.make_superkmer_counter(m, k, w, route_capacity=1024,
                                          route_passes=2,
                                          aggregate="compact")
    res = cnt(jax.device_put(jnp.asarray(rows), mesh_ops.batch_sharding(m)))
    assert int(res.metrics["route_overflow"]) == 0
    g = pipeline.global_table(res)
    want = pipeline.count_reads(jnp.asarray(rows), k,
                                aggregate="compact").table
    nu = int(want.n_unique)
    assert int(g.n_unique) == nu
    np.testing.assert_array_equal(np.asarray(g.keys.hi)[:nu],
                                  np.asarray(want.keys.hi)[:nu])
    np.testing.assert_array_equal(np.asarray(g.keys.lo)[:nu],
                                  np.asarray(want.keys.lo)[:nu])
    np.testing.assert_array_equal(np.asarray(g.counts)[:nu],
                                  np.asarray(want.counts)[:nu])
    # every k-mer here appears on both strands, so each key's count is
    # even -- the exactness above is only meaningful if RC mass arrived
    assert (np.asarray(g.counts)[:nu] % 2 == 0).all()
    # document the non-disjointness this test exists for: with RC pairs,
    # at least one canonical key typically lands on two shards (forward-
    # strand minimizers differ between the strands).  Don't hard-require
    # it (shard assignment could coincide), just surface the observation.
    t = res.table
    d, cap = t.counts.shape
    per_shard = []
    for s in range(d):
        nu_s = int(t.n_unique[s])
        keys = (np.asarray(t.keys.hi[s])[:nu_s].astype(np.uint64) << 32
                | np.asarray(t.keys.lo[s])[:nu_s].astype(np.uint64))
        per_shard.append(set(keys.tolist()))
    n_dup = sum(len(a & b) for i, a in enumerate(per_shard)
                for b in per_shard[i + 1:])
    # exactness held above either way; record the overlap for debugging
    print(f"cross-shard duplicated keys: {n_dup}")


def test_sharded_streaming_counter_minimizer_partition():
    from kmers_tpu.parallel.stream import (ShardedStreamingCounter,
                                           StreamingCounter)

    k = 21
    rows = genome_reads(96, 64)
    flat = StreamingCounter(k, capacity=1 << 13, merge_every=2)
    sh = ShardedStreamingCounter(k, capacity=1 << 13, merge_every=2,
                                 n_devices=8, route_capacity=512,
                                 route_passes=2, partition="minimizer",
                                 minimizer_w=7)
    for i in range(0, 96, 32):
        flat.update(jnp.asarray(rows[i:i + 32]))
        sh.update(jnp.asarray(rows[i:i + 32]))
    assert sh.route_overflow == 0
    assert dict(sh.to_pairs()) == dict(flat.to_pairs())
    assert sh.route_superkmers > 0
    with pytest.raises(NotImplementedError):
        sh.update_packed(None, None)


@pytest.mark.parametrize("aggregate", ["unit", "compact"])
def test_superkmer_prefilter_table_bit_exact(aggregate):
    """Super-k-mer counting with the route budget passes=2 (the owner
    sort sees every emitted lane; no compaction step runs before it):
    same global table as single-device counting when nothing is
    dropped, in both per-shard table forms."""
    k, w = 21, 7
    rows = genome_reads(64, 64)
    m = mesh_ops.make_mesh(8)
    cnt = pipeline.make_superkmer_counter(m, k, w, route_capacity=512,
                                          route_passes=2,
                                          aggregate=aggregate)
    res = cnt(jax.device_put(jnp.asarray(rows), mesh_ops.batch_sharding(m)))
    assert int(res.metrics["route_overflow"]) == 0
    g = pipeline.global_table(res)
    want = pipeline.count_reads(jnp.asarray(rows), k,
                                aggregate="compact").table
    nu = int(want.n_unique)
    assert int(g.n_unique) == nu
    np.testing.assert_array_equal(np.asarray(g.keys.hi)[:nu],
                                  np.asarray(want.keys.hi)[:nu])
    np.testing.assert_array_equal(np.asarray(g.keys.lo)[:nu],
                                  np.asarray(want.keys.lo)[:nu])
    np.testing.assert_array_equal(np.asarray(g.counts)[:nu],
                                  np.asarray(want.counts)[:nu])


def test_superkmer_prefilter_cap_drops_counted():
    """When the route budget truncates, the dropped k-mer mass is
    meta-weighted into route_overflow: table mass + overflow == emitted
    still holds exactly."""
    k, w = 21, 7
    rows = genome_reads(64, 64)
    m = mesh_ops.make_mesh(8)
    cnt = pipeline.make_superkmer_counter(m, k, w, route_capacity=8,
                                          route_passes=1)
    res = cnt(jax.device_put(jnp.asarray(rows), mesh_ops.batch_sharding(m)))
    assert int(res.metrics["route_overflow"]) > 0
    g = pipeline.global_table(res)
    mass = int(np.asarray(g.counts).sum())
    assert mass + int(res.metrics["route_overflow"]) == int(
        res.metrics["kmers_emitted"])
