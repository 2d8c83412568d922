"""Streaming counter: multi-batch folding, capacity bounds, checkpoint/resume,
file-to-table end-to-end."""

import collections
import random

import numpy as np
import pytest
import jax.numpy as jnp

from kmers_tpu.oracle import numpy_ref as o
from kmers_tpu.parallel.stream import StreamingCounter, count_fastx

RNG = random.Random(1357)


def rand_seq(n, alphabet=b"ACGTN"):
    return bytes(RNG.choice(alphabet) for _ in range(n))


def make_batch(n_reads, L):
    reads = [rand_seq(L) for _ in range(n_reads)]
    arr = np.stack([np.frombuffer(r, dtype=np.uint8) for r in reads])
    return reads, jnp.asarray(arr)


def oracle_counts(all_reads, k):
    c = collections.Counter()
    for r in all_reads:
        it = o.CanonicalKmerIterator(r, k)
        for _, fw, rc in it:
            c[min(fw, rc)] += 1
    return sorted(c.items())


def test_streaming_matches_oracle_across_batches():
    k = 21
    all_reads = []
    sc = StreamingCounter(k, capacity=4096)
    for _ in range(5):
        reads, arr = make_batch(8, 60)
        all_reads += reads
        sc.update(arr)
    assert sc.batches == 5
    assert sc.dropped_unique == 0
    assert sc.to_pairs() == oracle_counts(all_reads, k)
    assert sc.kmers == sum(c for _, c in oracle_counts(all_reads, k))


def test_streaming_capacity_overflow_counted():
    k = 15
    sc = StreamingCounter(k, capacity=16)  # absurdly small
    _, arr = make_batch(8, 60)
    sc.update(arr)
    sc.update(make_batch(8, 60)[1])
    # consolidation is deferred; drop accounting lands when the table is
    # read (to_pairs/lookup/save all consolidate first)
    sc.to_pairs()
    assert sc.dropped_unique > 0
    assert sc.dropped_kmers > 0
    assert int(sc.table.n_unique) <= 16


def test_streaming_deferred_merge_matches_eager():
    k = 15
    batches = [make_batch(6, 50)[1] for _ in range(5)]
    eager = StreamingCounter(k, capacity=4096, merge_every=1)
    lazy = StreamingCounter(k, capacity=4096, merge_every=16)
    for b in batches:
        eager.update(b)
        lazy.update(b)
    assert eager.to_pairs() == lazy.to_pairs()
    assert eager.kmers == lazy.kmers


def test_checkpoint_resume(tmp_path):
    k = 21
    batches = [make_batch(6, 50) for _ in range(4)]
    all_reads = [r for reads, _ in batches for r in reads]
    # full run
    full = StreamingCounter(k, capacity=2048)
    for _, arr in batches:
        full.update(arr)
    # checkpointed run: 2 batches, save, load, 2 more
    a = StreamingCounter(k, capacity=2048)
    a.update(batches[0][1])
    a.update(batches[1][1])
    p = str(tmp_path / "ckpt.npz")
    a.save(p)
    b = StreamingCounter.load(p)
    assert b.batches == 2 and b.k == k
    b.update(batches[2][1])
    b.update(batches[3][1])
    assert b.to_pairs() == full.to_pairs()
    assert b.kmers == full.kmers
    assert b.to_pairs() == oracle_counts(all_reads, k)


def test_count_fastx_end_to_end(tmp_path):
    k = 17
    records = [rand_seq(RNG.randrange(20, 300), b"ACGT") for _ in range(15)]
    records.append(rand_seq(1500, b"ACGTN"))  # long record: halo chunking
    p = str(tmp_path / "reads.fasta")
    with open(p, "wb") as f:
        for i, r in enumerate(records):
            f.write(b">r%d\n" % i)
            for j in range(0, len(r), 61):
                f.write(r[j:j + 61] + b"\n")
    sc = count_fastx(p, k, capacity=8192, batch=8, length=128)
    want = collections.Counter()
    for r in records:
        it = o.CanonicalKmerIterator(r, k)
        for _, fw, rc in it:
            want[min(fw, rc)] += 1
    assert sc.to_pairs() == sorted(want.items())
    assert sc.dropped_unique == 0


def test_eviction_policy_lowest_count_first():
    """Over-capacity merges evict the rarest k-mers first (ties: largest
    keys), keeping the heavy hitters -- the documented policy."""
    k = 5
    sc = StreamingCounter(k, capacity=4)
    # 6 distinct canonical 5-mers with controlled multiplicities in ONE
    # batch: each read is one 5-mer repeated as separate rows
    kmers = [b"AAAAA", b"AAAAC", b"AAAAG", b"AAACC", b"AAAGG", b"AATTC"]
    mults = [6, 5, 4, 3, 2, 1]
    rows = []
    for s, m in zip(kmers, mults):
        rows += [s] * m
    batch = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(-1, 5)
    sc.update(jnp.asarray(batch))
    pairs = sc.to_pairs()
    # capacity 4 keeps the 4 highest counts
    assert sorted(c for _, c in pairs) == [3, 4, 5, 6]
    assert sc.dropped_unique == 2
    assert sc.dropped_kmers == 3  # counts 2 + 1
    # keys stay sorted (lookup invariant)
    keys = [w for w, _ in pairs]
    assert keys == sorted(keys)
    # lookup still exact for survivors
    for s, m in zip(kmers[:3], mults[:3]):
        it = o.CanonicalKmerIterator(s, k)
        km, _ = it.get()
        word = km.get_canonical_word()
        from kmers_tpu.core import u64 as u
        got = int(np.asarray(sc.lookup(u.from_numpy(
            np.array([word], dtype=np.uint64))))[0])
        assert got == m


def test_eviction_tie_breaks_toward_large_keys():
    k = 5
    sc = StreamingCounter(k, capacity=2)
    kmers = [b"AAAAA", b"AAAAC", b"AAAAG"]  # canonical words ascending
    batch = np.frombuffer(b"".join(kmers), dtype=np.uint8).reshape(-1, 5)
    sc.update(jnp.asarray(batch))
    pairs = sc.to_pairs()
    assert [c for _, c in pairs] == [1, 1]
    # all counts equal -> the numerically largest canonical word evicted
    words = []
    for s in kmers:
        it = o.CanonicalKmerIterator(s, k)
        km, _ = it.get()
        words.append(km.get_canonical_word())
    assert [w for w, _ in pairs] == sorted(words)[:2]
    assert sc.dropped_unique == 1


def test_count_fastx_packed_matches_ascii(tmp_path):
    """The packed-ingest pipeline (update_packed) produces the identical
    table to the ASCII path, N-handling and halo chunking included."""
    k = 19
    records = [rand_seq(RNG.randrange(25, 260)) for _ in range(20)]
    records.append(rand_seq(700))
    p = str(tmp_path / "reads.fastq")
    with open(p, "wb") as f:
        for i, r in enumerate(records):
            f.write(b"@r%d\n" % i + r + b"\n+\n" + b"I" * len(r) + b"\n")
    sc_p = count_fastx(p, k, capacity=8192, batch=8, length=96, packed=True)
    sc_a = count_fastx(p, k, capacity=8192, batch=8, length=96, packed=False)
    assert sc_p.to_pairs() == sc_a.to_pairs()
    assert sc_p.kmers == sc_a.kmers
    assert sc_p.to_pairs() == oracle_counts(records, k)


def test_sharded_count_fastx_matches_single_device(tmp_path):
    """BASELINE config 5 operational: sharding meets a FILE.  8-virtual-
    device sharded count of a FASTQ (packed ingest, all_to_all routing,
    [D, cap] shard tables through the deferred merge) is bit-exact vs the
    single-device table and the oracle."""
    import jax

    from kmers_tpu.parallel.stream import ShardedStreamingCounter

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    k = 21
    records = [rand_seq(RNG.randrange(30, 220)) for _ in range(30)]
    records.append(rand_seq(900))
    p = str(tmp_path / "reads.fastq")
    with open(p, "wb") as f:
        for i, r in enumerate(records):
            f.write(b"@r%d\n" % i + r + b"\n+\n" + b"I" * len(r) + b"\n")
    single = count_fastx(p, k, capacity=8192, batch=8, length=96)
    sharded = count_fastx(p, k, capacity=8192, batch=8, length=96,
                          devices=8, route_capacity=512)
    assert sharded.route_overflow == 0
    assert sharded.to_pairs() == single.to_pairs()
    assert sharded.to_pairs() == oracle_counts(records, k)
    assert sharded.kmers == single.kmers
    # ASCII sharded path agrees too (odd batch size exercises row padding)
    sharded_a = count_fastx(p, k, capacity=8192, batch=7, length=96,
                            devices=8, route_capacity=512, packed=False)
    assert sharded_a.to_pairs() == single.to_pairs()


def test_sharded_streaming_wide(tmp_path):
    import jax

    from kmers_tpu.core import u128 as u128mod
    from kmers_tpu.oracle import numpy_ref as o
    from kmers_tpu.parallel.stream import ShardedStreamingCounter

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    k = 63
    records = [rand_seq(RNG.randrange(70, 200), b"ACGT") for _ in range(12)]
    p = str(tmp_path / "reads.fasta")
    with open(p, "wb") as f:
        for i, r in enumerate(records):
            f.write(b">r%d\n" % i + r + b"\n")
    single = count_fastx(p, k, capacity=4096, batch=4, length=224)
    sharded = count_fastx(p, k, capacity=4096, batch=4, length=224,
                          devices=4, route_capacity=512)
    assert sharded.route_overflow == 0
    assert sharded.to_pairs() == single.to_pairs()


def test_sharded_route_overflow_is_counted():
    """Tiny route capacity MUST surface overflow, never silently drop."""
    import jax
    import jax.numpy as jnp

    from kmers_tpu.parallel.stream import ShardedStreamingCounter

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    k = 15
    sc = ShardedStreamingCounter(k, capacity=8192, n_devices=8,
                                 route_capacity=8, merge_every=1)
    # pure-ACGT reads: every window valid, so per-destination load
    # (~46 lanes) far exceeds the 8-lane budget
    reads = [rand_seq(200, b"ACGT") for _ in range(16)]
    arr = jnp.asarray(np.stack(
        [np.frombuffer(r, dtype=np.uint8) for r in reads]))
    sc.update(arr)
    _ = sc.to_pairs()
    total = sum(c for _, c in sc.to_pairs())
    want_total = sum(len(list(o.CanonicalKmerIterator(r, k))) for r in reads)
    assert sc.route_overflow > 0
    assert total + sc.route_overflow == want_total


def test_kmerspec_is_the_config_carrier():
    """VERDICT r4 item 8: KmerSpec carries (k, w, seed) -- and nothing
    else: no environment knob feeds the configuration -- and is accepted
    by count_reads* and the counters."""
    import dataclasses

    from kmers_tpu import KmerSpec
    from kmers_tpu.parallel import pipeline

    spec = KmerSpec(21, w=7, seed=9)
    assert [f.name for f in dataclasses.fields(KmerSpec)] == ["k", "w",
                                                              "seed"]
    assert not hasattr(KmerSpec, "from_env")
    assert spec.aggregate == "unit" and not spec.wide
    _, arr = make_batch(4, 60)
    via_spec = pipeline.count_reads(arr, spec)
    via_int = pipeline.count_reads(arr, 21)
    np.testing.assert_array_equal(np.asarray(via_spec.table.keys.lo),
                                  np.asarray(via_int.table.keys.lo))
    with pytest.raises(ValueError):
        pipeline.count_reads(arr, k=20, spec=spec)
    # counters take the spec in place of k (seed/w ride along)
    sc = StreamingCounter(spec, capacity=1024)
    assert sc.k == 21 and sc.spec.seed == 9
    reads, arr = make_batch(4, 60)
    sc.update(arr)
    assert sc.to_pairs() == oracle_counts(reads, 21)
    # wide + k=32 fallbacks keep their aggregate forms
    assert KmerSpec(32).aggregate == "runlength"
    assert KmerSpec(63).aggregate == "unit"
    assert KmerSpec(33).wide


def test_sharded_counter_takes_spec_seed():
    import jax

    from kmers_tpu import KmerSpec
    from kmers_tpu.parallel.stream import ShardedStreamingCounter

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    spec = KmerSpec(15, w=7, seed=3)
    sc = ShardedStreamingCounter(spec, capacity=4096, n_devices=8,
                                 route_capacity=256, merge_every=1)
    reads, arr = make_batch(8, 64)
    sc.update(arr)
    assert sc.route_overflow == 0
    assert sc.to_pairs() == oracle_counts(reads, 15)
