"""Pipeline-level exactness compiled for a real GPU.

The rest of the suite runs on the CPU mesh; these tests compile the
counting pipelines for the card and compare them with the scalar oracle:

    KMERS_TEST_DEVICE=gpu python -m pytest tests/ -m gpu

Elsewhere the ``gpu_device`` fixture (tests/conftest.py) skips them.
"""

import collections

import numpy as np
import pytest
import jax.numpy as jnp

from kmers_tpu.oracle import numpy_ref as o

pytestmark = pytest.mark.gpu

RNG = np.random.default_rng(77)


def rand_reads(B, L, n_rate=0.03):
    return RNG.choice(np.frombuffer(b"ACGTNacgt", dtype=np.uint8),
                      size=(B, L),
                      p=[(1 - n_rate - 0.2) / 4] * 4 + [n_rate] + [0.05] * 4)


def oracle_counts(rows, k):
    return collections.Counter(
        c for row in rows for _, _, c in o.canonical_windows_wide(
            row.tobytes(), k))


@pytest.mark.parametrize("k", [31, 47])
def test_streaming_counter_on_device_exact(gpu_device, k):
    """StreamingCounter (unit emission + deferred consolidation, with an
    eviction-free table) on the card vs the scalar oracle."""
    from kmers_tpu.parallel.stream import StreamingCounter

    rows = rand_reads(512, 96)
    sc = StreamingCounter(k, capacity=1 << 16, merge_every=2)
    for i in range(0, 512, 128):
        sc.update(jnp.asarray(rows[i:i + 128]))
    assert sc.table.counts.devices() == {gpu_device}
    want = oracle_counts(rows, k)
    assert dict(sc.to_pairs()) == dict(want)
    assert sc.kmers == sum(want.values())


def test_superkmer_pipeline_on_device_exact(gpu_device):
    """Super-k-mer counting (minimizer emission + routing + expansion) on
    a one-GPU mesh: global table equals single-device counting."""
    from kmers_tpu.parallel import mesh as mesh_ops, pipeline

    k, w = 31, 11
    reads = jnp.asarray(rand_reads(64, 256, n_rate=0.01))
    m = mesh_ops.make_mesh(1)
    cnt = pipeline.make_superkmer_counter(m, k, w, route_capacity=1 << 14,
                                          aggregate="unit")
    res = cnt(reads)
    assert int(res.metrics["route_overflow"]) == 0
    g = pipeline.global_table(res)
    want = pipeline.count_reads(reads, k, aggregate="compact").table
    nu = int(want.n_unique)
    assert int(g.n_unique) == nu
    for a, b in ((g.keys.hi, want.keys.hi), (g.keys.lo, want.keys.lo),
                 (g.counts, want.counts)):
        np.testing.assert_array_equal(np.asarray(a)[:nu], np.asarray(b)[:nu])
