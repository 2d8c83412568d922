"""Per-batch emission -- ASCII or packed rows -> windows -> canonical ->
hash / folded unit keys -- on the jnp path every backend compiles, checked
against the scalar oracle at the k, L, batch and N/lowercase mixes of the
emission kernels this path replaced."""

import numpy as np
import pytest
import jax.numpy as jnp

from kmers_tpu.core import u64 as u
from kmers_tpu.core import u128 as u128mod
from kmers_tpu.io.fastx import pack_batch_np
from kmers_tpu.oracle import numpy_ref as o
from kmers_tpu.ops import kmer as kmer_ops
from kmers_tpu.parallel import count as count_ops
from kmers_tpu.parallel import pipeline

RNG = np.random.default_rng(77)


def make_reads(B, L, n_frac=0.03):
    reads = RNG.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(B, L))
    reads[RNG.random((B, L)) < n_frac] = ord("N")
    lower = RNG.random((B, L)) < 0.1
    reads[lower] |= 0x20
    return jnp.asarray(reads)


def oracle_windows(reads, k):
    """{(row, pos): (forward word, canonical word)} of every N-free
    window, from the scalar 128-bit model (exact for every k <= 64)."""
    return {(i, p): (fw, cw)
            for i, row in enumerate(np.asarray(reads))
            for p, fw, cw in o.canonical_windows_wide(row.tobytes(), k)}


def words64(x):
    return (np.asarray(x.hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(x.lo).astype(np.uint64)


def words128(x):
    return [[(int(h) << 64) | int(lo) for h, lo in zip(hr, lr)]
            for hr, lr in zip(words64(x.hi), words64(x.lo))]


def assert_valid_lanes(valid, want):
    v = np.asarray(valid)
    got = {(int(i), int(p)) for i, p in zip(*np.nonzero(v))}
    assert got == set(want)


@pytest.mark.parametrize("k", [5, 16, 17, 31, 32])
def test_window_canonical_hash_matches_oracle(k):
    reads = make_reads(8, 256)
    win = kmer_ops.kmer_windows(reads, k)
    canon = kmer_ops.canonical_word(win.fw, win.rc)
    h = words64(u.mix_hash(canon, 3))
    c = words64(canon)
    want = oracle_windows(reads, k)
    assert_valid_lanes(win.valid, want)
    for (i, p), (_, cw) in want.items():
        assert int(c[i, p]) == cw
        assert int(h[i, p]) == o.mix_hash(cw, 3)


def test_window_canonical_many_rows():
    """32 rows x 128 lanes, k=31: every row is its own record."""
    k = 31
    reads = make_reads(32, 128)
    win = kmer_ops.kmer_windows(reads, k)
    c = words64(kmer_ops.canonical_word(win.fw, win.rc))
    want = oracle_windows(reads, k)
    assert_valid_lanes(win.valid, want)
    for (i, p), (_, cw) in want.items():
        assert int(c[i, p]) == cw


@pytest.mark.parametrize("stage", ["pack", "canon"])
@pytest.mark.parametrize("k", [5, 16, 17, 31])
def test_unit_keys_folded_layout(stage, k):
    """unit_table's folded spare-bit layout: bit 31 of hi is the invalid
    flag, valid lanes hold the word, invalid lanes are exactly
    (0x80000000, 0) -- and sorting the folded keys puts valid lanes
    first."""
    reads = make_reads(8, 256)
    win = kmer_ops.kmer_windows(reads, k)
    word = (kmer_ops.canonical_word(win.fw, win.rc) if stage == "canon"
            else win.fw)
    keys = count_ops.unit_table(word, win.valid).keys
    hi, lo = np.asarray(keys.hi), np.asarray(keys.lo)
    want = oracle_windows(reads, k)
    assert_valid_lanes((hi >> 31) == 0, want)
    w = words64(keys)
    for (i, p), (fw, cw) in want.items():
        assert int(w[i, p]) == (cw if stage == "canon" else fw)
    v = np.asarray(win.valid)
    assert (hi[~v] == 0x80000000).all() and (lo[~v] == 0).all()
    s_hi = np.sort(((hi.astype(np.uint64) << np.uint64(32)) | lo).ravel())
    n_valid = int(v.sum())
    assert (s_hi[:n_valid] >> np.uint64(63) == 0).all()
    assert (s_hi[n_valid:] >> np.uint64(63) == 1).all()


@pytest.mark.parametrize("stage", ["pack", "canon"])
@pytest.mark.parametrize("k,L", [(5, 128), (15, 256), (16, 256), (17, 256),
                                 (21, 1024), (31, 256)])
def test_packed_windows_match_oracle(stage, k, L):
    """The CLI's default ingest layout (read_packed_batches: [B, L/16]
    code words + [B, L/32] validity bits) gives the oracle's windows."""
    reads = make_reads(8, L)
    words, vbits = (jnp.asarray(a) for a in pack_batch_np(np.asarray(reads)))
    win = kmer_ops.kmer_windows_packed(words, vbits, k)
    word = (kmer_ops.canonical_word(win.fw, win.rc) if stage == "canon"
            else win.fw)
    w = words64(word)
    want = oracle_windows(reads, k)
    assert_valid_lanes(win.valid, want)
    for (i, p), (fw, cw) in want.items():
        assert int(w[i, p]) == (cw if stage == "canon" else fw)


def test_count_reads_packed_unit_table_exact():
    """The packed unit path produces the same counted table as the ASCII
    path after a merge -- the CLI-default invariant."""
    k, B, L = 21, 8, 256
    reads = make_reads(B, L)
    words, vbits = (jnp.asarray(a) for a in pack_batch_np(np.asarray(reads)))
    res_p = pipeline.count_reads_packed(words, vbits, k, aggregate="unit")
    res_a = pipeline.count_reads(reads, k, aggregate="unit")
    tp = count_ops.merge_many([res_p.table], max_k=k)
    ta = count_ops.merge_many([res_a.table], max_k=k)
    assert int(res_p.metrics["kmers_emitted"]) == int(
        res_a.metrics["kmers_emitted"])
    nu = int(ta.n_unique)
    assert int(tp.n_unique) == nu
    for a, b in ((tp.keys.hi, ta.keys.hi), (tp.keys.lo, ta.keys.lo),
                 (tp.counts, ta.counts)):
        np.testing.assert_array_equal(np.asarray(a)[:nu], np.asarray(b)[:nu])


@pytest.mark.parametrize("k", [33, 48, 63, 64])
def test_window_wide_canonical_hash_matches_oracle(k):
    reads = make_reads(8, 256)
    win = kmer_ops.kmer_windows_wide(reads, k)
    canon = kmer_ops.canonical_word_wide(win.fw, win.rc)
    c = words128(canon)
    h = words64(u128mod.mix_hash(canon, 7))
    want = oracle_windows(reads, k)
    assert_valid_lanes(win.valid, want)
    for (i, p), (_, cw) in want.items():
        assert c[i][p] == cw
        assert int(h[i, p]) == o.mix_hash_wide(cw, 7)


@pytest.mark.parametrize("k", [33, 48, 63])
def test_unit_keys_wide_folded_layout(k):
    """UnitTableWide's layout: bit 31 of hi.hi flags invalid lanes, which
    are exactly (0x80000000, 0, 0, 0); valid lanes hold the canonical
    128-bit word."""
    reads = make_reads(8, 256)
    win = kmer_ops.kmer_windows_wide(reads, k)
    canon = kmer_ops.canonical_word_wide(win.fw, win.rc)
    keys = count_ops.unit_table_wide(canon, win.valid).keys
    k3 = np.asarray(keys.hi.hi)
    want = oracle_windows(reads, k)
    assert_valid_lanes((k3 >> 31) == 0, want)
    w = words128(keys)
    for (i, p), (_, cw) in want.items():
        assert w[i][p] == cw
    v = np.asarray(win.valid)
    assert (k3[~v] == 0x80000000).all()
    for plane in (keys.hi.lo, keys.lo.hi, keys.lo.lo):
        assert (np.asarray(plane)[~v] == 0).all()


def test_count_reads_wide_unit_table_exact():
    """The wide unit path merges to the same table as the compact wide
    path."""
    k, B, L = 47, 8, 256
    reads = make_reads(B, L)
    res_u = pipeline.count_reads_wide(reads, k, aggregate="unit")
    tu = count_ops.merge_many_wide([res_u.table], max_k=k)
    tc = pipeline.count_reads_wide(reads, k, aggregate="compact").table
    nu = int(tc.n_unique)
    assert int(tu.n_unique) == nu
    for a, b in ((tu.keys.hi.hi, tc.keys.hi.hi),
                 (tu.keys.hi.lo, tc.keys.hi.lo),
                 (tu.keys.lo.hi, tc.keys.lo.hi),
                 (tu.keys.lo.lo, tc.keys.lo.lo),
                 (tu.counts, tc.counts)):
        np.testing.assert_array_equal(np.asarray(a)[:nu], np.asarray(b)[:nu])
