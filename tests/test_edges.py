"""Adversarial edge cases on the device paths (VERDICT r1 item 9).

Each case runs the jnp window path -- the one every backend compiles --
and checks it against the scalar oracle.  Cases: palindromes at even k,
k=32 full-word canonical, all-N
reads, reads shorter than k, L == k, w == k minimizers, non-power-of-two
shard counts through the multiply-shift owner map, and count tables with
the spare-bit sort at its k boundaries.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kmers_tpu.core import u64 as u
from kmers_tpu.core.u64 import U64
from kmers_tpu.oracle import numpy_ref as o
from kmers_tpu.ops import hash as hash_ops
from kmers_tpu.ops import kmer as kmer_ops
from kmers_tpu.ops import minimizer as mini_ops
from kmers_tpu.parallel import count as count_ops
from kmers_tpu.parallel import route as route_ops

RNG = np.random.default_rng(2024)


def reads_from(seqs, pad_to=None):
    L = pad_to or max(len(s) for s in seqs)
    out = np.full((len(seqs), L), ord("N"), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
    return jnp.asarray(out)


def _windows_vs_oracle(reads, k):
    """jnp windows + canonical vs the scalar model: the valid lanes are
    exactly the oracle's N-free windows, each holding its canonical word
    (canonical_wide is exact for every k <= 64, k = 32 included)."""
    win = kmer_ops.kmer_windows(reads, k)
    canon = kmer_ops.canonical_word(win.fw, win.rc)
    v = np.asarray(win.valid)
    ch, cl = np.asarray(canon.hi), np.asarray(canon.lo)
    for i, row in enumerate(np.asarray(reads)):
        want = {p: c for p, _, c in o.canonical_windows_wide(row.tobytes(),
                                                             k)}
        assert sorted(np.flatnonzero(v[i]).tolist()) == sorted(want)
        for p, w in want.items():
            assert (int(ch[i, p]) << 32) | int(cl[i, p]) == w
    return canon, win.valid


# -- palindromes at even k -----------------------------------------------------

@pytest.mark.parametrize("k", [4, 6, 16, 32])
def test_palindrome_even_k(k):
    """fw == rc exactly at even k: canonical word equals both strands and
    the oracle agrees (reference: <= ties at kmer.rs:55-58)."""
    half = bytes(RNG.choice(list(b"ACGT"), size=k // 2).astype(np.uint8))
    pal = half + str(
        o.Kmer.from_str(half).to_reverse_complement()).upper().encode()
    assert len(pal) == k
    ok = o.Kmer.from_str(pal)
    orc = ok.to_reverse_complement()
    assert ok.data == orc.data, "constructed sequence must be a palindrome"
    assert ok.is_canonical()

    reads = reads_from([pal], pad_to=max(k, 8))
    canon, valid = _windows_vs_oracle(reads, k)
    assert bool(np.asarray(valid)[0, 0])
    got = (int(np.asarray(canon.hi)[0, 0]) << 32) | int(
        np.asarray(canon.lo)[0, 0])
    assert got == ok.data


# -- k = 32 full-word canonical ------------------------------------------------

def test_k32_full_word_canonical():
    """k=32 uses every bit of the u64 word (MASK_TABLE[32] quirk lives in
    from_u64 only; string construction supports k=32)."""
    k = 32
    seqs = [bytes(RNG.choice(list(b"ACGT"), size=k).astype(np.uint8))
            for _ in range(16)]
    seqs.append(b"T" * 32)   # all-T: word == u64::MAX
    seqs.append(b"A" * 32)   # all-A: word == 0
    reads = reads_from(seqs, pad_to=40)
    canon, valid = _windows_vs_oracle(reads, k)
    ch, cl = np.asarray(canon.hi), np.asarray(canon.lo)
    for i, s in enumerate(seqs):
        want = o.CanonicalKmer.from_str(s).get_canonical_word()
        got = (int(ch[i, 0]) << 32) | int(cl[i, 0])
        assert got == want, s
    # all-T canonicalizes to all-A (its revcomp), never to padding
    assert ((int(ch[-2, 0]) << 32) | int(cl[-2, 0])) == 0


def test_k32_all_T_vs_count_table():
    """all-T k-mers at k=32 must survive counting (no aliasing with the
    invalid sentinel): 3-key sort path, max_k=32."""
    words = np.zeros(16, dtype=np.uint64)
    words[:5] = np.uint64(0xFFFFFFFFFFFFFFFF)
    words[5:8] = np.uint64(7)
    valid = np.zeros(16, dtype=bool)
    valid[:8] = True
    t = jax.jit(lambda w, v: count_ops.count_words(w, v, max_k=32))(
        u.from_numpy(words), jnp.asarray(valid))
    assert int(t.n_unique) == 2
    assert int(t.counts[0]) == 3   # key 7 sorts first
    assert int(t.counts[1]) == 5   # u64::MAX counted, not dropped


# -- all-N reads ----------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 31])
def test_all_N_reads(k):
    reads = reads_from([b"N" * 64, b"n" * 64])
    canon, valid = _windows_vs_oracle(reads, k)
    assert not np.asarray(valid).any()
    # counting an all-invalid batch yields the empty table
    t = jax.jit(lambda c, v: count_ops.count_words(c, v, max_k=k))(
        canon, valid)
    assert int(t.n_unique) == 0
    assert int(t.counts.sum()) == 0
    # oracle iterator agrees: no k-mers emitted
    it = o.CanonicalKmerIterator(b"N" * 64, k)
    assert it.exhausted()


# -- reads shorter than k / L == k ----------------------------------------------

def test_read_shorter_than_k():
    k = 31
    reads = reads_from([b"ACGTACGT"], pad_to=k + 2)  # 8 real bases, N pad
    canon, valid = _windows_vs_oracle(reads, k)
    assert not np.asarray(valid).any()


@pytest.mark.parametrize("k", [5, 16, 31, 32])
def test_L_equals_k(k):
    """Exactly one window when L == k (structural bound iota < L-k+1)."""
    seq = bytes(RNG.choice(list(b"ACGT"), size=k).astype(np.uint8))
    reads = jnp.asarray(np.frombuffer(seq, dtype=np.uint8)[None, :])
    canon, valid = _windows_vs_oracle(reads, k)
    v = np.asarray(valid)
    assert v[0, 0] and v.sum() == 1
    want = o.CanonicalKmer.from_str(seq).get_canonical_word()
    got = (int(np.asarray(canon.hi)[0, 0]) << 32) | int(
        np.asarray(canon.lo)[0, 0])
    assert got == want


# -- w == k minimizers -----------------------------------------------------------

@pytest.mark.parametrize("k", [7, 16, 31])
def test_minimizer_w_equals_k(k):
    """w == k: the only w-mer of each window is the k-mer itself, so the
    minimizer word equals the (forward) k-mer word and pos == window pos."""
    L = 80
    seq = bytes(RNG.choice(list(b"ACGTN"), size=L,
                           p=[0.245] * 4 + [0.02]).astype(np.uint8))
    reads = jnp.asarray(np.frombuffer(seq, dtype=np.uint8)[None, :])
    hash_fn = hash_ops.mix_hash_fn(0)
    mm = mini_ops.minimizer_stream(reads, k, k, hash_fn)
    win = kmer_ops.kmer_windows(reads, k)
    v = np.asarray(mm.valid)
    np.testing.assert_array_equal(v, np.asarray(win.valid))
    sel = v[0]
    np.testing.assert_array_equal(np.asarray(mm.word.hi)[0][sel],
                                  np.asarray(win.fw.hi)[0][sel])
    np.testing.assert_array_equal(np.asarray(mm.word.lo)[0][sel],
                                  np.asarray(win.fw.lo)[0][sel])
    np.testing.assert_array_equal(
        np.asarray(mm.pos)[0][sel],
        np.arange(L, dtype=np.int32)[sel])


# -- non-power-of-two shard counts through _mul_shift32 ---------------------------

@pytest.mark.parametrize("d", [1, 3, 5, 6, 7])
def test_owner_of_non_pow2(d):
    """owner_of must hit [0, d) for non-power-of-two d, with every shard
    reachable at realistic scale (multiply-shift, not modulo)."""
    words = u.from_numpy(RNG.integers(0, 2**64, size=4096, dtype=np.uint64))
    owner = np.asarray(jax.jit(
        lambda w: route_ops.owner_of(w, d))(words))
    assert owner.min() >= 0 and owner.max() < d
    if d > 1:
        hist = np.bincount(owner, minlength=d)
        assert (hist > 0).all(), hist
        # multiply-shift on uniform hashes is near-uniform; allow wide slack
        assert hist.max() < 3 * hist.mean()


# -- spare-bit sort vs reference 3-key sort at k boundaries -----------------------

@pytest.mark.parametrize("k", [15, 16, 31])
def test_spare_bit_count_matches_full_sort(k):
    n = 512
    ws = RNG.integers(0, 2 ** (2 * k), size=n, dtype=np.uint64)
    ws[:50] = ws[0]  # force duplicates
    valid = RNG.random(n) < 0.7
    words = u.from_numpy(ws)
    va = jnp.asarray(valid)
    fast = jax.jit(lambda w, v: count_ops.count_words(w, v, max_k=k))(
        words, va)
    slow = jax.jit(lambda w, v: count_ops.count_words(w, v))(words, va)
    assert int(fast.n_unique) == int(slow.n_unique)
    m = int(fast.n_unique)
    np.testing.assert_array_equal(np.asarray(fast.keys.hi)[:m],
                                  np.asarray(slow.keys.hi)[:m])
    np.testing.assert_array_equal(np.asarray(fast.keys.lo)[:m],
                                  np.asarray(slow.keys.lo)[:m])
    np.testing.assert_array_equal(np.asarray(fast.counts),
                                  np.asarray(slow.counts))


@pytest.mark.parametrize("k", [33, 63])
def test_spare_bit_count_wide_matches_full_sort(k):
    from kmers_tpu.core import u128 as u128mod

    n = 256
    his = RNG.integers(0, 2 ** (2 * k - 64), size=n, dtype=np.uint64)
    los = RNG.integers(0, 2**64, size=n, dtype=np.uint64)
    his[:40] = his[0]
    los[:40] = los[0]
    valid = RNG.random(n) < 0.7
    words = u128mod.U128(u.from_numpy(his), u.from_numpy(los))
    va = jnp.asarray(valid)
    fast = jax.jit(lambda w, v: count_ops.count_words_wide(w, v, max_k=k))(
        words, va)
    slow = jax.jit(lambda w, v: count_ops.count_words_wide(w, v))(words, va)
    assert int(fast.n_unique) == int(slow.n_unique)
    np.testing.assert_array_equal(np.asarray(fast.counts),
                                  np.asarray(slow.counts))
    for leaf_f, leaf_s in zip(jax.tree.leaves(fast.keys),
                              jax.tree.leaves(slow.keys)):
        np.testing.assert_array_equal(np.asarray(leaf_f), np.asarray(leaf_s))
