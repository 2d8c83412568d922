"""Minimizer selection on the jnp path (ops.minimizer.minimizer_stream,
the one every backend compiles) vs a brute-force model: for each valid
k-mer window, the leftmost w-mer of minimal order among its k-w+1 w-mers.
Covers each selection order and the (k, w) shapes of the window-scan
kernel this path replaced: w == k, the largest direct-scan window, the
smallest van Herk/Gil-Werman window, the steady state, and w > 16."""

import numpy as np
import pytest
import jax.numpy as jnp

from kmers_tpu.core import u64 as u
from kmers_tpu.oracle import numpy_ref as o
from kmers_tpu.ops import hash as hash_ops
from kmers_tpu.ops import minimizer as mini_ops

RNG = np.random.default_rng(78)


def make_reads(B, L, n_frac=0.03):
    reads = RNG.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(B, L))
    reads[RNG.random((B, L)) < n_frac] = ord("N")
    lower = RNG.random((B, L)) < 0.1
    reads[lower] |= 0x20
    return reads


def brute_force(reads, k, w, hash_fn):
    """{(row, kmer pos): (w-mer word, w-mer pos)} over valid k-mers; w-mer
    words from the scalar oracle, orders from the selection order."""
    out = {}
    for i, row in enumerate(reads):
        b = row.tobytes()
        wpos = [p for p in range(len(b) - w + 1)
                if all(c in b"ACGTacgt" for c in b[p:p + w])]
        words = np.array([o.word_from_bytes(b[p:p + w].upper())
                          for p in wpos], dtype=np.uint64)
        h = hash_fn(u.from_numpy(words))
        order = (np.asarray(h.hi, np.uint64) << np.uint64(32)) | \
            np.asarray(h.lo, np.uint64)
        at = dict(zip(wpos, range(len(wpos))))
        for p in range(len(b) - k + 1):
            if not all(c in b"ACGTacgt" for c in b[p:p + k]):
                continue
            cand = [at[q] for q in range(p, p + k - w + 1)]
            best = cand[int(np.argmin(order[cand]))]     # leftmost tie
            out[(i, p)] = (int(words[best]), wpos[best])
    return out


@pytest.mark.parametrize("use_lex,order", [(False, "mix64"),
                                           (False, "mix32"),
                                           (False, "mix16"),
                                           (True, "mix64")])
@pytest.mark.parametrize("k,w", [
    (11, 11),   # one w-mer per k-mer (w == k)
    (16, 11),   # 6 w-mers: largest direct-scan window
    (17, 11),   # 7 w-mers: smallest van Herk/Gil-Werman window
    (31, 11),   # 21 w-mers: steady state
    (31, 19),   # w > 16: the order needs more than one 16-bit plane
])
def test_minimizer_selection_matches_brute_force(use_lex, order, k, w):
    reads = make_reads(8, 256)
    if use_lex:
        hash_fn = hash_ops.lex_hash_fn(w)
    else:
        hash_fn = {"mix64": hash_ops.mix_hash_fn,
                   "mix32": hash_ops.mix32_hash_fn,
                   "mix16": hash_ops.mix16_hash_fn}[order](5)
    mm = mini_ops.minimizer_stream(jnp.asarray(reads), k, w, hash_fn)
    want = brute_force(reads, k, w, hash_fn)
    v = np.asarray(mm.valid)
    assert {(int(i), int(p)) for i, p in zip(*np.nonzero(v))} == set(want)
    words = (np.asarray(mm.word.hi, np.uint64) << np.uint64(32)) | \
        np.asarray(mm.word.lo, np.uint64)
    pos = np.asarray(mm.pos)
    for (i, p), (word, wp) in want.items():
        assert (int(words[i, p]), int(pos[i, p])) == (word, wp)
