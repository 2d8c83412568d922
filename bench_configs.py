"""Measure the five BASELINE.json graded configs; print one JSON line each.

Usage: python bench_configs.py [--quick] [--lengths | --generic | --stream
                                          | --superk | --lookup]

Runs on jax.devices()[0]; every arm times the plain jnp/XLA path that
production runs.  Multi-device configs (4, 5) measure one device here;
their sharded paths are checked on the 8-device CPU mesh by
tests/test_parallel.py, tests/test_halo.py and on four GPUs by
``chip_smoke.py --devices 4``.

Timing: the benchlib serial-chain slope protocol -- every iteration's input
is derived on-device from the previous iteration's outputs, the only sync
is a dependent-scalar fetch, and the rate is the slope between two chain
lengths (see benchlib.py).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

import benchlib

QUICK = "--quick" in sys.argv


def first_reads(B, L, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                                  size=(B, L)))


def emit(name, value, unit, note=""):
    print(json.dumps({"config": name, "value": round(value, 1), "unit": unit,
                      "note": note}), flush=True)


def emit_hash_k31(reads):
    """Plain emission at k=31 (windows + canonical + hash), next input
    derived from the hash word."""
    from kmers_tpu.core import u64 as u
    from kmers_tpu.ops import kmer as kmer_ops

    win = kmer_ops.kmer_windows(reads, 31)
    h = u.mix_hash(kmer_ops.canonical_word(win.fw, win.rc), 0)
    return benchlib.ascii_from_codes(h.lo)


def main():
    from kmers_tpu.core import u64 as u
    from kmers_tpu.ops import hash as hash_ops
    from kmers_tpu.ops import kmer as kmer_ops
    from kmers_tpu.ops import minimizer as mini_ops
    from kmers_tpu.parallel import count_reads

    # config 1: k=15 encode+hash, 10k x 150bp reads
    B1, L1 = (1024, 152) if QUICK else (10240, 152)

    def cfg1(reads):
        win = kmer_ops.kmer_windows(reads, 15)
        h = u.mix_hash(win.fw)
        return benchlib.ascii_from_codes(h.lo)

    # k15 is fast enough that the default 256-iteration delta can sit
    # within dispatch jitter: stretch the chain.
    rate = benchlib.chain_rate(cfg1, first_reads(B1, L1, 1),
                               B1 * (L1 - 15 + 1), s_short=8, s_long=2056)
    emit("k15_encode_hash_150bp", rate, "kmers/s")

    # config 2: k=31 canonical over 1M reads (streamed in batches)
    B2, L2 = 2048, 1024

    rate = benchlib.chain_rate(emit_hash_k31, first_reads(B2, L2, 2),
                               B2 * (L2 - 31 + 1))
    emit("k31_canonical_hash", rate, "kmers/s",
         "bit-exactness vs reference: tests/test_ops.py, tests/test_oracle.py")

    # config 3: k=63 multi-word (2xu64) windows + canonical + hash
    from kmers_tpu.core import u128 as u128mod

    B3, L3 = (256, 512) if QUICK else (2048, 1024)

    def cfg3(reads):
        win = kmer_ops.kmer_windows_wide(reads, 63)
        h = u128mod.mix_hash(kmer_ops.canonical_word_wide(win.fw, win.rc))
        return benchlib.ascii_from_codes(h.lo)

    rate = benchlib.chain_rate(cfg3, first_reads(B3, L3, 3),
                               B3 * (L3 - 63 + 1))
    emit("k63_2xu64_window_canonical", rate, "kmers/s",
         "bit-exactness vs oracle: tests/test_emission.py")

    # config 4: minimizers w=11 k=31 under the super-k-mer partition's
    # mix16 order (the selection pipeline.emit_superkmers runs)
    B4, L4 = (256, 512) if QUICK else (2048, 1024)
    order16 = hash_ops.mix16_hash_fn(0)

    def cfg4(reads):
        mm = mini_ops.minimizer_stream(reads, 31, 11, order16)
        return benchlib.ascii_from_codes(mm.word.lo
                                         ^ mm.pos.astype(jnp.uint32))

    rate = benchlib.chain_rate(cfg4, first_reads(B4, L4, 4),
                               B4 * (L4 - 31 + 1))
    emit("minimizers_k31_w11", rate, "kmers/s",
         "mix16 selection order; multi-device data-parallel path: "
         "tests/test_halo.py on the CPU mesh")

    # config 5: full counting pipeline (windows+canonical+sort+count),
    # E. coli-scale stream = many such batches; multi-host all_to_all path
    # validated on CPU mesh (tests/test_parallel.py)
    B5, L5 = (512, 256) if QUICK else (4096, 256)

    def cfg5(reads):
        res = count_reads(reads, 31)
        # scalar depending on the whole table; rotates every base code
        s = (jnp.sum(res.table.counts.astype(jnp.uint32)) ^
             jnp.sum(res.table.keys.lo)) & jnp.uint32(3)
        internal = (reads.astype(jnp.uint32) >> 1) & jnp.uint32(3)
        code = internal ^ (internal >> 1)
        return benchlib.ascii_from_codes(code + s)

    rate = benchlib.chain_rate(cfg5, first_reads(B5, L5, 5),
                               B5 * (L5 - 31 + 1))
    emit("count_pipeline_k31", rate, "kmers/s",
         "scatter-free sort+compact count table per batch; sharded path on CPU mesh")

    # config 5r: same pipeline in the streaming per-batch form -- run-length
    # table (count_sorted_runs), no per-batch compaction sort; this is what
    # StreamingCounter actually executes per batch
    def cfg5r(reads):
        res = count_reads(reads, 31, compact=False)
        s = (jnp.sum(res.table.counts.astype(jnp.uint32)) ^
             jnp.sum(res.table.keys.lo)) & jnp.uint32(3)
        internal = (reads.astype(jnp.uint32) >> 1) & jnp.uint32(3)
        code = internal ^ (internal >> 1)
        return benchlib.ascii_from_codes(code + s)

    rate = benchlib.chain_rate(cfg5r, first_reads(B5, L5, 5),
                               B5 * (L5 - 31 + 1))
    emit("count_pipeline_k31_runlength", rate, "kmers/s",
         "run-length table form (round-3 streaming per-batch mode): key "
         "sort + reverse-cummin, compaction deferred to consolidation")

    # config 5u: the streaming per-batch form -- UnitTable passthrough
    # (raw folded canonical keys, zero per-batch aggregation; see
    # kmers_tpu/parallel/count.UnitTable)
    def cfg5u(reads):
        res = count_reads(reads, 31, aggregate="unit")
        s = (jnp.sum(res.table.keys.lo) ^ jnp.sum(res.table.keys.hi)
             ) & jnp.uint32(3)
        internal = (reads.astype(jnp.uint32) >> 1) & jnp.uint32(3)
        code = internal ^ (internal >> 1)
        return benchlib.ascii_from_codes(code + s)

    rate = benchlib.chain_rate(cfg5u, first_reads(B5, L5, 5),
                               B5 * (L5 - 31 + 1))
    emit("count_pipeline_k31_unit", rate, "kmers/s",
         "unit passthrough form (the streaming per-batch mode): the "
         "per-batch table IS the folded canonical keys")


def length_matrix():
    """The reference's criterion matrix, all four arms
    (/root/reference/benches/simple_benchmark.rs:58-102): k=31 construct
    and reverse-complement, naive_impl vs generic+Xor10, over input
    lengths 2^8..2^15.

    ONE static shape serves the whole matrix (VERDICT r3 item 4): every
    length packs into the same [B, 2^15] slab as N-separated reads --
    m = floor((2^15+1)/(len+1)) reads of `len` bases per row, one 'N'
    between them (the N machinery invalidates the straddling windows
    natively, exactly as in production ragged batches).  Each arm
    therefore compiles exactly one chain pair; per-length numbers differ
    only in input data.  Rates use the VALID k-mers actually produced, so
    short lengths honestly pay their separator/tail overhead
    ((len-k+1)/(len+1) utilization) -- the batched analog of the
    reference's per-length efficiency curve.

    Arm mapping (batch-first analogs of the per-window scalar loops):
      construct/naive  -> windows + canonical + hash (the emission path)
      construct/xor10  -> xor10 base codes + log-doubling window words
                          (generic Kmer<u64,31> + Xor10)
      rc/naive         -> windows + the 5-step revcomp ladder
      rc/xor10         -> xor10 windows + complement(^0b10) + base
                          reversal + shift (corrected semantics)
    """
    from kmers_tpu.core import u64 as u
    from kmers_tpu.ops import kmer as kmer_ops

    K = 31
    B, LPAD = (8, 1 << 15) if QUICK else (64, 1 << 15)
    arm_naive = emit_hash_k31

    def arm_xor10(reads):
        internal = (reads.astype(jnp.uint32) >> 1) & jnp.uint32(3)
        w = kmer_ops.window_words(internal, K)    # Kmer<u64,31> words
        return benchlib.ascii_from_codes(w.lo ^ w.hi)

    def arm_rc_naive(reads):
        win = kmer_ops.kmer_windows(reads, K)     # includes revcomp
        return benchlib.ascii_from_codes(win.rc.lo ^ win.rc.hi)

    def arm_rc_xor10(reads):
        internal = (reads.astype(jnp.uint32) >> 1) & jnp.uint32(3)
        w = kmer_ops.window_words(internal, K)
        comp = u.xor_const(w, 0xAAAAAAAAAAAAAAAA)  # code ^ 0b10 per base
        rc = u.shr(u.reverse_bases(comp), 2 * (32 - K))
        return benchlib.ascii_from_codes(rc.lo ^ rc.hi)

    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    exps = (8, 12, 15) if QUICK else range(8, 16)
    for exp in exps:
        L = 1 << exp
        m = (LPAD + 1) // (L + 1)        # reads per row, N-separated
        row = np.full((B, LPAD), ord("N"), dtype=np.uint8)
        for j in range(m):
            s = j * (L + 1)
            row[:, s:s + L] = rng.choice(acgt, size=(B, L))
        reads0 = jnp.asarray(row)
        n = B * m * (L - K + 1)
        for name, fn in (("naive", arm_naive), ("xor10", arm_xor10),
                         ("rc_naive", arm_rc_naive),
                         ("rc_xor10", arm_rc_xor10)):
            rate = benchlib.chain_rate(fn, reads0, n)
            emit(f"{name}_k31_len_2e{exp}", rate, "kmers/s",
                 f"B={B} x {m} reads/row, one [B, 32768] compile per arm")


def generic_layer_bench():
    """Throughput of ops/generic.py itself (encode / rev_comp, u64+Xor10
    and u64+ACGT) on [N, 31] k-mer batches -- the generic layer had never
    been timed (VERDICT r2 missing item 1)."""
    from kmers_tpu.ops import generic as g

    N = 1 << 18
    rng = np.random.default_rng(7)
    kmers0 = jnp.asarray(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                                    size=(N, 31)))
    def lanes_to_next_ascii(lanes):
        """Derive the next [N, 31] ASCII batch from both output lanes
        (serial dependency on everything the benched op computes)."""
        shifts = 2 * jnp.arange(16, dtype=jnp.uint32)
        parts = [((x[..., None] >> shifts) & jnp.uint32(3)) for x in lanes]
        codes = jnp.concatenate(parts, axis=-1)[:, :31]
        return benchlib.ascii_from_codes(codes)

    for enc_name in ("xor10", "ACGT"):
        spec = g.GenericSpec(64, 31, enc_name)

        def enc_step(ascii_u8, spec=spec):
            return lanes_to_next_ascii(g.encode(spec, ascii_u8))

        rate = benchlib.chain_rate(enc_step, kmers0, N)
        emit(f"generic_encode_u64_{enc_name}", rate, "kmers/s", f"N={N}")

        def rc_step(ascii_u8, spec=spec):
            return lanes_to_next_ascii(
                g.rev_comp(spec, g.encode(spec, ascii_u8)))

        rate = benchlib.chain_rate(rc_step, kmers0, N)
        emit(f"generic_encode_revcomp_u64_{enc_name}", rate, "kmers/s",
             f"N={N}")

    # windowed construction (round 4; VERDICT r3 item 5): every base
    # encoded once, windows assembled from the shared log-doubling pack --
    # vs the per-kmer [N, 31] layout above that re-reads each base k times
    B, L = 2048, 1024
    reads0 = first_reads(B, L, 8)
    for enc_name in ("xor10", "ACGT"):
        spec = g.GenericSpec(64, 31, enc_name)

        def win_step(reads, spec=spec):
            lanes, _valid = g.encode_windows(spec, reads)
            return benchlib.ascii_from_codes(lanes[0] ^ lanes[1])

        rate = benchlib.chain_rate(win_step, reads0, B * (L - 31 + 1))
        emit(f"generic_encode_windows_u64_{enc_name}", rate, "kmers/s",
             f"B={B} L={L}; bit-exact vs per-window encode "
             "(tests/test_generic.py)")


def superkmer_bench():
    """Single-chip DEVICE cost of the two sharded-routing modes, k=31
    w=11 (1-device mesh: the all_to_all is degenerate, so this isolates
    emission + bucketing + [expansion] + unit-table wrap -- the compute
    price paid for minimizer partitioning's 4.0x wire-byte win; the win
    itself is a multi-device property, reported as route_bytes)."""
    from kmers_tpu.parallel import mesh as mesh_ops, pipeline

    m = mesh_ops.make_mesh(1)
    B, L = (256, 256) if QUICK else (2048, 256)
    n = B * (L - 31 + 1)
    sk = pipeline.make_superkmer_counter(m, 31, 11,
                                         route_capacity=1 << 17,
                                         aggregate="unit")
    hashed = pipeline.make_sharded_counter(m, 31, route_capacity=1 << 20,
                                           aggregate="unit")

    def mk(counter):
        def fn(reads):
            res = counter(reads)
            s = (jnp.sum(res.table.keys.lo) ^ jnp.sum(res.table.keys.hi)
                 ) & jnp.uint32(3)
            internal = (reads.astype(jnp.uint32) >> 1) & jnp.uint32(3)
            code = internal ^ (internal >> 1)
            return benchlib.ascii_from_codes(code + s)
        return fn

    reads0 = first_reads(B, L, 17)
    for name, counter in (("superkmer", sk), ("hash", hashed)):
        rate = benchlib.chain_rate(mk(counter), reads0, n)
        emit(f"partition_{name}_device_cost_k31", rate, "kmers/s",
             "emission+bucket+expand+unit wrap, 1-device mesh")


def streaming_sustained():
    """The honest TOTAL device cost of streaming counting: per-batch unit
    emission is ~free (config 5u), so the cost center is the deferred
    consolidation.  This measures seconds per consolidation with the
    chain-slope protocol (each iteration's pending keys derive from the
    previous merged table -- serial dependency) in both regimes:

      noevict: distinct keys fit capacity (the sized-right common case;
               lax.cond takes the free-slice path: 2 device sorts)
      evict:   table saturated, rank-evict every merge (4 device sorts)

    and reports the sustained streaming rate
        kmers_per_batch / (t_batch_unit + t_consolidate / merge_every).
    """
    import functools

    from kmers_tpu.core.u64 import U64
    from kmers_tpu.parallel import count as count_ops
    from kmers_tpu.parallel import count_reads
    from kmers_tpu.parallel.count import CountTable, UnitTable
    from kmers_tpu.parallel.stream import _merge_bounded

    B5, L5 = (512, 256) if QUICK else (4096, 256)
    ME = 4 if QUICK else 16           # merge_every
    CAP = (1 << 19) if QUICK else (1 << 23)
    lanes = B5 * L5

    def mix32(x):
        x = x ^ (x >> 16)
        x = x * jnp.uint32(0x7FEB352D)
        x = x ^ (x >> 15)
        x = x * jnp.uint32(0x846CA68B)
        return x ^ (x >> 16)

    def make_step(space_bits: int):
        lo_mask = jnp.uint32((1 << min(space_bits, 32)) - 1)
        hi_bits = max(space_bits - 32, 0)
        hi_mask = jnp.uint32((1 << hi_bits) - 1)   # < bit 31: flag stays clear

        @functools.partial(jax.jit, donate_argnums=0)
        def step(table):
            base = table.keys.lo[:lanes] ^ table.keys.hi[:lanes]
            pending = tuple(
                UnitTable(keys=U64(
                    mix32(base + jnp.uint32(2 * i + 1)) & hi_mask,
                    mix32(base ^ jnp.uint32((0x9E3779B9 * (i + 1))
                                            & 0xFFFFFFFF)) & lo_mask))
                for i in range(ME))
            out, _, _ = _merge_bounded(table, pending, CAP, max_k=31)
            return out

        return step

    z = jnp.zeros(CAP, dtype=jnp.uint32)
    table0 = CountTable(keys=U64(z, z), counts=jnp.zeros(CAP, jnp.int32),
                        n_unique=jnp.int32(0))
    # noevict: ME*lanes draws from a space_bits space; distinct << CAP
    ne_bits = max(CAP.bit_length() - 3, 16)
    sec_ne = benchlib.chain_seconds_per_iter(
        make_step(ne_bits), table0, s_short=2, s_long=10, rounds=4)
    emit("consolidate_noevict", sec_ne * 1e3, "ms/merge",
         f"capacity {CAP}, {ME} pending x {lanes} lanes: concat + "
         "weighted re-count (2 sorts)")
    sec_ev = benchlib.chain_seconds_per_iter(
        make_step(60), table0, s_short=2, s_long=10, rounds=4)
    emit("consolidate_evict", sec_ev * 1e3, "ms/merge",
         "saturated table, rank-evict every merge (re-count + eviction "
         "sorts)")

    def cfg5u(reads):
        res = count_reads(reads, 31, aggregate="unit")
        s = (jnp.sum(res.table.keys.lo) ^ jnp.sum(res.table.keys.hi)
             ) & jnp.uint32(3)
        internal = (reads.astype(jnp.uint32) >> 1) & jnp.uint32(3)
        code = internal ^ (internal >> 1)
        return benchlib.ascii_from_codes(code + s)

    t_batch = benchlib.chain_seconds_per_iter(cfg5u, first_reads(B5, L5, 5))
    kmers_per_batch = B5 * (L5 - 31 + 1)
    for name, sec in (("noevict", sec_ne), ("evict", sec_ev)):
        sustained = kmers_per_batch / (t_batch + sec / ME)
        emit(f"stream_sustained_{name}", sustained, "kmers/s",
             f"per-batch {t_batch*1e3:.3f} ms + merge {sec*1e3:.1f} ms / "
             f"merge_every {ME}")

    # the CLI's default ingest: PACKED batches (0.375 B/base of input)
    from kmers_tpu.io.fastx import pack_batch_np
    from kmers_tpu.parallel.pipeline import count_reads_packed

    w0, v0 = pack_batch_np(np.asarray(first_reads(B5, L5, 5)))
    wv0 = (jnp.asarray(w0), jnp.asarray(v0))

    def cfg5p(carry):
        words, validbits = carry
        res = count_reads_packed(words, validbits, 31, aggregate="unit")
        s = (jnp.sum(res.table.keys.lo) ^ jnp.sum(res.table.keys.hi))
        return (words ^ (s & jnp.uint32(3)), validbits)

    t_packed = benchlib.chain_seconds_per_iter(cfg5p, wv0)
    emit("count_pipeline_k31_unit_packed", kmers_per_batch / t_packed,
         "kmers/s", "packed-ingest unit emission (count_reads_packed)")


def lookup_bench():
    """Distributed lookup service (VERDICT r4 item 9): queries/s/chip for
    make_sharded_lookup on a 1-device mesh -- the all_to_all is degenerate,
    so this isolates the device cost of the query path: owner bucket-sort,
    binary search over the shard table, and the sort-based reply
    delivery."""
    from kmers_tpu.core.u64 import U64
    from kmers_tpu.parallel import count as count_ops
    from kmers_tpu.parallel import mesh as mesh_ops, pipeline

    NQ = (1 << 16) if QUICK else (1 << 20)
    CAP = 1 << 20
    m = mesh_ops.make_mesh(1)
    # build a realistic table: random keys, counts 1..100
    rng = np.random.default_rng(11)
    n_keys = CAP // 2
    keys = np.zeros(CAP, np.uint64)
    keys[:n_keys] = np.sort(
        rng.choice(2**62, size=n_keys, replace=False)).astype(np.uint64)
    table = count_ops.CountTable(
        keys=U64(jnp.asarray((keys >> 32).astype(np.uint32)),
                 jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32))),
        counts=jnp.asarray(
            np.where(np.arange(CAP) < n_keys,
                     rng.integers(1, 100, CAP), 0).astype(np.int32)),
        n_unique=jnp.int32(n_keys))
    tables = jax.tree.map(lambda x: x[None], table)    # leading [D=1]

    q0 = U64(jnp.asarray(rng.integers(0, 2**30, NQ, dtype=np.uint32)),
             jnp.asarray(rng.integers(0, 2**32, NQ, dtype=np.uint32)))
    valid = jnp.ones(NQ, dtype=bool)

    def mix32(x):
        x = x ^ (x >> 16)
        x = x * jnp.uint32(0x7FEB352D)
        x = x ^ (x >> 15)
        x = x * jnp.uint32(0x846CA68B)
        return x ^ (x >> 16)

    lookup = pipeline.make_sharded_lookup(m, query_capacity=NQ)

    def step(carry):
        qh, ql = carry
        counts, _ov = lookup(tables, qh, ql, valid)
        u = counts.astype(jnp.uint32)
        return (mix32(qh ^ u) & jnp.uint32(0x3FFFFFFF), mix32(ql + u))

    sec = benchlib.chain_seconds_per_iter(step, (q0.hi, q0.lo),
                                          s_short=4, s_long=68, rounds=4)
    emit("lookup_service_1chip_binsearch", NQ / sec, "queries/s",
         f"{NQ} queries vs {n_keys}-key table; per-query binary search")


if __name__ == "__main__":
    from kmers_tpu import compile_cache

    compile_cache.configure()
    if "--lengths" in sys.argv:
        length_matrix()
    elif "--generic" in sys.argv:
        generic_layer_bench()
    elif "--stream" in sys.argv:
        streaming_sustained()
    elif "--superk" in sys.argv:
        superkmer_bench()
    elif "--lookup" in sys.argv:
        lookup_bench()
    else:
        main()
