#!/usr/bin/env python3
"""Prove the FASTQ -> count-table path on the GPU, through the entry points
a user calls (``python -m kmers_tpu count / query / stats`` and
``StreamingCounter.lookup``), at the size of an E. coli short-read isolate.

    python chip_smoke.py                one GPU (the default)
    python chip_smoke.py --devices 4    four GPUs: sharded counting and lookup
    python chip_smoke.py --trace DIR    also write a jax.profiler trace of the
                                        one-GPU count and lookup to DIR

One GPU, in order: the card's name and power limit; the native parser; the
reads (tools/simulate_reads.py defaults, seed 0: a 4.6 Mbp genome, 1,000,000
x 150 bp reads, N-rate 0.002, 5% lowercase); the count's compile time, cold
and from the persistent cache; the k=31 count with the CLI defaults; an
exact compare of every key and count with a NumPy count of the same file
(oracle.numpy_ref.count_fastq_exact, which shares no code with the device
path); CLI ``query`` and ``stats``; 2^20 lookups, half present and half
absent; the first 200,000 reads counted at k=63 (128-bit keys) and compared
exactly.  ``--devices 4`` runs only: ``count --devices 4`` in hash mode, in
minimizer mode with ASCII ingest, and ``make_sharded_lookup`` over the four
shard tables, each compared exactly with the NumPy count.

Every result is integer and compared bit for bit.  Any failed phase raises
and the process exits non-zero; the final JSON line is printed only after
every phase passed.  On a machine without a GPU the script exits non-zero
before doing any work.  Everything runs in this one process, so JAX opens
the card once.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, "smoke_data")

K = 31
K_WIDE = 63
CAPACITY = 1 << 23          # above the genome's ~4.6M distinct canonical k-mers
WIDE_READS = 200_000
N_LOOKUP = 1 << 20
# --devices 4: per-destination lane budgets, sized so no lane overflows.
# Hash mode ships ~1,900 valid k-mers per destination per batch; minimizer
# mode ~180 super-k-mers (one per ~(k-w+2)/2 windows).
ROUTE = {"hash": (4096, 1), "minimizer": (512, 1)}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.strip().splitlines()[0]


def simulate(data_dir: str, n_reads: int, genome_mbp: float) -> str:
    """Write the reads with tools/simulate_reads.py (seed 0)."""
    spec = importlib.util.spec_from_file_location(
        "simulate_reads", os.path.join(ROOT, "tools", "simulate_reads.py"))
    sim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sim)
    rc = sim.main([data_dir, "--reads", str(n_reads),
                   "--genome-mbp", str(genome_mbp), "--seed", "0"])
    check(rc == 0, f"simulate_reads exited {rc}")
    return os.path.join(data_dir, "reads.fastq.gz")


def head_fastq(src: str, dst: str, n_reads: int) -> str:
    with gzip.open(src, "rb") as f, open(dst, "wb") as out:
        for _ in range(4 * n_reads):
            line = f.readline()
            if not line:
                break
            out.write(line)
    return dst


def cli(argv) -> tuple:
    """Run the CLI in this process: (exit code, stdout)."""
    from kmers_tpu.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    return rc, buf.getvalue()


def kmer_string(word: int, k: int) -> str:
    return "".join("ACGT"[(word >> (2 * i)) & 3] for i in range(k))


def saved_keys(table: str, k: int):
    """(key planes, counts, npz) of a table saved by `count`, in the
    reference's layout: (keys,) for k <= 32, (hi, lo) for k > 32."""
    z = np.load(table)
    nu = int(z["n_unique"])
    u64 = lambda hi, lo: ((z[hi][:nu].astype(np.uint64) << np.uint64(32))
                          | z[lo][:nu].astype(np.uint64))
    if k <= 32:
        planes = (u64("keys_hi", "keys_lo"),)
    else:
        planes = (u64("keys_hi_hi", "keys_hi_lo"),
                  u64("keys_lo_hi", "keys_lo_lo"))
    return planes, z["counts"][:nu].astype(np.int64), z


def compare_table(table: str, k: int, ref, what: str) -> None:
    planes, counts, z = saved_keys(table, k)
    ref_planes, ref_counts = ref
    check(int(z["dropped_unique"]) == 0 and int(z["dropped_kmers"]) == 0,
          f"{what}: capacity evicted k-mers")
    check(len(counts) == len(ref_counts),
          f"{what}: {len(counts)} distinct k-mers, reference "
          f"{len(ref_counts)}")
    for got, want in zip(planes, ref_planes):
        check(np.array_equal(got, want), f"{what}: keys differ")
    check(np.array_equal(counts, ref_counts), f"{what}: counts differ")
    check(int(z["kmers"]) == int(ref_counts.sum()),
          f"{what}: {int(z['kmers'])} k-mers, reference "
          f"{int(ref_counts.sum())}")
    print(f"{what}: {len(counts)} distinct, {int(ref_counts.sum())} k-mers; "
          f"every key and count equals the NumPy count", flush=True)


def lookup_queries(ref_keys: np.ndarray, k: int, n: int, seed: int):
    """n query words, half sampled from the table and half absent from it,
    shuffled, with their expected counts' indices (-1 = absent)."""
    rng = np.random.default_rng(seed)
    present = rng.integers(0, len(ref_keys), n // 2)
    cand = rng.integers(0, 1 << (2 * k), 2 * n, dtype=np.uint64)
    pos = np.minimum(np.searchsorted(ref_keys, cand), len(ref_keys) - 1)
    absent = cand[ref_keys[pos] != cand][:n - n // 2]
    check(len(absent) == n - n // 2, "could not draw enough absent keys")
    words = np.concatenate([ref_keys[present], absent])
    idx = np.concatenate([present, np.full(len(absent), -1)])
    order = rng.permutation(n)
    return words[order], idx[order]


def compile_times(k: int, capacity: int, batch: int, length: int):
    """Seconds to compile the count's two executables (per-batch emission
    and consolidation) at the CLI shapes: first compile in this process,
    then again after jax.clear_caches(), which reads the persistent
    cache when the first compile was kept there."""
    import jax
    import jax.numpy as jnp

    from kmers_tpu.parallel import stream

    merge_every = stream.auto_merge_every(
        capacity, stream.pending_table_lanes(batch, length))
    sc = stream.StreamingCounter(k, capacity, merge_every=merge_every)
    words = jax.ShapeDtypeStruct((batch, length // 16), jnp.uint32)
    bits = jax.ShapeDtypeStruct((batch, length // 32), jnp.uint32)
    pending = (jax.eval_shape(sc._count_packed, words, bits).table,
               ) * merge_every

    def compile_all() -> float:
        t = time.perf_counter()
        sc._count_packed.lower(words, bits).compile()
        stream._merge_bounded.lower(sc.table, pending, capacity=capacity,
                                    max_k=k).compile()
        return time.perf_counter() - t

    first = compile_all()
    jax.clear_caches()
    return first, compile_all()


def run_single(data_dir: str, card: str, n_reads: int = 1_000_000,
               genome_mbp: float = 4.6, capacity: int = CAPACITY,
               wide_reads: int = WIDE_READS, n_lookup: int = N_LOOKUP,
               trace_dir=None) -> None:
    import jax

    from kmers_tpu import compile_cache
    from kmers_tpu.core import u64 as u
    from kmers_tpu.oracle import numpy_ref
    from kmers_tpu.parallel.stream import StreamingCounter

    cache_dir = compile_cache.configure()
    reads = simulate(data_dir, n_reads, genome_mbp)
    t = time.perf_counter()
    ref = numpy_ref.count_fastq_exact(reads, K)
    print(f"NumPy reference k={K}: {len(ref[1])} distinct in "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    n_cached = (len(os.listdir(cache_dir)) if os.path.isdir(cache_dir)
                else 0)
    cold, cached = compile_times(K, capacity, 256, 256)
    print(f"count compile (emission + consolidation, k={K}): first "
          f"{cold:.2f} s, after clear_caches {cached:.2f} s; persistent "
          f"cache {cache_dir} held {n_cached} entries before", flush=True)

    table = os.path.join(data_dir, f"k{K}.npz")
    trace = (jax.profiler.trace(trace_dir) if trace_dir
             else contextlib.nullcontext())
    with trace:
        t = time.perf_counter()
        rc, _ = cli(["count", reads, "-k", K, "--capacity", capacity,
                     "-o", table])
        wall = time.perf_counter() - t
        check(rc == 0, f"count exited {rc}")
        total = int(ref[1].sum())
        print(f"count k={K}: {total} k-mers in {wall:.2f} s = "
              f"{total / wall:.4g} k-mers/s wall, compile included "
              f"[{card}]", flush=True)
        compare_table(table, K, ref, f"k={K} table")

        # lookup: 2^20 queries, half present and half absent
        sc = StreamingCounter.load(table)
        words, idx = lookup_queries(ref[0][0], K, n_lookup, seed=1)
        q = u.from_numpy(words)
        want = np.where(idx >= 0, ref[1][np.maximum(idx, 0)], 0)
        got = np.asarray(sc.lookup(q))              # compiles
        t = time.perf_counter()
        got = np.asarray(jax.block_until_ready(sc.lookup(q)))
        dt = time.perf_counter() - t
    check(np.array_equal(got, want), "lookup answers differ")
    print(f"lookup: {n_lookup} queries ({n_lookup // 2} present) exact; "
          f"{dt * 1e3:.2f} ms = {n_lookup / dt:.4g} queries/s wall, "
          f"compiled [{card}]", flush=True)

    # CLI query: a few present and absent k-mers
    strings = [kmer_string(int(w), K) for w in words[:8]]
    rc, out = cli(["query", table] + strings)
    check(rc == 0, f"query exited {rc}")
    answers = dict(line.split("\t") for line in out.splitlines())
    for s, c in zip(strings, want[:8]):
        check(int(answers[s]) == int(c), f"query {s}: {answers[s]} != {c}")
    print(f"query: {len(strings)} k-mers ({int((idx[:8] >= 0).sum())} "
          f"present) answered exactly", flush=True)

    rc, out = cli(["stats", table])
    check(rc == 0, f"stats exited {rc}")
    check(f"distinct kmers: {len(ref[1])} / capacity {capacity}" in out
          and f"total kmers:    {total}" in out, f"stats: {out!r}")
    print("stats: distinct and total k-mers match", flush=True)

    # wide keys: the first reads at k=63
    sub = head_fastq(reads, os.path.join(data_dir, "head.fastq"), wide_reads)
    ref_w = numpy_ref.count_fastq_exact(sub, K_WIDE)
    table_w = os.path.join(data_dir, f"k{K_WIDE}.npz")
    t = time.perf_counter()
    rc, _ = cli(["count", sub, "-k", K_WIDE, "--capacity", capacity,
                 "-o", table_w])
    wall = time.perf_counter() - t
    check(rc == 0, f"count k={K_WIDE} exited {rc}")
    print(f"count k={K_WIDE}: {int(ref_w[1].sum())} k-mers in {wall:.2f} s "
          f"wall, compile included [{card}]", flush=True)
    compare_table(table_w, K_WIDE, ref_w, f"k={K_WIDE} table")


def shard_tables(table: str, n_shards: int, mesh):
    """Split a saved global table into per-shard tables [D, cap] by the
    routing owner of each key, sharded over the mesh's 'd' axis."""
    import jax
    import jax.numpy as jnp

    from kmers_tpu.core.u64 import U64
    from kmers_tpu.parallel import mesh as mesh_ops
    from kmers_tpu.parallel import route
    from kmers_tpu.parallel.count import CountTable

    z = np.load(table)
    nu = int(z["n_unique"])
    hi, lo = z["keys_hi"][:nu], z["keys_lo"][:nu]
    counts = z["counts"][:nu]
    owner = np.asarray(jax.jit(lambda h, l: route.owner_of(
        U64(h, l), n_shards))(jnp.asarray(hi), jnp.asarray(lo)))
    cap = int(np.bincount(owner, minlength=n_shards).max())
    planes = np.zeros((3, n_shards, cap), np.uint32)
    n_unique = np.zeros(n_shards, np.int32)
    for d in range(n_shards):
        sel = owner == d                   # keeps the global key order
        n = int(sel.sum())
        planes[0, d, :n], planes[1, d, :n] = hi[sel], lo[sel]
        planes[2, d, :n] = counts[sel]
        n_unique[d] = n
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   mesh_ops.batch_sharding(mesh))
    return CountTable(keys=U64(put(planes[0]), put(planes[1])),
                      counts=put(planes[2].astype(np.int32)),
                      n_unique=put(n_unique))


def run_sharded(data_dir: str, card: str, n_devices: int,
                n_reads: int = 1_000_000, genome_mbp: float = 4.6,
                capacity: int = CAPACITY, n_lookup: int = N_LOOKUP) -> None:
    import jax
    import jax.numpy as jnp

    from kmers_tpu import compile_cache
    from kmers_tpu.core import u64 as u
    from kmers_tpu.oracle import numpy_ref
    from kmers_tpu.parallel import mesh as mesh_ops
    from kmers_tpu.parallel import pipeline

    compile_cache.configure()
    reads = simulate(data_dir, n_reads, genome_mbp)
    ref = numpy_ref.count_fastq_exact(reads, K)
    total = int(ref[1].sum())
    tables = {}
    for partition, extra in (("hash", []),
                             ("minimizer", ["--ascii-ingest"])):
        rcap, passes = ROUTE[partition]
        table = os.path.join(data_dir, f"k{K}_{partition}.npz")
        t = time.perf_counter()
        rc, _ = cli(["count", reads, "-k", K, "--capacity", capacity,
                     "--devices", n_devices, "--partition", partition,
                     "--route-capacity", rcap, "--route-passes", passes,
                     "-o", table] + extra)
        wall = time.perf_counter() - t
        # exit 3 would mean routing overflow or eviction
        check(rc == 0, f"count --devices {n_devices} --partition "
                       f"{partition} exited {rc}")
        print(f"count --devices {n_devices} --partition {partition} "
              f"--route-capacity {rcap} --route-passes {passes} "
              f"{' '.join(extra)}: route overflow 0; {total} k-mers in "
              f"{wall:.2f} s = {total / wall:.4g} k-mers/s wall, compile "
              f"included [{card}]", flush=True)
        compare_table(table, K, ref, f"{partition}-sharded k={K} table")
        tables[partition] = table

    mesh = mesh_ops.make_mesh(n_devices)
    shards = shard_tables(tables["hash"], n_devices, mesh)
    words, idx = lookup_queries(ref[0][0], K, n_lookup, seed=2)
    want = np.where(idx >= 0, ref[1][np.maximum(idx, 0)], 0)
    q = u.from_numpy(words.reshape(n_devices, -1))
    put = lambda x: jax.device_put(x, mesh_ops.batch_sharding(mesh))
    lookup = pipeline.make_sharded_lookup(
        mesh, query_capacity=2 * n_lookup // n_devices ** 2)
    args = (shards, put(q.hi), put(q.lo),
            put(jnp.ones(q.hi.shape, dtype=bool)))
    counts, overflow = lookup(*args)                   # compiles
    t = time.perf_counter()
    counts, overflow = jax.block_until_ready(lookup(*args))
    dt = time.perf_counter() - t
    check(int(overflow) == 0, f"sharded lookup overflow {int(overflow)}")
    check(np.array_equal(np.asarray(counts).reshape(-1), want),
          "sharded lookup answers differ")
    print(f"make_sharded_lookup over {n_devices} shard tables: {n_lookup} "
          f"queries ({n_lookup // 2} present) exact, overflow 0; "
          f"{dt * 1e3:.2f} ms = {n_lookup / dt:.4g} queries/s wall, "
          f"compiled [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--trace", metavar="DIR",
                    help="jax.profiler trace of the one-GPU count and lookup")
    args = ap.parse_args(argv)

    card = card_line()
    print(f"card: {card}", flush=True)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform}); nothing was run", file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"chip_smoke: --devices {args.devices} but JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 1

    from kmers_tpu.io import fastx

    if not fastx.native_available():
        print(f"chip_smoke: native parser did not build:\n"
              f"{fastx.native_build_error()}", file=sys.stderr)
        return 1
    os.makedirs(DATA_DIR, exist_ok=True)
    if args.devices == 1:
        run_single(DATA_DIR, card, trace_dir=args.trace)
    else:
        run_sharded(DATA_DIR, card, args.devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
