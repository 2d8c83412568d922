"""Command-line interface: python -m kmers_tpu <command>.

Commands:
  count      FASTA/FASTQ -> canonical k-mer count table (npz), with
             periodic checkpointing and resume.
  query      look up k-mers (as ACGT strings) in a saved table.
  stats      summarize a saved table.

The reference is a library with no CLI; this is the operational wrapper a
counting framework needs (SURVEY.md §5.3: restart tolerance via
checkpoint-every + --resume).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _cmd_count(args) -> int:
    import signal
    import traceback

    from .io import fastx
    from .parallel.stream import ShardedStreamingCounter, StreamingCounter

    def auto_cadence():
        from .parallel.stream import auto_merge_every, pending_table_lanes

        return auto_merge_every(args.capacity, pending_table_lanes(
            args.batch, args.length, devices=args.devices,
            route_capacity=args.route_capacity,
            route_passes=args.route_passes, partition=args.partition,
            k=args.k, minimizer_w=args.minimizer_w))

    def make_counter():
        from .core.spec import KmerSpec

        # one frozen config object carries k / minimizer width / seed
        # into the counters (core/spec.py)
        spec = KmerSpec(args.k, w=args.minimizer_w, seed=args.seed)
        merge_every = args.merge_every or auto_cadence()
        if args.devices > 1:
            return ShardedStreamingCounter(
                spec, args.capacity, merge_every=merge_every,
                n_devices=args.devices,
                route_capacity=args.route_capacity,
                route_passes=args.route_passes,
                partition=args.partition)
        return StreamingCounter(spec, args.capacity,
                                merge_every=merge_every)

    def load_counter(resuming: bool):
        """(counter, batches_to_skip), from the checkpoint if one exists.

        np.savez appends .npz when the path lacks it; check both spellings
        so `-o counts --resume` finds the checkpoint savez actually wrote."""
        ckpt_exists = (os.path.exists(args.output)
                       or os.path.exists(args.output + ".npz"))
        if not (resuming and ckpt_exists):
            return make_counter(), 0
        loaded = StreamingCounter.load(args.output)
        if loaded.k != args.k:
            raise SystemExit(
                f"error: checkpoint has k={loaded.k}, requested k={args.k}")
        if args.devices > 1:
            # transplant the flat checkpoint state into a sharded counter
            # (the merged table is a valid merge input either way)
            sc = make_counter()
            sc.table = loaded.table
            sc.batches, sc.kmers = loaded.batches, loaded.kmers
            sc.dropped_unique = loaded.dropped_unique
            sc.dropped_kmers = loaded.dropped_kmers
        else:
            sc = loaded
            sc.merge_every = max(1, args.merge_every or auto_cadence())
        print(f"resuming from {args.output}: {sc.batches} batches, "
              f"{sc.kmers} kmers", file=sys.stderr)
        return sc, sc.batches

    # Whether THIS run has successfully written args.output (checkpoint or
    # emergency save).  The in-process restart path may trust an existing
    # output file only if we wrote it (or the user explicitly passed
    # --resume): otherwise a stale table from an earlier unrelated run
    # would be silently merged and its batch count skipped (ADVICE r3).
    wrote_output = False

    def stream(sc, skip: int) -> None:
        """One pass over the file, skipping `skip` already-counted batches.
        Packed ingest (2-bit words + validity bitmaps, ~2.7x less upload) +
        background parse thread; ASCII fallback for length % 32 != 0."""
        nonlocal wrote_output
        use_packed = (args.length % 32 == 0 and not args.ascii_ingest
                      and not (args.devices > 1
                               and args.partition == "minimizer"))
        if use_packed:
            it = fastx.read_packed_batches(args.input, k=args.k,
                                           batch=args.batch,
                                           length=args.length)
        else:
            it = fastx.read_kmer_batches(args.input, k=args.k,
                                         batch=args.batch,
                                         length=args.length)
        seen = 0
        for item in fastx.prefetch(it):
            seen += 1
            if seen <= skip:
                continue
            if use_packed:
                sc.update_packed(*item)
            else:
                sc.update(item)
            if (args.checkpoint_every
                    and sc.batches % args.checkpoint_every == 0):
                sc.save(args.output)
                wrote_output = True

    def emergency_save(sc) -> bool:
        """Best-effort durable checkpoint after a failure: pending
        (unconsolidated) batches roll back first so the saved batch count
        matches the table, then the table is flushed if the device still
        answers."""
        nonlocal wrote_output
        sc.discard_pending()
        try:
            sc.save(args.output)
            wrote_output = True
            return True
        except Exception:
            return False

    try:
        sc, skip = load_counter(args.resume)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2

    # failure detection + elastic recovery (SURVEY.md §5.3): SIGTERM lands
    # as KeyboardInterrupt -> graceful checkpoint; any other mid-stream
    # error auto-saves and restarts in-process from the checkpoint (the
    # skip fast-forwards the file, so a restart recounts only lost batches)
    def _graceful(_signum, _frame):
        raise KeyboardInterrupt

    prev_term = signal.signal(signal.SIGTERM, _graceful)
    t0 = time.time()
    restarts = 0
    try:
        while True:
            try:
                stream(sc, skip)
                sc.save(args.output)
                break
            except KeyboardInterrupt:
                saved = emergency_save(sc)
                print(f"interrupted: {'checkpoint saved to ' + args.output if saved else 'checkpoint save FAILED'}"
                      f" ({sc.batches} batches); re-run with --resume",
                      file=sys.stderr)
                return 130
            except Exception:
                traceback.print_exc()
                saved = emergency_save(sc)
                print(f"stream failed after {sc.batches} batches "
                      f"(checkpoint {'saved' if saved else 'save FAILED'})",
                      file=sys.stderr)
                if restarts >= args.max_restarts:
                    print(f"giving up after {restarts} restarts; "
                          f"re-run with --resume to continue",
                          file=sys.stderr)
                    return 4
                restarts += 1
                trust_ckpt = args.resume or wrote_output
                print(f"restart {restarts}/{args.max_restarts} from "
                      f"{'the last checkpoint' if trust_ckpt else 'scratch'}",
                      file=sys.stderr)
                sc, skip = load_counter(resuming=trust_ckpt)
    finally:
        signal.signal(signal.SIGTERM, prev_term)
    dt = time.time() - t0
    print(f"{sc.kmers} kmers ({int(sc.table.n_unique)} distinct) "
          f"from {sc.batches} batches in {dt:.1f}s "
          f"-> {args.output}", file=sys.stderr)
    if getattr(sc, "route_overflow", 0):
        print(f"WARNING: routing overflow: {sc.route_overflow} kmers "
              f"dropped in transit ({sc.route_rerouted} re-routed); "
              f"raise --route-capacity or --route-passes for exact counts",
              file=sys.stderr)
        return 3
    if sc.dropped_unique:
        print(f"WARNING: capacity exceeded: {sc.dropped_unique} distinct "
              f"kmers ({sc.dropped_kmers} occurrences) dropped; "
              f"re-run with a larger --capacity", file=sys.stderr)
        return 3
    return 0


def _cmd_query(args) -> int:
    import numpy as np

    from .core import u64 as u
    from .core import u128 as u128mod
    from .oracle import numpy_ref as o
    from .parallel.stream import StreamingCounter

    sc = StreamingCounter.load(args.table)
    words, bad = [], False
    for q in args.kmers:
        if len(q) != sc.k:
            print(f"error: '{q}' has length {len(q)}, table k={sc.k}",
                  file=sys.stderr)
            bad = True
            continue
        try:
            if sc.wide:
                fw = o.word_from_bytes_wide(q.upper().encode())
                canon = o.canonical_wide(fw, sc.k)
            else:
                fw = o.word_from_bytes(q.upper().encode())
                canon = min(fw, o.reverse_complement_word(fw, sc.k))
        except ValueError:
            print(f"error: '{q}' contains non-ACGT characters",
                  file=sys.stderr)
            bad = True
            continue
        words.append((q, canon))
    if words:
        if sc.wide:
            qa = u128mod.from_python_ints([w for _, w in words])
        else:
            qa = u.from_numpy(np.array([w for _, w in words],
                                       dtype=np.uint64))
        counts = np.asarray(sc.lookup(qa))
        for (q, _), c in zip(words, counts):
            print(f"{q}\t{int(c)}")
    return 2 if bad else 0


def _cmd_stats(args) -> int:
    import numpy as np

    from .parallel.stream import StreamingCounter

    sc = StreamingCounter.load(args.table)
    nu = int(sc.table.n_unique)
    counts = np.asarray(sc.table.counts)[:nu]
    print(f"k:              {sc.k}")
    print(f"distinct kmers: {nu} / capacity {sc.capacity}")
    print(f"total kmers:    {sc.kmers}")
    print(f"batches:        {sc.batches}")
    print(f"dropped:        {sc.dropped_unique} distinct "
          f"/ {sc.dropped_kmers} occurrences")
    if nu:
        print(f"count range:    [{counts.min()}, {counts.max()}], "
              f"mean {counts.mean():.2f}")
        print(f"singletons:     {(counts == 1).sum()}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmers_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser(
        "count", help="count canonical k-mers of a file",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=(
            "exactness contract: counts are exact iff --capacity >= the\n"
            "input's DISTINCT canonical k-mer count (and no routing\n"
            "overflow in sharded mode).  Past capacity, lowest-count\n"
            "entries are evicted first and the dropped mass is reported\n"
            "(dropped_unique / dropped_kmers; exit code 3) -- counts are\n"
            "then lower bounds (an evicted key restarts from zero if it\n"
            "reappears).  Treat any nonzero 'dropped' as re-run bigger.\n"))
    c.add_argument("input", help="FASTA/FASTQ path")
    c.add_argument("-k", type=int, required=True,
                   help="k-mer length (1..64; k > 32 uses 128-bit keys)")
    c.add_argument("-o", "--output", required=True, help="output .npz table")
    c.add_argument("--capacity", type=int, default=1 << 22,
                   help="max distinct kmers the table can hold (default "
                        "4M).  Counts are EXACT only when this is >= the "
                        "input's distinct-k-mer count; otherwise lowest-"
                        "count entries are evicted (reported as dropped_*, "
                        "exit 3) and surviving counts are lower bounds")
    c.add_argument("--batch", type=int, default=256)
    c.add_argument("--length", type=int, default=256,
                   help="row length; long records are halo-chunked")
    c.add_argument("--merge-every", type=int, default=0,
                   help="consolidate pending batch tables every N batches "
                        "(higher = fewer big merges, more device memory); "
                        "0 = auto, ~capacity/batch-lanes clamped to "
                        "[8, 64] (balances the merge's capacity and "
                        "batch lane terms)")
    c.add_argument("--checkpoint-every", type=int, default=0,
                   help="save every N batches (enables --resume)")
    c.add_argument("--resume", action="store_true",
                   help="resume from an existing output checkpoint")
    c.add_argument("--max-restarts", type=int, default=2,
                   help="on a mid-stream failure, auto-save a checkpoint "
                        "and restart in-process up to N times (0 = save "
                        "and exit 4)")
    c.add_argument("--ascii-ingest", action="store_true",
                   help="upload raw ASCII instead of 2-bit packed batches "
                        "(debug/compare; ~2.7x more upload traffic)")
    c.add_argument("--devices", type=int, default=1,
                   help="shard counting over N local devices "
                        "(hash-routed all_to_all pipeline)")
    c.add_argument("--route-capacity", type=int, default=4096,
                   help="per-destination lane budget per routing pass "
                        "(sharded mode)")
    c.add_argument("--route-passes", type=int, default=1,
                   help="overflow re-route rounds (sharded mode)")
    c.add_argument("--partition", choices=("hash", "minimizer"),
                   default="hash",
                   help="sharded-mode routing: 'hash' ships each k-mer to "
                        "hash-prefix owners; 'minimizer' ships packed "
                        "super-k-mer runs to minimizer owners (~4-6x "
                        "fewer wire bytes; k <= 31, ASCII ingest).  NOTE "
                        "--route-capacity is then a SUPER-K-MER budget: "
                        "size it ~(k-w+2)/2 smaller than for hash mode "
                        "(the receiver expands every lane to k-w+1 "
                        "windows, so oversizing inflates merge lanes)")
    c.add_argument("--minimizer-w", type=int, default=11,
                   help="minimizer width for --partition minimizer")
    c.add_argument("--seed", type=int, default=0,
                   help="seed of the routing/minimizer mixer hash "
                        "(carried by the KmerSpec config object; affects "
                        "shard assignment, never counts)")
    c.set_defaults(fn=_cmd_count)

    q = sub.add_parser("query", help="look up k-mers in a saved table")
    q.add_argument("table", help=".npz table from `count`")
    q.add_argument("kmers", nargs="+", help="k-mer strings (ACGT)")
    q.set_defaults(fn=_cmd_query)

    s = sub.add_parser("stats", help="summarize a saved table")
    s.add_argument("table")
    s.set_defaults(fn=_cmd_stats)

    args = p.parse_args(argv)
    from . import compile_cache

    compile_cache.configure()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
