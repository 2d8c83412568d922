"""Summarise a jax.profiler trace: device time per XLA module and op.

    python tools/trace_summary.py TRACE_DIR [--top 60] [-o summary.json]

Reads the newest ``*.xplane.pb`` under TRACE_DIR with
``jax.profiler.ProfileData``.  For each device plane and each of its lines
(streams, "XLA Ops", "XLA Modules"): the window from first start to last
end, the busy time (union of event intervals) and idle share, and per
module and per (module, op) the number of events and their summed
duration.  Ops are named by the ``hlo_module`` / ``hlo_op`` stats XLA
attaches to device events, falling back to the event name.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict


def _busy_ns(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def summarize(trace_dir: str, top: int = 60) -> dict:
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    data = ProfileData.from_file(files[-1])
    out = {"file": files[-1], "planes": []}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = []
        for line in plane.lines:
            ops = defaultdict(lambda: [0, 0.0])
            modules = defaultdict(lambda: [0, 0.0])
            spans = []
            for ev in line.events:
                stats = dict(ev.stats)
                module = str(stats.get("hlo_module", ""))
                key = (module, str(stats.get("hlo_op", ev.name)))
                for acc in (ops[key], modules[module]):
                    acc[0] += 1
                    acc[1] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
            if not spans:
                continue
            window = max(e for _, e in spans) - min(s for s, _ in spans)
            busy = _busy_ns(spans)
            ranked = sorted(ops.items(), key=lambda kv: -kv[1][1])
            by_module = sorted(modules.items(), key=lambda kv: -kv[1][1])
            lines.append({
                "line": line.name, "events": len(spans),
                "window_ms": window / 1e6, "busy_ms": busy / 1e6,
                "idle_share": 1 - busy / window if window else 0.0,
                "modules": [{"module": m, "events": n, "ms": ns / 1e6}
                            for m, (n, ns) in by_module],
                "ops": [{"module": m, "op": o, "calls": n, "ms": ns / 1e6}
                        for (m, o), (n, ns) in ranked[:top]],
            })
        out["planes"].append({"plane": plane.name, "lines": lines})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=60)
    ap.add_argument("-o", "--output", help="write the summary as JSON")
    args = ap.parse_args(argv)
    summary = summarize(args.trace_dir, args.top)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(summary, f, indent=1)
    for plane in summary["planes"]:
        for line in plane["lines"]:
            print(f"{plane['plane']} | {line['line']}: {line['events']} "
                  f"events, window {line['window_ms']:.3f} ms, busy "
                  f"{line['busy_ms']:.3f} ms, idle share "
                  f"{line['idle_share']:.4f}")
            for mod in line["modules"][:10]:
                print(f"    {mod['ms']:12.3f} ms {mod['events']:7d}x  "
                      f"module {mod['module']}")
            for op in line["ops"][:10]:
                print(f"    {op['ms']:12.3f} ms {op['calls']:7d}x  "
                      f"{op['module']} :: {op['op']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
