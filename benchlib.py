"""Shared device-timing protocol for bench.py / bench_configs.py.

Times one jitted step as device seconds per application, independent of
dispatch and host->device latency:

  * run the op S times inside ONE jitted ``lax.scan`` whose carry derives
    iteration i+1's input from iteration i's output (serial dependency --
    nothing elides, overlaps, or caches), fetch one dependent scalar, and
    take the SLOPE between two chain lengths (default S=8 vs S=264).
    Dispatch, the fetch and the final reduction are identical in both
    chains and cancel; the slope is device time per iteration.
  * The probe scalar is a FULL reduction of the carry: probing one element
    would let XLA dead-code-eliminate everything outside that element's
    dependency cone.
  * The host must be otherwise idle (dispatch is host-driven).

This protocol times one op in isolation.  End-to-end numbers come from
wall time around the user's path (chip_smoke.py) and per-layer device
time from a profiler trace (tools/trace_summary.py).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np


def ascii_from_codes(codes: jnp.ndarray) -> jnp.ndarray:
    """uint32 2-bit codes (A=0,C=1,G=2,T=3) -> ASCII uint8, branch-free."""
    c = codes.astype(jnp.uint32) & jnp.uint32(3)
    a = jnp.where(c == 0, jnp.uint32(65),
                  jnp.where(c == 1, jnp.uint32(67),
                            jnp.where(c == 2, jnp.uint32(71),
                                      jnp.uint32(84))))
    return a.astype(jnp.uint8)


def chain_seconds_per_iter(step: Callable[[Any], Any], x0: Any,
                           s_short: int = 8, s_long: int = 264,
                           rounds: int = 6) -> float:
    """Device seconds per application of `step`, via the slope between two
    serial chain lengths.

    `step` maps a carry pytree to a carry pytree of the same structure and
    must make the new carry data-depend on everything the benched op
    computes (derive it from the op's outputs, not from the inputs).

    Robustness rules:
      * s_long - s_short must make the time difference dwarf the jitter of
        one dispatch + fetch.
      * slope of MIN times, not min of per-round slopes: per-round slopes
        are (device + jitter) differences and taking their min selects the
        most negative jitter sample, biasing the rate high.
    """
    def make(S: int):
        @jax.jit
        def run(x):
            def body(c, _):
                return step(c), None
            c, _ = jax.lax.scan(body, x, None, length=S)
            # full reduction over every leaf: no DCE cone, one scalar fetch
            acc = jnp.float32(0)
            for leaf in jax.tree_util.tree_leaves(c):
                acc = acc + jnp.sum(leaf.astype(jnp.float32))
            return acc
        return run

    f_short, f_long = make(s_short), make(s_long)
    np.asarray(f_short(x0))   # compile + warm
    np.asarray(f_long(x0))
    t_short, t_long = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        np.asarray(f_short(x0))
        t1 = time.perf_counter()
        np.asarray(f_long(x0))
        t2 = time.perf_counter()
        t_short.append(t1 - t0)
        t_long.append(t2 - t1)
    slope = (min(t_long) - min(t_short)) / (s_long - s_short)
    if slope <= 0:
        raise RuntimeError(
            f"chain timing slope non-positive ({slope:.3e}s/iter; "
            f"min short {min(t_short):.4f}s, min long {min(t_long):.4f}s) "
            "-- host contention?")
    return slope


def chain_rate(step, x0, items_per_iter: int, **kw) -> float:
    return items_per_iter / chain_seconds_per_iter(step, x0, **kw)
