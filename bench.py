"""Benchmark: per-batch emission throughput, k=31 -- windows + canonical +
hash, the plain jnp path (ops.kmer.kmer_windows -> canonical_word ->
core.u64.mix_hash) that XLA compiles for the device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"device"}.  Needs an accelerator whose device_kind is in
profiling.PEAK_HBM_GBPS; anything else (the CPU included) raises.

``vs_baseline`` is the share of the device-memory roofline: the least
time the step could take, its minimal traffic over the published peak
bandwidth, divided by the measured time.  Timing protocol: a serial
lax.scan chain and the slope between two chain lengths (benchlib.py).

Minimal traffic model (all arrays [B, L]; windows exist at the first
L-k+1 lanes but every lane is computed): the step reads the ASCII rows
(1 B/lane) and, deriving the next iteration's rows from the hash word,
writes ASCII rows (1 B/lane) = 2 B/lane = 2*L/(L-k+1) B/kmer.  A fused
step moves nothing else; any intermediate XLA keeps in device memory
lowers the share.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np
import jax.numpy as jnp

import benchlib
from kmers_tpu import compile_cache
from kmers_tpu.core import u64 as u
from kmers_tpu.ops import kmer as kmer_ops
from kmers_tpu.profiling import device_hbm_gbps as hbm_gbps

K = 31
B, L = 2048, 1024          # 2 MiB of ASCII; ~2.03M k-mer windows per call
ROUNDS = 5


def step(reads):
    """One benched iteration: emission, then the next input derived from
    the hash output (serial dependency; 4-letter variety)."""
    win = kmer_ops.kmer_windows(reads, K)
    h = u.mix_hash(kmer_ops.canonical_word(win.fw, win.rc), 0)
    return benchlib.ascii_from_codes(h.lo)


def main():
    compile_cache.configure()
    peak = hbm_gbps()                 # fails before any work off the card
    rng = np.random.default_rng(0)
    reads0 = jnp.asarray(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                                    size=(B, L)))
    # the headline is the MEDIAN of independent slope measurements, with
    # the spread alongside
    secs = [benchlib.chain_seconds_per_iter(step, reads0)
            for _ in range(ROUNDS)]
    kmers = B * (L - K + 1)
    rates = sorted(kmers / s for s in secs)
    rate = float(np.median(rates))
    bytes_per_iter = B * L * 2
    sol = peak * 1e9 / (bytes_per_iter / kmers)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "kmers_per_sec_per_chip_windows_canonical_hash_k31",
        "value": round(rate, 1),
        "unit": "kmers/s",
        "vs_baseline": round(rate / sol, 4),
        "spread_min": round(rates[0] / sol, 4),
        "spread_max": round(rates[-1] / sol, 4),
        "rounds": ROUNDS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
