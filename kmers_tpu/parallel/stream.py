"""Host-driven streaming k-mer counting over many read batches.

Real datasets do not fit one device call; this module folds a stream of
[B, L] batches into a fixed-capacity device count table:

  per batch:    UNIT emission -- the raw folded canonical keys of the
                batch's windows wrapped as a count.UnitTable.  No per-batch
                sort or run-length pass AT ALL: the consolidation below
                sorts every pending lane regardless (static shapes), so
                any per-batch aggregation is pure overhead -- the rounds
                2/3 global-sort / segment-sort steps reduced its cost by
                exactly zero (see count.UnitTable).  k = 32 / 64 (no
                spare flag bit) fall back to the run-length form.
  consolidate:  DEFERRED -- per-batch tables accumulate in a pending list
                and are merged into the main table only every
                `merge_every` batches (and before any read of the table):
                one concat + weighted re-count; a rank-evict pass runs
                ONLY when the merged table overflows capacity (lax.cond --
                the common sized-right case is 2 device sorts, not 4).

Keys are kept sorted, so a consolidation is one sort of
(capacity + merge_every * batch) lanes -- no scatter, no host round-trip
of the table.

Eviction policy (explicit, tested): if the merged table exceeds capacity,
the LOWEST-COUNT entries are evicted first (the table keeps the heavy
hitters); among equal counts the numerically largest keys are evicted
first, so eviction is deterministic.  Evicted mass is counted in
``dropped_unique`` / ``dropped_kmers`` ("no silent caps", SURVEY.md §7);
size capacity above the expected distinct-k-mer count to avoid evicting
at all.  Note the count-based policy is still an approximation under
adversarial arrival order (a key evicted early loses its prior count if
it reappears); the drop counters bound the error.

Checkpoint/resume (SURVEY.md §5.4): ``save`` / ``load`` persist the table
in an endian-stable npz layout (little-endian u32 words of the 2-bit
LSB-first packing), mirroring the reference's serde support
(seq_vector.rs:18-22).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import u64 as u
from ..core import u128 as u128mod
from ..core.u64 import U64
from ..core.u128 import U128
from . import count as count_ops
from . import pipeline
from .count import CountTable, CountTableWide


@functools.partial(jax.jit, static_argnames=("capacity", "max_k"))
def _merge_bounded(table: CountTable, pending: tuple, capacity: int,
                   max_k=None):
    merged = count_ops.merge_many((table,) + tuple(pending), max_k=max_k)
    return _bound_table(merged, capacity)


def _bound_table(merged: CountTable, capacity: int):
    """Bound a compact key-sorted table to `capacity` slots: free slice
    when it fits, rank-eviction (lowest counts first) otherwise."""
    idx = jnp.arange(merged.capacity, dtype=jnp.int32)

    def no_evict(m: CountTable):
        # merged fits: m is compact and key-sorted, every live lane is in
        # the first n_unique <= capacity slots -- the bounded table is a
        # free slice, no further sorting.  This is the common case (sized
        # capacity above the distinct count); it halves the consolidation
        # from 4 device sorts to the 2 inside count_weighted.
        out = CountTable(
            keys=U64(m.keys.hi[:capacity], m.keys.lo[:capacity]),
            counts=m.counts[:capacity], n_unique=m.n_unique)
        return out, jnp.int32(0), jnp.int32(0)

    def evict(m: CountTable):
        live = idx < m.n_unique
        # rank by (dead last, count desc, key asc): the first `capacity`
        # lanes are the keepers -- lowest-count entries are evicted first,
        # ties evict the largest keys (see module docstring)
        maxi = jnp.int32(jnp.iinfo(jnp.int32).max)
        dead = (~live).astype(jnp.uint32)
        inv_count = jnp.where(live, maxi - m.counts, maxi)
        _, _, r_hi, r_lo, r_cnt = jax.lax.sort(
            (dead, inv_count, m.keys.hi, m.keys.lo, m.counts),
            num_keys=4, is_stable=True)
        dropped_unique = jnp.maximum(m.n_unique - capacity, 0)
        dropped_kmers = jnp.where(idx >= capacity,
                                  jnp.where(idx < m.n_unique, r_cnt, 0),
                                  0).sum()
        # restore the key-sorted invariant on the kept prefix (live first)
        kept_live = idx[:capacity] < jnp.minimum(m.n_unique, capacity)
        k_dead = (~kept_live).astype(jnp.uint32)
        _, s_hi, s_lo, s_cnt = jax.lax.sort(
            (k_dead, r_hi[:capacity], r_lo[:capacity], r_cnt[:capacity]),
            num_keys=3, is_stable=True)
        n_kept = jnp.minimum(m.n_unique, capacity)
        kept = jnp.arange(capacity, dtype=jnp.int32) < n_kept
        out = CountTable(
            keys=U64(jnp.where(kept, s_hi, 0), jnp.where(kept, s_lo, 0)),
            counts=jnp.where(kept, s_cnt, 0),
            n_unique=n_kept,
        )
        return (out, dropped_unique.astype(jnp.int32),
                dropped_kmers.astype(jnp.int32))

    return jax.lax.cond(merged.n_unique <= capacity, no_evict, evict,
                        merged)


@functools.partial(jax.jit, static_argnames=("capacity", "max_k"))
def _merge_bounded_wide(table: CountTableWide, pending: tuple, capacity: int,
                        max_k=None):
    """_merge_bounded for 128-bit keys (33 <= k <= 64): same eviction policy
    (lowest count first, ties evict largest keys), 4 key words per lane,
    same free-slice fast path when the merged table fits."""
    merged = count_ops.merge_many_wide((table,) + tuple(pending),
                                       max_k=max_k)
    return _bound_table_wide(merged, capacity)


def _bound_table_wide(merged: CountTableWide, capacity: int):
    idx = jnp.arange(merged.capacity, dtype=jnp.int32)

    def no_evict(m: CountTableWide):
        s = lambda x: x[:capacity]
        out = CountTableWide(
            keys=U128(U64(s(m.keys.hi.hi), s(m.keys.hi.lo)),
                      U64(s(m.keys.lo.hi), s(m.keys.lo.lo))),
            counts=s(m.counts), n_unique=m.n_unique)
        return out, jnp.int32(0), jnp.int32(0)

    def evict(m: CountTableWide):
        live = idx < m.n_unique
        maxi = jnp.int32(jnp.iinfo(jnp.int32).max)
        dead = (~live).astype(jnp.uint32)
        inv_count = jnp.where(live, maxi - m.counts, maxi)
        mk = m.keys
        _, _, r_hh, r_hl, r_lh, r_ll, r_cnt = jax.lax.sort(
            (dead, inv_count, mk.hi.hi, mk.hi.lo, mk.lo.hi, mk.lo.lo,
             m.counts),
            num_keys=6, is_stable=True)
        dropped_unique = jnp.maximum(m.n_unique - capacity, 0)
        dropped_kmers = jnp.where(idx >= capacity,
                                  jnp.where(idx < m.n_unique, r_cnt, 0),
                                  0).sum()
        kept_live = idx[:capacity] < jnp.minimum(m.n_unique, capacity)
        k_dead = (~kept_live).astype(jnp.uint32)
        _, s_hh, s_hl, s_lh, s_ll, s_cnt = jax.lax.sort(
            (k_dead, r_hh[:capacity], r_hl[:capacity], r_lh[:capacity],
             r_ll[:capacity], r_cnt[:capacity]),
            num_keys=5, is_stable=True)
        n_kept = jnp.minimum(m.n_unique, capacity)
        kept = jnp.arange(capacity, dtype=jnp.int32) < n_kept
        z = lambda x: jnp.where(kept, x, 0)
        out = CountTableWide(
            keys=U128(U64(z(s_hh), z(s_hl)), U64(z(s_lh), z(s_ll))),
            counts=z(s_cnt), n_unique=n_kept)
        return (out, dropped_unique.astype(jnp.int32),
                dropped_kmers.astype(jnp.int32))

    return jax.lax.cond(merged.n_unique <= capacity, no_evict, evict,
                        merged)


class StreamingCounter:
    """Fold read batches into one fixed-capacity canonical k-mer table.

    k <= 32 keys are one u64 (2xu32 lanes); 33 <= k <= 64 switches the
    whole stack -- windows, canonical, sort, merge, eviction, lookup,
    checkpoint -- to 128-bit keys (4xu32 lanes), matching the reference's
    multi-word reach (kmer.rs:12-14, k=65 u128 vectors at naive.rs:419-445).
    """

    def __init__(self, k, capacity: int, merge_every: int = 16):
        from ..core.spec import KmerSpec

        # `k` may be an int or a KmerSpec -- the framework's one config
        # carrier (core/spec.py); its seed and minimizer width ride along.
        self.spec = k if isinstance(k, KmerSpec) else KmerSpec(k)
        k = self.spec.k
        if not (1 <= k <= 64):
            raise ValueError("StreamingCounter supports 1 <= k <= 64")
        self.k = k
        self.wide = self.spec.wide
        self.capacity = capacity
        self.merge_every = max(1, merge_every)
        # Per-batch table form: "unit" (raw folded canonical keys, NO
        # per-batch aggregation -- the consolidation sorts every pending
        # lane regardless, see count.UnitTable) whenever the spare flag
        # bit exists; k = 32 / 64 keys use all 2k bits, so those fall back
        # to the round-3 run-length form.
        self._aggregate = self.spec.aggregate
        agg = self._aggregate
        z = jnp.zeros(capacity, dtype=jnp.uint32)
        if self.wide:
            self._count = jax.jit(
                lambda a: pipeline.count_reads_wide(a, k, aggregate=agg))
            self._count_packed = jax.jit(
                lambda w, v: pipeline.count_reads_packed_wide(
                    w, v, k, aggregate=agg))
            self.table = CountTableWide(
                keys=U128(U64(z, z), U64(z, z)),
                counts=jnp.zeros(capacity, jnp.int32),
                n_unique=jnp.int32(0))
        else:
            self._count = jax.jit(
                lambda a: pipeline.count_reads(a, k, aggregate=agg))
            self._count_packed = jax.jit(
                lambda w, v: pipeline.count_reads_packed(w, v, k,
                                                         aggregate=agg))
            self.table = CountTable(keys=U64(z, z),
                                    counts=jnp.zeros(capacity, jnp.int32),
                                    n_unique=jnp.int32(0))
        self._pending = []
        self._pending_kmers = []
        self.batches = 0
        self.kmers = 0
        self.dropped_unique = 0
        self.dropped_kmers = 0

    def update(self, reads: jnp.ndarray) -> None:
        """Count one [B, L] uint8 batch; consolidation is deferred until
        `merge_every` batches are pending (or the table is read).

        No device sync happens here: fetching even one scalar per batch
        would serialize the stream on the host<->device round trip.
        Metric scalars accumulate on device and are fetched at
        consolidation time."""
        res = self._count(jnp.asarray(reads))
        self._absorb(res)

    def update_packed(self, words, validbits) -> None:
        """Count one packed batch ([B, L/16] code words + [B, L/32]
        validity bitmaps, io.fastx.read_packed_batches layout).  Preferred
        over `update`: ~2.7x less upload traffic per base."""
        res = self._count_packed(jnp.asarray(words), jnp.asarray(validbits))
        self._absorb(res)

    def _absorb(self, res) -> None:
        self._pending.append(res.table)
        self._pending_kmers.append(res.metrics["kmers_emitted"])
        self.batches += 1
        if len(self._pending) >= self.merge_every:
            self._consolidate()

    def _consolidate(self) -> None:
        if not self._pending:
            return
        pending = list(self._pending)
        # pad to merge_every with empty same-shaped tables so every
        # consolidation compiles to ONE executable (a partial final merge
        # would otherwise cost a fresh XLA compile)
        caps = {t.capacity for t in pending}
        if len(caps) == 1 and len(pending) < self.merge_every:
            empty = count_ops.empty_like_table(pending[0])
            pending += [empty] * (self.merge_every - len(pending))
        merge = _merge_bounded_wide if self.wide else _merge_bounded
        new_table, du, dk = merge(
            self.table, tuple(pending), self.capacity, max_k=self.k)
        # Commit state ATOMICALLY only after the merge demonstrably
        # completed: the scalar fetches below force the executable, so a
        # device fault (the elastic-recovery case) raises BEFORE any
        # counter or the table is updated -- discard_pending then rewinds
        # the batches AND their kmer mass together, and an emergency
        # checkpoint never stores counters the post-restart recount would
        # double-count (ADVICE r3).
        du_i, dk_i = int(du), int(dk)
        kmers_add = sum(int(km) for km in self._pending_kmers)
        self.table = new_table
        self.kmers += kmers_add
        self._pending_kmers = []
        self._pending = []
        self.dropped_unique += du_i
        self.dropped_kmers += dk_i

    def discard_pending(self) -> None:
        """Roll back unconsolidated per-batch tables after a mid-stream
        failure: the batch counter rewinds with them, so a resume (which
        skips `batches` input batches) recounts exactly the dropped ones.
        The consolidated table is untouched -- state stays consistent even
        if the failure interrupted a half-absorbed batch (SURVEY.md §5.3)."""
        self.batches -= len(self._pending)
        self._pending = []
        self._pending_kmers = []

    def lookup(self, words) -> jnp.ndarray:
        """Counts for query words: U64 (k <= 32) or U128 (k > 32)."""
        self._consolidate()
        if self.wide:
            return count_ops.lookup_wide(self.table, words)
        return count_ops.lookup(self.table, words)

    def to_pairs(self):
        """Host-side [(word, count)] of live slots (sorted by word)."""
        self._consolidate()
        nu = int(self.table.n_unique)
        if self.wide:
            keys = u128mod.to_python_ints(self.table.keys)[:nu]
        else:
            keys = [int(x) for x in u.to_numpy(self.table.keys)[:nu]]
        counts = np.asarray(self.table.counts)[:nu]
        return [(a, int(b)) for a, b in zip(keys, counts)]

    # -- checkpoint / resume --------------------------------------------------

    def save(self, path: str) -> None:
        """Atomic checkpoint: the table lands at `path` (.npz appended if
        missing) via a same-directory temp file + os.replace, so a crash or
        SIGKILL mid-write can never leave a truncated checkpoint -- the
        previous complete one survives (elastic recovery depends on this)."""
        self._consolidate()
        if self.wide:
            key_arrays = dict(
                keys_hi_hi=np.asarray(self.table.keys.hi.hi, dtype="<u4"),
                keys_hi_lo=np.asarray(self.table.keys.hi.lo, dtype="<u4"),
                keys_lo_hi=np.asarray(self.table.keys.lo.hi, dtype="<u4"),
                keys_lo_lo=np.asarray(self.table.keys.lo.lo, dtype="<u4"))
        else:
            key_arrays = dict(
                keys_hi=np.asarray(self.table.keys.hi, dtype="<u4"),
                keys_lo=np.asarray(self.table.keys.lo, dtype="<u4"))
        final = path if path.endswith(".npz") else path + ".npz"
        tmp = final + ".tmp.npz"
        np.savez(
            tmp,
            counts=np.asarray(self.table.counts, dtype="<i4"),
            n_unique=np.int64(int(self.table.n_unique)),
            k=np.int64(self.k),
            capacity=np.int64(self.capacity),
            batches=np.int64(self.batches),
            kmers=np.int64(self.kmers),
            dropped_unique=np.int64(self.dropped_unique),
            dropped_kmers=np.int64(self.dropped_kmers),
            **key_arrays,
        )
        os.replace(tmp, final)

    @staticmethod
    def load(path: str) -> "StreamingCounter":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        sc = StreamingCounter(int(z["k"]), int(z["capacity"]))
        j32 = lambda name: jnp.asarray(z[name].astype(np.uint32))
        if sc.wide:
            sc.table = CountTableWide(
                keys=U128(U64(j32("keys_hi_hi"), j32("keys_hi_lo")),
                          U64(j32("keys_lo_hi"), j32("keys_lo_lo"))),
                counts=jnp.asarray(z["counts"].astype(np.int32)),
                n_unique=jnp.int32(int(z["n_unique"])),
            )
        else:
            sc.table = CountTable(
                keys=U64(j32("keys_hi"), j32("keys_lo")),
                counts=jnp.asarray(z["counts"].astype(np.int32)),
                n_unique=jnp.int32(int(z["n_unique"])),
            )
        sc.batches = int(z["batches"])
        sc.kmers = int(z["kmers"])
        sc.dropped_unique = int(z["dropped_unique"])
        sc.dropped_kmers = int(z["dropped_kmers"])
        return sc


class ShardedStreamingCounter(StreamingCounter):
    """StreamingCounter over a device mesh: each batch is data-parallel
    over the 'd' axis, every k-mer rides a fixed-capacity all_to_all to the
    shard owning its hash prefix (parallel.route), and per-shard disjoint
    tables accumulate in the same deferred-merge pipeline (merge_many
    consumes the [D, cap] shard tables directly).

    This is BASELINE config 5 made operational: file ingest -> sharded
    counting -> one merged global table, reachable from the CLI
    (--devices).  Overflowed routing lanes are COUNTED per batch
    (route_overflow/route_rerouted) and surfaced on the final stats --
    raise route_capacity / route_passes until overflow is 0 for exact
    tables.
    """

    def __init__(self, k, capacity: int, merge_every: int = 16,
                 mesh=None, n_devices: Optional[int] = None,
                 route_capacity: int = 4096, route_passes: int = 1,
                 seed: Optional[int] = None, partition: str = "hash",
                 minimizer_w: Optional[int] = None):
        from . import mesh as mesh_ops
        from . import pipeline as pl

        super().__init__(k, capacity, merge_every)
        # seed / minimizer width default from the spec (KmerSpec carries
        # them when `k` was passed as a spec); explicit kwargs win
        if seed is None:
            seed = self.spec.seed
        if minimizer_w is None:
            minimizer_w = self.spec.w if self.spec.w is not None else 11
        k = self.k
        assert partition in ("hash", "minimizer")
        if partition == "minimizer" and k > 31:
            raise ValueError("minimizer partitioning needs k <= 31")
        self.mesh = mesh if mesh is not None else mesh_ops.make_mesh(
            n_devices)
        self.n_devices = self.mesh.shape["d"]
        self.route_capacity = route_capacity
        self.route_passes = route_passes
        self.partition = partition
        self.route_overflow = 0
        self.route_rerouted = 0
        self.route_superkmers = 0
        self._pending_overflow = []
        self._sharding = mesh_ops.batch_sharding(self.mesh)
        if partition == "minimizer":
            # super-k-mer transport: k-mers sharing a minimizer travel as
            # one packed-bases lane (~4-6x fewer wire bytes per k-mer);
            # the GLOBAL table is identical to hash partitioning because
            # the consolidation re-counts across shards -- per-shard
            # tables are NOT key-disjoint (forward-strand minimizers can
            # send a canonical key's RC occurrences elsewhere; see
            # pipeline.py's super-k-mer module comment)
            self._scount = pl.make_superkmer_counter(
                self.mesh, k, minimizer_w, route_capacity=route_capacity,
                route_passes=route_passes, seed=seed,
                aggregate=self._aggregate)
            self._scount_packed = None    # ASCII ingest only (see CLI)
        else:
            mk = (pl.make_sharded_counter_wide if self.wide
                  else pl.make_sharded_counter)
            self._scount = mk(self.mesh, k, route_capacity=route_capacity,
                              route_passes=route_passes, seed=seed,
                              aggregate=self._aggregate)
            self._scount_packed = mk(self.mesh, k,
                                     route_capacity=route_capacity,
                                     route_passes=route_passes, seed=seed,
                                     packed=True,
                                     aggregate=self._aggregate)
        # multi-host: host-side reads (to_pairs/save) need the merged table
        # fully replicated; this jit inserts the all_gather
        self._replicate = jax.jit(lambda t: t,
                                  out_shardings=mesh_ops.replicated(
                                      self.mesh))

    def _pad_rows(self, arr: np.ndarray, fill: int) -> np.ndarray:
        # rows must divide evenly over the devices each process feeds
        d = max(1, self.n_devices // jax.process_count())
        b = arr.shape[0]
        if b % d == 0:
            return np.asarray(arr)
        pad = d - b % d
        filler = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
        return np.concatenate([np.asarray(arr), filler], axis=0)

    def _put(self, arr: np.ndarray):
        """Assemble a (process-local in multi-host runs) row block into a
        global array sharded over 'd'."""
        if jax.process_count() > 1:
            from . import mesh as mesh_ops

            return mesh_ops.make_global_array(arr, self.mesh)
        return jax.device_put(jnp.asarray(arr), self._sharding)

    def update(self, reads) -> None:
        arr = self._pad_rows(np.asarray(reads), ord("N"))
        self._absorb_sharded(self._scount(self._put(arr)))

    def update_packed(self, words, validbits) -> None:
        if self._scount_packed is None:
            raise NotImplementedError(
                "minimizer partitioning counts from ASCII batches "
                "(use update / --ascii-ingest)")
        w = self._pad_rows(np.asarray(words), 0)
        v = self._pad_rows(np.asarray(validbits), 0)
        self._absorb_sharded(self._scount_packed(self._put(w), self._put(v)))

    def _absorb_sharded(self, res) -> None:
        # traced scalars only -- fetching here would sync every batch
        self._pending_overflow.append(
            (res.metrics["route_overflow"], res.metrics["route_rerouted"],
             res.metrics.get("superkmers")))
        self._absorb(res)

    def discard_pending(self) -> None:
        super().discard_pending()
        self._pending_overflow = []

    def _consolidate(self) -> None:
        had_pending = bool(self._pending)
        super()._consolidate()
        # overflow counters commit only after the merge succeeded (the base
        # class raised otherwise), mirroring the kmer-mass rule: a faulted
        # merge leaves them consistent with discard_pending's rewind
        for ov, rr, sk in self._pending_overflow:
            self.route_overflow += int(ov)
            self.route_rerouted += int(rr)
            if sk is not None:
                self.route_superkmers += int(sk)
        self._pending_overflow = []
        if had_pending and jax.process_count() > 1:
            self.table = self._replicate(self.table)


def auto_merge_every(capacity: int, batch_lanes: int) -> int:
    """Consolidation cadence that balances the merge's two lane terms.

    A consolidation sorts capacity + merge_every * batch_lanes lanes, so
    the amortized per-batch cost is ~ capacity/merge_every + batch_lanes;
    below merge_every = capacity / batch_lanes the CAPACITY term
    dominates (at the CLI defaults -- capacity 4M, 65k-lane batches --
    the round-3 fixed default of 16 left it 4x dominant).  Clamp to
    [8, 64]: past 64 the wins are <2% while pending-table memory grows
    linearly.

    batch_lanes must be the ACTUAL per-batch pending-table lane count --
    use pending_table_lanes(); in sharded mode that is route-derived
    (passes * D^2 * route_capacity [* (k-w+1) for super-k-mers]), NOT
    batch * length (ADVICE r4)."""
    return max(8, min(64, capacity // max(1, batch_lanes)))


def pending_table_lanes(batch: int, length: int, devices: int = 1,
                        route_capacity: int = 4096, route_passes: int = 1,
                        partition: str = "hash", k: int = 0,
                        minimizer_w: int = 11) -> int:
    """Lane count of ONE pending per-batch table, per mode (feeds
    auto_merge_every).

    Single device: the unit/run-length table spans the batch's window
    lanes, batch * length.  Sharded: each of the D shards receives
    route_passes * D * route_capacity lanes (parallel.route's fixed
    send buffers), so the stacked pending table holds
    passes * D^2 * route_capacity lanes -- independent of the batch
    shape.  Minimizer partitioning additionally expands every received
    super-k-mer lane to k - w + 1 windows (pipeline.expand_superkmers)."""
    if devices > 1:
        lanes = route_passes * devices * devices * route_capacity
        if partition == "minimizer":
            lanes *= max(1, k - minimizer_w + 1)
        return lanes
    return batch * length


def count_fastx(path: str, k: int, capacity: int, batch: int = 256,
                length: int = 256, merge_every: int = 0,
                counter: Optional[StreamingCounter] = None,
                packed: bool = True, prefetch_depth: int = 512,
                devices: int = 1, route_capacity: int = 4096,
                route_passes: int = 1, partition: str = "hash",
                minimizer_w: int = 11) -> StreamingCounter:
    """Count every k-mer of a FASTA/FASTQ file (native ingest, halo-chunked
    long records).  Pass `counter` to resume from a checkpoint.

    packed=True (default) ships 2-bit packed words + validity bitmaps to
    the device (0.375 B/base vs 1 B/base ASCII) and parses batch i+1 on a
    background thread while batch i uploads/computes.  Requires
    length % 32 == 0; falls back to the ASCII path otherwise.

    devices > 1 runs the hash-routed sharded pipeline over that many local
    devices (ShardedStreamingCounter; route overflow is surfaced on the
    returned counter)."""
    from ..io import fastx

    if merge_every <= 0:
        merge_every = auto_merge_every(capacity, pending_table_lanes(
            batch, length, devices=devices, route_capacity=route_capacity,
            route_passes=route_passes, partition=partition, k=k,
            minimizer_w=minimizer_w))
    if counter is not None:
        sc = counter
    elif devices > 1:
        sc = ShardedStreamingCounter(k, capacity, merge_every=merge_every,
                                     n_devices=devices,
                                     route_capacity=route_capacity,
                                     route_passes=route_passes,
                                     partition=partition,
                                     minimizer_w=minimizer_w)
    else:
        sc = StreamingCounter(k, capacity, merge_every=merge_every)
    if getattr(sc, "partition", "hash") == "minimizer":
        packed = False    # super-k-mer emission starts from ASCII rows
    if packed and length % 32 == 0:
        it = fastx.read_packed_batches(path, k=k, batch=batch, length=length)
        for words, validbits in fastx.prefetch(it, depth=prefetch_depth):
            sc.update_packed(words, validbits)
    else:
        it = fastx.read_kmer_batches(path, k=k, batch=batch, length=length)
        for rows in fastx.prefetch(it, depth=prefetch_depth):
            sc.update(rows)
    return sc
