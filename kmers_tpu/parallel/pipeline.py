"""End-to-end counting pipelines: single-chip and mesh-sharded.

The flagship "model" of this framework (BASELINE.json configs 2 and 5):

  reads [B, L] uint8 ASCII
    -> fused pack + k-mer windows + canonical   (ops.kmer)
    -> [single chip]  sort + segment-sum count table (parallel.count)
    -> [mesh]         hash-prefix all_to_all to owning shards
                      (parallel.route), then per-shard count tables.

Metrics (SURVEY.md §5.5): every step returns lightweight counters --
reads ingested, k-mers emitted, invalid windows skipped, routing overflow --
as traced scalars in a dict (no silent caps).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core import u64 as u
from ..core.spec import KmerSpec
from ..core.u64 import U64
from ..ops import kmer as kmer_ops
from . import count as count_ops
from . import route as route_ops
from .count import CountTable


class CountResult(NamedTuple):
    table: CountTable
    metrics: Dict[str, jnp.ndarray]


def canonical_kmers(reads: jnp.ndarray, k: int) -> Tuple[U64, jnp.ndarray]:
    """reads [B, L] -> (canonical words [B, L], valid [B, L])."""
    win = kmer_ops.kmer_windows(reads, k)
    return kmer_ops.canonical_word(win.fw, win.rc), win.valid


def _resolve_aggregate(compact: bool, aggregate: Optional[str]) -> str:
    if aggregate is None:
        return "compact" if compact else "runlength"
    assert aggregate in ("compact", "runlength", "unit"), aggregate
    return aggregate


def _resolve_k(k, spec: Optional[KmerSpec]):
    """`k` may be an int, a KmerSpec, or None with `spec` given -- the
    KmerSpec is the framework's one config carrier (core/spec.py)."""
    if isinstance(k, KmerSpec):
        assert spec is None or spec is k
        return k.k
    if spec is not None:
        if k is not None and k != spec.k:
            raise ValueError(f"k={k} contradicts spec.k={spec.k}")
        return spec.k
    if k is None:
        raise TypeError("pass k or spec")
    return k


def _count_metrics(n_reads: int, n_win: int, emitted) -> Dict[str, jnp.ndarray]:
    return {
        "reads": jnp.int32(n_reads),
        "kmers_emitted": emitted,
        "windows_skipped": jnp.int32(n_reads * n_win) - emitted,
    }


def count_reads(reads: jnp.ndarray, k=None, compact: bool = True,
                aggregate: Optional[str] = None,
                spec: Optional[KmerSpec] = None) -> CountResult:
    """Single-device bit-exact k-mer counter (BASELINE config 2).

    `k` may be an int or a core.spec.KmerSpec (or pass spec=).

    aggregate selects the per-batch table form (default from `compact`):
      "compact"    sorted + compacted CountTable (direct reads/lookup)
      "runlength"  sorted with duplicates, counts at run starts (~2x less
                   device work; round-3 streaming mode)
      "unit"       PASSTHROUGH UnitTable, k <= 31: raw folded canonical
                   keys, one occurrence per valid lane, NO per-batch sort
                   at all.  The streaming mode since round 4: the deferred
                   weighted consolidation sorts every pending lane
                   regardless (static shapes), so any per-batch aggregation
                   is overhead -- see count.UnitTable."""
    k = _resolve_k(k, spec)
    mode = _resolve_aggregate(compact, aggregate)
    n_win = reads.shape[-1] - k + 1
    if mode == "unit":
        assert 1 <= k <= 31, "unit tables need the spare flag bit (k <= 31)"
        canon, valid = canonical_kmers(reads, k)
        return CountResult(
            table=count_ops.unit_table(canon, valid),
            metrics=_count_metrics(reads.shape[0], n_win,
                                   valid.sum().astype(jnp.int32)))
    canon, valid = canonical_kmers(reads, k)
    table = count_ops.count_words(canon, valid, max_k=k,
                                  compact=mode == "compact")
    return CountResult(
        table=table,
        metrics=_count_metrics(reads.shape[0], n_win,
                               valid.sum().astype(jnp.int32)))


def count_reads_packed(words: jnp.ndarray, validbits: jnp.ndarray,
                       k=None, compact: bool = True,
                       aggregate: Optional[str] = None,
                       spec: Optional[KmerSpec] = None) -> CountResult:
    """count_reads over PACKED ingest batches ([B, L/16] code words +
    [B, L/32] validity bitmaps from io.fastx.read_packed_batches): same
    table, ~2.7x less host->device traffic (the round-2 CLI was
    upload-bound with the device 4% busy).  See count_reads for
    `aggregate` and `spec`."""
    k = _resolve_k(k, spec)
    mode = _resolve_aggregate(compact, aggregate)
    win = kmer_ops.kmer_windows_packed(words, validbits, k)
    canon = kmer_ops.canonical_word(win.fw, win.rc)
    emitted = win.valid.sum().astype(jnp.int32)
    if mode == "unit":
        assert 1 <= k <= 31
        table = count_ops.unit_table(canon, win.valid)
    else:
        table = count_ops.count_words(canon, win.valid, max_k=k,
                                      compact=mode == "compact")
    return CountResult(
        table=table,
        metrics=_count_metrics(words.shape[0], win.n_windows, emitted))


def _sharded_count_tail(canon, valid, n_reads: int, n_win: int, k: int,
                        capacity: int, seed: int, axis: str,
                        passes: int, aggregate: str = "compact"
                        ) -> CountResult:
    """Shared tail of the sharded count bodies: route -> owned table.
    aggregate="unit" skips the per-shard sort entirely (the routed lanes
    ARE the table; see count.UnitTable) -- the streaming-consolidation
    mode; "compact" keeps per-shard sorted tables for direct reads."""
    routed = route_ops.route(canon, valid, axis, capacity, seed,
                             passes=passes)
    if aggregate == "unit":
        table = count_ops.unit_table(routed.words, routed.valid)
    else:
        table = count_ops.count_words(routed.words, routed.valid, max_k=k)
    emitted = valid.sum().astype(jnp.int32)
    metrics = {
        "reads": jax.lax.psum(jnp.int32(n_reads), axis),
        "kmers_emitted": jax.lax.psum(emitted, axis),
        "windows_skipped": jax.lax.psum(
            jnp.int32(n_reads * n_win) - emitted, axis),
        "route_overflow": jax.lax.psum(routed.overflow, axis),
        "route_rerouted": jax.lax.psum(routed.rerouted, axis),
        "route_bytes": jax.lax.psum(
            jnp.int32(routed.words.lo.size * 9), axis),  # 8B word + 1B mask
    }
    return CountResult(table=table, metrics=metrics)


def _sharded_count_body(reads_local: jnp.ndarray, k: int, capacity: int,
                        seed: int, axis: str, passes: int,
                        aggregate: str = "compact") -> CountResult:
    """shard_map body: local reads -> routed -> owned count table."""
    canon, valid = canonical_kmers(reads_local, k)
    return _sharded_count_tail(canon, valid, reads_local.shape[0],
                               reads_local.shape[-1] - k + 1, k, capacity,
                               seed, axis, passes, aggregate)


def _sharded_count_body_packed(words_local: jnp.ndarray,
                               validbits_local: jnp.ndarray, k: int,
                               capacity: int, seed: int, axis: str,
                               passes: int,
                               aggregate: str = "compact") -> CountResult:
    win = kmer_ops.kmer_windows_packed(words_local, validbits_local, k)
    canon = kmer_ops.canonical_word(win.fw, win.rc)
    return _sharded_count_tail(canon, win.valid, words_local.shape[0],
                               win.n_windows, k, capacity, seed, axis,
                               passes, aggregate)


_COUNTER_METRICS = ("reads", "kmers_emitted", "windows_skipped",
                    "route_overflow", "route_rerouted", "route_bytes")


def make_sharded_counter(mesh: Mesh, k: int, *, route_capacity: int,
                         seed: int = 0, axis: str = "d",
                         route_passes: int = 1, packed: bool = False,
                         aggregate: str = "compact"):
    """Build a jitted sharded counting step over `mesh`.

    Returns fn(reads [B, L] sharded over axis on dim 0) -> CountResult where
    table leaves are per-shard (leading device dim folded into capacity
    axis under the mesh sharding) and metrics are replicated scalars.
    With packed=True, fn takes (words [B, L/16], validbits [B, L/32]) in
    the read_packed_batches ingest layout instead of ASCII reads.

    Every shard's table holds only k-mers whose hash-prefix it owns, so the
    global table is the disjoint union of shard tables.

    route_passes > 1 re-routes bucket overflow in extra all_to_all rounds
    (exact results while every destination load <= passes * capacity); what
    still overflows is reported in metrics, never silently dropped.

    aggregate="unit" (streaming-consolidation mode) returns per-shard
    UnitTables -- the routed lanes themselves, no per-shard sort.
    """
    if aggregate == "unit":
        table_spec = count_ops.UnitTable(keys=U64(P(axis), P(axis)))
    else:
        table_spec = CountTable(keys=U64(P(axis), P(axis)), counts=P(axis),
                                n_unique=P(axis))
    out_spec = CountResult(
        table=table_spec,
        metrics={m: P() for m in _COUNTER_METRICS},
    )
    kw = dict(k=k, capacity=route_capacity, seed=seed, axis=axis,
              passes=route_passes, aggregate=aggregate)

    def wrapped(*args):
        if packed:
            res = _sharded_count_body_packed(*args, **kw)
        else:
            res = _sharded_count_body(*args, **kw)
        # add leading axis-of-size-1 per shard so outputs concatenate over 'd'
        table = jax.tree.map(lambda x: x[None], res.table)
        return CountResult(table=table, metrics=res.metrics)

    in_specs = (P(axis), P(axis)) if packed else (P(axis),)
    fn = shard_map(wrapped, mesh=mesh, in_specs=in_specs,
                   out_specs=out_spec)
    return jax.jit(fn)


def global_table(result: CountResult) -> CountTable:
    """Merge a sharded CountResult's per-shard tables [D, cap] into one
    globally key-sorted CountTable of capacity D*cap.  Shards are disjoint
    by construction, so this is a re-sort, not a re-count (the per-key
    counts are carried as weights and remain exact)."""
    t = result.table
    if isinstance(t, count_ops.UnitTable):
        hi, lo, w, live = count_ops._table_parts(t)
        return count_ops.count_weighted(U64(hi, lo), live, w)
    d, cap = t.counts.shape
    idx = jnp.arange(cap, dtype=jnp.int32)[None, :]
    live = idx < t.n_unique[:, None]                         # [D, cap]
    keys = U64(t.keys.hi.reshape(-1), t.keys.lo.reshape(-1))
    return count_ops.count_weighted(keys, live.reshape(-1),
                                    t.counts.reshape(-1))


def lookup_sharded(tables: CountTable, queries: U64, n_shards: int,
                   seed: int = 0) -> jnp.ndarray:
    """Host-convenience lookup across per-shard tables [D, cap]: one
    branch-free binary search per query against its OWNER's key region
    (row-indexed gathers), not a scan of every shard."""
    owner = route_ops.owner_of(queries, n_shards, seed)      # [Q]
    cap = tables.counts.shape[-1]
    n_unique_q = tables.n_unique[owner]                      # [Q]
    lo_idx = jnp.zeros(queries.lo.shape, dtype=jnp.int32)
    hi_idx = jnp.full(queries.lo.shape, cap, dtype=jnp.int32)
    for _ in range(max(1, cap.bit_length())):
        mid = (lo_idx + hi_idx) // 2
        mid_c = jnp.clip(mid, 0, cap - 1)
        mk = U64(tables.keys.hi[owner, mid_c], tables.keys.lo[owner, mid_c])
        key_lt_query = (mid < n_unique_q) & u.lt(mk, queries)
        lo_idx = jnp.where(key_lt_query, mid + 1, lo_idx)
        hi_idx = jnp.where(key_lt_query, hi_idx, mid)
    found = jnp.clip(lo_idx, 0, cap - 1)
    fk = U64(tables.keys.hi[owner, found], tables.keys.lo[owner, found])
    hit = (lo_idx < n_unique_q) & u.eq(fk, queries)
    return jnp.where(hit, tables.counts[owner, found], 0)


# -- multi-word (33 <= k <= 64) pipelines -------------------------------------

from ..core import u128 as u128mod          # noqa: E402
from ..core.u128 import U128                # noqa: E402


def canonical_kmers_wide(reads: jnp.ndarray, k: int):
    win = kmer_ops.kmer_windows_wide(reads, k)
    return kmer_ops.canonical_word_wide(win.fw, win.rc), win.valid


def count_reads_wide(reads: jnp.ndarray, k=None, compact: bool = True,
                     aggregate: Optional[str] = None,
                     spec: Optional[KmerSpec] = None) -> CountResult:
    """Single-device counter for multi-word k (BASELINE config 3).  See
    count_reads for `aggregate` and `spec`; "unit" needs k <= 63 (spare
    flag bit in hi.hi)."""
    k = _resolve_k(k, spec)
    mode = _resolve_aggregate(compact, aggregate)
    n_win = reads.shape[-1] - k + 1
    if mode == "unit":
        assert 33 <= k <= 63
        canon, valid = canonical_kmers_wide(reads, k)
        return CountResult(
            table=count_ops.unit_table_wide(canon, valid),
            metrics=_count_metrics(reads.shape[0], n_win,
                                   valid.sum().astype(jnp.int32)))
    canon, valid = canonical_kmers_wide(reads, k)
    emitted = valid.sum().astype(jnp.int32)
    table = count_ops.count_words_wide(canon, valid, max_k=k,
                                       compact=mode == "compact")
    return CountResult(
        table=table, metrics=_count_metrics(reads.shape[0], n_win, emitted))


def count_reads_packed_wide(words: jnp.ndarray, validbits: jnp.ndarray,
                            k=None, compact: bool = True,
                            aggregate: Optional[str] = None,
                            spec: Optional[KmerSpec] = None) -> CountResult:
    """count_reads_wide over packed ingest batches (33 <= k <= 64)."""
    k = _resolve_k(k, spec)
    mode = _resolve_aggregate(compact, aggregate)
    win = kmer_ops.kmer_windows_packed_wide(words, validbits, k)
    canon = kmer_ops.canonical_word_wide(win.fw, win.rc)
    emitted = win.valid.sum().astype(jnp.int32)
    if mode == "unit":
        assert 33 <= k <= 63
        table = count_ops.unit_table_wide(canon, win.valid)
    else:
        table = count_ops.count_words_wide(canon, win.valid, max_k=k,
                                           compact=mode == "compact")
    return CountResult(
        table=table,
        metrics=_count_metrics(words.shape[0], win.n_windows, emitted))


def _sharded_count_tail_wide(canon, valid, n_reads: int, n_win: int, k: int,
                             capacity: int, seed: int, axis: str,
                             passes: int, aggregate: str = "compact"
                             ) -> CountResult:
    routed = route_ops.route_wide(canon, valid, axis, capacity, seed,
                                  passes=passes)
    if aggregate == "unit":
        table = count_ops.unit_table_wide(routed.words, routed.valid)
    else:
        table = count_ops.count_words_wide(routed.words, routed.valid,
                                           max_k=k)
    emitted = valid.sum().astype(jnp.int32)
    metrics = {
        "reads": jax.lax.psum(jnp.int32(n_reads), axis),
        "kmers_emitted": jax.lax.psum(emitted, axis),
        "windows_skipped": jax.lax.psum(
            jnp.int32(n_reads * n_win) - emitted, axis),
        "route_overflow": jax.lax.psum(routed.overflow, axis),
        "route_rerouted": jax.lax.psum(routed.rerouted, axis),
        "route_bytes": jax.lax.psum(
            jnp.int32(routed.words.lo.lo.size * 17), axis),
    }
    return CountResult(table=table, metrics=metrics)


def _sharded_count_body_wide(reads_local: jnp.ndarray, k: int, capacity: int,
                             seed: int, axis: str, passes: int,
                             aggregate: str = "compact") -> CountResult:
    canon, valid = canonical_kmers_wide(reads_local, k)
    return _sharded_count_tail_wide(canon, valid, reads_local.shape[0],
                                    reads_local.shape[-1] - k + 1, k,
                                    capacity, seed, axis, passes, aggregate)


def _sharded_count_body_wide_packed(words_local, validbits_local, k: int,
                                    capacity: int, seed: int, axis: str,
                                    passes: int,
                                    aggregate: str = "compact") -> CountResult:
    win = kmer_ops.kmer_windows_packed_wide(words_local, validbits_local, k)
    canon = kmer_ops.canonical_word_wide(win.fw, win.rc)
    return _sharded_count_tail_wide(canon, win.valid, words_local.shape[0],
                                    win.n_windows, k, capacity, seed, axis,
                                    passes, aggregate)


def make_sharded_counter_wide(mesh: Mesh, k: int, *, route_capacity: int,
                              seed: int = 0, axis: str = "d",
                              route_passes: int = 1, packed: bool = False,
                              aggregate: str = "compact"):
    """Sharded counter for 33 <= k <= 64 (2xu64 keys); packed=True takes
    (words, validbits) ingest batches like make_sharded_counter.
    aggregate="unit" needs k <= 63 (spare flag bit)."""
    from .count import CountTableWide

    if aggregate == "unit":
        assert 33 <= k <= 63
        table_spec = count_ops.UnitTableWide(
            keys=U128(U64(P(axis), P(axis)), U64(P(axis), P(axis))))
    else:
        table_spec = CountTableWide(
            keys=U128(U64(P(axis), P(axis)), U64(P(axis), P(axis))),
            counts=P(axis), n_unique=P(axis))
    out_spec = CountResult(
        table=table_spec,
        metrics={m: P() for m in _COUNTER_METRICS},
    )
    kw = dict(k=k, capacity=route_capacity, seed=seed, axis=axis,
              passes=route_passes, aggregate=aggregate)

    def wrapped(*args):
        if packed:
            res = _sharded_count_body_wide_packed(*args, **kw)
        else:
            res = _sharded_count_body_wide(*args, **kw)
        table = jax.tree.map(lambda x: x[None], res.table)
        return CountResult(table=table, metrics=res.metrics)

    in_specs = (P(axis), P(axis)) if packed else (P(axis),)
    fn = shard_map(wrapped, mesh=mesh, in_specs=in_specs,
                   out_specs=out_spec)
    return jax.jit(fn)


# -- sequence-parallel counting (long contigs; SURVEY §5.7) -------------------

from ..ops import hash as hash_ops          # noqa: E402
from ..ops import minimizer as mini_ops     # noqa: E402
from . import halo as halo_ops              # noqa: E402


def make_sequence_parallel_counter(mesh: Mesh, k: int, *, route_capacity: int,
                                   seed: int = 0, axis: str = "d",
                                   route_passes: int = 1):
    """Count k-mers of ONE long sequence sharded contiguously over `axis`.

    Input: [G] uint8 ASCII, G divisible by the axis size; each device holds
    a contiguous block and fetches a (k-1)-base halo from its right
    neighbor (ppermute) before windowing.  Windows spanning the global end
    are masked via the invalid-byte machinery (halo.py).
    """
    wide = k > 32
    out_spec = CountResult(
        table=(count_ops.CountTableWide(
                   keys=U128(U64(P(axis), P(axis)), U64(P(axis), P(axis))),
                   counts=P(axis), n_unique=P(axis)) if wide else
               CountTable(keys=U64(P(axis), P(axis)), counts=P(axis),
                          n_unique=P(axis))),
        metrics={m: P() for m in ("kmers_emitted", "route_overflow",
                                  "route_rerouted")},
    )

    def body(seq_local):
        seq_local = seq_local.reshape(-1)
        if wide:
            win = halo_ops.sharded_windows_wide(seq_local, k, axis)
            canon = kmer_ops.canonical_word_wide(win.fw, win.rc)
            routed = route_ops.route_wide(canon, win.valid, axis,
                                          route_capacity, seed,
                                          passes=route_passes)
            table = count_ops.count_words_wide(routed.words, routed.valid, max_k=k)
        else:
            win = halo_ops.sharded_windows(seq_local, k, axis)
            canon = kmer_ops.canonical_word(win.fw, win.rc)
            routed = route_ops.route(canon, win.valid, axis,
                                     route_capacity, seed,
                                     passes=route_passes)
            table = count_ops.count_words(routed.words, routed.valid, max_k=k)
        metrics = {
            "kmers_emitted": jax.lax.psum(
                win.valid.sum().astype(jnp.int32), axis),
            "route_overflow": jax.lax.psum(routed.overflow, axis),
            "route_rerouted": jax.lax.psum(routed.rerouted, axis),
        }
        return CountResult(table=jax.tree.map(lambda x: x[None], table),
                           metrics=metrics)

    fn = shard_map(body, mesh=mesh, in_specs=(P(axis),), out_specs=out_spec)
    return jax.jit(fn)


# -- sharded minimizer bucketing (BASELINE config 4) ---------------------------

def make_sharded_minimizer_counter(mesh: Mesh, k: int, w: int, *,
                                   route_capacity: int, seed: int = 0,
                                   use_lex: bool = False, axis: str = "d",
                                   route_passes: int = 1):
    """Data-parallel minimizer selection + hashed bucketing over the mesh.

    reads [B, L] sharded over `axis` -> per-k-mer minimizers (leftmost-tie,
    deque-equivalent) -> each k-mer's MINIMIZER word is routed to the shard
    owning its hash -> per-shard (minimizer, k-mer count) tables: the
    super-k-mer partition step of distributed k-mer table construction.

    Capacity note: unlike raw k-mer routing, minimizer words are heavily
    repeated (one minimizer covers up to k-w+1 consecutive windows), so
    per-destination load is skewed -- set `route_passes` > 1 so overflow is
    re-routed in extra all_to_all rounds (exact while destination load
    <= passes * capacity; the rest is counted in `route_overflow`).
    """
    out_spec = CountResult(
        table=CountTable(keys=U64(P(axis), P(axis)), counts=P(axis),
                         n_unique=P(axis)),
        metrics={m: P() for m in ("kmers_emitted", "route_overflow",
                                  "route_rerouted")},
    )
    hash_fn = (hash_ops.lex_hash_fn(w) if use_lex
               else hash_ops.mix_hash_fn(seed))

    def body(reads_local):
        mm = mini_ops.minimizer_stream(reads_local, k, w, hash_fn)
        routed = route_ops.route(mm.word, mm.valid, axis, route_capacity,
                                 seed, passes=route_passes)
        table = count_ops.count_words(routed.words, routed.valid,
                                      max_k=w)  # table keys are w-mer words
        metrics = {
            "kmers_emitted": jax.lax.psum(
                mm.valid.sum().astype(jnp.int32), axis),
            "route_overflow": jax.lax.psum(routed.overflow, axis),
            "route_rerouted": jax.lax.psum(routed.rerouted, axis),
        }
        return CountResult(table=jax.tree.map(lambda x: x[None], table),
                           metrics=metrics)

    fn = shard_map(body, mesh=mesh, in_specs=(P(axis),), out_specs=out_spec)
    return jax.jit(fn)


# -- super-k-mer (minimizer-partitioned) counting ------------------------------
#
# THE point of minimizers in distributed k-mer counting (SURVEY.md §5.8;
# reference rationale at seq_vector/minimizers.rs:20-36): consecutive
# k-mers overwhelmingly share their minimizer, so a RUN of r consecutive
# k-mers travels as ONE lane of packed bases (r + k - 1 bases <= 2k - w)
# instead of r separate 8-byte words -- the mean run length is ~(k-w+2)/2,
# so wire bytes per k-mer drop ~4-6x vs hash-prefix routing of individual
# k-mers.
#
# Shard-disjointness caveat (ADVICE r4): minimizers are selected on the
# FORWARD strand of each read, while the counted key is canonical.  The
# same canonical k-mer occurring as a reverse complement in another read
# derives its minimizer from the RC strand's w-mers and can land on a
# DIFFERENT shard -- per-shard tables are therefore NOT key-disjoint
# partial counts (unlike hash-prefix routing).  The final table is still
# exact because every consumer (global_table, StreamingCounter's
# merge_many consolidation) re-counts across shards; do not key-hash
# lookups or treat a single shard's table as authoritative for a key.
# Tested with explicit reverse-complement read pairs in
# tests/test_superkmer.py.

from ..ops import encoding as enc_ops        # noqa: E402


def _superkmer_payload_words(k: int, w: int) -> int:
    """uint32 words needed for a super-k-mer's packed bases: a minimizer
    serves at most k-w+1 consecutive windows, spanning <= 2k-w bases."""
    return -(-(2 * (2 * k - w)) // 32)


def _superkmer_layout(k: int, w: int):
    """(nwords, meta_off, fold): where the run's window count (meta,
    <= k-w+1 <= 31, 5 bits) lives.  When the last payload plane has >= 5
    spare bits above the packed bases (fold=True), meta rides there --
    one fewer route-sort operand and 4 fewer wire bytes per super-k-mer.
    Safe because a receiver window j reads absolute bits < 2*(2k-w) only,
    and its own 2k-bit masks cut everything above (see expand_superkmers);
    the sender masks the last plane's pack garbage before OR-ing meta."""
    nwords = _superkmer_payload_words(k, w)
    bits_used = 2 * (2 * k - w)
    meta_off = bits_used - 32 * (nwords - 1)
    fold = meta_off <= 27
    return nwords, meta_off, fold


def emit_superkmers(reads_local: jnp.ndarray, k: int, w: int, seed: int):
    """Per-row super-k-mer extraction (static shapes, no control flow).

    Returns (owner_words U64, start mask, planes, kmers_emitted) where
    `planes` = nwords packed-base uint32 planes + one meta plane (the
    window count c of the run, 1..k-w+1); all [B, L], one lane per
    k-mer-window position, live only at run starts.  Runs are maximal
    stretches of equal minimizer POSITION within a row (equal position
    implies equal w-mer; a repeated w-mer at a different position starts
    a new run, which is still correct -- both route to the same owner).
    """
    assert 1 <= w <= min(k, 31) and k <= 31
    B, L = reads_local.shape
    # minimizer selection under the mix16 packed order (which w-mer wins
    # changes run boundaries, never the counted table -- every occurrence
    # of a k-mer still routes to one owner)
    mm = mini_ops.minimizer_stream(reads_local, k, w,
                                   hash_ops.mix16_hash_fn(seed))
    codes = enc_ops.ascii_to_codes(reads_local)
    w16 = kmer_ops.pack_u32_words(codes)
    col = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :], (B, L))
    pad1 = lambda x, fill: jnp.concatenate(
        [jnp.full((B, 1), fill, x.dtype), x[:, :-1]], axis=1)
    prev_valid = pad1(mm.valid, False)
    prev_pos = pad1(mm.pos, -1)
    start = mm.valid & (~prev_valid | (prev_pos != mm.pos))
    # next boundary (run start or invalid window) strictly after p --
    # every run ends at the latest at window L-k (structurally invalid
    # lanes follow), so ns_excl is always a true bound
    m = jnp.where(start | ~mm.valid, col, L)
    ns_incl = jax.lax.cummin(m, axis=1, reverse=True)
    ns_excl = jnp.concatenate(
        [ns_incl[:, 1:], jnp.full((B, 1), L, jnp.int32)], axis=1)
    c = jnp.where(start, ns_excl - col, 0)       # windows in this run
    nwords, meta_off, fold = _superkmer_layout(k, w)
    planes = [kmer_ops._shift_left(w16, 16 * j) for j in range(nwords)]
    if fold:
        # meta rides the last plane's spare bits (see _superkmer_layout);
        # the pack garbage above the payload bits is masked out first
        planes[-1] = ((planes[-1] & jnp.uint32((1 << meta_off) - 1))
                      | (c.astype(jnp.uint32) << meta_off))
        planes = tuple(planes)
    else:
        planes = tuple(planes) + (c.astype(jnp.uint32),)
    kmers = mm.valid.sum().astype(jnp.int32)
    return mm.word, start, planes, kmers


def expand_superkmers(planes, valid: jnp.ndarray, k: int, w: int):
    """Receiver side: [N] super-k-mer lanes -> ([N, W] forward window
    words, [N, W] validity), W = k-w+1.  All static shifts, no gathers.
    The folded meta bits (when _superkmer_layout folds) never reach a
    window's value: window j reads absolute bits < 2*(2k-w) and its own
    2k-bit masks cut the rest."""
    W = k - w + 1
    _, meta_off, fold = _superkmer_layout(k, w)
    if fold:
        pw = planes
        meta = (planes[-1] >> meta_off) & jnp.uint32(31)
    else:
        pw, meta = planes[:-1], planes[-1]
    zeros = jnp.zeros_like(pw[0])

    def word_at(i):
        return pw[i] if i < len(pw) else zeros

    los, his = [], []
    for j in range(W):
        bit, off = (2 * j) // 32, (2 * j) % 32
        if off:
            lo = (word_at(bit) >> off) | (word_at(bit + 1) << (32 - off))
            hi = (word_at(bit + 1) >> off) | (word_at(bit + 2) << (32 - off))
        else:
            lo = word_at(bit)
            hi = word_at(bit + 1)
        if 2 * k <= 32:
            lo = lo & jnp.uint32((1 << (2 * k)) - 1) if 2 * k < 32 else lo
            hi = jnp.zeros_like(lo)
        elif 2 * k < 64:
            hi = hi & jnp.uint32((1 << (2 * k - 32)) - 1)
        los.append(lo)
        his.append(hi)
    fw = U64(jnp.stack(his, axis=-1), jnp.stack(los, axis=-1))
    wv = valid[..., None] & (jnp.arange(W, dtype=jnp.int32)[None, :]
                             < meta.astype(jnp.int32)[..., None])
    return fw, wv


def make_superkmer_counter(mesh: Mesh, k: int, w: int, *,
                           route_capacity: int, seed: int = 0,
                           axis: str = "d", route_passes: int = 1,
                           aggregate: str = "unit"):
    """Sharded counting with super-k-mer (minimizer-partitioned) routing
    (k <= 31): the `--partition minimizer` pipeline.

    The GLOBAL table (after the cross-shard re-count every consumer runs:
    global_table / StreamingCounter's merge_many consolidation) is
    bit-exact vs hash-prefix routing, while packed base runs ship instead
    of per-k-mer words.  Per-shard tables are NOT key-disjoint, unlike
    hash routing: minimizers are selected on the forward strand, so a
    canonical k-mer seen as a reverse complement elsewhere can land on a
    different shard (see the module comment above).  Metrics:
      superkmers       routed lanes (run count)
      route_bytes      wire bytes of the fixed send buffers
      route_overflow   K-MERS dropped (meta-weighted, never silent)
    Capacity note: destination load is in SUPER-K-MERS (~2n/(k-w+2) per
    batch), so route_capacity can be ~5x smaller than per-k-mer routing
    for the same input.
    """
    assert k <= 31
    nwords, meta_off, fold = _superkmer_layout(k, w)
    n_planes = nwords if fold else nwords + 1
    if aggregate == "unit":
        table_spec = count_ops.UnitTable(keys=U64(P(axis), P(axis)))
    else:
        table_spec = CountTable(keys=U64(P(axis), P(axis)), counts=P(axis),
                                n_unique=P(axis))
    out_spec = CountResult(
        table=table_spec,
        metrics={m: P() for m in ("reads", "kmers_emitted",
                                  "windows_skipped", "superkmers",
                                  "route_overflow", "route_rerouted",
                                  "route_bytes")},
    )

    def body(reads_local):
        owner, start, planes, kmers = emit_superkmers(reads_local, k, w,
                                                      seed)
        n_superkmers = start.sum().astype(jnp.int32)
        routed = route_ops.route_payload(
            owner, start, planes, axis, route_capacity, seed,
            passes=route_passes, weight_plane=n_planes - 1,
            weight_shift=meta_off if fold else 0,
            weight_mask=31 if fold else None)
        fw, wv = expand_superkmers(routed.planes, routed.valid, k, w)
        canon = kmer_ops.canonical_word(fw, kmer_ops.reverse_complement(
            fw, k))
        if aggregate == "unit":
            table = count_ops.unit_table(canon, wv)
        else:
            table = count_ops.count_words(canon, wv, max_k=k)
        n_win = reads_local.shape[-1] - k + 1
        metrics = {
            "reads": jax.lax.psum(jnp.int32(reads_local.shape[0]), axis),
            "kmers_emitted": jax.lax.psum(kmers, axis),
            "windows_skipped": jax.lax.psum(
                jnp.int32(reads_local.shape[0] * n_win) - kmers, axis),
            "superkmers": jax.lax.psum(n_superkmers, axis),
            # overflow in K-MERS (meta-weighted): comparable to the
            # per-k-mer pipelines' counter
            "route_overflow": jax.lax.psum(routed.overflow_weight, axis),
            "route_rerouted": jax.lax.psum(routed.rerouted, axis),
            "route_bytes": jax.lax.psum(
                jnp.int32(routed.valid.size * (4 * n_planes + 1)),
                axis),
        }
        return CountResult(table=jax.tree.map(lambda x: x[None], table),
                           metrics=metrics)

    fn = shard_map(body, mesh=mesh, in_specs=(P(axis),), out_specs=out_spec)
    return jax.jit(fn)


# -- distributed lookup service (query serving over shard tables) --------------

def make_sharded_lookup(mesh: Mesh, *, query_capacity: int, seed: int = 0,
                        axis: str = "d"):
    """Build a jitted query step over per-shard count tables.

    fn(tables, query_hi, query_lo, query_valid) -> counts int32, aligned
    with the query lanes (-1 where the query was invalid or overflowed the
    routing capacity).  tables: CountTable pytree with leading [D] dim
    (as returned by make_sharded_counter), sharded over `axis`; queries
    sharded over `axis` on dim 0.

    The owning shard answers its received queries by the branch-free
    binary search (count.lookup); answers ride the inverse all_to_all
    home scatter-free (route_queries.reply).
    """
    table_spec = CountTable(keys=U64(P(axis), P(axis)), counts=P(axis),
                            n_unique=P(axis))

    def body(tables, q_hi, q_lo, q_valid):
        shard = CountTable(
            keys=U64(tables.keys.hi[0], tables.keys.lo[0]),
            counts=tables.counts[0], n_unique=tables.n_unique[0])
        recv, recv_valid, reply, overflow = route_ops.route_queries(
            U64(q_hi.reshape(-1), q_lo.reshape(-1)), q_valid.reshape(-1),
            axis, query_capacity, seed)
        answers = count_ops.lookup(shard, recv).reshape(recv_valid.shape)
        answers = jnp.where(recv_valid, answers, -1)
        counts = reply(answers)
        return counts.reshape(q_hi.shape), jax.lax.psum(overflow, axis)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(table_spec, P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()))
    return jax.jit(fn)
