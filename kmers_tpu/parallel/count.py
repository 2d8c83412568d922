"""Single-device k-mer counting: sort + segment-sum count tables.

This is new scope vs the reference (SURVEY.md §5.8, §7): the reference is a
k-mer *type* library; the counting pipeline demanded by BASELINE.json is
built here.

Design (static shapes, no data-dependent control flow):
  * canonical k-mer words arrive as (hi, lo) uint32 pairs + a validity mask
    (invalid = N-window / padding / structurally-out-of-range).
  * sort by (invalid, hi, lo) via ``jax.lax.sort`` with three keys --
    invalid lanes sort to the end *without* a sentinel key, so the all-T
    k-mer (word == u64::MAX) cannot alias padding.  (For k <= 31 the
    invalid flag folds into a spare key bit instead: 2 operands.)
  * group boundaries by neighbor compare; then a second stable sort
    compacts the run-start lanes (with their start positions as payload)
    to the front, and each run's count is the DIFFERENCE OF CONSECUTIVE
    compacted start positions.  Everything is sorts, shifts, compares and
    log-depth scans -- scatter-free AND gather-free.  That choice was
    made on an accelerator where scatters and gathers cost several times
    a sort of the same lanes (SURVEY.md §7 "hard parts"); whether it still
    pays on the GPU is an open measurement (ROADMAP C8).

Everything returns fixed-capacity tables: ``keys[cap]``, ``counts[cap]``,
``n_unique`` (traced scalar); slots past n_unique are zero padding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import u64 as u
from ..core.u64 import U64


class CountTable(NamedTuple):
    """Fixed-capacity k-mer count table (a JAX pytree).

    keys: U64 of shape [cap]; slots >= n_unique are zeros.
    counts: int32 [cap]; zeros past n_unique.
    n_unique: int32 scalar, number of live slots.
    """

    keys: U64
    counts: jnp.ndarray
    n_unique: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.counts.shape[-1]


UNIT_INVALID_HI = 0x80000000   # plain int: a module-level jnp
                               # constant would init the backend at
                               # import, breaking jax.distributed


class UnitTable(NamedTuple):
    """Per-batch PASSTHROUGH table: every valid lane is one occurrence.

    keys: U64 [cap] in the folded spare-bit layout (k <= 31 only): bit 31
    of hi is the INVALID flag; invalid lanes are exactly (0x80000000, 0).
    A lane with the flag clear contributes its key with weight 1.

    Why this exists (the round-4 counting insight): the deferred weighted
    consolidation (merge_many -> count_weighted) sorts EVERY lane of every
    pending table -- dead or alive -- because shapes are static.  Per-batch
    aggregation (global sort in round 2, segment-local sort in round 3)
    therefore reduces the consolidation's lane count by exactly zero; all
    that work was pure overhead ahead of a merge whose cost it never
    changed.  The information-theoretically minimal per-batch emission is
    the raw canonical keys themselves, so the per-batch "count" step
    disappears entirely, and this 8 B/lane wrapper is its table form (no
    counts plane in device memory: the weight of a live lane is
    definitionally 1 and the validity is the folded flag bit)."""

    keys: U64

    @property
    def capacity(self) -> int:
        return self.keys.lo.size


def unit_table(words: U64, valid: jnp.ndarray) -> UnitTable:
    """Wrap canonical words + validity as a UnitTable (k <= 31: bit 31 of
    hi must be structurally clear for valid keys).  Invalid lanes are
    normalized to exactly (0x80000000, 0)."""
    v = valid
    vmask = jnp.uint32(0) - v.astype(jnp.uint32)
    hi = (words.hi & vmask) | jnp.where(v, jnp.uint32(0),
                                    jnp.uint32(UNIT_INVALID_HI))
    return UnitTable(keys=U64(hi, words.lo & vmask))


def sort_by_word(words: U64, valid: jnp.ndarray, *extras,
                 spare_hi_bit: bool = False):
    """Stable sort lanes by ((~valid), hi, lo).  Returns (words, valid,
    *extras) reordered; invalid lanes are last.

    spare_hi_bit=True is a bandwidth optimization for k <= 31: bit 31 of
    `hi` is structurally clear for every valid k-mer word (hi holds at most
    2k-32 <= 30 bits), so the invalid flag folds into it -- the sort then
    moves two key operands instead of three keys + a valid payload, and
    valid is reconstructed as lane < n_valid (invalid lanes all carry the
    flag bit, so they sort strictly last).  NOT safe for k = 32 (the all-T
    word uses bit 31): there the separate invalid key keeps u64::MAX
    k-mers from aliasing padding (see module docstring)."""
    if spare_hi_bit:
        flag = jnp.where(valid, jnp.uint32(0), jnp.uint32(1) << 31)
        key_hi = words.hi | flag
        n = words.lo.shape[-1]
        out = jax.lax.sort((key_hi, words.lo) + tuple(extras),
                           num_keys=2, is_stable=True)
        v = jnp.arange(n, dtype=jnp.int32) < valid.sum(dtype=jnp.int32)
        return U64(out[0] & jnp.uint32(0x7FFFFFFF), out[1]), v, out[2:]
    invalid_key = (~valid).astype(jnp.uint32)
    operands = (invalid_key, words.hi, words.lo, valid) + tuple(extras)
    out = jax.lax.sort(operands, num_keys=3, is_stable=True)
    return U64(out[1], out[2]), out[3], out[4:]


def _run_starts(words: U64, valid: jnp.ndarray):
    """Boundary mask of equal-word runs in a sorted lane array (invalid
    lanes are last and never start a run)."""
    n = words.lo.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    prev = U64(jnp.roll(words.hi, 1), jnp.roll(words.lo, 1))
    prev_valid = jnp.roll(valid, 1)
    starts = valid & ((idx == 0) | u.ne(words, prev) | ~prev_valid)
    return starts, idx


def _counts_from_positions(pos: jnp.ndarray, idx: jnp.ndarray,
                           n_unique: jnp.ndarray,
                           last_total: jnp.ndarray) -> jnp.ndarray:
    """counts[g] = pos[g+1] - pos[g] for slots g < n_unique (the last live
    run is closed by `last_total`): consecutive differences of compacted
    start positions -- no segment ops, no gathers."""
    live = idx < n_unique
    nxt = jnp.where(idx + 1 < n_unique, jnp.roll(pos, -1), last_total)
    return jnp.where(live, nxt - pos, 0)


def _compact_starts(s: U64, starts: jnp.ndarray, payload: jnp.ndarray,
                    spare_hi_bit: bool):
    """Stable-compact run-start lanes to the front of a key-sorted array,
    carrying `payload`.  Returns (k_hi, k_lo, payload) compacted.

    spare_hi_bit=True (k <= 31 keys, flag-stripped): the not-start flag
    folds into bit 31 of hi -- 3 sort operands instead of 4.  Sorting by
    the folded (hi, lo) equals a stable sort by not_start alone here:
    run starts are unique per key and already in key order, so ordering
    starts by key is the same permutation, and non-start lane order is
    irrelevant (their payload is discarded past n_unique)."""
    not_start = (~starts).astype(jnp.uint32)
    if spare_hi_bit:
        f_hi, k_lo, pay = jax.lax.sort(
            (s.hi | (not_start << 31), s.lo, payload),
            num_keys=2, is_stable=True)
        return f_hi & jnp.uint32(0x7FFFFFFF), k_lo, pay
    _, k_hi, k_lo, pay = jax.lax.sort(
        (not_start, s.hi, s.lo, payload), num_keys=1, is_stable=True)
    return k_hi, k_lo, pay


def count_sorted(words: U64, valid: jnp.ndarray,
                 spare_hi_bit: bool = False) -> CountTable:
    """Count runs of equal (already sorted) words; invalid lanes ignored.
    spare_hi_bit: see _compact_starts (requires k <= 31 keys)."""
    n = words.lo.shape[-1]
    starts, idx = _run_starts(words, valid)
    n_unique = starts.sum(dtype=jnp.int32)
    n_valid = valid.sum(dtype=jnp.int32)
    # stable-compact run-start lanes (with their positions) to the front;
    # stability preserves key order, so the table invariant holds
    k_hi, k_lo, pos = _compact_starts(words, starts, idx, spare_hi_bit)
    live = idx < n_unique
    counts = _counts_from_positions(pos, idx, n_unique, n_valid)
    keys = U64(jnp.where(live, k_hi, 0), jnp.where(live, k_lo, 0))
    return CountTable(keys=keys, counts=counts, n_unique=n_unique)


def count_sorted_runs(words: U64, valid: jnp.ndarray) -> CountTable:
    """Count runs of equal (already sorted) words WITHOUT compacting:
    keys stay sorted-with-duplicates; counts[p] = run length at run-start
    lanes, 0 elsewhere.

    Why: the compaction in count_sorted is a second full sort (~45% of the
    batch-count cost).  Run lengths need only the distance to the NEXT run
    start, which is a reverse cumulative minimum over start positions --
    one bandwidth-bound scan instead of a sort.  The result is a valid
    count table for every consumer keyed on ``counts > 0`` (merging,
    weighted re-count); the streaming pipeline compacts once per
    `merge_every` batches at consolidation instead of once per batch."""
    n = words.lo.shape[-1]
    starts, idx = _run_starts(words, valid)
    n_unique = starts.sum(dtype=jnp.int32)
    n_valid = valid.sum(dtype=jnp.int32)
    # index of the next run start strictly after p (n where none): reverse
    # cummin of (idx at starts, n elsewhere), shifted left by one lane
    s_pos = jnp.where(starts, idx, n)
    ns_incl = jax.lax.cummin(s_pos, axis=0, reverse=True)
    ns_excl = jnp.concatenate(
        [ns_incl[1:], jnp.full((1,), n, dtype=ns_incl.dtype)])
    counts = jnp.where(starts, jnp.minimum(ns_excl, n_valid) - idx, 0)
    return CountTable(keys=words, counts=counts.astype(jnp.int32),
                      n_unique=n_unique)


def count_words(words: U64, valid: jnp.ndarray,
                max_k: Optional[int] = None,
                compact: bool = True) -> CountTable:
    """Sort + count a flat lane array of k-mer words.

    max_k: when given and <= 31, the sort folds the invalid flag into the
    structurally-spare bit 31 of hi (see sort_by_word) -- same table,
    ~2x less sort traffic.  Leave None for unknown or k = 32 key spaces.

    compact=False returns a run-length form (count_sorted_runs): keys
    stay globally sorted with duplicates, counts sit at run starts -- no
    compaction sort, same information; use when the table feeds a merge
    rather than direct indexed reads."""
    flat = U64(words.hi.reshape(-1), words.lo.reshape(-1))
    s, v, _ = sort_by_word(flat, valid.reshape(-1),
                           spare_hi_bit=max_k is not None and max_k <= 31)
    if compact:
        return count_sorted(s, v,
                            spare_hi_bit=max_k is not None and max_k <= 31)
    return count_sorted_runs(s, v)


def count_weighted(words: U64, valid: jnp.ndarray, weights: jnp.ndarray,
                   max_k: Optional[int] = None) -> CountTable:
    """Like count_words but each lane contributes `weights` (int32) --
    used to merge pre-counted tables."""
    flat = U64(words.hi.reshape(-1), words.lo.reshape(-1))
    s, v, (w,) = sort_by_word(flat, valid.reshape(-1), weights.reshape(-1),
                              spare_hi_bit=max_k is not None and max_k <= 31)
    starts, idx = _run_starts(s, v)
    n_unique = starts.sum(dtype=jnp.int32)
    # run weight = difference of the exclusive weight prefix sum at
    # consecutive run starts (same sort-compaction trick as count_sorted).
    # The prefix sum is uint32 ON PURPOSE: total mass past 2^31 (human-
    # genome scale) wraps, but each run weight is a DIFFERENCE of two
    # prefix values, which is exact mod 2^32 -- so counts stay correct as
    # long as every individual key's count < 2^31 (the int32 CountTable
    # ceiling; dropped_kmers accounting shares it).
    mw = jnp.where(v, w, 0).astype(jnp.uint32)
    csum = jnp.cumsum(mw)
    csum_excl = csum - mw
    k_hi, k_lo, p_excl = _compact_starts(
        s, starts, csum_excl,
        spare_hi_bit=max_k is not None and max_k <= 31)
    live = idx < n_unique
    counts = _counts_from_positions(p_excl, idx, n_unique,
                                    csum[-1]).astype(jnp.int32)
    keys = U64(jnp.where(live, k_hi, 0), jnp.where(live, k_lo, 0))
    return CountTable(keys=keys, counts=counts, n_unique=n_unique)


def merge_tables(a: CountTable, b: CountTable,
                 max_k: Optional[int] = None) -> CountTable:
    """Merge two count tables (capacity = cap_a + cap_b)."""
    return merge_many([a, b], max_k=max_k)


def _live_lanes(t) -> jnp.ndarray:
    """Flat live-slot mask of a count table: slots carrying mass.

    ``counts > 0`` covers every count-table form uniformly -- compacted
    (live prefix), run-length (count_sorted_runs: counts only at run
    starts) and per-shard stacked [D, cap] tables -- since dead/padding
    slots always hold count 0 and live keys always count >= 1.  UnitTable
    liveness is the folded flag bit instead (no counts plane exists)."""
    if isinstance(t, UnitTable):
        return ((t.keys.hi.reshape(-1) >> 31) == 0)
    return (t.counts > 0).reshape(-1)


def _table_parts(t):
    """(hi, lo, weights, valid) flat views of any narrow table form.

    For a UnitTable the weights plane never touches HBM: it is the 0/1
    validity itself, fused by XLA into the consuming merge."""
    valid = _live_lanes(t)
    hi = t.keys.hi.reshape(-1)
    if isinstance(t, UnitTable):
        # strip the folded flag so concatenated keys are uniform; the
        # merge re-folds it from `valid` (sort_by_word spare path)
        return (hi & jnp.uint32(0x7FFFFFFF), t.keys.lo.reshape(-1),
                valid.astype(jnp.int32), valid)
    return hi, t.keys.lo.reshape(-1), t.counts.reshape(-1), valid


def merge_many(tables, max_k: Optional[int] = None) -> CountTable:
    """Merge count tables (capacity = sum of capacities): one concat +
    weighted re-count, so merging N tables at once costs one sort instead
    of N-1 pairwise merge sorts.  Tables may be flat or per-shard stacked
    ([D, cap]; shard tables are disjoint so this is exact), and any of
    them may be a UnitTable (per-batch passthrough form)."""
    parts = [_table_parts(t) for t in tables]
    keys = U64(jnp.concatenate([p[0] for p in parts]),
               jnp.concatenate([p[1] for p in parts]))
    counts = jnp.concatenate([p[2] for p in parts])
    valid = jnp.concatenate([p[3] for p in parts])
    return count_weighted(keys, valid, counts, max_k=max_k)


def empty_like_table(t):
    """An all-dead table with t's shapes (consolidation padding): zeros
    for count tables; for UnitTable every lane must carry the INVALID
    pattern (0x80000000, 0) -- an all-zeros UnitTable would claim
    capacity occurrences of key 0."""
    if isinstance(t, UnitTable):
        return UnitTable(keys=U64(
            jnp.full_like(t.keys.hi, UNIT_INVALID_HI),
            jnp.zeros_like(t.keys.lo)))
    if isinstance(t, UnitTableWide):
        return UnitTableWide(keys=U128(
            U64(jnp.full_like(t.keys.hi.hi, UNIT_INVALID_HI),
                jnp.zeros_like(t.keys.hi.lo)),
            U64(jnp.zeros_like(t.keys.lo.hi),
                jnp.zeros_like(t.keys.lo.lo))))
    return jax.tree.map(jnp.zeros_like, t)


def lookup(table: CountTable, queries: U64) -> jnp.ndarray:
    """Count of each query word (0 if absent): branch-free binary search
    over the sorted key region.  Static log2(cap) steps."""
    cap = table.capacity
    lo_idx = jnp.zeros(queries.lo.shape, dtype=jnp.int32)
    hi_idx = jnp.full(queries.lo.shape, cap, dtype=jnp.int32)
    steps = max(1, cap.bit_length())
    for _ in range(steps):
        mid = (lo_idx + hi_idx) // 2
        mid_c = jnp.clip(mid, 0, cap - 1)
        mk = U64(table.keys.hi[mid_c], table.keys.lo[mid_c])
        # keys past n_unique are padding: treat as +inf
        in_range = mid < table.n_unique
        key_lt_query = in_range & u.lt(mk, queries)
        lo_idx = jnp.where(key_lt_query, mid + 1, lo_idx)
        hi_idx = jnp.where(key_lt_query, hi_idx, mid)
    found = jnp.clip(lo_idx, 0, cap - 1)
    fk = U64(table.keys.hi[found], table.keys.lo[found])
    hit = (lo_idx < table.n_unique) & u.eq(fk, queries)
    return jnp.where(hit, table.counts[found], 0)


# -- multi-word (k <= 64) count tables ----------------------------------------

from ..core import u128 as u128mod          # noqa: E402
from ..core.u128 import U128                # noqa: E402


class CountTableWide(NamedTuple):
    """Fixed-capacity count table keyed by 128-bit k-mer words."""

    keys: U128
    counts: jnp.ndarray
    n_unique: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.counts.shape[-1]


class UnitTableWide(NamedTuple):
    """Per-batch passthrough table for 128-bit keys (33 <= k <= 63): bit
    31 of hi.hi is the INVALID flag (structurally clear for k <= 63 keys);
    invalid lanes are exactly (0x80000000, 0, 0, 0).  See UnitTable for
    why per-batch aggregation is skipped entirely."""

    keys: U128

    @property
    def capacity(self) -> int:
        return self.keys.lo.lo.size


def unit_table_wide(words: U128, valid: jnp.ndarray) -> UnitTableWide:
    """Wrap wide canonical words + validity as a UnitTableWide (k <= 63)."""
    v = valid
    vmask = jnp.uint32(0) - v.astype(jnp.uint32)
    hh = (words.hi.hi & vmask) | jnp.where(v, jnp.uint32(0),
                                       jnp.uint32(UNIT_INVALID_HI))
    return UnitTableWide(keys=U128(
        U64(hh, words.hi.lo & vmask),
        U64(words.lo.hi & vmask, words.lo.lo & vmask)))


def _flatten_wide(words: U128) -> U128:
    return U128(
        U64(words.hi.hi.reshape(-1), words.hi.lo.reshape(-1)),
        U64(words.lo.hi.reshape(-1), words.lo.lo.reshape(-1)))


def sort_by_word_wide(words: U128, valid: jnp.ndarray, *extras,
                      spare_hi_bit: bool = False):
    """Stable sort lanes by ((~valid), key128).  Returns (words, valid,
    extras) reordered; invalid lanes last.

    spare_hi_bit=True (safe for k <= 63): hi.hi holds at most 2k-96 <= 30
    bits, so the invalid flag folds into its bit 31 -- 4 sort operands
    instead of 6, valid reconstructed as lane < n_valid (mirror of
    sort_by_word's k <= 31 optimization)."""
    flat = _flatten_wide(words)
    v = valid.reshape(-1)
    n = v.shape[-1]
    if spare_hi_bit:
        flag = jnp.where(v, jnp.uint32(0), jnp.uint32(1) << 31)
        out = jax.lax.sort(
            (flat.hi.hi | flag, flat.hi.lo, flat.lo.hi, flat.lo.lo)
            + tuple(extras),
            num_keys=4, is_stable=True)
        s = U128(U64(out[0] & jnp.uint32(0x7FFFFFFF), out[1]),
                 U64(out[2], out[3]))
        sv = jnp.arange(n, dtype=jnp.int32) < v.sum(dtype=jnp.int32)
        return s, sv, out[4:]
    invalid_key = (~v).astype(jnp.uint32)
    out = jax.lax.sort(
        (invalid_key, flat.hi.hi, flat.hi.lo, flat.lo.hi, flat.lo.lo, v)
        + tuple(extras),
        num_keys=5, is_stable=True)
    return U128(U64(out[1], out[2]), U64(out[3], out[4])), out[5], out[6:]


def _run_starts_wide(s: U128, sv: jnp.ndarray):
    n = sv.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    prev = jax.tree.map(lambda x: jnp.roll(x, 1), s)
    prev_valid = jnp.roll(sv, 1)
    starts = sv & ((idx == 0) | u128mod.ne(s, prev) | ~prev_valid)
    return starts, idx


def _compact_wide(s: U128, starts: jnp.ndarray, idx: jnp.ndarray,
                  n_unique: jnp.ndarray, pos_payload: jnp.ndarray,
                  last_total: jnp.ndarray,
                  spare_hi_bit: bool = False) -> CountTableWide:
    """Stable-compact run-start lanes to the front, derive counts from
    consecutive compacted position payloads (shared by plain/weighted).
    spare_hi_bit (k <= 63 keys): fold not_start into bit 31 of hi.hi --
    5 sort operands instead of 6 (see _compact_starts for the argument
    why sorting starts by key equals the stable not_start compaction)."""
    not_start = (~starts).astype(jnp.uint32)
    if spare_hi_bit:
        fhh, khl, klh, kll, pos = jax.lax.sort(
            (s.hi.hi | (not_start << 31), s.hi.lo, s.lo.hi, s.lo.lo,
             pos_payload),
            num_keys=4, is_stable=True)
        khh = fhh & jnp.uint32(0x7FFFFFFF)
    else:
        _, khh, khl, klh, kll, pos = jax.lax.sort(
            (not_start, s.hi.hi, s.hi.lo, s.lo.hi, s.lo.lo, pos_payload),
            num_keys=1, is_stable=True)
    live = idx < n_unique
    counts = _counts_from_positions(pos, idx, n_unique,
                                    last_total).astype(jnp.int32)
    zero = lambda x: jnp.where(live, x, 0)
    keys = U128(U64(zero(khh), zero(khl)), U64(zero(klh), zero(kll)))
    return CountTableWide(keys=keys, counts=counts, n_unique=n_unique)


def count_words_wide(words: U128, valid: jnp.ndarray,
                     max_k: Optional[int] = None,
                     compact: bool = True) -> CountTableWide:
    """Sort + count 128-bit keys: lexicographic sort then run-length
    counting (see sort_by_word_wide for the max_k <= 63 spare-bit trick).

    compact=False returns the run-length form (see count_sorted_runs):
    globally sorted keys with duplicates, counts at run starts."""
    s, sv, _ = sort_by_word_wide(words, valid,
                                 spare_hi_bit=max_k is not None
                                 and max_k <= 63)
    starts, idx = _run_starts_wide(s, sv)
    n_unique = starts.sum(dtype=jnp.int32)
    n_valid = sv.sum(dtype=jnp.int32)
    if compact:
        return _compact_wide(s, starts, idx, n_unique, idx, n_valid,
                             spare_hi_bit=max_k is not None and max_k <= 63)
    n = sv.shape[-1]
    s_pos = jnp.where(starts, idx, n)
    ns_incl = jax.lax.cummin(s_pos, axis=0, reverse=True)
    ns_excl = jnp.concatenate(
        [ns_incl[1:], jnp.full((1,), n, dtype=ns_incl.dtype)])
    counts = jnp.where(starts, jnp.minimum(ns_excl, n_valid) - idx, 0)
    return CountTableWide(keys=s, counts=counts.astype(jnp.int32),
                          n_unique=n_unique)


def count_weighted_wide(words: U128, valid: jnp.ndarray,
                        weights: jnp.ndarray,
                        max_k: Optional[int] = None) -> CountTableWide:
    """count_words_wide with per-lane int32 weights (table merging).  Same
    uint32 wraparound-difference prefix-sum invariant as count_weighted."""
    s, sv, (w,) = sort_by_word_wide(words, valid, weights.reshape(-1),
                                    spare_hi_bit=max_k is not None
                                    and max_k <= 63)
    starts, idx = _run_starts_wide(s, sv)
    n_unique = starts.sum(dtype=jnp.int32)
    mw = jnp.where(sv, w, 0).astype(jnp.uint32)
    csum = jnp.cumsum(mw)
    return _compact_wide(s, starts, idx, n_unique, csum - mw, csum[-1],
                         spare_hi_bit=max_k is not None and max_k <= 63)


def _table_parts_wide(t):
    """(hh, hl, lh, ll, weights, valid) flat views of any wide table form
    (mirror of _table_parts)."""
    if isinstance(t, UnitTableWide):
        hh = t.keys.hi.hi.reshape(-1)
        valid = (hh >> 31) == 0
        return (hh & jnp.uint32(0x7FFFFFFF), t.keys.hi.lo.reshape(-1),
                t.keys.lo.hi.reshape(-1), t.keys.lo.lo.reshape(-1),
                valid.astype(jnp.int32), valid)
    return (t.keys.hi.hi.reshape(-1), t.keys.hi.lo.reshape(-1),
            t.keys.lo.hi.reshape(-1), t.keys.lo.lo.reshape(-1),
            t.counts.reshape(-1), (t.counts > 0).reshape(-1))


def merge_many_wide(tables, max_k: Optional[int] = None) -> CountTableWide:
    """Merge wide count tables (capacity = sum of capacities): one concat
    + weighted re-count (mirror of merge_many; accepts flat or per-shard
    stacked tables, any of them UnitTableWide)."""
    parts = [_table_parts_wide(t) for t in tables]
    keys = U128(
        U64(jnp.concatenate([p[0] for p in parts]),
            jnp.concatenate([p[1] for p in parts])),
        U64(jnp.concatenate([p[2] for p in parts]),
            jnp.concatenate([p[3] for p in parts])))
    counts = jnp.concatenate([p[4] for p in parts])
    valid = jnp.concatenate([p[5] for p in parts])
    return count_weighted_wide(keys, valid, counts, max_k=max_k)


def merge_tables_wide(a: CountTableWide, b: CountTableWide,
                      max_k: Optional[int] = None) -> CountTableWide:
    return merge_many_wide([a, b], max_k=max_k)


def lookup_wide(table: CountTableWide, queries: U128) -> jnp.ndarray:
    """Count of each 128-bit query word (0 if absent): branch-free binary
    search over the sorted key region (mirror of lookup)."""
    cap = table.capacity
    lo_idx = jnp.zeros(queries.lo.lo.shape, dtype=jnp.int32)
    hi_idx = jnp.full(queries.lo.lo.shape, cap, dtype=jnp.int32)
    for _ in range(max(1, cap.bit_length())):
        mid = (lo_idx + hi_idx) // 2
        mid_c = jnp.clip(mid, 0, cap - 1)
        mk = U128(U64(table.keys.hi.hi[mid_c], table.keys.hi.lo[mid_c]),
                  U64(table.keys.lo.hi[mid_c], table.keys.lo.lo[mid_c]))
        in_range = mid < table.n_unique
        key_lt_query = in_range & u128mod.lt(mk, queries)
        lo_idx = jnp.where(key_lt_query, mid + 1, lo_idx)
        hi_idx = jnp.where(key_lt_query, hi_idx, mid)
    found = jnp.clip(lo_idx, 0, cap - 1)
    fk = U128(U64(table.keys.hi.hi[found], table.keys.hi.lo[found]),
              U64(table.keys.lo.hi[found], table.keys.lo.lo[found]))
    hit = (lo_idx < table.n_unique) & u128mod.eq(fk, queries)
    return jnp.where(hit, table.counts[found], 0)
