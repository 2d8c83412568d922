"""Hash-prefix routing of k-mers to owning shards via all_to_all.

New scope vs the reference (SURVEY.md §5.8): each of the D devices on the
``"d"`` mesh axis owns 1/D of the 64-bit hash space; every locally produced
canonical k-mer is routed to owner ``mix_hash(word) >> (64 - log2 D)``.

Ragged all_to_all is not expressible in XLA, so routing uses
**fixed-capacity buckets** (SURVEY.md §7 "hard parts"):

  1. owner id per lane (invalid lanes -> dead owner D, sorts last);
  2. stable sort lanes by owner;
  3. per-owner counts (histogram) + exclusive prefix = bucket extents;
  4. per-destination CONTIGUOUS dynamic slices into a [D, capacity] send
     buffer (buckets are contiguous after the owner sort, so no gather --
     see _bucket_slices; slack-sized, lanes beyond an owner's capacity are
     *counted* as overflow, never silently dropped);
  5. ``jax.lax.all_to_all`` over "d" -> [D, capacity] received lanes, all
     owned by this shard.

Overflow re-routing (SURVEY.md §7 "count overflow and re-route in a second
pass"): with ``passes=P``, pass p ships bucket lanes [p*C, (p+1)*C) --
the sort is done once, only the all_to_all repeats -- so results are EXACT
whenever every per-destination bucket holds <= P*C lanes.  Lanes beyond
P*C are dropped AND counted in ``overflow``; lanes delivered by passes
>= 2 are counted in ``rerouted``.

All steps are sort/slice/compare lane ops -- no scatter, no gather, no
dynamic shapes.  (The slice form replaced a send-buffer gather on an
accelerator where gathers were slow; whether histogram + scatter is
cheaper on the GPU is an open measurement, ROADMAP A6.)  Overflow
counters come back with the result; callers must surface them (metrics
counters ``route_overflow`` / ``route_rerouted``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import u64 as u
from ..core.u64 import U64


class Routed(NamedTuple):
    """Result of routing: lanes now living on their owning shard."""

    words: U64            # [passes * D * capacity] received k-mer words
    valid: jnp.ndarray    # [passes * D * capacity] bool
    overflow: jnp.ndarray  # int32 scalar: lanes dropped on *this* sender
    rerouted: jnp.ndarray  # int32 scalar: lanes this sender shipped in
    #                        passes >= 2 (0 when passes == 1)


def owner_of(words: U64, n_shards: int, seed: int = 0) -> jnp.ndarray:
    """Owning shard = top bits of the BIJECTIVE feistel mix of the word
    (hash-prefix routing; core.u64.feistel_mix).

    Invertibility is the round-5 routing win: the owner is a PREFIX of
    the mixed key, so the partition sorts two operands (f_hi, f_lo)
    instead of (owner, key_hi, key_lo), ships the mixed words, and the
    receiver recovers exact keys with feistel_unmix -- one fewer operand
    through the dominant sort, zero information loss.

    n_shards need not be a power of two: the prefix is mapped by
    multiply-shift ((f_hi * D) >> 32), which preserves the
    range-partition property on the mixed space.
    """
    h = u.feistel_mix(words, seed)
    # 32-bit-only multiply-shift (no u64 multiply)
    return _mul_shift32(h.hi, n_shards)


def _owner_boundaries(n_shards: int) -> list:
    """Static f_hi values where ownership changes: owner(x) >= o iff
    x >= ceil(o * 2^32 / D) (exact inverse of the multiply-shift)."""
    return [-(-o * (1 << 32) // n_shards) for o in range(n_shards + 1)]


def _owner_histogram(owner_sorted: jnp.ndarray, n_shards: int) -> jnp.ndarray:
    """Per-owner lane counts [n_shards] from an owner-SORTED lane array:
    bucket extents by binary search (searchsorted), counts by difference.

    Scatter-free on purpose (segment_sum lowers to a scatter), and
    log-depth in the lane count: D+1
    binary searches of log2(n) gathers each, so pod-scale D (256 shards x
    1M lanes) costs ~5K gathers, not D full compare-reduce passes."""
    bounds = jnp.searchsorted(owner_sorted,
                              jnp.arange(n_shards + 1, dtype=jnp.int32),
                              side="left")
    return (bounds[1:] - bounds[:-1]).astype(jnp.int32)


def _mul_shift32(x: jnp.ndarray, d: int) -> jnp.ndarray:
    """floor(x * d / 2**32) for uint32 x and small static d, using only
    32-bit lane ops (no u64 multiply)."""
    xl = x & u.u32(0xFFFF)
    xh = x >> 16
    # x*d = xh*d*2^16 + xl*d ; >> 32
    lo_prod = xl * u.u32(d)                    # < 2^48 -> fits? no: keep 32b
    hi_prod = xh * u.u32(d)
    # (hi_prod << 16 + lo_prod) >> 32 == (hi_prod + (lo_prod >> 16)) >> 16
    return ((hi_prod + (lo_prod >> 16)) >> 16).astype(jnp.int32)


def bucket_sort(words: U64, valid: jnp.ndarray, n_shards: int,
                seed: int = 0):
    """Sort lanes by owner (invalid last), in the FEISTEL-MIXED domain.

    Returns (mixed U64, valid, owner) sorted + per-owner counts
    [n_shards].  The owner is a prefix of f_hi (see owner_of), so the
    sort carries exactly TWO operands -- the mixed key planes -- instead
    of the round-4 (owner, key_hi, key_lo); callers ship the mixed planes
    and invert on the receiving shard (u.feistel_unmix).

    Invalid lanes become (0xFFFFFFFF, 0xFFFFFFFF), which sorts last;
    validity is recovered positionally (lane < n_valid) and the owner
    histogram is clipped to n_valid, so a real key aliasing the sentinel
    (possible: the mix is a bijection, one key maps there) is still
    counted exactly -- equal mixed values are interchangeable.
    """
    f = u.feistel_mix(words, seed)
    maxu = jnp.uint32(0xFFFFFFFF)
    f_hi = jnp.where(valid, f.hi, maxu)
    f_lo = jnp.where(valid, f.lo, maxu)
    # equal keys are interchangeable (payloads ride inside the key):
    # stability not required
    s_hi, s_lo = jax.lax.sort((f_hi, f_lo), num_keys=2, is_stable=False)
    n_valid = valid.sum(dtype=jnp.int32)
    sv = jnp.arange(s_hi.shape[-1], dtype=jnp.int32) < n_valid
    bounds = jnp.searchsorted(
        s_hi, jnp.asarray(_owner_boundaries(n_shards)[:-1],
                          dtype=jnp.uint32), side="left").astype(jnp.int32)
    bounds = jnp.minimum(bounds, n_valid)
    ends = jnp.concatenate([bounds[1:], n_valid[None]])
    counts = ends - bounds
    owner = _mul_shift32(s_hi, n_shards)
    return U64(s_hi, s_lo), sv, owner, counts


_UNROLL_MAX_D = 16


def _bucket_slices(arrs, starts: jnp.ndarray, capacity: int,
                   max_offset: int):
    """GATHER-FREE [D, capacity] send buffers: each destination's bucket
    is a CONTIGUOUS range of the owner-sorted lanes, so a per-destination
    ``dynamic_slice`` replaces the [D, C] gather the round-3 design used
    -- a gather of N lanes costs random reads while a contiguous slice
    is pure bandwidth.  Arrays are
    padded by max_offset + capacity zeros so no slice ever clamps (a
    clamped start would shift real bucket lanes under the in_bucket
    mask).

    Graph size (VERDICT r4 item 6): for D <= 16 the per-destination
    slices are unrolled (XLA schedules them freely -- the measured-fast
    form on small meshes); for pod-scale D they compile to ONE
    ``fori_loop`` whose body slices every plane for one destination, so
    the traced graph is O(planes), not O(D * planes) -- D = 256 with 5
    super-k-mer planes would otherwise unroll thousands of slice ops per
    pass.  Identical outputs either way (tested both forms).

    Returns a function slice_at(offset) -> list of [D, C] buffers (the
    multi-pass re-route reuses the same padded arrays)."""
    d = starts.shape[0]
    padded = [jnp.concatenate(
        [a, jnp.zeros(max_offset + capacity, a.dtype)]) for a in arrs]

    def slice_at(offset: int):
        if d <= _UNROLL_MAX_D:
            outs = []
            for a in padded:
                rows = [jax.lax.dynamic_slice_in_dim(
                    a, starts[dd] + offset, capacity) for dd in range(d)]
                outs.append(jnp.stack(rows))
            return outs

        def body(dd, bufs):
            start = starts[dd] + offset
            return tuple(
                jax.lax.dynamic_update_slice_in_dim(
                    buf,
                    jax.lax.dynamic_slice_in_dim(a, start, capacity)[None],
                    dd, axis=0)
                for buf, a in zip(bufs, padded))

        # the +a[:1]*0 keeps the carry's shard_map varying-axis annotation
        # equal to the body output's (a plain zeros init is unvarying and
        # fori_loop rejects the mismatch); XLA folds the no-op add
        init = tuple(jnp.zeros((d, capacity), a.dtype) + a[:1] * 0
                     for a in padded)
        return list(jax.lax.fori_loop(0, d, body, init))

    return slice_at


def route(words: U64, valid: jnp.ndarray, axis_name: str,
          capacity: int, seed: int = 0, passes: int = 1) -> Routed:
    """Inside shard_map: route local k-mers to their owning shard.

    words/valid: local lanes (any shape; flattened).
    capacity: per-destination lane budget on each sender, per pass.
    passes: overflow re-route rounds; pass p ships bucket lanes
    [p*C, (p+1)*C) (sorted once, all_to_all repeated).  Received size is
    passes * D * capacity; results are exact while every per-destination
    bucket holds <= passes*capacity lanes.

    The wire carries the feistel-MIXED words (bucket_sort's domain);
    receivers invert with u.feistel_unmix, so callers see exact original
    keys.
    """
    d = jax.lax.axis_size(axis_name)
    flat = U64(words.hi.reshape(-1), words.lo.reshape(-1))
    sw, sv, _so, counts = bucket_sort(flat, valid.reshape(-1), d, seed)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]).astype(jnp.int32)
    j = jnp.arange(capacity, dtype=jnp.int32)[None, :]        # [1, C]
    a2a = lambda x: jax.lax.all_to_all(x, axis_name, 0, 0, tiled=True)
    slice_at = _bucket_slices((sw.hi, sw.lo), starts, capacity,
                              (passes - 1) * capacity)
    recv_hi, recv_lo, recv_valid = [], [], []
    for p in range(passes):
        off = p * capacity
        s_hi, s_lo = slice_at(off)
        in_bucket = j < jnp.clip(counts - off, 0, capacity)[:, None]
        recv_hi.append(a2a(s_hi))
        recv_lo.append(a2a(s_lo))
        recv_valid.append(a2a(in_bucket))
    overflow = jnp.maximum(counts - passes * capacity,
                           0).sum().astype(jnp.int32)
    rerouted = jnp.clip(counts - capacity, 0,
                        (passes - 1) * capacity).sum().astype(jnp.int32)
    mixed = U64(jnp.concatenate([r.reshape(-1) for r in recv_hi]),
                jnp.concatenate([r.reshape(-1) for r in recv_lo]))
    return Routed(
        words=u.feistel_unmix(mixed, seed),
        valid=jnp.concatenate([r.reshape(-1) for r in recv_valid]),
        overflow=overflow,
        rerouted=rerouted,
    )


class RoutedPlanes(NamedTuple):
    """Result of payload routing: uint32 planes on their owning shard."""

    planes: tuple          # each [passes * D * capacity] uint32
    valid: jnp.ndarray
    overflow: jnp.ndarray
    rerouted: jnp.ndarray
    overflow_weight: jnp.ndarray   # sum of the weight plane over dropped
    #                                lanes (0 when weight_plane is None)


def route_payload(owner_words: U64, valid: jnp.ndarray, planes,
                  axis_name: str, capacity: int, seed: int = 0,
                  passes: int = 1, weight_plane=None,
                  weight_shift: int = 0,
                  weight_mask=None) -> RoutedPlanes:
    """Route arbitrary uint32 payload planes to the shard owning
    ``hash(owner_words)`` -- the owner KEY itself is not shipped.

    This is the super-k-mer transport (SURVEY.md §5.8, minimizers.rs
    20-36 rationale): k-mers sharing a minimizer route together as one
    packed-bases lane, so the per-k-mer wire cost drops by the mean run
    length.  Same fixed-capacity + multi-pass overflow design as
    ``route``.  weight_plane (an index into `planes`) makes the overflow
    accounting weight-aware: overflow_weight sums that plane over dropped
    lanes (e.g. the k-mers-per-super-k-mer meta plane, so droppage is
    reported in K-MERS, not opaque super-k-mer lanes); weight_shift /
    weight_mask extract a bit-field weight from that plane (the folded
    meta layout, pipeline._superkmer_layout)."""
    d = jax.lax.axis_size(axis_name)
    flat_owner = U64(owner_words.hi.reshape(-1), owner_words.lo.reshape(-1))
    v = valid.reshape(-1)
    owner = jnp.where(v, owner_of(flat_owner, d, seed), d).astype(jnp.int32)
    flat_planes = tuple(p.reshape(-1) for p in planes)
    out = jax.lax.sort((owner,) + flat_planes, num_keys=1, is_stable=True)
    o, sorted_planes = out[0], out[1:]
    counts = _owner_histogram(o, d)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]).astype(jnp.int32)
    n = o.shape[-1]
    if weight_plane is None:
        overflow_weight = jnp.int32(0)
    else:
        o_c = jnp.clip(o, 0, d - 1)
        rank = jnp.arange(n, dtype=jnp.int32) - starts[o_c]
        dropped = (o < d) & (rank >= passes * capacity)
        wvals = sorted_planes[weight_plane] >> weight_shift
        if weight_mask is not None:
            wvals = wvals & jnp.uint32(weight_mask)
        overflow_weight = jnp.where(
            dropped, wvals.astype(jnp.int32), 0).sum().astype(jnp.int32)
    j = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    a2a = lambda x: jax.lax.all_to_all(x, axis_name, 0, 0, tiled=True)
    slice_at = _bucket_slices(sorted_planes, starts, capacity,
                              (passes - 1) * capacity)
    recv = [[] for _ in sorted_planes]
    recv_valid = []
    for p in range(passes):
        off = p * capacity
        sliced = slice_at(off)
        in_bucket = j < jnp.clip(counts - off, 0, capacity)[:, None]
        for i, arr in enumerate(sliced):
            recv[i].append(a2a(arr))
        recv_valid.append(a2a(in_bucket))
    overflow = jnp.maximum(counts - passes * capacity,
                           0).sum().astype(jnp.int32)
    rerouted = jnp.clip(counts - capacity, 0,
                        (passes - 1) * capacity).sum().astype(jnp.int32)
    cat = lambda parts: jnp.concatenate([r.reshape(-1) for r in parts])
    return RoutedPlanes(
        planes=tuple(cat(r) for r in recv),
        valid=cat(recv_valid),
        overflow=overflow,
        rerouted=rerouted,
        overflow_weight=overflow_weight,
    )


# -- multi-word (k <= 64) routing ---------------------------------------------

from ..core import u128 as u128mod          # noqa: E402
from ..core.u128 import U128                # noqa: E402


class RoutedWide(NamedTuple):
    words: U128
    valid: jnp.ndarray
    overflow: jnp.ndarray
    rerouted: jnp.ndarray


def owner_of_wide(words: U128, n_shards: int, seed: int = 0) -> jnp.ndarray:
    h = u128mod.mix_hash(words, seed)
    return _mul_shift32(h.hi, n_shards)


def route_wide(words: U128, valid: jnp.ndarray, axis_name: str,
               capacity: int, seed: int = 0, passes: int = 1) -> RoutedWide:
    """Route 128-bit k-mer words to their owning shard (same fixed-capacity
    + multi-pass re-route design as `route`, with a 4-lane payload)."""
    d = jax.lax.axis_size(axis_name)
    flat = U128(
        U64(words.hi.hi.reshape(-1), words.hi.lo.reshape(-1)),
        U64(words.lo.hi.reshape(-1), words.lo.lo.reshape(-1)))
    v = valid.reshape(-1)
    owner = jnp.where(v, owner_of_wide(flat, d, seed), d).astype(jnp.int32)
    o, hh, hl, lh, ll = jax.lax.sort(
        (owner, flat.hi.hi, flat.hi.lo, flat.lo.hi, flat.lo.lo),
        num_keys=1, is_stable=True)
    counts = _owner_histogram(o, d)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]).astype(jnp.int32)
    j = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    a2a = lambda x: jax.lax.all_to_all(x, axis_name, 0, 0, tiled=True)
    slice_at = _bucket_slices((hh, hl, lh, ll), starts, capacity,
                              (passes - 1) * capacity)
    recv = [[] for _ in range(4)]
    recv_valid = []
    for p in range(passes):
        off = p * capacity
        sliced = slice_at(off)
        in_bucket = j < jnp.clip(counts - off, 0, capacity)[:, None]
        for i, arr in enumerate(sliced):
            recv[i].append(a2a(arr))
        recv_valid.append(a2a(in_bucket))
    overflow = jnp.maximum(counts - passes * capacity,
                           0).sum().astype(jnp.int32)
    rerouted = jnp.clip(counts - capacity, 0,
                        (passes - 1) * capacity).sum().astype(jnp.int32)
    cat = lambda parts: jnp.concatenate([r.reshape(-1) for r in parts])
    return RoutedWide(
        words=U128(U64(cat(recv[0]), cat(recv[1])),
                   U64(cat(recv[2]), cat(recv[3]))),
        valid=cat(recv_valid),
        overflow=overflow,
        rerouted=rerouted,
    )


# -- round-trip query routing (distributed lookup) -----------------------------

def route_queries(words: U64, valid: jnp.ndarray, axis_name: str,
                  capacity: int, seed: int = 0):
    """Route query words to owners, keeping the return path.

    Returns (recv_words, recv_valid [D, C], reply(fn), overflow):
    the owner computes a [D, C] int32 answer array aligned with recv and
    calls reply(answers) -> answers delivered back and scattered to the
    ORIGINAL lane positions of this sender's queries (absent/overflowed
    lanes get -1).
    """
    d = jax.lax.axis_size(axis_name)
    n = words.lo.size
    flat = U64(words.hi.reshape(-1), words.lo.reshape(-1))
    v = valid.reshape(-1)
    # feistel-prefix partition (see bucket_sort): 3 sort operands
    # (f_hi, f_lo, original position) instead of (owner, hi, lo, pos)
    f = u.feistel_mix(flat, seed)
    maxu = jnp.uint32(0xFFFFFFFF)
    f_hi = jnp.where(v, f.hi, maxu)
    f_lo = jnp.where(v, f.lo, maxu)
    # pos is the THIRD sort key (invalid lanes get pos = n): if a real
    # query aliases the (MAX, MAX) sentinel (the mix is a bijection, one
    # key maps there), its smaller pos sorts it before every invalid
    # lane, keeping it inside the valid prefix -- exact, not just
    # overwhelmingly likely
    pos = jnp.where(v, jnp.arange(n, dtype=jnp.int32), n)
    hi, lo, orig = jax.lax.sort((f_hi, f_lo, pos), num_keys=3,
                                is_stable=False)
    n_valid = v.sum(dtype=jnp.int32)
    bounds = jnp.searchsorted(
        hi, jnp.asarray(_owner_boundaries(d)[:-1], dtype=jnp.uint32),
        side="left").astype(jnp.int32)
    bounds = jnp.minimum(bounds, n_valid)
    counts = jnp.concatenate([bounds[1:], n_valid[None]]) - bounds
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]).astype(jnp.int32)
    j = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    in_bucket = j < jnp.minimum(counts, capacity)[:, None]
    overflow = jnp.maximum(counts - capacity, 0).sum().astype(jnp.int32)
    a2a = lambda x: jax.lax.all_to_all(x, axis_name, 0, 0, tiled=True)
    s_hi, s_lo, send_orig = _bucket_slices((hi, lo, orig), starts,
                                           capacity, 0)(0)
    recv = u.feistel_unmix(U64(a2a(s_hi), a2a(s_lo)), seed)
    recv_valid = a2a(in_bucket)

    def reply(answers: jnp.ndarray) -> jnp.ndarray:
        """answers [D, C] int32 on the owner -> [n] at the original sender
        lane positions (-1 where unanswered).

        Scatter-free: delivery is one 2-operand sort by the original
        position (count.py module docstring).  Dropped/overflowed lanes
        carry the
        position sentinel n and sort last; positions < n are unique, so
        after the sort lane i holds EITHER its answer (if answered) or a
        later lane's... no: every answered position appears exactly once
        and unanswered positions not at all, so the sorted prefix holds
        answers packed by position -- realign by comparing the sorted
        position stream against iota."""
        back = a2a(answers)                                 # [D, C] at sender
        flat_pos = jnp.where(in_bucket, send_orig, n)       # n = drop slot
        # union-sort delivery: answered lanes (tag 0) + one fill lane per
        # output position (tag 1, value -1), sorted by (pos, tag).  An
        # answered position (unique -- every query is sliced into at most
        # one bucket slot) lands directly before its fill lane, so each
        # fill lane takes its predecessor's value iff the packed position
        # matches; a final sort by position of the fill lanes is the
        # dense [n] answer array.
        fill_pos = jnp.arange(n, dtype=jnp.int32)
        fill_ans = jnp.full((n,), -1, jnp.int32)
        packed = jnp.concatenate(
            [flat_pos.reshape(-1) * 2, fill_pos * 2 + 1])
        vals = jnp.concatenate([back.reshape(-1), fill_ans])
        p2, v2 = jax.lax.sort((packed, vals), num_keys=1, is_stable=False)
        is_fill = (p2 & 1) == 1
        prev_v = jnp.concatenate([v2[:1] * 0 - 1, v2[:-1]])
        prev_p = jnp.concatenate([p2[:1] | 1, p2[:-1]])
        got = is_fill & (prev_p == (p2 & ~1))
        dense = jnp.where(got, prev_v, -1)
        _, out = jax.lax.sort(
            (jnp.where(is_fill, p2 >> 1, jnp.int32(n)).astype(jnp.int32),
             dense),
            num_keys=1, is_stable=False)
        return out[:n].reshape(words.lo.shape)

    return recv, recv_valid, reply, overflow
