"""Depth-capped reachability prefetch and rc-indexed primer scans.

The sPCR graph extension is a host-driven BFS that issues one small
candidate-count lookup batch per wave (pcr/graph.py). Each synchronous
device round trip costs a dispatch and a host sync, so per-wave device
lookups scale with the walk length (a 1.8 kb amplicon is ~1800 waves), and a
full host mirror of the table pays a device->host export of the whole
table before the first wave.

Both costs disappear if the device ships only the rows the walk can
ever touch. ``reach`` runs the whole expansion *inside one jitted
``lax.while_loop``*: starting from the host's current wave candidates,
it repeatedly expands every hit k-mer to its 8 de Bruijn neighbours
(4 suffix-shifts + 4 prefix-shifts — exactly the candidate set the
host enumerates per node per direction, graph.rs:417-430), keeps hits
with count >= the step threshold, and returns the visited rows. The
host then serves waves from that result:

* a hit in the result is the exact table count;
* a miss within ``depth`` waves of the prefetch is proven absent
  (below threshold): the closure is a superset of everything the host
  walk can query, because the host adds nodes only for candidates at
  or above the step threshold, and its high-coverage skip and node
  budget only *shrink* the explored region;
* when the closure ran to quiescence (frontier emptied) misses are
  trusted for the rest of the walk — the common case: one device call
  covers an entire gene x threshold step.

The device is a pure cache warmer; extension *semantics* (thresholds,
medians, coverage skip, budget, meet-in-the-middle) stay byte-exact on
host.

Lookup structure: the in-loop table probe must touch O(1) scattered
locations per candidate; a binary search over a 2^25-row partition
costs 25 dependent gathers per candidate per level. Instead each
partition gets a one-time *bucket LUT* sidecar: ``lut[b]`` = first row
whose key's top B bits equal b (built with one sort + one small
scatter). A probe is then 2 LUT gathers + a fixed number of
*contiguous* 32-row block reads + vector compares. ``build_sidecar``
raises the LUT bits until every bucket fits the default two-block probe
window; if a bucket still overflows at the bits cap (dense
low-complexity key clusters, or tables beyond ~2 G unique rows), the
sidecar records a wider power-of-two ``probe_blocks`` and the kernel
compiles with that wider fixed window instead — counts stay exact at
any occupancy.

Visited-set membership inside the loop is a **bitmap over global row
ids** (one u32 word per 32 table rows): the test is one scattered
gather + bit mask, and insertion is one tiny scatter-add of
freshly-deduplicated bits, instead of a ``searchsorted`` into a
re-merged sorted visited set every level. Each new row is also
appended to a flat id log, so the loop needs no re-merged visited
array at all; the log's valid entries are gathered once after the
loop.

``rc_index``/``range_scan_part`` serve the primer scans
(find_oligos_in_kmers, primers.rs:163-226): a forward prefix match is
a contiguous key range of the sorted partition, and a reverse-strand
match is a contiguous range of the revcomp-sorted index (a k-mer ends
with rc(oligo) iff its revcomp starts with the oligo), so each scan is
a tiny range-enumeration call instead of a full-table sweep.
"""

from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger("sharkmer")

from ..utils import phases
from .encoding import KMER_SENTINEL
from .hashtable import _revcomp_kernel

EMPTY = np.uint64(KMER_SENTINEL)
_INF32 = np.int32(0x7FFF_FFFF)

# Reach-loop shape defaults. f_cap is quantized to {256, 1024, 4096}
# (grow-and-retry on overflow): every distinct (f_cap, depth, n_words,
# partition-shape) tuple is a separate XLA compile of this kernel.
F_CAP = 256         # live walkers per iteration (typical walks carry < 30)
F_GROW = 4          # retry multiplier (stays on the quantized ladder)
DEPTH = 2048        # waves of host walk covered per prefetch: one
#                     closure covers all but the longest amplicons
BLOCK = 32          # contiguous rows fetched per bucket probe
_LOG2B = BLOCK.bit_length() - 1


# -- bucket LUT sidecar --------------------------------------------------------


def _lut_bits(n_slots: int, k: int) -> int:
    """Initial bucket-bit guess (~rows/16 per bucket); build_sidecar
    raises it until the max occupancy fits one 2-block probe. Bounded
    by the key width so tiny-k tests stay valid."""
    b = max(6, n_slots.bit_length() - 5)
    return min(b, 2 * k - 1, 26)


def _lut_bits_cap(k: int) -> int:
    return min(2 * k - 1, 26)


@functools.partial(jax.jit, static_argnames=("bits", "shift"))
def _build_lut_kernel(keys, bits: int, shift: int):
    """lut[b] = first row index whose bucket (key >> shift) >= b, for
    b in [0, 2^bits]; == n_real for buckets past the last occupied
    row. One full-width sort compacts the bucket run starts, then a
    small scatter + reverse-cummin backfill (a searchsorted of the
    2^bits boundaries would be millions of dependent 25-step binary
    searches). Also returns the max bucket occupancy, which
    build_sidecar uses to guarantee every bucket fits the kernel's
    fixed two-block probe window."""
    n = keys.shape[0]
    bi = jnp.minimum(
        keys >> jnp.uint64(shift), jnp.uint64(1) << jnp.uint64(bits)
    )
    prev = jnp.concatenate(
        [jnp.full((1,), jnp.uint64(0xFFFF_FFFF_FFFF_FFFF)), bi[:-1]]
    )
    first = bi != prev
    pos = jnp.arange(n, dtype=jnp.int64)
    packed = jnp.where(
        first, (bi.astype(jnp.int64) << 32) | pos,
        jnp.int64(0x7FFF_FFFF_FFFF_FFFF),
    )
    n_buckets = (1 << bits) + 1
    take = min(n_buckets, n)
    sp = jax.lax.sort(packed, is_stable=False)[:take]
    live = sp != jnp.int64(0x7FFF_FFFF_FFFF_FFFF)
    idx = jnp.where(live, sp >> 32, n_buckets)  # dropped when past end
    val = jnp.where(live, sp & jnp.int64(0xFFFF_FFFF), 0).astype(jnp.int32)
    lut = jnp.full((n_buckets,), _INF32)
    lut = lut.at[idx].min(val, mode="drop")
    # backfill: empty buckets inherit the next occupied bucket's start
    lut = jnp.flip(jax.lax.cummin(jnp.flip(jnp.minimum(lut, jnp.int32(n)))))
    max_occ = jnp.max(lut[1:] - lut[:-1])
    return lut, max_occ


# Steady-state loop width. Per-level cost is dominated by the probe
# gathers and scales with 8*F_NARROW candidates. Typical walks carry
# only a handful of live walkers; the rare frontier burst past 16
# overflows and retries at 64 via the grow ladder, costing one extra
# closure run.
F_NARROW = 16


@dataclass(frozen=True)
class PartSidecar:
    """Per-partition device index structures (immutable per flush).

    ``keys1d``/``counts1d`` alias the partition's ORIGINAL sorted
    planes (no copy) and serve the epilogue's result gathers. The
    probe reads [n_blocks, BLOCK] 2D copies: ``packed2d`` (key and a
    saturating count in one u64, +8 B/row) when the key leaves >= 12
    spare bits and the table is within the device table's row cap,
    else ``keys2d`` + ``counts2d``.

    The 2D copies exist because reshaping flat planes inside the
    reach kernel re-materializes them per while-loop capture."""

    keys1d: jax.Array   # the partition's sorted keys (aliased)
    counts1d: jax.Array
    lut: jax.Array      # [2^bits + 1] int32 row offsets
    bits: int
    shift: int
    keys2d: jax.Array
    counts2d: jax.Array
    # key | min(count, 2^(64-2k)-1) << 2k, when >= 12 spare bits exist:
    # the in-loop probe then gathers ONE block array for both the key
    # compare and the (saturating-exact) threshold test
    packed2d: jax.Array | None = None
    # fixed probe-window width in BLOCK-row blocks: 2 except when a
    # bucket overflows the two-block window at the LUT bits cap
    probe_blocks: int = 2


@functools.partial(jax.jit, static_argnames=("k",))
def _pack_counts_kernel(keys, counts, k: int):
    spare = 64 - 2 * k
    cap = jnp.uint64((1 << spare) - 1)
    return keys | (
        jnp.minimum(counts.astype(jnp.uint64), cap) << jnp.uint64(2 * k)
    )


def build_sidecar(part_keys, part_counts, k: int,
                  with_packed: bool = True) -> PartSidecar:
    """``with_packed=False`` (deep tables): no +8 B/row count-packed
    plane; probes then gather the key and count blocks separately."""
    n_slots = int(part_keys.shape[0])
    bits = _lut_bits(n_slots, k)
    cap = _lut_bits_cap(k)
    # raise bits until every bucket fits the probe's fixed two-block
    # window: occupancy <= BLOCK rows means [32*(s>>5), +64) always
    # covers [s, e) regardless of s's alignment, so the in-loop lookup
    # needs no widen retries (each LUT build is one searchsorted)
    while True:
        shift = 2 * k - bits
        lut, max_occ = _build_lut_kernel(part_keys, bits, shift)
        if int(max_occ) <= BLOCK or bits >= cap:
            break
        bits += 1
    # a W-block window starting at the bucket's first block covers at
    # least 32*W - 31 rows from the bucket start (worst alignment:
    # s % 32 == 31). Overfull buckets at the bits cap (dense
    # low-complexity key clusters, or tables beyond ~2 G unique rows)
    # therefore get a wider fixed window instead of a hard failure;
    # probe_blocks stays a power of two so the reach kernel compiles a
    # bounded set of window shapes.
    probe_blocks = 2
    while int(max_occ) > BLOCK * probe_blocks - (BLOCK - 1):
        probe_blocks *= 2
    pad = (-n_slots) % BLOCK
    if pad:  # partition widths are powers of two >= 64, so this is moot
        part_keys = jnp.concatenate(
            [part_keys, jnp.full((pad,), jnp.uint64(EMPTY))]
        )
        part_counts = jnp.concatenate(
            [part_counts, jnp.zeros((pad,), jnp.uint32)]
        )
    packed2d = None
    if with_packed and 64 - 2 * k >= 12:
        packed2d = _pack_counts_kernel(
            part_keys, part_counts, k
        ).reshape(-1, BLOCK)
    return PartSidecar(
        keys1d=part_keys, counts1d=part_counts,
        keys2d=part_keys.reshape(-1, BLOCK),
        counts2d=part_counts.reshape(-1, BLOCK),
        lut=lut, bits=bits, shift=shift, packed2d=packed2d,
        probe_blocks=probe_blocks,
    )


# -- rc index (primer scans) ---------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k",))
def _rc_index_kernel(keys, k: int):
    """(revcomp(key) sorted ascending, original row) for one partition.
    EMPTY rows keep the EMPTY sentinel (u64 max) and sort to the end."""
    rc = _revcomp_kernel(keys, k)
    idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    return jax.lax.sort((rc, idx), num_keys=1, is_stable=False)


@functools.partial(jax.jit, static_argnames=("shift", "k", "max_out"))
def _fused_scan_kernel(part_keys, part_counts, rc_sorted, rc_order,
                       n_keys, oligos, shift: int, k: int, max_out: int):
    """One partition's primer scan in ONE dispatch: forward range rows,
    reverse-strand rows (mapped through the rc index), row-level
    forward precedence, and the normalized (kmer, count) gathers, so a
    scan pays one dispatch and one host sync instead of 5-7.

    Returns (kmers u64 [2*max_out] EMPTY-padded, counts u32
    [2*max_out], totals i64 [2]) — totals carry the TRUE fwd/rc match
    counts so the host can detect max_out overflow without an extra
    round trip.
    """

    def range_rows(sorted_keys):
        lo = oligos << jnp.uint64(shift)
        hi = (oligos + jnp.uint64(1)) << jnp.uint64(shift)
        s = jnp.minimum(jnp.searchsorted(sorted_keys, lo), n_keys)
        e = jnp.minimum(jnp.searchsorted(sorted_keys, hi), n_keys)
        lens = (e - s).astype(jnp.int64)
        offs = jnp.cumsum(lens)
        total = offs[-1]
        j = jnp.arange(max_out, dtype=jnp.int64)
        seg = jnp.minimum(
            jnp.searchsorted(offs, j, side="right"), offs.shape[0] - 1
        )
        base = offs[seg] - lens[seg]
        row = s[seg].astype(jnp.int64) + (j - base)
        row = jnp.where(j < total, row, jnp.int64(-1))
        return row, total

    fwd_rows, fwd_total = range_rows(part_keys)
    rc_pos, rc_total = range_rows(rc_sorted)
    rc_rows = jnp.where(
        rc_pos >= 0,
        rc_order[jnp.maximum(rc_pos, 0)].astype(jnp.int64),
        jnp.int64(-1),
    )
    # forward precedence: a dual-orientation row reports forward only
    big = jnp.int64(0x7FFF_FFFF_FFFF_FFFF)
    fwd_sorted = jnp.sort(jnp.where(fwd_rows >= 0, fwd_rows, big))
    idx = jnp.minimum(jnp.searchsorted(fwd_sorted, rc_rows), max_out - 1)
    dup = (fwd_sorted[idx] == rc_rows) & (rc_rows >= 0)
    rc_rows = jnp.where(dup, jnp.int64(-1), rc_rows)

    safe_f = jnp.maximum(fwd_rows, 0)
    safe_r = jnp.maximum(rc_rows, 0)
    k_f = part_keys[safe_f]
    k_r = _revcomp_kernel(part_keys[safe_r], k)
    kmers = jnp.concatenate([
        jnp.where(fwd_rows >= 0, k_f, jnp.uint64(EMPTY)),
        jnp.where(rc_rows >= 0, k_r, jnp.uint64(EMPTY)),
    ])
    counts = jnp.concatenate([
        jnp.where(fwd_rows >= 0, part_counts[safe_f], jnp.uint32(0)),
        jnp.where(rc_rows >= 0, part_counts[safe_r], jnp.uint32(0)),
    ])
    return kmers, counts, jnp.stack([fwd_total, rc_total])


@functools.partial(jax.jit, static_argnames=("k", "max_out"))
def _panel_scan_kernel(part_keys, part_counts, rc_sorted, rc_order,
                       n_keys, oligos, shifts, req_ids, k: int,
                       max_out: int):
    """EVERY primer scan of a panel over one partition in ONE dispatch.

    The per-request formulation (_fused_scan_kernel) costs one
    dispatch + ~4 host transfers per (gene, primer, mismatch level) —
    ~40 requests per panel. Here the whole panel's requests are
    concatenated into one oligo array with per-oligo shifts and request
    tags, producing FOUR fetched arrays total.

    ``oligos`` [N] u64: concatenated per-request sorted oligo arrays;
    ``shifts`` [N] u64: 2*(k - olen) per oligo (olen may differ across
    requests); ``req_ids`` [N] i32: owning request, -1 for padding.
    Per-request semantics are preserved exactly: forward prefix hits
    report the table k-mer, reverse-strand hits report revcomp, and a
    row hit both ways WITHIN THE SAME REQUEST reports forward only.

    Returns (kmers [2*max_out], counts [2*max_out], reqs [2*max_out]
    i32 with -1 for dead slots, totals [2] i64 true fwd/rc match
    grand totals for overflow detection).
    """
    valid = req_ids >= 0
    one = jnp.uint64(1)
    lo = jnp.where(valid, oligos << shifts, jnp.uint64(0))
    hi = jnp.where(valid, (oligos + one) << shifts, jnp.uint64(0))

    def ranges(sorted_keys):
        s = jnp.minimum(jnp.searchsorted(sorted_keys, lo), n_keys)
        e = jnp.minimum(jnp.searchsorted(sorted_keys, hi), n_keys)
        e = jnp.where(valid, e, s)
        lens = (e - s).astype(jnp.int64)
        offs = jnp.cumsum(lens)
        total = offs[-1]
        j = jnp.arange(max_out, dtype=jnp.int64)
        seg = jnp.minimum(
            jnp.searchsorted(offs, j, side="right"), offs.shape[0] - 1
        )
        base = offs[seg] - lens[seg]
        row = s[seg].astype(jnp.int64) + (j - base)
        ok = j < total
        row = jnp.where(ok, row, jnp.int64(-1))
        req = jnp.where(ok, req_ids[seg], jnp.int32(-1))
        return row, req, total

    fwd_rows, fwd_req, fwd_total = ranges(part_keys)
    rc_pos, rc_req, rc_total = ranges(rc_sorted)
    rc_rows = jnp.where(
        rc_pos >= 0,
        rc_order[jnp.maximum(rc_pos, 0)].astype(jnp.int64),
        jnp.int64(-1),
    )
    # forward precedence per request: pack (req, row) into one i64 key
    big = jnp.int64(0x7FFF_FFFF_FFFF_FFFF)
    fwd_pk = jnp.where(
        fwd_rows >= 0,
        (fwd_req.astype(jnp.int64) << 40) | fwd_rows, big,
    )
    rc_pk = (rc_req.astype(jnp.int64) << 40) | jnp.maximum(rc_rows, 0)
    fwd_sorted = jnp.sort(fwd_pk)
    idx = jnp.minimum(jnp.searchsorted(fwd_sorted, rc_pk), max_out - 1)
    dup = (fwd_sorted[idx] == rc_pk) & (rc_rows >= 0)
    rc_rows = jnp.where(dup, jnp.int64(-1), rc_rows)
    rc_req = jnp.where(dup, jnp.int32(-1), rc_req)

    safe_f = jnp.maximum(fwd_rows, 0)
    safe_r = jnp.maximum(rc_rows, 0)
    k_f = part_keys[safe_f]
    k_r = _revcomp_kernel(part_keys[safe_r], k)
    kmers = jnp.concatenate([
        jnp.where(fwd_rows >= 0, k_f, jnp.uint64(EMPTY)),
        jnp.where(rc_rows >= 0, k_r, jnp.uint64(EMPTY)),
    ])
    counts = jnp.concatenate([
        jnp.where(fwd_rows >= 0, part_counts[safe_f], jnp.uint32(0)),
        jnp.where(rc_rows >= 0, part_counts[safe_r], jnp.uint32(0)),
    ])
    reqs = jnp.concatenate([fwd_req, rc_req])
    return kmers, counts, reqs, jnp.stack([fwd_total, rc_total])


def range_scan_part(part_keys, part_counts, rc_sorted, rc_order, n: int,
                    oligos: np.ndarray, oligo_len: int, k: int,
                    max_out: int = 1 << 12):
    """One partition's primer matches via sorted range queries.

    Semantics match the full-sweep scan (_prefix_scan_sorted_kernel /
    primers.rs:163-226): forward prefix hits report the table k-mer;
    reverse-strand hits (k-mer ends with rc(oligo), i.e. revcomp starts
    with the oligo) report revcomp(k-mer); a dual-orientation row
    reports the forward form only. Count filtering is the caller's.

    Returns (kmers u64, counts u32) for all matched rows.
    """
    shift = 2 * (k - oligo_len)
    pad_val = np.uint64(1) << np.uint64(2 * oligo_len)  # above all oligos
    width = max(64, 1 << max(len(oligos) - 1, 0).bit_length())
    padded = np.full(width, pad_val, np.uint64)
    padded[: len(oligos)] = np.sort(np.asarray(oligos, np.uint64))
    oligos_j = jnp.asarray(padded)

    while True:
        kmers, counts, totals = _fused_scan_kernel(
            part_keys, part_counts, rc_sorted, rc_order, jnp.int64(n),
            oligos_j, shift, k, max_out,
        )
        for a in (totals, kmers, counts):
            a.copy_to_host_async()  # overlap: one link round trip
        tot = np.asarray(totals)
        if int(tot.max()) <= max_out:
            break
        max_out = 1 << (int(tot.max()) - 1).bit_length()

    kh = np.asarray(kmers)
    ch = np.asarray(counts)
    # count-0 rows are ghost duplicates of a live key
    live = (kh != EMPTY) & (ch > 0)
    return kh[live], ch[live]


# -- reachability closure ------------------------------------------------------


def closure_log_w(depth: int, f_cap: int) -> int:
    """Log width: one f_cap block per level, depth levels + the root
    block + up to 3 ghost levels from the narrow phase's 4x unroll."""
    return (depth + 4) * f_cap


def _closure_run(lookup, c0, k: int, depth: int, f_cap: int,
                 f_narrow: int, n_words: int, pre=None):
    """The closure state machine, shared by the single-chip and the
    mesh-sharded reach kernels. ``lookup(cand) -> global row id | INF``
    is the only backend-specific piece (partition-loop probes on one
    chip; shard-local probes + a pmin combine on a mesh — every other
    state tensor is replicated and deterministic across shards).

    The expansion runs in TWO phases: a wide loop at ``f_cap`` while
    the frontier is larger than ``f_narrow`` (the root level seeds up
    to hundreds of primer-variant walkers), then a narrow loop at
    ``f_narrow``. Per-level cost is dominated by scattered gathers and
    scales with candidate width, but after the seed cluster collapses
    a walk carries only a handful of live walkers — the narrow phase
    is ~f_cap/f_narrow cheaper per level and covers almost all levels.

    ``pre`` (optional, EMPTY-padded unique canonical keys) warm-starts
    the visited bitmap: a re-prefetching session passes the closed
    interior of its cache (everything except the previous closure's
    cutoff frontier and the new roots) so the new closure explores
    only territory the walk has not already been served — without it a
    mid-walk re-prefetch re-expands backward over the covered region.
    Safe because every interior cache row already has ALL its
    above-threshold neighbours in the cache (only the cutoff
    frontier's neighbours were unexplored), so pre-marked rows cannot
    sit on any path from the roots to uncovered rows.

    Returns (log [(depth+4)*f_cap] global row ids INF-padded in BFS
    level blocks (closure_log_w: +4 blocks cover the narrow phase's
    4x-unroll ghost levels), boundary [<= f_cap] frontier kmers at
    loop exit (EMPTY-padded; non-empty only when depth was exhausted),
    n_visited, iters, overflow, done). ``depth`` is a floor-accurate
    but not strict cap: the narrow phase can overshoot by up to 3
    levels (one 4x-unrolled body), so callers must not treat
    iters <= depth as an invariant.
    """
    kmask = jnp.uint64((1 << (2 * k)) - 1)
    log_w = closure_log_w(depth, f_cap)
    inf = jnp.int32(_INF32)

    def expand(frontier):
        f = frontier[:, None]
        b = jnp.arange(4, dtype=jnp.uint64)[None, :]
        fwd = ((f << jnp.uint64(2)) | b) & kmask
        rev = (b << jnp.uint64(2 * (k - 1))) | (f >> jnp.uint64(2))
        cand = jnp.concatenate([fwd, rev], axis=1).reshape(-1)
        live = jnp.repeat(frontier != jnp.uint64(EMPTY), 8)
        return jnp.where(live, cand, jnp.uint64(EMPTY))

    def canon(c):
        rc = _revcomp_kernel(c, k)
        return jnp.where(c == jnp.uint64(EMPTY), jnp.uint64(EMPTY),
                         jnp.minimum(c, rc))

    def mark(bitmap, ids):
        """Set the bitmap bits of ``ids`` (unique, INF-padded). The
        scatter-ADD is exact OR here: ids are unique within the call
        and pre-filtered to unset bits, so each (word, bit) is added at
        most once ever. INF indices land past n_words and drop."""
        w = (ids >> 5).astype(jnp.int32)
        bit = jnp.uint32(1) << (ids & 31).astype(jnp.uint32)
        bit = jnp.where(ids != inf, bit, jnp.uint32(0))
        return bitmap.at[w].add(bit, mode="drop")

    def process(cand, bitmap, width: int):
        """First-visit hits among ``cand``: in-table, count >= floor,
        bit not yet set, unique within the call. Returns (frontier
        kmers [width], their ids [width] INF-padded-sorted, n_new,
        overflow: more new rows than the frontier can carry)."""
        cc = canon(cand)
        ids = lookup(cc)
        w = jnp.minimum((ids >> 5).astype(jnp.int32), n_words - 1)
        seen = (bitmap[w] >> (ids & 31).astype(jnp.uint32)) & 1
        ids = jnp.where((seen == 1) | (ids == inf), inf, ids)
        order = jnp.argsort(ids)
        ids_s = ids[order]
        km_s = cc[order]
        first = jnp.concatenate(
            [jnp.ones((1,), bool), ids_s[1:] != ids_s[:-1]]
        )
        ids_s = jnp.where(first, ids_s, inf)
        km_s = jnp.where(first & (ids_s != inf), km_s, jnp.uint64(EMPTY))
        n_all = jnp.sum(ids_s != inf).astype(jnp.int32)
        order2 = jnp.argsort(ids_s)
        ids_f = ids_s[order2][:width]
        km_f = km_s[order2][:width]
        if ids_f.shape[0] < width:
            # the root-level call can be narrower than the frontier
            # when a grow-retry raises f_cap past the fixed c0 width:
            # pad so every loop carry keeps the frontier shape
            pad = width - ids_f.shape[0]
            ids_f = jnp.concatenate([ids_f, jnp.full((pad,), inf)])
            km_f = jnp.concatenate(
                [km_f, jnp.full((pad,), jnp.uint64(EMPTY))]
            )
        n_new = jnp.sum(ids_f != inf).astype(jnp.int32)
        return km_f, ids_f, n_new, n_all > n_new

    def make_body(width: int):
        def body(state):
            frontier, bitmap, log, n_vis, it, overflow, _ = state
            cand = expand(frontier)
            km, ids, n_new, ov = process(cand, bitmap, width)
            bitmap = mark(bitmap, ids)
            # log blocks are addressed in f_cap strides regardless of
            # phase width (the narrow block's tail stays INF)
            log = jax.lax.dynamic_update_slice(log, ids, (it * f_cap,))
            done = n_new == 0
            return (km, bitmap, log, n_vis + n_new, it + 1,
                    overflow | ov, done)
        return body

    def cond_wide(state):
        frontier, _, _, _n_vis, it, overflow, done = state
        # keep the wide loop only while the frontier would overflow the
        # narrow width; iteration 0 (the roots) ran before the loop, so
        # body entries at it = 1..depth perform exactly `depth` levels
        n_live = jnp.sum(frontier != jnp.uint64(EMPTY))
        return (
            (~done) & (it <= depth) & (~overflow) & (n_live > f_narrow)
        )

    def cond_narrow(state):
        _, _, _, _n_vis, it, overflow, done = state
        return (~done) & (it <= depth) & (~overflow)

    bitmap0 = jnp.zeros((n_words,), jnp.uint32)
    if pre is not None:
        # unique keys -> unique rows; empty bitmap: the scatter-add OR
        # stays exact. Rows below the threshold probe to INF and drop.
        bitmap0 = mark(bitmap0, lookup(pre))
    log0 = jnp.full((log_w,), inf)
    km0, ids0, n0, ov0 = process(c0, bitmap0, f_cap)
    bitmap0 = mark(bitmap0, ids0)
    log0 = jax.lax.dynamic_update_slice(log0, ids0, (jnp.int32(0),))

    state = (km0, bitmap0, log0, n0, jnp.int32(1), ov0, n0 == 0)
    if f_narrow < f_cap:
        state = jax.lax.while_loop(cond_wide, make_body(f_cap), state)
        frontier, bitmap, log, n_vis, it, overflow, done = state
        # hand the (now <= f_narrow live walkers, sorted to the front)
        # frontier to the narrow loop; the sliced-off tail is non-EMPTY
        # only when the wide loop exited on depth/overflow, in which
        # case it belongs to the boundary
        wide_tail = frontier[f_narrow:]
        state = (frontier[:f_narrow], bitmap, log, n_vis, it, overflow,
                 done)
        # narrow-phase body unrolled 4x per while iteration: each
        # while iteration pays a fixed loop overhead (the predicate
        # round trip), and running the body on an already-done state
        # is a harmless no-op (empty frontier expands to empty
        # candidates), so the only cost is up to 3 ghost levels of `it`
        # accounting
        body_n = make_body(f_narrow)

        def body_n4(state):
            return body_n(body_n(body_n(body_n(state))))

        state = jax.lax.while_loop(cond_narrow, body_n4, state)
        boundary = jnp.concatenate([state[0], wide_tail])
    else:
        state = jax.lax.while_loop(cond_narrow, make_body(f_cap), state)
        boundary = state[0]
    (_, _, log, n_vis, it, overflow, done) = state
    return log, boundary, n_vis, it, overflow, done


def _pack_scalars(n_vis, it, overflow, done):
    """Scalars packed into ONE small array: one host sync per call
    instead of four separate int()/bool() reads."""
    return jnp.stack([
        n_vis.astype(jnp.int64),
        it.astype(jnp.int64),
        overflow.astype(jnp.int64),
        done.astype(jnp.int64),
    ])


# Static width of the closure result prefix gathered in-kernel; larger
# visited sets (rare) spill to one extra _spill_gather_kernel call.
OUT_W = 1 << 14


def _gather_rows(keys1d, counts1d, bases, ids):
    """(keys, counts) of global row ``ids`` (INF-padded, any order)
    from the partitions' ORIGINAL 1D sorted planes (flat gathers — no
    2D copies needed). EMPTY/0 where id is INF."""
    live = ids != _INF32
    out_keys = jnp.full(ids.shape, jnp.uint64(EMPTY))
    out_counts = jnp.zeros(ids.shape, jnp.uint32)
    for k1d, c1d, base in zip(keys1d, counts1d, bases):
        n_rows = k1d.shape[0]
        local = (ids - jnp.int32(base)).astype(jnp.int64)
        mine = live & (local >= 0) & (local < n_rows)
        safe = jnp.where(mine, local, 0)
        out_keys = jnp.where(mine, k1d[safe], out_keys)
        out_counts = jnp.where(mine, c1d[safe], out_counts)
    return out_keys, out_counts


@functools.partial(
    jax.jit,
    static_argnames=("width", "bases"),
)
def _spill_gather_kernel(keys1d, counts1d, bases, log_sorted,
                         width: int):
    """Wider gather for the rare closure whose visited set exceeds
    OUT_W: re-gathers the first ``width`` compacted ids."""
    ids = jax.lax.slice(log_sorted, (0,), (width,))
    return _gather_rows(keys1d, counts1d, bases, ids)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "depth", "f_cap", "f_narrow", "n_words", "bases", "packed",
        "probe_w",
    ),
)
def _reach_kernel(keys2d, counts2d, keys1d, counts1d, luts, shifts, c0,
                  min_count,
                  k: int, depth: int, f_cap: int, f_narrow: int,
                  n_words: int, bases: tuple, packed: bool,
                  probe_w: int = 2, pre=None):
    """Depth-capped 8-neighbour closure over the partitioned table.

    Probe structure: keys2d (count-packed blocks when ``packed``, raw
    key blocks + counts2d otherwise). keys1d/counts1d:
    the partitions' original 1D planes for the epilogue gathers.
    shifts: per-partition LUT shifts; bases: per-partition global
    row-id offsets. c0: the host wave's candidate k-mers, EMPTY-padded.
    ``n_words``: visited-bitmap width (total padded rows / 32). See
    ``_closure_run`` for the state machine.

    Returns (visited_keys, visited_counts [OUT_W], boundary kmers,
    scalars, log_sorted) — the append-log of first-visit rows compacted
    ascending, truncated to the static OUT_W prefix (log_sorted lets
    the driver re-gather wider on the rare n_vis > OUT_W call), plus
    the cutoff frontier (see _closure_run).
    """
    kmask = jnp.uint64((1 << (2 * k)) - 1)
    inf = jnp.int32(_INF32)
    k2ds, c2ds = keys2d, counts2d

    def lookup(cand):
        """(global row id | INF) per candidate k-mer. One fixed
        ``probe_w``-block window per candidate: build_sidecar records
        the window that covers each partition's max bucket occupancy
        (no widen retries in the loop)."""
        ids = jnp.full(cand.shape, inf)
        for k2d, c2d, lut, shift, base in zip(
            k2ds, c2ds, luts, shifts, bases
        ):
            b = jnp.minimum(
                cand >> jnp.uint64(shift),
                jnp.uint64(lut.shape[0] - 2),
            ).astype(jnp.int64)
            s = lut[b]
            e = lut[b + 1]
            j0 = (s >> _LOG2B).astype(jnp.int64)
            live = (cand != jnp.uint64(EMPTY)) & (e > s)
            jb = jnp.minimum(j0, k2d.shape[0] - 1)
            jbs = [
                jnp.minimum(j0 + w, k2d.shape[0] - 1)
                for w in range(probe_w)
            ]
            blk = jnp.concatenate([k2d[j] for j in jbs], axis=-1)
            rows = (jb * BLOCK)[:, None] + jnp.arange(
                probe_w * BLOCK, dtype=jnp.int64
            )[None, :]
            valid = (rows >= s[:, None]) & (rows < e[:, None])
            if packed:
                key_eq = (blk & kmask) == cand[:, None]
                above = (blk >> jnp.uint64(2 * k)) >= min_count
                hit = valid & key_eq & above & live[:, None]
            else:
                cblk = jnp.concatenate([c2d[j] for j in jbs], axis=-1)
                hit = (
                    valid & (blk == cand[:, None]) & live[:, None]
                    & (cblk >= min_count)
                )
            row = jnp.max(jnp.where(hit, rows, -1), axis=-1)
            mine = row >= 0
            ids = jnp.where(
                mine, row.astype(jnp.int32) + jnp.int32(base), ids
            )
        return ids

    log_w = closure_log_w(depth, f_cap)
    log, boundary, n_vis, it, overflow, done = _closure_run(
        lookup, c0, k, depth, f_cap, f_narrow, n_words, pre=pre
    )

    # compact the id log FIRST (one i32 sort: INF padding to the end,
    # real ids ascending == keys ascending, since global row ids follow
    # partition key order), then gather only a small static prefix.
    # Gathering the full log costs 2*log_w scattered reads for
    # closures that typically visit only a few thousand rows;
    # n_vis > OUT_W spills to a separate wider gather call (rare — the
    # driver handles it).
    log_sorted = jax.lax.sort(log, is_stable=False)
    out_w = min(OUT_W, log_w)
    ids_out = jax.lax.slice(log_sorted, (0,), (out_w,))
    out_keys, out_counts = _gather_rows(
        keys1d, counts1d, bases, ids_out
    )
    scalars = _pack_scalars(n_vis, it, overflow, done)
    return out_keys, out_counts, boundary, scalars, log_sorted


@functools.partial(jax.jit, static_argnames=("width",))
def _prefix_kernel(arr, width: int):
    return jax.lax.slice(arr, (0,), (width,))


@dataclass
class ReachResult:
    keys: np.ndarray      # visited row keys, ascending
    counts: np.ndarray
    complete: bool        # frontier emptied: closure fully explored
    iters: int
    # cutoff-frontier keys when the depth cap was hit (empty when
    # complete): the caller must NOT treat these as closed interior
    # when warm-starting a later closure
    boundary: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.boundary is None:
            self.boundary = np.zeros(0, np.uint64)

# pre (warm-start) arrays are padded to this fixed width: one extra
# compiled kernel variant, and truncating the closed interior to it is
# always safe (fewer pre-marked rows just means more re-exploration)
PRE_W = 4096


def _pad_pre(pre, roots=None) -> np.ndarray | None:
    """Pad warm-start keys to PRE_W. Deduplicates (mark()'s scatter-add
    is exact-OR only for unique ids, so uniqueness is enforced at this
    API boundary, not assumed of callers). When truncation is needed,
    keys NEAREST the new roots are kept: the walk re-expands outward
    from the roots, so pre-marked territory far from them buys nothing,
    while the first PRE_W keys in sorted order are uncorrelated with
    the walk's neighbourhood and would degrade the warm start to a
    near-no-op once the cache exceeds PRE_W keys."""
    if pre is None:
        return None
    pre = np.unique(np.asarray(pre, np.uint64).reshape(-1))
    pre = pre[pre != EMPTY]
    if len(pre) == 0:
        return None
    if len(pre) > PRE_W and roots is not None and len(roots):
        # keep the PRE_W keys closest (in sorted-key rank) to any root:
        # expand a window around each root's insertion point until the
        # combined coverage reaches PRE_W
        ins = np.searchsorted(pre, np.asarray(roots, np.uint64))
        half = max(PRE_W // (2 * len(ins)), 1)
        idx = np.unique(
            np.clip(
                ins[:, None] + np.arange(-half, half)[None, :],
                0, len(pre) - 1,
            )
        )
        while len(idx) < PRE_W and len(idx) < len(pre):
            half *= 2
            idx = np.unique(
                np.clip(
                    ins[:, None] + np.arange(-half, half)[None, :],
                    0, len(pre) - 1,
                )
            )
        pre = pre[idx[:PRE_W]]
    out = np.full(PRE_W, EMPTY, np.uint64)
    out[: min(len(pre), PRE_W)] = pre[:PRE_W]
    return out


def _drive_closure(run_kernel, roots: np.ndarray, depth: int,
                   f_cap: int = F_CAP,
                   max_retries: int = 4,
                   spill_gather=None) -> ReachResult | None:
    """Shared host driver for closure kernels with grow-and-retry.

    ``run_kernel(c0, f_cap, f_narrow) -> (keys, counts, boundary,
    scalars[, log_sorted])`` is the backend hook: the single-chip
    partition kernel or the mesh-sharded kernel
    (parallel/sharded_reach.py). ``roots``: candidate k-mers of the
    current host wave (directional; canonicalized on device).
    ``spill_gather(log_sorted, width) -> (keys, counts)`` re-gathers a
    wider result prefix when n_vis exceeds the kernel's static OUT_W
    (only backends returning log_sorted support it). Returns None when
    the closure overflowed even at the largest retry shapes (the
    caller falls back to exact but slow per-wave device lookups).
    """
    roots = np.unique(np.asarray(roots, dtype=np.uint64).reshape(-1))
    roots = roots[roots != EMPTY]
    if len(roots) == 0:
        return ReachResult(
            np.zeros(0, np.uint64), np.zeros(0, np.uint32), True, 0
        )
    out_k: list[np.ndarray] = []
    out_c: list[np.ndarray] = []
    out_b: list[np.ndarray] = []
    complete = True
    iters = 0
    # start wide enough that the root wave's own hits fit the frontier
    # (iteration 0 can yield up to len(roots) new rows); stay on the
    # quantized shape ladder — every f_cap is a separate XLA compile
    while f_cap < min(len(roots), 4096):
        f_cap *= F_GROW
    c_cap = 8 * f_cap
    for start in range(0, len(roots), c_cap):
        chunk = roots[start : start + c_cap]
        c0 = np.full(c_cap, EMPTY, np.uint64)
        c0[: len(chunk)] = chunk
        cur_f, cur_n = f_cap, F_NARROW
        t_call = time.perf_counter()
        for attempt in range(max_retries + 1):
            out = run_kernel(jnp.asarray(c0), cur_f, min(cur_n, cur_f))
            keys, counts, boundary, scalars = out[:4]
            log_sorted = out[4] if len(out) > 4 else None
            sc = np.asarray(scalars)  # the call's ONE device sync
            n_vis, it = int(sc[0]), int(sc[1])
            overflow, done = bool(sc[2]), bool(sc[3])
            if not overflow:
                break
            if attempt == max_retries:
                return None
            # an overflow can come from either phase: grow both widths
            # (shapes stay on the quantized ladder)
            cur_f *= F_GROW
            cur_n *= F_GROW
        if n_vis > int(keys.shape[0]):
            if spill_gather is None or log_sorted is None:
                # kernel returned the full log (sharded backend) but
                # the visited set somehow exceeds it: impossible by
                # construction; guard anyway
                n_vis = int(keys.shape[0])
            else:
                # rare: visited set exceeds the kernel's static OUT_W
                # prefix — one wider gather over the compacted id log
                w = 1 << max(n_vis - 1, 0).bit_length()
                w = min(w, int(log_sorted.shape[0]))
                keys, counts = spill_gather(log_sorted, w)
        if n_vis:
            if int(keys.shape[0]) <= OUT_W:
                # the result arrays are already the small static OUT_W
                # prefix: fetch them whole rather than compile one
                # _prefix_kernel per pow2(n_vis) width.
                pk, pc = keys, counts
            else:
                # full-log-width backends (mesh-sharded kernel):
                # slice before fetching
                w = min(
                    int(keys.shape[0]),
                    1 << max(n_vis - 1, 0).bit_length(),
                )
                pk = _prefix_kernel(keys, w)
                pc = _prefix_kernel(counts, w)
            pk.copy_to_host_async()
            pc.copy_to_host_async()
            out_k.append(np.asarray(pk)[:n_vis])
            out_c.append(np.asarray(pc)[:n_vis])
        else:
            out_k.append(np.zeros(0, np.uint64))
            out_c.append(np.zeros(0, np.uint32))
        complete = complete and done
        if not done:
            bh = np.asarray(boundary)
            out_b.append(bh[bh != EMPTY])
        iters += it
        call_wall = time.perf_counter() - t_call
        phases.add("closures", call_wall)
        phases.add("closure_levels", 0.0, calls=it)
        log.debug(
            "reach: %d roots, %d iters, %d visited, f_cap %d, "
            "done=%s, %.3fs",
            len(chunk), it, n_vis, cur_f, done, call_wall,
        )

    keys = np.concatenate(out_k)
    counts = np.concatenate(out_c)
    order = np.argsort(keys)
    keys, counts = keys[order], counts[order]
    if len(out_k) > 1 and len(keys):
        keep = np.concatenate([[True], keys[1:] != keys[:-1]])
        keys, counts = keys[keep], counts[keep]
    bound = (
        np.unique(np.concatenate(out_b)) if out_b
        else np.zeros(0, np.uint64)
    )
    return ReachResult(keys, counts, complete, iters, bound)


def reach(sidecars: list[PartSidecar], bases: tuple, roots: np.ndarray,
          min_count: int, k: int, depth: int = DEPTH, f_cap: int = F_CAP,
          max_retries: int = 4, pre=None) -> ReachResult | None:
    """Single-chip reach: partition-tuple kernel + the shared driver."""
    pre_j = _pad_pre(pre, roots=roots)
    pre_j = jnp.asarray(pre_j) if pre_j is not None else None
    # packed probes carry a saturating count in the key's spare bits;
    # exact iff the threshold fits below the saturation cap
    below_cap = min_count < (1 << (64 - 2 * k)) - 1
    packed = below_cap and all(s.packed2d is not None for s in sidecars)
    keys2d = tuple((s.packed2d if packed else s.keys2d) for s in sidecars)
    counts2d = tuple(s.counts2d for s in sidecars)
    keys1d = tuple(s.keys1d for s in sidecars)
    counts1d = tuple(s.counts1d for s in sidecars)
    luts = tuple(s.lut for s in sidecars)
    shifts = tuple(
        jnp.asarray(s.shift, jnp.uint64) for s in sidecars
    )
    n_rows_total = sum(int(s.keys1d.shape[0]) for s in sidecars)
    n_words = max(64, -(-n_rows_total // 32))
    probe_w = max((s.probe_blocks for s in sidecars), default=2)

    def run_kernel(c0, cur_f, cur_n):
        return _reach_kernel(
            keys2d, counts2d, keys1d, counts1d, luts, shifts, c0,
            jnp.uint32(max(min_count, 1)), k, depth, cur_f, cur_n,
            n_words, bases, packed, probe_w=probe_w, pre=pre_j,
        )

    def spill_gather(log_sorted, width):
        return _spill_gather_kernel(
            keys1d, counts1d, bases, log_sorted, width
        )

    return _drive_closure(run_kernel, roots, depth, f_cap, max_retries,
                          spill_gather=spill_gather)
