"""Sorted-run k-mer count store — the default count backend.

Every insert into a hash table is a random device-memory gather or
scatter, and probe loops pay the full batch width every round. This
store is built from sorts and scans instead (the reasoning that leads
GPU k-mer counters to sort-based designs):

* **raw buffer**: encoded canonical k-mers are appended tile-by-tile
  into a preallocated device buffer (a donated dynamic_update_slice
  per tile — pure memory bandwidth, no sort, no sync). Ingest therefore
  costs ~nothing until the buffer fills.
* **drain (the workhorse)**: ONE fused kernel over the whole buffer:
  u64 key sort (is_stable=False: equal keys are interchangeable here)
  -> run-length encode (an int32 ``lax.cummax`` over run-start
  positions) -> compact survivors to the front with one unstable sort.
* **partitioned master**: the master is a list of disjoint key-range
  partitions, each a sorted sentinel-padded device array of exactly
  ``part_budget`` width. Drained runs are routed into partitions with
  one device ``searchsorted`` against the partition boundary keys and
  merged partition-locally (merge = concat + u64-scan aggregate, exact
  u32 saturation). Partitions split in half when they outgrow their
  budget. The drain width comes from the device table
  (``sharkmer_tpu.device``).
* **histogram**: per partition, sort the clipped counts and difference
  ``searchsorted`` positions at the bin edges, then sum partitions.
* **lookup**: vectorized binary search per partition (a key lives in
  exactly one partition, so per-partition results sum).
* **primer scan**: forward prefix matches and RC low-bit matches via
  ``searchsorted`` set-membership sweeps per partition.

The store keeps identical observable semantics to ops.hashtable
(canonical u64 keys, exact u32 saturating counts), asserted by
differential tests, and exposes the same API so the engine and the
sPCR layer are backend-agnostic.

Replaces the reference's ``KmerCounts`` CPU hash map
(src/kmer/counting.rs:113).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .. import device
from .encoding import KMER_SENTINEL, canonical_kmers
from .hashtable import _histogram_kernel, _revcomp_kernel

EMPTY = np.uint64(KMER_SENTINEL)

# Raw-buffer append granularity (elements). Appends dispatch one tiny
# donated update per tile; 2^18 keeps per-batch dispatch counts in the
# tens while wasting at most TILE-1 buffer slots per appended batch.
TILE = 1 << 18


def _default_max_agg() -> int:
    """Largest element count a single fused sort/aggregate kernel sees.

    This is ALSO the raw-buffer width, so it sets the drain cadence and
    the peak batch memory (8 bytes/element for the buffer plus sort
    workspace). ``SHARKMER_MAX_AGG`` overrides the device table (tests
    use it to force multi-partition paths at small sizes).
    """
    env = os.environ.get("SHARKMER_MAX_AGG")
    if env:
        return int(env)
    return device.settings().max_agg


def _next_pow2(n: int) -> int:
    """Power-of-two ELEMENT width; floored at 64 so tiny arrays stay on
    lane-aligned shapes."""
    return 1 << max(6, (int(n) - 1).bit_length())


def _next_pow2_count(n: int) -> int:
    """Unfloored power of two — for TILE counts and other quantities
    that are already coarse-grained (a 64-tile floor would turn a
    one-tile append into a 128 MB allocation)."""
    return 1 << max(0, (int(n) - 1).bit_length())


_ALLONES = jnp.uint64(0xFFFF_FFFF_FFFF_FFFF)


def _aggregate_impl(kmers, counts, count_bits: int = 0):
    """Sort (kmers, counts); sum counts of equal keys; compact unique
    keys (still sorted) to the front with sentinel padding behind.

    Returns (unique_kmers, totals, n_unique) — same width as the input.

    ``count_bits`` (= 64 - 2k when the caller knows k, else 0) enables
    packed single-key sorts in place of the two kv-sorts: when every
    count fits the low 64-2k bits and no real key is 2^2k-1 (a
    canonical k-mer never is — its revcomp would be 0), (key << cb) |
    count sorts by key with the count riding along as one u64 sort
    instead of a key-value sort. Each sort picks its path with a
    runtime ``lax.cond`` on those predicates, so results stay exact for
    ALL inputs (overflowing counts take the kv route).
    """
    packable = count_bits >= 20
    if packable:
        cb = jnp.uint64(count_bits)
        cap = jnp.uint64((1 << count_bits) - 1)
        key_cap = jnp.uint64((1 << (64 - count_bits)) - 1)
        occupied = kmers != jnp.uint64(EMPTY)

    def _sort_kv(_):
        k2, c2 = jax.lax.sort((kmers, counts), num_keys=1, is_stable=False)
        return k2, c2.astype(jnp.uint64)

    if packable:

        def _sort_packed(_):
            packed = jnp.where(
                occupied,
                (kmers << cb) | counts.astype(jnp.uint64),
                _ALLONES,
            )
            sp = jax.lax.sort(packed, is_stable=False)
            sent = sp == _ALLONES
            return (
                jnp.where(sent, jnp.uint64(EMPTY), sp >> cb),
                jnp.where(sent, jnp.uint64(0), sp & cap),
            )

        in_packable = (
            jnp.max(counts).astype(jnp.uint64) < cap
        ) & (jnp.max(jnp.where(occupied, kmers, jnp.uint64(0))) < key_cap)
        sk, sc = jax.lax.cond(in_packable, _sort_packed, _sort_kv, None)
    else:
        sk, sc = _sort_kv(None)

    first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    last = jnp.concatenate([sk[:-1] != sk[1:], jnp.ones((1,), bool)])
    incl = jnp.cumsum(sc)  # inclusive prefix of counts (u64: no overflow)
    excl = incl - sc
    # prefix total just before each run's start, broadcast down the run
    # (excl is monotone non-decreasing, so a running max of the
    # run-start values propagates each run's base down its run).
    # lax.cummax, NOT associative_scan: the generic scan's unrolled
    # slice/concat tree makes XLA compile time explode past ~2^20
    # elements, while the cumulative-reduce primitives stay flat.
    run_base = jax.lax.cummax(jnp.where(first, excl, jnp.uint64(0)))
    # exact u32 saturation (the u64 sum is exact, so this matches the
    # reference's saturating_add for ALL counts)
    run_total = jnp.minimum(incl - run_base, jnp.uint64(0xFFFF_FFFF))

    keep = last & (sk != jnp.uint64(EMPTY))
    n_unique = jnp.sum(keep, dtype=jnp.int64)

    def _compact_kv(_):
        out_k = jnp.where(keep, sk, jnp.uint64(EMPTY))
        out_c = jnp.where(keep, run_total, 0).astype(jnp.uint32)
        # compact: sentinels sort to the end; unique keys stay ascending
        return jax.lax.sort((out_k, out_c), num_keys=1, is_stable=False)

    if not packable:
        out_k, out_c = _compact_kv(None)
        return out_k, out_c, n_unique

    def _compact_packed(_):
        packed = jnp.where(keep, (sk << cb) | run_total, _ALLONES)
        sp = jax.lax.sort(packed, is_stable=False)
        sent = sp == _ALLONES
        out_k = jnp.where(sent, jnp.uint64(EMPTY), sp >> cb)
        out_c = jnp.where(sent, jnp.uint64(0), sp & cap).astype(jnp.uint32)
        return out_k, out_c

    out_packable = (
        jnp.max(jnp.where(keep, run_total, jnp.uint64(0))) < cap
    ) & (jnp.max(jnp.where(keep, sk, jnp.uint64(0))) < key_cap)
    out_k, out_c = jax.lax.cond(
        out_packable, _compact_packed, _compact_kv, None
    )
    return out_k, out_c, n_unique


_aggregate_kernel = functools.partial(
    jax.jit, donate_argnums=(0, 1), static_argnames=("count_bits",)
)(_aggregate_impl)


def _aggregate_ingest_impl(kmers, count_bits: int):
    """Fused drain of a raw k-mer buffer (every count implicitly 1).

    Cheaper than ``_aggregate_impl``: the first sort carries no values
    and the run totals are pure position arithmetic in int32 (a run's
    total is its length), so the only scan is an int32 cummax. Run
    totals are bounded by the buffer width (< 2^31), far below u32
    saturation.

    Compaction (unique keys to the front, sentinels behind): a k-mer
    uses only 2k key bits, so for small enough k (``count_bits`` =
    64-2k >= 20) key and run total pack into ONE u64 and the compaction
    runs as a single-key sort instead of a u64+u32 key-value sort. Only
    EMPTY packs to all-ones (a canonical k-mer is never 2^2k-1: its
    revcomp would be 0 and win canonicalization), so sentinels stay
    unambiguous. If any run total would saturate the packed field (a
    single k-mer filling >= 2^count_bits slots of the buffer — poly-A
    class repeats), a runtime ``lax.cond`` falls back to the exact
    kv-sort, keeping counts exact for ALL inputs.
    """
    n = kmers.shape[0]
    sk = jax.lax.sort(kmers, is_stable=False)  # sentinels sort to the end
    last = jnp.concatenate([sk[:-1] != sk[1:], jnp.ones((1,), bool)])
    pos = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, pos, 0))
    run_total = (pos - run_start + 1).astype(jnp.uint32)
    keep = last & (sk != jnp.uint64(EMPTY))
    n_unique = jnp.sum(keep, dtype=jnp.int64)

    def _compact_kv(_):
        out_k = jnp.where(keep, sk, jnp.uint64(EMPTY))
        out_c = jnp.where(keep, run_total, jnp.uint32(0))
        return jax.lax.sort((out_k, out_c), num_keys=1, is_stable=False)

    if count_bits < 20:
        out_k, out_c = _compact_kv(None)
        return out_k, out_c, n_unique

    shift = jnp.uint64(count_bits)
    cap = jnp.uint64((1 << count_bits) - 1)
    sentinel = jnp.uint64(0xFFFF_FFFF_FFFF_FFFF)

    def _compact_packed(_):
        packed = jnp.where(
            keep,
            (sk << shift) | run_total.astype(jnp.uint64),
            sentinel,
        )
        sp = jax.lax.sort(packed, is_stable=False)
        sent = sp == sentinel
        out_k = jnp.where(sent, jnp.uint64(EMPTY), sp >> shift)
        out_c = jnp.where(sent, jnp.uint32(0), (sp & cap).astype(jnp.uint32))
        return out_k, out_c

    max_total = jnp.max(jnp.where(keep, run_total, jnp.uint32(0)))
    out_k, out_c = jax.lax.cond(
        max_total.astype(jnp.uint64) < cap, _compact_packed, _compact_kv,
        None,
    )
    return out_k, out_c, n_unique


_aggregate_ingest_jit = functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("count_bits",),
)(_aggregate_ingest_impl)


def _aggregate_ingest_ghosted_impl(kmers):
    """Fresh-drain fast path: a sorted GHOSTED run, no compaction sort.

    A run that seeds an EMPTY master is never merged, and its only
    consumers tolerate ghost rows, so the compaction step (moving each
    run's survivor to the front) is skipped: keys stay the full sorted
    array (duplicate runs intact, EMPTY tail); counts carry each run's
    total at its FIRST row and 0 on the duplicates behind it ("ghost"
    rows — searchsorted-left lands on the live row; histograms, scans
    and the host export filter count 0; every merge collapses them).
    Totals are exact u32 at ANY multiplicity (run length < 2^31).

    Returns (keys, counts, n_padded, n_real): n_padded = occupied
    slots including ghosts, n_real = distinct keys.
    """
    n = kmers.shape[0]
    sk = jax.lax.sort(kmers, is_stable=False)
    pos = jnp.arange(n, dtype=jnp.int32)
    # run-first markers are a LOCAL predecessor compare; only the run
    # END positions need a scan (total = run_end - pos + 1 at firsts)
    first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    last = jnp.concatenate([sk[:-1] != sk[1:], jnp.ones((1,), bool)])
    run_last = jax.lax.cummin(
        jnp.where(last, pos, jnp.int32(0x7FFF_FFFF)), reverse=True
    )
    occupied = sk != jnp.uint64(EMPTY)
    total = (run_last - pos + 1).astype(jnp.uint32)
    counts = jnp.where(first & occupied, total, jnp.uint32(0))
    n_real = jnp.sum(first & occupied, dtype=jnp.int64)
    n_padded = jnp.sum(occupied, dtype=jnp.int64)
    return sk, counts, n_padded, n_real


_aggregate_ingest_ghosted_jit = functools.partial(
    jax.jit, donate_argnums=(0,)
)(_aggregate_ingest_ghosted_impl)


@functools.partial(jax.jit, static_argnames=("n_tiles",))
def _pad_tiles_kernel(kmers, n_tiles: int):
    """Flat k-mers -> [n_tiles, TILE], sentinel-padded at the tail."""
    pad = n_tiles * TILE - kmers.shape[0]
    if pad:
        kmers = jnp.concatenate(
            [kmers, jnp.full((pad,), jnp.uint64(EMPTY))]
        )
    return kmers.reshape(n_tiles, TILE)


@functools.partial(jax.jit, donate_argnums=(0,))
def _append_tiles_kernel(buf, tiles, t_start, t_end, offset):
    """Write tiles [t_start, t_end) of ``tiles`` into ``buf`` starting
    at ``offset``. ONE dispatch per appended batch: the tile loop runs
    on device (traced fori_loop bounds), the buffer is donated, and the
    loop-carried dynamic_update_slice is applied in place by XLA —
    per-tile host dispatches would pay a full-buffer copy each when the
    runtime cannot alias the donated buffer."""
    tile_w = tiles.shape[1]

    def body(t, buf):
        tile = jax.lax.dynamic_slice(
            tiles, (t, jnp.int32(0)), (1, tile_w)
        )[0]
        off = offset + (t - t_start) * jnp.int32(tile_w)
        return jax.lax.dynamic_update_slice(buf, tile, (off,))

    return jax.lax.fori_loop(t_start, t_end, body, buf)


@functools.partial(jax.jit, static_argnames=("width",))
def _pad_to_kernel(keys, counts, width: int):
    """Pad (keys, counts) to exactly `width` with sentinels/zeros."""
    pad = width - keys.shape[0]
    if pad <= 0:
        return keys[:width], counts[:width]
    return (
        jnp.concatenate([keys, jnp.full((pad,), jnp.uint64(EMPTY))]),
        jnp.concatenate([counts, jnp.zeros((pad,), jnp.uint32)]),
    )


@jax.jit
def _searchsorted_kernel(keys, bounds):
    return jnp.searchsorted(keys, bounds)


@jax.jit
def _ghost_run_end_kernel(keys, cut):
    """``cut``, unless it falls inside a run of equal keys (the ghost
    rows behind a live first row); then the index just past that run."""
    key = keys[cut]
    inside = key == keys[cut - 1]
    return jnp.where(
        inside, jnp.searchsorted(keys, key, side="right"), cut
    )


@functools.partial(jax.jit, static_argnames=("count_bits",))
def _merge_kernel(pk, pc, sk, sc, count_bits: int = 0):
    """Merge two sorted runs into one aggregated run (exact u32
    saturation via the u64-scan aggregate)."""
    return _aggregate_impl(
        jnp.concatenate([pk, sk]), jnp.concatenate([pc, sc]), count_bits
    )


@functools.partial(jax.jit, static_argnames=("out_width",))
def _slice_run_kernel(keys, counts, start, size, out_width: int):
    """Masked dynamic slice [start, start+size) padded to out_width.
    The inputs are pre-padded so the window can never clamp."""
    kpad = jnp.concatenate(
        [keys, jnp.full((out_width,), jnp.uint64(EMPTY))]
    )
    cpad = jnp.concatenate([counts, jnp.zeros((out_width,), jnp.uint32)])
    k = jax.lax.dynamic_slice(kpad, (start,), (out_width,))
    c = jax.lax.dynamic_slice(cpad, (start,), (out_width,))
    pos = jnp.arange(out_width)
    k = jnp.where(pos < size, k, jnp.uint64(EMPTY))
    c = jnp.where(pos < size, c, 0)
    return k, c


@jax.jit
def _lookup_sorted_kernel(kmers, counts, n, queries):
    """Binary-search lookups against one sorted partition."""
    idx = jnp.searchsorted(kmers, queries)
    idx = jnp.minimum(idx, kmers.shape[0] - 1)
    hit = (kmers[idx] == queries) & (idx < n) & (queries != jnp.uint64(EMPTY))
    return jnp.where(hit, counts[idx], 0).astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("k",))
def _lookup_directional_sorted_kernel(kmers, counts, n, queries, k: int):
    rc = _revcomp_kernel(queries, k)
    canon = jnp.minimum(queries, rc)
    return _lookup_sorted_kernel(kmers, counts, n, canon)


@functools.partial(jax.jit, static_argnames=("shift", "rc_mask_bits", "max_out"))
def _prefix_scan_sorted_kernel(
    kmers, counts, rc_table, oligos_sorted, rc_oligos_sorted,
    shift: int, rc_mask_bits: int, max_out: int, min_count,
):
    """Primer scan over one partition (same semantics as the hashtable
    version: forward prefix match first, else RC low-bits match
    reported revcomp-normalized)."""
    occupied = (kmers != jnp.uint64(EMPTY)) & (counts >= min_count)

    def member(sorted_set, values):
        if sorted_set.shape[0] == 0:
            return jnp.zeros(values.shape, bool)
        idx = jnp.searchsorted(sorted_set, values)
        idx = jnp.minimum(idx, sorted_set.shape[0] - 1)
        return sorted_set[idx] == values

    prefix = kmers >> jnp.uint64(shift)
    fwd_hit = occupied & member(oligos_sorted, prefix)
    low = kmers & jnp.uint64((1 << rc_mask_bits) - 1)
    rc_hit = occupied & ~fwd_hit & member(rc_oligos_sorted, low)
    hit = fwd_hit | rc_hit
    out_kmer = jnp.where(rc_hit, rc_table, kmers)
    idx = jnp.nonzero(hit, size=max_out, fill_value=kmers.shape[0] - 1)[0]
    return out_kmer[idx], counts[idx], jnp.sum(hit)


# -- compressed host export ---------------------------------------------------

ESC_MAX = 1 << 14  # escape-list width (structural key-delta overflows)
CESC_MAX = 1 << 18  # count-escape width (counts > 255 in the u8 wire)
CHUNK_GRAN = 1 << 20  # transfer-chunk granularity (elements)
EXPORT_CHUNK = 1 << 22  # streamed packed-export chunk (16 MB of u32)


def _escape_positions(flags, esc_max: int):
    """First esc_max flagged positions, ascending (i32 fill 2^31-1 for
    absent). Sort-based, so the compiled shape is fixed by ``esc_max``
    and no data-dependent compaction is needed."""
    n = flags.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    keys = jnp.where(flags, pos, jnp.int32(0x7FFF_FFFF))
    return jax.lax.sort(keys, is_stable=False)[:esc_max]


@functools.partial(jax.jit, static_argnames=("esc_max",))
def _export_encode_kernel(keys, counts, esc_max: int):
    """Delta/escape encoding of one sorted partition for transfer.

    Keys: u32 delta from the predecessor; position 0 and any delta
    > u32 escape to a (index, u64 value) side list. Counts: u16 with a
    (index, u32 value) side list for the rare > 65535 entries.
    """
    n = keys.shape[0]
    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint64), keys[:-1]])
    delta = keys - prev  # u64 wraparound in the sentinel tail is fine
    pos = jnp.arange(n)
    esc = (delta > jnp.uint64(0xFFFF_FFFF)) | (pos == 0)
    delta32 = jnp.where(esc, jnp.uint64(0), delta).astype(jnp.uint32)
    esc_idx = _escape_positions(esc, esc_max)
    esc_val = keys[jnp.minimum(esc_idx, n - 1)]
    cesc = counts > jnp.uint32(0xFFFF)
    counts16 = jnp.where(cesc, jnp.uint32(0), counts).astype(jnp.uint16)
    cesc_idx = _escape_positions(cesc, esc_max)
    cesc_val = counts[jnp.minimum(cesc_idx, n - 1)]
    return (
        delta32, counts16, esc_idx.astype(jnp.int64), esc_val,
        jnp.sum(esc), cesc_idx.astype(jnp.int64), cesc_val, jnp.sum(cesc),
    )


@functools.partial(jax.jit, static_argnames=("esc_max", "cesc_max"))
def _export_encode24_kernel(keys, counts, esc_max: int, cesc_max: int):
    """Tightest wire tier: (24-bit key delta) | (count << 24) packed
    into ONE u32 per key — 4 bytes/key on the host link instead of 6,
    and a SINGLE contiguous array, so the whole payload streams through
    one async transfer queue instead of one transfer per byte plane.

    At 20M uniques over a 2^42 keyspace the mean delta is ~17 bits, so
    24-bit overflows are vanishingly rare in dense tables; sparse
    tables fall back to the u32 tier. Counts get the wider escape list
    (``cesc_max``) because counts > 255 (repeat families) are far
    likelier than counts > 65535.
    """
    n = keys.shape[0]
    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint64), keys[:-1]])
    delta = keys - prev  # u64 wraparound in the sentinel tail is fine
    pos = jnp.arange(n)
    esc = (delta > jnp.uint64(0xFF_FFFF)) | (pos == 0)
    d = jnp.where(esc, jnp.uint64(0), delta).astype(jnp.uint32)
    esc_idx = _escape_positions(esc, esc_max)
    esc_val = keys[jnp.minimum(esc_idx, n - 1)]
    cesc = counts > jnp.uint32(0xFF)
    counts8 = jnp.where(cesc, jnp.uint32(0), counts)
    packed = d | (counts8 << jnp.uint32(24))
    cesc_idx = _escape_positions(cesc, cesc_max)
    cesc_val = counts[jnp.minimum(cesc_idx, n - 1)]
    return (
        packed, esc_idx, esc_val, jnp.sum(esc),
        cesc_idx, cesc_val, jnp.sum(cesc),
    )


@jax.jit
def _filter_compact_kernel(keys, counts, min_count):
    """Drop rows below ``min_count`` on device BEFORE export: kept rows
    stay sorted at the front, dropped rows become a zero-count sentinel
    tail. One unstable kv-sort shrinks the device->host payload — the
    sPCR mirror never needs sub-threshold rows (counts.py
    FilteredTable; counting.rs:316-350 semantics)."""
    keep = (counts >= min_count) & (keys != jnp.uint64(EMPTY))
    masked = jnp.where(keep, keys, jnp.uint64(EMPTY))
    sk, sc = jax.lax.sort((masked, counts), num_keys=1, is_stable=False)
    sc = jnp.where(sk == jnp.uint64(EMPTY), jnp.uint32(0), sc)
    return sk, sc, jnp.sum(keep)


@functools.partial(jax.jit, static_argnames=("width",))
def _slice1d_kernel(arr, start, width: int):
    return jax.lax.dynamic_slice(arr, (start,), (width,))


def _fetch_prefix(arr, n: int) -> np.ndarray:
    """arr[:n] on host, transferred as pow2-granular chunks so only the
    occupied prefix crosses the link and each slice width compiles
    once."""
    W = int(arr.shape[0])
    n = min(int(n), W)
    if n == 0:
        return np.asarray(arr[:0])
    if W <= 2 * CHUNK_GRAN:
        return np.asarray(arr)[:n]
    units = -(-n // CHUNK_GRAN)
    slices = []
    start = 0
    for b in reversed(range(units.bit_length())):
        if (units >> b) & 1:
            w = (1 << b) * CHUNK_GRAN
            slices.append(_slice1d_kernel(arr, start, w))
            start += w
    for s in slices:  # overlap transfers where the runtime allows
        s.copy_to_host_async()
    return np.concatenate([np.asarray(s) for s in slices])[:n]


def _stream_decode_packed(packed, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Decode the packed (24-bit delta | count<<24) plane while it is
    still crossing the link: async host copies for every EXPORT_CHUNK
    slice are issued up front, then each chunk is unpacked + prefix-
    summed as it lands, overlapping host decode with the wire time of
    the chunks behind it. Returns (delta prefix-sum, u8 counts) for
    the occupied prefix. Exact mod-2^64 like a monolithic cumsum."""
    W = int(packed.shape[0])
    n = min(int(n), W)
    if W <= EXPORT_CHUNK or W % EXPORT_CHUNK:
        slices = [packed]
    else:
        units = -(-n // EXPORT_CHUNK)
        slices = [
            _slice1d_kernel(packed, u * EXPORT_CHUNK, EXPORT_CHUNK)
            for u in range(units)
        ]
        for s in slices:
            s.copy_to_host_async()
    cum = np.empty(n, np.uint64)
    c8 = np.empty(n, np.uint32)
    pos = 0
    carry = np.uint64(0)
    for s in slices:
        host = np.asarray(s)
        take = min(host.shape[0], n - pos)
        if take <= 0:
            break
        sl = host[:take]
        d = (sl & np.uint32(0xFF_FFFF)).astype(np.uint64)
        if pos:
            d[0] += carry
        np.cumsum(d, out=cum[pos : pos + take])
        carry = cum[pos + take - 1]
        c8[pos : pos + take] = sl >> np.uint32(24)
        pos += take
    return cum, c8


def _decode_keys(cum: np.ndarray, esc_idx: np.ndarray,
                 esc_val: np.ndarray, n: int) -> np.ndarray:
    """Reconstruct absolute keys from the delta prefix-sum ``cum`` and
    the (index, absolute value) escape list:
    true[i] = esc_val[j] + (cum[i] - cum[esc_idx[j]]) within segment j
    (mod-2^64 arithmetic: exact)."""
    keep = esc_idx < n
    esc_idx, esc_val = esc_idx[keep], esc_val[keep]
    offsets = esc_val - cum[esc_idx]
    seg_lens = np.diff(np.append(esc_idx, n))
    return cum + np.repeat(offsets, seg_lens)


def _apply_count_escapes(base: np.ndarray, cesc_idx: np.ndarray,
                         cesc_val: np.ndarray, n: int) -> np.ndarray:
    out = base.astype(np.uint32)
    m = cesc_idx < n
    out[cesc_idx[m]] = cesc_val[m]
    return out


def _export_part(keys, counts, n: int,
                 min_count: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """One partition's occupied prefix as host numpy (keys, counts).

    ``min_count`` > 1 drops sub-threshold rows on device first (sPCR
    mirror exports), shrinking the payload before it crosses the host
    link. Wire tiers, widest-compatible first: 24-bit deltas + u8
    counts (4 B/key) -> u32 deltas + u16 counts (6 B/key) -> raw
    (12 B/key), falling back when a tier's escape lists overflow."""
    if n == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    if min_count > 1:
        keys, counts, kept = _filter_compact_kernel(
            keys, counts, jnp.uint32(min_count)
        )
        n = int(kept)
        if n == 0:
            return np.zeros(0, np.uint64), np.zeros(0, np.uint32)

    (packed, esc_idx, esc_val, n_esc,
     cesc_idx, cesc_val, n_cesc) = _export_encode24_kernel(
        keys, counts, ESC_MAX, CESC_MAX
    )
    if int(n_esc) <= ESC_MAX and int(n_cesc) <= CESC_MAX:
        cum, c8 = _stream_decode_packed(packed, n)
        out_keys = _decode_keys(
            cum,
            np.asarray(esc_idx)[: int(n_esc)].astype(np.int64),
            np.asarray(esc_val)[: int(n_esc)], n,
        )
        out_counts = _apply_count_escapes(
            c8, np.asarray(cesc_idx)[: int(n_cesc)].astype(np.int64),
            np.asarray(cesc_val)[: int(n_cesc)], n,
        )
        return out_keys, out_counts

    # 24-bit tier overflowed (sparse keyspace / extreme repeat load):
    # u32-delta + u16-count tier
    (delta32, counts16, esc_idx, esc_val, n_esc,
     cesc_idx, cesc_val, n_cesc) = _export_encode_kernel(
        keys, counts, ESC_MAX
    )
    n_esc, n_cesc = int(n_esc), int(n_cesc)
    if n_esc > ESC_MAX or n_cesc > ESC_MAX:
        # escape overflow here too (e.g. very large k with few keys):
        # raw transfer of the occupied prefix
        return _fetch_prefix(keys, n), _fetch_prefix(counts, n)
    d32 = _fetch_prefix(delta32, n)
    c16 = _fetch_prefix(counts16, n)
    # astype first: np.cumsum(u32, dtype=u64) takes the slow upcasting
    # ufunc path (~1.7 s at 20M); accumulate over a u64 array is ~20x
    out_keys = _decode_keys(
        np.cumsum(d32.astype(np.uint64)),
        np.asarray(esc_idx)[:n_esc], np.asarray(esc_val)[:n_esc], n,
    )
    out_counts = _apply_count_escapes(
        c16, np.asarray(cesc_idx)[:n_cesc], np.asarray(cesc_val)[:n_cesc],
        n,
    )
    return out_keys, out_counts


@dataclass
class _Part:
    kmers: jax.Array  # sorted, sentinel-padded
    counts: jax.Array
    n: int  # occupied slots (may include zero-count ghost rows)
    first_key: int  # lower bound of the partition's key range
    # distinct live keys; -1 = not yet counted (partitions seeded by
    # the ghosted drain hold ghost rows: count 0, duplicating their live
    # predecessor's key; every merge collapses them). Counted lazily
    # on device the first time stats ask.
    n_real: int = -1

    def real(self) -> int:
        if self.n_real < 0:
            self.n_real = int(jnp.sum(self.counts > jnp.uint32(0)))
        return self.n_real


@dataclass
class SortedKmerStore:
    """Raw-buffered ingest + partitioned sorted master runs."""

    k: int
    parts: list = field(default_factory=list)  # ascending key ranges
    # 0 = auto (resolved lazily via _resolved_max_agg so that merely
    # constructing a store never initializes the JAX backend)
    max_agg: int = 0
    _buf: jax.Array | None = None  # raw k-mer buffer (lazily allocated)
    _buf_cap: int = 0
    _fill: int = 0  # tiles written * tile width (sentinel slack included)
    # staged run: drained unique runs accumulate here (merged pairwise
    # with ONE aggregate each) and fold into the partitioned master
    # only when the stage fills or a read forces _flushed(). Routing
    # every drain straight into the master costs a full aggregate sort
    # of every touched partition per drain, while staged runs
    # amortize it to one routing per
    # max_agg-worth of uniques. (uk, uc, n_unique) or None.
    _staged: tuple | None = None

    @staticmethod
    def create(k: int, capacity: int = 0, **_ignored) -> "SortedKmerStore":
        return SortedKmerStore(k=k)

    @property
    def capacity(self) -> int:
        return sum(p.kmers.shape[0] for p in self.parts)

    def _resolved_max_agg(self) -> int:
        if self.max_agg == 0:
            self.max_agg = _default_max_agg()
        return self.max_agg

    @property
    def part_budget(self) -> int:
        return self._resolved_max_agg() // 2

    def _count_bits(self) -> int:
        """Spare low bits for packed single-key sorts (0 = unusable)."""
        bits = 64 - 2 * self.k
        return bits if bits >= 20 else 0

    # -- ingest --------------------------------------------------------------

    def insert_kmers(self, kmers, counts=None) -> "SortedKmerStore":
        kmers = jnp.asarray(kmers, dtype=jnp.uint64).reshape(-1)
        if int(kmers.shape[0]) == 0:
            return self
        if counts is None:
            self._append_raw(kmers)
            return self
        # explicit-count path (checkpoint load, table merges): aggregate
        # directly in bounded sub-batches and fold into the master
        counts = jnp.asarray(counts, dtype=jnp.uint32).reshape(-1)
        step = self._resolved_max_agg()
        n_in = int(kmers.shape[0])
        for i in range(0, n_in, step):
            ksub = kmers[i : i + step]
            csub = counts[i : i + step]
            width = _next_pow2(int(ksub.shape[0]))
            ksub, csub = _pad_to_kernel(ksub, csub, width)
            uk, uc, nu = _aggregate_kernel(
                ksub, csub, count_bits=self._count_bits()
            )
            self._merge_run(uk, uc, int(nu))
        return self

    def ingest_codes(self, codes) -> "SortedKmerStore":
        kmers, _ = canonical_kmers(jnp.asarray(codes), self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "SortedKmerStore") -> "SortedKmerStore":
        """Fold another store's contents into this one, device-to-device.

        Each of the other store's partitions is already a sorted
        sentinel-padded run, which is exactly the explicit-count insert
        path's input shape — no host round-trip. This is the chunked
        engine's consolidation primitive (the analog of the reference's
        ``extend_with_histogram`` chunk merge, counting.rs:171-202).
        """
        if other.k != self.k:
            raise ValueError("k mismatch in merge_from")
        other._flushed()
        for p in other.parts:
            self.insert_kmers(p.kmers, p.counts)
        return self

    def _append_raw(self, kmers) -> None:
        """Tile-append raw k-mers into the device buffer; drain when full."""
        cap = self._ensure_buffer()
        tile = min(TILE, cap)
        n = int(kmers.shape[0])
        n_tiles = -(-n // tile)
        # pad the tile COUNT to a power of two so the append kernel
        # compiles for a handful of shapes only (the pad tiles are
        # never appended — the loop below runs over real tiles)
        shape_tiles = _next_pow2_count(n_tiles)
        if tile == TILE:
            tiles = _pad_tiles_kernel(kmers, shape_tiles)
        else:  # tiny-buffer (test) configuration
            pad = shape_tiles * tile - n
            tiles = jnp.concatenate(
                [kmers, jnp.full((pad,), jnp.uint64(EMPTY))]
            ).reshape(shape_tiles, tile)
        appended = 0
        while appended < n_tiles:
            space = (cap - self._fill) // tile
            if space == 0:
                self._drain()
                cap = self._ensure_buffer()
                continue
            take = min(space, n_tiles - appended)
            self._buf = _append_tiles_kernel(
                self._buf, tiles, jnp.int32(appended),
                jnp.int32(appended + take), jnp.int32(self._fill),
            )
            self._fill += take * tile
            appended += take

    def _ensure_buffer(self) -> int:
        if self._buf is None:
            self._buf_cap = max(self._resolved_max_agg(), 64)
            self._buf = jnp.full((self._buf_cap,), jnp.uint64(EMPTY))
            self._fill = 0
        return self._buf_cap

    def n_unique_master(self) -> int:
        return sum(p.real() for p in self.parts)

    # -- flush / partition management ----------------------------------------

    def flush(self) -> "SortedKmerStore":
        """Drain the raw buffer into the partitioned master (in place)."""
        self._drain()
        return self

    def _drain(self) -> None:
        if self._buf is None or self._fill == 0:
            return
        # drain only the filled prefix (rounded to a power of two so
        # partial drains reuse a small set of compiled widths)
        width = min(self._buf_cap, _next_pow2(self._fill))
        buf, self._buf = self._buf, None
        if width != self._buf_cap:
            buf = jax.lax.slice(buf, (0,), (width,))
        self._fill = 0
        if not self.parts and self._staged is None:
            # first drain into an empty store: the ghosted fast path
            # skips the compaction sort (the run seeds partitions
            # as-is; ghosts are invisible to every consumer and the
            # sPCR index de-ghosts before building sidecars)
            uk, uc, nu, _n_real = _aggregate_ingest_ghosted_jit(buf)
        else:
            uk, uc, nu = _aggregate_ingest_jit(
                buf, count_bits=self._count_bits()
            )
        nu = int(nu)  # occupied rows incl. ghost rows; one sync per drain
        if nu == 0:
            return
        run_w = min(width, _next_pow2(nu))
        if run_w != width:
            uk = jax.lax.slice(uk, (0,), (run_w,))
            uc = jax.lax.slice(uc, (0,), (run_w,))
        self._stage_run(uk, uc, nu)

    def _stage_run(self, uk, uc, nu: int) -> None:
        """Accumulate a drained unique run into the staged run.

        The staged run is a sorted aggregated (keys, counts) pair of
        bounded width (<= max_agg): merging two runs is ONE aggregate
        sort, vs a per-partition aggregate for every drain on the
        direct routing path. When the stage cannot absorb the new run
        it folds into the master first. Width discipline: the stage
        width only doubles from run widths, so merge shapes stay in
        the same pow2 family as the drains themselves.
        """
        if self._staged is None:
            self._staged = (uk, uc, nu)
            return
        sk, sc, sn = self._staged
        cap = self._resolved_max_agg()
        if sn + nu > cap or int(sk.shape[0]) + int(uk.shape[0]) > 2 * cap:
            self._staged = None
            self._merge_run(sk, sc, sn)
            self._staged = (uk, uc, nu)
            return
        mk, mc, mn = _merge_kernel(
            sk, sc, uk, uc, count_bits=self._count_bits()
        )
        mn = int(mn)
        # keep the stage at the smallest pow2 width that holds it (the
        # merged width is a sum of two pow2s; slicing back keeps the
        # compiled-shape set bounded)
        want = min(int(mk.shape[0]), _next_pow2(mn))
        if want != int(mk.shape[0]):
            mk = jax.lax.slice(mk, (0,), (want,))
            mc = jax.lax.slice(mc, (0,), (want,))
        self._staged = (mk, mc, mn)

    def _fold_staged(self) -> None:
        if self._staged is not None:
            sk, sc, sn = self._staged
            self._staged = None
            self._merge_run(sk, sc, sn)

    def _merge_run(self, uk, uc, nu: int) -> None:
        """Fold one sorted unique run into the partitioned master.

        Shape discipline: every partition array is sentinel-padded to a
        power-of-two width that ratchets up from _next_pow2(occupancy)
        by doubling, capped at part_budget (see _merge_into_part), so
        the whole lifetime of the store compiles a bounded set of XLA
        programs — at most log2(budget) merge/histogram/lookup widths —
        and small workloads never touch the deployment-scale shapes.
        """
        W = self.part_budget
        if nu == 0:
            return
        if not self.parts:
            # seed the master DIRECTLY from consecutive W-slices: the
            # run is sorted, so each slice is a valid partition with
            # no aggregate needed (the old path folded the tail
            # through merge+split — three extra full sorts for a
            # 2W-wide run). part 0's lower bound is never consulted
            # (it catches all keys below the second partition).
            # Partitions start at the smallest power-of-two width that
            # holds their occupancy and grow by doubling (up to W), so
            # small workloads never touch the deployment-scale shapes.
            pos = 0
            while pos < nu:
                size = min(W, nu - pos)
                width = min(W, _next_pow2(size))
                sk, sc = _slice_run_kernel(uk, uc, pos, size, width)
                first_key = (
                    0 if pos == 0 else int(np.asarray(sk[0:1])[0])
                )
                self.parts.append(
                    _Part(sk, sc, size, first_key)
                )
                pos += size
                if pos < nu:
                    # a ghosted run repeats a live key in zero-count
                    # rows behind it: a cut inside such a run would put
                    # the key in two partitions (later merges route to
                    # the second one), so skip the run's ghost tail
                    pos = int(_ghost_run_end_kernel(uk, jnp.int64(pos)))
            return

        # route the run across the partition key ranges with a single
        # device searchsorted against the boundary keys
        firsts = [p.first_key for p in self.parts[1:]]
        if firsts:
            bw = _next_pow2(len(firsts))
            bounds = np.full((bw,), EMPTY, dtype=np.uint64)
            bounds[: len(firsts)] = firsts
            splits = np.minimum(
                np.asarray(
                    _searchsorted_kernel(uk, jnp.asarray(bounds))
                )[: len(firsts)],
                nu,
            ).tolist()
        else:
            splits = []
        starts = [0, *splits]
        ends = [*splits, nu]
        # snapshot the targets: a merge may split its partition and
        # shift list indices, but the routing above is against the
        # pre-flush boundaries, so each segment's owner object is fixed
        targets = list(self.parts)
        for part, seg_start, seg_end in zip(targets, starts, ends):
            # wide runs can put more than W keys in one partition's
            # range: merge W-slices in ascending order, threading the
            # tail-owning partition through any splits
            target, pos = part, seg_start
            while pos < seg_end:
                size = min(W, seg_end - pos)
                sk, sc = _slice_run_kernel(
                    uk, uc, pos, size, min(W, _next_pow2(size))
                )
                target = self._merge_into_part(target, sk, sc)
                pos += size

    def _merge_into_part(self, part: _Part, sk, sc) -> "_Part":
        """Merge a sorted slice into `part`; grow or split if overfull.
        Returns the partition now owning the TOP of part's key range
        (the right half after a split), so callers merging ascending
        slices can keep targeting the correct partition."""
        W = self.part_budget
        p_idx = next(i for i, p in enumerate(self.parts) if p is part)
        mk, mc, mn = _merge_kernel(
            part.kmers, part.counts, sk, sc, count_bits=self._count_bits()
        )
        mn = int(mn)
        merged_w = int(mk.shape[0])
        if mn <= W:
            # keep the partition at the smallest power-of-two width
            # that holds it (never shrink: widths only ratchet up)
            width = min(W, max(int(part.kmers.shape[0]), _next_pow2(mn)))
            if width >= merged_w:
                nk, nc = _pad_to_kernel(mk, mc, width)
            else:
                nk = jax.lax.slice(mk, (0,), (width,))
                nc = jax.lax.slice(mc, (0,), (width,))
            new = _Part(nk, nc, mn, part.first_key, n_real=mn)
            self.parts[p_idx] = new
            return new
        # overfull: split at the budget midpoint. Both merge inputs hold
        # <= W uniques, so mn <= 2W and each half fits the budget.
        if merged_w < 2 * W:
            mk, mc = _pad_to_kernel(mk, mc, 2 * W)
        lk = jax.lax.slice(mk, (0,), (W,))
        lc = jax.lax.slice(mc, (0,), (W,))
        rk = jax.lax.slice(mk, (W,), (2 * W,))
        rc_ = jax.lax.slice(mc, (W,), (2 * W,))
        right_first = int(np.asarray(rk[0:1])[0])
        right = _Part(rk, rc_, mn - W, right_first, n_real=mn - W)
        self.parts[p_idx] = _Part(lk, lc, W, part.first_key, n_real=W)
        self.parts.insert(p_idx + 1, right)
        return right

    # -- queries --------------------------------------------------------------

    def _flushed(self) -> "SortedKmerStore":
        self._drain()
        self._fold_staged()
        return self

    def lookup(self, queries) -> jax.Array:
        s = self._flushed()
        q = jnp.asarray(queries, dtype=jnp.uint64)
        out = jnp.zeros(q.shape, jnp.uint32)
        for p in s.parts:
            out = out + _lookup_sorted_kernel(p.kmers, p.counts, p.n, q)
        return out

    def lookup_directional(self, queries) -> np.ndarray:
        s = self._flushed()
        q = np.asarray(queries, dtype=np.uint64).reshape(-1)
        nq = q.shape[0]
        if nq == 0:
            return np.zeros(0, np.uint32)
        padded = _next_pow2(nq)
        qp = np.full(padded, EMPTY, dtype=np.uint64)
        qp[:nq] = q
        qj = jnp.asarray(qp)
        out = np.zeros(padded, np.uint32)
        for p in s.parts:
            out = out + np.asarray(
                _lookup_directional_sorted_kernel(
                    p.kmers, p.counts, p.n, qj, s.k
                )
            )
        return out[:nq]

    def histogram(self, histo_max: int) -> np.ndarray:
        s = self._flushed()
        total = np.zeros(histo_max + 2, np.uint64)
        for p in s.parts:
            total = total + np.asarray(_histogram_kernel(p.counts, histo_max))
        return total

    def n_unique(self) -> int:
        return self._flushed().n_unique_master()

    def n_total(self) -> int:
        s = self._flushed()
        return sum(
            int(jnp.sum(p.counts.astype(jnp.uint64))) for p in s.parts
        )

    def max_count(self) -> int:
        s = self._flushed()
        if not s.parts:
            return 0
        return max(int(jnp.max(p.counts)) for p in s.parts)

    # -- sPCR device support (reach prefetch + primer range scans) -------------

    def _spcr_index(self):
        """Cached per-partition sidecars: bucket LUT (reach lookups)
        and revcomp-sorted index (primer scans). Rebuilt whenever the
        partition list changes (_Part objects are replaced, never
        mutated, on every merge/split)."""
        from . import reach as reach_mod

        s = self._flushed()
        cached = getattr(self, "_spcr_cache", None)
        token = tuple(id(p) for p in s.parts)
        if cached is not None and cached[0] == token:
            return cached[1]
        # ghost rows (zero-count duplicates of a live key) survive in
        # partitions seeded straight from the ghosted drain, and a long
        # ghost run inflates one bucket's occupancy past the LUT's
        # 2-block window, widening the probe for every closure level.
        # One compaction sort per partition de-ghosts the master in
        # place before the index is built.
        for i, p in enumerate(s.parts):
            if p.n > p.real():
                dk, dc, kept = _filter_compact_kernel(
                    p.kmers, p.counts, jnp.uint32(1)
                )
                s.parts[i] = _Part(
                    dk, dc, int(kept), p.first_key, n_real=int(kept)
                )
        # recompute the cache token AFTER de-ghosting: the _Part
        # objects just changed identity
        token = tuple(id(p) for p in s.parts)
        total_rows = sum(int(p.kmers.shape[0]) for p in s.parts)
        # above the device table's row cap the full index does not fit
        # beside the master: skip the count-packed probe plane
        # (+8 B/row; probes then gather key and count planes
        # separately) and serve the rc scan indexes transiently per
        # scan instead of caching them (+12 B/row)
        big = total_rows > device.settings().spcr_index_rows
        sidecars = [
            reach_mod.build_sidecar(
                p.kmers, p.counts, s.k, with_packed=not big
            )
            for p in s.parts
        ]
        rc_indexes = None if big else [
            reach_mod._rc_index_kernel(p.kmers, s.k) for p in s.parts
        ]
        bases = []
        off = 0
        for p in s.parts:
            bases.append(off)
            off += int(p.kmers.shape[0])
        data = (sidecars, rc_indexes, tuple(bases))
        self._spcr_cache = (token, data)
        return data

    def _rc_index_for(self, part):
        """The partition's rc scan index — cached on small tables,
        built transiently on big ones (the caller must not retain it)."""
        from . import reach as reach_mod

        return reach_mod._rc_index_kernel(part.kmers, self.k)

    def prepare_spcr(self) -> None:
        """Build the sPCR device indexes up front (one-time cost,
        otherwise paid lazily by the first scan/reach call)."""
        if self._flushed().parts:
            self._spcr_index()

    def reach(self, roots, min_count: int, depth: int | None = None,
              pre=None):
        """Depth-capped de Bruijn closure of ``roots`` over this table
        (ops/reach.py). ``pre``: already-covered interior keys to
        warm-start the visited set with (re-prefetching sessions).
        Returns a ReachResult or None on overflow."""
        from . import reach as reach_mod

        s = self._flushed()
        if not s.parts:
            return reach_mod.ReachResult(
                np.zeros(0, np.uint64), np.zeros(0, np.uint32), True, 0
            )
        sidecars, _rc, bases = self._spcr_index()
        return reach_mod.reach(
            sidecars, bases, roots, min_count, s.k,
            depth=depth or reach_mod.DEPTH, pre=pre,
        )

    def prefix_scan_many(self, requests, max_out: int = 1 << 14):
        """All primer scans in ONE device dispatch per partition.

        ``requests``: list of (oligos u64 array, oligo_len). The whole
        panel's oligo sets are concatenated into one tagged array and
        scanned by ``reach._panel_scan_kernel``, so the panel's primer
        discovery pays FOUR host transfers per partition instead of
        four per (gene, primer, mismatch level); a 7-gene panel issues
        ~40 requests. Returns [(kmers, counts)] per
        request at min count 1 (callers filter); semantics per request
        are identical to ``prefix_scan`` (each request keeps its own
        forward-precedence, nothing is unioned across requests).
        ``max_out`` bounds the TOTAL matches across the whole batch
        per orientation; overflow retries at the exact pow2 need.
        """
        from .reach import _panel_scan_kernel

        s = self._flushed()
        empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint32))
        if not s.parts:
            return [empty for _ in requests]
        _sidecars, rc_cached, _bases = self._spcr_index()

        n_oligos = 0
        for oligos, olen in requests:
            if olen <= 0 or olen >= s.k:
                raise ValueError(
                    f"oligo length {olen} out of range for k={s.k}"
                )
            n_oligos += len(oligos)
        width = max(64, 1 << max(n_oligos - 1, 0).bit_length())
        all_oligos = np.zeros(width, np.uint64)
        all_shifts = np.zeros(width, np.uint64)
        all_reqs = np.full(width, -1, np.int32)
        pos = 0
        for ri, (oligos, olen) in enumerate(requests):
            n = len(oligos)
            all_oligos[pos : pos + n] = np.sort(
                np.asarray(oligos, np.uint64)
            )
            all_shifts[pos : pos + n] = 2 * (s.k - olen)
            all_reqs[pos : pos + n] = ri
            pos += n
        oj = jnp.asarray(all_oligos)
        sj = jnp.asarray(all_shifts)
        rj = jnp.asarray(all_reqs)

        # partition-outer so big tables build each rc index ONCE and
        # release it before the next partition
        results = [([empty[0]], [empty[1]]) for _ in requests]
        for pi, p in enumerate(s.parts):
            rc_sorted, rc_order = (
                rc_cached[pi] if rc_cached is not None
                else self._rc_index_for(p)
            )
            mo = max_out
            while True:
                kk, cc, rr, totals = _panel_scan_kernel(
                    p.kmers, p.counts, rc_sorted, rc_order,
                    jnp.int64(p.n), oj, sj, rj, s.k, mo,
                )
                for a in (totals, kk, cc, rr):
                    a.copy_to_host_async()
                tot = int(np.asarray(totals).max())
                if tot <= mo:
                    break
                mo = 1 << (tot - 1).bit_length()
            kf = np.asarray(kk)
            cf = np.asarray(cc)
            rf = np.asarray(rr)
            # count-0 rows are ghost duplicates of a live
            # key: filter them so results honor the min-count-1
            # contract
            live = (rf >= 0) & (kf != EMPTY) & (cf > 0)
            kf, cf, rf = kf[live], cf[live], rf[live]
            order = np.argsort(rf, kind="stable")
            kf, cf, rf = kf[order], cf[order], rf[order]
            bounds = np.searchsorted(rf, np.arange(len(requests) + 1))
            for ri in range(len(requests)):
                lo, hi = bounds[ri], bounds[ri + 1]
                if hi > lo:
                    results[ri][0].append(kf[lo:hi])
                    results[ri][1].append(cf[lo:hi])
        return [
            (np.concatenate(ks), np.concatenate(cs))
            for ks, cs in results
        ]

    def prefix_scan(self, oligos, oligo_len: int, min_count: int,
                    max_out: int = 1 << 12):
        """Primer-oligo scan via sorted range queries against the
        partition keys (forward) and the revcomp-sorted sidecar
        (reverse strand) — ops/reach.py range_scan_part. Same
        observable semantics as the hashtable backend's full sweep
        (its kernel remains the differential oracle in tests)."""
        from .reach import range_scan_part

        if oligo_len <= 0 or oligo_len >= self.k:
            raise ValueError(
                f"oligo length {oligo_len} out of range for k={self.k}"
            )
        s = self._flushed()
        oligos = np.asarray(oligos, dtype=np.uint64)
        all_k, all_c = [np.zeros(0, np.uint64)], [np.zeros(0, np.uint32)]
        if s.parts:
            _sidecars, rc_cached, _bases = self._spcr_index()
            for pi, p in enumerate(s.parts):
                rc_sorted, rc_order = (
                    rc_cached[pi] if rc_cached is not None
                    else self._rc_index_for(p)
                )
                kk, cc = range_scan_part(
                    p.kmers, p.counts, rc_sorted, rc_order, p.n,
                    oligos, oligo_len, s.k, max_out=max_out,
                )
                all_k.append(kk)
                all_c.append(cc)
        kmers = np.concatenate(all_k)
        counts = np.concatenate(all_c)
        keep = counts >= np.uint32(max(min_count, 1))
        return kmers[keep], counts[keep]

    # -- host export -----------------------------------------------------------

    def to_sorted_arrays(
        self, min_count: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host mirror: (sorted unique kmers, counts), optionally
        restricted to rows with count >= ``min_count`` (filtered on
        device, so sub-threshold rows never cross the link).

        The export is the sPCR mirror's dominant cost. Keys travel as
        24-bit deltas of the sorted run (three u8 planes) and counts as u8, each with a small escape list for
        overflows (u32/u16 and raw fallback tiers), and only the
        occupied prefix is transferred (pow2-chunked slices, compiled
        once per width) — ~4 bytes/key instead of 12 bytes/slot of the
        padded partition width.
        """
        s = self._flushed()
        if not s.parts:
            return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
        keys, counts = [], []
        for p in s.parts:
            pk, pc = _export_part(p.kmers, p.counts, p.n, min_count)
            keys.append(pk)
            counts.append(pc)
        keys = np.concatenate(keys)
        counts = np.concatenate(counts)
        # drop zero-count ghost rows (ghosted-drain padding) so the
        # mirror/dict surfaces only live entries
        live = counts > 0
        return keys[live], counts[live]

    def to_dict(self) -> dict[int, int]:
        keys, counts = self.to_sorted_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))
