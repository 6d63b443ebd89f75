"""Device-resident open-addressed canonical k-mer count table.

The ``--backend hash`` replacement for the reference's ``KmerCounts``
hash map (src/kmer/counting.rs:113). The reference uses an
unbounded CPU ``HashMap<u64, u32>`` mutated one k-mer at a time; here
the table is a pair of flat device arrays (keys: uint64, counts:
uint32) with linear probing, and every mutation is a *batched*
functional update:

* ``insert``: batch -> sort -> run-length aggregate (so each unique
  k-mer appears once) -> iterative claim/probe rounds. A round scatters
  pending k-mers into empty slots, re-reads to see who won, adds counts
  for winners, advances losers one slot. All rounds are pure vector
  ops; the loop runs until no k-mer is pending.
* ``lookup``: batched probe loop; returns the stored count (0 when
  absent).
* ``histogram``: clipped bincount over the counts array — reproduces
  ``Histogram::get_vector`` (histogram.rs:125-134) with the >histo_max
  tail folded into the last bin.
* ``prefix_scan``: full-table scan matching primer oligos at the k-mer
  START (forward orientation) or via reverse complement, replacing
  ``find_oligos_in_kmers`` (primers.rs:163-226). Set-membership is a
  ``searchsorted`` against the sorted oligo array instead of a hash
  probe per entry.

Counts saturate at u32::MAX like the reference (counting.rs:24-31).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from .encoding import KMER_SENTINEL, canonical_kmers

# numpy scalars: no device commitment at import time (the backend may
# not be up yet); they behave identically inside traced code
EMPTY = np.uint64(KMER_SENTINEL)
U32_MAX = np.uint32(0xFFFF_FFFF)

_M1 = np.uint64(0xFF51_AFD7_ED55_8CCD)
_M2 = np.uint64(0xC4CE_B9FE_1A85_EC53)


def _mix64(x: jax.Array) -> jax.Array:
    """SplitMix64 finalizer — avalanching hash for slot selection."""
    x = x ^ (x >> jnp.uint64(33))
    x = x * _M1
    x = x ^ (x >> jnp.uint64(33))
    x = x * _M2
    x = x ^ (x >> jnp.uint64(33))
    return x


# Counts at or above this value are frozen (no further adds). Gives the
# reference's saturating-add semantics for every reachable count: a
# count below the threshold plus one batch's worth of duplicates
# (< 2^29) can never wrap u32, and a count at/above it never changes.
# Exact u32 arithmetic differs from the reference only in the
# astronomically unreachable band above 3.76e9 — and even there the
# histogram output is identical (both fold into the overflow bucket).
SAT_THRESHOLD = np.uint32(0xE000_0000)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _insert_kernel(keys, counts, kmers, add_counts):
    """Insert a batch of (kmer, count) pairs. kmers==SENTINEL are skipped.

    Sort-free design: the batch goes straight into claim/probe rounds.
    Duplicate k-mers in the batch are handled by the scatter-add
    itself (duplicate indices accumulate), and duplicate *claims* of
    one slot all write the same key, so no aggregation pass is needed.
    Each round is a gather + two masked scatters over the pending
    lanes; the while_loop runs until every lane has landed (bounded by
    the longest probe chain, small at <=0.7 load).
    """
    capacity = keys.shape[0]
    mask = jnp.uint64(capacity - 1)
    amounts = add_counts.astype(jnp.uint32)

    slot = (_mix64(kmers) & mask).astype(jnp.int64)
    pending = kmers != EMPTY

    def cond(state):
        _, _, _, pending = state
        return jnp.any(pending)

    def body(state):
        keys, counts, slot, pending = state
        cur = keys[slot]
        hit = pending & (cur == kmers)
        frozen = counts[slot] >= SAT_THRESHOLD
        add_amt = jnp.where(hit & ~frozen, amounts, 0)
        counts = counts.at[jnp.where(hit, slot, capacity)].add(
            add_amt, mode="drop"
        )
        pending = pending & ~hit

        empty = pending & (cur == EMPTY)
        keys = keys.at[jnp.where(empty, slot, capacity)].set(
            kmers, mode="drop"
        )
        claimed = pending & (keys[slot] == kmers)
        frozen = counts[slot] >= SAT_THRESHOLD
        add_amt = jnp.where(claimed & ~frozen, amounts, 0)
        counts = counts.at[jnp.where(claimed, slot, capacity)].add(
            add_amt, mode="drop"
        )
        pending = pending & ~claimed

        slot = jnp.where(pending, (slot + 1) & jnp.int64(capacity - 1), slot)
        return keys, counts, slot, pending

    keys, counts, _, _ = jax.lax.while_loop(
        cond, body, (keys, counts, slot, pending)
    )
    return keys, counts


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _insert_kernel_exact(keys, counts, kmers, add_counts):
    """Aggregating insert with exact u32 saturating-add semantics.

    Sorts the batch and run-length-aggregates so each unique k-mer
    appears once, then uses saturating read-modify-write instead of
    scatter-add. Slower than ``_insert_kernel`` (the sort dominates);
    kept for strict-parity verification and as the differential oracle
    in tests.
    """
    capacity = keys.shape[0]
    mask = jnp.uint64(capacity - 1)

    # --- aggregate duplicates: sort + run-length encode -------------------
    sk = jax.lax.sort(kmers, is_stable=False)  # sentinels sort to the end
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]]
    ) & (sk != EMPTY)
    seg = jnp.cumsum(first) - 1  # segment id per element (junk for sentinels)
    contrib = jnp.where(sk != EMPTY, add_counts_sorted(sk, kmers, add_counts), 0)
    totals = jax.ops.segment_sum(contrib, seg, num_segments=sk.shape[0])
    ukmer = jnp.where(first, sk, EMPTY)
    ucount = jnp.where(first, totals[seg], 0).astype(jnp.uint64)

    slot = (_mix64(ukmer) & mask).astype(jnp.int64)
    pending = ukmer != EMPTY

    def sat_add_at(counts, slots, hits, amounts):
        # each hit slot is distinct within a round -> read-modify-write is safe
        old = counts[slots]
        summed = old.astype(jnp.uint64) + amounts
        newval = jnp.minimum(summed, jnp.uint64(0xFFFF_FFFF)).astype(jnp.uint32)
        idx = jnp.where(hits, slots, capacity)  # out-of-bounds -> dropped
        return counts.at[idx].set(jnp.where(hits, newval, 0), mode="drop")

    def cond(state):
        _, _, _, pending = state
        return jnp.any(pending)

    def body(state):
        keys, counts, slot, pending = state
        cur = keys[slot]
        hit = pending & (cur == ukmer)
        counts = sat_add_at(counts, slot, hit, ucount)
        pending = pending & ~hit

        empty = pending & (cur == EMPTY)
        claim_idx = jnp.where(empty, slot, capacity)
        keys = keys.at[claim_idx].set(ukmer, mode="drop")
        claimed = pending & (keys[slot] == ukmer)
        counts = sat_add_at(counts, slot, claimed, ucount)
        pending = pending & ~claimed

        slot = jnp.where(pending, (slot + 1) & jnp.int64(capacity - 1), slot)
        return keys, counts, slot, pending

    keys, counts, _, _ = jax.lax.while_loop(
        cond, body, (keys, counts, slot, pending)
    )
    return keys, counts


def add_counts_sorted(sorted_kmers, kmers, add_counts):
    """Counts aligned to the sorted k-mer order.

    When every input weight is 1 (the common ingest path) this is just
    ones; otherwise the weights must be permuted with the same sort.
    Implemented via a key-value sort to stay O(n log n).
    """
    if add_counts is None:
        return jnp.ones(sorted_kmers.shape, jnp.uint64)
    _, sorted_counts = jax.lax.sort((kmers, add_counts.astype(jnp.uint64)), num_keys=1, is_stable=False)
    return sorted_counts


@jax.jit
def _lookup_kernel(keys, counts, queries):
    """Probe the table for canonical queries. Returns uint32 counts (0 if absent)."""
    capacity = keys.shape[0]
    mask = jnp.int64(capacity - 1)
    slot = (_mix64(queries) & jnp.uint64(capacity - 1)).astype(jnp.int64)
    pending = queries != EMPTY
    result = jnp.zeros(queries.shape, jnp.uint32)

    def cond(state):
        _, _, pending = state
        return jnp.any(pending)

    def body(state):
        slot, result, pending = state
        cur = keys[slot]
        found = pending & (cur == queries)
        result = jnp.where(found, counts[slot], result)
        pending = pending & ~found & (cur != EMPTY)
        slot = jnp.where(pending, (slot + 1) & mask, slot)
        return slot, result, pending

    _, result, _ = jax.lax.while_loop(cond, body, (slot, result, pending))
    return result


@functools.partial(jax.jit, static_argnames=("histo_max",))
def _histogram_kernel(counts, histo_max: int):
    """Clipped count-of-counts. Index i = number of k-mers with count i,
    index histo_max+1 = number with count > histo_max (folded tail).
    Index 0 is forced to 0 (empty slots are not k-mers).

    Sort-based: sort the clipped counts and difference ``searchsorted``
    positions at the bin edges, instead of a bincount scatter-add."""
    clipped = jax.lax.sort(
        jnp.minimum(counts, jnp.uint32(histo_max + 1)), is_stable=False
    )
    edges = jnp.arange(histo_max + 3, dtype=jnp.uint32)
    pos = jnp.searchsorted(clipped, edges)
    histo = (pos[1:] - pos[:-1]).astype(jnp.uint64)
    return histo.at[0].set(0)


@functools.partial(jax.jit, static_argnames=("shift", "rc_mask_bits", "max_out"))
def _prefix_scan_kernel(
    keys,
    counts,
    oligos_sorted,
    rc_oligos_sorted,
    rc_table,
    shift: int,
    rc_mask_bits: int,
    max_out: int,
    min_count,
):
    """Full-table primer scan (find_oligos_in_kmers, primers.rs:163-226).

    A table k-mer matches when its high-bits prefix equals one of the
    oligos (forward) or its low bits equal one of the reverse-complement
    oligos (RC hit). RC hits are reported as the revcomp of the stored
    k-mer so the primer sits at the k-mer start, exactly as the
    reference stores them (primers.rs:216-222).

    ``rc_table`` is the precomputed revcomp of every table key (built
    once per table generation by the caller).
    """
    occupied = (keys != EMPTY) & (counts >= min_count)

    def member(sorted_set, values):
        if sorted_set.shape[0] == 0:
            return jnp.zeros(values.shape, bool)
        idx = jnp.searchsorted(sorted_set, values)
        idx = jnp.minimum(idx, sorted_set.shape[0] - 1)
        return sorted_set[idx] == values

    prefix = keys >> jnp.uint64(shift)
    fwd_hit = occupied & member(oligos_sorted, prefix)
    low = keys & jnp.uint64((1 << rc_mask_bits) - 1)
    rc_hit = occupied & ~fwd_hit & member(rc_oligos_sorted, low)

    hit = fwd_hit | rc_hit
    out_kmer = jnp.where(rc_hit, rc_table, keys)

    idx = jnp.nonzero(hit, size=max_out, fill_value=keys.shape[0] - 1)[0]
    n = jnp.sum(hit)
    return out_kmer[idx], counts[idx], n


@functools.partial(jax.jit, static_argnames=("k",))
def _revcomp_kernel(keys, k: int):
    out = jnp.zeros(keys.shape, jnp.uint64)
    x = keys
    for _ in range(k):
        out = (out << jnp.uint64(2)) | ((x & jnp.uint64(3)) ^ jnp.uint64(3))
        x = x >> jnp.uint64(2)
    return jnp.where(keys == EMPTY, EMPTY, out)


@functools.partial(jax.jit, static_argnames=("k",))
def _lookup_directional_kernel(keys, counts, queries, k: int):
    rc = _revcomp_kernel(queries, k)
    canon = jnp.minimum(queries, rc)
    return _lookup_kernel(keys, counts, canon)


@functools.partial(jax.jit, donate_argnums=(2, 3))
def _rehash_kernel(old_keys, old_counts, new_keys, new_counts):
    return _insert_kernel(
        new_keys,
        new_counts,
        old_keys,
        jnp.where(old_keys == EMPTY, 0, old_counts).astype(jnp.uint32),
    )


@jax.jit
def _stats_kernel(keys, counts):
    occ = keys != EMPTY
    n_unique = jnp.sum(occ, dtype=jnp.uint64)
    n_total = jnp.sum(counts.astype(jnp.uint64))
    max_count = jnp.max(jnp.where(occ, counts, 0))
    return n_unique, n_total, max_count


@dataclass
class KmerTable:
    """Functional handle on the device-resident count table."""

    k: int
    keys: jax.Array  # uint64 [capacity]
    counts: jax.Array  # uint32 [capacity]
    max_load: float = 0.70

    @staticmethod
    def create(k: int, capacity: int = 1 << 20, max_load: float = 0.70) -> "KmerTable":
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        keys = jnp.full((capacity,), EMPTY, dtype=jnp.uint64)
        counts = jnp.zeros((capacity,), dtype=jnp.uint32)
        return KmerTable(k=k, keys=keys, counts=counts, max_load=max_load)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    # -- ingest ------------------------------------------------------------

    def insert_kmers(self, kmers: jax.Array, counts: jax.Array | None = None) -> "KmerTable":
        """Insert a flat batch of canonical k-mers (SENTINEL entries skipped)."""
        kmers = jnp.asarray(kmers, dtype=jnp.uint64).reshape(-1)
        if counts is None:
            counts = jnp.ones(kmers.shape, jnp.uint32)
        table = self._maybe_grow(int(kmers.shape[0]))
        keys, cnts = _insert_kernel(table.keys, table.counts, kmers, counts)
        return replace(table, keys=keys, counts=cnts)

    def ingest_codes(self, codes: jax.Array) -> "KmerTable":
        """Encode a [n, width] uint8 code batch and insert its canonical k-mers."""
        kmers, _ = canonical_kmers(jnp.asarray(codes), self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "KmerTable") -> "KmerTable":
        """Fold another table's entries into this one (device-to-device):
        the other table's slot arrays feed the insert kernel directly —
        SENTINEL slots are skipped by the probe loop, and empty-slot
        counts are forced to 0 so they can never alias a real add."""
        if other.k != self.k:
            raise ValueError("k mismatch in merge_from")
        add = jnp.where(other.keys == EMPTY, 0, other.counts).astype(jnp.uint32)
        return self.insert_kmers(other.keys, add)

    def _maybe_grow(self, incoming: int) -> "KmerTable":
        table = self
        # n_unique is a device reduction; to avoid a sync per batch we grow
        # pessimistically on the running occupancy estimate.
        n_unique = int(_stats_kernel(table.keys, table.counts)[0])
        while n_unique + incoming > table.max_load * table.capacity:
            table = table._grow()
        return table

    def _grow(self) -> "KmerTable":
        new_cap = self.capacity * 2
        nk = jnp.full((new_cap,), EMPTY, dtype=jnp.uint64)
        nc = jnp.zeros((new_cap,), dtype=jnp.uint32)
        nk, nc = _rehash_kernel(self.keys, self.counts, nk, nc)
        return replace(self, keys=nk, counts=nc)

    # -- queries -----------------------------------------------------------

    def lookup(self, queries: jax.Array) -> jax.Array:
        """Counts for canonical queries (uint32, 0 when absent)."""
        q = jnp.asarray(queries, dtype=jnp.uint64)
        return _lookup_kernel(self.keys, self.counts, q)

    def lookup_directional(self, queries) -> np.ndarray:
        """Counts for *directional* k-mers: canonicalize (min of the k-mer
        and its revcomp) on device, then probe. Replaces the reference's
        two-orientation probe ``get_canonical`` (counting.rs:218-222).

        Host convenience: accepts numpy, pads to a power-of-two batch to
        bound the number of compiled shapes, returns numpy uint32.
        """
        q = np.asarray(queries, dtype=np.uint64).reshape(-1)
        n = q.shape[0]
        if n == 0:
            return np.zeros(0, np.uint32)
        padded = 1 << max(6, (n - 1).bit_length())
        qp = np.full(padded, np.uint64(KMER_SENTINEL), dtype=np.uint64)
        qp[:n] = q
        out = _lookup_directional_kernel(self.keys, self.counts, jnp.asarray(qp), self.k)
        return np.asarray(out)[:n]

    def histogram(self, histo_max: int) -> np.ndarray:
        """uint64 vector of length histo_max+2 (see Histogram::get_vector)."""
        return np.asarray(_histogram_kernel(self.counts, histo_max))

    def n_unique(self) -> int:
        return int(_stats_kernel(self.keys, self.counts)[0])

    def n_total(self) -> int:
        return int(_stats_kernel(self.keys, self.counts)[1])

    def max_count(self) -> int:
        return int(_stats_kernel(self.keys, self.counts)[2])

    def prefix_scan(
        self,
        oligos: np.ndarray,
        oligo_len: int,
        min_count: int,
        max_out: int = 1 << 16,
    ):
        """All table k-mers whose start matches an oligo (either strand).

        Returns (kmers, counts) numpy arrays of the actual matches,
        RC-normalized so the primer is at the k-mer start.
        """
        from .encoding import revcomp_kmer as _rc

        if oligo_len <= 0 or oligo_len >= self.k:
            raise ValueError(
                f"oligo length {oligo_len} out of range for k={self.k}"
            )
        oligos = np.asarray(oligos, dtype=np.uint64)
        rc = np.array(
            sorted({_rc(int(o), oligo_len) for o in oligos}), dtype=np.uint64
        )
        fwd = np.sort(oligos)
        rc_table = _revcomp_kernel(self.keys, self.k)
        # grow-and-retry on overflow: a degenerate oligo matching more
        # than max_out table entries must not kill the gene
        while True:
            kmers, counts, n = _prefix_scan_kernel(
                self.keys,
                self.counts,
                jnp.asarray(fwd),
                jnp.asarray(rc),
                rc_table,
                2 * (self.k - oligo_len),
                2 * oligo_len,
                max_out,
                jnp.uint32(min_count),
            )
            n = int(n)
            if n <= max_out:
                break
            max_out = 1 << (n - 1).bit_length()
        return np.asarray(kmers[:n]), np.asarray(counts[:n])

    # -- host export (tests / small tables) --------------------------------

    def to_sorted_arrays(
        self, min_count: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host mirror: (sorted unique kmers, counts), optionally
        restricted to rows with count >= ``min_count``."""
        keys = np.asarray(self.keys)
        counts = np.asarray(self.counts)
        occ = keys != np.uint64(KMER_SENTINEL)
        if min_count > 1:
            occ &= counts >= np.uint32(min_count)
        keys, counts = keys[occ], counts[occ]
        order = np.argsort(keys)
        return keys[order], counts[order]

    def to_dict(self) -> dict[int, int]:
        keys = np.asarray(self.keys)
        counts = np.asarray(self.counts)
        occ = keys != np.uint64(KMER_SENTINEL)
        return dict(zip(keys[occ].tolist(), counts[occ].tolist()))
