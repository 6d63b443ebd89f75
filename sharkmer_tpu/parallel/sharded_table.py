"""Count table sharded across a device mesh.

The multi-chip analog of the reference's single hash map — the
"sequence parallel" axis of this framework is the k-mer keyspace
(SURVEY.md §5): each device owns the k-mers whose hash maps to its
shard, so the scatter-add bottleneck and the table memory both scale
with the number of chips.

Design (all inside one `shard_map` over a 1-D mesh axis "shards"):

* **owner routing**: owner(kmer) = high bits of the SplitMix64 hash;
  local probe slots use the low bits, so shard choice and probe
  sequence stay independent.
* **insert**: the global k-mer batch is `all_gather`ed, each shard
  masks to its owned subset (others -> sentinel) and runs the same
  aggregate + claim/probe insert as the single-device kernel on its
  local arrays. Per-kmer totals are identical to the single-device
  path by construction (same batch boundaries, same saturation).
* **histogram**: local clipped bincount, all_gather + local u64 sum
  across shards (no u64 all-reduce needed).
* **lookup**: queries are replicated; each shard answers for owned
  queries (0 elsewhere) and results combine with `psum`.
* **prefix scan**: shard-local scan + `all_gather` of the match
  buffers; the host concatenates.

Shard-invariance (N-shard results == 1-shard results, bit-identical)
is asserted in tests/test_sharded.py, mirroring the reference's
chunk-invariance oracle.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.encoding import KMER_SENTINEL, canonical_kmers
from ..ops import hashtable as ht

AXIS = "shards"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A flat 1-D mesh over the first ``n_devices`` devices (every
    device pair is equally connected, so the mesh follows the
    algorithm alone). Raises when fewer devices exist."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"{n_devices} shards requested but only {len(devices)} "
                f"{devices[0].platform} device(s) are available"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def _owner(kmers: jax.Array, n_shards: int) -> jax.Array:
    """Shard owner from high hash bits (independent of probe slots)."""
    return (ht._mix64(kmers) >> jnp.uint64(40)) % jnp.uint64(n_shards)


def _local_insert(keys, counts, kmers, add_counts):
    """Single-shard insert on local arrays (reuses the claim/probe kernel)."""
    return ht._insert_kernel(keys, counts, kmers, add_counts)


@functools.lru_cache(maxsize=64)
def _make_local_merge(mesh: Mesh):
    """Shard-local table merge (both tables owner-aligned on `mesh`)."""

    @jax.jit
    def merge(keys, counts, okeys, ocounts):
        def body(keys, counts, okeys, ocounts):
            ok, oc = okeys[0], ocounts[0]
            add = jnp.where(
                ok == jnp.uint64(KMER_SENTINEL), 0, oc
            ).astype(jnp.uint32)
            nk, nc = _local_insert(keys[0], counts[0], ok, add)
            return nk[None], nc[None]

        return shard_map(
            body, mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None),
                      P(AXIS, None)),
            out_specs=(P(AXIS, None), P(AXIS, None)),
            check_vma=False,
        )(keys, counts, okeys, ocounts)

    return merge


@dataclass
class ShardedKmerTable:
    """Count table sharded over a 1-D device mesh."""

    k: int
    mesh: Mesh
    keys: jax.Array  # uint64 [n_shards, local_capacity], sharded axis 0
    counts: jax.Array  # uint32 [n_shards, local_capacity], sharded axis 0

    @staticmethod
    def create(k: int, mesh: Mesh, local_capacity: int = 1 << 18) -> "ShardedKmerTable":
        if local_capacity & (local_capacity - 1):
            raise ValueError("local_capacity must be a power of two")
        n = mesh.devices.size
        sharding = NamedSharding(mesh, P(AXIS, None))
        keys = jax.device_put(
            jnp.full((n, local_capacity), jnp.uint64(KMER_SENTINEL)), sharding
        )
        counts = jax.device_put(
            jnp.zeros((n, local_capacity), jnp.uint32), sharding
        )
        return ShardedKmerTable(k=k, mesh=mesh, keys=keys, counts=counts)

    @property
    def n_shards(self) -> int:
        return self.keys.shape[0]

    @property
    def local_capacity(self) -> int:
        return self.keys.shape[1]

    # -- kernels (built per mesh) -------------------------------------------

    @functools.cached_property
    def _insert_fn(self):
        mesh = self.mesh
        n_shards = self.n_shards

        @jax.jit
        def insert(keys, counts, kmers, add_counts):
            # kmers: [n_shards, B] sharded — each shard contributes a slice
            def body(keys, counts, kmers, add_counts):
                keys, counts = keys[0], counts[0]
                me = jax.lax.axis_index(AXIS)
                # gather the global batch, keep only owned k-mers
                full = jax.lax.all_gather(kmers[0], AXIS).reshape(-1)
                full_counts = jax.lax.all_gather(add_counts[0], AXIS).reshape(-1)
                owner = _owner(full, n_shards)
                mine = jnp.where(
                    owner == me.astype(jnp.uint64), full,
                    jnp.uint64(KMER_SENTINEL),
                )
                keys, counts = _local_insert(keys, counts, mine, full_counts)
                return keys[None], counts[None]

            return shard_map(
                body, mesh=mesh,
                in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None),
                          P(AXIS, None)),
                out_specs=(P(AXIS, None), P(AXIS, None)),
                check_vma=False,
            )(keys, counts, kmers, add_counts)

        return insert

    @functools.cached_property
    def _lookup_fn(self):
        mesh = self.mesh
        n_shards = self.n_shards
        k = self.k

        @functools.partial(jax.jit)
        def lookup(keys, counts, queries):
            def body(keys, counts, queries):
                keys, counts = keys[0], counts[0]
                me = jax.lax.axis_index(AXIS)
                rc = ht._revcomp_kernel(queries, k)
                canon = jnp.minimum(queries, rc)
                owner = _owner(canon, n_shards)
                mine = jnp.where(
                    owner == me.astype(jnp.uint64), canon,
                    jnp.uint64(KMER_SENTINEL),
                )
                local = ht._lookup_kernel(keys, counts, mine)
                return jax.lax.psum(local, AXIS)

            return shard_map(
                body, mesh=mesh,
                in_specs=(P(AXIS, None), P(AXIS, None), P()),
                out_specs=P(),
                check_vma=False,
            )(keys, counts, queries)

        return lookup

    def _histogram_fn(self, histo_max: int):
        mesh = self.mesh

        @jax.jit
        def histogram(counts):
            def body(counts):
                from .sorted_sharded import _sum_shards_u64

                local = ht._histogram_kernel(counts[0], histo_max)
                return _sum_shards_u64(local)

            return shard_map(
                body, mesh=mesh, in_specs=(P(AXIS, None),), out_specs=P(),
                check_vma=False,
            )(counts)

        return histogram

    # -- growth --------------------------------------------------------------

    def _grow(self) -> "ShardedKmerTable":
        """Double every shard's local capacity. Owner assignment does not
        depend on capacity, so each shard rehashes locally."""
        mesh = self.mesh
        new_local = self.local_capacity * 2

        @jax.jit
        def grow(keys, counts):
            def body(keys, counts):
                ok, oc = keys[0], counts[0]
                nk = jnp.full((new_local,), jnp.uint64(KMER_SENTINEL))
                nc = jnp.zeros((new_local,), jnp.uint32)
                nk, nc = ht._insert_kernel(
                    nk, nc, ok,
                    jnp.where(ok == jnp.uint64(KMER_SENTINEL), 0, oc).astype(
                        jnp.uint32
                    ),
                )
                return nk[None], nc[None]

            return shard_map(
                body, mesh=mesh,
                in_specs=(P(AXIS, None), P(AXIS, None)),
                out_specs=(P(AXIS, None), P(AXIS, None)),
                check_vma=False,
            )(keys, counts)

        keys, counts = grow(self.keys, self.counts)
        new = replace(self, keys=keys, counts=counts)
        # kernel closures cache shapes; rebuild for the new capacity
        new.__dict__.pop("_insert_fn", None)
        new.__dict__.pop("_lookup_fn", None)
        return new

    def _maybe_grow(self, incoming: int, max_load: float = 0.70) -> "ShardedKmerTable":
        table = self
        # worst-case skew guard: occupancy is measured globally, incoming
        # assumed evenly routed (the hash makes this hold in practice)
        while table.n_unique() + incoming > max_load * (
            table.n_shards * table.local_capacity
        ):
            table = table._grow()
        return table

    # -- public API (mirrors KmerTable) -------------------------------------

    def insert_kmers(self, kmers, counts=None) -> "ShardedKmerTable":
        """Insert a flat batch (replicated input, split across shards)."""
        kmers = np.asarray(kmers, dtype=np.uint64).reshape(-1)
        if counts is None:
            counts = np.ones(len(kmers), np.uint32)
        counts = np.asarray(counts, dtype=np.uint32).reshape(-1)
        table = self._maybe_grow(len(kmers))
        n = table.n_shards
        per = -(-len(kmers) // n)
        padded = np.full(n * per, np.uint64(KMER_SENTINEL), dtype=np.uint64)
        padded[: len(kmers)] = kmers
        padded_c = np.zeros(n * per, np.uint32)
        padded_c[: len(kmers)] = counts
        sharding = NamedSharding(table.mesh, P(AXIS, None))
        shards = jax.device_put(padded.reshape(n, per), sharding)
        shard_counts = jax.device_put(padded_c.reshape(n, per), sharding)
        keys, counts_arr = table._insert_fn(
            table.keys, table.counts, shards, shard_counts
        )
        return replace(table, keys=keys, counts=counts_arr)

    def ingest_codes(self, codes) -> "ShardedKmerTable":
        kmers, _ = canonical_kmers(jnp.asarray(codes), self.k)
        return self.insert_kmers(np.asarray(kmers).reshape(-1))

    def merge_from(self, other: "ShardedKmerTable") -> "ShardedKmerTable":
        """Fold another table (same mesh, same k) into this one. Both
        tables route by the same owner hash, so the merge is purely
        shard-local: each shard claim/probe-inserts the other table's
        local slots into its own — no collective, no host round-trip."""
        if other.k != self.k or other.mesh is not self.mesh:
            raise ValueError("merge_from requires same k and mesh")
        table = self._maybe_grow(other.n_unique())
        keys, counts = _make_local_merge(table.mesh)(
            table.keys, table.counts, other.keys, other.counts
        )
        return replace(table, keys=keys, counts=counts)

    def lookup_directional(self, queries) -> np.ndarray:
        q = np.asarray(queries, dtype=np.uint64).reshape(-1)
        n = q.shape[0]
        if n == 0:
            return np.zeros(0, np.uint32)
        padded_n = 1 << max(6, (n - 1).bit_length())
        qp = np.full(padded_n, np.uint64(KMER_SENTINEL), dtype=np.uint64)
        qp[:n] = q
        out = self._lookup_fn(self.keys, self.counts, jnp.asarray(qp))
        return np.asarray(out)[:n]

    def histogram(self, histo_max: int) -> np.ndarray:
        return np.asarray(self._histogram_fn(histo_max)(self.counts))

    def n_unique(self) -> int:
        return int(jnp.sum(self.keys != jnp.uint64(KMER_SENTINEL)))

    def n_total(self) -> int:
        return int(jnp.sum(self.counts.astype(jnp.uint64)))

    def max_count(self) -> int:
        occ = self.keys != jnp.uint64(KMER_SENTINEL)
        return int(jnp.max(jnp.where(occ, self.counts, 0)))

    def prefix_scan(self, oligos, oligo_len: int, min_count: int,
                    max_out: int = 1 << 16):
        """Shard-local scans; host merges the gathered match buffers."""
        from ..ops.encoding import revcomp_kmer as _rc

        if oligo_len <= 0 or oligo_len >= self.k:
            raise ValueError(
                f"oligo length {oligo_len} out of range for k={self.k}"
            )
        oligos = np.asarray(oligos, dtype=np.uint64)
        rc = np.array(
            sorted({_rc(int(o), oligo_len) for o in oligos}), dtype=np.uint64
        )
        fwd = np.sort(oligos)
        all_kmers, all_counts = [], []
        # shard-local scans run device-side; result buffers are small
        for s in range(self.n_shards):
            keys_s = self.keys[s]
            counts_s = self.counts[s]
            rc_table = ht._revcomp_kernel(keys_s, self.k)
            # grow-and-retry on overflow (degenerate oligos)
            cur_max = max_out
            while True:
                kmers, counts, nm = ht._prefix_scan_kernel(
                    keys_s, counts_s, jnp.asarray(fwd), jnp.asarray(rc),
                    rc_table, 2 * (self.k - oligo_len), 2 * oligo_len,
                    cur_max, jnp.uint32(min_count),
                )
                nm = int(nm)
                if nm <= cur_max:
                    break
                cur_max = 1 << (nm - 1).bit_length()
            all_kmers.append(np.asarray(kmers[:nm]))
            all_counts.append(np.asarray(counts[:nm]))
        return np.concatenate(all_kmers), np.concatenate(all_counts)

    def to_sorted_arrays(
        self, min_count: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        keys = np.asarray(self.keys).reshape(-1)
        counts = np.asarray(self.counts).reshape(-1)
        occ = keys != np.uint64(KMER_SENTINEL)
        if min_count > 1:
            occ &= counts >= np.uint32(min_count)
        keys, counts = keys[occ], counts[occ]
        order = np.argsort(keys)
        return keys[order], counts[order]

    def to_dict(self) -> dict[int, int]:
        keys = np.asarray(self.keys).reshape(-1)
        counts = np.asarray(self.counts).reshape(-1)
        occ = keys != np.uint64(KMER_SENTINEL)
        return dict(zip(keys[occ].tolist(), counts[occ].tolist()))


def make_ingest_step(mesh: Mesh, k: int, histo_max: int):
    """Build the fused multi-chip ingest step: encode (data-parallel over
    reads) -> owner-route -> local insert (table-parallel over the
    keyspace) -> psum'd histogram. This is the framework's full
    "training step": both parallelism axes of the design in one jitted
    program.

    Returns step(keys, counts, codes) -> (keys, counts, histo) where
      keys/counts: [n_shards, local_capacity] sharded on axis 0,
      codes: uint8 [n_shards, reads_per_shard, width] sharded on axis 0,
      histo: uint64 [histo_max+2] replicated.
    """
    n_shards = mesh.devices.size

    def body(keys, counts, codes):
        keys, counts = keys[0], counts[0]
        me = jax.lax.axis_index(AXIS)
        # dp: each shard encodes only its slice of the read batch
        kmers, _ = canonical_kmers(codes[0], k)
        local_kmers = kmers.reshape(-1)
        # keyspace routing: gather the global batch, keep owned k-mers
        full = jax.lax.all_gather(local_kmers, AXIS).reshape(-1)
        owner = _owner(full, n_shards)
        mine = jnp.where(
            owner == me.astype(jnp.uint64), full, jnp.uint64(KMER_SENTINEL)
        )
        keys, counts = _local_insert(
            keys, counts, mine, jnp.ones(mine.shape, jnp.uint32)
        )
        from .sorted_sharded import _sum_shards_u64

        histo = _sum_shards_u64(ht._histogram_kernel(counts, histo_max))
        return keys[None], counts[None], histo

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None, None)),
        out_specs=(P(AXIS, None), P(AXIS, None), P()),
        check_vma=False,
    )
    return jax.jit(mapped)
