"""Sorted-run store tests: differential vs the hash table and a dict model."""

import collections

import numpy as np
import pytest

from sharkmer_tpu.ops import KmerTable, ascii_to_codes, codes_to_batch
from sharkmer_tpu.ops.encoding import kmers_from_ascii_ref, seq_to_kmer
from sharkmer_tpu.ops.sorted_store import SortedKmerStore

from util import random_genome, reads_from_genome


def test_basic_insert_lookup():
    s = SortedKmerStore.create(5)
    s.insert_kmers(np.array([42], np.uint64), np.array([3], np.uint32))
    assert s.to_dict() == {42: 3}
    s.insert_kmers(np.array([42, 7, 7], np.uint64))
    assert s.to_dict() == {42: 4, 7: 2}
    assert s.lookup_directional(np.array([42], np.uint64)).tolist() == [4]


def test_saturation_exact():
    s = SortedKmerStore.create(5)
    s.insert_kmers(np.array([1], np.uint64), np.array([0xFFFFFFFF], np.uint32))
    s.insert_kmers(np.array([1], np.uint64), np.array([5], np.uint32))
    assert s.to_dict() == {1: 0xFFFFFFFF}


def test_differential_vs_hashtable_and_dict():
    rng = np.random.default_rng(11)
    genome = random_genome(4000, seed=11, n_rate=0.01)
    reads = reads_from_genome(genome, 2500, 100, seed=12)
    k = 21

    store = SortedKmerStore.create(k)
    table = KmerTable.create(k, capacity=1 << 14)
    model = collections.Counter()
    step = 300  # uneven batches exercise the LSM merge policy
    for i in range(0, len(reads), step):
        chunk = reads[i : i + step]
        codes = codes_to_batch([ascii_to_codes(r) for r in chunk])
        store.ingest_codes(codes)
        table = table.ingest_codes(codes)
        for r in chunk:
            model.update(kmers_from_ascii_ref(r, k))

    assert store.to_dict() == dict(model)
    assert store.to_dict() == table.to_dict()
    assert store.n_unique() == len(model)
    assert store.n_total() == sum(model.values())
    np.testing.assert_array_equal(store.histogram(100), table.histogram(100))

    queries = np.concatenate([
        np.array(list(model)[:400], np.uint64),
        rng.integers(0, 1 << 42, size=400, dtype=np.uint64),
    ])
    np.testing.assert_array_equal(
        store.lookup_directional(queries), table.lookup_directional(queries)
    )


def test_prefix_scan_matches_hashtable():
    genome = random_genome(3000, seed=21)
    reads = reads_from_genome(genome, 800, 90, seed=22)
    k = 15
    store = SortedKmerStore.create(k)
    table = KmerTable.create(k, capacity=1 << 13)
    codes = codes_to_batch([ascii_to_codes(r) for r in reads])
    store.ingest_codes(codes)
    table = table.ingest_codes(codes)

    oligo = np.array([seq_to_kmer(genome[100:109])], np.uint64)
    k1, c1 = table.prefix_scan(oligo, 9, min_count=1)
    k2, c2 = store.prefix_scan(oligo, 9, min_count=1)
    assert sorted(zip(k1.tolist(), c1.tolist())) == sorted(
        zip(k2.tolist(), c2.tolist())
    )
    assert len(k2) > 0


def test_pending_runs_flush_on_query():
    s = SortedKmerStore.create(7)
    for i in range(5):
        s.insert_kmers(np.arange(i * 10, i * 10 + 10, dtype=np.uint64))
    # queries must see everything regardless of pending state
    assert s.n_unique() == 50
    assert s.n_total() == 50


def test_sharded_sorted_matches_single():
    import jax

    from sharkmer_tpu.parallel.sorted_sharded import ShardedSortedStore
    from sharkmer_tpu.parallel.sharded_table import make_mesh

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    genome = random_genome(4000, seed=31, n_rate=0.005)
    reads = reads_from_genome(genome, 1500, 100, seed=32)
    k = 21

    single = SortedKmerStore.create(k)
    sharded = ShardedSortedStore.create(k, mesh, local_capacity=1 << 12)
    step = 400
    for i in range(0, len(reads), step):
        codes = codes_to_batch([ascii_to_codes(r) for r in reads[i : i + step]])
        single.ingest_codes(codes)
        sharded.ingest_codes(codes)

    assert sharded.to_dict() == single.to_dict()
    assert sharded.n_unique() == single.n_unique()
    assert sharded.n_total() == single.n_total()
    np.testing.assert_array_equal(sharded.histogram(100), single.histogram(100))

    rng = np.random.default_rng(4)
    queries = np.concatenate([
        np.array(list(single.to_dict().keys())[:300], np.uint64),
        rng.integers(0, 1 << 42, size=300, dtype=np.uint64),
    ])
    np.testing.assert_array_equal(
        sharded.lookup_directional(queries), single.lookup_directional(queries)
    )


def test_sharded_sorted_growth():
    import jax

    from sharkmer_tpu.parallel.sorted_sharded import ShardedSortedStore
    from sharkmer_tpu.parallel.sharded_table import make_mesh

    mesh = make_mesh(4)
    store = ShardedSortedStore.create(19, mesh, local_capacity=1 << 6)
    rng = np.random.default_rng(5)
    kmers = rng.integers(0, 1 << 38, size=5000, dtype=np.uint64)
    store.insert_kmers(kmers)
    import collections

    model = collections.Counter(kmers.tolist())
    assert store.to_dict() == dict(model)
    assert store.local_capacity > 1 << 6


def test_engine_sharded_sorted_backend():
    from sharkmer_tpu.engine import CountingEngine

    genome = random_genome(2000, seed=41)
    reads = [r.encode() for r in reads_from_genome(genome, 1000, 90, seed=42)]
    e1 = CountingEngine(k=17, n_chunks=3, histo_max=60, initial_capacity=1 << 12)
    e1.ingest(iter(reads))
    v1 = e1.consolidate()
    e8 = CountingEngine(k=17, n_chunks=3, histo_max=60,
                        initial_capacity=1 << 12, n_shards=8)
    e8.ingest(iter(reads))
    v8 = e8.consolidate()
    assert e1.stats.__dict__ == e8.stats.__dict__
    for a, b in zip(v1, v8):
        np.testing.assert_array_equal(a, b)
    assert e8.table.to_dict() == e1.table.to_dict()


def test_range_scan_matches_sweep_oracle():
    """The sorted store's range-query prefix_scan (ops/reach.py) must
    equal the hash backend's full-sweep scan on both orientations,
    across oligo lengths, including misses."""
    from sharkmer_tpu.ops.encoding import seq_to_kmer

    genome = random_genome(3000, seed=51)
    reads = reads_from_genome(genome, 900, 90, seed=52)
    k = 15
    store = SortedKmerStore.create(k)
    table = KmerTable.create(k, capacity=1 << 13)
    codes = codes_to_batch([ascii_to_codes(r) for r in reads])
    store.ingest_codes(codes)
    table = table.ingest_codes(codes)

    rng = np.random.default_rng(6)
    for olen in (5, 9, 14):
        # oligos drawn from the genome on both strands + random misses
        oligos = []
        for _ in range(20):
            pos = int(rng.integers(0, len(genome) - olen))
            oligos.append(seq_to_kmer(genome[pos : pos + olen]))
        oligos += [int(x) for x in rng.integers(0, 1 << (2 * olen), size=10)]
        oligos = np.array(sorted(set(oligos)), np.uint64)

        for mc in (1, 2):
            k1, c1 = table.prefix_scan(oligos, olen, min_count=mc)
            k2, c2 = store.prefix_scan(oligos, olen, min_count=mc)
            assert sorted(zip(k1.tolist(), c1.tolist())) == sorted(
                zip(k2.tolist(), c2.tolist())
            ), f"olen={olen} mc={mc}"


def test_full_mirror_lookup_matches_device():
    from sharkmer_tpu.pcr.counts import FilteredTable

    genome = random_genome(2000, seed=61)
    reads = reads_from_genome(genome, 600, 80, seed=62)
    store = SortedKmerStore.create(17)
    store.ingest_codes(codes_to_batch([ascii_to_codes(r) for r in reads]))
    ftm = FilteredTable(store, 2, mode="full")
    ftd = FilteredTable(store, 2, mode="device")
    rng = np.random.default_rng(7)
    queries = np.concatenate([
        np.array(list(store.to_dict())[:300], np.uint64),
        rng.integers(0, 1 << 34, size=300, dtype=np.uint64),
    ])
    np.testing.assert_array_equal(
        ftm.get_canonical_many(queries), ftd.get_canonical_many(queries)
    )
    ftm.warm_caches()
    assert ftm.mirror_rows() > 0


def test_partition_splitting_differential():
    """Tiny max_agg forces many partitions and splits; results must
    still match a dict model exactly."""
    import collections

    rng = np.random.default_rng(77)
    store = SortedKmerStore.create(21)
    store.max_agg = 1 << 8  # 256-entry ceiling -> constant splitting
    model = collections.Counter()
    for _ in range(6):
        batch = rng.integers(0, 1 << 12, size=700, dtype=np.uint64)
        store.insert_kmers(batch)
        model.update(batch.tolist())
    assert len(store._flushed().parts) > 1
    assert store.to_dict() == dict(model)
    assert store.n_unique() == len(model)
    assert store.n_total() == sum(model.values())
    # partitions stay within budget and are globally ordered
    s = store._flushed()
    prev_last = -1
    for p in s.parts:
        assert p.n <= s.part_budget
        keys = np.asarray(p.kmers[: p.n])
        assert (np.diff(keys.astype(np.int64)) > 0).all() if p.n > 1 else True
        assert int(keys[0]) > prev_last
        prev_last = int(keys[-1])
    # lookups across partition boundaries
    queries = np.array(list(model)[:200] + [1 << 40], np.uint64)
    got = store.lookup_directional(queries)
    from sharkmer_tpu.ops.encoding import revcomp_kmer

    for q, g in zip(queries.tolist(), got.tolist()):
        canon = min(q, revcomp_kmer(q, 21))
        assert g == model.get(canon, model.get(q, 0)) or g == model.get(q, 0)


def test_prefix_scan_overflow_grows_and_retries():
    """A low-complexity oligo matching more table entries than max_out
    must grow the output width and complete, not raise
    (VERDICT round 1, item 7)."""
    k = 9
    olen = 3
    oligo = seq_to_kmer("AAA")
    # many distinct k-mers all starting with AAA (canonical: keep kmers
    # whose forward form is already canonical)
    kmers = [(int(oligo) << (2 * (k - olen))) | low for low in range(64)]
    store = SortedKmerStore.create(k)
    store.insert_kmers(np.array(kmers, np.uint64))
    got_k, got_c = store.prefix_scan(
        np.array([oligo], np.uint64), olen, min_count=1, max_out=4
    )
    assert len(got_k) >= 32  # far more than max_out
    assert all(int(c) >= 1 for c in got_c)

    from sharkmer_tpu.ops import KmerTable as _KT

    table = _KT.create(k, capacity=1 << 10)
    table = table.insert_kmers(np.array(kmers, np.uint64))
    got_k2, got_c2 = table.prefix_scan(
        np.array([oligo], np.uint64), olen, min_count=1, max_out=4
    )
    assert sorted(zip(got_k.tolist(), got_c.tolist())) == sorted(
        zip(got_k2.tolist(), got_c2.tolist())
    )


def test_streamed_export_chunk_boundaries(monkeypatch):
    """The streamed packed-plane decode must be exact across transfer
    chunk boundaries: cumsum carry between chunks, escapes landing on
    and around boundaries, counts in the high byte."""
    import sharkmer_tpu.ops.sorted_store as ss

    monkeypatch.setattr(ss, "EXPORT_CHUNK", 64)
    rng = np.random.default_rng(7)
    # dense keys (small deltas) with a few huge gaps (delta escapes)
    # planted exactly at multiples of the chunk width
    deltas = rng.integers(1, 1 << 20, size=500, dtype=np.uint64)
    deltas[64] = 1 << 30  # escape on a chunk boundary
    deltas[63] = 1 << 31  # escape just before one
    deltas[200] = 1 << 40
    keys = np.cumsum(deltas).astype(np.uint64)
    counts = rng.integers(1, 1000, size=500, dtype=np.uint32)
    counts[128] = 70_000  # count escape on a boundary
    s = SortedKmerStore.create(31)
    s.insert_kmers(keys, counts)
    got_k, got_c = s.to_sorted_arrays()
    np.testing.assert_array_equal(got_k, keys)
    np.testing.assert_array_equal(got_c, counts)
    # filtered export through the same streamed path
    got_k, got_c = s.to_sorted_arrays(min_count=500)
    keep = counts >= 500
    np.testing.assert_array_equal(got_k, keys[keep])
    np.testing.assert_array_equal(got_c, counts[keep])


def test_compressed_export_escapes():
    """to_sorted_arrays' delta/escape transfer encoding must be exact
    for huge counts (u16 escapes), huge key gaps (u32 delta escapes),
    and sparse large-k stores (raw fallback)."""
    # counts above u16 via explicit-count inserts
    s = SortedKmerStore.create(21)
    ks = np.array([5, 9, 1 << 41], np.uint64)  # gap >> u32 -> key escape
    cs = np.array([70_000, 2, 0xFFFFFFFF], np.uint32)
    s.insert_kmers(ks, cs)
    got_k, got_c = s.to_sorted_arrays()
    assert got_k.tolist() == [5, 9, 1 << 41]
    assert got_c.tolist() == [70_000, 2, 0xFFFFFFFF]

    # sparse k=31 store: nearly every delta escapes; must still be exact
    rng = np.random.default_rng(3)
    s = SortedKmerStore.create(31)
    keys = np.unique(rng.integers(0, 1 << 62, size=5000, dtype=np.uint64))
    s.insert_kmers(keys, np.ones(len(keys), np.uint32))
    got_k, got_c = s.to_sorted_arrays()
    np.testing.assert_array_equal(got_k, keys)
    assert (got_c == 1).all()

    # counts in (255, 65535]: u8-wire escapes, no u16 escapes
    s = SortedKmerStore.create(21)
    ks = np.array([11, 13, 17, 19], np.uint64)
    cs = np.array([1, 300, 255, 65_535], np.uint32)
    s.insert_kmers(ks, cs)
    got_k, got_c = s.to_sorted_arrays()
    assert got_k.tolist() == ks.tolist()
    assert got_c.tolist() == cs.tolist()


def test_filtered_export_matches_host_filter():
    """to_sorted_arrays(min_count=m) (device-side pre-filter) must
    equal the host-filtered full export, across partition splits."""
    rng = np.random.default_rng(41)
    store = SortedKmerStore.create(21)
    store.max_agg = 1 << 10  # force multiple partitions
    for _ in range(4):
        batch = rng.integers(0, 1 << 14, size=900, dtype=np.uint64)
        store.insert_kmers(batch)
    full_k, full_c = store.to_sorted_arrays()
    for m in (1, 2, 3, 10):
        got_k, got_c = store.to_sorted_arrays(min_count=m)
        keep = full_c >= m
        np.testing.assert_array_equal(got_k, full_k[keep])
        np.testing.assert_array_equal(got_c, full_c[keep])
    # empty result when nothing clears the bar
    got_k, got_c = store.to_sorted_arrays(min_count=1 << 30)
    assert len(got_k) == 0 and len(got_c) == 0


def test_scan_below_view_threshold_sees_subthreshold_rows():
    """find_primer_matches with a min_count below the view's own
    threshold must still see sub-threshold rows (scans always go to
    the unfiltered device table, whatever the view's mode)."""
    from sharkmer_tpu.pcr.counts import FilteredTable

    k = 9
    olen = 4
    oligo = seq_to_kmer("ACGT")
    base = int(oligo) << (2 * (k - olen))
    store = SortedKmerStore.create(k)
    store.insert_kmers(
        np.array([base | 1, base | 2], np.uint64),
        np.array([1, 5], np.uint32),
    )
    for mode in ("auto", "full", "device"):
        ft = FilteredTable(store, min_count=3, mode=mode)
        ft.warm_caches()
        got_k, got_c = ft.find_primer_matches(
            np.array([oligo], np.uint64), olen, min_count=1
        )
        assert sorted(got_c.tolist()) == [1, 5], mode


def test_ghost_rows_invisible_to_queries():
    """Ghost rows (zero-count duplicates of a live key, left by the
    ghosted drain) must be invisible to lookups, histograms, unique
    counts and the host export."""
    import jax.numpy as jnp

    from sharkmer_tpu.ops import sorted_store as ss

    keys = np.array([5, 9, 9, 12, ss.EMPTY], np.uint64)  # 9 ghosted
    counts = np.array([3, 7, 0, 2, 0], np.uint32)
    store = SortedKmerStore.create(21)
    store.parts = [ss._Part(jnp.asarray(keys), jnp.asarray(counts), 4, 0)]
    got = store.lookup(np.array([5, 9, 12, 13], np.uint64))
    assert list(np.asarray(got)) == [3, 7, 2, 0]
    h = store.histogram(10)
    assert int(h.sum()) == 3  # ghost row contributes nothing
    assert store.n_unique() == 3  # lazy real count skips the ghost
    ks, cs = store.to_sorted_arrays()
    assert list(ks) == [5, 9, 12] and list(cs) == [3, 7, 2]


def test_prefix_scan_many_matches_per_request():
    """The one-dispatch batched panel scan (_panel_scan_kernel) must
    match per-request prefix_scan exactly: mixed oligo lengths, shared
    rows across requests (per-request forward precedence), and a
    max_out overflow retry."""
    from sharkmer_tpu.pcr.primers import string_to_oligo

    k = 11
    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    reads = reads_from_genome(genome, 900, 80, seed=2)
    store = SortedKmerStore.create(k)
    store.ingest_codes(codes_to_batch([ascii_to_codes(r) for r in reads]))

    requests = []
    for olen, n_oligos in ((5, 40), (7, 12), (9, 6), (6, 1)):
        raws = set()
        for _ in range(n_oligos):
            p = rng.integers(0, len(genome) - olen)
            raws.add(genome[p : p + olen])
        oligos = np.array(
            sorted(string_to_oligo(o)[0] for o in raws), np.uint64
        )
        requests.append((oligos, olen))
    # duplicate request: identical oligo sets must yield identical rows
    requests.append(requests[0])

    batched = store.prefix_scan_many(requests, max_out=64)  # forces retry
    assert len(batched) == len(requests)
    for (oligos, olen), (bk, bc) in zip(requests, batched):
        sk, sc = store.prefix_scan(oligos, olen, min_count=1)
        assert sorted(zip(bk.tolist(), bc.tolist())) == sorted(
            zip(sk.tolist(), sc.tolist())
        ), f"olen={olen}"


def test_staged_merge_batching_differential():
    """Drained runs are STAGED into per-partition pending batches and
    consolidated lazily (one aggregate per budget-full instead of one
    per drain). Interleaving inserts with reads (which force
    consolidation) and crossing many split boundaries must stay exact
    vs a dict model."""
    import collections

    rng = np.random.default_rng(78)
    store = SortedKmerStore.create(21)
    store.max_agg = 1 << 9
    model = collections.Counter()
    for i in range(12):
        # skewed batches: mostly clustered keys so single partitions
        # absorb whole batches and pending builds up before a split
        lo = (i % 3) * (1 << 11)
        batch = rng.integers(lo, lo + (1 << 11), size=900,
                             dtype=np.uint64)
        store.insert_kmers(batch)
        model.update(batch.tolist())
        if i % 4 == 3:  # mid-stream read forces consolidation
            assert store.n_unique() == len(model)
    assert store.to_dict() == dict(model)
    assert store.n_total() == sum(model.values())
    assert store._staged is None


def test_ghosted_fresh_drain_differential():
    """The fresh-drain ghosted fast path (no compaction sort) must
    surface EXACTLY the same counts as the compacted path through
    every consumer: dict export, lookups, histogram, n_unique, and a
    later compacted drain merging on top."""
    import collections

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 10, size=3000, dtype=np.uint64)
    model = collections.Counter(keys.tolist())

    store = SortedKmerStore.create(21)
    store.max_agg = 1 << 12
    store.insert_kmers(keys)
    assert store.n_unique() == len(model)  # folds the staged run
    # ghost rows present: padded occupancy above distinct keys
    assert sum(p.n for p in store.parts) > len(model)
    assert store.to_dict() == dict(model)
    assert store.n_total() == sum(model.values())
    q = np.array(list(model)[:64], np.uint64)
    got = np.asarray(store.lookup(q))
    np.testing.assert_array_equal(
        got, [model[int(x)] for x in q])

    # a second batch drains through the compacted path and merges over
    # the ghosted partitions exactly
    keys2 = rng.integers(0, 1 << 10, size=2500, dtype=np.uint64)
    model.update(keys2.tolist())
    store.insert_kmers(keys2)
    assert store.to_dict() == dict(model)
    assert store.n_total() == sum(model.values())


# -- drains against numpy (the XLA formulations are the only drain path) ----


def _drain_buffer(n: int, k: int, seed: int) -> np.ndarray:
    """Heavy duplication, one long run, and a sentinel tail."""
    from sharkmer_tpu.ops.sorted_store import EMPTY

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, (1 << (2 * k)) - 1, size=n // 6, dtype=np.uint64)
    buf = pool[rng.integers(0, len(pool), size=n)]
    buf[: n // 16] = pool[0]
    buf[-(n // 9):] = EMPTY
    rng.shuffle(buf)
    return buf


def _numpy_counts(buf):
    from sharkmer_tpu.ops.sorted_store import EMPTY

    keys, counts = np.unique(buf[buf != EMPTY], return_counts=True)
    return keys, counts.astype(np.uint32)


@pytest.mark.parametrize("k", [17, 19, 21, 25, 31])
def test_compacting_drain_matches_numpy(k):
    """The compacting drain (packed route for k <= 22, kv route above)
    equals numpy.unique, with a sentinel tail behind the uniques."""
    import jax.numpy as jnp

    from sharkmer_tpu.ops.sorted_store import EMPTY, _aggregate_ingest_jit

    buf = _drain_buffer(1 << 14, k, seed=k)
    keys, counts = _numpy_counts(buf)
    uk, uc, n = _aggregate_ingest_jit(jnp.asarray(buf), count_bits=64 - 2 * k)
    assert int(n) == len(keys)
    uk, uc = np.asarray(uk), np.asarray(uc)
    np.testing.assert_array_equal(uk[: len(keys)], keys)
    np.testing.assert_array_equal(uc[: len(keys)], counts)
    assert (uk[len(keys):] == EMPTY).all() and (uc[len(keys):] == 0).all()


@pytest.mark.parametrize("k", [17, 19, 21, 25, 31])
def test_ghosted_drain_matches_numpy(k):
    """The ghosted drain keeps the full sorted array: each run's total
    at its first row, zero-count ghosts behind it."""
    import jax.numpy as jnp

    from sharkmer_tpu.ops.sorted_store import (
        EMPTY,
        _aggregate_ingest_ghosted_jit,
    )

    buf = _drain_buffer(1 << 14, k, seed=100 + k)
    keys, counts = _numpy_counts(buf)
    sk, sc, n_p, n_r = _aggregate_ingest_ghosted_jit(jnp.asarray(buf))
    sk, sc = np.asarray(sk), np.asarray(sc)
    assert int(n_r) == len(keys)
    assert int(n_p) == int((buf != EMPTY).sum())
    np.testing.assert_array_equal(sk, np.sort(buf))
    live = sc > 0
    np.testing.assert_array_equal(sk[live], keys)
    np.testing.assert_array_equal(sc[live], counts)


def test_drain_packed_compaction_matches_kv():
    """The packed single-sort compaction (k <= 21) must be bit-identical
    to the kv-sort compaction, including the n_unique count."""
    import jax.numpy as jnp

    from sharkmer_tpu.ops.sorted_store import _aggregate_ingest_impl

    rng = np.random.default_rng(3)
    # 42-bit keyspace (k=21) with heavy duplication + sentinel tail
    buf = rng.integers(0, 1 << 42, size=4096, dtype=np.uint64)
    buf = np.concatenate([buf, buf[:1024], buf[:64],
                          np.full(512, (1 << 64) - 1, np.uint64)])
    k_kv, c_kv, n_kv = _aggregate_ingest_impl(jnp.asarray(buf), 0)
    k_pk, c_pk, n_pk = _aggregate_ingest_impl(jnp.asarray(buf), 22)
    assert int(n_kv) == int(n_pk)
    np.testing.assert_array_equal(np.asarray(k_kv), np.asarray(k_pk))
    np.testing.assert_array_equal(np.asarray(c_kv), np.asarray(c_pk))


def test_merge_aggregate_packed_matches_kv():
    """_aggregate_impl with count_bits set must match the kv formulation
    for benign counts (packed route), for counts exceeding the packed
    field (runtime kv fallback), and for the all-ones key edge case."""
    import jax.numpy as jnp

    from sharkmer_tpu.ops.sorted_store import _aggregate_impl

    rng = np.random.default_rng(11)
    kmers = rng.integers(0, 1 << 42, size=2048, dtype=np.uint64)
    kmers = np.concatenate([kmers, kmers[:512],
                            np.full(256, (1 << 64) - 1, np.uint64)])

    for counts in (
        rng.integers(1, 200, size=len(kmers), dtype=np.uint32),  # packed
        rng.integers(1, 1 << 31, size=len(kmers), dtype=np.uint32),  # kv
    ):
        c = counts.copy()
        c[-256:] = 0  # sentinel padding carries zero counts
        ref = _aggregate_impl(jnp.asarray(kmers), jnp.asarray(c), 0)
        got = _aggregate_impl(jnp.asarray(kmers), jnp.asarray(c), 22)
        assert int(ref[2]) == int(got[2])
        np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(got[0]))
        np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(got[1]))

    # a real key equal to 2^2k-1 must force the kv route and stay exact
    kmers2 = np.array([5, (1 << 42) - 1, (1 << 42) - 1, 9], np.uint64)
    counts2 = np.array([3, 4, 5, 1], np.uint32)
    ref = _aggregate_impl(jnp.asarray(kmers2), jnp.asarray(counts2), 0)
    got = _aggregate_impl(jnp.asarray(kmers2), jnp.asarray(counts2), 22)
    assert int(ref[2]) == int(got[2]) == 3
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(got[0]))
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(got[1]))


def test_drain_packed_overflow_falls_back_exactly():
    """A run total that saturates the packed count field must trigger
    the runtime kv fallback and stay exact (poly-A class repeats)."""
    import jax.numpy as jnp

    from sharkmer_tpu.ops.sorted_store import _aggregate_ingest_impl

    # count_bits=20 -> cap 2^20-1; one key repeated 2^20+5 times
    reps = (1 << 20) + 5
    buf = np.concatenate([
        np.full(reps, 7, np.uint64),
        np.arange(100, 200, dtype=np.uint64),
        np.full(123, (1 << 64) - 1, np.uint64),
    ])
    k_o, c_o, n_o = _aggregate_ingest_impl(jnp.asarray(buf), 20)
    assert int(n_o) == 101
    keys = np.asarray(k_o)[:101]
    counts = np.asarray(c_o)[:101]
    assert keys[0] == 7 and counts[0] == reps
    np.testing.assert_array_equal(keys[1:], np.arange(100, 200))
    assert (counts[1:] == 1).all()


def test_ghosted_seed_never_splits_a_key_across_partitions():
    """A ghosted first drain wider than one partition is cut into
    partitions; a cut inside a key's run of ghost rows must not leave
    the key in two partitions, where a later drain's counts would land
    in the second one."""
    k = 21
    first = np.concatenate([
        np.arange(100, 600, dtype=np.uint64),  # 500 singletons
        np.full(60, 700, np.uint64),           # a run across the cut at 512
        np.arange(800, 1264, dtype=np.uint64),
    ])
    second = np.concatenate([
        np.full(5, 700, np.uint64), np.arange(2000, 2200, dtype=np.uint64),
    ])
    store = SortedKmerStore.create(k)
    store.max_agg = 1 << 10  # partitions of 512 rows
    store.insert_kmers(first)
    store.insert_kmers(second)
    want = collections.Counter(first.tolist()) + collections.Counter(
        second.tolist()
    )
    assert len(store._flushed().parts) > 1
    assert store.to_dict() == dict(want)
    assert store.n_unique() == len(want)
    expect = np.zeros(102, np.uint64)
    for c in want.values():
        expect[min(c, 101)] += 1
    np.testing.assert_array_equal(store.histogram(100), expect)
