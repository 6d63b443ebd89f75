"""Tests for the device reachability prefetch (ops/reach.py) and the
prefetch session (pcr/prefetch.py).

Oracle: a python BFS over a dict model of the count table, expanding
every hit k-mer to its 8 de Bruijn neighbours — the same closure the
kernel computes. The session is differentially tested by running the
full sPCR pipeline in every lookup mode and asserting identical
products.
"""

import numpy as np
import pytest

from util import random_genome, reads_from_genome

from sharkmer_tpu.ops import ascii_to_codes, codes_to_batch
from sharkmer_tpu.ops.encoding import revcomp_kmer, seq_to_kmer
from sharkmer_tpu.ops.sorted_store import SortedKmerStore
from sharkmer_tpu.pcr.counts import FilteredTable


def build_store(genome: str, k: int, n_reads: int = 600,
                read_len: int = 80, seed: int = 1):
    reads = reads_from_genome(genome, n_reads, read_len, seed=seed)
    store = SortedKmerStore.create(k)
    store.ingest_codes(codes_to_batch([ascii_to_codes(r) for r in reads]))
    return store


def closure_oracle(model: dict[int, int], roots, min_count: int, k: int,
                   depth: int | None = None):
    """Python BFS: process roots (depth 0), expand hits 8 ways."""
    kmask = (1 << (2 * k)) - 1

    def canon(c):
        return min(c, revcomp_kmer(c, k))

    def hits(cands):
        out = set()
        for c in cands:
            cc = canon(c)
            if model.get(cc, 0) >= min_count:
                out.add(cc)
        return out

    visited = hits(roots)
    frontier = set(visited)
    level = 0
    while frontier and (depth is None or level < depth):
        cands = set()
        for f in frontier:
            for b in range(4):
                cands.add(((f << 2) | b) & kmask)
                cands.add((b << (2 * (k - 1))) | (f >> 2))
        frontier = hits(cands) - visited
        visited |= frontier
        level += 1
    return visited, not frontier


def test_reach_equals_oracle_full_closure():
    k = 11
    genome = random_genome(900, seed=3)
    store = build_store(genome, k)
    model = store.to_dict()

    pos = 200
    root_kmer = seq_to_kmer(genome[pos : pos + k])
    roots = np.array([root_kmer], np.uint64)

    for mc in (1, 2, 3):
        res = store.reach(roots, min_count=mc, depth=4096)
        oracle, complete = closure_oracle(model, [int(root_kmer)], mc, k)
        assert res is not None
        assert res.complete == complete
        got = dict(zip(res.keys.tolist(), res.counts.tolist()))
        want = {km: model[km] for km in oracle}
        assert got == want, f"mc={mc}: {len(got)} vs {len(want)} rows"


def test_reach_depth_cap_superset_guarantee():
    """A depth-capped closure must cover at least the oracle's
    depth-limited closure (the property the session's trusted-miss
    window relies on)."""
    k = 11
    genome = random_genome(3000, seed=4)
    store = build_store(genome, k, n_reads=1500)
    model = store.to_dict()
    root = seq_to_kmer(genome[1500 : 1500 + k])
    depth = 24

    res = store.reach(np.array([root], np.uint64), min_count=1, depth=depth)
    assert res is not None
    oracle_d, _ = closure_oracle(model, [int(root)], 1, k, depth=depth)
    got = set(res.keys.tolist())
    missing = oracle_d - got
    assert not missing, f"{len(missing)} rows missing from depth-{depth} closure"
    # and no rows outside the slightly deeper closure (sanity: the
    # kernel walks BFS levels, give transient walkers 2 levels slack)
    oracle_d2, _ = closure_oracle(model, [int(root)], 1, k, depth=depth + 2)
    assert got <= oracle_d2


def test_reach_multiple_roots_and_empty():
    k = 9
    genome = random_genome(400, seed=5)
    store = build_store(genome, k, n_reads=300, read_len=60)
    model = store.to_dict()
    roots = np.array(
        [seq_to_kmer(genome[i : i + k]) for i in (10, 100, 250)], np.uint64
    )
    res = store.reach(roots, min_count=1, depth=4096)
    oracle, complete = closure_oracle(
        model, [int(r) for r in roots], 1, k
    )
    assert res.complete == complete
    assert set(res.keys.tolist()) == oracle

    # roots that are all absent from the table
    res2 = store.reach(
        np.array([0xFFFF], np.uint64), min_count=1 << 20, depth=16
    )
    assert res2 is not None and res2.complete and len(res2.keys) == 0

    # empty root set
    res3 = store.reach(np.zeros(0, np.uint64), min_count=1, depth=16)
    assert res3.complete and len(res3.keys) == 0


def test_reach_multi_partition():
    """Closures must span partition boundaries (tiny max_agg forces
    several partitions)."""
    k = 11
    genome = random_genome(800, seed=6)
    import os

    store = SortedKmerStore.create(k)
    store.max_agg = 1 << 9  # tiny partitions
    reads = reads_from_genome(genome, 500, 70, seed=7)
    store.ingest_codes(codes_to_batch([ascii_to_codes(r) for r in reads]))
    assert len(store._flushed().parts) > 1
    model = store.to_dict()
    root = seq_to_kmer(genome[300 : 300 + k])
    res = store.reach(np.array([root], np.uint64), min_count=1, depth=4096)
    oracle, complete = closure_oracle(model, [int(root)], 1, k)
    assert res.complete == complete
    assert set(res.keys.tolist()) == oracle


def test_reach_overfull_bucket_wide_probe():
    """A dense cluster of contiguous keys can exceed the two-block
    probe window even at the LUT bits cap (26 bits at k=21 leaves
    2^16-key buckets). build_sidecar must widen probe_blocks instead
    of failing, and lookups in the overfull bucket must stay exact."""
    from sharkmer_tpu.ops import reach as reach_mod

    k = 21
    # 200 contiguous keys inside ONE cap-width bucket (bucket width
    # 2^(2k-26) = 2^16; base is bucket-aligned). Small keys are
    # canonical at k=21 (their revcomp has high bits set).
    base = 5 << 16
    cluster = np.arange(base, base + 200, dtype=np.uint64)
    scattered = (np.arange(40, dtype=np.uint64) + 1) << np.uint64(22)
    keys = np.concatenate([cluster, scattered])
    counts = np.full(keys.shape, 7, np.uint32)
    counts[:50] = 2  # below the threshold used below

    store = SortedKmerStore.create(k)
    store.insert_kmers(keys, counts)
    store.prepare_spcr()
    sidecars, _rc, _bases = store._spcr_index()
    assert max(s.probe_blocks for s in sidecars) > 2

    res = store.reach(cluster, min_count=3, depth=2)
    assert res is not None
    expected = set(cluster[50:].tolist())  # counts >= 3 only
    assert expected.issubset(set(res.keys.tolist()))
    got = dict(zip(res.keys.tolist(), res.counts.tolist()))
    for kk in expected:
        assert got[kk] == 7
    assert not (set(cluster[:50].tolist()) & set(res.keys.tolist()))


def test_reach_bubble_and_cycle_convergence():
    """Bubbles (SNP between repeated segments) and short cycles
    (tandem repeat) must converge, not loop forever."""
    k = 9
    seg = random_genome(120, seed=8)
    # bubble: two variants of the middle base; cycle: tandem repeat
    variant = seg[:60] + ("A" if seg[60] != "A" else "C") + seg[61:]
    cyc = random_genome(40, seed=9)
    genome = seg + variant + (cyc * 6) + seg
    store = build_store(genome, k, n_reads=900, read_len=60, seed=10)
    model = store.to_dict()
    root = seq_to_kmer(genome[5 : 5 + k])
    res = store.reach(np.array([root], np.uint64), min_count=1, depth=8192)
    assert res is not None
    oracle, complete = closure_oracle(model, [int(root)], 1, k)
    assert res.complete == complete
    assert set(res.keys.tolist()) == oracle


def test_session_matches_direct_lookups():
    """PrefetchSession.get_canonical_many must agree with the view's
    exact lookups for every count >= the session threshold, and report
    0 below it."""
    from sharkmer_tpu.pcr.prefetch import PrefetchSession

    k = 11
    genome = random_genome(1200, seed=11)
    store = build_store(genome, k, n_reads=900)
    view = FilteredTable(store, min_count=2, mode="auto")
    exact = FilteredTable(store, min_count=2, mode="device")

    for threshold in (2, 3):
        session = PrefetchSession(view, threshold, depth=16)
        # simulate a walk: waves of neighbours starting from a genome kmer
        cur = [seq_to_kmer(genome[600 : 600 + k])]
        kmask = (1 << (2 * k)) - 1
        for _ in range(40):
            cands = []
            for f in cur:
                for b in range(4):
                    cands.append(((f << 2) | b) & kmask)
                    cands.append((b << (2 * (k - 1))) | (f >> 2))
            cands = np.array(cands, np.uint64)
            got = session.get_canonical_many(cands)
            want = exact.get_canonical_many(cands)
            want[want < threshold] = 0
            np.testing.assert_array_equal(got, want)
            nxt = [int(c) for c, g in zip(cands.tolist(), got.tolist()) if g]
            if not nxt:
                break
            cur = nxt[:8]


def test_session_fallback_on_overflow(monkeypatch):
    """If the device closure overflows, the session must degrade to
    exact per-wave device lookups."""
    from sharkmer_tpu.pcr.prefetch import PrefetchSession

    k = 11
    genome = random_genome(600, seed=12)
    store = build_store(genome, k, n_reads=400)
    view = FilteredTable(store, min_count=1, mode="auto")
    monkeypatch.setattr(
        type(store), "reach", lambda self, r, m, d=None, pre=None: None
    )
    session = PrefetchSession(view, 1, depth=8)
    q = np.array([seq_to_kmer(genome[50 : 50 + k])], np.uint64)
    got = session.get_canonical_many(q)
    exact = FilteredTable(store, min_count=1, mode="device")
    np.testing.assert_array_equal(got, exact.get_canonical_many(q))
    assert session._dead


def test_do_pcr_identical_across_modes():
    """Full sPCR must produce byte-identical products in prefetch,
    full-mirror, and device modes — on noisy reads with bubbles."""
    from sharkmer_tpu.pcr.params import PCRParams
    from sharkmer_tpu.pcr.spcr import do_pcr

    rng = np.random.default_rng(13)
    bases = np.array(list("ACGT"))
    fwd = "".join(rng.choice(bases, size=20))
    rev = "".join(rng.choice(bases, size=20))
    comp = str.maketrans("ACGT", "TGCA")
    amplicon = fwd + "".join(rng.choice(bases, size=260)) + (
        rev.translate(comp)[::-1]
    )
    genome = (
        random_genome(400, seed=14) + amplicon + random_genome(400, seed=15)
    )
    # reads with 1% substitution errors
    reads = []
    for i in range(1400):
        p = int(rng.integers(0, len(genome) - 70))
        r = list(genome[p : p + 70])
        for j in range(len(r)):
            if rng.random() < 0.01:
                r[j] = str(rng.choice(bases))
        reads.append("".join(r))

    k = 17
    store = SortedKmerStore.create(k)
    store.ingest_codes(codes_to_batch([ascii_to_codes(r) for r in reads]))

    params = PCRParams(
        forward_seq=fwd, reverse_seq=rev, gene_name="modes",
        min_length=200, max_length=400, min_count=2,
    )
    results = {}
    for mode in ("auto", "full", "device"):
        ft = FilteredTable(store, min_count=2, mode=mode)
        outcome = do_pcr(ft, "s", params, max_num_nodes=20_000)
        results[mode] = [(r.rec_id, r.seq) for r in outcome.records]
    assert results["auto"] == results["full"] == results["device"]
    assert results["auto"], "no products recovered"


def test_sharded_reach_matches_single_chip():
    """The mesh-sharded closure must return exactly the single-chip
    closure's visited set (8-device CPU mesh)."""
    from sharkmer_tpu.parallel import make_mesh
    from sharkmer_tpu.parallel.sorted_sharded import ShardedSortedStore

    k = 11
    genome = random_genome(600, seed=21)
    reads = reads_from_genome(genome, 500, 70, seed=22)
    codes = codes_to_batch([ascii_to_codes(r) for r in reads])

    single = SortedKmerStore.create(k)
    single.ingest_codes(codes)

    mesh = make_mesh(8)
    sharded = ShardedSortedStore.create(k, mesh, local_capacity=1 << 12)
    sharded.ingest_codes(codes)

    roots = np.array(
        [seq_to_kmer(genome[i : i + k]) for i in (30, 200, 400)], np.uint64
    )
    for mc in (1, 3):
        r1 = single.reach(roots, min_count=mc, depth=4096)
        r2 = sharded.reach(roots, min_count=mc, depth=4096)
        assert r2 is not None
        assert r1.complete == r2.complete
        assert np.array_equal(r1.keys, r2.keys)
        assert np.array_equal(r1.counts, r2.counts)


def test_sharded_prefix_scan_matches_single_chip():
    from sharkmer_tpu.parallel import make_mesh
    from sharkmer_tpu.parallel.sorted_sharded import ShardedSortedStore

    k = 11
    genome = random_genome(600, seed=31)
    reads = reads_from_genome(genome, 400, 60, seed=32)
    codes = codes_to_batch([ascii_to_codes(r) for r in reads])
    single = SortedKmerStore.create(k)
    single.ingest_codes(codes)
    mesh = make_mesh(8)
    sharded = ShardedSortedStore.create(k, mesh, local_capacity=1 << 12)
    sharded.ingest_codes(codes)

    oligo = seq_to_kmer(genome[100:106])
    oligos = np.array([oligo], np.uint64)
    k1, c1 = single.prefix_scan(oligos, 6, 1)
    k2, c2 = sharded.prefix_scan(oligos, 6, 1)
    o1 = np.argsort(k1)
    o2 = np.argsort(k2)
    assert np.array_equal(k1[o1], k2[o2])
    assert np.array_equal(c1[o1], c2[o2])


def test_sharded_do_pcr_prefetch_matches_single():
    """Full sPCR against the mesh-sharded store in its deployment
    default (auto -> reach prefetch) must match the single-chip
    products byte for byte."""
    from sharkmer_tpu.parallel import make_mesh
    from sharkmer_tpu.parallel.sorted_sharded import ShardedSortedStore
    from sharkmer_tpu.pcr.params import PCRParams
    from sharkmer_tpu.pcr.spcr import do_pcr

    rng = np.random.default_rng(41)
    bases = np.array(list("ACGT"))
    fwd = "".join(rng.choice(bases, size=18))
    rev = "".join(rng.choice(bases, size=18))
    comp = str.maketrans("ACGT", "TGCA")
    amplicon = fwd + "".join(rng.choice(bases, size=200)) + (
        rev.translate(comp)[::-1]
    )
    genome = (
        random_genome(300, seed=42) + amplicon + random_genome(300, seed=43)
    )
    reads = []
    for i in range(1000):
        p = int(rng.integers(0, len(genome) - 60))
        reads.append(genome[p : p + 60])

    k = 15
    codes = codes_to_batch([ascii_to_codes(r) for r in reads])
    single = SortedKmerStore.create(k)
    single.ingest_codes(codes)
    mesh = make_mesh(8)
    sharded = ShardedSortedStore.create(k, mesh, local_capacity=1 << 12)
    sharded.ingest_codes(codes)

    params = PCRParams(
        forward_seq=fwd, reverse_seq=rev, gene_name="sharded",
        min_length=150, max_length=350, min_count=2,
    )
    out1 = do_pcr(FilteredTable(single, min_count=2, mode="auto"),
                  "s", params, max_num_nodes=20_000)
    out2 = do_pcr(FilteredTable(sharded, min_count=2, mode="auto"),
                  "s", params, max_num_nodes=20_000)
    assert [(r.rec_id, r.seq) for r in out1.records] == [
        (r.rec_id, r.seq) for r in out2.records
    ]
    assert out1.records, "no products recovered"


def test_warm_caches_degrades_when_index_build_fails(monkeypatch):
    """If the sPCR device-index build runs out of device memory (very
    large tables), warm_caches must fall back to the mirror mode and
    lookups must stay exact."""
    import jax

    k = 11
    genome = random_genome(500, seed=51)
    store = build_store(genome, k, n_reads=300)

    def boom(self):
        raise jax.errors.JaxRuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate"
        )

    monkeypatch.setattr(type(store), "prepare_spcr", boom)
    view = FilteredTable(store, min_count=1, mode="auto")
    view.warm_caches()
    assert view._resolved_mode() == "full"
    q = np.array([seq_to_kmer(genome[40 : 40 + k])], np.uint64)
    exact = FilteredTable(store, min_count=1, mode="device")
    np.testing.assert_array_equal(
        view.get_canonical_many(q), exact.get_canonical_many(q)
    )


def test_reach_spill_past_out_w():
    """Visited sets larger than the kernel's static OUT_W prefix spill
    to the wider log gather (ops/reach.py _spill_gather_kernel): 20k
    isolated k-mers used as their own roots all hit at level 0."""
    from sharkmer_tpu.ops.reach import OUT_W

    k = 21
    n = OUT_W + 4000
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 1 << (2 * k), size=3 * n, dtype=np.uint64)
    canon = np.unique(
        np.minimum(raw, np.array([revcomp_kmer(int(x), k) for x in raw],
                                 np.uint64))
    )[:n]
    assert len(canon) == n
    counts = rng.integers(2, 50, size=n, dtype=np.uint32)
    store = SortedKmerStore.create(k)
    store.insert_kmers(canon, counts)

    res = store.reach(canon, min_count=2, depth=64)
    assert res is not None and res.complete
    assert len(res.keys) == n
    np.testing.assert_array_equal(res.keys, canon)
    np.testing.assert_array_equal(res.counts, counts)


@pytest.mark.parametrize("error", [
    RuntimeError("RESOURCE_EXHAUSTED but not from the runtime"),
    ValueError("bad sidecar"),
    "internal",
])
def test_warm_caches_propagates_other_errors(monkeypatch, error):
    """Only a device out-of-memory error degrades the lookup mode; any
    other failure of the index build is a fault and propagates."""
    import jax

    if error == "internal":
        error = jax.errors.JaxRuntimeError("INTERNAL: kernel launch failed")
    store = build_store(random_genome(400, seed=52), 11, n_reads=200)

    def boom(self):
        raise error

    monkeypatch.setattr(type(store), "prepare_spcr", boom)
    view = FilteredTable(store, min_count=1, mode="auto")
    with pytest.raises(type(error)):
        view.warm_caches()


@pytest.mark.parametrize("k", [19, 31])
def test_reach_matches_host_lookups(k):
    """Closures at production k (19: count-packed probe blocks; 31: no
    spare bits, separate key and count blocks) against the host mirror
    BFS: same visited rows, same counts."""
    genome = random_genome(1200, seed=60 + k)
    store = build_store(genome, k, n_reads=700, read_len=100, seed=k)
    keys, counts = store.to_sorted_arrays()
    model = dict(zip(keys.tolist(), counts.tolist()))
    store.prepare_spcr()
    packed = [s.packed2d is not None for s in store._spcr_cache[1][0]]
    assert all(packed) == (64 - 2 * k >= 12)
    root = seq_to_kmer(genome[500 : 500 + k])
    for mc in (1, 2):
        res = store.reach(np.array([root], np.uint64), min_count=mc,
                          depth=4096)
        oracle, complete = closure_oracle(model, [int(root)], mc, k)
        assert res is not None and res.complete == complete
        got = dict(zip(res.keys.tolist(), res.counts.tolist()))
        assert got == {km: model[km] for km in oracle}
