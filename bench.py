"""Benchmark: k-mer counting throughput AND sPCR wall time on one device.

Prints ONE JSON line:
  {"device": {"platform": P, "kind": K, "count": C},
   "metric": "kmers_per_sec_per_chip", "value": N, "unit": "kmer/s",
   "vs_baseline": N, "spcr_wall_s": S, "spcr_genes_ok": G,
   "mirror_export_s": M, "e2e_wall_s": E, "e2e_vs_baseline": R,
   "e2e_8m_wall_s": E8, "e2e_8m_vs_baseline": R8, ...}

Baseline: the reference counts 131,779,117 k-mer events from 1M
150bp reads in 22.5 s wall INCLUDING its full 7-gene cnidaria sPCR
pass (169.1 s at 8M reads), on an aarch64 12-core at 8 threads —
5.857e6 kmer/s (BASELINE.md, from the reference's own committed
benchmark results).

The default (sorted backend) run reproduces that workload shape:
1M synthetic 150bp reads at ~7.5x coverage over a genome with the
cnidaria panel's 7 amplicons embedded, k=21, **with 1% per-base
substitution errors** — the reference's numbers come from real ENA
reads, and error k-mers inflate the unique-key load ~5x and create
the tips/bubbles the pruning machinery exists for, so an error-free
bench materially understates the workload. "value" times the core
count loop (encode + drain + merges + final spectrum); spcr_wall_s
times the full 7-gene panel through run_pcr against the built table;
mirror_export_s is the one-time sPCR index/export prep; e2e_wall_s is
count + prep + sPCR vs the reference's 22.5 s. A second timed config
at 8M reads (the reference's largest committed row, 169.1 s) reports
e2e_8m_wall_s / e2e_8m_vs_baseline.

Every result names the device it ran on (platform, device kind,
device count). The bench refuses to run on the CPU unless
``JAX_PLATFORMS=cpu`` was set explicitly (``--quick`` smoke runs), so
a missing accelerator never yields a CPU number under a device name.

Process layout: a thin orchestrator (no JAX) runs the measured pass as
one subprocess, then a --cache-evidence subprocess that replays the
warmup stages in a FRESH process and reports persistent compile-cache
hits/misses and the warm-process warmup wall. The subprocesses run in
sequence, so one process at a time holds the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_T0 = time.perf_counter()


def _stage(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _hbm(tag: str) -> None:
    """Device memory in use at a stage boundary (localizes
    RESOURCE_EXHAUSTED). The CPU backend keeps no memory statistics;
    an accelerator that reports none is an error."""
    import jax

    dev = jax.devices()[0]
    ms = dev.memory_stats()
    if ms is None:
        if dev.platform == "cpu":
            return
        raise RuntimeError(f"{dev.device_kind} reports no memory_stats()")
    _stage(f"  device mem[{tag}]: {ms['bytes_in_use'] / 1e9:.2f} GB "
           f"(peak {ms['peak_bytes_in_use'] / 1e9:.2f})")


def _device() -> dict:
    """The device this process measures on. Refuses the CPU unless
    JAX_PLATFORMS=cpu was set explicitly."""
    from sharkmer_tpu import device

    d = device.describe()
    _stage(f"device: platform={d['platform']} kind={d['kind']} "
           f"count={d['count']}")
    if d["platform"] == "cpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(
            "bench: no accelerator found (JAX fell back to the CPU); set "
            "JAX_PLATFORMS=cpu to run on the CPU deliberately"
        )
    return d

BASELINE_KMERS_PER_SEC = 131_779_117 / 22.5
BASELINE_E2E_WALL_S = 22.5   # reference: 1M-read cnidaria run, count+sPCR
BASELINE_E2E_8M_WALL_S = 169.1  # reference: same panel at 8M reads

GEN_SLAB = 1_000_000  # reads generated per host slab (bounds peak RAM)


def make_genome_codes(genome_mbp: float, seed: int = 0,
                      panel: str | None = None) -> np.ndarray:
    """uint8-code genome; optionally embeds one exact amplicon per
    primer pair of ``panel`` (IUPAC positions realized concretely)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=int(genome_mbp * 1e6), dtype=np.uint8)
    if panel is None:
        return genome
    from sharkmer_tpu.ops.encoding import ascii_to_codes
    from sharkmer_tpu.pcr.panels import get_panel
    from sharkmer_tpu.pcr.params import IUPAC

    rc = str.maketrans("ACGT", "TGCA")
    pos = 1000
    for p in get_panel(panel):
        fwd = "".join(
            c if c in "ACGT" else rng.choice(list(IUPAC[c]))
            for c in p.forward_seq
        )
        rev = "".join(
            c if c in "ACGT" else rng.choice(list(IUPAC[c]))
            for c in p.reverse_seq
        )
        total = p.expected_length or (p.min_length + p.max_length) // 2
        insert = "".join(
            rng.choice(list("ACGT"), size=total - len(fwd) - len(rev))
        )
        amp = fwd + insert + rev.translate(rc)[::-1]
        # panel targets are high-copy genes (rRNA repeats, mito): embed
        # 8 copies so amplicon k-mers sit well above min_count at ~7.5x
        # genome-wide coverage, like real data
        codes = ascii_to_codes(amp)
        for _ in range(8):
            genome[pos : pos + len(codes)] = codes
            pos += len(codes) + 2000
    return genome


def make_reads_codes(n_reads: int, read_len: int, genome_mbp: float,
                     seed: int = 0, panel: str | None = None,
                     error_rate: float = 0.01):
    """Reads as uint8 code batches sliced straight out of a code genome.

    ``error_rate`` injects uniform random substitution errors per base
    (Illumina-like ~0.3-1%), the workload shape the reference's real
    ENA benchmarks have. Reads are generated in GEN_SLAB slabs so the
    error-mask temporaries never exceed ~1 GB even at 8M reads."""
    rng = np.random.default_rng(seed)
    genome = make_genome_codes(genome_mbp, seed, panel)
    out = np.empty((n_reads, read_len), np.uint8)
    col = np.arange(read_len)[None, :]
    for s in range(0, n_reads, GEN_SLAB):
        n = min(GEN_SLAB, n_reads - s)
        starts = rng.integers(0, len(genome) - read_len, size=n)
        reads = genome[starts[:, None] + col]
        if error_rate > 0.0:
            err = rng.random(reads.shape) < error_rate
            # substitute with a DIFFERENT base: add 1..3 mod 4
            shift = rng.integers(1, 4, size=reads.shape, dtype=np.uint8)
            reads = np.where(err, (reads + shift) % 4, reads).astype(np.uint8)
        out[s : s + n] = reads
    return out


def build_parser() -> argparse.ArgumentParser:
    """Shared by profile_spcr.py so profiles track bench defaults."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--reads", type=int, default=1_000_000)
    parser.add_argument("--reads-large", type=int, default=8_000_000,
                        help="second timed config (0 disables); the "
                             "reference's largest committed row")
    parser.add_argument("--read-len", type=int, default=150)
    parser.add_argument("--k", type=int, default=21)
    parser.add_argument("--genome-mbp", type=float, default=20.0)
    parser.add_argument("--batch", type=int, default=1 << 18)
    parser.add_argument("--capacity", type=int, default=1 << 26)
    parser.add_argument("--backend", choices=["sorted", "hash"],
                        default="sorted")
    parser.add_argument("--panel", default="cnidaria",
                        help="panel whose amplicons are embedded + amplified")
    parser.add_argument("--threads", type=int, default=4,
                        help="gene-level sPCR thread pool")
    parser.add_argument("--error-rate", type=float, default=0.01,
                        help="per-base sequencing-error rate for the reads")
    parser.add_argument("--mirror", choices=["auto", "full", "device"],
                        default="auto",
                        help="sPCR lookup strategy (auto = device "
                             "reach-prefetch, full = host mirror export)")
    parser.add_argument("--quick", action="store_true",
                        help="small shapes for smoke testing")
    parser.add_argument("--inner", action="store_true",
                        help="(internal) run the measured bench itself")
    parser.add_argument("--cache-evidence", action="store_true",
                        help="(internal) replay warmup in a fresh "
                             "process, report compile-cache hits")
    parser.add_argument("--no-evidence", action="store_true",
                        help="skip the second-process cache-evidence run")
    return parser


def main():
    args = build_parser().parse_args()
    if args.quick:
        args.reads, args.batch = 50_000, 1 << 14
        args.capacity, args.genome_mbp = 1 << 22, 1.0
        args.reads_large = 0
    if args.cache_evidence:
        return run_cache_evidence(args)
    if args.inner:
        return run_bench(args)
    # orchestrator: never touches JAX, so the measured subprocess and
    # the cache-evidence subprocess each get the device exclusively
    argv = [a for a in sys.argv[1:] if a != "--no-evidence"]
    rc = subprocess.call([sys.executable, __file__, "--inner", *argv])
    if rc != 0:
        sys.exit(rc)
    if not (args.quick or args.no_evidence):
        _stage("cache evidence: fresh-process warmup replay")
        subprocess.call([sys.executable, __file__, "--cache-evidence", *argv])


def _count_cache_events():
    """Attach a counting handler to the persistent-cache log channel.
    Returns the mutable counter dict {hits, writes}."""
    import logging

    counts = {"hits": 0, "writes": 0}

    class _H(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "Persistent compilation cache hit" in msg:
                counts["hits"] += 1
            elif "persistent compilation cache" in msg:
                counts["writes"] += 1

    lg = logging.getLogger("jax._src.compiler")
    lg.setLevel(logging.DEBUG)
    lg.addHandler(_H())
    lg.propagate = False  # count quietly: keep DEBUG spam off stderr
    return counts


def _make_store_factory(args):
    if args.backend == "sorted":
        from sharkmer_tpu.ops.sorted_store import SortedKmerStore

        def make_store():
            return SortedKmerStore.create(args.k)
    else:
        from sharkmer_tpu.ops.hashtable import KmerTable

        def make_store():
            return KmerTable.create(args.k, capacity=args.capacity)
    return make_store


def _build_batches(args, n_reads: int, seed: int = 0):
    import jax.numpy as jnp

    codes_all = make_reads_codes(
        n_reads, args.read_len, args.genome_mbp, seed=seed,
        panel=args.panel, error_rate=args.error_rate,
    )
    n_batches = -(-n_reads // args.batch)
    pad = n_batches * args.batch - n_reads
    if pad:
        codes_all = np.concatenate(
            [codes_all, np.full((pad, args.read_len), 5, np.uint8)]
        )
    return [
        jnp.asarray(codes_all[b * args.batch : (b + 1) * args.batch])
        for b in range(n_batches)
    ], n_batches


def _one_pass(make_store, batches, consume: bool = False):
    store = make_store()
    for i, codes in enumerate(batches):
        # SortedKmerStore mutates and returns self; KmerTable is
        # functional and returns the updated table — rebind for both
        store = store.ingest_codes(codes)
        if consume:  # free each batch's device buffer as it lands
            batches[i] = None
    if hasattr(store, "flush"):
        store.flush()
    histo = store.histogram(10_000)
    return store, int(np.sum(histo))


def _spcr_phase(args, store, n_reads: int):
    """sPCR prep + full panel against ``store``. Returns
    (prep_wall, spcr_wall, genes_ok, n_genes)."""
    import tempfile

    from sharkmer_tpu.pcr.counts import FilteredTable
    from sharkmer_tpu.pcr.graph import compute_node_budget
    from sharkmer_tpu.pcr.panels import get_panel
    from sharkmer_tpu.stats import run_pcr

    panel_params = get_panel(args.panel)
    _hbm("pre-spcr")
    t0 = time.perf_counter()
    filtered = FilteredTable(store, min_count=2, mode=args.mirror)
    # one-time device index build (auto) or full device->host export
    # (full); reported as mirror_export_s for round-over-round
    # comparability
    filtered.warm_caches()
    prep_wall = time.perf_counter() - t0
    _hbm("post-index")

    # same dynamic node budget the CLI resolves (graph.rs:40-52)
    max_nodes = compute_node_budget(n_reads * args.read_len)
    with tempfile.TemporaryDirectory() as outdir:
        _stage(f"timed: sPCR panel, {n_reads} reads "
               f"(node budget {max_nodes})")
        t0 = time.perf_counter()
        results = run_pcr(
            filtered, panel_params, "bench", outdir + "/",
            max_nodes=max_nodes, threads=args.threads,
        )
        spcr_wall = time.perf_counter() - t0
    genes_ok = sum(1 for r in results if r.status == "success")
    for r in results:
        tag = "+" if r.status == "success" else "-"
        _stage(f"  {tag} {r.gene_name} ({len(r.product_lengths)} "
               f"product(s) {r.product_lengths})")
    return prep_wall, spcr_wall, genes_ok, len(panel_params)


def _warm_scale_shapes(args, make_store):
    """Compile the deep-table (8M-read-class) program set off the
    timed path: drains that fold into a multi-partition master, the
    merge/split/routing kernels, the deep histogram, and the sPCR
    index + panel-scan programs at deployment partition widths.

    Junk keys are generated ON DEVICE (shapes depend on occupancies,
    never on values) with the noisy workload's two-component
    structure: a ~19% stream of error singletons (1-(1-err)^k) over a
    high-duplication genome pool, reproducing the production per-drain
    run occupancies and the master's partition trajectory. The warmup
    pays the compile bill of these shapes once, off the clock, exactly
    like the 1M warmup does for the shallow shapes."""
    import gc

    import jax
    import jax.numpy as jnp

    from sharkmer_tpu.ops.sorted_store import _default_max_agg
    from sharkmer_tpu.pcr.counts import FilteredTable
    from sharkmer_tpu.pcr.panels import get_panel
    from sharkmer_tpu.pcr.primers import warm_panel_scans

    events = args.reads_large * (args.read_len - args.k + 1)
    width = _default_max_agg()
    n_drains = -(-events // width)
    pool = max(int(args.genome_mbp * 1.25e6), 1)
    sing_frac = 1.0 - (1.0 - args.error_rate) ** args.k
    mask = jnp.uint64((1 << (2 * args.k)) - 1)

    def mix64(z):  # SplitMix64 finalizer: sparse uniform keys, like
        z = z * jnp.uint64(0x9E3779B97F4A7C15)  # real canonical kmers
        z = (z ^ (z >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
        return z ^ (z >> jnp.uint64(31))

    def junk(seed):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        g_idx = jax.random.randint(
            k1, (width,), 0, np.int64(pool), dtype=jnp.int64
        ).astype(jnp.uint64)
        s_idx = (
            jnp.uint64(1 << 48)
            + jnp.uint64(seed) * jnp.uint64(width)
            + jnp.arange(width, dtype=jnp.uint64)
        )
        pick = jax.random.uniform(k2, (width,)) < sing_frac
        return jnp.where(
            pick, mix64(s_idx) & mask, mix64(g_idx + jnp.uint64(1)) & mask
        )

    junk_jit = jax.jit(junk)
    store = make_store()
    for d in range(n_drains):
        store.insert_kmers(junk_jit(d))
        store.flush()
    store.histogram(10_000)
    _stage("  junk warmup partition widths "
           f"{[int(p.kmers.shape[0]) for p in getattr(store, 'parts', [])]}"
           f" ({store.n_unique_master()} unique)")
    filtered = FilteredTable(store, min_count=2, mode=args.mirror)
    filtered.warm_caches()
    warm_panel_scans(filtered, get_panel(args.panel))
    del filtered, store
    gc.collect()


def run_bench(args):
    """The measured pass (subprocess): warmup compiles every count +
    sPCR-prep shape, then the timed 1M config and the timed 8M config
    run back to back through the production store."""
    dev = _device()
    make_store = _make_store_factory(args)
    counters = _count_cache_events()

    _stage(f"generating {args.reads} reads "
           f"(error rate {args.error_rate})")
    batches, n_batches = _build_batches(args, args.reads)
    kmers_per_batch = args.batch * (args.read_len - args.k + 1)

    from sharkmer_tpu.pcr.counts import FilteredTable

    # warmup: compiles every kernel shape the timed passes will hit —
    # the count sequence AND the sPCR-prep (index/export) kernels
    _stage("warmup: count pass (compiles)")
    warm_store, _ = _one_pass(make_store, batches)
    _stage(f"warmup: sPCR prep, mode={args.mirror} (compiles)")
    warm_filtered = FilteredTable(warm_store, min_count=2, mode=args.mirror)
    warm_filtered.warm_caches()
    # panel-scan kernel shapes (one batched dispatch per panel)
    from sharkmer_tpu.pcr.panels import get_panel
    from sharkmer_tpu.pcr.primers import warm_panel_scans

    warm_panel_scans(warm_filtered, get_panel(args.panel))
    del warm_filtered, warm_store
    if args.reads_large and args.backend == "sorted":
        _stage("warmup: deep-table shapes for the "
               f"{args.reads_large}-read row (compiles)")
        _warm_scale_shapes(args, make_store)
    warmup_wall = time.perf_counter() - _T0
    _stage(f"warmup done ({counters['hits']} persistent-cache hits, "
           f"{counters['writes']} writes)")

    _stage("timed: count pass")
    t0 = time.perf_counter()
    store, n_unique = _one_pass(make_store, batches)
    count_wall = time.perf_counter() - t0
    total_kmers = n_batches * kmers_per_batch
    assert n_unique > 0
    del batches

    _stage(f"timed: sPCR prep (mode={args.mirror})")
    prep_wall, spcr_wall, genes_ok, n_genes = _spcr_phase(
        args, store, args.reads
    )
    del store

    kmers_per_sec = total_kmers / count_wall
    e2e_wall = count_wall + prep_wall + spcr_wall
    result = {
        "device": dev,
        "metric": "kmers_per_sec_per_chip",
        "value": round(kmers_per_sec),
        "unit": "kmer/s",
        "vs_baseline": round(kmers_per_sec / BASELINE_KMERS_PER_SEC, 3),
        "error_rate": args.error_rate,
        "spcr_wall_s": round(spcr_wall, 2),
        "spcr_genes_ok": f"{genes_ok}/{n_genes}",
        "mirror_export_s": round(prep_wall, 2),
        "e2e_wall_s": round(e2e_wall, 2),
        "e2e_vs_baseline": round(BASELINE_E2E_WALL_S / e2e_wall, 3),
        "warmup_wall_s": round(warmup_wall, 1),
    }

    # ---- 8M-read row (the reference's largest committed config) ----------
    if args.reads_large:
        import gc

        gc.collect()  # free the 1M store's device buffers first
        try:
            _stage(f"generating {args.reads_large} reads")
            batches8, n_batches8 = _build_batches(args, args.reads_large)
            _stage("timed: count pass (8M)")
            t0 = time.perf_counter()
            # consume=True: free each 40 MB batch after ingest so the
            # batches do not sit in device memory beside the merges
            store8, n_unique8 = _one_pass(
                make_store, batches8, consume=True
            )
            count8_wall = time.perf_counter() - t0
            _hbm("post-count-8m")
            del batches8
            gc.collect()
            total8 = n_batches8 * kmers_per_batch
            parts8 = [
                int(p.kmers.shape[0])
                for p in getattr(store8, "parts", [])
            ]
            _stage(f"timed: sPCR prep+panel (8M, {n_unique8} unique, "
                   f"partition widths {parts8})")
            h0, w0 = counters["hits"], counters["writes"]
            prep8, spcr8, genes_ok8, _ = _spcr_phase(
                args, store8, args.reads_large
            )
            if counters["writes"] > w0:
                # a cache WRITE inside the timed row = a mid-run
                # compile the deep-shape warmup missed; surface it
                _stage(
                    f"  WARNING: {counters['writes'] - w0} compile(s) "
                    f"({counters['hits'] - h0} cache hits) inside the "
                    "timed 8M sPCR phase — warmup shape gap"
                )
            del store8
            e2e8 = count8_wall + prep8 + spcr8
            result.update({
                "kmers_per_sec_8m": round(total8 / count8_wall),
                "spcr_8m_wall_s": round(prep8 + spcr8, 2),
                "spcr_8m_genes_ok": f"{genes_ok8}/{n_genes}",
                "e2e_8m_wall_s": round(e2e8, 2),
                "e2e_8m_vs_baseline": round(
                    BASELINE_E2E_8M_WALL_S / e2e8, 3
                ),
            })
        except Exception as e:  # never lose the 1M row's JSON line
            import traceback

            traceback.print_exc(file=sys.stderr)
            result["e2e_8m_error"] = f"{type(e).__name__}: {e}"[:200]

    print(json.dumps(result))


def run_cache_evidence(args):
    """Fresh-process warmup replay: every stage below was compiled by
    the measured subprocess moments ago, so a healthy persistent cache
    serves ALL of it as cache hits. Reports per-stage walls and the
    hit/write counts (the stderr tail carries the evidence)."""
    _device()
    counters = _count_cache_events()
    make_store = _make_store_factory(args)
    from sharkmer_tpu.pcr.counts import FilteredTable

    t0 = time.perf_counter()
    batches, _ = _build_batches(args, args.reads)
    gen_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    store, _ = _one_pass(make_store, batches)
    count_wall = time.perf_counter() - t0
    _stage(f"evidence: count warmup {count_wall:.1f}s "
           f"({counters['hits']} cache hits, {counters['writes']} writes)")

    hits0 = counters["hits"]
    t0 = time.perf_counter()
    FilteredTable(store, min_count=2, mode=args.mirror).warm_caches()
    prep_wall = time.perf_counter() - t0
    _stage(f"evidence: sPCR-prep warmup {prep_wall:.1f}s "
           f"({counters['hits'] - hits0} cache hits)")

    warm = count_wall + prep_wall
    verdict = "OK (<30s)" if warm < 30 else "SLOW (>=30s)"
    _stage(
        f"evidence: second-process warmup {warm:.1f}s excl. "
        f"{gen_wall:.1f}s host datagen — {verdict}; persistent cache: "
        f"{counters['hits']} hits, {counters['writes']} writes"
    )


if __name__ == "__main__":
    main()
