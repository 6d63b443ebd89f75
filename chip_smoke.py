"""Smoke run of the count + chunked spectra + sPCR path on one NVIDIA GPU.

    python chip_smoke.py          # one card: phases 0-4
    python chip_smoke.py --four   # four cards: the --n-shards 4 phase only

Phases (every comparison is exact: keys are u64, counts u32):

0. device: the platform must be ``gpu``; prints the card's name and power
   limit, the device kind, count and allocatable memory, and whether the
   native FASTQ reader was built and loaded (it must be);
1. drains at the device table's production width: the packed (k=19) and
   key-value (k=31) compacting drains and the ghosted drain, each against
   ``numpy.unique``, with ``compiled.memory_analysis()`` of each program;
2. the CLI end to end (``sharkmer_tpu.main.main``) on 2,000,000 synthetic
   150 bp reads with the cnidaria amplicons embedded: ``.final.histo``
   against a plain numpy count, 7/7 genes, every product inside its
   embedded amplicon;
3. chunked spectra (``--chunks 10``): every column against the numpy
   histogram of its round-robin chunk prefix;
4. sPCR from the saved table with host lookups (``--mirror full``): the
   FASTA files must be byte-identical to phase 2's;
5. (``--four``) phase 2 with the table sharded over four cards.

The numpy reference here is independent of ``sharkmer_tpu.ops``. The last
line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
PANEL = "cnidaria"
N_READS = 2_000_000  # a depth of the reference's benchmark matrix
GENOME_MBP = 20.0
K = 19
HISTO_MAX = 10000
N_CHUNKS = 10
READS_PER_CHUNK_GROUP = 1000  # the CLI's round-robin granularity

_T0 = time.perf_counter()


def say(msg: str) -> None:
    print(f"[smoke +{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


class PhaseError(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# -- plain numpy reference ---------------------------------------------------

_CODE = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
_CODE[ord("N")] = 4


def read_fastq_seqs(path: Path) -> list[bytes]:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    return lines[1::4][: len(lines) // 4]


def encode_reads(seqs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Reads as an [n, L] code array (N-padded) and their lengths."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    width = int(lens.max()) if len(seqs) else 0
    if len(seqs) and (lens == width).all():
        raw = np.frombuffer(b"".join(seqs), np.uint8).reshape(-1, width)
    else:
        raw = np.full((len(seqs), width), ord("N"), np.uint8)
        for i, s in enumerate(seqs):
            raw[i, : len(s)] = np.frombuffer(s, np.uint8)
    codes = _CODE[raw]
    if (codes == 255).any():
        raise ValueError("reads hold characters other than ACGTN")
    return codes, lens


def window_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(canonical k-mers [n, L-k+1] u64, valid mask) of a code array.

    Forward and reverse-complement words of every window are built by
    binary doubling: words of length a at j and length b at j + a
    concatenate to a word of length a + b at j, so k = 19 takes six
    concatenations (1-2-4-8-16, +2, +1) instead of k shifted ORs.
    """
    n, width = codes.shape
    w = width - k + 1
    if w <= 0:
        return np.zeros((n, 0), np.uint64), np.zeros((n, 0), bool)
    c = np.minimum(codes, 3).astype(np.uint64)

    def cat(a, b):
        (fa, ra, la), (fb, rb, lb) = a, b
        wid = width - (la + lb) + 1
        fwd = (fa[:, :wid] << np.uint64(2 * lb)) | fb[:, la : la + wid]
        rev = (rb[:, la : la + wid] << np.uint64(2 * la)) | ra[:, :wid]
        return fwd, rev, la + lb

    powers = [(c, np.uint64(3) - c, 1)]
    while 2 * powers[-1][2] <= k:
        powers.append(cat(powers[-1], powers[-1]))
    word = None
    for p in reversed(powers):
        if p[2] & k:
            word = p if word is None else cat(word, p)
    fwd, rev, _ = word
    bad = np.concatenate(
        [np.zeros((n, 1), np.int64), np.cumsum(codes == 4, axis=1)], axis=1
    )
    valid = (bad[:, k:] - bad[:, :w]) == 0
    return np.minimum(fwd[:, :w], rev[:, :w]), valid


def _slab_counts(seqs: list[bytes], start: int, k: int, n_chunks: int):
    """Sorted unique (k-mer << 4 | chunk) tags of one slab of reads,
    with their counts. Read i belongs to chunk (i // 1000) % n_chunks."""
    codes, _ = encode_reads(seqs)
    km, valid = window_kmers(codes, k)
    chunk = (
        (np.arange(start, start + codes.shape[0]) // READS_PER_CHUNK_GROUP)
        % n_chunks
    ).astype(np.uint64)
    tag = (km << np.uint64(4)) | chunk[:, None]
    return np.unique(tag[valid], return_counts=True)


def _bucket_spectra(pieces, n_chunks: int, histo_max: int) -> np.ndarray:
    """Prefix spectra contribution of one key-range bucket: ``pieces``
    are (tags, counts) from every slab, all tags of a k-mer inside it."""
    tags = np.concatenate([p[0] for p in pieces])
    cnts = np.concatenate([p[1] for p in pieces])
    keys, inv = np.unique(tags, return_inverse=True)
    counts = np.bincount(inv, weights=cnts, minlength=len(keys)).astype(
        np.int64
    )
    kmer = keys >> np.uint64(4)
    chunk = (keys & np.uint64(15)).astype(np.int64)
    new = np.concatenate([[True], kmer[1:] != kmer[:-1]])
    run = np.cumsum(new) - 1
    cum = np.cumsum(counts)
    base = (cum - counts)[new][run]
    total = cum - base  # count of the k-mer through this chunk
    nxt = np.where(
        np.concatenate([~new[1:], [False]]),
        np.concatenate([chunk[1:], [n_chunks]]), n_chunks,
    )
    bins = np.minimum(total, histo_max + 1)
    # each (k-mer, chunk) row holds the k-mer's count for chunk prefixes
    # [chunk, next chunk of the same k-mer): add +1 there, -1 after
    width = histo_max + 2
    size = (n_chunks + 1) * width
    return (
        np.bincount(chunk * width + bins, minlength=size)
        - np.bincount(nxt * width + bins, minlength=size)
    )


def reference_spectra(seqs: list[bytes], k: int, n_chunks: int,
                      histo_max: int, slab: int = 50_000) -> np.ndarray:
    """[n_chunks, histo_max + 2] count-of-counts of each chunk prefix.

    Every k-mer is tagged with its chunk, ``np.unique`` counts each
    (k-mer, chunk) pair, and a cumulative sum over a k-mer's chunks
    gives its count in every prefix. Column 0 stays 0; column
    histo_max + 1 folds the tail, as the CLI's histograms do. Slabs of
    reads, then key-range buckets, run on a thread pool (numpy releases
    the interpreter lock in its sorts and ufuncs).
    """
    from concurrent.futures import ThreadPoolExecutor

    workers = max(1, min(8, os.cpu_count() or 1))
    starts = range(0, len(seqs), slab)
    with ThreadPoolExecutor(workers) as pool:
        slabs = list(pool.map(
            lambda s: _slab_counts(seqs[s : s + slab], s, k, n_chunks),
            starts,
        ))
        # bucket bounds on k-mer boundaries (tag low 4 bits zero)
        n_buckets = 4 * workers
        edges = [
            np.uint64(((1 << (2 * k)) * b // n_buckets) << 4)
            for b in range(1, n_buckets)
        ]
        split = [np.searchsorted(u, edges) for u, _ in slabs]
        buckets = [
            [
                (u[lo:hi], c[lo:hi])
                for (u, c), cut in zip(slabs, split)
                for lo, hi in [(
                    0 if b == 0 else cut[b - 1],
                    len(u) if b == n_buckets - 1 else cut[b],
                )]
            ]
            for b in range(n_buckets)
        ]
        del slabs
        diff = sum(pool.map(
            lambda p: _bucket_spectra(p, n_chunks, histo_max), buckets
        ))
    width = histo_max + 2
    return np.cumsum(diff.reshape(n_chunks + 1, width), axis=0)[:n_chunks]


def read_histo(path: Path) -> np.ndarray:
    """[n_columns, histo_max + 2] from a .histo or .final.histo file."""
    rows = [
        ln.split("\t") for ln in path.read_text().splitlines()[2:] if ln
    ]
    cols = np.array([[int(x) for x in r[1:]] for r in rows], np.int64).T
    return np.concatenate(
        [np.zeros((cols.shape[0], 1), np.int64), cols], axis=1
    )


def _rc(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def read_fasta(path: Path) -> list[str]:
    seqs, cur = [], []
    for ln in path.read_text().splitlines():
        if ln.startswith(">"):
            if cur:
                seqs.append("".join(cur))
            cur = []
        else:
            cur.append(ln.strip())
    if cur:
        seqs.append("".join(cur))
    return seqs


# -- phases ------------------------------------------------------------------


def phase_device(n_expected: int) -> dict:
    import jax

    from sharkmer_tpu import device
    from sharkmer_tpu.io import native

    d = device.describe()
    check(d["platform"] == "gpu",
          f"no GPU: JAX runs on {d['platform']} ({d['kind']})")
    check(d["count"] >= n_expected,
          f"{n_expected} GPU(s) needed, {d['count']} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    limit = jax.devices()[0].memory_stats()["bytes_limit"]
    say(f"device kind {d['kind']!r}, count {d['count']}, "
        f"bytes_limit {limit}")
    s = device.settings()
    say(f"device table: max_agg 2^{s.max_agg.bit_length() - 1}, "
        f"spcr_index_rows 2^{s.spcr_index_rows.bit_length() - 1}")
    ok = native.available()
    say(f"native FASTQ reader built and loaded: {ok} ({native.lib_path()})")
    check(ok, "the native FASTQ reader did not build")
    return d


def _drain_case(name, lower, buf_host, expect_keys, expect_counts,
                ghosted):
    import jax
    import jax.numpy as jnp

    compiled = lower(jnp.asarray(buf_host)).compile()
    say(f"  {name}: memory_analysis {compiled.memory_analysis()}")
    times = []
    for _ in range(3):
        buf = jnp.asarray(buf_host)
        jax.block_until_ready(buf)
        t0 = time.perf_counter()
        out = compiled(buf)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    keys, counts = np.asarray(out[0]), np.asarray(out[1])
    n_real = int(out[-1])
    check(n_real == len(expect_keys),
          f"{name}: {n_real} unique keys, numpy says {len(expect_keys)}")
    if ghosted:
        live = counts > 0
        keys, counts = keys[live], counts[live]
    check(np.array_equal(keys[: len(expect_keys)], expect_keys),
          f"{name}: keys differ from numpy.unique")
    check(np.array_equal(counts[: len(expect_keys)], expect_counts),
          f"{name}: counts differ from numpy.unique")
    say(f"  {name}: exact; wall {min(times) * 1e3:.1f} ms "
        f"(best of 3, first light)")


def drain_buffer(width: int, k: int, seed: int) -> np.ndarray:
    """Seeded keys with heavy duplication and a sentinel tail."""
    rng = np.random.default_rng(seed)
    n_live = width - width // 8
    pool = rng.integers(0, (1 << (2 * k)) - 1, size=width // 4,
                        dtype=np.uint64)
    buf = np.full(width, np.uint64(0xFFFF_FFFF_FFFF_FFFF))
    buf[:n_live] = pool[rng.integers(0, len(pool), size=n_live)]
    buf[: width // 64] = pool[0]  # one long run
    return buf


def phase_drains() -> None:
    from sharkmer_tpu import device
    from sharkmer_tpu.ops import sorted_store as ss

    width = device.settings().max_agg
    say(f"phase 1: drains at width 2^{width.bit_length() - 1}")
    for k, seed in ((19, 1), (31, 2)):
        buf = drain_buffer(width, k, seed)
        live = buf[buf != np.uint64(0xFFFF_FFFF_FFFF_FFFF)]
        keys, counts = np.unique(live, return_counts=True)
        route = "packed" if 64 - 2 * k >= 20 else "kv"
        _drain_case(
            f"compacting drain k={k} ({route})",
            lambda b, cb=64 - 2 * k: ss._aggregate_ingest_jit.lower(
                b, count_bits=cb
            ),
            buf, keys, counts.astype(np.uint32), ghosted=False,
        )
        if k == 19:
            _drain_case(
                "ghosted drain k=19", ss._aggregate_ingest_ghosted_jit.lower,
                buf, keys, counts.astype(np.uint32), ghosted=True,
            )


def run_cli(argv: list[str]) -> None:
    from sharkmer_tpu.main import main

    say("sharkmer " + " ".join(argv))
    t0 = time.perf_counter()
    rc = main(argv)
    check(rc == 0, f"CLI exited {rc}")
    say(f"  CLI wall {time.perf_counter() - t0:.1f} s (first light)")


def check_genes(outdir: Path, sample: str, amplicons: dict) -> dict:
    from sharkmer_tpu.pcr.panels import load_yaml

    stats = load_yaml((outdir / f"{sample}.stats.yaml").read_text())
    results = {r["gene_name"]: r for r in stats["pcr_results"]}
    check(len(results) == len(amplicons),
          f"{len(results)} genes run, {len(amplicons)} expected")
    files = {}
    for gene, amp in amplicons.items():
        name = f"{PANEL}_{gene}"
        r = results.get(name)
        check(r is not None and r["status"] == "success",
              f"{name}: {r and r.get('failure_reason')}")
        fasta = outdir / f"{sample}_{name}.fasta"
        for seq in read_fasta(fasta):
            check(seq in amp or _rc(seq) in amp,
                  f"{name}: a {len(seq)} bp product is not inside the "
                  f"embedded {len(amp)} bp amplicon")
        files[name] = fasta.read_bytes()
    say(f"  {len(results)}/{len(amplicons)} genes recovered, every product "
        "inside its embedded amplicon")
    return files


def synth(n_reads: int) -> tuple[Path, dict]:
    sys.path.insert(0, str(ROOT / "scripts"))
    from sharkmer_validate.synth import (
        embedded_amplicons,
        synthesize_panel_fastq,
    )

    panel = ROOT / "sharkmer_tpu" / "panels" / f"{PANEL}.yaml"
    fq = WORK / f"{PANEL}_{n_reads}.fastq.gz"
    t0 = time.perf_counter()
    synthesize_panel_fastq(panel, fq, n_reads, genome_mbp=GENOME_MBP)
    say(f"synthetic reads: {fq.name} ({time.perf_counter() - t0:.1f} s)")
    return fq, embedded_amplicons(panel, genome_mbp=GENOME_MBP)


def reference(fq: Path) -> np.ndarray:
    from sharkmer_tpu.ops.encoding import kmers_from_ascii_ref

    t0 = time.perf_counter()
    seqs = read_fastq_seqs(fq)
    check(len(seqs) == N_READS, f"{len(seqs)} reads in {fq.name}")
    # the vectorised encoder agrees with the rolling reference encoder
    codes, _ = encode_reads(seqs[:200])
    km, valid = window_kmers(codes, K)
    for i, s in enumerate(seqs[:200]):
        check(km[i][valid[i]].tolist() == kmers_from_ascii_ref(s.decode(), K),
              f"numpy encoder disagrees with the rolling encoder, read {i}")
    spectra = reference_spectra(seqs, K, N_CHUNKS, HISTO_MAX)
    say(f"numpy reference spectra ({time.perf_counter() - t0:.1f} s)")
    return spectra


def phase_cli(fq: Path, amplicons: dict, spectra: np.ndarray) -> dict:
    out = WORK / "count"
    table = WORK / "table.npz"
    say("phase 2: CLI count + sPCR")
    run_cli([str(fq), "-s", "smoke", "-k", str(K), "--chunks", "1",
             "--pcr-panel", PANEL, "--save-table", str(table),
             "-o", str(out)])
    final = read_histo(out / "smoke.final.histo")[0]
    check(np.array_equal(final, spectra[-1]),
          ".final.histo differs from the numpy reference")
    say("  .final.histo equals the numpy reference")
    return check_genes(out, "smoke", amplicons)


def phase_chunks(fq: Path, spectra: np.ndarray) -> None:
    out = WORK / "chunks"
    say(f"phase 3: chunked spectra (--chunks {N_CHUNKS})")
    run_cli([str(fq), "-s", "smoke", "-k", str(K), "--chunks",
             str(N_CHUNKS), "-o", str(out)])
    got = read_histo(out / "smoke.histo")
    check(got.shape[0] == N_CHUNKS, f"{got.shape[0]} histogram columns")
    for c in range(N_CHUNKS):
        check(np.array_equal(got[c], spectra[c]),
              f"chunk {c + 1} differs from the numpy prefix histogram")
    say(f"  all {N_CHUNKS} columns equal the numpy prefix histograms")


def phase_mirror(fasta_auto: dict) -> None:
    out = WORK / "mirror"
    say("phase 4: sPCR from the saved table with host lookups")
    run_cli(["--load-table", str(WORK / "table.npz"), "-s", "smoke",
             "-k", str(K), "--pcr-panel", PANEL, "--mirror", "full",
             "-o", str(out)])
    for name, data in fasta_auto.items():
        got = (out / f"smoke_{name}.fasta").read_bytes()
        check(got == data, f"{name}: --mirror full FASTA differs")
    say(f"  {len(fasta_auto)} FASTA files byte-identical to phase 2")


def phase_four(fq: Path, amplicons: dict, spectra: np.ndarray) -> None:
    out = WORK / "four"
    say("phase 5: CLI with the table sharded over 4 cards")
    run_cli([str(fq), "-s", "smoke", "-k", str(K), "--chunks", "1",
             "--n-shards", "4", "--pcr-panel", PANEL, "-o", str(out)])
    final = read_histo(out / "smoke.final.histo")[0]
    check(np.array_equal(final, spectra[-1]),
          "sharded .final.histo differs from the numpy reference")
    say("  .final.histo equals the numpy reference")
    check_genes(out, "smoke", amplicons)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card --n-shards 4 phase")
    args = ap.parse_args(argv)

    import sharkmer_tpu  # noqa: F401  (enables x64 before jax use)

    n_dev = 4 if args.four else 1
    dev = phase_device(n_dev)
    WORK.mkdir(parents=True, exist_ok=True)
    fq, amplicons = synth(N_READS)
    if args.four:
        spectra = reference(fq)
        phase_four(fq, amplicons, spectra)
    else:
        phase_drains()
        spectra = reference(fq)
        fasta = phase_cli(fq, amplicons, spectra)
        phase_chunks(fq, spectra)
        phase_mirror(fasta)
    say("all phases passed")
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev["platform"], "kind": dev["kind"],
                   "count": dev["count"]},
    }))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
