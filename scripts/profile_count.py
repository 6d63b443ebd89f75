#!/usr/bin/env python3
"""Per-stage decomposition of the count loop's drain on the device.

Times each stage of the production drain at the 1M-read workload width
(2^27 raw k-mers by default): the flat u64 sort, the run-start scan
(``lax.cummax``) of the compacting drain, the reverse run-end scan
(``lax.cummin``) of the ghosted drain, the packed compaction sort, both
full drains, and the final histogram sweep. Each line is the median
wall of ``--iters`` calls after a warm-up call, every call ending in
``block_until_ready``; the device's name is printed first.

Usage:  python scripts/profile_count.py [--width 27] [--iters 5] [--k 19]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sharkmer_tpu  # noqa: E402,F401  (enables x64)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def timeit(label, fn, iters):
    jax.block_until_ready(fn())  # compile + warm
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    dt = statistics.median(walls)
    print(f"{label:44s} {dt * 1e3:9.2f} ms  (median of {iters})",
          flush=True)
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=27)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--k", type=int, default=19)
    args = ap.parse_args()
    n = 1 << args.width
    k = args.k
    cb = 64 - 2 * k

    from sharkmer_tpu import device
    from sharkmer_tpu.ops.sorted_store import (
        EMPTY,
        SortedKmerStore,
        _aggregate_ingest_ghosted_jit,
        _aggregate_ingest_jit,
    )

    # ~5x duplication like the 1M-read noisy workload
    rng = np.random.default_rng(0)
    uniq = rng.integers(0, (1 << (2 * k)) - 1, size=n // 5, dtype=np.uint64)
    buf = jnp.asarray(uniq[rng.integers(0, len(uniq), size=n)])
    print(f"device {device.describe()}; width 2^{args.width} = {n} "
          f"k-mers, k={k}, {len(uniq)} distinct", flush=True)

    sort = jax.jit(lambda x: jax.lax.sort(x, is_stable=False))
    t_sort = timeit("flat u64 sort (lax.sort)", lambda: sort(buf),
                    args.iters)
    sk = sort(buf)

    @jax.jit
    def run_starts(sk):
        pos = jnp.arange(sk.shape[0], dtype=jnp.int32)
        first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
        return jax.lax.cummax(jnp.where(first, pos, 0))

    @jax.jit
    def run_ends(sk):
        pos = jnp.arange(sk.shape[0], dtype=jnp.int32)
        last = jnp.concatenate([sk[:-1] != sk[1:], jnp.ones((1,), bool)])
        return jax.lax.cummin(
            jnp.where(last, pos, jnp.int32(0x7FFF_FFFF)), reverse=True
        )

    t_max = timeit("run starts: lax.cummax (int32)",
                   lambda: run_starts(sk), args.iters)
    t_min = timeit("run ends: reverse lax.cummin (int32)",
                   lambda: run_ends(sk), args.iters)

    @jax.jit
    def packed_compaction(sk):
        rs = run_starts(sk)
        pos = jnp.arange(sk.shape[0], dtype=jnp.int32)
        last = jnp.concatenate([sk[:-1] != sk[1:], jnp.ones((1,), bool)])
        total = (pos - rs + 1).astype(jnp.uint64)
        packed = jnp.where(
            last & (sk != jnp.uint64(EMPTY)),
            (sk << jnp.uint64(cb)) | total,
            jnp.uint64(0xFFFF_FFFF_FFFF_FFFF),
        )
        return packed

    packed = packed_compaction(sk)
    timeit("packed compaction sort (lax.sort)", lambda: sort(packed),
           args.iters)
    # the drain kernels DONATE their input: hand each call a fresh
    # device-side copy (its cost is in the line below)
    t_copy = timeit("device copy of the buffer",
                    lambda: buf + jnp.uint64(0), args.iters)
    t_c = timeit("compacting drain (sort+cummax+compaction)",
                 lambda: _aggregate_ingest_jit(buf + jnp.uint64(0),
                                               count_bits=cb),
                 args.iters)
    t_g = timeit("ghosted drain (sort+cummin+counts)",
                 lambda: _aggregate_ingest_ghosted_jit(buf + jnp.uint64(0)),
                 args.iters)
    print(f"scan share: cummax {t_max / (t_c - t_copy):.1%} of the "
          f"compacting drain, cummin {t_min / (t_g - t_copy):.1%} of the "
          f"ghosted drain; sort {t_sort / (t_c - t_copy):.1%} of the "
          f"compacting drain", flush=True)

    store = SortedKmerStore.create(k)
    store.insert_kmers(buf + jnp.uint64(0))
    store.flush()
    timeit("histogram(10000) on seeded store",
           lambda: store.histogram(10_000), args.iters)


if __name__ == "__main__":
    main()
