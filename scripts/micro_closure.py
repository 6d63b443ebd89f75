"""Device microbenchmark: decompose the reach-closure per-level cost.

Times a while_loop of N fixed iterations whose body is a subset of the
production narrow-phase level body (ops/reach.py _closure_run), against
a single full partition (2^26 rows, the partition width of a 2^27
drain). Every timing ends in ``block_until_ready``. Reports ms/level:
  full        - the production body (lookup + process + mark + log)
  lookup      - probe gathers only
  process     - dedup argsorts only (lookup stubbed to arange)
  mark_log    - bitmap scatter + log update only
  empty       - loop overhead only
"""
from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from sharkmer_tpu import device
from sharkmer_tpu.ops import reach as R

print(f"device {device.describe()}", flush=True)
K = 21
N_ROWS = 1 << 26
F_NARROW = 16
LEVELS = 512

rng = np.random.default_rng(0)
keys = np.sort(rng.integers(0, 1 << (2 * K), size=N_ROWS, dtype=np.uint64))
keys = np.unique(keys)
pad = N_ROWS - len(keys)
keys = np.concatenate([keys, np.full(pad, R.EMPTY, np.uint64)])
counts = rng.integers(1, 100, size=N_ROWS, dtype=np.uint32)

sc = R.build_sidecar(jnp.asarray(keys), jnp.asarray(counts), K)
n_words = max(64, -(-N_ROWS // 32))
kmask = jnp.uint64((1 << (2 * K)) - 1)
inf = jnp.int32(R._INF32)


def make_lookup(mode, k2d, lut):
    shift = jnp.asarray(sc.shift, jnp.uint64)
    min_count = jnp.uint32(1)

    def lookup(cand):
        if mode == "stub":
            return jnp.where(
                cand != jnp.uint64(R.EMPTY),
                (cand & jnp.uint64(0xFFFFF)).astype(jnp.int32), inf)
        ids = jnp.full(cand.shape, inf)
        b = jnp.minimum(cand >> shift,
                        jnp.uint64(lut.shape[0] - 2)).astype(jnp.int64)
        s = lut[b]
        e = lut[b + 1]
        j0 = (s >> R._LOG2B).astype(jnp.int64)
        live = (cand != jnp.uint64(R.EMPTY)) & (e > s)
        jbs = [jnp.minimum(j0 + w, k2d.shape[0] - 1) for w in range(2)]
        blk = jnp.concatenate([k2d[j] for j in jbs], axis=-1)
        rows = (jnp.minimum(j0, k2d.shape[0] - 1) * R.BLOCK)[:, None] + \
            jnp.arange(2 * R.BLOCK, dtype=jnp.int64)[None, :]
        valid = (rows >= s[:, None]) & (rows < e[:, None])
        key_eq = (blk & kmask) == cand[:, None]
        above = (blk >> jnp.uint64(2 * K)) >= min_count
        hit = valid & key_eq & above & live[:, None]
        row = jnp.max(jnp.where(hit, rows, -1), axis=-1)
        return jnp.where(row >= 0, row.astype(jnp.int32), ids)

    return lookup


@functools.partial(jax.jit, static_argnames=("variant",))
def run(c0, k2d, lut, variant: str):
    lookup = make_lookup("stub" if variant == "process" else "real", k2d, lut)

    def expand(frontier):
        f = frontier[:, None]
        b = jnp.arange(4, dtype=jnp.uint64)[None, :]
        fwd = ((f << jnp.uint64(2)) | b) & kmask
        rev = (b << jnp.uint64(2 * (K - 1))) | (f >> jnp.uint64(2))
        cand = jnp.concatenate([fwd, rev], axis=1).reshape(-1)
        live = jnp.repeat(frontier != jnp.uint64(R.EMPTY), 8)
        return jnp.where(live, cand, jnp.uint64(R.EMPTY))

    def canon(c):
        from sharkmer_tpu.ops.hashtable import _revcomp_kernel
        rc = _revcomp_kernel(c, K)
        return jnp.where(c == jnp.uint64(R.EMPTY), jnp.uint64(R.EMPTY),
                         jnp.minimum(c, rc))

    def mark(bitmap, ids):
        w = (ids >> 5).astype(jnp.int32)
        bit = jnp.uint32(1) << (ids & 31).astype(jnp.uint32)
        bit = jnp.where(ids != inf, bit, jnp.uint32(0))
        return bitmap.at[w].add(bit, mode="drop")

    def process(cand, bitmap, width):
        cc = canon(cand)
        ids = lookup(cc)
        w = jnp.minimum((ids >> 5).astype(jnp.int32), n_words - 1)
        seen = (bitmap[w] >> (ids & 31).astype(jnp.uint32)) & 1
        ids = jnp.where((seen == 1) | (ids == inf), inf, ids)
        order = jnp.argsort(ids)
        ids_s = ids[order]
        km_s = cc[order]
        first = jnp.concatenate([jnp.ones((1,), bool), ids_s[1:] != ids_s[:-1]])
        ids_s = jnp.where(first, ids_s, inf)
        km_s = jnp.where(first & (ids_s != inf), km_s, jnp.uint64(R.EMPTY))
        order2 = jnp.argsort(ids_s)
        return km_s[order2][:width], ids_s[order2][:width]

    log_w = 520 * 256
    log0 = jnp.full((log_w,), inf)
    bitmap0 = jnp.zeros((n_words,), jnp.uint32)

    def body(state):
        frontier, bitmap, log, it = state
        if variant == "empty":
            return frontier, bitmap, log, it + 1
        cand = expand(frontier)
        if variant == "lookup":
            ids = lookup(canon(cand))
            # touch ids so it isn't DCE'd; keep frontier alive
            frontier2 = jnp.where(
                jnp.max(ids) > -2, frontier, frontier)
            return frontier2, bitmap, log, it + 1
        km, ids = process(cand, bitmap, F_NARROW)
        if variant == "process":
            return km[:F_NARROW], bitmap, log, it + 1
        bitmap = mark(bitmap, ids)
        log = jax.lax.dynamic_update_slice(log, ids, (it * 256,))
        return km[:F_NARROW], bitmap, log, it + 1

    def cond(state):
        return state[3] < LEVELS

    state = (c0, bitmap0, log0, jnp.int32(0))
    state = jax.lax.while_loop(cond, body, state)
    return state[3], state[1][:8]


c0 = jnp.asarray(
    np.concatenate([keys[1000:1000 + F_NARROW]]).astype(np.uint64))

for variant in ("empty", "lookup", "process", "mark_log", "full"):
    v = "full" if variant in ("mark_log", "full") else variant
    # mark_log isolated via subtraction later; just run both
    it, bm = run(c0, sc.packed2d, sc.lut, variant if variant != "mark_log" else "full")
    jax.block_until_ready(bm)
    t0 = time.perf_counter()
    it, bm = run(c0, sc.packed2d, sc.lut, variant if variant != "mark_log" else "full")
    jax.block_until_ready(bm)
    dt = time.perf_counter() - t0
    print(f"{variant:10s}: {dt:7.3f}s total, {dt / LEVELS * 1e3:7.3f} ms/level")
