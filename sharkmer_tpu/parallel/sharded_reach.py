"""Mesh-sharded sPCR data plane for ``ShardedSortedStore``.

The single-chip store serves graph-extension waves from depth-capped
device reachability closures and primer scans from fused range queries
(ops/reach.py). This module gives the mesh-sharded store the same data
plane, SPMD-native:

* **index build** (`build_spcr_index`): ONE shard_map call builds each
  shard's bucket LUT, revcomp-sorted scan index, and (when the key has
  >= 12 spare bits) the count-packed probe plane — all shard-local, no
  data movement off-shard.
* **reach** (`sharded_reach`): the closure state machine
  (ops/reach.py `_closure_run`) runs REPLICATED on every shard inside
  one shard_map'd ``lax.while_loop``; only the probe is shard-local.
  Each shard looks up the candidates it owns against its own LUT
  sidecar and reports global row ids (shard * capacity + local row);
  an ``lax.pmin`` over the shard axis combines them (INF = miss
  loses). Because every other state tensor (frontier, bitmap, log,
  counters) is computed from the combined ids, all shards stay in
  lockstep through the loop — the collective is the only cross-shard
  traffic, 8 * f_cap i32 per level between devices. The visited-row
  gather at the end combines shard-local key/count gathers with an
  all_gather+min (a u64 min over an all_gather needs no u64
  all-reduce support from the collective library) and a psum.
* **primer scans** (`sharded_range_scan`): the fused single-dispatch
  range-query kernel (ops/reach.py `_fused_scan_kernel`) runs
  shard-local under shard_map; per-shard padded results and true match
  totals are all_gathered and combined on host with the same
  grow-and-retry the single-chip path uses.

Bit-identity with the single-chip plane follows from the closure
semantics being backend-independent (same candidate expansion, same
threshold test, same first-visit dedup — only row-id numbering
differs, and ids never leave the kernel).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import reach as reach_mod
from ..ops.hashtable import _revcomp_kernel
from ..ops.reach import (
    BLOCK,
    EMPTY,
    _INF32,
    _build_lut_kernel,
    _closure_run,
    _drive_closure,
    _fused_scan_kernel,
    _lut_bits,
    _lut_bits_cap,
    _pack_counts_kernel,
    _pack_scalars,
    _rc_index_kernel,
)
from .sharded_table import AXIS


@functools.lru_cache(maxsize=32)
def _make_index_builder(mesh: Mesh, k: int, bits: int, packed: bool):
    shift = 2 * k - bits

    @jax.jit
    def build(kmers, counts):
        def body(kmers, counts):
            keys = kmers[0]
            lut, max_occ = _build_lut_kernel(keys, bits, shift)
            rc_sorted, rc_order = _rc_index_kernel(keys, k)
            occ = jnp.sum(keys != jnp.uint64(EMPTY), dtype=jnp.int64)
            stats = jnp.stack([max_occ.astype(jnp.int64), occ])
            outs = [
                lut[None], rc_sorted[None], rc_order[None],
                jax.lax.all_gather(stats, AXIS),
            ]
            if packed:
                outs.append(_pack_counts_kernel(keys, counts[0], k)[None])
            return tuple(outs)

        out_specs = [P(AXIS, None)] * 3 + [P()]
        if packed:
            out_specs.append(P(AXIS, None))
        return shard_map(
            body, mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None)),
            out_specs=tuple(out_specs),
            check_vma=False,
        )(kmers, counts)

    return build


class ShardedSpcrIndex:
    """Per-shard sidecars for one flushed ShardedSortedStore state."""

    def __init__(self, store):
        self.mesh = store.mesh
        self.k = store.k
        self.cap = store.local_capacity
        cap_bits = _lut_bits_cap(store.k)
        bits = _lut_bits(self.cap, store.k)
        self.packed = (64 - 2 * store.k) >= 12
        while True:
            build = _make_index_builder(
                self.mesh, store.k, bits, self.packed
            )
            outs = build(store.kmers, store.counts)
            stats = np.asarray(outs[3])
            max_occ = int(stats[:, 0].max())
            if max_occ <= BLOCK or bits >= cap_bits:
                break
            bits += 1
        self.bits = bits
        self.shift = 2 * store.k - bits
        self.lut = outs[0]
        self.rc_sorted = outs[1]
        self.rc_order = outs[2]
        self.occupancy = stats[:, 1].astype(np.int64)
        self.packed_plane = outs[4] if self.packed else None
        probe_w = 2
        while max_occ > BLOCK * probe_w - (BLOCK - 1):
            probe_w *= 2
        self.probe_w = probe_w


@functools.lru_cache(maxsize=64)
def _make_reach_kernel(mesh: Mesh, k: int, bits: int, cap: int,
                       depth: int, f_cap: int, f_narrow: int,
                       n_words: int, packed: bool, probe_w: int):
    shift = 2 * k - bits
    n_blocks = cap // BLOCK
    kmask = jnp.uint64((1 << (2 * k)) - 1)
    inf = jnp.int32(_INF32)

    @functools.partial(jax.jit, static_argnames=("has_pre",))
    def run(kmers, counts, lut, probe_plane, c0, min_count, pre,
            has_pre: bool):
        def body(kmers, counts, lut, probe_plane, c0, min_count, pre):
            me = jax.lax.axis_index(AXIS).astype(jnp.int32)
            base = me * jnp.int32(cap)
            k2d = probe_plane[0].reshape(n_blocks, BLOCK)
            c2d = counts[0].reshape(n_blocks, BLOCK)
            mylut = lut[0]

            def lookup(cand):
                b = jnp.minimum(
                    cand >> jnp.uint64(shift),
                    jnp.uint64(mylut.shape[0] - 2),
                ).astype(jnp.int64)
                s = mylut[b]
                e = mylut[b + 1]
                j0 = (s >> reach_mod._LOG2B).astype(jnp.int64)
                live = (cand != jnp.uint64(EMPTY)) & (e > s)
                jb = jnp.minimum(j0, n_blocks - 1)
                jbs = [
                    jnp.minimum(j0 + w, n_blocks - 1)
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
                    cblk = jnp.concatenate(
                        [c2d[j] for j in jbs], axis=-1
                    )
                    hit = (
                        valid & (blk == cand[:, None]) & live[:, None]
                        & (cblk >= min_count)
                    )
                row = jnp.max(jnp.where(hit, rows, -1), axis=-1)
                ids = jnp.where(
                    row >= 0, row.astype(jnp.int32) + base, inf
                )
                # a key lives on exactly one shard: min picks its row
                return jax.lax.pmin(ids, AXIS)

            log, boundary, n_vis, it, overflow, done = _closure_run(
                lookup, c0, k, depth, f_cap, f_narrow, n_words,
                pre=pre if has_pre else None,
            )

            # shard-local gather of the logged rows, then cross-shard
            # combine: keys via all_gather+min (EMPTY = u64 max
            # loses), counts via psum
            live = log != inf
            local = (log - base).astype(jnp.int64)
            mine = live & (local >= 0) & (local < cap)
            safe = jnp.where(mine, local, 0)
            gk = kmers[0][safe]
            gc = counts[0][safe]
            out_keys = jnp.where(mine, gk, jnp.uint64(EMPTY))
            out_counts = jnp.where(mine, gc, jnp.uint32(0))
            out_keys = jnp.min(
                jax.lax.all_gather(out_keys, AXIS), axis=0
            )
            out_counts = jax.lax.psum(out_counts, AXIS)
            out_keys, out_counts = jax.lax.sort(
                (out_keys, out_counts), num_keys=1, is_stable=False
            )
            return (
                out_keys, out_counts, boundary,
                _pack_scalars(n_vis, it, overflow, done),
            )

        return shard_map(
            body, mesh=mesh,
            in_specs=(
                P(AXIS, None), P(AXIS, None), P(AXIS, None),
                P(AXIS, None), P(), P(), P(),
            ),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )(kmers, counts, lut, probe_plane, c0, min_count, pre)

    return run


def sharded_reach(store, index: ShardedSpcrIndex, roots: np.ndarray,
                  min_count: int, depth: int,
                  f_cap: int = reach_mod.F_CAP,
                  max_retries: int = 4, pre=None):
    """Mesh-sharded closure through the shared host driver."""
    from ..ops.reach import _pad_pre

    k = store.k
    pre_h = _pad_pre(pre, roots=roots)
    has_pre = pre_h is not None
    pre_j = jnp.asarray(
        pre_h if has_pre
        else np.full(reach_mod.PRE_W, EMPTY, np.uint64)
    )
    packed = index.packed and (
        min_count < (1 << (64 - 2 * k)) - 1
    )
    n_rows_total = store.n_shards * index.cap
    n_words = max(64, -(-n_rows_total // 32))
    probe_plane = index.packed_plane if packed else store.kmers

    def run_kernel(c0, cur_f, cur_n):
        kern = _make_reach_kernel(
            index.mesh, k, index.bits, index.cap, depth, cur_f, cur_n,
            n_words, packed, index.probe_w,
        )
        return kern(
            store.kmers, store.counts, index.lut, probe_plane, c0,
            jnp.uint32(max(min_count, 1)), pre_j, has_pre=has_pre,
        )

    return _drive_closure(run_kernel, roots, depth, f_cap, max_retries)


@functools.lru_cache(maxsize=64)
def _make_scan_kernel(mesh: Mesh, shift: int, k: int, max_out: int):
    @jax.jit
    def run(kmers, counts, rc_sorted, rc_order, occ, oligos):
        def body(kmers, counts, rc_sorted, rc_order, occ, oligos):
            me = jax.lax.axis_index(AXIS)
            kk, cc, totals = _fused_scan_kernel(
                kmers[0], counts[0], rc_sorted[0], rc_order[0],
                occ[me], oligos, shift, k, max_out,
            )
            return kk[None], cc[None], totals[None]

        return shard_map(
            body, mesh=mesh,
            in_specs=(
                P(AXIS, None), P(AXIS, None), P(AXIS, None),
                P(AXIS, None), P(), P(),
            ),
            out_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None)),
            check_vma=False,
        )(kmers, counts, rc_sorted, rc_order, occ, oligos)

    return run


def sharded_range_scan(store, index: ShardedSpcrIndex,
                       oligos: np.ndarray, oligo_len: int,
                       max_out: int = 1 << 12):
    """All-shard primer matches via shard-local fused range scans.

    Same contract as ops.reach.range_scan_part summed over shards:
    (kmers u64, counts u32) of every matched row, forward precedence
    per row, RC hits revcomp-normalized. Count filtering is the
    caller's.
    """
    k = store.k
    if oligo_len <= 0 or oligo_len >= k:
        raise ValueError(
            f"oligo length {oligo_len} out of range for k={k}"
        )
    shift = 2 * (k - oligo_len)
    pad_val = np.uint64(1) << np.uint64(2 * oligo_len)
    width = max(64, 1 << max(len(oligos) - 1, 0).bit_length())
    padded = np.full(width, pad_val, np.uint64)
    padded[: len(oligos)] = np.sort(np.asarray(oligos, np.uint64))
    oligos_j = jnp.asarray(padded)
    occ_j = jnp.asarray(index.occupancy)

    while True:
        kern = _make_scan_kernel(index.mesh, shift, k, max_out)
        kk, cc, totals = kern(
            store.kmers, store.counts, index.rc_sorted, index.rc_order,
            occ_j, oligos_j,
        )
        for a in (totals, kk, cc):
            a.copy_to_host_async()
        tot = np.asarray(totals)
        if int(tot.max()) <= max_out:
            break
        max_out = 1 << (int(tot.max()) - 1).bit_length()

    kh = np.asarray(kk).reshape(-1)
    ch = np.asarray(cc).reshape(-1)
    live = kh != EMPTY
    return kh[live], ch[live]
