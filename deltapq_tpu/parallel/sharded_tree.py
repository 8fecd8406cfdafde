"""Sharded DeltaTree index: compressed-code query over a device mesh.

BASELINE.json north star: "compressed code arrays and DeltaTree
partitions are tensor-sharded" across chips/hosts.  Design:

- the database is split into S contiguous row partitions; an
  independent DeltaTree is built per partition (build stays
  embarrassingly parallel and each shard's traversal is local);
- each shard's level-major arrays (ops/delta.py) are padded to common
  per-level shapes and stacked on a leading shard axis, so one
  ``shard_map`` program runs every shard's traversal in SPMD;
- per-shard top-k candidates merge with one ``all_gather`` (k values
  per query per shard — negligible vs the scan).

Padding: level blocks pad to the per-level maximum across shards;
padded slots get parent_local=0 and no diffs, producing garbage
distances that the final database-order gather never reads (db_to_lm
only targets real rows, and rows beyond a shard's n_local are masked).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..tree.build import find_edges_by_diff
from ..tree.layout import DeltaTree, build_layout
from ..ops.delta import build_delta_pack, DeltaPack
from ..ops.topk import smallest_k
from .mesh import make_mesh


@dataclass
class ShardedDeltaPack:
    """Stacked + padded level-major arrays for S shards."""

    # per level: parent_local [S, nd_max], seg/midx_to/midx_from
    # [S, td_max]
    levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    root_idx: np.ndarray      # [S, M] flat table indices of root codes
    db_to_lm: np.ndarray      # [S, n_pad] local db id -> level-major pos
    n_local: np.ndarray       # [S] true rows per shard
    row_base: np.ndarray      # [S] global id offset of each partition
    n_pad: int                # padded db rows per shard
    lm_size: int              # 1 + sum of padded level sizes
    M: int
    K: int
    level_skew: float = 1.0   # max/mean padded-level inflation across
                              # shards (memory cost of the [S, max]
                              # padding; ~1 = balanced)


def _build_shard_tree(args):
    part, K, codewords, tree_kwargs = args
    res = find_edges_by_diff(part, K=K, **tree_kwargs)
    return build_layout(part, res.edges, res.root_id, K=K,
                        codewords=codewords)


def build_sharded_trees(codes: np.ndarray, K: int, n_shards: int,
                        codewords: np.ndarray, workers: int = 0,
                        **tree_kwargs
                        ) -> Tuple[List[DeltaTree], np.ndarray]:
    """Split rows into contiguous partitions and build one DeltaTree per
    partition (independent builds — the multi-host build path),
    optionally over a spawn process pool (``workers`` > 1; 0 = serial).

    Returns (trees, true_sizes): a shard with no rows gets a 1-row
    dummy tree whose true size is 0 (its results are masked out).

    NOTE on padding: ``build_sharded_pack`` pads every shard's
    per-level arrays to the global per-level max, so one deep/skewed
    shard inflates all shards' memory by up to
    ``max_level_size / mean_level_size``; the contiguous-partition
    split after a lexicographic sort keeps shards statistically
    balanced, and the pack records ``level_skew`` so callers can see
    the inflation.  (At O(100+) shards prefer the fused tile engines,
    which have no cross-shard padding.)"""
    n = len(codes)
    per = -(-n // n_shards)
    jobs = []
    sizes = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        part = codes[s * per:(s + 1) * per]
        sizes[s] = len(part)
        if len(part) == 0:
            part = codes[:1]  # degenerate shard: dummy row, size 0
        jobs.append((np.ascontiguousarray(part), K, codewords,
                     tree_kwargs))
    if workers and workers > 1 and n_shards > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        from ..platform import cpu_only_worker

        with ProcessPoolExecutor(
                max_workers=workers, initializer=cpu_only_worker,
                mp_context=mp.get_context("spawn")) as ex:
            trees = list(ex.map(_build_shard_tree, jobs))
    else:
        trees = [_build_shard_tree(j) for j in jobs]
    return trees, sizes


def build_sharded_pack(trees: List[DeltaTree], row_bases: np.ndarray,
                       true_sizes: np.ndarray = None) -> ShardedDeltaPack:
    packs = [build_delta_pack(t) for t in trees]
    S = len(packs)
    M, K = packs[0].M, packs[0].K
    n_pad = max(p.n for p in packs)
    n_levels = max(len(p.levels) for p in packs)

    levels = []
    level_nd = []
    for d in range(n_levels):
        nd_max = max((len(p.levels[d].parent_local) if d < len(p.levels)
                      else 0) for p in packs)
        td_max = max((len(p.levels[d].seg) if d < len(p.levels) else 0)
                     for p in packs)
        nd_max = max(nd_max, 1)
        td_max = max(td_max, 1)
        parent = np.zeros((S, nd_max), np.int32)
        seg = np.full((S, td_max), nd_max - 1, np.int32)
        midx_to = np.zeros((S, td_max), np.int32)
        midx_from = np.zeros((S, td_max), np.int32)
        for s, p in enumerate(packs):
            if d >= len(p.levels):
                continue
            lp = p.levels[d]
            nd, td = len(lp.parent_local), len(lp.seg)
            parent[s, :nd] = lp.parent_local
            seg[s, :td] = lp.seg
            midx_to[s, :td] = lp.dm * K + lp.dto
            midx_from[s, :td] = lp.dm * K + lp.dfrom
        levels.append((parent, seg, midx_to, midx_from))
        level_nd.append(nd_max)

    # padding skew: total padded cells vs total real cells
    real = sum(len(p.levels[d].parent_local)
               for p in packs for d in range(len(p.levels)))
    padded = S * sum(level_nd)
    skew = padded / max(real, 1)

    # per-shard db_to_lm remapped into the PADDED level-major space:
    # shard-local level offsets differ from the padded ones
    lm_size = 1 + sum(level_nd)
    pad_off = np.concatenate([[0], [1], 1 + np.cumsum(level_nd)])[:-1]
    # pad_off[d] = start of level d block (level 0 = root at 0)
    db_to_lm = np.zeros((S, n_pad), np.int32)
    n_local = np.zeros(S, np.int32)
    for s, p in enumerate(packs):
        # p.db_to_lm indexes the shard's own compact level-major space;
        # recompute with padded offsets
        own_nd = [len(lp.parent_local) for lp in p.levels]
        own_off = np.concatenate([[0], [1], 1 + np.cumsum(own_nd)])[:-1]
        lm = p.db_to_lm.astype(np.int64)
        # find each position's level via searchsorted on own offsets
        lev = np.searchsorted(np.concatenate([own_off[1:], [np.iinfo(
            np.int64).max]]), lm, side="right")
        local_in_level = lm - own_off[lev]
        db_to_lm[s, :p.n] = (pad_off[lev] + local_in_level).astype(np.int32)
        n_local[s] = p.n if true_sizes is None else int(true_sizes[s])
    root_idx = np.stack([np.arange(M, dtype=np.int32) * K + p.root_code
                         for p in packs])
    return ShardedDeltaPack(level_skew=float(skew),
                            levels=levels, root_idx=root_idx,
                            db_to_lm=db_to_lm, n_local=n_local,
                            row_base=np.asarray(row_bases, np.int32),
                            n_pad=n_pad, lm_size=lm_size, M=M, K=K)


def make_sharded_compressed_query_fn(mesh: Mesh, pack: ShardedDeltaPack,
                                     top_k: int, axis: str = "shard"):
    """Jitted (table [B, M, K]) -> (dists [B, k], global ids [B, k]),
    with the sharded pack arrays placed along the mesh axis."""
    S = mesh.devices.size
    assert pack.root_idx.shape[0] == S, \
        f"pack has {pack.root_idx.shape[0]} shards, mesh has {S}"
    n_pad = pack.n_pad
    level_sizes = tuple((lv[0].shape[1], lv[1].shape[1])
                        for lv in pack.levels)

    shard0 = NamedSharding(mesh, P(axis))
    dev_levels = tuple(
        tuple(jax.device_put(a, shard0) for a in lv) for lv in pack.levels)
    dev_root = jax.device_put(pack.root_idx, shard0)
    dev_lm = jax.device_put(pack.db_to_lm, shard0)
    dev_nloc = jax.device_put(pack.n_local, shard0)
    dev_base = jax.device_put(pack.row_base, shard0)

    def body(table, levels, root_idx, db_to_lm, n_local, row_base):
        # all leading shard dims are 1 inside shard_map; index [0]
        B = table.shape[0]
        tf = table.reshape(B, -1)
        root_d = jnp.sum(jnp.take(tf, root_idx[0], axis=1), axis=1)
        prev = root_d[:, None]
        blocks = [prev]
        for (parent_local, seg, midx_to, midx_from), (nd, td) in zip(
                levels, level_sizes):
            terms = (jnp.take(tf, midx_to[0], axis=1)
                     - jnp.take(tf, midx_from[0], axis=1))
            delta = jax.vmap(lambda t: jax.ops.segment_sum(
                t, seg[0], num_segments=nd))(terms)
            parent_d = jnp.take(prev, parent_local[0], axis=1)
            prev = parent_d + delta
            blocks.append(prev)
        dist_lm = jnp.concatenate(blocks, axis=1)
        db_dist = jnp.take(dist_lm, db_to_lm[0], axis=1)  # [B, n_pad]
        valid = jax.lax.broadcasted_iota(jnp.int32, (1, n_pad), 1) \
            < n_local[0]
        db_dist = jnp.where(valid, db_dist, jnp.inf)
        # a shard can hold fewer rows than top_k; clamp the local k and
        # pad candidates so the cross-shard merge stays uniform
        k_local = min(top_k, n_pad)
        d, li = smallest_k(db_dist, k_local)
        if k_local < top_k:
            pad = top_k - k_local
            d = jnp.concatenate(
                [d, jnp.full((B, pad), jnp.inf, jnp.float32)], axis=1)
            li = jnp.concatenate(
                [li, jnp.full((B, pad), 0, jnp.int32)], axis=1)
        gids = li + row_base[0]
        all_d = jax.lax.all_gather(d, axis)
        all_i = jax.lax.all_gather(gids, axis)
        cat_d = jnp.moveaxis(all_d, 0, 1).reshape(B, -1)
        cat_i = jnp.moveaxis(all_i, 0, 1).reshape(B, -1)
        neg, pos = jax.lax.top_k(-cat_d, top_k)
        return -neg, jnp.take_along_axis(cat_i, pos, axis=1)

    level_specs = tuple(tuple(P(axis) for _ in lv) for lv in pack.levels)
    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), level_specs, P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()), check_vma=False)
    jitted = jax.jit(mapped)

    def run(table):
        return jitted(table, dev_levels, dev_root, dev_lm, dev_nloc,
                      dev_base)

    return run


def sharded_query_compressed(codewords: np.ndarray, codes: np.ndarray,
                             queries: np.ndarray, top_k: int = 10,
                             mesh: Mesh = None, **tree_kwargs
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Convenience end-to-end: build per-shard DeltaTrees, run the
    sharded compressed query, return (dists, global ids)."""
    from ..ops.adc import adc_table

    if mesh is None:
        mesh = make_mesh()
    S = mesh.devices.size
    n = len(codes)
    per = -(-n // S)
    row_bases = np.arange(S, dtype=np.int32) * per
    trees, sizes = build_sharded_trees(codes, int(codewords.shape[1]), S,
                                       codewords, **tree_kwargs)
    pack = build_sharded_pack(trees, row_bases, sizes)
    M, K, Ds = codewords.shape
    q = np.asarray(queries, np.float32)
    if q.shape[1] < M * Ds:
        q = np.pad(q, ((0, 0), (0, M * Ds - q.shape[1])))
    table = adc_table(jnp.asarray(codewords, jnp.float32), jnp.asarray(q))
    run = make_sharded_compressed_query_fn(mesh, pack, top_k)
    d, i = run(table)
    return np.asarray(d), np.asarray(i)
