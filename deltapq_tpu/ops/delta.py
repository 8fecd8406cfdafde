"""Compressed-code (DeltaTree) query execution, level by level.

The reference scans the DTC stream **sequentially** per query with a
stack of (code, distance) per tree depth, updating
``dist = parent_dist - T[m][from] + T[m][to]`` per diff
(``query_processing_scan_compressed_codes_opt_o_direct``,
``deltapq_create_approx_tree.h:2805-2984``); the batch variant
vectorizes that inner update over queries (``:3223-3447``).

Design (SURVEY.md §7): the stack recurrence is re-expressed
**level-by-level** — all nodes at depth d depend only on depth d-1, and
tree height is bounded by MAX_HEIGHT (= M*h) + finalist chain, so the
whole traversal is ~M+2 rounds of

    delta[b, j] = sum over node j's diffs of (T[b,m,to] - T[b,m,from])
    dist[level d] = dist[parent at level d-1] + delta

Layout: nodes are stored **level-major** (sorted by depth, then DFS
position), so each level is a contiguous block; a level's output is
computed from the previous block with one gather (parents) plus a
segment-sum of the level's flat diff terms, and blocks simply
concatenate — no scatter into a global distance array.  The final
level-major distances permute back to database order with one gather.
Every round is dense and fully parallel over (queries x nodes) — a
data-parallel realization of the reference's per-node stack loop.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..tree.layout import DeltaTree, _ragged_indices


@dataclass
class LevelPack:
    """Per-depth flat arrays for one level of the DeltaTree
    (level-major local indices)."""

    parent_local: np.ndarray  # i32[n_d] index into level d-1's block
    seg: np.ndarray           # i32[t_d] index into 0..n_d-1 per diff
    dm: np.ndarray            # i32[t_d] subspace of each diff
    dfrom: np.ndarray         # i32[t_d] parent's centroid id
    dto: np.ndarray           # i32[t_d] node's centroid id


@dataclass
class DeltaPack:
    """Device-ready level-major layout of a DeltaTree."""

    levels: List[LevelPack]
    root_code: np.ndarray     # [M] int32
    db_to_lm: np.ndarray      # [N] int32: database id -> level-major pos
    n: int
    M: int
    K: int


def build_delta_pack(tree: DeltaTree) -> DeltaPack:
    """Host-side preparation: sort nodes level-major, flatten each
    level's diffs, and resolve each diff's ``from`` (= parent's centroid
    in that subspace, which the DTC stream stores implicitly via the
    decode stack)."""
    decoded_db = tree.decode_codes()
    codes_dfs = decoded_db[tree.vec_id.astype(np.int64)].astype(np.int32)

    n = tree.n
    maxd = int(tree.depth.max()) if n else 0
    # level-major order: stable sort by depth keeps DFS order within level
    order = np.argsort(tree.depth, kind="stable").astype(np.int64)
    lm_pos = np.empty(n, np.int64)
    lm_pos[order] = np.arange(n)
    level_off = np.searchsorted(tree.depth[order], np.arange(maxd + 2))

    levels: List[LevelPack] = []
    for d in range(1, maxd + 1):
        sel = order[level_off[d]:level_off[d + 1]]  # DFS positions, lvl d
        cnt = tree.diff_num[sel].astype(np.int64)
        flat = _ragged_indices(tree.diff_off[sel], cnt)
        seg = np.repeat(np.arange(len(sel)), cnt).astype(np.int32)
        dm = tree.diff_m[flat].astype(np.int32)
        dto = tree.diff_to[flat].astype(np.int32)
        par = tree.parent_pos[sel].astype(np.int64)
        dfrom = codes_dfs[np.repeat(par, cnt), dm]
        parent_local = (lm_pos[par] - level_off[d - 1]).astype(np.int32)
        levels.append(LevelPack(
            parent_local=parent_local, seg=seg, dm=dm,
            dfrom=dfrom.astype(np.int32), dto=dto))

    # database id -> level-major position
    db_to_lm = np.empty(n, np.int64)
    db_to_lm[tree.vec_id.astype(np.int64)] = lm_pos
    return DeltaPack(levels=levels,
                     root_code=codes_dfs[0].astype(np.int32),
                     db_to_lm=db_to_lm.astype(np.int32),
                     n=n, M=tree.M, K=tree.K)


def make_compressed_query_fn(pack: DeltaPack):
    """Build a jitted function (table [B, M, K]) -> dists [B, N_db]
    running the full level-wise traversal.  Shapes are baked per index
    (one compile per dataset, like the reference's per-file decode).

    The level arrays are passed as jit *arguments*, not closure
    constants (closure-captured device arrays are baked into the HLO as
    constants).  All levels' arrays are concatenated into four flat
    device buffers and sliced at static offsets inside the program.
    """
    level_sizes = tuple(len(lp.parent_local) for lp in pack.levels)
    diff_sizes = tuple(len(lp.seg) for lp in pack.levels)
    node_off = np.concatenate([[0], np.cumsum(level_sizes)])
    diff_off = np.concatenate([[0], np.cumsum(diff_sizes)])
    parent_all = jnp.asarray(np.concatenate(
        [lp.parent_local for lp in pack.levels]) if pack.levels
        else np.zeros(1, np.int32))
    seg_all = jnp.asarray(np.concatenate(
        [lp.seg for lp in pack.levels]) if pack.levels
        else np.zeros(1, np.int32))
    midx_to_all = jnp.asarray(np.concatenate(
        [lp.dm * pack.K + lp.dto for lp in pack.levels]) if pack.levels
        else np.zeros(1, np.int32))
    midx_from_all = jnp.asarray(np.concatenate(
        [lp.dm * pack.K + lp.dfrom for lp in pack.levels]) if pack.levels
        else np.zeros(1, np.int32))
    root_idx = jnp.asarray(np.arange(pack.M, dtype=np.int32) * pack.K
                           + pack.root_code)
    db_to_lm = jnp.asarray(pack.db_to_lm)
    node_off_t = tuple(int(x) for x in node_off)
    diff_off_t = tuple(int(x) for x in diff_off)

    @functools.partial(jax.jit,
                       static_argnames=("nsizes", "noffs", "doffs"))
    def run_impl(table, parent_all, seg_all, midx_to_all, midx_from_all,
                 root_idx, db_to_lm, nsizes, noffs, doffs):
        B = table.shape[0]
        tf = table.reshape(B, -1)
        root_d = jnp.sum(jnp.take(tf, root_idx, axis=1), axis=1)
        prev = root_d[:, None]  # [B, 1]
        blocks = [prev]
        for d, n_lvl in enumerate(nsizes):
            ns, ne = noffs[d], noffs[d + 1]
            ds, de = doffs[d], doffs[d + 1]
            seg = seg_all[ds:de]
            terms = (jnp.take(tf, midx_to_all[ds:de], axis=1)
                     - jnp.take(tf, midx_from_all[ds:de], axis=1))
            delta = jax.vmap(
                lambda t: jax.ops.segment_sum(t, seg,
                                              num_segments=n_lvl))(terms)
            parent_d = jnp.take(prev, parent_all[ns:ne], axis=1)
            prev = parent_d + delta
            blocks.append(prev)
        dist_lm = jnp.concatenate(blocks, axis=1)  # [B, N] level-major
        return jnp.take(dist_lm, db_to_lm, axis=1)

    def run(table: jnp.ndarray) -> jnp.ndarray:
        return run_impl(table, parent_all, seg_all, midx_to_all,
                        midx_from_all, root_idx, db_to_lm,
                        level_sizes, node_off_t, diff_off_t)

    return run


def query_compressed(pack: DeltaPack, codewords: np.ndarray,
                     queries: np.ndarray, top_k: int = 10
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end compressed query: ADC tables + level-wise traversal +
    exact top-k.  Returns (dists [B, top_k], ids [B, top_k]) in
    database-id space (ascending distance)."""
    from .adc import adc_table
    from .topk import smallest_k

    codewords = jnp.asarray(codewords, jnp.float32)
    M, K, Ds = codewords.shape
    q = np.asarray(queries, np.float32)
    if q.shape[1] < M * Ds:
        q = np.pad(q, ((0, 0), (0, M * Ds - q.shape[1])))
    table = adc_table(codewords, jnp.asarray(q))
    run = make_compressed_query_fn(pack)
    dists = run(table)  # [B, N] in db order
    d, ids = smallest_k(dists, top_k)
    return np.asarray(d), np.asarray(ids)
