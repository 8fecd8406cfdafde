"""Sharded query execution and data-parallel codebook training.

No reference counterpart (the reference is single-process OpenMP;
SURVEY.md §2.8/§5).  Design per BASELINE.json's north star:

- the [N, M] code array is sharded along N over a 1-D device mesh;
- ADC tables for a query batch are replicated (B*M*K*4 bytes, small);
- every shard scans its rows and keeps a local top-k;
- local top-k candidates are merged with an ``all_gather`` over the
  mesh axis (k*S candidates/query, tiny vs the scan) so every device
  holds the final result — the collective rides ICI, the scan rides HBM;
- k-means runs data-parallel: per-shard one-hot matmul partial sums
  are ``psum``-reduced, so each Lloyd step is one collective pair.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .mesh import make_mesh
from ..ops.adc import adc_table, adc_tile_dists


# --------------------------------------------------------------------------
# Sharded ADC query
# --------------------------------------------------------------------------

def _local_scan_topk(table, codes_local, n_valid, base, top_k, tile_n,
                     axis=None):
    """Top-k over this shard's rows (same streaming scan as
    ops.adc.adc_query_topk but with a global id offset)."""
    B = table.shape[0]
    n_local = codes_local.shape[0]
    if n_local % tile_n != 0:
        # fall back to one tile covering the shard (callers normally
        # pad per-shard rows to a multiple of tile_n)
        tile_n = n_local
    n_tiles = n_local // tile_n
    codes_t = codes_local.reshape(n_tiles, tile_n, codes_local.shape[1])
    tile = tile_n

    init_d = jnp.full((B, top_k), jnp.inf, jnp.float32)
    init_i = jnp.full((B, top_k), -1, jnp.int32)
    if axis is not None:
        # inside shard_map the carry becomes device-varying after the
        # first step; mark the (replicated) init values accordingly
        init_d = jax.lax.pcast(init_d, (axis,), to="varying")
        init_i = jax.lax.pcast(init_i, (axis,), to="varying")

    def step(carry, inp):
        best_d, best_i = carry
        t_idx, ct = inp
        local_ids = t_idx * tile + jax.lax.broadcasted_iota(
            jnp.int32, (1, tile), 1)
        d = adc_tile_dists(table, ct)
        gids = base + local_ids
        d = jnp.where(local_ids < n_valid, d, jnp.inf)
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(gids, (B, tile))], axis=1)
        neg, pos = jax.lax.top_k(-cat_d, top_k)
        return (-neg, jnp.take_along_axis(cat_i, pos, axis=1)), None

    (best_d, best_i), _ = jax.lax.scan(
        step, (init_d, init_i),
        (jnp.arange(n_tiles, dtype=jnp.int32), codes_t))
    return best_d, best_i


def make_sharded_query_fn(mesh: Mesh, top_k: int, tile_n: int = 8192,
                          axis: str = "shard"):
    """Returns a jitted fn (table [B,M,K], codes [N_pad,M], n_valid)
    -> (dists [B,top_k], ids [B,top_k]) with codes sharded along N.

    The final merge all-gathers each shard's k candidates and reduces
    with one more top-k; results are replicated on every device.
    """
    n_shards = mesh.devices.size

    def body(table, codes_local, n_valid):
        # codes_local: this shard's rows [N_pad/S, M]
        idx = jax.lax.axis_index(axis)
        rows = codes_local.shape[0]
        base = idx.astype(jnp.int32) * rows
        local_valid = jnp.clip(n_valid - base, 0, rows)
        d, i = _local_scan_topk(table, codes_local, local_valid, base,
                                top_k, min(tile_n, rows), axis=axis)
        # merge across shards: [S, B, k] -> top-k
        all_d = jax.lax.all_gather(d, axis)   # [S, B, k]
        all_i = jax.lax.all_gather(i, axis)
        B = table.shape[0]
        cat_d = jnp.moveaxis(all_d, 0, 1).reshape(B, n_shards * top_k)
        cat_i = jnp.moveaxis(all_i, 0, 1).reshape(B, n_shards * top_k)
        neg, pos = jax.lax.top_k(-cat_d, top_k)
        return -neg, jnp.take_along_axis(cat_i, pos, axis=1)

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P()),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(mapped)


def _pad_codes_for_mesh(codes: np.ndarray, mesh: Mesh,
                        tile_n: int = 8192):
    """Pad rows so each shard gets the same count (a multiple of the
    scan tile).  Returns (codes_padded, n_valid)."""
    n_shards = mesh.devices.size
    n_valid = codes.shape[0]
    per = max(256, -(-n_valid // n_shards))
    per = -(-per // tile_n) * tile_n if per > tile_n else per
    total = n_shards * per
    if codes.shape[0] < total:
        codes = np.concatenate(
            [codes, np.zeros((total - codes.shape[0], codes.shape[1]),
                             codes.dtype)])
    return codes, n_valid


def sharded_query_plain(codewords: np.ndarray, queries: np.ndarray,
                        codes: np.ndarray, top_k: int = 10,
                        mesh: Optional[Mesh] = None, tile_n: int = 8192
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end sharded plain-ADC query over all local devices."""
    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    n_valid = codes.shape[0]
    # pad rows so each shard gets the same count, a multiple of the
    # scan tile (per-shard rows must divide evenly into tiles)
    tile_n = min(tile_n, 8192)
    per = max(256, -(-n_valid // n_shards))
    per = -(-per // tile_n) * tile_n if per > tile_n else per
    total = n_shards * per
    codes_p = np.asarray(codes)
    if codes_p.shape[0] < total:
        codes_p = np.concatenate(
            [codes_p, np.zeros((total - codes_p.shape[0],
                                codes.shape[1]), codes.dtype)])
    cw = jnp.asarray(codewords, jnp.float32)
    M, K, Ds = codewords.shape
    q = np.asarray(queries, np.float32)
    if q.shape[1] < M * Ds:
        q = np.pad(q, ((0, 0), (0, M * Ds - q.shape[1])))
    table = adc_table(cw, jnp.asarray(q))

    codes_dev = jax.device_put(
        codes_p, NamedSharding(mesh, P(axis)))
    fn = make_sharded_query_fn(mesh, top_k,
                               tile_n=min(tile_n, per), axis=axis)
    d, i = fn(table, codes_dev, jnp.int32(n_valid))
    return np.asarray(d), np.asarray(i)


# --------------------------------------------------------------------------
# Data-parallel k-means (the framework's "training step")
# --------------------------------------------------------------------------

def make_dp_lloyd_step(mesh: Mesh, axis: str = "shard"):
    """One data-parallel Lloyd iteration over a sharded learn set.

    x_local: [M, n/S, Ds] shard of subspace-sliced training data;
    centers: [M, K, Ds] replicated.  Per-shard one-hot matmuls produce
    partial centroid sums/counts that are ``psum``-reduced over the mesh
    — the canonical DP training step of this framework.
    """

    def body(x_local, centers):
        # assignment: d2[m, n_loc, K]
        x2 = jnp.sum(x_local * x_local, axis=2, keepdims=True)
        c2 = jnp.sum(centers * centers, axis=2)  # [M, K]
        cross = jnp.einsum("mnd,mkd->mnk", x_local, centers,
                           preferred_element_type=jnp.float32)
        d2 = x2 - 2.0 * cross + c2[:, None, :]
        labels = jnp.argmin(d2, axis=2)  # [M, n_loc]
        onehot = jax.nn.one_hot(labels, centers.shape[1],
                                dtype=jnp.float32)  # [M, n_loc, K]
        sums = jnp.einsum("mnk,mnd->mkd", onehot, x_local,
                          preferred_element_type=jnp.float32)
        counts = jnp.sum(onehot, axis=1)  # [M, K]
        sums = jax.lax.psum(sums, axis)
        counts = jax.lax.psum(counts, axis)
        new_centers = sums / jnp.maximum(counts, 1.0)[..., None]
        # keep old center for empty clusters
        new_centers = jnp.where((counts == 0)[..., None], centers,
                                new_centers)
        distortion = jax.lax.psum(jnp.sum(jnp.min(d2, axis=2)), axis)
        return new_centers, distortion

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(None, axis, None), P()),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(mapped)


# --------------------------------------------------------------------------
# Sharded decoded-cache engine (the high-QPS tier over the mesh)
# --------------------------------------------------------------------------

def make_sharded_decoded_query_fn(mesh: Mesh, top_k: int,
                                  precision: str = "bf16x2",
                                  axis: str = "shard"):
    """Sharded decoded-cache query: xhat_hi/lo [N_pad, D], precomp
    [N_pad] and codes [N_pad, M] sharded along N; table + queries
    replicated.  Per shard: matrix-product scan + exact shortlist +
    exact f32 rerank, then one all-gather top-k merge (ids are global
    rows).

    precomp must carry +inf on padding rows (DecodedEngine convention).
    """
    n_shards = mesh.devices.size

    def body(table, queries, hi, lo, pre, codes_local):
        B = queries.shape[0]
        rows = hi.shape[0]
        base = jax.lax.axis_index(axis).astype(jnp.int32) * rows
        q_hi = queries.astype(jnp.bfloat16)
        q_lo = (queries - q_hi.astype(jnp.float32)).astype(jnp.bfloat16)
        q2 = jnp.sum(queries * queries, axis=1)
        cross = jnp.dot(hi, q_hi.T, preferred_element_type=jnp.float32)
        if precision == "bf16x2":
            cross = (cross
                     + jnp.dot(hi, q_lo.T,
                               preferred_element_type=jnp.float32)
                     + jnp.dot(lo, q_hi.T,
                               preferred_element_type=jnp.float32))
        d = pre[:, None] - 2.0 * cross + q2[None, :]  # [rows, B]
        shortlist = min(max(16 * top_k, 64), 1024, rows)
        neg, ci = jax.lax.top_k(-d.T, shortlist)
        cd = -neg
        ci = ci.astype(jnp.int32)
        # exact f32 rerank on the local shortlist
        from ..ops.adc import exact_dists_for_ids

        exact = exact_dists_for_ids(table, codes_local, ci)
        exact = jnp.where(jnp.isfinite(cd), exact, jnp.inf)
        k_local = min(top_k, shortlist)
        neg, pos = jax.lax.top_k(-exact, k_local)
        li = jnp.take_along_axis(ci, pos, axis=1)
        dloc = -neg
        if k_local < top_k:
            pad = top_k - k_local
            dloc = jnp.concatenate(
                [dloc, jnp.full((B, pad), jnp.inf, jnp.float32)], axis=1)
            li = jnp.concatenate(
                [li, jnp.zeros((B, pad), jnp.int32)], axis=1)
        gids = li + base
        all_d = jax.lax.all_gather(dloc, axis)
        all_i = jax.lax.all_gather(gids, axis)
        cat_d = jnp.moveaxis(all_d, 0, 1).reshape(B, n_shards * top_k)
        cat_i = jnp.moveaxis(all_i, 0, 1).reshape(B, n_shards * top_k)
        neg, pos = jax.lax.top_k(-cat_d, top_k)
        return -neg, jnp.take_along_axis(cat_i, pos, axis=1)

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(mapped)


def sharded_query_decoded(codewords: np.ndarray, queries: np.ndarray,
                          codes: np.ndarray, top_k: int = 10,
                          mesh: Optional[Mesh] = None,
                          precision: str = "bf16x2"
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end sharded decoded-cache query over all local devices."""
    from ..ops.decoded import build_decoded_cache

    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    S = mesh.devices.size
    n_valid = codes.shape[0]
    per = max(8, -(-n_valid // S))
    total = S * per
    codes_p = np.asarray(codes)
    if len(codes_p) < total:
        codes_p = np.concatenate(
            [codes_p, np.zeros((total - len(codes_p), codes.shape[1]),
                               codes.dtype)])
    hi, lo, pre = build_decoded_cache(codewords, codes_p)
    pre[n_valid:] = np.inf
    M, K, Ds = codewords.shape
    q = np.asarray(queries, np.float32)
    if q.shape[1] < M * Ds:
        q = np.pad(q, ((0, 0), (0, M * Ds - q.shape[1])))
    table = adc_table(jnp.asarray(codewords, jnp.float32), jnp.asarray(q))
    sh = NamedSharding(mesh, P(axis))
    args = (jax.device_put(np.asarray(hi), sh),
            jax.device_put(np.asarray(lo), sh),
            jax.device_put(pre, sh),
            jax.device_put(codes_p, sh))
    fn = make_sharded_decoded_query_fn(mesh, top_k, precision, axis)
    d, i = fn(table, jnp.asarray(q), *args)
    return np.asarray(d), np.asarray(i)
