"""Asymmetric distance computation (ADC): table build + linear scan.

Reference: per-query table ``m_sub_distances[M][K]`` built at every query
site (``pq.cpp:219-237``, ``pq_tree.cpp:445-454``) and a serial scan
``sum += T[m][code[m]]`` with a size-k max-heap (``pq_tree.cpp:457-474``).

Here tables for a whole query batch are one product [B, M, K]; the
scan is tiled over the database with a running top-k carried through
``lax.scan``, so arbitrary N streams through fixed device memory.  The
per-tile distance is M gathers of [B, tile].  ``adc_rerank`` is the same
table sum over per-query candidate rows (the fused engines' rerank).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def adc_table(codewords: jnp.ndarray, queries: jnp.ndarray) -> jnp.ndarray:
    """Squared-L2 table T[b, m, k] between query slices and codewords.

    codewords f32[M, K, Ds]; queries f32[B, D] (D = M*Ds, zero-padded by
    caller if needed).  Matches ``PQ::DTable`` (``pq.cpp:219-237``):
    the direct form sum_j (q_j - c_j)^2, accumulated in ascending j with
    explicit f32 adds.  No matrix product is involved, so every entry is
    the same bits whatever the batch width or the library's algorithm
    choice (an expanded-form product rounds differently per shape), and
    no reduced-precision (TF32) path can touch the exact distances.
    """
    M, K, Ds = codewords.shape
    B = queries.shape[0]
    qs = queries.reshape(B, M, Ds)
    acc = jnp.zeros((B, M, K), jnp.float32)
    for j in range(Ds):
        diff = qs[:, :, j:j + 1] - codewords[None, :, :, j]
        acc = acc + diff * diff
    return acc


def adc_tile_dists(table: jnp.ndarray, codes_tile: jnp.ndarray
                   ) -> jnp.ndarray:
    """Distances [B, tile] for one tile of codes [tile, M].

    dist[b, n] = sum_m T[b, m, codes[n, m]] — M gathers over the K axis.
    """
    B, M, K = table.shape
    codes_tile = codes_tile.astype(jnp.int32)
    acc = jnp.zeros((B, codes_tile.shape[0]), jnp.float32)
    for m in range(M):  # M is small & static; unrolled gathers
        acc = acc + jnp.take(table[:, m, :], codes_tile[:, m], axis=1)
    return acc


def adc_rerank(table: jnp.ndarray, cand_codes: jnp.ndarray
               ) -> jnp.ndarray:
    """Exact distances [B, S] of per-query candidates cand_codes
    [B, S, M]: sum_m T[b, m, code] in ascending m with explicit adds,
    the same values and order as ``adc_tile_dists`` (bit-identical)."""
    B, M, K = table.shape
    tf = table.reshape(B, M * K)
    acc = jnp.zeros(cand_codes.shape[:2], jnp.float32)
    for m in range(M):
        acc = acc + jnp.take_along_axis(
            tf, m * K + cand_codes[:, :, m].astype(jnp.int32), axis=1)
    return acc


def exact_dists_for_ids(table: jnp.ndarray, codes: jnp.ndarray,
                        ids: jnp.ndarray) -> jnp.ndarray:
    """Exact f32 distances for row ids [B, k] of ``codes`` (ids are
    clipped, so -1 sentinels read row 0 harmlessly)."""
    safe = jnp.clip(ids, 0, codes.shape[0] - 1)
    return adc_rerank(table, codes[safe])


@functools.partial(jax.jit, static_argnames=("top_k", "tile_n"))
def adc_query_topk(table: jnp.ndarray, codes: jnp.ndarray, n_valid: jnp.ndarray,
                   top_k: int, tile_n: int = 16384
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming ADC scan with running top-k.

    table f32[B, M, K]; codes [N_pad, M] with N_pad % tile_n == 0;
    n_valid: true database size (padding rows get +inf distance).
    Returns (dists [B, top_k] ascending, ids [B, top_k]).
    """
    B = table.shape[0]
    n_pad = codes.shape[0]
    assert n_pad % tile_n == 0, "pad codes to a multiple of tile_n"
    n_tiles = n_pad // tile_n
    codes_t = codes.reshape(n_tiles, tile_n, codes.shape[1])

    init_d = jnp.full((B, top_k), jnp.inf, jnp.float32)
    init_i = jnp.full((B, top_k), -1, jnp.int32)

    def step(carry, inp):
        best_d, best_i = carry
        tile_idx, ct = inp
        base = tile_idx * tile_n
        d = adc_tile_dists(table, ct)
        ids = base + jax.lax.broadcasted_iota(jnp.int32, (1, tile_n), 1)
        d = jnp.where(ids < n_valid, d, jnp.inf)
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate([best_i, jnp.broadcast_to(ids, (B, tile_n))],
                                axis=1)
        neg_top, pos = jax.lax.top_k(-cat_d, top_k)
        new_i = jnp.take_along_axis(cat_i, pos, axis=1)
        return (-neg_top, new_i), None

    (best_d, best_i), _ = jax.lax.scan(
        step, (init_d, init_i),
        (jnp.arange(n_tiles, dtype=jnp.int32), codes_t))
    # ascending order
    order = jnp.argsort(best_d, axis=1)
    return (jnp.take_along_axis(best_d, order, axis=1),
            jnp.take_along_axis(best_i, order, axis=1))


def pad_codes(codes: np.ndarray, tile_n: int) -> np.ndarray:
    """Pad the database to a multiple of tile_n (padding rows are code 0;
    they are masked by n_valid during scans)."""
    n = codes.shape[0]
    pad = (-n) % tile_n
    if pad:
        codes = np.concatenate(
            [codes, np.zeros((pad, codes.shape[1]), codes.dtype)], axis=0)
    return codes


def query_plain(codewords: np.ndarray, queries: np.ndarray,
                codes: np.ndarray, top_k: int = 10, tile_n: int = 16384
                ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end plain ADC query (reference ``PQTree::QueryPlain``,
    ``pq_tree.cpp:434-503``): build tables, exact gather scan, top-k.

    Returns (dists [B, top_k], ids [B, top_k]).
    """
    codewords = jnp.asarray(codewords, jnp.float32)
    M, K, Ds = codewords.shape
    D = M * Ds
    q = np.asarray(queries, np.float32)
    if q.shape[1] < D:
        q = np.pad(q, ((0, 0), (0, D - q.shape[1])))
    n_valid = codes.shape[0]
    tile_n = min(tile_n, max(256, 1 << (n_valid - 1).bit_length()))
    codes_p = pad_codes(np.asarray(codes), tile_n)
    table = adc_table(codewords, jnp.asarray(q))
    d, i = adc_query_topk(table, jnp.asarray(codes_p),
                          jnp.int32(n_valid), top_k, tile_n)
    return np.asarray(d), np.asarray(i)
