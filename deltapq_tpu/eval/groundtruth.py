"""Exact brute-force top-k groundtruth.

Reference: ``batch_partial_topk_queries`` (``main.cpp:107-166``) — OpenMP
over queries x streamed buffers, exact squared L2, per-query max-heap.
Here the distance matrix for a (query batch x database tile) is one
full-f32 matrix product (``d2 = |q|^2 - 2 q x^T + |x|^2``), with a
running top-k merged per tile.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("top_k",))
def _exact_tile_topk(q: jnp.ndarray, x_tile: jnp.ndarray, base: jnp.ndarray,
                     n_valid: jnp.ndarray, best_d: jnp.ndarray,
                     best_i: jnp.ndarray, top_k: int):
    """Merge one database tile into the running (best_d, best_i)."""
    B = q.shape[0]
    tile = x_tile.shape[0]
    q2 = jnp.sum(q * q, axis=1, keepdims=True)
    x2 = jnp.sum(x_tile * x_tile, axis=1)
    d2 = q2 - 2.0 * jnp.dot(q, x_tile.T,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32) \
        + x2[None, :]
    ids = base + jax.lax.broadcasted_iota(jnp.int32, (1, tile), 1)
    d2 = jnp.where(ids < n_valid, d2, jnp.inf)
    cat_d = jnp.concatenate([best_d, d2], axis=1)
    cat_i = jnp.concatenate([best_i, jnp.broadcast_to(ids, (B, tile))], axis=1)
    neg_top, pos = jax.lax.top_k(-cat_d, top_k)
    return -neg_top, jnp.take_along_axis(cat_i, pos, axis=1)


def exact_topk(queries: np.ndarray, base_iter, top_k: int = 100,
               tile_n: int = 65536) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over a database streamed as an iterable of [tile, D]
    arrays (or a single [N, D] array).

    Returns (dists [B, top_k] squared-L2 ascending, ids [B, top_k]).
    """
    q = jnp.asarray(np.asarray(queries, np.float32))
    B = q.shape[0]
    if isinstance(base_iter, np.ndarray):
        arr = base_iter
        base_iter = (arr[i:i + tile_n] for i in range(0, len(arr), tile_n))
    best_d = jnp.full((B, top_k), jnp.inf, jnp.float32)
    best_i = jnp.full((B, top_k), -1, jnp.int32)
    offset = 0
    for x_tile in base_iter:
        # keep integer (bvecs-style) tiles in their narrow dtype for
        # the host->device transfer; convert to f32 on device
        x_tile = np.asarray(x_tile)
        if x_tile.dtype not in (np.uint8, np.int8):
            x_tile = x_tile.astype(np.float32, copy=False)
        n = len(x_tile)
        pad = (-n) % 256
        if pad:
            x_tile = np.pad(x_tile, ((0, pad), (0, 0)))
        xd = jnp.asarray(x_tile)
        if xd.dtype != jnp.float32:
            xd = xd.astype(jnp.float32)
        best_d, best_i = _exact_tile_topk(
            q, xd, jnp.int32(offset),
            jnp.int32(offset + n), best_d, best_i, top_k)
        offset += n
    order = jnp.argsort(best_d, axis=1)
    d = np.asarray(jnp.take_along_axis(best_d, order, axis=1))
    i = np.asarray(jnp.take_along_axis(best_i, order, axis=1))
    return d, i


def groundtruth_from_file(base_path: str, queries: np.ndarray, ext: str,
                          top_k: int = 100, top_n: int = -1,
                          tile_n: int = 262144
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Stream base vectors from a TEXMEX file (reference ``groundtruth``
    task, ``main.cpp:569-669``)."""
    from ..io.vecs import iter_vec_batches

    it = iter_vec_batches(base_path, ext=ext, batch_size=tile_n, top_n=top_n)
    return exact_topk(queries, it, top_k=top_k)
