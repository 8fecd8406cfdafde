"""Batched k-means for PQ codebook learning.

Reference (``PQ::Learn``, ``pq.cpp:129-157``) loops over the M subspaces
calling ``cv::kmeans`` (kmeans++ init, 3 attempts, <=1000 iters, eps 1.0)
one subspace at a time on the CPU.  Here a single jitted program runs
**all M subspaces x n_init restarts in parallel** via ``vmap``:

- distance computations are matrix products at full f32 precision
  (``d2 = |x|^2 - 2 x c^T + |c|^2``),
- centroid updates are one-hot products (segment sums),
- kmeans++ seeding is a ``lax.scan`` over K steps with an on-device
  categorical draw from the running min-distance distribution,
- Lloyd iterations run under ``lax.while_loop`` with the same
  center-shift epsilon semantics as cv::TermCriteria(EPS+MAX_ITER).

Empty clusters are re-seeded from the points currently farthest from
their assigned centroid (cv::kmeans similarly re-seeds from the biggest
cluster's far points).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _pairwise_sq_dists(x: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Squared L2 distances [n, K] between x [n, d] and c [K, d]."""
    x2 = jnp.sum(x * x, axis=1, keepdims=True)
    c2 = jnp.sum(c * c, axis=1)
    cross = jnp.dot(x, c.T, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
    return x2 - 2.0 * cross + c2[None, :]


def _kmeanspp_init(key: jax.Array, x: jnp.ndarray, K: int
                   ) -> jnp.ndarray:
    """kmeans++ seeding: first center uniform, then next centers drawn
    with probability proportional to squared distance to the nearest
    already-chosen center (a ``lax.scan`` over K-1 sequential draws)."""
    n, d = x.shape
    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, n)
    centers0 = jnp.zeros((K, d), x.dtype).at[0].set(x[first])
    min_d2 = jnp.sum((x - x[first]) ** 2, axis=1)

    def step(carry, ki):
        centers, min_d2 = carry
        i, k = ki
        total = jnp.sum(min_d2)
        logits = jnp.where(total > 0,
                           jnp.log(jnp.maximum(min_d2, 1e-30)),
                           jnp.zeros_like(min_d2))
        idx = jax.random.categorical(k, logits)
        c_new = x[idx]
        centers = centers.at[i].set(c_new)
        d2_new = jnp.sum((x - c_new) ** 2, axis=1)
        return (centers, jnp.minimum(min_d2, d2_new)), None

    keys = jax.random.split(key, K - 1)
    (centers, _), _ = jax.lax.scan(
        step, (centers0, min_d2), (jnp.arange(1, K), keys))
    return centers


def _update_centers(x: jnp.ndarray, labels: jnp.ndarray, K: int
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean per cluster via a one-hot product (segment sum)."""
    onehot = jax.nn.one_hot(labels, K, dtype=x.dtype)  # [n, K]
    counts = jnp.sum(onehot, axis=0)  # [K]
    sums = jnp.dot(onehot.T, x, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)  # [K, d]
    means = sums / jnp.maximum(counts, 1.0)[:, None]
    return means, counts


def _reseed_empty(x: jnp.ndarray, centers: jnp.ndarray, counts: jnp.ndarray,
                  min_d2: jnp.ndarray) -> jnp.ndarray:
    """Replace empty clusters' centers with the points farthest from
    their assigned center (deterministic)."""
    K = centers.shape[0]
    empty = counts == 0  # [K]
    # rank empty clusters 0..e-1
    order = jnp.cumsum(empty.astype(jnp.int32)) - 1  # index among empties
    far_idx = jnp.argsort(-min_d2)[:K]  # K farthest points
    repl = x[far_idx]  # [K, d]
    cand = repl[jnp.clip(order, 0, K - 1)]
    return jnp.where(empty[:, None], cand, centers)


@functools.partial(jax.jit, static_argnames=("K", "max_iters", "tol"))
def _kmeans_single(key: jax.Array, x: jnp.ndarray, K: int,
                   max_iters: int, tol: float):
    centers = _kmeanspp_init(key, x, K)

    def cond(state):
        _, _, shift2, it = state
        return jnp.logical_and(it < max_iters, shift2 > tol * tol)

    def body(state):
        centers, _, _, it = state
        d2 = _pairwise_sq_dists(x, centers)
        labels = jnp.argmin(d2, axis=1)
        min_d2 = jnp.min(d2, axis=1)
        new_centers, counts = _update_centers(x, labels, K)
        new_centers = _reseed_empty(x, new_centers, counts, min_d2)
        shift2 = jnp.max(jnp.sum((new_centers - centers) ** 2, axis=1))
        distortion = jnp.sum(min_d2)
        return new_centers, distortion, shift2, it + 1

    init = (centers, jnp.float32(jnp.inf), jnp.float32(jnp.inf),
            jnp.int32(0))
    centers, _, _, _ = jax.lax.while_loop(cond, body, init)
    d2 = _pairwise_sq_dists(x, centers)
    labels = jnp.argmin(d2, axis=1)
    distortion = jnp.sum(jnp.min(d2, axis=1))
    return centers, labels, distortion


def kmeans(key: jax.Array, x: jnp.ndarray, K: int, max_iters: int = 1000,
            tol: float = 1.0, n_init: int = 3):
    """k-means with ``n_init`` parallel restarts; returns the best
    (centers [K,d], labels [n], distortion) by total distortion.

    Matches reference semantics ``cv::kmeans(..., attempts=3,
    KMEANS_PP_CENTERS)`` at ``pq.cpp:149-151``.
    """
    keys = jax.random.split(key, n_init)
    centers, labels, dist = jax.vmap(
        lambda k: _kmeans_single(k, x, K, max_iters, tol))(keys)
    best = jnp.argmin(dist)
    return centers[best], labels[best], dist[best]


def pq_learn(key: jax.Array, vecs: np.ndarray, M: int, K: int,
             max_iters: int = 1000, tol: float = 1.0, n_init: int = 3
             ) -> np.ndarray:
    """Learn a PQ codebook: returns codewords f32 [M, K, Ds].

    Splits the (zero-padded, ``pq.cpp:113-124``) dimensions into M
    contiguous slices and runs all M k-means problems as one vmapped
    program on the active backend (the reference loops subspaces
    serially, ``pq.cpp:139-156``).
    """
    vecs = np.asarray(vecs, np.float32)
    n, D = vecs.shape
    pad = (-D) % M
    if pad:
        vecs = np.pad(vecs, ((0, 0), (0, pad)))
    Ds = (D + pad) // M
    sub = jnp.asarray(np.ascontiguousarray(
        vecs.reshape(n, M, Ds).transpose(1, 0, 2)))  # [M, n, Ds]
    keys = jax.random.split(key, M)
    centers, _, _ = jax.vmap(
        lambda k, xs: kmeans(k, xs, K, max_iters, tol, n_init)
    )(keys, sub)
    return np.asarray(centers)
