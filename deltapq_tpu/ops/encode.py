"""PQ encoding: nearest-centroid per subspace.

Reference ``PQTree::EncodePlain`` (``pq_tree.cpp:192-253``) loops M x K x
Ds per vector under OpenMP (``EncodeParallel``, ``main.cpp:29-58``).
Here the whole batch is a single jitted program: per subspace the
distance matrix is a full-f32 matrix product and the code is an argmin
over K.
Ties resolve to the lowest centroid id, matching the reference's
``dist < min`` scan order.
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def _encode_batch(codewords: jnp.ndarray, x: jnp.ndarray,
                  out_dtype: str = "uint8") -> jnp.ndarray:
    """codewords f32[M,K,Ds], x f32[n, M*Ds] -> codes [n, M]."""
    M, K, Ds = codewords.shape
    n = x.shape[0]
    xs = x.reshape(n, M, Ds)
    # d2[n, m, k] = |x|^2 - 2 x.c + |c|^2 ; |x|^2 constant in k -> skip
    cross = jnp.einsum("nmd,mkd->nmk", xs, codewords,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
    c2 = jnp.sum(codewords * codewords, axis=2)  # [M, K]
    d2 = c2[None] - 2.0 * cross
    return jnp.argmin(d2, axis=2).astype(out_dtype)


def pq_encode(codewords: np.ndarray, vecs: np.ndarray,
              batch_size: int = 131072) -> np.ndarray:
    """Encode vectors -> PQ codes [N, M] (uint8, or uint16 for K>256).

    Zero-pads short vectors like ``pq_tree.cpp:194-198``.  Host-side
    batching keeps device memory bounded for large N (the reference
    streams through a buffer of max(N/2000, 10000) vectors,
    ``main.cpp:358-389``).
    """
    codewords = np.asarray(codewords, np.float32)
    M, K, Ds = codewords.shape
    D = M * Ds
    out_dtype = "uint8" if K <= 256 else "uint16"
    vecs = np.asarray(vecs)
    if vecs.dtype not in (np.uint8, np.int8):
        # integer (bvecs-style) inputs stay narrow for the
        # host->device transfer and convert to f32 on device
        vecs = vecs.astype(np.float32, copy=False)
    if vecs.shape[1] < D:
        vecs = np.pad(vecs, ((0, 0), (0, D - vecs.shape[1])))
    elif vecs.shape[1] > D:
        raise ValueError(f"vector dim {vecs.shape[1]} > codebook dim {D}")
    cw = jnp.asarray(codewords)
    chunks = []
    for off in range(0, len(vecs), batch_size):
        xb = jnp.asarray(vecs[off:off + batch_size])
        if xb.dtype != jnp.float32:
            xb = xb.astype(jnp.float32)
        chunks.append(np.asarray(_encode_batch(cw, xb, out_dtype)))
    return np.concatenate(chunks, axis=0) if chunks else \
        np.empty((0, M), dtype=out_dtype)


def pq_decode(codewords: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Reconstruct vectors from codes (``PQTree::DecodePlain``,
    ``pq_tree.cpp:1243-1257``)."""
    codewords = np.asarray(codewords, np.float32)
    M, K, Ds = codewords.shape
    codes = np.asarray(codes)
    n = codes.shape[0]
    out = np.empty((n, M * Ds), dtype=np.float32)
    for m in range(M):
        out[:, m * Ds:(m + 1) * Ds] = codewords[m][codes[:, m]]
    return out
