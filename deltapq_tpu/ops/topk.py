"""Top-k selection helper."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def smallest_k(dists: jnp.ndarray, top_k: int):
    """(values [B, k] ascending, indices [B, k]) of the smallest entries
    per row (exact ``lax.top_k``).  More requested than rows exist pads
    with (+inf, -1)."""
    B, n = dists.shape
    if top_k > n:
        neg, idx = jax.lax.top_k(-dists, n)
        pad_d = jnp.full((B, top_k - n), jnp.inf, dists.dtype)
        pad_i = jnp.full((B, top_k - n), -1, idx.dtype)
        return (jnp.concatenate([-neg, pad_d], axis=1),
                jnp.concatenate([idx, pad_i], axis=1))
    neg, idx = jax.lax.top_k(-dists, top_k)
    return -neg, idx
