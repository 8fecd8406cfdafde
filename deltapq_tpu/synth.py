"""Synthetic datasets for testing/benchmarks.

``chain_codes`` mirrors the reference's ``-synth`` generator
(``main.cpp:443-462``): a chain of PQ codes where each code differs from
its predecessor in exactly one subspace — the designed best case for
DeltaPQ compression (every tree edge has weight 1).
"""

from __future__ import annotations

import numpy as np


def chain_codes(n: int, M: int = 8, K: int = 256, seed: int = 0
                ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if K <= 256 else np.uint16
    codes = np.empty((n, M), dtype)
    codes[0] = rng.integers(0, K, M)
    ms = rng.integers(0, M, n - 1)
    # new value differs from old: draw from K-1 and shift
    deltas = rng.integers(1, K, n - 1)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        m = ms[i - 1]
        codes[i, m] = (int(codes[i, m]) + int(deltas[i - 1])) % K
    return codes


def clustered_vectors(n: int, dim: int, n_clusters: int = 64,
                      spread: float = 1.0, scale: float = 4.0,
                      seed: int = 0) -> np.ndarray:
    """Gaussian mixture — gives PQ codes with heavy sharing (realistic
    for DeltaTree compression tests)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * scale
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] +
            rng.normal(size=(n, dim)).astype(np.float32) * spread)


#: calibrated workload recipes for 128-d data coded at M=8, K=256:
#: (rows per cluster, noise sigma) set the PQ-code duplication factor
#: (measured at N=1M: sift_like ~1.06x, moderate ~2x, dup_heavy ~37x
#: with <= 64K distinct codes)
WORKLOADS = {
    "sift_like": dict(rows_per_cluster=8, sigma=0.8),
    "moderate": dict(rows_per_cluster=16, sigma=0.35),
    "dup_heavy": dict(rows_per_cluster=256, sigma=0.35),
}


def workload_chunks(n: int, dim: int = 128, rows_per_cluster: int = 8,
                    sigma: float = 0.8, seed: int = 0,
                    chunk: int = 1 << 20):
    """Gaussian-mixture vectors of a ``WORKLOADS`` recipe, yielded in
    ``chunk``-row f32 blocks (host memory holds one block at a time).
    Cluster centers are drawn once; each block draws its own
    assignments and noise from ``seed``."""
    rng = np.random.default_rng(seed)
    n_clusters = max(n // rows_per_cluster, 1)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 4.0
    for c, lo in enumerate(range(0, n, chunk)):
        m = min(chunk, n - lo)
        r = np.random.default_rng([seed, c])
        x = centers[r.integers(0, n_clusters, size=m)]
        x += r.normal(size=(m, dim)).astype(np.float32) * sigma
        yield x
