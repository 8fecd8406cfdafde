"""Fused-scan engines: parity vs the exact XLA plain scan.

Both tiers must report exact f32 ADC distances and the same ids
(modulo equal-distance ties) as the plain gather scan ``query_plain``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deltapq_tpu.ops.adc import query_plain
from deltapq_tpu.ops.encode import pq_encode
from deltapq_tpu.ops.fused import (FusedCodesEngine,
                                   FusedCompressedEngine)
from deltapq_tpu.ops.kmeans import pq_learn


@pytest.fixture(scope="module")
def pq_setup(small_dataset):
    M, K = 4, 32
    cw = pq_learn(jax.random.key(0), small_dataset, M, K, max_iters=25)
    codes = pq_encode(cw, small_dataset)
    queries = small_dataset[:64] + 0.05
    d_ref, i_ref = query_plain(cw, queries, codes, top_k=10)
    return cw, codes, queries, d_ref, i_ref


def _check(d, i, d_ref, i_ref):
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)
    # id agreement modulo ties: compare distance multisets instead of
    # raw ids (equal distances may order differently)
    assert (np.mean(i == i_ref) > 0.9) or np.allclose(d, d_ref)


def test_fused_codes_parity(pq_setup):
    cw, codes, queries, d_ref, i_ref = pq_setup
    eng = FusedCodesEngine(cw, codes)
    d, i = eng.query(queries, top_k=10)
    _check(d, i, d_ref, i_ref)


def test_fused_codes_with_order(pq_setup):
    cw, codes, queries, d_ref, i_ref = pq_setup
    rng = np.random.default_rng(1)
    order = rng.permutation(len(codes))
    eng = FusedCodesEngine(cw, codes, order=order)
    d, i = eng.query(queries, top_k=10)
    _check(d, i, d_ref, i_ref)


def test_fused_compressed_parity(pq_setup):
    cw, codes, queries, d_ref, i_ref = pq_setup
    # scan order: sort codes lexicographically (clusters similar rows,
    # like DFS order does)
    order = np.lexsort(np.asarray(codes).T[::-1])
    eng = FusedCompressedEngine(cw, np.asarray(codes)[order],
                                row_to_db=order)
    d, i = eng.query(queries, top_k=10)
    _check(d, i, d_ref, i_ref)


def test_fused_compressed_from_tree(pq_setup, small_dataset):
    cw, codes, queries, d_ref, i_ref = pq_setup
    from deltapq_tpu.tree.build import find_edges_by_diff
    from deltapq_tpu.tree.layout import build_layout

    res = find_edges_by_diff(np.asarray(codes), K=32)
    tree = build_layout(np.asarray(codes), res.edges, res.root_id,
                        K=32, codewords=cw)
    eng = FusedCompressedEngine.from_tree(cw, tree)
    assert eng.bytes_per_vec() < eng.M  # compresses vs plain codes
    d, i = eng.query(queries, top_k=10)
    _check(d, i, d_ref, i_ref)


def test_fused_topk_larger_than_one_subtile(pq_setup):
    cw, codes, queries, _, _ = pq_setup
    d_ref, i_ref = query_plain(cw, queries, codes, top_k=100)
    eng = FusedCompressedEngine(cw, codes)
    d, i = eng.query(queries, top_k=100)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def gist_setup():
    """GIST1M-config shapes: M=16, D=960 — two mask planes in the
    stream-tile format, a 1024-wide padded scan contraction."""
    rng = np.random.default_rng(8)
    M, K, Ds, n, B = 16, 32, 60, 4000, 16
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    # chain-correlated codes so the delta tiles actually compress
    codes = np.empty((n, M), np.uint8)
    codes[0] = rng.integers(0, K, size=M)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        for _ in range(rng.integers(1, 3)):
            codes[i, rng.integers(0, M)] = rng.integers(0, K)
    queries = rng.normal(size=(B, M * Ds)).astype(np.float32)
    return cw, codes, queries


def test_fused_codes_m16_parity(gist_setup):
    cw, codes, queries = gist_setup
    d_ref, i_ref = query_plain(cw, queries, codes, top_k=100)
    eng = FusedCodesEngine(cw, codes)
    d, i = eng.query(queries, top_k=100)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


def test_fused_compressed_m16_parity(gist_setup):
    cw, codes, queries = gist_setup
    d_ref, i_ref = query_plain(cw, queries, codes, top_k=100)
    eng = FusedCompressedEngine(cw, codes)
    d, i = eng.query(queries, top_k=100)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


def test_fused_topk_near_database_size():
    """top_k close to (or beyond the candidate pool of) a tiny database
    must pad with (+inf, -1) instead of failing."""
    rng = np.random.default_rng(9)
    M, K, Ds, n = 8, 16, 4, 700
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    queries = rng.normal(size=(4, M * Ds)).astype(np.float32)
    eng = FusedCodesEngine(cw, codes)
    d, i = eng.query(queries, top_k=680)
    assert d.shape == (4, 680)
    valid = np.isfinite(d)
    d_ref, i_ref = query_plain(cw, queries, codes, top_k=680)
    np.testing.assert_allclose(d[valid],
                               np.asarray(d_ref)[valid], rtol=1e-5,
                               atol=1e-4)


def test_fused_compressed_save_load(pq_setup, tmp_path):
    cw, codes, queries, d_ref, i_ref = pq_setup
    order = np.lexsort(np.asarray(codes).T[::-1])
    eng = FusedCompressedEngine(cw, np.asarray(codes)[order],
                                row_to_db=order)
    p = str(tmp_path / "ct.npz")
    eng.save(p)
    eng2 = FusedCompressedEngine.load(p)
    d, i = eng2.query(queries, top_k=10)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


def test_dedup_engine_exact(small_dataset):
    """Dedup tier == plain scan distances on heavily duplicated codes
    (ids may permute within equal-distance duplicate groups)."""
    import jax

    from deltapq_tpu.ops.adc import adc_table, query_plain
    from deltapq_tpu.ops.encode import pq_encode
    from deltapq_tpu.ops.fused import DedupCompressedEngine
    from deltapq_tpu.ops.kmeans import pq_learn

    M, K = 4, 16  # coarse codebook -> many duplicate codes
    cw = pq_learn(jax.random.key(0), small_dataset, M, K, max_iters=15)
    codes = np.asarray(pq_encode(cw, small_dataset))
    eng = DedupCompressedEngine(cw, codes)
    assert eng.n_unique < len(codes)
    q = small_dataset[:24] + 0.02
    d_ref, i_ref = query_plain(cw, q, codes, top_k=10)
    d, ids = eng.query(q, top_k=10)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)
    # every returned id's exact table distance equals the reported one
    tab = np.asarray(adc_table(jnp.asarray(np.asarray(cw)),
                               jnp.asarray(q)))
    for b in range(len(q)):
        for j in range(10):
            rid = ids[b, j]
            assert rid >= 0
            dt = sum(tab[b, m, codes[rid, m]]
                     for m in range(codes.shape[1]))
            assert abs(dt - d[b, j]) <= 1e-3 + 1e-5 * abs(dt)
    assert eng.bytes_per_vec() < codes.shape[1]
