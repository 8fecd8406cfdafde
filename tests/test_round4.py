"""Round-4 primitives: hierarchical unit selection, exact-all matmul
rerank, dedup expansion edge cases, in-graph escalation, memory-mapped
tiles."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_select_units_hierarchical_fence_invariant():
    """For NU > 16384 the two-level selection must keep the fence
    invariant: every unit NOT selected has min >= fence."""
    from deltapq_tpu.ops.fused_pallas import _select_units

    rng = np.random.default_rng(0)
    B, NU, ns = 4, 20000, 8
    mins = rng.normal(size=(B, NU)).astype(np.float32) * 10
    sub_ids, fence = jax.jit(
        lambda m: _select_units(m, ns))(jnp.asarray(mins))
    sub_ids, fence = np.asarray(sub_ids), np.asarray(fence)
    assert sub_ids.shape == (B, ns)
    for b in range(B):
        sel = set(sub_ids[b].tolist())
        assert len(sel) == ns
        unsel = np.setdiff1d(np.arange(NU), list(sel))
        assert mins[b, unsel].min() >= fence[b] - 1e-5


def test_select_units_hierarchical_matches_flat_when_easy():
    """On well-separated mins the hierarchical path finds the true
    top units (a miss would only cost escalation, but on easy data
    there should be none)."""
    from deltapq_tpu.ops.fused_pallas import _select_units

    rng = np.random.default_rng(1)
    B, NU, ns = 2, 32768, 4
    mins = rng.uniform(10, 20, size=(B, NU)).astype(np.float32)
    best = rng.integers(0, NU, size=(B, ns))
    for b in range(B):
        mins[b, best[b]] = np.arange(ns)  # clearly smallest
    sub_ids, fence = _select_units(jnp.asarray(mins), ns)
    for b in range(B):
        assert set(np.asarray(sub_ids)[b].tolist()) == \
            set(best[b].tolist())
        assert fence[b] >= 10 - 1e-5


def test_exact_all_topk_matches_plain_scan():
    from deltapq_tpu.ops.adc import adc_table
    from deltapq_tpu.ops.fused import exact_all_topk
    from deltapq_tpu.ops import query_plain

    rng = np.random.default_rng(2)
    M, K, Ds, n, B, k = 4, 16, 8, 700, 8, 5
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32)
    n_pad = 1024
    cp = np.zeros((n_pad, M), np.uint8)
    cp[:n] = codes
    tab = adc_table(jnp.asarray(cw), jnp.asarray(q))
    d, ids = exact_all_topk(tab, jnp.asarray(cp), jnp.int32(n), k)
    d_ref, i_ref = query_plain(cw, q, codes, top_k=k)
    np.testing.assert_allclose(np.asarray(d), d_ref, rtol=1e-5,
                               atol=1e-4)
    # ids may differ only on exact-distance ties
    mism = np.asarray(ids) != np.asarray(i_ref)
    assert np.allclose(np.asarray(d)[mism], d_ref[mism])


def test_dedup_expand_edges():
    from deltapq_tpu.ops.fused import DedupCompressedEngine

    rng = np.random.default_rng(3)
    M, K = 4, 16
    cw = rng.normal(size=(M, K, 8)).astype(np.float32)
    # 3 distinct codes with counts 1, 2, 5
    base = rng.integers(0, K, size=(3, M)).astype(np.uint8)
    codes = np.concatenate([base[0:1],
                            np.repeat(base[1:2], 2, axis=0),
                            np.repeat(base[2:3], 5, axis=0)])
    ded = DedupCompressedEngine(cw, codes)
    assert ded.n_unique == 3
    q = rng.normal(size=(2, M * 8)).astype(np.float32)
    # top_k spanning several duplicate groups
    d, ids = ded.query(q, top_k=6)
    assert d.shape == (2, 6) and ids.shape == (2, 6)
    # every id valid exactly once, distances ascending
    for b in range(2):
        u = ids[b][ids[b] >= 0]
        assert len(np.unique(u)) == len(u)
        dd = d[b][np.isfinite(d[b])]
        assert (np.diff(dd) >= -1e-5).all()
    # top_k beyond the database: padded with (inf, -1)
    d, ids = ded.query(q, top_k=10)
    assert (ids[:, 8:] == -1).all() and np.isinf(d[:, 8:]).all()


def test_dedup_matches_plain_scan_small():
    from deltapq_tpu.ops.fused import DedupCompressedEngine
    from deltapq_tpu.ops import query_plain

    rng = np.random.default_rng(4)
    M, K = 4, 16
    cw = rng.normal(size=(M, K, 8)).astype(np.float32)
    distinct = rng.integers(0, K, size=(60, M)).astype(np.uint8)
    codes = distinct[rng.integers(0, 60, size=2000)]
    ded = DedupCompressedEngine(cw, codes)
    q = rng.normal(size=(5, M * 8)).astype(np.float32)
    d, ids = ded.query(q, top_k=7)
    d_ref, _ = query_plain(cw, q, codes, top_k=7)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


def test_dedup_chunked_inner_engine():
    """Above the chunk threshold the dedup tier composes with the
    chunked engine; results must still match the plain scan."""
    from deltapq_tpu.ops.fused import DedupCompressedEngine
    from deltapq_tpu.ops import query_plain

    rng = np.random.default_rng(9)
    M, K = 4, 16
    cw = rng.normal(size=(M, K, 8)).astype(np.float32)
    distinct = rng.integers(0, K, size=(2600, M)).astype(np.uint8)
    codes = distinct[rng.integers(0, 2600, size=8000)]
    ded = DedupCompressedEngine(cw, codes, chunked_min_rows=1000)
    from deltapq_tpu.bigscale import ChunkedCompressedEngine
    assert isinstance(ded.engine, ChunkedCompressedEngine)
    q = rng.normal(size=(4, M * 8)).astype(np.float32)
    d, ids = ded.query(q, top_k=6)
    d_ref, _ = query_plain(cw, q, codes, top_k=6)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


def test_stream_tiles_mmap_roundtrip(tmp_path):
    from deltapq_tpu.ops.stream_tiles import (build_stream_tiles,
                                              decode_stream_tiles)

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, size=(3000, 8)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.9] = 7  # compressible
    st = build_stream_tiles(codes)
    p = str(tmp_path / "tiles")
    st.save(p)
    for mmap in (False, True):
        st2 = st.load(p, mmap=mmap)
        assert st2.n_valid == st.n_valid and st2.e_max == st.e_max
        np.testing.assert_array_equal(decode_stream_tiles(st2), codes)
        if mmap:
            assert isinstance(st2.vals, np.memmap)


def test_chunked_engine_saved_mmap_query(tmp_path):
    """Beyond-host-RAM mode: a saved chunked engine reopened with
    memory-mapped tiles must answer queries identically."""
    from deltapq_tpu.bigscale import ChunkedCompressedEngine
    from deltapq_tpu.ops.encode import pq_encode
    from deltapq_tpu.ops.kmeans import pq_learn

    rng = np.random.default_rng(6)
    n, d = 6000, 32
    centers = rng.normal(size=(64, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 64, size=n)]
         + rng.normal(size=(n, d)).astype(np.float32) * 0.2)
    cw = np.asarray(pq_learn(jax.random.PRNGKey(0), x, M=4, K=16,
                             max_iters=10))
    codes = np.asarray(pq_encode(cw, x))
    order = np.lexsort(codes.T[::-1])
    eng = ChunkedCompressedEngine(cw, codes[order], row_to_db=order,
                                  chunk_rows=2048, resident=False)
    q = x[:8] + 0.01
    d_ref, i_ref = eng.query(q, top_k=5)
    p = str(tmp_path / "eng")
    eng.save(p)
    eng2 = ChunkedCompressedEngine.from_saved(p, mmap=True,
                                              resident=False)
    d2, i2 = eng2.query(q, top_k=5)
    np.testing.assert_allclose(d2, d_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(i2, i_ref)


def test_final_exact_terminal_scan_guarantees_results():
    """fused_select_esc(final_exact=True) must return plain-scan
    results even when every certificate fails (forced via the
    ``invalid`` mask) — the cond-gated terminal scan is the
    correctness backstop."""
    from deltapq_tpu.ops.adc import adc_table
    from deltapq_tpu.ops.fused import fused_select_esc
    from deltapq_tpu.ops import fused_pallas as fp
    from deltapq_tpu.ops import query_plain

    rng = np.random.default_rng(10)
    M, K, Ds, n, B, k = 4, 16, 8, 2048, 8, 5
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32)
    tab = adc_table(jnp.asarray(cw), jnp.asarray(q))
    # mins from the true distances (subtile min over SUB rows), so the
    # selection itself is sound — only the certificate is sabotaged
    tabn = np.asarray(tab)
    d_all = np.zeros((B, n), np.float32)
    for m in range(M):
        d_all += tabn[:, m, :][:, codes[:, m].astype(np.int64)]
    q2 = np.sum(q * q, axis=1).astype(np.float32)
    mins_bn = (d_all - q2[:, None]).reshape(
        B, n // fp.SUB, fp.SUB).min(axis=2)              # [B, NU]
    mins_nb = jnp.asarray(mins_bn.T.astype(np.float32))
    fail = jnp.ones((B,), bool)  # certificate always fails
    d, rows, ok, ok1 = fused_select_esc(
        mins_nb, jnp.asarray(q2), tab, jnp.asarray(codes),
        jnp.int32(n), k, (2,), 1, invalid=fail, final_exact=True)
    assert not bool(jnp.any(ok))             # all forced to terminal
    d_ref, _ = query_plain(cw, q, codes, top_k=k)
    np.testing.assert_allclose(np.asarray(d), d_ref, rtol=1e-5,
                               atol=1e-4)


def test_index_auto_engine_resolution(monkeypatch):
    """engine="auto" resolves to the dedup tier on the GPU when the
    DISTINCT-code count fits the exact-all regime, the dense compressed
    tier above it, the plain XLA scan on the CPU (tests), and raises on
    any other platform."""
    from deltapq_tpu import DeltaPQIndex
    from deltapq_tpu.ops.fused import DedupCompressedEngine

    rng = np.random.default_rng(8)
    M, K = 4, 16
    cw = rng.normal(size=(M, K, 8)).astype(np.float32)
    distinct = rng.integers(0, K, size=(50, M)).astype(np.uint8)
    dup_codes = distinct[rng.integers(0, 50, size=3000)]
    idx = DeltaPQIndex(cw, dup_codes, build_tree=False)
    assert idx._resolve_auto(backend="gpu") == "fused_dedup"
    assert idx._resolve_auto(backend="cpu") == "xla"
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        idx._resolve_auto(backend="metal")
    uniq_codes = rng.integers(0, K, size=(3000, M)).astype(np.uint8)
    idx2 = DeltaPQIndex(cw, uniq_codes, build_tree=False)
    # ~3000 distinct codes still fit the exact-all regime
    assert idx2._resolve_auto(backend="gpu") == "fused_dedup"
    # above the exact-all bound the dense compressed tier wins
    monkeypatch.setattr(DedupCompressedEngine, "EXACT_ALL_MAX_ROWS",
                        1000)
    assert idx2._resolve_auto(backend="gpu") == "fused_compressed"


def test_warmup_compiles_query_path():
    from deltapq_tpu.ops.fused import FusedCompressedEngine

    rng = np.random.default_rng(7)
    M, K = 4, 16
    cw = rng.normal(size=(M, K, 8)).astype(np.float32)
    codes = rng.integers(0, K, size=(2500, M)).astype(np.uint8)
    eng = FusedCompressedEngine(cw, codes)
    eng.warmup(batch_sizes=(8,), top_k=3)
    d, ids = eng.query(rng.normal(size=(8, M * 8)).astype(np.float32),
                       top_k=3)
    assert d.shape == (8, 3)
