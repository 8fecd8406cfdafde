"""Stream-tile format: pack/decode losslessness, compressed-tier scan
parity vs the codes tier, engine exactness, save/load."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deltapq_tpu.ops import fused_pallas as fp
from deltapq_tpu.ops.fused import FusedCompressedEngine
from deltapq_tpu.ops.stream_tiles import (TILE, build_stream_tiles,
                                          decode_stream_tiles,
                                          window_groups)


def _structured_codes(rng, n, M, K=256):
    """Delta-compressible codes: repeated rows + sparse flips."""
    base = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    reps = rng.integers(1, 6, size=n)
    codes = np.repeat(base, reps, axis=0)[:n]
    flip = rng.random((len(codes), M)) < 0.15
    return np.where(flip, rng.integers(0, K, codes.shape), codes
                    ).astype(np.uint8)


@pytest.mark.parametrize("n,M", [(5000, 8), (TILE, 8), (1, 8),
                                 (TILE + 1, 8), (3000, 16), (777, 4)])
def test_roundtrip(n, M):
    rng = np.random.default_rng(n + M)
    codes = _structured_codes(rng, n, M)
    st = build_stream_tiles(codes)
    assert np.array_equal(decode_stream_tiles(st), codes)


def test_roundtrip_random_incompressible():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 256, size=(4000, 8), dtype=np.uint8)
    st = build_stream_tiles(codes)
    assert np.array_equal(decode_stream_tiles(st), codes)
    # every subspace differs -> ~1 + M bytes/row (plain + mask), plus
    # the fixed DMA-window tail slack (amortized away at real N)
    tail = window_groups(8, st.e_max) * 1024
    assert st.bytes_per_vec() < 8 + 1.2 + tail / len(codes)


def test_compresses_chain():
    rng = np.random.default_rng(4)
    n, M = 4000, 8
    codes = np.empty((n, M), np.uint8)
    codes[0] = rng.integers(0, 256, size=M)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        codes[i, rng.integers(0, M)] = rng.integers(0, 256)
    st = build_stream_tiles(codes)
    assert np.array_equal(decode_stream_tiles(st), codes)
    # mask byte + ~1 diff/row (+ tile-first full rows + window tail)
    tail = window_groups(8, st.e_max) * 1024
    assert st.bytes_per_vec() < 2.2 + tail / len(codes)


@pytest.mark.parametrize("M", [8, 16])
def test_kernel_matches_codes_tier(M):
    """The compressed tier's scan (device decode + fused scan) must
    produce bit-identical mins to the codes tier's scan of the same
    codes, and the decoded codes the rerank reads must equal them."""
    from deltapq_tpu.ops.stream_tiles import decode_stream_device

    rng = np.random.default_rng(M)
    n, K, Ds = 5000, 256, 4
    codes = _structured_codes(rng, n, M, K)
    st = build_stream_tiles(codes)

    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    mu = fp.codebook_center(cw)
    cb = fp.scan_codebook(cw, mu)
    d_pad = fp.scan_width(M * Ds)
    q = np.zeros((128, d_pad), np.float32)
    q[:, :M * Ds] = rng.normal(size=(128, M * Ds)) - mu
    qop = jnp.asarray(q, jnp.bfloat16).T

    dec = decode_stream_device(jnp.asarray(st.row_data),
                               jnp.asarray(st.vals),
                               jnp.asarray(st.meta), M)
    assert np.array_equal(np.asarray(dec)[:n], codes)
    mins = fp.scan_mins(qop, cb, dec, jnp.int32(n), M, K, Ds)

    codes_p = np.zeros((st.n_pad, M), np.uint8)
    codes_p[:n] = codes
    mins_ref = fp.scan_mins(qop, cb, jnp.asarray(codes_p), jnp.int32(n),
                            M, K, Ds)
    np.testing.assert_array_equal(np.asarray(mins),
                                  np.asarray(mins_ref))


def test_window_groups_covers_dense():
    # all-diff rows: e_max = M*TILE must still produce a valid window
    assert window_groups(8, 8 * TILE) >= 9


def test_engine_stream_exact(small_dataset):
    from deltapq_tpu.ops.adc import query_plain
    from deltapq_tpu.ops.encode import pq_encode
    from deltapq_tpu.ops.kmeans import pq_learn

    M, K = 4, 32
    cw = pq_learn(jax.random.key(0), small_dataset, M, K, max_iters=25)
    codes = np.asarray(pq_encode(cw, small_dataset))
    queries = small_dataset[:32] + 0.05
    d_ref, i_ref = query_plain(cw, queries, codes, top_k=10)
    order = np.lexsort(codes.T[::-1])
    eng = FusedCompressedEngine(cw, codes[order], row_to_db=order)
    d, i = eng.query(queries, top_k=10)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


def test_engine_stream_save_load(tmp_path, small_dataset):
    from deltapq_tpu.ops.encode import pq_encode
    from deltapq_tpu.ops.kmeans import pq_learn

    M, K = 4, 32
    cw = pq_learn(jax.random.key(1), small_dataset, M, K, max_iters=20)
    codes = np.asarray(pq_encode(cw, small_dataset))
    order = np.lexsort(codes.T[::-1])
    eng = FusedCompressedEngine(cw, codes[order], row_to_db=order)
    path = str(tmp_path / "engine")
    eng.save(path)
    eng2 = FusedCompressedEngine.load(path)
    assert eng2.bytes_per_vec() == eng.bytes_per_vec()
    q = small_dataset[:16]
    d1, i1 = eng.query(q, top_k=5)
    d2, i2 = eng2.query(q, top_k=5)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
