"""Per-index certificate calibration, warmup routing at scale, and
index-space edge audits."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deltapq_tpu.ops import query_plain
from deltapq_tpu.ops.adc import adc_table
from deltapq_tpu.ops.encode import pq_encode
from deltapq_tpu.ops.fused import (FusedCompressedEngine,
                                   _select_with_escalation)
from deltapq_tpu.ops.kmeans import pq_learn
from deltapq_tpu.ops import fused_pallas as fp


@pytest.fixture(scope="module")
def clustered(small_dataset):
    M, K = 4, 32
    cw = pq_learn(jax.random.key(0), small_dataset, M, K, max_iters=25)
    codes = pq_encode(cw, small_dataset)
    return np.asarray(cw), np.asarray(codes)


def _sabotaged_args(seed=10, n=2048, B=8, M=4, K=16, Ds=8):
    """mins from true distances (sound selection) + every query marked
    invalid (certificate always fails): drives the adaptive path."""
    rng = np.random.default_rng(seed)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32)
    tab = adc_table(jnp.asarray(cw), jnp.asarray(q))
    tabn = np.asarray(tab)
    d_all = np.zeros((B, n), np.float32)
    for m in range(M):
        d_all += tabn[:, m, :][:, codes[:, m].astype(np.int64)]
    q2 = np.sum(q * q, axis=1).astype(np.float32)
    mins_bn = (d_all - q2[:, None]).reshape(
        B, n // fp.SUB, fp.SUB).min(axis=2)
    mins_nb = jnp.asarray(mins_bn.T.astype(np.float32))
    fail = jnp.ones((B,), bool)
    return mins_nb, jnp.asarray(q2), tab, jnp.asarray(codes), fail


class _FakeEngine:
    ns_hint = None


def test_adaptive_ns_grows_on_certificate_collapse():
    """A failing first-shot certificate must double the engine's
    ns_hint (power-of-2 growth toward the ladder cap), so steady
    state stops paying the escalation rung every batch."""
    mins_nb, q2, tab, codes, fail = _sabotaged_args()
    eng = _FakeEngine()
    d, rows, frac = _select_with_escalation(
        mins_nb, q2, tab, codes, jnp.int32(codes.shape[0]), 5,
        invalid=fail, engine=eng)
    assert frac == 0.0
    assert eng.ns_hint is not None and eng.ns_hint >= 4
    first_hint = eng.ns_hint
    # second batch grows further from the hinted rung
    _select_with_escalation(
        mins_nb, q2, tab, codes, jnp.int32(codes.shape[0]), 5,
        invalid=fail, engine=eng)
    assert eng.ns_hint >= first_hint


def test_explicit_n_sub_disables_adaptation():
    mins_nb, q2, tab, codes, fail = _sabotaged_args()
    eng = _FakeEngine()
    _select_with_escalation(
        mins_nb, q2, tab, codes, jnp.int32(codes.shape[0]), 5,
        n_sub=2, invalid=fail, engine=eng)
    assert eng.ns_hint is None


def test_calibrate_reaches_target_and_stays_exact(clustered,
                                                 small_dataset):
    cw, codes = clustered
    eng = FusedCompressedEngine(cw, codes)
    frac = eng.calibrate(top_k=5, b=16)
    assert 0.0 <= frac <= 1.0
    q = small_dataset[:16] + 0.05
    d, i = eng.query(q, top_k=5)
    d_ref, i_ref = query_plain(cw, q, codes, top_k=5)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


def test_chunked_engine_warmup_seeds_all_chunks(clustered):
    from deltapq_tpu.bigscale import ChunkedCompressedEngine

    cw, codes = clustered
    eng = ChunkedCompressedEngine(cw, codes, chunk_rows=1024,
                                  resident=True)
    assert len(eng.chunks) >= 2
    eng.chunks[0].ns_hint = None
    eng.warmup(batch_sizes=(8,), top_k=5)
    hint = getattr(eng.chunks[0], "ns_hint", None)
    if hint:  # calibration raised the rung: every chunk must follow
        assert all(getattr(e, "ns_hint", None) == hint
                   for e in eng.chunks[1:])
    # queries remain exact after warmup/calibration
    rng = np.random.default_rng(3)
    q = rng.normal(size=(8, cw.shape[0] * cw.shape[2])
                   ).astype(np.float32)
    d, i = eng.query(q, top_k=5)
    d_ref, i_ref = query_plain(cw, q, codes, top_k=5)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------- #
# VERDICT r4 #6: SIFT1B index-space edge audit                      #
# ---------------------------------------------------------------- #

def test_stream_capacity_guard_boundary():
    """One engine's packed value stream caps at 2^31 values (i32
    kernel addressing); the guard is pure arithmetic so the boundary
    is testable without allocating 2 GB."""
    from deltapq_tpu.ops.stream_tiles import (MAX_STREAM_VALUES,
                                              check_stream_capacity)

    check_stream_capacity(MAX_STREAM_VALUES - 1)   # fine
    with pytest.raises(ValueError, match="Chunked"):
        check_stream_capacity(MAX_STREAM_VALUES)


def test_row_id_i32_guard_boundary():
    from deltapq_tpu.ops.fused import _row_ids_i32

    ok = _row_ids_i32(np.array([0, 2 ** 31 - 1], np.int64))
    assert ok.dtype == np.int32 and int(ok[1]) == 2 ** 31 - 1
    with pytest.raises(ValueError, match="i32 id map"):
        _row_ids_i32(np.array([2 ** 31], np.int64))


def test_stream_position_arithmetic_is_i64_on_host():
    """The host-side stream-position formula must be int64: positions
    beyond 2^31 would silently wrap in int32.  (The device-side cap is
    enforced by check_stream_capacity; this audits the HOST math used
    by build/decode on a synthetic near-boundary position.)"""
    p = np.int64(2 ** 31 + 12345)       # a position past i32
    flat_idx = (p // 1024) * 1024 + (p % 8) * 128 + (p // 8) % 128
    assert flat_idx.dtype == np.int64
    # round-trip: the chunked layout is a bijection on [0, 2^41)
    w, lane, sub = p // 1024, p % 8, (p // 8) % 128
    assert w * 1024 + sub * 8 + lane == p


def test_dedup_expand_counts_are_i64():
    """Cumulative duplicate counts must not wrap at i32 (a single hot
    code can own billions of rows at config-5 scale)."""
    from deltapq_tpu.ops.fused import DedupCompressedEngine

    rng = np.random.default_rng(0)
    cw = rng.normal(size=(4, 16, 8)).astype(np.float32)
    codes = rng.integers(0, 16, size=(600, 4)).astype(np.uint8)
    eng = DedupCompressedEngine(cw, codes)
    assert eng.counts.dtype == np.int64
    assert eng.order.dtype == np.int64
    # expand arithmetic at synthetic near-boundary counts: the csum
    # path must carry i64
    eng2 = DedupCompressedEngine.__new__(DedupCompressedEngine)
    eng2.counts = np.array([2 ** 31, 5], np.int64)
    eng2.starts = np.array([0, 2 ** 31], np.int64)
    eng2.order = np.arange(2, dtype=np.int64)
    d_u = np.array([[0.5, 1.5]], np.float32)
    i_u = np.array([[0, 1]], np.int64)
    d, ids = eng2.expand(d_u, i_u, top_k=3)
    assert d.shape == (1, 3) and (d == 0.5).all()


def test_config5_capacity_math():
    """BASELINE config 5 (SIFT1B-shape: N=1.5e9 rows, ~2 diffs/row,
    M=8) fits the chunked engine's per-chunk bounds with wide margin.
    ARCHITECTURE.md cites this audit."""
    from deltapq_tpu.bigscale import ChunkedCompressedEngine
    from deltapq_tpu.ops.stream_tiles import MAX_STREAM_VALUES

    N, diffs_per_row, M = 1_500_000_000, 2.0, 8
    chunk_rows = ChunkedCompressedEngine.CHUNK_ROWS       # 16M
    n_chunks = -(-N // chunk_rows)
    # per-chunk packed values (diffs + full first rows + 8-align pad)
    vals_per_chunk = int(chunk_rows * (diffs_per_row + 1)
                         + (chunk_rows // 1024) * (M + 8))
    assert vals_per_chunk < MAX_STREAM_VALUES // 30
    # per-chunk device decode: i32 stream positions of every
    # (row, subspace) stay addressable with i32 element offsets
    assert chunk_rows * M < 2 ** 31
    # per-chunk row ids stay under the i32 id-map cap; the global id
    # space is carried i64 by the chunk save format and merge
    assert N - 1 < 2 ** 31 or n_chunks > 1   # sharded by construction
    assert chunk_rows - 1 < 2 ** 31
    # cross-chunk merge concatenates n_chunks * top_k i64 candidates
    assert n_chunks * 100 < 2 ** 31


def test_config5_mesh_rehearsal_mmap_sharded(clustered, tmp_path):
    """Config-5 topology at small N on the virtual mesh: disk-backed
    (mmap) chunked tiles reopened sharded over all devices; results
    must equal the plain scan."""
    import jax
    from jax.sharding import Mesh

    from deltapq_tpu.bigscale import ChunkedCompressedEngine

    cw, codes = clustered
    order = np.lexsort(codes.T[::-1])
    eng = ChunkedCompressedEngine(cw, codes[order], row_to_db=order,
                                  chunk_rows=1024, resident=False)
    p = str(tmp_path / "c5")
    eng.save(p)
    devs = np.array(jax.devices())
    mesh = Mesh(devs, ("shard",))
    eng2 = ChunkedCompressedEngine.from_saved(p, mmap=True, mesh=mesh)
    assert len(eng2.chunks) >= 2
    rng = np.random.default_rng(5)
    q = rng.normal(size=(8, cw.shape[0] * cw.shape[2])
                   ).astype(np.float32)
    d, ids = eng2.query(q, top_k=5)
    d_ref, _ = query_plain(cw, q, codes, top_k=5)
    np.testing.assert_allclose(d, d_ref, rtol=1e-4, atol=1e-4)
