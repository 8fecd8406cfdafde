"""Wave-coalescing serving layer (``deltapq_tpu/serving.py``)."""

import numpy as np
import pytest

from deltapq_tpu.ops.fused import FusedCodesEngine
from deltapq_tpu.ops.encode import pq_encode
from deltapq_tpu.ops.kmeans import pq_learn
from deltapq_tpu.serving import CoalescingServer, query_coalesced


@pytest.fixture(scope="module")
def small_engine():
    import jax

    rng = np.random.default_rng(3)
    n, d = 4096, 32
    centers = rng.normal(size=(64, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 64, size=n)]
         + rng.normal(size=(n, d)).astype(np.float32) * 0.2)
    cw = pq_learn(jax.random.PRNGKey(0), x, M=4, K=16, max_iters=15)
    codes = np.asarray(pq_encode(cw, x))
    eng = FusedCodesEngine(np.asarray(cw), codes)
    qs = rng.normal(size=(48, d)).astype(np.float32) * 2
    return eng, qs


def test_query_coalesced_matches_individual(small_engine):
    eng, qs = small_engine
    batches = [qs[:7], qs[7:20], qs[20:21], qs[21:48]]
    got = query_coalesced(eng, batches, top_k=5, wave_rows=24)
    assert len(got) == len(batches)
    for b, (d, ids) in zip(batches, got):
        dr, idr = eng.query(b, top_k=5)
        np.testing.assert_allclose(d, dr, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(ids, idr)


def test_server_coalesces_and_matches(small_engine):
    eng, qs = small_engine

    class Counting:
        def __init__(self, e):
            self.e, self.calls, self.sizes = e, 0, []

        def query(self, q, top_k):
            self.calls += 1
            self.sizes.append(len(q))
            return self.e.query(q, top_k=top_k)

    ce = Counting(eng)
    # max_wait far above any CI scheduling stall: the <=2-dispatch
    # assertion must not depend on the submit loop outrunning the
    # partial-wave timeout (ADVICE r3)
    with CoalescingServer(ce, wave_rows=32, max_wait_ms=5000,
                          top_k=5) as srv:
        futs = [srv.submit(qs[i:i + 8]) for i in range(0, 48, 8)]
        outs = [f.result(timeout=30) for f in futs]
    # 6 waves of 8 rows -> at most 2 dispatches of <= 32 rows
    assert ce.calls <= 2 and srv.rows_served == 48
    assert all(s <= 32 for s in ce.sizes)
    for i, (d, ids) in enumerate(outs):
        dr, idr = eng.query(qs[8 * i:8 * i + 8], top_k=5)
        np.testing.assert_allclose(d, dr, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(ids, idr)


def test_server_partial_wave_flushes_on_timeout(small_engine):
    eng, qs = small_engine
    with CoalescingServer(eng, wave_rows=4096, max_wait_ms=20,
                          top_k=3) as srv:
        d, ids = srv.submit(qs[:5]).result(timeout=30)
    dr, idr = eng.query(qs[:5], top_k=3)
    np.testing.assert_array_equal(ids, idr)
    assert srv.dispatches == 1


def test_server_never_splits_a_submitted_wave(small_engine):
    eng, qs = small_engine

    class Sizes:
        def __init__(self, e):
            self.e, self.sizes = e, []

        def query(self, q, top_k):
            self.sizes.append(len(q))
            return self.e.query(q, top_k=top_k)

    se = Sizes(eng)
    with CoalescingServer(se, wave_rows=16, max_wait_ms=50,
                          top_k=3) as srv:
        futs = [srv.submit(qs[:12]), srv.submit(qs[12:24]),
                srv.submit(qs[24:36])]
        [f.result(timeout=30) for f in futs]
    # 12-row waves into 16-row dispatches: each dispatch is exactly one
    # wave (12 + 12 > 16 would split otherwise)
    assert all(s == 12 for s in se.sizes)


def test_server_survives_cancelled_future(small_engine):
    """A cancelled PENDING future must not kill the dispatcher thread
    (ADVICE r3: set_result on it raises InvalidStateError)."""
    eng, qs = small_engine
    with CoalescingServer(eng, wave_rows=4096, max_wait_ms=100,
                          top_k=3) as srv:
        f1 = srv.submit(qs[:4])
        assert f1.cancel()           # still PENDING: cancel succeeds
        f2 = srv.submit(qs[4:12])    # must still resolve
        d, ids = f2.result(timeout=30)
    dr, idr = eng.query(qs[4:12], top_k=3)
    np.testing.assert_array_equal(ids, idr)


def test_server_empty_submit_resolves_immediately(small_engine):
    eng, qs = small_engine
    with CoalescingServer(eng, wave_rows=8, top_k=3) as srv:
        d, ids = srv.submit(qs[:0]).result(timeout=5)
        assert d.shape == (0, 3) and ids.shape == (0, 3)
        d2, ids2 = srv.submit(qs[:8]).result(timeout=30)
    dr, idr = eng.query(qs[:8], top_k=3)
    np.testing.assert_array_equal(ids2, idr)


def test_server_blocking_query_and_close(small_engine):
    eng, qs = small_engine
    srv = CoalescingServer(eng, wave_rows=8, top_k=3)
    d, ids = srv.query(qs[:8])
    dr, idr = eng.query(qs[:8], top_k=3)
    np.testing.assert_array_equal(ids, idr)
    srv.close()
    with pytest.raises(RuntimeError):
        srv.submit(qs[:1])


def test_server_dedup_engine_under_concurrent_load():
    """VERDICT r4 #8: the dedup product tier behind the server — the
    host-side ``expand`` runs on the dispatcher thread; concurrent
    client waves must all resolve exactly (vs the plain scan) and the
    server must still coalesce (no per-wave dispatch)."""
    import threading

    import jax

    from deltapq_tpu.ops import query_plain
    from deltapq_tpu.ops.fused import DedupCompressedEngine

    rng = np.random.default_rng(9)
    M, K, Ds = 4, 16, 8
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    distinct = rng.integers(0, K, size=(64, M)).astype(np.uint8)
    codes = distinct[rng.integers(0, 64, size=3000)]
    eng = DedupCompressedEngine(cw, codes)
    qs = rng.normal(size=(64, M * Ds)).astype(np.float32)
    d_ref, _ = query_plain(cw, qs, codes, top_k=5)

    results = {}
    errs = []

    def client(i):
        try:
            f = srv.submit(qs[i * 8:(i + 1) * 8])
            results[i] = f.result(timeout=60)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    with CoalescingServer(eng, wave_rows=32, max_wait_ms=20,
                          top_k=5) as srv:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not errs
    assert len(results) == 8 and srv.rows_served == 64
    # expansion correctness: each returned id's decoded-code distance
    # must equal the reported distance (ids are real duplicate rows)
    dec = cw.reshape(M * K, Ds)[
        (codes.astype(np.int64) + np.arange(M) * K)].reshape(-1, M * Ds)
    for i in range(8):
        d, ids = results[i]
        np.testing.assert_allclose(d, d_ref[i * 8:(i + 1) * 8],
                                   rtol=1e-5, atol=1e-4)
        qb = qs[i * 8:(i + 1) * 8]
        d_ids = ((qb[:, None, :] - dec[ids]) ** 2).sum(axis=2)
        np.testing.assert_allclose(d_ids, d, rtol=1e-4, atol=1e-3)
    # coalescing happened: 8 waves of 8 rows in <= 4 dispatches
    assert srv.dispatches <= 4
