"""Decoded-cache engine (``cli -engine decoded``): parity with the plain
scan and a save/load roundtrip."""

import numpy as np
import pytest


def test_decoded_engine_matches_plain(rng=None):
    import numpy as np
    from deltapq_tpu.ops.decoded import DecodedEngine
    from deltapq_tpu.ops import query_plain

    rng = np.random.default_rng(21)
    M, K, Ds, N, B = 4, 16, 8, 3000, 6
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32)
    eng = DecodedEngine(cw, codes)
    d_e, i_e = eng.query(q, top_k=10)
    d_p, i_p = query_plain(cw, q, codes, top_k=10)
    np.testing.assert_allclose(d_e, d_p, rtol=1e-5, atol=1e-5)
    for b in range(B):
        assert set(i_e[b]) == set(i_p[b]) or np.allclose(d_e[b], d_p[b],
                                                         rtol=1e-5)


def test_decoded_engine_save_load(tmp_path):
    import numpy as np
    from deltapq_tpu.ops.decoded import DecodedEngine

    rng = np.random.default_rng(5)
    M, K, Ds, N = 4, 16, 8, 500
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
    q = rng.normal(size=(3, M * Ds)).astype(np.float32)
    eng = DecodedEngine(cw, codes)
    p = str(tmp_path / "cache.npz")
    eng.save(p)
    eng2 = DecodedEngine.load(p)
    d1, i1 = eng.query(q, top_k=5)
    d2, i2 = eng2.query(q, top_k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_index_rejects_unknown_engine():
    from deltapq_tpu.index import DeltaPQIndex

    cw = np.zeros((2, 4, 2), np.float32)
    codes = np.zeros((8, 2), np.uint8)
    for engine in ("pallas", "fused", "decoded"):
        with pytest.raises(ValueError, match="unknown engine"):
            DeltaPQIndex(cw, codes, engine=engine, build_tree=False)
