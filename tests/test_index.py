import numpy as np
import pytest

from deltapq_tpu.index import DeltaPQIndex


@pytest.fixture(scope="module")
def built(small_dataset):
    return DeltaPQIndex.build(small_dataset[:1000], small_dataset,
                              M=4, K=16, max_iters=15)


def test_build_and_search(built, small_dataset):
    d, i = built.search(small_dataset[:8], top_k=5)
    # self-query: own code must rank first
    for b in range(8):
        np.testing.assert_array_equal(built.codes[i[b, 0]],
                                      built.codes[b])
    st = built.stats()
    assert st["n"] == len(small_dataset)
    assert st["compressed_bytes"] < st["plain_bytes"]


def test_add_and_search(built, small_dataset, rng):
    idx = DeltaPQIndex(built.codewords, built.codes.copy())
    new = small_dataset[:3] + 0.01
    ids = idx.add(new)
    assert list(ids) == [2000, 2001, 2002]
    d, i = idx.search(new, top_k=2)
    # the new rows must be findable (same code as their near-duplicates
    # or themselves)
    all_codes = idx._all_codes()
    for b in range(3):
        np.testing.assert_array_equal(all_codes[i[b, 0]],
                                      all_codes[2000 + b])


def test_remove_masks_results(built, small_dataset):
    idx = DeltaPQIndex(built.codewords, built.codes.copy())
    q = small_dataset[:4]
    d0, i0 = idx.search(q, top_k=3)
    idx.remove(i0[:, 0])
    d1, i1 = idx.search(q, top_k=3)
    for b in range(4):
        assert i0[b, 0] not in i1[b]


def test_rebuild_threshold_compacts(built, small_dataset):
    idx = DeltaPQIndex(built.codewords, built.codes.copy(),
                       rebuild_fraction=0.01)
    idx.add(small_dataset[:50])  # 50 > 1% of 2000 -> compacts
    assert len(idx.tail) == 0
    assert len(idx.codes) == 2050
    assert idx.tree is not None and idx.tree.n == 2050


def test_compact_drops_deleted(built, small_dataset):
    idx = DeltaPQIndex(built.codewords, built.codes.copy())
    idx.remove([0, 1, 2])
    idx.compact()
    assert len(idx.codes) == 1997
    assert not idx.deleted.any()


def test_save_load_roundtrip(tmp_path, built, small_dataset):
    p = str(tmp_path / "idx")
    built.save(p)
    idx2 = DeltaPQIndex.load(p)
    q = small_dataset[:5]
    d1, i1 = built.search(q, top_k=5)
    d2, i2 = idx2.search(q, top_k=5)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    np.testing.assert_array_equal(i1, i2)


def test_search_topk_exceeds_n(built):
    """top_k > n must pad with (+inf, -1) instead of failing
    (VERDICT round-1 weak #6)."""
    idx = DeltaPQIndex(built.codewords, built.codes[:7].copy(),
                       build_tree=False)
    d, i = idx.search(np.random.default_rng(0).normal(
        size=(3, built.codewords.shape[0] * built.codewords.shape[2])
    ).astype(np.float32), top_k=12)
    assert d.shape == (3, 12) and i.shape == (3, 12)
    assert np.isinf(d[:, 7:]).all() and (i[:, 7:] == -1).all()
    assert (i[:, :7] >= 0).all()


def test_search_mass_delete(built, small_dataset):
    """Deleting nearly everything must yield -1/inf padding, never a
    deleted id."""
    idx = DeltaPQIndex(built.codewords, built.codes.copy(),
                       build_tree=False)
    keep = [5, 123]
    dele = [j for j in range(idx.n) if j not in keep]
    idx.remove(dele)
    d, i = idx.search(small_dataset[:4], top_k=10)
    live = np.isfinite(d)
    assert set(i[live].ravel()) <= set(keep)
    assert (i[~live] == -1).all()


def test_search_fused_engines(built, small_dataset):
    """The fused round-2 tiers must be reachable through the facade and
    agree with the plain path."""
    d_ref, i_ref = built.search(small_dataset[:8], top_k=5)
    for engine in ("fused_codes", "fused_compressed"):
        idx = DeltaPQIndex(built.codewords, built.codes.copy(),
                           engine=engine)
        d, i = idx.search(small_dataset[:8], top_k=5)
        np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


def test_fused_search_with_deletes(built, small_dataset):
    """Fused path must over-fetch so deletes cannot truncate results
    (round-2 review finding)."""
    idx = DeltaPQIndex(built.codewords, built.codes.copy(),
                       engine="fused_codes")
    q = small_dataset[:4]
    d0, i0 = idx.search(q, top_k=10)
    # delete every current top-5 of query 0
    idx.remove(i0[0, :5][i0[0, :5] >= 0])
    d, i = idx.search(q, top_k=10)
    live = np.isfinite(d[0])
    assert live.sum() == 10  # plenty of live rows remain
    assert not np.isin(i0[0, :5], i[0]).any()


def test_index_m16_compressed(rng):
    """GIST-shape (M=16) index: the DeltaTree builds (DFS order feeds
    the fused compressed tier) but no DTC stream exists (the reference
    byte format caps at M=8); search stays exact."""
    from deltapq_tpu.ops.adc import query_plain

    M, K, Ds, n = 16, 16, 4, 600
    x = rng.normal(size=(n, M * Ds)).astype(np.float32)
    idx = DeltaPQIndex.build(x, x, M=M, K=K, max_iters=10,
                             engine="fused_compressed")
    assert idx.tree is not None and idx._stream is None
    q = x[:8] + 0.01
    d, i = idx.search(q, top_k=5)
    d_ref, _ = query_plain(idx.codewords, q, idx.codes, top_k=5)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)
    st = idx.stats()
    assert "bytes_per_vec" not in st
    assert st["delta_tile_bytes_per_vec"] > 0


def test_index_fused_dedup_engine(small_dataset):
    from deltapq_tpu.index import DeltaPQIndex
    from deltapq_tpu.ops import query_plain

    idx = DeltaPQIndex.build(small_dataset[:1000], small_dataset,
                             M=4, K=16, engine="fused_dedup")
    q = small_dataset[:8] + 0.01
    d, i = idx.search(q, top_k=5)
    d_ref, _ = query_plain(idx.codewords, q, idx._all_codes(),
                           top_k=5)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)
