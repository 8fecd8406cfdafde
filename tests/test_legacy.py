"""Legacy bit-interleaved store + prefix-tree query (non-PLAIN_PQ
reference path, pq_tree.cpp:552-979)."""

import numpy as np
import pytest

from deltapq_tpu.legacy import (BitVecsStore, deinterleave_codes,
                                dichotomize_codewords, interleave_codes,
                                prefix_tree_query)


def test_interleave_roundtrip():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, size=(500, 8)).astype(np.uint8)
    w = interleave_codes(codes)
    np.testing.assert_array_equal(deinterleave_codes(w, 8), codes)


def test_bitvecs_io_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 256, size=(300, 8)).astype(np.uint8)
    store = BitVecsStore(codes)
    assert (np.diff(store.words.astype(np.int64)) >= 0).all()  # sorted
    p = str(tmp_path / "bv.bin")
    store.write(p)
    back = BitVecsStore.read(p, M=8)
    np.testing.assert_array_equal(back.words, store.words)


def test_dichotomize_preserves_codeword_set(small_dataset):
    import jax

    from deltapq_tpu.ops.kmeans import pq_learn

    cw = pq_learn(jax.random.key(0), small_dataset, 4, 16,
                  max_iters=10)
    cw2 = dichotomize_codewords(cw, max_iters=10)
    assert cw2.shape == cw.shape
    for m in range(cw.shape[0]):
        a = np.sort(cw[m].round(4).view([("", cw.dtype)] * cw.shape[2]),
                    axis=0)
        b = np.sort(cw2[m].round(4).view([("", cw.dtype)] * cw.shape[2]),
                    axis=0)
        np.testing.assert_array_equal(a, b)  # a permutation


def test_prefix_query_matches_plain_top1(small_dataset):
    import jax

    from deltapq_tpu.ops.adc import query_plain
    from deltapq_tpu.ops.encode import pq_encode
    from deltapq_tpu.ops.kmeans import pq_learn

    x = small_dataset[:800]
    cw = pq_learn(jax.random.key(0), x, 8, 256, max_iters=15)
    cw = dichotomize_codewords(cw, max_iters=10)
    codes = np.asarray(pq_encode(cw, x))
    store = BitVecsStore(codes)
    queries = x[:20] + 0.02
    d_ref, i_ref = query_plain(cw, queries, codes, top_k=1)
    for b in range(len(queries)):
        rid, dist, stats = prefix_tree_query(store, cw, queries[b],
                                             codes_db=codes)
        assert abs(dist - float(d_ref[b, 0])) < 1e-3
