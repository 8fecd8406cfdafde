"""Big-N pipeline pieces at toy scale (serial workers on CPU)."""

import numpy as np
import pytest

from deltapq_tpu.bigscale import (BigCompressedIndex, build_partitioned,
                                  encode_stream)


@pytest.fixture(scope="module")
def cw_codes(small_dataset, rng):
    import jax

    from deltapq_tpu.ops.encode import pq_encode
    from deltapq_tpu.ops.kmeans import pq_learn

    cw = pq_learn(jax.random.key(0), small_dataset, 8, 16,
                  max_iters=10)
    codes = np.asarray(pq_encode(cw, small_dataset))
    return cw, codes


def test_encode_stream_matches_batch(cw_codes, small_dataset):
    cw, codes = cw_codes
    chunks = [small_dataset[i:i + 700]
              for i in range(0, len(small_dataset), 700)]
    streamed = encode_stream(cw, iter(chunks))
    np.testing.assert_array_equal(streamed, codes)


def test_build_partitioned_permutation(cw_codes):
    cw, codes = cw_codes
    row_to_db, stats = build_partitioned(codes, n_parts=3, K=16,
                                         workers=1)
    assert sorted(row_to_db.tolist()) == list(range(len(codes)))
    assert stats.n_diffs > 0


def test_big_index_query_parity(cw_codes, small_dataset):
    cw, codes = cw_codes
    from deltapq_tpu.ops.adc import query_plain

    idx = BigCompressedIndex(cw, codes, n_parts=2, workers=1)
    q = small_dataset[:16] + 0.01
    d_ref, i_ref = query_plain(cw, q, codes, top_k=5)
    d, i = idx.query(q, top_k=5)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("resident", [True, False])
def test_chunked_engine_parity(cw_codes, small_dataset, resident):
    """Out-of-core chunked engine == plain scan (chunk merge exact)."""
    from deltapq_tpu.bigscale import ChunkedCompressedEngine
    from deltapq_tpu.ops.adc import query_plain

    cw, codes = cw_codes
    order = np.lexsort(codes.T[::-1])
    eng = ChunkedCompressedEngine(cw, codes[order], row_to_db=order,
                                  chunk_rows=1024,
                                  resident=resident)
    assert (len(eng.chunks) if resident else len(eng._host)) > 1
    q = small_dataset[:16] + 0.01
    d_ref, i_ref = query_plain(cw, q, codes, top_k=5)
    d, i = eng.query(q, top_k=5)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)
    assert eng.bytes_per_vec() < codes.shape[1] + 2
