import numpy as np
import pytest

import jax

from deltapq_tpu.ops import pq_learn, pq_encode
from deltapq_tpu.tree import (find_edges_by_diff, nchoosek, pack_keys,
                              build_layout, mkk_tables, DeltaTree,
                              serialize_dtc, decode_dtc_to_codes,
                              serialize_diff_index, decode_diff_index,
                              write_dtc, read_dtc_raw)


@pytest.fixture(scope="module")
def clustered_codes():
    rng = np.random.default_rng(7)
    n, M, K = 1500, 8, 16
    # base patterns with few distinct values per column -> many shared codes
    base = rng.integers(0, K, size=(40, M))
    rows = base[rng.integers(0, 40, n)]
    # sprinkle random mutations
    mut = rng.random((n, M)) < 0.08
    rows = np.where(mut, rng.integers(0, K, size=(n, M)), rows)
    return rows.astype(np.uint8), M, K


@pytest.fixture(scope="module")
def tree_and_codes(clustered_codes):
    codes, M, K = clustered_codes
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(M, K, 4)).astype(np.float32)
    res = find_edges_by_diff(codes, K=K, max_height_folds=1, method=1)
    tree = build_layout(codes, res.edges, res.root_id, K=K, codewords=cw)
    return codes, tree, res, cw


def test_nchoosek_order_matches_reference():
    # reference nchoosek(4, 2) via prev_permutation == lexicographic
    assert nchoosek(4, 2) == [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def test_pack_keys_u64_grouping():
    codes = np.array([[1, 2, 3], [1, 5, 3], [1, 2, 3]], np.uint8)
    k = pack_keys(codes, (0, 1), 8)
    assert k[0] == k[2] and k[0] != k[1]
    k2 = pack_keys(codes, (0, 2), 8)
    assert k2[0] == k2[1] == k2[2]  # dims 0 and 2 agree on all rows


def test_pack_keys_u128():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, size=(50, 16)).astype(np.uint8)
    k = pack_keys(codes, tuple(range(16)), 8)
    assert k.shape == (50, 2)
    # uniqueness matches row uniqueness
    _, inv1 = np.unique(codes, axis=0, return_inverse=True)
    _, inv2 = np.unique(k, axis=0, return_inverse=True)
    a = inv1[:, None] == inv1[None, :]
    b = inv2[:, None] == inv2[None, :]
    np.testing.assert_array_equal(a, b)


def test_edges_form_spanning_tree(clustered_codes):
    codes, M, K = clustered_codes
    res = find_edges_by_diff(codes, K=K)
    n = len(codes)
    assert len(res.edges) == n - 1
    # every node except root appears exactly once as child
    children = res.edges[:, 1]
    assert len(np.unique(children)) == n - 1
    assert res.root_id not in children
    # no self loops
    assert np.all(res.edges[:, 0] != res.edges[:, 1])


def test_edges_method2(clustered_codes):
    codes, M, K = clustered_codes
    res = find_edges_by_diff(codes, K=K, method=2)
    assert len(res.edges) == len(codes) - 1


def test_duplicate_codes_get_zero_diff_edges():
    codes = np.tile(np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.uint8), (10, 1))
    res = find_edges_by_diff(codes, K=16)
    assert len(res.edges) == 9
    assert res.n_diffs == 0


def test_layout_dfs_invariants(tree_and_codes):
    codes, tree, res, cw = tree_and_codes
    n = tree.n
    assert tree.parent_pos[0] == -1
    assert tree.depth[0] == 0
    # parents precede children in DFS order and depth increments by 1
    for i in range(1, n):
        p = tree.parent_pos[i]
        assert 0 <= p < i
        assert tree.depth[i] == tree.depth[p] + 1
    # vec_id is a permutation
    assert len(np.unique(tree.vec_id)) == n
    # root diffs: M pseudo-diffs carrying the root code
    assert tree.diff_num[0] == tree.M
    np.testing.assert_array_equal(tree.diff_to[:tree.M],
                                  codes[tree.root_id])


def test_layout_child_num_is_descendant_count(tree_and_codes):
    _, tree, _, _ = tree_and_codes
    # child_num == number of DFS descendants (reference :1182)
    n = tree.n
    desc = np.zeros(n, np.int64)
    for i in range(n - 1, 0, -1):
        desc[tree.parent_pos[i]] += desc[i] + 1
    np.testing.assert_array_equal(tree.child_num, desc)


def test_lossless_decode_codes(tree_and_codes):
    codes, tree, _, _ = tree_and_codes
    decoded = tree.decode_codes()
    np.testing.assert_array_equal(decoded, codes)


def test_dtc_serialization_roundtrip(tree_and_codes):
    codes, tree, res, _ = tree_and_codes
    stream = np.frombuffer(serialize_dtc(tree), np.uint8)
    # size formula (deltapq_create_approx_tree.h:1765) for M=8
    n = tree.n
    expect = 8 + res.n_diffs + (3 * (n - 1) + 1) // 2
    assert len(stream) == expect
    decoded_dfs = decode_dtc_to_codes(stream, n, tree.M)
    # decoded rows are in DFS order; map back via vec_id
    back = np.empty_like(codes)
    back[tree.vec_id.astype(np.int64)] = decoded_dfs
    np.testing.assert_array_equal(back, codes)


def test_dtc_file_roundtrip(tmp_path, tree_and_codes):
    codes, tree, _, _ = tree_and_codes
    p = str(tmp_path / "dtc.bin")
    write_dtc(p, tree)
    n_codes, stream = read_dtc_raw(p)
    assert n_codes == tree.n
    decoded = decode_dtc_to_codes(stream, n_codes, tree.M)
    back = np.empty_like(codes)
    back[tree.vec_id.astype(np.int64)] = decoded
    np.testing.assert_array_equal(back, codes)


def test_diff_index_roundtrip(clustered_codes):
    codes, M, K = clustered_codes
    stream = np.frombuffer(serialize_diff_index(codes), np.uint8)
    back = decode_diff_index(stream, len(codes), M, K)
    np.testing.assert_array_equal(back, codes)


def test_diff_index_roundtrip_u16():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1024, size=(200, 4)).astype(np.uint16)
    stream = np.frombuffer(serialize_diff_index(codes), np.uint8)
    back = decode_diff_index(stream, 200, 4, K=1024)
    np.testing.assert_array_equal(back, codes)


def test_height_constraint_bounds_depth(clustered_codes):
    codes, M, K = clustered_codes
    res = find_edges_by_diff(codes, K=K, max_height_folds=1, method=1)
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(M, K, 4)).astype(np.float32)
    tree = build_layout(codes, res.edges, res.root_id, K=K, codewords=cw)
    # MAX_HEIGHT = M*h = 8; finalists chain adds 1, root adds 1
    assert int(tree.depth.max()) <= M * 1 + 2


def test_end_to_end_tree_from_learned_codes(small_dataset):
    cw = pq_learn(jax.random.PRNGKey(0), small_dataset, M=4, K=16,
                  max_iters=20)
    codes = pq_encode(cw, small_dataset)
    res = find_edges_by_diff(codes, K=16)
    tree = build_layout(codes, res.edges, res.root_id, K=16, codewords=cw)
    np.testing.assert_array_equal(tree.decode_codes(), codes)
    stream = np.frombuffer(serialize_dtc(tree), np.uint8)
    decoded = decode_dtc_to_codes(stream, tree.n, tree.M)
    back = np.empty_like(codes)
    back[tree.vec_id.astype(np.int64)] = decoded
    np.testing.assert_array_equal(back, codes)
    # compression actually helps on clustered data
    assert len(stream) < codes.size


def test_exact_mst_spanning_and_lossless(clustered_codes):
    from deltapq_tpu.tree.exact_mst import find_edges_exact_mst
    codes, M, K = clustered_codes
    res = find_edges_exact_mst(codes, K=K)
    n = len(codes)
    assert len(res.edges) == n - 1
    children = res.edges[:, 1]
    assert len(np.unique(children)) == n - 1
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(M, K, 4)).astype(np.float32)
    tree = build_layout(codes, res.edges, res.root_id, K=K, codewords=cw)
    np.testing.assert_array_equal(tree.decode_codes(), codes)


def test_exact_mst_fewer_or_equal_diffs_than_approx(clustered_codes):
    from deltapq_tpu.tree.exact_mst import find_edges_exact_mst
    codes, M, K = clustered_codes
    approx = find_edges_by_diff(codes, K=K)
    exact = find_edges_exact_mst(codes, K=K)
    # the exact variant links nodes at their minimal diff round, so its
    # total diff count can't exceed the star-forest's by much; sanity:
    assert exact.n_diffs <= approx.n_diffs * 1.5 + 8


def test_block_aware_size(clustered_codes):
    from deltapq_tpu.tree.serialize import block_aware_size
    codes, M, K = clustered_codes
    res = find_edges_by_diff(codes, K=K)
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(M, K, 4)).astype(np.float32)
    tree = build_layout(codes, res.edges, res.root_id, K=K, codewords=cw)
    out = block_aware_size(tree)
    assert out["blocks"] >= 1
    assert out["bytes"] >= len(serialize_dtc(tree)) - 4096


def test_reroot_min_height_reduces_chain():
    from deltapq_tpu.tree.reroot import reroot_min_height, tree_height
    # a path of 101 nodes rooted at an end has height 100; center -> 50
    n = 101
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    oriented, root, h = reroot_min_height(edges, n)
    assert root == 50 and h == 50
    assert len(oriented) == n - 1
    assert tree_height(oriented, root, n) == 50
    # orientation: every node except root appears once as child
    assert len(np.unique(oriented[:, 1])) == n - 1
    assert root not in oriented[:, 1]


def test_reroot_on_mst_tree(clustered_codes):
    from deltapq_tpu.tree.exact_mst import find_edges_exact_mst
    from deltapq_tpu.tree.reroot import reroot_min_height, tree_height
    codes, M, K = clustered_codes
    res = find_edges_exact_mst(codes, K=K)
    n = len(codes)
    h_before = tree_height(res.edges, res.root_id, n)
    oriented, root, h_after = reroot_min_height(res.edges, n)
    assert h_after <= h_before
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(M, K, 4)).astype(np.float32)
    tree = build_layout(codes, oriented, root, K=K, codewords=cw)
    np.testing.assert_array_equal(tree.decode_codes(), codes)


def test_with_id_tree_roundtrip(clustered_codes):
    from deltapq_tpu.tree.with_id import (build_tree_with_id,
                                          split_id_bytes,
                                          extend_table_for_id)
    codes, M, K = clustered_codes
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(M, K, 4)).astype(np.float32)
    tree = build_tree_with_id(codes, K=K, codewords=cw)
    # lossless: decoded extended codes reproduce codes AND embedded ids
    ext = tree.decode_codes()
    back_codes, back_ids = split_id_bytes(ext)
    np.testing.assert_array_equal(back_codes, codes)
    np.testing.assert_array_equal(back_ids, np.arange(len(codes)))


def test_with_id_query_distances_unchanged(clustered_codes):
    from deltapq_tpu.tree.with_id import (build_tree_with_id,
                                          extend_table_for_id)
    from deltapq_tpu.ops.delta import (build_delta_pack,
                                       make_compressed_query_fn)
    from deltapq_tpu.ops import adc_table
    import jax.numpy as jnp
    codes, M, K = clustered_codes
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(M, K, 4)).astype(np.float32)
    tree = build_tree_with_id(codes, K=K, codewords=cw)
    pack = build_delta_pack(tree)
    q = rng.normal(size=(3, M * 4)).astype(np.float32)
    table = np.asarray(adc_table(cw, q))
    run = make_compressed_query_fn(pack)
    dists = np.asarray(run(jnp.asarray(extend_table_for_id(table))))
    # plain ADC reference over the real M subspaces
    full = np.zeros((3, len(codes)), np.float32)
    for m in range(M):
        full += table[:, m, :][:, codes[:, m]]
    # pack's db order = embedded id order = original order
    np.testing.assert_allclose(dists, full, rtol=2e-4, atol=1e-3)


def test_bit_format_roundtrip(tree_and_codes):
    from deltapq_tpu.tree.serialize import serialize_bits, deserialize_bits
    codes, tree, res, _ = tree_and_codes
    stream, n_bits = serialize_bits(tree)
    # reference size formula: 8*n_diffs + 11*N + 64 (root code, M=8)
    assert n_bits == 8 * res.n_diffs + 11 * tree.n + 64
    decoded = deserialize_bits(stream, n_bits, tree.n, tree.M)
    back = np.empty_like(codes)
    back[tree.vec_id.astype(np.int64)] = decoded
    np.testing.assert_array_equal(back, codes)


def test_row_store_roundtrip(tree_and_codes):
    from deltapq_tpu.tree.serialize import (serialize_dtc_row_store,
                                            serialize_dtc)
    codes, tree, _, _ = tree_and_codes
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, size=(tree.n, 12)).astype(np.uint8)
    rs = serialize_dtc_row_store(tree, raw)
    assert len(rs) == len(serialize_dtc(tree)) + tree.n * 12


def test_chain_data_compression_near_optimal():
    """The reference's -synth chain (each code differs from its
    predecessor in exactly one subspace) is DeltaPQ's designed best
    case: the tree must achieve ~1 diff/node and ~2.5 B/vec."""
    from deltapq_tpu.synth import chain_codes
    codes = chain_codes(4000, M=8, K=256, seed=1)
    res = find_edges_by_diff(codes, K=256)
    assert res.n_diffs / len(codes) < 2.0, res.n_diffs
    rng = np.random.default_rng(0)
    cw = rng.normal(size=(8, 256, 2)).astype(np.float32)
    tree = build_layout(codes, res.edges, res.root_id, K=256,
                        codewords=cw)
    stream = serialize_dtc(tree)
    bytes_per_vec = len(stream) / len(codes)
    assert bytes_per_vec < 3.6, bytes_per_vec  # vs 8 plain
    np.testing.assert_array_equal(tree.decode_codes(), codes)


def test_serialize_repairs_deep_tree():
    """depth > 15 (reachable with -h 2) must auto-repair inside
    serialize_dtc (center reroot + chain halving, pqbase.cpp:72-286
    semantics) and still round-trip losslessly."""
    from deltapq_tpu.tree.layout import build_layout
    from deltapq_tpu.tree.serialize import (serialize_dtc,
                                            decode_dtc_to_codes)

    rng = np.random.default_rng(5)
    n, M = 64, 8
    # a pure path tree: node i diffs from i-1 in one subspace
    codes = np.empty((n, M), np.uint8)
    codes[0] = rng.integers(0, 256, size=M)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        codes[i, rng.integers(0, M)] = rng.integers(0, 256)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    tables = np.zeros((M, 256, 256), np.float32)
    tree = build_layout(codes, edges, 0, K=256, tables=tables)
    assert int(tree.depth.max()) == n - 1  # deep path
    stream = serialize_dtc(tree)  # repairs in place
    assert int(tree.depth.max()) <= 15
    decoded = decode_dtc_to_codes(np.frombuffer(stream, np.uint8),
                                  n, M)
    # stream reproduces the tree's DFS-ordered codes; map back to ids
    np.testing.assert_array_equal(
        decoded[np.argsort(tree.vec_id.astype(np.int64))], codes)


def test_rotate_tree_reduces_height():
    from deltapq_tpu.tree.reroot import rotate_tree, tree_height

    n = 33
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    oriented, root, h = rotate_tree(edges, 0, n)
    assert h <= tree_height(edges, 0, n)
    assert len(oriented) == n - 1


def test_ta_edge_finding_method3(small_dataset):
    """Method 3 (TA minimum-weight attachment) must yield a valid
    spanning tree with total table-distance weight <= method 1's."""
    import jax

    from deltapq_tpu.ops.encode import pq_encode
    from deltapq_tpu.ops.kmeans import pq_learn
    from deltapq_tpu.tree.build import find_edges_by_diff
    from deltapq_tpu.tree.layout import mkk_tables, table_code_dists

    cw = pq_learn(jax.random.key(0), small_dataset, 4, 16,
                  max_iters=10)
    codes = pq_encode(cw, small_dataset)
    tables = mkk_tables(cw)

    def weight(res):
        return float(table_code_dists(
            tables, np.asarray(codes),
            res.edges[:, 0].astype(np.int64),
            res.edges[:, 1].astype(np.int64)).sum())

    r1 = find_edges_by_diff(np.asarray(codes), K=16, method=1)
    r3 = find_edges_by_diff(np.asarray(codes), K=16, method=3,
                            tables=tables)
    n = len(codes)
    assert len(r3.edges) == n - 1
    # spanning + acyclic
    parents = np.full(n, -1, np.int64)
    parents[r3.edges[:, 1].astype(np.int64)] = r3.edges[:, 0]
    assert (parents < 0).sum() == 1
    anc = parents.copy()
    for _ in range(64):
        if not (anc >= 0).any():
            break
        anc = np.where(anc >= 0, parents[np.maximum(anc, 0)], -1)
    assert not (anc >= 0).any(), "tree deeper than 64 => cycle"
    assert weight(r3) <= weight(r1) * 1.02


def test_row_store_and_bits_query_paths(small_dataset):
    """Query entry points over the row-store and bit-format streams:
    decode is lossless so distances match the plain scan; row-store
    also returns the winners' co-located raw bytes."""
    import jax

    from deltapq_tpu.ops.adc import query_plain
    from deltapq_tpu.ops.encode import pq_encode
    from deltapq_tpu.ops.kmeans import pq_learn
    from deltapq_tpu.tree.build import find_edges_by_diff
    from deltapq_tpu.tree.layout import build_layout
    from deltapq_tpu.tree.serialize import (query_bits, query_row_store,
                                            serialize_bits,
                                            serialize_dtc_row_store)

    x = small_dataset[:500]
    cw = pq_learn(jax.random.key(0), x, 4, 16, max_iters=10)
    codes = np.asarray(pq_encode(cw, x))
    res = find_edges_by_diff(codes, K=16)
    tree = build_layout(codes, res.edges, res.root_id, K=16,
                        codewords=cw)
    queries = x[:16] + 0.03
    d_ref, i_ref = query_plain(cw, queries, codes, top_k=5)

    raw = np.clip(x * 8 + 128, 0, 255).astype(np.uint8)
    rs = serialize_dtc_row_store(tree, raw)
    d, ids, raw_rows = query_row_store(
        rs, tree.n, tree.M, raw.shape[1], cw, queries, tree.vec_id,
        top_k=5)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(raw_rows[:, 0], raw[ids[:, 0]])

    bs, n_bits = serialize_bits(tree)
    db, ib = query_bits(bs, n_bits, tree.n, tree.M, cw, queries,
                        tree.vec_id, top_k=5)
    np.testing.assert_allclose(db, d_ref, rtol=1e-5, atol=1e-4)
