"""Smoke test of the compressed-code search path on NVIDIA GPUs.

Drives the product's entry points once at full SIFT width (128-d, M=8,
K=256, top-10) with data generated from ``--seed``, and checks every
result against references written here (a NumPy float32 ADC scan) or
kept in the package (the plain XLA scan, exact groundtruth):

* ``index``   — ``DeltaPQIndex.build`` + ``search`` at the SIFT1M shape
  (1M base, 100K train, 10K queries in waves of 512; ~1.06x code
  duplication); ``auto`` must pick ``fused_compressed`` and its scan
  must be the compiled Triton kernel;
* ``dedup``   — the same at ~37x duplication (<= 64K distinct codes);
  ``auto`` must pick ``fused_dedup``.  Both phases also check the plain
  exact paths against NumPy sums of the same device tables: the gather
  scan bit-exact, the dedup tier's one-hot product within tolerance;
* ``serve``   — ``CoalescingServer`` over the ``index`` engine, 8
  client threads submitting waves of 1..700 rows;
* ``cli``     — learn -> encode -> groundtruth -> approx_tree ->
  query_compressed -> recall on a 100K-row fvecs dataset;
* ``chunked`` — ``BigCompressedIndex`` at 2^24 rows in 2^22-row chunks.

``--chips 4`` instead runs only the multi-card phase: the sharded,
dedup and chunked engines over a 4-device mesh at 2^24 rows, each
checked against the single-device NumPy reference.

Tolerances: reported distances are f32 sums of f32 ADC tables; the
engine accumulates each table entry sum_j (q_j - c_j)^2 in f32, the
reference computes it in float64 and rounds once, so entries differ by
a few f32 ulps and distances (~1e2-1e3 at SIFT magnitudes) agree to
rtol 1e-5 / atol 1e-3.  Ids must agree except among ties at the k-th
distance (equal codes, or equal sums, have equal distances and either
order is correct).

Every phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

RTOL, ATOL = 1e-5, 1e-3
M, K, D, TOP_K = 8, 256, 128, 10
N_INDEX, N_TRAIN, N_QUERY, WAVE = 1_000_000, 100_000, 10_000, 512
N_CLI = 100_000
N_BIG, CHUNK_ROWS = 1 << 24, 1 << 22
SERVE_CLIENTS, SERVE_WAVES, SERVE_MAX_ROWS = 8, 6, 700


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


class Report:
    def __init__(self, card_line):
        import jax

        self.card = card_line
        self.dev = jax.devices()[0]

    def emit(self, phase, t0, **kw):
        stats = self.dev.memory_stats() or {}
        line = {"phase": phase, "card": self.card,
                "device_kind": self.dev.device_kind,
                "seconds": round(time.perf_counter() - t0, 3),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                **kw}
        print(json.dumps(line), flush=True)


# ---------------------------------------------------------------- data

def vectors(n, recipe, seed):
    from deltapq_tpu.synth import WORKLOADS, workload_chunks

    return workload_chunks(n, dim=D, seed=seed, **WORKLOADS[recipe])


def dataset(n, recipe, seed, n_train=None, n_query=None):
    """(base [n, D], train, queries) of one recipe, same clusters."""
    n_train = N_TRAIN if n_train is None else n_train
    n_query = N_QUERY if n_query is None else n_query
    x = np.concatenate(list(vectors(n + n_train + n_query, recipe,
                                    seed)))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    return (x[perm[:n]], x[perm[n:n + n_train]],
            x[perm[n + n_train:]])


# ----------------------------------------------------------- reference

def np_tables(cw, q):
    """Exact ADC tables [B, M, K] (float64 direct form, cast to f32)."""
    Ds = cw.shape[2]
    diff = (q.astype(np.float64).reshape(len(q), M, 1, Ds)
            - cw.astype(np.float64)[None])
    return (diff * diff).sum(-1).astype(np.float32)


def np_adc_topk(cw, codes, q, k=TOP_K, block=16):
    """NumPy float32 ADC scan: table sums in ascending m, exact top-k."""
    return np_topk_from_tables(np_tables(cw, q), codes, k, block)


def np_topk_from_tables(tab, codes, k=TOP_K, block=16):
    """Exact top-k of float32 table sums [B, M, K] in ascending m."""
    out_d = np.empty((len(tab), k), np.float32)
    out_i = np.empty((len(tab), k), np.int64)
    cols = [codes[:, m].astype(np.intp) for m in range(M)]
    for lo in range(0, len(tab), block):
        t = tab[lo:lo + block]
        d = np.zeros((len(t), len(codes)), np.float32)
        for m in range(M):
            d += t[:, m, :][:, cols[m]]
        part = np.argpartition(d, k, axis=1)[:, :k]
        pd = np.take_along_axis(d, part, axis=1)
        o = np.argsort(pd, axis=1, kind="stable")
        out_d[lo:lo + block] = np.take_along_axis(pd, o, axis=1)
        out_i[lo:lo + block] = np.take_along_axis(part, o, axis=1)
    return out_d, out_i


def check_against(d, ids, d_ref, cw, codes, q, what):
    """Distances match the reference; ids differ only among ties at the
    k-th distance; every returned id's own distance is its reported
    one."""
    np.testing.assert_allclose(d, d_ref, rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: distances")
    tab = np_tables(cw, q)
    ids = np.asarray(ids, np.int64)
    assert (ids >= 0).all() and (ids < len(codes)).all(), what
    own = np.zeros(ids.shape, np.float32)
    for m in range(M):
        own += np.take_along_axis(tab[:, m, :],
                                  codes[ids, m].astype(np.intp), axis=1)
    np.testing.assert_allclose(own, d, rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: id distances")
    for b in range(len(q)):
        assert len(set(ids[b].tolist())) == ids.shape[1], what
    return True


def ids_agree_up_to_ties(d, ids, d_ref, ids_ref):
    """Per query: any id outside the other list sits at the k-th
    distance (a tie).  Returns the count of queries whose lists differ."""
    tol = ATOL + RTOL * np.abs(d_ref[:, -1])
    differ = 0
    for b in range(len(d)):
        a, r = set(ids[b].tolist()), set(ids_ref[b].tolist())
        if a == r:
            continue
        differ += 1
        kth = d_ref[b, -1]
        for j, i in enumerate(ids[b]):
            if i not in r:
                assert abs(d[b, j] - kth) <= tol[b], (b, i)
        for j, i in enumerate(ids_ref[b]):
            if i not in a:
                assert abs(d_ref[b, j] - kth) <= tol[b], (b, i)
    return differ


def scan_hlo_check(eng, batch):
    """The scan the engine runs lowers to the compiled Triton kernel:
    one Triton custom call and no interpreter loop."""
    import jax
    import jax.numpy as jnp

    from deltapq_tpu.ops import fused_pallas as fp
    from deltapq_tpu.platform import interpret

    assert not interpret()
    codes = eng._codes()
    q = jnp.zeros((eng.d_pad, batch), jnp.bfloat16)
    text = jax.jit(
        lambda *a: fp.scan_mins(*a, M=eng.M, K=eng.K, Ds=eng.Ds)
    ).lower(q, eng.cb, codes, jnp.int32(eng.n_valid)).as_text()
    n_triton = text.count("__gpu$xla.gpu.triton")
    assert n_triton == 1, n_triton
    assert "stablehlo.while" not in text
    return n_triton


def exact_paths_vs_numpy(cw, codes, q):
    """The plain-XLA exact paths against a NumPy float32 sum of the same
    device tables: the gather scan (``adc_query_topk``, the ladder's
    terminal rung) must be bit-exact; the one-hot 3-digit product
    (``exact_all_topk``, the dedup tier, for <= 64K codes) is reported
    (its tensor-core accumulation order may differ in the last bit)."""
    import jax.numpy as jnp

    from deltapq_tpu.ops.adc import adc_query_topk, adc_table, pad_codes
    from deltapq_tpu.ops.fused import exact_all_topk

    tab = adc_table(jnp.asarray(cw), jnp.asarray(q))
    d_np, _ = np_topk_from_tables(np.asarray(tab), codes)
    n = len(codes)
    tile = 16384
    d_g, _ = adc_query_topk(tab, jnp.asarray(pad_codes(codes, tile)),
                            jnp.int32(n), TOP_K, tile)
    out = {"plain_scan_bitexact": bool(np.array_equal(np.asarray(d_g),
                                                      d_np))}
    assert out["plain_scan_bitexact"]
    if n <= 65536:
        d_a, _ = exact_all_topk(tab, jnp.asarray(pad_codes(codes, 1024)),
                                jnp.int32(n), TOP_K)
        d_a = np.asarray(d_a)
        np.testing.assert_allclose(d_a, d_np, rtol=RTOL, atol=ATOL)
        out["exact_all_bitexact"] = bool(np.array_equal(d_a, d_np))
        out["exact_all_max_abs_diff"] = float(np.abs(d_a - d_np).max())
    return out


def waves(x, size):
    return [x[i:i + size] for i in range(0, len(x), size)]


def median_ms(ts):
    return round(float(np.median(ts)) * 1e3, 3)


# -------------------------------------------------------------- phases

def phase_index(rep, seed):
    from deltapq_tpu import DeltaPQIndex
    from deltapq_tpu.eval import exact_topk, recall_at_k
    from deltapq_tpu.ops import query_plain

    t0 = time.perf_counter()
    base, train, queries = dataset(N_INDEX, "sift_like", seed)
    t_build = time.perf_counter()
    idx = DeltaPQIndex.build(train, base, M=M, K=K, seed=seed)
    t_build = time.perf_counter() - t_build
    ts, d_all, i_all = [], [], []
    for w in waves(queries, WAVE):
        t = time.perf_counter()
        d, i = idx.search(w, top_k=TOP_K)
        ts.append(time.perf_counter() - t)
        d_all.append(d)
        i_all.append(i)
    d, ids = np.concatenate(d_all), np.concatenate(i_all)
    assert idx._engine_resolved == "fused_compressed", \
        idx._engine_resolved
    eng = idx._fused_engine
    n_triton = scan_hlo_check(eng, WAVE)
    codes = idx.codes
    cw = idx.codewords
    check_against(d[:256], ids[:256],
                  np_adc_topk(cw, codes, queries[:256])[0], cw, codes,
                  queries[:256], "index")
    _, gt = exact_topk(queries, base, top_k=TOP_K, tile_n=1 << 15)
    d_x, i_x = query_plain(cw, queries, codes, top_k=TOP_K)
    np.testing.assert_allclose(d, d_x, rtol=RTOL, atol=ATOL)
    exact = exact_paths_vs_numpy(cw, codes, queries[:256])
    differ = ids_agree_up_to_ties(d, ids, d_x, i_x)
    rec = recall_at_k(ids, np.asarray(gt), k=TOP_K)
    rec_x = recall_at_k(i_x, np.asarray(gt), k=TOP_K)
    # Recall must equal the plain scan's.  The only ids allowed to differ
    # are those swapped among ties at the k-th distance (checked above),
    # and each such swap can move the hit count by at most one.
    swapped = sum(len(set(ids[b].tolist()) - set(i_x[b].tolist()))
                  for b in range(len(ids)))
    hit_gap = round(abs(rec - rec_x) * len(ids) * TOP_K)
    assert hit_gap <= swapped, (rec, rec_x, swapped)
    if not swapped:
        assert rec == rec_x, (rec, rec_x)
    rep.emit("index", t0, n=len(base), build_s=round(t_build, 3),
             engine=idx._engine_resolved,
             wave_ms_median=median_ms(ts[1:]), waves=len(ts),
             bytes_per_vec=round(eng.bytes_per_vec(), 4),
             certified_first_shot=eng.last_exact_frac,
             recall_at_10=rec, recall_at_10_plain=rec_x,
             queries_differing_by_ties=differ, ids_swapped_by_ties=swapped,
             recall_hit_gap=hit_gap, triton_calls=n_triton,
             **exact)
    return idx, queries


def phase_dedup(rep, seed):
    from deltapq_tpu import DeltaPQIndex

    t0 = time.perf_counter()
    base, train, queries = dataset(N_INDEX, "dup_heavy", seed + 1)
    idx = DeltaPQIndex.build(train, base, M=M, K=K, seed=seed)
    ts, d_all, i_all = [], [], []
    for w in waves(queries[:4 * WAVE], WAVE):
        t = time.perf_counter()
        d, i = idx.search(w, top_k=TOP_K)
        ts.append(time.perf_counter() - t)
        d_all.append(d)
        i_all.append(i)
    d, ids = np.concatenate(d_all), np.concatenate(i_all)
    assert idx._engine_resolved == "fused_dedup", idx._engine_resolved
    eng = idx._fused_engine
    check_against(d[:256], ids[:256],
                  np_adc_topk(idx.codewords, idx.codes,
                              queries[:256])[0],
                  idx.codewords, idx.codes, queries[:256], "dedup")
    exact = exact_paths_vs_numpy(
        idx.codewords, eng._unique_codes, queries[:256])
    rep.emit("dedup", t0, n=len(base), engine=idx._engine_resolved,
             **exact,
             n_unique=eng.n_unique, dup=round(len(base) / eng.n_unique, 3),
             wave_ms_median=median_ms(ts[1:]),
             bytes_per_vec=round(eng.bytes_per_vec(), 4))


def phase_serve(rep, idx, queries, seed):
    from deltapq_tpu.serving import CoalescingServer

    t0 = time.perf_counter()
    eng = idx._fused_engine
    rng = np.random.default_rng(seed)
    plans = [[(int(o), int(s)) for o, s in zip(
        rng.integers(0, len(queries) - SERVE_MAX_ROWS, size=SERVE_WAVES),
        rng.integers(1, SERVE_MAX_ROWS + 1, size=SERVE_WAVES))]
        for _ in range(SERVE_CLIENTS)]
    results = [[None] * SERVE_WAVES for _ in range(SERVE_CLIENTS)]
    with CoalescingServer(eng, wave_rows=1024, top_k=TOP_K) as srv:
        def client(c):
            futs = [srv.submit(queries[o:o + s]) for o, s in plans[c]]
            for j, f in enumerate(futs):
                results[c][j] = f.result(timeout=600)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dispatches = srv.dispatches
    rows = differ = 0
    max_diff = 0.0
    for c in range(SERVE_CLIENTS):
        for (o, s), (d, i) in zip(plans[c], results[c]):
            d_ref, i_ref = eng.query(queries[o:o + s], top_k=TOP_K)
            np.testing.assert_allclose(d, d_ref, rtol=RTOL, atol=ATOL)
            max_diff = max(max_diff, float(np.abs(d - d_ref).max()))
            differ += ids_agree_up_to_ties(d, i, d_ref, i_ref)
            rows += s
    rep.emit("serve", t0, clients=SERVE_CLIENTS,
             waves=SERVE_CLIENTS * SERVE_WAVES, rows=rows,
             dispatches=dispatches, max_abs_diff_vs_direct=max_diff,
             queries_differing_by_ties=differ)


def phase_cli(rep, seed):
    from deltapq_tpu.cli import main
    from deltapq_tpu.io import write_vecs

    t0 = time.perf_counter()
    base, train, queries = dataset(N_CLI, "sift_like", seed + 2,
                                   n_train=N_CLI // 5, n_query=256)
    with tempfile.TemporaryDirectory() as ds:
        write_vecs(os.path.join(ds, "base.fvecs"), base)
        write_vecs(os.path.join(ds, "learn.fvecs"), train)
        write_vecs(os.path.join(ds, "query.fvecs"), queries)
        common = ["-dataset", ds, "-ext", "fvecs", "-m", str(M), "-k",
                  str(K), "-topk", str(TOP_K)]
        outs = {}
        for task in ("learn", "encode", "groundtruth", "approx_tree",
                     "query_compressed", "recall"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(common + ["-task", task])
            assert rc in (0, None), (task, rc)
            outs[task] = buf.getvalue()
    ran = [ln for ln in outs["query_compressed"].splitlines()
           if "B/vec resident" in ln]
    assert ran, outs["query_compressed"][-500:]
    recall = json.loads(outs["recall"].strip().splitlines()[-1])["recall"]
    assert recall > 0.3, recall
    rep.emit("cli", t0, n=len(base), recall_at_10=recall,
             query_compressed=ran[-1][:120])


def big_codes(n, seed):
    import jax

    from deltapq_tpu.bigscale import encode_stream
    from deltapq_tpu.ops.kmeans import pq_learn

    train = np.concatenate(list(vectors(N_TRAIN, "sift_like", seed + 7)))
    cw = pq_learn(jax.random.PRNGKey(seed), train, M=M, K=K,
                  max_iters=40, n_init=1)
    codes = encode_stream(cw, vectors(n, "sift_like", seed + 3))
    queries = next(vectors(32, "sift_like", seed + 9))
    return np.asarray(cw), codes, queries


def phase_chunked(rep, seed):
    from deltapq_tpu.bigscale import BigCompressedIndex

    t0 = time.perf_counter()
    n = N_BIG
    cw, codes, queries = big_codes(n, seed)
    t_build = time.perf_counter()
    idx = BigCompressedIndex(cw, codes, n_parts=16,
                             workers=min(16, os.cpu_count() or 1),
                             chunk_rows=CHUNK_ROWS)
    t_build = time.perf_counter() - t_build
    d, ids = idx.query(queries, top_k=TOP_K)
    t = time.perf_counter()
    d, ids = idx.query(queries, top_k=TOP_K)
    t_q = time.perf_counter() - t
    d_ref, _ = np_adc_topk(cw, codes, queries)
    check_against(d, ids, d_ref, cw, codes, queries, "chunked")
    rep.emit("chunked", t0, n=n, chunks=len(idx.engine.chunks),
             build_s=round(t_build, 3), query_ms=round(t_q * 1e3, 3),
             bytes_per_vec=round(idx.bytes_per_vec(), 4),
             resident_mb=round(idx.bytes_per_vec() * n / 1e6, 1))


def phase_mesh(rep, seed, n_dev):
    import jax

    from deltapq_tpu.bigscale import ChunkedCompressedEngine
    from deltapq_tpu.ops.fused import DedupCompressedEngine
    from deltapq_tpu.parallel.fused_sharded import ShardedCompressedEngine
    from deltapq_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) >= n_dev, jax.devices()
    t0 = time.perf_counter()
    mesh = make_mesh(n_dev)
    axis = mesh.axis_names[0]
    n = N_BIG
    cw, codes, queries = big_codes(n, seed)
    order = np.lexsort(codes.T[::-1])
    d_ref, _ = np_adc_topk(cw, codes, queries)
    rep.emit("mesh_setup", t0, n=n, devices=n_dev)
    engines = {
        "sharded": lambda: ShardedCompressedEngine(
            cw, codes[order], mesh, row_to_db=order, axis=axis),
        "dedup": lambda: DedupCompressedEngine(
            cw, codes, mesh=mesh, shard_axis=axis),
        "chunked": lambda: ChunkedCompressedEngine(
            cw, codes[order], row_to_db=order, chunk_rows=CHUNK_ROWS,
            mesh=mesh, shard_axis=axis),
    }
    for name, make in engines.items():
        t0 = time.perf_counter()
        eng = make()
        eng.query(queries, top_k=TOP_K)
        t = time.perf_counter()
        d, ids = eng.query(queries, top_k=TOP_K)
        t_q = time.perf_counter() - t
        check_against(d, ids, d_ref, cw, codes, queries, name)
        rep.emit(f"mesh_{name}", t0, n=n, devices=n_dev,
                 query_ms=round(t_q * 1e3, 3),
                 bytes_per_vec=round(eng.bytes_per_vec(), 4))
        del eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    line = card()
    print(f"card: {line}", flush=True)
    rep = Report(line)
    if args.chips == 4:
        phase_mesh(rep, args.seed, 4)
    else:
        idx, queries = phase_index(rep, args.seed)
        phase_serve(rep, idx, queries, args.seed)
        del idx
        phase_dedup(rep, args.seed)
        phase_cli(rep, args.seed)
        phase_chunked(rep, args.seed)
    dev = jax.devices()[0]
    print(f"card: {line}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
