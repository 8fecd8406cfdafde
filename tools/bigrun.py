"""Big-N end-to-end run (BASELINE config 4 analog, synthetic):
chunked generate -> device encode -> partitioned build -> compressed-tier
query -> recall vs streamed exact groundtruth, all timed, with host
memory bounded by the chunk size.

Usage: python tools/bigrun.py [N] [n_parts] [n_queries] [out.json]
Writes the JSON summary to ``out.json`` (default ``bigrun.json`` in the
working directory) after every phase.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHUNK = 1_000_000
D, M, K, Ds = 128, 8, 256, 16


def n_clusters_for(n_total: int) -> int:
    """Scale cluster count with N so clusters stay small (~16 rows):
    otherwise cluster members share PQ codes and recall@10 is capped
    by intra-cluster ties, not by the index."""
    return int(min(max(65536, n_total // 16), 8_000_000))


def chunk_vectors(chunk_id: int, n: int, centers: np.ndarray
                  ) -> np.ndarray:
    """Deterministic per-chunk generation (regenerable for the
    groundtruth pass without storing 100M x 128 floats).  Output is
    uint8 (SIFT bvecs semantics) — 4x less host->device traffic; the
    encode/groundtruth paths convert to f32 on device."""
    rng = np.random.default_rng(1000 + chunk_id)
    assign = rng.integers(0, len(centers), size=n)
    x = (centers[assign]
         + rng.normal(size=(n, D)).astype(np.float32) * 6.0)
    return np.clip(x + 128.0, 0, 255).astype(np.uint8)


def main():
    n_total = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000_000
    n_parts = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    n_q = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    out_name = sys.argv[4] if len(sys.argv) > 4 else "bigrun.json"
    top_k = 10
    report = {"n": n_total, "n_parts": n_parts, "n_queries": n_q}

    def checkpoint():
        # phase-incremental write: a killed run still lands the phases
        # it finished
        with open(out_name, "w") as f:
            json.dump(report, f, indent=1)

    import jax

    from deltapq_tpu.bigscale import BigCompressedIndex, encode_stream
    from deltapq_tpu.eval.groundtruth import exact_topk
    from deltapq_tpu.eval.metrics import recall_at_k
    from deltapq_tpu.ops.kmeans import pq_learn
    from deltapq_tpu.profiling import host_mem_usage

    rng = np.random.default_rng(7)
    n_cl = n_clusters_for(n_total)
    report["n_clusters"] = n_cl
    centers = rng.normal(size=(n_cl, D)).astype(np.float32) * 40.0
    queries = chunk_vectors(999_999, n_q, centers)
    n_chunks = -(-n_total // CHUNK)

    def chunks():
        left = n_total
        for c in range(n_chunks):
            n = min(CHUNK, left)
            left -= n
            yield chunk_vectors(c, n, centers)

    print(f"[bigrun] N={n_total} parts={n_parts} backend="
          f"{jax.default_backend()}", flush=True)

    t0 = time.time()
    cw = pq_learn(jax.random.PRNGKey(0),
                  chunk_vectors(0, min(100_000, n_total), centers),
                  M=M, K=K, max_iters=60)
    report["t_learn_s"] = round(time.time() - t0, 1)
    print(f"[bigrun] learn {report['t_learn_s']}s", flush=True)
    checkpoint()

    t0 = time.time()
    codes = encode_stream(cw, chunks())
    report["t_encode_s"] = round(time.time() - t0, 1)
    report["mem_after_encode_mb"] = round(
        host_mem_usage()["rss_kb"] / 1024, 1)
    print(f"[bigrun] encode {report['t_encode_s']}s "
          f"rss={report['mem_after_encode_mb']}MB", flush=True)
    checkpoint()

    t0 = time.time()
    idx = BigCompressedIndex(cw, codes, n_parts=n_parts,
                             workers=min(n_parts, os.cpu_count() or 1))
    report["t_build_s"] = round(time.time() - t0, 1)
    report["t_sort_s"] = round(idx.build_stats.t_sort, 1)
    report["t_trees_s"] = round(idx.build_stats.t_build, 1)
    report["n_diffs"] = int(idx.build_stats.n_diffs)
    report["bytes_per_vec"] = round(idx.bytes_per_vec(), 3)
    report["mem_after_build_mb"] = round(
        host_mem_usage()["rss_kb"] / 1024, 1)
    print(f"[bigrun] build {report['t_build_s']}s "
          f"(sort {report['t_sort_s']}s trees {report['t_trees_s']}s) "
          f"{report['bytes_per_vec']} B/vec", flush=True)
    checkpoint()

    # warmup + certificate calibration + the persistent compile cache:
    # t_warmup_s is the cold-process cost and t_first_query_s the
    # first served query after it
    t0 = time.time()
    idx.warmup(batch_sizes=(n_q,), top_k=top_k)
    report["t_warmup_s"] = round(time.time() - t0, 1)
    hint = getattr(getattr(idx.engine, "chunks", [idx.engine])[0],
                   "ns_hint", None)
    report["calibrated_ns_hint"] = hint
    print(f"[bigrun] warmup {report['t_warmup_s']}s "
          f"(calibrated ns_hint={hint})", flush=True)
    t0 = time.time()
    d, ids = idx.query(queries, top_k=top_k)
    report["t_first_query_s"] = round(time.time() - t0, 3)
    t0 = time.time()
    d, ids = idx.query(queries, top_k=top_k)
    report["t_query_batch_s"] = round(time.time() - t0, 3)
    report["qps"] = round(n_q / max(time.time() - t0, 1e-9), 1)
    print(f"[bigrun] first query {report['t_first_query_s']}s, "
          f"batch {report['t_query_batch_s']}s", flush=True)
    checkpoint()

    # kernel/epilogue split: time decode + fused scan alone across all
    # chunks, same query batch
    import jax.numpy as jnp

    from deltapq_tpu.ops import fused_pallas as fp
    from deltapq_tpu.ops.fused import _pad_queries

    engines = getattr(idx.engine, "chunks", [idx.engine])
    e0 = engines[0]
    qp, _ = _pad_queries(queries, e0.d_pad)
    qop = jnp.asarray(qp - e0.mu[None, :], jnp.bfloat16).T

    def kernels_once():
        outs = [fp.scan_mins(qop, e.cb, e._codes(), jnp.int32(e.n_valid),
                             e.M, e.K, e.Ds) for e in engines]
        return [m.block_until_ready() for m in outs]

    kernels_once()  # warm
    t0 = time.time()
    kernels_once()
    report["t_decode_scan_s"] = round(time.time() - t0, 3)
    report["n_chunks"] = len(engines)
    report["exact_frac"] = round(float(np.mean(
        [e.last_exact_frac for e in engines])), 4)
    print(f"[bigrun] decode+scan {report['t_decode_scan_s']}s "
          f"over {len(engines)} chunk(s)", flush=True)
    checkpoint()

    t0 = time.time()
    gt_d, gt_i = exact_topk(queries, chunks(), top_k=top_k,
                            tile_n=524288)
    report["t_groundtruth_s"] = round(time.time() - t0, 1)
    rec = recall_at_k(ids, gt_i, k=top_k)
    report["recall_at_10"] = round(float(rec), 4)
    print(f"[bigrun] groundtruth {report['t_groundtruth_s']}s "
          f"recall@10={rec:.4f}", flush=True)
    checkpoint()

    # plain-codes cross-check at the SAME scale: the compressed tier is lossless, so its recall must equal the plain
    # PQ scan's on the identical workload (up to equal-distance ties)
    import jax.numpy as jnp

    from deltapq_tpu.ops.adc import adc_query_topk, adc_table, pad_codes
    t0 = time.time()
    tab = adc_table(cw, queries.astype(np.float32))
    pc_chunk = 16 * 1024 * 1024
    best_d = np.full((n_q, top_k), np.inf, np.float32)
    best_i = np.full((n_q, top_k), -1, np.int64)
    for lo in range(0, n_total, pc_chunk):
        hi = min(lo + pc_chunk, n_total)
        cp = jnp.asarray(pad_codes(codes[lo:hi], 16384))
        d_c, i_c = adc_query_topk(tab, cp, jnp.int32(hi - lo), top_k)
        d_all = np.concatenate([best_d, np.asarray(d_c)], axis=1)
        i_all = np.concatenate([best_i,
                                np.asarray(i_c).astype(np.int64) + lo],
                               axis=1)
        sel = np.argsort(d_all, axis=1, kind="stable")[:, :top_k]
        best_d = np.take_along_axis(d_all, sel, axis=1)
        best_i = np.take_along_axis(i_all, sel, axis=1)
    rec_plain = recall_at_k(best_i, gt_i, k=top_k)
    report["t_plain_scan_s"] = round(time.time() - t0, 1)
    report["recall_plain_at_10"] = round(float(rec_plain), 4)
    report["recall_delta_vs_plain"] = round(float(rec - rec_plain), 4)
    print(f"[bigrun] plain-scan cross-check {report['t_plain_scan_s']}s"
          f" recall@10={rec_plain:.4f} (delta "
          f"{report['recall_delta_vs_plain']:+.4f})", flush=True)

    checkpoint()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
