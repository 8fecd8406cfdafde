"""Benchmark: compressed-tier ADC query throughput on one GPU.

Prints ONE JSON line:
  {"metric": "adc_qps_per_chip", "value": N, "unit": "queries/s",
   "device": {"platform": ..., "kind": ..., "count": ...}}

The measured path is the system's namesake capability through the
product entry point: ``DeltaPQIndex.search`` with ``engine="auto"`` over
the DeltaTree-compressed codes (stream tiles resident, decoded on the
device per batch, fused Triton scan, exact f32 rerank with the in-graph
escalation ladder — results are exact by construction).  The headline
workload is ``sift_like`` (``deltapq_tpu.synth.WORKLOADS``: 128-d, M=8,
K=256, ~1.06x code duplication) at 1M rows; ``dup_heavy`` (~37x, the
dedup tier) is reported on stderr.  Query batches of 512, top-10; the
time is the median of 20 batches after warm-up, each ended by
``block_until_ready`` (the engine returns host arrays).

Fails when JAX finds no GPU.  Usage: python bench.py [B] [workload]
"""

import json
import statistics
import sys
import time

import numpy as np


def run_workload(name, n, B, top_k, reps=20, seed=0):
    from deltapq_tpu import DeltaPQIndex
    from deltapq_tpu.synth import WORKLOADS, workload_chunks

    x = np.concatenate(list(workload_chunks(
        n + 20000 + 20 * B, seed=seed, **WORKLOADS[name])))
    base, train, qs = x[:n], x[n:n + 20000], x[n + 20000:]
    idx = DeltaPQIndex.build(train, base, M=8, K=256, seed=seed,
                             max_iters=40)
    batches = [qs[i * B:(i + 1) * B] for i in range(20)]
    idx.search(batches[0], top_k=top_k)            # compile + warm
    idx.search(batches[1], top_k=top_k)
    ts = []
    for i in range(reps):
        t = time.perf_counter()
        idx.search(batches[i % len(batches)], top_k=top_k)
        ts.append(time.perf_counter() - t)
    per_batch = statistics.median(ts)
    eng = idx._fused_engine
    print(f"# [{name}] engine={idx._engine_resolved} "
          f"{per_batch * 1e3:.3f} ms/batch of {B} = {B / per_batch:.0f} "
          f"QPS (median of {reps}); {eng.bytes_per_vec():.3f} B/vec "
          f"resident", file=sys.stderr)
    return B / per_batch


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {jax.default_backend()!r}")
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    n, top_k = 1 << 20, 10
    qps = run_workload("sift_like" if which == "all" else which, n, B,
                       top_k)
    if which == "all":
        run_workload("dup_heavy", n, B, top_k)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "adc_qps_per_chip", "value": round(qps, 1),
        "unit": "queries/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
