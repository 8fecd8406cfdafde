"""On-card A/B: the fused scan kernel against what XLA makes of the
plain form, alone and inside the whole ``FusedCompressedEngine.query``,
plus the stream decode and the XLA rerank at the first and cap rungs.

Data: the sift_like recipe (``deltapq_tpu.synth.WORKLOADS``; 128-d,
M=8, K=256, ~1.06x code duplication) in lexsort scan order, a batch of
B queries, top-10.  Every time is the median of ``--reps`` calls after
warm-up, each ended by ``block_until_ready``.  Prints one JSON line per
measurement, each naming the device.

Usage: python tools/ab_kernels.py [--n 1048576 16777216] [--b 512]
                                  [--reps 20] [--quick] [--sweep]
``--quick`` compiles each kernel at the real widths and checks it
against its plain form once, then stops.  ``--sweep`` also times the
scan kernel over its tiling constants (``fused_pallas.SCAN_*``) at
the first ``--n``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def median_ms(fn, reps):
    import jax

    jax.block_until_ready(fn())          # warm-up (and compile)
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def sweep(fp, qop, eng, dec, nv, kw, reps, emit, n):
    """Time the scan kernel at each tiling; restores the defaults."""
    import itertools

    import jax

    names = ("SCAN_BN", "SCAN_BB", "SCAN_BK", "SCAN_WARPS",
             "SCAN_STAGES")
    keep = {k: getattr(fp, k) for k in names}
    try:
        for bn, bb, bk, w, st in itertools.product(
                (64, 128), (64, 128, 256), (32, 64, 128), (4, 8),
                (2, 3)):
            for k, v in zip(names, (bn, bb, bk, w, st)):
                setattr(fp, k, v)
            f = jax.jit(lambda *a: fp.scan_mins.__wrapped__(*a, **kw))
            try:
                t = median_ms(lambda: f(qop, eng.cb, dec, nv), reps)
            except Exception as e:  # a tiling the compiler refuses
                t = repr(e)[:120]
            emit(phase="scan_sweep", n=n, bn=bn, bb=bb, bk=bk, warps=w,
                 stages=st, triton_ms=t)
    finally:
        for k, v in keep.items():
            setattr(fp, k, v)


def sift_like(n, seed=0):
    import jax

    from deltapq_tpu.bigscale import encode_stream
    from deltapq_tpu.ops.kmeans import pq_learn
    from deltapq_tpu.synth import WORKLOADS, workload_chunks

    rec = WORKLOADS["sift_like"]
    train = next(workload_chunks(20000, seed=seed + 1, **rec))
    cw = pq_learn(jax.random.PRNGKey(seed), train, M=8, K=256,
                  max_iters=40, n_init=1)
    codes = encode_stream(cw, workload_chunks(n, seed=seed, **rec))
    q = next(workload_chunks(4096, seed=seed + 2, **rec))
    return cw, codes, q


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+",
                    default=[1 << 20, 1 << 24])
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        sys.exit("ab_kernels: no GPU found")
    from deltapq_tpu.ops import fused_pallas as fp
    from deltapq_tpu.ops.adc import adc_rerank, adc_table
    from deltapq_tpu.ops.fused import FusedCompressedEngine, _ladder

    dev = jax.devices()[0]
    base = {"card": card(), "device_kind": dev.device_kind,
            "platform": dev.platform}

    def emit(**kw):
        print(json.dumps({**base, **kw}), flush=True)

    B, top_k = args.b, 10
    for n in args.n:
        t0 = time.perf_counter()
        cw, codes, qs = sift_like(n)
        order = np.lexsort(codes.T[::-1])
        eng = FusedCompressedEngine(cw, codes[order], row_to_db=order)
        emit(phase="setup", n=n, seconds=time.perf_counter() - t0,
             bytes_per_vec=eng.bytes_per_vec())
        q = qs[:B]
        qp = np.zeros((B, eng.d_pad), np.float32)
        qp[:, :eng.D] = q - eng.mu[None, :eng.D]
        qop = jnp.asarray(qp, jnp.bfloat16).T
        nv = jnp.int32(eng.n_valid)
        dec = eng._codes()
        kw = dict(M=eng.M, K=eng.K, Ds=eng.Ds)
        got = fp.scan_mins(qop, eng.cb, dec, nv, **kw)
        ref = fp.scan_mins_reference(qop, eng.cb, dec, nv, **kw)
        fin = jnp.isfinite(ref)
        err = float(jnp.max(jnp.where(fin, jnp.abs(got - ref), 0.0)))
        scale = float(jnp.max(jnp.where(fin, jnp.abs(ref), 0.0)))
        emit(phase="scan_check", n=n, max_abs_err=err, scale=scale,
             inf_agree=bool(jnp.all(jnp.isinf(got) == jnp.isinf(ref))))
        d, i = eng.query(q, top_k=top_k)
        emit(phase="engine_check", n=n, finite=bool(np.isfinite(d).all()),
             first_shot=eng.last_exact_frac)
        table = adc_table(eng.codewords, jnp.asarray(q))
        rungs, pool = _ladder(dec.shape[0] // fp.SUB, B, top_k)
        rng = np.random.default_rng(0)
        cands = {}
        for name, ns in (("first", rungs[0]), ("cap", rungs[-1])):
            S = ns * fp.SUB * pool
            cands[name] = jnp.asarray(
                rng.integers(0, 256, size=(B, S, 8)), jnp.uint8)
        rr_x = jax.jit(adc_rerank)
        if args.quick:
            continue

        t_dec = median_ms(lambda: eng._codes(), args.reps)
        t_k = median_ms(lambda: fp.scan_mins(qop, eng.cb, dec, nv, **kw),
                        args.reps)
        t_x = median_ms(lambda: fp.scan_mins_reference(
            qop, eng.cb, dec, nv, **kw), args.reps)
        emit(phase="scan_ab", n=n, b=B, decode_ms=t_dec,
             triton_ms=t_k, xla_ms=t_x)
        if args.sweep and n == args.n[0]:
            sweep(fp, qop, eng, dec, nv, kw, args.reps, emit, n)

        # whole query, kernel vs plain form in turns (K, X, X, K) after
        # calibration, so the certificate's first rung is settled
        eng.calibrate(top_k=top_k, b=B)
        kernel = fp.scan_mins
        times = {"triton": [], "xla": []}
        for form in ("triton", "xla", "xla", "triton"):
            fp.scan_mins = kernel if form == "triton" else \
                fp.scan_mins_reference
            try:
                times[form].append(median_ms(
                    lambda: eng.query(q, top_k=top_k), args.reps))
            finally:
                fp.scan_mins = kernel
        emit(phase="engine_ab", n=n, b=B, query_triton_ms=times["triton"],
             query_xla_ms=times["xla"], first_shot=eng.last_exact_frac,
             ns_hint=getattr(eng, "ns_hint", None))

        # rerank at the first rung and at the cap rung
        for name, cand in cands.items():
            t_r = median_ms(lambda: rr_x(table, cand), args.reps)
            emit(phase="rerank", n=n, rung=name,
                 rows_per_query=int(cand.shape[1]), xla_ms=t_r)


if __name__ == "__main__":
    main()
