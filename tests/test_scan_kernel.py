"""The GPU query path's pieces on the CPU: the device stream decode, the
fused scan kernel (Pallas interpret mode) against its plain-XLA form,
the kernel's lowering to Triton, the XLA rerank, the platform helper
and the compile-cache placement.  Tests marked ``gpu`` run the compiled
kernel and skip where there is no card."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deltapq_tpu.ops import fused_pallas as fp
from deltapq_tpu.ops.stream_tiles import (TILE, build_stream_tiles,
                                          decode_stream_device,
                                          decode_stream_tiles)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codes(kind, n, M, seed):
    rng = np.random.default_rng(seed)
    if kind == "dense":
        return rng.integers(0, 256, size=(n, M)).astype(np.uint8)
    # chain: each row differs from the previous in one subspace
    codes = np.repeat(rng.integers(0, 256, size=(1, M)), n, axis=0)
    m = rng.integers(0, M, size=n)
    v = rng.integers(0, 256, size=n)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        codes[i, m[i]] = v[i]
    return codes.astype(np.uint8)


@pytest.mark.parametrize("kind", ["dense", "chain"])
@pytest.mark.parametrize("n", [1, 1023, 1024, 5000])
@pytest.mark.parametrize("M", [4, 8, 12, 16])
def test_decode_stream_device_matches_oracle(M, n, kind):
    codes = _codes(kind, n, M, seed=M * 7919 + n)
    st = build_stream_tiles(codes)
    out = np.asarray(decode_stream_device(
        jnp.asarray(st.row_data), jnp.asarray(st.vals),
        jnp.asarray(st.meta), M))
    assert out.shape == (st.n_pad, M) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[:n], decode_stream_tiles(st))
    np.testing.assert_array_equal(out[:n], codes)
    # padding rows repeat the last valid row (zero diffs)
    assert (out[n:] == codes[-1]).all()


def _scan_problem(M, Ds, n, B, seed=0):
    rng = np.random.default_rng(seed)
    K = 256
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    mu = fp.codebook_center(cw)
    cb = fp.scan_codebook(cw, mu)
    d_pad = fp.scan_width(M * Ds)
    n_pad = -(-n // TILE) * TILE
    codes = np.zeros((n_pad, M), np.uint8)
    codes[:n] = rng.integers(0, K, size=(n, M))
    q = np.zeros((B, d_pad), np.float32)
    q[:, :M * Ds] = rng.normal(size=(B, M * Ds)) * 2 - mu
    return (jnp.asarray(q, jnp.bfloat16).T, cb, jnp.asarray(codes),
            jnp.int32(n), K)


@pytest.mark.parametrize("n", [1000, 2500])
@pytest.mark.parametrize("B", [128, 512])
@pytest.mark.parametrize("M,Ds", [(4, 8), (8, 16), (16, 60)])
def test_scan_kernel_interpret_matches_reference(M, Ds, B, n):
    q, cb, codes, n_valid, K = _scan_problem(M, Ds, n, B)
    got = np.asarray(fp.scan_mins(q, cb, codes, n_valid, M, K, Ds))
    ref = np.asarray(fp.scan_mins_reference(q, cb, codes, n_valid, M, K,
                                            Ds, chunk=1024))
    assert got.shape == (codes.shape[0] // fp.SUB, B)
    # padding subtiles are +inf in both; valid ones agree to f32
    # summation order (both accumulate the same bf16 products in f32)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    scale = np.abs(ref[fin]).max()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0,
                               atol=2e-6 * scale)


def test_scan_reference_matches_numpy():
    """The plain form is the documented arithmetic: bf16 codewords and
    queries, f32 products and sums, min over each SUB-row subtile."""
    M, Ds, n, B = 8, 16, 1500, 128
    q, cb, codes, n_valid, K = _scan_problem(M, Ds, n, B, seed=3)
    ref = np.asarray(fp.scan_mins_reference(q, cb, codes, n_valid, M, K,
                                            Ds))
    cbf = np.asarray(cb.astype(jnp.float32))[:-Ds].reshape(M, K, Ds)
    c = np.asarray(codes)
    x = np.concatenate([cbf[m][c[:, m]] for m in range(M)], axis=1)
    qf = np.asarray(q.astype(jnp.float32))[:M * Ds]
    d = (x * x).sum(1)[:, None] - 2.0 * (x @ qf)
    d[n:] = np.inf
    want = d.reshape(-1, fp.SUB, B).min(axis=1)
    np.testing.assert_allclose(ref, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("M,Ds", [(8, 16), (12, 8)])
def test_scan_kernel_lowers_to_triton(M, Ds, monkeypatch):
    """Compiled (not interpreted), the kernel lowers for CUDA to one
    Triton custom call — checked here without a card."""
    monkeypatch.setattr(fp, "interpret", lambda: False)
    q, cb, codes, n_valid, K = _scan_problem(M, Ds, 1024, 256)
    lowered = jax.jit(
        lambda *a: fp.scan_mins(*a, M=M, K=K, Ds=Ds)
    ).trace(q, cb, codes, n_valid).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "deltapq_scan_mins" in text


def test_scan_width_and_query_padding():
    from deltapq_tpu.ops.fused import _pad_queries

    assert [fp.scan_width(d) for d in (8, 16, 96, 128, 960)] == \
        [16, 16, 128, 128, 1024]
    for b, want in ((1, 1), (128, 128), (129, 256), (700, 1024)):
        want = max(want, fp.SCAN_BB)
        q, nb = _pad_queries(np.ones((b, 96), np.float32), 128)
        assert q.shape == (want, 128) and nb == b
        assert (q[b:] == 0).all() and (q[:, 96:] == 0).all()


@pytest.mark.parametrize("S", [64, 4096])
def test_rerank_bit_equal_adc_tile_dists(S):
    from deltapq_tpu.ops.adc import adc_rerank, adc_tile_dists

    rng = np.random.default_rng(S)
    B, M, K = 6, 8, 256
    table = jnp.asarray(rng.normal(size=(B, M, K)).astype(np.float32)
                        * 100)
    cand = rng.integers(0, K, size=(B, S, M)).astype(np.uint8)
    got = np.asarray(adc_rerank(table, jnp.asarray(cand)))
    for b in range(B):
        want = np.asarray(adc_tile_dists(table[b:b + 1],
                                         jnp.asarray(cand[b])))[0]
        np.testing.assert_array_equal(got[b], want)


def test_platform_helper():
    from deltapq_tpu import platform

    assert platform.backend() == "cpu"
    assert platform.interpret() and not platform.on_gpu()
    assert platform.on_gpu("gpu") and not platform.interpret("gpu")
    for name in ("rocm", "metal", "iree"):
        with pytest.raises(RuntimeError, match="unsupported"):
            platform.backend(name)


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_placement(preset, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c",
         "import deltapq_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120, check=True).stdout.strip().splitlines()[-1]
    want = (str(tmp_path / "cache") if preset
            else os.path.join(ROOT, ".jax_cache"))
    assert out == want


@pytest.mark.gpu
def test_scan_kernel_on_gpu_matches_reference(gpu):
    """Compiled on the card at the index width the smoke test uses."""
    q, cb, codes, n_valid, K = _scan_problem(8, 16, 1 << 16, 512)
    got = np.asarray(fp.scan_mins(q, cb, codes, n_valid, 8, K, 16))
    ref = np.asarray(fp.scan_mins_reference(q, cb, codes, n_valid, 8, K,
                                            16))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0,
                               atol=2e-6 * np.abs(ref[fin]).max())
