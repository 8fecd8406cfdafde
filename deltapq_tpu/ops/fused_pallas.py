"""Fused ADC scan kernel (Pallas, Triton route) + the selection epilogue.

The ADC distance decomposes exactly through the decoded vector
(``ops/decoded.py``):

    dist[n, b] = ||xhat_n||^2 - 2 <xhat_n, q_b> + ||q_b||^2

so the database scan is a matrix product contracting over D (= M*Ds).
The plain form writes the whole [N, B] f32 distance matrix and reads it
back to reduce it; ``scan_mins`` never materializes it: each block
gathers its rows' codewords (the codebook is a few hundred KB and stays
in L1/L2), runs the bf16 product on the tensor cores with f32
accumulation, and reduces every SUB=32 consecutive rows to their
**subtile minimum** in registers, so only [N/32, B] f32 leaves the
kernel.  ``scan_mins_reference`` is the same arithmetic in plain XLA;
it is the tests' oracle and the A/B baseline, never a runtime path.

The caller selects the top subtiles per query, gathers their rows as
candidates, and reranks them with exact f32 ADC table lookups
(``select_rerank``) — reported distances are identical to the plain f32
scan, with a per-query exactness certificate that drives escalation in
the engines (``ops/fused.py``).

Numeric domain (the certificate margin ``_fence_margin`` assumes it):
codewords and queries are centred on ``codebook_center`` and rounded to
bf16; ``||xhat||^2`` is the f32 sum of squares of the bf16-rounded
codeword values; products accumulate in f32.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..platform import interpret

SUB = 32      # rows per subtile-min

#: kernel tiling: rows per block, queries per block, contraction chunk,
#: warps and pipeline stages (powers of two; see ``scan_mins``).  Chosen
#: by a 72-point sweep on an H100 at 2^20 rows x 512 queries, D=128
#: (``tools/ab_kernels.py --sweep``)
SCAN_BN = 64
SCAN_BB = 256
SCAN_BK = 32
SCAN_WARPS = 8
SCAN_STAGES = 2


def codebook_center(codewords: np.ndarray) -> np.ndarray:
    """Global centering vector mu [D]: the concatenated per-subspace
    centroid means.  Squared-L2 distances are translation-invariant,
    so the scan runs on (x-mu, q-mu) — this kills the common-mode
    magnitude that otherwise dominates bf16 rounding error on
    uncentered (e.g. bvecs 0..255) data and breaks the exactness
    certificate's margins."""
    return np.asarray(codewords, np.float32).mean(axis=1).reshape(-1)


def scan_width(D: int) -> int:
    """Padded contraction width: a power of two >= 16 (Triton block
    shapes are powers of two and the tensor cores want >= 16)."""
    return max(16, 1 << (int(D) - 1).bit_length())


def scan_codebook(codewords: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Centred bf16 codebook, flattened: [M*K*Ds + Ds] with entry
    ``(m*K + k)*Ds + j`` = bf16(c[m, k, j] - mu[m*Ds + j]) and a
    trailing zero row that padding columns (d >= D) read."""
    cw = np.asarray(codewords, np.float32)
    M, K, Ds = cw.shape
    cwc = cw - np.asarray(center, np.float32).reshape(M, 1, Ds)
    flat = np.concatenate([cwc.reshape(-1), np.zeros(Ds, np.float32)])
    return jnp.asarray(flat, jnp.bfloat16)


def _flat_index(code: jnp.ndarray, dcol: jnp.ndarray, M: int, K: int,
                Ds: int) -> jnp.ndarray:
    """Codebook offsets for decoded columns ``dcol`` of rows whose
    subspace-``dcol // Ds`` code is ``code`` (same broadcast shape)."""
    m = jnp.minimum(dcol // Ds, M - 1)
    return jnp.where(dcol < M * Ds, (m * K + code) * Ds + dcol % Ds,
                     M * K * Ds)


def _scan_kernel(nv_ref, codes_ref, cb_ref, q_ref, out_ref, *, M: int,
                 K: int, Ds: int, BN: int, BB: int, BK: int,
                 n_k: int):
    """One (BN rows x BB queries) block.  codes [N_pad, M] u8 (whole
    array; rows gathered by offset); cb flat bf16 codebook; q [D_pad,
    BB] bf16 block; out [BN/SUB, BB] f32 block."""
    i = pl.program_id(0)
    rows = i * BN + jax.lax.broadcasted_iota(jnp.int32, (BN, BK), 0)
    kcol = jax.lax.broadcasted_iota(jnp.int32, (BN, BK), 1)

    def chunk(kk, carry):
        acc, pre = carry
        dcol = kk * BK + kcol
        code = codes_ref[rows, jnp.minimum(dcol // Ds, M - 1)]
        xhat = cb_ref[_flat_index(code.astype(jnp.int32), dcol, M, K,
                                  Ds)]                     # [BN, BK]
        xf = xhat.astype(jnp.float32)
        pre = pre + jnp.sum(xf * xf, axis=1)
        qk = q_ref[pl.ds(kk * BK, BK), :]                  # [BK, BB]
        acc = acc + jnp.dot(xhat, qk,
                            preferred_element_type=jnp.float32)
        return acc, pre

    acc, pre = jax.lax.fori_loop(
        0, n_k, chunk, (jnp.zeros((BN, BB), jnp.float32),
                        jnp.zeros((BN,), jnp.float32)))
    d = pre[:, None] - 2.0 * acc
    r = i * BN + jax.lax.broadcasted_iota(jnp.int32, (BN, BB), 0)
    d = jnp.where(r < nv_ref[0], d, jnp.inf)
    out_ref[...] = jnp.min(d.reshape(BN // SUB, SUB, BB), axis=1)


@functools.partial(jax.jit, static_argnames=("M", "K", "Ds"))
def scan_mins(q: jnp.ndarray, cb: jnp.ndarray, codes: jnp.ndarray,
              n_valid: jnp.ndarray, M: int, K: int, Ds: int
              ) -> jnp.ndarray:
    """Subtile minima [N_pad/SUB, B] of the (q2-less) distances
    ``||xhat||^2 - 2 <xhat, q>`` over the whole database.

    q [D_pad, B] bf16 centred queries (D_pad = ``scan_width(M*Ds)``, B a
    multiple of 16); cb from ``scan_codebook``; codes [N_pad, M] u8 with
    N_pad a multiple of SCAN_BN; rows >= n_valid map to +inf.
    """
    d_pad, B = q.shape
    n_pad = codes.shape[0]
    BN, BB = SCAN_BN, math.gcd(SCAN_BB, B)
    BK = min(SCAN_BK, d_pad)
    assert n_pad % BN == 0 and BB >= 16 and d_pad % BK == 0
    kernel = functools.partial(_scan_kernel, M=M, K=K, Ds=Ds, BN=BN,
                               BB=BB, BK=BK, n_k=d_pad // BK)
    return pl.pallas_call(
        kernel,
        grid=(n_pad // BN, B // BB),
        in_specs=[
            pl.BlockSpec((1,), lambda i, j: (0,)),
            pl.BlockSpec(codes.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(cb.shape, lambda i, j: (0,)),
            pl.BlockSpec((d_pad, BB), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((BN // SUB, BB), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n_pad // SUB, B), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=SCAN_WARPS, num_stages=SCAN_STAGES),
        interpret=interpret(),
        name="deltapq_scan_mins",
    )(jnp.asarray(n_valid, jnp.int32).reshape(1), codes, cb, q)


@functools.partial(jax.jit, static_argnames=("M", "K", "Ds", "chunk"))
def scan_mins_reference(q: jnp.ndarray, cb: jnp.ndarray,
                        codes: jnp.ndarray, n_valid: jnp.ndarray,
                        M: int, K: int, Ds: int, chunk: int = 1 << 20
                        ) -> jnp.ndarray:
    """``scan_mins`` in plain XLA: decode, one [rows, D] x [D, B]
    product, then the subtile-min reduce over the materialized
    distances.  Rows run in ``chunk``-row slices so the [rows, B] f32
    intermediate stays bounded."""
    d_pad, B = q.shape
    n_pad = codes.shape[0]
    dcol = jnp.arange(d_pad, dtype=jnp.int32)[None, :]

    def part(args):
        c, base = args
        code = c[:, jnp.minimum(dcol[0] // Ds, M - 1)].astype(jnp.int32)
        xhat = cb[_flat_index(code, dcol, M, K, Ds)]
        xf = xhat.astype(jnp.float32)
        pre = jnp.sum(xf * xf, axis=1)
        cross = jnp.dot(xhat, q, preferred_element_type=jnp.float32)
        d = pre[:, None] - 2.0 * cross
        r = base + jnp.arange(c.shape[0], dtype=jnp.int32)[:, None]
        d = jnp.where(r < n_valid, d, jnp.inf)
        return jnp.min(d.reshape(-1, SUB, B), axis=1)

    step = min(chunk, n_pad)
    while n_pad % step:
        step //= 2
    n_c = n_pad // step
    bases = jnp.arange(n_c, dtype=jnp.int32) * step
    out = jax.lax.map(part, (codes.reshape(n_c, step, -1), bases))
    return out.reshape(n_pad // SUB, B)


# --------------------------------------------------------------------------
# Selection epilogue: subtile select + exact rerank
# --------------------------------------------------------------------------

def _fence_margin(fence: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    """bf16-matmul-domain error allowance for the exactness
    certificate.  The subtile mins come from bf16 operands (~2^-8
    relative on ``precomp`` and ``cross``, which are O(distance + q2)
    before cancellation), so the allowance scales with the full
    pre-cancellation magnitude, not the small final distance."""
    return 0.02 * (jnp.abs(fence) + q2 + 1.0)


@functools.partial(jax.jit, static_argnames=("pool",))
def pool_mins_nb(mins_nb: jnp.ndarray, pool: int) -> jnp.ndarray:
    """Min-pool kernel-layout mins [NS, B] by ``pool`` along NS, then
    transpose -> [B, NS/pool].  Pooling before the transpose shrinks
    the relayout ``pool``x."""
    NS, B = mins_nb.shape
    pad = (-NS) % pool
    if pad:
        mins_nb = jnp.concatenate(
            [mins_nb, jnp.full((pad, B), jnp.inf, mins_nb.dtype)],
            axis=0)
    return jnp.min(mins_nb.reshape(-1, pool, B), axis=1).T


def _select_units(mins: jnp.ndarray, n_sub: int
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pick the ``n_sub`` candidate units and the exactness fence from
    pooled mins [B, NU].  Returns (sub_ids [B, n_sub], fence [B]) with
    the invariant: every unit NOT in ``sub_ids`` has min >= fence.

    Large NU runs a two-level exact selection (a flat [B, NU] top_k
    grows super-linearly with NU): coarse-pool by C, top-(nc+1) coarse
    groups (coarse fence bounds every unit outside them), then
    top-(n_sub+1) among the selected groups' units (fine fence bounds
    the unselected units inside).  fence = min(coarse, fine) keeps the
    certificate exact even though the candidate set may miss a
    globally-top unit: any such miss is caught by the fence check and
    escalates, never mis-reports."""
    B, NU = mins.shape
    C = 16
    nc = min(max(4 * n_sub, 64), NU // C - 1)
    if NU <= 16384 or nc < 1 or nc * C <= n_sub:
        neg, sub_ids = jax.lax.top_k(-mins, n_sub + 1)
        return sub_ids[:, :n_sub], -neg[:, n_sub]
    pad = (-NU) % C
    if pad:
        mins = jnp.concatenate(
            [mins, jnp.full((B, pad), jnp.inf, mins.dtype)], axis=1)
    mc = mins.reshape(B, -1, C)                      # [B, NC, C]
    cmins = jnp.min(mc, axis=2)                      # [B, NC]
    negc, cids = jax.lax.top_k(-cmins, nc + 1)
    cfence = -negc[:, nc]
    cids = cids[:, :nc]
    fine = jnp.take_along_axis(
        mc, cids[:, :, None], axis=1)                # [B, nc, C]
    negf, fpos = jax.lax.top_k(-fine.reshape(B, nc * C), n_sub + 1)
    ffence = -negf[:, n_sub]
    fpos = fpos[:, :n_sub]
    sub_ids = (jnp.take_along_axis(cids, fpos // C, axis=1) * C
               + fpos % C)
    return sub_ids, jnp.minimum(cfence, ffence)


@functools.partial(jax.jit,
                   static_argnames=("top_k", "n_sub", "pool",
                                    "prepooled"))
def select_rerank(mins: jnp.ndarray, q2: jnp.ndarray, table: jnp.ndarray,
                  codes: jnp.ndarray, n_valid: jnp.ndarray, top_k: int,
                  n_sub: int, pool: int = 1, prepooled: bool = False
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Candidate selection + exact rerank.

    mins [B, NS] subtile minima in the q2-less matmul domain
    (``precomp - 2 cross``, +inf on padding); q2 [B] = ||q||^2; table
    [B, M, K] exact f32 ADC tables; codes [N_pad, M] u8 in scan order.
    Returns (dists [B, top_k] exact f32 ascending, rows [B, top_k]
    scan-order row ids, ok [B] exactness certificate).

    ``pool`` min-pools the subtile mins by that factor first, making
    the candidate unit ``SUB*pool`` rows (a pooled min lower-bounds all
    its rows, so the fence stays valid).

    Candidates = the union of the ``n_sub`` smallest units' rows.
    Certificate: every row of an unselected unit has approximate
    distance >= the (n_sub+1)-th unit min (the fence); the result is
    certified exact only when the reranked k-th distance clears the
    fence with the bf16 error margin *subtracted* (conservative: a
    false "not exact" triggers the caller's escalation, a false "exact"
    would be an error).  Engines escalate n_sub on failure and fall
    back to a full exact scan, so reported results are always exact
    (modulo equal-distance ties, as in the reference).
    """
    from .adc import adc_rerank

    B, NS = mins.shape
    M = table.shape[1]
    unit = SUB * pool
    if pool > 1 and not prepooled:
        pad = (-NS) % pool
        if pad:
            mins = jnp.concatenate(
                [mins, jnp.full((B, pad), jnp.inf, mins.dtype)], axis=1)
        mins = jnp.min(mins.reshape(B, -1, pool), axis=2)
    S = n_sub * unit
    sub_ids, fence = _select_units(mins, n_sub)
    rows = (sub_ids[:, :, None] * unit
            + jnp.arange(unit, dtype=jnp.int32)[None, None, :]
            ).reshape(B, S)
    # gather candidate codes at unit granularity: B*n_sub contiguous
    # unit-row slices instead of B*S scattered rows
    n_units_total = codes.shape[0] // unit
    safe_units = jnp.clip(sub_ids, 0, n_units_total - 1)
    cand = codes.reshape(n_units_total, unit * M)[safe_units]
    exact = adc_rerank(table, cand.reshape(B, S, M))
    exact = jnp.where(rows < n_valid, exact, jnp.inf)
    # top_k can exceed the candidate pool when it approaches N (tiny
    # databases): select what exists and pad with (+inf, -1)
    k_eff = min(top_k, S)
    negd, pos = jax.lax.top_k(-exact, k_eff)
    d = -negd
    out_rows = jnp.take_along_axis(rows, pos, axis=1)
    if k_eff < top_k:
        pad = top_k - k_eff
        d = jnp.concatenate(
            [d, jnp.full((B, pad), jnp.inf, d.dtype)], axis=1)
        out_rows = jnp.concatenate(
            [out_rows, jnp.full((B, pad), -1, out_rows.dtype)], axis=1)
    ok = (d[:, k_eff - 1] - q2) <= fence - _fence_margin(fence, q2)
    return d, out_rows, ok
