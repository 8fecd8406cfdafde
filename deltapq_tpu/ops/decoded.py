"""Decoded-cache ADC engine — the high-QPS tier.

The ADC distance decomposes exactly (quadratic expansion):

    dist[n, b] = sum_m T[b, m, codes[n, m]]
               = ||q_b||^2 + precomp[n] - 2 * (xhat_n . q_b)

where ``xhat_n`` is the PQ-decoded vector (concatenated centroids) and
``precomp[n] = sum_m ||c_{m, codes[n,m]}||^2``.  The scan becomes a
dense [N, D] @ [D, B] matrix product with **no gathers at query time**
— bound by reading the decoded cache.

Memory/speed tier: costs D*4 bytes/vector (hi+lo bf16 split ~ f32-exact)
vs M bytes for raw codes.  The reference has no such tier (its scan is
the byte-stream loop, ``deltapq_create_approx_tree.h:2805``): it trades
device memory for a gather-free layout.

Exactness: bf16 hi/lo matmuls accumulated in f32 give the cross term to
~2^-18 relative; the final candidates are **reranked with exact f32
table lookups**, so reported distances equal the plain ADC scan and the
shortlist (default 8x top_k) makes ranking mismatches vanishingly rare.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def build_decoded_cache(codewords: np.ndarray, codes: np.ndarray,
                        batch: int = 262144, center=None):
    """Returns (xhat_hi bf16 [N, D], xhat_lo bf16 [N, D], precomp f32 [N]).

    hi + lo reproduces the f32 decoded vector to ~2^-18 relative.
    ``center`` (f32 [D]) is subtracted before the bf16 split (distance-
    invariant translation; see ``fused_pallas.codebook_center`` — it
    keeps bf16 rounding proportional to the data spread, not to the
    common-mode magnitude).  precomp stays the UNcentered norm (used by
    the legacy decoded engine only).
    """
    codewords = np.asarray(codewords, np.float32)
    M, K, Ds = codewords.shape
    c2 = np.sum(codewords * codewords, axis=2)  # [M, K]
    n = codes.shape[0]
    D = M * Ds
    hi = np.empty((n, D), jnp.bfloat16)
    lo = np.empty((n, D), jnp.bfloat16)
    precomp = np.zeros(n, np.float32)
    for off in range(0, n, batch):
        c = codes[off:off + batch].astype(np.int64)
        x = np.empty((len(c), D), np.float32)
        for m in range(M):
            x[:, m * Ds:(m + 1) * Ds] = codewords[m][c[:, m]]
            precomp[off:off + batch] += c2[m][c[:, m]]
        if center is not None:
            x = x - center[None, :]
        h = x.astype(jnp.bfloat16)
        hi[off:off + batch] = h
        lo[off:off + batch] = (x - h.astype(np.float32)).astype(jnp.bfloat16)
    return hi, lo, precomp


@functools.partial(jax.jit,
                   static_argnames=("top_k", "precision", "exact_select",
                                    "rerank"))
def decoded_topk(xhat_hi: jnp.ndarray, xhat_lo: jnp.ndarray,
                 precomp: jnp.ndarray, table: jnp.ndarray,
                 codes: jnp.ndarray, queries: jnp.ndarray,
                 n_valid: jnp.ndarray, top_k: int,
                 precision: str = "bf16x2", exact_select: bool = False,
                 rerank: bool = True
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full decoded-tier query: whole-array matmul + shortlist + rerank.

    xhat_* [N_pad, D]; precomp [N_pad] with **+inf on padding rows**
    (folds the validity mask into the distance assembly — a separate
    iota mask costs a full memory pass); table [B, M, K] (for the exact
    rerank); codes [N_pad, M]; queries [B, D] f32.
    Returns (dists [B, top_k] f32 ascending, ids).

    precision: "bf16x2" — 3 bf16 matmuls reproduce the f32 cross term to
    ~2^-18 relative; "bf16" — 1 matmul, ~2^-8 shortlisting error.
    rerank=True recomputes candidate distances with exact f32 table
    lookups (a B x shortlist gather); rerank=False reports the
    matmul-domain distances (exact ids for bf16x2 in practice, values
    within ~1e-5 relative).
    Shortlisting uses ``lax.approx_min_k`` over the column axis;
    exact_select=True forces exact top_k selection.
    """
    B, D = queries.shape
    N = xhat_hi.shape[0]
    # a larger shortlist costs only the final small top_k, so keep the
    # approx_min_k recall headroom in both modes
    shortlist = min(max(16 * top_k, 64), 2048, N)

    q_hi = queries.astype(jnp.bfloat16)
    q_lo = (queries - q_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    q2 = jnp.sum(queries * queries, axis=1)  # [B]

    cross = jnp.dot(xhat_hi, q_hi.T, preferred_element_type=jnp.float32)
    if precision == "bf16x2":
        cross = (cross
                 + jnp.dot(xhat_hi, q_lo.T,
                           preferred_element_type=jnp.float32)
                 + jnp.dot(xhat_lo, q_hi.T,
                           preferred_element_type=jnp.float32))
    d = precomp[:, None] - 2.0 * cross + q2[None, :]  # [N, B]
    if exact_select:
        neg, cand_i = jax.lax.top_k(-d.T, shortlist)
        cand_d = -neg
    else:
        cand_d, cand_i = jax.lax.approx_min_k(
            d, shortlist, reduction_dimension=0, recall_target=0.99)
        cand_d, cand_i = cand_d.T, cand_i.T  # -> [B, shortlist]
    cand_i = cand_i.astype(jnp.int32)

    if not rerank:
        neg, pos = jax.lax.top_k(-cand_d, top_k)
        return -neg, jnp.take_along_axis(cand_i, pos, axis=1)

    # exact rerank of the shortlist with f32 table values
    from .adc import adc_rerank

    exact = adc_rerank(table, codes[jnp.clip(cand_i, 0, N - 1)])
    exact = jnp.where(jnp.isfinite(cand_d), exact, jnp.inf)
    neg, pos = jax.lax.top_k(-exact, top_k)
    return -neg, jnp.take_along_axis(cand_i, pos, axis=1)


class DecodedEngine:
    """Stateful wrapper holding the device-resident decoded cache."""

    def __init__(self, codewords: np.ndarray, codes: np.ndarray,
                 precision: str = "bf16x2"):
        from .adc import adc_table, pad_codes

        self._adc_table = adc_table
        self.codewords = jnp.asarray(codewords, jnp.float32)
        M, K, Ds = codewords.shape
        self.D = M * Ds
        self.n_valid = codes.shape[0]
        self.precision = precision
        codes_p = pad_codes(np.asarray(codes), 1024)
        hi, lo, pre = build_decoded_cache(codewords, codes_p)
        pre[self.n_valid:] = np.inf  # fold validity mask into precomp
        self.xhat_hi = jnp.asarray(hi)
        self.xhat_lo = jnp.asarray(lo)
        self.precomp = jnp.asarray(pre)
        self.codes = jnp.asarray(codes_p)

    def query(self, queries: np.ndarray, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(queries, np.float32)
        if q.shape[1] < self.D:
            q = np.pad(q, ((0, 0), (0, self.D - q.shape[1])))
        table = self._adc_table(self.codewords, jnp.asarray(q))
        d, i = decoded_topk(self.xhat_hi, self.xhat_lo, self.precomp,
                            table, self.codes, jnp.asarray(q),
                            jnp.int32(self.n_valid), top_k,
                            self.precision)
        return np.asarray(d), np.asarray(i)

    def save(self, path: str) -> None:
        """Persist the decoded cache (staged-artifact model, SURVEY §5)."""
        np.savez(path,
                 xhat_hi=np.asarray(self.xhat_hi).view(np.uint16),
                 xhat_lo=np.asarray(self.xhat_lo).view(np.uint16),
                 precomp=np.asarray(self.precomp),
                 codes=np.asarray(self.codes),
                 codewords=np.asarray(self.codewords),
                 n_valid=self.n_valid, precision=self.precision)

    @classmethod
    def load(cls, path: str) -> "DecodedEngine":
        from .adc import adc_table

        z = np.load(path, allow_pickle=False)
        self = cls.__new__(cls)
        self._adc_table = adc_table
        self.codewords = jnp.asarray(z["codewords"])
        M, K, Ds = self.codewords.shape
        self.D = M * Ds
        self.n_valid = int(z["n_valid"])
        self.precision = str(z["precision"])
        self.xhat_hi = jnp.asarray(z["xhat_hi"]).view(jnp.bfloat16)
        self.xhat_lo = jnp.asarray(z["xhat_lo"]).view(jnp.bfloat16)
        self.precomp = jnp.asarray(z["precomp"])
        self.codes = jnp.asarray(z["codes"])
        return self
