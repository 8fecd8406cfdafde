"""Fused-scan engines: the production query tiers.

Two engines over the shared fused scan kernel (``fused_pallas.py``) +
exact-rerank epilogue.  Both report **exact f32 ADC distances**
(identical to the reference plain scan's values) and carry a per-query
exactness certificate:

======================  ============  =================================
engine                  resident      scan input
======================  ============  =================================
FusedCodesEngine        M B/vec       u8 codes
FusedCompressedEngine   1+diffs/row   stream tiles (mask planes + one
                        (data-dep.)   packed value stream), decoded to
                                      codes on the device per batch
======================  ============  =================================

The compressed engine is the device realization of the reference's
compressed-stream query
(``query_processing_scan_compressed_codes_opt_o_direct``,
``deltapq_create_approx_tree.h:2805-2984``): same information content
(DFS-ordered diffs), decoded tile-parallel instead of stack-serial.
The decoded codes feed both the scan and the rerank, so no plain code
array stays resident.  ``DedupCompressedEngine`` scans each distinct
code once and expands row ids on the host.

The selection constants below (``_pool_for``, ``_default_n_sub``, the
ladder cap in ``_select_with_escalation``, ``ADAPT_*`` and
``DedupCompressedEngine.EXACT_ALL_MAX_ROWS``) have not been measured on
the GPU yet; ROADMAP lists them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .adc import adc_table
from .stream_tiles import (TILE, StreamTiles, build_stream_tiles,
                           decode_stream_device)
from . import fused_pallas as fp


def _pad_queries(queries: np.ndarray, d_pad: int
                 ) -> Tuple[np.ndarray, int]:
    """Zero-pad queries to [b_pad, d_pad]: b_pad is the next power of
    two >= max(b, SCAN_BB), so a server's varying wave sizes share a
    handful of compiled shapes."""
    q = np.asarray(queries, np.float32)
    b = q.shape[0]
    b_pad = max(fp.SCAN_BB, 1 << max(b - 1, 0).bit_length())
    out = np.zeros((b_pad, d_pad), np.float32)
    out[:b, :q.shape[1]] = q
    return out, b


def _row_ids_i32(ids) -> np.ndarray:
    """Row-id map for the device-side gather.  i32 on device (half the
    memory of i64); ids must stay below 2^31 — the reference has the
    same cap (N < INT_MAX, ``deltapq_create_approx_tree.h:982``).
    Beyond that, split the index (``bigscale.ChunkedCompressedEngine``
    keeps per-chunk ids well under the bound; its cross-chunk merge
    carries i64)."""
    a = np.asarray(ids)
    if len(a) and int(a.max()) >= 2 ** 31:
        raise ValueError(
            f"row id {int(a.max())} overflows the engine's i32 id map "
            f"(cap 2^31); split the index with "
            f"bigscale.ChunkedCompressedEngine")
    return a.astype(np.int32)


def _pool_for(ns_total: int) -> int:
    """Min-pool factor for the selection epilogue: coarsen the
    candidate unit so the [B, NS/pool] top_k + relayout stay small.
    Finer units certify more often (the top-k rows concentrate in few
    32-row subtiles), so pool grows only with N.  The fence bound stays
    valid at any pool (a pooled min lower-bounds all its rows); a
    coarser fence only costs escalation frequency, never exactness."""
    if ns_total <= 32768:        # <= 1M rows
        return 1
    if ns_total <= 131072:       # <= 4M rows
        return 2
    if ns_total <= 1048576:      # <= 32M rows (chunk-sized)
        return 4
    return 8


def _default_n_sub(top_k: int, n_units: int, unit: int) -> int:
    """Candidate unit count: ~50x over-provision of top_k rows (at
    least 512 rows), bounded to the database.  Under-provision on other
    index shapes is recovered by the per-index calibration, the
    across-batch adaptive growth (``ns_hint``) and the 2x escalation
    rung."""
    want = -(-max(50 * top_k, 512) // unit)
    return int(max(2, min(want, max(n_units - 1, 1))))


@functools.partial(jax.jit, static_argnames=("top_k", "rungs", "pool",
                                             "final_exact"))
def fused_select_esc(mins_nb, q2, table, codes_dev, n_valid, top_k,
                     rungs, pool, invalid=None, final_exact=False):
    """Device-resident selection + escalation: ``rungs`` is an
    ascending tuple of candidate-unit counts; rung 1 always runs, and
    each later rung is a ``lax.cond``-gated IN-GRAPH retry that fires
    only when some query's exactness certificate still fails — the
    all-pass path costs zero host round-trips, and the whole ladder is
    one device sync (the result transfer).
    Returns (d, rows, ok, ok1): ``ok`` is the final per-query
    certificate, ``ok1`` the first-shot one (the exact_frac
    statistic).  With ``final_exact`` a cond-gated full exact scan
    covers every query whose certificate still fails, so results are
    exact by construction (the reference's heap is exact the same way,
    ``deltapq_create_approx_tree.h:2909-2914``); ``invalid`` forces
    queries onto that scan.
    """
    mins_bn = fp.pool_mins_nb(mins_nb, pool)

    def rung(ns):
        d, r, ok = fp.select_rerank(mins_bn, q2, table, codes_dev,
                                    n_valid, top_k, ns, pool,
                                    prepooled=True)
        if invalid is not None:
            ok = jnp.logical_and(ok, jnp.logical_not(invalid))
        return d, r, ok

    d, rows, ok = rung(rungs[0])
    ok1 = ok
    for ns in rungs[1:]:
        d, rows, ok = jax.lax.cond(
            jnp.all(ok), lambda _, cur=(d, rows, ok): cur,
            lambda _, ns=ns: rung(ns), operand=None)
    if final_exact:
        from .adc import adc_query_topk

        # biggest scan tile that divides the padded code rows: the
        # terminal scan is a sequential lax.scan over tiles, so the
        # tile count sets its latency
        tile_n = TILE
        while (tile_n * 2 <= 16384
               and codes_dev.shape[0] % (tile_n * 2) == 0):
            tile_n *= 2

        def terminal(_):
            d_s, r_s = adc_query_topk(table, codes_dev, n_valid,
                                      top_k, tile_n)
            return (jnp.where(ok[:, None], d, d_s),
                    jnp.where(ok[:, None], rows, r_s))
        d, rows = jax.lax.cond(
            jnp.all(ok), lambda _, cur=(d, rows): cur, terminal,
            operand=None)
    return d, rows, ok, ok1


#: adaptive certificate calibration: grow the first rung when the
#: measured first-shot pass rate falls below GROW_BELOW (one power-of-2
#: step per batch; each step compiles once, landing in the persistent
#: compilation cache)
ADAPT_GROW_BELOW = 0.35
ADAPT_TARGET = 0.6


def _ladder(ns_total: int, b_cols: int, top_k: int,
            ns: Optional[int] = None) -> Tuple[Tuple[int, ...], int]:
    """(rungs, pool) of the escalation ladder for ``ns_total`` subtiles
    and a ``b_cols``-query batch; ``ns`` overrides the first rung.

    The ceiling caps the candidate pool at 64K rows per query and
    shrinks inversely with the batch (the cap rung's live
    intermediates are [B, S]-shaped); queries that fail past it go to
    the terminal exact scan.  Shape (ns, 2ns, 8ns, cap): the 2x rung
    absorbs borderline misses at a quarter of the 8x rung's cost; each
    rung is cond-gated and costs nothing when it doesn't fire."""
    pool = _pool_for(ns_total)
    n_units = -(-ns_total // pool)
    unit = fp.SUB * pool
    ns = ns or _default_n_sub(top_k, n_units, unit)
    ns = min(ns, max(n_units - 1, 1))
    cap_rows = max(8192, 65536 * 512 // max(b_cols, 512))
    ns_cap = min(max(n_units - 1, 1), max(ns, cap_rows // unit))
    rungs = tuple(dict.fromkeys(
        [ns, min(ns * 2, ns_cap), min(ns * 8, ns_cap), ns_cap]))
    return rungs, pool


def _select_with_escalation(mins_nb, q2, table, codes_dev, n_valid,
                            top_k, n_sub=None, invalid=None,
                            engine=None):
    """Select + rerank with fully device-resident escalation: the whole
    ladder — first shot, escalation rungs, and the cond-gated terminal
    full exact scan — runs inside ONE jitted call
    (``fused_select_esc(final_exact=True)``), so results are exact by
    construction with zero host round-trips.  ``invalid`` marks
    queries whose mins are untrustworthy.  ``engine``: when given and
    ``n_sub`` is None, the first rung comes from ``engine.ns_hint``
    (per-index calibration) and grows in power-of-2 steps when the
    measured first-shot rate collapses.  Returns (d, rows,
    exact_frac_before_escalation)."""
    hint = getattr(engine, "ns_hint", None) if engine is not None \
        else None
    rungs, pool = _ladder(mins_nb.shape[0], int(mins_nb.shape[1]),
                          top_k, n_sub or hint)
    d, rows, ok, ok1 = fused_select_esc(
        mins_nb, q2, table, codes_dev, n_valid, top_k, rungs, pool,
        invalid=invalid, final_exact=True)
    first_frac = float(np.asarray(ok1).mean())
    ns, ns_cap = rungs[0], rungs[-1]
    if (engine is not None and n_sub is None
            and first_frac < ADAPT_GROW_BELOW and ns < ns_cap):
        engine.ns_hint = min(ns * 2, ns_cap)
    return d, rows, first_frac


class _FusedScan:
    """Shared codebook setup + query path of the fused engines: the
    subclass provides ``_codes()`` (the [N_pad, M] u8 codes the scan
    reads, N_pad a TILE multiple), ``n_valid`` and ``row_to_db``."""

    def _init_codebook(self, codewords: np.ndarray) -> None:
        codewords = np.asarray(codewords, np.float32)
        M, K, Ds = codewords.shape
        if K > 256:
            raise NotImplementedError(
                "fused tiers require K <= 256 (u8 codes); use the "
                "plain XLA scan for u16 codes")
        self.codewords = jnp.asarray(codewords)
        self.M, self.K, self.Ds = M, K, Ds
        self.D = M * Ds
        self.d_pad = fp.scan_width(self.D)
        self.mu = np.zeros(self.d_pad, np.float32)
        self.mu[:self.D] = fp.codebook_center(codewords)
        self.cb = fp.scan_codebook(codewords, self.mu[:self.D])

    def query(self, queries: np.ndarray, top_k: int = 10,
              n_sub: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        q, b = _pad_queries(queries, self.d_pad)
        table = adc_table(self.codewords, jnp.asarray(q[:, :self.D]))
        qc = jnp.asarray(q - self.mu[None, :])    # centred scan domain
        q2 = jnp.sum(qc * qc, axis=1)
        codes = self._codes()
        n_valid = jnp.int32(self.n_valid)
        mins = fp.scan_mins(qc.astype(jnp.bfloat16).T, self.cb, codes,
                            n_valid, self.M, self.K, self.Ds)
        d, rows, frac = _select_with_escalation(
            mins, q2, table, codes, n_valid, top_k, n_sub, engine=self)
        self.last_exact_frac = frac
        if self.row_to_db is not None:
            mapped = jnp.take(self.row_to_db,
                              jnp.clip(rows, 0, self.n_valid - 1))
            rows = jnp.where(rows >= 0, mapped, -1)  # keep padding
        return np.asarray(d[:b]), np.asarray(rows[:b])


class FusedCodesEngine(_FusedScan):
    """Plain-codes tier: M bytes/vec resident, the fused scan reads
    them directly (no decode) — the baseline compression is costed
    against."""

    def __init__(self, codewords: np.ndarray, codes: np.ndarray,
                 order: Optional[np.ndarray] = None):
        self._init_codebook(codewords)
        codes = np.asarray(codes)
        self.n_valid = codes.shape[0]
        if order is not None:
            codes = codes[np.asarray(order, np.int64)]
            self.row_to_db = jnp.asarray(_row_ids_i32(order))
        else:
            self.row_to_db = None
        n_pad = -(-self.n_valid // TILE) * TILE
        codes_p = np.zeros((n_pad, self.M), np.uint8)
        codes_p[:self.n_valid] = codes
        self.codes = jnp.asarray(codes_p)

    def _codes(self) -> jnp.ndarray:
        return self.codes


class FusedCompressedEngine(_FusedScan):
    """Compressed tier: stream tiles resident (~(1 + diffs/row) B/vec —
    the information content of the reference's DTC stream,
    ``deltapq_create_approx_tree.h:1765``); every query batch decodes
    them to codes on the device and runs the fused scan.

    Build from a DeltaTree (DFS order = tile order) or from raw codes
    plus an explicit scan order.
    """

    def __init__(self, codewords: np.ndarray, codes_scan: np.ndarray,
                 row_to_db: Optional[np.ndarray] = None):
        self._init_codebook(codewords)
        self._set_tiles(build_stream_tiles(np.asarray(codes_scan)),
                        row_to_db)

    def _set_tiles(self, tiles: StreamTiles,
                   row_to_db: Optional[np.ndarray]) -> None:
        self.tiles = tiles
        self.n_valid = tiles.n_valid
        self.row_data = jnp.asarray(tiles.row_data)
        self.vals = jnp.asarray(tiles.vals)
        self.meta = jnp.asarray(tiles.meta)
        self.row_to_db = (jnp.asarray(_row_ids_i32(row_to_db))
                          if row_to_db is not None else None)

    def _codes(self) -> jnp.ndarray:
        return decode_stream_device(self.row_data, self.vals, self.meta,
                                    self.M)

    @classmethod
    def from_tree(cls, codewords: np.ndarray, tree
                  ) -> "FusedCompressedEngine":
        codes_db = tree.decode_codes()
        codes_scan = codes_db[tree.vec_id.astype(np.int64)]
        return cls(codewords, codes_scan,
                   row_to_db=tree.vec_id.astype(np.int64))

    @classmethod
    def from_tiles(cls, codewords: np.ndarray, tiles: "StreamTiles",
                   row_to_db: Optional[np.ndarray] = None
                   ) -> "FusedCompressedEngine":
        """Engine over pre-built stream tiles.  Construction cost is
        the device upload only — the out-of-core path
        (``bigscale.ChunkedCompressedEngine``) uses this to stream
        host-resident chunks through the device per query batch (the
        reference's O_DIRECT refill, ``deltapq_create_approx_tree.h:
        2816-2822``)."""
        self = cls.__new__(cls)
        self._init_codebook(codewords)
        self._set_tiles(tiles, row_to_db)
        return self

    def bytes_per_vec(self) -> float:
        return self.tiles.bytes_per_vec()

    def _warmup_queries(self, b: int, seed: int = 0) -> np.ndarray:
        """Data-like queries (a decoded row + jitter): degenerate
        queries (e.g. zeros) sit in tie pileups and would drag the
        warmup through the terminal exact scan."""
        rng = np.random.default_rng(seed)
        cw = np.asarray(self.codewords)
        base = cw[np.arange(self.M), 0].reshape(-1)
        sd = float(cw.std()) or 1.0
        q = base[None, :] + rng.normal(
            size=(int(b), self.D)).astype(np.float32) * sd
        return q.astype(np.float32)

    def calibrate(self, top_k: int = 10, b: int = 128,
                  target: float = ADAPT_TARGET, rounds: int = 6
                  ) -> float:
        """Warmup-time certificate calibration: run sampled data-like
        query batches, measure the first-shot certificate pass rate on
        THIS index's tie density, and grow ``ns_hint`` (the first rung)
        until the rate clears ``target``.  Returns the final measured
        first-shot rate."""
        q = self._warmup_queries(b, seed=17)
        frac = 0.0
        for _ in range(rounds):
            before = getattr(self, "ns_hint", None)
            self.query(q, top_k=top_k)
            frac = self.last_exact_frac
            if frac >= target:
                break
            if getattr(self, "ns_hint", None) in (None, before):
                # adaptive step didn't fire (frac between GROW_BELOW
                # and target): take one explicit doubling
                ns_total = -(-self.n_valid // fp.SUB)
                pool = _pool_for(ns_total)
                n_units = -(-ns_total // pool)
                unit = fp.SUB * pool
                cur = (before
                       or _default_n_sub(top_k, n_units, unit))
                cap = min(max(n_units - 1, 1),
                          max(cur, 65536 // unit))
                if cur >= cap:
                    break
                self.ns_hint = min(cur * 2, cap)
        return frac

    def warmup(self, batch_sizes=(512,), top_k: int = 10,
               calibrate: bool = True) -> None:
        """Pre-compile the full query path (decode + scan + in-graph
        escalation ladder) for the given batch sizes, so a cold process
        serves its first wave at steady-state latency.  ``calibrate``
        sizes the certificate's first rung to the index's measured tie
        density first, so the batch-size compiles happen at the rung
        the steady state will actually use."""
        if calibrate:
            self.calibrate(top_k=top_k)
        for b in batch_sizes:
            self.query(self._warmup_queries(b), top_k=top_k)

    def save(self, path: str) -> None:
        """Persist the stream tiles + mapping (staged-artifact model,
        SURVEY §5): ~compressed size on disk, load is upload-only."""
        np.savez(path, row_data=self.tiles.row_data, vals=self.tiles.vals,
                 meta=self.tiles.meta, e_max=self.tiles.e_max,
                 n_valid=self.n_valid, M=self.M,
                 codewords=np.asarray(self.codewords),
                 row_to_db=(np.asarray(self.row_to_db)
                            if self.row_to_db is not None
                            else np.zeros(0, np.int32)))

    @classmethod
    def load(cls, path: str) -> "FusedCompressedEngine":
        import os
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"  # np.savez appends the suffix
        z = np.load(path, allow_pickle=False)
        tiles = StreamTiles(
            row_data=z["row_data"], vals=z["vals"], meta=z["meta"],
            n_valid=int(z["n_valid"]), M=int(z["M"]),
            e_max=int(z["e_max"]))
        rtd = z["row_to_db"]
        return cls.from_tiles(z["codewords"], tiles,
                              row_to_db=rtd if len(rtd) else None)


@functools.partial(jax.jit, static_argnames=("top_k",))
def exact_all_topk(table, codes_pad, n_valid, top_k):
    """Exact f32 ADC top-k over a SMALL code array, gather-free.

    dist[n, b] = sum_m T[b, m, codes[n, m]] computed as one matrix
    product: a query-independent one-hot [n_pad, M*K] (rebuilt per
    call; storing it would cost K bytes/row) contracted with the
    flattened tables [M*K, B].  Below ``EXACT_ALL_MAX_ROWS`` distinct
    rows the dedup tier reranks EVERYTHING this way.

    Precision: the one-hot operand is EXACT in bf16 (0/1), so instead
    of a Precision.HIGHEST f32 product the table is split into 3 bf16
    digits (h1 = bf16(t), h2 = bf16(t-h1), h3 = the rest) and
    contracted in 3 bf16 passes with f32 accumulation — every product
    is exact and the digit sum carries ~24 mantissa bits
    (f32-faithful)."""
    B, M, K = table.shape
    n_pad = codes_pad.shape[0]
    tf = table.reshape(B, M * K)
    iota = jax.lax.broadcasted_iota(jnp.int32, (n_pad, K), 1)
    oh = jnp.concatenate(
        [(codes_pad[:, m:m + 1].astype(jnp.int32) == iota
          ).astype(jnp.bfloat16) for m in range(M)], axis=1)
    tft = tf.T                                        # [M*K, B] f32
    # the digit split MUST use lax.reduce_precision, not bf16 casts:
    # under --xla_allow_excess_precision XLA folds
    # ``t - f32(bf16(t))`` to zero and the digits collapse to one bf16
    # pass (results quantized to the bf16 grid)
    h1 = jax.lax.reduce_precision(tft, 8, 7)
    r1 = tft - h1
    h2 = jax.lax.reduce_precision(r1, 8, 7)
    h3 = jax.lax.reduce_precision(r1 - h2, 8, 7)
    dall = (jnp.dot(oh, h1.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
            + jnp.dot(oh, h2.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
            + jnp.dot(oh, h3.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32))
    dall = jnp.where(
        jnp.arange(n_pad)[:, None] < n_valid, dall, jnp.inf)
    negd, ids = jax.lax.top_k(-dall.T, top_k)
    return -negd, ids


class DedupCompressedEngine:
    """Duplicate-code-collapsed compressed tier.

    Clustered datasets produce heavy PQ-code duplication, and identical
    codes have identical ADC distances.  The scan's cost is per ROW, so
    this tier scans each DISTINCT code once and expands row ids at
    result time: top-k distinct codes by exact distance always cover
    >= top_k rows (every distinct code has at least one row), so the
    expanded (distance, id) lists equal the full scan's up to the order
    among equal-distance duplicates — the same tie semantics as the
    reference's heap.  Reference counterpart: none; its DTC stream
    stores a duplicate in ~1.5 bytes but still walks it during every
    query (``deltapq_create_approx_tree.h:2876-2975``).

    Device-resident bytes = stream tiles over the distinct codes only;
    the row expansion (sorted permutation + CSR counts) lives on the
    host.
    """

    #: distinct-row count below which queries skip the shortlist
    #: ladder and rerank every distinct code in one exact f32 product
    #: (``exact_all_topk``); above it, the fused scan + certificate
    #: ladder amortizes better
    EXACT_ALL_MAX_ROWS = 65536

    #: distinct-row count above which the inner engine is chunked
    CHUNKED_MIN_ROWS = 32 * 1024 * 1024

    def __init__(self, codewords: np.ndarray, codes_db: np.ndarray,
                 chunked_min_rows: int = CHUNKED_MIN_ROWS,
                 mesh=None, shard_axis: str = "shard"):
        codes_db = np.asarray(codes_db)
        cwf = np.asarray(codewords, np.float32)
        self.codewords = jnp.asarray(cwf)
        self.M, _, self.Ds = cwf.shape
        self.D = self.M * self.Ds
        self.d_pad = fp.scan_width(self.D)
        order = np.lexsort(codes_db.T[::-1])
        sc = codes_db[order]
        new = np.ones(len(sc), bool)
        if len(sc) > 1:
            new[1:] = np.any(sc[1:] != sc[:-1], axis=1)
        self.starts = np.flatnonzero(new)
        self.counts = np.diff(np.append(self.starts, len(sc)))
        self.order = order
        self.n_rows = len(codes_db)
        self._unique_codes = sc[new]
        self._chunked_min_rows = chunked_min_rows
        self._mesh, self._shard_axis = mesh, shard_axis
        self._engine = None
        if mesh is None and self.n_unique <= self.EXACT_ALL_MAX_ROWS:
            n_pad = -(-self.n_unique // TILE) * TILE
            cp = np.zeros((n_pad, codes_db.shape[1]), np.uint8)
            cp[:self.n_unique] = sc[new]
            self._codes_pad = jnp.asarray(cp)
        else:
            self._codes_pad = None
            self.engine  # build eagerly: every query path needs it

    @property
    def engine(self):
        """Inner engine over the distinct codes, built LAZILY: below
        ``EXACT_ALL_MAX_ROWS`` distinct rows the query path is
        ``exact_all_topk`` and never touches it.  With a ``mesh``, the
        distinct-code scan shards over the devices
        (``ShardedCompressedEngine``) and only the row expansion stays
        on the host."""
        if self._engine is None:
            cw = np.asarray(self.codewords)
            if self._mesh is not None:
                from ..parallel.fused_sharded import \
                    ShardedCompressedEngine
                self._engine = ShardedCompressedEngine(
                    cw, self._unique_codes, self._mesh,
                    axis=self._shard_axis)
            elif self.n_unique > self._chunked_min_rows:
                from ..bigscale import ChunkedCompressedEngine
                self._engine = ChunkedCompressedEngine(
                    cw, self._unique_codes, resident=True)
            else:
                self._engine = FusedCompressedEngine(
                    cw, self._unique_codes)
        return self._engine

    @property
    def n_unique(self) -> int:
        return len(self.starts)

    def bytes_per_vec(self) -> float:
        """Device-resident bytes amortized over ALL rows."""
        return (self.engine.bytes_per_vec() * self.n_unique
                / max(self.n_rows, 1))

    def query(self, queries: np.ndarray, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        ku = min(top_k, self.n_unique)
        if self._codes_pad is not None:
            q, b = _pad_queries(np.asarray(queries, np.float32),
                                self.d_pad)
            table = adc_table(self.codewords,
                              jnp.asarray(q[:, :self.D]))
            d_u, i_u = exact_all_topk(table, self._codes_pad,
                                      jnp.int32(self.n_unique), ku)
            d_u, i_u = np.asarray(d_u[:b]), np.asarray(i_u[:b])
        else:
            d_u, i_u = self.engine.query(queries, top_k=ku)
        return self.expand(d_u, i_u, top_k)

    def warmup(self, batch_sizes=(512,), top_k: int = 10) -> None:
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            q = rng.normal(size=(int(b), self.D)).astype(np.float32)
            self.query(q, top_k=top_k)

    def expand(self, d_u: np.ndarray, i_u: np.ndarray, top_k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized row expansion: unique-code results (d_u [B, ku]
        distances, i_u [B, ku] unique ids, -1 padding) -> per-row
        (d [B, top_k], ids [B, top_k]).  Each output slot f maps to the
        unique j whose cumulative row count first exceeds f; ties among
        a code's duplicate rows surface in ``order`` order (the same
        arbitrary-among-equals semantics as the reference heap)."""
        d_u, i_u = np.asarray(d_u), np.asarray(i_u, np.int64)
        B, ku = i_u.shape
        cnt = np.where(i_u >= 0,
                       self.counts[np.clip(i_u, 0, None)], 0)
        csum = np.cumsum(cnt, axis=1)                      # inclusive
        f = np.arange(top_k)
        j = (csum[:, :, None] <= f[None, None, :]).sum(axis=1)
        valid = (j < ku) & (f[None, :] < csum[:, -1:])
        jc = np.minimum(j, ku - 1)
        prev = np.concatenate(
            [np.zeros((B, 1), csum.dtype), csum[:, :-1]], axis=1)
        within = f[None, :] - np.take_along_axis(prev, jc, axis=1)
        u = np.take_along_axis(i_u, jc, axis=1)
        # invalid slots (f beyond the expandable rows) carry clamped
        # indices that can run past the arrays; bound the gather and
        # let the ``valid`` mask blank them below
        idx = (self.starts[np.clip(u, 0, None)]
               + np.clip(within, 0, None))
        ids = self.order[np.minimum(idx, len(self.order) - 1)]
        d = np.take_along_axis(d_u, jc, axis=1)
        return (np.where(valid, d, np.inf).astype(np.float32),
                np.where(valid, ids, -1))
