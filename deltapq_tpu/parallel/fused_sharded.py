"""Sharded compressed-tier query: the fused engine over a device mesh.

Each shard holds the stream tiles of one contiguous slice of the scan
order (split on TILE boundaries, so every shard's stream is
self-contained and no cross-shard decode state exists), decodes them on
its device, runs the fused scan and the full escalation ladder —
``fused_select_esc(final_exact=True)``, terminal exact scan included —
on its rows, and the per-shard exact top-k lists merge with one
all-gather.  Every shard's list is exact, so the merged result is the
plain scan's (modulo equal-distance ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import fused_pallas as fp
from ..ops.adc import adc_table
from ..ops.fused import _FusedScan, _ladder, _pad_queries, \
    fused_select_esc
from ..ops.stream_tiles import (GROUP, TILE, build_stream_tiles,
                                decode_stream_device, full_planes)


def make_sharded_stream_query_fn(mesh: Mesh, top_k: int, rungs, pool,
                                 M: int, K: int, Ds: int, rows_local: int,
                                 axis: str = "shard"):
    """Returns a jitted fn (q [D_pad, B] bf16 centred, q2 [B], table
    [B, M, K], cb, row_data, vals, meta, n_valid [S] i32) ->
    (dists [B, top_k], rows [B, top_k] global scan rows, ok1 [S, B]
    first-shot certificates) with the stream arrays sharded along
    their leading axis."""
    n_shards = mesh.devices.size

    def body(q, q2, table, cb, rd, vals, meta, nv):
        idx = jax.lax.axis_index(axis).astype(jnp.int32)
        codes = decode_stream_device(rd, vals, meta[0], M)
        n_valid = nv[0]
        mins = fp.scan_mins(q, cb, codes, n_valid, M, K, Ds)
        d, rows, _ok, ok1 = fused_select_esc(
            mins, q2, table, codes, n_valid, top_k, rungs, pool,
            final_exact=True)
        rows = jnp.where((rows >= 0) & jnp.isfinite(d),
                         rows + idx * rows_local, -1)
        all_d = jax.lax.all_gather(d, axis)       # [S, B, k]
        all_r = jax.lax.all_gather(rows, axis)
        B = d.shape[0]
        cat_d = jnp.moveaxis(all_d, 0, 1).reshape(B, n_shards * top_k)
        cat_r = jnp.moveaxis(all_r, 0, 1).reshape(B, n_shards * top_k)
        neg, pos = jax.lax.top_k(-cat_d, top_k)
        return (-neg, jnp.take_along_axis(cat_r, pos, axis=1),
                jax.lax.all_gather(ok1, axis))

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis), P(axis), P(axis),
                  P(axis)),
        out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(mapped)


class ShardedCompressedEngine(_FusedScan):
    """Compressed engine sharded over a 1-D mesh: one stream per shard.

    Query = replicated table build + per-shard decode, fused scan and
    exact escalation ladder + all-gather top-k merge.
    """

    def __init__(self, codewords: np.ndarray, codes_scan: np.ndarray,
                 mesh: Mesh, row_to_db: Optional[np.ndarray] = None,
                 axis: str = "shard"):
        self._init_codebook(codewords)
        self.mesh, self.axis = mesh, axis
        S = mesh.devices.size
        codes_scan = np.asarray(codes_scan, np.uint8)
        self.n_valid = n = len(codes_scan)
        nt = -(-n // TILE)
        per_t = max(1, -(-nt // S))                 # tiles per shard
        self.rows_local = per = per_t * TILE
        parts = []
        for s in range(S):
            part = codes_scan[s * per:(s + 1) * per]
            parts.append(build_stream_tiles(part) if len(part) else None)
        P_ = (self.M + 7) // 8
        a_max = max(st.vals.shape[0] for st in parts if st is not None)
        rd = np.zeros((S, per_t, P_, TILE), np.uint8)
        # padding tiles: a full first row reading stream position 0
        # (rows past n_valid are masked, so its values never matter)
        rd[:, :, :, 0] = full_planes(self.M)
        vals = np.zeros((S, a_max, 8, 128), np.uint8)
        meta = np.zeros((S, 2, per_t), np.int32)
        nv = np.zeros(S, np.int32)
        self._nbytes = 0
        for s, st in enumerate(parts):
            if st is None:
                continue
            nt = st.n_tiles
            rd[s, :nt] = st.row_data
            vals[s, :st.vals.shape[0]] = st.vals
            meta[s, :, :nt] = st.meta
            nv[s] = st.n_valid
            self._nbytes += st.nbytes()
        assert a_max * GROUP < 2 ** 31
        sh = NamedSharding(mesh, P(axis))
        self.row_data = jax.device_put(rd.reshape(S * per_t, P_, TILE), sh)
        self.vals = jax.device_put(vals.reshape(S * a_max, 8, 128), sh)
        self.meta = jax.device_put(meta, sh)
        self.nv = jax.device_put(nv, sh)
        self.row_to_db = (np.asarray(row_to_db, np.int64)
                          if row_to_db is not None else None)
        self._fns = {}

    def bytes_per_vec(self) -> float:
        """Resident stream-tile bytes per vector (summed over shards)."""
        return self._nbytes / max(self.n_valid, 1)

    def query(self, queries: np.ndarray, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        q, b = _pad_queries(queries, self.d_pad)
        table = adc_table(self.codewords, jnp.asarray(q[:, :self.D]))
        qc = jnp.asarray(q - self.mu[None, :])
        q2 = jnp.sum(qc * qc, axis=1)
        rungs, pool = _ladder(self.rows_local // fp.SUB, q.shape[0],
                              top_k)
        key = (top_k, rungs, pool)
        if key not in self._fns:
            self._fns[key] = make_sharded_stream_query_fn(
                self.mesh, top_k, rungs, pool, self.M, self.K, self.Ds,
                self.rows_local, self.axis)
        d, rows, ok1 = self._fns[key](
            qc.astype(jnp.bfloat16).T, q2, table, self.cb,
            self.row_data, self.vals, self.meta, self.nv)
        self.last_exact_frac = float(jnp.mean(
            jnp.all(ok1, axis=0)[:b]))
        rows = np.asarray(rows[:b]).astype(np.int64)
        if self.row_to_db is not None:
            mapped = self.row_to_db[np.clip(rows, 0, self.n_valid - 1)]
            rows = np.where(rows >= 0, mapped, -1)  # keep padding
        return np.asarray(d[:b]), rows
