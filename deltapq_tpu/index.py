"""High-level index facade: the product API of the framework.

Ties the pipeline together (codebook learning -> encoding -> DeltaTree
compression -> engine selection -> query) behind one object, with
persistence and **real incremental updates** — the reference only
simulates update byte costs (``update_query_processing_simulation``,
``deltapq_create_approx_tree.h:3646-3723``); here inserts/deletes are
served live: new vectors land in an uncompressed tail buffer scanned
alongside the compressed main index, deletes are masked, and the tree
is rebuilt once the tail outgrows ``rebuild_fraction``.

Example::

    idx = DeltaPQIndex.build(train_vecs, base_vecs, M=8, K=256)
    dists, ids = idx.search(queries, top_k=10)
    idx.add(new_vecs)
    idx.remove([3, 17])
    idx.save("index_dir")
    idx2 = DeltaPQIndex.load("index_dir")
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

ENGINES = ("auto", "xla", "fused_codes", "fused_compressed", "fused_dedup")


class DeltaPQIndex:
    def __init__(self, codewords: np.ndarray, codes: np.ndarray,
                 engine: str = "auto", tree_method: int = 1,
                 height: int = 1, rebuild_fraction: float = 0.2,
                 build_tree: bool = True):
        self.codewords = np.asarray(codewords, np.float32)
        self.M, self.K, self.Ds = self.codewords.shape
        self.codes = np.asarray(codes)
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
        self.engine = engine
        self.tree_method = tree_method
        self.height = height
        self.rebuild_fraction = rebuild_fraction
        self.tail = np.empty((0, self.M), self.codes.dtype)
        self.deleted = np.zeros(0, bool)  # lazily sized
        self.tree = None
        self._stream = None
        self._cached_codes = None  # device/scan cache, built lazily
        self._fused_engine = None
        self._engine_resolved = None  # "auto" resolution, per process
        if build_tree and self.K <= 256 and self.M <= 16 and len(codes):
            self._build_tree()

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, train_vecs: np.ndarray, base_vecs: np.ndarray,
              M: int = 8, K: int = 256, seed: int = 0,
              max_iters: int = 100, **kw) -> "DeltaPQIndex":
        import jax

        from .ops import pq_learn, pq_encode

        cw = pq_learn(jax.random.PRNGKey(seed), np.asarray(train_vecs),
                      M=M, K=K, max_iters=max_iters)
        codes = pq_encode(cw, np.asarray(base_vecs))
        return cls(cw, codes, **kw)

    def _build_tree(self):
        from .tree import find_edges_by_diff, build_layout, serialize_dtc

        res = find_edges_by_diff(self.codes, K=self.K,
                                 max_height_folds=self.height,
                                 method=self.tree_method)
        self.tree = build_layout(self.codes, res.edges, res.root_id,
                                 K=self.K, codewords=self.codewords)
        # the reference DTC byte format caps at M=8 (1-byte bitmap,
        # deltapq_create_approx_tree.h:36); for 8 < M <= 16 the tree
        # still drives the fused compressed tier's DFS scan order and
        # the stream tiles are the compressed at-rest format
        self._stream = (serialize_dtc(self.tree) if self.M <= 8
                        else None)

    # -- queries -----------------------------------------------------------

    @property
    def n(self) -> int:
        return len(self.codes) + len(self.tail)

    def _all_codes(self) -> np.ndarray:
        if len(self.tail):
            return np.concatenate([self.codes, self.tail])
        return self.codes

    def search(self, queries: np.ndarray, top_k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over main + tail, with deleted rows masked.

        The padded code array is cached on device across calls
        (invalidated by add/remove/compact); ``fetch`` is rounded up to
        a power of two so growing delete counts don't recompile the
        scan every call.
        """
        from .ops import query_plain

        engine = self.engine
        if engine == "auto":
            # resolve into a SEPARATE field: self.engine stays the
            # literal "auto" (and save() persists it), so a saved
            # index re-resolves on the host that loads it (a GPU-only
            # engine must not freeze into an index later loaded on
            # the CPU).  Invalidated together with _fused_engine on
            # add/compact.
            if getattr(self, "_engine_resolved", None) is None:
                self._engine_resolved = self._resolve_auto()
            engine = self._engine_resolved
        if engine in ("fused_codes", "fused_compressed", "fused_dedup"):
            return self._search_fused(queries, top_k, engine)
        q = np.asarray(queries, np.float32)
        fetch = top_k + int(self.deleted.sum())
        fetch = min(1 << (max(fetch, 1) - 1).bit_length(), self.n)
        fetch = min(max(fetch, top_k), self.n)  # never exceed rows
        if self._cached_codes is None:
            self._cached_codes = self._all_codes()
        d, i = query_plain(self.codewords, q, self._cached_codes,
                           top_k=fetch)
        if self.deleted.any():
            dele = np.flatnonzero(self.deleted)
            bad = np.isin(i, dele)
            d = np.where(bad, np.inf, d)
            order = np.argsort(d, axis=1, kind="stable")
            d = np.take_along_axis(d, order, axis=1)
            i = np.take_along_axis(i, order, axis=1)
        if fetch < top_k:  # top_k > live rows: pad explicitly
            pad = top_k - fetch
            d = np.concatenate(
                [d, np.full((len(d), pad), np.inf, d.dtype)], axis=1)
            i = np.concatenate(
                [i, np.full((len(i), pad), -1, i.dtype)], axis=1)
        d, i = d[:, :top_k], i[:, :top_k]
        # rows that ran out of live candidates (mass deletes) are
        # marked invalid explicitly instead of returning deleted ids
        i = np.where(np.isinf(d), -1, i)
        return d, i

    def _resolve_auto(self, backend: str = None) -> str:
        """Resolve engine="auto" once, at first search.

        On the GPU the product tier is the fused compressed engine; the
        dedup tier takes over when the DISTINCT-code count fits the
        exact-all regime (every distinct code reranked in one f32
        product, ``DedupCompressedEngine.EXACT_ALL_MAX_ROWS`` — a
        crossover not yet measured on the GPU).  u16 codes (K > 256) and
        M > 16 have no fused tier and take the plain XLA scan.  On the
        CPU (tests) the plain XLA scan stays: the fused kernel only
        runs interpreted there."""
        from .ops.fused import DedupCompressedEngine
        from .platform import on_gpu

        if not on_gpu(backend):
            return "xla"
        if self.K > 256 or self.M > 16 or not len(self.codes):
            return "xla"
        codes = self._all_codes()
        n_unique = len(np.unique(codes, axis=0))
        if n_unique <= DedupCompressedEngine.EXACT_ALL_MAX_ROWS:
            return "fused_dedup"
        return "fused_compressed"

    def _search_fused(self, queries, top_k, engine=None):
        """Fused-engine search path: the engine object is cached and
        rebuilt lazily after add/remove/compact."""
        engine = engine or self.engine
        if getattr(self, "_fused_engine", None) is None:
            from .ops.fused import (DedupCompressedEngine,
                                    FusedCodesEngine,
                                    FusedCompressedEngine)

            codes = self._all_codes()
            if engine == "fused_codes":
                self._fused_engine = FusedCodesEngine(
                    self.codewords, codes)
            elif engine == "fused_dedup":
                self._fused_engine = DedupCompressedEngine(
                    self.codewords, np.asarray(codes))
            elif self.tree is not None and len(self.tail) == 0:
                self._fused_engine = FusedCompressedEngine.from_tree(
                    self.codewords, self.tree)
            else:
                order = np.lexsort(np.asarray(codes).T[::-1])
                self._fused_engine = FusedCompressedEngine(
                    self.codewords, np.asarray(codes)[order],
                    row_to_db=order)
        # over-fetch so masked (deleted) rows cannot truncate results
        k_eff = min(top_k + int(self.deleted.sum()), self.n)
        d, i = self._fused_engine.query(np.asarray(queries, np.float32),
                                        top_k=k_eff)
        i = i.astype(np.int64)
        if self.deleted.any():
            dele = np.flatnonzero(self.deleted)
            bad = np.isin(i, dele)
            d = np.where(bad, np.inf, d)
            order = np.argsort(d, axis=1, kind="stable")
            d = np.take_along_axis(d, order, axis=1)
            i = np.take_along_axis(i, order, axis=1)
        if d.shape[1] < top_k:
            pad = top_k - d.shape[1]
            d = np.concatenate(
                [d, np.full((len(d), pad), np.inf, d.dtype)], axis=1)
            i = np.concatenate(
                [i, np.full((len(i), pad), -1, i.dtype)], axis=1)
        i = np.where(np.isinf(d), -1, i)
        return d[:, :top_k], i[:, :top_k]

    # -- updates -----------------------------------------------------------

    def add(self, vecs: np.ndarray) -> np.ndarray:
        """Insert vectors; returns their ids.  New codes go to the
        uncompressed tail; the tree is rebuilt when the tail exceeds
        ``rebuild_fraction`` of the index."""
        from .ops import pq_encode

        new_codes = pq_encode(self.codewords, np.asarray(vecs))
        ids = np.arange(self.n, self.n + len(new_codes))
        self.tail = np.concatenate([self.tail, new_codes])
        self._cached_codes = None
        self._fused_engine = None
        self._engine_resolved = None  # dup factor may have changed
        if len(self.tail) > self.rebuild_fraction * max(len(self.codes), 1):
            self.compact()
        return ids

    def remove(self, ids) -> None:
        """Mask rows as deleted (compacted out at the next rebuild)."""
        ids = np.asarray(ids, np.int64)
        if len(self.deleted) < self.n:
            self.deleted = np.concatenate(
                [self.deleted, np.zeros(self.n - len(self.deleted), bool)])
        self.deleted[ids] = True

    def compact(self) -> None:
        """Fold the tail into the main code array, drop deleted rows,
        and rebuild the DeltaTree.  NOTE: row ids change (compaction);
        callers needing stable ids should keep their own id map."""
        all_codes = self._all_codes()
        if len(self.deleted):
            mask = np.ones(len(all_codes), bool)
            mask[:len(self.deleted)] &= ~self.deleted
            all_codes = all_codes[mask]
        self.codes = all_codes
        self.tail = np.empty((0, self.M), self.codes.dtype)
        self.deleted = np.zeros(0, bool)
        self._fused_engine = None
        self._cached_codes = None
        self._engine_resolved = None  # dup factor may have changed
        if self.K <= 256 and self.M <= 16 and len(self.codes):
            self._build_tree()

    # -- stats / persistence ----------------------------------------------

    def stats(self) -> dict:
        out = {"n": self.n, "n_main": len(self.codes),
               "n_tail": len(self.tail),
               "n_deleted": int(self.deleted.sum()),
               "plain_bytes": int(self.n * self.codes.itemsize * self.M)}
        if self._stream is not None:
            out["compressed_bytes"] = len(self._stream)
            out["bytes_per_vec"] = round(
                len(self._stream) / max(len(self.codes), 1), 3)
        eng = getattr(self, "_fused_engine", None)
        if eng is not None and hasattr(eng, "bytes_per_vec"):
            # resident stream-tile footprint (M > 8 has no DTC stream;
            # the tiles are the compressed representation)
            out["delta_tile_bytes_per_vec"] = round(
                eng.bytes_per_vec(), 3)
        return out

    def save(self, path: str) -> None:
        # fold tail/deletes in first: the persisted DTC stream and tree
        # SoA must describe exactly the persisted code rows (otherwise
        # a load would see tree.n != len(codes) and stats/bytes_per_vec
        # would describe a stale subset)
        if len(self.tail) or (len(self.deleted) and self.deleted.any()):
            self.compact()
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "index.npz"),
                 codewords=self.codewords, codes=self._all_codes(),
                 deleted=self.deleted)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"engine": self.engine, "method": self.tree_method,
                       "height": self.height, "M": self.M, "K": self.K},
                      f)
        if self._stream is not None:
            from .tree import write_dtc

            write_dtc(os.path.join(path, "compressed.dtc"), self.tree)
            t = self.tree
            np.savez(os.path.join(path, "tree_soa.npz"),
                     vec_id=t.vec_id, parent_pos=t.parent_pos,
                     depth=t.depth, diff_num=t.diff_num,
                     diff_off=t.diff_off, diff_m=t.diff_m,
                     diff_to=t.diff_to,
                     child_pos_start=t.child_pos_start,
                     child_num=t.child_num, max_dist=t.max_dist,
                     max_dist2p=t.max_dist2p, root_id=t.root_id,
                     M=t.M, K=t.K)

    @classmethod
    def load(cls, path: str) -> "DeltaPQIndex":
        z = np.load(os.path.join(path, "index.npz"))
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        idx = cls(z["codewords"], z["codes"], engine=cfg["engine"],
                  tree_method=cfg["method"], height=cfg["height"],
                  build_tree=False)
        soa = os.path.join(path, "tree_soa.npz")
        if os.path.exists(soa):
            from .tree.layout import DeltaTree
            from .tree import serialize_dtc

            t = np.load(soa)
            idx.tree = DeltaTree(
                vec_id=t["vec_id"], parent_pos=t["parent_pos"],
                depth=t["depth"], diff_num=t["diff_num"],
                diff_off=t["diff_off"], diff_m=t["diff_m"],
                diff_to=t["diff_to"],
                child_pos_start=t["child_pos_start"],
                child_num=t["child_num"], max_dist=t["max_dist"],
                max_dist2p=t["max_dist2p"], root_id=int(t["root_id"]),
                M=int(t["M"]), K=int(t["K"]))
            idx._stream = serialize_dtc(idx.tree)
        if len(z["deleted"]):
            idx.deleted = z["deleted"]
        return idx
