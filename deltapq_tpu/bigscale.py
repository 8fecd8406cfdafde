"""Big-N (10^8+) single-device pipeline: chunked encode, partitioned
tree build, compressed-tier query.

The reference reaches N~1.5B only by streaming 4KB blocks from disk
through a sequential scanner (``deltapq_create_approx_tree.h:
2805-2984``, ``N < INT_MAX`` cap at ``:982``).  Here *host* memory is
bounded by chunked generation/encoding and *device* memory by the
compressed tile representation (~3 B/vec resident + per-batch scratch:
the decoded codes and the subtile minima of one chunk):

* ``encode_stream``      — encode a vector stream chunk-by-chunk on
  the device; only codes (M B/vec) accumulate on the host.
* ``build_partitioned``  — lexicographic global sort, split into P
  contiguous partitions, build an independent DeltaTree per partition
  (a process pool covers all cores; partitions are the unit of
  restartability), concatenate the per-partition DFS orders.  Delta
  tiles are TILE-self-contained, so partition boundaries cost nothing.
* ``BigCompressedIndex`` — the fused compressed engine over the
  concatenated order, with database-id mapping.
"""

from __future__ import annotations

import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np


def encode_stream(codewords: np.ndarray,
                  chunks: Iterable[np.ndarray]) -> np.ndarray:
    """Encode a stream of vector chunks; returns codes [N, M] u8/u16.
    Host memory holds only the accumulated codes (M bytes/vec), never
    the full vector set (the reference's streaming encode loop,
    ``main.cpp:369-389``)."""
    from .ops import pq_encode

    out: List[np.ndarray] = []
    for x in chunks:
        out.append(pq_encode(codewords, x, batch_size=262144))
    return np.concatenate(out, axis=0)


def _build_one_partition(args):
    """Worker: edges + DFS layout for one contiguous code partition.
    Returns the DFS permutation *local to the partition* plus stats."""
    codes_part, K, method = args
    from .tree.build import find_edges_by_diff
    from .tree.layout import build_layout

    t0 = time.time()
    res = find_edges_by_diff(codes_part, K=K, method=method)
    t1 = time.time()
    tree = build_layout(codes_part, res.edges, res.root_id, K=K,
                        tables="skip")
    t2 = time.time()
    return (tree.vec_id.astype(np.int64), res.n_diffs,
            t1 - t0, t2 - t1)


@dataclass
class BigBuildStats:
    n: int
    n_parts: int
    n_diffs: int
    t_sort: float
    t_build: float
    per_part: List[Tuple[float, float]] = field(default_factory=list)


def build_partitioned(codes: np.ndarray, n_parts: int = 16,
                      K: int = 256, method: int = 1, workers: int = 2
                      ) -> Tuple[np.ndarray, BigBuildStats]:
    """Global lex sort + per-partition DeltaTree DFS orders.

    Returns (row_to_db [N] i64: scan row -> database id, stats).  The
    scan order is the concatenation of each partition's DFS order; use
    ``codes[row_to_db]`` as the tile packer's input.
    """
    n, M = codes.shape
    t0 = time.time()
    order = np.lexsort(codes.T[::-1]).astype(np.int64)
    t_sort = time.time() - t0
    bounds = np.linspace(0, n, n_parts + 1).astype(np.int64)

    t0 = time.time()
    jobs = []
    for p in range(n_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        jobs.append((np.ascontiguousarray(codes[order[lo:hi]]), K,
                     method))
    results = []
    if workers > 1 and n_parts > 1:
        # spawn (not fork): the parent's JAX runtime is multithreaded
        # and fork risks deadlock in the children
        import multiprocessing as mp

        from .platform import cpu_only_worker

        with ProcessPoolExecutor(
                max_workers=workers, initializer=cpu_only_worker,
                mp_context=mp.get_context("spawn")) as ex:
            results = list(ex.map(_build_one_partition, jobs))
    else:
        results = [_build_one_partition(j) for j in jobs]
    t_build = time.time() - t0

    row_to_db = np.empty(n, np.int64)
    n_diffs = 0
    per_part = []
    for p, (vec_id_local, nd, te, tl) in enumerate(results):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        row_to_db[lo:hi] = order[lo:hi][vec_id_local]
        n_diffs += nd
        per_part.append((te, tl))
    stats = BigBuildStats(n=n, n_parts=n_parts, n_diffs=n_diffs,
                          t_sort=t_sort, t_build=t_build,
                          per_part=per_part)
    return row_to_db, stats


class BigCompressedIndex:
    """Compressed-tier index over a partition-concatenated scan order.

    Thin composition: ``build_partitioned`` + ``FusedCompressedEngine``
    (stream tiles resident on device, decoded per query batch).
    Beyond ``2 * chunk_rows`` rows the engine is a resident
    ``ChunkedCompressedEngine``, which bounds the per-batch scratch.
    """

    def __init__(self, codewords: np.ndarray, codes: np.ndarray,
                 n_parts: int = 16, method: int = 1, workers: int = 2,
                 batch_b: int = 128, chunk_rows: Optional[int] = None):
        from .ops.fused import FusedCompressedEngine

        K = codewords.shape[1]
        self.row_to_db, self.build_stats = build_partitioned(
            np.asarray(codes), n_parts=n_parts, K=K, method=method,
            workers=workers)
        codes_scan = np.asarray(codes)[self.row_to_db]
        n = len(codes_scan)
        if chunk_rows is None:
            chunk_rows = ChunkedCompressedEngine.CHUNK_ROWS
        if n > 2 * chunk_rows:
            self.engine = ChunkedCompressedEngine(
                codewords, codes_scan, row_to_db=self.row_to_db,
                chunk_rows=chunk_rows, resident=True)
        else:
            self.engine = FusedCompressedEngine(
                codewords, codes_scan, row_to_db=self.row_to_db)
        self.batch_b = batch_b

    def bytes_per_vec(self) -> float:
        return self.engine.bytes_per_vec()

    def warmup(self, batch_sizes=(128,), top_k: int = 10) -> None:
        """Pre-compile + certificate-calibrate the query path: serve
        after warmup, not on a cold first query."""
        if hasattr(self.engine, "warmup"):
            self.engine.warmup(batch_sizes, top_k=top_k)

    def query(self, queries: np.ndarray, top_k: int = 10):
        return self.engine.query(queries, top_k=top_k)


class ChunkedCompressedEngine:
    """Compressed tier split into row chunks — the out-of-core /
    beyond-HBM query path.

    The reference queries N~1.5e9 by streaming the DTC byte stream
    from disk in 4KB O_DIRECT blocks per query
    (``deltapq_create_approx_tree.h:2805-2984``, ``:2816-2822``).  Here
    stream tiles live in HOST memory (numpy), and each query batch
    uploads one chunk at a time, scans it with the fused kernel,
    selects exact per-chunk top-k, and merges across chunks (top-k of
    the concatenated candidates — exact, since per-chunk results are
    exact).  ``resident=True`` keeps every chunk's tiles on device
    (upload once); chunking then bounds the per-batch scratch (one
    chunk's decoded codes and subtile minima at a time).

    Exactness: each chunk engine reranks in exact f32 with its own
    certificate/escalation, so the merged top-k equals the plain-scan
    top-k (modulo equal-distance ties, as in the reference).
    """

    #: default rows per chunk (multiple of the kernel TILE)
    CHUNK_ROWS = 16 * 1024 * 1024

    def __init__(self, codewords: np.ndarray, codes_scan: np.ndarray,
                 row_to_db: Optional[np.ndarray] = None,
                 chunk_rows: int = CHUNK_ROWS,
                 resident: bool = True, mesh=None,
                 shard_axis: str = "shard"):
        from .ops.fused import FusedCompressedEngine

        n = len(codes_scan)
        chunk_rows = max(1024, (chunk_rows // 1024) * 1024)
        self.resident = resident
        self.chunks: List = []
        self._host: List = []
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            ids = (np.asarray(row_to_db)[lo:hi]
                   if row_to_db is not None
                   else np.arange(lo, hi, dtype=np.int64))
            if mesh is not None:
                # multi-chip form: each chunk's tiles shard over the
                # mesh (chunks stream sequentially as ever; every
                # chunk scan is a sharded all-gather-merged query)
                from .parallel.fused_sharded import \
                    ShardedCompressedEngine
                self.chunks.append(ShardedCompressedEngine(
                    np.asarray(codewords), codes_scan[lo:hi], mesh,
                    row_to_db=ids, axis=shard_axis))
            elif resident:
                self.chunks.append(FusedCompressedEngine(
                    codewords, codes_scan[lo:hi], row_to_db=ids))
            else:
                # defer tile upload to query time: store numpy tiles
                from .ops.stream_tiles import build_stream_tiles
                self._host.append((build_stream_tiles(
                    codes_scan[lo:hi]), ids))
        self.codewords = np.asarray(codewords, np.float32)
        if mesh is not None:
            self.resident = True  # sharded chunks live on the mesh

    def bytes_per_vec(self) -> float:
        if self.resident:
            tot = sum(e.bytes_per_vec() * e.n_valid
                      for e in self.chunks)
            nv = sum(e.n_valid for e in self.chunks)
        else:
            tot = sum(st.row_data.nbytes + st.vals.nbytes
                      for st, _ in self._host)
            nv = sum(st.n_valid for st, _ in self._host)
        return tot / max(nv, 1)

    def save(self, path: str) -> None:
        """Persist every chunk's stream tiles + id map as raw files
        (``StreamTiles.save``), reopenable with ``from_saved`` —
        including memory-mapped, for datasets beyond host RAM."""
        import json
        import os

        os.makedirs(path, exist_ok=True)
        items = (self.chunks if self.resident else self._host)
        n = base = 0
        for i, item in enumerate(items):
            st = item.tiles if self.resident else item[0]
            ids = (item.row_to_db if self.resident else item[1])
            ids = (np.asarray(ids) if ids is not None
                   else np.arange(base, base + st.n_valid,
                                  dtype=np.int64))
            base += st.n_valid
            cdir = os.path.join(path, f"chunk_{i:04d}")
            st.save(cdir)
            ids.astype(np.int64).tofile(os.path.join(cdir, "ids.i64"))
            n += 1
        np.save(os.path.join(path, "codewords.npy"), self.codewords)
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump({"n_chunks": n}, f)

    @classmethod
    def from_saved(cls, path: str, mmap: bool = True,
                   resident: bool = False, mesh=None,
                   shard_axis: str = "shard"
                   ) -> "ChunkedCompressedEngine":
        """Reopen a saved chunked engine.  ``mmap=True`` +
        ``resident=False`` is the beyond-host-RAM mode: tiles stay on
        disk, each query batch streams them chunk-by-chunk through
        the chip (the reference's per-query O_DIRECT refill,
        ``deltapq_create_approx_tree.h:2816-2822``, as a page-cache
        -backed upload instead of a 4KB read loop).  ``mesh``: shard
        each chunk's scan over devices (BASELINE config-5 topology —
        disk-backed chunks x a device mesh)."""
        import json
        import os

        from .ops.fused import FusedCompressedEngine
        from .ops.stream_tiles import StreamTiles, decode_stream_tiles

        with open(os.path.join(path, "header.json")) as f:
            h = json.load(f)
        self = cls.__new__(cls)
        self.codewords = np.load(os.path.join(path, "codewords.npy"))
        self.resident = resident
        if mesh is not None:
            from .parallel.fused_sharded import ShardedCompressedEngine

            self.chunks, self._host = [], []
            for i in range(int(h["n_chunks"])):
                cdir = os.path.join(path, f"chunk_{i:04d}")
                st = StreamTiles.load(cdir, mmap=mmap)
                ids = np.fromfile(os.path.join(cdir, "ids.i64"),
                                  np.int64)
                self.chunks.append(ShardedCompressedEngine(
                    self.codewords, decode_stream_tiles(st), mesh,
                    row_to_db=ids, axis=shard_axis))
            self.resident = True  # sharded chunks live on the mesh
            return self
        self.chunks, self._host = [], []
        for i in range(int(h["n_chunks"])):
            cdir = os.path.join(path, f"chunk_{i:04d}")
            st = StreamTiles.load(cdir, mmap=mmap)
            ids = np.fromfile(os.path.join(cdir, "ids.i64"), np.int64)
            if resident:
                self.chunks.append(FusedCompressedEngine.from_tiles(
                    self.codewords, st, row_to_db=ids))
            else:
                self._host.append((st, ids))
        return self

    def warmup(self, batch_sizes=(128,), top_k: int = 10,
               calibrate: bool = True) -> None:
        """Pre-compile + certificate-calibrate: the
        first chunk calibrates its first-rung size on its measured tie
        density; the hint seeds every other chunk (same data
        distribution — each still adapts individually afterwards).
        Non-resident chunks are ephemeral, so the hint lives on the
        chunked engine and is re-applied per upload."""
        from .ops.fused import FusedCompressedEngine

        if self.resident:
            if not self.chunks:
                return
            e0 = self.chunks[0]
            if calibrate and hasattr(e0, "calibrate"):
                e0.calibrate(top_k=top_k)
                hint = getattr(e0, "ns_hint", None)
                if hint:
                    for e in self.chunks[1:]:
                        e.ns_hint = hint
            for e in self.chunks:
                if hasattr(e, "warmup"):
                    try:
                        e.warmup(batch_sizes, top_k=top_k,
                                 calibrate=False)
                    except TypeError:  # sharded engine: no calibrate
                        e.warmup(batch_sizes, top_k=top_k)
        elif self._host:
            st, ids = self._host[0]
            eng = FusedCompressedEngine.from_tiles(
                self.codewords, st, row_to_db=ids)
            if calibrate:
                eng.calibrate(top_k=top_k)
                self.ns_hint = getattr(eng, "ns_hint", None)
            eng.warmup(batch_sizes, top_k=top_k, calibrate=False)

    def query(self, queries: np.ndarray, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        from .ops.fused import FusedCompressedEngine

        parts_d, parts_i = [], []
        if self.resident:
            engines = self.chunks
        else:
            # upload one chunk at a time (the O_DIRECT-refill analog);
            # device arrays are dropped after each chunk's scan
            engines = (FusedCompressedEngine.from_tiles(
                self.codewords, st, row_to_db=ids)
                for st, ids in self._host)
        hint = getattr(self, "ns_hint", None)
        for eng in engines:
            if not self.resident and hint:
                eng.ns_hint = hint
            d, i = eng.query(queries, top_k=top_k)
            if not self.resident:
                # carry adaptation across ephemeral chunk engines
                hint = self.ns_hint = getattr(eng, "ns_hint", hint)
            parts_d.append(d)
            parts_i.append(i)
        d_all = np.concatenate(parts_d, axis=1)
        i_all = np.concatenate(parts_i, axis=1)
        order = np.argsort(d_all, axis=1, kind="stable")[:, :top_k]
        return (np.take_along_axis(d_all, order, axis=1),
                np.take_along_axis(i_all, order, axis=1))
