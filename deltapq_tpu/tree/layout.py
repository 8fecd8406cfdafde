"""DeltaTree layout: edges -> DFS-ordered structure-of-arrays.

Behavioral re-implementation of
``edges_to_tree_index_approx_dfs_layout``
(``deltapq_create_approx_tree.h:1334-1487``):

1. parents array from edges;
2. CSR adjacency (``edges_to_adj_lists_approx``, ``:1067-1104``);
3. per-node max distance to descendants (``max_dists``) and max
   subtree-to-parent distance (``max_dist2p``) via ancestor-chain walks
   capped at 16 hops (``:1396-1417``), using the per-subspace K x K
   inter-centroid tables (``create_MKKTable``, ``pqbase.cpp:31-45``);
4. children sorted by descending ``max_dist2p`` (``:1421-1426``);
5. DFS numbering with per-node diff lists vs the parent
   (``dfs_node_layout``, ``:1156-1183``).

Instead of the reference's array-of-structs ``QNode`` (``:79-101``) the
result is a structure-of-arrays (columnar, device-friendly): dense per-node
columns plus a ragged diff array with CSR offsets.  The root stores its
full code as M pseudo-diffs with from = 255 sentinel (reference uses
from = -1, ``:1437-1445``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def mkk_tables(codewords: np.ndarray) -> np.ndarray:
    """Inter-centroid squared-L2 tables [M, K, K]
    (``PQBase::create_MKKTable``, ``pqbase.cpp:31-45``)."""
    cw = np.asarray(codewords, np.float32)
    M, K, Ds = cw.shape
    c2 = np.sum(cw * cw, axis=2)
    cross = np.einsum("mkd,mjd->mkj", cw, cw)
    return c2[:, :, None] - 2.0 * cross + c2[:, None, :]


def table_code_dists(tables: np.ndarray, codes: np.ndarray,
                     ids_a: np.ndarray, ids_b: np.ndarray) -> np.ndarray:
    """Approximate inter-code distance via the K x K tables
    (``cal_distance_by_tables``, ``deltapq_create_approx_tree.h:186-194``)."""
    M = codes.shape[1]
    out = np.zeros(len(ids_a), np.float32)
    ca = codes[ids_a]
    cb = codes[ids_b]
    for m in range(M):
        out += tables[m][ca[:, m].astype(np.int64), cb[:, m].astype(np.int64)]
    return out


@dataclass
class DeltaTree:
    """DFS-ordered DeltaTree (SoA).  Index 0 is the root pseudo-node."""

    vec_id: np.ndarray        # [N] uint32: database id at each DFS pos
    parent_pos: np.ndarray    # [N] int32: DFS pos of parent (-1 for root)
    depth: np.ndarray         # [N] uint8
    diff_num: np.ndarray      # [N] uint8 (root: M)
    diff_off: np.ndarray      # [N+1] int64 CSR offsets into diff arrays
    diff_m: np.ndarray        # [n_diffs_total] uint8 subspace index
    diff_to: np.ndarray       # [n_diffs_total] uint8/uint16 new centroid
    child_pos_start: np.ndarray  # [N] uint32 (reference QNode field)
    child_num: np.ndarray     # [N] uint32: number of DFS descendants
    max_dist: np.ndarray      # [N] float32 (sqrt'd, reference :1455)
    max_dist2p: np.ndarray    # [N] float32
    root_id: int
    M: int
    K: int

    @property
    def n(self) -> int:
        return len(self.vec_id)

    def decode_codes(self) -> np.ndarray:
        """Reconstruct the full [N_db, M] code array (losslessness check).

        Level-by-level: a node's code is its parent's code with its
        diffs applied; DFS positions are processed in index order, which
        guarantees parents come first.
        """
        n = self.n
        codes = np.zeros((n, self.M), dtype=self.diff_to.dtype)
        # apply diffs in DFS order; vectorize by depth levels: parents
        # always precede children in DFS order, and all nodes at depth d
        # have parents at depth < d.
        maxd = int(self.depth.max()) if n else 0
        for d in range(maxd + 1):
            sel = np.flatnonzero(self.depth == d)
            if d > 0:
                codes[sel] = codes[self.parent_pos[sel]]
            # scatter diffs of these nodes
            cnt = self.diff_num[sel].astype(np.int64)
            rows = np.repeat(sel, cnt)
            starts = self.diff_off[sel]
            flat = _ragged_indices(starts, cnt)
            codes[rows, self.diff_m[flat].astype(np.int64)] = self.diff_to[flat]
        out = np.empty_like(codes)
        out[self.vec_id.astype(np.int64)] = codes
        return out


def _ragged_indices(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat indices [sum(counts)] enumerating starts[i]..starts[i]+counts[i]."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    rep_starts = np.repeat(starts.astype(np.int64), counts)
    offs = np.arange(total, dtype=np.int64) - \
        np.repeat(np.cumsum(counts) - counts, counts)
    return rep_starts + offs


def ancestor_max_dists(codes: np.ndarray, parents: np.ndarray,
                       tables: np.ndarray, max_hops: int = 16):
    """Vectorized ancestor-chain walk (``:1396-1417``): for every node v
    and each of its first ``max_hops`` ancestors a, update
    ``max_dists[a] = max(.., d(v, a))`` and ``max_dist2p[prev] =
    max(.., d(v, a))`` where prev is the child of a on v's path."""
    n = len(parents)
    max_dists = np.zeros(n, np.float32)
    max_dist2p = np.zeros(n, np.float32)
    vids = np.arange(n, dtype=np.int64)
    prev = vids.copy()
    anc = parents.astype(np.int64)
    for _ in range(max_hops):
        mask = anc >= 0
        if not mask.any():
            break
        v = vids[mask]
        a = anc[mask]
        d = table_code_dists(tables, codes, v, a)
        np.maximum.at(max_dists, a, d)
        np.maximum.at(max_dist2p, prev[mask], d)
        prev = np.where(mask, anc, prev)
        anc = np.where(mask, parents[np.maximum(anc, 0)].astype(np.int64), -1)
    return max_dists, max_dist2p


def build_layout(codes: np.ndarray, edges: np.ndarray, root_id: int,
                 K: int, codewords: Optional[np.ndarray] = None,
                 tables=None, child_order: str = "dist") -> DeltaTree:
    """edges [E, 2] (parent, child) + root -> DFS SoA DeltaTree.

    tables: [M, K, K] inter-centroid distances, or the string "skip"
    for the big-N light build — the 16-hop ancestor distance walk and
    the max_dist2p child ordering are O(16 N) table lookups; skipping
    them zeroes the pruning bounds (unused by the tile-scan engines)
    and keeps children in natural order.

    child_order: sibling order within each node's child slice — free
    w.r.t. losslessness (any DFS of the same tree decodes the same
    codes).  "dist" = descending max_dist2p (reference pruning
    semantics, :1421-1426; natural order in light mode).  "code" =
    lexicographic by child code: consecutive DFS siblings then share
    changed-subspace patterns, which is what the sequential stream-tile
    format (``ops/stream_tiles.py``) compresses — use for the fused
    compressed tier.
    """
    codes = np.asarray(codes)
    n, M = codes.shape
    parents = np.full(n, -1, np.int64)
    if len(edges):
        parents[edges[:, 1].astype(np.int64)] = edges[:, 0]

    light = isinstance(tables, str) and tables == "skip"
    if tables is None and not light:
        if codewords is None:
            raise ValueError("need codewords or precomputed mkk tables")
        tables = mkk_tables(codewords)

    if light:
        max_dists = np.zeros(n, np.float32)
        max_dist2p = np.zeros(n, np.float32)
    else:
        max_dists, max_dist2p = ancestor_max_dists(codes, parents,
                                                   tables)

    # CSR adjacency with children sorted per child_order
    child = np.flatnonzero(parents >= 0)
    par = parents[child]
    if child_order == "code":
        ckeys = codes[child]
        order = np.lexsort(tuple(ckeys[:, m] for m in range(M - 1, -1, -1))
                           + (par,))
    else:
        order = np.lexsort((-max_dist2p[child], par))
    child_sorted = child[order]
    par_sorted = par[order]
    counts = np.bincount(par_sorted, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)])

    # iterative DFS producing the exact dfs_node_layout ordering;
    # C++ fast path (native/dtc_native.cpp dfs_layout) with a Python
    # explicit-stack fallback
    native_out = None
    try:
        from ..native import dfs_layout_native
        native_out = dfs_layout_native(
            n, child_sorted.astype(np.uint32), offsets.astype(np.int64),
            int(root_id))
    except Exception:
        native_out = None
    if native_out is not None:
        dfs_vec, dfs_parent, dfs_depth, pos_of = native_out
    else:
        dfs_vec = np.empty(n, np.uint32)
        dfs_parent = np.empty(n, np.int32)
        dfs_depth = np.empty(n, np.uint8)
        pos_of = np.empty(n, np.int64)
        dfs_vec[0] = root_id
        dfs_parent[0] = -1
        dfs_depth[0] = 0
        pos_of[root_id] = 0
        idx = 1
        cur = offsets.copy()
        stack_arr = np.empty(n + 1, np.int64)
        sp = 0
        stack_arr[0] = root_id
        while sp >= 0:
            v = stack_arr[sp]
            if cur[v] < offsets[v + 1]:
                c = child_sorted[cur[v]]
                cur[v] += 1
                dfs_vec[idx] = c
                dfs_parent[idx] = pos_of[v]
                dfs_depth[idx] = dfs_depth[pos_of[v]] + 1
                pos_of[c] = idx
                idx += 1
                sp += 1
                stack_arr[sp] = c
            else:
                sp -= 1
        assert idx == n, f"forest not reachable from root: {idx} != {n}"

    # child_pos_start / child_num (descendant count, :1160,:1182).
    # A DFS subtree of position i ends just before the next position with
    # depth <= depth[i]; depths are tiny (<= M*h+1) so one searchsorted
    # pass per depth level vectorizes the subtree-size computation.
    child_pos_start = np.arange(1, n + 1, dtype=np.uint32)
    depths_i64 = dfs_depth.astype(np.int64)
    subtree_end = np.full(n, n, np.int64)
    for d in range(int(depths_i64.max()) + 1):
        at_or_above = np.flatnonzero(depths_i64 <= d)
        mine = np.flatnonzero(depths_i64 == d)
        nxt = np.searchsorted(at_or_above, mine, side="right")
        subtree_end[mine] = np.where(nxt < len(at_or_above),
                                     at_or_above[np.minimum(nxt, len(at_or_above) - 1)],
                                     n)
    child_num = (subtree_end - np.arange(n) - 1).astype(np.uint32)

    # diffs vs parent code, in subspace order (:1169-1178); root stores
    # its full code as M pseudo-diffs (:1437-1445)
    codes_dfs = codes[dfs_vec.astype(np.int64)]
    parent_codes = np.empty_like(codes_dfs)
    parent_codes[0] = 0
    parent_codes[1:] = codes_dfs[dfs_parent[1:].astype(np.int64)]
    diff_mask = codes_dfs != parent_codes
    diff_mask[0] = True  # all M subspaces for the root
    diff_num = diff_mask.sum(axis=1).astype(np.uint8)
    diff_off = np.concatenate(
        [[0], np.cumsum(diff_num.astype(np.int64))])
    rows, cols = np.nonzero(diff_mask)
    diff_m = cols.astype(np.uint8)
    diff_to = codes_dfs[rows, cols]

    return DeltaTree(
        vec_id=dfs_vec, parent_pos=dfs_parent, depth=dfs_depth,
        diff_num=diff_num, diff_off=diff_off, diff_m=diff_m,
        diff_to=diff_to, child_pos_start=child_pos_start,
        child_num=child_num,
        max_dist=np.sqrt(max_dists[dfs_vec.astype(np.int64)]),
        max_dist2p=np.sqrt(max_dist2p[dfs_vec.astype(np.int64)]),
        root_id=int(root_id), M=M, K=K)
