"""DTC compressed-code serialization, byte-exact with the reference.

Format (``qnodes_to_compressed_codes_opt``,
``deltapq_create_approx_tree.h:1730-1845``), K <= 256:

- file header: ``int64 n_codes, int64 n_bytes``;
- stream: M root code bytes; then the N-1 non-root nodes in DFS order,
  packed two per depth byte: ``[depth1 | depth2<<4][bitmap1][tos1...]
  [bitmap2][tos2...]``; a final odd node stores its depth in a full
  byte.  ``bitmap`` bit m set <=> subspace m differs from the parent;
  the ``diff_num`` following bytes are the new centroid ids in ascending
  subspace order.  Total stream length ``n_bytes = M + n_diffs +
  (3*(N-1)+1)/2`` (``:1765``, for M=8).

The sequential diff index (``create_diff_index``, ``:1972-2053``) deltas
each code against the *previous code in file order* (no tree):
``[bitmap][changed bytes...]`` per code after an M-byte first code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .layout import DeltaTree, _ragged_indices


def _bitmaps_from_diffs(diff_num, diff_off, diff_m, n_nodes) -> np.ndarray:
    """Per-node bitmap byte from ragged diff subspace indices."""
    cnt = diff_num.astype(np.int64)
    flat = _ragged_indices(diff_off[:n_nodes], cnt)
    rows = np.repeat(np.arange(n_nodes, dtype=np.int64), cnt)
    bm = np.zeros(n_nodes, np.uint8)
    np.bitwise_or.at(bm, rows, (1 << diff_m[flat].astype(np.uint16))
                     .astype(np.uint8))
    return bm


def serialize_dtc(tree: DeltaTree, auto_repair: bool = True) -> bytes:
    """DeltaTree -> DTC byte stream (without the 16-byte file header).

    The paired-depth byte stores two 4-bit nibbles (``:1781-1788``), so
    depth must be <= 15; deeper trees (reachable with ``-h > 1``) are
    **repaired in place** when ``auto_repair``: center re-root +
    chain-halving (``tree/reroot.py:repair_tree``, the ``adjust_trees``
    / ``rotate_trees`` semantics of ``pqbase.cpp:72-286``).  The repair
    MUTATES ``tree``'s fields so the caller's object stays consistent
    with the emitted stream (DFS order changes).  The reference
    silently corrupts in this case (and even masks depth ``&7`` on
    read, ``:2883``).
    """
    n = tree.n
    M = tree.M
    if tree.K > 256:
        raise NotImplementedError("DTC byte format is defined for K<=256 "
                                  "(reference stores one byte per diff)")
    if M > 8:
        raise NotImplementedError(
            "DTC bitmap is a single byte (reference NUM_DIM=8, "
            "deltapq_create_approx_tree.h:36); M>8 cannot round-trip")
    if n > 1 and int(tree.depth.max()) > 15:
        if not auto_repair:
            raise ValueError(
                f"tree depth {int(tree.depth.max())} exceeds the DTC "
                f"format's 4-bit depth nibble (max 15); rebuild with a "
                f"smaller -h or re-root (tree/reroot.py)")
        from .reroot import repair_tree

        repaired = repair_tree(tree, max_depth=15)
        for f in ("vec_id", "parent_pos", "depth", "diff_num",
                  "diff_off", "diff_m", "diff_to", "child_pos_start",
                  "child_num", "max_dist", "max_dist2p", "root_id"):
            setattr(tree, f, getattr(repaired, f))
    # per-node (DFS pos 1..n-1) record sizes
    nd = tree.diff_num[1:].astype(np.int64)       # [n-1]
    j = np.arange(n - 1, dtype=np.int64)          # node index within stream
    depth_byte = np.where(j % 2 == 0, 1, 0)       # first of pair carries depth
    if (n - 1) % 2 == 1:
        depth_byte[-1] = 1                        # odd leftover: own byte
    sizes = depth_byte + 1 + nd
    offs = M + np.concatenate([[0], np.cumsum(sizes)])[:-1]
    total = M + int(np.sum(sizes))
    out = np.zeros(total, np.uint8)

    # root code
    out[:M] = tree.diff_to[:M].astype(np.uint8)

    depths = tree.depth[1:].astype(np.uint8)
    # paired depth bytes
    even = j[j % 2 == 0]
    pair_even = even[even + 1 < n - 1]
    d1 = depths[pair_even]
    d2 = depths[pair_even + 1]
    out[offs[pair_even]] = d1 | (d2 << 4)
    if (n - 1) % 2 == 1:
        out[offs[-1]] = depths[-1]

    # bitmaps
    bm = _bitmaps_from_diffs(tree.diff_num, tree.diff_off, tree.diff_m, n)[1:]
    out[offs + depth_byte] = bm

    # diff "to" bytes
    starts = tree.diff_off[1:n]
    flat = _ragged_indices(starts, nd)
    rep_off = np.repeat(offs + depth_byte + 1, nd)
    intra = np.arange(int(nd.sum()), dtype=np.int64) - \
        np.repeat(np.cumsum(nd) - nd, nd)
    out[rep_off + intra] = tree.diff_to[flat].astype(np.uint8)
    return out.tobytes()


def write_dtc(path: str, tree: DeltaTree) -> None:
    stream = serialize_dtc(tree)
    with open(path, "wb") as f:
        np.int64(tree.n).tofile(f)
        np.int64(len(stream)).tofile(f)
        f.write(stream)


def read_dtc_raw(path: str) -> Tuple[int, np.ndarray]:
    with open(path, "rb") as f:
        n_codes = int(np.fromfile(f, np.int64, 1)[0])
        n_bytes = int(np.fromfile(f, np.int64, 1)[0])
        stream = np.fromfile(f, np.uint8, n_bytes)
    return n_codes, stream


def deserialize_dtc(stream: np.ndarray, n_codes: int, M: int,
                    use_native: bool = True,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a DTC stream -> (depth [N], bitmap [N], diff_to ragged,
    diff_off [N+1]).  Position 0 is the root (depth 0, bitmap 0xff for
    M=8 semantics: all M subspaces).

    The stream is inherently sequential (record sizes are
    data-dependent), mirroring the reference decoder's pointer walk
    (``query_processing_..._in_memory``, ``:3786-3858``); the C++
    parser (native/dtc_native.cpp) is used when available, with this
    Python loop as fallback.
    """
    if use_native:
        try:
            from ..native import dtc_parse_native
            out = dtc_parse_native(stream, n_codes, M)
            if out is not None:
                return out
        except Exception:
            pass
    stream = np.asarray(stream, np.uint8)
    depths = np.zeros(n_codes, np.uint8)
    bitmaps = np.zeros(n_codes, np.uint8)
    diff_tos = []
    diff_counts = np.zeros(n_codes, np.int64)

    popcount = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                             axis=1).sum(axis=1).astype(np.int64)
    root_code = stream[:M]
    diff_tos.append(root_code)
    diff_counts[0] = M
    bitmaps[0] = (1 << M) - 1 if M < 8 else 0xFF
    off = M
    i = 1
    while i + 1 < n_codes:
        dbyte = int(stream[off]); off += 1
        # reference masks with &7 on read (:3793) but writes 4-bit
        # nibbles (:1782); we keep the write semantics and mask &15.
        d1 = dbyte & 0x0F
        d2 = (dbyte >> 4) & 0x0F
        bm = int(stream[off]); off += 1
        nd = popcount[bm]
        depths[i] = d1
        bitmaps[i] = bm
        diff_counts[i] = nd
        diff_tos.append(stream[off:off + nd]); off += nd
        bm = int(stream[off]); off += 1
        nd = popcount[bm]
        depths[i + 1] = d2
        bitmaps[i + 1] = bm
        diff_counts[i + 1] = nd
        diff_tos.append(stream[off:off + nd]); off += nd
        i += 2
    if i == n_codes - 1:
        depths[i] = int(stream[off]); off += 1
        bm = int(stream[off]); off += 1
        nd = popcount[bm]
        bitmaps[i] = bm
        diff_counts[i] = nd
        diff_tos.append(stream[off:off + nd]); off += nd
    diff_off = np.concatenate([[0], np.cumsum(diff_counts)])
    return depths, bitmaps, np.concatenate(diff_tos), diff_off


def decode_dtc_to_codes(stream: np.ndarray, n_codes: int, M: int,
                        use_native: bool = True) -> np.ndarray:
    """Full lossless decode of a DTC stream to the [N, M] code array
    (row order = DFS order; use the tree's vec_id to map to db order).

    Uses the depth-stack discipline of the reference decoder: DFS order
    means a node's parent state lives at stack[depth-1].  Prefers the
    C++ decoder (native/dtc_native.cpp).
    """
    if use_native:
        try:
            from ..native import dtc_decode_native
            out = dtc_decode_native(stream, n_codes, M)
            if out is not None:
                return out
        except Exception:
            pass
    depths, bitmaps, diff_to, diff_off = deserialize_dtc(
        stream, n_codes, M, use_native=False)
    codes = np.zeros((n_codes, M), np.uint8)
    stack = np.zeros((16 + 2, M), np.uint8)
    stack[0] = diff_to[:M]
    codes[0] = stack[0]
    # per-byte decoder LUT: bitmap -> subspace list (reference builds the
    # same 256-entry table at deltapq_approx_tree_main.cpp:312-325)
    lut = [np.flatnonzero([(b >> m) & 1 for m in range(8)])
           for b in range(256)]
    for i in range(1, n_codes):
        d = int(depths[i])
        row = stack[d - 1].copy()
        ms = lut[int(bitmaps[i])]
        s, e = diff_off[i], diff_off[i + 1]
        row[ms] = diff_to[s:e]
        stack[d] = row
        codes[i] = row
    return codes


# --------------------------------------------------------------------------
# Sequential diff index (no tree) — create_diff_index (:1972-2053)
# --------------------------------------------------------------------------

def serialize_diff_index(codes: np.ndarray) -> bytes:
    """Delta each code vs the previous code in file order."""
    codes = np.asarray(codes)
    n, M = codes.shape
    if codes.dtype == np.uint16:
        wide = True
    else:
        wide = False
    diff_mask = np.zeros((n, M), bool)
    diff_mask[0] = False
    diff_mask[1:] = codes[1:] != codes[:-1]
    nd = diff_mask[1:].sum(axis=1).astype(np.int64)
    bytes_per_diff = 2 if wide else 1
    sizes = 1 + nd * bytes_per_diff
    offs = M * bytes_per_diff + np.concatenate([[0], np.cumsum(sizes)])[:-1]
    total = M * bytes_per_diff + int(sizes.sum())
    out = np.zeros(total, np.uint8)
    if wide:
        out[:2 * M] = codes[0].astype("<u2").view(np.uint8)
    else:
        out[:M] = codes[0]
    # bitmaps
    bits = (diff_mask[1:].astype(np.uint16) <<
            np.arange(M, dtype=np.uint16)[None, :]).sum(axis=1)
    out[offs] = bits.astype(np.uint8)
    rows, cols = np.nonzero(diff_mask[1:])
    vals = codes[1:][rows, cols]
    intra = np.arange(len(rows), dtype=np.int64) - \
        np.repeat(np.cumsum(nd) - nd, nd)
    if wide:
        v16 = vals.astype("<u2").view(np.uint8).reshape(-1, 2)
        out[offs[rows] + 1 + 2 * intra] = v16[:, 0]
        out[offs[rows] + 2 + 2 * intra] = v16[:, 1]
    else:
        out[offs[rows] + 1 + intra] = vals.astype(np.uint8)
    return out.tobytes()


def write_diff_index(path: str, codes: np.ndarray) -> None:
    stream = serialize_diff_index(codes)
    with open(path, "wb") as f:
        np.int64(len(codes)).tofile(f)
        np.int64(len(stream)).tofile(f)
        f.write(stream)


def decode_diff_index(stream: np.ndarray, n_codes: int, M: int,
                      K: int = 256) -> np.ndarray:
    """Lossless decode of the sequential diff index."""
    stream = np.asarray(stream, np.uint8)
    wide = K > 256
    popcount = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                             axis=1).sum(axis=1).astype(np.int64)
    lut = [np.flatnonzero([(b >> m) & 1 for m in range(8)])
           for b in range(256)]
    dtype = np.uint16 if wide else np.uint8
    codes = np.zeros((n_codes, M), dtype)
    if wide:
        codes[0] = stream[:2 * M].view("<u2")
        off = 2 * M
    else:
        codes[0] = stream[:M]
        off = M
    for i in range(1, n_codes):
        bm = int(stream[off]); off += 1
        nd = popcount[bm]
        row = codes[i - 1].copy()
        ms = lut[bm]
        if wide:
            row[ms] = stream[off:off + 2 * nd].view("<u2")
            off += 2 * nd
        else:
            row[ms] = stream[off:off + nd]
            off += nd
        codes[i] = row
    return codes


def block_aware_size(tree: "DeltaTree", block_bytes: int = 4096) -> dict:
    """Block-aware packing simulation (reference method 4,
    ``qnodes_to_compressed_codes_opt_block_aware``,
    ``deltapq_create_approx_tree.h:1846-1970``): pack DFS node records
    greedily into fixed blocks (each block also stores a 10-bit node
    count + the entry node's full code so blocks decode independently);
    returns the block count and total bytes (measurement only — the
    reference stub prints and exits)."""
    n = tree.n
    M = tree.M
    nd = tree.diff_num[1:].astype(np.int64)
    # per node: ~0.5B shared depth nibble + 1B bitmap + diffs
    rec = 1.5 + 1 + nd
    header = 2 + M  # 10-bit count (2B) + entry code
    blocks = 1
    used = header + M  # first block carries the root code
    for r in rec:
        if used + r > block_bytes:
            blocks += 1
            used = header
        used += r
    return {"blocks": blocks, "bytes": blocks * block_bytes,
            "plain_bytes": n * M}


# --------------------------------------------------------------------------
# Legacy bit-level format — qnodes_to_compressed_codes (:1498-1596)
# --------------------------------------------------------------------------

def serialize_bits(tree: "DeltaTree") -> Tuple[bytes, int]:
    """Legacy bit format: per node (root included) 3-bit depth +
    8-bit bitmap + 8 bits per diff "to", bits packed LSB-first.
    Returns (bytes, n_bits).  n_bits = 8*n_diffs + 11*N + 64-ish
    (the reference formula hardcodes the root's 64 code bits for M=8;
    we emit the root like any node, which matches its writer loop)."""
    n, M = tree.n, tree.M
    if M > 8:
        raise NotImplementedError("bit format bitmap is 8 bits")
    bm = _bitmaps_from_diffs(tree.diff_num, tree.diff_off, tree.diff_m, n)
    bits = []
    depth = tree.depth.astype(np.uint8)
    nd = tree.diff_num.astype(np.int64)
    # per node bit payload: depth(3) + bitmap(8) + 8*nd
    total_bits = int(3 * n + 8 * n + 8 * nd.sum())
    out = np.zeros(total_bits, np.uint8)
    pos = 0
    for i in range(n):
        d = int(depth[i])
        out[pos:pos + 3] = [(d >> j) & 1 for j in range(3)]
        pos += 3
        b = int(bm[i])
        out[pos:pos + 8] = [(b >> j) & 1 for j in range(8)]
        pos += 8
        s, e = tree.diff_off[i], tree.diff_off[i + 1]
        for v in tree.diff_to[s:e]:
            v = int(v)
            out[pos:pos + 8] = [(v >> j) & 1 for j in range(8)]
            pos += 8
    packed = np.packbits(out, bitorder="little")
    return packed.tobytes(), total_bits


def deserialize_bits(stream: bytes, n_bits: int, n_codes: int, M: int
                     ) -> np.ndarray:
    """Decode the legacy bit format back to [N, M] codes in DFS order."""
    bits = np.unpackbits(np.frombuffer(stream, np.uint8),
                         bitorder="little")[:n_bits]
    codes = np.zeros((n_codes, M), np.uint8)
    stack = np.zeros((16, M), np.uint8)
    pos = 0

    def take(k):
        nonlocal pos
        v = 0
        for j in range(k):
            v |= int(bits[pos + j]) << j
        pos += k
        return v

    for i in range(n_codes):
        d = take(3)
        bm = take(8)
        row = stack[d - 1].copy() if i else np.zeros(M, np.uint8)
        for m in range(8):
            if bm & (1 << m):
                row[m] = take(8)
        stack[d] = row
        codes[i] = row
    return codes


# --------------------------------------------------------------------------
# Row-store variant — row_store_qnodes_to_compressed_codes_opt (:1598-1729)
# --------------------------------------------------------------------------

def serialize_dtc_row_store(tree: "DeltaTree", raw_vectors: np.ndarray
                            ) -> bytes:
    """DTC byte format with each node's raw vector bytes interleaved
    after its record (for systems that co-locate raw data with codes;
    reference row-store variant).  raw_vectors: [N_db, D] uint8 (bvecs
    semantics), indexed by database id."""
    from io import BytesIO

    n, M = tree.n, tree.M
    raw = np.asarray(raw_vectors, np.uint8)
    base = serialize_dtc(tree)
    # re-walk the record layout of serialize_dtc to interleave vectors
    depths, bitmaps, diff_to, diff_off = deserialize_dtc(
        np.frombuffer(base, np.uint8), n, M, use_native=False)
    out = BytesIO()
    stream = np.frombuffer(base, np.uint8)
    off = M
    out.write(stream[:M].tobytes())
    out.write(raw[tree.vec_id[0]].tobytes())
    i = 1
    while i + 1 < n:
        out.write(stream[off:off + 1].tobytes()); off += 1  # depth byte
        for half in range(2):
            ndiff = int(diff_off[i + half + 1] - diff_off[i + half])
            out.write(stream[off:off + 1 + ndiff].tobytes())
            off += 1 + ndiff
            out.write(raw[tree.vec_id[i + half]].tobytes())
        i += 2
    if i == n - 1:
        ndiff = int(diff_off[i + 1] - diff_off[i])
        out.write(stream[off:off + 2 + ndiff].tobytes())
        out.write(raw[tree.vec_id[i]].tobytes())
    return out.getvalue()


def deserialize_dtc_row_store(stream: bytes, n_codes: int, M: int,
                              d_raw: int):
    """Decode the row-store stream back to (codes [N, M] u8 DFS order,
    raw vectors [N, d_raw] u8 DFS order) — the read side of
    ``serialize_dtc_row_store`` (reference row-store scan,
    ``deltapq_create_approx_tree.h:3453-3645``, which skips the raw
    bytes during the distance pass and fetches them for winners)."""
    s = np.frombuffer(stream, np.uint8)
    codes = np.zeros((n_codes, M), np.uint8)
    raw = np.zeros((n_codes, d_raw), np.uint8)
    stack = np.zeros((17, M), np.uint8)
    off = 0
    codes[0] = s[off:off + M]
    stack[0] = codes[0]
    off += M
    raw[0] = s[off:off + d_raw]
    off += d_raw
    i = 1
    while i < n_codes:
        pair = min(2, n_codes - i)
        depth_byte = int(s[off]); off += 1
        depths = [depth_byte & 0xF, (depth_byte >> 4) & 0xF]
        for half in range(pair):
            d = depths[half] if pair == 2 or half == 0 else 0
            bm = int(s[off]); off += 1
            row = stack[d - 1].copy()
            for m in range(M):
                if bm & (1 << m):
                    row[m] = s[off]; off += 1
            stack[d] = row
            codes[i + half] = row
            raw[i + half] = s[off:off + d_raw]
            off += d_raw
        i += pair
    return codes, raw


def query_row_store(stream: bytes, n_codes: int, M: int, d_raw: int,
                    codewords: np.ndarray, queries: np.ndarray,
                    vec_id: np.ndarray, top_k: int = 10):
    """Query over the row-store stream: decode (lossless), plain ADC
    scan, and return the winners' co-located raw vectors — the
    reference's row-store value proposition (``:3453-3645``).

    Returns (dists [B, k], db_ids [B, k], raw_rows [B, k, d_raw] u8).
    """
    from ..ops.adc import query_plain

    codes, raw = deserialize_dtc_row_store(stream, n_codes, M, d_raw)
    d, rows = query_plain(codewords, queries, codes, top_k=top_k)
    vid = np.asarray(vec_id, np.int64)
    ids = vid[rows]
    return d, ids, raw[rows]


def query_bits(stream: bytes, n_bits: int, n_codes: int, M: int,
               codewords: np.ndarray, queries: np.ndarray,
               vec_id: np.ndarray, top_k: int = 10):
    """Query over the legacy bit-format stream (reference
    ``query_processing_scan_compressed_codes``, ``:2193-2302``):
    lossless decode then plain ADC scan — identical distances by
    construction.  Returns (dists, db_ids)."""
    from ..ops.adc import query_plain

    codes = deserialize_bits(stream, n_bits, n_codes, M)
    d, rows = query_plain(codewords, queries, codes, top_k=top_k)
    return d, np.asarray(vec_id, np.int64)[rows]
