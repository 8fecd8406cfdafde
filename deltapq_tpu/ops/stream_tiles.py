"""Stream-tile format: packed variable-length delta compression.

Each row stores exactly what the reference's DTC byte stream stores per
node (bitmap + the changed bytes, ``qnodes_to_compressed_codes_opt``,
``deltapq_create_approx_tree.h:1730-1845``), re-linearized so a whole
tile decodes in parallel:

* ``row_data`` [nT, P, TILE] u8 — per-row changed-subspace mask planes
  (P = ceil(M/8)), diff vs the previous scan row; the first row of
  every tile is stored full (all-ones mask) so tiles stay
  self-contained;
* ``vals``     — ONE packed byte stream of all diff values in row-major
  (row, subspace) order, each tile's segment 8-aligned.  Stream
  position p lives at ``vals[p // 1024, p % 8, (p // 8) % 128]``;
* ``meta``     [2, nT] i32 — per tile the 1024-value group ``w0`` and
  in-group start offset ``rem`` (multiple of 8).

Size = P + mean(diffs/row) + ~1% padding bytes per vector — the
information-theoretic shape of the reference stream (its
``n_bytes = 8 + n_diffs + 1.5(N-1)``, ``:1765``) with the depth nibble
replaced by tile self-containment.

``decode_stream_device`` is the on-device decode (plain XLA: a
flattened prefix sum gives every stored value's stream position, a
per-column running max forward-fills unchanged subspaces, one gather
reads the values); ``decode_stream_tiles`` is its NumPy oracle.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

TILE = 1024
GROUP = 1024          # values per window group (vals.shape = [A, 8, 128])


def _n_gather(M: int) -> int:
    """8-value chunks a single row's values can span (offset 0..7 +
    up to M values)."""
    return (7 + M + 7) // 8


def window_groups(M: int, e_max: int) -> int:
    """Trailing GROUP-value groups the stream is padded with past the
    last tile's start group: rem < GROUP plus e_max values plus the
    chunks one row's values can span."""
    max_e_idx = (GROUP - 8 + e_max) // 8 + _n_gather(M)
    return max_e_idx // 128 + 1


@dataclass
class StreamTiles:
    """Device-ready packed delta stream (scan order = DFS)."""

    row_data: np.ndarray   # u8 [nT, P, TILE] mask planes
    vals: np.ndarray       # u8 [A_tot, 8, 128] chunked value stream
    meta: np.ndarray       # i32 [2, nT]: (w0 group, rem values)
    n_valid: int
    M: int
    e_max: int             # max per-tile segment length (values)

    @property
    def n_planes(self) -> int:
        return (self.M + 7) // 8

    @property
    def n_tiles(self) -> int:
        return self.row_data.shape[0]

    @property
    def n_pad(self) -> int:
        return self.n_tiles * TILE

    def nbytes(self) -> int:
        return self.row_data.nbytes + self.vals.nbytes

    def bytes_per_vec(self) -> float:
        return self.nbytes() / max(self.n_valid, 1)

    def save(self, path: str) -> None:
        """Persist tiles as raw arrays + a small header so they can be
        reopened with ``load`` (RAM) or ``load(mmap=True)`` (disk-
        backed, the reference's O_DIRECT-stream analog for datasets
        beyond host RAM, ``deltapq_create_approx_tree.h:2816-2822``)."""
        import json
        import os

        os.makedirs(path, exist_ok=True)
        self.row_data.tofile(os.path.join(path, "row_data.u8"))
        self.vals.tofile(os.path.join(path, "vals.u8"))
        self.meta.astype(np.int32).tofile(os.path.join(path,
                                                       "meta.i32"))
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump({"row_data_shape": list(self.row_data.shape),
                       "vals_shape": list(self.vals.shape),
                       "meta_shape": list(self.meta.shape),
                       "n_valid": self.n_valid, "M": self.M,
                       "e_max": self.e_max}, f)

    @classmethod
    def load(cls, path: str, mmap: bool = False) -> "StreamTiles":
        """Reopen saved tiles.  ``mmap=True`` maps ``row_data``/``vals``
        from disk read-only: host RAM holds only pages the query path
        touches, so an index larger than RAM still serves (upload to
        device streams straight from the page cache)."""
        import json
        import os

        with open(os.path.join(path, "header.json")) as f:
            h = json.load(f)
        opener = ((lambda p, sh: np.memmap(p, np.uint8, "r",
                                           shape=tuple(sh)))
                  if mmap else
                  (lambda p, sh: np.fromfile(p, np.uint8)
                   .reshape(sh)))
        rd = opener(os.path.join(path, "row_data.u8"),
                    h["row_data_shape"])
        vals = opener(os.path.join(path, "vals.u8"), h["vals_shape"])
        meta = np.fromfile(os.path.join(path, "meta.i32"), np.int32
                           ).reshape(h["meta_shape"])
        return cls(row_data=rd, vals=vals, meta=meta,
                   n_valid=int(h["n_valid"]), M=int(h["M"]),
                   e_max=int(h["e_max"]))


#: one engine's packed value stream must stay addressable with int32
#: positions on the device (the decode's prefix sums and the [2, nT]
#: i32 meta): 2^31 values.  SIFT1B-scale datasets (~3e9
#: values at ~2 diffs/row, BASELINE config 5) MUST go through
#: ``bigscale.ChunkedCompressedEngine`` — 16M-row chunks carry ~50M
#: values each, 40x under this bound (``test_config5_capacity_math``).  The reference has the same class of
#: cap: N < INT_MAX (``deltapq_create_approx_tree.h:982``).
MAX_STREAM_VALUES = 2 ** 31


def check_stream_capacity(n_values_padded: int) -> None:
    """Explicit capacity guard: fail loudly instead of silently
    wrapping an i32 offset."""
    if n_values_padded >= MAX_STREAM_VALUES:
        raise ValueError(
            f"packed value stream needs {n_values_padded} values; one "
            f"engine's i32 device addressing caps at "
            f"{MAX_STREAM_VALUES}.  Split the index with "
            f"bigscale.ChunkedCompressedEngine (16M-row chunks keep "
            f"each stream ~40x under the bound).")


def _mask_planes(bits: np.ndarray) -> np.ndarray:
    """[N, M] bool -> [N, ceil(M/8)] uint8 planes: plane p bit j set
    iff bits[:, 8p + j]."""
    n, M = bits.shape
    P = (M + 7) // 8
    out = np.zeros((n, P), np.uint8)
    for p in range(P):
        sub = bits[:, 8 * p:8 * p + 8]
        w = (1 << np.arange(sub.shape[1], dtype=np.uint32))[None, :]
        out[:, p] = (sub.astype(np.uint32) * w).sum(axis=1).astype(
            np.uint8)
    return out


def full_planes(M: int) -> np.ndarray:
    """All-ones mask planes ([P] u8): a row stored in full."""
    P = (M + 7) // 8
    return np.array([(1 << min(8, M - 8 * p)) - 1 for p in range(P)],
                    np.uint8)


def _mask_bits(c: np.ndarray) -> np.ndarray:
    """Sequential-diff bits [n_pad, M] with tile-first rows full."""
    n_pad, _ = c.shape
    prev = np.empty_like(c)
    prev[0] = 0
    prev[1:] = c[:-1]
    bits = c != prev
    bits[(np.arange(n_pad) % TILE) == 0] = True
    return bits


def build_stream_tiles(codes: np.ndarray) -> StreamTiles:
    """Pack scan-ordered codes [N, M] u8 (M <= 16, K <= 256) into
    stream tiles.  Padding rows (to a TILE multiple) repeat the last
    row (zero diffs) and are masked at query time via n_valid."""
    codes = np.asarray(codes, np.uint8)
    n, M = codes.shape
    if M > 16:
        raise NotImplementedError("stream tiles require M <= 16 "
                                  "(2 mask planes); use the codes tier")
    P = (M + 7) // 8
    n_pad = -(-n // TILE) * TILE
    c = np.concatenate([codes, np.repeat(codes[-1:], n_pad - n, axis=0)]
                       ) if n_pad != n else codes
    nt = n_pad // TILE

    bits = _mask_bits(c)
    nd = bits.sum(axis=1).astype(np.int64)

    mask = _mask_planes(bits)                               # [n_pad, P]
    row_data = np.ascontiguousarray(
        mask.reshape(nt, TILE, P).transpose(0, 2, 1))

    # per-tile segment bases (8-aligned) and row offsets
    nd_t = nd.reshape(nt, TILE)
    e_t = nd_t.sum(axis=1)
    e_pad = -(-e_t // 8) * 8
    base = np.zeros(nt, np.int64)
    base[1:] = np.cumsum(e_pad)[:-1]
    w0 = (base // GROUP).astype(np.int32)
    rem = (base % GROUP).astype(np.int32)
    off_in_tile = (np.cumsum(nd_t, axis=1) - nd_t)          # exclusive

    # global value positions, row-major (row asc, subspace asc)
    rows, cols = np.nonzero(bits)
    j = (np.cumsum(bits, axis=1) - bits)[rows, cols]        # rank in row
    tile_of = rows // TILE
    p = base[tile_of] + off_in_tile[tile_of, rows % TILE] + j

    e_max = int(max(e_t.max() if nt else 0, 8))
    w_a = window_groups(M, e_max)
    # covers the furthest group any tile's segment reaches
    a_tot = int(base[-1]) // GROUP + w_a
    check_stream_capacity(a_tot * GROUP)
    flat = np.zeros(a_tot * GROUP, np.uint8)
    flat[(p // GROUP) * GROUP + (p % 8) * 128 + (p // 8) % 128] = \
        c[rows, cols]
    vals = flat.reshape(a_tot, 8, 128)

    return StreamTiles(row_data=row_data, vals=vals,
                       meta=np.stack([w0, rem]).astype(np.int32),
                       n_valid=n, M=M, e_max=e_max)


def decode_stream_tiles(st: StreamTiles) -> np.ndarray:
    """NumPy oracle for ``decode_stream_device``: reconstruct the
    scan-ordered [n_valid, M] codes from mask planes + packed value
    stream via per-row rank/offset arithmetic + forward fill."""
    nt, P, T = st.row_data.shape
    M = st.M
    planes = st.row_data.astype(np.uint32)                  # [nT, P, T]
    bit = np.stack(
        [(planes[:, m // 8, :] >> (m % 8)) & 1 for m in range(M)],
        axis=2).astype(np.int64)                            # [nT, T, M]
    rank = np.cumsum(bit, axis=2) - bit
    nd = bit.sum(axis=2)                                    # [nT, T]
    off = np.cumsum(nd, axis=1) - nd

    flat = st.vals.reshape(-1)
    base = (st.meta[0].astype(np.int64) * GROUP
            + st.meta[1].astype(np.int64))

    t_i, r_i, m_i = np.nonzero(bit)
    p = base[t_i] + off[t_i, r_i] + rank[t_i, r_i, m_i]
    v = flat[(p // GROUP) * GROUP + (p % 8) * 128 + (p // 8) % 128]

    H = np.full((nt, T, M), -1, np.int32)
    H[t_i, r_i, m_i] = v
    s = 1
    while s < T:
        shifted = np.full_like(H, -1)
        shifted[:, s:] = H[:, :-s]
        H = np.where(H >= 0, H, shifted)
        s *= 2
    assert (H >= 0).all(), "tile row 0 must be a full (all-ones) row"
    return H.reshape(nt * T, M)[:st.n_valid].astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("M",))
def decode_stream_device(row_data: jnp.ndarray, vals: jnp.ndarray,
                         meta: jnp.ndarray, M: int) -> jnp.ndarray:
    """Decode stream tiles on the device: -> codes [nT*TILE, M] u8 in
    scan order (padding rows repeat the last valid row).

    Within a tile, values are stored in row-major (row, subspace) order
    of the set mask bits, so the flattened inclusive prefix sum of the
    bits, plus the tile's stream start, is each stored value's
    position.  A row's unchanged subspaces take the last stored value
    of their column: the running max of those positions down the rows
    (row 0 of every tile is full, so it always exists)."""
    nt, _, T = row_data.shape
    m = jnp.arange(M)
    planes = row_data.astype(jnp.int32)[:, m // 8, :]          # [nT, M, T]
    bits = ((planes >> (m % 8)[None, :, None]) & 1).transpose(0, 2, 1)
    flat = bits.reshape(nt, T * M)
    start = meta[0] * GROUP + meta[1]                          # [nT]
    pos = start[:, None] + jnp.cumsum(flat, axis=1) - 1
    pos = jnp.where(flat == 1, pos, -1).reshape(nt, T, M)
    src = jax.lax.cummax(pos, axis=1)
    idx = (src // GROUP) * GROUP + (src % 8) * 128 + (src // 8) % 128
    return vals.reshape(-1)[idx].reshape(nt * T, M)
