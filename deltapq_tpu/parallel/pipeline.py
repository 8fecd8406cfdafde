"""Pipelined sharded query: overlap the cross-shard top-k merge with
the next batch's table build + local scan.

BASELINE.json's north star names this explicitly: "per-shard top-k
results merge via all-gather overlapped with the next batch's
table-lookup compute".  The reference has no distributed layer; its
closest analog is the O_DIRECT read-ahead buffer
(``deltapq_create_approx_tree.h:2816``).

Design: one jitted ``lax.scan`` over the batch stream with a one-batch
software-pipeline carry.  Each scan step

1. builds batch *i*'s ADC table and runs the shard-local scan
   (compute-heavy, no collectives), and
2. all-gathers and merges batch *i-1*'s per-shard candidates
   (comm-heavy, tiny payload: ``S * B * k`` pairs).

The two stages have no data dependency inside a step, so XLA's
latency-hiding scheduler issues the all-gather while the scan runs —
the collective rides the interconnect behind compute instead of
serializing after it.  Results come out shifted by one step; a flush step drains
the last batch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.adc import adc_table
from .sharded import _local_scan_topk


def make_pipelined_query_fn(mesh: Mesh, top_k: int, tile_n: int = 8192,
                            axis: str = "shard"):
    """Returns a jitted fn
    ``(codewords [M,K,Ds], qbatches [NB, B, D], codes [N_pad, M],
    n_valid) -> (dists [NB, B, top_k], ids [NB, B, top_k])``
    with codes sharded along N and the whole batch stream processed in
    one pipelined scan (>= 2 batches in flight per step).
    """
    n_shards = mesh.devices.size

    def body(codewords, qbatches, codes_local, n_valid):
        idx = jax.lax.axis_index(axis)
        rows = codes_local.shape[0]
        base = idx.astype(jnp.int32) * rows
        local_valid = jnp.clip(n_valid - base, 0, rows)
        NB, B, D = qbatches.shape

        def local_stage(q):
            table = adc_table(codewords, q)
            d, i = _local_scan_topk(table, codes_local, local_valid,
                                    base, top_k, min(tile_n, rows),
                                    axis=axis)
            return d, i

        def merge_stage(d, i):
            all_d = jax.lax.all_gather(d, axis)    # [S, B, k]
            all_i = jax.lax.all_gather(i, axis)
            cat_d = jnp.moveaxis(all_d, 0, 1).reshape(
                B, n_shards * top_k)
            cat_i = jnp.moveaxis(all_i, 0, 1).reshape(
                B, n_shards * top_k)
            neg, pos = jax.lax.top_k(-cat_d, top_k)
            return -neg, jnp.take_along_axis(cat_i, pos, axis=1)

        def step(carry, q):
            prev_d, prev_i = carry
            # stage 1: THIS batch's table + local scan (compute)
            d_loc, i_loc = local_stage(q)
            # stage 2: PREVIOUS batch's cross-shard merge (comm) —
            # independent of stage 1, so XLA overlaps the all-gather
            # with the scan above
            out = merge_stage(prev_d, prev_i)
            return (d_loc, i_loc), out

        init = (jnp.full((B, top_k), jnp.inf, jnp.float32),
                jnp.full((B, top_k), -1, jnp.int32))
        init = tuple(jax.lax.pcast(x, (axis,), to="varying")
                     for x in init)
        (last_d, last_i), outs = jax.lax.scan(step, init, qbatches)
        # flush: merge the final batch's candidates
        fd, fi = merge_stage(last_d, last_i)
        dists = jnp.concatenate([outs[0][1:], fd[None]], axis=0)
        ids = jnp.concatenate([outs[1][1:], fi[None]], axis=0)
        return dists, ids

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(axis), P()),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(mapped)


def pipelined_query(codewords: np.ndarray, queries: np.ndarray,
                    codes: np.ndarray, mesh: Mesh, top_k: int = 10,
                    batch_size: int = 128
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end pipelined sharded query over a query stream.

    Pads the query count to a batch multiple and the database to a
    shard multiple; returns (dists [NQ, top_k], ids [NQ, top_k]).
    """
    from .sharded import _pad_codes_for_mesh

    codewords = np.asarray(codewords, np.float32)
    M, K, Ds = codewords.shape
    D = M * Ds
    q = np.asarray(queries, np.float32)
    nq = len(q)
    if q.shape[1] < D:
        q = np.pad(q, ((0, 0), (0, D - q.shape[1])))
    nb = -(-nq // batch_size)
    q_pad = np.zeros((nb * batch_size, D), np.float32)
    q_pad[:nq] = q
    qbatches = q_pad.reshape(nb, batch_size, D)

    codes_pad, n_valid = _pad_codes_for_mesh(np.asarray(codes), mesh)
    fn = make_pipelined_query_fn(mesh, top_k)
    d, i = fn(jnp.asarray(codewords), jnp.asarray(qbatches),
              jnp.asarray(codes_pad), jnp.int32(n_valid))
    d = np.asarray(d).reshape(nb * batch_size, top_k)[:nq]
    i = np.asarray(i).reshape(nb * batch_size, top_k)[:nq]
    return d, i
