"""Multi-host runtime + continuous query batching.

No reference counterpart (single-process OpenMP program).  This is the
serving-side runtime of the framework:

- ``init_distributed``: ``jax.distributed.initialize`` wrapper (no-op
  for single-process); after it, ``jax.devices()`` spans all hosts and
  the 1-D mesh in ``mesh.make_mesh`` covers the full slice, with shard
  collectives riding ICI within a pod and DCN across pods.
- ``ContinuousBatcher``: double-buffered query streaming.  JAX dispatch
  is asynchronous, so enqueueing batch i+1 while batch i executes
  overlaps host-side table staging and device compute; results are
  fetched one batch behind the dispatch frontier (the reference's
  analogous trick is the O_DIRECT read-ahead buffer,
  ``deltapq_create_approx_tree.h:2816``).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize the multi-host runtime; returns the process count.

    With no arguments this is a single-process no-op (the common local
    case and all CI).  On several hosts, pass the coordinator address,
    process count and this process's id.
    """
    import jax

    if coordinator_address is None and num_processes is None:
        try:
            return jax.process_count()
        except Exception:
            return 1
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_count()


class ContinuousBatcher:
    """Stream query batches through a query function with a bounded
    in-flight window (default 2 = double buffering).

    query_fn: (queries [B, D] np/jnp) -> (dists, ids) device arrays.
    The returned iterator yields NumPy (dists, ids) per input batch in
    order, fetching batch i while batch i+depth is already dispatched.
    """

    def __init__(self, query_fn: Callable, depth: int = 2):
        self.query_fn = query_fn
        self.depth = max(1, depth)

    def run(self, batches: Iterable[np.ndarray]
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        inflight = collections.deque()
        for q in batches:
            inflight.append(self.query_fn(q))
            if len(inflight) >= self.depth:
                d, i = inflight.popleft()
                yield np.asarray(d), np.asarray(i)
        while inflight:
            d, i = inflight.popleft()
            yield np.asarray(d), np.asarray(i)


def batch_iterator(queries: np.ndarray, batch_size: int,
                   pad_to_batch: bool = True) -> Iterator[np.ndarray]:
    """Slice a query set into fixed-size batches (padding the tail with
    repeated rows so every dispatch hits the same compiled program)."""
    n = len(queries)
    for off in range(0, n, batch_size):
        q = queries[off:off + batch_size]
        if pad_to_batch and len(q) < batch_size:
            reps = -(-batch_size // len(q))
            q = np.tile(q, (reps, 1))[:batch_size]
        yield q
