"""Worker for the 2-process distributed test (VERDICT r2 #5).

Launched twice by tests/test_sharded.py::test_two_process_distributed:
each process brings 2 virtual CPU devices, `jax.distributed.initialize`
joins them into one 4-device runtime, and both the sharded plain query
and one DP Lloyd step must match single-device reference results.

Usage: python tests/_dist_worker.py <proc_id> <nproc> <port>
"""

import os
import sys

proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from deltapq_tpu.parallel.runtime import init_distributed  # noqa: E402

n = init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=proc_id)
assert n == nproc, f"process_count {n} != {nproc}"
assert len(jax.devices()) == 2 * nproc, jax.devices()
assert len(jax.local_devices()) == 2

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from deltapq_tpu.ops.adc import adc_table, query_plain  # noqa: E402
from deltapq_tpu.parallel.sharded import (make_dp_lloyd_step,  # noqa: E402
                                          sharded_query_plain)

rng = np.random.default_rng(0)
M, K, Ds = 4, 16, 8
N, B = 3000, 8
cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
queries = rng.normal(size=(B, M * Ds)).astype(np.float32)

mesh = Mesh(np.array(jax.devices()), ("shard",))
d, i = sharded_query_plain(cw, queries, codes, top_k=5, mesh=mesh,
                           tile_n=256)

# single-device reference (local computation, identical on both procs)
d_ref, i_ref = query_plain(cw, queries, codes, top_k=5)
np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-4)

# one DP Lloyd step across both processes
nx = 512
x = rng.normal(size=(M, nx, Ds)).astype(np.float32)
centers = rng.normal(size=(M, K, Ds)).astype(np.float32)
step = make_dp_lloyd_step(mesh)
xs = jax.device_put(x, NamedSharding(mesh, P(None, "shard", None)))
cs = jax.device_put(centers, NamedSharding(mesh, P()))
new_c, dist = step(xs, cs)

# reference Lloyd step on the full arrays
x2 = np.sum(x * x, axis=2, keepdims=True)
c2 = np.sum(centers * centers, axis=2)
cross = np.einsum("mnd,mkd->mnk", x, centers)
d2 = x2 - 2.0 * cross + c2[:, None, :]
labels = np.argmin(d2, axis=2)
ref_c = centers.copy()
for m in range(M):
    for k in range(K):
        sel = labels[m] == k
        if sel.any():
            ref_c[m, k] = x[m, sel].mean(axis=0)
np.testing.assert_allclose(np.asarray(new_c), ref_c, rtol=1e-4,
                           atol=1e-4)
ref_dist = float(np.sum(np.min(d2, axis=2)))
assert abs(float(dist) - ref_dist) / ref_dist < 1e-4

# compressed (product) tier across the process boundary: one stream
# per shard over the 4-device / 2-process mesh, result must match the
# single-device fused compressed engine
from deltapq_tpu.ops.fused import FusedCompressedEngine  # noqa: E402
from deltapq_tpu.parallel.fused_sharded import \
    ShardedCompressedEngine  # noqa: E402

codes_c = np.sort(codes, axis=0)  # duplicate-heavy, compressible
order = np.lexsort(codes_c.T[::-1])
ref_eng = FusedCompressedEngine(cw, codes_c[order], row_to_db=order)
d_ref_c, _ = ref_eng.query(queries, top_k=5)
sh_eng = ShardedCompressedEngine(cw, codes_c[order], mesh,
                                 row_to_db=order)
d_c, _ = sh_eng.query(queries, top_k=5)
np.testing.assert_allclose(d_c, d_ref_c, rtol=1e-5, atol=1e-4)

# dedup product tier across the process boundary: distinct codes sharded over the 2-process mesh, host row expansion;
# distances must match the plain scan over the duplicated rows
from deltapq_tpu.ops.fused import DedupCompressedEngine  # noqa: E402

distinct = rng.integers(0, K, size=(64, M)).astype(np.uint8)
codes_dup = distinct[rng.integers(0, 64, size=2048)]
dd_eng = DedupCompressedEngine(cw, codes_dup, mesh=mesh)
d_dd, _ = dd_eng.query(queries, top_k=5)
d_dd_ref, _ = query_plain(cw, queries, codes_dup, top_k=5)
np.testing.assert_allclose(d_dd, d_dd_ref, rtol=1e-5, atol=1e-4)

print(f"proc {proc_id}: OK", flush=True)
