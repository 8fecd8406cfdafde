"""deltapq: a JAX/XLA/Pallas quantized similarity search engine with the
capabilities of RunhuiWang/DeltaPQ (VLDB'20), running on NVIDIA GPUs.

See SURVEY.md for the structural analysis of the reference this build
follows.  Layers:

- ``deltapq_tpu.io``       dataset / artifact I/O (reference-compatible formats)
- ``deltapq_tpu.ops``      JAX/Pallas compute kernels (k-means, encode, ADC, top-k)
- ``deltapq_tpu.tree``     DeltaTree construction, layout and serialization
- ``deltapq_tpu.eval``     groundtruth + recall/mAP metrics
- ``deltapq_tpu.parallel`` mesh sharding, multi-chip query execution
"""

import os as _os

import jax as _jax

# Persistent compilation cache: the query path compiles a kernel per
# (shape, rung), so a warm cache makes every later process (server
# restart, benchmark re-run) start at steady state.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the cache
# lives at a fixed path inside the checkout (a moving path never hits).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))

from .config import (PQConfig, TreeConfig, QueryConfig, ShardConfig)
from .index import DeltaPQIndex

__version__ = "0.1.0"

__all__ = ["PQConfig", "TreeConfig", "QueryConfig", "ShardConfig",
           "DeltaPQIndex", "__version__"]
