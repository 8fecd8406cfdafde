"""The one place that decides what the active JAX platform means.

The product runs on the GPU: ``DeltaPQIndex`` resolves ``engine="auto"``
to the compressed tiers there and the Pallas kernels compile through
Triton.  The CPU backend exists for the test suite: Pallas kernels run
in interpret mode and ``auto`` keeps the plain XLA scan.  Any other
platform is an error — nothing silently falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional

import jax

PLATFORMS = ("gpu", "cpu")


def backend(name: Optional[str] = None) -> str:
    """Validated platform name: ``name`` or the active JAX backend."""
    name = name or jax.default_backend()
    if name not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: deltapq runs on 'gpu' "
            f"(CUDA) and on 'cpu' (tests only)")
    return name


def on_gpu(name: Optional[str] = None) -> bool:
    return backend(name) == "gpu"


def interpret(name: Optional[str] = None) -> bool:
    """Pallas kernels run interpreted exactly when on the CPU."""
    return backend(name) == "cpu"


def cpu_only_worker() -> None:
    """``ProcessPoolExecutor`` initializer for spawned host workers:
    pin them to the CPU backend so none can open the accelerator (a JAX
    process reserves most of the card's memory when it first uses it)."""
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
