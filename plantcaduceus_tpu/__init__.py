"""plantcaduceus_tpu — a plant DNA language-model framework in JAX.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of
kuleshov-group/PlantCaduceus (the reference): the Caduceus architecture
(bidirectional, reverse-complement-equivariant Mamba SSM over nucleotide
windows) plus its application suite — zero-shot variant-effect scoring,
embedding extraction for XGBoost classifiers, LoRA fine-tuning, and masked-LM
pre-training — built around SPMD meshes and a Triton selective-scan kernel
for NVIDIA GPUs.
"""

__version__ = "0.1.0"

import os as _os
from pathlib import Path as _Path

import jax as _jax

_CHECKOUT = _Path(__file__).resolve().parent.parent


def compile_cache_dir(env=_os.environ):
    """The persistent XLA compile cache directory for a process with
    environment ``env``. ``JAX_COMPILATION_CACHE_DIR`` wins (JAX reads it
    itself); otherwise a fixed ``.jax_cache`` in the checkout, so its path —
    part of every cache key — never moves. CPU processes (tests) keep the
    cache off: XLA:CPU entries are tied to the host's codegen options and
    would only be recompiled. Returns None when off."""
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return env["JAX_COMPILATION_CACHE_DIR"]
    if "cpu" in (env.get("PCAD_PLATFORM"), env.get("JAX_PLATFORMS")):
        return None
    return str(_CHECKOUT / ".jax_cache")


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR") and compile_cache_dir():
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from plantcaduceus_tpu.models.config import CaduceusConfig  # noqa: E402,F401
