"""Platform selection helper.

``jax.config.update('jax_platforms', ...)`` works as long as no backend has
initialised yet. CLIs call :func:`maybe_force_platform` first thing; set
``PCAD_PLATFORM=cpu`` to run any workload on the host CPU (e.g. functional
checks without a GPU)."""

from __future__ import annotations

import os

import jax


def maybe_force_platform() -> None:
    plat = os.environ.get("PCAD_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)
