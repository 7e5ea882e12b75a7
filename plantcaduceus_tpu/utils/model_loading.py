"""Model + tokenizer resolution shared by every CLI.

Accepts either an HF checkpoint directory (imported via compat.hf_import —
the analogue of the reference's AutoModelForMaskedLM.from_pretrained at
src/zero_shot_score.py:90-98) or a preset spec ``<preset>[:random]`` that
builds a randomly initialised model of the published size (smoke tests and
benchmarks on hardware without the released weights).
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path
from typing import Tuple

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu.models import caduceus
from plantcaduceus_tpu.models.config import PRESETS, CaduceusConfig

log = logging.getLogger(__name__)


def load_model_and_tokenizer(spec: str, seed: int = 0) -> Tuple[dict, CaduceusConfig, DnaTokenizer]:
    """Resolve ``spec`` to (params, config, tokenizer).

    Accepts: an HF checkpoint dir (torch weights), a framework export dir
    (train.checkpoint.export_params output), or a preset name."""
    path = Path(spec)
    if path.is_dir():
        try:
            tokenizer = DnaTokenizer.from_hf_dir(path)
        except FileNotFoundError:
            tokenizer = DnaTokenizer()
        if (path / "params.npz").is_file():  # framework export
            from plantcaduceus_tpu.train.checkpoint import load_params

            log.info("Loading framework checkpoint from %s", path)
            params, cfg = load_params(path)
            return params, cfg, tokenizer
        from plantcaduceus_tpu.compat.hf_import import import_params

        log.info("Importing HF checkpoint from %s", path)
        params, cfg = import_params(path)
        return params, cfg, tokenizer

    name = spec.split(":")[0]
    if name not in PRESETS:
        raise FileNotFoundError(
            f"model spec {spec!r} is neither a checkpoint dir nor a preset "
            f"({sorted(PRESETS)})"
        )
    log.info("Building randomly initialised preset %s", name)
    cfg = CaduceusConfig.preset(name)
    params = init_params_seeded(cfg, seed)
    return params, cfg, DnaTokenizer()


def init_params_seeded(cfg: CaduceusConfig, seed: int = 0):
    """Initialise fp32 parameters from ``seed`` as one jitted program on
    the default device (eagerly it would be hundreds of small dispatches);
    the engine/training setup places the pytree on its mesh afterwards."""
    init = functools.partial(caduceus.init_params, cfg=cfg,
                             dtype=jnp.float32)
    return jax.jit(init)(jax.random.PRNGKey(seed))


def load_tokenizer_only(spec: str) -> DnaTokenizer:
    path = Path(spec)
    if path.is_dir():
        try:
            return DnaTokenizer.from_hf_dir(path)
        except FileNotFoundError:
            pass
    return DnaTokenizer()
