"""Checkpoint save/resume in a plain numpy format.

Replacement for the reference's three checkpoint formats (HF save_pretrained
dirs, Composer .pt, PEFT adapter dirs — SURVEY.md §5.4) with one mechanism:
a pytree saved as one ``.npz`` of its leaves, keyed by their tree paths,
beside a JSON record. A CheckpointManager keeps numbered step directories
over the TrainState with HF-Trainer-style latest-checkpoint resume detection
(src/HF_pre_train.py:334-352 semantics). It needs nothing beyond numpy.

Layout of a step directory ``<dir>/<step>/``: ``state.npz`` (the leaves)
and ``checkpoint.json`` (``{"step": N}``), written last, so a directory
without it is an interrupted save and is ignored.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from plantcaduceus_tpu.models.config import CaduceusConfig
from plantcaduceus_tpu.train.step import TrainState

log = logging.getLogger(__name__)

_DTYPES = "__dtypes__"


def _path_key(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


def _to_host(x) -> np.ndarray:
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(jax.device_get(x))


def save_tree(path, tree) -> None:
    """Write ``tree``'s leaves to ``path`` (.npz) keyed by tree path. Dtypes
    numpy cannot store (bfloat16 and the other ml_dtypes) are saved as raw
    bytes and recorded by name."""
    path = Path(path)
    arrays, dtypes = {}, {}
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = _path_key(p)
        a = _to_host(leaf)
        if a.dtype.kind not in "biufc":
            dtypes[key] = a.dtype.name
            a = np.ascontiguousarray(a).reshape(-1).view(np.uint8).reshape(
                a.shape + (a.dtype.itemsize,))
        arrays[key] = a
    if jax.process_index() != 0:
        return
    arrays[_DTYPES] = np.asarray(json.dumps(dtypes))
    tmp = path.with_name(path.name + ".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _read(path) -> dict:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    dtypes = json.loads(str(arrays.pop(_DTYPES)))
    for key, name in dtypes.items():
        a = arrays[key]
        arrays[key] = a.reshape(-1).view(jnp.dtype(name)).reshape(a.shape[:-1])
    return arrays


def load_tree(path, template=None):
    """Read a :func:`save_tree` file. With ``template``, the leaves are
    restored into its structure, dtypes and (where the template leaf has
    one) shardings; without, the file must hold a tree of nested dicts."""
    arrays = _read(path)
    if template is None:
        tree: dict = {}
        for key, a in arrays.items():
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = a
        return tree
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for p, t in flat:
        key = _path_key(p)
        if key not in arrays:
            raise KeyError(f"{path} has no leaf {key!r}")
        a = arrays[key].astype(np.asarray(t).dtype)
        sharding = getattr(t, "sharding", None)
        leaves.append(jax.device_put(a, sharding) if sharding is not None
                      else jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, leaves)


class CheckpointManager:
    def __init__(self, directory, save_interval_steps: int = 1000,
                 max_to_keep: int = 20):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._interval = save_interval_steps
        self._keep = max_to_keep

    def steps(self) -> list:
        """Completed checkpoint steps, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / "checkpoint.json").exists())

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        if not force and self._interval and step % self._interval != 0:
            return False
        step_dir = self.directory / str(int(step))
        step_dir.mkdir(parents=True, exist_ok=True)
        save_tree(step_dir / "state.npz", state._asdict())
        if jax.process_index() == 0:
            (step_dir / "checkpoint.json").write_text(
                json.dumps({"step": int(step)}))
            steps = self.steps()
            for old in steps[:max(0, len(steps) - self._keep)]:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Restore onto the template's structure and shardings."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        restored = load_tree(self.directory / str(step) / "state.npz",
                             state_template._asdict())
        log.info("Restored checkpoint at step %d from %s", step, self.directory)
        return TrainState(**restored)

    def wait(self):
        """Saves are synchronous; kept for callers that fence on it."""

    def close(self):
        """Nothing to release; kept for callers that close managers."""


def save_config(directory, cfg: CaduceusConfig) -> None:
    Path(directory).mkdir(parents=True, exist_ok=True)
    cfg.save(Path(directory) / "config.json")


def export_params(directory, params, cfg: CaduceusConfig) -> None:
    """Standalone weight export (inference checkpoints): config.json +
    params.npz."""
    directory = Path(directory).absolute()
    save_config(directory, cfg)
    save_tree(directory / "params.npz", params)


def load_params(directory):
    """Load an exported params dir -> (params, cfg)."""
    directory = Path(directory).absolute()
    cfg = CaduceusConfig.load(directory / "config.json")
    return load_tree(directory / "params.npz"), cfg
