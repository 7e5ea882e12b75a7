"""Training loop driver with monitoring, eval, and checkpoint/resume.

Framework equivalent of the reference's two trainer stacks (HF Trainer in
src/HF_pre_train.py, Composer in pretrain/scripts/train_mosaic_bert.py):
steps-based loop, periodic eval + perplexity, periodic checkpoints with
autoresume, and a SpeedMonitor-style throughput/step-time tracker
(SURVEY.md §5.1) with optional wandb logging.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Iterable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from plantcaduceus_tpu.train.checkpoint import CheckpointManager
from plantcaduceus_tpu.train.step import TrainState

log = logging.getLogger(__name__)


class SpeedMonitor:
    """Rolling window step-time / throughput tracker."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list = []

    def tick(self) -> None:
        self.times.append(time.time())
        if len(self.times) > self.window + 1:
            self.times.pop(0)

    def stats(self, tokens_per_step: int) -> dict:
        if len(self.times) < 2:
            return {}
        dt = (self.times[-1] - self.times[0]) / (len(self.times) - 1)
        return {"step_time_s": dt, "tokens_per_sec": tokens_per_step / dt}


def run_training(
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    train_iter: Iterator[dict],
    eval_batches: Optional[Callable[[], Iterable[dict]]],
    max_steps: int,
    log_every: int = 50,
    eval_every: int = 1000,
    eval_max_batches: int = 20,
    ckpt: Optional[CheckpointManager] = None,
    wandb_run=None,
    tokens_per_step: int = 0,
    profile_dir: Optional[str] = None,
    mesh=None,
    sync_every: int = 4,
) -> TrainState:
    """Run to max_steps (resuming from state.step). Returns final state.

    With ``mesh``, batches are placed directly onto their step-input
    shardings (parallel.mesh.shard_batch) — one sharded H2D transfer
    instead of a replicated transfer plus an in-step reshard."""
    from plantcaduceus_tpu.utils.profiling import StepWindowProfiler

    start_step = int(state.step)
    monitor = SpeedMonitor()
    host0 = jax.process_index() == 0
    profiler = StepWindowProfiler(profile_dir, start_step + 10, 3)
    if mesh is not None:
        from plantcaduceus_tpu.parallel.mesh import shard_batch
        place = lambda b: shard_batch(b, mesh)
    else:
        place = lambda b: {k: jnp.asarray(v) for k, v in b.items()}

    for step in range(start_step, max_steps):
        profiler.step(step)
        batch = place(next(train_iter))
        if step == start_step:
            # The first step carries the compile + buffer assignment; a
            # device-memory overflow here surfaces as an opaque runtime
            # error — wrap it with the actionable levers.
            try:
                state, metrics_dev = train_step(state, batch)
            except Exception as e:
                msg = str(e)
                if "RESOURCE_EXHAUSTED" in msg or "Ran out of memory" in msg:
                    raise RuntimeError(
                        "first training step failed in compile/allocation "
                        "— this usually means the config does not fit the "
                        "device's memory. Levers: lower --batch-size and "
                        "scale with --grad-accum (same effective batch, less "
                        "memory); shard optimizer state over devices with "
                        "--fsdp N; split deep layer stacks with --pipe N. "
                        f"Original error: {e}"
                    ) from e
                raise
        else:
            state, metrics_dev = train_step(state, batch)
        # Synchronise every few steps: a scalar fetch bounds host run-ahead
        # on the donated state chain; logging/eval/checkpoint boundaries
        # below also sync. The cadence is not measured on the GPU yet
        # (ROADMAP.md).
        metrics = None
        if sync_every and (step + 1) % sync_every == 0:
            metrics = {k: float(v) for k, v in metrics_dev.items()}
        monitor.tick()

        if host0 and (step + 1) % log_every == 0:
            if metrics is None:
                metrics = {k: float(v) for k, v in metrics_dev.items()}
            m = dict(metrics)
            m.update(monitor.stats(tokens_per_step))
            log.info("step %d/%d loss=%.4f acc=%.4f %s", step + 1, max_steps,
                     m["loss"], m["accuracy"],
                     " ".join(f"{k}={v:.3g}" for k, v in m.items()
                              if k not in ("loss", "accuracy")))
            if wandb_run is not None:
                wandb_run.log({"train/" + k: v for k, v in m.items()},
                              step=step + 1)

        if eval_every and eval_batches is not None and (step + 1) % eval_every == 0:
            ev = evaluate(state, eval_step, eval_batches(), eval_max_batches,
                          place=place)
            if host0:
                log.info("eval @ %d: loss=%.4f ppl=%.2f acc=%.4f", step + 1,
                         ev["loss"], ev["perplexity"], ev["accuracy"])
                if wandb_run is not None:
                    wandb_run.log({"eval/" + k: v for k, v in ev.items()},
                                  step=step + 1)

        if ckpt is not None:
            ckpt.save(step + 1, state)

    profiler.close()
    if ckpt is not None:
        if ckpt.latest_step() != max_steps:
            ckpt.save(max_steps, state, force=True)
        ckpt.wait()
    return state


def evaluate(state: TrainState, eval_step: Callable,
             batches: Iterable[dict], max_batches: Optional[int] = None,
             place: Optional[Callable] = None) -> dict:
    """``place`` must match the train loop's batch placement (mesh-aware
    shard_batch when training over a mesh) so the jitted eval_step sees
    identically-placed inputs."""
    if place is None:
        place = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    losses, accs = [], []
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        batch = place(batch)
        m = eval_step(state, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    loss = float(np.mean(losses)) if losses else float("nan")
    try:
        ppl = math.exp(loss)
    except OverflowError:
        ppl = float("inf")
    return {"loss": loss, "perplexity": ppl,
            "accuracy": float(np.mean(accs)) if accs else float("nan")}
