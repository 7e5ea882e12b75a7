"""Knowledge distillation between Caduceus models (teacher → student).

Beyond-reference capability motivated by the SSD family (docs/DESIGN.md §7):
the released PlantCaduceus checkpoints are Mamba-1, but the framework's
fastest architecture is the SSD (`-ssd`) variant — distillation is the
migration path that transfers a pretrained Mamba-1 teacher into an SSD
student (or any teacher/student config pair: smaller d_model, fewer layers,
longer context) without pretraining from scratch.

Objective (Hinton-style masked-LM distillation): at the MLM-masked
positions,

    loss = alpha * T^2 * KL(softmax(t/T) || softmax(s/T)) + (1-alpha) * CE

with the same soft-mask loss-weighting and global normalisation as the
pre-training step (train/step.py): local (weighted sum, weight sum) pairs
psum over the batch axes so uneven mask counts per shard don't bias
gradients. The T^2 factor keeps soft-target gradient magnitudes
temperature-independent (standard distillation scaling).

Sharding mirrors train/step.py: student parameters/optimizer state shard
over 'fsdp' (ZeRO: all_gather before use, psum_scatter of grads), batch
over ('data','fsdp'); the teacher runs forward-only and stays REPLICATED —
it is read-only traffic, and at these model scales (≤225M params) a
replicated teacher costs less than all_gathering it every step. Tensor/
sequence axes are not supported here (distillation batches are short
fixed windows; use data/fsdp).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from plantcaduceus_tpu.models import caduceus
from plantcaduceus_tpu.models.config import CaduceusConfig
from plantcaduceus_tpu.parallel import mesh as meshlib
from plantcaduceus_tpu.train.step import (BATCH_AXES, TrainState,
                                          _gather_fsdp, _loss_sums,
                                          _sync_grads, make_init_state)


def make_distill_step(
    teacher_cfg: CaduceusConfig,
    student_cfg: CaduceusConfig,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    student_template,
    dtype=jnp.bfloat16,
    temperature: float = 2.0,
    alpha: float = 0.5,
    remat: bool = True,
    fsdp: bool | None = None,
):
    """Build (init_state, distill_step).

    ``distill_step(state, teacher_params, batch) -> (state, metrics)`` with
    metrics {loss, accuracy, kl, hard, agree, grad_norm}; ``agree`` is the
    masked-position argmax agreement between student and teacher — the
    distillation-progress metric. ``teacher_params`` is an ordinary
    (replicated) argument, not baked into the jit, so one compiled step
    serves checkpoint sweeps.
    """
    if (mesh.shape.get("tensor", 1) > 1 or mesh.shape.get("seq", 1) > 1
            or mesh.shape.get("pipe", 1) > 1):
        raise ValueError("distillation supports data/fsdp meshes only")
    if teacher_cfg.vocab_size != student_cfg.vocab_size:
        raise ValueError(
            f"teacher vocab {teacher_cfg.vocab_size} != student "
            f"{student_cfg.vocab_size}")
    if fsdp is None:
        fsdp = mesh.shape.get("fsdp", 1) > 1
    pspecs = meshlib.param_pspec_tree(student_template, replicated=not fsdp)
    single = mesh.size == 1
    T = float(temperature)

    def psum(v):
        return v if single else jax.lax.psum(v, BATCH_AXES)

    def local_step(params_s, params_t, batch):
        valid = batch["labels"] != -100
        w_local = valid.astype(jnp.float32)
        if "loss_weights" in batch:
            w_local = w_local * batch["loss_weights"].astype(jnp.float32)
        # Parameter-independent normaliser: psum OUTSIDE the grad graph
        # (same reasoning as train/step.py).
        W = jnp.maximum(psum(jnp.sum(w_local)), 1e-8)

        # Teacher is forward-only (outside the differentiated closure).
        t_logits = jax.lax.stop_gradient(
            caduceus.forward(params_t, batch["input_ids"], teacher_cfg,
                             dtype=dtype)["logits"]
        ).astype(jnp.float32)
        logp_t = jax.nn.log_softmax(t_logits / T, axis=-1)
        p_t = jnp.exp(logp_t)

        def loss_fn(student_full):
            out = caduceus.forward(student_full, batch["input_ids"],
                                   student_cfg, dtype=dtype, remat=remat)
            s_logits = out["logits"].astype(jnp.float32)
            logq = jax.nn.log_softmax(s_logits / T, axis=-1)
            kl = jnp.sum(p_t * (logp_t - logq), axis=-1)       # [B, L]
            kl_sum = jnp.sum(kl * w_local) * (T * T)
            hard_sum, _ = _loss_sums(s_logits, batch["labels"],
                                     batch.get("loss_weights"))
            obj = (alpha * kl_sum + (1.0 - alpha) * hard_sum) / W
            return obj, (s_logits, kl_sum, hard_sum)

        student_full = params_s if single else _gather_fsdp(params_s, pspecs)
        (local_obj, (s_logits, kl_sum, hard_sum)), grads = \
            jax.value_and_grad(loss_fn, has_aux=True)(student_full)
        if not single:
            grads = _sync_grads(grads, pspecs)
        loss = psum(local_obj)
        kl_g = psum(kl_sum) / W
        hard_g = psum(hard_sum) / W

        pred = jnp.argmax(s_logits, axis=-1)
        n_valid = jnp.maximum(psum(jnp.sum(valid)), 1)
        acc = psum(jnp.sum((pred == batch["labels"]) & valid)) / n_valid
        agree = psum(
            jnp.sum((pred == jnp.argmax(t_logits, axis=-1)) & valid)
        ) / n_valid
        return loss, kl_g, hard_g, acc, agree, grads

    batch_spec = {"input_ids": P(BATCH_AXES, None),
                  "labels": P(BATCH_AXES, None),
                  "loss_weights": P(BATCH_AXES, None)}

    def grad_fn(params_s, params_t, batch):
        if single:
            return local_step(params_s, params_t, batch)
        t_rep = jax.tree.map(lambda _: P(), params_t)
        bspec = {k: batch_spec[k] for k in batch}
        return jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(pspecs, t_rep, bspec),
            out_specs=(P(), P(), P(), P(), P(), pspecs),
            check_vma=False,
        )(params_s, params_t, batch)

    init_state = make_init_state(optimizer, mesh, pspecs)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def distill_step(state: TrainState, teacher_params,
                     batch) -> Tuple[TrainState, Dict]:
        loss, kl, hard, acc, agree, grads = grad_fn(state.params,
                                                    teacher_params, batch)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        metrics = {"loss": loss, "accuracy": acc, "kl": kl, "hard": hard,
                   "agree": agree, "grad_norm": optax.global_norm(grads)}
        return TrainState(params, opt_state, state.step + 1), metrics

    return init_state, distill_step
