"""Sharded training step: dp + fsdp + tp over one device mesh.

Replaces the reference's three DDP wrappers (composer.dist / HF Trainer /
Lightning — SURVEY.md §2.7) and its dormant fsdp_config hook
(pretrain/scripts/train_mosaic_bert.py:262) with a single mechanism:

* the gradient computation runs under ``shard_map`` with explicit collectives
  (the Triton scan kernel has no GSPMD partitioning rule, so SPMD must be
  manual on the hot path),
* batch shards over ('data','fsdp'); parameters/optimizer state shard over
  'fsdp' (ZeRO-style: all_gather before use, psum_scatter of gradients) and
  over 'tensor' on d_inner axes (mixer psums; see models.caduceus),
* the optimizer update runs under plain jit — elementwise, GSPMD handles it.

Loss is globally normalised: local (weighted-NLL sum, weight sum) pairs are
psummed over the batch axes before dividing, so uneven mask counts per shard
don't bias gradients.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from plantcaduceus_tpu.models import caduceus
from plantcaduceus_tpu.models.config import CaduceusConfig
from plantcaduceus_tpu.parallel import mesh as meshlib

BATCH_AXES = ("data", "fsdp")


class TrainState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    step: jax.Array


def _loss_sums(logits, labels, loss_weights, ignore_index=-100):
    """(weighted NLL sum, weight sum) — local shard contribution."""
    valid = labels != ignore_index
    labels_safe = jnp.where(valid, labels, 0)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, labels_safe[..., None], axis=-1)[..., 0]
    w = valid.astype(jnp.float32)
    if loss_weights is not None:
        w = w * loss_weights.astype(jnp.float32)
    return jnp.sum(nll * w), jnp.sum(w)


def _gather_fsdp(params, specs):
    def g(p, spec):
        for i, ax in enumerate(spec):
            if ax == "fsdp":
                return jax.lax.all_gather(p, "fsdp", axis=i, tiled=True)
        return p
    return jax.tree.map(g, params, specs, is_leaf=lambda x: isinstance(x, P))


# mamba2 params replicated over 'tensor' but consumed by every tensor
# shard's heads: their gradients are per-shard partials (models.caduceus
# mamba2_mixer docstring) and must additionally psum over 'tensor'. The
# list lives next to the param_specs tp rules it mirrors;
# meshlib.validate_tp_grad_coverage (called at step-build time under TP)
# fails loudly if a mixer leaf is covered by neither.
_TENSOR_PARTIAL_LEAVES = meshlib.TENSOR_PARTIAL_LEAVES


def _sync_grads(grads, specs, extra_axes=(), tp: bool = False,
                pp: bool = False):
    """Sum over batch (+ any sequence) axes; reduce-scatter back onto fsdp
    shards. ``extra_axes`` names mesh axes (e.g. 'seq') whose shards hold
    partial parameter gradients that must also be summed. Under pipeline
    parallelism (``pp``), stage-replicated leaves (embedding/norm_f/lm_head
    — anything without 'pipe' in its spec) hold per-stage partial grads
    (only stage 0 touches the embedding input, only the last stage the
    head) and psum over 'pipe'; pipe-sharded block leaves are stage-local
    and complete."""
    extra_axes = tuple(extra_axes)

    def _has_axis(spec, name):
        return any(ax == name or (isinstance(ax, (tuple, list)) and
                                  name in ax) for ax in spec)

    def s(path, g, spec):
        leaf = str(getattr(path[-1], "key", path[-1]))
        axes = BATCH_AXES + extra_axes
        if tp and leaf in _TENSOR_PARTIAL_LEAVES:
            axes = axes + ("tensor",)
        if pp and not _has_axis(spec, "pipe"):
            axes = axes + ("pipe",)
        fsdp_axis = next((i for i, ax in enumerate(spec) if ax == "fsdp"), None)
        if fsdp_axis is None:
            return jax.lax.psum(g, axes)
        g = jax.lax.psum(g, tuple(a for a in axes if a != "fsdp"))
        return jax.lax.psum_scatter(g, "fsdp", scatter_dimension=fsdp_axis,
                                    tiled=True)
    return jax.tree_util.tree_map_with_path(
        s, grads, specs, is_leaf=lambda x: isinstance(x, P))


def make_init_state(optimizer: optax.GradientTransformation, mesh: Mesh,
                    pspecs):
    """Shared TrainState initialiser (train step + distillation)."""

    def init_state(params) -> TrainState:
        # Jitted identity copy (NOT device_put): the step donates the
        # state, and device_put aliases the source buffer into the matching
        # shard of the output even with may_alias=False — donating that
        # output would delete the caller's params. jit without donation
        # always materialises fresh output buffers.
        shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                                 is_leaf=lambda x: isinstance(x, P))
        params = jax.jit(lambda t: t, out_shardings=shardings)(params)
        opt_state = jax.jit(optimizer.init)(params)
        # Commit the loose leaves (optimizer step counters and the like are
        # constant-folded onto one device, uncommitted) onto the mesh: a
        # fresh state tolerates them because uncommitted arrays auto-move,
        # but a checkpoint-restored state is committed everywhere and the
        # jitted step rejects mixed placements — the template must carry
        # the real shardings so restore can re-establish them.
        rep = NamedSharding(mesh, P())
        mesh_devs = set(mesh.devices.flat)
        commit = lambda x: x if x.sharding.device_set == mesh_devs \
            else jax.device_put(x, rep)
        opt_state = jax.tree.map(commit, opt_state)
        return TrainState(params, opt_state,
                          jax.device_put(jnp.zeros((), jnp.int32), rep))

    return init_state


def make_grad_fn(cfg: CaduceusConfig, mesh: Mesh, param_specs,
                 dtype=jnp.bfloat16, remat: bool = True,
                 pp_microbatches: Optional[int] = None,
                 grad_accum: int = 1):
    """shard_map'd (params, batch) -> (loss, accuracy, grads). On a
    single-device mesh the shard_map wrapper (and its no-op collectives) is
    bypassed entirely.

    ``grad_accum > 1`` runs the batch as that many sequential microbatches
    (``lax.scan`` over a [accum, rows/accum, L] reshape of each shard's
    rows), accumulating gradients against the GLOBAL weight normaliser so an
    accum-N step computes exactly the one-big-batch gradient (the reference
    recipes depend on this: pre-train 32x4 per README, LoRA grad-accum 64 —
    src/lora_fine_tune.py:311-333). FSDP params are all-gathered once per
    optimizer step, not per microbatch, and gradients sync once — the
    no_sync()-style DDP behavior."""
    tp = mesh.shape.get("tensor", 1) > 1
    tp_axis = "tensor" if tp else None
    sp_shards = mesh.shape.get("seq", 1)
    sp = sp_shards > 1
    sp_axis = "seq" if sp else None
    pp_stages = mesh.shape.get("pipe", 1)
    pp = pp_stages > 1
    if sp and tp:
        raise ValueError("sequence and tensor parallelism cannot be combined "
                         "(the context-parallel mixer needs unsharded d_inner)")
    if pp and (sp or tp):
        raise ValueError("pipeline parallelism combines with data/fsdp only "
                         "(parallel/pipeline.py module docstring)")
    # Scalars (loss, metrics) and replicated-param grads are partial over the
    # sequence shards too: include 'seq' in their reduction axes.
    loss_axes = BATCH_AXES + (("seq",) if sp else ())
    # Gated per-stage contributions (nll, accuracy numerator) additionally
    # sum over 'pipe'; the normalisers (W, valid counts) are stage-replicated
    # and must NOT.
    gated_axes = loss_axes + (("pipe",) if pp else ())
    single = mesh.size == 1

    def psum(v, axes):
        return v if single else jax.lax.psum(v, axes)

    def local_grads(params, batch):
        if grad_accum > 1:
            rows = batch["labels"].shape[0]
            if rows % grad_accum:
                raise ValueError(f"per-shard batch rows {rows} must divide "
                                 f"by grad_accum={grad_accum}")
            batch = jax.tree.map(
                lambda a: a.reshape((grad_accum, rows // grad_accum)
                                    + a.shape[1:]), batch)
        # Global normaliser: parameter-independent (labels/weights only), so
        # its psum stays OUTSIDE the differentiated graph — differentiating
        # through psum under check_vma=False would scale grads by axis size.
        # Computed over ALL microbatches, so accumulated grads sum to the
        # one-big-batch gradient exactly.
        valid = batch["labels"] != -100
        w_local = valid.astype(jnp.float32)
        if "loss_weights" in batch:
            w_local = w_local * batch["loss_weights"].astype(jnp.float32)
        W = jnp.maximum(psum(jnp.sum(w_local), loss_axes), 1e-8)

        def loss_fn(params_full, mb):
            if pp:
                from plantcaduceus_tpu.parallel.pipeline import (
                    pipeline_forward)

                logits, is_last = pipeline_forward(
                    params_full, mb["input_ids"], cfg,
                    n_stages=pp_stages, n_micro=pp_microbatches,
                    dtype=dtype, remat=remat)
                nll, _ = _loss_sums(logits, mb["labels"],
                                    mb.get("loss_weights"))
                # Non-final stages carry zero logits: gate their nll out;
                # the psum over 'pipe' (outside the grad) restores the total.
                nll = jnp.where(is_last, nll, 0.0)
                return nll / W, jnp.where(is_last, logits, 0.0)
            out = caduceus.forward(
                params_full, mb["input_ids"], cfg, dtype=dtype,
                tp_axis=tp_axis, remat=remat,
                sp_axis=sp_axis, sp_shards=sp_shards,
            )
            nll, _ = _loss_sums(out["logits"], mb["labels"],
                                mb.get("loss_weights"))
            # Local share of the globally-normalised loss; grads psum in
            # _sync_grads reassembles the full gradient.
            return nll / W, out["logits"]

        def one_microbatch(params_full, mb):
            (obj, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params_full, mb)
            # masked-token accuracy (metric parity: MaskedAccuracy ignore
            # -100). Under pp only the final stage's logits are real; its
            # pred==label count is the whole numerator (gated_axes includes
            # 'pipe'; zero logits on other stages argmax to token 0, but
            # their count is excluded by dividing by the stage-replicated
            # valid total — token 0 is PAD/BOS-layout dependent, so gate
            # explicitly instead).
            pred = jnp.argmax(logits, axis=-1)
            correct = jnp.sum((pred == mb["labels"]) & (mb["labels"] != -100))
            if pp:
                correct = jnp.where(
                    jax.lax.axis_index("pipe") == pp_stages - 1, correct, 0)
            return obj, grads, correct

        params_full = params if single else _gather_fsdp(params, param_specs)
        if grad_accum == 1:
            local_obj, grads, correct = one_microbatch(params_full, batch)
        else:
            def body(carry, mb):
                obj_acc, g_acc, corr_acc = carry
                obj, g, corr = one_microbatch(params_full, mb)
                g_acc = jax.tree.map(jnp.add, g_acc, g)
                return (obj_acc + obj, g_acc, corr_acc + corr), None

            init = (jnp.zeros((), jnp.float32),
                    jax.tree.map(jnp.zeros_like, params_full),
                    jnp.zeros((), jnp.int32))
            (local_obj, grads, correct), _ = jax.lax.scan(body, init, batch)
        if not single:
            grads = _sync_grads(grads, param_specs,
                                extra_axes=("seq",) if sp else (), tp=tp,
                                pp=pp)
        loss = psum(local_obj, gated_axes)
        acc = psum(correct, gated_axes) / jnp.maximum(
            psum(jnp.sum(valid), loss_axes), 1)
        return loss, acc, grads

    seq_dim = "seq" if sp else None
    batch_spec = {
        "input_ids": P(BATCH_AXES, seq_dim),
        "labels": P(BATCH_AXES, seq_dim),
        "loss_weights": P(BATCH_AXES, seq_dim),
    }

    def grad_fn(params, batch):
        if single:
            return local_grads(params, batch)
        bspec = {k: batch_spec[k] for k in batch}
        return jax.shard_map(
            local_grads, mesh=mesh,
            in_specs=(param_specs, bspec),
            out_specs=(P(), P(), param_specs),
            check_vma=False,
        )(params, batch)

    return grad_fn


def make_train_step(
    cfg: CaduceusConfig,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    params_template,
    dtype=jnp.bfloat16,
    remat: bool = True,
    fsdp: Optional[bool] = None,
    pp_microbatches: Optional[int] = None,
    grad_accum: int = 1,
):
    """Build (init_state, train_step, eval_step).

    ``fsdp=None`` auto-enables parameter sharding when the mesh has a
    non-trivial fsdp axis. ``pp_microbatches`` sets the GPipe microbatch
    count under pipeline parallelism (default: the stage count; raising it
    shrinks the bubble — efficiency is M/(M + stages - 1) — at the cost of
    smaller per-stage matmuls). ``grad_accum=N`` expects train batches with
    N-times the microbatch rows and runs them as N sequential microbatches
    with one optimizer update (see make_grad_fn).
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if fsdp is None:
        fsdp = mesh.shape.get("fsdp", 1) > 1
    pp_stages_ = mesh.shape.get("pipe", 1)
    if pp_stages_ > 1 and (mesh.shape.get("tensor", 1) > 1
                           or mesh.shape.get("seq", 1) > 1):
        raise ValueError("pipeline parallelism combines with data/fsdp only "
                         "(parallel/pipeline.py module docstring)")
    if pp_stages_ > 1 and cfg.n_layer % pp_stages_:
        raise ValueError(f"n_layer={cfg.n_layer} must divide evenly over "
                         f"pipe={pp_stages_} stages")
    pspecs = meshlib.param_pspec_tree(params_template,
                                      replicated=not (fsdp or
                                                      mesh.shape.get("tensor", 1) > 1),
                                      pipeline=pp_stages_ > 1)
    if mesh.shape.get("tensor", 1) > 1:
        meshlib.validate_tp_grad_coverage(pspecs)
    grad_fn = make_grad_fn(cfg, mesh, pspecs, dtype=dtype, remat=remat,
                           pp_microbatches=pp_microbatches,
                           grad_accum=grad_accum)
    init_state = make_init_state(optimizer, mesh, pspecs)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, acc, grads = grad_fn(state.params, batch)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        metrics = {"loss": loss, "accuracy": acc,
                   "grad_norm": optax.global_norm(grads)}
        return TrainState(params, opt_state, state.step + 1), metrics

    single = mesh.size == 1
    tp_axis = "tensor" if mesh.shape.get("tensor", 1) > 1 else None
    sp_shards = mesh.shape.get("seq", 1)
    sp = sp_shards > 1
    pp_ev = mesh.shape.get("pipe", 1) > 1
    loss_axes = BATCH_AXES + (("seq",) if sp else ())
    gated_axes = loss_axes + (("pipe",) if pp_ev else ())

    def local_eval(params, batch):
        # forward-only (no gradients)
        psum = (lambda v, a: v) if single else jax.lax.psum
        if pp_ev:
            from plantcaduceus_tpu.parallel.pipeline import pipeline_forward

            logits, is_last = pipeline_forward(
                params, batch["input_ids"], cfg, n_stages=pp_stages_,
                n_micro=pp_microbatches, dtype=dtype, remat=False)
            gate = lambda v: jnp.where(is_last, v, jnp.zeros_like(v))
        else:
            out = caduceus.forward(
                params, batch["input_ids"], cfg, dtype=dtype,
                tp_axis=tp_axis,
                sp_axis="seq" if sp else None,
                sp_shards=sp_shards)
            logits = out["logits"]
            gate = lambda v: v
        nll, w = _loss_sums(logits, batch["labels"],
                            batch.get("loss_weights"))
        loss = psum(gate(nll), gated_axes) / jnp.maximum(
            psum(w, loss_axes), 1e-8)
        valid = batch["labels"] != -100
        pred = jnp.argmax(logits, axis=-1)
        correct = gate(jnp.sum((pred == batch["labels"]) & valid))
        acc = psum(correct, gated_axes) / jnp.maximum(
            psum(jnp.sum(valid), loss_axes), 1)
        return {"loss": loss, "accuracy": acc}

    @jax.jit
    def eval_step(state: TrainState, batch) -> Dict:
        if single:
            return local_eval(state.params, batch)

        def gathered_eval(params, batch):
            params_full = _gather_fsdp(params, pspecs)
            return local_eval(params_full, batch)

        return jax.shard_map(
            gathered_eval, mesh=mesh,
            in_specs=(pspecs,
                      {k: P(BATCH_AXES, "seq" if sp else None)
                       for k in batch}),
            out_specs={"loss": P(), "accuracy": P()},
            check_vma=False,
        )(state.params, batch)

    return init_state, train_step, eval_step
