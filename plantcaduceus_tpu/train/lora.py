"""LoRA fine-tuning: low-rank adapters over the Mamba projections.

Reproduces the reference recipe (src/lora_fine_tune.py:608-617): rank 8,
alpha 32, dropout 0.1, targets = the Mamba-block projections in_proj /
x_proj / out_proj. In this framework those live as the split stacked tensors
in_proj_x/in_proj_z (= torch in_proj), x_proj_dt/x_proj_B/x_proj_C
(= torch x_proj), and out_proj — adapters are stacked per layer like the
base weights, and applied by materialising ``W + (alpha/r) * A@B`` on the
fly inside the loss, which keeps the backbone forward unchanged and lets
gradients flow only to the adapter/head leaves.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from plantcaduceus_tpu.models import heads
from plantcaduceus_tpu.models.config import CaduceusConfig

# The reference's target_modules = [x_proj, in_proj, out_proj]
# (src/lora_fine_tune.py:615) in this framework's split naming. Names not
# present in the model are skipped at init, so the same default covers both
# SSM variants: mamba1 has x_proj_*, mamba2 (SSD) has in_proj_B/C/dt instead.
DEFAULT_TARGETS = ("in_proj_x", "in_proj_z", "out_proj",
                   "x_proj_dt", "x_proj_B", "x_proj_C",
                   "in_proj_B", "in_proj_C", "in_proj_dt")


class LoraConfig(NamedTuple):
    r: int = 8
    alpha: float = 32.0
    dropout: float = 0.1
    targets: Tuple[str, ...] = DEFAULT_TARGETS


def init_lora(rng: jax.Array, params, cfg_l: LoraConfig,
              dtype=jnp.float32) -> Dict:
    """A ~ N(0, 1/r) on the input side, B = 0 (torch PEFT convention:
    delta starts at zero)."""
    adapters = {}
    blocks = params["blocks"]
    targets = [n for n in cfg_l.targets if n in blocks]
    if not targets:
        raise ValueError(f"no LoRA targets {cfg_l.targets} found in model")
    keys = jax.random.split(rng, len(targets))
    for k, name in zip(keys, targets):
        W = blocks[name]                       # [L, G?, in, out]
        *lead, fan_in, fan_out = W.shape
        a = jax.random.normal(k, (*lead, fan_in, cfg_l.r)) * (1.0 / cfg_l.r)
        b = jnp.zeros((*lead, cfg_l.r, fan_out))
        adapters[name] = {"a": a.astype(dtype), "b": b.astype(dtype)}
    return adapters


def apply_lora(params, adapters, cfg_l: LoraConfig):
    """Materialise effective weights: W + (alpha/r) * a @ b.

    Dropout-free application (inference/eval/export) — exactly equal to the
    activation-path formulation by linearity. Training with dropout > 0 must
    use :func:`lora_ctx` instead: PEFT applies dropout to the adapted
    projection's input activations per (batch, position, feature)
    (reference src/lora_fine_tune.py:609-616), which cannot be expressed as
    a weight perturbation.
    """
    scale = cfg_l.alpha / cfg_l.r
    blocks = dict(params["blocks"])
    for name, ab in adapters.items():
        delta = jnp.einsum("...ir,...ro->...io", ab["a"], ab["b"]) * scale
        blocks[name] = blocks[name] + delta.astype(blocks[name].dtype)
    out = dict(params)
    out["blocks"] = blocks
    return out


def lora_ctx(adapters, cfg_l: LoraConfig,
             dropout_rng: Optional[jax.Array] = None) -> dict:
    """Build the activation-path LoRA context consumed by
    models.caduceus.backbone (PEFT semantics: y = Wx + scale*B A dropout(x),
    dropout i.i.d. per batch/position/feature at each adapted module)."""
    if dropout_rng is not None and cfg_l.dropout > 0:
        dropout_rng = _rbg_key(dropout_rng)
    return {"adapters": adapters, "scale": cfg_l.alpha / cfg_l.r,
            "dropout": cfg_l.dropout, "rng": dropout_rng}


def _rbg_key(key):
    """Re-key dropout onto the rbg generator.

    LoRA training draws per-module [rows, L, d]-shaped dropout masks at
    every layer, and bit generation with the default threefry generator is
    a large share of the step (on the GPU: not measured). rbg keys
    split/fold_in deterministically, so checkpoint-resume mask replay is
    preserved; only the bit pattern differs from threefry, which no
    semantics depend on."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    data = key.astype(jnp.uint32).reshape(-1)
    return jax.random.wrap_key_data(jnp.tile(data, 4 // data.shape[0]),
                                    impl="rbg")


def merge_lora(params, adapters, cfg_l: LoraConfig):
    """Fold adapters into the base weights (inference export)."""
    return apply_lora(params, adapters, cfg_l)


class LoraTrainState(NamedTuple):
    adapters: Dict
    head: Dict
    opt_state: optax.OptState
    step: jax.Array


def make_lora_train_step(
    cfg: CaduceusConfig,
    cfg_l: LoraConfig,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    base_params,
    task_type: str = "classification",
    dtype=jnp.bfloat16,
    remat: bool = True,
    grad_accum: int = 1,
):
    """Build (init_state, train_step, infer_fn). Base params stay frozen and
    replicated; only adapters + head train (sharded batch over data axes).

    ``grad_accum=N`` expects batches with N x the microbatch rows and runs
    them sequentially with one optimizer update, against the global row
    normaliser — matching the reference recipe's
    gradient_accumulation_steps=64 default (src/lora_fine_tune.py:311-333).
    Dropout draws a distinct rng per microbatch (fold_in by index)."""
    from plantcaduceus_tpu.parallel import mesh as meshlib

    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    pspecs = meshlib.param_pspec_tree(base_params, replicated=True)
    bspec = P(("data", "fsdp"))

    def local_grads(trainable, base, batch, rng):
        rows = batch["labels"].shape[0]
        if grad_accum > 1:
            if rows % grad_accum:
                raise ValueError(f"per-shard batch rows {rows} must divide "
                                 f"by grad_accum={grad_accum}")
            batch = jax.tree.map(
                lambda a: a.reshape((grad_accum, rows // grad_accum)
                                    + a.shape[1:]), batch)
        # globally-averaged loss over ALL rows of the optimizer step: each
        # microbatch's mean is weighted by its local/global row share.
        n_global = jax.lax.psum(rows, ("data", "fsdp"))

        def loss_fn(trainable, mb, sub):
            adapters, head = trainable
            # Activation-path application: matches PEFT's per-position input
            # dropout. (With dropout == 0 this equals merged weights exactly.)
            ctx = lora_ctx(adapters, cfg_l,
                           dropout_rng=sub if cfg_l.dropout > 0 else None)
            logits = heads.sequence_logits(base, head, mb["input_ids"], cfg,
                                           dtype=dtype, remat=remat, lora=ctx)
            local = heads.task_loss(logits, mb["labels"], task_type)
            return local * mb["labels"].shape[0] / n_global

        if grad_accum == 1:
            local_obj, grads = jax.value_and_grad(loss_fn)(
                trainable, batch, rng)
        else:
            def body(carry, x):
                mb, i = x
                obj, g = jax.value_and_grad(loss_fn)(
                    trainable, mb, jax.random.fold_in(rng, i))
                return (carry[0] + obj,
                        jax.tree.map(jnp.add, carry[1], g)), None

            init = (jnp.zeros((), jnp.float32),
                    jax.tree.map(jnp.zeros_like, trainable))
            (local_obj, grads), _ = jax.lax.scan(
                body, init, (batch, jnp.arange(grad_accum)))
        grads = jax.tree.map(lambda g: jax.lax.psum(g, ("data", "fsdp")), grads)
        loss = jax.lax.psum(local_obj, ("data", "fsdp"))
        return loss, grads

    def grad_fn(trainable, base, batch, rng):
        return jax.shard_map(
            local_grads, mesh=mesh,
            in_specs=((P(), P()), pspecs,
                      {k: bspec for k in batch}, P()),
            out_specs=(P(), (P(), P())),
            check_vma=False,
        )(trainable, base, batch, rng)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def train_step(state: LoraTrainState, base, batch, rng):
        loss, grads = grad_fn((state.adapters, state.head), base, batch, rng)
        updates, opt_state = optimizer.update(
            grads, state.opt_state, (state.adapters, state.head))
        adapters, head = optax.apply_updates((state.adapters, state.head),
                                             updates)
        return LoraTrainState(adapters, head, opt_state, state.step + 1), {
            "loss": loss}

    @jax.jit
    def infer_fn(state: LoraTrainState, base, batch):
        def local(trainable, base, ids):
            adapters, head = trainable
            eff = apply_lora(base, adapters, cfg_l)
            return heads.sequence_logits(eff, head, ids, cfg, dtype=dtype)

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=((P(), P()), pspecs, bspec),
            out_specs=bspec,
            check_vma=False,
        )((state.adapters, state.head), base, batch["input_ids"])

    return train_step, infer_fn


def init_lora_state(rng: jax.Array, base_params, cfg: CaduceusConfig,
                    cfg_l: LoraConfig, num_labels: int,
                    optimizer: optax.GradientTransformation) -> LoraTrainState:
    k1, k2 = jax.random.split(rng)
    adapters = init_lora(k1, base_params, cfg_l)
    head = heads.init_head(k2, cfg, num_labels)
    opt_state = optimizer.init((adapters, head))
    return LoraTrainState(adapters, head, opt_state, jnp.zeros((), jnp.int32))


def make_full_finetune_step(
    cfg: CaduceusConfig,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    task_type: str = "classification",
    dtype=jnp.bfloat16,
    remat: bool = True,
    grad_accum: int = 1,
):
    """Full fine-tuning (reference FineTuningStrategy.FULL): every backbone
    parameter trains alongside the head. Same shard_map/collective structure
    as the LoRA step, with the base params in the trainable tuple."""
    from plantcaduceus_tpu.parallel import mesh as meshlib

    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    bspec = P(("data", "fsdp"))

    def local_grads(trainable, batch):
        rows = batch["labels"].shape[0]
        if grad_accum > 1:
            if rows % grad_accum:
                raise ValueError(f"per-shard batch rows {rows} must divide "
                                 f"by grad_accum={grad_accum}")
            batch = jax.tree.map(
                lambda a: a.reshape((grad_accum, rows // grad_accum)
                                    + a.shape[1:]), batch)
        n_global = jax.lax.psum(rows, ("data", "fsdp"))

        def loss_fn(trainable, mb):
            params, head = trainable
            logits = heads.sequence_logits(params, head, mb["input_ids"],
                                           cfg, dtype=dtype, remat=remat)
            local = heads.task_loss(logits, mb["labels"], task_type)
            return local * mb["labels"].shape[0] / n_global

        if grad_accum == 1:
            local_obj, grads = jax.value_and_grad(loss_fn)(trainable, batch)
        else:
            def body(carry, mb):
                obj, g = jax.value_and_grad(loss_fn)(trainable, mb)
                return (carry[0] + obj,
                        jax.tree.map(jnp.add, carry[1], g)), None

            init = (jnp.zeros((), jnp.float32),
                    jax.tree.map(jnp.zeros_like, trainable))
            (local_obj, grads), _ = jax.lax.scan(body, init, batch)
        grads = jax.tree.map(lambda g: jax.lax.psum(g, ("data", "fsdp")), grads)
        return jax.lax.psum(local_obj, ("data", "fsdp")), grads

    def grad_fn(trainable, batch):
        pspecs = jax.tree.map(lambda _: P(), trainable)
        return jax.shard_map(
            local_grads, mesh=mesh,
            in_specs=(pspecs, {k: bspec for k in batch}),
            out_specs=(P(), pspecs),
            check_vma=False,
        )(trainable, batch)

    @functools.partial(jax.jit, donate_argnums=(0,), static_argnames=())
    def _step(state, batch):
        trainable = (state.adapters, state.head)  # adapters slot = params
        loss, grads = grad_fn(trainable, batch)
        updates, opt_state = optimizer.update(grads, state.opt_state, trainable)
        params, head = optax.apply_updates(trainable, updates)
        return LoraTrainState(params, head, opt_state, state.step + 1), {
            "loss": loss}

    def train_step(state, base_unused, batch, rng_unused=None):
        # same call signature as the LoRA step (base/rng ignored)
        return _step(state, batch)

    @jax.jit
    def infer_fn(state, base_unused, batch):
        def local(trainable, ids):
            params, head = trainable
            return heads.sequence_logits(params, head, ids, cfg, dtype=dtype)

        pspecs = jax.tree.map(lambda _: P(), (state.adapters, state.head))
        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(pspecs, bspec), out_specs=bspec,
            check_vma=False,
        )((state.adapters, state.head), batch["input_ids"])

    return train_step, infer_fn


# ---------------------------------------------------------------------------
# Adapter persistence (the PEFT-adapter-dir analogue, SURVEY.md §5.4)
# ---------------------------------------------------------------------------


def save_adapter(directory, state: LoraTrainState, cfg_l: LoraConfig,
                 task_type: str, base_model: str) -> None:
    import json
    from pathlib import Path

    from plantcaduceus_tpu.train.checkpoint import save_tree

    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "adapter_config.json").write_text(json.dumps({
        "r": cfg_l.r, "alpha": cfg_l.alpha, "dropout": cfg_l.dropout,
        "targets": list(cfg_l.targets), "task_type": task_type,
        "base_model_name_or_path": str(base_model),
    }, indent=2))
    save_tree(directory / "adapter.npz",
              {"adapters": state.adapters, "head": state.head})


def load_adapter(directory):
    """-> (adapters, head, LoraConfig, task_type, base_model_name)."""
    import json
    from pathlib import Path

    from plantcaduceus_tpu.train.checkpoint import load_tree

    directory = Path(directory).absolute()
    meta = json.loads((directory / "adapter_config.json").read_text())
    tree = load_tree(directory / "adapter.npz")
    cfg_l = LoraConfig(r=meta["r"], alpha=meta["alpha"],
                       dropout=meta["dropout"],
                       targets=tuple(meta["targets"]))
    return (tree.get("adapters", {}), tree.get("head", {}), cfg_l,
            meta["task_type"], meta["base_model_name_or_path"])


def save_train_state(directory, state: LoraTrainState, cfg_l: LoraConfig,
                     task_type: str, base_model: str) -> None:
    """Adapter dir + optimizer/step state: a checkpoint-N a later run can
    resume from with full fidelity (the reference's resume_from_checkpoint —
    src/lora_fine_tune.py:271,349-353). The adapter part stays loadable by
    evaluate/predict like any exported adapter."""
    from pathlib import Path

    from plantcaduceus_tpu.train.checkpoint import save_tree

    save_adapter(directory, state, cfg_l, task_type, base_model)
    save_tree(Path(directory).absolute() / "train_state.npz",
              {"opt_state": state.opt_state,
               "step": jnp.asarray(state.step, jnp.int32)})


def load_train_state(directory, optimizer) -> Tuple[LoraTrainState,
                                                    LoraConfig, str, str]:
    """Restore a full LoraTrainState (adapters + head + optimizer + step)
    from a save_train_state checkpoint dir.
    -> (state, LoraConfig, task_type, base_model_name)."""
    from pathlib import Path

    from plantcaduceus_tpu.train.checkpoint import load_tree

    directory = Path(directory).absolute()
    adapters, head, cfg_l, task_type, base = load_adapter(directory)
    adapters = jax.tree.map(jnp.asarray, adapters)
    head = jax.tree.map(jnp.asarray, head)
    ts_file = directory / "train_state.npz"
    if not ts_file.exists():
        raise FileNotFoundError(
            f"{directory} has no train_state.npz — it is an adapter export, "
            "not a resumable training checkpoint")
    # The optimizer's init tree is the restore template (it carries the
    # pytree structure of the optax NamedTuple states).
    template = {"opt_state": optimizer.init((adapters, head)),
                "step": jnp.zeros((), jnp.int32)}
    tree = load_tree(ts_file, template)
    state = LoraTrainState(adapters, head, tree["opt_state"],
                           jnp.asarray(tree["step"], jnp.int32))
    return state, cfg_l, task_type, base
