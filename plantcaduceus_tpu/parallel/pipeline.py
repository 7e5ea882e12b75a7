"""GPipe-style pipeline parallelism over the Caduceus layer stack.

The reference has no pipeline parallelism (SURVEY.md §2.6 — DDP plus a
dormant fsdp hook is its entire distributed story); this implements PP
TPU-natively for the deep PlantCAD2 configs (l48 at d_model 1024/1536),
where layer-axis sharding is the natural second parameter axis once fsdp
alone stops paying:

* Block parameters are already stacked on a leading ``n_layer`` axis for the
  ``lax.scan`` over layers (models/caduceus.py init_params) — pipeline
  sharding is simply that axis placed over a ``pipe`` mesh axis. Each stage
  holds ``n_layer / n_stages`` contiguous layers.
* Inside ``shard_map`` the forward runs a microbatched GPipe schedule as one
  ``lax.scan`` with a static trip count ``n_micro + n_stages - 1``:
  per step, every stage runs its local layer stack on its in-flight
  microbatch and hands the activation to the next stage with a single
  ``ppermute`` over ICI. No data-dependent control flow — stages that are
  filling/draining compute on gated garbage that ``jnp.where`` masks out,
  which is how a bubble is expressed in SPMD.
* The schedule is fully differentiable: the transpose of ``ppermute`` is the
  reverse ``ppermute`` and the transpose of the scan is the reversed scan,
  so ``jax.grad`` derives the backward pipeline (bubbles mirrored) without
  any hand-written schedule.
* Embedding / final norm / LM head are replicated across stages; only
  stage 0 consumes the embedding and only the last stage computes the head,
  so their parameter gradients are per-stage partials that
  ``train.step._sync_grads`` psums over ``pipe`` (blocks gradients are
  stage-local and stay unsummed).

Composition: ``pipe`` combines with ``data`` and ``fsdp`` (batch shards over
(data, fsdp) and is replicated across stages; fsdp gathers happen per stage
over the stage's layer shard). ``tensor`` / ``seq`` do not combine with
``pipe`` in v1 — at the scales where PP matters the mixer is already large
enough to fill the device without intra-layer sharding.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.models import caduceus
from plantcaduceus_tpu.models.config import CaduceusConfig

AXIS = "pipe"


def pipeline_stages(blocks_local, emb_mb: jax.Array, block_fn, n_stages: int,
                    n_micro: int, axis: str = AXIS) -> jax.Array:
    """Run the GPipe schedule. Call inside ``shard_map`` with
    ``blocks_local`` holding this stage's layer shard (leading axis
    ``n_layer / n_stages``).

    ``emb_mb``: ``[n_micro, mb, L, d]`` embedded microbatches in residual
    dtype (identical on every stage; only stage 0 reads them).

    Returns ``[n_micro, mb, L, d]`` final residual-stream states — valid
    ONLY on the last stage (zeros elsewhere; gate downstream use on
    ``lax.axis_index(axis) == n_stages - 1``).
    """
    stage = jax.lax.axis_index(axis)
    n_steps = n_micro + n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def run_stage(res):
        out, _ = jax.lax.scan(block_fn, res, blocks_local)
        return out

    def step(carry, t):
        recv, outputs = carry
        mb = jax.lax.dynamic_index_in_dim(
            emb_mb, jnp.clip(t, 0, n_micro - 1), 0, keepdims=False)
        x = jnp.where(stage == 0, mb, recv)
        y = run_stage(x)
        # The last stage finishes microbatch (t - n_stages + 1) at step t.
        oi = jnp.clip(t - (n_stages - 1), 0, n_micro - 1)
        write = jnp.logical_and(stage == n_stages - 1, t >= n_stages - 1)
        prev = jax.lax.dynamic_index_in_dim(outputs, oi, 0, keepdims=False)
        outputs = jax.lax.dynamic_update_index_in_dim(
            outputs, jnp.where(write, y, prev), oi, 0)
        recv = jax.lax.ppermute(y, axis, perm)
        return (recv, outputs), None

    init = (jnp.zeros_like(emb_mb[0]), jnp.zeros_like(emb_mb))
    (_, outputs), _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return outputs


def pipeline_forward(
    params,
    input_ids: jax.Array,
    cfg: CaduceusConfig,
    *,
    n_stages: int,
    n_micro: Optional[int] = None,
    dtype=jnp.bfloat16,
    axis: str = AXIS,
    remat: bool = True,
):
    """Full masked-LM forward under pipeline parallelism.

    Call inside ``shard_map`` over a mesh with a ``pipe`` axis of size
    ``n_stages``, with ``params['blocks']`` leaves sharded on their leading
    (n_layer) axis over that axis and everything else replicated across it.

    Returns ``(logits, is_last)``: logits carry real values only where
    ``is_last`` (the final stage); gate loss/metric contributions on it and
    psum over ``axis``.
    """
    n_micro = n_micro or n_stages
    residual = caduceus.embed_residual(params, input_ids, cfg, dtype)
    SB, L, d = residual.shape
    if SB % n_micro:
        raise ValueError(
            f"pipeline microbatching needs batch rows ({SB}, streams folded) "
            f"divisible by n_micro={n_micro}")
    emb_mb = residual.reshape(n_micro, SB // n_micro, L, d)

    block_fn = caduceus.make_block_fn(cfg, dtype, remat=remat)
    outs = pipeline_stages(params["blocks"], emb_mb, block_fn,
                           n_stages, n_micro, axis)
    h_res = outs.reshape(SB, L, d)
    h_work = caduceus._norm(h_res.astype(dtype), params["norm_f_weight"], cfg)
    logits = caduceus.lm_logits(params, h_work, cfg)
    is_last = jax.lax.axis_index(axis) == n_stages - 1
    return logits, is_last
