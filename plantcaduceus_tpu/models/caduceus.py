"""Caduceus in JAX: bidirectional, RC-equivariant Mamba masked LM.

Re-architecture notes (this is NOT a port of the torch remote code the
reference loads via ``trust_remote_code`` — see SURVEY.md §2.2):

The torch Caduceus composes three nested wrappers per layer — RCPS stream
wrapper, BiMamba direction wrapper, Mamba mixer — each doing its own
flips/concats and small matmuls. Here the same mathematical model is
flattened into large batched ops:

* **RC stream folding.** An RCPS layer applies the *same* weights to the
  forward stream and to the flip_LC-transformed RC stream. We therefore keep
  the RC stream permanently in its "working frame": the residual stream is a
  ``[2B, L, d]`` tensor whose rows ``B:`` hold the network state of the
  reverse-complemented input. All norms/projections/scans act on it exactly
  like on the forward rows — zero flips inside the network body. The RCPS
  frame conversions collapse into (a) embedding the reverse-complemented
  token ids as extra batch rows and (b) a single flip + complement-gather in
  the LM head / hidden-state readout. f(RC(x)) = RC(f(x)) holds exactly.

* **Direction folding.** The two scan directions of a BiMamba block share
  in_proj/out_proj (bidirectional_weight_tie) but have separate
  conv/x_proj/dt_proj/A/D. Direction becomes a leading *group* axis ``G``
  over stacked per-direction weights; the reverse direction runs an
  anticausal conv and a right-to-left scan in natural time order.

Per layer this yields exactly two full-width matmuls (in_proj, out_proj),
one grouped matmul (x_proj) and one grouped selective scan over
``[G, 2B, L, d_inner]`` — versus 8 small mamba calls in the reference
composition.

Behavioural contract reproduced (reference usage):
  * ``logits: [B, L, vocab]`` — src/zero_shot_score.py:114-118
  * ``hidden_states[-1]: [B, L, 2*d_model]`` with channel layout
    ``[fwd ‖ rc]`` — src/train_XGBoost.py:104-113, README RC-averaging
  * optional ``labels`` / ``loss_weights`` weighted masked CE —
    src/HF_pre_train.py:424-437 soft-mask semantics
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.models.config import CaduceusConfig
from plantcaduceus_tpu.ops.conv import (depthwise_conv_xla,
                                        halo_depthwise_conv_silu)
from plantcaduceus_tpu.ops.norms import layer_norm, rms_norm
from plantcaduceus_tpu.ops.selective_scan import selective_scan
from plantcaduceus_tpu.ops.seq_parallel import selective_scan_seq_sharded
from plantcaduceus_tpu.ops.ssd import select_ssd_impl, ssd_chunked
from plantcaduceus_tpu.ops.ssd_seq_parallel import ssd_dir_seq_sharded

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialisation (matches mamba_ssm defaults so pre-training behaves the same)
# ---------------------------------------------------------------------------


def _linear_init(key, fan_in, shape, dtype=jnp.float32):
    """Kaiming-uniform, torch nn.Linear default: U(-1/sqrt(fan_in), +)."""
    bound = 1.0 / math.sqrt(fan_in)
    return jax.random.uniform(key, shape, dtype, -bound, bound)


def _dt_bias_init(key, shape, dt_min=1e-3, dt_max=1e-1, dt_floor=1e-4):
    """mamba_ssm dt-bias init: softplus(bias) ~ LogUniform(dt_min, dt_max)."""
    u = jax.random.uniform(key, shape)
    dt = jnp.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = jnp.clip(dt, dt_floor, None)
    return dt + jnp.log(-jnp.expm1(-dt))  # inverse softplus


def init_params(rng: jax.Array, cfg: CaduceusConfig, dtype=jnp.float32) -> Params:
    """Build the parameter pytree. Block params are stacked on a leading
    n_layer axis so the forward pass can ``lax.scan`` over layers."""
    if cfg.ssm_variant == "mamba2":
        return _init_params_mamba2(rng, cfg, dtype)
    d, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    G = cfg.n_directions
    Gio = 1 if (cfg.bidirectional_weight_tie or G == 1) else G
    L_ = cfg.n_layer

    keys = jax.random.split(rng, 8)

    # dt_proj special init (mamba_ssm): weight U(+-dt_rank^-0.5); bias such
    # that softplus(bias) ~ LogUniform(dt_min, dt_max).
    dt_bias = _dt_bias_init(keys[0], (L_, G, di))

    A = jnp.tile(jnp.arange(1, N + 1, dtype=jnp.float32), (L_, G, di, 1))

    out_proj = _linear_init(keys[1], di, (L_, Gio, di, d))
    # rescale_prenorm_residual (mamba _init_weights): out_proj /= sqrt(2*n_layer)
    out_proj = out_proj / math.sqrt(2 * L_)

    # Packed projections are stored split (in_proj -> x/z halves; x_proj ->
    # dt/B/C) so tensor parallelism can shard every d_inner axis cleanly —
    # the torch-packed layouts interleave differently-sharded quantities.
    in_proj = _linear_init(keys[3], d, (L_, Gio, d, 2 * di))
    x_proj = _linear_init(keys[6], di, (L_, G, di, R + 2 * N))
    params: Params = {
        "embedding": (0.02 * jax.random.normal(keys[2], (cfg.vocab_size, d))).astype(dtype),
        "blocks": {
            "norm_weight": jnp.ones((L_, d), dtype),
            "in_proj_x": in_proj[..., :di].astype(dtype),
            "in_proj_z": in_proj[..., di:].astype(dtype),
            "out_proj": out_proj.astype(dtype),
            "conv_w": _linear_init(keys[4], K, (L_, G, di, K)).astype(dtype),
            "conv_b": _linear_init(keys[5], K, (L_, G, di)).astype(dtype),
            "x_proj_dt": x_proj[..., :R].astype(dtype),
            "x_proj_B": x_proj[..., R : R + N].astype(dtype),
            "x_proj_C": x_proj[..., R + N :].astype(dtype),
            "dt_proj_w": (
                jax.random.uniform(keys[7], (L_, G, R, di), jnp.float32,
                                   -(R ** -0.5), R ** -0.5)
            ).astype(dtype),
            "dt_proj_b": dt_bias.astype(jnp.float32),
            "A_log": jnp.log(A),           # fp32 always (scan numerics)
            "D": jnp.ones((L_, G, di), jnp.float32),
        },
        "norm_f_weight": jnp.ones((d,), dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = 0.02 * jax.random.normal(
            jax.random.fold_in(rng, 99), (cfg.vocab_size, d)
        ).astype(dtype)
    return params


def _init_params_mamba2(rng: jax.Array, cfg: CaduceusConfig,
                        dtype=jnp.float32) -> Params:
    """Parameter pytree for the SSD (Mamba-2) variant.

    Follows mamba_ssm ``Mamba2`` defaults where they exist (A ~ U(1, 16) per
    head, dt-bias log-uniform, D = 1, gated RMSNorm before out_proj); the
    bidirectional/RCPS composition mirrors the Mamba-1 layout: direction is a
    leading group axis G, in/out projections (and the gated-norm weight) tied
    across directions when ``bidirectional_weight_tie``. B/C/dt projections
    are per-direction (the analogue of Mamba-1's per-direction x_proj).
    """
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    H, NGN = cfg.n_heads, cfg.n_groups * cfg.d_state
    G = cfg.n_directions
    Gio = 1 if (cfg.bidirectional_weight_tie or G == 1) else G
    L_ = cfg.n_layer

    keys = jax.random.split(rng, 12)
    A = jax.random.uniform(keys[1], (L_, G, H), minval=1.0, maxval=16.0)
    in_proj = _linear_init(keys[3], d, (L_, Gio, d, 2 * di))
    out_proj = _linear_init(keys[2], di, (L_, Gio, di, d)) / math.sqrt(2 * L_)

    params: Params = {
        "embedding": (0.02 * jax.random.normal(keys[0], (cfg.vocab_size, d))).astype(dtype),
        "blocks": {
            "norm_weight": jnp.ones((L_, d), dtype),
            "in_proj_x": in_proj[..., :di].astype(dtype),
            "in_proj_z": in_proj[..., di:].astype(dtype),
            "in_proj_B": _linear_init(keys[4], d, (L_, G, d, NGN)).astype(dtype),
            "in_proj_C": _linear_init(keys[5], d, (L_, G, d, NGN)).astype(dtype),
            "in_proj_dt": _linear_init(keys[6], d, (L_, G, d, H)).astype(dtype),
            "conv_x_w": _linear_init(keys[7], K, (L_, G, di, K)).astype(dtype),
            "conv_x_b": _linear_init(keys[8], K, (L_, G, di)).astype(dtype),
            "conv_B_w": _linear_init(keys[9], K, (L_, G, NGN, K)).astype(dtype),
            "conv_B_b": jnp.zeros((L_, G, NGN), dtype),
            "conv_C_w": _linear_init(keys[10], K, (L_, G, NGN, K)).astype(dtype),
            "conv_C_b": jnp.zeros((L_, G, NGN), dtype),
            "mixer_norm_weight": jnp.ones((L_, Gio, di), dtype),
            "out_proj": out_proj.astype(dtype),
            "dt_bias": _dt_bias_init(keys[11], (L_, G, H)).astype(jnp.float32),
            "A_log": jnp.log(A),           # fp32 always (decay numerics)
            "D": jnp.ones((L_, G, H), jnp.float32),
        },
        "norm_f_weight": jnp.ones((d,), dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = 0.02 * jax.random.normal(
            jax.random.fold_in(rng, 99), (cfg.vocab_size, d)
        ).astype(dtype)
    return params


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _sp_flip(x: jax.Array, sp_axis: Optional[str], sp_shards: int,
             axis: int) -> jax.Array:
    """Flip a (possibly sequence-sharded) axis globally: local flip plus a
    shard-order reversal ppermute. With ``sp_axis=None`` it is jnp.flip.
    Differentiable (the transpose of a ppermute is the reverse ppermute)."""
    x = jnp.flip(x, axis=axis)
    if sp_axis is None or sp_shards == 1:
        return x
    return jax.lax.ppermute(
        x, sp_axis, [(i, sp_shards - 1 - i) for i in range(sp_shards)])


def rc_ids(input_ids: jax.Array, cfg: CaduceusConfig,
           sp_axis: Optional[str] = None, sp_shards: int = 1) -> jax.Array:
    """Reverse-complement token ids: complement map then reverse along L."""
    cmap = jnp.asarray(cfg.complement_map, jnp.int32)
    return _sp_flip(cmap[input_ids], sp_axis, sp_shards, axis=-1)


def _norm(x, w, cfg):
    if cfg.rms_norm:
        return rms_norm(x, w, cfg.norm_epsilon)
    return layer_norm(x, w, None, cfg.norm_epsilon)


# Manual-collective autodiff, pinned down explicitly so correctness does not
# depend on shard_map's vma mode (with check_vma=False, jax transposes psum
# as psum, which would scale gradients by the axis size):
#   * _psum_id_bwd — forward psum, backward identity: the cotangent of a
#     reduced partial is the (replicated) downstream cotangent.
#   * _tp_boundary — forward identity, backward psum: applied where
#     replicated activations enter tensor-sharded matmuls, reducing the
#     per-shard partial cotangents exactly once per layer so gradients of
#     replicated parameters are complete locally.


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _psum_id_bwd(x, axis):
    return jax.lax.psum(x, axis)


def _psum_id_bwd_fwd(x, axis):
    return jax.lax.psum(x, axis), None


def _psum_id_bwd_bwd(axis, _, g):
    return (g,)


_psum_id_bwd.defvjp(_psum_id_bwd_fwd, _psum_id_bwd_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _psum_psum_bwd(x, axis):
    return jax.lax.psum(x, axis)


def _psum_psum_bwd_fwd(x, axis):
    return jax.lax.psum(x, axis), None


def _psum_psum_bwd_bwd(axis, _, g):
    return (jax.lax.psum(g, axis),)


_psum_psum_bwd.defvjp(_psum_psum_bwd_fwd, _psum_psum_bwd_bwd)


def _maybe_psum(x, axis):
    """For reductions whose output feeds *replicated* computation (out_proj
    into the residual stream): downstream cotangent is complete, backward is
    identity."""
    return x if axis is None else _psum_id_bwd(x, axis)


def _maybe_psum_sharded_consumer(x, axis):
    """For reductions whose output feeds *sharded* computation (dt/B/C into
    the d_inner-sharded scan): each shard's backward yields only its partial
    cotangent, so the backward must psum them."""
    return x if axis is None else _psum_psum_bwd(x, axis)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tp_boundary(x, axis):
    return x


def _tp_boundary_fwd(x, axis):
    return x, None


def _tp_boundary_bwd(axis, _, g):
    return (jax.lax.psum(g, axis),)


_tp_boundary.defvjp(_tp_boundary_fwd, _tp_boundary_bwd)


# ---------------------------------------------------------------------------
# Activation-path LoRA (PEFT semantics)
# ---------------------------------------------------------------------------
#
# peft's LoraLayer computes y = W x + (alpha/r) * B A dropout(x): dropout is
# applied to the adapted projection's INPUT activations, independently per
# (batch, position, feature) — reference src/lora_fine_tune.py:609-616. The
# mixers below accept an optional ``lora`` dict
#     {"adapters": {name: {"a": [G?, in, r], "b": [G?, r, out]}},
#      "scale": alpha/r, "dropout": p, "rng": key-or-None}
# (per-layer slices; train.lora threads the stacked tree through the layer
# scan) and add the delta at each adapted projection site. With dropout off
# this is exactly equal to materialising W + scale*a@b (linearity), which is
# what merge_lora/inference do.

_LORA_SITE_IDS = {name: i for i, name in enumerate((
    "in_proj_x", "in_proj_z", "out_proj",
    "x_proj_dt", "x_proj_B", "x_proj_C",
    "in_proj_B", "in_proj_C", "in_proj_dt",
))}

# Dropout-mask sharing groups = the reference's TORCH MODULES. PEFT hangs
# ONE lora_dropout per adapted Linear (src/lora_fine_tune.py:615 targets
# in_proj/x_proj/out_proj); this framework splits those Linears into
# per-output sites (in_proj -> x/z[/B/C/dt], x_proj -> dt/B/C), so sites of
# the same torch module must share one mask draw to match PEFT semantics —
# and the shared key lets XLA CSE the (expensive) mask generation + multiply
# down to one instance per module instead of one per site.
_LORA_DROP_GROUPS = {
    "in_proj_x": 0, "in_proj_z": 0,
    "in_proj_B": 0, "in_proj_C": 0, "in_proj_dt": 0,   # mamba2 in_proj
    "x_proj_dt": 1, "x_proj_B": 1, "x_proj_C": 1,      # mamba1 x_proj
    "out_proj": 2,
}


def _lora_delta(lora, name: str, x: jax.Array, spec_a: str, spec_b: str,
                g: Optional[int] = None):
    """scale * einsum_b(einsum_a(dropout(x), a), b) for an adapted site, or
    None when the site has no adapter. ``g`` indexes the direction axis of
    the adapter (sites applied per direction, e.g. untied out_proj)."""
    if lora is None:
        return None
    ab = lora["adapters"].get(name)
    if ab is None:
        return None
    rng, p_drop = lora.get("rng"), lora.get("dropout", 0.0)
    if rng is not None and p_drop > 0:
        # One mask per TORCH MODULE per direction (see _LORA_DROP_GROUPS):
        # split sites of the same reference Linear share the draw, exactly
        # like PEFT's single lora_dropout per adapted module. Directions are
        # separate adapted modules in the torch layout, hence the g term.
        k = jax.random.fold_in(rng, _LORA_DROP_GROUPS[name] * 4 + (g or 0))
        keep = jax.random.bernoulli(k, 1.0 - p_drop, x.shape)
        x = x * keep.astype(x.dtype) / (1.0 - p_drop)
    a, b = ab["a"], ab["b"]
    if g is not None:
        a, b = a[min(g, a.shape[0] - 1)], b[min(g, b.shape[0] - 1)]
    mid = jnp.einsum(spec_a, x, a.astype(x.dtype))
    return lora["scale"] * jnp.einsum(spec_b, mid, b.astype(x.dtype))


def _add_lora(base: jax.Array, lora, name: str, x: jax.Array, spec_a: str,
              spec_b: str, g: Optional[int] = None) -> jax.Array:
    d = _lora_delta(lora, name, x, spec_a, spec_b, g)
    return base if d is None else base + d.astype(base.dtype)


def mamba_mixer(p: Params, x: jax.Array, cfg: CaduceusConfig,
                tp_axis: Optional[str] = None,
                sp_axis: Optional[str] = None, sp_shards: int = 1,
                lora=None) -> jax.Array:
    """One (Bi)Mamba mixer over ``x: [B, L, d]`` (B may include folded
    streams). ``p`` holds a single layer's parameters (no n_layer axis).

    Tensor parallelism: when ``tp_axis`` names a shard_map mesh axis, ``p``
    holds d_inner-sharded parameters; the contractions over d_inner
    (x_proj_dt/B/C and out_proj) psum partial results over that axis. All
    other mixer ops are elementwise in d_inner and stay local.

    Sequence (context) parallelism: when ``sp_axis`` names a mesh axis over
    which the L axis is sharded, the conv exchanges a K-1-row halo with the
    neighbouring shard (ppermute) and the scan runs the two-pass seeded
    scan (ops/seq_parallel.py). Requires bidirectional ``add``, tied
    in_proj, and no tensor axis.

    Flip-free bidirectional path: the reverse direction uses an anticausal
    conv (== flip∘causal-conv∘flip, computed without the flips) and the scan
    runs it right-to-left natively, with the low-rank dt projection fused
    into the scan, so no [.., L, d_inner] tensor is materialised
    time-reversed and the full-width dt never exists.
    """
    G = cfg.n_directions
    cdtype = x.dtype
    if lora is not None and (tp_axis is not None or sp_axis is not None):
        raise NotImplementedError(
            "activation-path LoRA does not compose with tensor/sequence "
            "axes; merge adapters (train.lora.merge_lora) instead")
    if tp_axis is not None:
        x = _tp_boundary(x, tp_axis)

    sp = sp_axis is not None
    tied = p["in_proj_x"].shape[0] == 1  # [Gio, d, di]; tied = released path
    if sp and not (G == 2 and tp_axis is None and tied
                   and cfg.bidirectional_strategy == "add"):
        raise NotImplementedError(
            "sequence parallelism needs bidirectional 'add', tied in_proj, "
            "and no tensor axis")

    # in_proj halves: [Gio, d, di]. Tied (Gio=1) is the released-model path.
    xi = _add_lora(jnp.einsum("bld,gdi->gbli", x, p["in_proj_x"].astype(cdtype)),
                   lora, "in_proj_x", x, "bld,gdr->gblr", "gblr,gri->gbli")
    z = _add_lora(jnp.einsum("bld,gdi->gbli", x, p["in_proj_z"].astype(cdtype)),
                  lora, "in_proj_z", x, "bld,gdr->gblr", "gblr,gri->gbli")

    conv_w = p["conv_w"].astype(cdtype)
    conv_b = p["conv_b"].astype(cdtype)
    if sp:
        # Context-parallel conv: K-1-row halo exchange with the
        # neighbouring shard (ops/conv.halo_depthwise_conv_silu).
        conv = functools.partial(halo_depthwise_conv_silu, sp_axis=sp_axis,
                                 sp_shards=sp_shards)
    else:
        conv = functools.partial(depthwise_conv_xla, activation="silu")
    xg = jnp.stack([
        conv(xi[min(g, xi.shape[0] - 1)], conv_w[g], conv_b[g],
             anticausal=(g == 1))
        for g in range(G)
    ])  # [G, B, L, di], every direction in natural time order

    # x_proj -> dt low-rank, B, C (contractions over d_inner: psum under TP).
    dt_lr = _maybe_psum_sharded_consumer(
        _add_lora(jnp.einsum("gbli,gir->gblr", xg, p["x_proj_dt"].astype(cdtype)),
                  lora, "x_proj_dt", xg, "gbli,gix->gblx", "gblx,gxr->gblr"),
        tp_axis)
    Bm = _maybe_psum_sharded_consumer(
        _add_lora(jnp.einsum("gbli,gin->gbln", xg, p["x_proj_B"].astype(cdtype)),
                  lora, "x_proj_B", xg, "gbli,gix->gblx", "gblx,gxn->gbln"),
        tp_axis)
    Cm = _maybe_psum_sharded_consumer(
        _add_lora(jnp.einsum("gbli,gin->gbln", xg, p["x_proj_C"].astype(cdtype)),
                  lora, "x_proj_C", xg, "gbli,gix->gblx", "gblx,gxn->gbln"),
        tp_axis)

    scan_args = (xg, dt_lr, -jnp.exp(p["A_log"]), Bm, Cm, p["D"])
    directions = tuple(g == 1 for g in range(G))
    if sp:
        y = selective_scan_seq_sharded(
            *scan_args, p["dt_proj_b"], p["dt_proj_w"].astype(jnp.float32),
            sp_axis, sp_shards, directions=directions, impl=cfg.scan_impl)
    else:
        y = selective_scan(
            *scan_args, dt_bias=p["dt_proj_b"],
            dt_proj_w=p["dt_proj_w"].astype(jnp.float32),
            directions=directions, impl=cfg.scan_impl)
    # y: [G, B, L, di], natural time order

    gate = jax.nn.silu(z)  # [Gio, B, L, di]

    if G == 2 and tied and cfg.bidirectional_strategy == "add":
        # Tied+add fast path: share the gate, single out_proj.
        y_sum = (y[0] + y[1]) * gate[0]
        return _maybe_psum(
            _add_lora(y_sum @ p["out_proj"][0].astype(cdtype),
                      lora, "out_proj", y_sum,
                      "bli,ir->blr", "blr,ro->blo", g=0), tp_axis)

    # General path: per-direction gate + out_proj, then combine.
    outs = []
    for g in range(G):
        zg = gate[min(g, gate.shape[0] - 1)]
        og = y[g] * zg
        W = p["out_proj"][min(g, p["out_proj"].shape[0] - 1)].astype(cdtype)
        outs.append(_maybe_psum(
            _add_lora(og @ W, lora, "out_proj", og,
                      "bli,ir->blr", "blr,ro->blo", g=g), tp_axis))
    if G == 1:
        return outs[0]
    if cfg.bidirectional_strategy == "add":
        return outs[0] + outs[1]
    return outs[0] * outs[1]  # ew_multiply


def mamba2_mixer(p: Params, x: jax.Array, cfg: CaduceusConfig,
                 tp_axis: Optional[str] = None,
                 sp_axis: Optional[str] = None, sp_shards: int = 1,
                 lora=None) -> jax.Array:
    """One (Bi)Mamba-2 (SSD) mixer over ``x: [B, L, d]``.

    Same stream/direction folding as :func:`mamba_mixer`; the recurrence is
    the matmul-shaped chunked SSD (ops/ssd.py) instead of the selective
    scan. The reverse direction runs natively anticausal (conv + SSD) — no
    time flips. Per direction: gated RMSNorm(y * silu(z)) before the (tied)
    out_proj, following mamba_ssm's Mamba2 module structure.

    Tensor parallelism: heads (and d_inner with them) shard over ``tp_axis``
    — in_proj_x/z/dt, conv_x, dt_bias/A/D, the norm weight and out_proj are
    head/d_inner-sharded; the group-shared B/C projections are REPLICATED
    (every shard's heads read the full B/C), so their weight gradients are
    per-shard partials that train.step._sync_grads psums over 'tensor'. The
    gated RMS norm reduces over the full d_inner via a collective.

    Sequence (context) parallelism: when ``sp_axis`` names a mesh axis over
    which L is sharded, the three convs (x/B/C) exchange K-1-row halos with
    the neighbouring shard (ppermute) and the recurrence runs the sharded
    SSD (ops/ssd_seq_parallel.py: local pass + closed-form boundary-state
    correction — cheaper than Mamba-1's two-pass re-scan because the SSD
    decay is scalar per head). Requires no tensor axis.
    """
    if sp_axis is not None and tp_axis is not None:
        raise NotImplementedError(
            "mamba2 mixer: tensor and sequence axes cannot combine")
    if lora is not None and (tp_axis is not None or sp_axis is not None):
        raise NotImplementedError(
            "activation-path LoRA does not compose with tensor/sequence "
            "axes; merge adapters (train.lora.merge_lora) instead")
    G = cfg.n_directions
    N = cfg.d_state
    # Local (possibly tensor-sharded) sizes come from the weights.
    H = p["in_proj_dt"].shape[-1]
    di = p["in_proj_x"].shape[-1]
    Pd = di // H
    NG = p["in_proj_B"].shape[-1] // N
    cdtype = x.dtype
    if tp_axis is not None:
        if NG > 1:
            raise NotImplementedError(
                "mamba2 tensor parallelism requires n_groups == 1 (grouped "
                "B/C would need group-aligned head sharding)")
        x = _tp_boundary(x, tp_axis)

    xi = _add_lora(jnp.einsum("bld,gdi->gbli", x, p["in_proj_x"].astype(cdtype)),
                   lora, "in_proj_x", x, "bld,gdr->gblr", "gblr,gri->gbli")
    z = _add_lora(jnp.einsum("bld,gdi->gbli", x, p["in_proj_z"].astype(cdtype)),
                  lora, "in_proj_z", x, "bld,gdr->gblr", "gblr,gri->gbli")
    Braw = _add_lora(jnp.einsum("bld,gdn->gbln", x, p["in_proj_B"].astype(cdtype)),
                     lora, "in_proj_B", x, "bld,gdr->gblr", "gblr,grn->gbln")
    Craw = _add_lora(jnp.einsum("bld,gdn->gbln", x, p["in_proj_C"].astype(cdtype)),
                     lora, "in_proj_C", x, "bld,gdr->gblr", "gblr,grn->gbln")
    dt = _add_lora(jnp.einsum("bld,gdh->gblh", x, p["in_proj_dt"].astype(cdtype)),
                   lora, "in_proj_dt", x, "bld,gdr->gblr", "gblr,grh->gblh")
    B_, L_ = x.shape[0], x.shape[1]

    select_ssd_impl(jax.default_backend())
    A = -jnp.exp(p["A_log"])

    sp = sp_axis is not None

    if sp:
        conv = functools.partial(halo_depthwise_conv_silu, sp_axis=sp_axis,
                                 sp_shards=sp_shards)
    else:
        conv = functools.partial(depthwise_conv_xla, activation="silu")
    xs, Bs, Cs = [], [], []
    for g in range(G):
        anti = g == 1
        x_in = xi[0] if xi.shape[0] == 1 else xi[g]
        xs.append(conv(x_in, p["conv_x_w"][g].astype(cdtype),
                       p["conv_x_b"][g].astype(cdtype), anticausal=anti))
        Bs.append(conv(Braw[g], p["conv_B_w"][g].astype(cdtype),
                       p["conv_B_b"][g].astype(cdtype), anticausal=anti))
        Cs.append(conv(Craw[g], p["conv_C_w"][g].astype(cdtype),
                       p["conv_C_b"][g].astype(cdtype), anticausal=anti))
    if sp:
        y = [
            ssd_dir_seq_sharded(
                xs[g], dt[g], A[g], Bs[g].reshape(B_, L_, NG, N),
                Cs[g].reshape(B_, L_, NG, N), p["D"][g], p["dt_bias"][g],
                cfg.chunk_size, g == 1, sp_axis, sp_shards)
            for g in range(G)
        ]
    else:
        y5 = ssd_chunked(
            jnp.stack(xs).reshape(G, B_, L_, H, Pd), dt, A,
            jnp.stack(Bs).reshape(G, B_, L_, NG, N),
            jnp.stack(Cs).reshape(G, B_, L_, NG, N), p["D"],
            dt_bias=p["dt_bias"], chunk=cfg.chunk_size,
            directions=tuple(g == 1 for g in range(G)),
        )
        y = [y5[g].reshape(B_, L_, H * Pd) for g in range(G)]

    gate = jax.nn.silu(z)  # [Gio, B, L, di]
    outs = []
    for g in range(G):
        zg = gate[min(g, gate.shape[0] - 1)]
        wn = p["mixer_norm_weight"][min(
            g, p["mixer_norm_weight"].shape[0] - 1)]
        u = y[g].astype(cdtype) * zg
        if tp_axis is None:
            outs.append(rms_norm(u, wn.astype(cdtype), cfg.norm_epsilon))
        else:
            # Gated RMS norm over the FULL (tensor-sharded) d_inner: the
            # mean-of-squares is a collective whose output feeds every
            # shard, so its backward psums (sharded-consumer rule).
            uf = u.astype(jnp.float32)
            ss = _maybe_psum_sharded_consumer(
                jnp.sum(uf * uf, axis=-1, keepdims=True), tp_axis)
            ms = ss / cfg.d_inner
            outs.append((uf * jax.lax.rsqrt(ms + cfg.norm_epsilon))
                        .astype(cdtype) * wn.astype(cdtype))
    if G == 2 and p["out_proj"].shape[0] == 1 \
            and cfg.bidirectional_strategy == "add":
        # Tied+add fast path: sum the normed streams, one out_proj matmul.
        o_sum = outs[0] + outs[1]
        return _maybe_psum(
            _add_lora(o_sum @ p["out_proj"][0].astype(cdtype),
                      lora, "out_proj", o_sum,
                      "bli,ir->blr", "blr,ro->blo", g=0), tp_axis)
    projs = [
        _maybe_psum(
            _add_lora(
                o @ p["out_proj"][min(g, p["out_proj"].shape[0] - 1)]
                .astype(cdtype),
                lora, "out_proj", o, "bli,ir->blr", "blr,ro->blo", g=g),
            tp_axis)
        for g, o in enumerate(outs)
    ]
    if G == 1:
        return projs[0]
    if cfg.bidirectional_strategy == "add":
        return projs[0] + projs[1]
    return projs[0] * projs[1]  # ew_multiply


def embed_residual(params: Params, input_ids: jax.Array, cfg: CaduceusConfig,
                   dtype=jnp.bfloat16, sp_axis: Optional[str] = None,
                   sp_shards: int = 1) -> jax.Array:
    """Token embedding → initial residual stream ``[S*B, L, d]`` (S=2 when
    rcps: rows B: are the RC stream), in fp32 when cfg.residual_in_fp32.
    Shared by the plain backbone scan and the pipeline-parallel schedule so
    the stream/dtype framing cannot drift between them."""
    ids = input_ids
    if cfg.rcps:
        ids = jnp.concatenate(
            [input_ids, rc_ids(input_ids, cfg, sp_axis, sp_shards)], axis=0)
    # Gather rows of the fp32 table, then cast: the backward's scatter-add
    # then accumulates in fp32 (in bf16 it loses the embedding gradient's
    # low bits over thousands of tokens per row).
    hidden = params["embedding"][ids].astype(dtype)  # [SB, L, d]
    return hidden.astype(jnp.float32 if cfg.residual_in_fp32 else dtype)


def make_block_fn(cfg: CaduceusConfig, dtype=jnp.bfloat16, *,
                  tp_axis: Optional[str] = None,
                  sp_axis: Optional[str] = None, sp_shards: int = 1,
                  collect_layers: bool = False, remat: bool = False):
    """One residual block as a ``lax.scan`` body over stacked layer params:
    res_{k+1} = res_k + mixer(norm(res_k)). The single definition used by
    every forward path (backbone scan, pipeline stages).

    ``remat=True`` rematerialises the block in the backward pass: activation
    memory drops from O(n_layer * L * d) to O(L * d) at ~33% extra FLOPs —
    the standard device-memory trade (jax.checkpoint composes with lax.scan)."""
    mixer_fn = mamba2_mixer if cfg.ssm_variant == "mamba2" else mamba_mixer

    def block_fn(res, lp):
        normed = _norm(res.astype(dtype), lp["norm_weight"], cfg)
        out = mixer_fn(lp, normed, cfg, tp_axis=tp_axis,
                       sp_axis=sp_axis, sp_shards=sp_shards)
        y = res.astype(dtype) if collect_layers else None
        return res + out.astype(res.dtype), y

    return jax.checkpoint(block_fn) if remat else block_fn


def backbone(params: Params, input_ids: jax.Array, cfg: CaduceusConfig,
             dtype=jnp.bfloat16, tp_axis: Optional[str] = None,
             remat: bool = False,
             sp_axis: Optional[str] = None, sp_shards: int = 1,
             collect_layers: bool = False, lora=None):
    """Run embedding + n_layer blocks + final norm.

    Returns the *working-frame* hidden states ``[S*B, L, d]`` where S=2 when
    rcps (rows B: are the RC stream) else 1. Use :func:`readout_hidden` to
    convert to the HF-contract ``[B, L, hidden_size]`` layout.

    ``collect_layers=True`` returns ``(final, per_layer)`` where per_layer is
    ``[n_layer, S*B, L, d]`` — each block's residual-stream input (the HF
    ``output_hidden_states`` tuple's entries 0..n_layer-1; the final
    post-norm output is the tuple's last entry).
    """
    residual = embed_residual(params, input_ids, cfg, dtype,
                              sp_axis=sp_axis, sp_shards=sp_shards)
    if lora is None:
        block_fn = make_block_fn(cfg, dtype, tp_axis=tp_axis,
                                 sp_axis=sp_axis, sp_shards=sp_shards,
                                 collect_layers=collect_layers, remat=remat)
        residual, per_layer = jax.lax.scan(block_fn, residual,
                                           params["blocks"])
    else:
        # Activation-path LoRA: per-layer adapter slices (and per-layer
        # dropout keys) ride the same layer scan as the base weights.
        mixer_fn = mamba2_mixer if cfg.ssm_variant == "mamba2" else mamba_mixer
        rngs = (jax.random.split(lora["rng"], cfg.n_layer)
                if lora.get("rng") is not None else None)
        meta = {"scale": lora["scale"], "dropout": lora.get("dropout", 0.0)}

        def block_fn(res, xs):
            lp, la, lrng = xs
            ctx = dict(meta, adapters=la, rng=lrng)
            normed = _norm(res.astype(dtype), lp["norm_weight"], cfg)
            out = mixer_fn(lp, normed, cfg, tp_axis=tp_axis,
                           sp_axis=sp_axis, sp_shards=sp_shards, lora=ctx)
            y = res.astype(dtype) if collect_layers else None
            return res + out.astype(res.dtype), y

        if remat:
            block_fn = jax.checkpoint(block_fn)
        residual, per_layer = jax.lax.scan(
            block_fn, residual, (params["blocks"], lora["adapters"], rngs))
    final = _norm(residual.astype(dtype), params["norm_f_weight"], cfg)
    return (final, per_layer) if collect_layers else final


def readout_hidden(h_work: jax.Array, cfg: CaduceusConfig,
                   sp_axis: Optional[str] = None,
                   sp_shards: int = 1) -> jax.Array:
    """Working-frame ``[S*B, L, d]`` -> HF-contract hidden states.

    For rcps: ``[B, L, 2d]`` where channels ``d:`` are the RC stream in its
    stored frame (flip length AND channels) — the layout the reference's
    RC-averaging assumes (src/train_XGBoost.py:108-113).
    """
    if not cfg.rcps:
        return h_work
    B = h_work.shape[0] // 2
    fwd, rc = h_work[:B], h_work[B:]
    rc_stored = jnp.flip(_sp_flip(rc, sp_axis, sp_shards, axis=1), axis=2)
    return jnp.concatenate([fwd, rc_stored], axis=-1)


def lm_logits(params: Params, h_work: jax.Array, cfg: CaduceusConfig,
              sp_axis: Optional[str] = None, sp_shards: int = 1) -> jax.Array:
    """MLM head. RCPS head: fwd logits + complement-permuted, time-flipped RC
    logits (equivalent to the torch RCPSLMHead applied to the stored frame)."""
    W = params.get("lm_head", params["embedding"]).astype(h_work.dtype)
    logits = h_work @ W.T  # [SB, L, V]
    if not cfg.rcps:
        return logits
    B = logits.shape[0] // 2
    fwd = logits[:B]
    cmap = jnp.asarray(cfg.complement_map, jnp.int32)
    rc = _sp_flip(logits[B:], sp_axis, sp_shards, axis=1)[..., cmap]
    out = fwd + rc
    if cfg.lm_head_strategy == "mean":
        out = out * 0.5
    return out


def forward(
    params: Params,
    input_ids: jax.Array,
    cfg: CaduceusConfig,
    dtype=jnp.bfloat16,
    output_hidden_states: bool = False,
    all_hidden_states: bool = False,
    tp_axis: Optional[str] = None,
    remat: bool = False,
    sp_axis: Optional[str] = None,
    sp_shards: int = 1,
) -> Dict[str, jax.Array]:
    """Full masked-LM forward. Returns dict with ``logits`` and optionally
    ``hidden_states`` (final layer only — the entry the reference reads).
    ``all_hidden_states=True`` additionally returns the full HF
    ``output_hidden_states`` tuple as one stacked ``[n_layer+1, B, L, 2d]``
    array (entry k = block k's residual-stream input, last entry = the
    post-norm final state == ``hidden_states``) — the intermediate-layer
    API of AutoModelForMaskedLM(output_hidden_states=True).
    ``sp_axis``/``sp_shards`` enable context parallelism: call inside shard_map with the L axis of
    ``input_ids`` sharded over that mesh axis; logits come back sharded the
    same way."""
    h_work = backbone(params, input_ids, cfg, dtype=dtype, tp_axis=tp_axis,
                      remat=remat,
                      sp_axis=sp_axis, sp_shards=sp_shards,
                      collect_layers=all_hidden_states)
    per_layer = None
    if all_hidden_states:
        h_work, per_layer = h_work
    out = {"logits": lm_logits(params, h_work, cfg, sp_axis, sp_shards)}
    if output_hidden_states or all_hidden_states:
        out["hidden_states"] = readout_hidden(h_work, cfg, sp_axis, sp_shards)
    if all_hidden_states:
        stacked = jax.vmap(
            lambda h: readout_hidden(h, cfg, sp_axis, sp_shards))(per_layer)
        out["all_hidden_states"] = jnp.concatenate(
            [stacked, out["hidden_states"][None]], axis=0)
    return out


def mlm_loss(
    logits: jax.Array,
    labels: jax.Array,
    loss_weights: Optional[jax.Array] = None,
    ignore_index: int = -100,
) -> jax.Array:
    """Weighted masked cross-entropy.

    ``labels == ignore_index`` positions contribute nothing; ``loss_weights``
    implements the soft-masked (lowercase/repeat) down-weighting of
    src/HF_pre_train.py:424-437: per-position weights multiply the CE and the
    normaliser is the weight sum over scored positions.
    """
    valid = labels != ignore_index
    labels_safe = jnp.where(valid, labels, 0)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, labels_safe[..., None], axis=-1)[..., 0]
    w = valid.astype(jnp.float32)
    if loss_weights is not None:
        w = w * loss_weights.astype(jnp.float32)
    return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1e-8)
