"""Autoregressive Mamba language model with recurrent O(1)-per-token decode.

Rebuilds the capability of the reference's Lightning Mamba sanity harness and
its use of ``mamba_ssm``'s autoregressive generation (SURVEY.md §2.3 B18:
/root/reference/pretrain/llmlib/architectures/models/mamba/{base,mamba}.py —
``MambaLMHeadModel`` + ``mamba_ssm.utils.generation.decode``, bits-per-dim
loss at base.py:35-48), in JAX:

* Training/prefill forward runs the same selective-scan stack as Caduceus
  (``ops.selective_scan`` dispatch: the Triton kernel on the GPU, the
  chunked XLA scan on the CPU) in one direction — causal conv, causal scan.
* Decoding is the SSM's native O(1) recurrence: a per-layer cache of the
  conv tail (K-1 inputs) and the fp32 SSM state [d_inner, d_state]; one
  ``step`` advances every layer with pure elementwise math plus the small
  projections — no growing KV cache, unlike attention.
* ``generate`` jit-compiles prefill + sampling as one ``lax.scan`` program —
  static shapes, no per-token Python dispatch.

The model is a plain unidirectional Mamba LM head model: embedding ->
n_layer x (RMSNorm -> Mamba mixer -> residual) -> norm -> tied LM head,
initialised with the same mamba_ssm defaults as the Caduceus blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.ops.conv import depthwise_conv_xla
from plantcaduceus_tpu.ops.norms import rms_norm
from plantcaduceus_tpu.ops.selective_scan import selective_scan
from plantcaduceus_tpu.ops.ssd import select_ssd_impl, ssd_dir

Params = Dict[str, Any]


@dataclasses.dataclass
class MambaLmConfig:
    d_model: int = 256
    n_layer: int = 4
    vocab_size: int = 256
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None
    norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    scan_impl: str = "auto"
    # "mamba1" (selective scan) or "mamba2" (SSD — scalar-per-head decay,
    # matmul-shaped chunked recurrence; same variant axis as CaduceusConfig).
    ssm_variant: str = "mamba1"
    head_dim: int = 64     # mamba2: d_inner = n_heads * head_dim
    n_groups: int = 1      # mamba2: B/C groups shared across heads
    chunk_size: int = 64   # mamba2: SSD chunk length (L % chunk_size == 0)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    def __post_init__(self):
        if self.ssm_variant not in ("mamba1", "mamba2"):
            raise ValueError(f"unknown ssm_variant {self.ssm_variant!r}")
        if self.ssm_variant == "mamba2":
            if self.d_inner % self.head_dim:
                raise ValueError(
                    f"d_inner={self.d_inner} not divisible by "
                    f"head_dim={self.head_dim}")
            if self.n_heads % self.n_groups:
                raise ValueError(
                    f"n_heads={self.n_heads} not divisible by "
                    f"n_groups={self.n_groups}")


def _linear_init(key, fan_in, shape, dtype=jnp.float32):
    bound = 1.0 / math.sqrt(fan_in)
    return jax.random.uniform(key, shape, dtype, -bound, bound)


def _dt_bias_init(key, shape):
    """softplus(bias) ~ LogUniform(1e-3, 1e-1) — mamba_ssm's dt init."""
    dt_min, dt_max, dt_floor = 1e-3, 1e-1, 1e-4
    u = jax.random.uniform(key, shape)
    dt = jnp.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = jnp.clip(dt, dt_floor, None)
    return dt + jnp.log(-jnp.expm1(-dt))  # inverse softplus


def init_params(rng: jax.Array, cfg: MambaLmConfig,
                dtype=jnp.float32) -> Params:
    """Parameter pytree; block params stacked on a leading n_layer axis so
    the forward can ``lax.scan`` over layers (same convention as
    models.caduceus.init_params, same mamba_ssm init recipe)."""
    if cfg.ssm_variant == "mamba2":
        return _init_params_mamba2(rng, cfg, dtype)
    d, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank_,
                      cfg.d_conv)
    L_ = cfg.n_layer
    keys = jax.random.split(rng, 8)

    dt_bias = _dt_bias_init(keys[0], (L_, di))

    A = jnp.tile(jnp.arange(1, N + 1, dtype=jnp.float32), (L_, di, 1))
    out_proj = _linear_init(keys[1], di, (L_, di, d)) / math.sqrt(2 * L_)
    in_proj = _linear_init(keys[3], d, (L_, d, 2 * di))
    x_proj = _linear_init(keys[6], di, (L_, di, R + 2 * N))
    params: Params = {
        "embedding": (0.02 * jax.random.normal(keys[2], (cfg.vocab_size, d))
                      ).astype(dtype),
        "blocks": {
            "norm_weight": jnp.ones((L_, d), dtype),
            "in_proj_x": in_proj[..., :di].astype(dtype),
            "in_proj_z": in_proj[..., di:].astype(dtype),
            "out_proj": out_proj.astype(dtype),
            "conv_w": _linear_init(keys[4], K, (L_, di, K)).astype(dtype),
            "conv_b": _linear_init(keys[5], K, (L_, di)).astype(dtype),
            "x_proj_dt": x_proj[..., :R].astype(dtype),
            "x_proj_B": x_proj[..., R: R + N].astype(dtype),
            "x_proj_C": x_proj[..., R + N:].astype(dtype),
            "dt_proj_w": jax.random.uniform(
                keys[7], (L_, R, di), jnp.float32, -(R ** -0.5), R ** -0.5
            ).astype(dtype),
            "dt_proj_b": dt_bias.astype(jnp.float32),
            "A_log": jnp.log(A),
            "D": jnp.ones((L_, di), jnp.float32),
        },
        "norm_f_weight": jnp.ones((d,), dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = 0.02 * jax.random.normal(
            jax.random.fold_in(rng, 99), (cfg.vocab_size, d)).astype(dtype)
    return params


def _init_params_mamba2(rng: jax.Array, cfg: MambaLmConfig,
                        dtype=jnp.float32) -> Params:
    """SSD-variant pytree — the unidirectional analogue of
    models.caduceus._init_params_mamba2 (same names, no direction axis)."""
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    H, NGN = cfg.n_heads, cfg.n_groups * cfg.d_state
    L_ = cfg.n_layer
    keys = jax.random.split(rng, 12)
    A = jax.random.uniform(keys[1], (L_, H), minval=1.0, maxval=16.0)
    in_proj = _linear_init(keys[3], d, (L_, d, 2 * di))
    params: Params = {
        "embedding": (0.02 * jax.random.normal(keys[0], (cfg.vocab_size, d))
                      ).astype(dtype),
        "blocks": {
            "norm_weight": jnp.ones((L_, d), dtype),
            "in_proj_x": in_proj[..., :di].astype(dtype),
            "in_proj_z": in_proj[..., di:].astype(dtype),
            "in_proj_B": _linear_init(keys[4], d, (L_, d, NGN)).astype(dtype),
            "in_proj_C": _linear_init(keys[5], d, (L_, d, NGN)).astype(dtype),
            "in_proj_dt": _linear_init(keys[6], d, (L_, d, H)).astype(dtype),
            "conv_x_w": _linear_init(keys[7], K, (L_, di, K)).astype(dtype),
            "conv_x_b": _linear_init(keys[8], K, (L_, di)).astype(dtype),
            "conv_B_w": _linear_init(keys[9], K, (L_, NGN, K)).astype(dtype),
            "conv_B_b": jnp.zeros((L_, NGN), dtype),
            "conv_C_w": _linear_init(keys[10], K, (L_, NGN, K)).astype(dtype),
            "conv_C_b": jnp.zeros((L_, NGN), dtype),
            "mixer_norm_weight": jnp.ones((L_, di), dtype),
            "out_proj": (_linear_init(keys[2], di, (L_, di, d))
                         / math.sqrt(2 * L_)).astype(dtype),
            "dt_bias": _dt_bias_init(keys[11], (L_, H)).astype(jnp.float32),
            "A_log": jnp.log(A),
            "D": jnp.ones((L_, H), jnp.float32),
        },
        "norm_f_weight": jnp.ones((d,), dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = 0.02 * jax.random.normal(
            jax.random.fold_in(rng, 99), (cfg.vocab_size, d)).astype(dtype)
    return params


# ---------------------------------------------------------------------------
# Parallel (training / prefill) forward
# ---------------------------------------------------------------------------


def _mixer(lp: Params, x: jax.Array, cfg: MambaLmConfig, dtype) -> jax.Array:
    """One causal Mamba mixer over [B, L, d_model] (post-norm input)."""
    R, N = cfg.dt_rank_, cfg.d_state
    xi = x @ lp["in_proj_x"].astype(dtype)
    z = x @ lp["in_proj_z"].astype(dtype)
    xg = depthwise_conv_xla(xi, lp["conv_w"], lp["conv_b"])
    dt_lr = xg @ lp["x_proj_dt"].astype(dtype)
    Bm = (xg @ lp["x_proj_B"].astype(dtype)).astype(jnp.float32)
    Cm = (xg @ lp["x_proj_C"].astype(dtype)).astype(jnp.float32)
    y = selective_scan(
        xg[None], dt_lr[None], -jnp.exp(lp["A_log"][None]), Bm[None],
        Cm[None], lp["D"][None], dt_bias=lp["dt_proj_b"][None],
        dt_proj_w=lp["dt_proj_w"][None].astype(jnp.float32),
        impl=cfg.scan_impl)[0]
    y = (y.astype(jnp.float32) * jax.nn.silu(z.astype(jnp.float32))
         ).astype(dtype)
    return y @ lp["out_proj"].astype(dtype)


def _mixer2(lp: Params, x: jax.Array, cfg: MambaLmConfig,
            dtype) -> jax.Array:
    """One causal SSD (Mamba-2) mixer over [B, L, d_model]: conv(x/B/C) +
    chunked SSD + gated RMSNorm + out_proj — the unidirectional analogue of
    models.caduceus.mamba2_mixer."""
    B_, L_ = x.shape[:2]
    N, NG = cfg.d_state, cfg.n_groups
    xi = x @ lp["in_proj_x"].astype(dtype)
    z = x @ lp["in_proj_z"].astype(dtype)
    dt = x @ lp["in_proj_dt"].astype(dtype)
    xg = depthwise_conv_xla(xi, lp["conv_x_w"].astype(dtype),
                            lp["conv_x_b"].astype(dtype), activation="silu")
    Bc = depthwise_conv_xla(x @ lp["in_proj_B"].astype(dtype),
                            lp["conv_B_w"].astype(dtype),
                            lp["conv_B_b"].astype(dtype), activation="silu")
    Cc = depthwise_conv_xla(x @ lp["in_proj_C"].astype(dtype),
                            lp["conv_C_w"].astype(dtype),
                            lp["conv_C_b"].astype(dtype), activation="silu")
    A = -jnp.exp(lp["A_log"])

    select_ssd_impl(jax.default_backend())
    y = ssd_dir(xg, dt, A, Bc.reshape(B_, L_, NG, N),
                Cc.reshape(B_, L_, NG, N), lp["D"], lp["dt_bias"],
                cfg.chunk_size, False)
    u = y.astype(dtype) * jax.nn.silu(z)
    out = rms_norm(u, lp["mixer_norm_weight"].astype(dtype), cfg.norm_epsilon)
    return out @ lp["out_proj"].astype(dtype)


def forward(params: Params, input_ids: jax.Array, cfg: MambaLmConfig,
            dtype=jnp.bfloat16) -> Dict[str, jax.Array]:
    """input_ids: [B, L] -> {"logits": [B, L, V], "hidden_states": [B, L, d]}.
    logits[t] predicts token t+1 (standard AR convention)."""
    x = params["embedding"].astype(dtype)[input_ids]
    res = x.astype(jnp.float32)
    mixer = _mixer2 if cfg.ssm_variant == "mamba2" else _mixer

    def block_fn(res, lp):
        h = rms_norm(res.astype(dtype), lp["norm_weight"], cfg.norm_epsilon)
        res = res + mixer(lp, h, cfg, dtype).astype(jnp.float32)
        return res, None

    res, _ = jax.lax.scan(block_fn, res, params["blocks"])
    h = rms_norm(res.astype(dtype), params["norm_f_weight"], cfg.norm_epsilon)
    dec = params.get("lm_head", params["embedding"]).astype(dtype)
    return {"logits": h @ dec.T, "hidden_states": h}


def nll_loss(params: Params, input_ids: jax.Array, cfg: MambaLmConfig,
             dtype=jnp.bfloat16) -> jax.Array:
    """Mean next-token cross-entropy in nats. bits/dim = nll / ln 2
    (the reference harness's bpd metric, base.py:35-48)."""
    logits = forward(params, input_ids, cfg, dtype)["logits"][:, :-1]
    targets = input_ids[:, 1:]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)
    return jnp.mean(nll)


def bits_per_dim(nll_nats: jax.Array) -> jax.Array:
    return nll_nats / math.log(2.0)


# ---------------------------------------------------------------------------
# Recurrent decode (O(1) per token)
# ---------------------------------------------------------------------------


def init_cache(cfg: MambaLmConfig, batch: int) -> Dict[str, jax.Array]:
    """Per-layer decode state: conv tails (last K-1 inputs of each conv) and
    the fp32 SSM state. Constant-size — the SSM analogue of a KV cache."""
    Lk = cfg.n_layer
    if cfg.ssm_variant == "mamba2":
        NGN = cfg.n_groups * cfg.d_state
        return {
            "conv": jnp.zeros((Lk, batch, cfg.d_conv - 1, cfg.d_inner),
                              jnp.float32),
            "conv_B": jnp.zeros((Lk, batch, cfg.d_conv - 1, NGN),
                                jnp.float32),
            "conv_C": jnp.zeros((Lk, batch, cfg.d_conv - 1, NGN),
                                jnp.float32),
            "ssm": jnp.zeros(
                (Lk, batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                jnp.float32),
        }
    return {
        "conv": jnp.zeros((Lk, batch, cfg.d_conv - 1, cfg.d_inner),
                          jnp.float32),
        "ssm": jnp.zeros((Lk, batch, cfg.d_inner, cfg.d_state),
                         jnp.float32),
    }


def _conv_step(tail, new, w, b):
    """One causal depthwise-conv output from the cached tail + this token's
    input. tail [B, K-1, D], new [B, D] -> (silu output [B, D], new tail)."""
    window = jnp.concatenate([tail, new.astype(jnp.float32)[:, None]], axis=1)
    out = jnp.einsum("bkd,dk->bd", window, w.astype(jnp.float32))
    return jax.nn.silu(out + b.astype(jnp.float32)), window[:, 1:]


def step(params: Params, cache: Dict[str, jax.Array], token: jax.Array,
         cfg: MambaLmConfig, dtype=jnp.bfloat16
         ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Advance one token. token: [B] int32 -> (logits [B, V], new cache).

    Matches ``forward``'s math exactly at every position (tested): the conv
    windows over the cached tail, the scan recurrence advances in fp32.
    """
    x = params["embedding"].astype(dtype)[token]          # [B, d]
    res = x.astype(jnp.float32)

    def layer_m1(carry, inp):
        res = carry
        lp, conv_tail, h = inp                            # [B,K-1,di], [B,di,N]
        hcur = rms_norm(res.astype(dtype), lp["norm_weight"],
                        cfg.norm_epsilon)
        xi = hcur @ lp["in_proj_x"].astype(dtype)         # [B, di]
        z = hcur @ lp["in_proj_z"].astype(dtype)
        xg, tail_new = _conv_step(conv_tail, xi, lp["conv_w"], lp["conv_b"])
        xg_c = xg.astype(dtype)
        dt_lr = xg_c @ lp["x_proj_dt"].astype(dtype)
        Bv = (xg_c @ lp["x_proj_B"].astype(dtype)).astype(jnp.float32)
        Cv = (xg_c @ lp["x_proj_C"].astype(dtype)).astype(jnp.float32)
        dt = (dt_lr @ lp["dt_proj_w"].astype(dtype)).astype(jnp.float32)
        dtp = jax.nn.softplus(dt + lp["dt_proj_b"])       # [B, di]
        A = -jnp.exp(lp["A_log"])                         # [di, N]
        a = jnp.exp(dtp[..., None] * A[None])             # [B, di, N]
        h = a * h + (dtp * xg)[..., None] * Bv[:, None, :]
        y = jnp.einsum("bdn,bn->bd", h, Cv) + lp["D"][None] * xg
        y = (y * jax.nn.silu(z.astype(jnp.float32))).astype(dtype)
        res = res + (y @ lp["out_proj"].astype(dtype)).astype(jnp.float32)
        return res, (tail_new, h)

    def layer_m2(carry, inp):
        res = carry
        lp, xt, Bt, Ct, S = inp  # tails [B,K-1,·]; S [B,H,N,P] fp32
        H, N, NG = cfg.n_heads, cfg.d_state, cfg.n_groups
        hg = H // NG
        hcur = rms_norm(res.astype(dtype), lp["norm_weight"],
                        cfg.norm_epsilon)
        xi = hcur @ lp["in_proj_x"].astype(dtype)         # [B, di]
        z = hcur @ lp["in_proj_z"].astype(dtype)
        dt = (hcur @ lp["in_proj_dt"].astype(dtype)).astype(jnp.float32)
        xg, xt_new = _conv_step(xt, xi, lp["conv_x_w"], lp["conv_x_b"])
        Bv, Bt_new = _conv_step(
            Bt, hcur @ lp["in_proj_B"].astype(dtype),
            lp["conv_B_w"], lp["conv_B_b"])               # [B, NG*N]
        Cv, Ct_new = _conv_step(
            Ct, hcur @ lp["in_proj_C"].astype(dtype),
            lp["conv_C_w"], lp["conv_C_b"])
        dtp = jax.nn.softplus(dt + lp["dt_bias"])         # [B, H]
        a = jnp.exp(dtp * -jnp.exp(lp["A_log"]))          # [B, H] scalar decay
        xh = xg.reshape(*xg.shape[:-1], H, cfg.head_dim)  # [B, H, P]
        Bh = jnp.repeat(Bv.reshape(-1, NG, N), hg, axis=1)  # [B, H, N]
        Ch = jnp.repeat(Cv.reshape(-1, NG, N), hg, axis=1)
        S = a[..., None, None] * S + jnp.einsum(
            "bhn,bhp->bhnp", Bh * dtp[..., None], xh)
        y = jnp.einsum("bhn,bhnp->bhp", Ch, S) + lp["D"][..., None] * xh
        u = y.reshape(xg.shape).astype(dtype) * jax.nn.silu(z)
        out = rms_norm(u, lp["mixer_norm_weight"].astype(dtype),
                       cfg.norm_epsilon)
        res = res + (out @ lp["out_proj"].astype(dtype)).astype(jnp.float32)
        return res, (xt_new, Bt_new, Ct_new, S)

    if cfg.ssm_variant == "mamba2":
        res, (conv_new, convB_new, convC_new, ssm_new) = jax.lax.scan(
            layer_m2, res, (params["blocks"], cache["conv"], cache["conv_B"],
                            cache["conv_C"], cache["ssm"]))
        hf = rms_norm(res.astype(dtype), params["norm_f_weight"],
                      cfg.norm_epsilon)
        dec = params.get("lm_head", params["embedding"]).astype(dtype)
        return hf @ dec.T, {"conv": conv_new, "conv_B": convB_new,
                            "conv_C": convC_new, "ssm": ssm_new}

    res, (conv_new, ssm_new) = jax.lax.scan(
        layer_m1, res, (params["blocks"], cache["conv"], cache["ssm"]))
    hf = rms_norm(res.astype(dtype), params["norm_f_weight"],
                  cfg.norm_epsilon)
    dec = params.get("lm_head", params["embedding"]).astype(dtype)
    return hf @ dec.T, {"conv": conv_new, "ssm": ssm_new}


def generate(params: Params, cfg: MambaLmConfig, prompt_ids: jax.Array,
             n_new: int, rng: Optional[jax.Array] = None,
             temperature: float = 1.0, top_k: Optional[int] = None,
             dtype=jnp.bfloat16) -> jax.Array:
    """Autoregressive sampling: [B, Lp] prompt -> [B, n_new] continuation.
    ``rng=None`` or ``temperature=0`` decodes greedily. Prefill and the
    sampling loop are each one ``lax.scan`` — a single compiled program.
    (Capability of mamba_ssm.utils.generation.decode, mamba.py:33-46.)"""
    B = prompt_ids.shape[0]
    cache = init_cache(cfg, B)

    def prefill(cache, tok):
        logits, cache = step(params, cache, tok, cfg, dtype)
        return cache, logits

    cache, logits_seq = jax.lax.scan(prefill, cache, prompt_ids.T)
    logits = logits_seq[-1]

    def pick(logits, key):
        logits = logits.astype(jnp.float32)
        if rng is None or temperature == 0:
            return jnp.argmax(logits, axis=-1).astype(prompt_ids.dtype)
        logits = logits / temperature
        if top_k is not None:
            kth = jax.lax.top_k(logits, top_k)[0][..., -1:]
            logits = jnp.where(logits < kth, -jnp.inf, logits)
        return jax.random.categorical(key, logits).astype(prompt_ids.dtype)

    keys = (jax.random.split(rng, n_new) if rng is not None
            else jnp.zeros((n_new, 2), jnp.uint32))

    def sample(carry, key):
        logits, cache = carry
        tok = pick(logits, key)
        logits, cache = step(params, cache, tok, cfg, dtype)
        return (logits, cache), tok

    _, toks = jax.lax.scan(sample, (logits, cache), keys)
    return toks.T
