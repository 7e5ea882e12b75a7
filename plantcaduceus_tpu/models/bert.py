"""MosaicBERT-capability baseline: ALiBi encoder with gated-linear-unit FFN.

The reference keeps a full MosaicBERT stack as its attention baseline
(pretrain/llmlib/architectures/models/bert/bert_layers.py: ALiBi bias
instead of position embeddings, GLU FFN, MLM loss on masked tokens). This is
the TPU-native equivalent — functional pytree params, fused attention from
ops.attention, optional RoPE with PI/NTK/YaRN context extension
(ops.rotary; the reference's rotary_embeddings.py capability) and optional
local-window attention (the xformers LocalAttention capability). Not used by
the Caduceus path; exists for architecture-baseline parity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.ops import attention as attn_ops
from plantcaduceus_tpu.ops import rotary as rope_ops
from plantcaduceus_tpu.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 16
    d_model: int = 256
    n_layer: int = 4
    n_heads: int = 8
    ffn_mult: int = 4
    glu: bool = True                 # MosaicBERT GatedLinearUnit FFN
    position: str = "alibi"          # alibi | rope | none
    rope_scaling: str = "none"       # none | interpolate | ntk | yarn
    rope_scale: float = 1.0
    rope_base: float = 10000.0
    original_max_len: int = 2048     # for rope scaling schemes
    local_window: Optional[int] = None
    norm_epsilon: float = 1e-12
    pad_token_id: int = 4

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ffn(self) -> int:
        return self.ffn_mult * self.d_model


def init_params(rng: jax.Array, cfg: BertConfig, dtype=jnp.float32) -> Params:
    d, f, L_ = cfg.d_model, cfg.d_ffn, cfg.n_layer
    ks = jax.random.split(rng, 10)

    def lin(key, fan_in, shape):
        return (jax.random.normal(key, shape) * (0.02)).astype(dtype)

    ffn_in_cols = 2 * f if cfg.glu else f
    params = {
        "embedding": lin(ks[0], d, (cfg.vocab_size, d)),
        "blocks": {
            "qkv_w": lin(ks[1], d, (L_, d, 3 * d)),
            "qkv_b": jnp.zeros((L_, 3 * d), dtype),
            "attn_out_w": lin(ks[2], d, (L_, d, d)),
            "attn_out_b": jnp.zeros((L_, d), dtype),
            "ln1_w": jnp.ones((L_, d), dtype),
            "ln1_b": jnp.zeros((L_, d), dtype),
            "ffn_in_w": lin(ks[3], d, (L_, d, ffn_in_cols)),
            "ffn_in_b": jnp.zeros((L_, ffn_in_cols), dtype),
            "ffn_out_w": lin(ks[4], f, (L_, f, d)),
            "ffn_out_b": jnp.zeros((L_, d), dtype),
            "ln2_w": jnp.ones((L_, d), dtype),
            "ln2_b": jnp.zeros((L_, d), dtype),
        },
        "emb_ln_w": jnp.ones((d,), dtype),
        "emb_ln_b": jnp.zeros((d,), dtype),
        "head_dense_w": lin(ks[5], d, (d, d)),
        "head_dense_b": jnp.zeros((d,), dtype),
        "head_ln_w": jnp.ones((d,), dtype),
        "head_ln_b": jnp.zeros((d,), dtype),
        "head_bias": jnp.zeros((cfg.vocab_size,), dtype),
    }
    return params


def forward(params: Params, input_ids: jax.Array, cfg: BertConfig,
            dtype=jnp.bfloat16) -> Dict[str, jax.Array]:
    B, L = input_ids.shape
    H, hd = cfg.n_heads, cfg.head_dim
    x = params["embedding"].astype(dtype)[input_ids]
    x = layer_norm(x, params["emb_ln_w"], params["emb_ln_b"], cfg.norm_epsilon)

    # ALiBi / local windows pass as structured forms (ops/attention.py
    # builds the bias).
    alibi = cfg.position == "alibi"
    cos = sin = None
    if cfg.position == "rope":
        cos, sin = rope_ops.rope_tables(
            L, hd, base=cfg.rope_base, scaling=cfg.rope_scaling,
            scale=cfg.rope_scale, original_max_len=cfg.original_max_len)

    def block(x, lp):
        qkv = x @ lp["qkv_w"].astype(dtype) + lp["qkv_b"].astype(dtype)
        q, k, v = jnp.split(qkv.reshape(B, L, 3 * H, hd), 3, axis=2)
        if cos is not None:
            q = rope_ops.apply_rotary(q, cos, sin)
            k = rope_ops.apply_rotary(k, cos, sin)
        a = attn_ops.multi_head_attention(q, k, v, alibi=alibi,
                                          local_window=cfg.local_window)
        a = a.reshape(B, L, cfg.d_model)
        a = a @ lp["attn_out_w"].astype(dtype) + lp["attn_out_b"].astype(dtype)
        # post-norm residual (BERT convention)
        x = layer_norm(x + a, lp["ln1_w"], lp["ln1_b"], cfg.norm_epsilon)
        h = x @ lp["ffn_in_w"].astype(dtype) + lp["ffn_in_b"].astype(dtype)
        if cfg.glu:
            gate, up = jnp.split(h, 2, axis=-1)
            h = jax.nn.gelu(gate) * up
        else:
            h = jax.nn.gelu(h)
        h = h @ lp["ffn_out_w"].astype(dtype) + lp["ffn_out_b"].astype(dtype)
        x = layer_norm(x + h, lp["ln2_w"], lp["ln2_b"], cfg.norm_epsilon)
        return x, None

    x, _ = jax.lax.scan(block, x, params["blocks"])

    # MLM head: dense+gelu+ln then tied decoder (bert_layers prediction head)
    h = jax.nn.gelu(x @ params["head_dense_w"].astype(dtype)
                    + params["head_dense_b"].astype(dtype))
    h = layer_norm(h, params["head_ln_w"], params["head_ln_b"],
                   cfg.norm_epsilon)
    logits = h @ params["embedding"].astype(dtype).T \
        + params["head_bias"].astype(dtype)
    return {"logits": logits, "hidden_states": x}
