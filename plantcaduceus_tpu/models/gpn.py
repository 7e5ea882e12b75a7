"""GPN dilated-convolution baseline masked LM.

Capability-parity port target: the reference's ConvNet genomic LM
(pretrain/llmlib/architectures/models/conv/gpn.py + modules/conv.py):
one-hot-style embedding, a stack of dilated conv layers (dilation cycling
powers of two up to a cap), each followed by layernorm and a pointwise FFN
with residuals, and the weighted-CE ``loss_weight`` forward that Caduceus
mirrors. TPU-native: dilated depthwise+pointwise convs via
lax.conv_general_dilated (layout handled by XLA).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass
class GpnConfig:
    vocab_size: int = 16
    d_model: int = 256
    n_layer: int = 8
    kernel_size: int = 9
    dilation_max: int = 32
    dilation_double_every: int = 1
    dilation_cycle: int = 6
    ffn_mult: int = 4
    norm_epsilon: float = 1e-12

    def dilation_schedule(self):
        """Reference get_dilation_schedule (modules/conv.py:97-101):
        dilation doubles every ``double_every`` layers, capped at
        ``dilation_max``, cycling with period ``cycle``."""
        return [
            min(self.dilation_max,
                2 ** ((i % self.dilation_cycle) // self.dilation_double_every))
            for i in range(self.n_layer)
        ]


def init_params(rng: jax.Array, cfg: GpnConfig, dtype=jnp.float32) -> Params:
    d, f, K = cfg.d_model, cfg.ffn_mult * cfg.d_model, cfg.kernel_size
    ks = jax.random.split(rng, 6)
    lin = lambda key, shape: (0.02 * jax.random.normal(key, shape)).astype(dtype)
    layers = []
    for i in range(cfg.n_layer):
        k = jax.random.fold_in(ks[1], i)
        kk = jax.random.split(k, 4)
        layers.append({
            "conv_w": lin(kk[0], (K, d, d)),      # [width, in, out]
            "conv_b": jnp.zeros((d,), dtype),
            "ln1_w": jnp.ones((d,), dtype), "ln1_b": jnp.zeros((d,), dtype),
            "ffn_in_w": lin(kk[1], (d, f)), "ffn_in_b": jnp.zeros((f,), dtype),
            "ffn_out_w": lin(kk[2], (f, d)), "ffn_out_b": jnp.zeros((d,), dtype),
            "ln2_w": jnp.ones((d,), dtype), "ln2_b": jnp.zeros((d,), dtype),
        })
    return {
        "embedding": lin(ks[0], (cfg.vocab_size, d)),
        "layers": layers,
        "head_w": lin(ks[2], (d, cfg.vocab_size)),
        "head_b": jnp.zeros((cfg.vocab_size,), dtype),
    }


def _dilated_conv(x: jax.Array, w: jax.Array, b: jax.Array,
                  dilation: int) -> jax.Array:
    """SAME-padded dilated conv along L. x: [B, L, d]; w: [K, d_in, d_out]."""
    y = jax.lax.conv_general_dilated(
        x, w.astype(x.dtype),
        window_strides=(1,), padding="SAME",
        rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC"),
    )
    return y + b.astype(x.dtype)


def forward(params: Params, input_ids: jax.Array, cfg: GpnConfig,
            dtype=jnp.bfloat16) -> Dict[str, jax.Array]:
    x = params["embedding"].astype(dtype)[input_ids]
    for lp, dil in zip(params["layers"], cfg.dilation_schedule()):
        h = jax.nn.gelu(_dilated_conv(x, lp["conv_w"], lp["conv_b"], dil))
        x = layer_norm(x + h, lp["ln1_w"], lp["ln1_b"], cfg.norm_epsilon)
        h = jax.nn.gelu(x @ lp["ffn_in_w"].astype(dtype)
                        + lp["ffn_in_b"].astype(dtype))
        h = h @ lp["ffn_out_w"].astype(dtype) + lp["ffn_out_b"].astype(dtype)
        x = layer_norm(x + h, lp["ln2_w"], lp["ln2_b"], cfg.norm_epsilon)
    logits = x @ params["head_w"].astype(dtype) + params["head_b"].astype(dtype)
    return {"logits": logits, "hidden_states": x}
