"""int8 matmul primitives — kept from a rejected model-level experiment.

An int8 projection path for the scoring engine (dynamic per-tensor, then
static per-layer activation scales) was built and removed earlier because
it lost end to end: the projections were too small a share of the mixer,
which the selective scan dominates. On the GPU it is not measured. What
remains are the tested primitives (weight quant, static/dynamic activation
quant, int8 matmul with fused rescale) — worth measuring again where the
projections are a larger share, e.g. the SSD variants' chunked-matmul
recurrence, on tensor cores that run int8 at twice their bf16 rate.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def quantize_weight(w: jax.Array, reduce_axis: int = 0
                    ) -> Tuple[jax.Array, jax.Array]:
    """Per-output-channel symmetric int8. ``reduce_axis`` is the
    contraction axis; the scale broadcasts over the remaining axes.

    Returns (w8 int8, scale f32 with reduce_axis collapsed to size 1)."""
    w = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(w), axis=reduce_axis, keepdims=True)
    scale = jnp.maximum(amax, 1e-12) / 127.0
    w8 = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return w8, scale


def quantize_activation(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Dynamic per-tensor symmetric int8: one amax over the whole tensor
    (per-row scales would add a second elementwise pass for <0.1% accuracy
    at these distributions)."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf))
    scale = jnp.maximum(amax, 1e-12) / 127.0
    x8 = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return x8, scale


def int8_dense(x: jax.Array, w8: jax.Array, w_scale: jax.Array,
               out_dtype=jnp.float32) -> jax.Array:
    """y = x @ dequant(w8): int8 matmul with f32 rescale.

    x: [..., d_in]; w8: [d_in, d_out] int8; w_scale: [1, d_out] f32."""
    x8, sx = quantize_activation(x)
    lead = x8.shape[:-1]
    y32 = jax.lax.dot_general(
        x8.reshape(-1, x8.shape[-1]), w8,
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    y = y32.astype(jnp.float32) * (sx * w_scale)
    return y.reshape(*lead, w8.shape[-1]).astype(out_dtype)


def quantize_activation_static(x: jax.Array, a_scale: jax.Array) -> jax.Array:
    """Quantize with a pre-calibrated scale: one fused elementwise pass (no
    amax reduction — XLA folds it into the producer's epilogue). Values
    beyond the calibration range saturate at ±127, which symmetric int8
    tolerates (see :func:`calibrate`'s margin)."""
    xf = x.astype(jnp.float32)
    return jnp.clip(jnp.round(xf * (1.0 / a_scale)), -127, 127).astype(jnp.int8)


def int8_matmul(x8: jax.Array, w8: jax.Array, scale: jax.Array,
                out_dtype=jnp.float32) -> jax.Array:
    """[..., d_in] int8 @ [d_in, d_out] int8 -> int32 accumulation, rescaled by
    ``scale`` (= a_scale * w_scale, broadcastable over the output) in the
    dot's epilogue."""
    lead = x8.shape[:-1]
    y32 = jax.lax.dot_general(
        x8.reshape(-1, x8.shape[-1]), w8,
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    y = y32.astype(jnp.float32) * scale
    return y.reshape(*lead, w8.shape[-1]).astype(out_dtype)


def int8_dense_static(x: jax.Array, w8: jax.Array, w_scale: jax.Array,
                      a_scale: jax.Array, out_dtype=jnp.float32) -> jax.Array:
    """y = x @ dequant(w8) with a pre-calibrated activation scale.

    ``a_scale`` is a scalar (this layer's calibrated amax/127)."""
    return int8_matmul(quantize_activation_static(x, a_scale), w8,
                       a_scale * w_scale, out_dtype)


