"""Attention ops for the baseline (BERT-family) models.

Replacement for the reference's attention kernel zoo (SURVEY.md §2.5): the
flash_attn CUDA wheel, the vendored 1.1k-line Triton kernel, and the
xformers backends. Attention only serves the BERT/GPN baselines, at the
reference's 512-bp windows, so the implementation is a fused-by-XLA
einsum+softmax with additive bias — the hand-written kernel is reserved for
the SSM scan, where the time actually goes. Provides:

* ``multi_head_attention`` — bias-capable (ALiBi) bidirectional attention
* ``alibi_bias`` — MosaicBERT's symmetric ALiBi bias, rebuilt on demand for
  any length (bert_layers.py:458-512 capability)
* ``local_window_mask`` — banded mask (xformers LocalAttention capability)
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp


def alibi_slopes(n_heads: int) -> jax.Array:
    """ALiBi head slopes (power-of-two geometric schedule, extended for
    non-power-of-two head counts)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        s = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        s = pow2_slopes(closest)
        extra = pow2_slopes(2 * closest)[0::2][: n_heads - closest]
        s = s + extra
    return jnp.asarray(s, jnp.float32)


def alibi_bias(n_heads: int, seq_len: int) -> jax.Array:
    """Symmetric (bidirectional-encoder) ALiBi bias [n_heads, L, L]:
    -slope * |i - j| (MosaicBERT uses the non-causal distance form)."""
    pos = jnp.arange(seq_len)
    dist = jnp.abs(pos[None, :] - pos[:, None]).astype(jnp.float32)
    return -alibi_slopes(n_heads)[:, None, None] * dist[None]


def local_window_mask(seq_len: int, window: int) -> jax.Array:
    """[L, L] additive mask: 0 within +-window, -inf outside."""
    pos = jnp.arange(seq_len)
    dist = jnp.abs(pos[None, :] - pos[:, None])
    return jnp.where(dist <= window, 0.0, -jnp.inf).astype(jnp.float32)


def select_attention_impl(backend: str) -> str:
    """The attention implementation for ``backend``: the plain XLA form on
    ``gpu`` and ``cpu``. Any other backend is an error."""
    if backend not in ("gpu", "cpu"):
        raise ValueError(f"no attention implementation for backend "
                         f"{backend!r} (gpu or cpu)")
    return "xla"


def multi_head_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    bias: Optional[jax.Array] = None,
    mask: Optional[jax.Array] = None,
    causal: bool = False,
    alibi: bool = False,
    local_window: Optional[int] = None,
) -> jax.Array:
    """q, k, v: [B, L, H, hd]. bias: broadcastable to [B, H, L, L]
    (e.g. alibi_bias -> [H, L, L]). mask: additive, same broadcast.
    Returns [B, L, H, hd]. Softmax in fp32.

    Structured bias forms — ``alibi=True`` (symmetric MosaicBERT ALiBi) and
    ``local_window`` — may be given instead of materialised bias/mask
    arrays."""
    select_attention_impl(jax.default_backend())
    if alibi and bias is not None:
        raise ValueError("pass either alibi=True or an explicit bias")
    if alibi:
        bias = alibi_bias(q.shape[2], q.shape[1])
    if local_window is not None:
        lw = local_window_mask(q.shape[1], local_window)
        mask = lw if mask is None else mask + lw
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    logits = jnp.einsum("blhd,bmhd->bhlm", q, k).astype(jnp.float32) * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits + mask
    if causal:
        L = q.shape[1]
        cm = jnp.where(jnp.arange(L)[None, :] <= jnp.arange(L)[:, None],
                       0.0, -jnp.inf)
        logits = logits + cm
    probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
    return jnp.einsum("bhlm,bmhd->blhd", probs, v)
