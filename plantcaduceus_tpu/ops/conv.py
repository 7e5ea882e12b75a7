"""Short causal depthwise convolution — the Mamba conv prologue.

Replaces the reference's ``causal_conv1d`` CUDA kernel
(its env/requirements.txt pins causal-conv1d==1.4.0) with XLA's
depthwise convolution.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def depthwise_conv_xla(
    x: jax.Array,
    w: jax.Array,
    b: Optional[jax.Array] = None,
    activation: Optional[str] = "silu",
    anticausal: bool = False,
) -> jax.Array:
    """Depthwise causal 1-D convolution of ``x: [B, L, D]`` with per-channel
    taps ``w: [D, K]`` (tap K-1 multiplies the current step) and bias
    ``b: [D]``, through XLA's native depthwise convolution.

    Equivalent to torch ``nn.Conv1d(D, D, K, groups=D, padding=K-1)[..., :L]``
    as used inside ``mamba_ssm.Mamba`` (see SURVEY.md §2.2).

    ``anticausal=True`` computes ``flip_L(causal_conv(flip_L(x), w, b))``
    without the flips — the reverse-direction conv of a bidirectional block
    in natural time order (output at t looks at x[t .. t+K-1] through
    reversed taps)."""
    K = w.shape[-1]
    taps = jnp.flip(w, -1) if anticausal else w
    # WIO with feature_group_count=D: [K, 1, D]
    kernel = jnp.transpose(taps, (1, 0))[:, None, :].astype(x.dtype)
    pad = (0, K - 1) if anticausal else (K - 1, 0)
    y = jax.lax.conv_general_dilated(
        x, kernel, window_strides=(1,), padding=[pad],
        dimension_numbers=("NWC", "WIO", "NWC"),
        feature_group_count=x.shape[-1])
    if b is not None:
        y = y + b[None, None, :].astype(x.dtype)
    if activation == "silu":
        y = jax.nn.silu(y)
    return y


def halo_depthwise_conv_silu(
    inp: jax.Array,
    w: jax.Array,
    b: jax.Array,
    anticausal: bool,
    sp_axis: str,
    sp_shards: int,
) -> jax.Array:
    """Context-parallel depthwise conv over a sequence-sharded ``inp:
    [B, Llocal, D]``: the K-1 boundary rows are ppermuted from the
    neighbouring shard (next shard for the anticausal direction, previous
    for the causal one); sequence-edge shards receive zeros from the
    ppermute, which equals the conv's own causal zero-padding. Fully
    differentiable — ppermute's transpose is the reverse ppermute. Shared
    by both SSM variants' mixers (models/caduceus.py)."""
    K = w.shape[-1]
    if anticausal:  # halo = next shard's first K-1 rows
        halo = jax.lax.ppermute(
            inp[:, : K - 1], sp_axis,
            [(i, i - 1) for i in range(1, sp_shards)])
        ext = jnp.concatenate([inp, halo], axis=1)
        return depthwise_conv_xla(ext, w, b, activation="silu",
                                  anticausal=True)[:, : inp.shape[1]]
    halo = jax.lax.ppermute(
        inp[:, -(K - 1):], sp_axis,
        [(i, i + 1) for i in range(sp_shards - 1)])
    ext = jnp.concatenate([halo, inp], axis=1)
    return depthwise_conv_xla(ext, w, b, activation="silu")[:, K - 1:]
