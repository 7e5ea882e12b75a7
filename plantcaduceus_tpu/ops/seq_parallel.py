"""Sequence-parallel (context-parallel) selective scan — fwd AND grad.

Shards the time axis over a mesh axis — the SSM long-context strategy the
reference never needed (SURVEY.md §5.7 records it as a design option): a
linear recurrence splits across chips with only an ``[rows, D, N]`` state
exchange per shard boundary, unlike attention's all-to-all.

Two-pass scan-correct structure per direction group, inside ``shard_map``:

  pass 1: each device scans its local chunk from zero, emitting its final
          state F; the chunk's decay product P is computed OUTSIDE the
          kernel as ``exp(A · Σ_t softplus(dt_t))`` — a product of exps is
          the exp of a sum, so it costs one elementwise pass over [B, L, D]
          instead of an extra per-state multiply inside the kernel.
  stitch: all_gather the tiny (P, F) pairs over the seq axis and run the
          exclusive first-order recurrence across devices in shard order
          (reversed for reverse-direction groups):
          h0_i = P_{i-1} h0_{i-1} + F_{i-1}.
  pass 2: each device re-scans its chunk seeded with its h0.

Cost: 2x the scan compute + two tiny collectives — the standard trade for
sequence lengths that exceed one chip.

Both passes run the seeded form of the selected scan implementation
(``ops.selective_scan``: the Triton kernel on the GPU, the chunked XLA scan
on the CPU), which takes an initial state and returns the final one and is
differentiable in both. Everything else (the stitch, the decay product, the
all_gather) is plain JAX, so ``jax.grad`` through ``shard_map`` inserts the
adjoint collectives automatically — no hand-written cross-shard adjoint.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.ops.selective_scan import (select_scan_impl,
                                                  selective_scan)


def _decay_product(dt, A, dt_bias, dt_proj_w):
    """P[g, b, d, n] = prod_t exp(softplus(dt)[g,b,t,d] * A[g,d,n]) over the
    LOCAL chunk, as exp of the time-summed rates. Direction-independent (it
    is a product over the whole chunk either way). Differentiable JAX."""
    f32 = jnp.float32
    dtr = dt.astype(f32)
    if dt_proj_w is not None:
        dtr = jnp.einsum("gblr,gri->gbli", dtr, dt_proj_w.astype(f32))
    s = jnp.sum(jax.nn.softplus(dtr + dt_bias.astype(f32)[:, None, None, :]),
                axis=2)                                   # [G, B, D]
    return jnp.exp(s[..., None] * A.astype(f32)[:, None])  # [G, B, D, N]


def _stitch_h0(aprod, hfin, axis_name: str, n_shards: int, reverse: bool):
    """Exclusive cross-shard state: h0 for THIS device. aprod/hfin are the
    local [B, D, N] pass-1 results of one group."""
    pf = jax.lax.all_gather(
        jnp.stack([aprod, hfin]), axis_name)          # [n, 2, B, D, N]
    idx = jax.lax.axis_index(axis_name)
    order = range(n_shards - 1, -1, -1) if reverse else range(n_shards)
    h0_mine = jnp.zeros_like(hfin)
    carry = jnp.zeros_like(hfin)
    for k in order:
        h0_mine = jnp.where(idx == k, carry, h0_mine)
        carry = pf[k, 0] * carry + pf[k, 1]
    return h0_mine


def selective_scan_seq_sharded(
    x: jax.Array,
    dt: jax.Array,
    A: jax.Array,
    Bm: jax.Array,
    Cm: jax.Array,
    Dskip: jax.Array,
    dt_bias: jax.Array,
    dt_proj_w: Optional[jax.Array],
    seq_axis: str,
    n_shards: int,
    directions: Optional[Sequence[bool]] = None,
    impl: str = "auto",
) -> jax.Array:
    """Run inside shard_map with the L axis of x/dt/Bm/Cm sharded over
    ``seq_axis`` (arguments hold the LOCAL chunk). Same group semantics as
    ``ops.selective_scan.selective_scan``. Returns the local y chunk.
    Differentiable: ``jax.grad`` through the enclosing shard_map yields
    gradients identical to the single-device scan
    (tests/test_seq_parallel.py). The reference impls (sequential,
    associative) have no seeded form; they run the chunked scan here."""
    impl = select_scan_impl(jax.default_backend(), impl)
    if impl not in ("triton", "chunked"):
        impl = "chunked"
    G = x.shape[0]
    dirs = tuple(bool(d) for d in directions) if directions else (False,) * G

    def scan(h0):
        return selective_scan(x, dt, A, Bm, Cm, Dskip, dt_bias=dt_bias,
                              dt_proj_w=dt_proj_w, directions=dirs, h0=h0,
                              impl=impl, return_final_state=True)

    aprod = _decay_product(dt, A, dt_bias, dt_proj_w)
    # pass 1: local scan from zero; keep only the final state
    _, hfin = scan(jnp.zeros_like(aprod))
    h0 = jnp.stack([_stitch_h0(aprod[g], hfin[g], seq_axis, n_shards, dirs[g])
                    for g in range(G)])
    # pass 2: re-scan seeded with the stitched state
    y, _ = scan(h0)
    return y
