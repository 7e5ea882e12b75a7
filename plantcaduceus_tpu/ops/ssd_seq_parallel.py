"""Sequence-parallel (context-parallel) SSD — fwd AND grad.

The Mamba-2 counterpart of ops/seq_parallel.py: shards the time axis of the
SSD recurrence (ops/ssd.py semantics) over a mesh axis. The reference has no
sequence parallelism at all (SURVEY.md §5.7); this module exists so the
beyond-reference SSD family scales past one chip's context length the same
way the Mamba-1 path does.

Structure per direction, inside ``shard_map`` — ONE local pass plus a
closed-form correction, cheaper than the Mamba-1 two-pass design:

  local:   each device runs the chunked SSD on its own chunk from a zero
           state, giving y_zero.
  summary: because the SSD decay is a *scalar per head* (the structural fact
           that makes the recurrence matmul-shaped, ops/ssd.py docstring),
           the quantities the stitch needs are closed-form and tiny:
           the whole-shard decay product  prod[b,h]   = exp(Σ_t la[t])
           and the shard's final state    F[b,h,n,p]  = Σ_t w[t]·B[t]⊗x[t]
           — one [N, L]@[L, P] matmul per head, no second scan.
  stitch:  all_gather the (prod, F) pairs over the seq axis and run the
           exclusive first-order recurrence across shards in shard order
           (reversed for the anticausal direction):
           S0_i = prod_{i-1} · S0_{i-1} + F_{i-1}.
  correct: y[t] = y_zero[t] + (C[t] @ S0) · exp(cum_into[t]) — the incoming
           boundary state's contribution, again closed-form because the
           per-position decay-from-boundary is the scalar exp(cum_into[t]).
           (Mamba-1's per-(channel, state) decay makes this term as
           expensive as the scan itself, hence its two-pass re-scan; SSD
           gets the seeded result for one extra [L, N]@[N, P] matmul.)

All stitch/correction math is plain differentiable JAX around the local SSD
core (``ops.ssd.ssd_dir``, the chunked XLA form), so ``jax.grad`` through the enclosing ``shard_map`` inserts
the adjoint collectives automatically — no hand-written cross-shard adjoint.

Every exponent above is ≤ 0 (la = softplus(dt)·A with A < 0), so no term
can overflow regardless of shard count or sequence length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.ops.ssd import ssd_dir


def _stitch_state(prod, fin, axis_name: str, n_shards: int, reverse: bool):
    """Exclusive cross-shard boundary state for THIS device. prod [B, NG, hg]
    and fin [B, NG, hg, N, P] are the local-shard summary results."""
    gp = jax.lax.all_gather(prod, axis_name)  # [n, B, NG, hg]
    gf = jax.lax.all_gather(fin, axis_name)   # [n, B, NG, hg, N, P]
    idx = jax.lax.axis_index(axis_name)
    order = range(n_shards - 1, -1, -1) if reverse else range(n_shards)
    mine = jnp.zeros_like(fin)
    carry = jnp.zeros_like(fin)
    for k in order:
        mine = jnp.where(idx == k, carry, mine)
        carry = gp[k][..., None, None] * carry + gf[k]
    return mine


def ssd_dir_seq_sharded(
    x: jax.Array,
    dt: jax.Array,
    A: jax.Array,
    Bm: jax.Array,
    Cm: jax.Array,
    Dskip: jax.Array,
    dt_bias: jax.Array,
    chunk: int,
    reverse: bool,
    seq_axis: str,
    n_shards: int,
) -> jax.Array:
    """One direction with the L axis sharded over ``seq_axis``; arguments
    hold the LOCAL chunk. Same flat contract as ssd.ssd_dir:
    x [B, Lloc, H*P], dt [B, Lloc, H] raw (bias+softplus applied inside),
    Bm/Cm [B, Lloc, NG, N], A/Dskip/dt_bias [H]. Returns the local y chunk.
    Differentiable; gradients match the single-device SSD
    (tests/test_ssd_seq_parallel.py)."""
    B, L, HP = x.shape
    H = dt.shape[-1]
    P = HP // H
    NG, N = Bm.shape[-2:]
    hg = H // NG
    f32 = jnp.float32

    # Local pass from zero state (includes the D-skip).
    y = ssd_dir(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk, reverse)

    # Shard summary + boundary correction, head-grouped shapes [.., NG, hg].
    dtp = jax.nn.softplus(dt.astype(f32) + dt_bias.astype(f32))  # [B, L, H]
    la = (dtp * A.astype(f32)).reshape(B, L, NG, hg)             # ≤ 0
    dtg = dtp.reshape(B, L, NG, hg)
    cum = jnp.cumsum(la, axis=1)
    total = cum[:, -1]  # [B, NG, hg] — Σ_t la, direction-independent
    if not reverse:
        # w[t] = dt'[t]·exp(Σ_{r>t} la[r]) decays t's contribution to the
        # shard END; S0 enters position t with exp(cum[t]) (inclusive: the
        # boundary state passes through t's own decay).
        w = dtg * jnp.exp(total[:, None] - cum)
        into = cum
    else:
        # Anticausal: e = exclusive-left cumsum. Contribution of t to the
        # shard-START boundary state decays by exp(e[t]); the shard-END
        # boundary state enters position t with exp(Σ_{r>=t} la[r]).
        e = cum - la
        w = dtg * jnp.exp(e)
        into = total[:, None] - e

    xg = x.astype(f32).reshape(B, L, NG, hg, P)
    fin = jnp.einsum("blgn,blghp->bghnp", Bm.astype(f32),
                     w[..., None] * xg)                  # [B, NG, hg, N, P]
    s0 = _stitch_state(jnp.exp(total), fin, seq_axis, n_shards, reverse)
    corr = jnp.einsum("blgn,bghnp->blghp", Cm.astype(f32), s0) \
        * jnp.exp(into)[..., None]
    return y + corr.reshape(B, L, HP).astype(y.dtype)
