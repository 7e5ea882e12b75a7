"""SSD (Mamba-2 / state-space duality) recurrence — matmul-shaped chunked form.

The reference framework has no Mamba-2 anywhere (its ``mamba-ssm==2.2.2`` pin
ships the CUDA SSD kernels, but every PlantCaduceus model is Mamba-1; see
SURVEY.md §2.2). Mamba-1's per-(channel, state) decay makes its selective
scan elementwise work, whereas Mamba-2 restricts the decay to a *scalar per
head* — which turns the whole recurrence into chunked matrix products, which
XLA hands to the GPU's tensor cores (cuBLAS). The SSD presets exist to scale
the model family that way.

Semantics (per head h with head dim P, state size N, B/C shared per group):

    dt'   = softplus(dt + dt_bias)                  [.., L, H]
    a[t]  = exp(dt'[t,h] * A[h])                    scalar per (t, h)
    S[t]  = a[t] * S[t-1] + dt'[t] * B[t] ⊗ x[t]    S: [H, N, P]
    y[t]  = C[t]ᵀ S[t] + D[h] * x[t]                [.., L, H, P]

Chunked algorithm (chunk length T; everything is a matmul):

    within chunk:  scores[t,s] = (C[t]·B[s]) * exp(cum[t]-cum[s]) * dt'[s]
                   Y_intra = scores @ X                       ([T,T]@[T,P])
    chunk state:   states = (B * dt' * decay_to_end)ᵀ @ X     ([N,T]@[T,P])
    across chunks: S[c] = exp(Σ la_c) * S[c-1] + states[c]    (lax.scan, L/T steps)
    inter:         Y_inter[t] = (C[t] @ S_prev) * exp(cum[t]) ([T,N]@[N,P])

The reverse (anticausal) direction is native — no jnp.flip of any
[.., L, ..] tensor: the in-chunk mask transposes, the cumulative decays
become exclusive/suffix sums, and the chunk-state scan runs with
``reverse=True`` (the same native reverse as the Mamba-1 scans,
ops/selective_scan.py).

All internals are float32 (the inter-chunk state recurrence especially);
inputs may be bfloat16 and the output is cast back to the input dtype.
Differentiation is ordinary XLA autodiff — unlike the Mamba-1 Triton kernel
no custom VJP is needed, and the backward is matmul-shaped too.

Shapes (group axis G = scan directions, like ops/selective_scan.py):

    x       [G, B, L, H, P]
    dt      [G, B, L, H]
    A       [G, H]                (negative reals; pass -exp(A_log))
    Bm, Cm  [G, B, L, NG, N]      (NG groups; H % NG == 0)
    Dskip   [G, H]
    dt_bias [G, H]
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp


def _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus):
    f32 = jnp.float32
    x, dt, A = x.astype(f32), dt.astype(f32), A.astype(f32)
    Bm, Cm, Dskip = Bm.astype(f32), Cm.astype(f32), Dskip.astype(f32)
    if dt_bias is not None:
        dt = dt + dt_bias.astype(f32)[:, None, None, :]
    if dt_softplus:
        dt = jax.nn.softplus(dt)
    return x, dt, A, Bm, Cm, Dskip


def ssd_sequential(
    x: jax.Array,
    dt: jax.Array,
    A: jax.Array,
    Bm: jax.Array,
    Cm: jax.Array,
    Dskip: jax.Array,
    dt_bias: Optional[jax.Array] = None,
    dt_softplus: bool = True,
    directions: Sequence[bool] = (False,),
) -> jax.Array:
    """Ground-truth sequential recurrence via ``lax.scan`` (tests / CPU).

    ``directions[g]`` = True runs group g right-to-left (anticausal), i.e.
    equivalent to flip → causal scan → flip.
    """
    out_dtype = x.dtype
    x, dt, A, Bm, Cm, Dskip = _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus)
    G, B, L, H, P = x.shape
    NG, N = Bm.shape[-2:]
    hg = H // NG

    def run_group(xg, dtg, Ag, Bg, Cg, rev):
        # xg [B,L,H,P], dtg [B,L,H], Ag [H], Bg/Cg [B,L,NG,N]
        xs = (
            jnp.moveaxis(xg, 1, 0),
            jnp.moveaxis(dtg, 1, 0),
            jnp.moveaxis(Bg, 1, 0),
            jnp.moveaxis(Cg, 1, 0),
        )
        S0 = jnp.zeros((B, H, N, P), jnp.float32)

        def step(S, inp):
            x_t, dt_t, B_t, C_t = inp  # [B,H,P] [B,H] [B,NG,N] [B,NG,N]
            a = jnp.exp(dt_t * Ag)  # [B,H]
            Bh = jnp.repeat(B_t, hg, axis=1)  # [B,H,N]
            Ch = jnp.repeat(C_t, hg, axis=1)
            S = a[..., None, None] * S + jnp.einsum(
                "bhn,bhp->bhnp", Bh * dt_t[..., None], x_t)
            y_t = jnp.einsum("bhn,bhnp->bhp", Ch, S)
            return S, y_t

        _, ys = jax.lax.scan(step, S0, xs, reverse=rev)
        return jnp.moveaxis(ys, 0, 1)  # [B,L,H,P]

    ys = [
        run_group(x[g], dt[g], A[g], Bm[g], Cm[g], bool(directions[g])
                  if g < len(directions) else False)
        for g in range(G)
    ]
    y = jnp.stack(ys) + Dskip[:, None, None, :, None] * x
    return y.astype(out_dtype)


def _chunk_group(xg, dtg, Ag, Bg, Cg, chunk, rev, mm_dtype=jnp.float32):
    """One direction of the chunked SSD. xg [B,L,H,P] fp32 (dt applied in),
    dtg [B,L,H], Ag [H], Bg/Cg [B,L,NG,N]. Returns y [B,L,H,P] fp32.

    ``mm_dtype`` is the matmul operand dtype: decays, the inter-chunk state
    and every accumulation stay fp32, but with bf16 inputs the matmul
    operands (scores, x, B, C, boundary states) are cast to bf16 — halving
    the memory traffic of the materialised [T, T, H] score blocks and
    running the tensor cores at their bf16 rate.
    """
    B, L, H, P = xg.shape
    NG, N = Bg.shape[-2:]
    hg = H // NG
    T = min(chunk, L)
    assert L % T == 0, f"L={L} not divisible by chunk={T}"
    nc = L // T
    f32 = jnp.float32

    # Head-major layout: every matmul below is a plain batched dot whose two
    # minor-most axes are the matrix dims ([T,T]@[T,P], [N,T]@[T,P],
    # [T,N]@[N,P]) rather than time-major einsums, which stride the head
    # axis through the matmul minors.
    xh = jnp.transpose(xg.reshape(B, nc, T, NG, hg, P),
                       (0, 1, 3, 4, 2, 5)).astype(mm_dtype)  # [B,nc,NG,hg,T,P]
    dth = jnp.transpose(dtg.reshape(B, nc, T, NG, hg),
                        (0, 1, 3, 4, 2))                      # [B,nc,NG,hg,T]
    Bh = jnp.transpose(Bg.reshape(B, nc, T, NG, N),
                       (0, 1, 3, 2, 4))                       # [B,nc,NG,T,N]
    Ch = jnp.transpose(Cg.reshape(B, nc, T, NG, N), (0, 1, 3, 2, 4))

    la = dth * Ag.reshape(NG, hg, 1)  # [B,nc,NG,hg,T] log-decay (negative)
    cum = jnp.cumsum(la, axis=-1)
    if not rev:
        # cum[t] = Σ_{r<=t} la[r] (inclusive). decay(t←s) = exp(cum[t]-cum[s])
        # for s <= t; decay to chunk end = exp(cum[-1]-cum[t]).
        seg = cum[..., :, None] - cum[..., None, :]  # [B,nc,NG,hg,T(t),T(s)]
        mask = jnp.tril(jnp.ones((T, T), bool))
        into = cum  # decay from chunk start to (incl.) t, applied to S_prev
        outof = cum[..., -1:] - cum  # t's contribution decay to chunk end
    else:
        # Anticausal: h[t] = a[t]*h[t+1] + dt[t]*B[t]⊗x[t]. Unrolled:
        # h[t] = Σ_{s>=t} exp(e[s]-e[t]) b[s] with e = exclusive left cumsum
        # (e[t] = Σ_{r<t} la[r]) — the mask transposes, no flips anywhere.
        e = cum - la  # exclusive left cumsum
        seg = e[..., None, :] - e[..., :, None]  # [.., t, s]: e[s]-e[t]
        mask = jnp.triu(jnp.ones((T, T), bool))
        # decay from chunk END boundary state into position t: Σ_{r>=t} la[r]
        into = cum[..., -1:] - e
        # contribution of position s to the chunk-START boundary state:
        # prod_{r<s} a[r] = exp(e[s])
        outof = e

    segexp = jnp.exp(jnp.where(mask, seg, -jnp.inf))

    # scores[t,s] = (C[t]·B[s]) * segexp[t,s] * dt'[s]  → Y_intra = scores @ x
    GBC = jnp.einsum("bcgtn,bcgsn->bcgts", Ch.astype(mm_dtype),
                     Bh.astype(mm_dtype),
                     preferred_element_type=f32)  # [B,nc,NG,T,T]
    scores = GBC[:, :, :, None] * segexp * dth[..., None, :]
    y_intra = jnp.einsum("bcghts,bcghsp->bcghtp", scores.astype(mm_dtype),
                         xh, preferred_element_type=f32)

    # chunk boundary states: [B,nc,NG,hg,N,P]
    w = Bh[:, :, :, None] * (dth * jnp.exp(outof))[..., None]
    states = jnp.einsum("bcghtn,bcghtp->bcghnp", w.astype(mm_dtype),
                        xh, preferred_element_type=f32)

    # inter-chunk recurrence over nc chunk states (tiny sequential scan).
    total = jnp.exp(jnp.sum(la, axis=-1))  # [B,nc,NG,hg]

    def step(S, inp):
        st, dec = inp  # [B,NG,hg,N,P], [B,NG,hg]
        S_prev = S
        S = dec[..., None, None] * S + st
        return S, S_prev

    _, S_prev = jax.lax.scan(
        step,
        jnp.zeros((B, NG, hg, N, P), jnp.float32),
        (jnp.moveaxis(states, 1, 0), jnp.moveaxis(total, 1, 0)),
        reverse=rev,
    )
    S_prev = jnp.moveaxis(S_prev, 0, 1)  # [B,nc,NG,hg,N,P]

    # Y_inter[t] = (C[t] @ S_boundary) * exp(into[t])
    y_inter = jnp.einsum("bcgtn,bcghnp->bcghtp", Ch.astype(mm_dtype),
                         S_prev.astype(mm_dtype),
                         preferred_element_type=f32)
    y_inter = y_inter * jnp.exp(into)[..., None]

    y = jnp.transpose(y_intra + y_inter, (0, 1, 4, 2, 3, 5))  # [B,nc,T,NG,hg,P]
    return y.reshape(B, L, H, P)


@functools.partial(jax.jit,
                   static_argnames=("dt_softplus", "chunk", "directions"))
def ssd_chunked(
    x: jax.Array,
    dt: jax.Array,
    A: jax.Array,
    Bm: jax.Array,
    Cm: jax.Array,
    Dskip: jax.Array,
    dt_bias: Optional[jax.Array] = None,
    dt_softplus: bool = True,
    chunk: int = 128,
    directions: Sequence[bool] = (False,),
) -> jax.Array:
    """Chunked (matmul) SSD — the production path on GPU and CPU alike."""
    out_dtype = x.dtype
    # bf16 activations keep bf16 matmul operands (fp32 decays/accumulation);
    # fp32 inputs get a fully-fp32 computation (tests, parity checks).
    mm_dtype = jnp.bfloat16 if out_dtype == jnp.bfloat16 else jnp.float32
    x, dt, A, Bm, Cm, Dskip = _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus)
    G = x.shape[0]
    ys = [
        _chunk_group(x[g], dt[g], A[g], Bm[g], Cm[g], chunk,
                     bool(directions[g]) if g < len(directions) else False,
                     mm_dtype=mm_dtype)
        for g in range(G)
    ]
    y = jnp.stack(ys) + Dskip[:, None, None, :, None] * x
    return y.astype(out_dtype)


def select_ssd_impl(backend: str) -> str:
    """The SSD implementation for ``backend``: the chunked XLA form on
    ``gpu`` (its matmuls go to cuBLAS) and on ``cpu``. Any other backend is
    an error."""
    if backend not in ("gpu", "cpu"):
        raise ValueError(f"no SSD implementation for backend {backend!r} "
                         "(gpu or cpu)")
    return "xla"


def ssd_dir(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk, reverse):
    """One direction of :func:`ssd_chunked` on flat shapes: x [R, L, H*P],
    dt [R, L, H] raw (bias + softplus applied inside), Bm/Cm [R, L, NG, N],
    A/Dskip/dt_bias [H]. Returns y [R, L, H*P]."""
    R, L, HP = x.shape
    H = dt.shape[-1]
    y = ssd_chunked(x.reshape(1, R, L, H, HP // H), dt[None], A[None],
                    Bm[None], Cm[None], Dskip[None], dt_bias=dt_bias[None],
                    chunk=chunk, directions=(reverse,))
    return y.reshape(R, L, HP)
