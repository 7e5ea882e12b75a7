"""Selective scan as a Pallas kernel through Triton, for NVIDIA GPUs.

Same contract as ``ops.selective_scan.selective_scan_chunked`` (groups,
per-group directions, fused low-rank dt projection, initial state in, final
state out), after the design of mamba_ssm's ``selective_scan_cuda``:

* **Forward.** The grid runs over (rows = direction groups x batch, blocks
  of ``bd`` channels). Each program walks the sequence once, holding its
  state ``h [bd, N]`` in fp32 registers. Per step it reads x, dt (or the
  low-rank dt, projected up by ``W_dt`` in the kernel), B and C once and
  writes only y: softplus(dt + bias), the discretisation, the C read-out and
  the D skip all happen in registers. A reverse group walks its row
  right-to-left by index, so nothing is flipped in memory. Any D and any L
  are handled by masking. Under differentiation it also stores the state at
  the start of every ``T``-step chunk.
* **Backward.** Each program walks the chunks in reverse processing order.
  It recomputes a chunk's ``T`` states in registers from the stored chunk
  state, then runs the adjoint recurrence back through them; the states of
  the whole sequence are never stored. Reductions over channels (dB, dC and
  the low-rank ddt) are written per channel block and summed outside; those
  over batch and time (dA, dD, ddt_bias, dW_dt) accumulate in registers and
  are written per row.

The kernels only compile for the GPU. CPU tests run them with
``interpret=True``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Block sizes from a sweep on an H100 at l20 widths (PERF.md): one warp per
# program and short recompute chunks win; longer chunks spill registers and
# compile for minutes (the backward unrolls each chunk).
FWD_BD = 32    # channels per forward program
BWD_BD = 32    # channels per backward program (holds T + 1 states)
CHUNK_T = 4    # time steps per stored state / backward recompute chunk
FWD_WARPS = 1
BWD_WARPS = 1
_LOG2E = 1.4426950408889634


def _pow2(n: int) -> int:
    return max(1, 1 << (int(n) - 1).bit_length())


def _softplus(v):
    # mamba_ssm's form: identity above 20, where log1p(exp(v)) == v in fp32.
    return jnp.where(v > 20.0, v, jnp.log1p(jnp.exp(jnp.minimum(v, 20.0))))


def _is_reverse(g, directions):
    rev = jnp.zeros((), jnp.bool_)
    for k, flag in enumerate(directions):
        if flag:
            rev = rev | (g == k)
    return rev


class _Block:
    """Index vectors and masks of one program: its row, its channel block,
    the state axis and the low-rank dt axis (padded to powers of two)."""

    def __init__(self, B, D, N, K, bd, directions):
        self.r = pl.program_id(0)
        self.blk = pl.program_id(1)
        self.g = self.r // B
        self.rev = _is_reverse(self.g, directions)
        self.d = self.blk * bd + jnp.arange(bd)
        self.dm = self.d < D
        self.n = jnp.arange(_pow2(N))
        self.nm = self.n < N
        self.k = jnp.arange(_pow2(K))
        self.km = self.k < K
        self.dn = (self.d[:, None], self.n[None, :])
        self.dnm = self.dm[:, None] & self.nm[None, :]

    def time(self, i, L):
        ok = i < L
        return jnp.where(self.rev, L - 1 - i, i), ok


def _load_params(blk, A_ref, D_ref, dtb_ref, w_ref, fused):
    f32 = jnp.float32
    A = plgpu.load(A_ref.at[blk.g, *blk.dn], mask=blk.dnm, other=0.0)
    Ds = plgpu.load(D_ref.at[blk.g, blk.d], mask=blk.dm, other=0.0)
    dtb = plgpu.load(dtb_ref.at[blk.g, blk.d], mask=blk.dm, other=0.0)
    W = None
    if fused:
        W = plgpu.load(w_ref.at[blk.g, blk.k[:, None], blk.d[None, :]],
                       mask=blk.km[:, None] & blk.dm[None, :],
                       other=0.0).astype(f32)               # [Kp, bd]
    return A.astype(f32) * _LOG2E, Ds.astype(f32), dtb.astype(f32), W


def _load_step(blk, t, ok, x_ref, dt_ref, B_ref, C_ref, W, dtb, fused):
    """Step ``t``'s inputs in fp32; masked steps read zeros and get dt' 0."""
    f32 = jnp.float32
    m = blk.dm & ok
    x = plgpu.load(x_ref.at[blk.r, t, blk.d], mask=m, other=0.0).astype(f32)
    if fused:
        dl = plgpu.load(dt_ref.at[blk.r, t, blk.k], mask=blk.km & ok,
                        other=0.0).astype(f32)
        dtr = jnp.sum(dl[:, None] * W, axis=0)
    else:
        dl = None
        dtr = plgpu.load(dt_ref.at[blk.r, t, blk.d], mask=m,
                         other=0.0).astype(f32)
    Bt = plgpu.load(B_ref.at[blk.r, t, blk.n], mask=blk.nm & ok,
                    other=0.0).astype(f32)
    Ct = plgpu.load(C_ref.at[blk.r, t, blk.n], mask=blk.nm & ok,
                    other=0.0).astype(f32)
    pre = dtr + dtb
    dtp = jnp.where(ok, _softplus(pre), 0.0)
    return x, dl, pre, dtp, Bt, Ct


def _fwd_kernel(x_ref, dt_ref, w_ref, A_ref, B_ref, C_ref, D_ref, dtb_ref,
                h0_ref, y_ref, hfin_ref, *hb_ref, B, L, T, bd, directions,
                fused):
    D, N, K = x_ref.shape[-1], A_ref.shape[-1], dt_ref.shape[-1]
    blk = _Block(B, D, N, K, bd, directions)
    A2, Ds, dtb, W = _load_params(blk, A_ref, D_ref, dtb_ref, w_ref, fused)
    h = plgpu.load(h0_ref.at[blk.r, *blk.dn], mask=blk.dnm, other=0.0)

    def chunk(c, h):
        if hb_ref:
            plgpu.store(hb_ref[0].at[blk.r, c, *blk.dn], h, mask=blk.dnm)

        def step(s, h):
            t, ok = blk.time(c * T + s, L)
            x, _, _, dtp, Bt, Ct = _load_step(blk, t, ok, x_ref, dt_ref,
                                              B_ref, C_ref, W, dtb, fused)
            h = jnp.exp2(dtp[:, None] * A2) * h \
                + (dtp * x)[:, None] * Bt[None, :]
            y = jnp.sum(h * Ct[None, :], axis=1) + Ds * x
            plgpu.store(y_ref.at[blk.r, t, blk.d], y.astype(y_ref.dtype),
                        mask=blk.dm & ok)
            return h

        return jax.lax.fori_loop(0, T, step, h)

    h = jax.lax.fori_loop(0, pl.cdiv(L, T), chunk, h)
    plgpu.store(hfin_ref.at[blk.r, *blk.dn], h, mask=blk.dnm)


def _bwd_kernel(x_ref, dt_ref, w_ref, A_ref, B_ref, C_ref, D_ref, dtb_ref,
                hb_ref, gy_ref, g0_ref, dx_ref, ddt_ref, dB_ref, dC_ref,
                dA_ref, dD_ref, ddtb_ref, dW_ref, dh0_ref, *, B, L, T, bd,
                directions, fused):
    f32 = jnp.float32
    D, N, K = x_ref.shape[-1], A_ref.shape[-1], dt_ref.shape[-1]
    blk = _Block(B, D, N, K, bd, directions)
    A2, Ds, dtb, W = _load_params(blk, A_ref, D_ref, dtb_ref, w_ref, fused)
    nc = pl.cdiv(L, T)
    load = functools.partial(_load_step, blk, x_ref=x_ref, dt_ref=dt_ref,
                             B_ref=B_ref, C_ref=C_ref, W=W, dtb=dtb,
                             fused=fused)

    def chunk(j, carry):
        g, dA, dD, ddtb, dW = carry
        c = nc - 1 - j
        # Recompute the chunk's states from its stored entry state.
        hs = [plgpu.load(hb_ref.at[blk.r, c, *blk.dn], mask=blk.dnm,
                         other=0.0)]
        for s in range(T):
            t, ok = blk.time(c * T + s, L)
            x, _, _, dtp, Bt, _ = load(t, ok)
            hs.append(jnp.exp2(dtp[:, None] * A2) * hs[-1]
                      + (dtp * x)[:, None] * Bt[None, :])
        # Adjoint recurrence back through them.
        for s in reversed(range(T)):
            t, ok = blk.time(c * T + s, L)
            x, dl, pre, dtp, Bt, Ct = load(t, ok)
            m = blk.dm & ok
            gy = plgpu.load(gy_ref.at[blk.r, t, blk.d], mask=m,
                            other=0.0).astype(f32)
            a = jnp.exp2(dtp[:, None] * A2)
            g = g + gy[:, None] * Ct[None, :]
            ga = g * hs[s] * a
            gB = jnp.sum(g * Bt[None, :], axis=1)
            ddtp = gB * x + jnp.sum(ga * A2, axis=1) * (1.0 / _LOG2E)
            ddt = jnp.where(ok, ddtp * jax.nn.sigmoid(pre), 0.0)
            dA = dA + ga * dtp[:, None]
            dD = dD + gy * x
            ddtb = ddtb + ddt
            plgpu.store(dx_ref.at[blk.r, t, blk.d], gB * dtp + gy * Ds,
                        mask=m)
            nm = blk.nm & ok
            plgpu.store(dB_ref.at[blk.r, blk.blk, t, blk.n],
                        jnp.sum(g * (dtp * x)[:, None], axis=0), mask=nm)
            plgpu.store(dC_ref.at[blk.r, blk.blk, t, blk.n],
                        jnp.sum(hs[s + 1] * gy[:, None], axis=0), mask=nm)
            if fused:
                plgpu.store(ddt_ref.at[blk.r, blk.blk, t, blk.k],
                            jnp.sum(W * ddt[None, :], axis=1),
                            mask=blk.km & ok)
                dW = dW + dl[:, None] * ddt[None, :]
            else:
                plgpu.store(ddt_ref.at[blk.r, t, blk.d], ddt, mask=m)
            g = a * g
        return g, dA, dD, ddtb, dW

    g0 = plgpu.load(g0_ref.at[blk.r, *blk.dn], mask=blk.dnm, other=0.0)
    zeros = jnp.zeros((bd,), f32)
    g, dA, dD, ddtb, dW = jax.lax.fori_loop(
        0, nc, chunk,
        (g0, jnp.zeros_like(g0), zeros, zeros,
         jnp.zeros((_pow2(K), bd), f32)))
    plgpu.store(dh0_ref.at[blk.r, *blk.dn], g, mask=blk.dnm)
    plgpu.store(dA_ref.at[blk.r, *blk.dn], dA, mask=blk.dnm)
    plgpu.store(dD_ref.at[blk.r, blk.d], dD, mask=blk.dm)
    plgpu.store(ddtb_ref.at[blk.r, blk.d], ddtb, mask=blk.dm)
    if fused:
        plgpu.store(dW_ref.at[blk.r, blk.k[:, None], blk.d[None, :]], dW,
                    mask=blk.km[:, None] & blk.dm[None, :])


def _call(kernel, out_shape, grid, name, warps, interpret):
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=grid, backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps),
        interpret=interpret, name=name)


def _flat(t):  # [G, B, ...] -> [G*B, ...]
    return t.reshape((t.shape[0] * t.shape[1],) + t.shape[2:])


def _forward(x, dt, A, Bm, Cm, Dskip, dt_bias, w, h0, directions, fused,
             interpret, keep_states):
    bd, T = FWD_BD, CHUNK_T
    G, B, L, D = x.shape
    N = A.shape[-1]
    R, nc = G * B, pl.cdiv(L, T)
    f32 = jnp.float32
    out_shape = [jax.ShapeDtypeStruct((R, L, D), x.dtype),
                 jax.ShapeDtypeStruct((R, D, N), f32)]
    if keep_states:
        out_shape.append(jax.ShapeDtypeStruct((R, nc, D, N), f32))
    kernel = functools.partial(_fwd_kernel, B=B, L=L, T=T, bd=bd,
                               directions=directions, fused=fused)
    outs = _call(kernel, out_shape, (R, pl.cdiv(D, bd)), "selective_scan_fwd",
                 FWD_WARPS, interpret)(_flat(x), _flat(dt), w, A, _flat(Bm), _flat(Cm),
                            Dskip, dt_bias, _flat(h0))
    y = outs[0].reshape(G, B, L, D)
    hfin = outs[1].reshape(G, B, D, N)
    return (y, hfin) + ((outs[2],) if keep_states else ())


def _backward(res, gy, ghfin, directions, fused, interpret):
    bd = BWD_BD
    x, dt, w, A, Bm, Cm, Dskip, dt_bias, hb = res
    G, B, L, D = x.shape
    N, K = A.shape[-1], dt.shape[-1]
    R, nd = G * B, pl.cdiv(D, bd)
    f32 = jnp.float32
    S = lambda *shape: jax.ShapeDtypeStruct(shape, f32)
    out_shape = [
        S(R, L, D),                                   # dx
        S(R, nd, L, K) if fused else S(R, L, D),      # ddt (partial if fused)
        S(R, nd, L, N), S(R, nd, L, N),               # dB, dC partials
        S(R, D, N), S(R, D), S(R, D),                 # dA, dD, ddt_bias rows
        S(R, _pow2(K), D) if fused else S(1, 1, 1),   # dW rows
        S(R, D, N),                                   # dh0
    ]
    kernel = functools.partial(_bwd_kernel, B=B, L=L, T=CHUNK_T, bd=bd,
                               directions=directions, fused=fused)
    dx, ddt, dBp, dCp, dA, dD, ddtb, dW, dh0 = _call(
        kernel, out_shape, (R, nd), "selective_scan_bwd", BWD_WARPS,
        interpret)(
        _flat(x), _flat(dt), w, A, _flat(Bm), _flat(Cm), Dskip, dt_bias, hb,
        _flat(gy), _flat(ghfin.astype(f32)))
    per_group = lambda t: t.reshape((G, B) + t.shape[1:]).sum(axis=1)
    if fused:
        ddt = ddt.sum(axis=1)
        dW = per_group(dW)[:, :K]
    else:
        dW = jnp.zeros_like(w)
    return (dx.reshape(x.shape).astype(x.dtype),
            ddt.reshape(dt.shape).astype(dt.dtype), per_group(dA),
            dBp.sum(axis=1).reshape(Bm.shape).astype(Bm.dtype),
            dCp.sum(axis=1).reshape(Cm.shape).astype(Cm.dtype),
            per_group(dD), per_group(ddtb), dW,
            dh0.reshape(G, B, D, N))


@functools.partial(jax.custom_vjp, nondiff_argnums=(9, 10, 11))
def _scan(x, dt, w, A, Bm, Cm, Dskip, dt_bias, h0, directions, fused,
          interpret):
    return _forward(x, dt, A, Bm, Cm, Dskip, dt_bias, w, h0, directions,
                    fused, interpret, keep_states=False)


def _scan_fwd(x, dt, w, A, Bm, Cm, Dskip, dt_bias, h0, directions, fused,
              interpret):
    y, hfin, hb = _forward(x, dt, A, Bm, Cm, Dskip, dt_bias, w, h0,
                           directions, fused, interpret, keep_states=True)
    return (y, hfin), (x, dt, w, A, Bm, Cm, Dskip, dt_bias, hb)


def _scan_bwd(directions, fused, interpret, res, cts):
    gy, ghfin = cts
    dx, ddt, dA, dB, dC, dD, ddtb, dW, dh0 = _backward(
        res, gy, ghfin, directions, fused, interpret)
    return dx, ddt, dW, dA, dB, dC, dD, ddtb, dh0


_scan.defvjp(_scan_fwd, _scan_bwd)


def selective_scan_triton(
    x: jax.Array,
    dt: jax.Array,
    A: jax.Array,
    Bm: jax.Array,
    Cm: jax.Array,
    Dskip: jax.Array,
    dt_bias: Optional[jax.Array] = None,
    dt_proj_w: Optional[jax.Array] = None,
    directions: Optional[Sequence[bool]] = None,
    h0: Optional[jax.Array] = None,
    interpret: bool = False,
):
    """Triton selective scan. Returns ``(y, final_state)``; contract of
    ``ops.selective_scan.selective_scan_chunked``. Differentiable in every
    array argument, the initial state included."""
    G, B, L, D = x.shape
    N = A.shape[-1]
    f32 = jnp.float32
    if dt_bias is None:
        dt_bias = jnp.zeros((G, D), f32)
    if h0 is None:
        h0 = jnp.zeros((G, B, D, N), f32)
    fused = dt_proj_w is not None
    w = dt_proj_w.astype(f32) if fused else jnp.zeros((G, 1, D), f32)
    dirs = tuple(bool(d) for d in directions) if directions else (False,) * G
    return _scan(x, dt, w, A.astype(f32), Bm, Cm, Dskip.astype(f32),
                 dt_bias.astype(f32), h0.astype(f32), dirs, fused, interpret)
