"""Selective-scan (Mamba S6) recurrence.

This is the hot op of the Caduceus model. The reference runs it through the
``mamba-ssm`` CUDA wheel (``selective_scan_cuda``; pinned in the
reference's env/requirements.txt). Implementations here:

* ``selective_scan_sequential`` — ``lax.scan`` over time. Minimal memory, the
  numerical ground truth for tests.
* ``selective_scan_associative`` — ``lax.associative_scan`` over the whole
  sequence. Materialises the ``[*, L, D, N]`` state tensors, so it is a test
  reference only: at PlantCaduceus_l20 batch 128 one such fp32 tensor is
  12.9 GB.
* ``selective_scan_chunked`` — ``lax.scan`` over time chunks carrying the
  state ``h [G, B, D, N]``; an associative scan inside each chunk, the chunk
  body rematerialised under ``jax.checkpoint``. It never holds more than one
  chunk's ``[G, B, T, D, N]`` states, takes an initial state and returns the
  final one. The CPU path, and the plain XLA form the GPU kernel is timed
  against.
* ``ops.triton_scan`` (separate module) — the Pallas (Triton) GPU kernel.

:func:`select_scan_impl` is the one place that picks among them.

Recurrence (per batch row, channel d, state n), matching the semantics of the
CUDA kernel with ``delta_softplus=True``:

    dt'    = softplus(dt + dt_bias)
    a[t]   = exp(dt'[t,d] * A[d,n])              (A real, negative)
    h[t]   = a[t] * h[t-1] + dt'[t,d] * B[t,n] * x[t,d]
    y[t,d] = sum_n C[t,n] * h[t,d,n] + D[d] * x[t,d]

All shapes carry a leading *group* axis ``G`` so that the two scan directions
of a bidirectional Mamba block (which have distinct A/D/dt_bias parameters)
run in one batched call:

    x, dt : [G, B, L, D]     (dt: [G, B, L, R] with ``dt_proj_w [G, R, D]``)
    A     : [G, D, N]
    Bm, Cm: [G, B, L, N]
    Dskip : [G, D]
    dt_bias: [G, D]
    y     : [G, B, L, D]
    h0, final state: [G, B, D, N]

``directions`` flags groups that scan right-to-left; their inputs and
outputs stay in natural time order, and their initial/final states are the
states at the sequence's right/left end. The scan carry is always float32
regardless of input dtype; outputs are cast back to ``x.dtype``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

CHUNK = 16  # time steps per chunk of selective_scan_chunked


def select_scan_impl(backend: str, requested: str = "auto") -> str:
    """The Mamba-1 scan implementation for ``backend``
    (``jax.default_backend()``). ``auto`` is the Triton kernel on ``gpu`` and
    the chunked XLA scan on ``cpu``; ``pallas`` is an older name of
    ``triton``. Any other backend is an error: nothing here is tuned for it.
    The Triton kernel only compiles for the GPU (its CPU tests call it in
    interpret mode directly)."""
    if backend not in ("gpu", "cpu"):
        raise ValueError(f"no selective-scan implementation for backend "
                         f"{backend!r} (gpu or cpu)")
    impl = "triton" if requested == "pallas" else requested
    if impl == "auto":
        return "triton" if backend == "gpu" else "chunked"
    if impl not in ("triton", "chunked", "sequential", "associative"):
        raise ValueError(f"unknown selective_scan impl {requested!r}")
    if impl == "triton" and backend != "gpu":
        raise ValueError("the Triton selective scan compiles only for the "
                         "GPU; use scan_impl='chunked' on the CPU")
    return impl


def _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus):
    """Common fp32 upcast + dt activation. Returns fp32 tensors."""
    f32 = jnp.float32
    x = x.astype(f32)
    dt = dt.astype(f32)
    A = A.astype(f32)
    Bm = Bm.astype(f32)
    Cm = Cm.astype(f32)
    Dskip = Dskip.astype(f32)
    if dt_bias is not None:
        dt = dt + dt_bias.astype(f32)[:, None, None, :]
    if dt_softplus:
        dt = jax.nn.softplus(dt)
    return x, dt, A, Bm, Cm, Dskip


def selective_scan_sequential(
    x: jax.Array,
    dt: jax.Array,
    A: jax.Array,
    Bm: jax.Array,
    Cm: jax.Array,
    Dskip: jax.Array,
    dt_bias: Optional[jax.Array] = None,
    dt_softplus: bool = True,
    h0: Optional[jax.Array] = None,
    return_final_state: bool = False,
):
    """Ground-truth sequential scan via ``lax.scan`` over the time axis,
    from ``h0`` (zeros by default); with ``return_final_state`` it returns
    ``(y, final_state)``."""
    out_dtype = x.dtype
    x, dt, A, Bm, Cm, Dskip = _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus)
    G, B, L, D = x.shape
    N = A.shape[-1]

    # Time-major for lax.scan: [L, G, B, ...]
    xs = (
        jnp.moveaxis(x, 2, 0),
        jnp.moveaxis(dt, 2, 0),
        jnp.moveaxis(Bm, 2, 0),
        jnp.moveaxis(Cm, 2, 0),
    )
    h0 = jnp.zeros((G, B, D, N), jnp.float32) if h0 is None \
        else h0.astype(jnp.float32)

    def step(h, inp):
        x_t, dt_t, B_t, C_t = inp  # [G,B,D], [G,B,D], [G,B,N], [G,B,N]
        a = jnp.exp(dt_t[..., None] * A[:, None])  # [G,B,D,N]
        b = (dt_t * x_t)[..., None] * B_t[:, :, None, :]  # [G,B,D,N]
        h = a * h + b
        y_t = jnp.einsum("gbdn,gbn->gbd", h, C_t)
        return h, y_t

    h_end, ys = jax.lax.scan(step, h0, xs)  # ys: [L, G, B, D]
    y = jnp.moveaxis(ys, 0, 2) + Dskip[:, None, None, :] * x
    y = y.astype(out_dtype)
    return (y, h_end) if return_final_state else y


def _combine(left, right):
    """First-order linear recurrence monoid: (a1, b1) then (a2, b2)."""
    a1, b1 = left
    a2, b2 = right
    return a2 * a1, a2 * b1 + b2


def selective_scan_associative(
    x: jax.Array,
    dt: jax.Array,
    A: jax.Array,
    Bm: jax.Array,
    Cm: jax.Array,
    Dskip: jax.Array,
    dt_bias: Optional[jax.Array] = None,
    dt_softplus: bool = True,
) -> jax.Array:
    """Parallel prefix scan over the linear recurrence.

    Combines pairs ``(a, b)`` with ``(a2*a1, a2*b1 + b2)`` — the standard
    first-order-recurrence monoid — using ``lax.associative_scan`` along L.
    """
    out_dtype = x.dtype
    x, dt, A, Bm, Cm, Dskip = _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus)

    a = jnp.exp(dt[..., None] * A[:, None, None])  # [G,B,L,D,N]
    b = (dt * x)[..., None] * Bm[:, :, :, None, :]  # [G,B,L,D,N]
    _, h = jax.lax.associative_scan(_combine, (a, b), axis=2)
    y = jnp.einsum("gbldn,gbln->gbld", h, Cm)
    y = y + Dskip[:, None, None, :] * x
    return y.astype(out_dtype)


def _chunked_one_direction(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, h0,
                           reverse: bool, chunk: int):
    """Chunked scan of groups that share one direction. Returns (y, h_end)."""
    f32 = jnp.float32
    G, B, L, D = x.shape
    T = min(chunk, L)
    nc = -(-L // T)
    pad = nc * T - L
    valid = None
    if pad:
        # Padded steps get dt' = 0: decay 1, input 0 — the state passes
        # through them unchanged. Reverse groups pad at the front, so the
        # padding is processed last in either direction.
        widths = ((0, 0), (0, 0), (pad, 0) if reverse else (0, pad), (0, 0))
        x, dt, Bm, Cm = (jnp.pad(t, widths) for t in (x, dt, Bm, Cm))
        t_idx = jnp.arange(nc * T)
        valid = (t_idx >= pad) if reverse else (t_idx < L)
        valid = valid.reshape(nc, 1, 1, T, 1)

    def chunks(t):  # [G, B, nc*T, F] -> [nc, G, B, T, F]
        return jnp.moveaxis(t.reshape(G, B, nc, T, t.shape[-1]), 2, 0)

    A = A.astype(f32)
    Dskip = Dskip.astype(f32)
    dt_bias = dt_bias.astype(f32)
    w = None if dt_proj_w is None else dt_proj_w.astype(f32)
    xs = (chunks(x), chunks(dt), chunks(Bm), chunks(Cm))
    if valid is not None:
        xs = xs + (valid,)

    @jax.checkpoint
    def body(h, inp):
        xc, dtc, Bc, Cc = (t.astype(f32) for t in inp[:4])
        if w is not None:
            dtc = jnp.einsum("gbtr,grd->gbtd", dtc, w)
        dtp = jax.nn.softplus(dtc + dt_bias[:, None, None, :])  # [G,B,T,D]
        if len(inp) == 5:
            dtp = jnp.where(inp[4], dtp, 0.0)
        a = jnp.exp(dtp[..., None] * A[:, None, None])          # [G,B,T,D,N]
        b = (dtp * xc)[..., None] * Bc[:, :, :, None, :]
        a_cum, b_cum = jax.lax.associative_scan(_combine, (a, b), axis=2,
                                                reverse=reverse)
        hs = a_cum * h[:, :, None] + b_cum
        y = jnp.einsum("gbtdn,gbtn->gbtd", hs, Cc) + Dskip[:, None, None] * xc
        return hs[:, :, 0 if reverse else -1], y.astype(x.dtype)

    h_end, ys = jax.lax.scan(body, h0.astype(f32), xs, reverse=reverse)
    y = jnp.moveaxis(ys, 0, 2).reshape(G, B, nc * T, D)
    if pad:
        y = y[:, :, pad:] if reverse else y[:, :, :L]
    return y, h_end


def selective_scan_chunked(
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
    chunk: int = CHUNK,
):
    """Chunked XLA scan. Returns ``(y, final_state)``; see the module
    docstring for shapes, ``directions`` and the state convention."""
    G, B, L, D = x.shape
    N = A.shape[-1]
    if dt_bias is None:
        dt_bias = jnp.zeros((G, D), jnp.float32)
    if h0 is None:
        h0 = jnp.zeros((G, B, D, N), jnp.float32)
    dirs = tuple(bool(d) for d in directions) if directions else (False,) * G
    args = (x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, h0)
    if len(set(dirs)) == 1:
        return _chunked_one_direction(*args, dirs[0], chunk)
    # Mixed directions: one scan per group, static slices.
    outs = [_chunked_one_direction(
        *(None if t is None else t[g:g + 1] for t in args), dirs[g], chunk)
        for g in range(G)]
    return tuple(jnp.concatenate(o) for o in zip(*outs))


@functools.partial(jax.jit, static_argnames=(
    "dt_softplus", "impl", "directions", "return_final_state"))
def selective_scan(
    x: jax.Array,
    dt: jax.Array,
    A: jax.Array,
    Bm: jax.Array,
    Cm: jax.Array,
    Dskip: jax.Array,
    dt_bias: Optional[jax.Array] = None,
    dt_softplus: bool = True,
    impl: str = "auto",
    dt_proj_w: Optional[jax.Array] = None,
    directions: Optional[tuple] = None,
    h0: Optional[jax.Array] = None,
    return_final_state: bool = False,
):
    """Dispatching entry point (``impl`` as in :func:`select_scan_impl`).

    ``dt_proj_w [G, R, D]``: ``dt`` is the low-rank dt ``[G, B, L, R]`` and
    is projected up inside the scan. ``directions``: per-group reverse
    flags. ``h0`` / ``return_final_state``: seeded scan with its final
    state, as context parallelism needs (all but the associative scan).
    """
    impl = select_scan_impl(jax.default_backend(), impl)
    if impl in ("chunked", "triton"):
        if not dt_softplus:
            raise NotImplementedError(
                "dt_softplus=False is only available in the reference impls")
        if impl == "triton":
            from plantcaduceus_tpu.ops.triton_scan import selective_scan_triton
            fn = selective_scan_triton
        else:
            fn = selective_scan_chunked
        y, h = fn(x, dt, A, Bm, Cm, Dskip, dt_bias=dt_bias,
                  dt_proj_w=dt_proj_w, directions=directions, h0=h0)
        return (y, h) if return_final_state else y
    if impl == "sequential":
        fn = functools.partial(selective_scan_sequential, h0=h0,
                               return_final_state=return_final_state)
    elif h0 is not None or return_final_state:
        raise NotImplementedError(
            "the associative scan has no initial/final state")
    else:
        fn = selective_scan_associative
    if dt_proj_w is not None:
        dt = jnp.einsum("gblr,grd->gbld", dt.astype(jnp.float32),
                        dt_proj_w.astype(jnp.float32))
    if not directions or not any(directions):
        return fn(x, dt, A, Bm, Cm, Dskip, dt_bias=dt_bias,
                  dt_softplus=dt_softplus)
    # Reference impls scan left-to-right only: flip the reverse groups.
    m = jnp.asarray([bool(d) for d in directions])[:, None, None, None]
    rev = lambda t: jnp.where(m, jnp.flip(t, axis=2), t)
    out = fn(rev(x), rev(dt), A, rev(Bm), rev(Cm), Dskip, dt_bias=dt_bias,
             dt_softplus=dt_softplus)
    return (rev(out[0]), out[1]) if return_final_state else rev(out)
