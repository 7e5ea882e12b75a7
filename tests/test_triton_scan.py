"""The Triton selective-scan kernel (interpret mode on the CPU) against the
sequential reference: directions, initial and final states, the fused
low-rank dt projection, channel counts and lengths that do not divide the
kernel's blocks, and the gradients of every input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plantcaduceus_tpu.ops import triton_scan
from plantcaduceus_tpu.ops.selective_scan import selective_scan_sequential


def make_inputs(seed, G=2, B=2, L=13, D=40, N=16, R=5, fused=True,
                with_h0=True):
    ks = jax.random.split(jax.random.PRNGKey(seed), 9)
    x = jax.random.normal(ks[0], (G, B, L, D))
    dt = jax.random.normal(ks[1], (G, B, L, R if fused else D)) * 0.5 - 1.0
    w = jax.random.normal(ks[2], (G, R, D)) * 0.3 if fused else None
    A = -jnp.exp(jax.random.normal(ks[3], (G, D, N)) * 0.5)
    Bm = jax.random.normal(ks[4], (G, B, L, N))
    Cm = jax.random.normal(ks[5], (G, B, L, N))
    Ds = jax.random.normal(ks[6], (G, D))
    dtb = jax.random.normal(ks[7], (G, D)) * 0.3
    h0 = jax.random.normal(ks[8], (G, B, D, N)) if with_h0 else None
    return x, dt, A, Bm, Cm, Ds, dtb, w, h0


def reference(x, dt, A, Bm, Cm, Ds, dtb, w, h0, directions):
    """Sequential scan per group, reverse groups by explicit flips, with an
    initial state: y and the final state."""
    if w is not None:
        dt = jnp.einsum("gblr,grd->gbld", dt, w)
    G, B, L, D = x.shape
    N = A.shape[-1]
    if h0 is None:
        h0 = jnp.zeros((G, B, D, N))
    ys, hs = [], []
    for g in range(G):
        seq = [t[g] for t in (x, dt, Bm, Cm)]
        if directions[g]:
            seq = [jnp.flip(t, 1) for t in seq]
        xg, dtg, bg, cg = seq
        dtp = jax.nn.softplus(dtg + dtb[g])

        def step(h, inp, g=g):
            xt, dtt, bt, ct = inp
            h = jnp.exp(dtt[..., None] * A[g]) * h \
                + (dtt * xt)[..., None] * bt[:, None, :]
            return h, jnp.einsum("bdn,bn->bd", h, ct)

        hT, y = jax.lax.scan(step, h0[g], tuple(
            jnp.moveaxis(t, 1, 0) for t in (xg, dtp, bg, cg)))
        y = jnp.moveaxis(y, 0, 1) + Ds[g] * xg
        ys.append(jnp.flip(y, 1) if directions[g] else y)
        hs.append(hT)
    return jnp.stack(ys), jnp.stack(hs)


def run(x, dt, A, Bm, Cm, Ds, dtb, w, h0, directions):
    return triton_scan.selective_scan_triton(
        x, dt, A, Bm, Cm, Ds, dtb, dt_proj_w=w, directions=directions,
        h0=h0, interpret=True)


DIRECTIONS = [(False, False), (False, True), (True, True)]


@pytest.mark.parametrize("directions", DIRECTIONS)
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("with_h0", [True, False])
def test_forward_matches_sequential(directions, fused, with_h0):
    args = make_inputs(0, fused=fused, with_h0=with_h0)
    with jax.default_matmul_precision("highest"):
        y_ref, h_ref = reference(*args, directions)
        y, h = run(*args, directions)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,D", [(1, 8), (3, 32), (4, 33), (17, 64)])
def test_lengths_and_widths_off_the_blocks(L, D):
    """Lengths shorter than, equal to and past one stored-state chunk, and
    channel counts below, at and past one channel block."""
    args = make_inputs(1, G=1, B=1, L=L, D=D, N=4, R=3)
    with jax.default_matmul_precision("highest"):
        y_ref, h_ref = reference(*args, (False,))
        y, h = run(*args, (False,))
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)


def test_bf16_activations():
    x, dt, A, Bm, Cm, Ds, dtb, w, h0 = make_inputs(2)
    bf = lambda t: t.astype(jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        y_ref, _ = reference(bf(x).astype(jnp.float32),
                             bf(dt).astype(jnp.float32), A,
                             bf(Bm).astype(jnp.float32),
                             bf(Cm).astype(jnp.float32), Ds, dtb, w, h0,
                             (False, True))
        y, _ = run(bf(x), bf(dt), A, bf(Bm), bf(Cm), Ds, dtb, w, h0,
                   (False, True))
    assert y.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(y, np.float32), np.asarray(y_ref),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("directions", [(False, True), (True, False)])
def test_grads_match_sequential(fused, directions):
    """Gradients of a random-cotangent loss on y and the final state, for
    every input the scan takes (the initial state included)."""
    args = make_inputs(3, L=9, D=36, fused=fused)
    ky = jax.random.normal(jax.random.PRNGKey(7), args[0].shape)
    kh = jax.random.normal(jax.random.PRNGKey(8), args[-1].shape)
    argnums = (0, 1, 2, 3, 4, 5, 6, 8) + ((7,) if fused else ())

    def loss(fn):
        def f(*a):
            y, h = fn(*a, directions)
            return jnp.sum(y * ky) + jnp.sum(h * kh)
        return f

    with jax.default_matmul_precision("highest"):
        want = jax.grad(loss(reference), argnums=argnums)(*args)
        got = jax.grad(loss(run), argnums=argnums)(*args)
    for i, g, r in zip(argnums, got, want):
        scale = float(jnp.max(jnp.abs(r))) + 1e-6
        err = float(jnp.max(jnp.abs(g - r))) / scale
        assert err < 1e-4, (i, err)


@pytest.mark.parametrize("D,L", [(768, 512), (3072, 64)])
def test_lowers_to_triton(D, L):
    """Forward and backward lower to Triton IR at real widths (l20, and
    pc2-large's d_inner) — lowering only; the GPU compiles it."""
    x, dt, A, Bm, Cm, Ds, dtb, w, h0 = make_inputs(4, B=2, L=L, D=D, R=24)

    def f(x, dt, w, h0):
        def loss(x, dt, w, h0):
            y, h = triton_scan.selective_scan_triton(
                x, dt, A, Bm, Cm, Ds, dtb, dt_proj_w=w,
                directions=(False, True), h0=h0)
            return jnp.sum(y.astype(jnp.float32)) + jnp.sum(h)
        return jax.grad(loss, argnums=(0, 1, 2, 3))(x, dt, w, h0)

    lowered = jax.jit(f).trace(x.astype(jnp.bfloat16), dt, w, h0).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("__gpu$xla.gpu.triton") == 2  # forward + backward


@pytest.mark.gpu
def test_compiled_kernel_on_gpu(gpu):
    """The compiled kernel (no interpret mode) against the reference."""
    args = make_inputs(5, B=2, L=100, D=96)
    directions = (False, True)
    with jax.default_matmul_precision("highest"):
        y_ref, h_ref = reference(*args, directions)
        y, h = jax.jit(lambda *a: triton_scan.selective_scan_triton(
            *a[:7], dt_proj_w=a[7], directions=directions, h0=a[8]))(*args)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref),
                               rtol=1e-4, atol=1e-4)
