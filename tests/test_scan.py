"""Selective-scan implementations vs the fp64 golden recurrence."""

import jax.numpy as jnp
import numpy as np
import pytest

from plantcaduceus_tpu.ops.selective_scan import (
    selective_scan,
    selective_scan_associative,
    selective_scan_sequential,
)
from tests import golden


def make_inputs(rng, G=2, B=3, L=64, D=8, N=4):
    x = rng.standard_normal((G, B, L, D))
    dt = rng.standard_normal((G, B, L, D)) * 0.5 - 1.0
    A = -np.exp(rng.standard_normal((G, D, N)) * 0.5)
    Bm = rng.standard_normal((G, B, L, N))
    Cm = rng.standard_normal((G, B, L, N))
    Ds = rng.standard_normal((G, D))
    dtb = rng.standard_normal((G, D)) * 0.3
    return x, dt, A, Bm, Cm, Ds, dtb


def golden_scan(x, dt, A, Bm, Cm, Ds, dtb):
    G, B, L, D = x.shape
    y = np.zeros_like(x)
    for g in range(G):
        for b in range(B):
            y[g, b] = golden.selective_scan_ref(
                x[g, b], dt[g, b], A[g], Bm[g, b], Cm[g, b], Ds[g], dtb[g]
            )
    return y


@pytest.mark.parametrize("impl", [selective_scan_sequential, selective_scan_associative])
def test_scan_matches_golden(rng, impl):
    inputs = make_inputs(rng)
    want = golden_scan(*inputs)
    x, dt, A, Bm, Cm, Ds, dtb = (jnp.asarray(v, jnp.float32) for v in inputs)
    got = impl(x, dt, A, Bm, Cm, Ds, dt_bias=dtb)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)


def test_impls_agree_long(rng):
    inputs = make_inputs(rng, G=1, B=2, L=512, D=16, N=16)
    args = tuple(jnp.asarray(v, jnp.float32) for v in inputs)
    a = selective_scan_sequential(*args[:6], dt_bias=args[6])
    b = selective_scan_associative(*args[:6], dt_bias=args[6])
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_dispatch(rng):
    inputs = make_inputs(rng, G=1, B=1, L=16, D=4, N=2)
    args = tuple(jnp.asarray(v, jnp.float32) for v in inputs)
    y = selective_scan(*args[:6], dt_bias=args[6], impl="sequential")
    assert y.shape == args[0].shape


def test_scan_grads_finite(rng):
    import jax

    inputs = make_inputs(rng, G=2, B=2, L=32, D=4, N=4)
    args = tuple(jnp.asarray(v, jnp.float32) for v in inputs)

    def loss(x, dt, A, Bm, Cm, Ds, dtb):
        return jnp.sum(
            selective_scan_associative(x, dt, A, Bm, Cm, Ds, dt_bias=dtb) ** 2
        )

    grads = jax.grad(loss, argnums=tuple(range(7)))(*args)
    for g in grads:
        assert np.all(np.isfinite(np.asarray(g)))


# ---------------------------------------------------------------------------
# Chunked XLA scan: directions, seeded state, fused dt projection
# ---------------------------------------------------------------------------

from plantcaduceus_tpu.ops.selective_scan import (  # noqa: E402
    select_scan_impl, selective_scan_chunked)
from tests.test_triton_scan import (  # noqa: E402
    make_inputs as make_scan_inputs, reference)


@pytest.mark.parametrize("directions", [(False, False), (False, True),
                                        (True, True)])
@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("fused", [True, False])
def test_chunked_matches_sequential(directions, chunk, fused):
    """Chunks that divide L, that do not (padding), and one chunk longer
    than L; every direction mix; initial state in, final state out."""
    import jax

    args = make_scan_inputs(10, L=37, D=12, N=4, fused=fused)
    x, dt, A, Bm, Cm, Ds, dtb, w, h0 = args
    with jax.default_matmul_precision("highest"):
        y_ref, h_ref = reference(*args, directions)
        y, h = selective_scan_chunked(x, dt, A, Bm, Cm, Ds, dtb,
                                      dt_proj_w=w, directions=directions,
                                      h0=h0, chunk=chunk)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("directions", [(False, True), (True, False)])
def test_chunked_grads_match_sequential(directions):
    import jax

    args = make_scan_inputs(11, L=21, D=8, N=4)
    ky = jax.random.normal(jax.random.PRNGKey(3), args[0].shape)
    kh = jax.random.normal(jax.random.PRNGKey(4), args[-1].shape)

    def chunked(x, dt, A, Bm, Cm, Ds, dtb, w, h0, dirs):
        return selective_scan_chunked(x, dt, A, Bm, Cm, Ds, dtb, dt_proj_w=w,
                                      directions=dirs, h0=h0, chunk=8)

    def loss(fn):
        def f(*a):
            y, h = fn(*a, directions)
            return jnp.sum(y * ky) + jnp.sum(h * kh)
        return f

    argnums = tuple(range(9))
    with jax.default_matmul_precision("highest"):
        want = jax.grad(loss(reference), argnums=argnums)(*args)
        got = jax.grad(loss(chunked), argnums=argnums)(*args)
    for i, g, r in zip(argnums, got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=f"arg {i}")


@pytest.mark.parametrize("impl", ["sequential", "associative", "chunked"])
def test_dispatch_directions_and_dt_projection(impl):
    """Every CPU implementation behind the dispatcher honours directions and
    the fused low-rank dt projection the same way."""
    import jax

    x, dt, A, Bm, Cm, Ds, dtb, w, _ = make_scan_inputs(12, L=24, D=8, N=4)
    with jax.default_matmul_precision("highest"):
        want, _ = reference(x, dt, A, Bm, Cm, Ds, dtb, w, None,
                            (False, True))
        got = selective_scan(x, dt, A, Bm, Cm, Ds, dt_bias=dtb, impl=impl,
                             dt_proj_w=w, directions=(False, True))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_dispatch_returns_final_state():
    x, dt, A, Bm, Cm, Ds, dtb, w, h0 = make_scan_inputs(13, L=16, D=8, N=4)
    y, h = selective_scan(x, dt, A, Bm, Cm, Ds, dt_bias=dtb, impl="chunked",
                          dt_proj_w=w, directions=(False, True), h0=h0,
                          return_final_state=True)
    assert y.shape == x.shape and h.shape == h0.shape


def test_associative_refuses_state():
    x, dt, A, Bm, Cm, Ds, dtb, w, h0 = make_scan_inputs(14, L=8, D=8, N=4)
    with pytest.raises(NotImplementedError):
        selective_scan(x, dt, A, Bm, Cm, Ds, dt_bias=dtb, impl="associative",
                       dt_proj_w=w, h0=h0)


@pytest.mark.parametrize("directions", [(False, True), (True, True)])
def test_sequential_dispatch_seeded_state(directions):
    """The plain reference takes an initial state and returns the final one
    through the dispatcher, reverse groups included."""
    import jax

    args = make_scan_inputs(15, L=11, D=8, N=4)
    x, dt, A, Bm, Cm, Ds, dtb, w, h0 = args
    with jax.default_matmul_precision("highest"):
        y_ref, h_ref = reference(*args, directions)
        y, h = selective_scan(x, dt, A, Bm, Cm, Ds, dt_bias=dtb,
                              impl="sequential", dt_proj_w=w,
                              directions=directions, h0=h0,
                              return_final_state=True)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,requested,want", [
    ("gpu", "auto", "triton"),
    ("gpu", "pallas", "triton"),
    ("gpu", "chunked", "chunked"),
    ("cpu", "auto", "chunked"),
    ("cpu", "associative", "associative"),
    ("cpu", "sequential", "sequential"),
])
def test_select_scan_impl(backend, requested, want):
    assert select_scan_impl(backend, requested) == want


@pytest.mark.parametrize("backend,requested", [
    ("cpu", "triton"),      # the kernel only compiles for the GPU
    ("cpu", "pallas"),
    ("rocm", "auto"),       # no implementation for other backends
    ("METAL", "auto"),
    ("gpu", "flash"),       # unknown implementation
])
def test_select_scan_impl_refuses(backend, requested):
    with pytest.raises(ValueError):
        select_scan_impl(backend, requested)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_select_ssd_and_attention_impls(backend):
    from plantcaduceus_tpu.ops.attention import select_attention_impl
    from plantcaduceus_tpu.ops.ssd import select_ssd_impl

    assert select_ssd_impl(backend) == "xla"
    assert select_attention_impl(backend) == "xla"


@pytest.mark.parametrize("backend", ["rocm", "METAL", ""])
def test_select_ssd_and_attention_refuse_unknown_backend(backend):
    from plantcaduceus_tpu.ops.attention import select_attention_impl
    from plantcaduceus_tpu.ops.ssd import select_ssd_impl

    with pytest.raises(ValueError):
        select_ssd_impl(backend)
    with pytest.raises(ValueError):
        select_attention_impl(backend)
