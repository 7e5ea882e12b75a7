"""Sequence-parallel SSD on a virtual mesh vs the single-device SSD."""

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from plantcaduceus_tpu.ops.ssd import ssd_chunked
from plantcaduceus_tpu.ops.ssd_seq_parallel import ssd_dir_seq_sharded


def make_flat(rng, B=2, L=256, H=4, Pd=8, NG=2, N=4):
    x = rng.standard_normal((B, L, H * Pd)).astype(np.float32)
    dt = (rng.standard_normal((B, L, H)) * 0.5 - 1.0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, NG, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, NG, N)).astype(np.float32)
    Ds = rng.standard_normal(H).astype(np.float32)
    dtb = (rng.standard_normal(H) * 0.3).astype(np.float32)
    return tuple(jnp.asarray(v) for v in (x, dt, A, Bm, Cm, Ds, dtb))


def _ref_flat(x, dt, A, Bm, Cm, Ds, dtb, chunk, reverse):
    B, L, HP = x.shape
    H = dt.shape[-1]
    return ssd_chunked(
        x.reshape(1, B, L, H, HP // H), dt[None], A[None], Bm[None],
        Cm[None], Ds[None], dt_bias=dtb[None], chunk=chunk,
        directions=(reverse,)).reshape(B, L, HP)


def _shard_f(args, n_seq, chunk, reverse):
    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))
    lspec = P(None, "seq", None)
    specs = (lspec, lspec, P(), lspec, lspec, P(), P())

    def local(*a):
        return ssd_dir_seq_sharded(*a, chunk, reverse, "seq", n_seq)

    return jax.shard_map(local, mesh=mesh, in_specs=specs,
                         out_specs=lspec, check_vma=False)


@pytest.mark.parametrize("reverse", [False, True])
def test_seq_sharded_matches_single_device(rng, reverse):
    args = make_flat(rng)
    want = _ref_flat(*args, chunk=32, reverse=reverse)
    got = jax.jit(_shard_f(args, 4, 32, reverse))(*args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_seq_sharded_grads_match_single_device(rng, reverse):
    """jax.grad through shard_map over the seq axis == single-device grads
    (the stitch/correction adjoints are derived compositionally)."""
    args = make_flat(rng)
    seed = jnp.asarray(
        np.random.default_rng(1).standard_normal(args[0].shape), jnp.float32)
    f_sp = _shard_f(args, 4, 32, reverse)

    def loss(fn):
        return lambda *a: jnp.sum(fn(*a) * seed)

    argnums = (0, 1, 2, 3, 4, 5, 6)
    want = jax.grad(
        loss(ft.partial(_ref_flat, chunk=32, reverse=reverse)),
        argnums=argnums)(*args)
    got = jax.grad(jax.jit(loss(f_sp)), argnums=argnums)(*args)
    for i, (g, r) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=1e-3, atol=1e-3, err_msg=f"arg {i}")


def test_seq_sharded_wide_heads(rng):
    """At the presets' head geometry (P = N = chunk = 128) the local core
    composes with the stitch/correction — fwd and an x-gradient."""
    args = make_flat(rng, B=1, L=512, H=2, Pd=128, NG=1, N=128)
    want = _ref_flat(*args, chunk=128, reverse=True)
    f_sp = _shard_f(args, 4, 128, True)
    seed = jnp.asarray(
        np.random.default_rng(1).standard_normal(args[0].shape), jnp.float32)
    got = jax.jit(f_sp)(*args)
    gx = jax.grad(
        lambda x: jnp.sum(jax.jit(f_sp)(x, *args[1:]) * seed))(args[0])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-4, atol=3e-4)
    want_gx = jax.grad(
        lambda x: jnp.sum(_ref_flat(x, *args[1:], chunk=128, reverse=True)
                          * seed))(args[0])
    np.testing.assert_allclose(np.asarray(gx), np.asarray(want_gx),
                               rtol=1e-3, atol=1e-3)


def _m2_cfg(**kw):
    from plantcaduceus_tpu.models.config import CaduceusConfig

    base = dict(d_model=32, n_layer=2, vocab_size=16, ssm_variant="mamba2",
                d_state=8, head_dim=16, chunk_size=32)
    base.update(kw)
    return CaduceusConfig(**base)


def test_mamba2_model_forward_context_parallel(rng):
    """Full mamba2 Caduceus forward (RCPS + bidirectional) with the sequence
    axis sharded over a 4-device mesh == the single-device forward: RC-stream
    shard-order flips, the x/B/C conv halos, and the sharded SSD compose."""
    from plantcaduceus_tpu.models import caduceus

    n_seq = 4
    cfg = _m2_cfg()
    params = jax.jit(ft.partial(caduceus.init_params, cfg=cfg))(
        jax.random.PRNGKey(0))
    ids = jnp.asarray(rng.integers(7, 11, size=(2, 128)), jnp.int32)

    want = caduceus.forward(params, ids, cfg, dtype=jnp.float32)["logits"]

    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))

    def local(params, ids):
        return caduceus.forward(params, ids, cfg, dtype=jnp.float32,
                                sp_axis="seq", sp_shards=n_seq)["logits"]

    f = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(None, "seq")),
                      out_specs=P(None, "seq"), check_vma=False)
    got = jax.jit(f)(params, ids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_mamba2_model_grads_context_parallel(rng):
    """MLM-loss gradients through the mamba2 context-parallel forward match
    the single-device gradients."""
    from plantcaduceus_tpu.models import caduceus

    n_seq = 4
    cfg = _m2_cfg()
    params = jax.jit(ft.partial(caduceus.init_params, cfg=cfg))(
        jax.random.PRNGKey(0))
    ids = np.asarray(rng.integers(7, 11, size=(2, 128)), np.int32)
    labels = np.where(rng.random(ids.shape) < 0.3, ids, -100).astype(np.int32)
    ids, labels = jnp.asarray(ids), jnp.asarray(labels)

    def ref_loss(params):
        out = caduceus.forward(params, ids, cfg, dtype=jnp.float32)
        return caduceus.mlm_loss(out["logits"], labels)

    want = jax.grad(ref_loss)(params)

    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))

    def sp_loss(params):
        def local(params, ids, labels):
            out = caduceus.forward(params, ids, cfg, dtype=jnp.float32,
                                   sp_axis="seq", sp_shards=n_seq)
            valid = labels != -100
            safe = jnp.where(valid, labels, 0)
            logp = jax.nn.log_softmax(out["logits"].astype(jnp.float32), -1)
            nll = -jnp.take_along_axis(logp, safe[..., None], -1)[..., 0]
            w = valid.astype(jnp.float32)
            num = jax.lax.psum(jnp.sum(nll * w), "seq")
            den = jax.lax.psum(jnp.sum(w), "seq")
            return num / jnp.maximum(den, 1e-8)

        f = jax.shard_map(local, mesh=mesh,
                          in_specs=(P(), P(None, "seq"), P(None, "seq")),
                          out_specs=P(), check_vma=False)
        return f(params, ids, labels)

    got = jax.grad(jax.jit(sp_loss))(params)

    for path in (("embedding",), ("blocks", "conv_x_w"), ("blocks", "A_log"),
                 ("blocks", "in_proj_B"), ("blocks", "dt_bias"),
                 ("blocks", "in_proj_x"), ("blocks", "mixer_norm_weight"),
                 ("blocks", "out_proj")):
        g, r = got, want
        for k in path:
            g, r = g[k], r[k]
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=3e-3, atol=3e-3,
                                   err_msg="/".join(path))
