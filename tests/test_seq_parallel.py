"""Sequence-parallel scan on a virtual mesh vs the single-device scan."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from plantcaduceus_tpu.ops.seq_parallel import selective_scan_seq_sharded
from plantcaduceus_tpu.ops.selective_scan import selective_scan_sequential


@pytest.mark.parametrize("directions", [None, (False, True)])
def test_seq_sharded_matches_single_device(rng, directions):
    G, B, L, D, N = 2, 2, 256, 16, 4
    n_seq = 4
    x = jnp.asarray(rng.standard_normal((G, B, L, D)), jnp.float32)
    dt = jnp.asarray(rng.standard_normal((G, B, L, D)) * 0.5 - 1, jnp.float32)
    A = jnp.asarray(-np.exp(rng.standard_normal((G, D, N)) * .5), jnp.float32)
    Bm = jnp.asarray(rng.standard_normal((G, B, L, N)), jnp.float32)
    Cm = jnp.asarray(rng.standard_normal((G, B, L, N)), jnp.float32)
    Ds = jnp.asarray(rng.standard_normal((G, D)), jnp.float32)
    dtb = jnp.asarray(rng.standard_normal((G, D)) * .3, jnp.float32)

    # single-device reference (with per-group flips for reversed directions)
    if directions is None:
        want = selective_scan_sequential(x, dt, A, Bm, Cm, Ds, dt_bias=dtb)
    else:
        flip1 = lambda t: t.at[1].set(jnp.flip(t[1], axis=1))
        want = selective_scan_sequential(flip1(x), flip1(dt), A, flip1(Bm),
                                         flip1(Cm), Ds, dt_bias=dtb)
        want = flip1(want)

    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))
    lspec = P(None, None, "seq", None)

    def local(x, dt, Bm, Cm):
        return selective_scan_seq_sharded(
            x, dt, A, Bm, Cm, Ds, dtb, None, "seq", n_seq,
            directions=directions)

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(lspec, lspec, lspec, lspec),
                      out_specs=lspec, check_vma=False)
    got = jax.jit(f)(x, dt, Bm, Cm)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("directions", [None, (False, True)])
def test_seq_sharded_grads_match_single_device(rng, directions):
    """jax.grad through shard_map over the seq axis == single-device grads
    (the adjoint stitching is derived compositionally; no hand-written
    cross-shard backward)."""
    G, B, L, D, N = 2, 2, 256, 16, 4
    n_seq = 4
    x = jnp.asarray(rng.standard_normal((G, B, L, D)), jnp.float32)
    dt = jnp.asarray(rng.standard_normal((G, B, L, D)) * 0.5 - 1, jnp.float32)
    A = jnp.asarray(-np.exp(rng.standard_normal((G, D, N)) * .5), jnp.float32)
    Bm = jnp.asarray(rng.standard_normal((G, B, L, N)), jnp.float32)
    Cm = jnp.asarray(rng.standard_normal((G, B, L, N)), jnp.float32)
    Ds = jnp.asarray(rng.standard_normal((G, D)), jnp.float32)
    dtb = jnp.asarray(rng.standard_normal((G, D)) * .3, jnp.float32)
    w = jnp.asarray(rng.standard_normal((G, B, L, D)), jnp.float32)

    if directions is None:
        rev = lambda t: t
    else:
        rev = lambda t: t.at[1].set(jnp.flip(t[1], axis=1))

    def ref_loss(x, dt, A, Bm, Cm, Ds, dtb):
        y = selective_scan_sequential(rev(x), rev(dt), A, rev(Bm), rev(Cm),
                                      Ds, dt_bias=dtb)
        return jnp.sum(rev(y) * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4, 5, 6))(
        x, dt, A, Bm, Cm, Ds, dtb)

    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))
    lspec = P(None, None, "seq", None)

    def sp_loss(x, dt, A, Bm, Cm, Ds, dtb):
        def local(x, dt, Bm, Cm, w):
            y = selective_scan_seq_sharded(
                x, dt, A, Bm, Cm, Ds, dtb, None, "seq", n_seq,
                directions=directions)
            return jax.lax.psum(jnp.sum(y * w), "seq")

        f = jax.shard_map(local, mesh=mesh,
                          in_specs=(lspec, lspec, lspec, lspec, lspec),
                          out_specs=P(), check_vma=False)
        return f(x, dt, Bm, Cm, w)

    got = jax.jit(jax.grad(sp_loss, argnums=(0, 1, 2, 3, 4, 5, 6)))(
        x, dt, A, Bm, Cm, Ds, dtb)

    names = ["dx", "ddt", "dA", "dB", "dC", "dD", "ddtb"]
    for n, g, r in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=2e-3, atol=2e-3, err_msg=n)


def test_seq_sharded_grads_fused_dtproj(rng):
    """Gradients with the low-rank dt projection fused into the kernel."""
    G, B, L, D, N, R = 1, 2, 128, 16, 4, 8
    n_seq = 4
    x = jnp.asarray(rng.standard_normal((G, B, L, D)), jnp.float32)
    dt_lr = jnp.asarray(rng.standard_normal((G, B, L, R)) * .5, jnp.float32)
    W = jnp.asarray(rng.standard_normal((G, R, D)) * .3, jnp.float32)
    A = jnp.asarray(-np.exp(rng.standard_normal((G, D, N)) * .5), jnp.float32)
    Bm = jnp.asarray(rng.standard_normal((G, B, L, N)), jnp.float32)
    Cm = jnp.asarray(rng.standard_normal((G, B, L, N)), jnp.float32)
    Ds = jnp.asarray(rng.standard_normal((G, D)), jnp.float32)
    dtb = jnp.asarray(rng.standard_normal((G, D)) * .3, jnp.float32)
    w = jnp.asarray(rng.standard_normal((G, B, L, D)), jnp.float32)

    def ref_loss(x, dt_lr, W, A, Bm, Cm, Ds, dtb):
        dt = jnp.einsum("gblr,gri->gbli", dt_lr, W)
        y = selective_scan_sequential(x, dt, A, Bm, Cm, Ds, dt_bias=dtb)
        return jnp.sum(y * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(x, dt_lr, W, A, Bm, Cm,
                                                 Ds, dtb)

    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))
    lspec = P(None, None, "seq", None)

    def sp_loss(x, dt_lr, W, A, Bm, Cm, Ds, dtb):
        def local(x, dt_lr, Bm, Cm, w):
            y = selective_scan_seq_sharded(
                x, dt_lr, A, Bm, Cm, Ds, dtb, W, "seq", n_seq,
                directions=None)
            return jax.lax.psum(jnp.sum(y * w), "seq")

        f = jax.shard_map(local, mesh=mesh,
                          in_specs=(lspec, lspec, lspec, lspec, lspec),
                          out_specs=P(), check_vma=False)
        return f(x, dt_lr, Bm, Cm, w)

    got = jax.jit(jax.grad(sp_loss, argnums=(0, 1, 2)))(
        x, dt_lr, W, A, Bm, Cm, Ds, dtb)

    for n, g, r in zip(["dx", "ddt_lr", "dW"], got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=2e-3, atol=2e-3, err_msg=n)


def test_model_forward_context_parallel(rng):
    """Full Caduceus forward (RCPS + bidirectional) with the sequence axis
    sharded over a 4-device mesh == the single-device forward: the RC-stream
    global flips (ppermute), the conv halo exchange, and the two-pass scan
    all compose correctly."""
    import functools as ft

    from plantcaduceus_tpu.models import caduceus
    from plantcaduceus_tpu.models.config import CaduceusConfig

    n_seq = 4
    cfg = CaduceusConfig(d_model=16, n_layer=2, vocab_size=16, d_state=4,
                         scan_impl="chunked")
    cfg_ref = CaduceusConfig(d_model=16, n_layer=2, vocab_size=16, d_state=4,
                             scan_impl="associative")
    params = jax.jit(ft.partial(caduceus.init_params, cfg=cfg))(
        jax.random.PRNGKey(0))
    ids = jnp.asarray(rng.integers(7, 11, size=(2, 128)), jnp.int32)

    want = caduceus.forward(params, ids, cfg_ref, dtype=jnp.float32)["logits"]

    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))

    def local(params, ids):
        return caduceus.forward(params, ids, cfg, dtype=jnp.float32,
                                sp_axis="seq", sp_shards=n_seq)["logits"]

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(), P(None, "seq")),
                      out_specs=P(None, "seq"), check_vma=False)
    got = jax.jit(f)(params, ids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_model_grads_context_parallel(rng):
    """MLM-loss gradients through the context-parallel forward match the
    single-device gradients (spot-checked on embedding + one mixer's
    conv/x_proj/A params)."""
    import functools as ft

    from plantcaduceus_tpu.models import caduceus
    from plantcaduceus_tpu.models.config import CaduceusConfig

    n_seq = 4
    cfg = CaduceusConfig(d_model=16, n_layer=2, vocab_size=16, d_state=4,
                         scan_impl="chunked")
    cfg_ref = CaduceusConfig(d_model=16, n_layer=2, vocab_size=16, d_state=4,
                             scan_impl="associative")
    params = jax.jit(ft.partial(caduceus.init_params, cfg=cfg))(
        jax.random.PRNGKey(0))
    ids = np.asarray(rng.integers(7, 11, size=(2, 128)), np.int32)
    labels = np.where(rng.random(ids.shape) < 0.3, ids, -100).astype(np.int32)
    ids, labels = jnp.asarray(ids), jnp.asarray(labels)

    def ref_loss(params):
        out = caduceus.forward(params, ids, cfg_ref, dtype=jnp.float32)
        return caduceus.mlm_loss(out["logits"], labels)

    want = jax.grad(ref_loss)(params)

    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))

    def sp_loss(params):
        def local(params, ids, labels):
            out = caduceus.forward(params, ids, cfg, dtype=jnp.float32,
                                   sp_axis="seq", sp_shards=n_seq)
            # globally-normalised weighted CE: psum numerator + denominator
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

    for path in (("embedding",), ("blocks", "conv_w"), ("blocks", "A_log"),
                 ("blocks", "x_proj_B"), ("blocks", "dt_proj_w"),
                 ("blocks", "in_proj_x"), ("blocks", "out_proj")):
        g, r = got, want
        for k in path:
            g, r = g[k], r[k]
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=3e-3, atol=3e-3,
                                   err_msg="/".join(path))


def test_train_step_context_parallel(rng):
    """make_train_step on a (data=2, seq=4) mesh == a pure-DP (data=8) mesh:
    one optimizer step from identical params/batch yields the same loss,
    accuracy, and updated parameters."""
    import optax

    from plantcaduceus_tpu.models import caduceus
    from plantcaduceus_tpu.models.config import CaduceusConfig
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import step as step_lib

    cfg = CaduceusConfig(d_model=16, n_layer=2, vocab_size=16, d_state=4,
                         scan_impl="chunked")
    params = jax.jit(functools.partial(caduceus.init_params, cfg=cfg))(
        jax.random.PRNGKey(0))
    B, L = 8, 64
    ids = rng.integers(7, 11, size=(B, L)).astype(np.int32)
    labels = np.where(rng.random((B, L)) < 0.3, ids, -100).astype(np.int32)
    batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels),
             "loss_weights": jnp.ones((B, L), jnp.float32)}

    def run(mesh_cfg):
        mesh = meshlib.make_mesh(mesh_cfg)
        init_state, train_step, eval_step = step_lib.make_train_step(
            cfg, optax.sgd(1e-2), mesh, params, dtype=jnp.float32,
            remat=True, fsdp=False)
        state = init_state(params)
        state, metrics = train_step(state, batch)
        ev = eval_step(state, batch)
        return state, metrics, ev

    state_dp, m_dp, ev_dp = run(meshlib.MeshConfig(data=8))
    state_sp, m_sp, ev_sp = run(meshlib.MeshConfig(data=2, seq=4))

    np.testing.assert_allclose(float(m_sp["loss"]), float(m_dp["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m_sp["accuracy"]),
                               float(m_dp["accuracy"]), rtol=1e-6)
    np.testing.assert_allclose(float(ev_sp["loss"]), float(ev_dp["loss"]),
                               rtol=1e-4)
    flat_dp = jax.tree.leaves(state_dp.params)
    flat_sp = jax.tree.leaves(state_sp.params)
    for a, b in zip(flat_sp, flat_dp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3)


def test_model_forward_context_parallel_auto_impl(rng):
    """Context parallelism must work with the default scan_impl='auto'
    (on the CPU it resolves to the chunked scan's seeded form)."""
    import functools as ft

    from plantcaduceus_tpu.models import caduceus
    from plantcaduceus_tpu.models.config import CaduceusConfig

    n_seq = 2
    cfg = CaduceusConfig(d_model=16, n_layer=1, vocab_size=16, d_state=4)
    assert cfg.scan_impl == "auto"
    params = jax.jit(ft.partial(caduceus.init_params, cfg=cfg))(
        jax.random.PRNGKey(0))
    ids = jnp.asarray(rng.integers(7, 11, size=(2, 64)), jnp.int32)

    want = caduceus.forward(params, ids, cfg, dtype=jnp.float32)["logits"]

    mesh = Mesh(np.asarray(jax.devices()[:n_seq]), ("seq",))
    f = jax.shard_map(
        lambda p, i: caduceus.forward(p, i, cfg, dtype=jnp.float32,
                                      sp_axis="seq",
                                      sp_shards=n_seq)["logits"],
        mesh=mesh, in_specs=(P(), P(None, "seq")),
        out_specs=P(None, "seq"), check_vma=False)
    got = jax.jit(f)(params, ids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_shard_batch_seq_mesh():
    """shard_batch shards [B, L] token arrays over (batch, seq) on a seq
    mesh, leaves other entries batch-only, and is a no-op spec-wise on a
    seq-free mesh."""
    from plantcaduceus_tpu.parallel import mesh as meshlib

    batch = {"input_ids": jnp.zeros((8, 16), jnp.int32),
             "labels": jnp.zeros((8, 16), jnp.int32),
             "extra": jnp.zeros((8, 3), jnp.float32)}

    m_sp = meshlib.make_mesh(meshlib.MeshConfig(data=2, seq=4))
    placed = meshlib.shard_batch(batch, m_sp)
    assert placed["input_ids"].sharding.spec == P(("data", "fsdp"), "seq")
    assert placed["extra"].sharding.spec == meshlib.batch_spec()

    m_dp = meshlib.make_mesh(meshlib.MeshConfig(data=8))
    placed = meshlib.shard_batch(batch, m_dp)
    assert placed["input_ids"].sharding.spec == meshlib.batch_spec()
