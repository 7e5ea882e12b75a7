"""The numpy checkpoint format: pytree round-trips, the step manager's
save interval, keep-N and resume, and the weight export."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from plantcaduceus_tpu.models.config import CaduceusConfig
from plantcaduceus_tpu.train import checkpoint as ckpt
from plantcaduceus_tpu.train.step import TrainState


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32,
                                   jnp.bool_, jnp.float16])
@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_tree_round_trip(tmp_path, dtype, shape):
    a = (jnp.arange(int(np.prod(shape)) or 1) % 3).reshape(shape)
    tree = {"w": a.astype(dtype), "nested": {"b": jnp.ones((2,), dtype)}}
    ckpt.save_tree(tmp_path / "t.npz", tree)
    back = ckpt.load_tree(tmp_path / "t.npz")
    assert set(back) == {"w", "nested"}
    for got, want in ((back["w"], tree["w"]),
                      (back["nested"]["b"], tree["nested"]["b"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want, np.float32))


def _state(seed=0):
    params = {"emb": jax.random.normal(jax.random.PRNGKey(seed), (4, 3)),
              "blocks": {"w": jnp.ones((2, 3), jnp.bfloat16)}}
    opt = optax.adamw(1e-3)
    return TrainState(params, opt.init(params), jnp.asarray(seed, jnp.int32))


def test_restore_onto_template(tmp_path):
    state = _state(5)
    mgr = ckpt.CheckpointManager(tmp_path, save_interval_steps=1)
    assert mgr.save(5, state)
    back = mgr.restore(_state(0))
    assert int(back.step) == 5
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_save_interval_and_force(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, save_interval_steps=3)
    assert not mgr.save(2, _state())
    assert mgr.save(3, _state())
    assert mgr.save(4, _state(), force=True)
    assert mgr.steps() == [3, 4]


def test_keep_n(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, save_interval_steps=1,
                                 max_to_keep=2)
    for s in range(1, 6):
        mgr.save(s, _state())
    assert mgr.steps() == [4, 5]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["4", "5"]


def test_latest_step_skips_interrupted_save(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, save_interval_steps=1)
    mgr.save(2, _state())
    (tmp_path / "7").mkdir()  # a save that never wrote checkpoint.json
    assert mgr.latest_step() == 2
    assert json.loads((tmp_path / "2" / "checkpoint.json").read_text()) == \
        {"step": 2}


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(tmp_path).restore(_state())


def test_export_and_load_params(tmp_path):
    cfg = CaduceusConfig(d_model=16, n_layer=1, d_state=4)
    params = _state(1).params
    ckpt.export_params(tmp_path / "exp", params, cfg)
    back, cfg2 = ckpt.load_params(tmp_path / "exp")
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(back["emb"]),
                                  np.asarray(params["emb"]))
    assert back["blocks"]["w"].dtype == jnp.bfloat16


def test_pretrain_cli_resumes_the_step_count(tmp_path):
    """cli.pretrain saves on its interval, and a second run with more steps
    resumes from the saved step instead of starting over."""
    from plantcaduceus_tpu.cli import pretrain

    cfg = CaduceusConfig(d_model=16, n_layer=1, d_state=4)
    cfg.save(tmp_path / "cfg.json")
    out = tmp_path / "run"
    common = ["--dataset", "synthetic", "--config", str(tmp_path / "cfg.json"),
              "--window", "32", "--batch-size", "8", "--save-steps", "2",
              "--eval-steps", "0",
              "--output-dir", str(out), "--dtype", "float32"]
    pretrain.main(common + ["--max-steps", "2"])
    assert ckpt.CheckpointManager(out).latest_step() == 2
    pretrain.main(common + ["--max-steps", "4"])
    mgr = ckpt.CheckpointManager(out)
    assert mgr.latest_step() == 4
    assert (out / "final" / "params.npz").is_file()
