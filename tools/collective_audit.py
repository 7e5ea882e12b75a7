"""Deterministic collective audit of the sharded programs.

Compile the REAL sharded scoring forward and the REAL training step on an
8-virtual-device CPU mesh, read the post-SPMD HLO, and pin every collective
XLA will issue on a real multi-device mesh — op kinds, instruction counts,
payload bytes per step. The inventory does not depend on the device, and
host contention cannot corrupt it (unlike a timing proxy on virtual
devices). A pinned golden (tests/goldens/collective_audit.json,
tests/test_collective_audit.py) fails if a code change adds or grows a
collective.

Usage:
    PCAD_PLATFORM=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/collective_audit.py [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("PCAD_PLATFORM", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

from plantcaduceus_tpu.utils.platform import maybe_force_platform  # noqa: E402

maybe_force_platform()

# Audit geometry: small width/depth so CPU compiles stay in seconds — the
# collective STRUCTURE (which ops, how many, which tensors they carry) is
# what the golden pins; payload bytes for the real presets are obtained by
# exact parameter-count scaling of the param-shaped collectives (gradient
# all-reduce bytes == 4 * n_params by construction, verified against the
# audited byte count below).
AUDIT_D_MODEL = 128
AUDIT_N_LAYER = 2
AUDIT_BATCH = 16          # global batch over the 8-device data axis
AUDIT_WINDOW = 512

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

# Collective HLO opcodes (sync and async-start forms; -done carries no
# payload of its own).
_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.-]+\s*=\s*(\([^)]*\)|[\w\[\],{}\s]+?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all|"
    r"collective-broadcast)(?:-start)?\(", re.M)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_text: str) -> int:
    """Total bytes of an HLO shape string (handles tuples)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue  # token[] etc.
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collect_collectives(hlo_text: str) -> dict:
    """-> {opcode: {"count": n, "bytes": total_payload_bytes}} from
    post-optimization HLO."""
    out: dict = {}
    for m in _COLL_RE.finditer(hlo_text):
        shape_text, op = m.group(1), m.group(2)
        rec = out.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += _shape_bytes(shape_text)
    return out


def _param_count(tree) -> int:
    import jax

    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def _small_cfg(ssm_variant: str = "mamba1"):
    from plantcaduceus_tpu.models.config import CaduceusConfig

    kw = {}
    if ssm_variant != "mamba1":
        kw["ssm_variant"] = ssm_variant
    return CaduceusConfig(d_model=AUDIT_D_MODEL, n_layer=AUDIT_N_LAYER, **kw)


def audit_scoring(n_dev: int = 8) -> dict:
    """Post-SPMD collectives of the data-parallel scoring forward."""
    import jax
    import jax.numpy as jnp

    from plantcaduceus_tpu.engine.runner import InferenceRunner
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.utils.model_loading import init_params_seeded

    cfg = _small_cfg()
    params = init_params_seeded(cfg)
    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=n_dev),
                             devices=jax.devices()[:n_dev])
    runner = InferenceRunner(params, cfg, mesh=mesh, dtype=jnp.bfloat16,
                             batch_size=AUDIT_BATCH)
    nuc = jnp.asarray([7, 8, 9, 10], jnp.int32)
    pos = AUDIT_WINDOW // 2 - 1

    def extract(out):
        sel = out["logits"][:, pos, :][:, nuc]
        return jax.nn.softmax(sel, axis=-1)

    fwd = runner._build_fwd(extract, want_hidden=False)
    ids = jnp.zeros((AUDIT_BATCH, AUDIT_WINDOW), jnp.int32)
    ids = jax.device_put(ids, runner._batch_sharding)
    hlo = fwd.lower(runner.params, ids).compile().as_text()
    colls = collect_collectives(hlo)
    return {"mesh": f"data={n_dev}", "params": _param_count(params),
            "global_batch": AUDIT_BATCH, "window": AUDIT_WINDOW,
            "collectives": colls,
            "total_bytes": sum(c["bytes"] for c in colls.values())}


def audit_training(n_dev: int = 8, fsdp: int = 1,
                   ssm_variant: str = "mamba1") -> dict:
    """Post-SPMD collectives of one optimizer step (grad psum, fsdp
    gather/scatter when sharded)."""
    import jax
    import jax.numpy as jnp
    import optax

    from plantcaduceus_tpu.models import caduceus
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import step as step_lib

    cfg = _small_cfg(ssm_variant)
    params = caduceus.init_params(jax.random.PRNGKey(0), cfg)
    n_params = _param_count(params)
    mesh = meshlib.make_mesh(
        meshlib.MeshConfig(data=n_dev // fsdp, fsdp=fsdp),
        devices=jax.devices()[:n_dev])
    opt = optax.adamw(2e-4)
    init_state, train_step, _ = step_lib.make_train_step(
        cfg, opt, mesh, params, dtype=jnp.bfloat16, remat=True)
    state = init_state(params)
    batch = {
        "input_ids": jnp.zeros((AUDIT_BATCH, AUDIT_WINDOW), jnp.int32),
        "labels": jnp.full((AUDIT_BATCH, AUDIT_WINDOW), -100, jnp.int32),
        "loss_weights": jnp.ones((AUDIT_BATCH, AUDIT_WINDOW), jnp.float32),
    }
    hlo = train_step.lower(state, batch).compile().as_text()
    colls = collect_collectives(hlo)
    return {"mesh": f"data={n_dev // fsdp}xfsdp={fsdp}", "params": n_params,
            "global_batch": AUDIT_BATCH, "window": AUDIT_WINDOW,
            "collectives": colls,
            "total_bytes": sum(c["bytes"] for c in colls.values())}


def build_artifact(n_dev: int = 8, include_fsdp: bool = True,
                   include_ssd: bool = True) -> dict:
    """The audit payload: every program's collective inventory, and the
    tie of the gradient all-reduce bytes to the parameter count."""
    audits = {"scoring_dp8": audit_scoring(n_dev),
              "train_dp8": audit_training(n_dev, fsdp=1)}
    if include_fsdp:
        audits["train_dp4_fsdp2"] = audit_training(n_dev, fsdp=2)
    if include_ssd:
        audits["train_dp8_ssd"] = audit_training(n_dev, fsdp=1,
                                                 ssm_variant="mamba2")

    # Sanity tie: the small-geometry gradient all-reduce payload must equal
    # 4 bytes * n_params (fp32 grads,
    # one reduction of every gradient tensor per step).
    t = audits["train_dp8"]
    ar = t["collectives"].get("all-reduce", {"bytes": 0})
    grad_bytes_expected = 4 * t["params"]
    # all-reduce also carries the scalar loss/accuracy/grad-norm metrics;
    # allow a small absolute slack for those.
    tie = abs(ar["bytes"] - grad_bytes_expected) <= 4096 + 0.02 * grad_bytes_expected

    return {
        "mode": "deterministic collective audit: post-SPMD HLO of the real "
                "8-virtual-device programs (kinds/counts/payload bytes)",
        "audit_geometry": {"d_model": AUDIT_D_MODEL, "n_layer": AUDIT_N_LAYER,
                           "global_batch": AUDIT_BATCH,
                           "window": AUDIT_WINDOW},
        "audits": audits,
        "audit_grad_bytes_tie": {
            "grad_allreduce_bytes_audited": ar["bytes"],
            "grad_bytes_expected_4x_params": grad_bytes_expected,
            "consistent": bool(tie)},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, help="write artifact here")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-ssd", action="store_true")
    args = ap.parse_args()
    art = build_artifact(include_fsdp=not args.no_fsdp,
                         include_ssd=not args.no_ssd)
    text = json.dumps(art, indent=1)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(text)
    print(text)


if __name__ == "__main__":
    main()
