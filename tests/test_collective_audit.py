"""Pin the collective inventory of the sharded programs.

The deterministic scaling signal: the post-SPMD HLO of the 8-virtual-device
scoring forward and training step must issue EXACTLY the pinned collectives
(kinds, counts, payload bytes). A code change that adds an unexpected
collective — or grows one — fails here, noise-free.

Golden regenerated by: python tools/collective_audit.py (see the tool's
docstring); tests/goldens/collective_audit.json.
"""

import json
import os

import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "collective_audit.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


def test_scoring_dp8_issues_no_collectives(golden):
    from tools.collective_audit import audit_scoring

    got = audit_scoring(8)
    # The DP scoring forward is collective-free by design: weights are
    # pre-replicated at device_put time, every batch row is device-local,
    # and extraction output stays batch-sharded. This is WHY inference
    # scales ~linearly (BASELINE.md >=85% north star).
    assert got["collectives"] == {}
    assert got["total_bytes"] == 0
    assert got == golden["scoring_dp8"]


def test_train_dp8_collectives_pinned(golden):
    from tools.collective_audit import audit_training

    got = audit_training(8, fsdp=1)
    assert got == golden["train_dp8"], (
        f"collective inventory changed: {got['collectives']} vs golden "
        f"{golden['train_dp8']['collectives']}")
    # Structural invariant independent of the golden: DP-only training
    # all-reduces exactly the gradients (4 bytes/param fp32) plus a few
    # metric scalars.
    ar = got["collectives"]["all-reduce"]
    assert abs(ar["bytes"] - 4 * got["params"]) <= 4096


def test_train_fsdp_uses_zero_pattern(golden):
    from tools.collective_audit import audit_training

    got = audit_training(8, fsdp=2)
    assert got == golden["train_dp4_fsdp2"]
    colls = got["collectives"]
    # ZeRO signature: params gathered (all-gather of ~4*params bytes over
    # the fwd+bwd), grads reduce-scattered (4*params/2 bytes to each
    # half-shard) + the cross-data all-reduce.
    assert "all-gather" in colls and "reduce-scatter" in colls
    assert abs(colls["all-gather"]["bytes"] - 4 * got["params"]) <= 4096
    assert abs(colls["reduce-scatter"]["bytes"] - 2 * got["params"]) <= 4096


def test_train_ssd_dp8_collectives_pinned(golden):
    from tools.collective_audit import audit_training

    got = audit_training(8, fsdp=1, ssm_variant="mamba2")
    assert got == golden["train_dp8_ssd"]
