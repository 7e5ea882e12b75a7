"""Structural tests for the budgeted bench harness.

These pin the harness's guarantees without touching a GPU: the device probe
and the per-lane subprocess dispatch are monkeypatched, measurements are
faked, and only the platform gate, scheduling, budget and summary-emission
logic runs.
"""

import importlib
import json

import pytest

import bench as bench_mod

H100_KIND = "NVIDIA H100 80GB HBM3"


@pytest.fixture()
def bench(monkeypatch, tmp_path):
    """A reloaded bench module with fake measurements, a fake GPU probe and
    in-process lane dispatch."""
    b = importlib.reload(bench_mod)
    calls = {"ladder": [], "train": []}

    monkeypatch.setattr(b, "measure",
                        lambda model, n, batch: calls["ladder"].append(model)
                        or 100.0)
    monkeypatch.setattr(
        b, "measure_train",
        lambda model, batch, window, accum: calls["train"].append(model)
        or {"s_per_step": 0.1, "tokens_per_s": 50000, "mfu": 0.05,
            "params": 1000})
    monkeypatch.setattr(
        b, "measure_convergence",
        lambda: {"final_loss": 1.0, "loss_trajectory": [],
                 "motif_accuracy": 0.9, "background_accuracy": 0.3,
                 "repeat_loss": 1.0, "held_out": True})
    monkeypatch.setattr(b, "_probe_platform",
                        lambda: {"platform": "gpu", "kind": H100_KIND})
    monkeypatch.setattr(b, "_dispatch",
                        lambda fn_name, args, timeout_s=0: getattr(b, fn_name)(
                            *args))
    monkeypatch.setattr(b, "CONVERGENCE_ANCHOR_PATH",
                        str(tmp_path / "conv.json"))
    b._calls = calls
    return b


def _summaries(capsys):
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return lines, [ln for ln in lines if "metric" in ln]


def test_full_run_emits_progressive_summaries(bench, capsys):
    bench.main()
    lines, summaries = _summaries(capsys)
    # partial after headline, partial after train, final at end
    assert len(summaries) >= 3
    assert summaries[0]["partial"] is True
    assert summaries[0]["value"] == 100.0          # headline present early
    final = summaries[-1]
    assert "partial" not in final
    assert final["value"] == 100.0
    assert final["device"] == {"platform": "gpu", "kind": H100_KIND}
    # every ladder model and train lane ran
    assert set(m for m, *_ in bench.LADDER) == set(bench._calls["ladder"])
    assert len(final["train"]) == len(bench.TRAIN_LANE)


def test_budget_skips_tail_lanes_but_keeps_headline(bench, capsys,
                                                    monkeypatch):
    # Headline-lane estimate (380) fits, nothing after it does: each
    # completed lane reports a high observed per-unit cost.
    monkeypatch.setattr(bench, "BUDGET", 380 + 100 + bench.RESERVE)
    orig_run_lane = bench.run_lane

    def slow_clock_lane(name, cat, weight, fn):
        out = orig_run_lane(name, cat, weight, fn)
        bench._observed[cat] = 300.0  # observed per-unit cost stays high
        return out

    monkeypatch.setattr(bench, "run_lane", slow_clock_lane)
    bench.main()
    lines, summaries = _summaries(capsys)
    final = summaries[-1]
    assert final["value"] == 100.0                 # headline recorded
    assert final["skipped"], "tail lanes must be recorded as skipped"
    skipped_names = {s["lane"] for s in final["skipped"]}
    assert any(ln.startswith("ladder:pc2") or ln.startswith("train")
               for ln in skipped_names)
    for s in final["skipped"]:
        assert s["reason"] == "budget"


def test_lane_error_does_not_kill_the_bench(bench, capsys, monkeypatch):
    def boom(model, n, batch):
        raise RuntimeError("lane exploded")

    monkeypatch.setattr(bench, "measure", boom)
    bench.main()
    lines, summaries = _summaries(capsys)
    final = summaries[-1]
    assert final["value"] is None
    assert any("lane exploded" in v for v in final["errors"].values())
    assert final["train"], "training lanes still ran"


@pytest.mark.parametrize("platform", ["cpu", "METAL"])
def test_non_gpu_platform_is_refused(bench, capsys, monkeypatch, platform):
    monkeypatch.setattr(bench, "_probe_platform",
                        lambda: {"platform": platform, "kind": "x"})
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code == 2
    lines, summaries = _summaries(capsys)
    assert "no GPU" in summaries[-1]["errors"]["platform"]
    assert not bench._calls["ladder"] and not bench._calls["train"]


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12),
])
def test_peak_flops_by_device_kind(kind, peak):
    assert bench_mod.peak_flops(kind) == peak


@pytest.mark.parametrize("kind", ["NVIDIA H200", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(ValueError, match="no peak FLOP/s"):
        bench_mod.peak_flops(kind)
