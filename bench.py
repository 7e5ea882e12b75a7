"""Benchmark lanes on one NVIDIA GPU, budgeted and headline-first.

Mirrors the reference's headline benchmark — wall-clock to zero-shot score
masked 512-bp windows (reference README.md:331-385, 5,000 SNPs per config) —
for every size the reference publishes numbers for (l20/l24/l28/l32), the
SSD (Mamba-2) variants, and the PlantCAD2 family at 8,192 bp
(docs/PlantCAD2-overview.md:17-21). Also times the TRAINING path (s/step,
tok/s, MFU) and runs a planted-structure convergence lane.

* **GPU only**: on any other platform the bench emits a parseable error
  summary and exits non-zero instead of grinding on a fallback backend.
* **One process per card**: every ladder/train lane runs in its own
  subprocess, one after another, and the parent never opens the card.
* **Wall-clock budget** (PCAD_BENCH_BUDGET_S): lanes run headline-first,
  and a lane whose estimated cost exceeds the remaining budget is skipped
  and RECORDED as skipped rather than started.
* **Partial summaries**: the `{"metric": ...}` summary line is printed
  after the headline lane, after the training lanes, and from a
  SIGTERM/atexit handler.

Prints one JSON line per config plus summary lines:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
(the last such line is the most complete). vs_baseline is measured against
the reference's published H100 times (BASELINE.md); headline stays l20.
"""

import atexit
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

T0 = time.time()
BUDGET = float(os.environ.get("PCAD_BENCH_BUDGET_S", "6600"))
RESERVE = 90.0  # tail room: artifacts + final summary always get written

# H100 windows/s from BASELINE.md (5000 / seconds). SSD variants are held to
# the same-size mamba1 baseline; the PlantCAD2 family has no published
# reference throughput (tok/s reported instead, vs the 512-bp ladder).
H100 = {"l20": 312.5, "l24": 238.1, "l28": 161.3, "l32": 106.4}

# (model, n_windows, batch, cost_weight) — window counts capped so the big
# configs keep total runtime bounded; throughput is windows/dt so the cap
# only widens the noise band. cost_weight scales the per-lane first-run
# estimate (deeper/wider => longer compile). Ordered headline-first.
LADDER = [
    ("l20", 5000, 128, 1.0),
    ("l24", 3000, 128, 1.1),
    ("l28", 2000, 128, 1.3),
    ("l32", 1500, 128, 1.5),
    ("l20-ssd", 5000, 128, 1.1),
    ("l32-ssd", 1500, 128, 1.6),
    ("pc2-small", 1024, 32, 1.6),
    ("pc2-small-ssd", 512, 32, 1.7),
    ("pc2-medium", 256, 16, 2.2),
    ("pc2-medium-ssd", 128, 8, 2.2),
    ("pc2-large", 128, 8, 3.0),
]

TRAIN_LANE = [
    # (name, model, batch, window, grad_accum, cost_weight) — headline
    # lanes (l20 family + LoRA) first.
    ("l20", "l20", 32, 512, 1, 1.0),
    ("l20-ssd", "l20-ssd", 32, 512, 1, 1.1),
    ("lora-l20-accum4", "l20", 8, 512, 4, 1.0),
    ("l32", "l32", 32, 512, 1, 1.5),
    ("l32-ssd", "l32-ssd", 32, 512, 1, 1.6),
    ("pc2-small", "pc2-small", 8, 8192, 1, 1.7),
    ("pc2-small-ssd", "pc2-small-ssd", 8, 8192, 1, 1.8),
    ("pc2-medium", "pc2-medium", 2, 8192, 1, 2.4),
]

# First-run cost estimates per lane category (seconds at cost_weight 1.0,
# compilation included). Once a lane of a category completes, later
# estimates shrink toward the observed cost.
COLD_EST = {"ladder": 380.0, "train": 520.0, "convergence": 450.0}

# Dense bf16 tensor-core peak FLOP/s by JAX device_kind, from NVIDIA's H100
# data sheet (SXM 989.4 TFLOPS, PCIe 756 TFLOPS, NVL 835 TFLOPS; without
# sparsity). An unknown kind is an error, not a default.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
}


def peak_flops(kind: str) -> float:
    try:
        return PEAK_FLOPS[kind]
    except KeyError:
        raise ValueError(f"no peak FLOP/s recorded for device kind {kind!r}; "
                         f"add it to bench.PEAK_FLOPS with its source") from None


# ---------------------------------------------------------------------------
# State + summary emission (partial-safe)
# ---------------------------------------------------------------------------

STATE = {
    "results": {},          # ladder: model -> windows/s
    "train_results": {},    # lane -> dict
    "errors": {},           # lane -> message
    "skipped": [],          # [{lane, reason, est_s}]
    "learn_regressions": None,   # None = lane didn't run
    "convergence": None,
    "device": None,         # {"platform", "kind"} of the card
}
_final_emitted = False


def remaining() -> float:
    return BUDGET - (time.time() - T0) - RESERVE


def emit_summary(partial: bool) -> None:
    global _final_emitted
    if _final_emitted:
        return
    if not partial:
        _final_emitted = True
    results, train_results = STATE["results"], STATE["train_results"]
    wps = results.get("l20")
    line = {
        "metric": "zero-shot 512bp windows/sec/chip (l20)",
        "value": round(wps, 1) if wps else None,
        "unit": "windows/s",
        "vs_baseline": round(wps / H100["l20"], 3) if wps else None,
        "device": STATE["device"],
        "ladder_vs_h100": {m: round(results[m] / H100[m.replace("-ssd", "")], 3)
                           for m in results
                           if m.replace("-ssd", "") in H100},
        "pc2_tokens_per_s": {m: round(results[m] * 8192)
                             for m in results if m.startswith("pc2")},
        "train": {k: {"s_per_step": v["s_per_step"],
                      "tokens_per_s": v["tokens_per_s"], "mfu": v["mfu"]}
                  for k, v in train_results.items()},
        "learn_regressions": STATE["learn_regressions"],
        "errors": STATE["errors"] or None,
        "skipped": STATE["skipped"] or None,
        "elapsed_s": round(time.time() - T0, 1),
        "budget_s": BUDGET,
    }
    if partial:
        line["partial"] = True
    print(json.dumps(line), flush=True)


def _on_term(signum, frame):
    STATE["skipped"].append({"lane": "(in-flight)",
                             "reason": f"terminated by signal {signum}"})
    emit_summary(partial=True)
    os._exit(124)


def _at_exit():
    if not _final_emitted:
        emit_summary(partial=True)


# ---------------------------------------------------------------------------
# Lane scheduler: first-run estimates that shrink toward observed cost
# ---------------------------------------------------------------------------

_observed: dict = {}  # category -> max observed seconds per unit weight


def _estimate(category: str, weight: float) -> float:
    obs = _observed.get(category)
    cold = COLD_EST[category] * weight
    if obs is None:
        return cold
    return min(cold, 1.6 * obs * weight + 15.0)


def run_lane(name: str, category: str, weight: float, fn):
    """Run fn() if the budget allows; record skip/error otherwise.
    Returns fn()'s value or None."""
    est = _estimate(category, weight)
    rem = remaining()
    if rem < est:
        STATE["skipped"].append({"lane": name, "reason": "budget",
                                 "est_s": round(est),
                                 "remaining_s": round(rem)})
        print(json.dumps({"lane": name, "skipped": "budget",
                          "est_s": round(est), "remaining_s": round(rem)}),
              flush=True)
        return None
    t0 = time.time()
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — a lane failure must not kill the bench
        STATE["errors"][name] = str(e)[:300]
        print(json.dumps({"lane": name, "error": str(e)[:300]}), flush=True)
        return None
    dt = time.time() - t0
    per_unit = dt / max(weight, 1e-6)
    _observed[category] = max(_observed.get(category, 0.0), per_unit)
    return out


# ---------------------------------------------------------------------------
# Per-lane process isolation
# ---------------------------------------------------------------------------
# Every ladder/train lane runs in its own subprocess, one at a time: a JAX
# process reserves most of the card's memory when it starts, so the parent
# must never open the card, a lane OOM cannot kill the bench, and each lane
# starts from fresh device memory. Compiled programs are shared through the
# persistent compile cache.


def _dispatch(fn_name: str, args: tuple, timeout_s: float = 2400.0):
    code = (f"import json, bench; r = bench.{fn_name}(*{args!r}); "
            f"print('@@RESULT ' + json.dumps(r), flush=True)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ), capture_output=True,
                          text=True, timeout=timeout_s)
    for ln in proc.stdout.splitlines():
        if ln.startswith("@@RESULT "):
            return json.loads(ln[len("@@RESULT "):])
    raise RuntimeError(
        f"{fn_name}{args} subprocess rc={proc.returncode}: "
        f"{(proc.stderr or proc.stdout)[-300:]}")


# ---------------------------------------------------------------------------
# Measurements
# ---------------------------------------------------------------------------


def measure(model: str, n_windows: int, batch: int) -> float:
    import jax.numpy as jnp

    from plantcaduceus_tpu.engine.runner import InferenceRunner
    from plantcaduceus_tpu.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu.models.config import CaduceusConfig
    from plantcaduceus_tpu.utils.model_loading import init_params_seeded

    window = 8192 if model.startswith("pc2") else 512
    cfg = CaduceusConfig.preset(model)
    params = init_params_seeded(cfg)
    tok = DnaTokenizer()
    runner = InferenceRunner(params, cfg, dtype=jnp.bfloat16, batch_size=batch)

    rng = np.random.default_rng(0)
    ids = rng.integers(7, 11, size=(n_windows, window)).astype(np.int32)
    pos = window // 2 - 1
    ids[:, pos] = tok.mask_token_id
    nuc = [7, 8, 9, 10]

    runner.masked_probs(ids[:batch], nuc, pos, progress=False)  # compile
    # masked_probs returns host arrays, so the timing ends after the card.
    t0 = time.perf_counter()
    probs = runner.masked_probs(ids, nuc, pos, progress=False)
    dt = time.perf_counter() - t0
    assert probs.shape == (n_windows, 4) and np.isfinite(probs).all()
    return n_windows / dt


def _param_count(tree) -> int:
    import jax

    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def measure_train(model: str, batch: int, window: int,
                  grad_accum: int) -> dict:
    """One training config: s/step, tok/s, MFU. grad_accum>1 routes through
    the LoRA step (the reference's accumulation-heavy recipe);
    otherwise the full MLM pre-train step at the reference's batch 32."""
    import jax
    import jax.numpy as jnp
    import optax

    from plantcaduceus_tpu.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu.models import caduceus
    from plantcaduceus_tpu.models.config import CaduceusConfig
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import step as step_lib
    from plantcaduceus_tpu.train.masking import MlmCollator

    cfg = CaduceusConfig.preset(model)
    params = caduceus.init_params(jax.random.PRNGKey(0), cfg)
    n_params = _param_count(params)
    mesh = meshlib.make_mesh()
    tok = DnaTokenizer()
    rng = np.random.default_rng(0)
    rows = batch * grad_accum
    raw = rng.integers(7, 11, size=(rows, window)).astype(np.int32)
    b = MlmCollator(tok, seed=0)(raw)
    b["loss_weights"] = np.ones_like(raw, np.float32)
    batch_dev = {k: jnp.asarray(v) for k, v in b.items()}

    lora = grad_accum > 1
    if lora:
        from plantcaduceus_tpu.train import lora as lora_lib

        cfg_l = lora_lib.LoraConfig()
        opt = optax.adamw(1e-3)
        train_step, _ = lora_lib.make_lora_train_step(
            cfg, cfg_l, opt, mesh, params, dtype=jnp.bfloat16,
            grad_accum=grad_accum)
        state = lora_lib.init_lora_state(jax.random.PRNGKey(1), params, cfg,
                                         cfg_l, 2, opt)
        base = meshlib.shard_params(params, mesh, replicated=True)
        lbatch = {"input_ids": batch_dev["input_ids"],
                  "labels": jnp.asarray(rng.integers(0, 2, rows))}
        key = jax.random.PRNGKey(2)

        def one_step(i):
            nonlocal state
            state, m = train_step(state, base, lbatch,
                                  jax.random.fold_in(key, i))
            return m
    else:
        opt = optax.adamw(2e-4)
        init_state, train_step, _ = step_lib.make_train_step(
            cfg, opt, mesh, params, dtype=jnp.bfloat16, remat=True,
            grad_accum=grad_accum)
        state = init_state(params)

        def one_step(i):
            nonlocal state
            state, m = train_step(state, batch_dev)
            return m

    n_warm, n_timed = 2, 10  # the first step compiles
    for i in range(n_warm):
        jax.block_until_ready(one_step(i))
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + n_timed):
        m = one_step(i)
    jax.block_until_ready(m)
    dt = (time.perf_counter() - t0) / n_timed

    tokens = rows * window
    toks_per_s = tokens / dt
    # Training FLOPs ~ 6 * params * tokens (fwd 2x + bwd 4x matmul FLOPs);
    # for LoRA only ~2/6 of that is backward through frozen weights — keep
    # the standard 6x as the conventional upper-bound estimate.
    mfu = 6.0 * n_params * toks_per_s / peak_flops(
        jax.devices()[0].device_kind)
    return {"s_per_step": dt, "tokens_per_s": toks_per_s, "mfu": mfu,
            "params": n_params}


CONVERGENCE_ANCHOR_PATH = os.path.join(REPO, "tests", "goldens",
                                       "convergence_anchor.json")


def measure_convergence() -> dict:
    """Planted-structure learning check (VERDICT r3 #2): pre-train a tiny
    config for 200 steps through the real pipeline at the recipe's
    soft-mask weight 0.1 and probe what it learned — on HELD-OUT probe
    sequences (fresh generator seed; VERDICT r4 #6). Guarded against the
    pinned anchor so the lane fails if the optimizer/masking/weighting
    wiring stops LEARNING, not just stops descending."""
    import jax.numpy as jnp

    from plantcaduceus_tpu.models.config import CaduceusConfig
    from plantcaduceus_tpu.train import convergence as C

    cfg = CaduceusConfig(d_model=64, n_layer=2, vocab_size=16, d_state=8)
    run = C.train_planted(cfg, steps=200, batch=16, n_corpus=512,
                          soft_masked_weight=0.1, dtype=jnp.bfloat16)
    m = C.evaluate_structure(run)
    return {"final_loss": round(run["final_loss"], 4),
            "loss_trajectory": [[s, round(v, 4)] for s, v in run["losses"]],
            "motif_accuracy": round(m["motif_accuracy"], 4),
            "background_accuracy": round(m["background_accuracy"], 4),
            "repeat_loss": round(m["repeat_loss"], 4),
            "held_out": bool(m.get("held_out", False))}


def check_convergence() -> list:
    """-> list of learn-regression strings (empty = healthy); prints the
    convergence JSON line and refreshes the anchor (best loss kept)."""
    r = _dispatch("measure_convergence", ())
    STATE["convergence"] = r
    try:
        anchor = json.load(open(CONVERGENCE_ANCHOR_PATH))
    except Exception:
        anchor = {}
    probs = []
    if r["motif_accuracy"] < 0.8:
        probs.append(f"motif accuracy {r['motif_accuracy']} < 0.8 floor "
                     "(recipe no longer learns planted structure)")
    if r["background_accuracy"] > 0.45:
        probs.append(f"background accuracy {r['background_accuracy']} > "
                     "0.45 (label/mask leakage)")
    if anchor.get("final_loss") and \
            r["final_loss"] > 1.15 * anchor["final_loss"]:
        probs.append(f"loss@200 {r['final_loss']} > 115% of anchor "
                     f"{anchor['final_loss']}")
    print(json.dumps({"convergence": r,
                      "anchor_final_loss": anchor.get("final_loss"),
                      "learn_regressions": probs or None}), flush=True)
    best = min(r["final_loss"], anchor.get("final_loss", float("inf")))
    if best != anchor.get("final_loss"):
        with open(CONVERGENCE_ANCHOR_PATH, "w") as fh:
            json.dump({"final_loss": best,
                       "motif_accuracy_floor": 0.8}, fh, indent=1)
    return probs


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def _probe_platform() -> dict:
    """Device probe in a subprocess, so this process never opens the card."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax, json; d = jax.devices()[0]; "
         "print('@@RESULT ' + json.dumps({'platform': d.platform, "
         "'kind': d.device_kind}), flush=True)"],
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True,
        timeout=300)
    for ln in proc.stdout.splitlines():
        if ln.startswith("@@RESULT "):
            return json.loads(ln[len("@@RESULT "):])
    raise RuntimeError(f"device probe rc={proc.returncode}: "
                       f"{(proc.stderr or proc.stdout)[-300:]}")


def main():
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    atexit.register(_at_exit)

    # -- GPU assertion: fail fast and parseably anywhere else --------------
    try:
        probe = _probe_platform()
        platform = probe["platform"]
    except Exception as e:
        STATE["errors"]["platform"] = f"jax device init failed: {e!s:.300}"
        emit_summary(partial=False)
        sys.exit(3)
    STATE["device"] = probe
    if platform != "gpu":
        STATE["errors"]["platform"] = (
            f"no GPU: jax platform is '{platform}' — refusing to grind on a "
            "fallback backend")
        emit_summary(partial=False)
        sys.exit(2)
    print(json.dumps({"platform": platform, "device_kind": probe["kind"],
                      "budget_s": BUDGET}), flush=True)

    def ladder_lane(model, n, batch):
        window = 8192 if model.startswith("pc2") else 512
        wps = _dispatch("measure", (model, n, batch))
        STATE["results"][model] = wps
        base = H100.get(model.replace("-ssd", ""))
        print(json.dumps({
            "model": model,
            "windows_per_s": round(wps, 1),
            "window_bp": window,
            "tokens_per_s": round(wps * window),
            "vs_h100": round(wps / base, 3) if base else None,
        }), flush=True)

    # -- 1. headline lane ---------------------------------------------------
    name, n, batch, w = LADDER[0]
    run_lane(f"ladder:{name}", "ladder", w,
             lambda: ladder_lane(name, n, batch))
    emit_summary(partial=True)  # a hard kill from here on still leaves l20

    # -- 2./3. ladder + training lanes, priority-interleaved ----------------
    # The 512-bp ladder and the headline training lanes run before the
    # expensive 8192-bp pc2 compiles; pc2 training lanes last.
    def train_lane(lname, model, batch, window, accum):
        r = _dispatch("measure_train", (model, batch, window, accum))
        STATE["train_results"][lname] = r
        print(json.dumps({"train": lname, **r}), flush=True)

    ladder_by_name = {m: (m, n, b, w) for m, n, b, w in LADDER}
    train_by_name = dict((t[0], t) for t in TRAIN_LANE)
    order = ([("ladder", ladder_by_name[m]) for m in
              ("l24", "l28", "l32", "l20-ssd", "l32-ssd")]
             + [("train", train_by_name[t]) for t in
                ("l20", "l20-ssd", "lora-l20-accum4", "l32", "l32-ssd")]
             + [("ladder", ladder_by_name[m]) for m in
                ("pc2-small", "pc2-small-ssd", "pc2-medium",
                 "pc2-medium-ssd", "pc2-large")]
             + [("train", train_by_name[t]) for t in
                ("pc2-small", "pc2-small-ssd", "pc2-medium")])
    for kind, spec in order:
        if kind == "ladder":
            model, n, batch, w = spec
            run_lane(f"ladder:{model}", "ladder", w,
                     lambda m=model, nn=n, bb=batch: ladder_lane(m, nn, bb))
        else:
            lname, model, batch, window, accum, w = spec
            run_lane(f"train:{lname}", "train", w,
                     lambda a=lname, b=model, c=batch, d=window, e=accum:
                     train_lane(a, b, c, d, e))
    emit_summary(partial=True)  # ladder + training now safe

    # -- 4. convergence lane ------------------------------------------------
    out = run_lane("convergence", "convergence", 1.0, check_convergence)
    if out is not None:
        STATE["learn_regressions"] = out or None
    elif "convergence" in STATE["errors"]:
        STATE["learn_regressions"] = [
            f"convergence lane failed to run: {STATE['errors']['convergence']}"]

    emit_summary(partial=False)


if __name__ == "__main__":
    main()
