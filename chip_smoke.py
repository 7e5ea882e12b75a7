#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU, in one process.

Run from the root of a checkout:

    python3 chip_smoke.py             # one card
    python3 chip_smoke.py --cards 4   # the four-card phases only

One card, at the published widths of PlantCaduceus_l20 (d_model 384,
20 layers, 512 bp) with random weights made from a seed:

1. card       — name and power limit (nvidia-smi), JAX device kind, compile
                cache directory;
2. kernels    — the selected Mamba-1 scan (the Triton kernel, compiled for
                the card) against the sequential reference in fp32 with TF32
                off: forward and gradients, both directions, with and
                without an initial state, at d_inner 768 / L 512 (l20),
                2048 / 512 (l32) and 3072 / 8192 (pc2-large); and the
                compiled memory of the l20 scoring step at batch 128;
3. scoring    — cli.zero_shot_score in VCF mode at batch 128 over a FASTA
                and VCF made from the seed, then 64 of its windows again
                through the plain fp32 model (chunked XLA scan, highest
                matmul precision);
4. serving    — engine.server.ScoringServer in this process, /score and
                /embed over localhost; its scores must equal the CLI's;
5. training   — cli.pretrain on synthetic data at batch 32 with a save and
                a resume: finite, falling loss, and a resumed step count;
6. timing     — the Triton scan against the chunked XLA scan end to end:
                l20 scoring windows/s at batch 128 and l20 training s/step
                at batch 32, in turns (A B B A).

With ``--cards 4`` it runs only: data-parallel training and scoring over
four cards against one card at the same global batch, and context-parallel
(seq=4) scoring of PlantCAD2-Small at 8,192 bp against one card.

Any failed phase ends the run with a non-zero exit and no result line. The
last line of a passing run is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

SEED = 0
L20 = "l20"
WINDOW = 512
TOKEN_IDX = 255

# Tolerances (relative to the largest reference magnitude). fp32 on both
# sides, TF32 off; what remains is summation order (the kernel reduces over
# the state axis in registers, the reference with an einsum).
FWD_TOL = 1e-4
GRAD_TOL = 1e-3
# Scores against the fp32 reference: tests/test_score_consistency.py's bf16
# bound (log-ratio scores are O(0.1-1)).
SCORE_CORR, SCORE_ATOL = 0.999, 0.05


class PhaseFailed(RuntimeError):
    pass


def say(*parts):
    print(*parts, flush=True)


def check(name, value, limit, *, below=True):
    ok = np.isfinite(value) and (value <= limit if below else value >= limit)
    say(f"  {name}: {value:.3e} ({'<=' if below else '>='} {limit:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed(f"{name} = {value} outside {limit}")


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def phase_card(jax):
    say(card_line())
    d = jax.devices()[0]
    say(f"device_kind: {d.device_kind} (count {len(jax.devices())})")
    say(f"compile cache: {jax.config.jax_compilation_cache_dir}")


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------


def scan_inputs(jax, jnp, B, L, D, N=16, G=2, seed=SEED):
    """Model-like inputs: low-rank dt (rank d_model/16) projected up inside
    the scan, negative A, fp32."""
    R = -(-D // 32)
    ks = jax.random.split(jax.random.PRNGKey(seed), 9)
    x = jax.random.normal(ks[0], (G, B, L, D))
    dt = jax.random.normal(ks[1], (G, B, L, R)) * 0.5 - 1.0
    w = jax.random.normal(ks[2], (G, R, D)) * R ** -0.5
    A = -jnp.exp(jax.random.normal(ks[3], (G, D, N)) * 0.5)
    Bm = jax.random.normal(ks[4], (G, B, L, N))
    Cm = jax.random.normal(ks[5], (G, B, L, N))
    Ds = jax.random.normal(ks[6], (G, D))
    dtb = jax.random.normal(ks[7], (G, D)) * 0.3
    h0 = jax.random.normal(ks[8], (G, B, D, N))
    return x, dt, A, Bm, Cm, Ds, dtb, w, h0


def phase_kernels(jax, jnp, shapes, impl):
    from plantcaduceus_tpu.ops.selective_scan import selective_scan

    say(f"kernel under test: {impl}")
    directions = (False, True)  # group 0 forward, group 1 reverse

    def make(impl_name, with_h0):
        def f(x, dt, A, Bm, Cm, Ds, dtb, w, h0, ky, kh):
            y, h = selective_scan(
                x, dt, A, Bm, Cm, Ds, dt_bias=dtb, impl=impl_name,
                dt_proj_w=w, directions=directions,
                h0=h0 if with_h0 else None, return_final_state=True)
            return jnp.sum(y * ky) + jnp.sum(h * kh), (y, h)
        return jax.jit(jax.value_and_grad(f, argnums=tuple(range(9)),
                                          has_aux=True))

    for name, (B, L, D) in shapes.items():
        args = scan_inputs(jax, jnp, B, L, D)
        ky = jax.random.normal(jax.random.PRNGKey(1), args[0].shape)
        kh = jax.random.normal(jax.random.PRNGKey(2), args[-1].shape)
        for with_h0 in (False, True):
            with jax.default_matmul_precision("highest"):
                (_, (y, h)), g = make(impl, with_h0)(*args, ky, kh)
                (_, (y_r, h_r)), g_r = make("sequential", with_h0)(
                    *args, ky, kh)
            tag = f"{name} d_inner={D} L={L} batch={B} h0={with_h0}"
            say(f"{tag}:")
            check("forward y rel err", rel_err(y, y_r), FWD_TOL)
            check("final state rel err", rel_err(h, h_r), FWD_TOL)
            names = ["dx", "ddt", "dA", "dB", "dC", "dD", "ddt_bias",
                     "dW_dt", "dh0"]
            worst = max((rel_err(a, b), n) for n, a, b in zip(names, g, g_r)
                        if with_h0 or n != "dh0")
            check(f"grad rel err (worst: {worst[1]})", worst[0], GRAD_TOL)


def phase_memory(jax, jnp, cfg, params, batch):
    from plantcaduceus_tpu.models import caduceus

    spec = lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
    ids = jax.ShapeDtypeStruct((batch, WINDOW), jnp.int32)
    fwd = jax.jit(lambda p, i: caduceus.forward(p, i, cfg)["logits"])
    mem = fwd.lower(jax.tree.map(spec, params), ids).compile() \
        .memory_analysis()
    total = (mem.argument_size_in_bytes + mem.output_size_in_bytes
             + mem.temp_size_in_bytes)
    cap = (jax.devices()[0].memory_stats() or {}).get("bytes_limit", 0)
    say(f"l20 scoring step memory (batch {batch}): arguments "
        f"{mem.argument_size_in_bytes / 2**30:.3f} GiB, outputs "
        f"{mem.output_size_in_bytes / 2**30:.3f} GiB, temporaries "
        f"{mem.temp_size_in_bytes / 2**30:.3f} GiB; total "
        f"{total / 2**30:.3f} GiB of {cap / 2**30:.1f} GiB usable")
    if cap and total > cap:
        raise PhaseFailed("l20 scoring step does not fit the card")


# ---------------------------------------------------------------------------
# 3. scoring, 4. serving
# ---------------------------------------------------------------------------


def write_inputs(workdir: Path, n_snps: int, seed=SEED):
    """A FASTA of two chromosomes and a VCF of ``n_snps`` SNVs (some at the
    chromosome edges, a few multi-allelic), made from ``seed``."""
    rng = np.random.default_rng(seed)
    chroms = {"chr1": 40_000, "chr2": 25_000}
    seqs = {c: "".join(rng.choice(list("ACGT"), n)) for c, n in chroms.items()}
    fa = workdir / "genome.fa"
    with open(fa, "w") as f:
        for c, s in seqs.items():
            f.write(f">{c}\n")
            for i in range(0, len(s), 80):
                f.write(s[i:i + 80] + "\n")
    records = []
    for i in range(n_snps):
        c = "chr1" if i % 3 else "chr2"
        if i < 4:
            pos = [1, 7, chroms[c] - 3, chroms[c]][i]  # window edges
        else:
            pos = int(rng.integers(1, chroms[c] + 1))
        ref = seqs[c][pos - 1]
        alts = [b for b in "ACGT" if b != ref]
        alt = ",".join(rng.choice(alts, 2, replace=False)) if i % 17 == 0 \
            else str(rng.choice(alts))
        records.append((c, pos, ref, alt))
    records.sort(key=lambda r: (r[0], r[1]))
    vcf = workdir / "variants.vcf"
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        for c, n in chroms.items():
            f.write(f"##contig=<ID={c},length={n}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for k, (c, pos, ref, alt) in enumerate(records):
            f.write(f"{c}\t{pos}\tsnp{k}\t{ref}\t{alt}\t.\tPASS\t.\n")
    return fa, vcf, records


def read_scores(vcf_out: Path):
    """Per output record: the list of scores in INFO plantCAD_zero_shot."""
    scores = []
    with open(vcf_out) as f:
        for line in f:
            if line.startswith("#"):
                continue
            info = line.rstrip("\n").split("\t")[7]
            field = [kv for kv in info.split(";")
                     if kv.startswith("plantCAD_zero_shot=")]
            if not field:
                raise PhaseFailed(f"record without a score: {line[:80]}")
            scores.append([float(v)
                           for v in field[0].split("=")[1].split(",")])
    return scores


def phase_scoring(jax, jnp, workdir: Path, model: str, batch: int,
                  n_snps: int, n_ref: int):
    from plantcaduceus_tpu.cli import zero_shot_score
    from plantcaduceus_tpu.engine import zero_shot
    from plantcaduceus_tpu.engine.runner import InferenceRunner
    from plantcaduceus_tpu.utils.model_loading import load_model_and_tokenizer

    fa, vcf, records = write_inputs(workdir, n_snps)
    out = workdir / "scored.vcf"
    t0 = time.perf_counter()
    zero_shot_score.main(["-input-vcf", str(vcf), "-input-fasta", str(fa),
                          "-model", model, "-output", str(out),
                          "-batchSize", str(batch), "-no-progress"])
    say(f"cli.zero_shot_score: {n_snps} records in "
        f"{time.perf_counter() - t0:.1f} s (compilation included)")
    scores = read_scores(out)
    if len(scores) != len(records):
        raise PhaseFailed(f"{len(scores)} scored records, want {len(records)}")
    flat = np.asarray([s for row in scores for s in row])
    if not np.all(np.isfinite(flat)):
        raise PhaseFailed("non-finite scores")
    say(f"  records: {len(scores)} (all finite, "
        f"{len(flat)} alleles, mean {flat.mean():.4f})")

    # The plain fp32 model path on the first n_ref windows.
    windows, _ = zero_shot.windows_from_vcf(vcf, fa, WINDOW, TOKEN_IDX)
    windows = windows[:n_ref]
    refs = [r[2] for r in records[:n_ref]]
    alts = [r[3].split(",")[0] for r in records[:n_ref]]
    cli_scores = np.asarray([s[0] for s in scores[:n_ref]])
    params, cfg, tok = load_model_and_tokenizer(model)
    ref_cfg = dataclasses.replace(cfg, scan_impl="chunked")
    runner = InferenceRunner(params, ref_cfg, dtype=jnp.float32,
                             batch_size=n_ref)
    with jax.default_matmul_precision("highest"):
        probs = zero_shot.nucleotide_probs(runner, tok, windows, TOKEN_IDX,
                                           progress=False)
    want = zero_shot.log_ratio_scores(probs, refs, alts)
    corr = float(np.corrcoef(cli_scores, want)[0, 1])
    say(f"CLI (bf16, batch {batch}) vs plain fp32 model on {n_ref} windows:")
    check("score correlation", corr, SCORE_CORR, below=False)
    check("max |score diff|", float(np.max(np.abs(cli_scores - want))),
          SCORE_ATOL)
    return params, cfg, tok, windows, refs, alts, cli_scores


def phase_serving(jnp, params, cfg, tok, batch, windows, refs, alts,
                  cli_scores):
    from plantcaduceus_tpu.engine.client import ScoringClient
    from plantcaduceus_tpu.engine.runner import InferenceRunner
    from plantcaduceus_tpu.engine.server import ScoringServer, ScoringService

    runner = InferenceRunner(params, cfg, dtype=jnp.bfloat16,
                             batch_size=batch)
    server = ScoringServer(ScoringService(runner, tok), port=0,
                           model_name=L20)
    server.start_background()
    try:
        client = ScoringClient(f"http://127.0.0.1:{server.port}")
        if client.healthz().get("status") != "ok":
            raise PhaseFailed("server not healthy")
        n = 8
        got = np.asarray(client.score(windows[:n], refs[:n], alts[:n]))
        emb = np.asarray(client.embed(windows[:4]))
    finally:
        server.shutdown()
    say(f"server /score on {n} windows vs the CLI's scores:")
    check("max |score diff|", float(np.max(np.abs(got - cli_scores[:n]))),
          1e-4)
    if emb.shape != (4, cfg.d_model) or not np.all(np.isfinite(emb)):
        raise PhaseFailed(f"bad /embed result {emb.shape}")
    say(f"server /embed: shape {emb.shape}, finite")


# ---------------------------------------------------------------------------
# 5. training
# ---------------------------------------------------------------------------


class _StepLosses(logging.Handler):
    """Collects (step, loss) from train.loop's per-step log records."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        if record.msg.startswith("step %d/%d loss="):
            self.steps.append((int(record.args[0]), float(record.args[2])))


def run_training(workdir: Path, preset_args, batch, window, steps):
    """Two cli.pretrain runs into one output directory: ``steps`` steps
    with a save at the end, then a second run to ``2 * steps`` that must
    resume from the save."""
    from plantcaduceus_tpu.cli import pretrain
    from plantcaduceus_tpu.train.checkpoint import CheckpointManager

    out = workdir / "pretrain"
    common = ["--dataset", "synthetic", *preset_args,
              "--batch-size", str(batch), "--window", str(window),
              "--output-dir", str(out), "--save-steps", str(steps),
              "--log-steps", "1", "--eval-steps", "0", "--lr", "1e-3",
              "--warmup-steps", "0"]
    logger = logging.getLogger("plantcaduceus_tpu.train.loop")
    losses = []
    for max_steps in (steps, 2 * steps):
        handler = _StepLosses()
        logger.addHandler(handler)
        t0 = time.perf_counter()
        try:
            pretrain.main(common + ["--max-steps", str(max_steps)])
        finally:
            logger.removeHandler(handler)
        say(f"cli.pretrain to step {max_steps}: logged steps "
            f"{[s for s, _ in handler.steps]} in "
            f"{time.perf_counter() - t0:.1f} s (compilation included)")
        losses.append(handler.steps)
    first, second = losses
    if [s for s, _ in first] != list(range(1, steps + 1)):
        raise PhaseFailed(f"first run logged steps {first}")
    if [s for s, _ in second] != list(range(steps + 1, 2 * steps + 1)):
        raise PhaseFailed(f"resumed run did not continue the count: {second}")
    if CheckpointManager(out).latest_step() != 2 * steps:
        raise PhaseFailed("no checkpoint at the last step")
    curve = [v for _, v in first + second]
    say("  loss by step: " + " ".join(f"{v:.4f}" for v in curve))
    if not np.all(np.isfinite(curve)):
        raise PhaseFailed("non-finite loss")
    if not curve[-1] < curve[0]:
        raise PhaseFailed(f"loss did not fall: {curve[0]} -> {curve[-1]}")
    say(f"  loss fell {curve[0]:.4f} -> {curve[-1]:.4f}; resumed at step "
        f"{second[0][0]}")


# ---------------------------------------------------------------------------
# 6. timing
# ---------------------------------------------------------------------------


def phase_timing(jax, jnp, cfg, params, score_batch, n_windows, train_batch,
                 n_steps, impls=("triton", "chunked")):
    """Times implementation A = impls[0] against B = impls[1]."""
    import optax

    from plantcaduceus_tpu.engine.runner import InferenceRunner
    from plantcaduceus_tpu.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import step as step_lib
    from plantcaduceus_tpu.train.masking import MlmCollator

    rng = np.random.default_rng(SEED)
    ids = rng.integers(7, 11, size=(n_windows, WINDOW)).astype(np.int32)
    ids[:, TOKEN_IDX] = 3
    raw = rng.integers(7, 11, size=(train_batch, WINDOW)).astype(np.int32)
    b = MlmCollator(DnaTokenizer(), seed=SEED)(raw)
    b["loss_weights"] = np.ones_like(raw, np.float32)
    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=1),
                             devices=jax.devices()[:1])
    batch = meshlib.shard_batch({k: jnp.asarray(v) for k, v in b.items()},
                                mesh)

    runners, steps = {}, {}

    def score_rate(impl):
        if impl not in runners:
            runners[impl] = InferenceRunner(
                params, dataclasses.replace(cfg, scan_impl=impl), mesh=mesh,
                dtype=jnp.bfloat16, batch_size=score_batch)
            runners[impl].masked_probs(ids[:score_batch], [7, 8, 9, 10],
                                       TOKEN_IDX, progress=False)
        t0 = time.perf_counter()
        probs = runners[impl].masked_probs(ids, [7, 8, 9, 10], TOKEN_IDX,
                                           progress=False)  # host arrays
        dt = time.perf_counter() - t0
        if not np.all(np.isfinite(probs)):
            raise PhaseFailed(f"{impl}: non-finite probabilities")
        return n_windows / dt

    def step_time(impl):
        if impl not in steps:
            init, train_step, _ = step_lib.make_train_step(
                dataclasses.replace(cfg, scan_impl=impl),
                optax.adamw(1e-4), mesh, params, dtype=jnp.bfloat16,
                remat=True)
            state = init(params)
            for _ in range(2):  # the first step compiles
                state, m = train_step(state, batch)
            jax.block_until_ready(state)
            steps[impl] = [train_step, state]
        train_step, state = steps[impl]
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, m = train_step(state, batch)
        jax.block_until_ready(state)
        dt = (time.perf_counter() - t0) / n_steps
        steps[impl][1] = state
        if not np.isfinite(float(m["loss"])):
            raise PhaseFailed(f"{impl}: non-finite training loss")
        return dt

    order = [impls[0], impls[1], impls[1], impls[0]]
    kernel_timing(jax, jnp, cfg, score_batch, train_batch, order)
    rates = {k: [] for k in impls}
    for impl in order:
        rates[impl].append(score_rate(impl))
    say(f"l20 scoring windows/s at batch {score_batch} ({n_windows} windows, "
        "A B B A):")
    for impl, v in rates.items():
        say(f"  {impl}: " + " ".join(f"{x:.1f}" for x in v))
    runners.clear()
    times = {k: [] for k in impls}
    for impl in order:
        times[impl].append(step_time(impl))
    say(f"l20 training s/step at batch {train_batch} ({n_steps} steps, "
        "A B B A):")
    for impl, v in times.items():
        say(f"  {impl}: " + " ".join(f"{x:.4f}" for x in v))


def kernel_timing(jax, jnp, cfg, score_batch, train_batch, order, reps=5):
    """The scan alone at the l20 mixer's shapes: forward at the scoring
    batch, forward + backward at the training batch (both RC streams and
    both directions, bf16 activations), ms per call."""
    from plantcaduceus_tpu.ops.selective_scan import selective_scan

    def scan(impl):
        def f(x, dt, A, Bm, Cm, Ds, dtb, w):
            return selective_scan(x, dt, A, Bm, Cm, Ds, dt_bias=dtb,
                                  impl=impl, dt_proj_w=w,
                                  directions=(False, True))
        return f

    def loss(impl):
        f = scan(impl)
        return lambda *a: jnp.sum(f(*a).astype(jnp.float32))

    for label, rows, build in (
            ("forward", 2 * score_batch, lambda i: jax.jit(scan(i))),
            ("forward+backward", 2 * train_batch,
             lambda i: jax.jit(jax.grad(loss(i), argnums=tuple(range(8)))))):
        args = scan_inputs(jax, jnp, rows, WINDOW, cfg.d_inner)[:8]
        args = tuple(a.astype(jnp.bfloat16) if a.ndim == 4 else a
                     for a in args)
        fns, ms = {}, {k: [] for k in order}
        for impl in order:
            fn = fns.setdefault(impl, build(impl))
            jax.block_until_ready(fn(*args))
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
            ms[impl].append((time.perf_counter() - t0) / reps * 1e3)
        say(f"scan {label}, one l20 layer ({rows} rows x {WINDOW} x "
            f"{cfg.d_inner}, both directions), ms (A B B A):")
        for impl, v in ms.items():
            say(f"  {impl}: " + " ".join(f"{x:.3f}" for x in v))


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_dp_training(jax, jnp, cfg, params, batch, n_steps):
    import optax

    from plantcaduceus_tpu.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import step as step_lib
    from plantcaduceus_tpu.train.masking import MlmCollator

    rng = np.random.default_rng(SEED)
    collate = MlmCollator(DnaTokenizer(), seed=SEED)
    batches = []
    for _ in range(n_steps):
        raw = rng.integers(7, 11, size=(batch, WINDOW)).astype(np.int32)
        bb = collate(raw)
        bb["loss_weights"] = np.ones_like(raw, np.float32)
        batches.append(bb)
    curves = {}
    for n_dev in (4, 1):
        mesh = meshlib.make_mesh(meshlib.MeshConfig(data=n_dev),
                                 devices=jax.devices()[:n_dev])
        init, train_step, _ = step_lib.make_train_step(
            cfg, optax.adamw(1e-3), mesh, params, dtype=jnp.bfloat16,
            remat=True)
        state = init(params)
        curve = []
        for bb in batches:
            state, m = train_step(state, meshlib.shard_batch(
                {k: jnp.asarray(v) for k, v in bb.items()}, mesh))
            curve.append((float(m["loss"]), float(m["grad_norm"])))
        curves[n_dev] = np.asarray(curve)
        say(f"data-parallel training on {n_dev} card(s), global batch "
            f"{batch}: loss " + " ".join(f"{v:.5f}" for v in curve_col(curve, 0))
            + " | grad-norm " + " ".join(f"{v:.5f}"
                                         for v in curve_col(curve, 1)))
        del state
    say("4 cards vs 1 card (bf16 matmuls whose algorithms XLA picks per "
        "per-device shape):")
    check("loss rel diff", rel_err(curves[4][:, 0], curves[1][:, 0]), 1e-2)
    check("grad-norm rel diff", rel_err(curves[4][:, 1], curves[1][:, 1]),
          1e-2)


def curve_col(curve, i):
    return [c[i] for c in curve]


def phase_sharded_scoring(jax, jnp, cfg, params, batch, window, mesh_kw,
                          label, dtype, tol):
    from plantcaduceus_tpu.engine.runner import InferenceRunner
    from plantcaduceus_tpu.parallel import mesh as meshlib

    rng = np.random.default_rng(SEED)
    n = 2 * batch
    ids = rng.integers(7, 11, size=(n, window)).astype(np.int32)
    pos = window // 2 - 1
    ids[:, pos] = 3
    refs = rng.integers(0, 4, n)
    alts = (refs + 1 + rng.integers(0, 3, n)) % 4
    scores = {}
    for name, mesh in (
            ("4 cards", meshlib.make_mesh(meshlib.MeshConfig(**mesh_kw),
                                          devices=jax.devices()[:4])),
            ("1 card", meshlib.make_mesh(meshlib.MeshConfig(data=1),
                                         devices=jax.devices()[:1]))):
        runner = InferenceRunner(params, cfg, mesh=mesh, dtype=dtype,
                                 batch_size=batch)
        with jax.default_matmul_precision("highest"):
            probs = runner.masked_probs(ids, [7, 8, 9, 10], pos,
                                        progress=False)
        rows = np.arange(n)
        scores[name] = np.log(probs[rows, alts] / probs[rows, refs])
        del runner
    say(f"{label}: {n} windows of {window} bp, {jnp.dtype(dtype).name}, "
        "4 cards vs 1 card:")
    diff = float(np.max(np.abs(scores["4 cards"] - scores["1 card"])))
    check("max |score diff|", diff, tol)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def one_card(jax, jnp):
    from plantcaduceus_tpu.models.config import CaduceusConfig
    from plantcaduceus_tpu.ops.selective_scan import select_scan_impl
    from plantcaduceus_tpu.utils.model_loading import init_params_seeded

    say("== card")
    phase_card(jax)
    say("== kernels")
    phase_kernels(jax, jnp, {"l20": (2, 512, 768), "l32": (2, 512, 2048),
                             "pc2-large": (1, 8192, 3072)},
                  select_scan_impl(jax.default_backend()))
    cfg = CaduceusConfig.preset(L20)
    params = init_params_seeded(cfg, SEED)
    phase_memory(jax, jnp, cfg, params, 128)
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        work = Path(tmp)
        say("== scoring")
        params, cfg, tok, windows, refs, alts, cli_scores = phase_scoring(
            jax, jnp, work, L20, 128, n_snps=300, n_ref=64)
        say("== serving")
        phase_serving(jnp, params, cfg, tok, 128, windows, refs, alts,
                      cli_scores)
        say("== training")
        run_training(work, ["--preset", L20], batch=32, window=WINDOW,
                     steps=4)
    say("== timing")
    phase_timing(jax, jnp, cfg, params, score_batch=128, n_windows=1024,
                 train_batch=32, n_steps=5)


def four_cards(jax, jnp):
    from plantcaduceus_tpu.models.config import CaduceusConfig
    from plantcaduceus_tpu.utils.model_loading import init_params_seeded

    say("== card")
    phase_card(jax)
    cfg = CaduceusConfig.preset(L20)
    params = init_params_seeded(cfg, SEED)
    say("== data-parallel training")
    phase_dp_training(jax, jnp, cfg, params, batch=32, n_steps=3)
    say("== data-parallel scoring")
    # Batch rows are independent and each card runs the same program on
    # its rows: the scores must agree to the last bit.
    phase_sharded_scoring(jax, jnp, cfg, params, 128, WINDOW, {"data": 4},
                          "data-parallel l20 scoring", jnp.bfloat16, 1e-6)
    say("== context-parallel scoring")
    cfg2 = CaduceusConfig.preset("pc2-small")
    params2 = init_params_seeded(cfg2, SEED)
    # In bf16 the sharded and unsharded runs round differently (other
    # matmul shapes, the seeded second scan pass) and 24 layers amplify it
    # to ~1e-2 (seen on the H100); fp32 with TF32 off leaves summation
    # order only.
    phase_sharded_scoring(jax, jnp, cfg2, params2, 2, 8192, {"seq": 4},
                          "seq=4 pc2-small scoring", jnp.float32, 2e-3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card phases")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: {args.cards} cards asked for, {len(devices)} "
              "found", file=sys.stderr)
        return 2
    try:
        (four_cards if args.cards == 4 else one_card)(jax, jnp)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
