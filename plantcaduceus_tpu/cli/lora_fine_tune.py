"""CLI: LoRA fine-tuning (the reference's src/lora_fine_tune.py).

Subcommands (argparse equivalents of the reference's fire dispatch):

  tokenize  — TSV/HF-parquet -> fixed-length token-id parquet (zstd)
  train     — LoRA adapters (r=8, alpha=32, dropout .1, mamba projections)
              + task head; classification | regression | multi_label
  evaluate  — metrics on a tokenized parquet
  predict   — probabilities/values CSV
  display   — print adapter/base parameter inventory + trainability

Examples:
  python -m plantcaduceus_tpu.cli.lora_fine_tune tokenize \
      --data-dir data.tsv --model-name l20 --sequence-length 512
  python -m plantcaduceus_tpu.cli.lora_fine_tune train \
      --train-dir train.parquet --valid-dir valid.parquet \
      --model-name <ckpt|preset> --output-dir /tmp/ft --max-steps 500
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# tokenize
# ---------------------------------------------------------------------------


def cmd_tokenize(args):
    import pandas as pd

    from plantcaduceus_tpu.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu.utils.model_loading import load_tokenizer_only

    tok = load_tokenizer_only(args.model_name) if args.model_name else DnaTokenizer()

    if args.data_dir:
        df = pd.read_csv(args.data_dir, sep="\t")
    elif args.hf_dataset:
        import datasets

        ds = datasets.load_dataset(args.hf_dataset, args.hf_config,
                                   split=args.hf_split)
        df = ds.to_pandas()
    else:
        sys.exit("provide --data-dir or --hf-dataset")
    df.columns = [c.lower() for c in df.columns]
    seq_col = args.seq_column.lower()
    label_col = args.label_column.lower()

    L = args.sequence_length
    seqs = df[seq_col].astype(str)
    bad = seqs.str.len() != L
    if bad.any():
        # reference behavior: pad/truncate to max_length then error if unequal
        raise ValueError(
            f"All sequences must be of length {L}; found lengths "
            f"{sorted(seqs.str.len().unique())[:5]}")
    ids = tok.encode_batch(seqs.tolist())
    out = pd.DataFrame({"input_ids": list(ids)})
    if label_col in df.columns:
        if args.task_type == "multi_label":
            out["labels"] = [
                [int(c) for c in str(v)] if not isinstance(v, (list, np.ndarray))
                else [int(x) for x in v]
                for v in df[label_col]
            ]
        else:
            out["label"] = df[label_col]
    output = args.output_path or str(Path(args.data_dir).with_suffix(".parquet"))
    out.to_parquet(output, compression="zstd")
    log.info("Wrote %d tokenized rows to %s", len(out), output)


# ---------------------------------------------------------------------------
# shared model/data loading for train/evaluate/predict
# ---------------------------------------------------------------------------


def _load_parquet(path):
    import pandas as pd

    df = pd.read_parquet(path)
    ids = np.stack(df["input_ids"].to_numpy()).astype(np.int32)
    labels = None
    if "labels" in df.columns:
        labels = np.stack(df["labels"].to_numpy()).astype(np.float32)
    elif "label" in df.columns:
        labels = df["label"].to_numpy()
    return ids, labels


def _batch_at(ids, labels, batch_size, step, seed=0, shuffle=True):
    """Training batch for a global step as a PURE function of (seed, step):
    global row g = step*batch_size + j indexes the concatenation of
    per-epoch permutations, so (a) no tail rows are ever dropped at epoch
    boundaries (the reference's HF Trainer keeps them via drop_last=False) —
    the tail simply shares a batch with the next epoch's head — and (b)
    resume from a checkpoint replays the exact uninterrupted stream."""
    n = ids.shape[0]

    def order(epoch):
        if not shuffle:
            return np.arange(n)
        return np.random.default_rng([seed, epoch]).permutation(n)

    g0 = step * batch_size
    e0, e1 = g0 // n, (g0 + batch_size - 1) // n
    orders = {e: order(e) for e in range(e0, e1 + 1)}
    idx = np.array([orders[g // n][g % n] for g in range(g0, g0 + batch_size)])
    batch = {"input_ids": ids[idx]}
    if labels is not None:
        batch["labels"] = labels[idx]
    return batch


def _build(args, task_type, num_labels):
    import jax
    import jax.numpy as jnp

    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import lora as lora_lib
    from plantcaduceus_tpu.train.optimizer import make_optimizer
    from plantcaduceus_tpu.utils.model_loading import load_model_and_tokenizer

    params, cfg, tok = load_model_and_tokenizer(args.model_name)
    mesh = meshlib.make_mesh()
    # Checkpoint restores commit arrays to one device; replicate over the
    # mesh or shard_map rejects them on multi-device meshes.
    params = meshlib.shard_params(params, mesh, replicated=True)
    cfg_l = lora_lib.LoraConfig(r=args.lora_r, alpha=args.lora_alpha,
                                dropout=args.lora_dropout)
    if num_labels is None:
        num_labels = {"classification": 2, "regression": 1}.get(task_type)
    optimizer = make_optimizer(
        learning_rate=args.learning_rate, schedule="linear",
        warmup_steps=args.warmup_steps, total_steps=args.max_steps,
        weight_decay=args.weight_decay, grad_clip=1.0)
    dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    grad_accum = getattr(args, "grad_accum", 1)
    if getattr(args, "full_finetune", False):
        train_step, infer_fn = lora_lib.make_full_finetune_step(
            cfg, optimizer, mesh, task_type=task_type, dtype=dtype,
            grad_accum=grad_accum)
    else:
        train_step, infer_fn = lora_lib.make_lora_train_step(
            cfg, cfg_l, optimizer, mesh, params, task_type=task_type,
            dtype=dtype, grad_accum=grad_accum)
    return params, cfg, tok, mesh, cfg_l, optimizer, train_step, infer_fn, num_labels


def _predict_all(infer_fn, state, params, ids, batch_size, n_pad_to=None):
    out = []
    n = ids.shape[0]
    for i in range(0, n, batch_size):
        chunk = ids[i : i + batch_size]
        k = chunk.shape[0]
        if k < batch_size:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - k, axis=0)])
        logits = np.asarray(infer_fn(state, params, {"input_ids": chunk}))
        out.append(logits[:k])
    return np.concatenate(out, axis=0)


def cmd_train(args):
    import jax

    from plantcaduceus_tpu.downstream import metrics as M
    from plantcaduceus_tpu.train import lora as lora_lib

    task_type = args.task_type
    ids_tr, y_tr = _load_parquet(args.train_dir)
    ids_ev, y_ev = _load_parquet(args.valid_dir)
    if args.eval_num_samples:
        ids_ev, y_ev = ids_ev[: args.eval_num_samples], y_ev[: args.eval_num_samples]

    num_labels = args.num_labels
    if task_type == "multi_label":
        if num_labels is None:
            num_labels = y_tr.shape[1]
    (params, cfg, tok, mesh, cfg_l, optimizer, train_step, infer_fn,
     num_labels) = _build(args, task_type, num_labels)

    if args.resume_from:
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec

        state, cfg_l_saved, task_saved, _ = lora_lib.load_train_state(
            args.resume_from, optimizer)
        if task_saved != task_type:
            sys.exit(f"checkpoint task_type {task_saved!r} != requested "
                     f"{task_type!r}")
        # A mode/config mismatch would otherwise surface much later as an
        # opaque pytree-template error — fail with a clear message.
        import json as _json

        meta = _json.loads(
            (Path(args.resume_from) / "adapter_config.json").read_text())
        saved_full = meta.get("full_finetune", False)
        if saved_full != bool(args.full_finetune):
            sys.exit(f"checkpoint was saved with full_finetune={saved_full} "
                     f"but --full-finetune={bool(args.full_finetune)} was "
                     "requested — pass the matching mode to resume")
        if not saved_full and (cfg_l_saved.r, cfg_l_saved.alpha,
                               cfg_l_saved.dropout,
                               tuple(cfg_l_saved.targets)) != (
                                   cfg_l.r, cfg_l.alpha, cfg_l.dropout,
                                   tuple(cfg_l.targets)):
            sys.exit(
                "checkpoint LoRA config "
                f"(r={cfg_l_saved.r}, alpha={cfg_l_saved.alpha}, "
                f"dropout={cfg_l_saved.dropout}, "
                f"targets={list(cfg_l_saved.targets)}) does not match the "
                f"CLI configuration (r={cfg_l.r}, alpha={cfg_l.alpha}, "
                f"dropout={cfg_l.dropout}, targets={list(cfg_l.targets)}) "
                "— resume with the original hyperparameters")
        # Restored leaves are committed to one device; replicate onto the
        # mesh to match the (replicated) base params the jitted step sees.
        rep = NamedSharding(mesh, PartitionSpec())
        state = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), rep),
                             state)
        log.info("Resumed training from %s at step %d", args.resume_from,
                 int(state.step))
    elif args.full_finetune:
        from plantcaduceus_tpu.models import heads as heads_lib
        import jax.numpy as jnp

        head = heads_lib.init_head(jax.random.PRNGKey(args.seed + 9), cfg,
                                   num_labels)
        state = lora_lib.LoraTrainState(
            params, head, optimizer.init((params, head)),
            jnp.zeros((), jnp.int32))
    else:
        state = lora_lib.init_lora_state(
            jax.random.PRNGKey(args.seed), params, cfg, cfg_l, num_labels,
            optimizer)

    # One optimizer step consumes train_batch_size * grad_accum rows.
    step_rows = args.train_batch_size * args.grad_accum
    rng = jax.random.PRNGKey(args.seed + 1)
    start_step = int(state.step)
    for step in range(start_step, args.max_steps):
        batch = _batch_at(ids_tr, y_tr, step_rows, step, seed=args.seed)
        # Dropout rng keyed by step (not a sequential split): resume draws
        # the exact masks an uninterrupted run would.
        sub = jax.random.fold_in(rng, step)
        state, metrics = train_step(state, params, batch, sub)
        # per-step sync bounds host run-ahead on the donated state
        loss = float(metrics["loss"])
        if (step + 1) % args.logging_steps == 0:
            log.info("step %d/%d loss=%.4f", step + 1, args.max_steps, loss)
        if (step + 1) % args.eval_steps == 0 or step + 1 == args.max_steps:
            logits = _predict_all(infer_fn, state, params, ids_ev,
                                  args.eval_batch_size)
            m = _task_metrics(task_type, logits, y_ev, M)
            log.info("eval @ %d: %s", step + 1,
                     {k: round(v, 4) for k, v in m.items()})
        if (step + 1) % args.save_steps == 0 or step + 1 == args.max_steps:
            _save_state(args, Path(args.output_dir) / f"checkpoint-{step+1}",
                        state, cfg_l, task_type, resumable=True)
    _save_state(args, Path(args.output_dir) / "final", state, cfg_l, task_type)
    log.info("Saved adapter to %s/final", args.output_dir)


def _save_state(args, path, state, cfg_l, task_type, resumable=False):
    from plantcaduceus_tpu.train import lora as lora_lib

    if args.full_finetune:
        cfg_l = lora_lib.LoraConfig(r=0, alpha=0.0, dropout=0.0, targets=())
    if resumable:  # checkpoint-N: adapter + optimizer/step for --resume-from
        lora_lib.save_train_state(path, state, cfg_l, task_type,
                                  args.model_name)
    else:          # final export: adapter only (evaluate/predict format)
        lora_lib.save_adapter(path, state, cfg_l, task_type, args.model_name)
    if args.full_finetune:
        import json
        from pathlib import Path

        meta_path = Path(path) / "adapter_config.json"
        meta = json.loads(meta_path.read_text())
        meta["full_finetune"] = True
        meta_path.write_text(json.dumps(meta, indent=2))


def _task_metrics(task_type, logits, labels, M):
    if task_type == "classification":
        return M.classification_metrics(logits, labels.astype(int))
    if task_type == "regression":
        return M.regression_metrics(logits[:, 0], labels)
    return M.multilabel_metrics(logits, labels)


def _load_for_eval(args):
    import jax

    from plantcaduceus_tpu.compat import peft_adapter
    from plantcaduceus_tpu.train import lora as lora_lib

    if peft_adapter.is_peft_adapter_dir(args.checkpoint_dir):
        # Released PEFT-format adapter dirs (the reference resolves these
        # via PeftConfig.base_model_name_or_path, lora_fine_tune.py:502-515)
        # map onto the framework adapter tree through the strict importer.
        from plantcaduceus_tpu.utils.model_loading import (
            load_model_and_tokenizer)

        if not args.model_name:
            raise SystemExit("--model-name is required with a PEFT adapter "
                             "dir (its base_model_name_or_path is a hub id, "
                             "not a local path)")
        _, cfg_probe, _ = load_model_and_tokenizer(args.model_name)
        adapters, head, cfg_l, task_type, base = \
            peft_adapter.import_peft_adapter(args.checkpoint_dir, cfg_probe)
        if head is None:
            raise SystemExit("PEFT adapter carries no classification head "
                             "(modules_to_save) — cannot evaluate/predict")
        import jax.numpy as _jnp

        adapters = jax.tree.map(_jnp.asarray, adapters)
        head = jax.tree.map(_jnp.asarray, head)
        ns = argparse.Namespace(**vars(args))
        ns.full_finetune = False
        ns.lora_r, ns.lora_alpha, ns.lora_dropout = (cfg_l.r, cfg_l.alpha,
                                                     cfg_l.dropout)
        num_labels = head["b"].shape[0]
        (params, cfg, tok, mesh, cfg_l2, optimizer, train_step, infer_fn,
         _) = _build(ns, task_type, num_labels)
        state = lora_lib.LoraTrainState(adapters, head, optimizer.init(
            (adapters, head)), 0)
        return state, params, infer_fn, task_type

    adapters, head, cfg_l, task_type, base = lora_lib.load_adapter(
        args.checkpoint_dir)
    import json as _json
    from pathlib import Path as _Path

    meta = _json.loads(
        (_Path(args.checkpoint_dir) / "adapter_config.json").read_text())
    model_name = args.model_name or base
    ns = argparse.Namespace(**vars(args))
    ns.model_name = model_name
    ns.full_finetune = meta.get("full_finetune", False)
    if not ns.full_finetune:
        ns.lora_r, ns.lora_alpha, ns.lora_dropout = (cfg_l.r, cfg_l.alpha,
                                                     cfg_l.dropout)
    num_labels = head["b"].shape[0]
    (params, cfg, tok, mesh, cfg_l2, optimizer, train_step, infer_fn,
     _) = _build(ns, task_type, num_labels)
    state = lora_lib.LoraTrainState(adapters, head, optimizer.init(
        (adapters, head)), 0)
    return state, params, infer_fn, task_type


def cmd_evaluate(args):
    from plantcaduceus_tpu.downstream import metrics as M

    state, params, infer_fn, task_type = _load_for_eval(args)
    ids, labels = _load_parquet(args.data_dir)
    logits = _predict_all(infer_fn, state, params, ids, args.batch_size)
    m = _task_metrics(task_type, logits, labels, M)
    log.info("Results: %s", m)
    print("\n".join(f"{k}\t{v:.6f}" for k, v in m.items()))
    if getattr(args, "metrics_json", None):
        import json as _json
        from pathlib import Path as _Path

        _Path(args.metrics_json).write_text(
            _json.dumps({k: float(v) for k, v in m.items()}, indent=1))


def cmd_predict(args):
    import pandas as pd

    from plantcaduceus_tpu.downstream.metrics import sigmoid, softmax

    state, params, infer_fn, task_type = _load_for_eval(args)
    ids, _ = _load_parquet(args.data_dir)
    logits = _predict_all(infer_fn, state, params, ids, args.batch_size)
    if task_type == "classification":
        df = pd.DataFrame({"probability_positive": softmax(logits, 1)[:, 1]})
    elif task_type == "regression":
        df = pd.DataFrame({"predicted_value": logits[:, 0]})
    else:
        probs = sigmoid(logits)
        df = pd.DataFrame(probs, columns=[f"class_{i}"
                                          for i in range(probs.shape[1])])
    df.to_csv(args.output_file, index=False)
    log.info("Predictions saved to %s", args.output_file)


def cmd_display(args):
    import jax

    from plantcaduceus_tpu.train import lora as lora_lib
    from plantcaduceus_tpu.utils.model_loading import load_model_and_tokenizer

    params, cfg, _ = load_model_and_tokenizer(args.model_name)
    cfg_l = lora_lib.LoraConfig(r=args.lora_r, alpha=args.lora_alpha,
                                dropout=args.lora_dropout)
    adapters = lora_lib.init_lora(jax.random.PRNGKey(0), params, cfg_l)
    rows = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        rows.append((jax.tree_util.keystr(path), False, leaf.shape, leaf.size))
    for path, leaf in jax.tree_util.tree_leaves_with_path(adapters):
        rows.append(("lora" + jax.tree_util.keystr(path), True, leaf.shape,
                     leaf.size))
    total = sum(r[3] for r in rows)
    trainable = sum(r[3] for r in rows if r[1])
    w = max(len(r[0]) for r in rows) + 2
    print(f"{'Name':<{w}} {'Trainable':<10} {'Shape':<24} Size")
    for name, tr, shape, size in rows:
        print(f"{name:<{w}} {str(tr):<10} {str(shape):<24} {size}")
    print(f"\ntrainable params: {trainable} | all params: {total} "
          f"| trainable%: {100*trainable/total:.4f}")


# ---------------------------------------------------------------------------


def main(argv=None):
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    tkn = sub.add_parser("tokenize")
    tkn.add_argument("--data-dir", default=None)
    tkn.add_argument("--output-path", default=None)
    tkn.add_argument("--model-name", default=None)
    tkn.add_argument("--sequence-length", type=int, default=8192)
    tkn.add_argument("--task-type", default="classification")
    tkn.add_argument("--hf-dataset", default=None)
    tkn.add_argument("--hf-config", default=None)
    tkn.add_argument("--hf-split", default="train")
    tkn.add_argument("--seq-column", default="sequence")
    tkn.add_argument("--label-column", default="label")
    tkn.set_defaults(fn=cmd_tokenize)

    def common(sp, train=False):
        sp.add_argument("--model-name", default=None)
        sp.add_argument("--task-type", default="classification",
                        choices=["classification", "regression", "multi_label"])
        sp.add_argument("--num-labels", type=int, default=None)
        sp.add_argument("--full-finetune", action="store_true",
                        help="train all backbone params (FULL strategy) "
                             "instead of LoRA adapters")
        sp.add_argument("--lora-r", type=int, default=8)
        sp.add_argument("--lora-alpha", type=float, default=32)
        sp.add_argument("--lora-dropout", type=float, default=0.1)
        sp.add_argument("--learning-rate", type=float, default=1e-3)
        sp.add_argument("--warmup-steps", type=int, default=50)
        sp.add_argument("--max-steps", type=int, default=500)
        sp.add_argument("--weight-decay", type=float, default=0.01)
        sp.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True)
        sp.add_argument("--seed", type=int, default=42)

    tr = sub.add_parser("train")
    common(tr)
    tr.add_argument("--train-dir", required=True)
    tr.add_argument("--valid-dir", required=True)
    tr.add_argument("--output-dir", default="/tmp/pcv2-ft")
    tr.add_argument("--train-batch-size", type=int, default=8)
    tr.add_argument("--grad-accum", type=int, default=64,
                    help="gradient-accumulation microbatches per optimizer "
                         "step (reference gradient_accumulation_steps "
                         "default: 64 — src/lora_fine_tune.py:311-333)")
    tr.add_argument("--resume-from", default=None,
                    help="checkpoint-N dir from a previous run: restores "
                         "adapters + head + optimizer state + step and "
                         "replays the exact data/dropout stream "
                         "(reference resume_from_checkpoint)")
    tr.add_argument("--eval-batch-size", type=int, default=8)
    tr.add_argument("--eval-num-samples", type=int, default=0)
    tr.add_argument("--eval-steps", type=int, default=25)
    tr.add_argument("--save-steps", type=int, default=100)
    tr.add_argument("--logging-steps", type=int, default=10)
    tr.set_defaults(fn=cmd_train)

    ev = sub.add_parser("evaluate")
    common(ev)
    ev.add_argument("--checkpoint-dir", required=True)
    ev.add_argument("--data-dir", required=True)
    ev.add_argument("--batch-size", type=int, default=8)
    ev.add_argument("--metrics-json", default=None,
                    help="also write the metrics dict to this JSON path")
    ev.set_defaults(fn=cmd_evaluate)

    pr = sub.add_parser("predict")
    common(pr)
    pr.add_argument("--checkpoint-dir", required=True)
    pr.add_argument("--data-dir", required=True)
    pr.add_argument("--batch-size", type=int, default=8)
    pr.add_argument("--output-file", default="/tmp/predictions.csv")
    pr.set_defaults(fn=cmd_predict)

    dp = sub.add_parser("display")
    common(dp)
    dp.set_defaults(fn=cmd_display)

    args = p.parse_args(argv)

    from plantcaduceus_tpu.utils.platform import maybe_force_platform

    maybe_force_platform()
    args.fn(args)


if __name__ == "__main__":
    main()
