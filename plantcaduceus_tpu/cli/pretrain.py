"""CLI: masked-LM pre-training (the reference's src/HF_pre_train.py).

Usage (smoke run):
    python -m plantcaduceus_tpu.cli.pretrain --dataset synthetic \
        --preset l20 --max-steps 20 --batch-size 8 --output-dir /tmp/run

Reproduces the reference recipe surface: 15% dynamic masking, soft-masked
(lowercase) loss down-weighting (0.1 train / 0.0 eval), AdamW
constant-with-warmup lr 2e-4 / 1k warmup, checkpoints every N steps with
autoresume, eval + perplexity (README pre-train command; HF_pre_train.py
defaults). Multi-host: one flag-free mechanism — jax.distributed init +
record striding + mesh collectives.
"""

from __future__ import annotations

import argparse
import logging
import sys

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu.models import caduceus
from plantcaduceus_tpu.models.config import CaduceusConfig, PRESETS
from plantcaduceus_tpu.parallel import mesh as meshlib
from plantcaduceus_tpu.train import checkpoint as ckpt_lib
from plantcaduceus_tpu.train import data as data_lib
from plantcaduceus_tpu.train import loop as loop_lib
from plantcaduceus_tpu.train import step as step_lib
from plantcaduceus_tpu.train.optimizer import make_optimizer
from plantcaduceus_tpu.utils.platform import maybe_force_platform


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   help="synthetic | file.tsv/.parquet | genome.fa | "
                        "hf:<name> | shards:<dir-or-file> (streaming)")
    p.add_argument("--eval-dataset", default=None)
    p.add_argument("--eval-shards", type=int, default=0,
                   help="with a shards: dataset, hold out the last N shards "
                        "as the eval split (streaming-mode eval per "
                        "--eval-steps, like the reference Trainer's "
                        "eval_strategy)")
    p.add_argument("--seq-column", default="seq")
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--config", default=None, help="CaduceusConfig json path")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint dir (defaults to --output-dir autoresume)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-host microbatch (reference: 32/device)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer "
                        "step (reference pre-train recipe: 4 — README "
                        "per-device batch 32 x accum 4)")
    p.add_argument("--max-steps", type=int, default=120000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--schedule", default="constant_with_warmup")
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--mlm-probability", type=float, default=0.15)
    p.add_argument("--soft-masked-weight-train", type=float, default=0.1)
    p.add_argument("--soft-masked-weight-eval", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=32)
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--save-total-limit", type=int, default=20)
    p.add_argument("--eval-steps", type=int, default=1000)
    p.add_argument("--log-steps", type=int, default=50)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--fsdp", type=int, default=1, help="fsdp mesh axis size")
    p.add_argument("--seq", type=int, default=1,
                   help="sequence(context)-parallel mesh axis size")
    p.add_argument("--tensor", type=int, default=1, help="tensor mesh axis size")
    p.add_argument("--pipe", type=int, default=1,
                   help="pipeline-parallel mesh axis size (GPipe stages over "
                        "the layer stack; n_layer must divide by it)")
    p.add_argument("--pipe-microbatches", type=int, default=None,
                   help="GPipe microbatch count (default: --pipe; raise to "
                        "shrink the pipeline bubble, efficiency "
                        "M/(M+stages-1); must divide the folded batch rows)")
    p.add_argument("--profile-dir", default=None,
                   help="jax.profiler trace dir (traces steps 10-13)")
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--wandb-run-name", default=None)
    p.add_argument("--push-to-hub", default=None, metavar="REPO_ID",
                   help="after the final export, upload to this HF hub repo "
                        "(reference HF_pre_train.py:545-548; needs "
                        "huggingface_hub + network). A model card README.md "
                        "is always written either way.")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = parse_args(argv)
    maybe_force_platform()
    meshlib.initialize_distributed()

    if args.config:
        cfg = CaduceusConfig.load(args.config)
    elif args.preset:
        cfg = CaduceusConfig.preset(args.preset)
    else:
        sys.exit("one of --preset / --config is required")

    tokenizer = DnaTokenizer()
    params = caduceus.init_params(jax.random.PRNGKey(args.seed), cfg)
    mesh = meshlib.make_mesh(meshlib.MeshConfig(fsdp=args.fsdp,
                                                seq=args.seq,
                                                tensor=args.tensor,
                                                pipe=args.pipe))
    logging.info("mesh: %s", dict(mesh.shape))

    optimizer = make_optimizer(
        learning_rate=args.lr, schedule=args.schedule,
        warmup_steps=args.warmup_steps, total_steps=args.max_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        params=params)
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    remat = not args.no_remat
    init_state, train_step, eval_step = step_lib.make_train_step(
        cfg, optimizer, mesh, params, dtype=dtype, remat=remat,
        pp_microbatches=args.pipe_microbatches, grad_accum=args.grad_accum)
    state = init_state(params)
    # One optimizer step consumes batch_size * grad_accum rows.
    step_rows = args.batch_size * args.grad_accum

    ckpt = ckpt_lib.CheckpointManager(args.output_dir,
                                      save_interval_steps=args.save_steps,
                                      max_to_keep=args.save_total_limit)
    ckpt_lib.save_config(args.output_dir, cfg)
    resume_dir = args.resume_from or args.output_dir
    try:
        resume = ckpt_lib.CheckpointManager(resume_dir) \
            if resume_dir != args.output_dir else ckpt
        if resume.latest_step() is not None:
            state = resume.restore(state)
            logging.info("Resumed from step %d", int(state.step))
    except FileNotFoundError:
        pass

    dataset = args.dataset
    # Corpus-scale FASTA: route through the streaming path automatically —
    # the in-memory source would either blow RSS or hit its cap.
    if (dataset.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz"))
            and not dataset.startswith("shards:")):
        from pathlib import Path as _Path

        _p = _Path(dataset)
        # exists() first: a mistyped path must fall through to
        # sequence_source's dataset-spec error, not die here on stat().
        if _p.exists() and _p.stat().st_size > 256 * 2**20:
            logging.info("large FASTA (>256MB): streaming at O(chromosome) "
                         "memory (shards: path)")
            dataset = "shards:" + dataset
    eval_stream = None
    if dataset.startswith("shards:"):
        # Streaming path: shard directory (or one big file), memory-bounded,
        # multi-host deterministic (the MDS-streaming capability).
        from plantcaduceus_tpu.train.streaming import StreamingPretrainDataset

        train_data = StreamingPretrainDataset(
            dataset[len("shards:"):], tokenizer, step_rows,
            seq_column=args.seq_column, window=args.window,
            soft_masked_weight=args.soft_masked_weight_train,
            mlm_probability=args.mlm_probability, seed=args.seed,
            process_index=jax.process_index(),
            process_count=jax.process_count(),
            eval_shards=args.eval_shards, split="train")
        if args.eval_shards:
            eval_stream = StreamingPretrainDataset(
                dataset[len("shards:"):], tokenizer, args.batch_size,
                seq_column=args.seq_column, window=args.window,
                soft_masked_weight=args.soft_masked_weight_eval,
                mlm_probability=args.mlm_probability, seed=args.seed,
                eval_shards=args.eval_shards, split="eval")
        seqs = None
    else:
        seqs = data_lib.sequence_source(args.dataset, seq_column=args.seq_column,
                                        window=args.window, seed=args.seed)
        train_data = data_lib.PretrainDataset(
            seqs, tokenizer, step_rows,
            soft_masked_weight=args.soft_masked_weight_train,
            mlm_probability=args.mlm_probability, seed=args.seed,
            process_index=jax.process_index(), process_count=jax.process_count())
    if args.eval_dataset:
        eval_seqs = data_lib.sequence_source(
            args.eval_dataset, split="validation", seq_column=args.seq_column,
            window=args.window, seed=args.seed + 1)
    elif seqs is not None:
        eval_seqs = seqs[: max(args.batch_size, len(seqs) // 20)]
    else:
        eval_seqs = None  # streaming: eval via --eval-shards holdout
    eval_data = eval_stream
    if eval_seqs is not None:
        eval_data = data_lib.PretrainDataset(
            eval_seqs, tokenizer, args.batch_size,
            soft_masked_weight=args.soft_masked_weight_eval,
            mlm_probability=args.mlm_probability, seed=args.seed + 2,
            process_index=jax.process_index(), process_count=jax.process_count())

    wandb_run = None
    if args.wandb_project:
        try:
            import wandb

            wandb_run = wandb.init(project=args.wandb_project,
                                   name=args.wandb_run_name, resume="allow")
        except Exception as e:  # offline env: log and continue
            logging.warning("wandb unavailable: %s", e)

    tokens_per_step = step_rows * args.window * jax.process_count()
    # Resume data determinism: restart the stream at the restored step so
    # the resumed run sees exactly the batches an uninterrupted run would
    # (batches are a pure function of (seed, step) — train/data.py).
    train_iter = train_data.iter_from(int(state.step))
    state = loop_lib.run_training(
        state, train_step, eval_step, train_iter,
        eval_data.eval_batches if eval_data is not None else None,
        args.max_steps,
        log_every=args.log_steps, eval_every=args.eval_steps,
        ckpt=ckpt, wandb_run=wandb_run, tokens_per_step=tokens_per_step,
        profile_dir=args.profile_dir, mesh=mesh)

    # Final standalone export for the inference CLIs, with the model card
    # the reference emits via trainer.create_model_card / push_to_hub
    # (src/HF_pre_train.py:535-548).
    params_host = jax.device_get(state.params)
    # Final eval is a jitted mesh computation with cross-host collectives:
    # it must run on ALL processes (only logging/export below is gated on
    # process 0), or process 0 would hang waiting for peers.
    final_metrics = None
    if eval_data is not None and args.eval_steps:
        from plantcaduceus_tpu.parallel.mesh import shard_batch

        final_metrics = loop_lib.evaluate(
            state, eval_step, eval_data.eval_batches(), max_batches=20,
            place=lambda b: shard_batch(b, mesh))
        logging.info("final eval: %s", final_metrics)
    if jax.process_index() == 0:
        from plantcaduceus_tpu.compat import model_card as card_lib

        final_dir = f"{args.output_dir}/final"
        ckpt_lib.export_params(final_dir, params_host, cfg)
        import numpy as _np

        n_params = sum(int(_np.prod(_np.shape(x)))
                       for x in jax.tree.leaves(params_host))
        card_lib.write_model_card(
            final_dir, cfg, tasks="fill-mask", dataset=args.dataset,
            metrics=card_lib._final_metrics_from_log(final_metrics),
            n_params=n_params)
        logging.info("Exported final params + model card to %s", final_dir)
        if args.push_to_hub:
            card_lib.push_to_hub(final_dir, args.push_to_hub)


if __name__ == "__main__":
    main()
