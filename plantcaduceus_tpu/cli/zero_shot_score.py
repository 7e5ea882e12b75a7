"""CLI: zero-shot SNP scoring (the reference's src/zero_shot_score.py).

Usage:
    python -m plantcaduceus_tpu.cli.zero_shot_score \
        -input-table examples/example_snp.tsv -model <ckpt-or-preset> \
        -output scores.tsv [-outBED] [-batchSize 128] [-tokenIdx 255]

    python -m plantcaduceus_tpu.cli.zero_shot_score \
        -input-vcf in.vcf -input-fasta genome.fa -model <ckpt> -output out.vcf

``-model`` accepts either an HF checkpoint directory (weights imported via
compat.hf_import) or a preset name like ``l20`` / ``l20:random`` for a
randomly initialised model of that size (benchmarks, smoke tests).
"""

from __future__ import annotations

import argparse
import logging
import sys

import jax
import jax.numpy as jnp

from plantcaduceus_tpu.engine.runner import InferenceRunner
from plantcaduceus_tpu.engine import zero_shot
from plantcaduceus_tpu.parallel import mesh as meshlib
from plantcaduceus_tpu.utils.model_loading import load_model_and_tokenizer
from plantcaduceus_tpu.utils.platform import maybe_force_platform


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    grp = p.add_mutually_exclusive_group(required=True)
    grp.add_argument("-input-table", dest="input_table", default=None,
                     help="TSV with columns ref, alt, sequences")
    grp.add_argument("-input-vcf", dest="input_vcf", default=None)
    p.add_argument("-input-fasta", dest="input_fasta", default=None,
                   help="FASTA (required with -input-vcf)")
    p.add_argument("-output", dest="output", required=True)
    p.add_argument("-outBED", action="store_true", dest="out_bed")
    p.add_argument("-model", dest="model", required=True,
                   help="HF checkpoint dir or preset (l20/l24/l28/l32)")
    p.add_argument("-batchSize", dest="batch_size", type=int, default=128)
    p.add_argument("-tokenIdx", dest="token_idx", type=int, default=255)
    p.add_argument("-window", dest="window", type=int, default=512)
    p.add_argument("-seq", dest="seq", type=int, default=1,
                   help="context-parallel mesh shards over the window "
                        "length (long-window latency)")
    p.add_argument("-dtype", dest="dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("-no-progress", action="store_true", dest="no_progress")
    args = p.parse_args(argv)
    if args.input_vcf and not args.input_fasta:
        p.error("-input-fasta is required with -input-vcf")
    return args


def main(argv=None):
    logging.basicConfig(
        force=True,
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    args = parse_args(argv)
    maybe_force_platform()
    meshlib.initialize_distributed()

    params, cfg, tokenizer = load_model_and_tokenizer(args.model)
    mesh = meshlib.make_mesh(meshlib.MeshConfig(seq=args.seq)) \
        if args.seq > 1 else None
    runner = InferenceRunner(
        params, cfg, mesh=mesh,
        dtype=jnp.float32 if args.dtype == "float32" else jnp.bfloat16,
        batch_size=args.batch_size,
    )
    progress = not args.no_progress

    if args.input_table:
        import pandas as pd

        logging.info("Reading input data from %s", args.input_table)
        df = pd.read_csv(args.input_table, delimiter="\t")
        df = zero_shot.score_table(runner, tokenizer, df,
                                   token_idx=args.token_idx, progress=progress)
        if jax.process_index() == 0:
            zero_shot.write_table(df, args.output, as_bed=args.out_bed)
    else:
        n = zero_shot.score_vcf(runner, tokenizer, args.input_vcf,
                                args.input_fasta, args.output,
                                token_idx=args.token_idx, window=args.window,
                                progress=progress)
        logging.info("Scored %d records", n)
    logging.info("Zero-shot scores saved to %s", args.output)


if __name__ == "__main__":
    sys.exit(main())
