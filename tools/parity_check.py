"""Parity harness: checkpoint-to-scores in one command, and TSV comparison.

Usage (compare two scoring TSVs):
    python tools/parity_check.py ours.tsv theirs.tsv [--col zeroShotScore]
                                 [--rtol 1e-3] [--atol 1e-4]

Usage (real-checkpoint gate — strict import + score, then optional compare):
    python tools/parity_check.py --import <hf_ckpt_dir> \
        [--table examples.tsv] [--out ours.tsv] [--batch 128] [theirs.tsv]

Usage (dry audit — full key/shape forensics, never builds the model):
    python tools/parity_check.py --audit <hf_ckpt_dir>

``--import`` runs compat.hf_import.import_params(strict=True) — the
checkpoint either maps exactly (every tensor consumed, every shape right) or
the command fails naming the offending keys — then scores ``--table``
(default: the reference example_snp.tsv fixture) through the standard
engine. Passing a reference TSV afterwards compares the two. Rows are
matched on (chr, pos, ref, alt) when present, else by order. Prints max/mean
absolute difference, correlation, and pass/fail; exit code 1 on failure.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_FIXTURE = "/root/reference/examples/example_snp.tsv"


def run_import_and_score(ckpt: str, table: str, out: str, batch: int) -> str:
    """Strict-import ``ckpt`` and score ``table`` into ``out``. Returns out."""
    from plantcaduceus_tpu.utils.platform import maybe_force_platform

    maybe_force_platform()  # BEFORE any array op (PCAD_PLATFORM=cpu support)
    from plantcaduceus_tpu.cli import zero_shot_score

    # Ensure a broken checkpoint fails HERE, with the strict importer's
    # key-level message, before any scoring machinery spins up. Host arrays
    # only — the accelerator is not needed for the audit.
    import jax

    from plantcaduceus_tpu.compat.hf_import import import_params

    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        import_params(ckpt, strict=True)
    zero_shot_score.main(["-input-table", table, "-model", ckpt,
                          "-output", out, "-batchSize", str(batch)])
    return out


def main():
    import pandas as pd

    ap = argparse.ArgumentParser()
    ap.add_argument("ours", nargs="?",
                    help="scoring TSV (omit with --import)")
    ap.add_argument("theirs", nargs="?",
                    help="reference scoring TSV (optional with --import)")
    ap.add_argument("--import", dest="import_dir", default=None,
                    help="HF checkpoint dir: strict-import, score --table, "
                         "write --out, then compare if a reference TSV given")
    ap.add_argument("--audit", dest="audit_dir", default=None,
                    help="HF checkpoint dir: print the full consumed/"
                         "unconsumed key map and mapped-vs-expected shape "
                         "table without building the model; exit 1 if the "
                         "mapping is not a clean bijection")
    ap.add_argument("--table", default=REF_FIXTURE)
    ap.add_argument("--out", default="parity_scores.tsv")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--col", default="zeroShotScore")
    ap.add_argument("--rtol", type=float, default=1e-3)
    ap.add_argument("--atol", type=float, default=1e-4)
    args = ap.parse_args()

    if args.audit_dir:
        import json as _json

        from plantcaduceus_tpu.utils.platform import maybe_force_platform

        maybe_force_platform()
        from plantcaduceus_tpu.compat.hf_import import audit

        report = audit(args.audit_dir)
        print(_json.dumps(report, indent=1, default=str))
        sys.exit(0 if report.get("ok") else 1)

    if args.import_dir:
        if args.ours and not args.theirs:  # sole positional = reference TSV
            args.ours, args.theirs = None, args.ours
        path = run_import_and_score(args.import_dir, args.table, args.out,
                                    args.batch)
        print(f"strict import OK; scores written to {path}")
        if not args.theirs:
            return
        args.ours = path
    elif not (args.ours and args.theirs):
        ap.error("either two TSVs or --import <ckpt_dir> is required")

    a = pd.read_csv(args.ours, sep="\t")
    b = pd.read_csv(args.theirs, sep="\t")
    keys = [k for k in ("chr", "pos", "ref", "alt") if
            k in a.columns and k in b.columns]
    if keys:
        m = a.merge(b, on=keys, suffixes=("_ours", "_ref"))
        xa = m[args.col + "_ours"].to_numpy(float)
        xb = m[args.col + "_ref"].to_numpy(float)
        print(f"matched {len(m)} rows on {keys}")
    else:
        n = min(len(a), len(b))
        xa = a[args.col].to_numpy(float)[:n]
        xb = b[args.col].to_numpy(float)[:n]
        print(f"matched {n} rows by order")

    diff = np.abs(xa - xb)
    tol = args.atol + args.rtol * np.abs(xb)
    bad = diff > tol
    corr = float(np.corrcoef(xa, xb)[0, 1]) if len(xa) > 1 else float("nan")
    print(f"max |diff| = {diff.max():.6g}  mean = {diff.mean():.6g}  "
          f"pearson r = {corr:.6f}")
    print(f"{bad.sum()} / {len(xa)} rows outside rtol={args.rtol} "
          f"atol={args.atol}")
    if bad.any():
        worst = np.argsort(-diff)[:5]
        for i in worst:
            print(f"  row {i}: ours={xa[i]:.6g} ref={xb[i]:.6g}")
        sys.exit(1)
    print("PARITY OK")


if __name__ == "__main__":
    main()
