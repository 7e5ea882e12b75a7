"""CLI: autoregressive Mamba LM sanity harness.

TPU-native equivalent of the reference's Lightning Mamba image-LM harness
(SURVEY.md §2.3 B18: pretrain/scripts/run_ssm_im.py + models/mamba/{base,
mamba}.py — AR Mamba trained on tokenized images, bits-per-dim loss, and
``mamba_ssm`` recurrent generation). Exercises the raw unidirectional
selective-scan stack independently of Caduceus:

  train   — fit an AR Mamba on tokenized data, reporting bits/dim.
            Data sources: ``--data synthetic`` (procedural textures
            quantised to --levels tokens, the offline stand-in for the
            reference's tokenized CIFAR) or ``--data FILE`` (any file,
            byte-level LM over 256 tokens).
  sample  — greedy/temperature generation from a saved checkpoint via the
            O(1) recurrent decode.

Checkpoints are plain .npz pytrees (a sanity harness, not a production
training loop — that is cli.pretrain).
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)


def _synthetic_batch(rng: np.random.Generator, batch: int, side: int,
                     levels: int) -> np.ndarray:
    """Procedural [batch, side*side] token images: random oriented
    sinusoidal gratings + gradients, quantised to ``levels`` bins. Has
    genuine 2-D structure (rows are phase-shifted copies), so an AR model
    that learns it beats the uniform-bpd floor by a wide margin."""
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    imgs = np.empty((batch, side, side), np.float32)
    for i in range(batch):
        th = rng.uniform(0, np.pi)
        freq = rng.uniform(1.0, 3.0)
        phase = rng.uniform(0, 2 * np.pi)
        g = np.sin(2 * np.pi * freq * (np.cos(th) * xx + np.sin(th) * yy)
                   + phase)
        imgs[i] = 0.5 * (g + 1)
    toks = np.clip((imgs * levels).astype(np.int32), 0, levels - 1)
    return toks.reshape(batch, side * side)


def _file_batches(path: Path, batch: int, seq_len: int,
                  rng: np.random.Generator):
    data = np.frombuffer(path.read_bytes(), np.uint8)
    if data.size < seq_len + 1:
        raise SystemExit(f"{path} too small for seq_len={seq_len}")
    while True:
        starts = rng.integers(0, data.size - seq_len, size=batch)
        yield np.stack([data[s: s + seq_len] for s in starts]).astype(np.int32)


def train(args):
    import jax
    import jax.numpy as jnp
    import optax

    from plantcaduceus_tpu.models import mamba_lm

    synthetic = args.data == "synthetic"
    vocab = args.levels if synthetic else 256
    seq_len = args.side * args.side if synthetic else args.seq_len
    if args.ssm_variant == "mamba2":
        eff = min(args.chunk_size, seq_len)
        if seq_len % eff:
            raise SystemExit(
                f"--seq-len {seq_len} is not divisible by the effective "
                f"--chunk-size {eff} (mamba2 SSD chunking)")
    cfg = mamba_lm.MambaLmConfig(d_model=args.d_model, n_layer=args.n_layer,
                                 vocab_size=vocab, d_state=args.d_state,
                                 ssm_variant=args.ssm_variant,
                                 head_dim=args.head_dim,
                                 chunk_size=args.chunk_size)
    params = mamba_lm.init_params(jax.random.PRNGKey(args.seed), cfg)
    opt = optax.adamw(args.lr)
    opt_state = opt.init(params)
    rng = np.random.default_rng(args.seed)
    gen = (None if synthetic
           else _file_batches(Path(args.data), args.batch, seq_len, rng))

    @jax.jit
    def train_step(params, opt_state, ids):
        loss, grads = jax.value_and_grad(
            lambda p: mamba_lm.nll_loss(p, ids, cfg))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    t0 = time.time()
    for it in range(1, args.steps + 1):
        ids = (_synthetic_batch(rng, args.batch, args.side, args.levels)
               if synthetic else next(gen))
        params, opt_state, loss = train_step(params, opt_state,
                                             jnp.asarray(ids))
        if it % args.log_every == 0 or it == args.steps:
            bpd = float(mamba_lm.bits_per_dim(loss))
            tok_s = it * args.batch * seq_len / (time.time() - t0)
            log.info("step %d  bits/dim %.4f  (uniform %.2f)  %.0f tok/s",
                     it, bpd, np.log2(vocab), tok_s)

    out = Path(args.output)
    flat = {"/".join(map(str, k)): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez_compressed(out, __config__=json.dumps(vars(args)),
                        **{k.replace("['", "").replace("']", ""): v
                           for k, v in flat.items()})
    log.info("Saved checkpoint to %s", out)


def _load_ckpt(path: Path):
    z = np.load(path, allow_pickle=False)
    args = json.loads(str(z["__config__"]))
    params: dict = {}
    for key in z.files:
        if key == "__config__":
            continue
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return args, params


def sample(args):
    import jax
    import jax.numpy as jnp

    from plantcaduceus_tpu.models import mamba_lm

    targs, params = _load_ckpt(Path(args.checkpoint))
    synthetic = targs["data"] == "synthetic"
    vocab = targs["levels"] if synthetic else 256
    cfg = mamba_lm.MambaLmConfig(d_model=targs["d_model"],
                                 n_layer=targs["n_layer"], vocab_size=vocab,
                                 d_state=targs["d_state"],
                                 ssm_variant=targs.get("ssm_variant",
                                                       "mamba1"),
                                 head_dim=targs.get("head_dim", 64),
                                 chunk_size=targs.get("chunk_size", 64))
    params = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(args.seed)
    if synthetic:
        prompt = _synthetic_batch(rng, 1, targs["side"],
                                  targs["levels"])[:, : args.prompt_len]
    else:
        prompt = rng.integers(0, vocab, size=(1, args.prompt_len))
    key = None if args.temperature == 0 else jax.random.PRNGKey(args.seed)
    toks = mamba_lm.generate(params, cfg, jnp.asarray(prompt, jnp.int32),
                             args.n_new, rng=key,
                             temperature=args.temperature, top_k=args.top_k)
    print(json.dumps({"prompt": prompt[0].tolist(),
                      "generated": np.asarray(toks)[0].tolist()}))


def main(argv=None):
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train")
    tr.add_argument("--data", default="synthetic",
                    help="'synthetic' or a path to any file (byte-level LM)")
    tr.add_argument("--output", default="ar_lm.npz")
    tr.add_argument("--steps", type=int, default=200)
    tr.add_argument("--batch", type=int, default=32)
    tr.add_argument("--side", type=int, default=16,
                    help="synthetic image side (seq_len = side^2)")
    tr.add_argument("--levels", type=int, default=8,
                    help="synthetic quantisation levels (vocab)")
    tr.add_argument("--seq-len", type=int, default=256,
                    help="sequence length for file data")
    tr.add_argument("--d-model", type=int, default=128)
    tr.add_argument("--n-layer", type=int, default=4)
    tr.add_argument("--d-state", type=int, default=16)
    tr.add_argument("--ssm-variant", choices=("mamba1", "mamba2"),
                    default="mamba1",
                    help="mamba2 = SSD (chunked-matmul recurrence); pick "
                         "--d-state/--head-dim to taste (e.g. 64/64)")
    tr.add_argument("--head-dim", type=int, default=64,
                    help="mamba2 head size (d_inner %% head_dim == 0)")
    tr.add_argument("--chunk-size", type=int, default=64,
                    help="mamba2 SSD chunk (seq_len %% chunk == 0)")
    tr.add_argument("--lr", type=float, default=3e-3)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--log-every", type=int, default=20)

    sm = sub.add_parser("sample")
    sm.add_argument("checkpoint")
    sm.add_argument("--prompt-len", type=int, default=32)
    sm.add_argument("--n-new", type=int, default=64)
    sm.add_argument("--temperature", type=float, default=0.0)
    sm.add_argument("--top-k", type=int, default=None)
    sm.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    (train if args.cmd == "train" else sample)(args)


if __name__ == "__main__":
    main()
