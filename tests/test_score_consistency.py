"""Zero-shot score stability: dtype, batch size, and engine invariances."""

import jax
import jax.numpy as jnp
import numpy as np

from plantcaduceus_tpu.engine.runner import InferenceRunner
from plantcaduceus_tpu.engine import zero_shot
from plantcaduceus_tpu.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu.models import caduceus
from plantcaduceus_tpu.models.config import CaduceusConfig
from plantcaduceus_tpu.parallel import mesh as meshlib

TINY = dict(d_model=32, n_layer=3, vocab_size=16, d_state=8)


def _setup(rng, n=24, L=128):
    cfg = CaduceusConfig(**TINY)
    params = caduceus.init_params(jax.random.PRNGKey(0), cfg)
    tok = DnaTokenizer()
    seqs = ["".join(rng.choice(list("ACGT"), L)) for _ in range(n)]
    return cfg, params, tok, seqs


def _mesh1():
    return meshlib.make_mesh(meshlib.MeshConfig(data=1),
                             devices=jax.devices()[:1])


def test_scores_batch_size_invariant(rng):
    """Padding the ragged tail must not change any score."""
    cfg, params, tok, seqs = _setup(rng, n=21)
    out = {}
    for bs in (8, 16, 32):
        runner = InferenceRunner(params, cfg, mesh=_mesh1(),
                                 dtype=jnp.float32, batch_size=bs)
        out[bs] = zero_shot.nucleotide_probs(runner, tok, seqs, token_idx=64,
                                             progress=False)
    np.testing.assert_allclose(out[8], out[16], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out[8], out[32], rtol=1e-6, atol=1e-7)


def test_scores_bf16_close_to_fp32(rng):
    """bf16 inference must give scores close to fp32 (the reference runs
    bf16 on A100+; zero-shot scores are softmax-ratio quantities and must be
    stable under reduced precision)."""
    cfg, params, tok, seqs = _setup(rng, n=16)
    probs = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        runner = InferenceRunner(params, cfg, mesh=_mesh1(), dtype=dtype,
                                 batch_size=16)
        probs[dtype] = zero_shot.nucleotide_probs(runner, tok, seqs, 64,
                                                  progress=False)
    refs = [s[64] for s in seqs]
    alts = ["A" if r != "A" else "C" for r in refs]
    s32 = zero_shot.log_ratio_scores(probs[jnp.float32], refs, alts)
    s16 = zero_shot.log_ratio_scores(probs[jnp.bfloat16], refs, alts)
    # scores are O(0.1-1); bf16 tolerance per BASELINE "bf16 mode validated
    # separately" — demand tight correlation and small absolute error
    assert np.corrcoef(s32, s16)[0, 1] > 0.999
    np.testing.assert_allclose(s16, s32, atol=0.05)


def test_score_symmetry_under_rc(rng):
    """Scoring a window and its reverse complement (with the complementary
    ref/alt) must give identical scores — the RC-equivariance guarantee at
    the application level."""
    from plantcaduceus_tpu.io.tokenizer import reverse_complement

    cfg, params, tok, seqs = _setup(rng, n=8, L=129)
    runner = InferenceRunner(params, cfg, mesh=_mesh1(), dtype=jnp.float32,
                             batch_size=8)
    center = 64  # center of a 129-mer: RC maps position 64 -> 64
    probs_f = zero_shot.nucleotide_probs(runner, tok, seqs, center,
                                         progress=False)
    rc_seqs = [reverse_complement(s) for s in seqs]
    probs_r = zero_shot.nucleotide_probs(runner, tok, rc_seqs, center,
                                         progress=False)
    # P_rc(base) == P_fwd(complement(base)): columns A,C,G,T -> T,G,C,A
    np.testing.assert_allclose(probs_r, probs_f[:, ::-1], rtol=1e-4,
                               atol=1e-5)


def test_unstripe_reassembly(rng):
    """Multi-host gather reassembly restores global record order."""
    from plantcaduceus_tpu.engine.zero_shot import _unstripe

    n_hosts, total = 3, 10
    data = rng.standard_normal((total, 4)).astype(np.float32)
    per = -(-total // n_hosts)
    gathered = np.zeros((n_hosts, per, 4), np.float32)
    counts = []
    for h in range(n_hosts):
        mine = data[h::n_hosts]
        counts.append(len(mine))
        gathered[h, : len(mine)] = mine
    out = _unstripe(gathered, counts)
    np.testing.assert_array_equal(out, data)


def test_scores_context_parallel_match(rng):
    """A (data=2, seq=4) context-parallel runner scores long windows
    identically to the single-device runner: the length-sharded forward
    (halo conv + two-pass scan + RC shard flips) plus the GSPMD-sliced
    extraction reproduce every probability."""
    # shapes at the scale of tests/test_seq_parallel.py's full-model checks
    small = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)
    cfg_sp = CaduceusConfig(**small, scan_impl="chunked")
    cfg_ref = CaduceusConfig(**small)
    params = caduceus.init_params(jax.random.PRNGKey(0), cfg_ref)
    tok = DnaTokenizer()
    seqs = ["".join(rng.choice(list("ACGT"), 128)) for _ in range(4)]

    ref_runner = InferenceRunner(params, cfg_ref, mesh=_mesh1(),
                                 dtype=jnp.float32, batch_size=4)
    want = zero_shot.nucleotide_probs(ref_runner, tok, seqs, token_idx=64,
                                      progress=False)

    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=2, seq=4))
    sp_runner = InferenceRunner(params, cfg_sp, mesh=mesh,
                                dtype=jnp.float32, batch_size=4)
    got = zero_shot.nucleotide_probs(sp_runner, tok, seqs, token_idx=64,
                                     progress=False)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_scores_context_parallel_match_mamba2(rng):
    """Same engine invariance for the SSD family: a (data=2, seq=4) mamba2
    runner reproduces the single-device probabilities (x/B/C conv halos +
    sharded SSD stitch/correction under the GSPMD-sliced extraction)."""
    small = dict(d_model=32, n_layer=2, vocab_size=16, ssm_variant="mamba2",
                 d_state=8, head_dim=16, chunk_size=32)
    cfg = CaduceusConfig(**small)
    params = caduceus.init_params(jax.random.PRNGKey(0), cfg)
    tok = DnaTokenizer()
    seqs = ["".join(rng.choice(list("ACGT"), 128)) for _ in range(4)]

    ref_runner = InferenceRunner(params, cfg, mesh=_mesh1(),
                                 dtype=jnp.float32, batch_size=4)
    want = zero_shot.nucleotide_probs(ref_runner, tok, seqs, token_idx=64,
                                      progress=False)

    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=2, seq=4))
    sp_runner = InferenceRunner(params, cfg, mesh=mesh,
                                dtype=jnp.float32, batch_size=4)
    got = zero_shot.nucleotide_probs(sp_runner, tok, seqs, token_idx=64,
                                     progress=False)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_duplicate_windows_scored_once(rng, monkeypatch):
    """Saturation-mutagenesis shape: every window repeated 3x (one per alt).
    The engine must forward each unique window once and scatter the probs
    back into record order."""
    cfg, params, tok, seqs = _setup(rng, n=8)
    tripled = [s for s in seqs for _ in range(3)]
    runner = InferenceRunner(params, cfg, mesh=_mesh1(),
                             dtype=jnp.float32, batch_size=8)

    want = zero_shot.nucleotide_probs(runner, tok, seqs, token_idx=64,
                                      progress=False)

    n_forwarded = []
    real = InferenceRunner.masked_probs

    def counting(self, ids, nucleotide_ids, position, progress=True):
        n_forwarded.append(len(ids))
        return real(self, ids, nucleotide_ids, position, progress=progress)

    monkeypatch.setattr(InferenceRunner, "masked_probs", counting)
    got = zero_shot.nucleotide_probs(runner, tok, tripled, token_idx=64,
                                     progress=False)
    assert n_forwarded == [len(seqs)]
    assert got.shape == (len(tripled), 4)
    np.testing.assert_array_equal(got, np.repeat(want, 3, axis=0))


def test_ssd_long_context_no_batch_warning(rng, monkeypatch):
    """The runner emits no long-context batch warning for the SSD variants:
    large batches at long windows run silently."""
    import warnings

    cfg = CaduceusConfig(d_model=32, n_layer=1, vocab_size=16,
                         ssm_variant="mamba2", d_state=8, head_dim=16,
                         chunk_size=32, scan_impl="xla")
    params = caduceus.init_params(jax.random.PRNGKey(0), cfg)
    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=1),
                             devices=jax.devices()[:1])
    runner = InferenceRunner(params, cfg, mesh=mesh, dtype=jnp.float32,
                             batch_size=32)
    # stub the compiled-forward machinery: only the guard layer is under test
    monkeypatch.setattr(runner, "_build_fwd",
                        lambda extract, want_hidden: 1 / 0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            runner.run(np.full((4, 4096), 7, np.int32), lambda out: out)
        except ZeroDivisionError:
            pass
    assert not any("HBM cliff" in str(x.message) for x in w)


def test_uppercase_vocab_tokenizer_scores_end_to_end(rng, tmp_path):
    """A from_hf_dir tokenizer with an UPPERCASE vocab (no lowercasing
    normalizer) must resolve nucleotide ids case-insensitively and score
    through the engine instead of KeyError-ing on vocab['a']."""
    import json

    from plantcaduceus_tpu.io.tokenizer import nucleotide_ids

    vocab = {"[PAD]": 0, "[UNK]": 1, "[MASK]": 2, "A": 3, "C": 4, "G": 5,
             "T": 6, "N": 7}
    (tmp_path / "tokenizer.json").write_text(json.dumps({
        "normalizer": None,
        "model": {"type": "WordLevel", "vocab": vocab},
    }))
    tok = DnaTokenizer.from_hf_dir(tmp_path)
    assert tok.lowercase is False
    assert nucleotide_ids(tok) == [3, 4, 5, 6]

    cfg = CaduceusConfig(**TINY)
    params = caduceus.init_params(jax.random.PRNGKey(0), cfg)
    seqs = ["".join(rng.choice(list("ACGT"), 128)) for _ in range(8)]
    runner = InferenceRunner(params, cfg, mesh=_mesh1(), dtype=jnp.float32,
                             batch_size=8)
    probs = zero_shot.nucleotide_probs(runner, tok, seqs, token_idx=64,
                                       progress=False)
    assert probs.shape == (8, 4) and np.isfinite(probs).all()
    scores = zero_shot.log_ratio_scores(probs, ["A"] * 8, ["T"] * 8)
    assert np.isfinite(scores).all()


def test_nucleotide_ids_missing_base_clear_error():
    """A vocab with no entry for a base in either case fails with a message
    naming the vocab, not a bare KeyError."""
    import pytest

    from plantcaduceus_tpu.io.tokenizer import nucleotide_ids

    tok = DnaTokenizer(characters=("a", "c", "g"))  # no t/T
    with pytest.raises(KeyError, match="neither 't' nor 'T'"):
        nucleotide_ids(tok)
