"""Batched, sharded inference engine.

The hot path of every scoring/embedding workload (SURVEY.md §3.1-3.2): a
jitted forward over fixed-shape batches, weights replicated (or sharded) on
the mesh, input windows sharded over the ``data`` axis. Ragged tails are
padded to the fixed batch shape so XLA compiles exactly one executable per
(batch, length) — the recompilation-control rule of SURVEY.md §7.3.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from plantcaduceus_tpu.models import caduceus
from plantcaduceus_tpu.models.config import CaduceusConfig
from plantcaduceus_tpu.parallel import mesh as meshlib


class InferenceRunner:
    """Owns params-on-device + the compiled forward; yields numpy results."""

    def __init__(
        self,
        params,
        cfg: CaduceusConfig,
        mesh: Optional[Mesh] = None,
        dtype=jnp.bfloat16,
        batch_size: int = 128,
    ):
        self.cfg = cfg
        self.dtype = dtype
        self.batch_size = batch_size
        self.mesh = mesh if mesh is not None else meshlib.make_mesh()
        self.params = meshlib.shard_params(params, self.mesh, replicated=True)
        sp_shards = self.mesh.shape.get("seq", 1)
        self._sp = sp_shards > 1
        bspec = meshlib.batch_spec()
        ids_spec = P(bspec[0], "seq") if self._sp else bspec
        self._batch_sharding = NamedSharding(self.mesh, ids_spec)
        if batch_size % (self.mesh.shape["data"] * self.mesh.shape["fsdp"]):
            raise ValueError(
                f"batch_size {batch_size} must divide over the "
                f"{self.mesh.shape['data'] * self.mesh.shape['fsdp']}-way batch axes"
            )

        pspecs = meshlib.param_pspec_tree(params, replicated=True)
        self._fwd_cache = {}
        # Closure-keyed fallback entries live in a small LRU so callers that
        # pass a fresh ``extract`` per call (no cache_key) can't grow the
        # cache — and pin compiled executables — without bound.
        from collections import OrderedDict

        self._fwd_lru: "OrderedDict" = OrderedDict()
        self._fwd_lru_max = 8

        def build_fwd(extract, want_hidden):
            """Compile forward + extraction as ONE program, so the
            extraction adds no eager per-op dispatches per batch."""
            sp = self._sp

            def local_fwd(params, ids):
                # shard_map rather than GSPMD because the Triton scan has no
                # SPMD partitioning rule; batch rows are device-local. With
                # a non-trivial seq axis the window length is sharded too —
                # context-parallel scoring of long (8192-bp) windows.
                out = caduceus.forward(
                    params, ids, cfg, dtype=dtype,
                    output_hidden_states=want_hidden,
                    sp_axis="seq" if sp else None, sp_shards=sp_shards)
                res = {"logits": out["logits"].astype(jnp.float32)}
                if want_hidden:
                    res["hidden_states"] = out["hidden_states"].astype(jnp.float32)
                return res if sp else extract(res)

            if sp:
                # Raw outputs come back length-sharded; the extraction runs
                # under plain jit where GSPMD inserts the (tiny) collective
                # that fetches the scored position's shard.
                raw_specs = {"logits": ids_spec}
                if want_hidden:
                    raw_specs["hidden_states"] = ids_spec

                @jax.jit
                def fwd(params, ids):
                    raw = jax.shard_map(
                        local_fwd, mesh=self.mesh,
                        in_specs=(pspecs, ids_spec),
                        out_specs=raw_specs,
                        check_vma=False,
                    )(params, ids)
                    return extract(raw)

                return fwd

            @jax.jit
            def fwd(params, ids):
                return jax.shard_map(
                    local_fwd, mesh=self.mesh,
                    in_specs=(pspecs, bspec),
                    out_specs=P(("data", "fsdp")),
                    check_vma=False,
                )(params, ids)

            return fwd

        self._build_fwd = build_fwd

    # -- batching ----------------------------------------------------------

    def _pad(self, ids: np.ndarray) -> tuple[np.ndarray, int]:
        n = ids.shape[0]
        if n == self.batch_size:
            return ids, n
        pad = np.zeros((self.batch_size - n,) + ids.shape[1:], ids.dtype)
        pad[:] = self.cfg.pad_token_id
        return np.concatenate([ids, pad], axis=0), n

    def _iter_batches(self, ids: np.ndarray) -> Iterator[tuple[np.ndarray, int]]:
        for i in range(0, ids.shape[0], self.batch_size):
            yield self._pad(ids[i : i + self.batch_size])

    def run(
        self,
        ids: np.ndarray,
        extract: Callable[[dict], jax.Array],
        want_hidden: bool = False,
        progress: bool = True,
        cache_key: Optional[tuple] = None,
    ) -> np.ndarray:
        """Run the forward over all rows of ``ids`` ([N, L] int32). ``extract``
        (traced into the compiled program — it sees a dict of fp32 arrays)
        reduces per-batch outputs; batches are dispatched ahead of the host
        readback so upload/compute/download pipeline."""
        # Fall back to the closure object itself (not id(extract): the cache
        # must hold a strong reference, or a GC'd closure's id could be
        # reused by a different extract and serve the wrong compiled fwd).
        # Keyed entries persist for the runner's lifetime; closure-keyed
        # fallbacks go through a bounded LRU (see __init__) so repeated
        # callers with fresh closures don't pin executables forever —
        # such callers should pass ``cache_key`` to reuse compilations.
        if cache_key is not None:
            fwd = self._fwd_cache.get(cache_key)
            if fwd is None:
                fwd = self._build_fwd(extract, want_hidden)
                self._fwd_cache[cache_key] = fwd
        else:
            fwd = self._fwd_lru.get(extract)
            if fwd is None:
                fwd = self._build_fwd(extract, want_hidden)
                self._fwd_lru[extract] = fwd
                while len(self._fwd_lru) > self._fwd_lru_max:
                    self._fwd_lru.popitem(last=False)
            else:
                self._fwd_lru.move_to_end(extract)

        results = []
        batches = list(self._iter_batches(ids))
        it = batches
        if progress:
            try:
                from tqdm import tqdm

                it = tqdm(batches, desc="forward", unit="batch")
            except ImportError:
                pass
        pending = []
        for chunk, n in it:
            dev = jax.device_put(jnp.asarray(chunk), self._batch_sharding)
            pending.append((fwd(self.params, dev), n))
            # keep a shallow dispatch pipeline; drain oldest to numpy
            if len(pending) > 2:
                out, m = pending.pop(0)
                results.append(np.asarray(out)[:m])
        for out, m in pending:
            results.append(np.asarray(out)[:m])
        return np.concatenate(results, axis=0)

    # -- workload-specific extractors --------------------------------------

    def masked_probs(self, ids: np.ndarray, nucleotide_ids, position: int,
                     progress: bool = True) -> np.ndarray:
        """Softmax probabilities over the 4 nucleotide logits at ``position``
        for pre-masked inputs — the zero-shot scoring contract
        (src/zero_shot_score.py:107-121). Returns [N, 4] float32."""
        nuc = jnp.asarray(list(nucleotide_ids), jnp.int32)

        def extract(out):
            sel = out["logits"][:, position, :][:, nuc]
            return jax.nn.softmax(sel, axis=-1)

        return self.run(ids, extract, progress=progress,
                        cache_key=("masked", position, tuple(nucleotide_ids)))

    def multi_masked_probs(self, ids: np.ndarray, nucleotide_ids,
                           positions, progress: bool = True) -> np.ndarray:
        """Probs at several masked positions, flattened row-major like the
        reference's masked_select (src/zero-shot-eval.py:129-140):
        [N * len(positions), 4]."""
        nuc = jnp.asarray(list(nucleotide_ids), jnp.int32)
        pos = jnp.asarray(list(positions), jnp.int32)

        def extract(out):
            sel = out["logits"][:, pos, :][..., nuc]           # [B, P, 4]
            return jax.nn.softmax(sel, axis=-1)

        probs = self.run(ids, extract, progress=progress,
                         cache_key=("multi", tuple(positions),
                                    tuple(nucleotide_ids)))  # [N, P, 4]
        return probs.reshape(-1, probs.shape[-1])

    def positionwise_probs(self, ids: np.ndarray, nucleotide_ids,
                           progress: bool = True) -> np.ndarray:
        """Unmasked per-position probs over A,C,G,T: [N, L, 4]
        (src/zero-shot-eval.py:143-178 semantics)."""
        nuc = jnp.asarray(list(nucleotide_ids), jnp.int32)

        def extract(out):
            return jax.nn.softmax(out["logits"][..., nuc], axis=-1)

        return self.run(ids, extract, progress=progress,
                        cache_key=("positionwise", tuple(nucleotide_ids)))

    def center_embeddings(self, ids: np.ndarray, position: int,
                          rc_average: bool = True,
                          progress: bool = True) -> np.ndarray:
        """Final-layer embedding at ``position``, RC-averaged per the
        reference contract (src/train_XGBoost.py:104-113): split channels in
        half, reverse the second half's channel order, mean."""

        def extract(out):
            emb = out["hidden_states"][:, position, :]
            if not rc_average:
                return emb
            d = emb.shape[-1] // 2
            fwd, rev = emb[:, :d], emb[:, d:][:, ::-1]
            return (fwd + rev) * 0.5

        return self.run(ids, extract, want_hidden=True, progress=progress,
                        cache_key=("embed", position, rc_average))
