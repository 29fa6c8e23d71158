"""Deterministic, sharded, checkpointable synthetic LM data pipeline.

Production pipelines (SSTable/ArrayRecord readers) are replaced by a
seeded synthetic token stream with the same *interface contract*:

* deterministic: batch at step k is a pure function of (seed, k) — replay
  after restart yields bit-identical batches;
* sharded: each data-parallel replica draws only its slice (host-local
  reads on a real pod);
* checkpointable: the cursor is a single integer restored from the train
  checkpoint;
* schema-aware: emits the stub frontend embeddings for whisper/pixtral.

The synthetic distribution is a per-document Markov chain over the vocab
(not iid-uniform) so the loss has learnable structure — convergence tests
and examples train on it.

This is the PyTorch port's copy of ``repro.data.pipeline``: it draws with
numpy ``default_rng`` exactly as the original does, so both packages see
the same tokens for the same (seed, step). Batches stay numpy; the
trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchFamily, ModelConfig


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d) -> "DataState":
        return cls(step=int(d["step"]))


class SyntheticLMPipeline:
    """Markov-chain token stream.

    ``global_batch`` rows per step; ``replica_batch(replica, n_replicas)``
    returns only that replica's rows (deterministic function of step).
    """

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, order: int = 2):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.state = DataState()
        # small Markov backbone: vocab maps onto `order`-step cycle classes
        rng = np.random.default_rng(seed)
        self._classes = 64
        self._trans = rng.dirichlet(
            np.ones(self._classes) * 0.3, size=self._classes)
        self._class_of = rng.integers(0, self._classes, size=cfg.vocab_size)
        # tokens of each class (for sampling)
        self._members = [np.where(self._class_of == c)[0]
                         for c in range(self._classes)]
        for c in range(self._classes):
            if len(self._members[c]) == 0:
                self._members[c] = np.array([c % cfg.vocab_size])

    # ----- core determinism: batch is a pure function of (seed, step) -----
    def _rows(self, step: int, row_lo: int, row_hi: int) -> np.ndarray:
        out = np.empty((row_hi - row_lo, self.seq_len), np.int32)
        for r in range(row_lo, row_hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, r]))
            cls = rng.integers(0, self._classes)
            toks = np.empty(self.seq_len, np.int32)
            for t in range(self.seq_len):
                members = self._members[cls]
                toks[t] = members[rng.integers(0, len(members))]
                cls = rng.choice(self._classes, p=self._trans[cls])
            out[r - row_lo] = toks
        return out

    def _frontend(self, step: int, batch: int) -> Optional[np.ndarray]:
        cfg = self.cfg
        if not cfg.embed_frontend_stub:
            return None
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 1 << 20]))
        if cfg.family == ArchFamily.AUDIO:
            t = min(cfg.max_source_positions, 64)
        else:  # VLM patches: quarter of the sequence
            t = max(self.seq_len // 4, 1)
        return rng.normal(size=(batch, t, cfg.d_model)).astype(np.float32)

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        tokens = self._rows(step, 0, self.global_batch)
        return self._assemble(step, tokens)

    def replica_batch(self, step: int, replica: int, n_replicas: int
                      ) -> Dict[str, np.ndarray]:
        per = self.global_batch // n_replicas
        tokens = self._rows(step, replica * per, (replica + 1) * per)
        return self._assemble(step, tokens)

    def _assemble(self, step: int, tokens: np.ndarray) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        batch: Dict[str, np.ndarray] = {"tokens": tokens}
        fe = self._frontend(step, tokens.shape[0])
        if fe is not None:
            if cfg.family == ArchFamily.AUDIO:
                batch["enc_embeds"] = fe
            else:
                s_img = fe.shape[1]
                batch["patch_embeds"] = fe
                batch["tokens"] = tokens[:, : self.seq_len - s_img]
        return batch

    # ----- iterator protocol with checkpointable cursor -----
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.global_batch_at(self.state.step)
        self.state.step += 1
        return b

    def checkpoint(self) -> Dict[str, int]:
        return self.state.to_dict()

    def restore(self, d: Dict[str, int]) -> None:
        self.state = DataState.from_dict(d)
