"""Synthetic token pipeline of the port: ``repro.data.pipeline`` in numpy.

Deterministic, seedable, host-side generation: sequences are drawn from a
Zipfian unigram model with EOS-delimited documents of exponential length.
For one ``DataConfig`` the batches equal the JAX package's bit for bit (the
same numpy generator, drawn in the same order); that module imports JAX,
so this is the port's own copy. ``make_batch_specs`` gives one phase's
inputs as meta tensors, the ``jax.ShapeDtypeStruct`` stand-ins of the JAX
package (the spec derivation reads them; nothing is allocated).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..configs.base import InputShape, ModelConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    doc_len_mean: float = 180.0  # mean document length (tokens)
    eos_id: int = 1
    pad_id: int = 0


class TokenPipeline:
    """Infinite iterator of {"tokens", "targets"} int32 numpy batches of
    shape (batch_size, seq_len); targets are the tokens shifted by one."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # Zipfian unigram distribution over the vocab (precomputed CDF)
        ranks = np.arange(2, cfg.vocab_size, dtype=np.float64)  # skip pad/eos
        w = 1.0 / ranks ** cfg.zipf_a
        self._cdf = np.cumsum(w) / w.sum()

    def _sample_tokens(self, n: int) -> np.ndarray:
        u = self.rng.random(n)
        return (np.searchsorted(self._cdf, u) + 2).astype(np.int32)

    def _sample_stream(self, n: int) -> np.ndarray:
        """n + 1 tokens of EOS-delimited documents."""
        out = np.empty(n + 1, np.int32)
        i = 0
        while i <= n:
            dl = max(1, int(self.rng.exponential(self.cfg.doc_len_mean)))
            dl = min(dl, n + 1 - i)
            out[i:i + dl] = self._sample_tokens(dl)
            i += dl
            if i <= n:
                out[i] = self.cfg.eos_id
                i += 1
        return out[:n + 1]

    def next_batch(self) -> dict:
        c = self.cfg
        toks = np.stack([self._sample_stream(c.seq_len)
                         for _ in range(c.batch_size)])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def output_length_samples(self, n: int = 10_000) -> np.ndarray:
        """Document lengths: the characterization feed for
        ``dec_timesteps``."""
        return np.maximum(
            1, self.rng.exponential(self.cfg.doc_len_mean, size=n).astype(int))


def make_batch_specs(cfg: ModelConfig, shape: InputShape,
                     dtype=torch.bfloat16) -> dict:
    """Meta tensors of one phase's inputs: train {"tokens", "targets"} and
    prefill {"tokens"} (B, S) int32, with a (B, P, d) ``dtype`` "prefix"
    for a model with prefix embeddings; decode {"token", "pos"} (B,)
    int32 (one new token per row, ragged positions within [0, S))."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt=torch.int32: torch.empty(shp, dtype=dt,
                                                   device="meta")
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": meta((B, S))}
        if shape.kind == "train":
            specs["targets"] = meta((B, S))
        if cfg.modality is not None and cfg.num_prefix_embeddings:
            specs["prefix"] = meta((B, cfg.num_prefix_embeddings,
                                    cfg.d_model), dtype)
        return specs
    return {"token": meta((B,)), "pos": meta((B,))}
