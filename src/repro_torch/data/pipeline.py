"""Deterministic synthetic C4-like token pipeline (a copy of
`repro.data.pipeline`, which is numpy-only; the port imports nothing of the
reference, and the same seed gives the same batches in both packages).

Production shape without the dataset gate: a seeded Zipf-ish sampler emits
packed documents (BOS/EOS delimited) so the stream has realistic token
statistics; every (seed, step, dp_rank) triple is reproducible, which the
fault-tolerance tests rely on (bit-exact resume). Batches are generated
host-side per data-parallel rank and prefetched on a background thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    bos: int = 1
    eos: int = 2


class SyntheticC4:
    """Stateless per-step batch synthesis: batch(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf-ish unigram distribution over the vocab (heavy head like C4)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = (p / p.sum()).astype(np.float64)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(B, S + 1), p=self._p) \
            .astype(np.int32)
        toks = np.maximum(toks, 3)                # reserve specials
        # doc boundaries: geometric lengths, packed
        n_docs = max(1, (S + 1) // cfg.mean_doc_len)
        for b in range(B):
            cuts = rng.integers(1, S, size=n_docs)
            toks[b, cuts] = cfg.eos
        toks[:, 0] = cfg.bos
        tokens, targets = toks[:, :-1], toks[:, 1:]
        valid = (targets != cfg.bos).astype(np.float32)
        return {"tokens": tokens, "targets": np.ascontiguousarray(targets),
                "valid": valid}


def adapt_batch(base: dict, specs: dict, step: int, seed: int = 0) -> dict:
    """Fit a SyntheticC4 token batch to a model's `input_specs`.

    Token-shaped fields (tokens/targets/valid) are CROPPED from the base
    batch (models like the VLM or the enc-dec reserve part of the sequence
    budget for the modality stream, so their text spans are shorter);
    non-token float fields (img_embeds, frames) are synthesized from a
    seeded rng — deterministic per (seed, step), like the token stream.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, 0x5eed]))
    out = {}
    for k, sd in specs.items():
        if k in base:
            a = base[k]
            if a.ndim != len(sd.shape) or any(
                    have < want for have, want in zip(a.shape, sd.shape)):
                raise ValueError(
                    f"batch field {k!r}: base {a.shape} cannot cover "
                    f"spec {sd.shape}")
            out[k] = np.ascontiguousarray(
                a[tuple(slice(0, n) for n in sd.shape)])
        elif np.issubdtype(np.dtype(sd.dtype), np.integer):
            out[k] = rng.integers(3, 100, size=sd.shape).astype(sd.dtype)
        else:
            out[k] = (rng.standard_normal(sd.shape) * 0.3).astype(sd.dtype)
    return out


class Prefetcher:
    """Background-thread batch prefetch with bounded queue."""

    def __init__(self, ds: SyntheticC4, start_step: int = 0, depth: int = 2):
        self._ds = ds
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._ds.batch(step)), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._t.join(timeout=2)
