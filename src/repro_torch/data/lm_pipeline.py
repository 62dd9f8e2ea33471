"""LM token pipeline: synthetic corpus stream + host prefetch (port of
``repro/data/lm_pipeline.py``).

The synthetic stream is a deterministic function of (seed, step) so
restarts resume mid-epoch bit-identically; its numpy draws are the
reference's, token for token. The reference hands out ``jnp.asarray``
int32 arrays; here the batches are int32 tensors on the device the caller
names (the CPU by default; the train step moves them to the model's).
`Prefetcher` overlaps host batch assembly with device compute via a
bounded background queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.store import resolve_device


def synthetic_lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                         start_step: int = 0, device=None,
                         dtype=torch.int32) -> Iterator[dict]:
    """Markov-ish synthetic token stream (next-token structure so loss can
    actually decrease): token_{t+1} = (a * token_t + noise) % vocab."""
    dev = torch.device("cpu" if device is None else device)
    step = start_step
    while True:
        rng = np.random.default_rng((seed << 20) ^ step)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        noise = (rng.random((batch, seq)) < 0.1)
        rand = rng.integers(0, vocab, (batch, seq))
        for t in range(seq):
            nxt = (toks[:, t] * 31 + 7) % vocab
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        yield {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev, dtype),
               "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev, dtype)}
        step += 1


class Prefetcher:
    """Bounded background prefetch over any iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def device_put_batch(batch: dict, device=None) -> dict:
    """Every tensor of ``batch`` on ``device`` (the card unless the caller
    asks for another)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
