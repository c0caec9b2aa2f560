"""Host-side data pipeline of the port (the JAX package's
`data/pipeline.py`, numpy, the same seeds): a sharded, prefetching batch
iterator.

Each data-parallel host feeds only its slice of the global batch
(per-host batch = global / n_hosts); a background thread keeps `prefetch`
batches ready.  Batches are numpy dicts; the train step moves them to the
model's device.  When the queue is full the worker waits with its batch
(the reference drops it and draws a new one), so the sequence of batches
depends on the seed alone, never on timing.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


class BatchPipeline:
    def __init__(self, make_batch: Callable[[np.random.Generator], Dict],
                 seed: int = 0, prefetch: int = 2,
                 host_index: int = 0, n_hosts: int = 1):
        self.make_batch = make_batch
        self.rng = np.random.default_rng(seed + host_index * 9973)
        self.host_index = host_index
        self.n_hosts = n_hosts
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.make_batch(self.rng)
            if self.n_hosts > 1:
                batch = {k: self._host_slice(v) for k, v in batch.items()}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def _host_slice(self, arr: np.ndarray) -> np.ndarray:
        per = arr.shape[0] // self.n_hosts
        lo = self.host_index * per
        return arr[lo:lo + per]

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def lm_synthetic_batches(vocab_size: int, batch: int, seq: int):
    """Synthetic LM token stream (shifted-label causal LM)."""
    def make(rng: np.random.Generator) -> Dict:
        toks = rng.integers(1, vocab_size, (batch, seq + 1), dtype=np.int64)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
    return make
