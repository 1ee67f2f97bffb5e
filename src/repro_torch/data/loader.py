"""Sharded, prefetching host data loader.

Each host materializes only its shard of the global batch (``host_id`` /
``n_hosts``), and a background thread keeps ``prefetch`` batches ready —
the input pipeline's analogue of overlapping far-tier fetches with compute.
State is a single integer cursor: checkpointable, elastic-reshardable (a
restore with a different n_hosts re-slices the same global index space).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.data.synthetic import SyntheticCorpus


class ShardedLoader:
    def __init__(
        self,
        corpus: SyntheticCorpus,
        global_batch: int,
        host_id: int = 0,
        n_hosts: int = 1,
        prefetch: int = 2,
        start_step: int = 0,
    ):
        assert global_batch % n_hosts == 0, (global_batch, n_hosts)
        self.corpus = corpus
        self.global_batch = global_batch
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = global_batch // n_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _indices(self, step: int) -> np.ndarray:
        base = step * self.global_batch
        lo = base + self.host_id * self.local_batch
        return np.arange(lo, lo + self.local_batch)

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.corpus.batch(self._indices(step))
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def state(self) -> dict:
        return {"step": self.step, "host_id": self.host_id, "n_hosts": self.n_hosts}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    @classmethod
    def restore(cls, corpus, global_batch, state: dict, host_id: int, n_hosts: int, **kw):
        """Elastic restore: same global cursor, re-sliced for the new topology."""
        return cls(
            corpus, global_batch, host_id=host_id, n_hosts=n_hosts, start_step=state["step"], **kw
        )
