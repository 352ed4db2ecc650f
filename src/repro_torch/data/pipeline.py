"""Deterministic sharded synthetic data pipeline: the port's own copy of
the JAX package's (``repro.data.pipeline``), numpy only, so
``SyntheticLMStream.batch_at`` gives the same bits in both packages.

Design mirrors a production loader:
  * a *global* sample space indexed by (step, position-in-global-batch);
  * each data-parallel host materializes only its shard (host_id,
    n_hosts), so 1000-node runs never duplicate IO;
  * background prefetch thread keeps ``prefetch`` batches ready (overlap
    host-side generation with device compute);
  * restart-safe: the stream is a pure function of (seed, step), so
    resuming from checkpoint step k reproduces the exact remaining
    stream - no loader state to checkpoint.

Synthetic distribution: Zipf-ish token draw (heavy-tailed like real
corpora) from a deterministic counter-based generator (numpy
Philox), with labels = inputs (standard next-token LM objective uses the
shifted view inside the loss).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 20260305
    zipf_a: float = 1.2
    prefetch: int = 2


class SyntheticLMStream:
    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 n_hosts: int = 1) -> None:
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step, host): the elastic-restart
        contract."""
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[step, self.host_id, 0, 0]))
        z = rng.zipf(cfg.zipf_a, size=(self.local_batch, cfg.seq_len))
        tokens = (z % (cfg.vocab_size - 1)).astype(np.int32) + 1
        return {"tokens": tokens, "labels": tokens.copy()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """Background-thread prefetch wrapper (host-side pipelining)."""

    def __init__(self, stream: SyntheticLMStream, start_step: int = 0,
                 prefetch: Optional[int] = None) -> None:
        self.stream = stream
        self.start_step = start_step
        depth = prefetch or stream.cfg.prefetch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.start_step
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> tuple[int, dict]:
        # bounded wait: a dead worker must surface as an error, not a
        # silent hang of the train loop
        return self._q.get(timeout=60.0)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
