"""Deterministic, host-sharded synthetic token pipeline (the port of
``repro.data.pipeline``, numpy only: ``batch(step)`` is bitwise the JAX
package's).

Production properties that matter at 1000-node scale and are reproduced
here faithfully even though the corpus is synthetic:

* **statelessness** — batch ``i`` is a pure function of (seed, step,
  host_shard), so a restarted/elastic job resumes mid-epoch with no data
  loss or duplication (the checkpoint only stores the step);
* **host sharding** — each host materializes only its slice of the global
  batch (``host_slice``), matching a multi-host global batch;
* **prefetch** — a background thread keeps ``prefetch`` batches ready so
  host-side generation overlaps device compute.

The token stream is a mixture of Zipf-distributed unigrams and a
repetition process, giving a learnable (compressible) distribution so
training-loss decrease is a meaningful test signal.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataSpec", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class DataSpec:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Stateless synthetic LM data: batch(step) -> {tokens, labels}."""

    def __init__(self, spec: DataSpec, prefetch: int = 2):
        self.spec = spec
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        ranks = np.arange(1, spec.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    def batch(self, step: int) -> dict:
        spec = self.spec
        rng = np.random.default_rng(
            np.random.SeedSequence([spec.seed, step, spec.host_id])
        )
        B, S = spec.host_batch, spec.seq_len
        toks = rng.choice(spec.vocab, size=(B, S + 1), p=self._p)
        # repetition process: with p=0.3, copy the token 4 back (learnable)
        rep = rng.random((B, S + 1)) < 0.3
        for off in (4,):
            idx = np.arange(S + 1)
            src = np.clip(idx - off, 0, None)
            toks = np.where(rep, toks[:, src], toks)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # ---- prefetching iterator -------------------------------------------
    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                self._q.put(self.batch(step))
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            stop.set()
