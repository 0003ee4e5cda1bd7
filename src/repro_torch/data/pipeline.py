"""Data pipeline: deterministic synthetic token streams + byte-level file
corpora, host-sharded for multi-host training, with background prefetch.

Every host pulls only its shard (``host_id``/``num_hosts``), matching the
per-host feeding of a pod slice; the Launchpad data nodes wrap these
iterators behind a courier service (see ``repro_torch.core.nodes.reverb``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    batch_size: int               # per-host batch
    vocab_size: int
    seed: int = 0
    kind: str = "synthetic"       # synthetic | bytes
    path: Optional[str] = None    # for kind="bytes"


class SyntheticLM:
    """Deterministic pseudo-corpus: next token = hash of a short context.

    Gives a learnable (non-trivial, non-random) sequence distribution so
    training losses actually decrease; deterministic given (seed, host).
    """

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed * num_hosts + host_id)
        # A random linear-congruential next-token rule over a small state.
        self._a = int(self._rng.integers(1, cfg.vocab_size))
        self._b = int(self._rng.integers(0, cfg.vocab_size))

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        while True:
            start = self._rng.integers(0, cfg.vocab_size, size=(cfg.batch_size, 1))
            toks = [start]
            for _ in range(cfg.seq_len - 1):
                prev = toks[-1]
                noise = self._rng.integers(0, 4, size=prev.shape)
                nxt = (self._a * prev + self._b + noise) % cfg.vocab_size
                toks.append(nxt)
            tokens = np.concatenate(toks, axis=1).astype(np.int32)
            yield {"tokens": tokens, "labels": tokens}


class ByteCorpus:
    """Byte-level LM over a local file; documents packed into sequences."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.path, "ByteCorpus needs cfg.path"
        with open(cfg.path, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8).astype(np.int32)
        # Host sharding: contiguous stripe per host.
        stripe = len(data) // num_hosts
        self._data = data[host_id * stripe:(host_id + 1) * stripe]
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed + host_id)
        if len(self._data) < cfg.seq_len + 1:
            raise ValueError("corpus shard smaller than one sequence")

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        hi = len(self._data) - cfg.seq_len - 1
        while True:
            offs = self._rng.integers(0, hi, size=cfg.batch_size)
            tokens = np.stack([self._data[o:o + cfg.seq_len] for o in offs])
            yield {"tokens": tokens, "labels": tokens}


def make_source(cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg, host_id, num_hosts)
    if cfg.kind == "bytes":
        return ByteCorpus(cfg, host_id, num_hosts)
    raise ValueError(cfg.kind)


class Prefetcher:
    """Background-thread prefetch so host data prep overlaps device compute."""

    def __init__(self, source, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(iter(source),),
                                        daemon=True, name="data-prefetch")
        self._thread.start()

    def _fill(self, it):
        while not self._stop.is_set():
            try:
                item = next(it)
            except StopIteration:
                self._q.put(None)
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
