"""Token data pipeline: deterministic synthetic stream + packed batches,
per-host sharding and background prefetch — the port's own copy of
``repro.data.pipeline`` (numpy only), which yields the same bytes.

Real deployments swap ``SyntheticTokenSource`` for a file-backed source with
the same iterator contract; everything downstream (packing, sharding,
prefetch, checkpointing of the stream position) is production-shaped.
Batches are numpy int32 arrays; the trainer moves them to its device.
One difference: the reference's prefetch thread drops a batch when its
queue stays full for a second (a step slower than that skips data); this
copy waits instead, so the batches are the reference's whatever the
consumer's pace.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticTokenSource:
    """Deterministic pseudo-corpus: documents of random length with a
    Markov-ish structure so losses move during training."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 mean_doc_len: int = 512):
        self.vocab = vocab_size
        self.seed = seed
        self.mean_doc_len = mean_doc_len
        self._doc_idx = 0

    def state(self) -> Dict:
        return {"doc_idx": self._doc_idx}

    def restore(self, state: Dict) -> None:
        self._doc_idx = int(state["doc_idx"])

    def next_doc(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, self._doc_idx))
        self._doc_idx += 1
        n = int(rng.integers(self.mean_doc_len // 2, self.mean_doc_len * 2))
        # zipfian unigram marginal + bigram chains: learnable signal so
        # training losses visibly move on the reduced configs
        ranks = np.arange(1, self.vocab, dtype=np.float64)
        p = 1.0 / ranks
        p /= p.sum()
        base = rng.choice(np.arange(1, self.vocab), size=n, p=p)
        base[1::2] = (base[0::2][:base[1::2].size] * 7 + 3) % self.vocab
        return base.astype(np.int32)


class PackedBatchIterator:
    """Packs documents into fixed [batch, seq] blocks (no padding waste),
    shards the batch over hosts, prefetches in a background thread."""

    def __init__(self, source: SyntheticTokenSource, *, batch: int,
                 seq_len: int, host_index: int = 0, host_count: int = 1,
                 prefetch: int = 2):
        assert batch % host_count == 0
        self.source = source
        self.batch = batch
        self.local_batch = batch // host_count
        self.host_index = host_index
        self.host_count = host_count
        self.seq_len = seq_len
        self._buf = np.zeros(0, np.int32)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _fill(self, n: int) -> np.ndarray:
        while self._buf.size < n:
            doc = self.source.next_doc()
            self._buf = np.concatenate([self._buf, doc, [0]])  # 0 = doc sep
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _produce(self) -> None:
        while not self._stop.is_set():
            need = self.batch * (self.seq_len + 1)
            block = self._fill(need).reshape(self.batch, self.seq_len + 1)
            lo = self.host_index * self.local_batch
            local = block[lo:lo + self.local_batch]
            item = {"tokens": local[:, :-1].copy(),
                    "labels": local[:, 1:].copy()}
            # the reference drops ``item`` when the queue stays full for
            # a second (a consumer slower than that loses batches); here
            # it waits, so the order never depends on the consumer's pace
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
