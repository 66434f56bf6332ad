"""Dataset base: sliding-window index over HDF5 sequence stores + loader
(copy of ``cs_vit_tpu/data/base.py``).

Replaces torch Dataset/DataLoader/DistributedSampler with a numpy pipeline:
* sliding-window index with cumsum + binary search (ref `DexYCB.py:60-85`)
* epoch-seeded shuffling and deterministic per-process sharding
  (ref `DistributedSampler`, `scripts/finetune.py:109,312`)
* background-thread prefetch of collated numpy batches (an item's exception
  reaches the consumer); the caller moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


class DeterministicItemRNG:
    """Per-(epoch, item) RNG for augmentation draws.

    A shared ``np.random.Generator`` is neither thread-safe (the parallel
    loader calls ``__getitem__`` concurrently) nor reproducible (draws depend
    on iteration order). Seeding a fresh generator from ``[seed, epoch, ix]``
    makes every item's augmentation a pure function of (seed, epoch, index),
    so a ``num_workers=8`` run produces bitwise-identical batches to a serial
    one. Mirrors the determinism intent of torch's per-worker
    ``base_seed + worker_id`` seeding (ref `scripts/finetune.py:103-111`)
    while being stronger (order-independent).
    """

    _seed: int = 0
    epoch: int = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _item_rng(self, ix: int) -> np.random.Generator:
        return np.random.default_rng([self._seed, self.epoch, int(ix)])


class SlidingWindowDataset(DeterministicItemRNG):
    """Base for h5-sequence datasets: index arithmetic + len/locate."""

    def __init__(self, num_frames: int):
        self.num_frames = num_frames
        self.seq_index: List[Dict[str, Any]] = []
        self.aux_index: Optional[np.ndarray] = None

    def build_index(self, entries: List[Dict[str, Any]]):
        """entries: [{'path_h5': ..., 'seq_length': int}, ...] (>= num_frames)."""
        self.seq_index = [e for e in entries if e["seq_length"] >= self.num_frames]
        windows = [e["seq_length"] - self.num_frames + 1 for e in self.seq_index]
        self.aux_index = np.cumsum(windows) if windows else np.zeros(0, np.int64)

    def __len__(self) -> int:
        return int(self.aux_index[-1]) if len(self.aux_index) else 0

    def locate(self, ix: int):
        """Map a flat index to (sequence, offset within it)."""
        group_ix = int(np.searchsorted(self.aux_index, ix + 1, side="left"))
        in_group_ix = ix if group_ix == 0 else ix - int(self.aux_index[group_ix - 1])
        return group_ix, int(in_group_ix)


def collate(batch: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy fields to [B,...]; keep imgs_path/flip as python lists.

    Ref `InterHand26MSeq.collate_fn` (`InterHand26MSeq.py:22-34`).
    """
    out: Dict[str, Any] = {}
    for key in batch[0]:
        if key in ("imgs_path", "flip"):
            out[key] = [s[key] for s in batch]
        else:
            out[key] = np.stack([np.asarray(s[key]) for s in batch], axis=0)
    return out


class ConcatDataset:
    """Concatenation of datasets with a shared item schema."""

    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._cum[-1]) if len(self._cum) else 0

    def __getitem__(self, ix: int):
        d = int(np.searchsorted(self._cum, ix + 1, side="left"))
        base = 0 if d == 0 else int(self._cum[d - 1])
        return self.datasets[d][ix - base]

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)


class DataLoader:
    """Epoch-seeded shuffling, per-process sharding, parallel item loading.

    ``num_workers > 1`` fans ``__getitem__`` out over a thread pool (the hot
    per-item work — cv2 JPEG decode, the ctypes C fast-crop, h5py reads —
    releases the GIL, so threads scale like the reference's 8 dataloader
    worker *processes*, ref `scripts/finetune.py:103-111`, without the
    pickling/fork cost). Batches are yielded in order and, thanks to the
    datasets' per-(epoch, item) RNG, are bitwise-identical to a serial run.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 42,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        num_workers: int = 0,
        collate_fn=collate,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        # DistributedSampler-style padding so every shard sees the same count
        total = ((n + self.num_shards - 1) // self.num_shards) * self.num_shards
        if total > n:
            order = np.concatenate([order, order[: total - n]])
        return order[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        per = len(self._indices())
        if self.drop_last:
            return per // self.batch_size
        return (per + self.batch_size - 1) // self.batch_size

    def _chunks(self) -> Iterator[np.ndarray]:
        idx = self._indices()
        stop = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for s in range(0, stop, self.batch_size):
            yield idx[s : s + self.batch_size]

    def _batches(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers > 1:
            yield from self._batches_parallel()
            return
        for chunk in self._chunks():
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])

    def _batches_parallel(self) -> Iterator[Dict[str, Any]]:
        """Thread-pool item loading, up to ``prefetch + 1`` batches in flight."""
        with ThreadPoolExecutor(self.num_workers) as ex:
            pending: deque = deque()
            chunks = self._chunks()

            def fill():
                while len(pending) <= max(0, self.prefetch):
                    chunk = next(chunks, None)
                    if chunk is None:
                        return
                    pending.append(
                        [ex.submit(self.dataset.__getitem__, int(i)) for i in chunk]
                    )

            fill()
            while pending:
                futures = pending.popleft()
                batch = self.collate_fn([f.result() for f in futures])
                fill()
                yield batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:  # raised in the consumer below
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]
