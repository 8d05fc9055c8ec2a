"""Host-side batch iteration (counterpart of
``codenerf_tpu/data/loader.py``; reference view_synthesis/utils/
util.py:59-90).

  * training samples WITH replacement from ``np.random.default_rng``, the
    stream the JAX package draws, so a seed picks the same images in both;
  * validation takes fixed sequential batches (the reference's 6th
    validation batch);
  * ``PrefetchIterator`` decodes the next batches on a thread while the
    device steps and, for a CUDA device, ships them there itself: from
    pinned memory, on a stream of the thread's own, with an event the
    consumer's stream waits on before first use.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from codenerf_tpu_torch.data.blender import BlenderNeRFDataset
from codenerf_tpu_torch.data.llff import LLFFDataset
from codenerf_tpu_torch.data.srn import SRNDataset

DATASET_REGISTRY = {
    "SRNDataset": SRNDataset,
    "BlenderNeRFDataset": BlenderNeRFDataset,
    "llff": LLFFDataset,
    "LLFFDataset": LLFFDataset,
}


def build_dataset(cfg_dataset, stage: str):
    """The dataset ``cfg_dataset.type`` names, for ``stage``, with the
    config's ``resolution_level`` (Blender) or ``downsample_factor`` and
    ``llffhold`` (LLFF)."""
    cls = DATASET_REGISTRY.get(cfg_dataset.type)
    if cls is None:
        raise ValueError(f"unknown dataset type: {cfg_dataset.type}")
    if cls is BlenderNeRFDataset:
        return cls(cfg_dataset.basedir, stage,
                   resolution_level=cfg_dataset.resolution_level)
    if cls is LLFFDataset:
        return cls(cfg_dataset.basedir, stage,
                   downsample_factor=cfg_dataset.downsample_factor,
                   llffhold=cfg_dataset.llffhold)
    return cls(cfg_dataset.basedir, stage)


def _load(dataset, idx) -> dict:
    """The samples at ``idx`` stacked: the dataset's ``load_views`` when it
    has one, else its items one by one."""
    if hasattr(dataset, "load_views"):
        return dataset.load_views(idx)
    samples = [dataset[int(i)] for i in idx]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchIterator:
    """Infinite with-replacement batch stream over a dataset.

    Args:
      dataset: a dataset (len and items, or ``load_views``).
      batch_size: images per batch.
      seed: seed of the ``np.random.default_rng`` stream; the harness
        passes the JAX package's seeds.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        idx = self.rng.integers(0, len(self.dataset), size=self.batch_size)
        return _load(self.dataset, idx)

    def fixed_batch(self, start: int = 0) -> dict:
        """Deterministic sequential batch (the reference's 6th-val-batch
        convention, eval.py:108-109)."""
        n = len(self.dataset)
        idx = [(start * self.batch_size + i) % n
               for i in range(self.batch_size)]
        return _load(self.dataset, idx)


class PrefetchIterator:
    """A background thread that loads the next ``depth`` batches of
    ``iterator`` while the device runs the current step.

    With ``device`` set, the arrays under ``device_keys`` arrive as
    tensors on it.  For a CUDA device the thread copies them from pinned
    memory on a stream of its own and records an event; ``__next__`` makes
    the consumer's current stream wait on that event and marks the tensors
    as used there (``record_stream``), so the copy overlaps the step's
    kernels instead of queueing behind them on the default stream.
    ``close`` stops the thread.
    """

    def __init__(self, iterator, depth: int = 2, device=None,
                 device_keys=("pose", "color", "object_id")):
        self._it = iterator
        self._q = queue.Queue(maxsize=max(1, depth))
        self._err = None
        self._stop = threading.Event()
        self._device = None if device is None else torch.device(device)
        self._keys = device_keys
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _ship(self, batch: dict, stream):
        out = dict(batch)
        if stream is None:
            for k in self._keys:
                out[k] = torch.from_numpy(np.asarray(batch[k])).to(
                    self._device)
            return out, None
        with torch.cuda.stream(stream):
            for k in self._keys:
                host = torch.from_numpy(np.ascontiguousarray(batch[k]))
                out[k] = host.pin_memory().to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            stream = None
            if self._device is not None and self._device.type == "cuda":
                stream = torch.cuda.Stream(self._device)
            while not self._stop.is_set():
                item = next(self._it)
                if self._device is not None:
                    item = self._ship(item, stream)
                if not self._put(item):
                    return
        except Exception as e:  # raised again on the consumer's side
            self._err = e
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise self._err
        if self._device is None:
            return item
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for k in self._keys:
                batch[k].record_stream(current)
        return batch

    def close(self, timeout: float = 10.0) -> None:
        """Stop the thread and wait for it (its current load finishes)."""
        self._stop.set()
        self._thread.join(timeout)
