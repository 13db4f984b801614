"""Host-side batch feed with background prefetch (counterpart of
``vqa_tpu/data/loader.py`` ``Loader`` and ``prefetch_to_device``).

- Fixed shapes: every batch has exactly ``batch_size`` rows; a short tail
  batch repeats its first row and carries ``nvalid``.
- Vectorized assembly: the dataset's ``get_batch`` (or the method named by
  ``batch_method``) gathers a whole batch; ``length`` overrides the index
  space, as the max-relevance feed needs (``get_batch_all`` takes question
  indices of a dataset whose ``len`` counts five captions a question).
- Pipelined: a background thread assembles the next batches.
- Sharded over processes (``num_shards``, ``shard_id``; ``for_process``
  takes them from a mesh's ``data`` axis): every shard draws the same
  permutation and takes the strided slice ``order[shard_id::num_shards]``,
  wrap-padded to ``shard_length`` so that every shard runs the same number
  of batches (unequal counts would deadlock lockstep collectives).
  ``batch_size`` is then the batch of one shard.
- Caption length bucketing (``length_bucket``): samples whose ``cap_len``
  falls in the same bucket form a batch whose caption axis is cut to the
  bucket's bound + 1, so the decoder's scan runs fewer steps. Every dropped
  step is masked out of the loss either way.
- ``prefetch_to_device`` moves the batches to a torch device ahead of the
  consumer; it imports torch when called, so the loader itself stays numpy
  only.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


class Loader:
    """Iterable over fixed-shape numpy batches with shuffle + prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 1111, drop_last: bool = False, prefetch: int = 2,
                 transform: Optional[Callable[[Dict[str, np.ndarray]],
                                              Dict[str, np.ndarray]]] = None,
                 batch_method: str = "get_batch",
                 length: Optional[int] = None,
                 num_shards: int = 1,
                 shard_id: int = 0,
                 length_bucket: bool = False,
                 bucket_bounds: tuple = (8, 12, 16, 20)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.transform = transform
        self.batch_method = batch_method
        self.length = length if length is not None else len(dataset)
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.length_bucket = length_bucket
        self.bucket_bounds = tuple(sorted(bucket_bounds))
        if length_bucket:
            if num_shards != 1:
                raise ValueError(
                    "length_bucket with sharding would need synchronized "
                    "bucket schedules (different caption lengths per shard "
                    "deadlock lockstep collectives); disable one of them")
            if getattr(dataset, "cap_lens", None) is None:
                raise ValueError("length_bucket needs dataset.cap_lens "
                                 "(a caption dataset)")
            # the top bucket must cover the longest caption, or its real
            # tokens would be cut by the truncation
            max_len = int(np.max(np.asarray(dataset.cap_lens)[:self.length]))
            if self.bucket_bounds[-1] < max_len:
                self.bucket_bounds = tuple(
                    sorted(set(self.bucket_bounds) | {max_len}))

    @classmethod
    def for_process(cls, dataset, batch_size: int, mesh=None, **kw):
        """A Loader over this process's shard: the shard of its rank on the
        mesh's ``data`` axis (ranks of one ``model`` group see the same
        rows), or of its rank in the world without a mesh."""
        import torch.distributed as dist
        if mesh is not None:
            n, r = mesh.size(0), mesh.get_local_rank("data")
        elif dist.is_initialized():
            n, r = dist.get_world_size(), dist.get_rank()
        else:
            n, r = 1, 0
        return cls(dataset, batch_size, num_shards=n, shard_id=r, **kw)

    @property
    def shard_length(self) -> int:
        """Samples this shard iterates: the same ceil(length / num_shards)
        for every shard (== length unsharded)."""
        return -(-self.length // self.num_shards)

    def __len__(self) -> int:
        if self.length_bucket:
            counts = self._bucket_counts()
            if self.drop_last:
                return sum(c // self.batch_size for c in counts)
            return sum(-(-c // self.batch_size) for c in counts if c)
        if self.drop_last:
            return self.shard_length // self.batch_size
        return -(-self.shard_length // self.batch_size)

    @property
    def num_samples(self) -> int:
        return self.shard_length

    def _bucket_of(self, lens: np.ndarray) -> np.ndarray:
        """Index of the first bound >= len (longer lengths share the last)."""
        bounds = np.asarray(self.bucket_bounds)
        return np.minimum(np.searchsorted(bounds, lens), len(bounds) - 1)

    def _bucket_counts(self):
        which = self._bucket_of(np.asarray(self.dataset.cap_lens)[:self.length])
        return [int(np.sum(which == b)) for b in range(len(self.bucket_bounds))]

    def _finish(self, idx: np.ndarray, nvalid: int, bound: Optional[int]):
        batch = getattr(self.dataset, self.batch_method)(list(idx))
        batch["nvalid"] = np.int32(nvalid)
        # keep one padded position beyond the bound, as the JAX package
        # does (its caption-reading predictors need it)
        if bound is not None and "c" in batch \
                and bound + 1 < batch["c"].shape[1]:
            batch["c"] = batch["c"][:, :bound + 1]
        return self.transform(batch) if self.transform is not None else batch

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        # an epoch-stable permutation: every shard derives the same order
        order = (self.rng.permutation(self.length) if self.shuffle
                 else np.arange(self.length))
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards]
            short = self.shard_length - len(order)
            if short > 0:     # wrap-pad so that every shard runs equal batches
                order = np.concatenate([order, order[:short]])
        plan = []                               # (idx [batch_size], nvalid, bound)
        if self.length_bucket:
            which = self._bucket_of(np.asarray(self.dataset.cap_lens)[order])
            groups = [(order[which == b], bound)
                      for b, bound in enumerate(self.bucket_bounds)]
        else:
            groups = [(order, None)]
        for members, bound in groups:
            for start in range(0, len(members), self.batch_size):
                idx = members[start:start + self.batch_size]
                nvalid = len(idx)
                if nvalid < self.batch_size:
                    if self.drop_last:
                        continue
                    idx = np.concatenate(
                        [idx, np.full(self.batch_size - nvalid, idx[0])])
                plan.append((idx, nvalid, bound))
        if self.length_bucket and self.shuffle:    # interleave the buckets
            self.rng.shuffle(plan)
        for idx, nvalid, bound in plan:
            yield self._finish(idx, nvalid, bound)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate with background prefetch (a daemon thread and a bounded
        queue). Abandoning the iterator stops the producer."""
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self._batches():
                    if not put(b):
                        return
            except BaseException as e:   # surface worker errors to the consumer
                error.append(e)
            finally:
                put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()


# bookkeeping entries that stay host values: consumers read them on the host
# (``int(batch.pop("nvalid"))``, the sample ids)
_BOOKKEEPING = ("nvalid", "id")


def prefetch_to_device(iterator, device, size: int = 2,
                       keys: Optional[Sequence[str]] = None):
    """Wrap a host-batch iterator so that the copies to ``device`` run ahead
    of the consumer, ``size`` batches deep.

    The entries named by ``keys`` (without ``keys``: every array entry but
    the bookkeeping ``nvalid`` and ``id``) become torch tensors on
    ``device``; the others pass through as they are, on the host. On a CUDA
    device each entry is staged in pinned host memory and copied with
    ``non_blocking`` on a side stream; a batch is handed out only after the
    consumer's stream waits on the event that ends its copies, and its
    tensors are recorded on that stream, so nothing synchronises the host.
    On the CPU the batches pass through as tensors.
    """
    import collections

    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def wanted(k, v):
        if keys is not None:
            return k in keys
        return k not in _BOOKKEEPING and np.ndim(v) > 0

    def put(batch):
        out = dict(batch)
        if not cuda:
            for k, v in batch.items():
                if wanted(k, v):
                    out[k] = torch.as_tensor(np.asarray(v))
            return out, None, None
        pinned = []
        with torch.cuda.stream(side):
            for k, v in batch.items():
                if wanted(k, v):
                    host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    pinned.append(host)
                    out[k] = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, done, pinned       # pinned buffers live until handed out

    def hand_out(item):
        out, done, _ = item
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for k, v in out.items():
                if torch.is_tensor(v) and v.device.type == "cuda":
                    v.record_stream(stream)
        return out

    queue_ = collections.deque()
    for batch in iterator:
        queue_.append(put(batch))
        if len(queue_) >= size:
            yield hand_out(queue_.popleft())
    while queue_:
        yield hand_out(queue_.popleft())
