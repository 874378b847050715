"""Data pipeline (mirrors ``paddle_tpu/io/__init__.py``; reference:
python/paddle/io/ — Dataset/DataLoader, fluid/reader.py:149).

A pure-Python copy of the reference's loader: the datasets
(``Dataset``, ``IterableDataset``, ``TensorDataset``, ``Subset``,
``ConcatDataset``, ``ChainDataset``, ``ComposeDataset``,
``random_split``), the samplers (sequence, random, weighted random,
batch, distributed batch), ``default_collate_fn`` and ``DataLoader``
with ``num_workers`` 0 (batches made on the caller's thread) or > 0 (a
pool of loader threads, batches delivered in order;
``get_worker_info``). The random samplers and ``random_split`` draw from
``core.rng._numpy_generator``, which ``seed(n)`` reseeds as the
reference's, so the shuffled batches are the reference's index for
index.

The loader yields torch tensors on its ``device`` (the card unless the
caller names another): ``default_collate_fn`` stacks on the host, and
each batch's tensors are moved as the consumer takes it. The reference's
C++ array engine (``io/native_engine.py``) is ROADMAP queue 1 item 9f:
``use_native_engine`` is accepted and every batch takes the Python path
(for a shuffled ``TensorDataset`` the reference's engine, where its
library is built, draws another order than its Python path).
"""
from __future__ import annotations

import queue
import threading
import weakref
from typing import List

import numpy as np
import torch

from ..core import rng
from ..core.place import resolve_device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "ConcatDataset", "ChainDataset", "ComposeDataset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "default_collate_fn", "get_worker_info", "WorkerInfo",
           "DataLoader", "synthetic_optin"]

_TODO_NATIVE = ("the C++ array engine of the data loader is not ported "
                "yet: ROADMAP queue 1 item 9f")


class Dataset:
    """Map-style dataset (reference: python/paddle/io/dataset.py)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


def synthetic_optin(cls_name: str, synthetic_size, default: int) -> int:
    """Synthetic data is OPT-IN across every dataset family (a typo'd
    path must not silently train on fake data).
    Without a real data file, callers must pass synthetic_size=N
    explicitly to acknowledge the corpus is synthetic."""
    if synthetic_size is None:
        raise ValueError(
            f"{cls_name}: no data_file was given and downloading is not "
            "possible here. Pass data_file=<path to the real dataset "
            "archive>, or explicitly opt in to a deterministic FAKE "
            f"corpus with synthetic_size=N (e.g. {default}) for "
            "tests/smoke runs.")
    return int(synthetic_size)


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: List):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ComposeDataset(Dataset):
    """Zip same-length datasets: sample i concatenates the fields of
    every dataset's sample i (reference: fluid/dataloader/dataset.py
    ComposeDataset)."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError("datasets cannot be empty")
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        for d in self.datasets[1:]:
            if len(d) != n:
                raise ValueError("ComposeDataset datasets must share "
                                 "one length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            s = d[idx]
            out.extend(s if isinstance(s, (tuple, list)) else [s])
        return tuple(out)


def random_split(dataset, lengths, generator=None):
    idx = rng._numpy_generator.permutation(len(dataset))
    out, ofs = [], 0
    for ln in lengths:
        out.append(Subset(dataset, idx[ofs:ofs + ln].tolist()))
        ofs += ln
    return out


# -- samplers ---------------------------------------------------------------
class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(rng._numpy_generator.randint(
                0, n, self.num_samples).tolist())
        return iter(rng._numpy_generator.permutation(n)[
            :self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(rng._numpy_generator.choice(
            len(self.weights), self.num_samples, self.replacement,
            p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """reference: python/paddle/io/batch_sampler.py"""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = bool(shuffle)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """reference: python/paddle/io/dataloader/batch_sampler.py
    DistributedBatchSampler — shards the index space across data-parallel
    ranks; the rank and world size default to the process group's."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed.env import get_rank, get_world_size

        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else \
            get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            r = np.random.RandomState(self.epoch)
            indices = r.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - n)]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


# -- collate ----------------------------------------------------------------
def default_collate_fn(batch):
    """Stack a list of samples field by field: numpy arrays, tensors and
    numbers into one torch tensor (on the host), tuples, lists and dicts
    recursively."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(list(batch))
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _to_device(batch, device):
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    return batch


class WorkerInfo:
    """Per-worker context visible inside an IterableDataset.__iter__
    (reference: fluid/reader.py worker loop sets a module-global
    _worker_info; public API paddle.io.get_worker_info). A
    sharding-aware iterable dataset reads ``id``/``num_workers`` and
    yields only its split; a naive dataset iterated by N workers yields
    every sample N times — same contract as the reference."""

    def __init__(self, id, num_workers, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_tls = threading.local()


def get_worker_info():
    """Inside a DataLoader worker: that worker's WorkerInfo; None in the
    main thread (reference: paddle.io.get_worker_info)."""
    return getattr(_worker_tls, "info", None)


class _PoolState:
    """Shared state of a DataLoader worker pool. Lives OUTSIDE the
    iterator so worker threads never hold a strong reference to it —
    otherwise an abandoned iterator could never be garbage-collected
    (threads are GC roots) and its pool would leak forever."""

    END = object()

    def __init__(self, nw, prefetch):
        self.nw = nw
        self.stop = threading.Event()
        self.cond = threading.Condition()
        self.results = {}
        self.dispatched = 0
        self.dispatch_done = False
        # iterable mode: per-worker produced-batch counts, recorded when
        # each worker's stream ends. Worker w's k-th batch is published at
        # seq k*nw + w (round-robin interleave — deterministic delivery
        # order); the consumer skips seqs that can never arrive.
        self.worker_counts = {}
        self.inflight = threading.Semaphore(prefetch * nw)
        # iterable mode: per-worker backpressure. A shared semaphore
        # would deadlock: a fast worker could hold every permit while the
        # consumer waits (in round-robin order) on a slow worker that is
        # itself parked in acquire().
        self.worker_sems = [threading.Semaphore(prefetch)
                            for _ in range(nw)]
        self.work_q = queue.Queue()
        # iterable mode: worker 0 probes whether the dataset is its own
        # iterator (shared cursor) and publishes the verdict here; the
        # other workers wait on the event before touching the dataset.
        self.probe_event = threading.Event()
        self.probe_single_stream = False

    def publish(self, seq, item):
        with self.cond:
            self.results[seq] = item
            self.cond.notify_all()

    def finish_dispatch(self, count):
        with self.cond:
            self.dispatched = count
            self.dispatch_done = True
            self.cond.notify_all()
        for _ in range(self.nw):
            self.work_q.put((None, self.END))

    def finish_worker(self, wid, count):
        with self.cond:
            self.worker_counts[wid] = count
            if len(self.worker_counts) == self.nw:
                self.dispatch_done = True
            self.cond.notify_all()

    def shutdown(self):
        """Idempotent: unblock the dispatcher (parked in acquire) and the
        workers (parked in get) so every pool thread exits."""
        if self.stop.is_set():
            return
        self.stop.set()
        for _ in range(self.nw + 1):
            self.inflight.release()
        for sem in self.worker_sems:
            sem.release()
        for _ in range(self.nw):
            self.work_q.put((None, self.END))
        self.probe_event.set()           # unblock workers awaiting probe
        with self.cond:
            self.cond.notify_all()


def _pool_dispatch(state, index_iter):
    seq = 0
    try:
        for indices in index_iter:
            state.inflight.acquire()
            if state.stop.is_set():
                break
            state.work_q.put((seq, indices))
            seq += 1
    finally:
        state.finish_dispatch(seq)


def _pool_map_worker(state, dataset, collate_fn):
    while not state.stop.is_set():
        seq, indices = state.work_q.get()
        if indices is state.END:
            break
        try:
            state.publish(seq, collate_fn([dataset[i] for i in indices]))
        except BaseException as e:       # re-raised in the consumer
            state.publish(seq, e)


def _pool_iterable_worker(state, dataset, collate_fn, batch_size,
                          drop_last, wid):
    """One of nw streams over an IterableDataset. Exposes WorkerInfo so
    sharding-aware datasets yield their split (reference
    fluid/reader.py:91 worker semantics); publishes its k-th batch at
    seq k*nw + wid."""
    _worker_tls.info = WorkerInfo(wid, state.nw, dataset)
    k = 0
    try:
        # A dataset that is its own iterator (iter(ds) returns ds) holds
        # ONE shared cursor, which N threads cannot drive safely (a
        # generator would raise "already executing"; a stateful __next__
        # would lose samples) — and such datasets often RESET the cursor
        # in __iter__, so a late worker merely *calling* iter() would
        # clobber worker 0's in-progress iteration. Probe exactly once:
        # worker 0 calls iter() and publishes the verdict via an Event;
        # workers 1..N-1 wait for it and bail out (single-stream
        # fallback) when the dataset is a self-iterator. Datasets whose
        # __iter__ returns fresh independent iterators keep the full
        # N-stream parallelism.
        if wid == 0:
            state.probe_single_stream = True   # pessimistic until probed
            try:
                it = iter(dataset)
                state.probe_single_stream = it is dataset
            finally:
                state.probe_event.set()
        else:
            state.probe_event.wait()
            if state.probe_single_stream or state.stop.is_set():
                return
            it = iter(dataset)
        while not state.stop.is_set():
            # draw via next(): islice would call iter(it) per batch,
            # re-triggering a cursor-resetting __iter__ every batch
            batch = []
            try:
                while len(batch) < batch_size:
                    batch.append(next(it))
            except StopIteration:
                pass
            if not batch or (drop_last and len(batch) < batch_size):
                break
            state.worker_sems[wid].acquire()
            if state.stop.is_set():
                break
            state.publish(k * state.nw + wid, collate_fn(batch))
            k += 1
    except BaseException as e:
        state.publish(k * state.nw + wid, e)
        k += 1
    finally:
        state.finish_worker(wid, k)


class _DataLoaderIter:
    """num_workers > 0: a POOL of num_workers loader threads (the
    reference runs N worker processes, fluid/reader.py:91; threads here —
    numpy/host IO releases the GIL).
    Batches are delivered IN ORDER via per-batch sequence numbers and a
    reorder buffer, with at most prefetch_factor×workers in flight.
    Iterable datasets run num_workers independent streams: each worker
    iterates its own iter(dataset) with WorkerInfo exposed via
    get_worker_info() (reference fluid/reader.py:91 per-worker-process
    semantics) — sharding-aware datasets yield their split, and batches
    interleave round-robin deterministically. Threads reference only the
    _PoolState; a weakref.finalize shuts the pool down when the iterator
    is dropped (early break / exception) so no thread ever leaks."""

    def __init__(self, loader):
        self.loader = loader
        self._index_iter = iter(loader.batch_sampler) \
            if not loader._iterable_mode else None
        self._state = None
        self._next_seq = 0
        if loader.num_workers > 0:
            nw = loader.num_workers
            st = _PoolState(nw, max(2, loader.prefetch_factor))
            self._state = st
            self._finalizer = weakref.finalize(self, _PoolState.shutdown,
                                               st)
            if loader._iterable_mode:
                threads = [threading.Thread(
                    target=_pool_iterable_worker,
                    args=(st, loader.dataset, loader.collate_fn,
                          loader.batch_size, loader.drop_last, w),
                    daemon=True) for w in range(nw)]
            else:
                threads = [threading.Thread(
                    target=_pool_map_worker,
                    args=(st, loader.dataset, loader.collate_fn),
                    daemon=True) for _ in range(nw)]
                threads.append(threading.Thread(
                    target=_pool_dispatch, args=(st, self._index_iter),
                    daemon=True))
            for t in threads:
                t.start()

    def _load_batch(self, indices):
        samples = [self.loader.dataset[i] for i in indices]
        return self.loader.collate_fn(samples)

    def __next__(self):
        st = self._state
        iterable = self.loader._iterable_mode
        if st is not None:
            with st.cond:
                while True:
                    if self._next_seq in st.results:
                        item = st.results.pop(self._next_seq)
                        self._next_seq += 1
                        break
                    if iterable:
                        # worker streams end at different k's: skip seqs a
                        # finished worker can never publish; stop when
                        # every worker is done and no published seq is
                        # left at/after next_seq
                        w = self._next_seq % st.nw
                        k = self._next_seq // st.nw
                        if w in st.worker_counts and \
                                k >= st.worker_counts[w]:
                            if len(st.worker_counts) == st.nw and not any(
                                    s >= self._next_seq
                                    for s in st.results):
                                raise StopIteration
                            self._next_seq += 1
                            continue
                    elif st.dispatch_done and \
                            self._next_seq >= st.dispatched:
                        raise StopIteration
                    st.cond.wait()
            if iterable:
                st.worker_sems[(self._next_seq - 1) % st.nw].release()
            else:
                st.inflight.release()
            if isinstance(item, BaseException):
                st.shutdown()
                raise item
            return item
        if self.loader._iterable_mode:
            if not hasattr(self, "_raw_iter"):
                self._raw_iter = iter(self.loader.dataset)
            # draw via next(): islice would call iter() on the stream per
            # batch, restarting datasets whose __iter__ resets a shared
            # cursor (same hazard as the worker-pool path)
            batch = []
            try:
                while len(batch) < self.loader.batch_size:
                    batch.append(next(self._raw_iter))
            except StopIteration:
                pass
            if not batch or (self.loader.drop_last and
                             len(batch) < self.loader.batch_size):
                raise StopIteration
            return self.loader.collate_fn(batch)
        return self._load_batch(next(self._index_iter))

    def close(self):
        if self._state is not None:
            self._state.shutdown()

    def __iter__(self):
        return self


class _NativeIterAdapter:
    """The reference's adapter over its C++ array engine (ROADMAP queue 1
    item 9f)."""

    def __init__(self, nat):
        raise NotImplementedError(_TODO_NATIVE)


class _DeviceIter:
    """The batches of ``it``, moved to ``device`` as they are taken."""

    def __init__(self, it, device):
        self._it, self._device = it, device

    def __iter__(self):
        return self

    def __next__(self):
        return _to_device(next(self._it), self._device)

    def close(self):
        self._it.close()


class DataLoader:
    """reference: fluid/reader.py DataLoader(:149). Batches of torch
    tensors on ``device`` (default the card). ``num_workers > 0``: a pool
    of loader threads, batches in order (``_DataLoaderIter``)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 use_native_engine=True, device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.collate_fn = collate_fn or default_collate_fn
        self.use_native_engine = use_native_engine
        self.device = resolve_device(device)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if not self._iterable_mode:
            self.batch_sampler = batch_sampler or BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_sampler = None

    def __iter__(self):
        return _DeviceIter(_DataLoaderIter(self), self.device)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)
