"""Batch loader with background prefetch (thread or process workers).

The port's own copy of pytorch3dunet_tpu/datasets/loader.py.

Replaces the reference's multi-process torch DataLoader
(pytorch3dunet/datasets/utils.py:408-422). Two worker modes:

- 'thread': zero-copy handoff to the trainer's host-to-device copy; right
  for cheap pipelines (test-time Standardize+ToTensor, light augmentation).
- 'process': fork workers that each hold their own dataset replica; right for
  the heavy scipy augmentations (ElasticDeformation ~1-3 s/patch holds the
  GIL, so threads serialize — measured 0.8 Mvox/s single-thread and *worse*
  with more threads, vs a ~20 Mvox/s device appetite).

The default is chosen per loader: processes when num_workers > 1 and the
platform supports fork, threads otherwise (`worker_mode` overrides).
"""

import math
import sys
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

# Fork-inherited dataset registry: the parent registers the (pre-loaded)
# dataset here BEFORE creating the executor, and forked workers look it up by
# key. With the 'fork' start method the registry (and the loaded numpy
# volumes) arrive in the child via copy-on-write pages — no pickling, and all
# workers SHARE the parent's volume memory instead of each loading a copy.
_FORK_DATASETS: dict = {}
_WORKER_DATASET = None


def _init_process_worker(key, base_seed, worker_id):
    global _WORKER_DATASET
    _WORKER_DATASET = _FORK_DATASETS[key]
    # decorrelate augmentations across workers: reseed the global RNGs AND
    # the fork-copied per-transform RandomStates (every worker would
    # otherwise replay the identical draw sequence). The raw and label
    # pipelines of a dataset get the SAME seed so paired geometric
    # transforms stay in lockstep. Seeds derive from base_seed + the worker
    # INDEX (not the pid): with `manual_seed` set, augmentation is
    # reproducible run-to-run — torch's DataLoader semantics
    # (base_seed + worker_id), which the reference's determinism relies on.
    seed = (base_seed + 7919 * (worker_id + 1)) % (2**31)
    np.random.seed(seed)
    import random as _stdlib_random

    _stdlib_random.seed(seed)  # GaussianBlur3D draws from the stdlib module
    for ds_index, ds in enumerate(getattr(_WORKER_DATASET, "datasets", [_WORKER_DATASET])):
        # distinct seed per dataset (the parent seeded each Transformer
        # differently too); raw/label pipelines of ONE dataset share a seed
        # so paired geometric transforms stay in lockstep
        ds_seed = (seed + 1 + 101 * ds_index) % (2**31)
        for name in ("raw_transform", "label_transform", "weight_transform"):
            t = getattr(ds, name, None)
            if t is not None and hasattr(t, "reseed"):
                t.reseed(ds_seed)
        scaler = getattr(ds, "random_scaler", None)
        if scaler is not None and hasattr(scaler, "rs"):
            scaler.rs.seed((ds_seed + 1) % (2**31))


def _process_fetch(indices):
    return [_WORKER_DATASET[int(i)] for i in indices]


class ConcatDataset:
    """Concatenation of several datasets (torch ConcatDataset analog)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert self.datasets, "datasets should not be an empty iterable"
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def locate(self, idx):
        """Maps a global index to (member dataset, local index)."""
        if idx < 0:
            idx += len(self)
        dataset_idx = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        sample_idx = idx if dataset_idx == 0 else idx - self.cumulative_sizes[dataset_idx - 1]
        return self.datasets[dataset_idx], sample_idx

    def __getitem__(self, idx):
        ds, sample_idx = self.locate(idx)
        return ds[sample_idx]


def default_collate(batch):
    """Stacks array samples; recursively transposes tuple samples."""
    first = batch[0]
    if isinstance(first, np.ndarray):
        return np.stack(batch, 0)
    if isinstance(first, (int, float)):
        return np.asarray(batch)
    if isinstance(first, (list, tuple)):
        return [default_collate(list(samples)) for samples in zip(*batch)]
    raise TypeError(f"unsupported sample type: {type(first)}")


class DataLoader:
    """Iterates a dataset in batches, fetching batches ahead in worker threads.

    API mirrors the subset of torch's DataLoader the framework needs:
    `len(loader)` is the number of batches; iteration yields collated batches.
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=1, collate_fn=None,
                 drop_last=False, prefetch_batches=None, seed=None, worker_mode=None,
                 max_batches=None, shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        # (index, count): yield only part `index` of `count` equal parts of
        # each batch (one rank's share of its host's batch, whose order every
        # rank of the host draws alike from the same seed)
        if shard is not None and batch_size % shard[1]:
            raise ValueError(f"a batch of {batch_size} does not split into {shard[1]} equal parts")
        self.shard = shard
        self.shuffle = shuffle
        self.num_workers = max(1, int(num_workers))
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        # cap on batches per epoch: multi-host training truncates every host
        # to the GLOBAL minimum so each collective train step has all hosts
        self.max_batches = max_batches
        if prefetch_batches is None:
            prefetch_batches = self.num_workers + 2
        assert prefetch_batches >= 1, "prefetch_batches must be >= 1 (the fetch window drives iteration)"
        self.prefetch_batches = prefetch_batches
        if seed is None:
            # derive from the global RNG so `manual_seed` makes shuffling
            # deterministic (reference parity with torch's seeded generators)
            seed = int(np.random.randint(0, 2**31 - 1))
        self._seed = seed
        self._epoch = None
        self._rng = np.random.RandomState(seed)
        # base seed for process-worker augmentation RNGs (manual_seed-driven)
        self._worker_base_seed = int(np.random.randint(0, 2**31 - 1))
        if worker_mode is None:
            worker_mode = "process" if (self.num_workers > 1 and sys.platform.startswith("linux")) else "thread"
        assert worker_mode in ("thread", "process")
        self.worker_mode = worker_mode
        self._executor = None
        # thread mode with >1 worker: the seed-paired raw/label transform
        # pipelines share per-transform RandomState objects, so concurrent
        # __getitem__ calls on the SAME dataset would interleave their draws
        # and silently break raw/label geometric alignment. One lock per
        # underlying dataset (transform state is per-dataset): fetches from
        # different datasets of a ConcatDataset still overlap their H5
        # reads/augmentation, only same-dataset access serializes.
        import threading

        if worker_mode == "thread" and self.num_workers > 1:
            # per-member locks require locate() to resolve global->member
            # indices; any other dataset type gets one lock on itself
            members = getattr(dataset, "datasets", None) if hasattr(dataset, "locate") else None
            self._lock_members = members is not None
            self._ds_locks = {id(ds): threading.Lock() for ds in (members or [dataset])}
        else:
            self._lock_members = False
            self._ds_locks = None

    def _get_executor(self):
        """Worker pool(s), created once and reused across epochs (the reference
        re-forks per epoch via torch's persistent_workers=False default; we
        keep workers alive — forking 32 processes per epoch is pure waste).

        Process mode uses N single-worker pools and round-robins batches over
        them (torch's batch->worker assignment): together with the indexed
        worker seeds this makes augmentation reproducible run-to-run under
        `manual_seed`. A shared pool would hand batches to whichever worker
        frees up first — a scheduling-dependent RNG-stream consumption order.
        """
        if self._executor is not None:
            return self._executor
        if self.worker_mode == "process":
            import multiprocessing

            # load volumes in the parent first: forked workers then share the
            # arrays via copy-on-write instead of each reading its own copy
            for ds in getattr(self.dataset, "datasets", [self.dataset]):
                if hasattr(ds, "preload"):
                    ds.preload()
            key = id(self)
            _FORK_DATASETS[key] = self.dataset
            ctx = multiprocessing.get_context("fork")
            self._executor = [
                ProcessPoolExecutor(
                    max_workers=1,
                    mp_context=ctx,
                    initializer=_init_process_worker,
                    initargs=(key, self._worker_base_seed, worker_id),
                )
                for worker_id in range(self.num_workers)
            ]
        else:
            self._executor = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="loader")
        return self._executor

    def __del__(self):
        executor = getattr(self, "_executor", None)
        for ex in executor if isinstance(executor, list) else ([executor] if executor else []):
            ex.shutdown(wait=False, cancel_futures=True)
        _FORK_DATASETS.pop(id(self), None)

    def __len__(self):
        n = len(self.dataset)
        nb = n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)
        if self.max_batches is not None:
            nb = min(nb, self.max_batches)
        return nb

    def set_epoch(self, epoch: int):
        """Epoch-keyed deterministic shuffling (the torch
        DistributedSampler.set_epoch analogue): once called, the epoch's
        permutation is a pure function of (seed, epoch) instead of the
        stateful RNG stream, so a run resumed from a checkpoint replays the
        SAME batch order the uninterrupted run used at that epoch — required
        for bit-identical checkpoint/resume trajectories (the trainer calls
        this at the top of every epoch)."""
        self._epoch = int(epoch)

    def _batch_indices(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            if self._epoch is not None:
                rng = np.random.RandomState((self._seed + 0x9E3779B1 * (self._epoch + 1)) % (2**31 - 1))
            else:
                rng = self._rng
            rng.shuffle(indices)
        nb = len(self)
        for b in range(nb):
            batch = indices[b * self.batch_size : (b + 1) * self.batch_size]
            if self.shard is not None:
                index, count = self.shard
                per = len(batch) // count
                batch = batch[index * per : (index + 1) * per]
            yield batch

    def _get_item(self, idx: int):
        if self._ds_locks is None:
            return self.dataset[idx]
        # the dispatch decision was fixed at construction: per-member locks
        # via locate(), or one lock on the dataset itself
        if self._lock_members:
            ds, local_idx = self.dataset.locate(idx)
        else:
            ds, local_idx = self.dataset, idx
        with self._ds_locks[id(ds)]:
            return ds[local_idx]

    def _fetch(self, batch_idx):
        items = [self._get_item(int(i)) for i in batch_idx]
        return self.collate_fn(items)

    def __iter__(self):
        batches = enumerate(self._batch_indices())
        executor = self._get_executor()
        if self.worker_mode == "process":
            # batch b -> worker b % num_workers: deterministic assignment
            submit = lambda b, idx: executor[b % self.num_workers].submit(  # noqa: E731
                _process_fetch, list(map(int, idx)))
            finalize = self.collate_fn  # collate in the parent (results are raw samples)
        else:
            submit = lambda b, idx: executor.submit(self._fetch, idx)  # noqa: E731
            finalize = None

        window: deque = deque()
        try:
            for _ in range(self.prefetch_batches):
                window.append(submit(*next(batches)))
        except StopIteration:
            pass
        while window:
            result = window.popleft().result()
            try:
                window.append(submit(*next(batches)))
            except StopIteration:
                pass
            yield finalize(result) if finalize is not None else result
