"""Host-side batch loaders with background prefetch.

A copy of `tepose_tpu/data/loaders.py` (`stack_items`, `BatchLoader`,
`get_data_loaders`: train_2d / train_3d / motion_disc / valid), pinned
equal to it by tests/test_torch_train_loop.py. Batches are assembled by a
thread and staged through a prefetch queue; items are numpy.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def stack_items(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items], axis=0)
            for k in items[0].keys()}


class _ProducerFailure:
    """Sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class BatchLoader:
    """Shuffled, infinitely-cycling batch iterator with thread prefetch.

    Multi-process (multi-host pod) sharding: pass ``num_shards`` /
    ``shard_index`` and each process ASSEMBLES only its contiguous
    ``batch_size/num_shards`` slice of every global batch — per-host data
    loading (SURVEY.md §2.6). ``batch_size`` stays the GLOBAL batch size;
    the epoch permutation is drawn from the seed alone, so as long as every
    process constructs the loader with the same seed (they do — seeds come
    from the config), the process-major concatenation of all shards' items
    is bit-identical to the single-process batch
    (tests/test_multiprocess.py pins this).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, drop_last: bool = True,
                 num_shards: int = 1, shard_index: int = 0):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be >= 1, got {batch_size} "
                             "(degenerate 2D/3D batch split?)")
        if not (0 <= shard_index < num_shards):
            raise ValueError(
                f"shard_index {shard_index} out of range for "
                f"{num_shards} shards")
        if batch_size % num_shards:
            raise ValueError(
                f"global batch of {batch_size} rows does not divide across "
                f"{num_shards} processes")
        if num_shards > 1 and not drop_last:
            raise ValueError(
                "sharded loading requires drop_last=True — a ragged final "
                "batch cannot split evenly across processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._rng = np.random.RandomState(seed)
        self._prefetch = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _producer(self) -> None:
        try:
            while not self._stop.is_set():
                order = self._epoch_order()
                nb = len(self)
                per = self.batch_size // self.num_shards
                for b in range(nb):
                    if self._stop.is_set():
                        return
                    sel = order[b * self.batch_size:
                                (b + 1) * self.batch_size]
                    # this process assembles only its contiguous slice of
                    # the global batch (matches the process-major row
                    # layout distributed.put_global expects)
                    sel = sel[self.shard_index * per:
                              (self.shard_index + 1) * per]
                    batch = stack_items([self.dataset[int(i)] for i in sel])
                    self._queue.put(batch)
        except BaseException as e:  # noqa: BLE001
            # a dead producer would leave the consumer blocked on
            # queue.get() forever with no traceback — ship the exception
            # to the consumer instead
            self._queue.put(_ProducerFailure(e))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if len(self) == 0:
            raise ValueError(
                f"dataset of {len(self.dataset)} items cannot fill even one "
                f"batch of {self.batch_size} with drop_last=True — the "
                "consumer would block forever (shrink the batch or grow "
                "the dataset)")
        if self._thread is None:
            self._queue = queue.Queue(maxsize=self._prefetch)
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()
        while True:
            item = self._queue.get()
            if isinstance(item, _ProducerFailure):
                self._thread = None  # a later __iter__ restarts the producer
                raise RuntimeError(
                    "batch producer thread failed while assembling a "
                    "batch") from item.exc
            yield item

    def close(self) -> None:
        self._stop.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass


def get_data_loaders(cfg, db_overrides: Optional[Dict] = None,
                     num_shards: int = 1, shard_index: int = 0):
    """Build (train_2d, train_3d, motion_disc, valid) loaders from a config.

    ref: loaders.py:61-130 — batch split: 2D rows =
    int(BATCH_SIZE * DATA_2D_RATIO), 3D rows = the rest; the discriminator
    loader draws BATCH_SIZE AMASS windows; the valid loader serves
    cfg.TRAIN.DATASET_EVAL whole videos.

    db_overrides maps dataset-name -> (db, psetheta) for tests / preloaded
    data.

    num_shards/shard_index (multi-process runtime,
    parallel/distributed.py): the three TRAIN loaders each assemble only
    this process's batch slice; the valid loader is NOT sharded — every
    process gets the full eval videos, and evaluate-side work splits over
    the global mesh inside jit instead.
    """
    from tepose_tpu_torch.data import datasets as D

    seqlen = cfg.DATASET.SEQLEN
    vidlen = cfg.DATASET.VIDLEN
    load_opt = cfg.TITLE
    over = db_overrides or {}

    def make(name, is_2d):
        kw = {}
        if name.lower() in over:
            kw["db"], kw["psetheta"] = over[name.lower()]
        if is_2d:
            if name == "Insta":
                return D.Insta(load_opt, seqlen, vidlen, **kw)
            if name == "PoseTrack":
                return D.PoseTrack(load_opt, seqlen, vidlen, **kw)
            raise ValueError(f"unknown 2D dataset {name}")
        cls = {"ThreeDPW": D.ThreeDPW, "MPII3D": D.MPII3D,
               "Human36M": D.Human36M}[name]
        return cls(load_opt, "train", seqlen, vidlen, **kw)

    class Concat:
        def __init__(self, parts):
            self.parts = parts
            self.cum = np.cumsum([len(p) for p in parts])

        def __len__(self):
            return int(self.cum[-1])

        def __getitem__(self, i):
            p = int(np.searchsorted(self.cum, i, side="right"))
            off = i - (self.cum[p - 1] if p else 0)
            return self.parts[p][int(off)]

    # truncating int(), not round(): the reference's split recipe
    # (ref: loaders.py:85-86); at 0.55*32 they differ (17 vs 18)
    n_2d = int(cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.DATA_2D_RATIO)
    n_3d = cfg.TRAIN.BATCH_SIZE - n_2d
    if n_2d <= 0 or n_3d <= 0:
        raise ValueError(
            f"degenerate 2D/3D batch split: BATCH_SIZE="
            f"{cfg.TRAIN.BATCH_SIZE} x DATA_2D_RATIO="
            f"{cfg.TRAIN.DATA_2D_RATIO} -> n_2d={n_2d}, n_3d={n_3d}; the "
            "trainer consumes mixed batches, so both must be >= 1")
    if not cfg.TRAIN.DATASETS_2D:
        raise ValueError(
            "TRAIN.DATASETS_2D is empty but the trainer draws "
            f"{n_2d} 2D rows per batch — add a 2D dataset or use a "
            "config with one (all reference configs do)")

    shard_kw = dict(num_shards=num_shards, shard_index=shard_index)
    ds2 = Concat([make(n, True) for n in cfg.TRAIN.DATASETS_2D])
    train_2d = BatchLoader(ds2, n_2d, seed=cfg.SEED_VALUE + 1
                           if cfg.SEED_VALUE >= 0 else 1, **shard_kw)

    ds3 = Concat([make(n, False) for n in cfg.TRAIN.DATASETS_3D])
    train_3d = BatchLoader(ds3, n_3d, seed=cfg.SEED_VALUE + 2
                           if cfg.SEED_VALUE >= 0 else 2, **shard_kw)

    amass_kw = {}
    if "amass" in over:
        amass_kw["db"] = over["amass"][0]
    disc = BatchLoader(D.AMASS(seqlen, **amass_kw), cfg.TRAIN.BATCH_SIZE,
                       seed=cfg.SEED_VALUE + 3 if cfg.SEED_VALUE >= 0 else 3,
                       **shard_kw)

    eval_name = cfg.TRAIN.DATASET_EVAL
    eval_kw = {}
    if eval_name.lower() in over:
        eval_kw["db"], eval_kw["psetheta"] = over[eval_name.lower()]
    valid_ds = {"ThreeDPW": D.ThreeDPW, "MPII3D": D.MPII3D,
                "Human36M": D.Human36M,
                "Human36M_VAL": D.Human36M}[eval_name](
        load_opt, "val", seqlen, vidlen, **eval_kw)
    valid = BatchLoader(valid_ds, batch_size=min(len(valid_ds), 8),
                        shuffle=False, drop_last=False)

    return train_2d, train_3d, disc, valid
