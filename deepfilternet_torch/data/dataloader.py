"""Multi-worker prefetching dataloader (reference: libDF/src/dataloader.rs),
the port's copy of `deepfilternet_tpu.data.dataloader`; batches stay numpy
(`train/run.py` moves them to the device).

Mirrors the reference's execution model with host-side Python threads in
place of the rayon pool (the heavy inner loops — codec decode, biquads,
FFTs — run in native code or NumPy, which release the GIL):

  * worker pool pulls sample indices from an input queue;
  * bounded output queue provides prefetch back-pressure;
  * ordered reassembly buffer keyed on batch index gives deterministic
    batch composition regardless of worker completion order
    (dataloader.rs:385-426);
  * epoch-seeded determinism: sample seed = epoch_seed + idx for train,
    idx for eval (dataloader.rs:270-278); overfit mode pins epoch_seed=0;
  * Collate pads to the longest sample and stacks (dataloader.rs:484-548).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclass
class Batch:
    speech: np.ndarray       # [B, C, T]
    noisy: np.ndarray        # [B, C, T]
    spec_clean: np.ndarray   # [B, C, T', F] complex64
    spec_noisy: np.ndarray   # [B, C, T', F] complex64
    feat_erb: np.ndarray     # [B, C, T', E]
    feat_spec: np.ndarray    # [B, C, T', F'] complex64
    lengths: np.ndarray      # [B] samples
    max_freq: np.ndarray     # [B]
    snr: np.ndarray          # [B]
    gain: np.ndarray         # [B]
    ids: np.ndarray          # [B]


def collate(samples: List[Dict]) -> Batch:
    """Pad to the longest sample and stack, keeping every audio channel
    (dataloader.rs:484-548 stacks [B, C, T, F]; C is 1 for mono corpora)."""
    max_t = max(s["speech"].shape[-1] for s in samples)
    max_tf = max(s["spec_clean"].shape[-2] for s in samples)

    def pad_td(key):
        out = np.zeros((len(samples), samples[0][key].shape[0], max_t), np.float32)
        for i, s in enumerate(samples):
            out[i, :, : s[key].shape[-1]] = s[key]
        return out

    def pad_fd(key, dtype):
        c, _, f = samples[0][key].shape
        out = np.zeros((len(samples), c, max_tf, f), dtype)
        for i, s in enumerate(samples):
            x = s[key]  # [C, T', F]
            out[i, :, : x.shape[1]] = x
        return out

    return Batch(
        speech=pad_td("speech"),
        noisy=pad_td("noisy"),
        spec_clean=pad_fd("spec_clean", np.complex64),
        spec_noisy=pad_fd("spec_noisy", np.complex64),
        feat_erb=pad_fd("feat_erb", np.float32),
        feat_spec=pad_fd("feat_spec", np.complex64),
        lengths=np.array([s["speech"].shape[-1] for s in samples], np.int64),
        max_freq=np.array([s["max_freq"] for s in samples], np.int64),
        snr=np.array([s["snr"] for s in samples], np.int8),
        gain=np.array([s["gain"] for s in samples], np.int8),
        ids=np.array([s["idx"] for s in samples], np.int64),
    )


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 4,
        prefetch: int = 4,
        drop_last: bool = False,
        overfit: bool = False,
        batch_size_eval: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.batch_size_eval = batch_size_eval or batch_size
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.overfit = overfit

    def set_batch_size(self, batch_size: int, split: str = "train"):
        if split == "train":
            self.batch_size = batch_size
        else:
            self.batch_size_eval = batch_size

    def len_of(self, split: str) -> int:
        bs = self.batch_size if split == "train" else self.batch_size_eval
        n = len(self.dataset)
        return n // bs if self.drop_last else -(-n // bs)

    def iter_epoch(self, split: str, seed: int) -> Iterator[Batch]:
        """Deterministic epoch iteration (dataloader.rs:297-458)."""
        epoch_seed = 0 if self.overfit else seed
        # per-epoch fractional sampling regeneration (dataset.rs:1397-1451)
        td = getattr(self.dataset, "td", self.dataset)
        if split == "train" and getattr(td, "_has_fractional", False):
            td.set_epoch(epoch_seed)
        n = len(self.dataset)
        bs = self.batch_size if split == "train" else self.batch_size_eval
        order_rng = np.random.default_rng(epoch_seed)
        indices = np.arange(n)
        if split == "train":
            order_rng.shuffle(indices)
        batches = [indices[i : i + bs] for i in range(0, n, bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()

        in_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        for bi, idxs in enumerate(batches):
            in_q.put((bi, idxs))
        stop = threading.Event()

        def seed_for(idx: int) -> int:
            # train: epoch_seed + idx; eval: idx (dataloader.rs:270-278)
            return epoch_seed + int(idx) if split == "train" else int(idx)

        from deepfilternet_torch.utils.timings import GLOBAL_TIMINGS

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = in_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    with GLOBAL_TIMINGS.timed("dataloader/sample"):
                        samples = [self.dataset.get_sample(int(i), seed_for(i))
                                   for i in idxs]
                    with GLOBAL_TIMINGS.timed("dataloader/collate"):
                        batch = collate(samples)
                    out_q.put((bi, batch))
                except Exception as e:  # surfaced on the consumer side
                    out_q.put((bi, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        # ordered reassembly (dataloader.rs:385-426)
        pending: Dict[int, Batch] = {}
        next_bi = 0
        try:
            while next_bi < len(batches):
                while next_bi not in pending:
                    bi, item = out_q.get(timeout=100.0)
                    if isinstance(item, Exception):
                        raise item
                    pending[bi] = item
                yield pending.pop(next_bi)
                next_bi += 1
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)
