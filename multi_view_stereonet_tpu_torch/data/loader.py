"""Batch assembly + background prefetch.

The reference used torch DataLoader worker processes (num_workers 4,
params.yaml:19); here a single background thread decodes/assembles the
next batches while the device computes (sample decode is jpg + npy IO).

Batches are numpy dicts with *static* shapes:
  left_image (B, H, W, 3), right_images (B, V, H, W, 3), K (B, 4, 4),
  T_right_in_left (B, V, 4, 4), left_depthmap_true (B, H, W),
  right_depthmap_true (B, V, H, W)  [when GT present]
matching ``train.pipeline.multi_view_unpack_batch``.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np


def collate(samples: list) -> dict:
    """Stack transformed samples into a batch dict."""
    batch = {
        "left_image": np.stack([s["left_image"] for s in samples]),
        "right_images": np.stack(
            [np.stack(s["right_images"]) for s in samples]),
        "K": np.stack([np.asarray(s["K"], np.float32) for s in samples]),
        "T_right_in_left": np.stack(
            [np.stack(s["T_right_in_left"]) for s in samples]).astype(np.float32),
        "left_filenames": [s["left_filename"] for s in samples],
        "right_filenames": [s["right_filenames"] for s in samples],
    }
    if "left_depthmap_true" in samples[0]:
        batch["left_depthmap_true"] = np.stack(
            [s["left_depthmap_true"] for s in samples]).astype(np.float32)
    if "right_depthmaps_true" in samples[0]:
        batch["right_depthmap_true"] = np.stack(
            [np.stack(s["right_depthmaps_true"]) for s in samples]).astype(np.float32)
    return batch


class BatchLoader:
    """Iterable over fixed-size batches with optional threaded prefetch.

    Drops the trailing partial batch (static shapes under jit). Epoch
    shuffling is seeded and reshuffles per epoch.

    ``workers`` > 1 decodes samples with a thread pool (bounded
    in-flight window, order-preserving) -- jpg decode + resize dominate
    eval-side wall clock (PIL ~9 ms/sample at 480x640 V=1; the native
    C++ backend is ~20% faster per core and thread-pools internally),
    and PIL/numpy/ctypes release the GIL. Randomized transforms are
    thread-safe via ``transforms.ThreadLocalRng`` (per-thread spawned
    streams): at ``workers=1`` the sample<->draw pairing is
    bit-reproducible run-to-run (each epoch's prefetch thread claims
    the next deterministic child stream); with more workers, pairing is
    scheduling-dependent, same as the reference's 4 torch DataLoader
    worker processes (params.yaml:19).
    """

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 prefetch=2, drop_last=True, workers=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.workers = workers
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Align the shuffle stream with a GLOBAL epoch counter (the torch
        DistributedSampler.set_epoch idiom). Without this, each process
        counts iterations from zero, so a run resumed from an epoch-k
        checkpoint reshuffles epoch k+1 like a fresh epoch 1 and diverges
        from the uninterrupted run's data order. The train CLI calls this
        every epoch, making the order a pure function of (seed, epoch) --
        tests/test_train_cli.py asserts resumed losses match bitwise."""
        self._epoch = epoch

    def _index_order(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            return rng.permutation(n)
        return np.arange(n)

    def _samples(self, order):
        if self.workers <= 1:
            for i in order:
                yield self.dataset[int(i)]
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.workers) as ex:
            inflight = deque()
            it = iter(order)
            for i in it:
                inflight.append(ex.submit(self.dataset.__getitem__, int(i)))
                if len(inflight) >= 2 * self.workers:
                    break
            for i in it:
                yield inflight.popleft().result()
                inflight.append(ex.submit(self.dataset.__getitem__, int(i)))
            while inflight:
                yield inflight.popleft().result()

    def _batches(self):
        order = self._index_order()
        nb = len(self)
        samples = self._samples(order[:nb * self.batch_size])
        for b in range(nb):
            want = min(self.batch_size, len(order) - b * self.batch_size)
            group = [next(samples) for _ in range(want)]
            yield collate(group)

    def __iter__(self):
        self._epoch += 1
        if self.prefetch <= 0:
            yield from self._batches()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure = []
        stop = threading.Event()

        def worker():
            try:
                for batch in self._batches():
                    # Bounded put so an abandoned consumer (a caller
                    # breaking out of the generator, e.g. a serving loop
                    # stopping early) can't leave this thread blocked
                    # forever against a full queue, pinning the prefetch
                    # batches + in-flight decodes.
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised in the consumer
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # Runs on GeneratorExit too: unblock + reap the worker.
            stop.set()
            while True:
                try:
                    if q.get_nowait() is sentinel:
                        break
                except queue.Empty:
                    if not t.is_alive():
                        break
                    time.sleep(0.01)
            t.join()
        if failure:
            # A swallowed loader error would end the epoch early and let
            # eval publish averages over a silently truncated subset
            # (torch DataLoader re-raises worker exceptions; so do we).
            raise failure[0]
