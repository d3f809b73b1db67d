"""Host-side input pipeline (port of ``tvqaplus_tpu/data/pipeline.py``).

A producer thread collates static-shape batches and, for a CUDA device,
pins them in page-locked host memory; the consumer copies each batch to the
device with ``non_blocking`` copies, so the upload of batch i+1 overlaps
the device work of batch i.  Shuffle-off iteration keeps dataset order
(inference, validation).  Shuffled iteration (training) permutes the
examples from a numpy generator seeded with (seed, epoch) and batches each
example with others of its own Li bucket, as the JAX pipeline does.

``group`` > 1 stacks that many same-shape batches on a new leading axis
K, one multi-step dispatch each (the trainer's ``steps_per_dispatch``, the
evaluators' ``eval_steps_per_dispatch``): batches wait in one buffer per
bucket, so full stacks form however the buckets interleave, and what is
left at the end of an epoch comes out as single batches, in bucket order
(JAX pipeline.py:241-270).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from tvqaplus_tpu_torch.data.batching import (
    StaticShapeSpec,
    collate_static,
    pick_bucket,
)


class DataPipeline:
    """Iterable over (device batch dict, meta, Li bucket) tuples.
    ``train``: shuffled bucket batching with the att-entry keys."""

    def __init__(self, dataset, cfg, device, batch_size=16, prefetch_depth=2,
                 train=False, seed=0, group=1):
        self.dataset = dataset
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.prefetch_depth = max(1, prefetch_depth)
        self.train = train
        self.seed = seed
        self.group = max(1, group)
        self.base_spec = StaticShapeSpec.from_config(cfg, batch=batch_size,
                                                     train=train)
        self.buckets = sorted(set(min(b, cfg.max_num_img)
                                  for b in cfg.img_buckets))
        self._epoch = 0

    def __len__(self):
        """Upper bound on batches (optimizer steps, not dispatches) per
        epoch: shuffled bucket batching can end an epoch with one partial
        batch per bucket."""
        base = -(-len(self.dataset) // self.batch_size)
        if self.train:
            base += max(0, len(self.buckets) - 1)
        return base

    def _bucket(self, examples):
        n_img = max((len(ex.get("image_indices", [])) or 1)
                    for ex in examples)
        return pick_bucket(n_img, self.buckets, self.cfg.max_num_img)

    def _batches(self):
        n = len(self.dataset)
        if not self.train:
            for i in range(0, n, self.batch_size):
                examples = [self.dataset[j]
                            for j in range(i, min(n, i + self.batch_size))]
                yield self._collate(examples, self._bucket(examples))
            return
        order = np.arange(n)
        np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        buffers = {}
        for j in order:
            ex = self.dataset[int(j)]
            b = self._bucket([ex])
            buffers.setdefault(b, []).append(ex)
            if len(buffers[b]) == self.batch_size:
                yield self._collate(buffers.pop(b), b)
        for b in sorted(buffers):
            yield self._collate(buffers[b], b)

    def _collate(self, examples, bucket):
        arrays, meta = collate_static(examples,
                                      self.base_spec.with_max_img(bucket))
        n_pos = max(meta["att_n_pos"], default=0)
        if self.train and n_pos > self.cfg.att_entry_cap:
            # the att loss would silently drop the positives past the cap
            raise ValueError(
                f"an example carries {n_pos} positive attention cells > "
                f"att_entry_cap={self.cfg.att_entry_cap}; raise "
                f"--att_entry_cap")
        n_over = max(meta["sub_tok_overflow"], default=0)
        if n_over:
            # dropped tokens would silently diverge from the reference's
            # expanded subtitle windows
            raise ValueError(
                f"an example's subtitle windows need {n_over} more unique "
                f"tokens than max_sub_tokens={self.cfg.max_sub_tokens}; "
                f"raise --max_sub_tokens (or disable --sub_dedup)")
        return arrays, meta, bucket

    def _grouped_batches(self):
        """``group`` same-shape batches stacked on a leading axis K (the
        key: the Li bucket and the first two sizes of the per-batch token
        stream, as JAX's); the leftovers of each buffer come out single,
        buffers in key order."""
        bufs = {}
        for arrays, meta, bucket in self._batches():
            key = (bucket,) + tuple(arrays[k].shape[:2] for k in
                                    ("sub_tokens",) if k in arrays)
            bats, metas = bufs.setdefault(key, ([], []))
            bats.append(arrays)
            metas.append(meta)
            if len(bats) == self.group:
                yield ({k: np.stack([b[k] for b in bats]) for k in bats[0]},
                       {k: sum((m[k] for m in metas), []) for k in metas[0]},
                       bucket)
                bufs.pop(key)
        for key in sorted(bufs):
            for arrays, meta in zip(*bufs[key]):
                yield arrays, meta, key[0]

    def _host(self, arrays):
        pin = self.device.type == "cuda"
        return {k: (torch.from_numpy(v).pin_memory() if pin
                    else torch.from_numpy(v)) for k, v in arrays.items()}

    def __iter__(self):
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        err = []
        stop = threading.Event()

        source = (self._grouped_batches() if self.group > 1
                  else self._batches())

        def producer():
            try:
                for arrays, meta, bucket in source:
                    item = (self._host(arrays), meta, bucket)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 - re-raised in consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                tensors, meta, bucket = item
                yield ({k: v.to(self.device, non_blocking=True)
                        for k, v in tensors.items()}, meta, bucket)
        finally:
            stop.set()
            while t.is_alive():        # drain so the producer can finish
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
