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
shape, so full stacks form however the buckets interleave, and what is
left at the end of an epoch comes out as single batches, in key order
(JAX pipeline.py:241-270).

Three batch layouts cut the bytes each batch moves to the card (JAX
pipeline.py:62-91):

* ``sub_token_buckets``: a batch's subtitle token stream takes the
  smallest St bucket covering its examples' unique tokens instead of the
  ``max_sub_tokens`` cap (the sub_dedup contract only; the values are the
  fixed-cap batch's first St slots);
* the host cast: under ``compute_dtype == "bfloat16"`` the large feature
  arrays (``BF16_KEYS``) are cast to bfloat16 on the producer thread before
  they are pinned (torch's cast rounds to nearest even: bit for bit JAX's
  ``ml_dtypes`` cast on every value but NaN, whose payload differs);
* ``video_dedup`` (serving only): each unique clip's ``vid`` /
  ``sub_tokens`` / ``sub_bert`` ships once a batch (``*_u``, U rows, the
  smallest ``video_buckets`` entry covering the batch) with ``ex_vid``,
  each example's row; the serve step gathers them back on the card
  (infer/predict.py ``expand_video_dedup``).

On a mesh (``mesh``, parallel/mesh.py) ``batch_size`` is the global batch
of the data axis.  Every rank makes every shape decision on the global
batch, the same on each: the shuffle order, the Li bucket, the St bucket
and the K-grouping, so all ranks run one sequence of dispatch shapes (a
rank that ran another shape would wait forever in a collective).  Then
each rank collates only its data row's rows ``[d b, (d + 1) b)`` of it, at
batch ``b``, and keeps its ctx rank's frames ``[c l, (c + 1) l)`` of the
Li-sharded keys (``LI_KEYS``, the layout of ``shard_batch``); its ``meta``
holds those rows.  An Li bucket that ctx does not divide raises.
``video_dedup`` is single-process (as in JAX pipeline.py:83-88).
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from tvqaplus_tpu_torch.data.batching import (
    StaticShapeSpec,
    collate_static,
    pick_bucket,
)
from tvqaplus_tpu_torch.parallel.mesh import LI_KEYS, li_slice, rank_rows

# the large float inputs that go to the card in bfloat16 under the bf16
# compute policy (JAX pipeline.py:34-35)
BF16_KEYS = ("qas_bert", "sub_bert", "sub_tokens", "vid", "sub_tokens_u",
             "vid_u", "sub_bert_u")


class DataPipeline:
    """Iterable over (device batch dict, meta, Li bucket) tuples.
    ``train``: shuffled bucket batching with the att-entry keys.
    ``video_dedup``: the per-unique-clip layout (serving).  ``mesh``: this
    rank's part of each global batch of ``batch_size``."""

    def __init__(self, dataset, cfg, device, batch_size=16, prefetch_depth=2,
                 train=False, seed=0, group=1, video_dedup=False, mesh=None):
        if video_dedup and mesh is not None \
                and mesh.data * mesh.ctx * mesh.model_size > 1:
            raise ValueError(
                "video_dedup is single-process only (each batch's table of "
                "unique clips would differ from rank to rank); disable "
                "--video_dedup for runs of more than one process")
        self.mesh = mesh
        self.dataset = dataset
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.rows = rank_rows(mesh, batch_size)
        self.prefetch_depth = max(1, prefetch_depth)
        self.train = train
        self.seed = seed
        self.group = max(1, group)
        self.base_spec = StaticShapeSpec.from_config(
            cfg, batch=self.rows[1] - self.rows[0], train=train)
        self.buckets = sorted(set(min(b, cfg.max_num_img)
                                  for b in cfg.img_buckets))
        cap = self.base_spec.max_sub_tokens
        self.st_buckets = sorted(set(min(b, cap) for b in
                                     cfg.sub_token_buckets)) if cap else []
        self.cast_bf16 = cfg.compute_dtype == "bfloat16"
        self.video_dedup = video_dedup
        self.video_buckets = sorted(set(
            min(b, batch_size) for b in cfg.video_buckets if b > 0)) \
            or [batch_size]
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

    def _st_bucket(self, examples):
        """The smallest St bucket covering the batch's unique-token need:
        per example the fixed cap's n_tok + 1 (slot 0 is the zero token,
        batching._collate_sub_dedup), so a bucketed batch equals the
        fixed-cap batch on its first St slots (JAX pipeline.py:143-160)."""
        cap = self.base_spec.max_sub_tokens
        need = 1
        for ex in examples:
            stream = ex.get("sub_tokens")
            if stream is not None:
                n = len(stream)
            else:
                n = sum(min(len(w), self.base_spec.max_sub_l)
                        for w in (ex.get("sub_bert") or [])[
                            : self.base_spec.max_img])
            need = max(need, min(n, cap - 1) + 1)
        return next((b for b in self.st_buckets if b >= need), cap)

    def _collate(self, examples, bucket):
        """This rank's rows of the global batch ``examples``, at the
        shapes the global batch decides."""
        spec = self.base_spec.with_max_img(bucket)
        if self.st_buckets:
            spec = dataclasses.replace(
                spec, max_sub_tokens=self._st_bucket(examples))
        arrays, meta = collate_static(examples[slice(*self.rows)], spec)
        if self.mesh is not None and self.mesh.ctx > 1:
            f0, f1 = li_slice(self.mesh, bucket)
            arrays.update({k: np.ascontiguousarray(arrays[k][:, f0:f1])
                           for k in LI_KEYS if k in arrays})
        if "qa_noun_masks" not in arrays and any(
                ex.get("qa_noun_masks") is not None for ex in examples):
            # the global batch's keys: another rank's rows carry the masks
            arrays["qa_noun_masks"] = np.zeros(
                (spec.batch, spec.num_a, spec.max_qa_l), np.float32)
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
        if self.video_dedup:
            arrays = self._dedup_videos(arrays, meta)
        return arrays, meta, bucket

    def _dedup_videos(self, arrays, meta):
        """``vid`` / ``sub_tokens`` / ``sub_bert`` -> one row per unique
        clip (``*_u``, (U, ...)) and ``ex_vid`` (B,) int32, each example's
        row (JAX pipeline.py:201-238).  A clip is (vid_name,
        image_indices): the feature files key rows by vid_name, so such
        examples carry the same arrays; unnamed examples never merge.  U is
        the smallest video bucket covering the batch (the batch size at
        most); the batch's padding rows point at a zero row past the
        clips when one is free, else at row 0 (their outputs are masked
        either way)."""
        n = len(meta["vid_name"])
        bsz = arrays["ex_mask"].shape[0]
        uniq, first_rows, ex_vid = {}, [], np.zeros(bsz, np.int32)
        for i in range(n):
            name = meta["vid_name"][i]
            key = ((name, tuple(meta["image_indices"][i])) if name
                   else ("", i))
            if key not in uniq:
                uniq[key] = len(first_rows)
                first_rows.append(i)
            ex_vid[i] = uniq[key]
        need = len(first_rows) + (1 if n < bsz else 0)
        u = next((b for b in self.video_buckets if b >= need),
                 max(bsz, need))
        if n < bsz:
            ex_vid[n:] = len(first_rows)
        out = dict(arrays)
        swapped = False
        for k in ("vid", "sub_tokens", "sub_bert"):
            if k not in out:
                continue
            v = out.pop(k)
            vu = np.zeros((u,) + v.shape[1:], v.dtype)
            vu[: len(first_rows)] = v[first_rows]
            out[k + "_u"] = vu
            swapped = True
        if swapped:
            out["ex_vid"] = ex_vid
        return out

    def _grouped_batches(self):
        """``group`` same-shape batches stacked on a leading axis K, keyed
        on every bucketed axis (Li; St under ``sub_token_buckets``; U
        under ``video_dedup``) as JAX's (pipeline.py:251-256); the
        leftovers of each buffer come out single, buffers in key order."""
        bufs = {}
        for arrays, meta, bucket in self._batches():
            key = (bucket,) + tuple(
                arrays[k].shape[:2] for k in
                ("sub_tokens", "sub_tokens_u", "vid_u", "sub_bert_u")
                if k in arrays)
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

    def _cast(self, arrays):
        """Host tensors of a collated batch: ``BF16_KEYS`` cast to bfloat16
        under the bf16 compute policy."""
        return {k: (torch.from_numpy(v).to(torch.bfloat16)
                    if self.cast_bf16 and k in BF16_KEYS
                    else torch.from_numpy(v))
                for k, v in arrays.items()}

    def _pin(self, tensors):
        """Page-locked copies for a CUDA device (non_blocking uploads)."""
        if self.device.type != "cuda":
            return tensors
        return {k: v.pin_memory() for k, v in tensors.items()}

    def _host(self, arrays):
        return self._pin(self._cast(arrays))

    def _upload(self, tensors):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in tensors.items()}

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
                yield self._upload(tensors), meta, bucket
        finally:
            stop.set()
            while t.is_alive():        # drain so the producer can finish
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
