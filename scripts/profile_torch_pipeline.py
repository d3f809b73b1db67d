"""Host cost of the port's serving pipeline per headline batch: collate,
bf16 host cast, pinning and upload, and the bytes each batch uploads, for
the four layouts of video dedup off/on x host cast off/on (the port's
counterpart of ``scripts/profile_collate.py``).

    python3 scripts/profile_torch_pipeline.py [--batches N] [--device cpu]
                                              [--cprofile]

The split is ``CachedDataset(SharedVideoDataset(synthetic, 7))``: TVQA+
has about 7 QAs per clip and serving iterates in clip order, which is what
video dedup exploits.  Batches are the serving CLI's: batch 16, 50 frames
(img_buckets [50]), St buckets [128, 256, 384] under the 512 cap, video
buckets [4, 8], in dataset order.  Each stage runs alone on the producer
thread's work for one batch (``DataPipeline._collate``, ``_cast``,
``_pin``, ``_upload`` + a synchronise), timed by the host clock; the
numbers are the median over the batches.  ``--device cpu`` measures
collate and cast only (no pinned memory, no upload).  One JSON line per
layout, after the card's name and power limit; ``--cprofile`` adds the
functions that take the collate time of the dedup + cast layout.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

BATCH, QAS_PER_VIDEO = 16, 7
LAYOUT = dict(img_buckets=[50], sub_token_buckets=[128, 256, 384],
              video_buckets=[4, 8])
LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


def serving_config(seed=2018, **kw):
    """The headline serving config with the St and U buckets, bf16."""
    from tvqaplus_tpu_torch.config import Config
    cfg = Config(synthetic_data=True, add_local=True, bsz=BATCH,
                 test_bsz=BATCH, seed=seed, compute_dtype="bfloat16",
                 **{**LAYOUT, **kw})
    return cfg.finalize("cpu")


def shared_split(cfg, n, mode="valid"):
    """``n`` synthetic QAs, 7 to a clip, made once up front."""
    from tvqaplus_tpu_torch.data.synthetic import (
        CachedDataset,
        SharedVideoDataset,
        SyntheticTVQADataset,
    )
    return CachedDataset(SharedVideoDataset(
        SyntheticTVQADataset(cfg, n, mode=mode), QAS_PER_VIDEO))


def host_stages(pipe, dataset, n_batches, device):
    """Median host ms per batch of each pipeline stage over the first
    ``n_batches`` batches of ``dataset`` in order, and the bytes a batch
    uploads (after the cast).  ``device``: "cuda" times pin and upload
    too."""
    times = {"collate_ms": [], "cast_ms": [], "pin_ms": [], "upload_ms": []}
    nbytes = []
    for i in range(n_batches):
        examples = [dataset[j] for j in range(i * pipe.batch_size,
                                              (i + 1) * pipe.batch_size)]
        t0 = time.perf_counter()
        arrays, _, _ = pipe._collate(examples, pipe._bucket(examples))
        t1 = time.perf_counter()
        tensors = pipe._cast(arrays)
        t2 = time.perf_counter()
        times["collate_ms"].append((t1 - t0) * 1e3)
        times["cast_ms"].append((t2 - t1) * 1e3)
        nbytes.append(sum(v.numel() * v.element_size()
                          for v in tensors.values()))
        if device == "cuda":
            pinned = pipe._pin(tensors)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            pipe._upload(pinned)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            times["pin_ms"].append((t3 - t2) * 1e3)
            times["upload_ms"].append((t4 - t3) * 1e3)
    out = {k: (statistics.median(v) if v else None)
           for k, v in times.items()}
    out["host_ms"] = sum(v for v in out.values() if v is not None)
    out["bytes_per_batch"] = statistics.median(nbytes)
    return out


def layout_pipeline(cfg, device, dedup, cast):
    """The serving pipeline of one layout; ``cast`` sets the host cast
    (on under bf16 compute), so both settings run on one config."""
    from tvqaplus_tpu_torch.data.pipeline import DataPipeline
    pipe = DataPipeline(None, cfg, device, batch_size=cfg.test_bsz,
                        video_dedup=dedup)
    pipe.cast_bf16 = cast
    return pipe


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cprofile", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("profile_torch_pipeline: no CUDA device; pass --device cpu "
                  "for the collate and cast stages alone", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0])
    cfg = serving_config()
    t0 = time.perf_counter()
    dataset = shared_split(cfg, args.batches * BATCH)
    print(json.dumps({"examples": len(dataset),
                      "make_s": time.perf_counter() - t0}), flush=True)
    for dedup, cast in LAYOUTS:
        pipe = layout_pipeline(cfg, args.device, dedup, cast)
        stages = host_stages(pipe, dataset, args.batches, args.device)
        print(json.dumps({"video_dedup": dedup, "host_cast": cast,
                          "device": args.device, "batch": BATCH,
                          "batches": args.batches,
                          "host_threads": torch.get_num_threads(),
                          **stages}), flush=True)
    if args.cprofile:
        pipe = layout_pipeline(cfg, args.device, True, True)
        prof = cProfile.Profile()
        prof.enable()
        host_stages(pipe, dataset, args.batches, "cpu")
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
        print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
