"""Where the port's serving step spends its time on the card.

    python scripts/profile_torch_step.py [--steps 10] [--merge_input_streams]

Builds the headline serving configuration (batch 16, 50 frames x 25
regions, 40 QA tokens, hsz 128, BERT-768 inputs, bf16, seeded random
weights, synthetic data), runs the eval step of ``InferenceRunner`` (forward,
span search, grounding compaction) under ``torch.profiler`` and prints JSON
lines: the step's wall time (host clock around synchronised steps), the
device's busy time (the sum of kernel times: one stream, no overlap) and
idle share, the kernel launches per step, and the kernels by device time.
Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tvqaplus_tpu_torch.config import Config  # noqa: E402
from tvqaplus_tpu_torch.data.batching import (  # noqa: E402
    StaticShapeSpec,
    collate_static,
)
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset  # noqa
from tvqaplus_tpu_torch.infer.predict import InferenceRunner  # noqa: E402
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig  # noqa: E402

B, LI, SEED = 16, 50, 2018


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--merge_input_streams", action="store_true",
                    help="the merged input-encoder path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = Config(synthetic_data=True, add_local=True, bsz=B, test_bsz=B,
                 seed=SEED,
                 merge_input_streams=args.merge_input_streams).finalize(dev)
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(SEED)).to(dev)
    runner = InferenceRunner(cfg, model, dev)
    ds = SyntheticTVQADataset(cfg, B, mode="valid")
    arrays, _ = collate_static(
        [ds[i] for i in range(B)],
        StaticShapeSpec.from_config(cfg, batch=B).with_max_img(LI))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

    def step():
        return runner.step(batch, True, LI)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.steps * 1e3

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us()
                  for e in kernels) / 1e3 / args.steps
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "steps": args.steps,
        "merge_input_streams": args.merge_input_streams,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms if kernels else None,
        "device_idle_share": 1 - busy_ms / wall_ms if kernels else None,
        "kernel_launches_per_step": len(kernels) / args.steps}))
    for name, (n, t) in rows[: args.top]:
        print(json.dumps({"kernel": name[:90], "calls_per_step":
                          n / args.steps, "ms_per_step": t / 1e3 / args.steps,
                          "share_of_busy": t / 1e3 / args.steps / busy_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
