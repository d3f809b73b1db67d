"""Replayed K = 4 train steps of a tree at hsz 64 and 256, for comparing a
change with its parent in one call: run it from each tree's root in turns
(parent, change, change, parent).

    python3 <repo>/scripts/train_step_turns.py

Needs one NVIDIA GPU.  The package timed is the one under the current
directory; the harness is this repo's ``chip_smoke.py`` (``train_steps``,
``train_step_rows``: the same yardstick for both trees), so the trees'
packages must share its entry points (``Trainer``, the config).  For each
hsz and path (separate, merged) it captures a Trainer's K = 4 dispatch of
four stacked headline batches (bf16, dropout 0.1) and prints one JSON
line: per step ms (the median of the two turns, and both), the profiled
window's busy ms, host ms and idle share, launches from the graph's nodes,
trained QA/s.
"""
import importlib.util
import json
import os
import sys

import torch

HSZS = (64, 256)


def main():
    sys.path.insert(0, os.getcwd())          # the tree's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs          # its dataclasses look it up
    spec.loader.exec_module(cs)
    from tvqaplus_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    steps, nodes = cs.train_steps(dev, os.path.join("build",
                                                    "train_step_turns"), HSZS)
    rows = cs.train_step_rows(steps, nodes)
    for row in rows.values():
        del row["names"], row["top_kernels"]
    print(json.dumps({"tree": os.getcwd(), "package": _build.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "train_steps": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
