"""Replayed K = 4 train steps of a tree at hsz 64 and 256 (or, with
``--serve``, its replayed serve steps at hsz 256 and 200), for comparing a
change with its parent in one call: run it from each tree's root in turns
(parent, change, change, parent).

    python3 <repo>/scripts/train_step_turns.py [--serve] [--hsz N,N..]

Needs one NVIDIA GPU.  The package timed is the one under the current
directory; the harness is this repo's ``chip_smoke.py`` (``train_steps``,
``train_step_rows``: the same yardstick for both trees), so the trees'
packages must share its entry points (``Trainer``, the config).  For each
hsz and path (separate, merged) it captures a Trainer's K = 4 dispatch of
four stacked headline batches (bf16, dropout 0.1) and prints one JSON
line: per step ms (the median of the two turns, and both), the profiled
window's busy ms, host ms and idle share, launches from the graph's nodes,
trained QA/s.  ``--serve``: for each hsz and path the K = 1 serve
dispatch of the headline batch (bf16, ``serve_steps``,
``serve_step_rows``): per step ms (both turns), busy ms, idle share,
launches from the trace, QA/s.  ``--hsz`` times those widths instead.
"""
import importlib.util
import json
import os
import sys

import torch

HSZS = (64, 256)
SERVE_HSZS = (256, 200)


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
    args = sys.argv[1:]
    serve = "--serve" in args
    hszs = SERVE_HSZS if serve else HSZS
    if "--hsz" in args:
        hszs = tuple(int(h) for h in args[args.index("--hsz") + 1].split(","))
    if serve:
        steps = cs.serve_steps(dev, cs.serve_models(hszs))
        rows = cs.serve_step_rows({k: v[0] for k, v in steps.items()})
        key = "serve_steps"
    else:
        steps, nodes = cs.train_steps(
            dev, os.path.join("build", "train_step_turns"), hszs)
        rows = cs.train_step_rows(steps, nodes)
        key = "train_steps"
    for row in rows.values():
        del row["names"], row["top_kernels"]
    print(json.dumps({"tree": os.getcwd(), "package": _build.__file__,
                      "device": torch.cuda.get_device_name(0),
                      key: rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
