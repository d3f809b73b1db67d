"""How far the port's bfloat16 forward on the card lies from the CPU forward
in bfloat16 (the reference of chip_smoke.py's whole-model check, FWD_TOL) and
in float32, over several seeds.

    python3 scripts/check_bf16_forward_noise.py [seed ...]

Needs one NVIDIA GPU.  For each seed (weights and the synthetic headline
batch: 16 questions x 5 answers, 50 frames) it runs STAGE on the card in
bfloat16 through the kernels, and on the CPU in bfloat16 and in float32
(every op's plain version; in bfloat16 with the card's rounding sites), and
prints chip_smoke.py's ``forward_errors`` of the card's outputs against each:
the errors of the span scores, the raw attention scores and the answer
scores, how many of the 80 top-1 spans both sides chose alike, and what
would fail FWD_TOL's bfloat16 bar.
"""
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from tvqaplus_tpu_torch.config import Config  # noqa: E402
from tvqaplus_tpu_torch.models import stage  # noqa: E402
from tvqaplus_tpu_torch.ops import _build  # noqa: E402

SEEDS = (2018, 1, 2, 3, 4, 5, 6, 7)


def one_seed(seed, dev):
    cfg = Config(synthetic_data=True, add_local=True, bsz=cs.B,
                 test_bsz=cs.B, synthetic_n_valid=32, seed=seed)
    cfg.finalize("cpu")
    sd = stage.STAGE(stage.ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(seed)).state_dict()
    cpu_cfg, cpu_batch, refs = cs.cpu_forwards(cfg, sd)
    model = stage.STAGE(dataclasses.replace(
        cpu_cfg, compute_dtype="bfloat16")).eval()
    model.load_state_dict(sd)
    model.to(dev)
    got = cs.forward_outputs(model,
                             {k: v.to(dev) for k, v in cpu_batch.items()})
    for dname, ref in refs.items():
        report, failed = cs.forward_errors(got, ref, cs.FWD_TOL["bfloat16"])
        print(json.dumps({"seed": seed, "card": "bfloat16", "cpu": dname,
                          **report, "failed": failed}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    cs.phase_device()
    for seed in [int(a) for a in sys.argv[1:]] or SEEDS:
        one_seed(seed, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
