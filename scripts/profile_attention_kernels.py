"""Device time of each kernel behind the QA-context attention op at the
headline shapes (batch 16, 5 answers x 40 QA tokens, 50 frames, 25 regions /
50 subtitle tokens, D 128, bfloat16), forward and backward, with and without
dropout.

    python3 scripts/profile_attention_kernels.py

Needs one NVIDIA GPU.  For each site (vid: raw "target", sub: raw "none") and
dropout rate (0, 0.1) it prints the CUDA-event time of the forward call and of
``torch.autograd.grad`` through the op (median of 30), and from
``torch.profiler`` the device time per call of every kernel they launch
(the backward: its main kernel, the gqn/gqe kernel, the weight-gradient
kernel and the fixed-order sums), so that the wrapper's and the launch gaps'
share of a call can be read as the difference.  The inputs are
``chip_smoke.py``'s.
"""
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from tvqaplus_tpu_torch.ops import _build  # noqa: E402

REPS = 10


def kernel_times(fn):
    """{kernel name: device ms per call of ``fn``}, profiled over REPS."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0][:60]
            ms = e.device_time_total / REPS / 1e3
            times[name] = times.get(name, 0.0) + ms
    return times


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.phase_device())
    _build.build_all()
    for case in cs.train_kernel_cases(dev):
        if case.key != "qa_ctx_attention":
            continue
        a, base_kw = case.args(torch.bfloat16)
        for rate in (0.0, cs.P_DROP):
            kw = {**base_kw, **case.kw, "dropout_rate": rate}
            ins, leaves = cs._leaves(a, case.diff)
            outs = cs._outputs(case.kernel(*ins, **kw))
            cots = [torch.ones_like(o) for o in outs]

            def forward():
                return case.kernel(*a, **kw)

            def backward():
                return torch.autograd.grad(outs, leaves, cots,
                                           retain_graph=True)
            for tag, fn in (("forward", forward), ("backward", backward)):
                times = kernel_times(fn)
                print(f"{case.name} dropout {rate} {tag}: call "
                      f"{cs.time_ms(fn):.4f} ms, kernels "
                      f"{sum(times.values()):.4f} ms", flush=True)
                for name, ms in sorted(times.items(), key=lambda t: -t[1]):
                    print(f"    {ms:.4f}  {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
