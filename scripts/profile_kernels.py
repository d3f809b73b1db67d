"""Device time of each kernel behind the port's ops at the headline shapes
(``chip_smoke.py``'s training cases: batch 16, 5 answers x 40 QA tokens, 50
frames, 25 regions / 50 subtitle tokens, the merged input encoder, D 128,
bfloat16), forward and backward, with and without dropout.

    python3 scripts/profile_kernels.py [key ...]

Needs one NVIDIA GPU.  ``key`` is a counter key of chip_smoke.py's cases
(qa_ctx_attention, tri_bridge, encoder, encoder_block, mlp_bridge; default:
the first four).  For each case and dropout rate (0, 0.1) it prints the
CUDA-event time of the forward call and of ``torch.autograd.grad`` through
the op (median of 30), bf16 and then float32 (the CUDA-core instantiation)
in the same call, and from ``torch.profiler`` the device time per call of
every kernel the bf16 call launches, so that the wrapper's and the launch
gaps' share of a call can be read as the difference.
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
        if e.device_time_total > 0 and e.count > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0][:60]
            # the mean of the launches the trace holds times the launches a
            # call (late in a long process a trace can miss some)
            ms = e.device_time_total / e.count * -(-e.count // REPS) / 1e3
            times[name] = times.get(name, 0.0) + ms
    return times


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    keys = sys.argv[1:] or ["qa_ctx_attention", "tri_bridge", "encoder",
                            "encoder_block"]
    dev = torch.device("cuda")
    print(cs.phase_device())
    _build.build_all()
    for case in cs.train_kernel_cases(dev):
        if case.key not in keys or "no mask" in case.name:
            continue
        for rate in (0.0, cs.P_DROP):
            calls = {}
            for dt in (torch.bfloat16, torch.float32):
                a, base_kw = case.args(dt)
                kw = {**base_kw, **case.kw, "dropout_rate": rate}
                ins, leaves = cs._leaves(a, case.diff)
                outs = cs._outputs(case.kernel(*ins, **kw))
                cots = [torch.ones_like(o) for o in outs]

                def forward(a=a, kw=kw):
                    return case.kernel(*a, **kw)

                def backward(outs=outs, leaves=leaves, cots=cots):
                    return torch.autograd.grad(outs, leaves, cots,
                                               retain_graph=True)
                calls[dt] = (forward, backward)
            for i, tag in enumerate(("forward", "backward")):
                fn = calls[torch.bfloat16][i]
                times = kernel_times(fn)
                print(f"{case.name} dropout {rate} {tag}: call "
                      f"{cs.time_ms(fn):.4f} ms (float32 "
                      f"{cs.time_ms(calls[torch.float32][i]):.4f} ms), "
                      f"kernels {sum(times.values()):.4f} ms", flush=True)
                for name, ms in sorted(times.items(), key=lambda t: -t[1]):
                    print(f"    {ms:.4f}  {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
