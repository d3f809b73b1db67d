"""Where a bf16 backward row's time goes outside its kernels: the
``autograd.grad`` call that ``chip_smoke.py``'s kernel table times for a
case of ``train_kernel_cases`` (dropout 0.1), split between the card and
the host's parts.

    python3 scripts/host_split.py [--forward] [--width D] [--families F,..]

Run from a tree's root (its ``chip_smoke.py`` and package are imported);
needs one NVIDIA GPU.  For each of ``CASES`` (the attention's vid and sub
rows at D = 64 and 128, the tri bridge's at 64 and 256, the encoder's
reduce and full-output rows at 64; ``--width`` and ``--families`` keep
those of that width and families) it prints one JSON line:

* ``row_ms``: the row as the table times it (CUDA events around the call,
  ``time_ms``: median of 30);
* ``host_ms``: the host's time to issue one call (from before the call to
  its return, each call then synchronised; median of 30);
* ``device_ms``: the kernels' time a call (``torch.profiler``, CUDA
  activity, 10 calls), and ``kernels``, each kernel's ms a call by name;
* ``entry_ms``: the host's time inside the kernels' C entries a call (the
  ctypes call: ``allow_smem``, the launches; ``CudaKernel.launch`` timed),
  and ``entries`` a call;
* ``torch_ops_ms``: the self CPU time a call of the torch ops the call runs
  (allocations, casts, views; ``torch.profiler``, CPU activity, 10 calls),
  and ``top_ops``, the largest;
* ``rest_ms``: host_ms less entry_ms and torch_ops_ms (Python: the
  autograd engine, the wrappers).

``--forward`` splits the same way the forward call of each of
``FWD_CASES`` (the attention's vid and sub rows at D = 64, the encoder's
reduce and full-output rows and the tri bridge's row at D = 64, the tri
bridge's rows at D = 256 and 200, in bf16) at dropout 0 and 0.1.
"""
import json
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

CASES = ((64, "qa_ctx_attention"), (128, "qa_ctx_attention"),
         (64, "tri_bridge"), (256, "tri_bridge"), (64, "encoder"),
         (64, "encoder_block"))
# --forward: the forward rows of ``kernel_cases`` at each dropout rate
FWD_CASES = ((64, "qa_ctx_attention"), (64, "encoder"), (64, "encoder_block"),
             (64, "tri_bridge"), (256, "tri_bridge"), (200, "tri_bridge"))
CALLS = 10


def split(cs, call, entry):
    """The row, host, device, entry and torch-op times of ``call`` (one
    JSON-ready dict); ``entry`` collects the C entries' host seconds."""
    row_ms = cs.time_ms(call)
    host = []
    entry.clear()
    for _ in range(30):
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    entries, entry_ms = len(entry) / 30, sum(entry) * 1e3 / 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
    # a kernel's ms a call: the mean of the launches the trace holds times
    # its launches a call (late in a long process a trace can miss some)
    sums, counts = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "") \
                .replace("void ", "").split("(")[0][:60]
            sums[name] = sums.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
            counts[name] = counts.get(name, 0) + 1
    kernels = {name: sums[name] / counts[name] * -(-counts[name] // CALLS)
               for name in sums}
    device_ms = sum(kernels.values())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_cpu_time_total / 1e3 / CALLS)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])
    ops_ms = sum(ms for _, ms in ops)
    host_ms = statistics.median(host)
    return {"row_ms": row_ms, "host_ms": host_ms, "device_ms": device_ms,
            "kernels": kernels, "entry_ms": entry_ms, "entries": entries,
            "torch_ops_ms": ops_ms, "rest_ms": host_ms - entry_ms - ops_ms,
            "top_ops": [[k, ms] for k, ms in ops[:8]]}


def chosen(cases, args):
    """The (width, family) pairs of ``cases`` that ``--width`` and
    ``--families`` keep."""
    width = int(args[args.index("--width") + 1]) if "--width" in args \
        else None
    families = args[args.index("--families") + 1].split(",") \
        if "--families" in args else None
    return [(d, f) for d, f in cases if width in (None, d)
            and (families is None or f in families)]


def main():
    args = sys.argv[1:]
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tvqaplus_tpu_torch.ops import _build
    _build.build_all()
    dev = torch.device("cuda")
    entry = []
    launch = _build.CudaKernel.launch

    def timed_launch(self, *a, **kw):
        t0 = time.perf_counter()
        launch(self, *a, **kw)
        entry.append(time.perf_counter() - t0)
    _build.CudaKernel.launch = timed_launch
    if "--forward" in args:
        for d, family in chosen(FWD_CASES, args):
            for case in cs.kernel_cases(dev, d):
                if case.key != family:
                    continue
                a, kw = case.args(torch.bfloat16)
                for rate in (0.0, cs.P_DROP):
                    kwr = {**kw, "dropout_rate": rate, "seed": cs.DROP_SEED}
                    print(json.dumps({
                        "case": f"{case.name} dropout {rate}", "width": d,
                        **split(cs, lambda: case.kernel(*a, **kwr), entry)}),
                        flush=True)
        _build.CudaKernel.launch = launch
        return 0
    for d, family in chosen(CASES, args):
        for case in cs.train_kernel_cases(dev, d):
            if case.key != family:
                continue
            a, base_kw = case.args(torch.bfloat16)
            ins, leaves = cs._leaves(a, case.diff)
            got = cs._outputs(case.kernel(*ins, **{**base_kw, **case.kw}))
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            cots = cs._cotangents(got, case.flip(a), gen, case.valid)

            def call():
                return torch.autograd.grad(got, leaves, cots,
                                           retain_graph=True)
            print(json.dumps({"case": case.name, "width": d,
                              **split(cs, call, entry)}), flush=True)
            del got, leaves, cots, ins
    _build.CudaKernel.launch = launch
    return 0


if __name__ == "__main__":
    sys.exit(main())
