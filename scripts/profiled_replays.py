"""Reproducer of a host fault under the profiler (ROADMAP C6): in one
process, profile replayed K = 4 train dispatches, round after round, until one
faults or the count reaches N, each configuration in a child process of its own.

    python3 scripts/profiled_replays.py [--rounds N] [--history] [CONFIG ...]

Run from a tree's root (its ``chip_smoke.py`` and package are imported);
needs one NVIDIA GPU.  CONFIG (default: all four, in this order):

* ``hsz256``: the hsz-256 train steps (separate and merged path, bf16,
  dropout 0.1, ``Trainer.dispatch_train`` of four stacked batches, a CUDA
  graph replay), rounds alternating between the two, each round
  ``torch.profiler`` with CUDA activity over two dispatches, its events
  walked as ``chip_smoke.py`` ``profile_steps`` walks them;
* ``hsz128``: the same at hsz 128;
* ``cpu_activity``: ``hsz256`` with the profiler's CPU activity only;
* ``d128_kernels``: a CUDA graph of the D = 128 kernels alone (forward
  and backward of the attention, tri bridge and encoder at the headline
  train shapes, bf16, dropout 0.1), no model, no optimizer.

``--history`` first runs, in the child, ``chip_smoke.py``'s phases in its
order from the kernels' to ``wide_serving`` (the process history before
``wide_training`` in a whole run, some thirty profiled windows among
them), then the configuration's loop.

Each child runs under ``faulthandler`` and prints one line a round; the
parent prints one JSON line a configuration (rounds done, exit code, the
signal if a fault ended it, seconds) and exits 1 if any child did not end
cleanly.
"""
import json
import os
import signal
import subprocess
import sys
import time

CONFIGS = ("hsz256", "hsz128", "cpu_activity", "d128_kernels")
ROUNDS, TIMEOUT_S = 60, 600


def _trainer_steps(cs, dev, hsz):
    """Replayed K = 4 train dispatches of the two paths at width ``hsz``,
    each warmed up and captured."""
    from tvqaplus_tpu_torch.train.loop import Trainer
    steps = []
    for merged in (False, True):
        cfg = cs.train_config(os.path.join("build", "profiled_replays"),
                              bsz=cs.B, hsz=hsz,
                              merge_input_streams=merged).finalize(dev)
        trainer = Trainer(cfg, dev)
        four = cs.stacked(cs.train_batch(cfg, dev, cs.B), cs.DISPATCH_K)
        steps.append(lambda t=trainer, b=four: t.dispatch_train(b))
        steps[-1]()                    # eager, then captured
    return steps


def _kernel_graph(cs, dev):
    """One CUDA graph of the D = 128 kernels' forwards and backwards."""
    import torch
    calls = []
    for case in cs.train_kernel_cases(dev, 128):
        if case.key not in ("qa_ctx_attention", "tri_bridge", "encoder"):
            continue
        a, base_kw = case.args(torch.bfloat16)
        kw = {**base_kw, **case.kw}
        # the seed a device tensor made before the capture, as a step's
        kw["seed"] = torch.tensor(kw["seed"], dtype=torch.int64, device=dev)
        ins, leaves = cs._leaves(a, case.diff)

        def call(c=case, i=ins, lv=leaves, k=kw):
            outs = cs._outputs(c.kernel(*i, **k))
            return torch.autograd.grad(outs, lv,
                                       [torch.ones_like(o) for o in outs])
        calls.append(call)

    def run():
        return [call() for call in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return [graph.replay]


def history(cs, dev):
    """``chip_smoke.py``'s phases before ``wide_training``, in its order."""
    import tempfile
    from tvqaplus_tpu_torch.ops import _build
    smi = cs.phase_device()
    cs.phase_build()
    cs.phase_kernels(dev)
    cs.phase_width_kernels(dev)
    cs.phase_train_kernels(dev)
    cs.phase_width_train_kernels(dev)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        cs.phase_evaluator(workdir)
        cfg, sd, _, pred, cpu = cs.phase_main(dev, workdir)
        cs.phase_merged_main(dev, workdir, cfg, sd, pred, cpu)
        cs.phase_serving(dev, cfg, sd)
        cs.phase_train_main(dev, workdir)
        cs.phase_train_main(dev, workdir, merged=True, steps_per_dispatch=2)
        cs.phase_bridge_module(dev, cfg, sd)
        cs.phase_train_vs_cpu(dev, workdir)
        cs.phase_dispatch(dev, workdir)
        cs.phase_training(dev, workdir)
        cs.phase_jax_checkpoint(dev, workdir)
        cs.phase_heads(dev, workdir)
        cs.phase_bookkeeping(dev, workdir)
        dp_launches, dp_per_step = cs.phase_data_parallel(dev, workdir, smi)
        cs.phase_mesh_axes(dev, workdir, smi, dp_launches, dp_per_step)
        cs.phase_wide_serving(dev, workdir, cfg, sd)


def child(config, rounds, with_history=False):
    import faulthandler
    faulthandler.enable(all_threads=True)
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tvqaplus_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    if with_history:
        history(cs, dev)
    if config == "d128_kernels":
        steps = _kernel_graph(cs, dev)
    else:
        steps = _trainer_steps(cs, dev, 128 if config == "hsz128" else 256)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU if config == "cpu_activity"
            else ProfilerActivity.CUDA]
    for n in range(rounds):
        step = steps[n % len(steps)]
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(2):
                step()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        print(json.dumps({"config": config, "round": n + 1,
                          "events": len(prof.events()),
                          "kernels": len(kernels),
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


def main(argv):
    if argv[:1] == ["--child"]:
        return child(argv[1], int(argv[2]), "--history" in argv)
    rounds = int(argv[argv.index("--rounds") + 1]) \
        if "--rounds" in argv else ROUNDS
    configs = [a for a in argv if a in CONFIGS] or list(CONFIGS)
    clean = True
    for config in configs:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", config,
             str(rounds)] + ["--history"] * ("--history" in argv),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        lines = out.splitlines()
        done = 0
        for line in lines:
            if line.startswith("{") and f'"config": "{config}"' in line:
                done = json.loads(line)["round"]
        code = proc.returncode
        fault = -code if code is not None and code < 0 else None
        tail = [ln for ln in lines if not ln.startswith('{"config"')][-25:]
        clean &= code == 0 and done == rounds
        print(json.dumps({
            "config": config, "rounds": rounds, "rounds_done": done,
            "exit_code": code,
            "signal": signal.Signals(fault).name if fault else None,
            "seconds": time.perf_counter() - t0,
            "fault_report": tail if code != 0 else []}), flush=True)
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
