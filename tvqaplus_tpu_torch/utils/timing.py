"""Device timing (the port's counterpart of ``tvqaplus_tpu/utils/timing.py``).

CUDA work is queued: a host clock read right after a call measures the
enqueue.  Every timed region here ends with ``host_sync``, a fetch to the
host of a value that depends on the whole timed chain, which cannot return
before the device has computed it (on the CPU it returns at once).
"""
from __future__ import annotations

import time

import torch


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def host_sync(x):
    """Wait for ``x`` (a tensor, or a dict / list / tuple of them) by
    fetching one element of its first tensor to the host; returns that
    element as a Python number, or None when ``x`` holds no tensor.  Pass a
    value that depends on everything to be timed (the last step's loss when
    steps chain through the parameters)."""
    leaves = [t for t in _leaves(x) if t.numel()]
    if not leaves:
        return None
    return leaves[0].detach().reshape(-1)[0].item()


def timeit_host_synced(fn, n=20, warmup=2, trials=3):
    """Best-of-``trials`` mean milliseconds per call of ``fn``, each trial
    ``n`` calls ended by a ``host_sync`` of the last call's result."""
    r = None
    for _ in range(max(1, warmup)):
        r = fn()
    host_sync(r)
    best = float("inf")
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        host_sync(r)
        best = min(best, time.perf_counter() - t0)
    return best / n * 1000.0


def compiled_flops(fn, *args, **kwargs):
    """Floating-point operations of one call ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (the matmuls,
    convolutions and attention of PyTorch's own operators), or None when it
    counts none.

    CAUTION: the hand-written kernels launch through ctypes, outside
    PyTorch's dispatcher, so the counter cannot see them: on ``cuda`` it
    undercounts a step that runs the fused kernels (on the CPU the plain
    versions run and are counted).  A CUDA-graph replay is invisible to it
    too: count the eager step and multiply by K."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None
