"""Multi-step dispatch: K same-shape steps at once, the port's counterpart
of the JAX package's ``lax.scan`` / ``lax.map`` over a stack of batches
(tvqaplus_tpu/train/loop.py ``steps_per_dispatch``, :175-183, :219-231;
``eval_steps_per_dispatch``, :233-240; infer/predict.py:260-300).

The pipeline stacks K batches of one Li bucket on a leading axis
(``DataPipeline(group=K)``).  A step function takes such a batch (or a
single one), runs its K steps one after the other and returns tensors.

On ``cuda`` every dispatch after the first of its shape is ONE replay of a
CUDA graph (``StepGraphs``), as ``jit`` makes every JAX dispatch after the
first one executable: the first dispatch of a shape runs eagerly on a side
stream (the warm-up: kernels are built and loaded, lazy state is made, and
its result is the dispatch's result), then the function is captured over
static input slots.  A later dispatch copies its batch into the slots (on
the current stream) and replays the graph.  What a step keeps across steps
(parameters, optimizer state, the step counter and the dropout seeds of
ops/philox.py ``StepSeeds``, the device generators) lives outside the graph
and is read and written in place, so a replayed step computes what the same
eager step computes.  A capture that fails raises: nothing falls back to
eager dispatch.  On the CPU the function runs eagerly.

Under data parallelism (parallel/mesh.py) a train step's collectives (the
cls loss's two counts and the gradient sum) are NCCL all-reduces, captured
in the dispatch's graph with the rest of the K steps: the communicator
exists before the first capture (``init_distributed`` makes it, the
trainer's ``broadcast_state`` uses it), the eager warm-up dispatch runs the
same collectives, and NCCL enqueues a captured collective's work into the
graph, so every replay runs it again.
"""
from __future__ import annotations

import torch

from tvqaplus_tpu_torch.data.batching import StaticShapeSpec, zeros_batch
from tvqaplus_tpu_torch.ops import _build


def auto_steps_per_dispatch(cfg, hbm_budget_bytes=6 * 2 ** 30, max_k=16):
    """K for ``steps_per_dispatch = 0``: as many stacked training batches
    of the largest bucket as a 6 GiB budget holds, at most 16 (JAX
    loop.py:42-52)."""
    spec = StaticShapeSpec.from_config(cfg, batch=cfg.bsz, train=True)
    batch_bytes = sum(a.nbytes for a in zeros_batch(spec).values())
    return max(1, min(max_k, int(hbm_budget_bytes // max(batch_bytes, 1))))


def steps_in(batch):
    """K of a stacked batch ((K, B) ``ex_mask``), 1 for a single batch."""
    return batch["ex_mask"].shape[0] if batch["ex_mask"].dim() == 2 else 1


def unstack(batch):
    """The K single batches of a stacked batch (views), or [batch]."""
    if batch["ex_mask"].dim() == 1:
        return [batch]
    return [{k: v[i] for k, v in batch.items()}
            for i in range(steps_in(batch))]


class _Graph:
    """One captured dispatch: its graph, its static input slots and
    outputs, and the kernel launches it holds (``ops/_build.py``
    counters)."""

    def __init__(self, graph, slots, outputs, launches):
        self.graph, self.slots = graph, slots
        self.outputs, self.launches = outputs, launches

    def replay(self, inputs):
        for k, v in inputs.items():
            self.slots[k].copy_(v, non_blocking=True)
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.outputs


class StepGraphs:
    """CUDA graphs of step functions on one card, one per (key, input
    shapes), all in one memory pool (they never run at once).  Each replay
    overwrites its outputs: the caller reads or copies them before the next
    dispatch of the same shape."""

    def __init__(self, device, *generators):
        self.device = torch.device(device)
        self.generators = generators   # drawn from inside a step
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.graphs = {}

    def __call__(self, key, fn, inputs):
        """``fn(inputs)`` (a tensor or a dict of tensors) for the dict of
        device tensors ``inputs``: eager the first time for ``key`` and
        these shapes (then captured), a replay after."""
        sig = (key,) + tuple((k, tuple(v.shape), v.dtype)
                             for k, v in sorted(inputs.items()))
        graph = self.graphs.get(sig)
        if graph is not None:
            return graph.replay(inputs)
        out = self._on_side_stream(fn, inputs)
        self.graphs[sig] = self._capture(fn, inputs)
        return out

    def _on_side_stream(self, fn, inputs):
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn(inputs)
        main.wait_stream(self.stream)
        return out

    def _capture(self, fn, inputs):
        slots = {k: v.clone() for k, v in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        before = _build.launch_counts()
        # thread-local: the pipeline's producer thread pins host memory
        # while the step is captured
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            outputs = fn(slots)
        launches = [n - m for n, m in zip(_build.launch_counts(), before)]
        _build.add_launches([-n for n in launches])   # nothing ran yet
        return _Graph(graph, slots, outputs, launches)
