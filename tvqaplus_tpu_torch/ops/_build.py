"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``; no PyTorch header
is compiled, so a cold build of all kernels takes seconds.  Libraries land
in ``build/tvqaplus_tpu_torch/`` beside the package, named by a hash of the
source, the shared header and the flags, so an edited kernel rebuilds at
its next first use and an unchanged one never does.  ``build_all`` starts
one ``nvcc`` per source, all at once.

The C entries take raw device pointers (``tensor.data_ptr()``) and the
stream (``torch.cuda.current_stream().cuda_stream``) as ``c_void_p``, launch
on that stream, allocate nothing, and return ``cudaGetLastError()``;
``CudaKernel.launch`` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from tvqaplus_tpu_torch.ops.widths import TRUE_WIDTHS, padded_width

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tvqaplus_tpu_torch")
SOURCES = ("qa_ctx_attention_fwd.cu", "qa_ctx_attention_bwd.cu",
           "qa_ctx_attention_bwd_wide.cu", "tri_bridge_fwd.cu",
           "tri_bridge_bwd.cu", "tri_bridge_bwd_wide.cu", "encoder_fwd.cu",
           "encoder_bwd.cu", "encoder_bwd_wide.cu", "encoder_bwd_tc_wide.cu",
           "mlp_bridge_fwd.cu", "mlp_bridge_bwd.cu")
_HEADERS = ("common.cuh", "philox.cuh", "grad_reduce.cuh",
            "qa_ctx_attention.cuh", "encoder.cuh", "encoder_tc.cuh",
            "tri_bridge_tc.cuh", "mlp_bridge.cuh", "mlp_bridge_tc.cuh",
            "wgmma.cuh", "wgrad_tc.cuh", "bwd_wide.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return found


def lib_path(source):
    """Path of the shared library built from ``source`` (a csrc file name)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + _HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_all(sources=SOURCES):
    """Compile every library of ``sources`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds spent;
    raises with the compiler's output if any build fails.  Each build's
    output (``-Xptxas=-v``: registers, shared memory, spills) is kept
    beside its library as ``.log``."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for src in sources:
        out = lib_path(src)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {src} (nvcc exit {proc.returncode})\n{log}")
            os.unlink(tmp)
            continue
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)     # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


class CudaKernel:
    """One C entry of one kernel library, loaded at first launch, with a
    count of its launches (``launches``) that callers may reset, and beside
    it the launches at each true width (``by_width[dv]``: a width padded to
    this instantiation counts there under its own dv).  A launch captured
    into a CUDA graph counts once for each replay of the graph
    (``launch_counts``, ``add_launches``: dispatch.py), not at capture."""

    def __init__(self, source, symbol, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.by_width = dict.fromkeys(TRUE_WIDTHS, 0)
        self._fn = None
        KERNELS.append(self)

    def _load(self):
        if self._fn is None:
            path = lib_path(self.source)
            if not os.path.exists(path):
                build_all((self.source,))
            lib = ctypes.CDLL(path)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device, *args, dv=None):
        """Launch on ``device``'s current stream (passed as the last
        argument) with ``device`` current; raises on a CUDA error.  ``dv``:
        the true width the launch runs (counted in ``by_width``)."""
        import torch
        fn = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} at launch "
                f"(see cudaError_t)")
        self.launches += 1
        if dv is not None:
            self.by_width[dv] += 1


KERNELS = []      # every CudaKernel, in the order the modules made them


class WidthCount:
    """The launches of ``kernel`` at the true width ``dv`` (its
    ``by_width`` entry) behind the ``launches`` attribute of a kernel, so a
    caller reads and resets it as it does a kernel's count."""

    def __init__(self, kernel, dv):
        self.kernel, self.dv = kernel, dv

    @property
    def launches(self):
        return self.kernel.by_width[self.dv]

    @launches.setter
    def launches(self, n):
        self.kernel.by_width[self.dv] = n


def width_counter(by_width, d):
    """The launch count of true width ``d`` in a wrapper's table of
    kernels by instantiation (``FWD_BY_WIDTH`` and the like): the table's
    own kernel at an instantiation, else the ``WidthCount`` of the
    instantiation ``d`` is padded to."""
    if d in by_width:
        return by_width[d]
    return WidthCount(by_width[padded_width(d)], d)


def launch_counts():
    """Every kernel's ``launches``, in ``KERNELS`` order, then every
    kernel's ``by_width`` counts."""
    return [k.launches for k in KERNELS] + [
        k.by_width[w] for k in KERNELS for w in TRUE_WIDTHS]


def add_launches(counts):
    """Add ``counts`` (``launch_counts`` order) to the kernels' counters."""
    n = len(KERNELS)
    for kernel, c in zip(KERNELS, counts[:n]):
        kernel.launches += c
    for i, c in enumerate(counts[n:]):
        kernel = KERNELS[i // len(TRUE_WIDTHS)]
        kernel.by_width[TRUE_WIDTHS[i % len(TRUE_WIDTHS)]] += c


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def wgrad_chunks(rows, k, target_blocks=528, d=128):
    """Row chunks (scratch slots) of the weight-gradient pass of
    ``csrc/grad_reduce.cuh`` for ``rows`` rows, a K-wide left operand and a
    D-wide right one: about four blocks per SM of an H100, at least 32 rows
    a chunk."""
    tiles = max(1, k // 64) * max(1, d // 128)
    return max(1, min(-(-rows // 32), target_blocks // tiles))


def tc_wgrad_chunks(rows, k, d=128):
    """Row chunks (scratch slots) of the tensor-core weight-gradient pass of
    ``csrc/wgrad_tc.cuh`` for ``rows`` rows, a K-wide left operand (K a
    multiple of 64) and a D-wide right one: two blocks on each of an H100's
    132 SMs, at least 64 rows a chunk."""
    tiles = -(-k // 128) * max(1, d // 128)
    return max(1, min(264 // tiles, -(-rows // 64)))


def sm_count(device):
    """Streaming multiprocessors of ``device`` (the persistent kernels run
    one block on each)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_aligned(**tensors):
    """Raise unless every tensor starts on a 16-byte boundary (the
    tensor-core kernels copy 16-byte chunks)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def check_device(device, **tensors):
    """Raise unless every tensor lies on ``device`` (a kernel given a host
    or another card's pointer would fault)."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
