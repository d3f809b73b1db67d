"""Dropout masks from Philox4x32-10, in plain PyTorch (the plain version
of ``csrc/philox.cuh``; see there for the contract).

Element ``e`` of the tensor a dropout acts on (its flat index) keeps its
value iff ``(bits(seed, e) >> 8) >= ceil(p * 2**24)``, where ``bits`` is
word ``e & 3`` of Philox4x32-10 at counter ``e >> 2`` under the key
``seed``.  The kernels and this module draw the same bits, so a kernel's
output with dropout on is held against its plain version exactly.

The 32 x 32 -> 64-bit products of Philox would overflow int64 tensors, so
each multiplier is split into 16-bit halves.  A seed is an int or a 0-d
int64 tensor (a training step's seed slot, ``StepSeeds``), which the plain
versions read on its device and the kernels through a pointer.
"""
from __future__ import annotations

import ctypes

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
SEED_BITS = 62


def _mulhilo(m, c):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``m``
    and the uint32 values ``c`` (int64 tensor), without overflow."""
    a = c * (m & 0xFFFF)                  # < 2**48
    b = c * (m >> 16)                     # < 2**48
    mid = a + ((b & 0xFFFF) << 16)        # < 2**49
    return (b >> 16) + (mid >> 32), mid & _MASK32


def philox_rounds(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on counter words (c0, c1, c2, c3) (uint32 values in
    int64 tensors) under the key words (k0, k1) (Python ints)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox4x32_10(counter, seed):
    """The four uint32 words (int64 tensors) of Philox4x32-10 at the
    counters (counter lo, counter hi, 0, 0) for the int64 tensor
    ``counter``, under the key (seed lo, seed hi) of the int ``seed``."""
    zero = torch.zeros_like(counter)
    return philox_rounds(counter & _MASK32, (counter >> 32) & _MASK32,
                         zero, zero, seed & _MASK32, (seed >> 32) & _MASK32)


def threshold(p):
    """Integer keep threshold on the top 24 bits: ceil(p * 2**24)."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1)")
    t = p * (1 << 24)
    return int(t) + (t != int(t))


def scale(p):
    """The float32 multiplier of a kept value, 1 / (1 - p)."""
    return float(torch.tensor(1.0 / (1.0 - p), dtype=torch.float32))


def kernel_seed(p, seed, device):
    """What a wrapper hands its kernels (and keeps for the backward) as the
    seed of a dropout at rate ``p``: None when it is off, else a 0-d int64
    tensor on ``device`` that the kernels read through a pointer
    (csrc/philox.cuh): a tensor as it comes (a slot of
    ``StepSeeds.seeds``), an int copied there (a synchronous copy: for tests
    and checks, not for a captured step)."""
    if p == 0.0:
        return None
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1 \
                or seed.device != torch.device(device):
            raise ValueError(f"a seed tensor must be one int64 on {device}; "
                             f"got {seed.dtype} {tuple(seed.shape)} on "
                             f"{seed.device}")
        return seed
    return torch.tensor(int(seed), dtype=torch.int64, device=device)


def kernel_args(p, seed):
    """(seed pointer, threshold, scale) as a kernel's C entry takes them,
    ``seed`` from ``kernel_seed``; threshold 0 means no dropout (and the
    pointer is not read)."""
    if p == 0.0:
        return None, 0, 1.0
    return ctypes.c_void_p(seed.data_ptr()), threshold(p), scale(p)


def keep_mask(numel, seed, p, device="cpu", offset=0):
    """Boolean keep mask of the elements ``offset .. offset + numel - 1``."""
    first, last = offset >> 2, (offset + numel - 1) >> 2
    ctr = torch.arange(first, last + 1, dtype=torch.int64, device=device)
    words = torch.stack(philox4x32_10(ctr, seed), dim=-1).reshape(-1)
    start = offset - 4 * first
    return (words[start:start + numel] >> 8) >= threshold(p)


def multiplier(shape, seed, p, device="cpu"):
    """float32 tensor of ``shape``: 1 / (1 - p) where element (flat index)
    is kept, else 0."""
    numel = 1
    for n in shape:
        numel *= n
    keep = keep_mask(numel, seed, p, device).reshape(shape)
    return keep.to(torch.float32) * scale(p)


def keep_at(keys, seed, p):
    """Boolean keep mask of the elements whose flat indices are the int64
    tensor ``keys`` (any shape)."""
    words = torch.stack(philox4x32_10(keys >> 2, seed), dim=-1)
    bits = words.gather(-1, (keys & 3)[..., None])[..., 0]
    return (bits >> 8) >= threshold(p)


def width_multiplier(shape, seed, p, dv, parts=1, device="cpu"):
    """``multiplier`` of a tensor of ``shape`` whose last dim holds ``parts``
    blocks of a width dv padded to ``shape[-1] / parts``: element (r, g, c),
    c < dv, keys r parts dv + g dv + c, the flat index of the unpadded
    (..., parts dv) tensor (csrc/philox.cuh ``Dropout::row_key`` and
    ``key3``); the pad columns take 0."""
    dp = shape[-1] // parts
    rows = 1
    for n in shape[:-1]:
        rows *= n
    m = multiplier((rows, parts, dv), seed, p, device)
    return torch.nn.functional.pad(m, (0, dp - dv)).reshape(shape)


def draw_seed(generator):
    """A kernel seed from a CPU ``torch.Generator``: no device sync."""
    return int(torch.randint(0, 1 << SEED_BITS, (), generator=generator,
                             dtype=torch.int64))


# kernel dropout sites one training forward may hold (STAGE holds five:
# two attention sites, the tri bridge, the cls encoder, the merged input
# encoder)
SITES = 16
# the Philox keys of data-parallel rank r start at base + r * RANK_STRIDE:
# 2**36 steps of SITES keys each before two ranks' keys could meet
RANK_STRIDE = 1 << 40
# torch.Generator seeds of the ranks: rank r's is seed + r * GOLDEN
# (mod 2**64), the 64-bit golden-ratio increment of splitmix64; the att
# loss's Gumbel-noise generator's is seed + NOISE_SALT on every rank
GOLDEN = 0x9E3779B97F4A7C15
NOISE_SALT = 0xBB67AE8584CAA73B


def noise_seed(seed):
    """The seed of the generator that draws the att loss's Gumbel noise,
    the same on every data-parallel rank (each takes its rows of one global
    draw) and apart from every rank's dropout seed (``rank_seed``)."""
    return (seed + NOISE_SALT) % (1 << 64)


def rank_seed(seed, rank):
    """The ``torch.Generator`` seed of data-parallel rank ``rank`` for a
    run seeded ``seed``: ``seed`` itself on rank 0, so a single process
    keeps its draws, and another seed on every other rank, so the ranks do
    not draw the same dropout masks."""
    return (seed + rank * GOLDEN) % (1 << 64)


class StepSeeds:
    """The kernels' dropout seeds of every training step, made on the
    device: the port's counterpart of JAX's ``fold_in(rng, state.step)``
    (tvqaplus_tpu/train/loop.py:148-150).  ``step`` is an int64 counter on
    ``device`` that ``next()`` advances; site i of step s draws under the
    Philox key ``base + rank * RANK_STRIDE + s * SITES + i``, ``base`` drawn
    once from ``seed``, so no two (rank, step, site) triples share a key,
    rank 0 keeps a single process's keys, and a CUDA graph that replays the
    step draws new masks each time, the same as the eager step."""

    def __init__(self, seed, device, rank=0):
        base = draw_seed(torch.Generator().manual_seed(seed)) \
            + rank * RANK_STRIDE
        self.sites = (base + torch.arange(SITES)).to(device)
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.seeds = torch.empty(SITES, dtype=torch.int64, device=device)

    def next(self):
        """Fill ``seeds`` with the current step's keys and advance the
        counter: two device ops, no host sync.  Returns ``seeds``."""
        torch.add(self.sites, self.step, alpha=SITES, out=self.seeds)
        self.step.add_(1)
        return self.seeds
