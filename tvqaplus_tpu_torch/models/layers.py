"""Core layers (port of ``tvqaplus_tpu/models/layers.py``).

Modules are named and nested so that ``state_dict()`` keys are the
reference PyTorch STAGE's (``nn.Sequential`` indices included: a Dropout or
ReLU slot keeps its index), which makes a reference ``best_valid.pth`` load
unchanged.  Weights keep the reference layouts: Linear (out, in), depthwise
Conv1d (D, 1, k), pointwise Conv1d (out, in, 1).

Numerics follow the JAX modules, not ``torch.nn.LayerNorm``: LayerNorm is
the flax formula (float32 stats, fast variance clipped at 0, result cast to
the compute dtype), ``DownProjection`` uses the exact variance, and every
dense layer casts its input and parameters to the compute dtype.  Parameters
stay float32.

Dropout: every ``forward`` takes ``drop``, a ``Dropout`` for a training
forward or None for eval.  The ``nn.Dropout`` slots keep the key layout
only.  The plain layers draw their masks from a generator on the batch's
device; the fused kernels read their Philox seeds from device memory, the
slots that the training step fills (ops/philox.py ``StepSeeds``), so a
step never waits on the device and a replayed CUDA graph draws new masks.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tvqaplus_tpu_torch.ops.encoder import encoder_block, encoder_reduce
from tvqaplus_tpu_torch.ops.mlp_bridge import mlp_bridge
from tvqaplus_tpu_torch.ops.plain import LN_EPS, depthwise_conv, layer_norm
from tvqaplus_tpu_torch.ops.tri_bridge import tri_bridge


class Dropout:
    """The dropout of one training forward (reference rate ``rate``):
    ``drop(x)`` for a plain layer, with its mask from ``generator`` (on the
    batch's device); ``kernel_args()`` gives the fused kernels, one call
    site after the other, their (rate, Philox seed): the next slot of
    ``seeds``, the step's int64 seed tensor on the batch's device
    (``StepSeeds.next()``)."""

    def __init__(self, rate, generator, seeds):
        self.rate = float(rate)
        self.generator = generator
        self.seeds = seeds
        self.site = 0

    def __call__(self, x):
        if self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))

    def kernel_args(self):
        if self.rate == 0.0:
            return 0.0, 0
        if self.site >= len(self.seeds):
            raise RuntimeError(f"more than {len(self.seeds)} kernel dropout "
                               f"sites in one forward")
        self.site += 1
        return self.rate, self.seeds[self.site - 1]


def apply_dropout(drop, x):
    """``drop(x)`` in a training forward, ``x`` in eval (drop is None)."""
    return x if drop is None else drop(x)


def kernel_dropout(drop):
    """(rate, seed) for a fused kernel: (0, 0) in eval."""
    return (0.0, 0) if drop is None else drop.kernel_args()


def dense(x, lin, dtype):
    """``lin`` (an ``nn.Linear``) applied in ``dtype``, like flax Dense."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class LayerNorm(nn.Module):
    """LayerNorm parameters (``weight``/``bias``, the reference's names)
    with flax numerics; see module docstring."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias).to(self.dtype)


class MLPBridge(nn.Sequential):
    """LN -> Dropout -> Linear -> ReLU -> LN: ``bert_word_encoding_fc`` /
    ``vid_fc`` (reference stage.py:85-113).  Built with ``use_kernel`` (the
    JAX module's ``use_pallas`` field, off by default and left off by
    STAGE) a 4-D input goes through the fused bridge kernel
    (ops/mlp_bridge.py), dropout included, in the module's dtype as the
    kernel's compute mode and output type (JAX layers.py:345-348)."""

    def __init__(self, in_hsz, out_hsz, dropout=0.1, dtype=torch.float32,
                 use_kernel=False):
        super().__init__(LayerNorm(in_hsz, dtype), nn.Dropout(dropout),
                         nn.Linear(in_hsz, out_hsz), nn.ReLU(),
                         LayerNorm(out_hsz, dtype))
        self.dtype = dtype
        self.use_kernel = use_kernel

    def forward(self, x, drop=None):
        if self.use_kernel and x.dim() == 4:
            ln_in, fc, ln_out = self[0], self[2], self[4]
            return mlp_bridge(x.contiguous(), ln_in.weight, ln_in.bias,
                              fc.weight.t(), fc.bias, ln_out.weight,
                              ln_out.bias, *kernel_dropout(drop),
                              compute_dtype=self.dtype)
        x = apply_dropout(drop, self[0](x))
        return self[4](torch.relu(dense(x, self[2], self.dtype)))


class TriMLPBridge(MLPBridge):
    """``concat_fc``: the MLPBridge recipe on [s; v; s*v] (reference
    stage.py:107-113, 300-302), through the fused tri-bridge kernel on CUDA
    (ops/tri_bridge.py) — the 3D-wide concat is never materialised."""

    def __init__(self, hsz, dropout=0.1, dtype=torch.float32):
        super().__init__(3 * hsz, hsz, dropout, dtype)

    def forward(self, s, v, drop=None):
        ln_in, fc, ln_out = self[0], self[2], self[4]
        return tri_bridge(s, v, ln_in.weight, ln_in.bias, fc.weight.t(),
                          fc.bias, ln_out.weight, ln_out.bias,
                          *kernel_dropout(drop))


class InputEmbedding(nn.Sequential):
    """Dropout -> Linear -> ReLU -> LN: ``input_embedding``
    (reference stage.py:115-120)."""

    def __init__(self, in_hsz, out_hsz, dropout=0.1, dtype=torch.float32):
        super().__init__(nn.Dropout(dropout), nn.Linear(in_hsz, out_hsz),
                         nn.ReLU(), LayerNorm(out_hsz, dtype))
        self.dtype = dtype

    def forward(self, x, drop=None):
        x = apply_dropout(drop, x)
        return self[3](torch.relu(dense(x, self[1], self.dtype)))


class DownProjection(nn.Sequential):
    """LN -> Dropout -> Linear -> ReLU: ``c2q_down_projection``
    (reference stage.py:133-138), with the exact variance of
    layers.py:394-401.  STAGE hands its parameters to the fused attention
    kernel; ``forward`` is the unfused layer (STAGE's plain attention
    route)."""

    def __init__(self, in_hsz, out_hsz, dropout=0.1, dtype=torch.float32):
        super().__init__(LayerNorm(in_hsz, dtype), nn.Dropout(dropout),
                         nn.Linear(in_hsz, out_hsz), nn.ReLU())
        self.dtype = dtype

    def forward(self, x, drop=None):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        ln = self[0]
        x = (x - mean) * torch.rsqrt(var + LN_EPS) * ln.weight + ln.bias
        return torch.relu(dense(apply_dropout(drop, x), self[2], self.dtype))


class DepthwiseSeparableConv(nn.Module):
    """Same-padded depthwise-separable 1-D conv + ReLU over (..., L, D)
    (reference cnn.py:6-47): k shifted FMAs, then the pointwise matmul."""

    def __init__(self, in_ch, out_ch, kernel_size, dtype=torch.float32):
        super().__init__()
        self.depthwise_conv = nn.Conv1d(in_ch, in_ch, kernel_size,
                                        groups=in_ch,
                                        padding=kernel_size // 2)
        self.pointwise_conv = nn.Conv1d(in_ch, out_ch, 1)
        self.dtype = dtype

    @property
    def dw(self):
        """Depthwise taps as (k, D), the JAX layout."""
        return self.depthwise_conv.weight[:, 0, :].t()

    @property
    def pw(self):
        """Pointwise weight as (in, out), the JAX layout."""
        return self.pointwise_conv.weight[:, :, 0].t()

    def forward(self, x):
        dt = self.dtype
        c = depthwise_conv(x.to(dt), self.dw.to(dt),
                           self.depthwise_conv.bias.to(dt))
        return torch.relu(c @ self.pw.to(dt)
                          + self.pointwise_conv.bias.to(dt))


class LinearWrapper(nn.Module):
    """[LN] -> Dropout -> Linear [-> ReLU] (reference stage.py:15-32)."""

    def __init__(self, in_hsz, out_hsz, relu=True, dropout=0.1,
                 dtype=torch.float32):
        super().__init__()
        self.conv = nn.Sequential(LayerNorm(in_hsz, dtype),
                                  nn.Dropout(dropout),
                                  nn.Linear(in_hsz, out_hsz))
        self.relu = relu
        self.dtype = dtype

    def forward(self, x, drop=None):
        x = dense(apply_dropout(drop, self.conv[0](x)), self.conv[2],
                  self.dtype)
        return torch.relu(x) if self.relu else x


class ConvLinear(nn.Module):
    """[LN] -> Dropout -> DepthwiseSeparableConv (reference stage.py:35-52;
    the t_iter > 0 projection layers)."""

    def __init__(self, in_hsz, out_hsz, kernel_size=3, dropout=0.1,
                 dtype=torch.float32):
        super().__init__()
        self.conv = nn.Sequential(
            LayerNorm(in_hsz, dtype), nn.Dropout(dropout),
            DepthwiseSeparableConv(in_hsz, out_hsz, kernel_size, dtype))

    def forward(self, x, drop=None):
        return self.conv[2](apply_dropout(drop, self.conv[0](x)))


def sinusoid_table(max_len, d):
    """Fixed sin/cos positional table (reference position_encoding.py:24-31),
    float32 (max_len, d), built on the CPU; see ``PositionEncoding.table``."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                         * -(math.log(10000.0) / d))
    pe = torch.zeros(max_len, d)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class PositionEncoding(nn.Module):
    """Add the sinusoid table to any (..., L, D) input.  Holds no
    parameter or buffer: the reference's fixed ``position_encoding.pe`` is
    recomputed (``table``), so it is neither saved nor loaded."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self._tables = {}

    def table(self, max_len, d, device, dtype):
        """``sinusoid_table(max_len, d)`` in ``dtype`` on ``device``, built
        once per (shape, device, dtype) and kept, so a step copies nothing
        from the host (a copy from pageable memory cannot be captured in a
        CUDA graph)."""
        key = (max_len, d, torch.device(device), dtype)
        if key not in self._tables:
            with torch.inference_mode(False):   # serves training steps too
                self._tables[key] = sinusoid_table(max_len, d).to(device,
                                                                  dtype)
        return self._tables[key]

    def forward(self, x):
        return x + self.table(x.shape[-2], x.shape[-1], x.device, self.dtype)


class EncoderBlock(nn.Module):
    """QANet-style conv block (reference encoder.py:9-52) at n_conv=2 and no
    attention heads: PE, 2 x [LN -> dsconv -> residual], final LN.

    With ``reduce_mask`` it returns ``max over L of mask_logits(out, m)``
    through the fused encoder kernel (ops/encoder.py).  Without, the block
    output: through the kernel's full-output mode when the block was built
    with ``use_kernel`` (the merged input encoder), else in plain PyTorch
    (the separate k=7 input-encoder sites, which the JAX package also
    leaves unfused).

    ``zero_mask`` (broadcastable to x.shape[:-1]) re-zeroes each conv's
    input where it is 0, so a tap that reads past a sequence's true length
    sees the zeros that per-stream padding would give (the merged-stream
    contract, JAX layers.py:247-254); positions where it is 0 come out as
    garbage for the caller to slice away.  The kernel takes a (G, L) mask
    on a 4-D input, or none."""

    def __init__(self, hsz, n_conv=2, kernel_size=7, num_heads=0,
                 dropout=0.1, dtype=torch.float32, use_kernel=False):
        super().__init__()
        if n_conv != 2 or num_heads:
            raise NotImplementedError(
                "the port's encoder block takes n_conv=2 and no heads")
        self.position_encoding = PositionEncoding(dtype)
        self.layer_norm = nn.ModuleList(LayerNorm(hsz, dtype)
                                        for _ in range(n_conv))
        self.conv = nn.ModuleList(
            DepthwiseSeparableConv(hsz, hsz, kernel_size, dtype)
            for _ in range(n_conv))
        self.final_layer_norm = LayerNorm(hsz, dtype)
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.use_kernel = use_kernel

    def kernel_params(self):
        """The 14 parameters in the fused kernel's layout and keys."""
        p = {"lnf_s": self.final_layer_norm.weight,
             "lnf_b": self.final_layer_norm.bias}
        for i in (0, 1):
            conv = self.conv[i]
            p.update({f"ln{i}_s": self.layer_norm[i].weight,
                      f"ln{i}_b": self.layer_norm[i].bias,
                      f"dw{i}": conv.dw,
                      f"dwb{i}": conv.depthwise_conv.bias,
                      f"pw{i}": conv.pw,
                      f"pwb{i}": conv.pointwise_conv.bias})
        return p

    def forward(self, x, reduce_mask=None, drop=None, zero_mask=None):
        lead, (l, d) = x.shape[:-2], x.shape[-2:]
        if reduce_mask is not None:
            if zero_mask is not None:
                raise NotImplementedError("reduce_mask with a zero_mask")
            out = encoder_reduce(
                x.reshape(lead[0], -1, l, d).contiguous(),
                self.position_encoding.table(l, d, x.device, torch.float32),
                self.kernel_params(), self.kernel_size,
                reduce_mask.reshape(lead[0], -1, l),
                *kernel_dropout(drop))
            return out.reshape(lead + (d,))
        zm_fusable = zero_mask is None or (
            zero_mask.dim() == 2 and x.dim() == 4
            and zero_mask.shape == x.shape[1:3])
        if self.use_kernel and x.dim() >= 3 and zm_fusable:
            out = encoder_block(
                x.reshape(lead[0], -1, l, d).contiguous(),
                self.position_encoding.table(l, d, x.device, torch.float32),
                self.kernel_params(), self.kernel_size, zero_mask,
                *kernel_dropout(drop))
            return out.reshape(x.shape)
        out = self.position_encoding(x)
        for i, (ln, conv) in enumerate(zip(self.layer_norm, self.conv)):
            t = ln(out)
            if i % 2 == 0:     # dropout on even conv layers (encoder.py:41)
                t = apply_dropout(drop, t)
            if zero_mask is not None:
                t = t * zero_mask[..., None].to(t.dtype)
            out = conv(t) + out
        return self.final_layer_norm(out)


class StackedEncoder(nn.Module):
    """n_blocks stacked EncoderBlocks (reference encoder.py:55-74); the
    ``reduce_mask`` of the last block folds in the masked word-max, every
    block takes the ``zero_mask``."""

    def __init__(self, n_blocks=1, n_conv=2, kernel_size=7, num_heads=0,
                 hsz=128, dropout=0.1, dtype=torch.float32,
                 use_kernel=False):
        super().__init__()
        self.stacked_encoderBlocks = nn.ModuleList(
            EncoderBlock(hsz, n_conv, kernel_size, num_heads, dropout, dtype,
                         use_kernel)
            for _ in range(n_blocks))

    def forward(self, x, reduce_mask=None, drop=None, zero_mask=None):
        last = len(self.stacked_encoderBlocks) - 1
        for i, block in enumerate(self.stacked_encoderBlocks):
            x = block(x, reduce_mask if i == last else None, drop, zero_mask)
        return x
