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
from tvqaplus_tpu_torch.ops.masking import mask_logits
from tvqaplus_tpu_torch.ops.mlp_bridge import mlp_bridge
from tvqaplus_tpu_torch.ops.plain import LN_EPS, depthwise_conv, layer_norm
from tvqaplus_tpu_torch.ops.tri_bridge import tri_bridge
from tvqaplus_tpu_torch.parallel import mesh as dp


class Dropout:
    """The dropout of one training forward (reference rate ``rate``):
    ``drop(x)`` for a plain layer, with its mask from ``generator`` (on the
    batch's device); ``kernel_args()`` gives the fused kernels, one call
    site after the other, their (rate, Philox seed): the next slot of
    ``seeds``, the step's int64 seed tensor on the batch's device
    (``StepSeeds.next()``).

    ``frames``: the dropout of the sites on Li-sharded tensors under
    context parallelism (parallel/mesh.py), another ``Dropout`` whose
    generator and seeds fold in the ctx rank; without it (no ctx axis)
    this one, so the draws keep their order."""

    def __init__(self, rate, generator, seeds, frames=None):
        self.rate = float(rate)
        self.generator = generator
        self.seeds = seeds
        self.site = 0
        self.frames = self if frames is None else frames

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


class GroupDropout:
    """``drop`` on a ctx rank's share of a group axis: ``groups`` is the
    group map (gmap, g_glob) of the merged input encoder (ops/encoder.py),
    ``batch`` the leading batch size.  Each call draws ``drop``'s mask for
    all g_glob groups, as one process draws it, and keeps the rows of the
    rank's groups, so every group takes the mask one process gives it at
    its global place and the generator advances as one process's does.
    ``x`` is laid out (batch, groups, ...) or (batch * groups, ...)."""

    def __init__(self, drop, groups, batch):
        self.drop = drop
        self.gmap, self.g_glob = groups
        self.batch = batch

    def __call__(self, x):
        rate = self.drop.rate
        if rate == 0.0:
            return x
        g = self.gmap.numel()
        rand = torch.rand((self.batch, self.g_glob, x.numel() // (
            self.batch * g)), generator=self.drop.generator, device=x.device)
        keep = (rand[:, self.gmap.long()] >= rate).reshape(x.shape)
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def apply_dropout(drop, x):
    """``drop(x)`` in a training forward, ``x`` in eval (drop is None)."""
    return x if drop is None else drop(x)


def kernel_dropout(drop):
    """(rate, seed) for a fused kernel: (0, 0) in eval."""
    return (0.0, 0) if drop is None else drop.kernel_args()


def frame_dropout(drop):
    """The dropout of the Li-sharded sites (``Dropout.frames``); None in
    eval."""
    return None if drop is None else drop.frames


def dense(x, lin, dtype):
    """``lin`` (an ``nn.Linear``) applied in ``dtype``, like flax Dense.
    A layer split over the model axis (``lin.shard``, parallel/mesh.py
    ``place_model``) holds its block of output columns: the product of
    that block, all-gathered over the model group, then the whole bias,
    so the bias's gradient is whole on every model rank as every
    replicated leaf's is."""
    shard = getattr(lin, "shard", None)
    if shard is None:
        return F.linear(x.to(dtype), lin.weight.to(dtype),
                        lin.bias.to(dtype))
    h = F.linear(dp.copy_to_model(shard, x.to(dtype)),
                 lin.weight.to(dtype))
    return dp.gather_columns(shard, h) + lin.bias.to(dtype)


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
            if getattr(fc, "shard", None) is not None:
                raise NotImplementedError(
                    "the MLP-bridge kernel takes whole weights: B5 at "
                    "model > 1 is not ported (ROADMAP.md, B5 at model > 1)")
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
        return tri_bridge(s, v, ln_in.weight, ln_in.bias,
                          dp.whole_weight(fc).t(), fc.bias, ln_out.weight,
                          ln_out.bias, *kernel_dropout(drop))


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
        """Pointwise weight as (in, out), the JAX layout: whole, gathered
        over the model axis when that splits it (parallel/mesh.py
        ``whole_weight``)."""
        return dp.whole_weight(self.pointwise_conv)[:, :, 0].t()

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


class MultiHeadedAttention(nn.Module):
    """Annotated-Transformer multi-head self-attention (JAX layers.py:
    142-177, reference self_attention.py:19-71): ``linears`` 0-3 are the
    q, k, v and output projections, scores scaled by ``1/sqrt(dk)``.  It
    keeps the reference's quirk of masking *query* rows: ``mask`` (x's
    leading dims + (L,)) is laid out (N, 1, L, 1), so a padded position's
    own row gets -1e9 everywhere (uniform weights) and the valid rows are
    left as they are.  Leading dims are flattened; ``drop`` acts on the
    attention weights."""

    def __init__(self, hsz, num_heads, dtype=torch.float32):
        super().__init__()
        if hsz % num_heads:
            raise ValueError(f"{num_heads} heads do not divide {hsz}")
        self.linears = nn.ModuleList(nn.Linear(hsz, hsz) for _ in range(4))
        self.num_heads = num_heads
        self.dtype = dtype

    def forward(self, x, mask=None, drop=None):
        lead, (l, d) = x.shape[:-2], x.shape[-2:]
        x = x.reshape(-1, l, d)
        n, nh = x.shape[0], self.num_heads
        dk = d // nh
        q, k, v = (dense(x, lin, self.dtype).reshape(n, l, nh, dk)
                   .transpose(1, 2) for lin in self.linears[:3])
        scores = q @ k.transpose(-2, -1) / math.sqrt(dk)
        if mask is not None:
            m = mask.reshape(n, 1, l, 1)
            scores = scores.masked_fill(m == 0, -1e9)
        attn = apply_dropout(drop, torch.softmax(scores, dim=-1))
        out = (attn @ v).transpose(1, 2).reshape(n, l, d)
        return dense(out, self.linears[3], self.dtype).reshape(lead + (l, d))


class NormalizeScale(nn.Module):
    """L2-normalise over axis 1, then scale by a learned per-dim weight
    (JAX layers.py:513-526, reference model_utils.py:23-34; STAGE does not
    use it)."""

    def __init__(self, dim, init_norm=20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((dim,), float(init_norm)))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / torch.clamp(norm, min=1e-12) * self.weight


class EncoderBlock(nn.Module):
    """QANet-style block (reference encoder.py:9-52): PE, n_conv x [LN ->
    (dropout on even convs) -> dsconv -> residual], with ``num_heads`` the
    attention branch [LN -> ``MultiHeadedAttention(mask)`` -> residual],
    then the final LN.

    The encoder kernel (ops/encoder.py) runs the block where the JAX
    package's predicate runs its Pallas kernel (layers.py:259-263): only
    at n_conv = 2 without heads, on an input of 3 dims or more (``fused``).
    There, with ``reduce_mask`` it returns ``max over L of mask_logits(out,
    m)``, and without it the block output through the kernel's full-output
    mode when the block was built with ``use_kernel`` (the merged input
    encoder).  Every other call runs the plain chain below, the JAX
    package's unfused route: the separate k=7 input-encoder sites, which
    the JAX package leaves unfused too, and any block with heads or another
    conv depth, where ``reduce_mask`` is applied after it as
    ``max(mask_logits(out, m), -2)``.

    ``zero_mask`` (broadcastable to x.shape[:-1]) re-zeroes each conv's
    input where it is 0, so a tap that reads past a sequence's true length
    sees the zeros that per-stream padding would give (the merged-stream
    contract, JAX layers.py:247-254); positions where it is 0 come out as
    garbage for the caller to slice away.  The kernel takes a (G, L) mask
    on a 4-D input, or none.  ``groups``: the group map of the merged
    input encoder under context parallelism (ops/encoder.py): the kernel
    keys its masks through it, the plain chain draws them through
    ``GroupDropout``, so a rank's frames take one process's masks either
    way."""

    def __init__(self, hsz, n_conv=2, kernel_size=7, num_heads=0,
                 dropout=0.1, dtype=torch.float32, use_kernel=False):
        super().__init__()
        self.position_encoding = PositionEncoding(dtype)
        self.layer_norm = nn.ModuleList(LayerNorm(hsz, dtype)
                                        for _ in range(n_conv))
        self.conv = nn.ModuleList(
            DepthwiseSeparableConv(hsz, hsz, kernel_size, dtype)
            for _ in range(n_conv))
        if num_heads:
            self.attn_layer_norm = LayerNorm(hsz, dtype)
            self.attn = MultiHeadedAttention(hsz, num_heads, dtype)
        self.final_layer_norm = LayerNorm(hsz, dtype)
        self.n_conv = n_conv
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.use_kernel = use_kernel

    def fused(self, x, reduce_mask=None, zero_mask=None):
        """Whether this call runs the encoder kernel (see the class
        docstring): decided by the block's shape and the call's inputs,
        never by a failed build or launch."""
        if self.n_conv != 2 or self.num_heads or x.dim() < 3:
            return False
        if reduce_mask is not None:
            return True
        return self.use_kernel and (zero_mask is None or (
            zero_mask.dim() == 2 and x.dim() == 4
            and zero_mask.shape == x.shape[1:3]))

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

    def forward(self, x, reduce_mask=None, drop=None, zero_mask=None,
                mask=None, groups=None):
        """``mask`` (x's leading dims + (L,)): the attention branch's mask
        (blocks with heads only)."""
        lead, (l, d) = x.shape[:-2], x.shape[-2:]
        if self.fused(x, reduce_mask, zero_mask):
            pe = self.position_encoding.table(l, d, x.device, torch.float32)
            xg = x.reshape(lead[0], -1, l, d).contiguous()
            if reduce_mask is None:
                return encoder_block(xg, pe, self.kernel_params(),
                                     self.kernel_size, zero_mask,
                                     *kernel_dropout(drop),
                                     groups=groups).reshape(x.shape)
            if zero_mask is not None:
                raise NotImplementedError("reduce_mask with a zero_mask")
            out = encoder_reduce(xg, pe, self.kernel_params(),
                                 self.kernel_size,
                                 reduce_mask.reshape(lead[0], -1, l),
                                 *kernel_dropout(drop))
            return out.reshape(lead + (d,))
        if drop is not None and groups is not None:
            drop = GroupDropout(drop, groups, lead[0])
        out = self.position_encoding(x)
        for i, (ln, conv) in enumerate(zip(self.layer_norm, self.conv)):
            t = ln(out)
            if i % 2 == 0:     # dropout on even conv layers (encoder.py:41)
                t = apply_dropout(drop, t)
            if zero_mask is not None:
                t = t * zero_mask[..., None].to(t.dtype)
            out = conv(t) + out
        if self.num_heads:
            out = self.attn(self.attn_layer_norm(out), mask, drop) + out
        out = self.final_layer_norm(out)
        if reduce_mask is not None:
            return mask_logits(out, reduce_mask[..., None]).amax(dim=-2)
        return out


class StackedEncoder(nn.Module):
    """n_blocks stacked EncoderBlocks (reference encoder.py:55-74); the
    ``reduce_mask`` of the last block folds in the masked word-max, every
    block takes the ``zero_mask``, the attention ``mask`` and the kernel's
    ``groups``."""

    def __init__(self, n_blocks=1, n_conv=2, kernel_size=7, num_heads=0,
                 hsz=128, dropout=0.1, dtype=torch.float32,
                 use_kernel=False):
        super().__init__()
        self.stacked_encoderBlocks = nn.ModuleList(
            EncoderBlock(hsz, n_conv, kernel_size, num_heads, dropout, dtype,
                         use_kernel)
            for _ in range(n_blocks))

    def forward(self, x, reduce_mask=None, drop=None, zero_mask=None,
                mask=None, groups=None):
        last = len(self.stacked_encoderBlocks) - 1
        for i, block in enumerate(self.stacked_encoderBlocks):
            x = block(x, reduce_mask if i == last else None, drop, zero_mask,
                      mask, groups)
        return x
