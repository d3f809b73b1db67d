"""Plain tensor math shared by the kernels' plain versions and the model
layers, written out so it matches the JAX package's numerics."""
from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def layer_norm(x, scale, bias, clip=True, n=None):
    """flax ``LayerNorm`` numerics in float32: fast variance
    E[x^2] - E[x]^2, clipped at 0 unless ``clip=False`` (the fused
    attention kernel's LN, pallas_attention.py:147-151).  ``n``: the true
    width of an ``x`` whose last dim is zero-padded past it (the sums are
    divided by ``n``; the pad columns come out as ``bias``, zero when the
    caller pads ``scale`` and ``bias`` with zeros).  Returns float32."""
    x = x.float()
    if n is None or n == x.shape[-1]:
        mean = x.mean(-1, keepdim=True)
        var = (x * x).mean(-1, keepdim=True) - mean * mean
    else:
        mean = x.sum(-1, keepdim=True) / n
        var = (x * x).sum(-1, keepdim=True) / n - mean * mean
    if clip:
        var = torch.clamp(var, min=0.0)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale.float() \
        + bias.float()


def depthwise_conv(x, dw, dwb):
    """Same-padded depthwise conv along L of (..., L, D) as k shifted FMAs
    (models/layers.py _DSConvParams); ``dw`` is (k, D), ``dwb`` (D,)."""
    k, l = dw.shape[0], x.shape[-2]
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + dw[j].to(x.dtype) * xp[..., j:j + l, :]
    return out + dwb.to(x.dtype)


def round_bf16(x):
    """float32 ``x`` rounded to the nearest bfloat16 value (round to nearest
    even, as the kernels' ``__float2bfloat16``)."""
    return x.to(torch.bfloat16).to(torch.float32)


class Bf16Dot(torch.autograd.Function):
    """``a @ b`` (broadcast over leading dims) as the bf16 tensor-core
    kernels and the TPU kernels' bf16 compute mode take a product: both
    operands rounded to bfloat16, float32 sums; the backward's two products
    round their operands (cotangent included) the same way
    (pallas_attention.py:323-379, pallas_encoder.py:219-226,
    pallas_tri_bridge.py:157-162).  The rounding has gradient 1."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(ar, br)
        ctx.shapes = (a.shape, b.shape)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = round_bf16(g)
        ga = (gr @ br.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        gb = (ar.transpose(-1, -2) @ gr).sum_to_size(ctx.shapes[1])
        return ga, gb


def dot(a, b, bf16):
    """``a @ b`` in float32, or with the bf16 compute mode's rounding sites
    (``Bf16Dot``) when ``bf16``."""
    return Bf16Dot.apply(a, b) if bf16 else a @ b


def as_f32(t):
    """Small parameter tensor as contiguous float32 with 16-byte alignment
    (the kernels read parameters as float4)."""
    t = t.detach().to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
