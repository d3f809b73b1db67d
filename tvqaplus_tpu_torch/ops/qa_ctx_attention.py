"""Fused QA-context attention, forward and backward (port of
``tvqaplus_tpu/ops/pallas_attention.py`` ``fused_qa_ctx_attention``).

Structured cosine attention of every QA word over the regions (or
subtitle tokens) of every frame, then the BiDAF-style [ce; att; ce*att]
LayerNorm + dropout + down-projection + ReLU of STAGE's
``c2q_down_projection`` (reference stage.py:365-387).  The CUDA kernels are
``csrc/qa_ctx_attention_fwd.cu`` and ``csrc/qa_ctx_attention_bwd.cu``
behind one ``torch.autograd.Function``; ``qa_ctx_attention_plain`` is the
same function in plain PyTorch, and autograd through it is the plain
backward.

The projection dropout acts on the (B*A*Li*Lqa, 3D) LN output, keyed by
(seed, flat index) through Philox (ops/philox.py), so the kernels and the
plain version draw the same mask.
"""
from __future__ import annotations

import ctypes

import torch

from tvqaplus_tpu_torch.ops import philox
from tvqaplus_tpu_torch.ops._build import (
    CudaKernel,
    check_device,
    ptr,
    wgrad_chunks,
)
from tvqaplus_tpu_torch.ops.masking import SAFE_FLOOR
from tvqaplus_tpu_torch.ops.plain import as_f32, layer_norm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U64, _U32 = ctypes.c_ulonglong, ctypes.c_uint
KERNEL = CudaKernel("qa_ctx_attention_fwd.cu", "qa_ctx_attention_fwd",
                    [_P] * 13 + [_I] * 5 + [_F, _U64, _U32, _F, _I, _P])
BWD_KERNEL = CudaKernel("qa_ctx_attention_bwd.cu", "qa_ctx_attention_bwd",
                        [_P] * 25 + [_I] * 5 + [_F, _U64, _U32, _F, _I, _I,
                                                _P])

# Kernel vs plain version on the same inputs.  float32: only the order of
# the float32 sums differs.  bfloat16 activations (compared against the
# plain version on the same bf16 values in float32): ``mixed`` is rounded
# to bf16 once on output (relative step 2**-8); ``raw`` stays float32.
TOL = {torch.float32: dict(mixed=(1e-4, 1e-4), raw=(1e-4, 1e-4)),
       torch.bfloat16: dict(mixed=(2e-2, 1e-2), raw=(1e-4, 1e-4))}
# Backward kernel vs autograd through the plain version, same inputs and
# cotangents.  float32: sums over up to A*Lqa rows and Li frames in another
# order, relative to the largest gradient.  bfloat16: the activation
# gradients are rounded to bf16 once (relative step 2**-8) and the
# cotangent g_mixed enters as bf16 on both sides.
GRAD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
RAW_MODES = ("full", "none", "target")
MAX_REGIONS = 64


def qa_ctx_attention_plain(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b,
                           scale=10.0, raw_mode="full", targets=None,
                           dropout_rate=0.0, seed=0):
    """Plain PyTorch version of the kernels.  cn/ce (B, A, Lqa, D); qn/qe
    (B, Li, Lr, D); c_mask (B, A, Lqa); q_mask (B, Li, Lr); gamma/beta
    (3D,); w (3D, D); b (D,); targets (B,) int for ``raw_mode="target"``.
    Returns mixed (B, A, Li, Lqa, D) in cn's dtype and the raw scores in
    float32: (B, A, Li, Lqa, Lr) for "full", (B, Li, Lqa, Lr) at each
    target answer for "target", none for "none"."""
    s = torch.einsum("bawd,bird->baiwr", cn.float(), qn.float())
    s_mask = (c_mask.float()[:, :, None, :, None]
              * q_mask.float()[:, None, :, None, :])
    masked = s - 1e10 * (1.0 - s_mask)
    p = torch.softmax(torch.clamp(masked * scale, min=SAFE_FLOOR), dim=-1)
    att = torch.einsum("baiwr,bird->baiwd", p * s_mask, qe.float())
    ce_b = ce.float()[:, :, None].expand_as(att)
    x = torch.cat([ce_b, att, ce_b * att], dim=-1)
    y = layer_norm(x, gamma, beta, clip=False)
    if dropout_rate > 0.0:
        y = y * philox.multiplier(y.shape, seed, dropout_rate, y.device)
    mixed = torch.relu(y @ w.float() + b.float()).to(cn.dtype)
    if raw_mode == "full":
        return mixed, masked
    if raw_mode == "target":
        return mixed, masked[torch.arange(masked.shape[0],
                                          device=masked.device),
                             targets.long()]
    return mixed


def _check(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, raw_mode,
           targets):
    bsz, num_a, lqa, d = cn.shape
    _, li, lr, _ = qn.shape
    dt = cn.dtype
    check_device(cn.device, ce=ce, qn=qn, qe=qe)
    for name, t, shape in (("ce", ce, cn.shape), ("qn", qn, qn.shape),
                           ("qe", qe, qn.shape)):
        if t.shape != shape or t.dtype != dt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(shape)} {dt}")
    if qn.shape[0] != bsz or d != 128 or lr > MAX_REGIONS:
        raise ValueError(f"kernel takes D == 128 and Lr <= {MAX_REGIONS}; "
                         f"got cn {tuple(cn.shape)}, qn {tuple(qn.shape)}")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"activations must be float32 or bfloat16, not {dt}")
    if not all(t.is_contiguous() for t in (cn, ce, qn, qe)):
        raise ValueError("cn/ce/qn/qe must be contiguous")
    if c_mask.shape != (bsz, num_a, lqa) or q_mask.shape != (bsz, li, lr):
        raise ValueError("mask shapes do not match the activations")
    cm, qm = as_f32(c_mask), as_f32(q_mask)
    gamma, beta, w, b = (as_f32(t) for t in (gamma, beta, w, b))
    check_device(cn.device, c_mask=cm, q_mask=qm, gamma=gamma, beta=beta,
                 w=w, b=b)
    if w.shape != (3 * d, d) or gamma.shape != (3 * d,) \
            or beta.shape != (3 * d,) or b.shape != (d,):
        raise ValueError("projection parameters do not match D")
    tg = None
    if raw_mode == "target":
        if targets is None or targets.shape != (bsz,):
            raise ValueError("raw_mode 'target' needs targets of shape (B,)")
        tg = targets.to(torch.int32).contiguous()
        check_device(cn.device, targets=tg)
    return cm, qm, gamma, beta, w, b, tg


class _QaCtxAttention(torch.autograd.Function):
    """The forward and backward CUDA kernels as one differentiable op."""

    @staticmethod
    def forward(ctx, cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b,
                targets, scale, raw_mode, dropout_rate, seed):
        cm, qm, g32, b32, w32, bias32, tg = _check(
            cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, raw_mode,
            targets)
        bsz, num_a, lqa, d = cn.shape
        _, li, lr, _ = qn.shape
        dev = cn.device
        mixed = torch.empty((bsz, num_a, li, lqa, d), dtype=cn.dtype,
                            device=dev)
        raw = None
        if raw_mode == "full":
            raw = torch.empty((bsz, num_a, li, lqa, lr), dtype=torch.float32,
                              device=dev)
        elif raw_mode == "target":
            raw = torch.empty((bsz, li, lqa, lr), dtype=torch.float32,
                              device=dev)
        KERNEL.launch(dev, ptr(cn), ptr(ce), ptr(qn), ptr(qe), ptr(cm),
                      ptr(qm), ptr(g32), ptr(b32), ptr(w32), ptr(bias32),
                      ptr(tg) if tg is not None else None, ptr(mixed),
                      ptr(raw) if raw is not None else None,
                      bsz, num_a, lqa, li, lr, float(scale),
                      *philox.kernel_args(dropout_rate, seed),
                      int(cn.dtype == torch.bfloat16))
        ctx.save_for_backward(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w,
                              b, targets, mixed)
        ctx.cfg = (scale, raw_mode, dropout_rate, seed)
        return (mixed, raw) if raw is not None else mixed

    @staticmethod
    def backward(ctx, g_mixed, g_raw=None):
        (cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, targets,
         mixed) = ctx.saved_tensors
        scale, raw_mode, dropout_rate, seed = ctx.cfg
        grads = qa_ctx_attention_backward(
            cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, g_mixed,
            g_raw, mixed, scale, raw_mode, targets, dropout_rate, seed)
        return grads[:4] + (None, None) + grads[4:] + (None,) * 5


def qa_ctx_attention_backward(cn, ce, qn, qe, c_mask, q_mask, gamma, beta,
                              w, b, g_mixed, g_raw, mixed, scale=10.0,
                              raw_mode="full", targets=None,
                              dropout_rate=0.0, seed=0):
    """Launch the backward kernel (CUDA tensors only).  Returns the
    gradients of (cn, ce, qn, qe) in their dtype and of (gamma, beta, w, b)
    in float32.  ``mixed`` is the saved forward output (the ReLU sign);
    ``g_raw`` may be None (no raw cotangent)."""
    cm, qm, g32, b32, w32, bias32, tg = _check(
        cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, raw_mode, targets)
    bsz, num_a, lqa, d = cn.shape
    _, li, lr, _ = qn.shape
    dev, dt = cn.device, cn.dtype
    g_mixed = g_mixed.to(dt).contiguous()
    if g_mixed.shape != mixed.shape:
        raise ValueError("g_mixed does not match mixed")
    graw = None
    if raw_mode != "none" and g_raw is not None:
        graw = g_raw.to(torch.float32).contiguous()
    rows = bsz * li * num_a * lqa
    f32 = dict(dtype=torch.float32, device=dev)
    chunks = wgrad_chunks(rows, 3 * d)
    gcn, gce = torch.empty_like(cn), torch.empty_like(ce)
    gqn, gqe = torch.empty_like(qn), torch.empty_like(qe)
    gvec = torch.empty(7 * d, **f32)
    gw = torch.empty(3 * d, d, **f32)
    scratch = [torch.empty(bsz, li, num_a * lqa, d, **f32),
               torch.empty(bsz, li, num_a * lqa, d, **f32),
               torch.empty(rows, 3 * d, **f32), torch.empty(rows, d, **f32),
               torch.empty(bsz * li, 7 * d, **f32),
               torch.empty(chunks, 3 * d, d, **f32)]
    wt = as_f32(w32.t())
    BWD_KERNEL.launch(
        dev, ptr(cn), ptr(ce), ptr(qn), ptr(qe), ptr(cm), ptr(qm), ptr(g32),
        ptr(b32), ptr(wt), ptr(g_mixed), ptr(mixed),
        ptr(graw) if graw is not None else None,
        ptr(tg) if (tg is not None and graw is not None) else None,
        ptr(gcn), ptr(gce), ptr(gqn), ptr(gqe), ptr(gvec), ptr(gw),
        *(ptr(t) for t in scratch), bsz, num_a, lqa, li, lr, float(scale),
        *philox.kernel_args(dropout_rate, seed), chunks,
        int(dt == torch.bfloat16))
    return (gcn, gce, gqn, gqe, gvec[:3 * d], gvec[3 * d:6 * d], gw,
            gvec[6 * d:])


def qa_ctx_attention(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b,
                     scale=10.0, raw_mode="full", targets=None,
                     dropout_rate=0.0, seed=0):
    """Kernels on CUDA tensors (differentiable through the backward
    kernel), plain version on CPU tensors (autograd through it).  Same
    signature and outputs as ``qa_ctx_attention_plain``; ``seed`` keys the
    dropout (ops/philox.py)."""
    if raw_mode not in RAW_MODES:
        raise NotImplementedError(f"raw_mode {raw_mode!r}")
    if raw_mode == "target" and targets is None:
        raise ValueError("raw_mode 'target' needs targets of shape (B,)")
    if not cn.is_cuda:
        return qa_ctx_attention_plain(cn, ce, qn, qe, c_mask, q_mask, gamma,
                                      beta, w, b, scale, raw_mode, targets,
                                      dropout_rate, seed)
    return _QaCtxAttention.apply(cn, ce, qn, qe, c_mask, q_mask, gamma, beta,
                                 w, b, targets, scale, raw_mode,
                                 dropout_rate, seed)
