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
plain version draw the same mask.  On CUDA a width between the
instantiations runs padded (ops/widths.py: gamma, beta and W's rows third
by third), the kernels told the true width, ``mixed`` sliced back.

Two compute modes, chosen by the activations' type.  float32: exact, the
CUDA-core kernels.  bfloat16 (what the entry points run on the card): every
product takes bf16 operands with float32 sums, as the TPU kernel's bf16
compute mode does (pallas_attention.py:107-162, :323-379): the kernels run
them on the tensor cores, and the plain version rounds at the same sites
(``_plain_bf16``), so the two differ by the order of float32 sums only.
"""
from __future__ import annotations

import ctypes

import torch

from tvqaplus_tpu_torch.ops import philox, widths
from tvqaplus_tpu_torch.ops._build import (
    CudaKernel,
    check_device,
    ptr,
    tc_wgrad_chunks,
    wgrad_chunks,
)
from tvqaplus_tpu_torch.ops.masking import SAFE_FLOOR
from tvqaplus_tpu_torch.ops.plain import (
    Bf16Dot,
    as_f32,
    layer_norm,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U32 = ctypes.c_uint
# The forward entry takes the width D; each width has its own launch count
# (KERNEL counts D = 128, the headline hsz).
# (cn, ce, qn, qe, the masks, gamma, beta, W, bias, targets, mixed, raw,
# the slab scratch wp: widths.slab_scratch)
FWD_BY_WIDTH = {d: CudaKernel("qa_ctx_attention_fwd.cu",
                              "qa_ctx_attention_fwd",
                              [_P] * 14 + [_I] * 6
                              + [_F, _P, _U32, _F, _I, _I, _P])
                for d in widths.FORWARD_WIDTHS}
KERNEL = FWD_BY_WIDTH[128]
# ... the scale, the dropout, the weight-gradient chunks, the true width,
# the compute mode, the stream
_BWD_TAIL = [_F, _P, _U32, _F, _I, _I, _I, _P]
BWD_KERNEL = CudaKernel("qa_ctx_attention_bwd.cu", "qa_ctx_attention_bwd",
                        [_P] * 28 + [_I] * 5 + _BWD_TAIL)
# The backward at each width: D = 128 the tensor-core design above, 64 and
# 256 csrc/qa_ctx_attention_bwd_wide.cu's entry, which takes D (one count
# each)
BWD_BY_WIDTH = {d: BWD_KERNEL if d == 128 else CudaKernel(
    "qa_ctx_attention_bwd_wide.cu", "qa_ctx_attention_bwd_wide",
    [_P] * 28 + [_I] * 6 + _BWD_TAIL)
    for d in widths.BACKWARD_WIDTHS}

# Kernel vs plain version on the same inputs.  float32: only the order of
# the float32 sums differs.  bfloat16: the kernels (tensor cores) and the
# plain version round the same operands to bf16 and sum in float32, so
# ``mixed`` differs by the order of those sums (~1e-6), by an operand that
# such a difference moves across a bf16 rounding boundary (a moved softmax
# weight shifts a ReLU input by up to 4.9e-3 in 40M measured outputs: the
# absolute term allows twice that) and then by the output's own rounding,
# one bf16 step (2**-8 of the value, measured 0.0156-0.031 at the headline
# shapes: the relative term allows two); ``raw`` stays float32 and its
# bf16 x bf16 products are exact (measured 1.5e-7).
TOL = {torch.float32: dict(mixed=(1e-4, 1e-4), raw=(1e-4, 1e-4)),
       torch.bfloat16: dict(mixed=(1e-2, 2.0 ** -7), raw=(1e-4, 1e-4))}
# Backward kernel vs autograd through the plain version, same inputs and
# cotangents.  float32: sums over up to A*Lqa rows and Li frames in another
# order, relative to the largest gradient.  bfloat16: both sides round the
# same operands (cotangents included, ``Bf16Dot``); a gradient differs by
# moved roundings inside sums of up to 160,000 rows and by its own output
# rounding, measured up to 1.2e-2 of the largest entry (two bf16 steps of an
# activation gradient near its maximum): 1e-2 of the largest entry plus four
# bf16 steps of the entry itself.
GRAD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-2, 2.0 ** -6)}
RAW_MODES = ("full", "none", "target")
MAX_REGIONS = 64


def _plain_bf16(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, scale,
                dropout_rate, seed, dv):
    """The function with the rounding sites of the bf16 compute mode: every
    product takes bf16 operands (``Bf16Dot``); softmax, masks, LayerNorm,
    dropout and the raw scores stay float32.  Returns float32 mixed before
    the output cast and the masked scores, both in the (B, A, Li, Lqa, .)
    order."""
    bsz, num_a, lqa, d = cn.shape
    _, li, lr, _ = qn.shape
    m = num_a * lqa
    s = Bf16Dot.apply(cn.float().reshape(bsz, 1, m, d),
                       qn.float().transpose(-1, -2))      # (B, Li, M, Lr)
    s_mask = (c_mask.float().reshape(bsz, 1, m, 1)
              * q_mask.float()[:, :, None, :])
    masked = s - 1e10 * (1.0 - s_mask)
    p = torch.softmax(torch.clamp(masked * scale, min=SAFE_FLOOR), dim=-1)
    att = Bf16Dot.apply(p * s_mask, qe.float())          # (B, Li, M, D)
    ce_b = ce.float().reshape(bsz, 1, m, d).expand_as(att)
    x = torch.cat([ce_b, att, ce_b * att], dim=-1)
    y = layer_norm(x, gamma, beta, clip=False, n=3 * dv)
    # the dropout's flat index runs over rows in mixed's (B, A, Li, Lqa) order
    y = y.reshape(bsz, li, num_a, lqa, 3 * d).permute(0, 2, 1, 3, 4)
    if dropout_rate > 0.0:
        y = y * philox.width_multiplier(y.shape, seed, dropout_rate, dv, 3,
                                        y.device)
    out = Bf16Dot.apply(y.reshape(-1, 3 * d), w.float())
    mixed = torch.relu(out.reshape(bsz, num_a, li, lqa, d) + b.float())
    masked = masked.reshape(bsz, li, num_a, lqa, lr).permute(0, 2, 1, 3, 4)
    return mixed, masked.contiguous()


def qa_ctx_attention_plain(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b,
                           scale=10.0, raw_mode="full", targets=None,
                           dropout_rate=0.0, seed=0, dv=None):
    """Plain PyTorch version of the kernels.  cn/ce (B, A, Lqa, D); qn/qe
    (B, Li, Lr, D); c_mask (B, A, Lqa); q_mask (B, Li, Lr); gamma/beta
    (3D,); w (3D, D); b (D,); targets (B,) int for ``raw_mode="target"``.
    Returns mixed (B, A, Li, Lqa, D) in cn's dtype and the raw scores in
    float32: (B, A, Li, Lqa, Lr) for "full", (B, Li, Lqa, Lr) at each
    target answer for "target", none for "none".  bfloat16 activations take
    the rounding sites of the bf16 kernels (``_plain_bf16``), float32 ones
    none.  ``dv``: the true width of inputs padded past it
    (``pad_inputs``), as the kernels take it."""
    dv = cn.shape[-1] if dv is None else dv
    if cn.dtype == torch.bfloat16:
        mixed, masked = _plain_bf16(cn, ce, qn, qe, c_mask, q_mask, gamma,
                                    beta, w, b, scale, dropout_rate, seed,
                                    dv)
        return _with_raw(mixed.to(cn.dtype), masked, raw_mode, targets)
    s = torch.einsum("bawd,bird->baiwr", cn.float(), qn.float())
    s_mask = (c_mask.float()[:, :, None, :, None]
              * q_mask.float()[:, None, :, None, :])
    masked = s - 1e10 * (1.0 - s_mask)
    p = torch.softmax(torch.clamp(masked * scale, min=SAFE_FLOOR), dim=-1)
    att = torch.einsum("baiwr,bird->baiwd", p * s_mask, qe.float())
    ce_b = ce.float()[:, :, None].expand_as(att)
    x = torch.cat([ce_b, att, ce_b * att], dim=-1)
    y = layer_norm(x, gamma, beta, clip=False, n=3 * dv)
    if dropout_rate > 0.0:
        y = y * philox.width_multiplier(y.shape, seed, dropout_rate, dv, 3,
                                        y.device)
    mixed = torch.relu(y @ w.float() + b.float()).to(cn.dtype)
    return _with_raw(mixed, masked, raw_mode, targets)


def pad_inputs(cn, ce, qn, qe, gamma, beta, w, b, dp):
    """The activations and projection parameters zero-padded from their
    width D to the instantiation ``dp`` (gamma, beta and W's rows third by
    third); the same objects at dp = D."""
    if dp == cn.shape[-1]:
        return cn, ce, qn, qe, gamma, beta, w, b
    pad = widths.pad_cols
    return (*(pad(t, dp).contiguous() for t in (cn, ce, qn, qe)),
            pad(gamma, dp, 3), pad(beta, dp, 3), widths.pad_weight(w, dp, 3),
            pad(b, dp))


def _with_raw(mixed, masked, raw_mode, targets):
    if raw_mode == "full":
        return mixed, masked
    if raw_mode == "target":
        return mixed, masked[torch.arange(masked.shape[0],
                                          device=masked.device),
                             targets.long()]
    return mixed


def _check(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, raw_mode,
           targets, backward=False):
    """Raise on what the kernels do not take (D in
    ``widths.FORWARD_WIDTHS``, the backward ``widths.BACKWARD_WIDTHS``);
    returns the float32 masks and parameters and the int32 targets."""
    bsz, num_a, lqa, d = cn.shape
    _, li, lr, _ = qn.shape
    dt = cn.dtype
    check_device(cn.device, ce=ce, qn=qn, qe=qe)
    for name, t, shape in (("ce", ce, cn.shape), ("qn", qn, qn.shape),
                           ("qe", qe, qn.shape)):
        if t.shape != shape or t.dtype != dt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(shape)} {dt}")
    if backward:
        widths.check_backward_width("qa_ctx_attention", d)
    else:
        widths.check_forward_width("qa_ctx_attention", d)
    if qn.shape[0] != bsz or lr > MAX_REGIONS:
        raise ValueError(f"kernel takes Lr <= {MAX_REGIONS}; got cn "
                         f"{tuple(cn.shape)}, qn {tuple(qn.shape)}")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"activations must be float32 or bfloat16, not {dt}")
    if not all(t.is_contiguous() for t in (cn, ce, qn, qe)):
        raise ValueError("cn/ce/qn/qe must be contiguous")
    if dt == torch.bfloat16 and any(t.data_ptr() % 16
                                    for t in (cn, ce, qn, qe)):
        raise ValueError("bfloat16 cn/ce/qn/qe must start on a 16-byte "
                         "boundary (the kernels copy 16-byte chunks)")
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
                targets, scale, raw_mode, dropout_rate, seed, dv):
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
        wp = None
        if cn.dtype == torch.bfloat16:
            # the tensor-core kernels' operand: W in bf16, which at D = 256
            # the C entry rounds into its slabs and at D = 64 the kernel as
            # each CTA loads it
            wp = widths.slab_scratch("qa_ctx_attention", d, dev)
            if d == 128:
                w32 = w32.to(torch.bfloat16)
        FWD_BY_WIDTH[d].launch(
            dev, ptr(cn), ptr(ce), ptr(qn), ptr(qe), ptr(cm), ptr(qm),
            ptr(g32), ptr(b32), ptr(w32), ptr(bias32),
            ptr(tg) if tg is not None else None, ptr(mixed),
            ptr(raw) if raw is not None else None,
            ptr(wp) if wp is not None else None,
            bsz, num_a, lqa, li, lr, d, float(scale),
            *philox.kernel_args(dropout_rate, seed), dv,
            int(cn.dtype == torch.bfloat16), dv=dv)
        ctx.save_for_backward(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w,
                              b, targets, mixed)
        ctx.cfg = (scale, raw_mode, dropout_rate, seed, dv)
        return (mixed, raw) if raw is not None else mixed

    @staticmethod
    def backward(ctx, g_mixed, g_raw=None):
        (cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, targets,
         mixed) = ctx.saved_tensors
        scale, raw_mode, dropout_rate, seed, dv = ctx.cfg
        grads = qa_ctx_attention_backward(
            cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, g_mixed,
            g_raw, mixed, scale, raw_mode, targets, dropout_rate, seed, dv)
        return grads[:4] + (None, None) + grads[4:] + (None,) * 6


def qa_ctx_attention_backward(cn, ce, qn, qe, c_mask, q_mask, gamma, beta,
                              w, b, g_mixed, g_raw, mixed, scale=10.0,
                              raw_mode="full", targets=None,
                              dropout_rate=0.0, seed=0, dv=None):
    """Launch the backward kernel (CUDA tensors only).  Returns the
    gradients of (cn, ce, qn, qe) in their dtype and of (gamma, beta, w, b)
    in float32.  ``mixed`` is the saved forward output (the ReLU sign);
    ``g_raw`` may be None (no raw cotangent); ``dv`` the true width of
    padded inputs (None: theirs)."""
    cm, qm, g32, b32, w32, bias32, tg = _check(
        cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b, raw_mode, targets,
        backward=True)
    seed = philox.kernel_seed(dropout_rate, seed, cn.device)
    bsz, num_a, lqa, d = cn.shape
    _, li, lr, _ = qn.shape
    dev, dt = cn.device, cn.dtype
    dv = d if dv is None else dv
    g_mixed = g_mixed.to(dt).contiguous()
    if g_mixed.shape != mixed.shape:
        raise ValueError("g_mixed does not match mixed")
    graw = None
    if raw_mode != "none" and g_raw is not None:
        graw = g_raw.to(torch.float32).contiguous()
    rows = bsz * li * num_a * lqa
    f32 = dict(dtype=torch.float32, device=dev)
    if d != 128:
        return _backward_wide(cn, ce, qn, qe, cm, qm, g32, b32, w32,
                              g_mixed, graw, tg, mixed, scale, dropout_rate,
                              seed, dv)
    tc = dt == torch.bfloat16          # the tensor-core kernels
    if tc and (g_mixed.data_ptr() % 16 or mixed.data_ptr() % 16):
        raise ValueError("g_mixed/mixed must start on a 16-byte boundary")
    chunks = tc_wgrad_chunks(rows, 3 * d) if tc \
        else wgrad_chunks(rows, 3 * d)
    gqn, gqe = torch.empty_like(qn), torch.empty_like(qe)
    m = num_a * lqa
    if tc:
        # gcn and gce, their per-frame slots, and [gw; gb] each lie back to
        # back, so one fixed-order sum launch serves each pair
        gc = torch.empty((2,) + cn.shape, dtype=dt, device=dev)
        gcn, gce = gc[0], gc[1]
        gc_part = torch.empty(2, bsz, li, m, d, **f32)
        gwb = torch.empty(3 * d + 1, d, **f32)
        gvec = torch.empty(6 * d, **f32)
        # the dropped LN output yd and g_out rows for the weight gradient
        # are bf16: the kernels round both before that product anyway
        scratch = [gc_part[0], gc_part[1],
                   torch.empty(rows, 3 * d, dtype=dt, device=dev),
                   torch.empty(rows, d, dtype=dt, device=dev),
                   torch.empty(bsz * li, 6 * d, **f32),
                   torch.empty(chunks, 3 * d + 1, d, **f32)]
        # g_s, p and g_att rows for the gqn / gqe kernel
        lrp = 32 if lr <= 32 else 64
        scratch += [torch.empty(rows, lrp, dtype=dt, device=dev),
                    torch.empty(rows, lrp, dtype=dt, device=dev),
                    torch.empty(rows, d, dtype=dt, device=dev)]
        gw, gb = gwb[:3 * d], gwb[3 * d]
    else:
        gcn, gce = torch.empty_like(cn), torch.empty_like(ce)
        gvec = torch.empty(7 * d, **f32)
        gw = torch.empty(3 * d, d, **f32)
        gb = gvec[6 * d:]
        scratch = [torch.empty(bsz, li, m, d, **f32),
                   torch.empty(bsz, li, m, d, **f32),
                   torch.empty(rows, 3 * d, **f32),
                   torch.empty(rows, d, **f32),
                   torch.empty(bsz * li, 7 * d, **f32),
                   torch.empty(chunks, 3 * d, d, **f32), None, None, None]
    # the kernel's weight operand: W in bf16 as it lies (tc), else W^T
    wk = w32.to(dt) if tc else as_f32(w32.t())
    BWD_KERNEL.launch(
        dev, ptr(cn), ptr(ce), ptr(qn), ptr(qe), ptr(cm), ptr(qm), ptr(g32),
        ptr(b32), ptr(wk), ptr(g_mixed), ptr(mixed),
        ptr(graw) if graw is not None else None,
        ptr(tg) if (tg is not None and graw is not None) else None,
        ptr(gcn), ptr(gce), ptr(gqn), ptr(gqe), ptr(gvec), ptr(gw),
        *(ptr(t) if t is not None else None for t in scratch), bsz, num_a,
        lqa, li, lr, float(scale),
        *philox.kernel_args(dropout_rate, seed), chunks, dv, int(tc), dv=dv)
    return gcn, gce, gqn, gqe, gvec[:3 * d], gvec[3 * d:6 * d], gw, gb


def _backward_wide(cn, ce, qn, qe, cm, qm, g32, b32, w32, g_mixed, graw, tg,
                   mixed, scale, dropout_rate, seed, dv):
    """The backward at D = 64 or 256 (``csrc/qa_ctx_attention_bwd_wide.cu``):
    the same outputs as at D = 128.  bf16: the tensor-core kernels, which
    take W in bf16 and hand their g_s, p and g_att rows on in bf16; float32:
    the CUDA-core kernel, which takes W^T and hands them on in float32.
    The yd and g_out rows of the weight gradient are in the activation
    type: bf16 feeds the tensor-core pass."""
    bsz, num_a, lqa, d = cn.shape
    _, li, lr, _ = qn.shape
    dev, dt = cn.device, cn.dtype
    bf16 = dt == torch.bfloat16
    if bf16 and (g_mixed.data_ptr() % 16 or mixed.data_ptr() % 16):
        raise ValueError("g_mixed/mixed must start on a 16-byte boundary")
    rows = bsz * li * num_a * lqa
    f32 = dict(dtype=torch.float32, device=dev)
    chunks = tc_wgrad_chunks(rows, 3 * d, d) if bf16 \
        else wgrad_chunks(rows, 3 * d, d=d)
    nv = (6 if bf16 else 7) * d
    gcn, gce = torch.empty_like(cn), torch.empty_like(ce)
    gqn, gqe = torch.empty_like(qn), torch.empty_like(qe)
    gvec = torch.empty(nv, **f32)
    gw = torch.empty(3 * d + bf16, d, **f32)     # [gw; gb] in bf16
    scratch = [torch.empty(shape, dtype=t, device=dev) for shape, t in
               wide_backward_scratch(bsz, li, num_a * lqa, lr, d, dt, chunks)]
    wk = w32.to(dt) if bf16 else as_f32(w32.t())
    BWD_BY_WIDTH[d].launch(
        dev, ptr(cn), ptr(ce), ptr(qn), ptr(qe), ptr(cm), ptr(qm), ptr(g32),
        ptr(b32), ptr(wk), ptr(g_mixed), ptr(mixed),
        ptr(graw) if graw is not None else None,
        ptr(tg) if (tg is not None and graw is not None) else None,
        ptr(gcn), ptr(gce), ptr(gqn), ptr(gqe), ptr(gvec), ptr(gw),
        *(ptr(t) for t in scratch), bsz, num_a, lqa, li, lr, d, float(scale),
        *philox.kernel_args(dropout_rate, seed), chunks, dv, int(bf16),
        dv=dv)
    gb = gw[3 * d] if bf16 else gvec[6 * d:]
    return (gcn, gce, gqn, gqe, gvec[:3 * d], gvec[3 * d:6 * d], gw[:3 * d],
            gb)


def wide_backward_scratch(bsz, li, m, lr, d, dt, chunks):
    """(shape, dtype) of each scratch buffer of the backward at D = 64 or
    256 (``csrc/qa_ctx_attention_bwd_wide.cu``'s C entry, in its order) for
    bsz x li frames of m answer-word rows and lr regions: gcn_part and
    gce_part (float32, each row's partials by frame; the bf16 kernel at 256
    also keeps a tile's P and Q there between its passes), the yd and g_out
    rows in ``dt``, vec_part (a slot of parameter sums a frame; the bf16
    kernels, persistent over the frames' 64-row tiles, a slot for each of
    their blocks, at most one a tile), wg_part (``chunks`` slots), then the
    g_s, p and g_att rows of the gqn / gqe kernel (bf16 from the tensor-core
    kernels, lr rounded up to their LRP of 32 or 64; float32 from the
    CUDA-core one, round4(lr))."""
    bf16 = dt == torch.bfloat16
    rows, nv = bsz * li * m, (6 if bf16 else 7) * d
    ld, rdt = ((32 if lr <= 32 else 64), dt) if bf16 \
        else ((lr + 3) & ~3, torch.float32)
    slots = bsz * li * (-(-m // 64) if bf16 else 1)
    f32 = torch.float32
    return [((bsz, li, m, d), f32), ((bsz, li, m, d), f32),
            ((rows, 3 * d), dt), ((rows, d), dt), ((slots, nv), f32),
            ((chunks, 3 * d + bf16, d), f32), ((rows, ld), rdt),
            ((rows, ld), rdt), ((rows, d), rdt)]


def qa_ctx_attention(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, b,
                     scale=10.0, raw_mode="full", targets=None,
                     dropout_rate=0.0, seed=0):
    """Kernels on CUDA tensors (differentiable through the backward
    kernel), plain version on CPU tensors (autograd through it).  Same
    signature and outputs as ``qa_ctx_attention_plain``; ``seed`` keys the
    dropout (ops/philox.py); a width between the instantiations runs
    padded (module docstring)."""
    if raw_mode not in RAW_MODES:
        raise NotImplementedError(f"raw_mode {raw_mode!r}")
    if raw_mode == "target" and targets is None:
        raise ValueError("raw_mode 'target' needs targets of shape (B,)")
    if not cn.is_cuda:
        return qa_ctx_attention_plain(cn, ce, qn, qe, c_mask, q_mask, gamma,
                                      beta, w, b, scale, raw_mode, targets,
                                      dropout_rate, seed)
    d = cn.shape[-1]
    dp = widths.padded_width(d)
    cn, ce, qn, qe, gamma, beta, w, b = pad_inputs(cn, ce, qn, qe, gamma,
                                                   beta, w, b, dp)
    out = _QaCtxAttention.apply(cn, ce, qn, qe, c_mask, q_mask, gamma, beta,
                                w, b, targets, scale, raw_mode, dropout_rate,
                                philox.kernel_seed(dropout_rate, seed,
                                                   cn.device), d)
    if dp == d:
        return out
    if raw_mode == "none":
        return out[..., :d]
    return out[0][..., :d], out[1]
