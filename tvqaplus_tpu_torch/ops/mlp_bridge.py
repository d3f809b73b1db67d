"""Fused MLP bridge, forward and backward (port of
``tvqaplus_tpu/ops/pallas_bridge.py`` ``fused_mlp_bridge``).

The ``MLPBridge`` recipe of STAGE's ``bert_word_encoding_fc`` (768 -> 300)
and ``vid_fc`` (300 -> 300): LN -> dropout -> dense Din -> Dout -> ReLU ->
LN, row by row (reference stage.py:85-113).  The CUDA kernels are
``csrc/mlp_bridge_fwd.cu`` and ``csrc/mlp_bridge_bwd.cu`` behind one
``torch.autograd.Function``; ``mlp_bridge_plain`` is the same function in
plain PyTorch (autograd through it is the plain backward).  Din and Dout are
run-time widths: multiples of 4 with 4 <= Din <= MAX_DIN (768) and
4 <= Dout <= MAX_DOUT (320), which take STAGE's 768 -> 300 and 300 -> 300;
the wrapper refuses every other width.  The dropout acts on the (rows, Din)
LN output, keyed by (seed, flat index) through Philox (ops/philox.py).

Two compute modes, as the TPU kernel's ``compute_dtype``: float32 (exact,
the CUDA-core kernels: the exactness check), and bfloat16, which reads
float32 or bfloat16 x, rounds the dense product's operands (the dropped LN
output and W; in the backward g_y1 with each) to bf16 with float32 sums
(pallas_bridge.py:52-54, :106-111) and returns bf16: the tensor-core
kernels, which take W packed once a call (``pack_weight``: bf16,
zero-padded to the kernels' K and N widths, ``padded_widths``).  The mode
defaults to x's type.
"""
from __future__ import annotations

import ctypes

import torch

from tvqaplus_tpu_torch.ops import philox
from tvqaplus_tpu_torch.ops._build import (
    CudaKernel,
    check_aligned,
    check_device,
    ptr,
    sm_count,
    wgrad_chunks,
)
from tvqaplus_tpu_torch.ops.plain import as_f32, dot, layer_norm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U32, _L = ctypes.c_uint, ctypes.c_longlong
KERNEL = CudaKernel("mlp_bridge_fwd.cu", "mlp_bridge_fwd",
                    [_P] * 8 + [_L, _I, _I, _P, _U32, _F, _I, _I, _P])
BWD_KERNEL = CudaKernel("mlp_bridge_bwd.cu", "mlp_bridge_bwd",
                        [_P] * 15 + [_L, _I, _I, _I, _P, _U32, _F, _I, _I,
                                     _P])

# Kernel vs plain version on the same inputs: float32 differs only in the
# order of float32 sums (768 terms a product); bf16 rounds the product's
# operands at the same sites on both sides and the output once (LN outputs
# are O(1), up to a few units), so a float32 difference may move one
# rounding by a bf16 step.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
# Backward kernel vs autograd through the plain version: float32 sums over
# all rows in another order (the parameter grads sum 4e4 rows at the
# subtitle stream's shape); bf16 rounds gx once and takes the cotangent in
# bf16 (rows whose ReLU input a moved rounding could flip take no
# cotangent, ops/checks.py).
GRAD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
_NAMES = ("gamma_in", "beta_in", "w", "b", "gamma_out", "beta_out")
# the widths the kernels take (csrc/mlp_bridge_tc.cuh BT_MAX_DIN /
# BT_MAX_DOUT): a lane of the tensor-core kernels' LN_in pass holds six
# quads of a row (Din <= 768, a 96 KB bf16 A tile of 64 rows), and y1's
# accumulators hold five 64-column panels over the two warpgroups
# (Dout <= 320)
MAX_DIN, MAX_DOUT = 768, 320


def mlp_bridge_pre(x, gamma_in, beta_in, w, b, dropout_rate=0.0, seed=0,
                   compute_dtype=None):
    """The bridge up to its ReLU input y1 = dropout(LN_in(x)) W + b
    (float32; ops/checks.py reads it), with the bf16 compute mode's rounding
    sites (``dot``, pallas_bridge.py:52-54, :106-111) when ``compute_dtype``
    (default: x's) is bfloat16."""
    bf16 = (compute_dtype or x.dtype) == torch.bfloat16
    y = layer_norm(x, gamma_in, beta_in)
    if dropout_rate > 0.0:
        y = y * philox.multiplier(y.shape, seed, dropout_rate, y.device)
    return dot(y, w.float(), bf16) + b.float()


def mlp_bridge_plain(x, gamma_in, beta_in, w, b, gamma_out, beta_out,
                     dropout_rate=0.0, seed=0, compute_dtype=None):
    """Plain PyTorch version.  x (..., Din); w (Din, Dout).  Returns
    (..., Dout) in the compute type (default: x's)."""
    h = torch.relu(mlp_bridge_pre(x, gamma_in, beta_in, w, b, dropout_rate,
                                  seed, compute_dtype))
    return layer_norm(h, gamma_out, beta_out).to(compute_dtype or x.dtype)


def padded_widths(d_in, d_out):
    """(Kp, Np): Din and Dout rounded up to whole 64-column panels, the K
    and N widths of the tensor-core kernels (csrc/mlp_bridge_tc.cuh)."""
    return -(-d_in // 64) * 64, -(-d_out // 64) * 64


def pack_weight(w):
    """W (Din, Dout) as the bf16 kernels take it: rounded to bfloat16 once
    (to nearest even, as JAX's ``astype``) and zero-padded to (Kp, Np)."""
    d_in, d_out = w.shape
    out = torch.zeros(padded_widths(d_in, d_out), dtype=torch.bfloat16,
                      device=w.device)
    out[:d_in, :d_out] = w.detach().to(torch.bfloat16)
    return out


def tc_backward_scratch(rows, d_in, d_out, sms):
    """Shapes of the bf16 backward's scratch on a card of ``sms`` SMs, by
    the C entry's names: the yd and g_y1 rows (bf16, padded to Kp and Np
    columns), the column-sum slot of each persistent block and the
    weight-gradient chunk slots (float32; ``mlp_bridge_wgrad_tc_kernel``
    runs one block a SM, Kp / 128 blocks a row chunk of at least 64
    rows)."""
    kp, np_ = padded_widths(d_in, d_out)
    chunks = max(1, min(-(-rows // 64), sms // -(-kp // 128)))
    return {"yd": (rows, kp), "g1": (rows, np_),
            "vec_part": (min(-(-rows // 64), sms), 2 * (d_in + d_out)),
            "wg_part": (chunks, kp + 1, np_)}


def _check(x, params, compute_dtype=None):
    d_in = x.shape[-1]
    compute_dtype = compute_dtype or x.dtype
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"x must be non-empty contiguous float32/bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if compute_dtype not in (torch.float32, torch.bfloat16) or (
            x.dtype == torch.bfloat16 and compute_dtype == torch.float32):
        raise ValueError(f"the kernels compute in float32 (float32 x) or "
                         f"bfloat16; got {compute_dtype} on {x.dtype} x")
    params = [as_f32(t) for t in params]
    if params[2].dim() != 2:
        raise ValueError(f"w must be (Din, Dout), got {tuple(params[2].shape)}")
    d_out = params[2].shape[1]
    if d_in % 4 or d_out % 4 or not (4 <= d_in <= MAX_DIN) \
            or not (4 <= d_out <= MAX_DOUT):
        raise ValueError(f"kernels take Din and Dout in multiples of 4 with "
                         f"4 <= Din <= {MAX_DIN} and 4 <= Dout <= "
                         f"{MAX_DOUT}; got {d_in} -> {d_out}")
    check_device(x.device, **dict(zip(_NAMES, params)))
    if compute_dtype == torch.bfloat16 and x.is_cuda:
        check_aligned(x=x)            # 8- and 16-byte loads of x
    shapes = [(d_in,), (d_in,), (d_in, d_out), (d_out,), (d_out,), (d_out,)]
    if [tuple(p.shape) for p in params] != shapes:
        raise ValueError("bridge parameters do not match x and each other")
    return params, d_in, d_out


class _MLPBridge(torch.autograd.Function):
    """The forward and backward CUDA kernels as one differentiable op."""

    @staticmethod
    def forward(ctx, x, gamma_in, beta_in, w, b, gamma_out, beta_out,
                dropout_rate, seed, compute_dtype):
        params, d_in, d_out = _check(
            x, (gamma_in, beta_in, w, b, gamma_out, beta_out), compute_dtype)
        out = torch.empty(x.shape[:-1] + (d_out,), dtype=compute_dtype,
                          device=x.device)
        if compute_dtype == torch.bfloat16:
            params[2] = pack_weight(params[2])
        KERNEL.launch(x.device, ptr(x), *(ptr(p) for p in params), ptr(out),
                      x.numel() // d_in, d_in, d_out,
                      *philox.kernel_args(dropout_rate, seed),
                      int(x.dtype == torch.bfloat16),
                      int(compute_dtype == torch.bfloat16))
        ctx.save_for_backward(x, gamma_in, beta_in, w, b, gamma_out, beta_out)
        ctx.cfg = (dropout_rate, seed, compute_dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        return mlp_bridge_backward(x, *params, g, *ctx.cfg) + (None,) * 3


def mlp_bridge_backward(x, gamma_in, beta_in, w, b, gamma_out, beta_out, g,
                        dropout_rate=0.0, seed=0, compute_dtype=None):
    """Launch the backward kernel (CUDA tensors only).  Returns the gradient
    of x in its dtype and of the six parameters in float32."""
    compute_dtype = compute_dtype or x.dtype
    (gin, bin_, w32, b32, gout, _), d_in, d_out = _check(
        x, (gamma_in, beta_in, w, b, gamma_out, beta_out), compute_dtype)
    seed = philox.kernel_seed(dropout_rate, seed, x.device)
    rows = x.numel() // d_in
    g = g.to(compute_dtype).contiguous()
    if g.shape != x.shape[:-1] + (d_out,):
        raise ValueError("cotangent does not match the output")
    f32 = dict(dtype=torch.float32, device=x.device)
    gx = torch.empty_like(x)
    gw = torch.empty(d_in, d_out, **f32)
    if compute_dtype == torch.bfloat16:       # the tensor-core kernels
        check_aligned(g=g)
        shapes = tc_backward_scratch(rows, d_in, d_out, sm_count(x.device))
        gvec = torch.empty(2 * (d_in + d_out), **f32)
        gb = torch.empty(d_out, **f32)
        # the dropped LN output yd and g_y1 rows for the weight gradient are
        # bf16: the kernel rounds both before that product anyway
        scratch = [torch.empty(shapes[k], dtype=dt, device=x.device)
                   for k, dt in (("yd", torch.bfloat16),
                                 ("g1", torch.bfloat16),
                                 ("vec_part", torch.float32),
                                 ("wg_part", torch.float32))]
        wk, chunks = pack_weight(w32), shapes["wg_part"][0]
    else:
        # one block of the weight-gradient pass per 64 x 128 tile of
        # (Din, Dout) and row chunk
        chunks = wgrad_chunks(rows, 64 * -(-d_in // 64) * -(-d_out // 128))
        gvec = torch.empty(2 * d_in + 3 * d_out, **f32)
        gb = None
        scratch = [torch.empty(rows, d_in, **f32),
                   torch.empty(rows, d_out, **f32),
                   torch.empty(-(-rows // 32), 2 * d_in + 3 * d_out, **f32),
                   torch.empty(chunks, d_in, d_out, **f32)]
        wk = w32
    BWD_KERNEL.launch(x.device, ptr(x), ptr(gin), ptr(bin_), ptr(wk),
                      ptr(b32), ptr(gout), ptr(g), ptr(gx), ptr(gvec),
                      ptr(gw), None if gb is None else ptr(gb),
                      *(ptr(t) for t in scratch), rows, d_in, d_out, chunks,
                      *philox.kernel_args(dropout_rate, seed),
                      int(x.dtype == torch.bfloat16),
                      int(compute_dtype == torch.bfloat16))
    ggin, gbin = gvec[:d_in], gvec[d_in:2 * d_in]
    if gb is not None:
        return (gx, ggin, gbin, gw, gb, gvec[2 * d_in:2 * d_in + d_out],
                gvec[2 * d_in + d_out:])
    return (gx, ggin, gbin, gw, gvec[2 * d_in:2 * d_in + d_out],
            gvec[2 * d_in + d_out:2 * d_in + 2 * d_out],
            gvec[2 * d_in + 2 * d_out:])


def mlp_bridge(x, gamma_in, beta_in, w, b, gamma_out, beta_out,
               dropout_rate=0.0, seed=0, compute_dtype=None):
    """Kernels on CUDA tensors (differentiable through the backward
    kernel), plain version on CPU tensors.  ``compute_dtype`` (default:
    x's) is the compute mode and the output's type."""
    if not x.is_cuda:
        return mlp_bridge_plain(x, gamma_in, beta_in, w, b, gamma_out,
                                beta_out, dropout_rate, seed, compute_dtype)
    return _MLPBridge.apply(x, gamma_in, beta_in, w, b, gamma_out, beta_out,
                            dropout_rate,
                            philox.kernel_seed(dropout_rate, seed, x.device),
                            compute_dtype or x.dtype)
