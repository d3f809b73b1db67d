"""Fused tri-concat MLP bridge, forward and backward (port of
``tvqaplus_tpu/ops/pallas_tri_bridge.py`` ``fused_tri_bridge``).

STAGE's ``concat_fc``: LN([s; v; s*v]) -> dropout -> dense 3D->D -> ReLU ->
LN, row by row over the attended statements (reference stage.py:107-113,
300-302).  The CUDA kernels are ``csrc/tri_bridge_fwd.cu`` and
``csrc/tri_bridge_bwd.cu`` behind one ``torch.autograd.Function``;
``tri_bridge_plain`` is the same function in plain PyTorch (autograd through
it is the plain backward).  The dropout acts on the (rows, 3D) LN output,
keyed by (seed, flat index) through Philox (ops/philox.py).  On CUDA a
width between the instantiations runs padded (ops/widths.py ``pad_cols``,
``pad_weight``: W's three input blocks apart), the kernels told the true
width.

Two compute modes, chosen by the activations' type.  float32: exact, the
CUDA-core kernels.  bfloat16 (what the entry points run on the card): the
product takes bf16 operands with float32 sums, as the TPU kernel's bf16
compute mode does: the forward and backward kernels run their products on
the tensor cores, and the plain version rounds at the same sites
(``tri_bridge_pre``).
"""
from __future__ import annotations

import ctypes

import torch

from tvqaplus_tpu_torch.ops import philox, widths
from tvqaplus_tpu_torch.ops._build import (
    CudaKernel,
    check_aligned,
    check_device,
    ptr,
    sm_count,
    tc_wgrad_chunks,
    wgrad_chunks,
)
from tvqaplus_tpu_torch.ops.plain import as_f32, dot, layer_norm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U32, _L = ctypes.c_uint, ctypes.c_longlong
# The forward entry takes the width D; each width has its own launch count
# (KERNEL counts D = 128, the headline hsz).
# the dropout, the true width, the compute mode and the stream
_TAIL = [_P, _U32, _F, _I, _I, _P]
FWD_BY_WIDTH = {d: CudaKernel("tri_bridge_fwd.cu", "tri_bridge_fwd",
                              [_P] * 10 + [_L, _I] + _TAIL)
                for d in widths.FORWARD_WIDTHS}
KERNEL = FWD_BY_WIDTH[128]
BWD_KERNEL = CudaKernel("tri_bridge_bwd.cu", "tri_bridge_bwd",
                        [_P] * 17 + [_L, _I] + _TAIL)
# The backward at each width: D = 128 the tensor-core design above, 64 and
# 256 csrc/tri_bridge_bwd_wide.cu's entry, which takes D (one count each)
BWD_BY_WIDTH = {d: BWD_KERNEL if d == 128 else CudaKernel(
    "tri_bridge_bwd_wide.cu", "tri_bridge_bwd_wide",
    [_P] * 19 + [_L, _I, _I] + _TAIL)
    for d in widths.BACKWARD_WIDTHS}

# Kernel vs plain version on the same inputs: float32 differs only in the
# order of float32 sums; bf16 output is rounded once (step 2**-8 relative;
# LN outputs are O(1), up to a few units).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
# Backward kernel vs autograd through the plain version: float32 sums over
# all rows in another order (parameter grads sum 10^5 rows at the headline
# shapes); bf16 rounds gs/gv once and takes the cotangent in bf16, and both
# sides round the products' operands at the same sites, so a float32
# difference may move one such rounding by a bf16 step (rows whose ReLU
# input a moved rounding could flip take no cotangent, ops/checks.py).
GRAD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
_NAMES = ("gamma_in", "beta_in", "w", "b", "gamma_out", "beta_out")


def tri_bridge_pre(s, v, gamma_in, beta_in, w, b, dropout_rate=0.0, seed=0,
                   dv=None):
    """The bridge up to its ReLU input y1 = dropout(LN_in([s; v; s*v])) W + b
    (float32; ops/checks.py reads it).  bfloat16 s and v take the rounding
    sites of the bf16 kernels, which are the TPU kernel's bf16 compute mode:
    the product rounds the LN output and W to bf16 and sums in float32, and
    its backward rounds the cotangent too (``Bf16Dot``,
    pallas_tri_bridge.py:77-79, :157-162).  ``dv``: the true width of
    inputs padded past it (``pad_inputs``), as the kernels take it."""
    s32, v32 = s.float(), v.float()
    dv = s.shape[-1] if dv is None else dv
    y = layer_norm(torch.cat([s32, v32, s32 * v32], dim=-1), gamma_in,
                   beta_in, n=3 * dv)
    if dropout_rate > 0.0:
        y = y * philox.width_multiplier(y.shape, seed, dropout_rate, dv, 3,
                                        y.device)
    return dot(y, w.float(), s.dtype == torch.bfloat16) + b.float()


def tri_bridge_plain(s, v, gamma_in, beta_in, w, b, gamma_out, beta_out,
                     dropout_rate=0.0, seed=0, dv=None):
    """Plain PyTorch version.  s, v (..., D); w (3D, D).  Returns (..., D)
    in s's dtype.  ``dv`` as ``tri_bridge_pre``."""
    h = torch.relu(tri_bridge_pre(s, v, gamma_in, beta_in, w, b,
                                  dropout_rate, seed, dv))
    return layer_norm(h, gamma_out, beta_out, n=dv).to(s.dtype)


def pad_inputs(s, v, params, dp):
    """s, v and the six parameters (``_NAMES`` order) zero-padded from
    their width D to the instantiation ``dp``: the 3D-long vectors and W's
    rows third by third; the same objects at dp = D."""
    if dp == s.shape[-1]:
        return s, v, params
    gin, bin_, w, b, gout, bout = params
    pad = widths.pad_cols
    return (pad(s, dp).contiguous(), pad(v, dp).contiguous(),
            (pad(gin, dp, 3), pad(bin_, dp, 3), widths.pad_weight(w, dp, 3),
             pad(b, dp), pad(gout, dp), pad(bout, dp)))


def _check(s, v, params, backward=False):
    """Raise on what the kernels do not take (D in
    ``widths.FORWARD_WIDTHS``, the backward ``widths.BACKWARD_WIDTHS``);
    returns the float32 parameters."""
    d = s.shape[-1]
    if v.shape != s.shape or v.dtype != s.dtype:
        raise ValueError(f"v {tuple(v.shape)} {v.dtype} does not match s "
                         f"{tuple(s.shape)} {s.dtype}")
    if backward:
        widths.check_backward_width("tri_bridge", d)
    else:
        widths.check_forward_width("tri_bridge", d)
    if s.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32/bfloat16; got "
                         f"{tuple(s.shape)} {s.dtype}")
    if not (s.is_contiguous() and v.is_contiguous()):
        raise ValueError("s and v must be contiguous")
    params = [as_f32(t) for t in params]
    check_device(s.device, v=v, **dict(zip(_NAMES, params)))
    if s.dtype == torch.bfloat16:      # the kernels copy 16-byte chunks
        check_aligned(s=s, v=v)
    shapes = [(3 * d,), (3 * d,), (3 * d, d), (d,), (d,), (d,)]
    if [tuple(p.shape) for p in params] != shapes:
        raise ValueError("bridge parameters do not match D")
    return params


def slab_scratch(s):
    """The forward's ``wp``: W rounded to bf16 slabs once a call (the bf16
    kernel at D = 256, ``widths.slab_scratch``), else None."""
    if s.dtype != torch.bfloat16:
        return None
    return widths.slab_scratch("tri_bridge", s.shape[-1], s.device)


class _TriBridge(torch.autograd.Function):
    """The forward and backward CUDA kernels as one differentiable op."""

    @staticmethod
    def forward(ctx, s, v, gamma_in, beta_in, w, b, gamma_out, beta_out,
                dropout_rate, seed, dv):
        params = _check(s, v, (gamma_in, beta_in, w, b, gamma_out, beta_out))
        out = torch.empty_like(s)
        d = s.shape[-1]
        gin, bin_, w32, *rest = params
        wp = slab_scratch(s)
        FWD_BY_WIDTH[d].launch(s.device, ptr(s), ptr(v), ptr(gin),
                               ptr(bin_), ptr(w32),
                               None if wp is None else ptr(wp),
                               *(ptr(p) for p in rest), ptr(out),
                               s.numel() // d, d,
                               *philox.kernel_args(dropout_rate, seed), dv,
                               int(s.dtype == torch.bfloat16), dv=dv)
        ctx.save_for_backward(s, v, gamma_in, beta_in, w, b, gamma_out,
                              beta_out)
        ctx.cfg = (dropout_rate, seed, dv)
        return out

    @staticmethod
    def backward(ctx, g):
        s, v, *params = ctx.saved_tensors
        grads = tri_bridge_backward(s, v, *params, g, *ctx.cfg)
        return grads + (None, None, None)


def tri_bridge_backward(s, v, gamma_in, beta_in, w, b, gamma_out, beta_out,
                        g, dropout_rate=0.0, seed=0, dv=None):
    """Launch the backward kernel (CUDA tensors only).  Returns the
    gradients of (s, v) in their dtype and of the six parameters in
    float32.  ``dv``: the true width of padded inputs (None: theirs)."""
    gin, bin_, w32, b32, gout, _ = _check(
        s, v, (gamma_in, beta_in, w, b, gamma_out, beta_out), backward=True)
    seed = philox.kernel_seed(dropout_rate, seed, s.device)
    d = s.shape[-1]
    dv = d if dv is None else dv
    rows = s.numel() // d
    g = g.to(s.dtype).contiguous()
    if g.shape != s.shape:
        raise ValueError("cotangent does not match s")
    f32 = dict(dtype=torch.float32, device=s.device)
    gs, gv = torch.empty_like(s), torch.empty_like(v)
    if d != 128:
        return _backward_wide(s, v, gin, bin_, w32, b32, gout, g, gs, gv,
                              dropout_rate, seed, dv)
    if s.dtype == torch.bfloat16:      # the tensor-core kernel
        check_aligned(g=g)
        bf16 = dict(dtype=torch.bfloat16, device=s.device)
        chunks = tc_wgrad_chunks(rows, 3 * d)
        blocks = min(-(-rows // 64), sm_count(s.device))
        gvec = torch.empty(8 * d, **f32)
        gwb = torch.empty(3 * d + 1, d, **f32)       # [gw; gb]
        # the dropped LN output yd and g_y1 rows for the weight gradient are
        # bf16: the kernel rounds both before that product anyway
        scratch = [torch.empty(rows, 3 * d, **bf16),
                   torch.empty(rows, d, **bf16),
                   torch.empty(blocks, 8 * d, **f32),
                   torch.empty(chunks, 3 * d + 1, d, **f32)]
        wk, wt, gw = w32.to(torch.bfloat16), None, gwb
    else:
        chunks = wgrad_chunks(rows, 3 * d)
        gvec = torch.empty(9 * d, **f32)
        gw = torch.empty(3 * d, d, **f32)
        scratch = [torch.empty(rows, 3 * d, **f32),
                   torch.empty(rows, d, **f32),
                   torch.empty(-(-rows // 32), 9 * d, **f32),
                   torch.empty(chunks, 3 * d, d, **f32)]
        wk, wt = w32, as_f32(w32.t())
    BWD_KERNEL.launch(s.device, ptr(s), ptr(v), ptr(gin), ptr(bin_),
                      ptr(wk), None if wt is None else ptr(wt), ptr(b32),
                      ptr(gout), ptr(g), ptr(gs), ptr(gv), ptr(gvec),
                      ptr(gw), *(ptr(t) for t in scratch), rows, chunks,
                      *philox.kernel_args(dropout_rate, seed), dv,
                      int(s.dtype == torch.bfloat16), dv=dv)
    if s.dtype == torch.bfloat16:
        return (gs, gv, gvec[:3 * d], gvec[3 * d:6 * d], gwb[:3 * d],
                gwb[3 * d], gvec[6 * d:7 * d], gvec[7 * d:])
    return (gs, gv, gvec[:3 * d], gvec[3 * d:6 * d], gw, gvec[6 * d:7 * d],
            gvec[7 * d:8 * d], gvec[8 * d:])


def _backward_wide(s, v, gin, bin_, w32, b32, gout, g, gs, gv,
                   dropout_rate, seed, dv):
    """The backward at D = 64 or 256 (``csrc/tri_bridge_bwd_wide.cu``): the
    same outputs as at D = 128.  bf16: the tensor-core kernels, which
    round W to bf16 (at 256 once a call, into the slabs the kernel reads)
    and at 256 keep each row's P and Q in a float32 scratch row
    (``wide_backward_scratch``); float32: the CUDA-core kernel, which also
    takes W^T."""
    d = s.shape[-1]
    rows = s.numel() // d
    bf16 = s.dtype == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=s.device)
    if bf16:
        check_aligned(g=g)
        chunks = tc_wgrad_chunks(rows, 3 * d, d)
        wt = None
    else:
        chunks = wgrad_chunks(rows, 3 * d, d=d)
        wt = as_f32(w32.t())
    nv = (8 if bf16 else 9) * d
    gvec = torch.empty(nv, **f32)
    gw = torch.empty(3 * d + bf16, d, **f32)     # [gw; gb] in bf16
    scratch = [None if spec is None
               else torch.empty(spec[0], dtype=spec[1], device=s.device)
               for spec in wide_backward_scratch(rows, d, s.dtype, chunks,
                                                 sm_count(s.device))]
    BWD_BY_WIDTH[d].launch(s.device, ptr(s), ptr(v), ptr(gin), ptr(bin_),
                           ptr(w32), None if wt is None else ptr(wt),
                           ptr(b32), ptr(gout), ptr(g), ptr(gs), ptr(gv),
                           ptr(gvec), ptr(gw),
                           *(None if t is None else ptr(t) for t in scratch),
                           rows, chunks, d,
                           *philox.kernel_args(dropout_rate, seed), dv,
                           int(bf16), dv=dv)
    if bf16:
        return (gs, gv, gvec[:3 * d], gvec[3 * d:6 * d], gw[:3 * d],
                gw[3 * d], gvec[6 * d:7 * d], gvec[7 * d:])
    return (gs, gv, gvec[:3 * d], gvec[3 * d:6 * d], gw, gvec[6 * d:7 * d],
            gvec[7 * d:8 * d], gvec[8 * d:])


def wide_backward_scratch(rows, d, dt, chunks, sms):
    """(shape, dtype) of each scratch buffer of the backward at D = 64 or
    256 (``csrc/tri_bridge_bwd_wide.cu``'s C entry, in its order) over
    ``rows`` rows in the activation type ``dt``: the yd and g_y1 rows (in
    ``dt``), vec_part (a slot of parameter sums a block: the bf16 kernels
    walk 64-row tiles on at most ``sms`` blocks, the float32 one takes a
    block a tile of 16 rows at 256, 32 at 64), wg_part (``chunks`` slots),
    then for the bf16 kernel at 256 pq (each row's P and Q in float32) and
    wp (W in bf16, twice: in the layout of each product that reads it),
    else None and None."""
    bf16 = dt == torch.bfloat16
    if bf16:
        blocks = min(-(-rows // 64), sms)
    else:
        blocks = -(-rows // (16 if d == 256 else 32))
    nv = (8 if bf16 else 9) * d
    f32 = torch.float32
    out = [((rows, 3 * d), dt), ((rows, d), dt), ((blocks, nv), f32),
           ((chunks, 3 * d + bf16, d), f32)]
    if bf16 and d == 256:
        return out + [((rows, 2 * d), f32), ((2, 3 * d, d), dt)]
    return out + [None, None]


def tri_bridge(s, v, gamma_in, beta_in, w, b, gamma_out, beta_out,
               dropout_rate=0.0, seed=0):
    """Kernels on CUDA tensors (differentiable through the backward
    kernel; a width between the instantiations padded, module docstring),
    plain version on CPU tensors."""
    if not s.is_cuda:
        return tri_bridge_plain(s, v, gamma_in, beta_in, w, b, gamma_out,
                                beta_out, dropout_rate, seed)
    d = s.shape[-1]
    dp = widths.padded_width(d)
    s, v, params = pad_inputs(s, v, (gamma_in, beta_in, w, b, gamma_out,
                                     beta_out), dp)
    out = _TriBridge.apply(s, v, *params, dropout_rate,
                           philox.kernel_seed(dropout_rate, seed, s.device),
                           d)
    return out if dp == d else out[..., :d]
