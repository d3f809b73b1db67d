"""Fused QANet encoder block, forward and backward (port of
``tvqaplus_tpu/ops/pallas_encoder.py`` ``fused_encoder_block``), in its two
modes.

x + PE, then 2 x [LN -> (dropout, conv 0 only) -> depthwise conv k ->
pointwise D x D -> ReLU -> residual], final LN (reference encoder.py:9-52).

* ``encoder_reduce`` (``reduce_mask`` mode) then takes ``max over L of
  mask_logits(out, m)`` (stage.py:500-505) and returns (B, G, D): STAGE's
  ``cls_encoder``.
* ``encoder_block`` returns the (B, G, L, D) block output, with an optional
  (G, L) ``zero_mask`` that re-zeroes each conv's input where it is 0 (the
  merged-stream contract of models/layers.py ``EncoderBlock``): STAGE's
  ``input_encoder`` over the merged qa/sub/vid streams.  Only positions
  where the mask is 1 are contractual; the rest are finite and the caller
  slices them away.

The CUDA kernels are ``csrc/encoder_fwd.cu`` and ``csrc/encoder_bwd.cu``,
one entry per mode, each mode behind one ``torch.autograd.Function`` that
takes the packed parameter vector, so ``torch.cat``'s autograd routes the
gradient pieces back to the parameters; ``encoder_reduce_plain`` and
``encoder_block_plain`` are the same functions in plain PyTorch (autograd
through them is the plain backward).
``params`` uses the JAX kernel's keys: ln{0,1}_s/_b (D,), dw{0,1} (k, D),
dwb{0,1} (D,), pw{0,1} (D, D) as (in, out), pwb{0,1} (D,), lnf_s/lnf_b
(D,).  Conv 0's dropout acts on its (B*G*L, D) LN output, keyed by (seed,
flat index) through Philox (ops/philox.py).  ``groups`` (the merged input
encoder under context parallelism, models/stage.py): a (G,) int32 map from
this rank's groups to the whole group axis and that axis's size, so
sequence (b, g) keys as (b, gmap[g]) of the whole tensor, the mask one
process draws there (csrc/philox.cuh ``Dropout::row_key``).

On CUDA any width ``widths.check_width`` takes runs in the instantiation
``widths.padded_width(D)``: the inputs and parameters zero-padded to it
(``pad_inputs``; the position table is the caller's, built at D), the
kernels told the true width, the output sliced back.

Two compute modes, chosen by the activations' type.  float32: exact, the
CUDA-core kernels.  bfloat16 (what the entry points run on the card): the
pointwise products take bf16 operands with float32 sums, as the TPU
kernel's bf16 compute mode does: the forward and backward kernels run
their products on the tensor cores, and the plain version rounds at the
same sites (``block_layers``).
"""
from __future__ import annotations

import ctypes
import functools

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
from tvqaplus_tpu_torch.ops.plain import (
    as_f32,
    depthwise_conv,
    dot,
    layer_norm,
    round_bf16,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U32 = ctypes.c_uint
# the dropout, the true width and the group map, the compute mode, the
# stream
_TAIL = [_P, _U32, _F, _I, _P, _I, _I, _P]
# The forward entries take the width D; each width has its own launch count
# (KERNEL and BLOCK_KERNEL count D = 128, the headline hsz).
# (x, pe, packed, mask, out, the slab scratch wp: widths.slab_scratch)
_REDUCE_ARGS = [_P] * 6 + [_I] * 4 + _TAIL
_BLOCK_ARGS = [_P] * 6 + [_I] * 5 + _TAIL
FWD_BY_WIDTH = {d: CudaKernel("encoder_fwd.cu", "encoder_reduce_fwd",
                              _REDUCE_ARGS) for d in widths.FORWARD_WIDTHS}
BLOCK_BY_WIDTH = {d: CudaKernel("encoder_fwd.cu", "encoder_block_fwd",
                                _BLOCK_ARGS) for d in widths.FORWARD_WIDTHS}
KERNEL = FWD_BY_WIDTH[128]
BLOCK_KERNEL = BLOCK_BY_WIDTH[128]
BWD_KERNEL = CudaKernel("encoder_bwd.cu", "encoder_reduce_bwd",
                        [_P] * 15 + [_I] * 4 + _TAIL)
BLOCK_BWD_KERNEL = CudaKernel("encoder_bwd.cu", "encoder_block_bwd",
                              [_P] * 15 + [_I] * 5 + _TAIL)
# The backwards at the other widths take D, with the same arguments:
# csrc/encoder_bwd_tc_wide.cu (bf16, tensor cores; BWD_BY_WIDTH[d] and
# BLOCK_BWD_BY_WIDTH[d], the main path's, counting at each width) and
# csrc/encoder_bwd_wide.cu (float32, CUDA cores; F32_*_BY_WIDTH[d]).
_WIDE_BWD_ARGS = [_P] * 16 + [_I] * 5 + _TAIL
_WIDE_BLOCK_BWD_ARGS = [_P] * 16 + [_I] * 6 + _TAIL


def _wide_bwd(tc, block):
    source = "encoder_bwd_tc_wide.cu" if tc else "encoder_bwd_wide.cu"
    symbol = ("encoder_block_bwd" if block else "encoder_reduce_bwd") \
        + ("_tc_wide" if tc else "_wide")
    return CudaKernel(source, symbol,
                      _WIDE_BLOCK_BWD_ARGS if block else _WIDE_BWD_ARGS)


_OTHER = [d for d in widths.BACKWARD_WIDTHS if d != 128]
BWD_BY_WIDTH = {128: BWD_KERNEL, **{d: _wide_bwd(True, False)
                                    for d in _OTHER}}
BLOCK_BWD_BY_WIDTH = {128: BLOCK_BWD_KERNEL, **{d: _wide_bwd(True, True)
                                                for d in _OTHER}}
F32_BWD_BY_WIDTH = {d: _wide_bwd(False, False) for d in _OTHER}
F32_BLOCK_BWD_BY_WIDTH = {d: _wide_bwd(False, True) for d in _OTHER}

PARAM_KEYS = ("ln0_s", "ln0_b", "dw0", "dwb0", "pw0", "pwb0",
              "ln1_s", "ln1_b", "dw1", "dwb1", "pw1", "pwb1",
              "lnf_s", "lnf_b")
# Kernel vs plain version on the same inputs: float32 differs only in the
# order of float32 sums; bf16 output is rounded once (LN outputs, O(1)).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
# Backward kernel vs autograd through the plain version: float32 sums over
# all rows in another order (the parameter grads sum 6.4e5 rows at the
# headline shapes).  bfloat16 is held by the relative L2 error of each
# gradient instead (one number; ops/checks.py hold_grad): both sides round
# the products' operands at the same sites, and a float32 difference moves
# such a rounding by a bf16 step, which shifts a ReLU input by up to 3.7e-3
# (scripts/measure_bf16_relu_shift.py); at such a margin every sequence of
# 2 x L x 128 ReLU inputs holds one, and a flipped sign inside the block
# changes its whole sequence, so no elementwise bar stands.  The same
# script measured relative L2 errors of 1.9e-4 .. 2.3e-3 (reduce-mode
# channels within a tie's margin take no cotangent, ops/checks.py
# encoder_tie_elements); the bar allows four times the largest.
GRAD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: 1e-2}
MAX_LEN = 56
# floats of scratch per block of the tensor-core backward behind its slot
# (csrc/encoder_bwd.cu ACC_FLOATS, H_FLOATS): running parameter-gradient
# sums (8 warps x 6 LN vectors and 2 halves x 2 layers x (9 taps + dwb),
# each D wide) and the h stash (64 floats for each of 256 threads)
TC_SUMS = (8 * 6 + 2 * 2 * 10) * 128 + 64 * 256



def wide_tc_launch(n, length, k, d, sms):
    """The grid of the bf16 backward at D = 64 or 256
    (csrc/encoder_bwd_tc_wide.cu) for n sequences of ``length`` on ``sms``
    multiprocessors (one block an SM over tiles of 64 // length sequences;
    at D = 64 a block's two warpgroups take tiles of their own) and the
    floats of a block's ``vec_part`` row (its slot of parameter sums: both
    kernels keep every running sum on the SM)."""
    tiles = -(-n // (64 // length))
    blocks = min(-(-tiles // 2) if d == 64 else tiles, sms)
    return blocks, (2 * (4 + k) + 2) * d


class _StashConv(torch.autograd.Function):
    """``depthwise_conv`` whose weight gradient reads its input rounded to
    bfloat16, as the bf16 kernels (and the TPU kernel's bf16 stash of the LN
    output ``ln_d``, pallas_encoder.py:204-206, :227) take it; the output
    and the input gradient are those of the float32 conv."""

    @staticmethod
    def forward(ctx, t, dw, dwb):
        ctx.save_for_backward(round_bf16(t), dw, dwb)
        return depthwise_conv(t, dw, dwb)

    @staticmethod
    def backward(ctx, g):
        tr, dw, dwb = (x.detach().requires_grad_(True)
                       for x in ctx.saved_tensors)
        with torch.enable_grad():
            return torch.autograd.grad(depthwise_conv(tr, dw, dwb),
                                       (tr, dw, dwb), g)


def block_layers(x, pe, params, k, zero_mask=None, dropout_rate=0.0, seed=0,
                 dv=None, groups=None):
    """The block in plain PyTorch, float32 arithmetic.  Returns the final
    LN's output (B, G, L, D) and the two layers' ReLU inputs (ops/checks.py
    reads them).  ``dv``: the true width of inputs zero-padded past it
    (``pad_inputs``), which every LN averages over and the dropout keys by, as
    the kernels do; ``groups``: the group map (module docstring).  bfloat16
    ``x`` takes the rounding sites of the bf16 kernels, which are the TPU
    kernel's bf16 compute mode: the pointwise products round their operands to
    bf16 (``Bf16Dot``, cotangents included, pallas_encoder.py:199-201,
    :221-226), and the depthwise weight gradient reads the LN output (after
    dropout) rounded to bf16, as the TPU kernel's stash ``ln_d`` is.  Its other
    bf16 stash, ``xhat``, is left unrounded, as the kernels leave it: the LN
    backward recomputes it in float32."""
    bf16 = x.dtype == torch.bfloat16
    h = x.float() + pe.float()
    v = None if zero_mask is None else zero_mask.float()[..., None]
    pre = []
    for i in (0, 1):
        t = layer_norm(h, params[f"ln{i}_s"], params[f"ln{i}_b"], n=dv)
        if i == 0 and dropout_rate > 0.0:
            t = t * _dropout_multiplier(t.shape, seed, dropout_rate, dv,
                                        groups, t.device)
        if v is not None:
            t = t * v
        conv = _StashConv.apply if bf16 else depthwise_conv
        c = conv(t, params[f"dw{i}"].float(), params[f"dwb{i}"].float())
        pre.append(dot(c, params[f"pw{i}"].float(), bf16)
                   + params[f"pwb{i}"].float())
        h = h + torch.relu(pre[-1])
    return layer_norm(h, params["lnf_s"], params["lnf_b"], n=dv), pre


def _dropout_multiplier(shape, seed, p, dv, groups, device):
    """Conv 0's dropout multipliers of the (B, G, L, D) LN output, keyed
    as the kernels key them (module docstring)."""
    bsz, g, length, d = shape
    dv = d if dv is None else dv
    if groups is None:
        return philox.width_multiplier(shape, seed, p, dv, device=device)
    gmap, g_glob = groups
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    seq = ar(bsz)[:, None] * g_glob + gmap.to(device, torch.int64)[None]
    keys = ((seq[..., None] * length + ar(length)) * dv)[..., None] + ar(dv)
    keep = philox.keep_at(keys, seed, p)
    return torch.nn.functional.pad(keep.float() * philox.scale(p),
                                   (0, d - dv))


def encoder_reduce_plain(x, pe, params, k, reduce_mask, dropout_rate=0.0,
                         seed=0, dv=None):
    """Plain PyTorch version.  x (B, G, L, D); pe (L, D); reduce_mask
    (B, G, L).  Returns (B, G, D) in x's dtype.  ``dv`` as
    ``block_layers``."""
    out, _ = block_layers(x, pe, params, k, None, dropout_rate, seed, dv)
    m = reduce_mask.float()[..., None]
    return (out * m + (m - 1.0) * 1e10).amax(dim=-2).to(x.dtype)


def encoder_block_plain(x, pe, params, k, zero_mask=None, dropout_rate=0.0,
                        seed=0, dv=None, groups=None):
    """Plain PyTorch version of the full-output mode.  x (B, G, L, D); pe
    (L, D); zero_mask (G, L) or None; the dropout mask is drawn on the whole
    (B*G*L, D) LN output (with ``groups``, on this rank's part of it).
    Returns (B, G, L, D) in x's dtype.  ``dv`` as ``block_layers``."""
    return block_layers(x, pe, params, k, zero_mask, dropout_rate,
                        seed, dv, groups)[0].to(x.dtype)


def pad_inputs(x, pe, params, dp):
    """x, pe and the parameters zero-padded from their width D to the
    instantiation ``dp`` (the pointwise weights in both dims); the same
    objects at dp = D."""
    d = x.shape[-1]
    if dp == d:
        return x, pe, params
    pad = functools.partial(widths.pad_cols, dp=dp)
    out = {key: pad(p) for key, p in params.items()}
    for key in ("pw0", "pw1"):
        out[key] = widths.pad_weight(params[key], dp)
    return pad(x).contiguous(), pad(pe), out


def pack_params(params):
    """The 14 parameters as one float32 vector in PARAM_KEYS order
    (differentiable: ``torch.cat`` routes its gradient back)."""
    return torch.cat([params[key].float().reshape(-1) for key in PARAM_KEYS])


def _check(x, pe, packed, k, reduce_mask=None, zero_mask=None,
           backward=False, groups=None):
    """Raise on what the kernels do not take (D in
    ``widths.FORWARD_WIDTHS``, the backward ``widths.BACKWARD_WIDTHS``);
    returns the float32 packed parameters, position table and mask (the
    reduce mask, else the zero mask, else None)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, G, L, D), got {tuple(x.shape)}")
    bsz, g, l, d = x.shape
    if backward:
        widths.check_backward_width("encoder", d)
    else:
        widths.check_forward_width("encoder", d)
    if l > MAX_LEN or k % 2 == 0 or k > 9:
        raise ValueError(f"kernel takes L <= {MAX_LEN} and odd k <= 9; got "
                         f"x {tuple(x.shape)}, k {k}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32/bfloat16, got "
                         f"{x.dtype}")
    mask = reduce_mask if reduce_mask is not None else zero_mask
    want = (bsz, g, l) if reduce_mask is not None else (g, l)
    if (mask is not None and mask.shape != want) or pe.shape != (l, d):
        raise ValueError("mask or position table does not match x")
    if packed.shape != ((2 * (4 + k) + 2) * d + 2 * d * d,):
        raise ValueError(f"packed parameters: {tuple(packed.shape)}")
    packed32, pe32 = as_f32(packed), as_f32(pe)
    m32 = None if mask is None else as_f32(mask)
    check_device(x.device, pe=pe32, params=packed32,
                 **({} if m32 is None else {"mask": m32}))
    if x.dtype == torch.bfloat16:      # the forward copies 16-byte chunks
        check_aligned(x=x)
    if groups is not None:
        gmap, _ = groups
        if gmap.shape != (g,) or gmap.dtype != torch.int32:
            raise ValueError(f"the group map must be ({g},) int32")
        check_device(x.device, gmap=gmap)
    return packed32, pe32, m32


def _offsets(k, d=128):
    """Start of each PARAM_KEYS piece in the packed vector."""
    sizes = {"dw0": k * d, "dw1": k * d, "pw0": d * d, "pw1": d * d}
    out, pos = {}, 0
    for key in PARAM_KEYS:
        out[key] = pos
        pos += sizes.get(key, d)
    return out


class _EncoderReduce(torch.autograd.Function):
    """The forward and backward CUDA kernels as one differentiable op over
    (x, packed parameters)."""

    @staticmethod
    def forward(ctx, x, pe, packed, reduce_mask, k, dropout_rate, seed, dv):
        packed32, pe32, m32 = _check(x, pe, packed, k, reduce_mask)
        bsz, g, l, d = x.shape
        out = torch.empty((bsz, g, d), dtype=x.dtype, device=x.device)
        wp = _slabs(x)
        FWD_BY_WIDTH[d].launch(x.device, ptr(x), ptr(pe32), ptr(packed32),
                               ptr(m32), ptr(out), _opt_ptr(wp), bsz * g, l,
                               k, d,
                               *philox.kernel_args(dropout_rate, seed),
                               *_width_args(dv, None),
                               int(x.dtype == torch.bfloat16), dv=dv)
        ctx.save_for_backward(x, pe, packed, reduce_mask)
        ctx.cfg = (k, dropout_rate, seed, dv)
        return out

    @staticmethod
    def backward(ctx, g):
        x, pe, packed, reduce_mask = ctx.saved_tensors
        gx, gpacked = encoder_reduce_backward(x, pe, packed, reduce_mask, g,
                                              *ctx.cfg)
        return gx, None, gpacked, None, None, None, None, None


def _slabs(x):
    """The forward's ``wp``: pw0 and pw1 in bf16 slabs (the bf16 kernel at
    D = 256, ``widths.slab_scratch``), else None."""
    if x.dtype != torch.bfloat16:
        return None
    return widths.slab_scratch("encoder", x.shape[-1], x.device)


def _opt_ptr(t):
    return None if t is None else ptr(t)


def _width_args(dv, groups):
    """The C entries' (dv, gmap, g_glob)."""
    if groups is None:
        return dv, None, 1
    gmap, g_glob = groups
    return dv, ptr(gmap), g_glob


def encoder_reduce_backward(x, pe, packed, reduce_mask, g, k,
                            dropout_rate=0.0, seed=0, dv=None):
    """Launch the reduce mode's backward kernel (CUDA tensors only).
    Returns gx in x's dtype and the float32 gradient of the packed
    parameter vector.  ``dv``: the true width of a padded x (None: x's)."""
    return _backward(x, pe, packed, reduce_mask, None, g, k, dropout_rate,
                     seed, dv)


def encoder_block_backward(x, pe, packed, zero_mask, g, k, dropout_rate=0.0,
                           seed=0, dv=None, groups=None):
    """The same for the full-output mode: ``g`` is the (B, G, L, D)
    cotangent, ``zero_mask`` (G, L) or None; ``groups`` the group map."""
    return _backward(x, pe, packed, None, zero_mask, g, k, dropout_rate, seed,
                     dv, groups, full=True)


def _backward(x, pe, packed, reduce_mask, zero_mask, g, k, dropout_rate,
              seed, dv=None, groups=None, full=False):
    packed32, pe32, m32 = _check(x, pe, packed, k, reduce_mask, zero_mask,
                                 backward=True)
    seed = philox.kernel_seed(dropout_rate, seed, x.device)
    bsz, grp, l, d = x.shape
    dv = d if dv is None else dv
    n = bsz * grp
    g = g.to(x.dtype).contiguous()
    if g.shape != ((bsz, grp, l, d) if full else (bsz, grp, d)):
        raise ValueError("cotangent does not match the output")
    off = _offsets(k, d)
    pws = [packed32[off[key]:off[key] + d * d].view(d, d)
           for key in ("pw0", "pw1")]
    f32 = dict(dtype=torch.float32, device=x.device)
    nv = (2 * (4 + k) + 2) * d
    blocks = min(n, sm_count(x.device))
    gx = torch.empty_like(x)
    tc = x.dtype == torch.bfloat16     # the tensor-core kernel
    if d != 128 and tc:
        # csrc/encoder_bwd_tc_wide.cu: at D = 64 the kernel rounds pw0 and
        # pw1 from packed as it loads them; at 256 [pw0; pw1; pw0^T;
        # pw1^T] in bf16 (its backward products stream them); the c and
        # g_y rows of the weight gradient in bf16
        chunks = tc_wgrad_chunks(n * l, d, d)
        blocks, row = wide_tc_launch(n, l, k, d, sm_count(x.device))
        pw = None if d == 64 else torch.stack(
            pws + [t.t() for t in pws]).to(torch.bfloat16)
        gvec = torch.empty(nv, **f32)
        gpw = torch.empty(2, d + 1, d, **f32)       # [gpw; gpwb] a layer
        scratch = [torch.empty(n * l, d, dtype=x.dtype, device=x.device)
                   for _ in range(4)] + [
            torch.empty(blocks, row, **f32), None,
            torch.empty(chunks, d + 1, d, **f32)]
        kernel = (BLOCK_BWD_BY_WIDTH if full else BWD_BY_WIDTH)[d]
        dims = (n, grp, l, k, d) if full else (n, l, k, d)
    elif d != 128:
        # csrc/encoder_bwd_wide.cu: [pw0^T; pw1^T], the c and g_y rows of
        # the weight gradient, and at D = 256 the per-block scratch of a
        # sequence's seven L x D buffers
        gvec = torch.empty(nv, **f32)
        chunks = wgrad_chunks(n * l, d, d=d)
        gpw = torch.empty(2, d, d, **f32)
        pw = torch.stack([t.t() for t in pws]).contiguous()
        work = widths.encoder_bwd_work_floats(d, l)
        scratch = [torch.empty(n * l, d, **f32) for _ in range(4)] + [
            torch.empty(blocks, nv, **f32),
            torch.empty(blocks, work, **f32) if work else None,
            torch.empty(chunks, d, d, **f32)]
        kernel = (F32_BLOCK_BWD_BY_WIDTH if full else F32_BWD_BY_WIDTH)[d]
        dims = (n, grp, l, k, d) if full else (n, l, k, d)
    elif tc:
        gvec = torch.empty(nv, **f32)
        # [pw0; pw1] as they lie, and the c and g_y rows of the weight
        # gradient in bf16: the kernel rounds them before that product anyway
        pw = torch.stack(pws).to(torch.bfloat16)
        chunks = tc_wgrad_chunks(n * l, d)
        gpw = torch.empty(2, d + 1, d, **f32)       # [gpw; gpwb] per layer
        # vec_part's slots, then the blocks' sums and stashes (TC_SUMS)
        scratch = [torch.empty(n * l, d, dtype=x.dtype, device=x.device)
                   for _ in range(4)] + [
            torch.empty(blocks, nv + TC_SUMS, **f32),
            torch.empty(chunks, d + 1, d, **f32)]
    else:
        gvec = torch.empty(nv, **f32)
        pw = torch.stack([t.t() for t in pws]).contiguous()
        chunks = wgrad_chunks(n * l, d)
        gpw = torch.empty(2, d, d, **f32)
        scratch = [torch.empty(n * l, d, **f32) for _ in range(4)] + [
            torch.empty(blocks, nv, **f32), torch.empty(chunks, d, d, **f32)]
    if d == 128:
        kernel, dims = (BLOCK_BWD_KERNEL, (n, grp, l, k)) if full \
            else (BWD_KERNEL, (n, l, k))
    kernel.launch(x.device, ptr(x), ptr(pe32), ptr(packed32),
                  None if pw is None else ptr(pw),
                  None if m32 is None else ptr(m32), ptr(g), ptr(gx),
                  ptr(gvec), ptr(gpw),
                  *(None if t is None else ptr(t) for t in scratch), *dims,
                  chunks, *philox.kernel_args(dropout_rate, seed),
                  *_width_args(dv, groups), int(tc), dv=dv)
    # gvec per layer: ln_s, ln_b, dw (k), dwb, pwb; then lnf_s, lnf_b (the
    # tensor-core kernel's gpwb is the last row of its gpw)
    pieces = []
    for i in (0, 1):
        v = gvec[i * (4 + k) * d:(i + 1) * (4 + k) * d]
        pieces += [v[:2 * d], v[2 * d:(2 + k) * d], v[(2 + k) * d:(3 + k) * d],
                   gpw[i, :d].reshape(-1),
                   gpw[i, d] if tc else v[(3 + k) * d:]]
    pieces.append(gvec[2 * (4 + k) * d:])
    return gx, torch.cat(pieces)


class _EncoderBlock(torch.autograd.Function):
    """The full-output mode's forward and backward CUDA kernels as one
    differentiable op over (x, packed parameters)."""

    @staticmethod
    def forward(ctx, x, pe, packed, zero_mask, k, dropout_rate, seed, dv,
                groups):
        packed32, pe32, m32 = _check(x, pe, packed, k, zero_mask=zero_mask,
                                     groups=groups)
        bsz, g, l, d = x.shape
        out = torch.empty_like(x)
        wp = _slabs(x)
        BLOCK_BY_WIDTH[d].launch(x.device, ptr(x), ptr(pe32), ptr(packed32),
                                 _opt_ptr(m32), ptr(out), _opt_ptr(wp),
                                 bsz * g, g, l, k, d,
                                 *philox.kernel_args(dropout_rate, seed),
                                 *_width_args(dv, groups),
                                 int(x.dtype == torch.bfloat16), dv=dv)
        ctx.save_for_backward(x, pe, packed, zero_mask)
        ctx.cfg = (k, dropout_rate, seed, dv, groups)
        return out

    @staticmethod
    def backward(ctx, g):
        x, pe, packed, zero_mask = ctx.saved_tensors
        gx, gpacked = encoder_block_backward(x, pe, packed, zero_mask, g,
                                             *ctx.cfg)
        return gx, None, gpacked, None, None, None, None, None, None


def _packed(params, k, d):
    shapes = {"dw0": (k, d), "dw1": (k, d), "pw0": (d, d), "pw1": (d, d)}
    for key in PARAM_KEYS:
        if tuple(params[key].shape) != shapes.get(key, (d,)):
            raise ValueError(f"param {key}: {tuple(params[key].shape)}")
    return pack_params(params)


def encoder_reduce(x, pe, params, k, reduce_mask, dropout_rate=0.0, seed=0):
    """Kernels on CUDA tensors (differentiable through the backward kernel,
    parameters included; a width between the instantiations padded, module
    docstring), plain version on CPU tensors."""
    if not x.is_cuda:
        return encoder_reduce_plain(x, pe, params, k, reduce_mask,
                                    dropout_rate, seed)
    d = x.shape[-1]
    dp = widths.padded_width(d)
    x, pe, params = pad_inputs(x, pe, params, dp)
    out = _EncoderReduce.apply(x, pe, _packed(params, k, dp), reduce_mask,
                               k, dropout_rate,
                               philox.kernel_seed(dropout_rate, seed,
                                                  x.device), d)
    return out if dp == d else out[..., :d]


def encoder_block(x, pe, params, k, zero_mask=None, dropout_rate=0.0, seed=0,
                  groups=None):
    """The full-output mode: kernels on CUDA tensors (differentiable, as
    ``encoder_reduce``), plain version on CPU tensors; ``groups`` the group
    map of the merged input encoder under context parallelism (module
    docstring)."""
    if not x.is_cuda:
        return encoder_block_plain(x, pe, params, k, zero_mask, dropout_rate,
                                   seed, groups=groups)
    d = x.shape[-1]
    dp = widths.padded_width(d)
    x, pe, params = pad_inputs(x, pe, params, dp)
    out = _EncoderBlock.apply(x, pe, _packed(params, k, dp), zero_mask, k,
                              dropout_rate,
                              philox.kernel_seed(dropout_rate, seed,
                                                 x.device), d, groups)
    return out if dp == d else out[..., :d]
