"""Holding a backward kernel against autograd through its plain version.

Both sides take the same discrete decisions from float32 values that they
compute in a different order: the sign of every ReLU input and, in the
encoder, which positions tie for a channel's masked maximum.  Where such a
value lies within float32 rounding of its threshold the two sides may
decide differently, and the whole row's gradient then differs by O(1)
(about one ReLU input in 10^6 at the headline shapes).  The checks zero the
cotangent wherever a decision margin is below ``eps``, well above the
rounding level, so that no compared gradient depends on a decision that
rounding can flip; every other element is held to the bar of ``grad_close``.
Where the ReLU is the op's last step (attention) only that output's
cotangent goes; where more follows it (tri bridge: a LayerNorm over the row;
encoder: the next layer and the max) the whole row or sequence goes.
"""
from __future__ import annotations

import torch

from tvqaplus_tpu_torch.ops.encoder import GRAD_TOL, block_layers
from tvqaplus_tpu_torch.ops.mlp_bridge import mlp_bridge_pre
from tvqaplus_tpu_torch.ops.qa_ctx_attention import qa_ctx_attention_plain
from tvqaplus_tpu_torch.ops.tri_bridge import tri_bridge_pre

# Decision margins: float32 products of 384 (attention, tri bridge) or 128
# (encoder) terms of O(1) round at ~1e-6, so a margin of 1e-4 / 1e-5 leaves
# a factor of 10-100.  About 1% of the rows and 10% of the encoder's
# sequences fall inside it at the headline shapes.
ROW_EPS = 1e-4
SEQ_EPS = 1e-5
# The bf16 attention kernels and their plain version round the softmax and
# the LN output to bfloat16 before a product.  A float32 difference in the
# last place moves such a rounding by a bf16 step (2**-8 relative) in about
# one value in 10^4; a moved softmax weight shifts the row's att by up to
# ~4e-3 and its ReLU inputs by ~3e-3 (measured up to 4.9e-3): the margin
# follows.  About 0.4% of the outputs fall inside it.
BF16_EPS = 5e-3
# The bf16 tri bridge and encoder kernels and their plain versions round the
# dense / pointwise products' operands to bf16 at the same sites, so a float32
# difference in the last place moves such a rounding by one bf16 step in a
# few values in 10^4.  Measured on the plain version against itself with the
# channel order permuted (the same function, other float32 sum orders):
# a ReLU input of the tri bridge moved by up to 2.7e-3 (2.56M inputs,
# scripts/measure_bf16_relu_shift.py), so its margin is 4e-3 (about a
# third of the rows of 128 inputs hold one).
TRI_BF16_EPS = 4e-3
# The MLP bridge's bf16 compute mode rounds the same way (LN output and W,
# 768 or 300 terms a product): a ReLU input moved by up to 2.4e-3 (6M
# inputs at 300 -> 300, 1.6e-3 at 768 -> 300), so it takes the tri
# bridge's margin; about 60% of the rows of 300 inputs hold one.
BRIDGE_BF16_EPS = 4e-3
# The encoder's moved by up to 3.7e-3: every sequence holds such an input,
# so its bf16 backward is held by a relative L2 bar (ops/encoder.py
# GRAD_TOL, hold_grad).  Its final LN outputs moved by up to 3.3e-3, and a
# reduce-mode channel whose two largest masked values lie that close may
# route its gradient to the other position: those channels take no
# cotangent (about 1% of them at the margin of 6e-3).
ENC_BF16_REL_L2 = GRAD_TOL[torch.bfloat16]
ENC_TIE_BF16_EPS = 6e-3


def grad_error(got, want, tol):
    """(max abs error, elements outside the bar) of ``got`` against
    ``want``; the bar is |err| <= tol[0] * max|want| + tol[1] * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max()) or 1.0
    bad = int((err > tol[0] * scale + tol[1] * want.abs()).sum())
    return float(err.max()), bad + int((~torch.isfinite(got)).sum())


def grad_close(name, got, want, tol):
    """Raise unless every element of ``got`` meets ``grad_error``'s bar."""
    err, bad = grad_error(got, want, tol)
    if bad:
        raise AssertionError(f"{name}: {bad} of {want.numel()} elements "
                             f"outside {tol}; max abs err {err}")
    return err


def rel_l2(got, want):
    """Relative L2 error of ``got`` against ``want`` (float32)."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / (want.norm() + 1e-30))


def rel_l2_close(name, got, want, bar):
    """Raise unless ``rel_l2(got, want) <= bar`` and ``got`` is finite."""
    err = rel_l2(got, want)
    if not err <= bar or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: relative L2 error {err} above {bar}")
    return err


def hold_grad(name, got, want, tol):
    """Hold a gradient: elementwise (``grad_close``) when ``tol`` is an
    (absolute, relative) pair, by its relative L2 error (``rel_l2_close``)
    when it is one number.  Returns the error."""
    if isinstance(tol, tuple):
        return grad_close(name, got, want, tol)
    return rel_l2_close(name, got, want, tol)


def attention_flip_elements(cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w,
                            b, scale=10.0, dropout_rate=0.0, seed=0,
                            eps=None):
    """(B, A, Li, Lqa, D) bool: outputs of ``mixed`` whose ReLU input lies
    within ``eps`` of 0 (relu(x) - relu(-x) = x, both from the plain
    version).  bfloat16 activations go through the plain version's bf16
    rounding sites and take ``BF16_EPS``; float32 ones take ``ROW_EPS``."""
    f = [cn, ce, qn, qe]
    if eps is None:
        eps = BF16_EPS if cn.dtype == torch.bfloat16 else ROW_EPS
    kw = dict(scale=scale, raw_mode="none", dropout_rate=dropout_rate,
              seed=seed)
    pre = (qa_ctx_attention_plain(*f, c_mask, q_mask, gamma, beta, w, b,
                                  **kw)
           - qa_ctx_attention_plain(*f, c_mask, q_mask, gamma, beta, -w, -b,
                                    **kw))
    return pre.float().abs() < eps


def tri_bridge_flip_rows(s, v, gamma_in, beta_in, w, b, dropout_rate=0.0,
                         seed=0, eps=None):
    """s's leading shape, bool: rows with a ReLU input within ``eps`` of 0
    (from the plain version, bf16 rounding sites included for bf16 s).
    bfloat16 takes ``TRI_BF16_EPS``, float32 ``ROW_EPS``."""
    if eps is None:
        eps = TRI_BF16_EPS if s.dtype == torch.bfloat16 else ROW_EPS
    return (tri_bridge_pre(s, v, gamma_in, beta_in, w, b, dropout_rate,
                           seed).abs() < eps).any(-1)


def encoder_flip_groups(x, pe, params, k, reduce_mask, dropout_rate=0.0,
                        seed=0, eps=SEQ_EPS):
    """(B, G) bool: sequences with a ReLU input within ``eps`` of 0, or a
    live channel whose two largest masked values lie within ``eps``."""
    out, pre = block_layers(x, pe, params, k, None, dropout_rate, seed)
    near = sum((y.abs() < eps).flatten(-2).any(-1) for y in pre) > 0
    m = reduce_mask.float()[..., None]
    top2 = (out * m + (m - 1.0) * 1e10).topk(2, dim=-2).values
    live = reduce_mask.sum(-1) > 0
    return near | (live & ((top2[..., 0, :] - top2[..., 1, :]) < eps).any(-1))


def encoder_tie_elements(x, pe, params, k, reduce_mask, dropout_rate=0.0,
                         seed=0, eps=ENC_TIE_BF16_EPS):
    """(B, G, D) bool: channels of the reduced output whose two largest
    masked values lie within ``eps`` (a moved rounding may move the max
    between them); the bf16 reduce mode zeroes their cotangent."""
    out, _ = block_layers(x, pe, params, k, None, dropout_rate, seed)
    m = reduce_mask.float()[..., None]
    top2 = (out * m + (m - 1.0) * 1e10).topk(2, dim=-2).values
    return (top2[..., 0, :] - top2[..., 1, :]) < eps


def encoder_block_flip_groups(x, pe, params, k, zero_mask=None,
                              dropout_rate=0.0, seed=0, eps=SEQ_EPS):
    """(B, G) bool, for the full-output mode: sequences with a ReLU input
    within ``eps`` of 0 at a position the zero mask keeps (a masked
    position carries no gradient when its cotangent is 0)."""
    _, pre = block_layers(x, pe, params, k, zero_mask, dropout_rate, seed)
    near = sum((y.abs() < eps).any(-1) for y in pre) > 0         # (B, G, L)
    if zero_mask is not None:
        near = near & (zero_mask > 0)
    return near.any(-1)


def mlp_bridge_flip_rows(x, gamma_in, beta_in, w, b, dropout_rate=0.0,
                         seed=0, compute_dtype=None, eps=None):
    """x's leading shape, bool: rows with a ReLU input within ``eps`` of 0
    (from the plain version, bf16 rounding sites included in the bf16
    compute mode, which takes ``BRIDGE_BF16_EPS``; float32 ``ROW_EPS``)."""
    bf16 = (compute_dtype or x.dtype) == torch.bfloat16
    if eps is None:
        eps = BRIDGE_BF16_EPS if bf16 else ROW_EPS
    return (mlp_bridge_pre(x, gamma_in, beta_in, w, b, dropout_rate, seed,
                           compute_dtype).abs() < eps).any(-1)
