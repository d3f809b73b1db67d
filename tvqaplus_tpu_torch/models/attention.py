"""Cross-modal structured attention (port of
``tvqaplus_tpu/models/attention.py``), plain path.

``structured_attention`` is STAGE's matcher (reference
context_query_attention.py:7-101): every QA word attends over the regions
(or subtitle tokens) of every frame through cosine similarity, softmaxed
over the region axis with temperature ``scale``.  STAGE runs it fused with
the down-projection (ops/qa_ctx_attention.py) unless an attention site
takes void vectors or the batch carries noun masks, which the fused kernel
does not take (as in the JAX package); then this unfused form runs.
``context_query_attention`` is kept for the JAX package's surface only.
"""
from __future__ import annotations

import math

import torch

from tvqaplus_tpu_torch.models.layers import apply_dropout, frame_dropout
from tvqaplus_tpu_torch.ops.masking import safe_softmax


def l2_normalize(x, dim=-1, eps=1e-12):
    """x / max(||x||, eps) with float32 statistics; result in x's dtype."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return (x32 / torch.clamp(norm, min=eps)).to(x.dtype)


def promoted_matmul(a, b):
    """``a @ b`` in the promoted type of the two, as ``jnp.matmul`` takes
    mixed operands (a bfloat16 and a float32 operand multiply in
    float32); ``torch.matmul`` refuses mixed types."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def structured_attention(C, Q, c_mask, q_mask, scale=10.0, drop=None,
                         noun_mask=None, void_vector=None, add_void=False):
    """Cosine structured attention over regions (JAX attention.py:46-113).

    C (N, 5, 1|Li, Lqa, D) QA-word embeddings; Q (N, 1, Li, Lr, D) context
    embeddings; c_mask (N, 5, 1|Li, Lqa); q_mask (N, 1, Li, Lr).  ``drop``
    (a ``layers.Dropout``, None in eval) acts on the normalised inputs
    (reference context_query_attention.py:95-96), Q's through its
    ``frames`` (Q carries Li, which context parallelism shards).  ``noun_mask``
    (N, 5, Lqa) or (N, 5, Li, Lqa) gates the rows of the softmax.
    ``void_vector`` (m, D): learned non-visual vectors appended to the
    region axis with mask 1, so they take part in the softmax; ``add_void``
    keeps them in the weighted sum.  The void vectors are float32, so with
    them the product runs in float32 whatever Q's type, as
    ``jnp.concatenate`` promotes in the JAX package.

    Returns (A, raw_S, S_mask, S_) with shapes (N, 5, Li, Lqa, D) and
    (N, 5, Li, Lqa, Lr) x 3, the void columns stripped."""
    num_void = 0
    if void_vector is not None:
        bsz, _, num_img, _, hsz = Q.shape
        num_void = void_vector.shape[0]
        dt = torch.promote_types(Q.dtype, void_vector.dtype)
        q_void = void_vector.reshape(1, 1, 1, num_void, hsz).expand(
            bsz, 1, num_img, num_void, hsz)
        Q = torch.cat([Q.to(dt), q_void.to(dt)], dim=-2)
        q_mask = torch.cat([q_mask, q_mask.new_ones(
            (bsz, 1, num_img, num_void))], dim=-1)
    cn = apply_dropout(drop, l2_normalize(C))
    qn = apply_dropout(frame_dropout(drop), l2_normalize(Q))
    s_mask = c_mask[..., :, None] * q_mask[..., None, :]
    masked = promoted_matmul(cn, qn.transpose(-2, -1)) - 1e10 * (1.0
                                                                 - s_mask)
    p = safe_softmax(masked * scale, dim=-1) * s_mask
    if noun_mask is not None:
        if noun_mask.dim() == 3:
            p = p * noun_mask[:, :, None, :, None]
        elif noun_mask.dim() == 4:
            p = p * noun_mask[..., None]
        else:
            raise ValueError(f"noun_mask of {noun_mask.dim()} dims; takes "
                             f"(N, 5, Lqa) or (N, 5, Li, Lqa)")
    if num_void:
        att = promoted_matmul(p if add_void else p[..., :-num_void],
                              Q if add_void else Q[..., :-num_void, :])
        return (att, masked[..., :-num_void], s_mask[..., :-num_void],
                p[..., :-num_void])
    return promoted_matmul(p, Q), masked, s_mask, p


def context_query_attention(C, Q, c_mask, q_mask, drop=None):
    """Scaled dot-product context-query attention (JAX attention.py:
    117-130, reference context_query_attention.py:104-142), kept for
    surface parity: STAGE does not call it.  C (..., Lc, D) attends over
    Q (..., Lq, D); the masked scores take -1e10 and ``safe_softmax``;
    ``drop`` acts on C and Q before the scores, the weighted sum reads the
    undropped Q."""
    s_mask = c_mask[..., :, None] * q_mask[..., None, :]
    scores = torch.matmul(apply_dropout(drop, C),
                          apply_dropout(drop, Q).transpose(-2, -1)) \
        / math.sqrt(C.shape[-1])
    return torch.matmul(safe_softmax(scores - 1e10 * (1.0 - s_mask), dim=-1),
                        Q)
