"""Span search, proposal windows and the GT-anchored training proposals
(port of ``tvqaplus_tpu/models/spans.py``).

Ties break as in the JAX package: ``jax.lax.top_k`` and ``jnp.argmax``
return the first (lowest) index among equal values, and so do
``torch.argmax``, ``torch.max`` and a stable descending sort.
"""
from __future__ import annotations

import torch

from tvqaplus_tpu_torch.ops.masking import safe_softmax


def top1_span(p1, p2):
    """The (st, ed) with st <= ed maximising p1[st] * p2[ed], over (..., L)
    (``top_spans`` at top_n=1; reference model_utils.py:92-111)."""
    length = p1.shape[-1]
    product = p1[..., :, None] * p2[..., None, :]
    triu = torch.ones(length, length, dtype=torch.bool,
                      device=p1.device).triu()
    product = torch.where(triu, product, torch.full_like(product,
                                                         -float("inf")))
    idx = product.flatten(-2).argmax(-1)
    return idx // length, idx % length


def top_spans(p1, p2, top_n=1):
    """Top-N spans (st, ed) with st <= ed maximising p1[st] * p2[ed] over
    (..., L); returns (st, ed, conf), each (..., top_n)
    (reference find_max_triples, model_utils.py:92-111)."""
    length = p1.shape[-1]
    product = p1[..., :, None] * p2[..., None, :]
    triu = torch.ones(length, length, dtype=torch.bool,
                      device=p1.device).triu()
    flat = torch.where(triu, product, torch.full_like(product, -float("inf"))
                       ).flatten(-2)
    conf, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    conf, idx = conf[..., :top_n], idx[..., :top_n]
    return idx // length, idx % length, conf


def temporal_iou(pred_st, pred_ed, gt_st, gt_ed):
    """IoU of [st, ed) spans with the reference's simplified union
    (model_utils.py:37-51: union = max(ed) - min(st))."""
    inter = torch.clamp(torch.minimum(pred_ed, gt_ed)
                        - torch.maximum(pred_st, gt_st), min=0.0)
    union = torch.maximum(pred_ed, gt_ed) - torch.minimum(pred_st, gt_st)
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(inter))


def training_proposals(t_scores_ca, ts_st, ts_ed, max_num_proposal=1,
                       iou_thd=0.5, ce_prob_thd=0.01):
    """Fixed-shape training proposals (stage.py:408-418): slot 0 is the GT
    span, slot j > 0 the j-th predicted span of the correct answer's span
    logits ``t_scores_ca`` (N, Li, 2), kept (weight 1) iff its confidence
    is >= ce_prob_thd and its IoU with the GT >= iou_thd.  Returns
    (span_st, span_ed_excl, weights), each (N, 1 + max_num_proposal)."""
    probs = safe_softmax(t_scores_ca.float(), dim=1)
    st, ed, conf = top_spans(probs[..., 0], probs[..., 1], max_num_proposal)
    pred_ed = ed + 1
    gt_st = ts_st[:, None].long()
    gt_ed = ts_ed[:, None].long() + 1
    iou = temporal_iou(st.float(), pred_ed.float(), gt_st.float(),
                       gt_ed.float())
    keep = ((conf >= ce_prob_thd) & (iou >= iou_thd)).float()
    return (torch.cat([gt_st, st], dim=1), torch.cat([gt_ed, pred_ed], dim=1),
            torch.cat([torch.ones_like(keep[:, :1]), keep], dim=1))


def find_max_pair(p1, p2):
    """Greedy best-span scan (reference inference.py:13-35): pair each end
    with the running argmax of p1 (first occurrence), keep the first best
    pair; (0, 1) with value 0 when no pair scores above 0.  (..., L) ->
    (st, ed, value), each (...)."""
    length = p1.shape[-1]
    cm = torch.cummax(p1, dim=-1).values
    idx = torch.arange(length, device=p1.device).expand_as(p1)
    is_new_max = torch.cat([torch.ones_like(p1[..., :1], dtype=torch.bool),
                            p1[..., 1:] > cm[..., :-1]], dim=-1)
    first = torch.where(is_new_max, idx, torch.full_like(idx, -1))
    argcm = torch.cummax(first, dim=-1).values
    vals = cm * p2
    best_ed = vals.argmax(-1)
    best_val = vals.gather(-1, best_ed[..., None])[..., 0]
    best_st = argcm.gather(-1, best_ed[..., None])[..., 0]
    default = best_val <= 0
    best_st = torch.where(default, torch.zeros_like(best_st), best_st)
    best_ed = torch.where(default, torch.ones_like(best_ed), best_ed)
    best_val = torch.where(default, torch.zeros_like(best_val), best_val)
    return best_st, best_ed, best_val


def expand_window_mask(st, ed_excl, length, extra=0):
    """(..., length) float mask of [max(0, st - extra), ed_excl + extra)
    (expand_span + python slicing, model_utils.py:78-89)."""
    idx = torch.arange(length, device=st.device)
    lo = torch.clamp(st - extra, min=0)[..., None]
    hi = (ed_excl + extra)[..., None]
    return ((idx >= lo) & (idx < hi)).float()


def eval_proposals(t_scores):
    """Top-1 span per (example, answer) for evaluation (stage.py:439-448):
    softmax over Li, unconstrained top-1.  t_scores (N, A, Li, 2) ->
    (st, ed_excl), each (N, A)."""
    probs = safe_softmax(t_scores.float(), dim=2)
    st, ed = top1_span(probs[..., 0], probs[..., 1])
    return st, ed + 1
