"""STAGE's losses (port of ``tvqaplus_tpu/models/losses.py``).

* ``cls_loss``: sum-reduction cross-entropy over the answers with the
  reference's ``len(qids)/len(targets)`` proposal rescale (main.py:57-59)
  through the proposal weights.
* ``ts_loss``: start/end CE-sum on the correct answer's span logits,
  averaged over the two heads (stage.py:539-555).
* ``att_loss``: the supervised spatial-attention ranking loss on the
  collate-time entries (data/labels.py ``att_entries_from_dense``): each
  positive entry is paired with ``num_negatives`` negatives of its own
  (img, word) group, uniformly (``gumbel`` noise, which the caller draws:
  argmax of the noise over the group's negatives), or by score rank with
  hard negatives (optionally sampled inside rank windows), then hinge or
  LSE summed over the valid pairs (stage.py:557-611, 738-745).
"""
from __future__ import annotations

import torch

from tvqaplus_tpu_torch.ops.masking import safe_log_softmax


def _ce_sum(logits, targets, weights):
    """-sum_i w_i log_softmax(logits_i)[t_i]; logits (..., C)."""
    logp = safe_log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(picked * weights).sum()


def cls_loss(answer_scores, proposal_weights, targets, ex_mask,
             count_sum=None):
    """Answer classification loss: (loss, n_correct, n_total).  Train
    shape answer_scores (B, P, A) with proposal_weights (B, P); eval shape
    (B, A).  The train loss rescales by the batch's (real examples,
    weighted proposals); under data parallelism ``count_sum`` sums the
    (2,) count vector over the ranks in place, so each rank rescales by the
    global batch's counts (JAX losses.py:56-66 sums them over the global
    batch) and the ranks' losses sum to the global loss."""
    if answer_scores.dim() == 3:
        b, p, _ = answer_scores.shape
        w = proposal_weights * ex_mask[:, None]
        tgt = targets[:, None].expand(b, p)
        raw = _ce_sum(answer_scores, tgt, w)
        n_eff = w.sum()
        counts = torch.stack([ex_mask.sum(), n_eff]).detach()
        if count_sum is not None:
            count_sum(counts)
        loss = raw * counts[0] / torch.clamp(counts[1], min=1.0)
        pred = answer_scores.argmax(-1)
        return loss, ((pred == tgt).float() * w).sum(), n_eff
    raw = _ce_sum(answer_scores, targets, ex_mask)
    pred = answer_scores.argmax(-1)
    return raw, ((pred == targets).float() * ex_mask).sum(), ex_mask.sum()


def ts_loss(t_scores, ts_st, ts_ed, targets, ex_mask):
    """Temporal span loss: t_scores (B, A, Li, 2), already masked."""
    ca = t_scores[torch.arange(t_scores.shape[0], device=t_scores.device),
                  targets.long()]
    return (_ce_sum(ca[..., 0], ts_st, ex_mask)
            + _ce_sum(ca[..., 1], ts_ed, ex_mask)) / 2.0


def gumbel_noise(shape, generator, device):
    """Standard Gumbel noise -log(-log(U)), U uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def att_loss(scores, entries, targets, ex_mask, gumbel=None,
             num_negatives=2, loss_type="lse", margin=0.1, alpha=20.0,
             use_hard_negatives=False, drop_topk=0, negative_pool_size=0,
             num_hard=2, entry_cap=128):
    """Supervised-attention ranking loss on the collate-time entries.

    scores: (B, A, Li, Lqa, Lr) raw scores, or (B, Li, Lqa, Lr) already at
    the target answer.  entries: the batch's ``att_*`` arrays
    (data/batching.py).  gumbel: (B, E, K, Lr) noise for the uniform and
    pool-window negatives (E = min(entry_cap, Li*Lqa*Lr), K =
    num_negatives); unused with direct hard negatives.  Returns (loss,
    {"att_n_pairs", "att_n_pos_dropped"})."""
    if scores.dim() == 5:
        b, _, li, lw, lr = scores.shape
        pred = scores[torch.arange(b, device=scores.device), targets.long()]
    else:
        b, li, lw, lr = scores.shape
        pred = scores
    m = li * lw * lr
    e = min(entry_cap, m)
    pred_flat = pred.reshape(b, m).float()
    entry_idx = entries["att_entry_idx"][:, :e].long()
    entry_valid = entries["att_entry_valid"][:, :e] * ex_mask[:, None]
    neg_rows = entries["att_neg_rows"][:, :e]
    rank = entries["att_entry_rank"][:, :e]
    n_pos_group = entries["att_group_npos"][:, :e]
    n_pos_dropped = torch.clamp(entries["att_n_pos"] - e, min=0.0).sum()

    pos_scores = pred_flat.gather(1, entry_idx)                   # (B, E)
    iw = entry_idx // lr
    score_rows = pred_flat.reshape(b, li * lw, lr).gather(
        1, iw[..., None].expand(b, e, lr))                        # (B, E, Lr)
    n_neg = neg_rows.sum(-1)
    has_neg = (n_neg > 0).float()
    k = num_negatives
    # filled on the device: a host->device copy would break a CUDA graph
    ninf = torch.full((), -float("inf"), device=scores.device)
    zero = torch.zeros((), device=scores.device)
    if not use_hard_negatives:
        logits = torch.where(neg_rows[:, :, None, :] > 0, zero, ninf)
        neg_r = (logits + gumbel).argmax(-1)                      # (B, E, K)
        pair_valid = (entry_valid * has_neg)[..., None].expand(b, e, k)
    else:
        order = torch.argsort(
            -torch.where(neg_rows > 0, score_rows, ninf), dim=-1,
            stable=True)                                          # (B, E, Lr)
        ks = torch.arange(k, device=scores.device)[None, None, :]
        if negative_pool_size > num_negatives:
            n_hard = num_hard if num_hard < num_negatives else num_negatives
            is_hard = ks < n_hard
            ranks = torch.arange(lr, device=scores.device)[None, None, None]
            below = ranks < n_neg[..., None, None]
            hard_win = ((ranks >= drop_topk)
                        & (ranks < drop_topk + negative_pool_size) & below)
            easy_win = (ranks >= drop_topk + negative_pool_size) & below
            win = torch.where(is_hard[..., None], hard_win, easy_win)
            sel_rank = (torch.where(win, zero, ninf) + gumbel).argmax(-1)
            window_ok = win.any(-1)
        else:
            sel_rank = drop_topk + ks * n_pos_group[..., None] \
                + rank[..., None]
            window_ok = sel_rank < n_neg[..., None]
            sel_rank = torch.clamp(sel_rank, 0, lr - 1)
        neg_r = order.gather(-1, sel_rank.long())
        pair_valid = (entry_valid * has_neg)[..., None] * window_ok.float()
    neg_scores = score_rows.gather(-1, neg_r)                     # (B, E, K)
    diff = neg_scores - pos_scores[..., None]
    # invalid pairs gather arbitrary (possibly -1e10 padding) scores: zero
    # their diff before the exp so neither value nor gradient sees inf
    diff = torch.where(pair_valid > 0, diff, torch.zeros_like(diff))
    if loss_type == "hinge":
        per_pair = torch.clamp(margin + diff, min=0.0)
    elif loss_type == "lse":
        per_pair = torch.log1p(torch.exp(alpha * diff))
    else:
        raise NotImplementedError("only hinge and lse are supported")
    loss = (per_pair * pair_valid).sum()
    return loss, {"att_n_pairs": pair_valid.sum(),
                  "att_n_pos_dropped": n_pos_dropped}


def total_loss(outputs, batch, gumbel=None, *, att_weight=0.1,
               ts_weight=0.5, use_sup_att=False, use_hard_negatives=False,
               num_negatives=2, att_loss_type="lse", margin=0.1, alpha=20.0,
               drop_topk=0, negative_pool_size=0, num_hard=2, entry_cap=128,
               vfeat_flag=True, train=True, count_sum=None):
    """loss = cls + ts_weight ts + att_weight att (main.py:55-60).  Returns
    (loss, metrics); every metric is a sum over this batch's rows
    (``count_sum``: see ``cls_loss``)."""
    c_loss, n_correct, n_eff = cls_loss(
        outputs["answer_scores"], outputs["proposal_weights"],
        batch["target"], batch["ex_mask"], count_sum)
    t_loss = ts_loss(outputs["t_scores"], batch["ts_st"], batch["ts_ed"],
                     batch["target"], batch["ex_mask"])
    metrics = {"loss_cls": c_loss, "loss_ts": ts_weight * t_loss,
               "n_correct": n_correct, "n_eff": n_eff,
               "n_examples": batch["ex_mask"].sum()}
    loss = c_loss + ts_weight * t_loss
    if use_sup_att and train and vfeat_flag:
        scores = outputs.get("vid_raw_target_s")
        if scores is None:
            scores = outputs["vid_raw_s"]
        a_loss, aux = att_loss(
            scores, batch, batch["target"], batch["ex_mask"], gumbel,
            num_negatives=num_negatives, loss_type=att_loss_type,
            margin=margin, alpha=alpha,
            use_hard_negatives=use_hard_negatives, drop_topk=drop_topk,
            negative_pool_size=negative_pool_size, num_hard=num_hard,
            entry_cap=entry_cap)
        loss = loss + att_weight * a_loss
        metrics["loss_att"] = att_weight * a_loss
        metrics.update(aux)
    else:
        metrics["loss_att"] = torch.zeros((), device=loss.device)
    metrics["loss"] = loss
    return loss, metrics
