"""VOC-style detection AP (the grounding-mAP metric of TVQA+; the port's
copy of ``tvqaplus_tpu/evaluation/voc.py``).

Fresh numpy implementation of the evaluation semantics used by the reference
(eval/maskrcnn_voc/voc_eval.py:14-217):

* per (image, class): predictions sorted by score descending are greedily
  matched to the argmax-IoU ground-truth box at ``iou_thresh`` (a GT box can
  satisfy only the first prediction that hits it; later hits are FPs);
* boxes are treated as integer-typed: +1 is added to the max corner before
  IoU (voc_eval.py:86-90) on top of the +1-pixel IoU convention itself;
* difficult GT boxes void their matches (-1, excluded from both TP and FP);
* per-class recall denominators count every GT instance of the class
  (voc_eval.py:122-129 recomputes n_pos over all gt, difficult included);
* AP is the every-point (correct) PR-curve area unless ``use_07_metric``.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from tvqaplus_tpu_torch.evaluation.boxes import pairwise_iou


def _match_image_class(pred_boxes, pred_scores, gt_boxes, gt_difficult,
                       iou_thresh):
    """Greedy matching for one (image, class).  Returns match flags per
    prediction in score order: 1=TP, 0=FP, -1=matched-difficult (void)."""
    order = pred_scores.argsort()[::-1]
    pred_boxes = pred_boxes[order]
    if len(pred_boxes) == 0:
        return []
    if len(gt_boxes) == 0:
        return [0] * len(pred_boxes)
    # integer-typed boxes: +1 on the max corner before IoU
    pb = pred_boxes.copy()
    pb[:, 2:] += 1
    gb = gt_boxes.copy()
    gb[:, 2:] += 1
    iou = pairwise_iou(pb, gb)
    gt_index = iou.argmax(axis=1)
    gt_index[iou.max(axis=1) < iou_thresh] = -1

    match = []
    taken = np.zeros(len(gt_boxes), dtype=bool)
    for gi in gt_index:
        if gi >= 0:
            if gt_difficult[gi]:
                match.append(-1)
            elif not taken[gi]:
                match.append(1)
            else:
                match.append(0)
            taken[gi] = True
        else:
            match.append(0)
    return match


def calc_prec_rec(gt_records, pred_records, iou_thresh=0.5):
    """Accumulate per-class precision/recall curves.

    Each record: dict with 'boxes' (N,4 xyxy), 'labels' (N,), plus 'scores'
    for predictions and 'difficult' for ground truth.
    Returns (prec, rec, n_tp, n_fp, n_pos) dicts keyed by class id.
    """
    assert len(gt_records) == len(pred_records)
    score = defaultdict(list)
    match = defaultdict(list)
    all_gt_labels = []
    for gt, pred in zip(gt_records, pred_records):
        pred_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        pred_labels = np.asarray(pred["labels"]).astype(int)
        pred_scores = np.asarray(pred["scores"], np.float64)
        gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt["labels"]).astype(int)
        gt_difficult = np.asarray(
            gt.get("difficult", np.zeros(len(gt_boxes)))).astype(bool)
        all_gt_labels.append(gt_labels)

        for cls in np.unique(np.concatenate([pred_labels, gt_labels])):
            p_sel = pred_labels == cls
            g_sel = gt_labels == cls
            order = pred_scores[p_sel].argsort()[::-1]
            score[cls].extend(pred_scores[p_sel][order])
            match[cls].extend(_match_image_class(
                pred_boxes[p_sel], pred_scores[p_sel],
                gt_boxes[g_sel], gt_difficult[g_sel], iou_thresh))

    # recall denominator: every GT instance of the class (voc_eval.py:122-129)
    all_gt_labels = (np.concatenate(all_gt_labels) if all_gt_labels
                     else np.zeros(0, int))
    prec, rec, n_tp, n_fp, n_pos = {}, {}, {}, {}, {}
    for cls in np.unique(all_gt_labels.astype(int)):
        n_pos[cls] = int(np.sum(all_gt_labels == cls))
        score_c = np.asarray(score[cls])
        match_c = np.asarray(match[cls], np.int8)
        order = score_c.argsort()[::-1]
        match_c = match_c[order]
        tp = np.cumsum(match_c == 1)
        fp = np.cumsum(match_c == 0)
        n_tp[cls] = int(np.sum(match_c == 1))
        n_fp[cls] = int(np.sum(match_c == 0))
        with np.errstate(divide="ignore", invalid="ignore"):
            prec[cls] = tp / (tp + fp)
        rec[cls] = tp / n_pos[cls] if n_pos[cls] > 0 else None
    return prec, rec, n_tp, n_fp, n_pos


def average_precision(prec, rec, use_07_metric=False):
    """AP per class from PR curves (voc_eval.py:161-217)."""
    ap = {}
    for cls in prec:
        if prec[cls] is None or rec[cls] is None:
            ap[cls] = np.nan
            continue
        if use_07_metric:
            val = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                mask = rec[cls] >= t
                p = np.max(np.nan_to_num(prec[cls])[mask]) if mask.any() else 0
                val += p / 11
            ap[cls] = val
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[cls]), [0]))
            mrec = np.concatenate(([0], rec[cls], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap[cls] = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    return ap


def eval_detection_voc(pred_records, gt_records, iou_thresh=0.5,
                       use_07_metric=False):
    """Full detection eval.  Returns (per-class metric dicts, mAP)."""
    prec, rec, n_tp, n_fp, n_pos = calc_prec_rec(gt_records, pred_records,
                                                 iou_thresh)
    ap = average_precision(prec, rec, use_07_metric)
    per_class = [
        {"ap": ap[c], "class_id": int(c),
         "precisions": np.nan_to_num(prec[c]).tolist(),
         "recalls": (rec[c].tolist() if rec[c] is not None else None),
         "n_tp": n_tp[c], "n_fp": n_fp[c], "n_positives": n_pos[c]}
        for c in ap
    ]
    m_ap = float(np.nanmean(list(ap.values()))) if ap else float("nan")
    return per_class, m_ap
