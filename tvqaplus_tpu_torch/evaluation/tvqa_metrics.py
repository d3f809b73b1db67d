"""TVQA+ metrics: QA accuracy, temporal R@k / mIoU, ASA, grounding mAP (the
port's copy of ``tvqaplus_tpu/evaluation/tvqa_metrics.py``).

Protocol-compatible with the reference evaluator
(eval/eval_tvqa_plus.py:30-248): consumes the same GT annotation JSON and the
same ``*_inference_predictions.json`` format ({"ts_answer": qid -> [[st, ed],
ans_idx], "raw_bbox": [...]}) and reports the same four headline numbers.
Run as a CLI: ``python -m tvqaplus_tpu_torch.evaluation.tvqa_metrics
--pred_path ... [--gt_path eval_data/tvqa_plus_val.json]``.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from tvqaplus_tpu_torch.evaluation.voc import eval_detection_voc
from tvqaplus_tpu_torch.utils.io import load_json, save_json_pretty
from tvqaplus_tpu_torch.utils.misc import merge_dicts


def clean_label(label_str):
    """Normalize curly quotes + case (eval_tvqa_plus.py:9-10)."""
    return label_str.replace(u"’", "'").replace(u"‘", "'").lower()


def compute_temporal_iou(pred, gt):
    """IoU of [st, ed] second spans, simplified union
    (eval_tvqa_plus.py:13-27)."""
    intersection = max(0, min(pred[1], gt[1]) - max(pred[0], gt[0]))
    union = max(pred[1], gt[1]) - min(pred[0], gt[0])
    return 1.0 * intersection / union if union != 0 else 0


def compute_temporal_metrics(pred_dict, gt_dict):
    """R@{0.1..0.9}, mIoU, QA Acc and ASA over qid-keyed
    {qid: [[st, ed], ans_idx]} dicts (eval_tvqa_plus.py:30-67)."""
    keys = sorted(pred_dict.keys())
    gt_key_type = type(next(iter(gt_dict.keys())))
    pred_ts = [pred_dict[k][0] for k in keys]
    gt_ts = [gt_dict[gt_key_type(k)][0] for k in keys]
    iou_array = np.array([compute_temporal_iou(p, g)
                          for p, g in zip(pred_ts, gt_ts)])
    pred_ans = np.array([pred_dict[k][1] for k in keys])
    gt_ans = np.array([gt_dict[gt_key_type(k)][1] for k in keys])
    answer_mask = pred_ans == gt_ans

    res = {}
    for iou_thd in np.arange(0.1, 1, 0.1):
        res["R@{:.2f}".format(iou_thd)] = float(
            np.sum(iou_array >= iou_thd)) / len(iou_array)
    res["miou"] = float(np.sum(iou_array)) / len(iou_array)
    res["ans_span_joint_acc@.5"] = float(
        np.sum(answer_mask * (iou_array >= 0.5))) / len(answer_mask)
    res["qa_acc"] = float(np.sum(answer_mask)) / len(answer_mask)
    return res


def load_tvqa_plus_annotation(anno_path):
    """GT json -> {ts_answer: qid -> [[st,ed], ans], bbox: img_name ->
    [[label, 1, xyxy]]} with img_name = "{vid}_{qid}_{img:05d}"
    (eval_tvqa_plus.py:149-171)."""
    raw = load_json(anno_path)
    gt_box_info = defaultdict(list)
    gt_ts_answer = {}
    for e in raw:
        qid, vid_name = e["qid"], e["vid_name"]
        gt_ts_answer[qid] = [e["ts"], int(e["answer_idx"])]
        for frm_id, box_list in e["bbox"].items():
            img_name = "{}_{}_{:05d}".format(vid_name, int(qid), int(frm_id))
            for b in box_list:
                gt_box_info[img_name].append(
                    [clean_label(b["label"]), 1,
                     [b["left"], b["top"],
                      b["left"] + b["width"], b["top"] + b["height"]]])
    return dict(ts_answer=gt_ts_answer, bbox=gt_box_info)


def load_predictions(pred_path, gt_path, w2i_path):
    """Reformat the model's raw_bbox output for scoring: keep only the
    predictions of the GT answer index, and only words annotated in the GT
    frame (eval_tvqa_plus.py:174-206)."""
    raw_preds = load_json(pred_path)
    gt_data = load_json(gt_path)
    word2idx = load_json(w2i_path)
    idx2word = {i: w for w, i in word2idx.items()}
    qid2ans = {int(e["qid"]): int(e["answer_idx"]) for e in gt_data}
    qid2bbox = {int(e["qid"]): e["bbox"] for e in gt_data}
    bbox_preds = {}
    for e in raw_preds["raw_bbox"]:
        qid = None
        for i in range(5):
            if len(e[str(i)]) > 0:
                qid = e[str(i)][0]["qid"]
        assert qid is not None, "empty raw_bbox record"
        ans_idx = qid2ans[int(qid)]
        cur_gt_bbox = qid2bbox[int(qid)]
        for p in e[str(ans_idx)]:
            annotated_word_ids = [
                word2idx.get(clean_label(b["label"]), word2idx["<unk>"])
                for b in cur_gt_bbox[str(p["img_idx"])]]
            collected = []
            for idx, b in enumerate(p["bbox"]):
                if p["word"] in annotated_word_ids:
                    collected.append(
                        [idx2word[p["word"]], float(p["pred"][idx]), b])
            key = "{vid_name}_{qid}_{img_idx:05d}".format(
                vid_name=p["vid_name"], qid=qid, img_idx=p["img_idx"])
            bbox_preds.setdefault(key, []).extend(collected)
    return dict(ts_answer=raw_preds["ts_answer"], bbox=bbox_preds)


def _to_records(im2boxes, word2idx, rm_unk=True, add_difficult=False):
    """{img_name: [[label, score, xyxy]]} -> per-image detection records
    keyed consistently; drops <unk>-labeled boxes (eval_tvqa_plus.py:97-121).
    Returns dict img_name -> record."""
    records = {}
    for img_name, entries in im2boxes.items():
        labels = [word2idx.get(e[0], word2idx["<unk>"]) for e in entries]
        scores = [e[1] for e in entries]
        boxes = [e[2] for e in entries]
        if rm_unk:
            keep = [i for i, l in enumerate(labels)
                    if int(l) != word2idx["<unk>"]]
            labels = [labels[i] for i in keep]
            scores = [scores[i] for i in keep]
            boxes = [boxes[i] for i in keep]
            if not boxes:
                continue
        rec = {"boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
               "labels": np.asarray(labels, int),
               "scores": np.asarray(scores, np.float64)}
        if add_difficult:
            rec["difficult"] = np.zeros(len(labels), bool)
        records[img_name] = rec
    return records


_EMPTY_PRED = {"boxes": np.zeros((1, 4)), "labels": np.zeros(1, int),
               "scores": np.zeros(1)}


def compute_att_metrics(pred_im2boxes, gt_im2boxes, word2idx):
    """Grounding mAP@0.5 via VOC detection eval (eval_tvqa_plus.py:79-146).
    Images with GT but no prediction get a zero placeholder box."""
    pred_records = _to_records(pred_im2boxes, word2idx)
    gt_records = _to_records(gt_im2boxes, word2idx, add_difficult=True)
    gt_list, pred_list = [], []
    for img_name, gt_rec in gt_records.items():
        gt_list.append(gt_rec)
        pred_list.append(pred_records.get(img_name, _EMPTY_PRED))
    per_class, m_ap = eval_detection_voc(pred_list, gt_list, iou_thresh=0.5)
    idx2word = {i: w for w, i in word2idx.items()}
    per_class = {idx2word[m["class_id"]]: dict(m, label=idx2word[m["class_id"]])
                 for m in per_class}
    return {"metrics_per_class": per_class, "overall_map": m_ap}


def evaluate_tvqa_plus(pred_path, gt_path, word2idx_path,
                       no_preproc_pred=False):
    """End-to-end scoring; returns the merged metrics dict."""
    groundtruth = load_tvqa_plus_annotation(gt_path)
    if no_preproc_pred:
        prediction = load_json(pred_path)
    else:
        prediction = load_predictions(pred_path, gt_path, word2idx_path)
    word2idx = load_json(word2idx_path)
    bbox_metrics = compute_att_metrics(prediction["bbox"],
                                       groundtruth["bbox"], word2idx)
    temporal_metrics = compute_temporal_metrics(prediction["ts_answer"],
                                                groundtruth["ts_answer"])
    return merge_dicts([bbox_metrics, temporal_metrics])


def main_eval():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt_path", type=str,
                        default="eval_data/tvqa_plus_val.json")
    parser.add_argument("--pred_path", type=str, required=True)
    parser.add_argument("--word2idx_path", type=str,
                        default="eval_data/word2idx.json")
    parser.add_argument("--output_path", type=str)
    parser.add_argument("--no_preproc_pred", action="store_true")
    args = parser.parse_args()

    metrics = evaluate_tvqa_plus(args.pred_path, args.gt_path,
                                 args.word2idx_path, args.no_preproc_pred)
    print("QA Acc. {}\nGrd. mAP {}\nTemp. mIoU {}\nASA {}".format(
        metrics["qa_acc"], metrics["overall_map"], metrics["miou"],
        metrics["ans_span_joint_acc@.5"]))
    if args.output_path:
        save_json_pretty(metrics, args.output_path)


if __name__ == "__main__":
    main_eval()
