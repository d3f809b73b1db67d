"""The TVQA+ evaluator (QA accuracy, temporal mIoU, ASA, grounding mAP)."""
from tvqaplus_tpu_torch.evaluation.boxes import Boxes, pairwise_iou
from tvqaplus_tpu_torch.evaluation.voc import eval_detection_voc
from tvqaplus_tpu_torch.evaluation.tvqa_metrics import (
    compute_temporal_iou,
    compute_temporal_metrics,
    compute_att_metrics,
    load_tvqa_plus_annotation,
    load_predictions,
    evaluate_tvqa_plus,
)
