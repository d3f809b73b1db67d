"""The PyTorch port's own evaluator (``tvqaplus_tpu_torch.evaluation``)
against ``tvqaplus_tpu.evaluation``: boxes, VOC detection AP, the temporal
metrics, the GT self-check on the real val set, and the CLI."""
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from tvqaplus_tpu.data.fixtures import write_artifacts
from tvqaplus_tpu.evaluation import boxes as jboxes
from tvqaplus_tpu.evaluation import tvqa_metrics as jmetrics
from tvqaplus_tpu.evaluation import voc as jvoc
from tvqaplus_tpu_torch.data.fixtures import gt_as_prediction
from tvqaplus_tpu_torch.evaluation import boxes as tboxes
from tvqaplus_tpu_torch.evaluation import tvqa_metrics as tmetrics
from tvqaplus_tpu_torch.evaluation import voc as tvoc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL_JSON = os.path.join(REPO, "eval_data", "tvqa_plus_val.json")
W2I_JSON = os.path.join(REPO, "eval_data", "word2idx.json")
HEADLINE = ("qa_acc", "overall_map", "miou", "ans_span_joint_acc@.5")


def random_xyxy(rng, n, canvas=(640, 360)):
    x1 = rng.integers(0, canvas[0] - 60, n)
    y1 = rng.integers(0, canvas[1] - 60, n)
    return np.stack([x1, y1, x1 + rng.integers(1, 60, n),
                     y1 + rng.integers(1, 60, n)], 1).astype(np.float64)


def same_boxes(got, ref):
    np.testing.assert_array_equal(got.bbox, ref.bbox)
    assert (got.size, got.mode, got.fields()) == \
        (tuple(ref.size), ref.mode, ref.fields())
    for f in ref.fields():
        np.testing.assert_array_equal(got.get_field(f), ref.get_field(f))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boxes_and_pairwise_iou_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = random_xyxy(rng, 7), random_xyxy(rng, 5)
    got, ref = tboxes.Boxes(a, (640, 360)), jboxes.Boxes(a, (640, 360))
    for box in (got, ref):
        box.add_field("labels", np.arange(7))
    same_boxes(got, ref)
    for mode in ("xywh", "xyxy"):
        same_boxes(got.convert(mode), ref.convert(mode))
    same_boxes(got.convert("xywh").convert("xyxy"),
               ref.convert("xywh").convert("xyxy"))
    same_boxes(got.resize((320, 720)), ref.resize((320, 720)))
    same_boxes(got.clip_to_image(), ref.clip_to_image())
    for method in (tboxes.FLIP_LEFT_RIGHT, tboxes.FLIP_TOP_BOTTOM):
        same_boxes(got.transpose(method), ref.transpose(method))
    with pytest.raises(NotImplementedError):
        got.transpose(2)
    same_boxes(got.crop((20, 30, 200, 150)), ref.crop((20, 30, 200, 150)))
    same_boxes(got[[0, 3]], ref[[0, 3]])
    np.testing.assert_array_equal(got.area(), ref.area())
    np.testing.assert_array_equal(got.convert("xywh").area(),
                                  ref.convert("xywh").area())
    np.testing.assert_array_equal(
        tboxes.pairwise_iou(got, tboxes.Boxes(b, (640, 360))),
        jboxes.pairwise_iou(ref, jboxes.Boxes(b, (640, 360))))
    np.testing.assert_array_equal(tboxes.pairwise_iou(a, b),
                                  jboxes.pairwise_iou(a, b))
    same_boxes(tboxes.cat_boxes([got, got[[1]]]),
               jboxes.cat_boxes([ref, ref[[1]]]))


def test_pairwise_iou_counts_the_extra_pixel():
    a = tboxes.Boxes([[0, 0, 9, 9]], (640, 360))
    c = tboxes.Boxes([[5, 0, 14, 9]], (640, 360))
    assert tboxes.pairwise_iou(a, c)[0, 0] == 50.0 / 150.0
    assert tboxes.pairwise_iou(a, a)[0, 0] == 1.0


def random_records(rng, n_img, n_cls):
    gts, preds = [], []
    for _ in range(n_img):
        n_gt = int(rng.integers(1, 5))
        gt_boxes = random_xyxy(rng, n_gt)
        gts.append({"boxes": gt_boxes,
                    "labels": rng.integers(0, n_cls, n_gt),
                    "difficult": rng.random(n_gt) < 0.15})
        n_pred = int(rng.integers(0, 7))
        # predictions near the GT boxes (hits, double hits) and elsewhere
        near = gt_boxes[rng.integers(0, n_gt, n_pred)] + \
            rng.integers(-6, 7, (n_pred, 4))
        far = random_xyxy(rng, n_pred)
        pick = rng.random(n_pred) < 0.7
        preds.append({"boxes": np.where(pick[:, None], near, far),
                      "labels": rng.integers(0, n_cls, n_pred),
                      "scores": rng.random(n_pred).round(2)})
    return gts, preds


@pytest.mark.parametrize("use_07", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_voc_detection_eval_matches_jax(seed, use_07):
    gts, preds = random_records(np.random.default_rng(seed), 12, 4)
    got = tvoc.eval_detection_voc(preds, gts, 0.5, use_07)
    ref = jvoc.eval_detection_voc(preds, gts, 0.5, use_07)
    np.testing.assert_equal(got, ref)
    got = tvoc.calc_prec_rec(gts, preds, 0.3)
    ref = jvoc.calc_prec_rec(gts, preds, 0.3)
    np.testing.assert_equal(got, ref)
    np.testing.assert_equal(tvoc.average_precision(got[0], got[1], use_07),
                            jvoc.average_precision(ref[0], ref[1], use_07))


GT1 = [{"boxes": np.array([[0, 0, 10, 10]]), "labels": np.array([1]),
        "difficult": np.zeros(1, bool)}]


@pytest.mark.parametrize("pred_boxes, scores, n_tp, n_fp, ap", [
    ([[0, 0, 10, 10], [0, 0, 10, 10]], [0.9, 0.8], 1, 1, 1.0),  # double hit
    ([[100, 100, 110, 110]], [0.9], 0, 1, 0.0),                 # a miss
    ([[100, 100, 110, 110], [0, 0, 10, 10]], [0.9, 0.8], 1, 1, 0.5),
])
def test_voc_greedy_matching_cases_match_jax(pred_boxes, scores, n_tp, n_fp,
                                             ap):
    pred = [{"boxes": np.array(pred_boxes), "scores": np.array(scores),
             "labels": np.ones(len(scores), int)}]
    got, m_ap = tvoc.eval_detection_voc(pred, GT1)
    np.testing.assert_equal((got, m_ap), jvoc.eval_detection_voc(pred, GT1))
    assert (got[0]["n_tp"], got[0]["n_fp"], m_ap) == (n_tp, n_fp, ap)


@pytest.mark.parametrize("seed", [0, 1])
def test_temporal_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    gt, pred = {}, {}
    for qid in rng.choice(10_000, 40, replace=False):
        st = float(rng.uniform(0, 50))
        gt[int(qid)] = [[st, st + float(rng.choice([0.0, 3.0, 9.5]))],
                        int(rng.integers(0, 5))]
        pst = st + float(rng.uniform(-4, 4))
        pred[str(qid)] = [[pst, pst + float(rng.uniform(0, 8))],
                          int(rng.integers(0, 5))]
    got = tmetrics.compute_temporal_metrics(pred, gt)
    assert got == jmetrics.compute_temporal_metrics(pred, gt)
    assert 0 < got["qa_acc"] < 1 and 0 < got["miou"] < 1
    span = [[2.0, 6.0], [4.0, 10.0]]
    assert tmetrics.compute_temporal_iou(*span) == \
        jmetrics.compute_temporal_iou(*span) == 0.25
    for label in ("Sheldon’s", "‘CUP’", "cup"):
        assert tmetrics.clean_label(label) == jmetrics.clean_label(label)


def test_gt_self_check_on_real_val_set_matches_jax(tmp_path):
    """The reference's self-check (eval/readme.txt:13-17): the GT scored as
    a prediction gives QA Acc 1.0 and ~0.999 on the other three."""
    gt = tmetrics.load_tvqa_plus_annotation(VAL_JSON)
    assert gt == jmetrics.load_tvqa_plus_annotation(VAL_JSON)
    assert len(gt["ts_answer"]) == 3017
    pred = gt_as_prediction(VAL_JSON, str(tmp_path / "gt_as_pred.json"))
    got = tmetrics.evaluate_tvqa_plus(pred, VAL_JSON, W2I_JSON,
                                      no_preproc_pred=True)
    ref = jmetrics.evaluate_tvqa_plus(pred, VAL_JSON, W2I_JSON,
                                      no_preproc_pred=True)
    assert list(got) == list(ref)
    np.testing.assert_equal(got, ref)
    assert got["qa_acc"] == 1.0
    assert all(got[k] > 0.99 for k in HEADLINE), {k: got[k] for k in HEADLINE}
    # what chip_smoke.py's evaluator phase holds the card machine to
    assert {k: got[k] for k in chip_smoke.EVAL_SELF_CHECK} == \
        chip_smoke.EVAL_SELF_CHECK
    lo, hi = chip_smoke.EVAL_MAP_RANGE
    assert lo < got["overall_map"] < hi


def test_evaluator_cli_prints_what_jax_prints(tmp_path):
    paths = write_artifacts(str(tmp_path / "a"), n_videos=4, qa_per_video=2,
                            frames_per_video=42, bert_dim=8, vfeat_dim=4,
                            num_region=5, split="overlap")
    pred = gt_as_prediction(paths["valid_path"], str(tmp_path / "p.json"))
    out = {}
    for pkg in ("tvqaplus_tpu", "tvqaplus_tpu_torch"):
        metrics_path = str(tmp_path / f"{pkg}.json")
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.evaluation.tvqa_metrics",
             "--pred_path", pred, "--gt_path", paths["valid_path"],
             "--word2idx_path", paths["word2idx_path"], "--no_preproc_pred",
             "--output_path", metrics_path],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        with open(metrics_path) as f:
            out[pkg] = (r.stdout, f.read())
    assert out["tvqaplus_tpu_torch"] == out["tvqaplus_tpu"]
    lines = out["tvqaplus_tpu_torch"][0].splitlines()
    assert [ln.split(" ")[0] for ln in lines] == ["QA", "Grd.", "Temp.", "ASA"]
    assert lines[0] == "QA Acc. 1.0"


def test_evaluator_cli_defaults_to_the_in_repo_val_set(tmp_path):
    pred = gt_as_prediction(VAL_JSON, str(tmp_path / "p.json"))
    r = subprocess.run(
        [sys.executable, "-m", "tvqaplus_tpu_torch.evaluation.tvqa_metrics",
         "--pred_path", pred, "--no_preproc_pred"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[0] == "QA Acc. 1.0"
