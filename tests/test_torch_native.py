"""The port's host fast paths (``tvqaplus_tpu_torch/native/fastops.c``)
against the numpy code they replace and against the JAX package: padded
copies, IoU, att-loss entries and sub_dedup window indices."""
import numpy as np
import pytest

from tvqaplus_tpu.data.labels import iou_single_gt_box as jax_iou_single
from tvqaplus_tpu.utils.misc import compute_iou_xyxy as jax_iou
from tvqaplus_tpu_torch import native
from tvqaplus_tpu_torch.data.labels import (
    att_entries_from_dense,
    iou_single_gt_box,
)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pad_batch_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    n, max_len, dim = 6, 7, 5
    arrays = [rng.standard_normal((int(k), dim)).astype(np.float32)
              for k in rng.integers(0, 11, n)]
    out = np.zeros((n + 2, max_len, dim), np.float32)
    mask = np.zeros((n + 2, max_len), np.float32)
    native.pad_batch(arrays, max_len, out[:n], mask[:n])
    want, want_mask = np.zeros_like(out), np.zeros_like(mask)
    for i, a in enumerate(arrays):
        k = min(len(a), max_len)
        want[i, :k], want_mask[i, :k] = a[:k], 1.0
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(mask, want_mask)
    with pytest.raises(ValueError):
        native.pad_batch(arrays, max_len, out[:n, :, :4])


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_matches_python_and_jax(seed):
    rng = np.random.default_rng(seed)
    boxes = [[float(x) for x in sorted(rng.integers(0, 300, 2))]
             + [float(y) for y in sorted(rng.integers(0, 200, 2))]
             for _ in range(12)]
    dets = [[b[0], b[2], b[1] + 1, b[3] + 1] for b in boxes]   # xyxy
    gt = {"left": 40.0, "top": 30.0, "width": 120.0, "height": 90.0}
    gt_xyxy = [40.0, 30.0, 160.0, 120.0]
    got = native.iou_one_vs_many(gt_xyxy, dets)
    np.testing.assert_array_equal(
        got, np.asarray([jax_iou(gt_xyxy, d) for d in dets]))
    assert iou_single_gt_box(gt, dets) == jax_iou_single(gt, dets)
    assert iou_single_gt_box(gt, []) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_att_entries_match_the_dense_path(seed):
    """The one-pass entries equal ``att_entries_from_dense`` on the dense
    copies clipped to the spec window, the cap hit in one case."""
    rng = np.random.default_rng(seed)
    src, spec, cap = (9, 7, 6), (8, 6, 5), (40, 40, 6)[seed]
    labels = (rng.random(src) > 0.9).astype(np.float32)
    defined = (rng.random(src) > 0.2).astype(np.float32)
    rows = {"idx": np.zeros(cap, np.int32), "valid": np.zeros(cap,
                                                               np.float32),
            "neg": np.zeros((cap, spec[2]), np.float32),
            "rank": np.zeros(cap, np.int32),
            "npos": np.zeros(cap, np.float32)}
    n_pos = native.att_entries(labels, defined, spec, cap, rows["idx"],
                               rows["valid"], rows["neg"], rows["rank"],
                               rows["npos"])
    dl, dd = np.zeros(spec, np.float32), np.zeros(spec, np.float32)
    li, lw, lr = (min(a, b) for a, b in zip(src, spec))
    dl[:li, :lw, :lr] = labels[:li, :lw, :lr]
    dd[:li, :lw, :lr] = defined[:li, :lw, :lr]
    *want, want_n = att_entries_from_dense(dl, dd, cap)
    assert n_pos == want_n and n_pos > 0
    for got, w in zip(rows.values(), want):
        np.testing.assert_array_equal(got, w)
    if seed == 2:
        assert n_pos > cap


def test_fill_sub_windows_matches_numpy():
    spans = np.asarray([[0, 4], [3, 9], [10, 4], [11, 0], [2, 6]], np.int64)
    ls, n_tok = 6, 12
    idx = np.zeros((5, ls), np.int32)
    mask = np.zeros((5, ls), np.float32)
    n_over = native.fill_sub_windows(spans, ls, n_tok, idx, mask)
    ln = np.minimum(spans[:, 1], ls)
    pos = np.arange(ls)
    valid = pos < ln[:, None]
    want = spans[:, :1] + pos
    ok = valid & (want < n_tok)
    np.testing.assert_array_equal(idx, np.where(ok, want + 1, 0))
    np.testing.assert_array_equal(mask, ok.astype(np.float32))
    assert n_over == int(valid.sum() - ok.sum()) == 2
