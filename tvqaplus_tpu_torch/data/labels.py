"""Attention labels (the port's copy of the part of
``tvqaplus_tpu/data/labels.py`` that the synthetic dataset and the
training collate need): densification and the att-loss entry arrays."""
from __future__ import annotations

import numpy as np


def densify_att_labels(att_label_list, anno_st_idx, num_img, num_words,
                       num_region):
    """Ragged per-image (n_words, n_regions) label arrays -> dense
    (num_img, num_words, num_region) labels + defined-mask.
    ``anno_st_idx`` is the grid position of the first annotated image, or a
    list of positions."""
    if isinstance(anno_st_idx, (list, tuple, np.ndarray)):
        positions = list(anno_st_idx)
    else:
        positions = [anno_st_idx + i for i in range(len(att_label_list))]
    labels = np.zeros((num_img, num_words, num_region), dtype=np.float32)
    defined = np.zeros((num_img, num_words, num_region), dtype=np.float32)
    for arr, img_idx in zip(att_label_list, positions):
        if img_idx >= num_img:
            continue
        w = min(arr.shape[0], num_words)
        r = min(arr.shape[1], num_region)
        labels[img_idx, :w, :r] = arr[:w, :r]
        defined[img_idx, :w, :r] = 1.0
    return labels, defined


def att_entries_from_dense(labels, defined, entry_cap):
    """Dense (Li, Lw, Lr) labels -> the att loss's static entry arrays
    (pure label algebra, so it runs on the host at collate).

    Returns (entry_idx, entry_valid, neg_rows, rank, group_npos, n_pos):
      entry_idx   (E,) int32  flat (img, word, region) indices of the first
                              E positives, ascending;
      entry_valid (E,)  f32   1 for real entries;
      neg_rows    (E, Lr) f32 the entry's group's sampleable negatives
                              (defined & label == 0, stage.py:652-665);
      rank        (E,) int32  the entry's rank among its group's positives
                              in increasing region order (stage.py:654);
      group_npos  (E,) int32  positives in the entry's group;
      n_pos       int         all positives before the cap.
    """
    li, lw, lr = labels.shape
    pos = (labels > 0) & (defined > 0)
    neg = ((labels == 0) & (defined > 0)).reshape(li * lw, lr)
    pos2 = pos.reshape(li * lw, lr)
    flat_all = np.nonzero(pos.reshape(-1))[0]
    flat = flat_all[:entry_cap]
    e = entry_cap
    entry_idx = np.zeros(e, np.int32)
    entry_valid = np.zeros(e, np.float32)
    neg_rows = np.zeros((e, lr), np.float32)
    rank = np.zeros(e, np.int32)
    group_npos = np.zeros(e, np.int32)
    if len(flat):
        iw = (flat // lr).astype(np.int64)
        r = (flat % lr).astype(np.int64)
        n = len(flat)
        entry_idx[:n] = flat
        entry_valid[:n] = 1.0
        neg_rows[:n] = neg[iw]
        cums = np.cumsum(pos2[iw], axis=1)
        rank[:n] = cums[np.arange(n), r] - 1
        group_npos[:n] = pos2[iw].sum(axis=1)
    return entry_idx, entry_valid, neg_rows, rank, group_npos, len(flat_all)
