"""Frame sampling, temporal-label construction and subtitle alignment (the
port's copy of ``tvqaplus_tpu/data/sampling.py``).

* ``get_all_img_ids``: the 0.5 fps grid over 3 fps frames
  (reference utils.py:148-168) — 1-indexed image ids every
  ``frame_interval`` frames, phase-locked to the first annotated image,
  capped at frame 300.
* ``get_ts_label``: float seconds -> (start_idx, end_idx) over the sampled
  grid with the >300-frame rescaling and boundary clamping
  (reference tvqa_dataset.py:224-254).
* subtitle alignment: per sampled frame, pick the nearest / spanning / larger
  subtitle sentence indices (reference tvqa_dataset.py:266-308).
"""
from __future__ import annotations

import numpy as np

MAX_BASE_FRAMES = 300  # videos are capped at 300 frames at 3 fps
BASE_FPS = 3
FRAME_INTERVAL = 6     # 0.5 fps sampling over the 3 fps frame stream


def get_all_img_ids(interval_start_img_id, interval_end_img_id, num_imgs,
                    frame_interval=FRAME_INTERVAL):
    """0.5 fps image-id sequence containing the annotated interval.

    Image ids are 1-indexed.  The grid phase is ``start_img_id %
    frame_interval`` (or ``frame_interval`` when the residual is 0) so that
    the first annotated image falls exactly on the grid.

    Returns:
      (indices, anno_start_idx, anno_end_idx): the 1-indexed image ids, and
      the positions of the first/last annotated image within them.
    """
    real_start = interval_start_img_id % frame_interval
    if real_start == 0:
        real_start = frame_interval
    indices = list(range(real_start, min(num_imgs + 1, MAX_BASE_FRAMES + 1),
                         frame_interval))
    assert 0 not in indices
    mask_start_idx = indices.index(interval_start_img_id)
    if interval_end_img_id in indices:
        mask_end_idx = indices.index(interval_end_img_id)
    else:
        # annotated end img can exceed the frame count; clamp to last sample
        mask_end_idx = len(indices) - 1
    return indices, mask_start_idx, mask_end_idx


def get_ts_label(st, ed, num_frame, indices, fps=BASE_FPS):
    """Timestamp span (seconds) -> (start_idx, end_idx) on the sampled grid.

    ``indices`` here are the 0-indexed frame numbers (1-indexed image ids
    minus one), matching the reference call site (tvqa_dataset.py:121-128).
    Videos longer than 300 frames have their timestamps rescaled instead of
    extending the features (tvqa_dataset.py:236-240).
    """
    indices = np.asarray(indices)
    if num_frame > MAX_BASE_FRAMES:
        scale = (float(MAX_BASE_FRAMES) / num_frame) * fps
        st, ed = st * scale, ed * scale
    else:
        st, ed = st * fps, ed * fps

    start_idx = int(np.searchsorted(indices, st, side="left"))
    end_idx = int(np.searchsorted(indices, ed, side="right"))
    max_len = len(indices)
    if not start_idx < max_len:
        start_idx -= 1
    if not end_idx < max_len:
        end_idx -= 1
    if start_idx == end_idx:
        return [start_idx, end_idx]
    return [start_idx, end_idx - 1]


def find_match(subtime, value, mode="larger", span=1.5):
    """Indices of subtitle sentences matching a frame timestamp.

    Modes (reference tvqa_dataset.py:266-280):
      nearest: the 2 closest sentence start times (sorted);
      span: all sentences within ``span`` seconds (plus leading ones when
        value <= 2);
      larger: the sentence starting at-or-before the value and its two
        neighbours, clipped to range.
    """
    subtime = np.asarray(subtime)
    if mode == "nearest":
        return sorted(np.abs(subtime - value).argsort()[:2].tolist())
    if mode == "span":
        idxs = np.nonzero(np.abs(subtime - value) < span)[0].tolist()
        if value <= 2:
            idxs = np.nonzero(subtime - 2 <= 0)[0].tolist() + idxs
        return idxs
    if mode == "larger":
        idx = max(0, int(np.searchsorted(subtime, value, side="left")) - 1)
        return [i for i in (idx - 1, idx, idx + 1) if 0 <= i < len(subtime)]
    raise NotImplementedError(mode)


def get_aligned_sub_indices(img_ids, subtext, subtime, fps=BASE_FPS,
                            mode="larger"):
    """Per sampled frame, the subtitle-sentence indices aligned to it.

    ``subtext`` is the " <eos> "-joined tokenized subtitle string;
    ``subtime`` the per-sentence start times.  Frame timestamp is
    ``img_id / fps`` (reference tvqa_dataset.py:282-303).

    Returns (list of per-frame index lists, per-sentence token counts).
    """
    sentences = subtext.split(" <eos> ")
    raw_sub_n_tokens = [len(s.split()) for s in sentences]
    assert len(subtime) == len(sentences), (
        f"{len(subtime)} subtitle times != {len(sentences)} sentences")
    img_timestamps = np.asarray(img_ids) / fps
    return ([find_match(subtime, t, mode=mode) for t in img_timestamps],
            raw_sub_n_tokens)


def get_aligned_sub(subtext, img_aligned_sentence_indices):
    """Materialize the aligned subtitle text per frame."""
    sentences = subtext.split(" <eos> ")
    return [" ".join(sentences[i] for i in idxs)
            for idxs in img_aligned_sentence_indices]
