"""Legacy 7x7 spatial-map bbox targets + region-index helpers.

The port's copy of ``tvqaplus_tpu/data/spatial.py``: capability parity with
reference utils.py:171-283 (the pre-region-feature
spatial attention-map supervision path and the detection-feature index
expansion helpers)."""
from __future__ import annotations

import math

import numpy as np

from tvqaplus_tpu_torch.utils.misc import dissect_by_lengths, flat_list_of_lists


def make_large_resolution_indices(indices, resolution=16):
    """Each index refers to `resolution` consecutive feature rows
    (reference utils.py:171-179)."""
    indices = np.asarray(indices) * resolution
    return flat_list_of_lists([range(e - resolution, e) for e in indices])


def get_elements_from_indices(elements, indices, resolution=1):
    """Select rows by indices, optionally expanding each index to
    `resolution` rows (reference utils.py:182-202)."""
    if resolution == 1:
        if isinstance(elements, list):
            return [elements[i] for i in indices]
        return elements[np.asarray(indices)]
    assert isinstance(elements, np.ndarray)
    return elements[make_large_resolution_indices(indices, resolution)]


def get_elements_variable_length(elements, indices_list, cnt_list=None,
                                 max_num_region=16, assert_equal=True):
    """Per-image variable-length region slices capped at max_num_region
    (reference utils.py:205-223)."""
    if isinstance(elements, np.ndarray):
        elements = dissect_by_lengths(elements, cnt_list,
                                      assert_equal=assert_equal)
    return [elements[i][:max_num_region] for i in indices_list]


def get_bbox_target_single_box(single_box, spatial_dim=7, img_w=640.0,
                               img_h=360.0, thd=0.5):
    """One GT box -> binary (spatial_dim, spatial_dim) attention map
    (reference utils.py:226-248)."""
    top, left = single_box["top"], single_box["left"]
    bottom = top + single_box["height"]
    right = left + single_box["width"]
    top = int(math.floor((top * spatial_dim) / img_h + thd))
    bottom = int(math.ceil((bottom * spatial_dim) / img_h - thd))
    left = int(math.floor((left * spatial_dim) / img_w + thd))
    right = int(math.ceil((right * spatial_dim) / img_w - thd))
    att = np.zeros([spatial_dim, spatial_dim], np.float32)
    att[top: bottom + 1, left: right + 1] = 1
    return att


def get_bbox_target_for_single_img(list_bboxes, spatial_dim=7):
    """0+ boxes -> flattened map; all-ones when unannotated
    (reference utils.py:251-260)."""
    if len(list_bboxes) == 0:
        cur = np.ones([spatial_dim, spatial_dim], np.float32)
    elif len(list_bboxes) == 1:
        cur = get_bbox_target_single_box(list_bboxes[0], spatial_dim)
    else:
        maps = [get_bbox_target_single_box(b, spatial_dim)
                for b in list_bboxes]
        cur = (sum(maps) > 0).astype(np.float32)
    return cur.reshape(-1)


def get_bbox_target(bbox_data_dict, num_imgs, spatial_dim=7):
    """Per-annotated-image maps + has-box mask (reference utils.py:263-283).
    Image ids are 1-indexed; ids beyond num_imgs dropped."""
    img_ids = sorted(int(k) for k in bbox_data_dict if int(k) <= num_imgs)
    mask = np.asarray([int(len(bbox_data_dict[str(k)]) > 0)
                       for k in img_ids])
    target = np.stack([
        get_bbox_target_for_single_img(bbox_data_dict[str(k)], spatial_dim)
        for k in img_ids], axis=0)
    return target, mask
