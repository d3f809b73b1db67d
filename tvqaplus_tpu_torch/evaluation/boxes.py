"""Numpy box container + pairwise IoU for the detection evaluator (the
port's copy of ``tvqaplus_tpu/evaluation/boxes.py``).

Capability parity with the reference's numpy BoxList port
(eval/maskrcnn_voc/bounding_box.py:12-292, boxlist_ops.py:10-89): xyxy/xywh
conversion, resize, clip, area and pairwise IoU — all using the VOC +1-pixel
integer-box convention (area and intersection add one pixel per side)."""
from __future__ import annotations

import numpy as np

TO_REMOVE = 1  # VOC integer-box convention

# PIL.Image transpose methods supported by the reference
# (bounding_box.py:150-192)
FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1


class Boxes:
    """(N, 4) boxes on a (width, height) canvas with named per-box fields."""

    def __init__(self, bbox, image_size, mode="xyxy"):
        assert mode in ("xyxy", "xywh")
        self.bbox = np.asarray(bbox, dtype=np.float64).reshape(-1, 4)
        self.size = tuple(image_size)
        self.mode = mode
        self.extra_fields = {}

    def __len__(self):
        return self.bbox.shape[0]

    def add_field(self, name, data):
        self.extra_fields[name] = np.asarray(data)

    def get_field(self, name):
        return self.extra_fields[name]

    def has_field(self, name):
        return name in self.extra_fields

    def fields(self):
        return list(self.extra_fields.keys())

    def convert(self, mode):
        if mode == self.mode:
            return self
        x1, y1 = self.bbox[:, 0], self.bbox[:, 1]
        if self.mode == "xyxy":  # -> xywh
            w = self.bbox[:, 2] - x1 + TO_REMOVE
            h = self.bbox[:, 3] - y1 + TO_REMOVE
            new = np.stack([x1, y1, w, h], axis=1)
        else:  # xywh -> xyxy
            x2 = x1 + np.maximum(self.bbox[:, 2] - TO_REMOVE, 0)
            y2 = y1 + np.maximum(self.bbox[:, 3] - TO_REMOVE, 0)
            new = np.stack([x1, y1, x2, y2], axis=1)
        out = Boxes(new, self.size, mode)
        out.extra_fields = dict(self.extra_fields)
        return out

    def resize(self, new_size):
        """Scale boxes to a new (width, height) canvas."""
        ratio_w = new_size[0] / self.size[0]
        ratio_h = new_size[1] / self.size[1]
        xyxy = self.convert("xyxy")
        scaled = xyxy.bbox * np.array([ratio_w, ratio_h, ratio_w, ratio_h])
        out = Boxes(scaled, new_size, "xyxy")
        out.extra_fields = dict(self.extra_fields)
        return out.convert(self.mode)

    def clip_to_image(self):
        w, h = self.size
        xyxy = self.convert("xyxy")
        b = xyxy.bbox
        b[:, 0] = np.clip(b[:, 0], 0, w - TO_REMOVE)
        b[:, 1] = np.clip(b[:, 1], 0, h - TO_REMOVE)
        b[:, 2] = np.clip(b[:, 2], 0, w - TO_REMOVE)
        b[:, 3] = np.clip(b[:, 3], 0, h - TO_REMOVE)
        return xyxy.convert(self.mode)

    def transpose(self, method):
        """Flip boxes horizontally or vertically on their canvas
        (reference bounding_box.py:150-192; only the two PIL flips are
        implemented there — rotations raise)."""
        if method not in (FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM):
            raise NotImplementedError(
                "Only FLIP_LEFT_RIGHT and FLIP_TOP_BOTTOM implemented")
        w, h = self.size
        b = self.convert("xyxy").bbox
        x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        if method == FLIP_LEFT_RIGHT:
            new = np.stack([w - x2 - TO_REMOVE, y1,
                            w - x1 - TO_REMOVE, y2], axis=1)
        else:
            new = np.stack([x1, h - y2, x2, h - y1], axis=1)
        out = Boxes(new, self.size, "xyxy")
        out.extra_fields = dict(self.extra_fields)
        return out.convert(self.mode)

    def crop(self, box):
        """Crop to a (left, upper, right, lower) window: shift into window
        coordinates and clamp to its extent (reference
        bounding_box.py:193-229; the canvas becomes the window size)."""
        b = self.convert("xyxy").bbox
        w, h = box[2] - box[0], box[3] - box[1]
        new = np.stack([
            np.clip(b[:, 0] - box[0], 0, w),
            np.clip(b[:, 1] - box[1], 0, h),
            np.clip(b[:, 2] - box[0], 0, w),
            np.clip(b[:, 3] - box[1], 0, h),
        ], axis=1)
        out = Boxes(new, (w, h), "xyxy")
        out.extra_fields = dict(self.extra_fields)
        return out.convert(self.mode)

    def area(self):
        b = self.bbox
        if self.mode == "xyxy":
            return ((b[:, 2] - b[:, 0] + TO_REMOVE)
                    * (b[:, 3] - b[:, 1] + TO_REMOVE))
        return b[:, 2] * b[:, 3]

    def __getitem__(self, item):
        out = Boxes(self.bbox[item], self.size, self.mode)
        for k, v in self.extra_fields.items():
            out.add_field(k, v[item])
        return out


def pairwise_iou(boxes1, boxes2):
    """(N, M) IoU between two Boxes sets, +1-pixel convention
    (reference boxlist_ops.py:10-48)."""
    b1 = boxes1.bbox if isinstance(boxes1, Boxes) else np.asarray(boxes1)
    b2 = boxes2.bbox if isinstance(boxes2, Boxes) else np.asarray(boxes2)
    area1 = (b1[:, 2] - b1[:, 0] + TO_REMOVE) * (b1[:, 3] - b1[:, 1] + TO_REMOVE)
    area2 = (b2[:, 2] - b2[:, 0] + TO_REMOVE) * (b2[:, 3] - b2[:, 1] + TO_REMOVE)
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt + TO_REMOVE, 0, None)
    inter = wh[:, :, 0] * wh[:, :, 1]
    return inter / (area1[:, None] + area2[None, :] - inter)


def cat_boxes(box_lists):
    """Concatenate Boxes of the same canvas/mode/fields."""
    size, mode = box_lists[0].size, box_lists[0].mode
    assert all(b.size == size and b.mode == mode for b in box_lists)
    out = Boxes(np.concatenate([b.bbox for b in box_lists], 0), size, mode)
    for field in box_lists[0].fields():
        out.add_field(field, np.concatenate(
            [b.get_field(field) for b in box_lists], 0))
    return out
