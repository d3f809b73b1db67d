"""Small helpers (the port's copy of ``tvqaplus_tpu/utils/misc.py``, less
its JAX parameter count): list and dict helpers, the sentence splitter, box
IoU, tokenizer matching, meters and a stopwatch, the show of a clip and the
accuracy by question type (reference utils.py:442-478)."""
from __future__ import annotations

import re
import time

import numpy as np


def flat_list_of_lists(l):
    return [item for sublist in l for item in sublist]


def merge_dicts(list_dicts):
    merged = dict(list_dicts[0])
    for d in list_dicts[1:]:
        merged.update(d)
    return merged


def dissect_by_lengths(np_array, lengths, dim=0, assert_equal=True):
    """Split an array along ``dim`` into consecutive chunks of ``lengths``.

    Same contract as reference utils.py:129-145 (used to split per-video
    token embeddings back into per-sentence chunks).
    """
    if assert_equal:
        assert np_array.shape[dim] == sum(lengths), (
            f"array dim {np_array.shape[dim]} != sum(lengths) {sum(lengths)}")
    offsets = np.cumsum([0] + list(lengths))
    if dim == 0:
        return [np_array[offsets[i]:offsets[i + 1]] for i in range(len(lengths))]
    if dim == 1:
        return [np_array[:, offsets[i]:offsets[i + 1]] for i in range(len(lengths))]
    if dim == 2:
        return [np_array[:, :, offsets[i]:offsets[i + 1]] for i in range(len(lengths))]
    raise NotImplementedError(f"dim={dim}")


def compute_iou_xyxy(box1, box2):
    """Box IoU with the reference's +1 pixel intersection convention
    (reference utils.py:506-522): intersection adds one pixel on each side,
    union uses raw areas.  Used for building attention labels."""
    inter_x1 = max(box1[0], box2[0])
    inter_y1 = max(box1[1], box2[1])
    inter_x2 = min(box1[2], box2[2])
    inter_y2 = min(box1[3], box2[3])
    if inter_x1 < inter_x2 and inter_y1 < inter_y2:
        inter = (inter_x2 - inter_x1 + 1) * (inter_y2 - inter_y1 + 1)
    else:
        inter = 0
    union = ((box1[2] - box1[0]) * (box1[3] - box1[1])
             + (box2[2] - box2[0]) * (box2[3] - box2[1]) - inter)
    return float(inter) / union


_TOKENIZER_RULES = [
    ("'", " ' "),
    ("n ' t", "n't"),
    ("' s", "'s"),
    ("' re", "'re"),
    ("' d", "'d"),
    ("' ll", "'ll"),
    ("' m", "'m"),
    ("' ve", "'ve"),
    ("cannot", "can not"),
    ("gonna", "gon na"),
    ("gotta", "got ta"),
    ("wanna", "wan na"),
    ("wan nabe", "wannabe"),
    ("`", " ` "),
    (" 'more", " ' more"),
    ("CAN ' T", "CA N'T"),
    ("DIDN ' T", "DID N'T"),
    ("D ' Onofio", "D'Onofio"),
    ("O ' Donnells", "O'Donnells"),
    ("O ' Brien", "O'Brien"),
    ("O ' Brian", "O'Brian"),
    ("d ' oeuvers", "d'oeuvers"),
    ("ma ' am", "ma'am"),
    ("O ' clock", "O'clock"),
    ("o ' clock", "o'clock"),
    (r"(\d)am", r"\1 am"),
    (r"(\d)pm", r"\1 pm"),
    (r"(\d)lbs", r"\1 lbs"),
    ("y ' all", "y' all"),
]


def match_stanford_tokenizer(line):
    """Regex normalization to match Stanford-tokenizer output
    (same rule table as reference utils.py:334-365)."""
    for pattern, repl in _TOKENIZER_RULES:
        line = re.sub(pattern, repl, line)
    return line


_SHOW_LIST = ["friends", "met", "castle", "house", "grey"]


def get_show_name(vid_name):
    """The TV show of a clip name; "bbt" unless the name's prefix is one of
    the five others."""
    prefix = vid_name.split("_")[0]
    return prefix if prefix in _SHOW_LIST else "bbt"


class AverageMeter:
    """Running average / max / min tracker (reference utils.py:399-424)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.max = -1e10
        self.min = 1e10

    def update(self, val, n=1):
        self.max = max(val, self.max)
        self.min = min(val, self.min)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Timer:
    """Context-manager stopwatch feeding an AverageMeter."""

    def __init__(self, meter=None):
        self.meter = meter if meter is not None else AverageMeter()

    def __enter__(self):
        self._start = time.time()
        return self

    def __exit__(self, *exc):
        self.meter.update(time.time() - self._start)
        return False


def count_parameters(model):
    """Number of parameter values of a ``torch.nn.Module``."""
    return sum(p.numel() for p in model.parameters())


_Q_TYPES = ["what", "who", "where", "how", "why", "other"]


def get_q_type(questions, word2idx):
    """Each question's type from its first token id (reference
    utils.py:442-451): one of ``_Q_TYPES``, "other" when none matches."""
    indexed = [word2idx.get(t, -1) for t in _Q_TYPES]
    out = []
    for q in questions:
        q_type = "other"
        for j in range(len(_Q_TYPES) - 1):
            if q[0] == indexed[j]:
                q_type = _Q_TYPES[j]
                break
        out.append(q_type)
    return out


def compute_acc_by_type(q_types, corrects):
    """Accuracy and question count per question type (reference
    utils.py:454-478)."""
    bucket = {t: [] for t in _Q_TYPES}
    for t, c in zip(q_types, corrects):
        bucket[t].append(c)
    return {t: {"acc": (sum(v) / len(v)) if v else 0.0, "num_qa": len(v)}
            for t, v in bucket.items()}
