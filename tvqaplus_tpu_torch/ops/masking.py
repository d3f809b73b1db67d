"""Masking primitives (port of ``tvqaplus_tpu/ops/masking.py``).

The reference masks by adding -1e10 (model_utils.py:14-15).  Every masked
softmax floors its logits at ``SAFE_FLOOR`` first: exp underflows to 0 more
than ~90 below the row max in float32, so the floor keeps exact masking
semantics while a fully masked row stays finite (uniform, then zeroed or
given weight 0 downstream) instead of NaN.
"""
from __future__ import annotations

import torch

NEG_INF = -1e10     # the additive mask value (reference model_utils.py:15)
SAFE_FLOOR = -3e4


def mask_logits(target, mask):
    """x*m + (1-m)*(-1e10)."""
    return target * mask + (1.0 - mask) * NEG_INF


def safe_softmax(x, dim=-1):
    """softmax that stays finite on fully masked (-1e10) rows."""
    return torch.softmax(torch.clamp(x, min=SAFE_FLOOR), dim=dim)


def safe_log_softmax(x, dim=-1):
    """log_softmax that stays finite on fully masked (-1e10) rows."""
    return torch.log_softmax(torch.clamp(x, min=SAFE_FLOOR), dim=dim)
