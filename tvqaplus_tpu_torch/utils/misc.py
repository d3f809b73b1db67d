"""Small training helpers (the port's copy of the part of
``tvqaplus_tpu/utils/misc.py`` the trainer needs)."""
from __future__ import annotations


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


def count_parameters(model):
    """Number of parameter values of a ``torch.nn.Module``."""
    return sum(p.numel() for p in model.parameters())
