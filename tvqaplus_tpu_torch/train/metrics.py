"""Scalar logging with the reference's metric set (port of
``tvqaplus_tpu/train/metrics.py``).

Train/{Acc,Loss,Loss_att,Loss_cls,Loss_ts}, Valid/{Acc,Loss} and
learning_rate (reference main.py:95-104, 145-146, 229) go to a JSONL stream
``scalars.jsonl`` and, when ``tensorboardX`` or else
``torch.utils.tensorboard`` imports, to a TensorBoard event file in the same
directory (JAX metrics.py:21-31); ``append_log`` writes the
``valid_acc.log`` lines and ``export_scalars`` the ``all_scalars.json``
dump of an early stop (main.py:244).
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict

from tvqaplus_tpu_torch.utils.io import save_json_pretty


def tb_writer(log_dir):
    """A TensorBoard ``SummaryWriter`` on ``log_dir`` from tensorboardX,
    else torch.utils.tensorboard, else None."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir)


class MetricsLogger:
    """The scalars of a run, written into ``results_dir``; with
    ``results_dir`` None (a data-parallel rank other than 0) kept in
    ``history`` only, and no file is written."""

    def __init__(self, results_dir):
        self.results_dir = results_dir
        self.history = defaultdict(list)
        self._f = self.tb = None
        if results_dir is None:
            return
        os.makedirs(results_dir, exist_ok=True)
        self.scalar_path = os.path.join(results_dir, "scalars.jsonl")
        self._f = open(self.scalar_path, "a")
        self.tb = tb_writer(results_dir)

    def add_scalar(self, tag, value, step):
        value = float(value)
        self.history[tag].append((int(step), value))
        if self._f is None:
            return
        rec = {"tag": tag, "value": value, "step": int(step),
               "ts": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def append_log(self, filename, lines):
        if self.results_dir is None:
            return
        with open(os.path.join(self.results_dir, filename), "a") as f:
            f.write("\n".join(lines) + "\n")

    def export_scalars(self, filename="all_scalars.json"):
        if self.results_dir is None:
            return
        save_json_pretty(dict(self.history),
                         os.path.join(self.results_dir, filename))

    def close(self):
        if self._f is not None:
            self._f.close()
        if self.tb is not None:
            self.tb.close()
