"""Scalar logging with the reference's metric set (port of
``tvqaplus_tpu/train/metrics.py`` without the TensorBoard mirror).

Train/{Acc,Loss,Loss_att,Loss_cls,Loss_ts}, Valid/{Acc,Loss} and
learning_rate (reference main.py:95-104, 145-146, 229) go to a JSONL stream
``scalars.jsonl``; ``append_log`` writes the ``valid_acc.log`` lines and
``export_scalars`` the ``all_scalars.json`` dump of an early stop
(main.py:244).
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict

from tvqaplus_tpu_torch.utils.io import save_json_pretty


class MetricsLogger:
    def __init__(self, results_dir):
        self.results_dir = results_dir
        os.makedirs(results_dir, exist_ok=True)
        self.scalar_path = os.path.join(results_dir, "scalars.jsonl")
        self._f = open(self.scalar_path, "a")
        self.history = defaultdict(list)

    def add_scalar(self, tag, value, step):
        value = float(value)
        rec = {"tag": tag, "value": value, "step": int(step),
               "ts": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.history[tag].append((int(step), value))

    def append_log(self, filename, lines):
        with open(os.path.join(self.results_dir, filename), "a") as f:
            f.write("\n".join(lines) + "\n")

    def export_scalars(self, filename="all_scalars.json"):
        save_json_pretty(dict(self.history),
                         os.path.join(self.results_dir, filename))

    def close(self):
        self._f.close()
