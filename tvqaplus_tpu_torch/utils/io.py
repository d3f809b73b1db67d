"""File I/O helpers (the port's copy of the JAX package's ``utils/io.py``
subset that config, the data loader, inference and the evaluator need)."""
from __future__ import annotations

import json
import pickle

import numpy as np


def load_json(file_path):
    with open(file_path, "r") as f:
        return json.load(f)


def save_json(data, file_path):
    with open(file_path, "w") as f:
        json.dump(data, f)


def save_json_pretty(data, file_path):
    """Formatted json for config files (reference utils.py:23-26)."""
    with open(file_path, "w") as f:
        f.write(json.dumps(data, indent=4, sort_keys=True))


def read_json_lines(file_path):
    lines = []
    with open(file_path, "r") as f:
        for line in f:
            line = line.strip("\n")
            if not line:
                continue
            try:
                lines.append(json.loads(line))
            except ValueError:
                continue
    return lines


def save_jsonl(records, file_path, append=False):
    mode = "a" if append else "w"
    with open(file_path, mode) as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def load_pickle(file_path):
    with open(file_path, "rb") as f:
        try:
            return pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            return pickle.load(f, encoding="latin1")


def load_glove(filename):
    """Parse a GloVe text file into {word: np.ndarray (D,)}
    (reference utils.py:94-104)."""
    glove = {}
    with open(filename) as f:
        for line in f:
            values = line.strip("\n").split(" ")
            if len(values) < 2:
                continue
            glove[values[0]] = np.asarray([float(e) for e in values[1:]])
    return glove
