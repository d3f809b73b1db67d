"""File I/O helpers (the port's copy of the JAX package's ``utils/io.py``
subset that config, the data loader, inference, the evaluator and the run
bookkeeping need)."""
from __future__ import annotations

import json
import os
import pickle
import zipfile

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


def save_pickle(data, file_path):
    with open(file_path, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def mkdirp(path):
    os.makedirs(path, exist_ok=True)


def files_exist(filepath_list):
    return all(os.path.exists(p) for p in filepath_list)


def make_zipfile(src_dir, save_path, enclosing_dir="", exclude_paths=None,
                 exclude_extensions=None):
    """Snapshot a source tree into a zip under ``enclosing_dir`` (JAX
    utils/io.py:91; reference config.py:177-181 keeps a copy of the code
    with every run), skipping the directories named in ``exclude_paths``,
    hidden directories and files with an extension in
    ``exclude_extensions``."""
    exclude_paths = exclude_paths or []
    exclude_extensions = exclude_extensions or []
    abs_src = os.path.abspath(src_dir)
    with zipfile.ZipFile(save_path, "w") as zf:
        for dirname, subdirs, files in os.walk(abs_src):
            subdirs[:] = [d for d in subdirs
                          if d not in exclude_paths and not d.startswith(".")]
            arc_dir = os.path.join(enclosing_dir,
                                   os.path.relpath(dirname, abs_src))
            for filename in files:
                if os.path.splitext(filename)[1] in exclude_extensions:
                    continue
                zf.write(os.path.join(dirname, filename),
                         os.path.join(arc_dir, filename))


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
