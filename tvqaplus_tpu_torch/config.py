"""Configuration: the port's own copy of the JAX package's ``Config``.

Every field keeps the JAX name and default, so the port reads a JAX run's
``opt.json`` unchanged (``override_from``, reference TestOptions
semantics).  Fields that only the JAX runtime reads (PRNG, XLA cache,
``use_pallas``) are kept for that reason and ignored here; ``mesh_shape``
is read by the entry points under ``torchrun`` (parallel/mesh.py).

What differs is the device policy: ``finalize(device)`` resolves

* ``use_kernels``: True on ``cuda`` (every ``ops/`` wrapper launches its
  CUDA kernel), False on ``cpu`` (the plain PyTorch versions);
* ``compute_dtype`` ``"auto"``: bfloat16 on ``cuda``, float32 on ``cpu``.

It never asks a JAX backend.  ``save_run`` writes a run's opt.json and
the ``code.zip`` snapshot of this package into its results directory (JAX
config.py:265-281); nothing else here writes to disk.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from tvqaplus_tpu_torch.utils.io import (
    load_json,
    make_zipfile,
    save_json_pretty,
)

# Fields that the CLI does not set: derived at finalize(), ``use_pallas``
# (read from a JAX run's opt.json, never used here) and ``device`` (a
# JAX-era integer GPU id kept for opt.json parity; the port's device is the
# explicit ``device`` argument of its entry points).
_NOT_CLI = ("results_dir", "h5driver", "vfeat_flag", "vcpt_flag", "sub_flag",
            "use_kernels", "use_pallas", "device")


@dataclass
class Config:
    # -- bookkeeping ---------------------------------------------------
    debug: bool = False
    results_dir_base: str = "results/results"
    results_dir: str = ""
    log_freq: int = 800
    seed: int = 2018
    rng_impl: str = "rbg"               # JAX-only (PRNG implementation)

    # -- training ------------------------------------------------------
    lr: float = 1e-3
    wd: float = 3e-7
    n_epoch: int = 100
    max_es_cnt: int = 5
    bsz: int = 16
    test_bsz: int = 16
    device: int = 0                     # opt.json parity only (see _NOT_CLI)
    device_ids: List[int] = field(default_factory=lambda: [0])
    num_workers: int = 2
    t_iter: int = 0
    t_layer_type: str = "linear"
    extra_span_length: int = 3
    ts_weight: float = 0.5
    add_local: bool = False
    input_streams: List[str] = field(default_factory=lambda: ["sub", "vfeat"])
    vfeat_type: Optional[str] = None
    no_core_driver: bool = False
    no_glove: bool = False
    learn_word_embedding: bool = False
    clip: float = 10.0
    resume: str = ""
    non_visual: int = 0
    add_non_visual: bool = False
    use_sup_att: bool = False
    att_weight: float = 0.1
    att_iou_thd: float = 0.5
    margin: float = 0.1
    num_region: int = 25
    att_loss_type: str = "lse"
    scale: float = 10.0
    alpha: float = 20.0
    num_hard: int = 2
    num_negatives: int = 2
    hard_negative_start: int = 100
    negative_pool_size: int = 0
    drop_topk: int = 0

    # -- length caps (reference config.py:88-99) ------------------------
    max_sub_l: int = 50
    max_vid_l: int = 300
    max_vcpt_l: int = 300
    max_q_l: int = 20
    max_a_l: int = 15
    max_qa_l: int = 40

    # -- model ----------------------------------------------------------
    embedding_size: int = 768
    hsz: int = 128
    vocab_size: int = 0
    dropout: float = 0.1
    input_encoder_n_blocks: int = 1
    input_encoder_n_conv: int = 2
    input_encoder_kernel_size: int = 7
    input_encoder_n_heads: int = 0
    cls_encoder_n_blocks: int = 1
    cls_encoder_n_conv: int = 2
    cls_encoder_kernel_size: int = 5
    cls_encoder_n_heads: int = 0

    # -- data paths ------------------------------------------------------
    glove_path: str = "data/glove.6B.300d.txt"
    word2idx_path: str = ""
    eval_object_vocab_path: str = ""
    qa_bert_path: str = ""
    sub_bert_path: str = ""
    train_path: str = ""
    valid_path: str = ""
    test_path: str = ""
    vcpt_path: str = ""
    vfeat_path: str = ""
    vfeat_size: int = 300
    sub_path: str = ""
    frm_cnt_path: str = ""

    # -- static shapes and batch layout -----------------------------------
    frame_interval: int = 6
    max_num_img: int = 50
    img_buckets: List[int] = field(default_factory=lambda: [16, 32, 50])
    sub_dedup: bool = True
    merge_input_streams: bool = False
    max_sub_tokens: int = 512
    sub_token_buckets: List[int] = field(default_factory=list)
    video_dedup: bool = False
    video_buckets: List[int] = field(default_factory=lambda: [4, 8])
    max_num_proposal: int = 1
    att_entry_cap: int = 128
    compute_dtype: str = "auto"         # {"auto", "float32", "bfloat16"}
    # (data, ctx[, model]) over the processes of a torchrun launch
    # (parallel/mesh.py): data x ctx x model = their number, one -1 entry
    mesh_shape: List[int] = field(default_factory=lambda: [-1, 1])
    use_pallas: Optional[bool] = None   # JAX-only; see use_kernels
    py2_offset_div: bool = False
    synthetic_data: bool = False
    synthetic_n_train: int = 256
    synthetic_n_valid: int = 128
    prefetch_depth: int = 2
    steps_per_dispatch: int = 1         # 0: auto (dispatch.py)
    eval_steps_per_dispatch: int = 4
    halt_on_nonfinite: bool = True
    profile_dir: str = ""
    compilation_cache_dir: str = "~/.cache/tvqaplus_tpu_xla"  # JAX-only

    # -- derived (filled by finalize()) ----------------------------------
    h5driver: Optional[str] = "core"
    vfeat_flag: bool = True
    vcpt_flag: bool = False
    sub_flag: bool = True
    use_kernels: Optional[bool] = None  # True iff the device is cuda

    def finalize(self, device="cpu"):
        """The reference's parse()-time side effects plus the device policy
        (see module docstring).  ``device`` is where the model will run."""
        if self.num_hard > self.num_negatives:
            raise ValueError("num_hard must be <= num_negatives")
        if self.att_loss_type not in ("hinge", "lse"):
            raise ValueError(f"att_loss_type {self.att_loss_type!r}")
        if self.t_layer_type not in ("linear", "conv"):
            raise ValueError(f"t_layer_type {self.t_layer_type!r}")
        if self.debug:
            # results/results -> results/debug_results (reference
            # config.py), keeping the base's directory
            self.results_dir_base = os.path.join(
                os.path.dirname(self.results_dir_base), "debug_results")
            self.no_core_driver = True
            self.num_workers = 0
        if not self.results_dir:
            self.results_dir = self.results_dir_base + time.strftime(
                "_%Y_%m_%d_%H_%M_%S")
        self.h5driver = None if self.no_core_driver else "core"
        self.vfeat_flag = "vfeat" in self.input_streams
        self.vcpt_flag = "vcpt" in self.input_streams
        self.sub_flag = "sub" in self.input_streams
        return self.resolve_device_policy(device)

    def resolve_device_policy(self, device):
        """Set ``use_kernels`` and resolve ``compute_dtype="auto"`` for
        ``device``; call again after ``override_from`` brings in a saved
        opt.json."""
        on_cuda = torch.device(device).type == "cuda"
        self.use_kernels = on_cuda
        if self.compute_dtype == "auto":
            self.compute_dtype = "bfloat16" if on_cuda else "float32"
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        return self

    def save(self, path):
        save_json_pretty(dataclasses.asdict(self), path)

    def save_run(self):
        """opt.json and ``code.zip`` (this package's sources under
        ``code/``, without results, caches, .pyc and .ipynb files) in
        ``results_dir``, which it creates."""
        os.makedirs(self.results_dir, exist_ok=True)
        self.save(os.path.join(self.results_dir, "opt.json"))
        code_dir = os.path.dirname(os.path.realpath(__file__))
        make_zipfile(code_dir, os.path.join(self.results_dir, "code.zip"),
                     enclosing_dir="code",
                     exclude_paths=["results", "__pycache__"],
                     exclude_extensions=[".pyc", ".ipynb"])

    def override_from(self, saved_opt_path, keep=("debug",)):
        """TestConfig semantics: every field of the saved run's opt.json
        overrides this config, except fields in ``keep``
        (reference config.py:169-174)."""
        saved = load_json(saved_opt_path)
        known = {f.name for f in dataclasses.fields(type(self))}
        for k, v in saved.items():
            if k in known and k not in keep:
                setattr(self, k, v)
        self.no_core_driver = True
        self.h5driver = None
        return self


def _list_elem_type(annotation):
    """Element type of a ``List[...]`` annotation string (the module uses
    ``from __future__ import annotations``)."""
    inner = str(annotation).strip()
    if inner.startswith(("List[", "list[")):
        elem = inner[5:-1].strip()
        return {"int": int, "float": float, "str": str}.get(elem)
    return None


def _add_field_arg(parser, f):
    name = "--" + f.name
    if f.type in ("bool", bool) or isinstance(f.default, bool):
        parser.add_argument(name, action="store_true", default=None)
    elif f.default_factory is not dataclasses.MISSING:
        proto = f.default_factory()
        elem_t = _list_elem_type(f.type) or (type(proto[0]) if proto else int)
        parser.add_argument(name, nargs="+", type=elem_t, default=None)
    else:
        t = type(f.default) if f.default is not None else str
        parser.add_argument(name, type=t, default=None)


def build_parser(extra_fields=()):
    """argparse parser over the Config fields plus ``extra_fields``
    (``(flag, kwargs)`` pairs)."""
    parser = argparse.ArgumentParser(
        description="STAGE (TVQA+ video QA), PyTorch/CUDA port")
    for f in dataclasses.fields(Config):
        if f.name not in _NOT_CLI:
            _add_field_arg(parser, f)
    for name, kwargs in extra_fields:
        parser.add_argument(name, **kwargs)
    return parser


def parse_args(argv=None, extra_fields=()):
    """CLI entry: defaults from Config, CLI flags override, then
    ``finalize`` for the device an extra ``--device`` flag names (``cuda``
    when there is none).  Returns (config, extra namespace)."""
    ns = build_parser(extra_fields).parse_args(argv)
    cfg = Config()
    extra_names = {n.lstrip("-").replace("-", "_") for n, _ in extra_fields}
    extras = argparse.Namespace()
    for k, v in vars(ns).items():
        if k in extra_names:
            setattr(extras, k, v)
        elif v is not None:
            setattr(cfg, k, v)
    return cfg.finalize(getattr(extras, "device", "cuda")), extras
