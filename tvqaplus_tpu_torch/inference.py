"""Inference entry point:
``python -m tvqaplus_tpu_torch.inference --model_dir <run> --mode valid``.

Reloads the run's ``opt.json`` (every field overrides the CLI's, except
``debug``; reference TestOptions), loads a checkpoint of the run, runs
inference and writes ``{mode}_inference_predictions.json`` beside them.

* ``--model_dir``: the run directory, or a name under ``results/``: this
  package's runs or the JAX package's (its opt.json names the same
  fields).
* ``--checkpoint NAME``: the file to serve, relative to the run directory
  or absolute.  Without it: ``best_valid.pth`` (this package's best), else
  ``best_valid.ckpt`` (the JAX package's), else ``last.ckpt`` with a
  warning when the run never wrote a best one (it is written only when the
  validation accuracy improves).
* Any of these files is read by its content, never by its name
  (``interop/flax_msgpack.py`` ``sniff``): a torch file is a
  reference-format state_dict or this package's trainer checkpoint (model
  and optimizer; only the model is read), a flax msgpack file is the JAX
  package's ``save_checkpoint`` or ``save_params`` (the parameters go
  through ``interop/weights.py``).  Anything else raises an error that
  names the formats read.
* ``--torch_checkpoint PATH``: the JAX CLI's flag for serving a
  reference-format ``best_valid.pth``; here it serves the file at PATH
  (relative to the working directory, as in JAX) through the same reader.
  ``--no_strict`` is accepted, as the JAX CLI declares it, and changes
  nothing: loading is always strict.
* ``--video_dedup``, ``--video_buckets``, ``--sub_token_buckets``: the
  serving batch layouts (data/pipeline.py), and ``--mesh_shape``, the
  layout of the work over the ranks.  They change what each batch ships
  to the card and where, not the predictions, so when the command line
  sets one it holds over the run's opt.json.

The split comes from the run's data: the TVQA+ artifacts its opt.json
names (``data/tvqa.py``; grounding records for the words of
``eval_object_vocab_path``), or synthetic data.  Score the predictions with
``python -m tvqaplus_tpu_torch.evaluation.tvqa_metrics``.

Runs on ``cuda`` unless ``--device cpu`` is given.  Under ``torchrun
--nproc_per_node N`` the ranks form the run's ``mesh_shape`` (opt.json, or
the flag): each data row serves its rows of every global ``test_bsz``
batch (the run's opt.json holds the global size, which the data size must
divide), ctx ranks split Li and model ranks the large weights, and rank 0
writes the predictions of the whole split, in the single-process order.
"""
from __future__ import annotations

import os

import torch

from tvqaplus_tpu_torch import resolve_device
from tvqaplus_tpu_torch.config import build_parser, parse_args
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.data.tvqa import TVQAPlusDataset
from tvqaplus_tpu_torch.infer.predict import InferenceRunner
from tvqaplus_tpu_torch.interop import flax_msgpack
from tvqaplus_tpu_torch.interop.weights import (
    reference_state_dict,
    state_dict_from_flax_checkpoint,
)
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
from tvqaplus_tpu_torch.parallel import mesh as dp
from tvqaplus_tpu_torch.utils.io import save_json

# the layout fields a command line may set over the run's opt.json
SERVING_LAYOUT = ("video_dedup", "video_buckets", "sub_token_buckets",
                  "mesh_shape")
EXTRA_FLAGS = (
    ("--model_dir", dict(type=str, required=True,
                         help="run directory holding opt.json and the "
                              "checkpoints, or its name under results/")),
    ("--mode", dict(type=str, default="valid", help="valid/test")),
    ("--checkpoint", dict(type=str, default="",
                          help="serve this checkpoint (relative to the run "
                               "directory, e.g. last.ckpt) instead of "
                               "best_valid.pth")),
    ("--torch_checkpoint", dict(type=str, default="",
                                help="serve this file (e.g. a reference "
                                     "best_valid.pth; relative to the "
                                     "working directory) instead of the "
                                     "run's checkpoint")),
    ("--no_strict", dict(action="store_true",
                         help="accepted for the JAX CLI's sake; changes "
                              "nothing (loading is always strict)")),
    ("--device", dict(type=str, default="cuda", choices=("cuda", "cpu"))),
)


def run_directory(model_dir):
    """``model_dir`` itself when it is a directory, else ``results/<name>``
    (JAX inference.py:45-46)."""
    return model_dir if os.path.isdir(model_dir) \
        else os.path.join("results", model_dir)


def checkpoint_path(run_dir, name=""):
    """The checkpoint to serve: ``name`` (relative to ``run_dir`` or
    absolute), else ``best_valid.pth``, else ``best_valid.ckpt`` (a JAX
    run's best, JAX inference.py:64), else ``last.ckpt`` with a warning (JAX
    inference.py:65-72)."""
    if name:
        return name if os.path.isabs(name) else os.path.join(run_dir, name)
    best, jax_best, last = (os.path.join(run_dir, f) for f in (
        "best_valid.pth", "best_valid.ckpt", "last.ckpt"))
    if os.path.exists(best) or not (os.path.exists(jax_best)
                                    or os.path.exists(last)):
        return best
    if os.path.exists(jax_best):
        return jax_best
    print(f"warning: {best} missing, using {last} (no {jax_best} either)")
    return last


def load_weights(path, cfg):
    """The model's state_dict (on the CPU) from a checkpoint file of any
    format this package reads, picked by the file's first bytes: a torch
    file holds this package's trainer checkpoint (``train/state.py``
    ``save_checkpoint``) or a reference-format state_dict, a flax file the
    JAX package's ``save_checkpoint`` or ``save_params``."""
    if flax_msgpack.sniff(path) == "flax":
        return state_dict_from_flax_checkpoint(path, cfg)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and {"model", "optimizer"} <= set(payload):
        return payload["model"]
    return reference_state_dict(payload)


def main_inference(argv=None):
    cfg, extras = parse_args(argv, extra_fields=EXTRA_FLAGS)
    device = resolve_device(dp.init_from_env(extras.device))
    run_dir = run_directory(extras.model_dir)
    given = vars(build_parser(EXTRA_FLAGS).parse_args(argv))
    layout = {k: getattr(cfg, k) for k in SERVING_LAYOUT
              if given[k] is not None}
    cfg.override_from(os.path.join(run_dir, "opt.json"))
    for k, v in layout.items():
        setattr(cfg, k, v)
    cfg.resolve_device_policy(device)
    mesh = dp.make_mesh(cfg.mesh_shape)

    model = STAGE(ModelConfig.from_config(cfg))
    path = extras.torch_checkpoint or checkpoint_path(run_dir,
                                                      extras.checkpoint)
    model.load_state_dict(load_weights(path, cfg), strict=True)

    if cfg.synthetic_data or not cfg.train_path:
        n = 32 if cfg.debug else cfg.synthetic_n_valid
        dataset = SyntheticTVQADataset(cfg, n, mode=extras.mode)
        object_word_ids = list(range(3, 1000))
    else:
        dataset = TVQAPlusDataset(cfg, mode=extras.mode)
        object_word_ids = dataset.eval_object_word_ids
    predictions = InferenceRunner(cfg, model, device, mesh).run(
        dataset, mode=extras.mode, object_word_ids=object_word_ids,
        debug=cfg.debug)
    pred_path = os.path.join(run_dir,
                             f"{extras.mode}_inference_predictions.json")
    if mesh.is_main:
        save_json(predictions, pred_path)
        print(f"predictions saved to {pred_path}")
    dp.barrier(mesh)
    return pred_path


if __name__ == "__main__":
    main_inference()
    dp.close()
