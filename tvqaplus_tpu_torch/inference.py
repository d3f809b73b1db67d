"""Inference entry point:
``python -m tvqaplus_tpu_torch.inference --model_dir <run> --mode valid``.

Reloads the run's ``opt.json`` (every field overrides the CLI's, except
``debug``; reference TestOptions), loads a checkpoint of the run, runs
inference and writes ``{mode}_inference_predictions.json`` beside them.

* ``--model_dir``: the run directory, or a name under ``results/``.
* ``--checkpoint NAME``: the file to serve, relative to the run directory
  or absolute: a reference-format state_dict (``best_valid.pth``) or the
  trainer's own ``last.ckpt`` (model and optimizer; only the model is
  read).  Without it: ``best_valid.pth``, or ``last.ckpt`` with a warning
  when the run never wrote the best one (it is written only when the
  validation accuracy improves).
* ``--video_dedup``, ``--video_buckets``, ``--sub_token_buckets``: the
  serving batch layouts (data/pipeline.py).  They change what each batch
  ships to the card, not the predictions, so when the command line sets
  one it holds over the run's opt.json.

The split comes from the run's data: the TVQA+ artifacts its opt.json
names (``data/tvqa.py``; grounding records for the words of
``eval_object_vocab_path``), or synthetic data.  Score the predictions with
``python -m tvqaplus_tpu_torch.evaluation.tvqa_metrics``.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import os

from tvqaplus_tpu_torch import resolve_device
from tvqaplus_tpu_torch.config import build_parser, parse_args
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.data.tvqa import TVQAPlusDataset
from tvqaplus_tpu_torch.infer.predict import InferenceRunner
from tvqaplus_tpu_torch.interop.weights import load_reference_checkpoint
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
from tvqaplus_tpu_torch.train.state import load_model_state
from tvqaplus_tpu_torch.utils.io import save_json

# the batch-layout fields a command line may set over the run's opt.json
SERVING_LAYOUT = ("video_dedup", "video_buckets", "sub_token_buckets")
EXTRA_FLAGS = (
    ("--model_dir", dict(type=str, required=True,
                         help="run directory holding opt.json and the "
                              "checkpoints, or its name under results/")),
    ("--mode", dict(type=str, default="valid", help="valid/test")),
    ("--checkpoint", dict(type=str, default="",
                          help="serve this checkpoint (relative to the run "
                               "directory, e.g. last.ckpt) instead of "
                               "best_valid.pth")),
    ("--device", dict(type=str, default="cuda", choices=("cuda", "cpu"))),
)


def run_directory(model_dir):
    """``model_dir`` itself when it is a directory, else ``results/<name>``
    (JAX inference.py:45-46)."""
    return model_dir if os.path.isdir(model_dir) \
        else os.path.join("results", model_dir)


def checkpoint_path(run_dir, name=""):
    """The checkpoint to serve: ``name`` (relative to ``run_dir`` or
    absolute), else ``best_valid.pth``, else ``last.ckpt`` with a warning."""
    if name:
        return name if os.path.isabs(name) else os.path.join(run_dir, name)
    best = os.path.join(run_dir, "best_valid.pth")
    last = os.path.join(run_dir, "last.ckpt")
    if not os.path.exists(best) and os.path.exists(last):
        print(f"warning: {best} missing, using {last}")
        return last
    return best


def load_weights(path):
    """The model's state_dict from a ``.ckpt`` of the trainer
    (``train/state.py`` ``save_checkpoint``) or a reference-format state
    dict."""
    if path.endswith(".ckpt"):
        return load_model_state(path)
    return load_reference_checkpoint(path)


def main_inference(argv=None):
    cfg, extras = parse_args(argv, extra_fields=EXTRA_FLAGS)
    device = resolve_device(extras.device)
    run_dir = run_directory(extras.model_dir)
    given = vars(build_parser(EXTRA_FLAGS).parse_args(argv))
    layout = {k: getattr(cfg, k) for k in SERVING_LAYOUT
              if given[k] is not None}
    cfg.override_from(os.path.join(run_dir, "opt.json"))
    for k, v in layout.items():
        setattr(cfg, k, v)
    cfg.resolve_device_policy(device)

    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(
        load_weights(checkpoint_path(run_dir, extras.checkpoint)),
        strict=True)

    if cfg.synthetic_data or not cfg.train_path:
        n = 32 if cfg.debug else cfg.synthetic_n_valid
        dataset = SyntheticTVQADataset(cfg, n, mode=extras.mode)
        object_word_ids = list(range(3, 1000))
    else:
        dataset = TVQAPlusDataset(cfg, mode=extras.mode)
        object_word_ids = dataset.eval_object_word_ids
    predictions = InferenceRunner(cfg, model, device).run(
        dataset, mode=extras.mode, object_word_ids=object_word_ids,
        debug=cfg.debug)
    pred_path = os.path.join(run_dir,
                             f"{extras.mode}_inference_predictions.json")
    save_json(predictions, pred_path)
    print(f"predictions saved to {pred_path}")
    return pred_path


if __name__ == "__main__":
    main_inference()
