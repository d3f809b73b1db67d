"""Training entry point: ``python -m tvqaplus_tpu_torch.main <flags>``.

Mirrors the JAX package's ``main.py`` (reference main.py:186-251): parse
the config, seed, build the datasets, model, optimizer and plateau
scheduler, and run epochs with validation at every ``log_freq`` crossing,
best-model saving and early stop.  Writes ``opt.json``, the ``code.zip``
snapshot of the package and, at each new best validation accuracy,
``best_valid.pth`` (a reference-format
state_dict) into the run directory, so ``python -m
tvqaplus_tpu_torch.inference --model_dir <run>`` reads it unchanged.

Runs on ``cuda`` unless ``--device cpu`` is given.  Data: the TVQA+
artifacts named by the path flags (``--train_path``, ``--valid_path``,
``--qa_bert_path``, ... as ``data/fixtures.py`` ``write_artifacts``
returns them), read by ``data/tvqa.py``; or ``--synthetic_data``.
``--debug`` is the end-to-end smoke run (the reference's ``run_main.sh
debug``): one epoch, a break after batch 5 (on synthetic data 64 train /
32 valid examples).

On a mesh: ``torchrun --nproc_per_node N -m tvqaplus_tpu_torch.main``
runs N ranks, one card each (``--device cpu``: gloo on the CPU); the mesh
is ``--mesh_shape`` (data, ctx[, model]), whose sizes multiply to N
(default ``-1 1``: every rank on the data axis; ``2 2``: two data rows of
two ctx ranks, each holding half of Li; ``1 1 2``: the large dense weights
split over two model ranks).  As in the JAX package (main.py:47-52),
``--bsz`` and ``--test_bsz`` are each data row's batch: the global batch
is the data size times that, and opt.json records the global sizes.  Rank
0 writes the run directory.
"""
from __future__ import annotations

import numpy as np
import torch

from tvqaplus_tpu_torch import resolve_device
from tvqaplus_tpu_torch.config import parse_args
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.data.tvqa import TVQAPlusDataset
from tvqaplus_tpu_torch.ops import widths
from tvqaplus_tpu_torch.parallel import mesh as dp
from tvqaplus_tpu_torch.train.loop import Trainer

EXTRA_FLAGS = (
    ("--device", dict(type=str, default="cuda", choices=("cuda", "cpu"))),
)


def build_datasets(cfg):
    if cfg.synthetic_data or not cfg.train_path:
        n_train = 64 if cfg.debug else cfg.synthetic_n_train
        n_valid = 32 if cfg.debug else cfg.synthetic_n_valid
        return (SyntheticTVQADataset(cfg, n_train, mode="train"),
                SyntheticTVQADataset(cfg, n_valid, mode="valid"))
    train = TVQAPlusDataset(cfg, mode="train")
    return train, train.view("valid")  # the view shares the loaded artifacts


def main(argv=None):
    cfg, extras = parse_args(argv, extra_fields=EXTRA_FLAGS)
    device = resolve_device(dp.init_from_env(extras.device))
    widths.check_trainable(cfg.hsz, device)   # before a run dir is written
    mesh = dp.make_mesh(cfg.mesh_shape)
    # the reference scales the global batch by the device count
    # (config.py:187-188), the JAX package by the data axis
    cfg.bsz *= dp.data_parallel_size(mesh)
    cfg.test_bsz *= dp.data_parallel_size(mesh)
    # rank 0's run directory (its name holds the time)
    cfg.results_dir = dp.broadcast_object(mesh, cfg.results_dir)
    if mesh.is_main:
        cfg.save_run()
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)

    train_ds, valid_ds = build_datasets(cfg)
    trainer = Trainer(cfg, device, mesh=mesh)
    if mesh.is_main:
        print(f"Parameter count: {trainer.n_params:,d}")
    best_acc = trainer.fit(train_ds, valid_ds)
    if mesh.is_main:
        print(f"Best val acc: {best_acc:.4f}")
        print(f"Results dir: {cfg.results_dir}")
    return cfg.results_dir, trainer


if __name__ == "__main__":
    main()
    dp.close()
