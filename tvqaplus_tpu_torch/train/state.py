"""Optimizer, gradient clipping, LR schedule and checkpoints (port of
``tvqaplus_tpu/train/state.py``).

* The optimizer is the reference recipe (main.py:209-219) as the JAX
  package's optax chain has it: clip by global norm (10), then Adam
  (0.9, 0.999, 1e-8) at lr 1e-3 with coupled L2 weight decay 3e-7 (added to
  the gradient before the moments), which is ``torch.optim.Adam``'s
  ``weight_decay``.
* ``clip_grad_norm`` is optax's ``clip_by_global_norm``: grads are scaled
  to ``g / norm * clip`` only when ``norm >= clip`` (torch's own
  ``clip_grad_norm_`` scales by ``clip / (norm + 1e-6)`` always), and it
  decides on the device, so a step never waits for the norm.
* ``PlateauScheduler`` is ReduceLROnPlateau(max, factor 0.5, patience 10,
  rel threshold 1e-4), stepped on the validation accuracy per epoch.
* On ``cuda`` Adam is ``capturable``, with its learning rate in a device
  tensor that ``set_lr`` fills, so a step captured in a CUDA graph
  (dispatch.py) reads the scheduler's rate at every replay; on the CPU it
  is torch's default Adam with a float rate.  ``dispatch_mode`` puts an
  optimizer in its device's mode, also after a checkpoint of the other
  mode was loaded.
* Checkpoints hold the model, the optimizer, the step and an ``extra``
  dict (``torch.save``).  ``load_checkpoint`` also restores the JAX
  trainer's flax ``save_checkpoint`` files (its ``last.ckpt``), picking the
  reader from the file's first bytes (``interop/flax_msgpack.py``): the
  parameters and Adam's moments through the weight bridge, Adam's count as
  torch's step, the injected learning rate.
"""
from __future__ import annotations

import os

import torch

from tvqaplus_tpu_torch.interop import flax_msgpack
from tvqaplus_tpu_torch.interop.weights import (
    adam_state_from_flax,
    state_dict_from_flax_tree,
)
from tvqaplus_tpu_torch.parallel.mesh import check_whole


def make_optimizer(params, lr, weight_decay=3e-7, device="cpu"):
    """Adam with coupled L2 decay (clip first with ``clip_grad_norm``), in
    ``device``'s dispatch mode."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    return dispatch_mode(opt, device)


def dispatch_mode(optimizer, device):
    """On ``cuda``: ``capturable``, the rate a float32 tensor on the card
    and the step counts there (Adam's capturable layout); on the CPU:
    float rate, step counts on the CPU.  Keeps the rate's value."""
    cuda = torch.device(device).type == "cuda"
    for group in optimizer.param_groups:
        lr = float(group["lr"])
        group["capturable"] = cuda
        group["lr"] = (torch.tensor(lr, dtype=torch.float32, device=device)
                       if cuda else lr)
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if cuda else "cpu", dtype=torch.float32)
    return optimizer


@torch.no_grad()
def clip_grad_norm(params, clip, sq_sum=None):
    """optax ``clip_by_global_norm`` in place; returns the pre-clip global
    norm (a device tensor).  ``sq_sum(params)``: the squared global norm,
    where the gradients are split over processes (parallel/mesh.py
    ``grad_sq_sum``)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads)
                      if sq_sum is None else sq_sum(params))
    keep = norm < clip
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * clip))
    return norm


def set_lr(optimizer, lr):
    """Set the rate in place (a device rate is filled, so a captured step
    reads it)."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


class PlateauScheduler:
    """ReduceLROnPlateau(max, factor, patience, rel threshold 1e-4)
    semantics (reference main.py:213-219, stepped on val accuracy per
    epoch)."""

    THRESHOLD = 1e-4

    def __init__(self, init_lr, factor=0.5, patience=10):
        self.lr = init_lr
        self.factor = factor
        self.patience = patience
        self.best = -float("inf")
        self.num_bad_epochs = 0

    def _is_better(self, metric):
        rel = 1.0 + self.THRESHOLD if self.best >= 0 else \
            1.0 - self.THRESHOLD
        return metric > self.best * rel

    def step(self, metric):
        """Returns the (possibly reduced) learning rate."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr *= self.factor
            self.num_bad_epochs = 0
        return self.lr


def save_checkpoint(path, model, optimizer, step, extra=None):
    """Model, optimizer, step and ``extra`` in one file (atomic rename);
    the model's weights must be whole (``parallel.mesh.full_state``)."""
    check_whole(model)
    tmp = path + ".tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": int(step),
                "extra": extra or {}}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, model, optimizer):
    """Restore a ``save_checkpoint`` file of this package (saved in either
    device's mode) or of the JAX package (flax) into ``model`` (a STAGE)
    and ``optimizer`` (``make_optimizer``'s Adam), the optimizer in its
    device's mode; returns (step, extra)."""
    device = next(iter(model.parameters())).device
    if flax_msgpack.sniff(path) == "flax":
        step, extra = _load_flax_checkpoint(path, model, optimizer)
    else:
        payload = torch.load(path, map_location="cpu", weights_only=False)
        model.load_state_dict(payload["model"])
        optimizer.load_state_dict(payload["optimizer"])
        step, extra = payload["step"], payload.get("extra", {})
    dispatch_mode(optimizer, device)
    return step, extra


def _load_flax_checkpoint(path, model, optimizer):
    tree = flax_msgpack.load(path)
    if "state" not in tree:
        raise ValueError(f"{path}: flax parameters alone (save_params); "
                         f"resuming needs a save_checkpoint file, such as "
                         f"the JAX trainer's last.ckpt")
    state = tree["state"]
    model.load_state_dict(state_dict_from_flax_tree(tree, model.cfg))
    moments, lr = adam_state_from_flax(state["opt_state"], model.cfg, model)
    for name, p in model.named_parameters():
        optimizer.state[p] = {k: v.to(p.device) if k != "step" else v
                              for k, v in moments[name].items()}
    for group in optimizer.param_groups:
        group["lr"] = lr
    extra = {k: v.item() if hasattr(v, "item") else v
             for k, v in tree.get("extra", {}).items()}
    return int(state["step"]), extra

