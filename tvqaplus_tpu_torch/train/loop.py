"""Training and validation loop (port of ``tvqaplus_tpu/train/loop.py``).

Mirrors the reference control flow (main.py:18-251): a per-epoch train loop
with validation at every ``log_freq`` crossing, best-model saving, plateau
LR on the validation accuracy, early stop after ``max_es_cnt`` flat epochs,
hard negatives after ``hard_negative_start`` epochs, the debug break after
batch 5 with a timing dump, and a halt on a non-finite loss that saves the
diverged state to ``crash_state.ckpt``.

One train step is forward(train) -> ``total_loss`` -> backward -> clip ->
Adam.  On ``cuda`` the three fused kernels and their backward kernels carry
it; the step never waits on the device: the kernels' dropout seeds come
from the step counter on the device (ops/philox.py ``StepSeeds``, which the
step advances), the plain layers' masks and the att loss's Gumbel noise
from a generator on the device, and the losses stay on the device until a
log point.

``cfg.resume`` names a checkpoint of this package's trainer or of the JAX
package's (its flax ``last.ckpt``), read by its content
(``train/state.py`` ``load_checkpoint``): the weights, Adam's state, the
step (which also keys the kernels' dropout seeds) and the best accuracy,
epoch and learning rate of its ``extra``, as the JAX Trainer resumes
(JAX loop.py:121-127).  With ``cfg.profile_dir`` a ``torch.profiler``
trace of epoch 0's dispatches 8 to 12 is written there (JAX
loop.py:300-301, 370-373).

Steps are dispatched K at a time, as the JAX Trainer dispatches them
(dispatch.py): ``steps_per_dispatch`` same-bucket training batches and
``eval_steps_per_dispatch`` validation batches (one at a time under
``debug`` or a batch budget) per dispatch, one CUDA-graph replay each on
``cuda``.  A dispatch's metrics are summed over its K steps, and log points
fall on the reference's batch indices (``log_crossing``).

``mesh`` (parallel/mesh.py) runs the trainer on a (data, ctx, model)
mesh, and a step is the single-process step on the global batch, as JAX's
SPMD step is (loop.py:89-124, 198-213).  Each data row ``d`` takes its rows
of every global batch (``DataPipeline(mesh=...)``): the cls loss rescales
by the global counts, the gradients are summed between the backward and
the clip, the att loss's Gumbel noise is the row's part of one global
draw, and each row drops other units (its own dropout seeds,
ops/philox.py ``rank_seed``).  Each ctx rank of a row takes its frames of
Li and gathers the whole Li before the head (models/stage.py): its
Li-sharded dropout sites draw under seeds that fold in (d, c) as well,
everything replicated under the row's.  On a model axis the large dense
weights and their Adam moments are split by columns (``place_model``);
the clip norm counts their squares over the model group, and checkpoints
gather them whole (``full_state``).  The log windows and the validation
totals are summed over the data rows and the validation answers gathered
in global row order, so every control decision (log points, best model,
plateau LR, early stop, the non-finite halt) reads the same values on
every rank.  Rank 0 alone writes the run's files; the others wait at a
barrier.
"""
from __future__ import annotations

import functools
import math
import os
import tempfile
import time

import torch

from tvqaplus_tpu_torch import dispatch, resolve_device
from tvqaplus_tpu_torch.data.pipeline import DataPipeline
from tvqaplus_tpu_torch.models.layers import Dropout
from tvqaplus_tpu_torch.models.losses import gumbel_noise, total_loss
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
from tvqaplus_tpu_torch.ops import widths
from tvqaplus_tpu_torch.ops.philox import StepSeeds, noise_seed, rank_seed
from tvqaplus_tpu_torch.parallel import mesh as dp
from tvqaplus_tpu_torch.train.metrics import MetricsLogger
from tvqaplus_tpu_torch.train.state import (
    PlateauScheduler,
    clip_grad_norm,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
    set_lr,
)
from tvqaplus_tpu_torch.utils.misc import AverageMeter, count_parameters

_WINDOW_KEYS = ("loss", "loss_att", "loss_ts", "loss_cls")


def log_crossing(prev_steps, new_steps, log_freq):
    """(triggered, batch index of the log point) for the optimizer steps
    [prev_steps, new_steps): the reference logs when
    ``batch_idx % log_freq == 0`` (main.py:81)."""
    if new_steps - prev_steps > log_freq:
        raise ValueError("an interval longer than log_freq would skip a "
                         "log point")
    if prev_steps == 0:
        return True, 0
    if (prev_steps - 1) // log_freq != (new_steps - 1) // log_freq:
        return True, ((prev_steps + log_freq - 1) // log_freq) * log_freq
    return False, 0


def start_trace(device):
    """A running ``torch.profiler`` trace of the host and, on ``cuda``, the
    card."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, device, profile_dir):
    """Stop ``prof`` once the device is done and write its Chrome trace
    into ``profile_dir``; returns the file's path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".json", dir=profile_dir,
                                prefix=time.strftime("torch_trace_%Y_%m_%d_"
                                                     "%H_%M_%S_"))
    os.close(fd)             # a unique name: runs sharing the directory
    prof.export_chrome_trace(path)
    return path


def _empty_window():
    return {"loss": [], "loss_att": [], "loss_ts": [], "loss_cls": [],
            "att_dropped": [], "n_correct": [], "n": []}


class Trainer:
    """Model, optimizer, schedule and the train/eval steps on ``device``
    (``cuda`` unless the caller asks for ``cpu``).  The model starts from
    seeded random weights (``cfg.seed``) unless ``cfg.resume`` names a
    checkpoint.  ``mesh``: this rank of a data-parallel run, whose global
    batch sizes are ``cfg.bsz`` and ``cfg.test_bsz``."""

    def __init__(self, cfg, device=None, logger=None, model=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # on cuda every step runs the backward kernels (D = 128 only)
        widths.check_trainable(cfg.hsz, self.device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.model_cfg = ModelConfig.from_config(cfg)
        if model is None:
            model = STAGE(self.model_cfg).reset_parameters(
                torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(self.params, cfg.lr, cfg.wd,
                                        self.device)
        self.scheduler = PlateauScheduler(cfg.lr, factor=0.5, patience=10)
        self.logger = logger or MetricsLogger(
            cfg.results_dir if self.is_main else None)
        self.n_params = count_parameters(self.model)
        self.steps_per_dispatch = cfg.steps_per_dispatch
        if self.steps_per_dispatch == 0:
            self.steps_per_dispatch = dispatch.auto_steps_per_dispatch(cfg)
        # kernel dropout seeds: from the step counter on the device; plain
        # dropout masks: a generator on the device (both the data row's
        # own; under a ctx axis a second pair, the row's and ctx rank's,
        # for the Li-sharded sites); the att loss's Gumbel noise: one
        # generator alike on every rank
        row = 0 if mesh is None else mesh.d
        self.seeds = StepSeeds(cfg.seed, self.device, row)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.seed, row))
        self.noise_generator = torch.Generator(
            device=self.device).manual_seed(noise_seed(cfg.seed))
        generators = [self.generator, self.noise_generator]
        self.frame_seeds = self.frame_generator = None
        if mesh is not None and mesh.ctx > 1:
            # keys apart from every data row's: index data + d ctx + c
            frame = mesh.data + mesh.d * mesh.ctx + mesh.c
            self.frame_seeds = StepSeeds(cfg.seed, self.device, frame)
            self.frame_generator = torch.Generator(
                device=self.device).manual_seed(rank_seed(cfg.seed, frame))
            generators.append(self.frame_generator)
        self.graphs = (dispatch.StepGraphs(self.device, *generators)
                       if self.device.type == "cuda" else None)
        self._names = {}           # metric names of a packed dispatch
        self.trace_path = None     # the profile_dir trace, once written
        self.step = 0
        self.best_acc = 0.0
        self.start_epoch = 0
        extra = {}
        if cfg.resume:             # every rank reads it; rank 0's holds
            self.step, extra = load_checkpoint(cfg.resume, self.model,
                                               self.optimizer)
        self.step, extra = dp.broadcast_state(
            mesh, self.model, self.optimizer, (self.step, extra))
        dp.place_model(mesh, self.model, self.optimizer)
        self.head = self.model.head_parameters()
        if cfg.resume:
            self.best_acc = extra.get("best_acc", 0.0)
            self.start_epoch = extra.get("epoch", 0)
            self.scheduler.lr = extra.get("lr", cfg.lr)
            set_lr(self.optimizer, self.scheduler.lr)
            self.seeds.step.fill_(self.step)
        self.loss_kwargs = dict(
            att_weight=cfg.att_weight, ts_weight=cfg.ts_weight,
            use_sup_att=cfg.use_sup_att, num_negatives=cfg.num_negatives,
            att_loss_type=cfg.att_loss_type, margin=cfg.margin,
            alpha=cfg.alpha, drop_topk=cfg.drop_topk,
            negative_pool_size=cfg.negative_pool_size,
            num_hard=cfg.num_hard, entry_cap=cfg.att_entry_cap,
            vfeat_flag=cfg.vfeat_flag,
            count_sum=None if mesh is None
            else functools.partial(dp.all_reduce_sum, mesh))
        # training reads only the vid raw scores, only at the target answer
        self.need_vid_raw = "target" if (cfg.use_sup_att
                                         and cfg.vfeat_flag) else False

    # ------------------------------------------------------------------
    def _gumbel(self, batch, use_hard_negatives):
        cfg = self.cfg
        if not (cfg.use_sup_att and cfg.vfeat_flag):
            return None
        if use_hard_negatives and cfg.negative_pool_size <= cfg.num_negatives:
            return None            # direct hard negatives: no sampling
        bsz, li, lr = batch["vid_mask"].shape
        li *= 1 if self.mesh is None else self.mesh.ctx    # the whole Li
        e = min(cfg.att_entry_cap, li * batch["qas_mask"].shape[-1] * lr)
        # this data row's rows of the global batch's draw
        n = bsz * (1 if self.mesh is None else self.mesh.data)
        lo, hi = dp.rank_rows(self.mesh, n)
        return gumbel_noise((n, e, cfg.num_negatives, lr),
                            self.noise_generator, self.device)[lo:hi]

    def train_step(self, batch, use_hard_negatives=False):
        """One eager optimizer step on a batch already on the device: the
        step's seeds from the counter, which it advances, then forward,
        losses, backward, the gradients' sum over the ranks, clip and Adam
        in place (what a dispatch's graph captures).  Returns the step's
        metrics as device tensors: sums over this rank's rows, and
        ``grad_norm``, the global norm before clipping."""
        self.model.train()
        frames = None if self.frame_seeds is None else Dropout(
            self.cfg.dropout, self.frame_generator, self.frame_seeds.next())
        drop = Dropout(self.cfg.dropout, self.generator, self.seeds.next(),
                       frames)
        out = self.model(batch, train=True, need_sub_raw=False,
                         need_vid_raw=self.need_vid_raw, drop=drop)
        loss, metrics = total_loss(
            out, batch, self._gumbel(batch, use_hard_negatives), train=True,
            use_hard_negatives=use_hard_negatives, **self.loss_kwargs)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        dp.all_reduce_grads(self.mesh, self.params, self.head,
                            self.model.shards.values())
        metrics["grad_norm"] = clip_grad_norm(
            self.params, self.cfg.clip,
            None if not self.model.shards else functools.partial(
                dp.grad_sq_sum, self.mesh, self.model))
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch):
        """Eval forward + losses (no att loss, as model.eval() gates it in
        the reference, stage.py:317); returns (metrics, answer ids)."""
        self.model.eval()
        out = self.model(batch, need_sub_raw=False, need_vid_raw=False)
        _, metrics = total_loss(out, batch, None, train=False,
                                **self.loss_kwargs)
        return metrics, out["answer_scores"].argmax(-1)

    def _packed(self, tag, metrics):
        """Per-step metric dicts -> their sums over the steps, one vector
        (names kept under ``tag``)."""
        names = self._names.setdefault(tag, list(metrics[0]))
        return torch.stack([torch.stack([m[n].float() for n in names])
                            for m in metrics]).sum(0)

    def _train_steps(self, batch, use_hard_negatives):
        return self._packed("train", [
            self.train_step(b, use_hard_negatives)
            for b in dispatch.unstack(batch)])

    def _eval_steps(self, batch):
        outs = [self.eval_step(b) for b in dispatch.unstack(batch)]
        return (self._packed("eval", [m for m, _ in outs]),
                torch.stack([p for _, p in outs]).reshape(-1))

    def _run(self, key, fn, batch):
        """``fn(batch)`` eagerly (CPU) or through a CUDA graph (cuda)."""
        return fn(batch) if self.graphs is None \
            else self.graphs(key, fn, batch)

    def dispatch_train(self, batch, use_hard_negatives=False):
        """The K optimizer steps of a (stacked) batch in one dispatch;
        returns their summed metrics as device tensors (JAX
        ``_dispatch_train``)."""
        step = self.step + dispatch.steps_in(batch)
        vec = self._run(("train", use_hard_negatives),
                        lambda b: self._train_steps(b, use_hard_negatives),
                        batch).clone()
        self.step = step       # a capture runs train_step's host part too
        return dict(zip(self._names["train"], vec.unbind()))

    def dispatch_eval(self, batch):
        """The K eval steps of a (stacked) batch in one dispatch: (summed
        metrics, the K*B answer ids in stack order), read before the next
        dispatch (a replay rewrites them)."""
        vec, preds = self._run(("eval",), self._eval_steps, batch)
        return dict(zip(self._names["eval"], vec.unbind())), preds

    def _pipeline(self, dataset, train, batch_size, group=1):
        return DataPipeline(dataset, self.cfg, self.device,
                            batch_size=batch_size,
                            prefetch_depth=self.cfg.prefetch_depth,
                            train=train, seed=self.cfg.seed, group=group,
                            mesh=self.mesh)

    def _summed(self, window):
        """The log window's per-dispatch values summed over the ranks, as
        host lists (one all-reduce)."""
        keys = [k for k, v in window.items() if v]
        flat = dp.all_reduce_sum(self.mesh, torch.cat(
            [torch.stack(window[k]).float() for k in keys]))
        sizes = [len(window[k]) for k in keys]
        return {k: v.cpu().tolist()
                for k, v in zip(keys, flat.split(sizes))}

    def _barrier_after(self, write):
        """``write()`` on rank 0, then every rank waits for it."""
        if self.is_main:
            write()
        dp.barrier(self.mesh)

    # ------------------------------------------------------------------
    def validate(self, dataset, max_batches=None):
        """A pass over the valid split: (acc, loss per example,
        qid_corrects) (reference main.py:151-183), ``eval_steps_per_dispatch``
        same-bucket batches a dispatch unless a batch budget (``debug``,
        ``max_batches``) caps the pass.  Data-parallel: the totals summed
        over the ranks, ``qid_corrects`` in the global batches' row order,
        the same on every rank."""
        dataset.set_mode("valid")
        group = max(1, self.cfg.eval_steps_per_dispatch)
        if max_batches is not None or self.cfg.debug:
            group = 1
        pipeline = self._pipeline(dataset, False, self.cfg.test_bsz, group)
        n_correct = loss = n = 0.0
        lines = []          # per dispatch, per batch: this rank's rows
        for i, (batch, meta, _) in enumerate(pipeline):
            metrics, preds = self.dispatch_eval(batch)
            preds = preds.cpu().tolist()
            n_correct += float(metrics["n_correct"])
            loss += float(metrics["loss"])
            n += len(meta["qid"])
            rows = ["%d\t%d" % (meta["qid"][j],
                                 int(preds[j] == meta["target"][j]))
                    for j in range(len(meta["qid"]))]
            # batch k of the dispatch: rows [k b, (k + 1) b) (only a
            # stack's last batch can be partial)
            b = batch["ex_mask"].shape[-1]
            lines.append([rows[k * b:(k + 1) * b]
                          for k in range(dispatch.steps_in(batch))])
            if max_batches is not None and i + 1 >= max_batches:
                break
            if self.cfg.debug and i == 20:
                break
        totals = dp.all_reduce_sum(self.mesh, torch.tensor(
            [n_correct, loss, n], dtype=torch.float64, device=self.device))
        n_correct, loss, n = totals.tolist()
        ranks = dp.gather_objects(self.mesh, lines)
        qid_corrects = [row for d, per_batch in enumerate(lines)
                        for k in range(len(per_batch))
                        for rank_lines in ranks for row in rank_lines[d][k]]
        return n_correct / max(n, 1), loss / max(n, 1), qid_corrects

    def train_epoch(self, dataset, epoch, use_hard_negatives=False,
                    valid_dataset=None):
        """One epoch (reference main.py:18-148); returns the best val
        acc."""
        cfg = self.cfg
        if valid_dataset is dataset:
            raise ValueError("pass separate train/valid dataset objects")
        dataset.set_mode("train")
        pipeline = self._pipeline(dataset, True, cfg.bsz,
                                  self.steps_per_dispatch)
        meters = {k: AverageMeter() for k in ("dataloading",
                                             "forward_backward")}
        window = _empty_window()
        valid_acc_log = ["batch_idx\tacc"]
        n_steps = len(pipeline)    # optimizer steps, not dispatches
        steps_done = 0
        profiler = None
        timer = time.time()
        for batch_idx, (batch, _, _) in enumerate(pipeline):
            if cfg.profile_dir and epoch == 0 and batch_idx == 8 \
                    and self.is_main:
                profiler = start_trace(self.device)
            meters["dataloading"].update(time.time() - timer)
            t0 = time.time()
            prev_steps = steps_done
            steps_done += dispatch.steps_in(batch)
            metrics = self.dispatch_train(batch, use_hard_negatives)
            if cfg.debug:              # per-step timing syncs, debug only
                float(metrics["loss"])
            meters["forward_backward"].update(time.time() - t0)
            for k in _WINDOW_KEYS:
                window[k].append(metrics[k])
            if "att_n_pos_dropped" in metrics:
                window["att_dropped"].append(metrics["att_n_pos_dropped"])
            window["n_correct"].append(metrics["n_correct"])
            window["n"].append(metrics["n_eff"])

            triggered, log_point = log_crossing(prev_steps, steps_done,
                                                cfg.log_freq)
            if triggered:
                niter = epoch * n_steps + log_point
                if log_point > 0:
                    host = self._summed(window)
                    self._halt_if_nonfinite(
                        host["loss"], epoch,
                        f"batches [{max(0, log_point - cfg.log_freq)}, "
                        f"{log_point})")
                    n = max(sum(host["n"]), 1)
                    self.logger.add_scalar("Train/Acc",
                                           sum(host["n_correct"]) / n, niter)
                    for k, tag in (("loss", "Loss"), ("loss_att", "Loss_att"),
                                   ("loss_cls", "Loss_cls"),
                                   ("loss_ts", "Loss_ts")):
                        self.logger.add_scalar(f"Train/{tag}",
                                               sum(host[k]) / n, niter)
                    if "att_dropped" in host:
                        self.logger.add_scalar("Train/Att_pos_dropped",
                                               sum(host["att_dropped"]),
                                               niter)
                if valid_dataset is not None:
                    valid_acc, valid_loss, _ = self.validate(valid_dataset)
                    self.logger.add_scalar("Valid/Acc", valid_acc, niter)
                    self.logger.add_scalar("Valid/Loss", valid_loss, niter)
                    valid_acc_log.append("%02d\t%.4f" % (log_point,
                                                         valid_acc))
                    if valid_acc > self.best_acc:
                        self.best_acc = valid_acc
                        self.save_best()
                    dataset.set_mode("train")
                    window = _empty_window()
            if profiler is not None and batch_idx >= 12:
                self.trace_path = stop_trace(profiler, self.device,
                                             cfg.profile_dir)
                profiler = None
            timer = time.time()
            # main.py:131, counted in batches, not dispatches
            if cfg.debug and steps_done > 5:
                for name, m in meters.items():
                    if self.is_main:
                        print(f"{name}: max {m.max:.4f} min {m.min:.4f} "
                              f"avg {m.avg:.4f}")
                break
        if profiler is not None:
            self.trace_path = stop_trace(profiler, self.device,
                                         cfg.profile_dir)
        if window["loss"]:
            # the tail window gets the non-finite check too
            tail = self._summed({"loss": window["loss"]})["loss"]
            self._halt_if_nonfinite(tail, epoch, "the epoch's tail window")
        self.logger.append_log("valid_acc.log", valid_acc_log)
        return self.best_acc

    def _halt_if_nonfinite(self, losses, epoch, where):
        """A NaN/inf training loss saves the diverged state and halts."""
        if not self.cfg.halt_on_nonfinite or math.isfinite(sum(losses)):
            return
        crash = os.path.join(self.cfg.results_dir, "crash_state.ckpt")
        self.save(crash, epoch=epoch)
        raise FloatingPointError(
            f"non-finite training loss in {where} of epoch {epoch}; "
            f"diverged state saved to {crash}")

    def fit(self, train_dataset, valid_dataset):
        """Training run with plateau LR and early stop (reference
        main.py:186-251); returns the best val acc."""
        cfg = self.cfg
        es_cnt = 0
        for epoch in range(self.start_epoch, cfg.n_epoch):
            use_hard = epoch + 1 > cfg.hard_negative_start
            self.logger.add_scalar("learning_rate", self.scheduler.lr, epoch)
            prev_best = self.best_acc
            cur_acc = self.train_epoch(train_dataset, epoch,
                                       use_hard_negatives=use_hard,
                                       valid_dataset=valid_dataset)
            set_lr(self.optimizer, self.scheduler.step(cur_acc))
            if cur_acc > prev_best:
                es_cnt = 0
            else:
                es_cnt += 1
                if es_cnt >= cfg.max_es_cnt:
                    if self.is_main:
                        print("=> early stop with valid acc %.4f"
                              % self.best_acc)
                    self.logger.export_scalars()
                    break
            self.save(os.path.join(cfg.results_dir, "last.ckpt"), epoch=epoch)
            if cfg.debug:
                break
        return self.best_acc

    def save(self, path, epoch=0):
        """The trainer's checkpoint (whole weights), written by rank 0;
        every rank waits for it."""
        with dp.full_state(self.mesh, self.model, self.optimizer):
            self._barrier_after(lambda: save_checkpoint(
                path, self.model, self.optimizer, self.step,
                extra={"best_acc": self.best_acc, "epoch": epoch,
                       "lr": self.scheduler.lr}))

    def save_best(self):
        """``best_valid.pth``: the model's state_dict in the reference
        format, which the port's inference CLI reads (rank 0 writes it)."""
        def write():
            sd = {k: v.detach().cpu()
                  for k, v in self.model.state_dict().items()}
            torch.save(sd, os.path.join(self.cfg.results_dir,
                                        "best_valid.pth"))
        with dp.full_state(self.mesh, self.model):
            self._barrier_after(write)
