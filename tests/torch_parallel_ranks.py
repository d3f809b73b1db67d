"""The rank programs of tests/test_torch_parallel.py,
tests/test_torch_parallel_cli.py and tests/test_torch_mesh_axes.py.

``run_ranks(fn, world, path)`` starts ``world`` processes (spawn), joins
them in a gloo process group (``init_distributed``, as an entry point does)
through a ``file://`` store beside the job, which no other process can take
from them as it could a port that was free when it was picked, and runs
``fn(rank, path)`` in each: ``path`` names a ``torch.save`` file with the
job, and each rank writes what it saw beside it (``<path>.rank<r>``).
This module imports the port and torch only, so a rank starts without
JAX."""
import dataclasses
import os
import socket
import uuid

import torch
import torch.multiprocessing as mp

from tvqaplus_tpu_torch.parallel import mesh as dp


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, world, path):
    """``fn(rank, path)`` on ``world`` gloo ranks; returns each rank's
    result file, loaded."""
    store = f"file://{path}.store-{uuid.uuid4().hex}"
    mp.start_processes(_entry, args=(fn, world, store, path),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(f"{path}.rank{r}", weights_only=False)
            for r in range(world)]


def _entry(rank, fn, world, store, path):
    torch.set_num_threads(1)
    dp.init_distributed(store, world, rank, device="cpu")
    try:
        torch.save(fn(rank, path), f"{path}.rank{rank}")
    finally:
        dp.close()


def _job(path):
    return torch.load(path, weights_only=False)


def train_job(cfg, state_dict, batches, use_hard_negatives, rows="shard",
              mesh_shape=(-1, 1), probe=False, save=None, resume=None):
    """A training job: ``batches`` (global batches, each a dict of CPU
    tensors, stacked when K > 1) dispatched in order from ``state_dict``
    on a mesh of ``mesh_shape``.  ``rows``: "shard" gives each rank its
    part (``shard_batch``), "same" every rank the whole batch.  ``probe``:
    record the QA stream and the classifier's input of each step.
    ``save``: write the trainer's checkpoint there after the last
    dispatch; ``resume``: start from that checkpoint."""
    return {"cfg": cfg, "sd": state_dict, "batches": batches,
            "use_hard": use_hard_negatives, "rows": rows,
            "mesh_shape": mesh_shape, "probe": probe, "save": save,
            "resume": resume}


def _probe(model):
    """Hooks that record, per forward, the input encoder's first output
    (the QA stream on the separate path) and the classifier's input (the
    pooled statement)."""
    seen = {"qa": [], "pooled": []}

    def encoder(mod, args, out):
        if len(seen["qa"]) < len(seen["pooled"]) + 1:
            seen["qa"].append(out.detach().clone())

    def classifier(mod, args):
        seen["pooled"].append(args[0].detach().clone())
    model.input_encoder.register_forward_hook(encoder)
    model.classifier.register_forward_pre_hook(classifier)
    return seen


def _probe_merged(model, blind):
    """Hooks that record each merged input-encoder call (the one with a
    zero mask): its input, output, zero mask, the state of the generator
    its plain dropout draws from, and the dropout rate and the seeds its
    kernel sites draw from.  ``blind``: run the call without the
    group map, keyed by the local place of each group (the mutation the
    map repairs)."""
    seen, states = [], []
    if blind:
        model.merged_group_map = lambda *args: None

    def pre_hook(mod, args, kwargs):
        if kwargs.get("zero_mask") is not None:
            states.append(kwargs["drop"].generator.get_state())

    def hook(mod, args, kwargs, out):
        if kwargs.get("zero_mask") is None:
            return
        drop = kwargs["drop"]
        seen.append({"x": args[0].detach().clone(),
                     "generator": states[len(seen)],
                     "out": out.detach().clone(),
                     "zero_mask": kwargs["zero_mask"].clone(),
                     "rate": drop.rate,
                     "seeds": drop.seeds[drop.site - len(
                         mod.stacked_encoderBlocks):].clone()})
    model.input_encoder.register_forward_pre_hook(pre_hook, with_kwargs=True)
    model.input_encoder.register_forward_hook(hook, with_kwargs=True)
    return seen


def _whole(mesh, model, name, t):
    """``t`` of the parameter ``name``, all-gathered whole when the model
    axis splits it."""
    if name not in model.shards:
        return t.detach().clone()
    return dp._gather_full(mesh, t.detach())


def train(job, mesh):
    """Run a ``train_job`` on this process (``mesh`` None: no group);
    returns the metrics of each dispatch (floats: this data row's sums and the
    global grad_norm), the whole gradients and parameters after the first and
    the last one, the names of the parameters the model axis split, and what
    ``probe`` recorded."""
    import dataclasses as dc

    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.train.loop import Trainer
    cfg = job["cfg"]
    if job.get("resume"):
        cfg = dc.replace(cfg, resume=job["resume"])
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(job["sd"], strict=True)
    trainer = Trainer(cfg, "cpu", model=model, mesh=mesh)
    seen = _probe(model) if job.get("probe") else None
    if job.get("probe_merged"):
        seen = _probe_merged(model, job.get("blind_map", False))
    metrics, first = [], None
    named = dict(model.named_parameters())
    for batch in job["batches"]:
        stacked = batch["ex_mask"].dim() == 2
        if job["rows"] == "shard":
            batch = dp.shard_batch(mesh, batch, stacked=stacked)
        m = trainer.dispatch_train(batch, job["use_hard"])
        metrics.append({k: float(v) for k, v in m.items()})
        if first is None:
            first = {k: _whole(mesh, model, k, p.grad)
                     for k, p in named.items()}
            with dp.full_state(mesh, model):
                first_params = {k: p.detach().clone()
                                for k, p in named.items()}
    grads = {k: _whole(mesh, model, k, p.grad) for k, p in named.items()}
    with dp.full_state(mesh, model):
        params = {k: p.detach().clone() for k, p in named.items()}
    if job.get("save"):
        trainer.save(job["save"])
    return {"metrics": metrics, "grads": grads, "first_grads": first,
            "params": params, "first_params": first_params,
            "step": trainer.step,
            "sharded": sorted(model.shards), "seen": seen,
            "coords": None if mesh is None else mesh.coords}


class _SummingGather(torch.autograd.Function):
    """A whole-weight gather whose backward sums the whole gradients over
    the model group before taking this rank's block (the mutation
    ``summing_gather`` runs)."""

    @staticmethod
    def forward(ctx, w, shard):
        ctx.shard = shard
        parts = [torch.empty_like(w) for _ in range(shard.size)]
        torch.distributed.all_gather(parts, w.contiguous(), group=shard.group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.shard.group)
        n = grad.shape[0] // ctx.shard.size
        return grad.narrow(0, ctx.shard.index * n, n), None


def _summing_gather(layer):
    shard = getattr(layer, "shard", None)
    return layer.weight if shard is None \
        else _SummingGather.apply(layer.weight, shard)


def train_rank(rank, path):
    job = _job(path)
    if job.get("summing_gather"):
        dp.gather_weight = _summing_gather
    return train(job, dp.make_mesh(job.get("mesh_shape", (-1, 1))))


def fit_rank(rank, path):
    """``Trainer.fit`` on synthetic data; each rank's ``results_dir`` is
    the job's with the rank appended, so a rank other than 0 that wrote a
    file would make a directory of its own."""
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.train.loop import Trainer
    job = _job(path)
    cfg = job["cfg"]
    last = os.path.join(cfg.results_dir, "last.ckpt")
    if rank:
        cfg.results_dir = f"{cfg.results_dir}.rank{rank}"
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(job["sd"], strict=True)
    mesh = dp.make_mesh()
    trainer = Trainer(cfg, "cpu", model=model, mesh=mesh)
    valid = SyntheticTVQADataset(cfg, job["n_valid"], mode="valid")
    best = trainer.fit(SyntheticTVQADataset(cfg, job["n_train"],
                                            mode="train"), valid)
    acc, loss, qid_corrects = trainer.validate(valid)
    # the resumed trainer logs through the first one's logger: each
    # TensorBoard writer opens an event file named by the second it opened
    # in, so a second writer made the directory hold one event file or two
    # by the clock alone
    resumed = Trainer(dataclasses.replace(cfg, resume=last), "cpu",
                      mesh=mesh, logger=trainer.logger)
    trainer.logger.close()
    return {"best": best, "acc": acc, "loss": loss,
            "qid_corrects": qid_corrects,
            "history": dict(trainer.logger.history),
            "params": {k: p.detach().clone()
                       for k, p in model.named_parameters()},
            "resumed": all(torch.equal(p, q) for p, q in
                           zip(model.parameters(),
                               resumed.model.parameters())),
            "resumed_step": resumed.step}


def infer_rank(rank, path):
    """``InferenceRunner.run`` over a synthetic split."""
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    job = _job(path)
    cfg = job["cfg"]
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(job["sd"], strict=True)
    runner = InferenceRunner(cfg, model, "cpu",
                             dp.make_mesh(job.get("mesh_shape", (-1, 1))))
    return runner.run(SyntheticTVQADataset(cfg, job["n"], mode="valid"),
                      object_word_ids=job["words"])
