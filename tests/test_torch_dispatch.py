"""Multi-step dispatch in the port (``dispatch.py``, ``DataPipeline(group)``,
``Trainer.dispatch_train`` / ``dispatch_eval``, ``InferenceRunner
.dispatch_infer``) against the JAX package's (``steps_per_dispatch``,
``eval_steps_per_dispatch``), and what makes a step capturable in a CUDA
graph: the kernels' dropout seeds from the step counter on the device
(ops/philox.py ``StepSeeds``), device-built constants, Adam's dispatch
mode.  On the CPU every dispatch runs eagerly; the replays themselves are
held on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tiny configs from numpy-seeded synthetic data; each tolerance is stated at
its use."""
import copy
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_inference_json_parity import _adopt_ref_floats
from tests.test_torch_bridge import bridge_inputs as mlp_inputs
from tests.test_torch_kernels import attn_inputs, encoder_inputs
from tests.test_torch_kernels import bridge_inputs as tri_inputs
from tests.test_torch_train import port_config
from tests.test_train import small_cfg
from tvqaplus_tpu.data.pipeline import DataPipeline as JaxPipeline
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.infer.predict import InferenceRunner as JaxRunner
from tvqaplus_tpu.parallel.mesh import make_mesh
from tvqaplus_tpu.train.loop import Trainer as JaxTrainer
from tvqaplus_tpu.train.loop import auto_steps_per_dispatch as jax_auto
from tvqaplus_tpu_torch import dispatch
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data.pipeline import DataPipeline
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.infer.predict import InferenceRunner
from tvqaplus_tpu_torch.interop.weights import params_from_flax
from tvqaplus_tpu_torch.models import layers as tl
from tvqaplus_tpu_torch.models.layers import Dropout
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
from tvqaplus_tpu_torch.ops import encoder, mlp_bridge, philox, \
    qa_ctx_attention, tri_bridge
from tvqaplus_tpu_torch.train import loop, state

torch.set_num_threads(1)
OBJECT_WORDS = list(range(3, 1000, 7))
# two Li buckets, so same-bucket stacking reorders batches
TWO_BUCKETS = dict(use_sup_att=True, add_local=True, dropout=0.0,
                   use_pallas=False, compute_dtype="float32", seed=3,
                   img_buckets=[5, 6], test_bsz=2)


# ------------------------------------------------------------------ seeds
def test_step_seeds_advance_on_the_device_counter():
    """Site i of step s draws under base + s * SITES + i; ``next()`` fills
    the slots and advances the counter; a forward's sites take the slots in
    order."""
    seeds = philox.StepSeeds(7, "cpu")
    base = philox.draw_seed(torch.Generator().manual_seed(7))
    first = seeds.next().clone()
    second = seeds.next().clone()
    want = base + torch.arange(philox.SITES)
    assert torch.equal(first, want)
    assert torch.equal(second, want + philox.SITES)
    assert int(seeds.step) == 2 and seeds.seeds.dtype == torch.int64
    drop = Dropout(0.1, torch.Generator(), seeds.seeds)
    got = [drop.kernel_args() for _ in range(3)]
    assert [int(s) for _, s in got] == second[:3].tolist()
    assert all(s.data_ptr() == seeds.seeds[i].data_ptr()
               for i, (_, s) in enumerate(got))
    drop.site = philox.SITES
    with pytest.raises(RuntimeError, match="kernel dropout sites"):
        drop.kernel_args()
    assert Dropout(0.0, None, seeds.seeds).kernel_args() == (0.0, 0)


def _kernel_calls():
    """Each fused op at the kernel tests' tiny inputs, as f(rate, seed)."""
    att = [torch.from_numpy(np.array(a)) for a in attn_inputs()]
    tri = [torch.from_numpy(a) for a in tri_inputs()]
    x, pe, p, mask = encoder_inputs(k=3)
    x, pe, mask = map(torch.from_numpy, (x, pe, mask))
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    br = [torch.from_numpy(a) for a in mlp_inputs()]
    return {
        "qa_ctx_attention": lambda rate, seed: qa_ctx_attention.
        qa_ctx_attention(*att, raw_mode="none", dropout_rate=rate,
                         seed=seed),
        "tri_bridge": lambda rate, seed: tri_bridge.tri_bridge(
            *tri, dropout_rate=rate, seed=seed),
        "encoder_reduce": lambda rate, seed: encoder.encoder_reduce(
            x, pe, p, 3, mask, rate, seed),
        "encoder_block": lambda rate, seed: encoder.encoder_block(
            x, pe, p, 3, None, rate, seed),
        "mlp_bridge": lambda rate, seed: mlp_bridge.mlp_bridge(
            *br, rate, seed),
    }


@pytest.mark.parametrize("op", ["qa_ctx_attention", "tri_bridge",
                                "encoder_reduce", "encoder_block",
                                "mlp_bridge"])
def test_a_seed_slot_draws_the_bits_of_its_value(op):
    """At dropout 0.1 every fused op (its plain version on the CPU) gives
    the same bits with its seed as a slot of the step's seed tensor as
    with the slot's value as an int (the seed the parent passed); the next
    step's slot draws another mask."""
    call = _kernel_calls()[op]
    seeds = philox.StepSeeds(5, "cpu")
    slot = seeds.next()[2]
    got = call(0.1, slot)
    assert torch.equal(got, call(0.1, int(slot)))
    assert not torch.equal(got, call(0.1, seeds.next()[2]))
    assert not torch.equal(got, call(0.0, 0))


def test_train_steps_draw_new_masks_and_resume_the_counter(tmp_path):
    """Two steps at dropout 0.1 from the same weights and batch draw other
    masks (their losses differ); a resumed Trainer's counter starts at the
    checkpoint's step."""
    jcfg = small_cfg(tmp_path, **{**TWO_BUCKETS, "dropout": 0.1})
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"))
    trainer = loop.Trainer(cfg, "cpu")
    batch = next(iter(trainer._pipeline(
        SyntheticTVQADataset(cfg, 4, mode="train"), True, 4)))[0]
    sd = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    first = float(trainer.train_step(batch, True)["loss"])
    trainer.model.load_state_dict(sd)
    assert float(trainer.train_step(batch, True)["loss"]) != first
    assert int(trainer.seeds.step) == trainer.step == 2
    trainer.save(str(tmp_path / "c.ckpt"))
    resumed = loop.Trainer(dataclasses.replace(
        cfg, resume=str(tmp_path / "c.ckpt")), "cpu")
    assert resumed.step == 2 and int(resumed.seeds.step) == 2


# ------------------------------------------------------ capture-safe values
def test_device_tables_equal_the_host_ones():
    """The cached sinusoid table and merged zero mask hold the values the
    step built on the host before, once per shape."""
    pe = tl.PositionEncoding()
    for dt in (torch.float32, torch.bfloat16):
        t = pe.table(50, 128, "cpu", dt)
        assert torch.equal(t, tl.sinusoid_table(50, 128).to(dt))
        assert pe.table(50, 128, "cpu", dt) is t
    x = torch.randn(2, 3, 7, 16)
    assert torch.equal(pe(x), x + tl.sinusoid_table(7, 16))
    stage = STAGE(ModelConfig(hsz=16, bridge_hsz=12, embedding_size=24,
                              vfeat_size=12))
    streams = ((5, 40), (50, 50), (50, 25))
    zm = stage.merged_zero_mask(streams, torch.device("cpu"))
    lens = torch.cat([torch.full((g,), n) for g, n in streams])
    old = (torch.arange(50)[None, :] < lens[:, None]).float()
    assert torch.equal(zm, old) and zm.shape == (105, 50)
    assert stage.merged_zero_mask(streams, torch.device("cpu")) is zm
    # made under inference mode (a serve step), still a normal tensor that a
    # training step may save for its backward
    with torch.inference_mode():
        t = pe.table(9, 16, "cpu", torch.float32)
        zm = stage.merged_zero_mask(((2, 3), (4, 9)), torch.device("cpu"))
    assert not t.is_inference() and not zm.is_inference()


# -------------------------------------------------------------- optimizer
def test_adam_dispatch_mode_and_both_checkpoint_formats(tmp_path):
    """The CPU keeps torch's default Adam (float rate): the same updates as
    before.  ``set_lr`` fills a device rate in place.  A checkpoint saved in
    the cuda mode (capturable, tensor rate) and one in the parent's format
    both load on the CPU into the CPU mode and train on identically."""
    torch.manual_seed(0)
    w0 = torch.randn(5, 3)
    grads = [torch.randn(5, 3) for _ in range(3)]

    def run(opt_fn, steps):
        p = torch.nn.Parameter(w0.clone())
        opt = opt_fn([p])
        for g in grads[:steps]:
            p.grad = g.clone()
            opt.step()
        return p, opt
    plain = run(lambda ps: torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999),
                                            eps=1e-8, weight_decay=3e-7), 3)
    ours = run(lambda ps: state.make_optimizer(ps, 1e-3, 3e-7, "cpu"), 3)
    assert torch.equal(plain[0], ours[0])
    assert ours[1].param_groups[0]["capturable"] is False
    lr = torch.tensor(1e-3)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    opt.param_groups[0]["lr"] = lr
    state.set_lr(opt, 5e-4)
    assert opt.param_groups[0]["lr"] is lr
    assert float(lr) == float(torch.tensor(5e-4))

    # a cuda-mode state dict, as a card's checkpoint holds it
    p, opt = run(lambda ps: state.make_optimizer(ps, 1e-3, 3e-7, "cpu"), 2)
    sd = copy.deepcopy(opt.state_dict())
    sd["param_groups"][0].update(capturable=True, lr=torch.tensor(1e-3))
    for formatted in (copy.deepcopy(opt.state_dict()), sd):
        q = torch.nn.Parameter(p.detach().clone())
        opt2 = state.make_optimizer([q], 1e-3, 3e-7, "cpu")
        opt2.load_state_dict(formatted)
        state.dispatch_mode(opt2, "cpu")
        g = opt2.param_groups[0]
        assert g["capturable"] is False and isinstance(g["lr"], float)
        q.grad = grads[2].clone()
        opt2.step()
        assert torch.equal(q, plain[0])


# ------------------------------------------------------------------- auto K
def test_auto_steps_per_dispatch_matches_jax(tmp_path):
    jcfg = small_cfg(tmp_path, **TWO_BUCKETS)
    cfg = port_config(jcfg)
    for budget in (6 * 2 ** 30, 2 ** 20, 1):
        assert dispatch.auto_steps_per_dispatch(cfg, budget) \
            == jax_auto(jcfg, budget)
    from tvqaplus_tpu.config import Config as JaxConfig
    headline, jhead = Config(), JaxConfig()
    assert dispatch.auto_steps_per_dispatch(headline) == jax_auto(jhead)
    tr = loop.Trainer(port_config(small_cfg(tmp_path, steps_per_dispatch=0),
                                  results_dir=str(tmp_path / "a")), "cpu")
    assert tr.steps_per_dispatch == 16


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("train", [True, False])
def test_grouped_pipeline_matches_jax(tmp_path, train):
    """Same dispatches in the same order: K, bucket and the qids of each,
    shuffled (training) and in dataset order (evaluation)."""
    jcfg = small_cfg(tmp_path, **TWO_BUCKETS)
    cfg = port_config(jcfg)
    n = 40
    jds = JaxSynthetic(jcfg, n, mode="train" if train else "valid")
    ds = SyntheticTVQADataset(cfg, n, mode="train" if train else "valid")
    bsz = 4 if train else 2
    ref = [(b["ex_mask"].shape[0] if b["ex_mask"].ndim == 2 else 1, bucket,
            meta["qid"]) for b, meta, bucket in JaxPipeline(
        jds, jcfg, batch_size=bsz, shuffle=train, seed=jcfg.seed, group=2)]
    pipe = DataPipeline(ds, cfg, "cpu", batch_size=bsz, train=train,
                        seed=cfg.seed, group=2)
    got = [(dispatch.steps_in(b), bucket, meta["qid"])
           for b, meta, bucket in pipe]
    assert got == ref
    assert 2 in {k for k, _, _ in got}
    assert len({b for _, b, _ in got}) == 2
    assert sum(k for k, _, _ in got) <= len(pipe)
    batch = next(b for b, _, _ in pipe if dispatch.steps_in(b) == 2)
    one, two = dispatch.unstack(batch)
    assert all(torch.equal(one[k], v[0]) and torch.equal(two[k], v[1])
               for k, v in batch.items())


# ------------------------------------------------------ training and eval
class Recorder:
    """A logger that keeps every scalar (tag, step, value)."""

    def __init__(self):
        self.scalars, self.logs = [], {}

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, int(step), float(value)))

    def append_log(self, name, lines):
        self.logs[name] = list(lines)

    def export_scalars(self, *a, **kw):
        pass


def jax_and_port_trainers(tmp_path, **kw):
    jcfg = small_cfg(tmp_path, **{**TWO_BUCKETS, **kw})
    os.makedirs(jcfg.results_dir)
    os.makedirs(tmp_path / "port")
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    jrec, rec = Recorder(), Recorder()
    jt = JaxTrainer(jcfg, mesh=mesh, logger=jrec)
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"))
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.state.params), jcfg))
    return jcfg, jt, jrec, cfg, loop.Trainer(cfg, "cpu", logger=rec,
                                             model=model), rec


def test_train_epoch_with_steps_per_dispatch_matches_jax(tmp_path):
    """One epoch at steps_per_dispatch 2, log_freq 2, with validation
    (eval_steps_per_dispatch 4), hard negatives (no sampling), dropout 0:
    the same optimizer steps, the same log points and valid-acc log, every
    logged scalar at 1e-4 relative (float32 sums in another order, PR 2's
    loss bar), and PR 2's parameter bar, 2e-6, after the epoch where JAX's
    parameter moved by at least half of steps x lr: there every step's
    gradient dominated its rounding, as PR 2's one-step mask |g| > 1e-3
    asks (Adam turns a gradient at rounding level into a step of up to lr
    of either sign; measured: 36% of the elements, largest error
    9.5e-7)."""
    jcfg, jt, jrec, cfg, ours, rec = jax_and_port_trainers(
        tmp_path, steps_per_dispatch=2, log_freq=2)
    before = {k: p.detach().clone() for k, p in
              ours.model.named_parameters()}
    train_j, valid_j = (JaxSynthetic(jcfg, 24, mode="train"),
                        JaxSynthetic(jcfg, 20, mode="valid"))
    train_t, valid_t = (SyntheticTVQADataset(cfg, 24, mode="train"),
                        SyntheticTVQADataset(cfg, 20, mode="valid"))
    jt.train_epoch(train_j, 0, use_hard_negatives=True,
                   valid_dataset=valid_j)
    ours.train_epoch(train_t, 0, use_hard_negatives=True,
                     valid_dataset=valid_t)
    assert ours.step == int(jt.state.step) > 6
    assert [(t, s) for t, s, _ in rec.scalars] \
        == [(t, s) for t, s, _ in jrec.scalars]
    assert {t for t, _, _ in rec.scalars} >= {"Train/Loss", "Valid/Acc"}
    np.testing.assert_allclose([v for _, _, v in rec.scalars],
                               [v for _, _, v in jrec.scalars], rtol=1e-4,
                               atol=1e-6)
    assert rec.logs["valid_acc.log"] == jrec.logs["valid_acc.log"]
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jt.state.params), jcfg)
    held = 0
    for name, p in ours.model.named_parameters():
        moved = (want[name] - before[name]).abs() >= 0.5 * ours.step * cfg.lr
        held += int(moved.sum())
        np.testing.assert_allclose(p.detach()[moved].numpy(),
                                   want[name][moved].numpy(), rtol=0,
                                   atol=2e-6, err_msg=name)
    assert held > 1000


def test_validate_with_eval_steps_per_dispatch_matches_jax(tmp_path):
    """validate at eval_steps_per_dispatch 4 (stacks and single leftovers
    over two buckets): the same qid_corrects in the same order, acc and
    loss at 1e-5 relative; a debug pass dispatches one batch at a time."""
    jcfg, jt, _, cfg, ours, _ = jax_and_port_trainers(tmp_path)
    jds, ds = (JaxSynthetic(jcfg, 40, mode="valid"),
               SyntheticTVQADataset(cfg, 40, mode="valid"))
    ref = jt.validate(jds)
    got = ours.validate(ds)
    assert got[2] == ref[2] and len(got[2]) == 40
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-5)
    calls = []
    real = ours.dispatch_eval
    ours.dispatch_eval = lambda b: calls.append(dispatch.steps_in(b)) or \
        real(b)
    ours.validate(ds, max_batches=3)
    assert calls == [1, 1, 1]


def test_inference_with_eval_steps_per_dispatch_matches_jax(tmp_path):
    """InferenceRunner.run at eval_steps_per_dispatch 4 over two buckets:
    the prediction JSON of the JAX runner from the same weights (answers and
    spans equal, grounding records in the same order, scores to the JAX
    floats' printing as test_torch_infer.py holds them)."""
    jcfg, jt, _, cfg, ours, _ = jax_and_port_trainers(tmp_path)
    assert cfg.eval_steps_per_dispatch == 4
    ref = JaxRunner(jcfg, jt.model, jt.state.params).run(
        JaxSynthetic(jcfg, 42, mode="valid"), mode="valid",
        object_word_ids=OBJECT_WORDS)
    runner = InferenceRunner(cfg, ours.model, "cpu")
    ks = []
    real = runner.dispatch_infer
    runner.dispatch_infer = lambda b, *a: ks.append(
        dispatch.steps_in(b)) or real(b, *a)
    got = runner.run(SyntheticTVQADataset(cfg, 42, mode="valid"),
                     mode="valid", object_word_ids=OBJECT_WORDS)
    assert 4 in ks and 1 in ks and sum(ks) == 21
    assert got["ts_answer"] == ref["ts_answer"]
    assert len(ref["raw_bbox"]) == 42
    assert json.dumps(_adopt_ref_floats(got["raw_bbox"], ref["raw_bbox"])) \
        == json.dumps(ref["raw_bbox"])


def test_a_dispatch_longer_than_log_freq_is_refused(tmp_path):
    jcfg = small_cfg(tmp_path, **TWO_BUCKETS)
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"),
                      steps_per_dispatch=3, log_freq=2)
    trainer = loop.Trainer(cfg, "cpu")
    with pytest.raises(ValueError, match="longer than log_freq"):
        trainer.train_epoch(SyntheticTVQADataset(cfg, 24, mode="train"), 0,
                            use_hard_negatives=True)
