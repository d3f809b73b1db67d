"""The port's training path against the JAX package: one train step of the
port's Trainer against the JAX Trainer's step (same weights, same batch;
the JAX side on its fused Pallas kernels and their backward kernels in
interpret mode), the optimizer chain and the plateau schedule, and the
``python -m tvqaplus_tpu_torch.main`` entry point."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_train import small_cfg
from tvqaplus_tpu.data.pipeline import DataPipeline as JaxPipeline
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.models import losses as jlosses
from tvqaplus_tpu.models.stage import STAGE as JaxSTAGE
from tvqaplus_tpu.models.stage import ModelConfig as JaxModelConfig
from tvqaplus_tpu.train.state import PlateauScheduler as JaxPlateau
from tvqaplus_tpu.train.state import make_optimizer as jax_optimizer
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.interop.weights import params_from_flax
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
from tvqaplus_tpu_torch.train import loop, state

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_CFG = dict(use_sup_att=True, add_local=True, dropout=0.0,
                use_pallas=True, compute_dtype="float32", seed=3)
TINY_FLAGS = ["--bsz", "4", "--test_bsz", "4", "--hsz", "16",
              "--embedding_size", "24", "--vfeat_size", "12", "--max_qa_l",
              "10", "--max_sub_l", "8", "--max_num_img", "6", "--num_region",
              "5", "--img_buckets", "6", "--max_q_l", "4", "--max_a_l", "4",
              "--use_sup_att", "--add_local", "--synthetic_data",
              "--synthetic_n_valid", "4"]


def port_config(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(Config)} - {"use_kernels"}
    cfg = Config(**{n: getattr(jcfg, n) for n in names})
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg.resolve_device_policy("cpu")


def check_train_step_against_jax(tmp_path, edit_batch=None, **cfg_kw):
    """The JAX Trainer's step body (loop.py:149-172: value_and_grad of
    total_loss through model.apply(train=True), then its optax chain), with
    hard negatives (no sampling noise), dropout 0, float32.  Loss and
    metrics at 1e-4 relative, grads at rtol 1e-3 / atol 1e-5 (f32 sums over
    ~10 layers in another order), grad_norm at 1e-4.  Adam's first step
    moves a parameter by about lr * sign(g), so the updated parameters are
    compared where |g| > 1e-3, far above the gradient tolerance, at 2e-6.
    ``edit_batch`` changes the collated batch (a dict of arrays) before
    both steps take it."""
    jcfg = small_cfg(tmp_path, **dict(STEP_CFG, **cfg_kw))
    model_cfg = JaxModelConfig.from_config(jcfg)
    jmodel = JaxSTAGE(model_cfg)
    batch = next(iter(JaxPipeline(JaxSynthetic(jcfg, 4, mode="train"), jcfg,
                                  batch_size=4)))[0]
    if edit_batch is not None:
        batch = edit_batch(batch)
    params = JaxSTAGE(dataclasses.replace(model_cfg, use_pallas=False)).init(
        {"params": jax.random.PRNGKey(jcfg.seed)}, batch,
        train=False)["params"]
    tx = jax_optimizer(jcfg.lr, jcfg.wd, jcfg.clip)
    loss_kwargs = dict(
        att_weight=jcfg.att_weight, ts_weight=jcfg.ts_weight,
        use_sup_att=jcfg.use_sup_att, num_negatives=jcfg.num_negatives,
        att_loss_type=jcfg.att_loss_type, margin=jcfg.margin,
        alpha=jcfg.alpha, drop_topk=jcfg.drop_topk,
        negative_pool_size=jcfg.negative_pool_size, num_hard=jcfg.num_hard,
        entry_cap=jcfg.att_entry_cap, vfeat_flag=jcfg.vfeat_flag)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, train=True,
                           need_sub_raw=False, need_vid_raw="target",
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jlosses.total_loss(out, batch, jax.random.PRNGKey(0),
                                  train=True, use_hard_negatives=True,
                                  **loss_kwargs)

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    sd0 = params_from_flax(to_np(params), jcfg)
    g_ref = params_from_flax(to_np(grads), jcfg)
    p_ref = params_from_flax(to_np(new_params), jcfg)
    norm_ref = float(optax.global_norm(grads))

    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"))
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(sd0, strict=True)
    ours = loop.Trainer(cfg, "cpu", model=model)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    metrics = ours.train_step(tb, use_hard_negatives=True)
    for k in ("loss", "loss_cls", "loss_ts", "loss_att", "n_correct",
              "n_eff", "att_n_pairs", "att_n_pos_dropped"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(ref["att_n_pairs"]) > 0
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm_ref,
                               rtol=1e-4)
    scale = min(1.0, jcfg.clip / norm_ref)
    named = dict(model.named_parameters())
    assert set(named) == set(g_ref)
    for name, p in named.items():
        g = g_ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g * scale, rtol=1e-3,
                                   atol=1e-5, err_msg=name)
        big = np.abs(g) > 1e-3
        np.testing.assert_allclose(p.detach().numpy()[big],
                                   p_ref[name].numpy()[big], rtol=0,
                                   atol=2e-6, err_msg=name)
    return model


def test_one_train_step_matches_the_jax_trainer(tmp_path):
    check_train_step_against_jax(tmp_path)


def test_clip_and_adam_match_the_optax_chain():
    """clip_by_global_norm(1) -> coupled L2 -> Adam over five steps on a
    toy quadratic, with the norm above and below the clip.  Parameters at
    1e-5: torch's Adam divides by sqrt(v) / sqrt(1 - b2^t) where optax takes
    sqrt(v / (1 - b2^t)), one rounding apart per step."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(6).astype(np.float32)
    tx = jax_optimizer(0.1, 1e-2, 1.0)
    jw, opt = jnp.asarray(w0), None
    opt = tx.init(jw)
    tw = torch.tensor(w0, requires_grad=True)
    adam = state.make_optimizer([tw], 0.1, 1e-2)
    for step in range(5):
        k = 3.0 if step < 2 else 0.05    # norm above, then below the clip
        g = jnp.asarray(k * np.cos(np.arange(6) + step), jnp.float32) * jw
        upd, opt = tx.update(g, opt, jw)
        jw = jw + upd
        tw.grad = torch.from_numpy(np.array(g))
        norm = state.clip_grad_norm([tw], 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        adam.step()
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                                   rtol=1e-5, atol=1e-5)


def test_plateau_scheduler_matches_jax():
    seq = [0.5, 0.5, 0.5, 0.5, 0.9, 0.9000001, 0.2, 0.2, 0.2, 0.95, 0.1]
    ref, ours = JaxPlateau(1.0, patience=2), state.PlateauScheduler(
        1.0, patience=2)
    assert [ours.step(m) for m in seq] == [ref.step(m) for m in seq]
    assert loop.log_crossing(0, 1, 4) == (True, 0)
    assert loop.log_crossing(3, 4, 4) == (False, 0)
    assert loop.log_crossing(4, 5, 4) == (True, 4)


def run_main(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "tvqaplus_tpu_torch.main",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_main_trains_and_the_inference_cli_reads_its_run(tmp_path):
    proc = run_main(TINY_FLAGS + ["--debug", "--device", "cpu",
                                  "--results_dir_base",
                                  str(tmp_path / "results")], tmp_path)
    assert proc.returncode == 0, proc.stderr
    (run,) = [p for p in tmp_path.iterdir() if p.name.startswith(
        "debug_results")]
    with open(run / "opt.json") as f:
        opt = json.load(f)
    assert opt["use_sup_att"] and opt["compute_dtype"] == "float32"
    for name in ("best_valid.pth", "last.ckpt", "scalars.jsonl",
                 "valid_acc.log"):
        assert (run / name).exists(), name
    proc = subprocess.run(
        [sys.executable, "-m", "tvqaplus_tpu_torch.inference", "--model_dir",
         str(run), "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(run / "valid_inference_predictions.json") as f:
        assert len(json.load(f)["ts_answer"]) == 4


def test_main_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    proc = run_main(TINY_FLAGS + ["--debug", "--results_dir_base",
                                  str(tmp_path / "results")], tmp_path)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_nonfinite_loss_halts_with_a_crash_checkpoint(tmp_path):
    jcfg = small_cfg(tmp_path, log_freq=2, n_epoch=1)
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"))
    trainer = loop.Trainer(cfg, "cpu")
    real = trainer.train_step

    def poisoned(batch, use_hard_negatives=False):
        metrics = real(batch, use_hard_negatives)
        metrics["loss"] = metrics["loss"] * float("nan")
        return metrics

    trainer.train_step = poisoned
    ds = SyntheticTVQADataset(cfg, 16, mode="train")
    vds = SyntheticTVQADataset(cfg, 4, mode="valid")
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train_epoch(ds, epoch=0, valid_dataset=vds)
    crash = os.path.join(cfg.results_dir, "crash_state.ckpt")
    step, extra = state.load_checkpoint(crash, trainer.model,
                                        trainer.optimizer)
    # batch 0 opens the log (log point 0, no window yet); batch 2 closes the
    # window of batches 1-2 at log point 2, after the third step
    assert step == 3 and extra["epoch"] == 0


def test_shuffled_pipeline_batches_by_bucket_once_per_epoch(tmp_path):
    """Training iteration (data/pipeline.py): every example exactly once
    per epoch, each batch in the smallest bucket that fits all its members,
    a new order each epoch, and the att-entry keys in every batch."""
    from tvqaplus_tpu_torch.data.batching import ATT_KEYS, pick_bucket
    from tvqaplus_tpu_torch.data.pipeline import DataPipeline
    jcfg = small_cfg(tmp_path, max_num_img=8, img_buckets=[4, 6, 8],
                     use_sup_att=True)
    cfg = port_config(jcfg)
    ds = SyntheticTVQADataset(cfg, 32, mode="train")
    by_qid = {ds[i]["qid"]: pick_bucket(len(ds[i]["image_indices"]),
                                        [4, 6, 8], 8) for i in range(32)}
    assert len(set(by_qid.values())) > 1
    pipe = DataPipeline(ds, cfg, "cpu", batch_size=4, train=True, seed=1)
    orders = []
    for _ in range(2):
        seen = []
        for batch, meta, bucket in pipe:
            assert set(ATT_KEYS) <= set(batch)
            assert batch["vid"].shape[1] == bucket
            n = int(batch["ex_mask"].sum())
            for qid in meta["qid"][:n]:
                assert by_qid[qid] == bucket
                seen.append(qid)
        assert sorted(seen) == sorted(by_qid)
        orders.append(seen)
    assert orders[0] != orders[1]
