"""The PyTorch port's serving path against the JAX package: span search,
synthetic data, static-shape collate, the InferenceRunner's prediction
JSON from the same weights, and the ``python -m
tvqaplus_tpu_torch.inference`` entry point."""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_inference_json_parity import _adopt_ref_floats
from tvqaplus_tpu.config import Config as JaxConfig
from tvqaplus_tpu.data import batching as jbatch
from tvqaplus_tpu.data.pipeline import DataPipeline as JaxPipeline
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.infer.predict import InferenceRunner as JaxRunner
from tvqaplus_tpu.models import spans as jspans
from tvqaplus_tpu.models.stage import STAGE as JaxSTAGE
from tvqaplus_tpu.models.stage import ModelConfig as JaxModelConfig
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data import batching as tbatch
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.infer.predict import InferenceRunner, spans_to_seconds
from tvqaplus_tpu_torch.interop.weights import params_from_flax
from tvqaplus_tpu_torch.models import spans as tspans
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(bsz=4, test_bsz=4, hsz=16, embedding_size=24, vfeat_size=12,
            max_qa_l=10, max_sub_l=8, max_num_img=6, num_region=5,
            img_buckets=[6], max_q_l=4, max_a_l=4, add_local=True,
            synthetic_data=True)
OBJECT_WORDS = list(range(3, 1000, 7))


# --------------------------------------------------------------------- spans
def span_probs(seed):
    rng = np.random.default_rng(seed)
    p = rng.random((3, 5, 9)).astype(np.float32)
    p[0, 0] = 0.25                       # ties everywhere
    p[0, 1, 4:] = p[0, 1, 3]             # a tied plateau after a peak
    p[1, 2] = 0.0                        # nothing above 0: default (0, 1)
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_find_max_pair_matches_jax(seed):
    p1, p2 = span_probs(seed), span_probs(seed + 10)
    ref = jspans.find_max_pair(jnp.asarray(p1), jnp.asarray(p2))
    got = tspans.find_max_pair(torch.from_numpy(p1), torch.from_numpy(p2))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_eval_proposals_and_window_mask_match_jax():
    rng = np.random.default_rng(2)
    t = rng.standard_normal((3, 5, 9, 2)).astype(np.float32)
    t[0, 0] = 0.0                        # tied scores: first index wins
    t[1, :, 6:] = -1e10                  # masked frames
    st, ed = jspans.eval_proposals(jnp.asarray(t), None)
    gst, ged = tspans.eval_proposals(torch.from_numpy(t))
    np.testing.assert_array_equal(gst.numpy(), np.asarray(st))
    np.testing.assert_array_equal(ged.numpy(), np.asarray(ed))
    ref = jspans.expand_window_mask(st, ed, 9, extra=3)
    got = tspans.expand_window_mask(gst, ged, 9, extra=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_spans_to_seconds_reference_math():
    assert spans_to_seconds(0, 0, first_img_id=3) == [1.0, 3.0]
    assert spans_to_seconds(2, 4, first_img_id=6) == [4.0, 10.0]
    assert spans_to_seconds(0, 0, 1, py2_offset_div=True) == [0, 2]
    assert spans_to_seconds(0, 1, 4, frame_interval=3) == [1 / 3, 2 + 1 / 3]


# ---------------------------------------------------------- data and collate
def configs(**kw):
    jcfg = JaxConfig(**{**TINY, **kw})
    jcfg.finalize(save=False)
    return jcfg, Config(**{**TINY, **kw}).finalize("cpu")


@pytest.mark.parametrize("sub_dedup", [True, False])
def test_synthetic_examples_and_collate_match_jax(sub_dedup):
    jcfg, cfg = configs(sub_dedup=sub_dedup, max_sub_tokens=64)
    jds, ds = JaxSynthetic(jcfg, 6, mode="valid"), \
        SyntheticTVQADataset(cfg, 6, mode="valid")
    jex, ex = [jds[i] for i in range(6)], [ds[i] for i in range(6)]
    for a, b in zip(jex, ex):
        assert a["qas"] == b["qas"] and a["boxes"] == b["boxes"]
        np.testing.assert_array_equal(a["sub_tokens"], b["sub_tokens"])
    spec_j = jbatch.StaticShapeSpec.from_config(jcfg, batch=8)
    spec_t = tbatch.StaticShapeSpec.from_config(cfg, batch=8)
    ref, jmeta = jbatch.collate_static(jex, spec_j, skip_att=True)
    got, meta = tbatch.collate_static(ex, spec_t)
    assert set(got) == set(ref) - set(jbatch.ATT_KEYS)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    for k in ("qid", "vid_name", "image_indices", "boxes", "anno_st"):
        assert meta[k] == jmeta[k], k


# --------------------------------------------------------------- inference
def jax_params_and_state_dict(jcfg, seed=0):
    model = JaxSTAGE(JaxModelConfig.from_config(jcfg))
    batch = next(iter(JaxPipeline(JaxSynthetic(jcfg, 4, mode="valid"),
                                  jcfg, batch_size=jcfg.test_bsz)))[0]
    params = model.init({"params": jax.random.PRNGKey(seed)}, batch,
                        train=False)["params"]
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params), jcfg)
    return model, params, sd


def test_inference_runner_matches_jax():
    jcfg, cfg = configs()
    jmodel, params, sd = jax_params_and_state_dict(jcfg)
    ref = JaxRunner(jcfg, jmodel, params).run(
        JaxSynthetic(jcfg, 10, mode="valid"), mode="valid",
        object_word_ids=OBJECT_WORDS)
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(sd, strict=True)
    ours = InferenceRunner(cfg, model, "cpu").run(
        SyntheticTVQADataset(cfg, 10, mode="valid"), mode="valid",
        object_word_ids=OBJECT_WORDS)
    assert ours["ts_answer"] == ref["ts_answer"]
    assert len(ref["raw_bbox"]) == 10
    assert sum(len(r) for q in ref["raw_bbox"] for r in q.values()) > 0
    assert json.dumps(_adopt_ref_floats(ours["raw_bbox"], ref["raw_bbox"])) \
        == json.dumps(ref["raw_bbox"])


def test_inference_cli_writes_predictions(tmp_path):
    cfg = Config(**TINY, synthetic_n_valid=6)
    cfg.save(str(tmp_path / "opt.json"))
    cfg.finalize("cpu")
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "best_valid.pth")
    proc = subprocess.run(
        [sys.executable, "-m", "tvqaplus_tpu_torch.inference",
         "--model_dir", str(tmp_path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / "valid_inference_predictions.json") as f:
        written = json.load(f)
    expect = InferenceRunner(cfg, model, "cpu").run(
        SyntheticTVQADataset(cfg, 6, mode="valid"), mode="valid",
        object_word_ids=list(range(3, 1000)))
    assert written == json.loads(json.dumps(expect))
    assert sorted(written["ts_answer"]) == [str(i) for i in range(6)]


def test_config_reads_a_jax_opt_json(tmp_path):
    """Same field names: a JAX run's opt.json overrides every port field it
    names, and the port's device policy then resolves what is left."""
    jcfg = JaxConfig(**{**TINY, "compute_dtype": "auto"})
    jcfg.save(str(tmp_path / "opt.json"))
    jax_names = {f.name for f in dataclasses.fields(JaxConfig)}
    port_names = {f.name for f in dataclasses.fields(Config)}
    assert port_names - jax_names == {"use_kernels"}
    assert jax_names <= port_names
    cfg = Config().override_from(str(tmp_path / "opt.json"))
    for name in jax_names - {"no_core_driver", "h5driver", "debug"}:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    cfg.resolve_device_policy("cpu")
    assert cfg.compute_dtype == "float32" and cfg.use_kernels is False
    assert Config().finalize("cuda").compute_dtype == "bfloat16"


def test_debug_run_stops_after_one_batch_and_its_loader():
    _, cfg = configs()
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(1))
    before = threading.active_count()
    pred = InferenceRunner(cfg, model, "cpu").run(
        SyntheticTVQADataset(cfg, 10, mode="valid"), mode="valid",
        object_word_ids=OBJECT_WORDS, debug=True)
    assert sorted(pred["ts_answer"]) == ["0", "1", "2", "3"]
    for _ in range(100):             # the producer thread has ended
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


# ------------------------------------------------ which checkpoint is served
def write_run(run_dir, best_seed=0, last_seed=1):
    """A run directory as the trainer leaves it: opt.json, best_valid.pth
    (weights from ``best_seed``, none when it is None) and last.ckpt (model
    and optimizer, weights from ``last_seed``).  Returns the config and the
    two models."""
    from tvqaplus_tpu_torch.train.state import make_optimizer, save_checkpoint
    os.makedirs(run_dir, exist_ok=True)
    cfg = Config(**TINY, synthetic_n_valid=6)
    cfg.save(os.path.join(run_dir, "opt.json"))
    cfg.finalize("cpu")
    models = {}
    for name, seed in (("best", best_seed), ("last", last_seed)):
        models[name] = None if seed is None else STAGE(
            ModelConfig.from_config(cfg)).reset_parameters(
            torch.Generator().manual_seed(seed))
    if models["best"] is not None:
        torch.save(models["best"].state_dict(),
                   os.path.join(run_dir, "best_valid.pth"))
    last = models["last"]
    save_checkpoint(os.path.join(run_dir, "last.ckpt"), last,
                    make_optimizer(last.parameters(), 1e-3), 7,
                    extra={"best_acc": 0.0, "epoch": 0, "lr": 1e-3})
    return cfg, models


def served(cfg, model):
    """The prediction JSON the CLI writes for ``model``, as it reads back."""
    pred = InferenceRunner(cfg, model, "cpu").run(
        SyntheticTVQADataset(cfg, 6, mode="valid"), mode="valid",
        object_word_ids=list(range(3, 1000)))
    return json.loads(json.dumps(pred))


def cli(*argv):
    from tvqaplus_tpu_torch.inference import main_inference
    with open(main_inference([*argv, "--device", "cpu"])) as f:
        return json.load(f)


@pytest.mark.parametrize("name,which", [("last.ckpt", "last"),
                                        ("best_valid.pth", "best")])
def test_inference_cli_serves_the_checkpoint_it_names(tmp_path, name, which):
    cfg, models = write_run(str(tmp_path))
    got = cli("--model_dir", str(tmp_path), "--checkpoint", name)
    assert got == served(cfg, models[which])
    assert got != served(cfg, models["best" if which == "last" else "last"])


def test_inference_cli_takes_an_absolute_checkpoint_path(tmp_path):
    cfg, models = write_run(str(tmp_path / "run"))
    got = cli("--model_dir", str(tmp_path / "run"), "--checkpoint",
              str(tmp_path / "run" / "last.ckpt"))
    assert got == served(cfg, models["last"])


def test_inference_cli_falls_back_to_last_ckpt_and_warns(tmp_path):
    """A run whose validation never improved wrote no best_valid.pth: the
    CLI, run as a user runs it, serves the end-of-training state."""
    cfg, models = write_run(str(tmp_path), best_seed=None)
    proc = subprocess.run(
        [sys.executable, "-m", "tvqaplus_tpu_torch.inference",
         "--model_dir", str(tmp_path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"warning: {tmp_path / 'best_valid.pth'} missing, using " \
           f"{tmp_path / 'last.ckpt'}" in proc.stdout
    with open(tmp_path / "valid_inference_predictions.json") as f:
        assert json.load(f) == served(cfg, models["last"])


def test_inference_cli_resolves_a_run_name_under_results(tmp_path,
                                                         monkeypatch):
    cfg, models = write_run(str(tmp_path / "results" / "my_run"))
    monkeypatch.chdir(tmp_path)
    got = cli("--model_dir", "my_run")
    assert got == served(cfg, models["best"])
    assert os.path.exists(tmp_path / "results" / "my_run"
                          / "valid_inference_predictions.json")


def test_last_ckpt_serves_what_best_valid_pth_of_the_same_weights_does(
        tmp_path):
    cfg, models = write_run(str(tmp_path), best_seed=3, last_seed=3)
    from_best = cli("--model_dir", str(tmp_path))
    from_last = cli("--model_dir", str(tmp_path), "--checkpoint", "last.ckpt")
    assert from_last == from_best == served(cfg, models["last"])
