"""The PyTorch port end to end on TVQA+-format artifacts, on the CPU: its
prediction JSON against the JAX package's from the same weights, and the
quality bars of ``tests/test_ref_evaluator_e2e.py`` through the port's own
CLIs and evaluator."""
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import torch

from tests.test_inference_json_parity import _adopt_ref_floats
from tvqaplus_tpu.config import Config as JaxConfig
from tvqaplus_tpu.data.fixtures import write_artifacts as jax_write_artifacts
from tvqaplus_tpu.data.pipeline import DataPipeline as JaxPipeline
from tvqaplus_tpu.data.tvqa import TVQAPlusDataset as JaxTVQAPlusDataset
from tvqaplus_tpu.evaluation.tvqa_metrics import \
    evaluate_tvqa_plus as jax_evaluate
from tvqaplus_tpu.infer.predict import InferenceRunner as JaxRunner
from tvqaplus_tpu.models.stage import STAGE as JaxSTAGE
from tvqaplus_tpu.models.stage import ModelConfig as JaxModelConfig
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data.fixtures import gt_as_prediction, write_artifacts
from tvqaplus_tpu_torch.data.pipeline import DataPipeline
from tvqaplus_tpu_torch.data.tvqa import TVQAPlusDataset
from tvqaplus_tpu_torch.evaluation.tvqa_metrics import evaluate_tvqa_plus
from tvqaplus_tpu_torch.infer.predict import InferenceRunner
from tvqaplus_tpu_torch.interop.weights import params_from_flax
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE = ("qa_acc", "overall_map", "miou", "ans_span_joint_acc@.5")


def region_less_frames_in_span(dataset, cfg):
    """Frames inside ``ts_mask`` with no detected region, over the port's
    collate of the split: the frames where the two packages' masked max
    differ (fault C2, pinned in test_torch_stage.py)."""
    n = 0
    for batch, _, _ in DataPipeline(dataset, cfg, "cpu",
                                    batch_size=cfg.test_bsz):
        empty = batch["vid_mask"].sum(-1) == 0
        n += int((empty & (batch["ts_mask"] > 0)).sum())
    return n


def test_prediction_json_matches_jax_on_fixture_artifacts(tmp_path):
    paths = jax_write_artifacts(str(tmp_path / "artifacts"), n_videos=8,
                                qa_per_video=3, frames_per_video=42,
                                bert_dim=24, vfeat_dim=12, num_region=5,
                                seed=1, split="overlap")
    fields = dict(paths, embedding_size=24, vfeat_size=12, num_region=5,
                  hsz=16, bsz=4, test_bsz=4, add_local=True,
                  no_core_driver=True)
    jcfg = JaxConfig(**fields)
    jcfg.finalize(save=False)
    cfg = Config(**fields).finalize("cpu")
    jds = JaxTVQAPlusDataset(jcfg, mode="valid")
    ds = TVQAPlusDataset(cfg, mode="valid")
    assert ds.eval_object_word_ids == jds.eval_object_word_ids
    assert len(ds) == 6

    jmodel = JaxSTAGE(JaxModelConfig.from_config(jcfg))
    batch = next(iter(JaxPipeline(jds, jcfg, batch_size=jcfg.test_bsz)))[0]
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, batch,
                         train=False)["params"]
    ref = JaxRunner(jcfg, jmodel, params).run(
        jds, mode="valid", object_word_ids=jds.eval_object_word_ids)
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), jcfg),
        strict=True)
    ours = InferenceRunner(cfg, model, "cpu").run(
        ds, mode="valid", object_word_ids=ds.eval_object_word_ids)

    assert ours["ts_answer"] == ref["ts_answer"]
    assert len(ref["ts_answer"]) == 6
    assert sum(len(r) for q in ref["raw_bbox"] for r in q.values()) > 0
    assert json.dumps(_adopt_ref_floats(ours["raw_bbox"], ref["raw_bbox"])) \
        == json.dumps(ref["raw_bbox"])
    assert region_less_frames_in_span(ds, cfg) == 0


def run_cli(module, flags):
    """``python -m <module> <flags>`` as a user runs it on the CPU."""
    env = dict(os.environ, OMP_NUM_THREADS="4")
    r = subprocess.run([sys.executable, "-m", module] + flags, env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"{module} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def test_port_clis_train_serve_and_score_fixture_artifacts(tmp_path):
    """tests/test_ref_evaluator_e2e.py's fixture, flags and bars, through
    ``python -m tvqaplus_tpu_torch.main`` / ``.inference`` and the port's
    evaluator, which must also equal the JAX package's evaluator."""
    paths = write_artifacts(str(tmp_path / "artifacts"), n_videos=12,
                            qa_per_video=2, frames_per_video=42,
                            bert_dim=64, vfeat_dim=32, num_region=5,
                            split="overlap")
    gt_pred = gt_as_prediction(paths["valid_path"],
                               str(tmp_path / "gt_as_pred.json"))
    chk = evaluate_tvqa_plus(gt_pred, paths["valid_path"],
                             paths["word2idx_path"], no_preproc_pred=True)
    assert all(chk[k] == 1.0 for k in HEADLINE), chk

    flags = [f"--{k}={v}" for k, v in paths.items()] + [
        "--embedding_size=64", "--vfeat_size=32", "--num_region=5",
        "--hsz=32", "--n_epoch=50", "--max_es_cnt=40", "--log_freq=6",
        "--bsz=4", "--test_bsz=4", "--use_sup_att", "--add_local",
        "--no_core_driver", "--results_dir_base", str(tmp_path / "run"),
        "--device", "cpu"]
    out = run_cli("tvqaplus_tpu_torch.main", flags)
    m_dir = re.search(r"Results dir: (\S+)", out)
    assert m_dir, f"no results dir printed:\n{out[-2000:]}"
    results_dir = m_dir.group(1)
    run_cli("tvqaplus_tpu_torch.inference",
            flags + ["--model_dir", results_dir, "--mode", "valid",
                     "--checkpoint", "last.ckpt"])
    pred_path = os.path.join(results_dir, "valid_inference_predictions.json")

    m = evaluate_tvqa_plus(pred_path, paths["valid_path"],
                           paths["word2idx_path"])
    ref = jax_evaluate(pred_path, paths["valid_path"],
                       paths["word2idx_path"])
    assert list(m) == list(ref)
    np.testing.assert_equal(m, ref)
    assert all(0.0 <= m[k] <= 1.0 for k in HEADLINE), m
    assert m["qa_acc"] >= 0.75, f"planted QA signal not learned: {m}"
    assert m["miou"] >= 0.5, f"temporal span signal not learned: {m}"
    assert m["overall_map"] >= 0.7, f"grounding signal not learned: {m}"
    assert m["ans_span_joint_acc@.5"] >= 0.4, \
        f"answer-span joint accuracy regressed: {m}"
