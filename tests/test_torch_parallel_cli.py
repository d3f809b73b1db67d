"""The port's runs on a mesh end to end on the CPU (gloo): the trainer's
``fit`` and the serving runner at 2 ranks against one process, on the data
axis and (serving) on the ctx and model axes, and both CLIs under
``torch.distributed.run`` (``torchrun``) on each axis.  Rank 0 alone
writes a run's files; validation and the prediction JSON are the single
process's, in its order.  Tiny configs from numpy-seeded synthetic data;
each tolerance is stated at its use."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.test_inference_json_parity import _adopt_ref_floats
from tests.test_torch_parallel import port_setup
from tests.test_torch_train import REPO, STEP_CFG, TINY_FLAGS, port_config
from tests.test_train import small_cfg
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.infer.predict import InferenceRunner as JaxRunner
from tvqaplus_tpu.models.stage import STAGE as JaxSTAGE
from tvqaplus_tpu.models.stage import ModelConfig as JaxModelConfig
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.infer.predict import InferenceRunner
from tvqaplus_tpu_torch.inference import main_inference
from tvqaplus_tpu_torch.interop.weights import flax_from_params
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig

torch.set_num_threads(1)
OBJECT_WORDS = list(range(3, 1000, 7))


def test_two_ranks_fit_and_validate_as_one_process(tmp_path):
    """``Trainer.fit`` (two epochs, validation at every second step,
    best-model saving, plateau LR) at 2 ranks x 4 rows against one process
    x 8, dropout 0: validation accuracy and ``qid_corrects`` (global row
    order, a partial last batch) equal, the logged training losses at 1e-5
    relative, the ranks' parameters equal bit for bit.  Rank 1 writes no
    file; rank 0 writes the files one process writes, and a resume from its
    last.ckpt gives both ranks its state."""
    cfg, sd = port_setup(tmp_path, dropout=0.0, log_freq=2, n_epoch=2,
                         test_bsz=8)
    cfg.results_dir = str(tmp_path / "ranks")
    job = {"cfg": cfg, "sd": sd, "n_train": 32, "n_valid": 12}
    path = str(tmp_path / "job")
    torch.save(job, path)
    out = ranks.run_ranks(ranks.fit_rank, 2, path)
    cfg.results_dir = str(tmp_path / "single")
    torch.save(dict(job, cfg=cfg), path)
    single = ranks.fit_rank(0, path)
    for o in out:
        assert o["acc"] == single["acc"] and o["best"] == single["best"]
        assert o["qid_corrects"] == single["qid_corrects"]
        assert len(o["qid_corrects"]) == 12
        assert o["history"]["Valid/Acc"] == single["history"]["Valid/Acc"]
        np.testing.assert_allclose(
            [v for _, v in o["history"]["Train/Loss"]],
            [v for _, v in single["history"]["Train/Loss"]], rtol=1e-5)
        assert o["resumed"] and o["resumed_step"] == single["resumed_step"]
    for name, p in out[0]["params"].items():
        assert torch.equal(p, out[1]["params"][name]), name
    assert not os.path.exists(tmp_path / "ranks.rank1")
    def files(d):               # a TensorBoard file's name holds the time
        return sorted(f.split(".tfevents.")[0] for f in os.listdir(d))
    written = files(tmp_path / "ranks")
    assert written == files(tmp_path / "single")
    assert {"last.ckpt", "scalars.jsonl", "valid_acc.log"} <= set(written)


def test_two_ranks_serve_the_single_process_predictions(tmp_path):
    """``InferenceRunner.run`` at 2 ranks x 2 rows of every global batch of
    4 (two batches a dispatch; 13 examples, so the last batch leaves rank 1
    no row) against one process: answers and spans identical, in the same
    order; grounding records equal at 1e-4."""
    cfg, sd = port_setup(tmp_path, test_bsz=4, eval_steps_per_dispatch=2)
    job = {"cfg": cfg, "sd": sd, "n": 13, "words": OBJECT_WORDS}
    path = str(tmp_path / "job")
    torch.save(job, path)
    out = ranks.run_ranks(ranks.infer_rank, 2, path)
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(sd)
    want = InferenceRunner(cfg, model, "cpu").run(
        SyntheticTVQADataset(cfg, 13, mode="valid"),
        object_word_ids=OBJECT_WORDS)
    assert len(want["ts_answer"]) == 13 and want["raw_bbox"]
    for got in out:
        assert list(got["ts_answer"].items()) == \
            list(want["ts_answer"].items())
        assert json.dumps(_adopt_ref_floats(got["raw_bbox"],
                                            want["raw_bbox"])) \
            == json.dumps(want["raw_bbox"])


def same_json(got, want):
    """Answers and spans identical, in the same order; grounding records
    equal at 1e-4 (``_adopt_ref_floats``)."""
    assert list(got["ts_answer"].items()) == list(want["ts_answer"].items())
    assert json.dumps(_adopt_ref_floats(got["raw_bbox"], want["raw_bbox"])) \
        == json.dumps(want["raw_bbox"])


@pytest.mark.parametrize("shape", [(1, 2), (1, 1, 2)])
def test_ctx_and_model_ranks_serve_the_single_process_predictions(
        tmp_path, shape):
    """``InferenceRunner.run`` on 2 ranks at (1, 2) (each rank 3 of the 6
    frames) and at (1, 1, 2) (the 256 x 300 BERT bridge split by columns),
    float32, two batches of 4 a dispatch over 10 examples, against the
    port's single process and the JAX runner on the same weights: answers
    and spans identical, grounding records at 1e-4."""
    kw = dict(STEP_CFG, use_pallas=False, test_bsz=4, embedding_size=256,
              eval_steps_per_dispatch=2)
    jcfg = small_cfg(tmp_path, **kw)
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"))
    sd = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(cfg.seed)).state_dict()
    job = {"cfg": cfg, "sd": sd, "n": 10, "words": OBJECT_WORDS,
           "mesh_shape": shape}
    path = str(tmp_path / "job")
    torch.save(job, path)
    out = ranks.run_ranks(ranks.infer_rank, 2, path)
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(sd)
    want = InferenceRunner(cfg, model, "cpu").run(
        SyntheticTVQADataset(cfg, 10, mode="valid"),
        object_word_ids=OBJECT_WORDS)
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_params(sd, cfg))
    ref = JaxRunner(jcfg, JaxSTAGE(JaxModelConfig.from_config(jcfg)),
                    params).run(JaxSynthetic(jcfg, 10, mode="valid"),
                                mode="valid", object_word_ids=OBJECT_WORDS)
    assert len(want["ts_answer"]) == 10 and want["raw_bbox"]
    same_json(want, ref)
    for got in out:
        same_json(got, want)


def torchrun(module, args, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--nnodes", "1", "--master_addr", "127.0.0.1",
         "--master_port", str(ranks.free_port()), "-m", module, *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_torchrun_trains_and_serves_with_global_batch_sizes(tmp_path):
    """``torchrun --nproc_per_node 2 -m tvqaplus_tpu_torch.main --device
    cpu --debug --synthetic_data``: opt.json holds the global batch sizes
    (2 x the flags', JAX main.py:47-52), one run directory is written;
    then the inference CLI under torchrun serves the run (a global batch of
    8 over 4 examples: rank 1 has no row) and rank 0 writes the split's
    predictions."""
    proc = torchrun("tvqaplus_tpu_torch.main",
                    TINY_FLAGS + ["--debug", "--device", "cpu",
                                  "--results_dir_base",
                                  str(tmp_path / "results")], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Best val acc") == 1
    (run,) = [p for p in tmp_path.iterdir()
              if p.name.startswith("debug_results")]
    with open(run / "opt.json") as f:
        opt = json.load(f)
    assert (opt["bsz"], opt["test_bsz"], opt["mesh_shape"]) == (8, 8, [-1, 1])
    for name in ("code.zip", "last.ckpt", "scalars.jsonl", "valid_acc.log"):
        assert (run / name).exists(), name
    proc = torchrun("tvqaplus_tpu_torch.inference",
                    ["--model_dir", str(run), "--device", "cpu",
                     "--checkpoint", "last.ckpt"], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("predictions saved") == 1
    with open(run / "valid_inference_predictions.json") as f:
        assert len(json.load(f)["ts_answer"]) == 4


@pytest.mark.parametrize("shape", [("1", "2"), ("1", "1", "2")])
def test_torchrun_runs_the_ctx_and_model_axes(tmp_path, shape):
    """Both CLIs under ``torchrun --nproc_per_node 2 --device cpu`` with
    ``--mesh_shape 1 2`` and ``1 1 2`` (``--embedding_size 256``, so the
    BERT bridge splits): the train CLI writes one run whose opt.json holds
    the mesh and the batch sizes of one data row; the inference CLI serves
    it on the same mesh and writes the prediction JSON that one process
    writes for the run (``--mesh_shape -1 1``): answers and spans
    identical, grounding records at 1e-4."""
    flags = TINY_FLAGS + ["--debug", "--device", "cpu", "--embedding_size",
                          "256", "--mesh_shape", *shape]
    proc = torchrun("tvqaplus_tpu_torch.main", flags + [
        "--results_dir_base", str(tmp_path / "results")], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Best val acc") == 1
    (run,) = [p for p in tmp_path.iterdir()
              if p.name.startswith("debug_results")]
    with open(run / "opt.json") as f:
        opt = json.load(f)
    assert (opt["bsz"], opt["test_bsz"]) == (4, 4)
    assert opt["mesh_shape"] == [int(s) for s in shape]
    pred = run / "valid_inference_predictions.json"
    main_inference(["--model_dir", str(run), "--device", "cpu",
                    "--checkpoint", "last.ckpt", "--mesh_shape", "-1", "1"])
    with open(pred) as f:
        want = json.load(f)
    os.remove(pred)
    proc = torchrun("tvqaplus_tpu_torch.inference",
                    ["--model_dir", str(run), "--device", "cpu",
                     "--checkpoint", "last.ckpt"], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("predictions saved") == 1
    with open(pred) as f:
        got = json.load(f)
    assert len(got["ts_answer"]) == 4
    same_json(got, want)
