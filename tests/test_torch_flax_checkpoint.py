"""The JAX package's flax checkpoints in the PyTorch port: the msgpack
reader and writer against flax's own (leaf for leaf, byte for byte), the
format sniff, the port's inference CLI serving a JAX run directory with the
JAX InferenceRunner's prediction JSON, and one train step resumed from a
JAX ``save_checkpoint`` file against the JAX Trainer's resumed step."""
import dataclasses
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_inference_json_parity import _adopt_ref_floats
from tests.test_torch_infer import TINY, jax_params_and_state_dict
from tests.test_torch_train import STEP_CFG, port_config
from tests.test_train import small_cfg
from tvqaplus_tpu.config import Config as JaxConfig
from tvqaplus_tpu.data.pipeline import DataPipeline as JaxPipeline
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.infer.predict import InferenceRunner as JaxRunner
from tvqaplus_tpu.parallel.mesh import place_state
from tvqaplus_tpu.train import state as jstate
from tvqaplus_tpu.train.loop import Trainer as JaxTrainer
from tvqaplus_tpu_torch.inference import main_inference
from tvqaplus_tpu_torch.interop import flax_msgpack
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.interop.weights import (
    flax_checkpoint_tree,
    params_from_flax,
    state_dict_from_flax_checkpoint,
)
from tvqaplus_tpu_torch.train import loop

torch.set_num_threads(1)
CLI_WORDS = list(range(3, 1000))        # the CLI's synthetic object words
EXTRA = {"best_acc": 0.375, "epoch": 4, "lr": 5e-4}


def leaves(tree):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({(k,) + p: x for p, x in leaves(v).items()})
        else:
            out[(k,)] = v
    return out


def assert_same_leaves(got, ref):
    got, ref = leaves(got), leaves(ref)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, np.ndarray) and r.dtype == jnp.bfloat16:
            assert isinstance(g, flax_msgpack.BFloat16Bits), k
            np.testing.assert_array_equal(np.asarray(g, np.uint16),
                                          r.view(np.uint16), err_msg=str(k))
            # the bits are torch's bfloat16 values
            t = torch.from_numpy(np.array(g, np.uint16).view(np.int16)
                                 ).view(torch.bfloat16)
            np.testing.assert_array_equal(t.float().numpy(),
                                          r.astype(np.float32))
        elif isinstance(r, np.ndarray):
            assert type(g) is np.ndarray and g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=str(k))
        else:
            assert type(g) is type(r) and g == r, (k, g, r)


def jax_state(seed=0, steps=3):
    """A JAX TrainState of the tiny STAGE with Adam moments drawn from a
    seed, ``steps`` steps and a reduced rate."""
    jcfg = JaxConfig(**TINY)
    jcfg.finalize(save=False)
    _, params, _ = jax_params_and_state_dict(jcfg, seed)
    state, _ = jstate.create_train_state(params, 1e-3)
    return with_moments(state, steps, seed), jcfg


def with_moments(state, steps, seed):
    rng = np.random.default_rng(seed + 100)
    draw = lambda p, s: jnp.asarray(  # noqa: E731
        s * rng.standard_normal(p.shape).astype(np.float32))
    clip, inject = state.opt_state
    adam = inject.inner_state[1]
    adam = adam._replace(
        count=jnp.asarray(steps, jnp.int32),
        mu=jax.tree_util.tree_map(lambda p: draw(p, 1e-2), adam.mu),
        nu=jax.tree_util.tree_map(lambda p: jnp.abs(draw(p, 1e-3)), adam.nu))
    inner = (inject.inner_state[0], adam, inject.inner_state[2])
    inject = inject._replace(count=jnp.asarray(steps, jnp.int32),
                             inner_state=inner)
    state = state.replace(step=jnp.asarray(steps, jnp.int32),
                          opt_state=(clip, inject))
    return state.with_lr(EXTRA["lr"])


def checkpoint_payload(state):
    """The tree ``save_checkpoint`` serializes."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_get(x) if isinstance(x, jax.Array) else x,
        {"state": flax.serialization.to_state_dict(state), "extra": EXTRA})


# ----------------------------------------------------------- the format
@pytest.fixture(scope="module")
def state_and_cfg():
    return jax_state()


def test_loads_equals_msgpack_restore_on_jax_checkpoints(tmp_path,
                                                         state_and_cfg):
    state, _ = state_and_cfg
    ckpt, params = str(tmp_path / "last.ckpt"), str(tmp_path / "p.ckpt")
    jstate.save_checkpoint(ckpt, state, extra=EXTRA)
    jstate.save_params(params, state.params)
    for path in (ckpt, params):
        with open(path, "rb") as f:
            data = f.read()
        assert_same_leaves(flax_msgpack.loads(data),
                           flax.serialization.msgpack_restore(data))
    tree = flax_msgpack.load(ckpt)
    assert sorted(tree) == ["extra", "state"]
    assert sorted(tree["state"]) == ["opt_state", "params", "step"]
    assert tree["extra"] == EXTRA and int(tree["state"]["step"]) == 3


@pytest.mark.parametrize("chunk", [None, 64])
def test_loads_reads_bf16_scalar_and_chunked_leaves(tmp_path, monkeypatch,
                                                    chunk):
    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(3)
    tree = {"w": jnp.asarray(rng.standard_normal((7, 9)), jnp.bfloat16),
            "b": rng.standard_normal(40).astype(np.float32),
            "i": np.arange(30, dtype=np.int64), "s": np.float32(2.5),
            "n": np.int32(-7), "e": {}, "x": 1.25, "k": 3,
            "t": np.asarray(True)}
    path = str(tmp_path / "p.ckpt")
    jstate.save_params(path, tree)
    with open(path, "rb") as f:
        data = f.read()
    assert (b"__msgpack_chunked_array__" in data) == bool(chunk)
    ref = flax.serialization.msgpack_restore(data)
    got = flax_msgpack.loads(data)
    assert_same_leaves(got, ref)
    np.testing.assert_array_equal(flax_msgpack.as_float32(got["w"]),
                                  np.asarray(tree["w"], np.float32))


@pytest.mark.parametrize("chunk", [None, 256])
@pytest.mark.parametrize("which", ["params", "checkpoint"])
def test_dumps_is_msgpack_serialize_byte_for_byte(monkeypatch, state_and_cfg,
                                                  which, chunk):
    state, _ = state_and_cfg
    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    tree = (flax.serialization.to_state_dict(jax.device_get(state.params))
            if which == "params" else checkpoint_payload(state))
    ref = flax.serialization.msgpack_serialize(tree)
    assert flax_msgpack.dumps(tree) == ref
    assert (b"__msgpack_chunked_array__" in ref) == bool(chunk)
    assert_same_leaves(flax_msgpack.loads(ref),
                       flax.serialization.msgpack_restore(ref))


def test_sniff_tells_the_formats_apart(tmp_path, state_and_cfg):
    state, _ = state_and_cfg
    sd = {"w": torch.arange(6.0)}
    torch.save(sd, tmp_path / "zip.pth")
    torch.save(sd, tmp_path / "legacy.pth",
               _use_new_zipfile_serialization=False)
    jstate.save_checkpoint(str(tmp_path / "flax.ckpt"), state, extra=EXTRA)
    (tmp_path / "empty.ckpt").write_bytes(flax.serialization
                                          .msgpack_serialize({}))
    (tmp_path / "notes.txt").write_text("not a checkpoint\n")
    assert (tmp_path / "legacy.pth").read_bytes()[:2] == b"\x80\x02"
    assert (tmp_path / "empty.ckpt").read_bytes() == b"\x80"
    for name, want in (("zip.pth", "torch"), ("legacy.pth", "torch"),
                       ("flax.ckpt", "flax"), ("empty.ckpt", "flax")):
        assert flax_msgpack.sniff(str(tmp_path / name)) == want, name
    with pytest.raises(ValueError) as err:
        flax_msgpack.sniff(str(tmp_path / "notes.txt"))
    for fmt in ("torch zip", "torch legacy pickle", "flax msgpack"):
        assert fmt in str(err.value)
    assert torch.equal(torch.load(tmp_path / "legacy.pth")["w"], sd["w"])


# -------------------------------------------------------------- serving
def write_jax_run(run_dir, state, jcfg, name="best_valid.ckpt"):
    os.makedirs(run_dir, exist_ok=True)
    dataclasses.replace(jcfg, synthetic_n_valid=6).save(
        os.path.join(run_dir, "opt.json"))
    jstate.save_checkpoint(os.path.join(run_dir, name), state, extra=EXTRA)


@pytest.fixture(scope="module")
def jax_predictions(state_and_cfg):
    """The JAX InferenceRunner's prediction JSON (as it reads back) for the
    weights of ``state_and_cfg`` and of seed 1, over the CLI's split."""
    state, jcfg = state_and_cfg
    jcfg = dataclasses.replace(jcfg, synthetic_n_valid=6)
    model, params1, _ = jax_params_and_state_dict(jcfg, 1)
    out = {}
    for key, params in (("seed0", state.params), ("seed1", params1)):
        pred = JaxRunner(jcfg, model, params).run(
            JaxSynthetic(jcfg, 6, mode="valid"), mode="valid",
            object_word_ids=CLI_WORDS)
        out[key] = json.loads(json.dumps(pred))
    assert sum(len(r) for q in out["seed0"]["raw_bbox"]
               for r in q.values()) > 0
    return out


def same_json(got, ref):
    """The CLI's parity bars: identical answers and spans, grounding within
    1e-4."""
    assert got["ts_answer"] == ref["ts_answer"]
    assert json.dumps(_adopt_ref_floats(got["raw_bbox"], ref["raw_bbox"])) \
        == json.dumps(ref["raw_bbox"])


def cli(*argv):
    with open(main_inference([*argv, "--device", "cpu"])) as f:
        return json.load(f)


def test_cli_serves_a_jax_run_directory(tmp_path, state_and_cfg,
                                        jax_predictions, capsys):
    state, jcfg = state_and_cfg
    write_jax_run(str(tmp_path), state, jcfg)
    got = cli("--model_dir", str(tmp_path), "--no_strict")
    same_json(got, jax_predictions["seed0"])
    assert "warning" not in capsys.readouterr().out


def test_cli_falls_back_to_a_jax_last_ckpt_and_warns(tmp_path, state_and_cfg,
                                                     jax_predictions, capsys):
    state, jcfg = state_and_cfg
    write_jax_run(str(tmp_path), state, jcfg, name="last.ckpt")
    got = cli("--model_dir", str(tmp_path))
    same_json(got, jax_predictions["seed0"])
    assert f"warning: {tmp_path / 'best_valid.pth'} missing, using " \
           f"{tmp_path / 'last.ckpt'}" in capsys.readouterr().out


def test_cli_serves_a_save_params_file_by_content(tmp_path, state_and_cfg,
                                                  jax_predictions):
    """A ``save_params`` file named like a torch file is still read as
    flax."""
    state, jcfg = state_and_cfg
    write_jax_run(str(tmp_path), state, jcfg)
    jstate.save_params(str(tmp_path / "weights.pth"), state.params)
    got = cli("--model_dir", str(tmp_path), "--checkpoint", "weights.pth")
    same_json(got, jax_predictions["seed0"])


def test_cli_torch_checkpoint_flag(tmp_path, state_and_cfg, jax_predictions):
    """``--torch_checkpoint`` serves a reference-format state_dict over the
    run's own best_valid.ckpt, and reads a flax file by its content as
    ``--checkpoint`` does."""
    state, jcfg = state_and_cfg
    write_jax_run(str(tmp_path), state, jcfg)
    _, params1, sd1 = jax_params_and_state_dict(jcfg, 1)
    torch.save(sd1, tmp_path / "reference.pth")
    got = cli("--model_dir", str(tmp_path), "--torch_checkpoint",
              str(tmp_path / "reference.pth"))
    same_json(got, jax_predictions["seed1"])
    got = cli("--model_dir", str(tmp_path), "--torch_checkpoint",
              str(tmp_path / "best_valid.ckpt"))
    same_json(got, jax_predictions["seed0"])


def test_cli_names_the_formats_for_an_unknown_file(tmp_path, state_and_cfg):
    """A file of neither format raises an error that names the formats read
    (not the IndexError torch.load gives a flax file)."""
    state, jcfg = state_and_cfg
    write_jax_run(str(tmp_path), state, jcfg, name="last.ckpt")
    (tmp_path / "best_valid.pth").write_text("{}\n")
    with pytest.raises(ValueError, match="flax msgpack checkpoint"):
        cli("--model_dir", str(tmp_path))


def test_state_dict_from_a_checkpoint_and_a_params_file_agree(tmp_path,
                                                              state_and_cfg):
    state, jcfg = state_and_cfg
    jstate.save_checkpoint(str(tmp_path / "c.ckpt"), state, extra=EXTRA)
    jstate.save_params(str(tmp_path / "p.ckpt"), state.params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                            jcfg)
    for name in ("c.ckpt", "p.ckpt"):
        got = state_dict_from_flax_checkpoint(str(tmp_path / name), jcfg)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k


# -------------------------------------------------------------- resuming
def test_resumed_train_step_matches_the_jax_trainer(tmp_path):
    """The JAX Trainer resumes from a ``save_checkpoint`` file (its loader,
    loop.py:121-127) and takes one step; the port's Trainer resumes from
    the same file and takes one step on the same batch (hard negatives,
    dropout 0, float32): loss and every updated parameter within 1e-5, and
    the step, Adam's state, rate and ``extra`` carried over."""
    jcfg = small_cfg(tmp_path, **STEP_CFG)
    trainer = JaxTrainer(jcfg)
    trainer.state = place_state(trainer.mesh, with_moments(
        trainer.state, 3, 2))
    path = str(tmp_path / "last.ckpt")
    jstate.save_checkpoint(path, trainer.state, extra=EXTRA)
    trainer.state, extra = jstate.load_checkpoint(path, trainer.state)
    trainer.state = place_state(trainer.mesh, trainer.state)
    assert extra == EXTRA
    batch = next(iter(JaxPipeline(JaxSynthetic(jcfg, 4, mode="train"), jcfg,
                                  batch_size=4)))[0]
    ref = trainer._dispatch_train(batch, True)
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, trainer.state.params), jcfg)

    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"), resume=path)
    ours = loop.Trainer(cfg, "cpu")
    assert (ours.step, ours.best_acc, ours.start_epoch, ours.scheduler.lr) \
        == (3, EXTRA["best_acc"], EXTRA["epoch"], EXTRA["lr"])
    assert int(ours.seeds.step) == 3
    group = ours.optimizer.param_groups[0]
    assert group["lr"] == pytest.approx(EXTRA["lr"])
    assert all(float(ours.optimizer.state[p]["step"]) == 3.0
               for p in ours.params)
    metrics = ours.train_step({k: torch.from_numpy(np.array(v))
                               for k, v in batch.items()},
                              use_hard_negatives=True)
    for k in ("loss", "loss_cls", "loss_ts", "loss_att"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    named = dict(ours.model.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert ours.step == 4 and int(ours.seeds.step) == 4


def test_a_resumed_state_exports_the_bytes_jax_wrote(tmp_path,
                                                    state_and_cfg):
    """``flax_checkpoint_tree`` of a Trainer resumed from a JAX checkpoint,
    written by ``dumps``, is the JAX file byte for byte: weights, moments,
    counts, rate, step and ``extra`` all map back exactly."""
    state, _ = state_and_cfg
    path = str(tmp_path / "last.ckpt")
    jstate.save_checkpoint(path, state, extra=EXTRA)
    cfg = Config(**TINY, results_dir=str(tmp_path / "port"),
                 resume=path).finalize("cpu")
    trainer = loop.Trainer(cfg, "cpu")
    tree = flax_checkpoint_tree(trainer.model, trainer.optimizer,
                                trainer.step, EXTRA, cfg)
    with open(path, "rb") as f:
        assert flax_msgpack.dumps(tree) == f.read()


def test_resume_refuses_a_params_only_file(tmp_path, state_and_cfg):
    state, _ = state_and_cfg
    jcfg = small_cfg(tmp_path, **STEP_CFG)
    path = str(tmp_path / "p.ckpt")
    jstate.save_params(path, state.params)
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"), resume=path)
    with pytest.raises(ValueError, match="save_params"):
        loop.Trainer(cfg, "cpu")
