"""Run bookkeeping of the PyTorch port against the JAX package: the
``code.zip`` snapshot, the ``profile_dir`` trace, the TensorBoard mirror of
the scalar log, the timing helpers, and the surface helpers the JAX
package exports (utils, ``expand_sub_windows``, the native IoU and 2-D
padding)."""
import json
import os
import sys
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_infer import TINY
from tvqaplus_tpu.config import Config as JaxConfig
from tvqaplus_tpu.data import batching as jbatch
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.native import pairwise_iou as jax_pairwise_iou
from tvqaplus_tpu.train import metrics as jmetrics
from tvqaplus_tpu.utils import io as jio
from tvqaplus_tpu.utils import misc as jmisc
from tvqaplus_tpu.utils import timing as jtiming
from tvqaplus_tpu_torch import native
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data import batching as tbatch
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.train import loop
from tvqaplus_tpu_torch.train import metrics as tmetrics
from tvqaplus_tpu_torch.utils import io as tio
from tvqaplus_tpu_torch.utils import misc as tmisc
from tvqaplus_tpu_torch.utils import timing as ttiming

torch.set_num_threads(1)


# ------------------------------------------------------------- code.zip
def source_tree(root):
    for rel, text in (("a.py", "x = 1\n"), ("sub/b.py", "y = 2\n"),
                      ("sub/c.pyc", "0"), ("nb.ipynb", "{}"),
                      ("results/r.json", "{}"), ("__pycache__/d.pyc", "0"),
                      (".hidden/e.py", "z\n"), ("sub/deep/f.txt", "f\n")):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


@pytest.mark.parametrize("enclosing", ["code", ""])
def test_make_zipfile_members_equal_jax(tmp_path, enclosing):
    source_tree(str(tmp_path / "src"))
    kw = dict(enclosing_dir=enclosing, exclude_paths=["results",
                                                      "__pycache__"],
              exclude_extensions=[".pyc", ".ipynb"])
    jio.make_zipfile(str(tmp_path / "src"), str(tmp_path / "j.zip"), **kw)
    tio.make_zipfile(str(tmp_path / "src"), str(tmp_path / "t.zip"), **kw)
    with zipfile.ZipFile(tmp_path / "j.zip") as j, \
            zipfile.ZipFile(tmp_path / "t.zip") as t:
        assert sorted(t.namelist()) == sorted(j.namelist())
        assert all(t.read(n) == j.read(n) for n in j.namelist())
    assert len(j.namelist()) == 3


def test_save_run_writes_opt_json_and_the_code_snapshot(tmp_path):
    cfg = Config(**TINY, results_dir=str(tmp_path / "run")).finalize("cpu")
    cfg.save_run()
    with open(tmp_path / "run" / "opt.json") as f:
        assert json.load(f)["hsz"] == TINY["hsz"]
    with zipfile.ZipFile(tmp_path / "run" / "code.zip") as z:
        names = z.namelist()
    assert "code/models/stage.py" in names
    assert "code/native/fastops.c" in names
    assert not [n for n in names if n.endswith(".pyc")
                or "__pycache__" in n or not n.startswith("code/")]


# --------------------------------------------------------------- profile
@pytest.mark.parametrize("n_batches", [10, 15])
def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path, monkeypatch,
                                               n_batches):
    """Epoch 0 traces dispatches 8 to 12 (JAX loop.py:300-301, 370-373):
    ended after dispatch 12, or at the epoch's end when it has fewer."""
    cfg = Config(**TINY, results_dir=str(tmp_path / "run"), log_freq=10000,
                 profile_dir=str(tmp_path / "prof")).finalize("cpu")
    trainer = loop.Trainer(cfg, "cpu")
    stops = []
    real_stop = loop.stop_trace

    def stop(prof, device, profile_dir):
        stops.append(trainer.step)
        return real_stop(prof, device, profile_dir)

    monkeypatch.setattr(loop, "stop_trace", stop)
    trainer.train_epoch(SyntheticTVQADataset(cfg, 4 * n_batches,
                                             mode="train"), 0)
    assert stops == [min(n_batches, 13)]
    (name,) = os.listdir(tmp_path / "prof")
    assert trainer.trace_path == str(tmp_path / "prof" / name)
    with open(trainer.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_no_trace_without_profile_dir_or_after_epoch_0(tmp_path):
    cfg = Config(**TINY, results_dir=str(tmp_path / "run"), log_freq=10000,
                 profile_dir=str(tmp_path / "prof")).finalize("cpu")
    trainer = loop.Trainer(cfg, "cpu")
    trainer.train_epoch(SyntheticTVQADataset(cfg, 40, mode="train"), 1)
    assert not os.path.exists(tmp_path / "prof")
    assert trainer.trace_path is None


# ----------------------------------------------------------- TensorBoard
class FakeWriters:
    """A ``tensorboardX`` module whose SummaryWriters record their calls."""

    def __init__(self):
        self.calls = []
        calls = self.calls

        class SummaryWriter:
            def __init__(self, log_dir):
                calls.append(("open", os.path.basename(log_dir)))

            def add_scalar(self, tag, value, step):
                calls.append(("scalar", tag, float(value), int(step)))

            def close(self):
                calls.append(("close",))

        self.module = types.ModuleType("tensorboardX")
        self.module.SummaryWriter = SummaryWriter


def log_some(logger):
    logger.add_scalar("Train/Loss", 0.5, 3)
    logger.add_scalar("Valid/Acc", np.float32(0.25), 4)
    logger.close()


def test_tensorboard_mirror_matches_jax(tmp_path, monkeypatch):
    fake = FakeWriters()
    monkeypatch.setitem(sys.modules, "tensorboardX", fake.module)
    log_some(jmetrics.MetricsLogger(str(tmp_path / "run")))
    jax_calls = list(fake.calls)
    fake.calls.clear()
    log_some(tmetrics.MetricsLogger(str(tmp_path / "run")))
    assert fake.calls == jax_calls
    assert fake.calls[1] == ("scalar", "Train/Loss", 0.5, 3)
    with open(tmp_path / "run" / "scalars.jsonl") as f:
        assert len(f.readlines()) == 4          # both loggers' lines


def test_no_tensorboard_no_mirror(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = tmetrics.MetricsLogger(str(tmp_path))
    assert logger.tb is None
    log_some(logger)


# ---------------------------------------------------------------- timing
def test_host_sync_and_timeit():
    x = {"a": [torch.zeros(0), torch.arange(3.0) + 2]}
    assert ttiming.host_sync(x) == 2.0 and ttiming.host_sync({}) is None
    calls = []
    ms = ttiming.timeit_host_synced(
        lambda: calls.append(1) or torch.ones(2), n=5, warmup=2, trials=3)
    assert ms >= 0 and len(calls) == 2 + 5 * 3


def test_compiled_flops_counts_as_jax_does():
    a, b = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    want = jtiming.compiled_flops(jax.jit(jnp.matmul), a, b)
    got = ttiming.compiled_flops(torch.matmul, torch.from_numpy(a),
                                 torch.from_numpy(b))
    assert got == want == 2 * 8 * 16 * 4
    assert ttiming.compiled_flops(torch.relu, torch.ones(4)) is None


# --------------------------------------------------------------- helpers
def test_misc_helpers_match_jax(tmp_path):
    for name in ("friends_s01e02_seg02_clip_00", "s05e02_seg01_clip_00",
                 "castle_s01", "grey_x", "met_y", "house_z", "bbt"):
        assert tmisc.get_show_name(name) == jmisc.get_show_name(name)
    w2i = {"what": 5, "who": 6, "where": 7, "how": 8, "why": 9}
    qs = [[5, 1], [6], [7, 2], [8], [9], [1, 5], [42]]
    assert tmisc.get_q_type(qs, w2i) == jmisc.get_q_type(qs, w2i)
    assert tmisc.get_q_type(qs, {}) == jmisc.get_q_type(qs, {})
    types_ = tmisc.get_q_type(qs, w2i)
    corrects = [1, 0, 1, 1, 0, 1, 0]
    assert tmisc.compute_acc_by_type(types_, corrects) == \
        jmisc.compute_acc_by_type(types_, corrects)
    meter = tmisc.AverageMeter()
    with tmisc.Timer(meter) as t:
        pass
    assert meter.count == 1 and t.meter is meter
    assert tmisc.Timer().meter.count == 0
    tio.mkdirp(str(tmp_path / "a" / "b"))
    tio.mkdirp(str(tmp_path / "a" / "b"))
    tio.save_pickle({"k": [1, 2]}, str(tmp_path / "a" / "p.pkl"))
    assert jio.load_pickle(str(tmp_path / "a" / "p.pkl")) == {"k": [1, 2]}
    paths = [str(tmp_path / "a" / "p.pkl"), str(tmp_path / "a" / "b")]
    assert tio.files_exist(paths) == jio.files_exist(paths) is True
    paths.append(str(tmp_path / "missing"))
    assert tio.files_exist(paths) == jio.files_exist(paths) is False


def test_expand_sub_windows_matches_jax():
    jcfg = JaxConfig(**TINY, sub_dedup=True, max_sub_tokens=64)
    jcfg.finalize(save=False)
    cfg = Config(**TINY, sub_dedup=True, max_sub_tokens=64).finalize("cpu")
    jds, ds = JaxSynthetic(jcfg, 4, mode="valid"), \
        SyntheticTVQADataset(cfg, 4, mode="valid")
    ref, _ = jbatch.collate_static([jds[i] for i in range(4)],
                                   jbatch.StaticShapeSpec.from_config(
                                       jcfg, batch=4), skip_att=True)
    got, _ = tbatch.collate_static([ds[i] for i in range(4)],
                                   tbatch.StaticShapeSpec.from_config(
                                       cfg, batch=4))
    out = tbatch.expand_sub_windows(got)
    np.testing.assert_array_equal(out, jbatch.expand_sub_windows(ref))
    assert out.shape == got["sub_win_idx"].shape + (TINY["embedding_size"],)
    assert np.abs(out).sum() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_native_pairwise_iou_matches_jax(seed):
    rng = np.random.default_rng(seed)

    def boxes(n):
        xy = rng.integers(0, 200, (n, 2)).astype(np.float64)
        return np.concatenate([xy, xy + rng.integers(-2, 80, (n, 2))], 1)
    a, b = boxes(7), boxes(5)
    np.testing.assert_array_equal(native.pairwise_iou(a, b),
                                  jax_pairwise_iou(a, b))
    assert native.pairwise_iou(a, b[:0]).shape == (7, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_pad_batch_2d_matches_numpy(seed):
    """The C copy (JAX fastops.c ``pad_batch_2d_f32``) against a numpy
    loop: items past max_outer and rows past max_inner clipped."""
    rng = np.random.default_rng(seed)
    n, max_outer, max_inner, dim = 4, 3, 5, 6
    items = [[rng.standard_normal((int(k), dim)).astype(np.float32)
              for k in rng.integers(0, 8, int(m))]
             for m in rng.integers(0, 5, n)]
    out = np.zeros((n, max_outer, max_inner, dim), np.float32)
    mask = np.zeros((n, max_outer, max_inner), np.float32)
    native.pad_batch_2d(items, max_outer, max_inner, out, mask)
    want, want_mask = np.zeros_like(out), np.zeros_like(mask)
    for i, ex in enumerate(items):
        for j, a in enumerate(ex[:max_outer]):
            k = min(len(a), max_inner)
            want[i, j, :k], want_mask[i, j, :k] = a[:k], 1.0
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(mask, want_mask)
    with pytest.raises(ValueError):
        native.pad_batch_2d(items, max_outer, max_inner, out[:, :, :, :4],
                            mask)
