"""The serving pipeline's batch layouts in the port against the JAX
package's ``DataPipeline``: St buckets (``sub_token_buckets``), the bf16
host cast and batch-level video dedup (``video_dedup``, ``video_buckets``),
each batch's arrays equal to JAX's; ``CachedDataset`` /
``SharedVideoDataset`` example for example; and the ``InferenceRunner``'s
prediction JSON with dedup on equal to JAX's and to the port's own with it
off."""
import json

import jax
import numpy as np
import pytest
import torch

from tests.test_inference_json_parity import _adopt_ref_floats
from tests.test_torch_infer import (
    OBJECT_WORDS,
    TINY,
    jax_params_and_state_dict,
)
from tvqaplus_tpu.config import Config as JaxConfig
from tvqaplus_tpu.data.batching import ATT_KEYS
from tvqaplus_tpu.data import synthetic as jsyn
from tvqaplus_tpu.data.pipeline import DataPipeline as JaxPipeline
from tvqaplus_tpu.infer.predict import InferenceRunner as JaxRunner
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data import synthetic as tsyn
from tvqaplus_tpu_torch.data.pipeline import BF16_KEYS, DataPipeline
from tvqaplus_tpu_torch.infer.predict import (
    InferenceRunner,
    expand_video_dedup,
)
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig

torch.set_num_threads(1)
BASE = dict(TINY, max_sub_tokens=64)


def configs(**kw):
    jcfg = JaxConfig(**{**BASE, **kw})
    jcfg.finalize(save=False)
    return jcfg, Config(**{**BASE, **kw}).finalize("cpu")


def shared(cfg, syn, n=10, qas_per_video=3):
    return syn.CachedDataset(syn.SharedVideoDataset(
        syn.SyntheticTVQADataset(cfg, n, mode="valid"), qas_per_video))


def port_batches(pipe):
    return [({k: v.numpy() if v.dtype != torch.bfloat16
              else v.view(torch.int16).numpy().view(np.uint16)
              for k, v in b.items()}, meta, bucket)
            for b, meta, bucket in pipe]


def jax_batches(ds, cfg, **kw):
    """JAX's serving pipeline (no att-loss keys, as its InferenceRunner
    asks), bf16 arrays as their uint16 bits."""
    out = []
    for b, meta, bucket in JaxPipeline(ds, cfg, exclude_keys=ATT_KEYS, **kw):
        arrays = {}
        for k, v in b.items():
            v = np.asarray(jax.device_get(v))
            arrays[k] = v.view(np.uint16) if str(v.dtype) == "bfloat16" \
                else v
        out.append((arrays, meta, bucket))
    return out


def assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for (g, gm, gb), (r, rm, rb) in zip(got, ref):
        assert gb == rb and set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        for k in ("qid", "vid_name", "image_indices"):
            assert gm[k] == rm[k], k


def test_shared_video_datasets_match_jax():
    jcfg, cfg = configs()
    jds, tds = shared(jcfg, jsyn, n=9), shared(cfg, tsyn, n=9)
    for i in range(9):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys()
        for k in ("vid_name", "qas", "ts_label", "boxes", "image_indices"):
            assert a[k] == b[k], (i, k)
        np.testing.assert_array_equal(a["sub_tokens"], b["sub_tokens"])
        assert all(np.array_equal(x, y) for x, y in zip(a["vfeat"],
                                                        b["vfeat"]))
    assert tds[4]["vid_name"] == tds[3]["vid_name"] != tds[2]["vid_name"]
    assert tds.max_annotated_frames() == cfg.max_num_img


@pytest.mark.parametrize("group", [1, 2])
def test_st_buckets_match_jax_and_the_fixed_cap(group):
    """A bucketed batch's arrays are JAX's, and the fixed-cap batch's on
    their first St slots; the stacks key on St."""
    jcfg, cfg = configs(sub_token_buckets=[32, 40, 56])
    jds, tds = shared(jcfg, jsyn, n=12, qas_per_video=1), \
        shared(cfg, tsyn, n=12, qas_per_video=1)
    got = port_batches(DataPipeline(tds, cfg, "cpu", batch_size=2,
                                    group=group))
    ref = jax_batches(jds, jcfg, batch_size=2, group=group)
    assert_same_batches(got, ref)
    _, fixed_cfg = configs()
    fixed = port_batches(DataPipeline(tds, fixed_cfg, "cpu", batch_size=2))
    sts = set()
    single = port_batches(DataPipeline(tds, cfg, "cpu", batch_size=2))
    for (b, _, _), (f, _, _) in zip(single, fixed):
        st = b["sub_tokens"].shape[1]
        sts.add(st)
        np.testing.assert_array_equal(b["sub_tokens"],
                                      f["sub_tokens"][:, :st])
        assert not f["sub_tokens"][:, st:].any()
        for k in f:
            if k != "sub_tokens":
                np.testing.assert_array_equal(b[k], f[k], err_msg=k)
    assert len(sts) > 1 and max(sts) < 64, sts
    if group > 1:        # stacks formed (keyed on St, as JAX's above)
        assert any(b["ex_mask"].ndim == 2 for b, _, _ in got)


def test_bf16_host_cast_is_bit_equal_to_jax():
    """Under ``compute_dtype="bfloat16"`` (asked for explicitly: the CPU
    resolves "auto" to float32) the feature arrays go out in bfloat16, bit
    for bit JAX's ``ml_dtypes`` cast (round to nearest even), the other
    keys untouched; ties and values near bf16's limits included."""
    jcfg, cfg = configs(compute_dtype="bfloat16")
    jds, tds = shared(jcfg, jsyn), shared(cfg, tsyn)
    # rounding ties (one half of a bf16 step) and large values
    for ds in (jds, tds):
        row = ds.examples[0]["qas_bert"][0][0]
        row[:4] = np.float32(1.0 + 2.0 ** -8)        # ties to 1.0
        row[4:6] = np.float32(1.0 + 3 * 2.0 ** -8)   # ties to 1 + 2**-6
        row[6:9] = np.float32([3.3e38, -1e-40, 65504.0])
    got = port_batches(DataPipeline(tds, cfg, "cpu", batch_size=4))
    ref = jax_batches(jds, jcfg, batch_size=4)
    assert_same_batches(got, ref)
    for b, _, _ in got:
        for k in b:
            assert (b[k].dtype == np.uint16) == (k in BF16_KEYS), k
    even = got[0][0]["qas_bert"][0, 0, 0, :6]
    assert list(even) == [0x3F80] * 4 + [0x3F82] * 2


@pytest.mark.parametrize("group", [1, 2])
def test_video_dedup_matches_jax(group):
    """``vid_u`` / ``sub_tokens_u`` / ``ex_vid`` and every other array
    equal JAX's, a smaller U bucket taken where the batch allows, the
    padding rows of the short last batch on the zero slot, and the device
    gather gives back the non-dedup batch."""
    jcfg, cfg = configs(video_buckets=[2, 3])
    jds, tds = shared(jcfg, jsyn), shared(cfg, tsyn)
    got = port_batches(DataPipeline(tds, cfg, "cpu", batch_size=4,
                                    group=group, video_dedup=True))
    ref = jax_batches(jds, jcfg, batch_size=4, group=group,
                      video_dedup=True)
    assert_same_batches(got, ref)
    base = port_batches(DataPipeline(tds, cfg, "cpu", batch_size=4))
    dedup = port_batches(DataPipeline(tds, cfg, "cpu", batch_size=4,
                                      video_dedup=True))
    us = []
    for (b, _, _), (d, meta, _) in zip(base, dedup):
        assert "vid" not in d and "sub_tokens" not in d
        us.append(d["vid_u"].shape[0])
        n = len(meta["qid"])
        if n < 4:                    # padding rows: the zero slot
            slot = d["ex_vid"][n]
            assert (d["ex_vid"][n:] == slot).all()
            assert not d["vid_u"][slot].any()
        expanded = expand_video_dedup({k: torch.from_numpy(v)
                                       for k, v in d.items()})
        assert set(expanded) == set(b)
        for k in b:
            np.testing.assert_array_equal(expanded[k].numpy(), b[k],
                                          err_msg=k)
    assert min(us) < 4 and us[-1] in (2, 3), us


def test_grouped_stacks_key_on_u():
    """Batches of different U buckets never stack into one dispatch (JAX
    tests/test_video_dedup.py ``test_grouped_stacks_key_on_u``)."""
    _, cfg = configs(video_buckets=[1, 4])
    base = tsyn.SyntheticTVQADataset(cfg, 8, mode="valid")
    ex = [dict(base[i]) for i in range(8)]
    for i in range(4):
        for k in tsyn.SharedVideoDataset._VIDEO_FIELDS:
            ex[i][k] = ex[0][k]

    class Listed:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return ex[i]

    pipe = DataPipeline(Listed(), cfg, "cpu", batch_size=4, group=2,
                        video_dedup=True)
    us = sorted(b["vid_u"].shape[-4] for b, _, _ in pipe)
    assert us == [1, 4], us


def test_predictions_with_video_dedup_match_jax_and_dedup_off():
    """The prediction JSON with ``video_dedup`` (and St buckets, two
    batches a dispatch) equals JAX's from the same weights and the port's
    own with both off: answers and spans identical, grounding records at
    1e-4."""
    layout = dict(video_buckets=[2, 3], sub_token_buckets=[24, 40],
                  eval_steps_per_dispatch=2)
    jcfg, cfg = configs(**layout)
    jmodel, params, sd = jax_params_and_state_dict(jcfg)
    jcfg.video_dedup = True
    ref = JaxRunner(jcfg, jmodel, params).run(
        shared(jcfg, jsyn, n=12), mode="valid", object_word_ids=OBJECT_WORDS)
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(sd, strict=True)
    preds = {}
    for dedup in (False, True):
        cfg.video_dedup = dedup
        cfg.sub_token_buckets = layout["sub_token_buckets"] if dedup else []
        preds[dedup] = InferenceRunner(cfg, model, "cpu").run(
            shared(cfg, tsyn, n=12), mode="valid",
            object_word_ids=OBJECT_WORDS)
    assert sum(len(r) for q in ref["raw_bbox"] for r in q.values()) > 0
    for ours in preds.values():
        assert ours["ts_answer"] == ref["ts_answer"]
        assert json.dumps(_adopt_ref_floats(ours["raw_bbox"],
                                            ref["raw_bbox"])) \
            == json.dumps(ref["raw_bbox"])
    assert preds[True]["ts_answer"] == preds[False]["ts_answer"]


def test_inference_cli_takes_the_layouts_from_its_command_line(tmp_path):
    """``--video_dedup`` and ``--sub_token_buckets`` on the inference entry
    point hold over the run's opt.json (which trained without them) and
    leave the prediction JSON as it is."""
    from tvqaplus_tpu_torch.inference import main_inference
    cfg = Config(**BASE, synthetic_n_valid=10)
    cfg.save(str(tmp_path / "opt.json"))
    cfg.finalize("cpu")
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "best_valid.pth")
    argv = ["--model_dir", str(tmp_path), "--device", "cpu"]
    preds, seen = [], []
    real = DataPipeline.__init__

    def spy(pipe, *a, **k):
        real(pipe, *a, **k)
        seen.append((pipe.video_dedup, pipe.st_buckets))
    DataPipeline.__init__ = spy
    try:
        for extra in ([], ["--video_dedup", "--sub_token_buckets", "24",
                           "40"]):
            with open(main_inference(argv + extra)) as f:
                preds.append(json.load(f))
    finally:
        DataPipeline.__init__ = real
    assert seen == [(False, []), (True, [24, 40])]
    assert preds[0]["ts_answer"] == preds[1]["ts_answer"]
    assert json.dumps(_adopt_ref_floats(preds[1]["raw_bbox"],
                                        preds[0]["raw_bbox"])) \
        == json.dumps(preds[0]["raw_bbox"])
