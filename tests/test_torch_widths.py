"""The port at hidden widths 64 and 256, where the JAX package's Pallas
kernels run as they do at 128 (none of their predicates tests the width).

* The plain versions of the three forward kernels (attention in every raw
  mode, tri bridge, encoder in both modes) at D = 64 and 256 against the
  Pallas kernels in interpret mode, as tests/test_torch_kernels.py holds
  them at D = 16.
* STAGE's eval forward at hsz 64 and 256 against JAX's
  ``STAGE(use_pallas=True)`` with the same weights (``params_from_flax``),
  separate and merged, at the bars of tests/test_torch_stage.py.
* The inference CLI's prediction JSON at hsz 256 against the JAX
  InferenceRunner's from the same weights.
* The Python side of the kernels' launch at these widths: which
  instantiation each width takes, the shared memory of each against the
  H100's limit, D = 96 padded to the 128 instantiation and D = 384 refused
  (forward and backward), training on a (faked) cuda device at hsz 64 to
  256 accepted and at hsz 384 refused at construction.
  The kernels themselves run on a card:
  tests/test_torch_cuda.py (``other_widths``) and chip_smoke.py.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_inference_json_parity import _adopt_ref_floats
from tests.test_stage_model import tiny_batch, tiny_cfg
from tests.test_torch_infer import (
    TINY,
    cli,
    configs,
    jax_params_and_state_dict,
)
from tests.test_torch_kernels import (
    TOL,
    attn_inputs,
    bridge_inputs,
    encoder_inputs,
    t,
)
from tests.test_torch_stage import assert_outputs_match, run_both, to_dedup
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.infer.predict import InferenceRunner as JaxRunner
from tvqaplus_tpu.ops import pallas_attention as pa
from tvqaplus_tpu.ops import pallas_encoder as pe_mod
from tvqaplus_tpu.ops import pallas_tri_bridge as tb
from tvqaplus_tpu_torch import main as port_main
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data.pipeline import DataPipeline
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.ops import encoder, qa_ctx_attention, tri_bridge
from tvqaplus_tpu_torch.ops import widths
from tvqaplus_tpu_torch.train import loop

torch.set_num_threads(1)
WIDTHS = (64, 256)
ALL_KEYS = ("answer_scores", "t_scores", "vid_raw_s", "sub_raw_s")


# ------------------------------------------- plain versions vs Pallas kernels
@pytest.mark.parametrize("raw_mode", ["full", "none", "target"])
@pytest.mark.parametrize("d", WIDTHS)
def test_qa_ctx_attention_plain_matches_pallas_at_width(d, raw_mode):
    args = attn_inputs(d=d, seed=3)
    targets = np.array([1, 3], np.int32)
    ref = pa.fused_qa_ctx_attention(
        *(jnp.asarray(x) for x in args), jnp.zeros((), jnp.int32),
        jnp.asarray(targets), 10.0, jnp.float32, 0.0, raw_mode)
    ours = qa_ctx_attention.qa_ctx_attention_plain(
        *(t(x) for x in args), scale=10.0, raw_mode=raw_mode,
        targets=torch.from_numpy(targets))
    if raw_mode == "none":
        ref, ours = (ref,), (ours,)
    assert len(ours) == len(ref)
    assert ours[0].shape[-1] == d
    for o, r in zip(ours, ref):
        assert np.isfinite(o.numpy()).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("d", WIDTHS)
def test_tri_bridge_plain_matches_pallas_at_width(d):
    args = bridge_inputs(d=d, seed=4)
    jargs = [jnp.asarray(x) for x in args]
    fused = tb.fused_tri_bridge(*jargs, jnp.zeros((), jnp.int32),
                                jnp.float32, 0.0)
    ours = tri_bridge.tri_bridge_plain(*(t(x) for x in args))
    assert ours.shape[-1] == d
    np.testing.assert_allclose(ours.numpy(), np.asarray(fused), **TOL)


@pytest.mark.parametrize("mode", ["reduce", "zero_mask", "full"])
@pytest.mark.parametrize("d", WIDTHS)
def test_encoder_plain_matches_pallas_at_width(d, mode):
    k = 5 if mode == "reduce" else 7
    x, pe, p, mask = encoder_inputs(d=d, k=k, seed=5)
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    tp = {key: t(v) for key, v in p.items()}
    if mode == "reduce":
        ref = pe_mod.fused_encoder_block(
            jnp.asarray(x), jnp.asarray(pe), jp, jnp.zeros((), jnp.int32), k,
            jnp.float32, 0.0, reduce_mask=jnp.asarray(mask))
        ours = encoder.encoder_reduce_plain(t(x), t(pe), tp, k, t(mask))
        valid = 1.0
    else:
        zm = None
        if mode == "zero_mask":      # a (G, L) length mask of merged streams
            lens = np.array([8, 8, 5, 5, 3, 3])
            zm = (np.arange(x.shape[2])[None] < lens[:, None]).astype(
                np.float32)
            x = x * zm[None, :, :, None]
        ref = pe_mod.fused_encoder_block(
            jnp.asarray(x), jnp.asarray(pe), jp, jnp.zeros((), jnp.int32), k,
            jnp.float32, 0.0,
            zero_mask=None if zm is None else jnp.asarray(zm))
        ours = encoder.encoder_block_plain(
            t(x), t(pe), tp, k, None if zm is None else t(zm))
        valid = 1.0 if zm is None else zm[None, :, :, None]
    assert ours.shape[-1] == d
    np.testing.assert_allclose(ours.numpy() * valid, np.asarray(ref) * valid,
                               **TOL)


# ------------------------------------------------ STAGE and the serving CLI
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("hsz", WIDTHS)
def test_eval_forward_matches_jax_pallas_at_hsz(hsz, merged):
    batch = tiny_batch()
    batch["vid_mask"][0, 1, 2:] = 0.0
    batch["sub_mask"][0, 2, 4:] = 0.0
    batch["qas_mask"][0, 2, 5:] = 0.0
    if merged:
        batch = to_dedup(batch)
    jcfg = tiny_cfg(hsz=hsz, use_pallas=True, add_local=True,
                    merge_input_streams=merged)
    got, ref = run_both(jcfg, batch)
    assert got["vid_raw_s"].shape == ref["vid_raw_s"].shape
    assert_outputs_match(got, ref, ALL_KEYS)


def test_inference_cli_json_at_hsz_256_matches_jax(tmp_path):
    """The CLI (``python -m tvqaplus_tpu_torch.inference``, run in process
    on the CPU) on a run directory holding the JAX model's weights: the
    answers and spans identical, the grounding records at 1e-4."""
    jcfg, _ = configs(hsz=256, synthetic_n_valid=10)
    jmodel, params, sd = jax_params_and_state_dict(jcfg)
    cfg = Config(**{**TINY, "hsz": 256, "synthetic_n_valid": 10})
    cfg.save(str(tmp_path / "opt.json"))
    torch.save(sd, tmp_path / "best_valid.pth")
    got = cli("--model_dir", str(tmp_path))
    ref = JaxRunner(jcfg, jmodel, params).run(
        JaxSynthetic(jcfg, 10, mode="valid"), mode="valid",
        object_word_ids=list(range(3, 1000)))
    ref = json.loads(json.dumps(ref))
    assert got["ts_answer"] == ref["ts_answer"]
    assert sum(len(r) for q in ref["raw_bbox"] for r in q.values()) > 0
    assert json.dumps(_adopt_ref_floats(got["raw_bbox"], ref["raw_bbox"])) \
        == json.dumps(ref["raw_bbox"])


# ---------------------------------------------- the launch's Python side
def test_width_table():
    assert widths.FORWARD_WIDTHS == (64, 128, 256)
    assert [widths.instantiation(d) for d in widths.FORWARD_WIDTHS] == [
        "resident", "resident", "streamed"]
    for mod in (qa_ctx_attention, tri_bridge, encoder):
        assert set(mod.FWD_BY_WIDTH) == set(widths.FORWARD_WIDTHS)
        assert mod.KERNEL is mod.FWD_BY_WIDTH[128]
        kernels = list(mod.FWD_BY_WIDTH.values())
        assert len({id(k) for k in kernels}) == 3      # a count per width
        assert {(k.source, k.symbol) for k in kernels} == {
            (mod.KERNEL.source, mod.KERNEL.symbol)}   # one C entry
    assert encoder.BLOCK_KERNEL is encoder.BLOCK_BY_WIDTH[128]


@pytest.mark.parametrize("family", widths.FAMILIES)
@pytest.mark.parametrize("d", widths.FORWARD_WIDTHS)
def test_shared_memory_fits_an_h100_block(family, d):
    tc = widths.tc_smem_bytes(family, d)
    f32 = widths.f32_smem_bytes(family, d)
    assert 0 < tc <= widths.SMEM_LIMIT
    assert 0 < f32 <= widths.SMEM_LIMIT
    # the D = 128 layouts are the ones the sources' notes give
    if d == 128:
        assert tc == {"qa_ctx_attention": 231_168, "tri_bridge": 220_672,
                      "encoder": 166_912}[family]


@pytest.mark.parametrize("family", widths.FAMILIES)
def test_streamed_width_would_not_fit_resident(family):
    """Why D = 256 streams: its weight alone, resident in bf16, is over the
    limit (W 3D x D; the encoder's two D x D)."""
    d = 256
    resident_w = (2 * d * d if family == "encoder" else 3 * d * d) * 2
    assert resident_w > widths.SMEM_LIMIT


def test_width_384_is_refused_with_the_widths_and_roadmap_item():
    """Past 256 no instantiation takes a width: the width rule and each
    kernel's check refuse D = 384, naming the widths and ROADMAP A10d;
    D = 96 is taken, in the 128 instantiation."""
    d, msg = 384, "64, 128 and 256"
    with pytest.raises(ValueError, match="up to 256.*A10d"):
        widths.check_width("encoder", d)
    with pytest.raises(ValueError, match="A10d"):
        widths.padded_width(d)
    xs, pes, ps, masks = encoder_inputs(d=d)
    packed = encoder.pack_params({k: t(v) for k, v in ps.items()})
    with pytest.raises(ValueError, match=msg) as e:
        encoder._check(t(xs), t(pes), packed, 5, reduce_mask=t(masks))
    assert "A10d" in str(e.value)
    s, v, *params = (t(a) for a in bridge_inputs(d=d))
    with pytest.raises(ValueError, match=msg):
        tri_bridge._check(s, v, params)
    args = [t(a) for a in attn_inputs(d=d)]
    with pytest.raises(ValueError, match=msg):
        qa_ctx_attention._check(*args, "full", None)
    with pytest.raises(ValueError, match=msg):
        widths.instantiation(d)
    widths.check_width("encoder", 96)
    assert widths.padded_width(96) == 128
    assert widths.instantiation(widths.padded_width(96)) == "resident"


@pytest.mark.parametrize("d", WIDTHS)
def test_forward_checks_pass_and_backward_checks_refuse_at_width(d):
    """The forward and the backward wrappers take D = 64 and 256 (the
    backward kernels of csrc/*_bwd_wide.cu), and D = 96 once padded to its
    instantiation (the wrappers' ``pad_inputs``); the backward checks
    refuse a width no kernel is built for (D = 384 here) and name ROADMAP
    A10d."""
    for width, ok in ((d, True), (96, True), (384, False)):
        xs, pes, ps, masks = encoder_inputs(d=width)
        s, v, *params = (t(a) for a in bridge_inputs(d=width))
        args = [t(a) for a in attn_inputs(d=width)]
        if width == 96:                  # what the wrappers launch
            dp = widths.padded_width(width)
            xs, pes, ps = encoder.pad_inputs(
                t(xs), t(pes), {k: t(p) for k, p in ps.items()}, dp)
            s, v, params = tri_bridge.pad_inputs(s, v, params, dp)
            args = list(qa_ctx_attention.pad_inputs(
                *args[:4], *args[6:], dp))
            args = args[:4] + [t(a) for a in attn_inputs(d=width)[4:6]] \
                + args[4:]
        packed = encoder.pack_params({k: t(v) for k, v in ps.items()})
        calls = (lambda: encoder._check(t(xs), t(pes), packed, 5,
                                        reduce_mask=t(masks), backward=True),
                 lambda: tri_bridge._check(s, v, params, backward=True),
                 lambda: qa_ctx_attention._check(*args, "full", None,
                                                 backward=True))
        if ok:
            encoder._check(t(xs), t(pes), packed, 5, reduce_mask=t(masks))
            tri_bridge._check(s, v, params)
            qa_ctx_attention._check(*args, "full", None)
            for call in calls:
                call()
            continue
        for call in calls:
            with pytest.raises(ValueError, match="backward kernels.*A10d"):
                call()


def test_cuda_trains_widths_to_256_and_refuses_wider_at_construction(
        monkeypatch, tmp_path):
    """The Trainer and the train CLI on a (faked) cuda device take hsz 64
    to 256 (96 and 200 padded to an instantiation).  hsz 384 is refused
    before any step and before a run directory is written, naming the
    widths and A10d; on the CPU every width trains."""
    cuda = torch.device("cuda")
    for hsz in (64, 96, 128, 200, 256):
        widths.check_trainable(hsz, cuda)
    with pytest.raises(ValueError, match="A10d"):
        widths.check_trainable(384, cuda)
    widths.check_trainable(384, torch.device("cpu"))
    widths.check_trainable(256, "cpu")
    class PastTheCheck(Exception):
        """Raised by the first step after the width check (this host has
        no card to build the model on)."""

    def past(*a, **k):
        raise PastTheCheck

    monkeypatch.setattr(loop, "resolve_device", lambda device=None: cuda)
    monkeypatch.setattr(loop, "STAGE", past)
    for hsz in (384, 256, 96, 64):
        _, cfg = configs(hsz=hsz)
        with pytest.raises(PastTheCheck if hsz != 384 else ValueError,
                           match=None if hsz != 384 else "up to 256.*A10d"):
            loop.Trainer(cfg, "cuda")
    monkeypatch.setattr(port_main, "resolve_device",
                        lambda device=None: cuda)
    monkeypatch.setattr(port_main.dp, "make_mesh", past)
    base = tmp_path / "runs"
    for hsz in (384, 256, 96):
        with pytest.raises(PastTheCheck if hsz != 384 else ValueError,
                           match=None if hsz != 384 else "A10d"):
            port_main.main(["--synthetic_data", "--debug", "--hsz", str(hsz),
                            "--device", "cpu", "--results_dir_base",
                            str(base)])
        assert not base.exists()


def test_cpu_trainer_steps_at_hsz_64(tmp_path):
    """On the CPU the port trains at any width, as before."""
    _, cfg = configs(hsz=64)
    cfg.results_dir = str(tmp_path)          # the trainer's log files
    trainer = loop.Trainer(cfg, "cpu")
    pipe = DataPipeline(SyntheticTVQADataset(cfg, 4, mode="train"), cfg,
                        "cpu", batch_size=4, train=True, seed=1)
    batch, _, _ = next(iter(pipe))
    metrics = trainer.train_step(batch)
    assert np.isfinite(float(metrics["loss"]))


def test_chip_smoke_reads_each_widths_instantiation_from_a_trace():
    """``chip_smoke.py`` finds the tensor-core forwards of the width it
    served in a profiler trace's kernel names, and no others."""
    import chip_smoke
    ns = "void (anonymous namespace)::"
    names = {f"{ns}encoder_fwd_tc_kernel<128, 5>(x)": 1,
             f"{ns}tri_bridge_fwd_tc_kernel<128>(x)": 1,
             f"{ns}encoder_fwd_tc_wide_kernel<5>(x)": 1,
             f"{ns}encoder_fwd_tc_wide_kernel<7>(x)": 1,
             f"{ns}tri_bridge_fwd_tc256_kernel<false>(x)": 1}
    chip_smoke.check_tc_forwards("serve", names, False, 128)
    chip_smoke.check_tc_forwards("serve", names, True, 256)
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.check_tc_forwards("serve", names, True, 128)
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.check_tc_forwards("serve", names, False, 64)
    names[f"{ns}encoder_fwd_kernel<256, 5>(x)"] = 1     # a CUDA-core one
    with pytest.raises(AssertionError, match="CUDA-core"):
        chip_smoke.check_tc_forwards("serve", names, False, 256)
