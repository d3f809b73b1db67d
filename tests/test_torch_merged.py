"""The merged input-encoder path of the port (``merge_input_streams``)
against the JAX package: the encoder kernel's full-output / zero-mask mode
(``ops/encoder.py encoder_block``: its plain version and gradients against
the Pallas kernel in interpret mode and the pure-JAX reference), the
``EncoderBlock`` module with a zero mask, the port's merged STAGE against
its own separate-stream STAGE and against the JAX merged STAGE, the
prediction JSON, one train step against the JAX Trainer, and the flag's way
from the CLI and ``opt.json`` to the model.

Inputs are float32 from numpy seeds.  Only positions where the zero mask is
1 are contractual (tests/test_pallas_encoder.py:156): outputs are compared
there, and the cotangents are zero elsewhere.  Each tolerance is stated at
its use."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_stage_model import tiny_batch, tiny_cfg
from tests.test_torch_infer import OBJECT_WORDS, TINY
from tests.test_torch_kernels import encoder_inputs
from tests.test_torch_layers import block_sd, flax_params, load, rand
from tests.test_torch_stage import assert_outputs_match, run_both, to_dedup
from tests.test_torch_train import TINY_FLAGS, check_train_step_against_jax
from tvqaplus_tpu.models import layers as jl
from tvqaplus_tpu.ops import pallas_encoder as pe_mod
from tvqaplus_tpu_torch.config import Config, parse_args
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.infer.predict import InferenceRunner
from tvqaplus_tpu_torch.inference import main_inference
from tvqaplus_tpu_torch.main import main as train_main
from tvqaplus_tpu_torch.models import layers as tl
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
from tvqaplus_tpu_torch.ops import checks, encoder, philox
from tvqaplus_tpu_torch.ops.plain import layer_norm
from tvqaplus_tpu_torch.train import loop

torch.set_num_threads(1)
F32 = np.float32
K = 7
SEED0 = jnp.zeros((), jnp.int32)


def length_mask(g, l, seed=6):
    """(G, L) static length mask, as ``_merged_input_encode`` builds it."""
    lens = np.random.default_rng(seed).integers(2, l + 1, g)
    lens[0] = l
    return (np.arange(l)[None, :] < lens[:, None]).astype(F32)


# ----------------------------------------------------- kernel B4, plain side
@pytest.mark.parametrize("masked", [True, False])
def test_encoder_block_plain_matches_pallas_and_reference(masked):
    """Forward, on the valid positions, at atol/rtol 1e-4 (float32 sums in
    another order)."""
    x, pe, p, _ = encoder_inputs(k=K, seed=5)
    zm = length_mask(*x.shape[1:3]) if masked else None
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    jzm = None if zm is None else jnp.asarray(zm)
    fused = pe_mod._forward(jnp.asarray(x), jnp.asarray(pe), jp, 0, K, 0.0,
                            interpret=True, compute_dtype=jnp.float32,
                            zero_mask=jzm)
    ref = pe_mod.reference_impl(jnp.asarray(x), jnp.asarray(pe), jp, K,
                                zero_mask=jzm)
    pt = {key: torch.from_numpy(v) for key, v in p.items()}
    ours = encoder.encoder_block_plain(
        torch.from_numpy(x), torch.from_numpy(pe), pt, K,
        None if zm is None else torch.from_numpy(zm))
    assert ours.shape == x.shape and ours.dtype == torch.float32
    valid = np.ones(x.shape[1:3], F32)[..., None] if zm is None \
        else zm[..., None]
    for name, want in (("pallas", fused), ("reference", ref)):
        np.testing.assert_allclose(ours.numpy() * valid,
                                   np.asarray(want) * valid, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # the CPU wrapper is the plain version
    wrapped = encoder.encoder_block(
        torch.from_numpy(x), torch.from_numpy(pe), pt, K,
        None if zm is None else torch.from_numpy(zm))
    assert torch.equal(wrapped, ours)


@pytest.mark.parametrize("masked", [True, False])
def test_encoder_block_grads_match_pallas_backward(masked):
    """Autograd through the plain version (x and the 14 parameters) against
    ``fused_encoder_block``'s custom VJP (the Pallas backward kernel in
    interpret mode): every element within 1e-4 of the largest gradient plus
    1e-3 relative (``checks.grad_close``)."""
    x, pe, p, _ = encoder_inputs(k=K, seed=7)
    zm = length_mask(*x.shape[1:3], seed=8) if masked else None
    valid = np.ones(x.shape[:3] + (1,), F32) if zm is None \
        else np.broadcast_to(zm[None, ..., None], x.shape[:3] + (1,))
    g = np.random.default_rng(9).standard_normal(x.shape).astype(F32) * valid

    def jloss(xj, pj):
        return jnp.sum(pe_mod.fused_encoder_block(
            xj, jnp.asarray(pe), pj, SEED0, K, jnp.float32, 0.0, None,
            None if zm is None else jnp.asarray(zm)) * g)

    jx, jpg = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {key: jnp.asarray(v) for key, v in p.items()})
    xt = torch.tensor(x, requires_grad=True)
    pt = {key: torch.tensor(v, requires_grad=True) for key, v in p.items()}
    out = encoder.encoder_block(xt, torch.from_numpy(pe), pt, K,
                                None if zm is None else torch.from_numpy(zm))
    (out * torch.from_numpy(g)).sum().backward()
    checks.grad_close("x", xt.grad, torch.from_numpy(np.array(jx)),
                      (1e-4, 1e-3))
    for key in encoder.PARAM_KEYS:
        checks.grad_close(key, pt[key].grad,
                          torch.from_numpy(np.array(jpg[key])),
                          (1e-4, 1e-3))
    if zm is not None:      # nothing flows back into a masked position
        assert (xt.grad.numpy()[np.broadcast_to(valid, x.shape) == 0]
                == 0).all()


def test_encoder_block_dropout_uses_the_philox_mask_of_the_merged_tensor():
    """Dropout through the wrapper against a mask built by hand from
    ops/philox.py on the whole (B, G, L, D) LN output (not per stream), with
    the zero mask applied after it: 1e-6, forward and gradient."""
    rate, seed = 0.1, 11
    x, pe, p, _ = encoder_inputs(k=K, seed=3)
    zm = torch.from_numpy(length_mask(*x.shape[1:3], seed=4))
    pt = {key: torch.from_numpy(v) for key, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    x2 = torch.tensor(x, requires_grad=True)
    out = encoder.encoder_block(xt, torch.from_numpy(pe), pt, K, zm, rate,
                                seed)
    h = x2 + torch.from_numpy(pe)
    for i in (0, 1):
        t = layer_norm(h, pt[f"ln{i}_s"], pt[f"ln{i}_b"])
        if i == 0:
            keep = philox.keep_mask(t.numel(), seed, rate).reshape(t.shape)
            t = torch.where(keep, t * philox.scale(rate), 0.0)
        t = t * zm[..., None]
        tp = torch.nn.functional.pad(t, (0, 0, K // 2, K // 2))
        c = sum(pt[f"dw{i}"][j] * tp[..., j:j + t.shape[-2], :]
                for j in range(K)) + pt[f"dwb{i}"]
        h = h + torch.relu(c @ pt[f"pw{i}"] + pt[f"pwb{i}"])
    want = layer_norm(h, pt["lnf_s"], pt["lnf_b"])
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    (out * zm[..., None]).sum().backward()
    (want * zm[..., None]).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), x2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not torch.equal(out, encoder.encoder_block(
        xt, torch.from_numpy(pe), pt, K, zm, rate, seed + 1))


def test_encoder_block_flip_groups_look_at_valid_positions_only():
    x, pe, p, _ = encoder_inputs(k=K, seed=2)
    zm = np.zeros(x.shape[1:3], F32)
    zm[:, :3] = 1.0
    args = (torch.from_numpy(x), torch.from_numpy(pe),
            {k: torch.from_numpy(v) for k, v in p.items()}, K)
    none = checks.encoder_block_flip_groups(*args, torch.from_numpy(zm),
                                            eps=0.0)
    assert none.shape == x.shape[:2] and not none.any()
    assert checks.encoder_block_flip_groups(*args, None, eps=1e9).all()
    zm[1] = 0.0                       # a group with no valid position
    flagged = checks.encoder_block_flip_groups(*args, torch.from_numpy(zm),
                                               eps=1e9)
    assert not flagged[:, 1].any() and flagged[:, 0].all()


def test_encoder_wrapper_refuses_what_the_kernels_do_not_take():
    """The checks that run before a launch (they need no card)."""
    x, pe, p, _ = encoder_inputs(d=128, k=K)
    pt = {key: torch.from_numpy(v) for key, v in p.items()}
    xt, pet = torch.from_numpy(x), torch.from_numpy(pe)
    packed = encoder.pack_params(pt)
    encoder._check(xt, pet, packed, K)
    encoder._check(xt, pet, packed, K, zero_mask=torch.ones(x.shape[1:3]))
    with pytest.raises(ValueError):          # a (B, G, L) zero mask
        encoder._check(xt, pet, packed, K, zero_mask=torch.ones(x.shape[:3]))
    with pytest.raises(ValueError):          # D != 128
        encoder._check(xt[..., :64], pet[:, :64], packed, K)
    long = torch.zeros(1, 1, encoder.MAX_LEN + 1, 128)
    with pytest.raises(ValueError):          # L > MAX_LEN
        encoder._check(long, torch.zeros(long.shape[2:]), packed, K)
    with pytest.raises(ValueError):          # not contiguous
        encoder._check(xt.transpose(1, 2), pet, packed, K)


# ------------------------------------------------------------ EncoderBlock
@pytest.mark.parametrize("route", ["plain_chain", "kernel", "broadcast_mask"])
def test_encoder_block_module_with_zero_mask_matches_jax(route):
    """``EncoderBlock(zero_mask=...)`` against the JAX module (its unfused
    chain, or its Pallas kernel in interpret mode) on the valid positions at
    1e-5 (plain chain: the same float32 ops) / 1e-4 (kernel route).  A
    (B, G, L) mask is not the kernel's (G, L) layout: it takes the plain
    chain even on a block built for the kernel."""
    d, g, l = 16, 5, 8
    x = rand((2, g, l, d), seed=2)
    zm = length_mask(g, l, seed=3)
    if route == "broadcast_mask":
        zm = np.broadcast_to(zm[None], (2, g, l)).copy()
    fused = route == "kernel"
    mod = jl.EncoderBlock(d, 2, K, 0, 0.1, use_pallas=fused)
    p = flax_params(jl.EncoderBlock(d, 2, K, 0, 0.1), x, train=False)
    ref = mod.apply({"params": p}, x, train=False, zero_mask=jnp.asarray(zm))
    block = load(tl.EncoderBlock(d, 2, K, use_kernel=route != "plain_chain"),
                 block_sd(p))
    calls = []
    spy = tl.encoder_block
    tl.encoder_block = lambda *a, **kw: calls.append(1) or spy(*a, **kw)
    try:
        with torch.no_grad():
            got = block(torch.from_numpy(x), zero_mask=torch.from_numpy(zm))
    finally:
        tl.encoder_block = spy
    assert len(calls) == (1 if fused else 0)
    tol = 1e-4 if fused else 1e-5
    valid = zm[..., None]
    np.testing.assert_allclose(got.numpy() * valid, np.asarray(ref) * valid,
                               rtol=tol, atol=tol)


def test_encoder_block_built_for_the_kernel_takes_no_mask_too():
    """The flag on with a batch that has no ``sub_tokens``: the separate
    calls go through ``encoder_block`` with ``zero_mask=None``, on 5-D and
    4-D inputs alike, and equal the plain chain at 1e-5."""
    d = 16
    x = rand((2, 3, 4, 8, d), seed=5)
    p = flax_params(jl.EncoderBlock(d, 2, K, 0, 0.1), x, train=False)
    plain = load(tl.EncoderBlock(d, 2, K), block_sd(p))
    fused = load(tl.EncoderBlock(d, 2, K, use_kernel=True), block_sd(p))
    with torch.no_grad():
        for xs in (x, x[:, 0]):
            want = plain(torch.from_numpy(xs))
            got = fused(torch.from_numpy(xs))
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)


# ------------------------------------------------------------------- STAGE
def port_pair(cfg):
    """The same seeded weights in a separate-stream and a merged STAGE."""
    sep = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(0))
    cfg_m = dataclasses.replace(cfg, merge_input_streams=True)
    mer = STAGE(ModelConfig.from_config(cfg_m))
    mer.load_state_dict(sep.state_dict())
    return cfg_m, sep, mer


def step_config(tmp_path, **kw):
    """The tiny training config of tests/test_train.py small_cfg: Lqa 10,
    Ls 8, Lr 5, so every stream has another length."""
    flags = TINY_FLAGS + ["--results_dir_base", str(tmp_path / "r"),
                          "--device", "cpu"]
    cfg, _ = parse_args(flags, extra_fields=(("--device", dict(type=str)),))
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def train_batch(cfg, n=4):
    from tvqaplus_tpu_torch.data.batching import (
        StaticShapeSpec,
        collate_static,
    )
    ds = SyntheticTVQADataset(cfg, n, mode="train")
    spec = StaticShapeSpec.from_config(cfg, batch=n, train=True)
    arrays, _ = collate_static([ds[i] for i in range(n)], spec)
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def test_merged_stage_equals_separate_stage(tmp_path):
    """Port against port, unequal stream lengths (Lqa 10, Ls 8, Lr 5), the
    bars of tests/test_sub_dedup.py:189-227: eval outputs at 1e-6, the
    train loss at rtol 1e-6, every gradient at rtol 2e-5 (atol 1e-7: the
    merged call sums its parameter gradients over the three streams in one
    order, the separate calls in another)."""
    cfg = step_config(tmp_path, dropout=0.0)
    cfg_m, sep, mer = port_pair(cfg)
    batch = train_batch(cfg)
    assert "sub_tokens" in batch
    lens = {batch["qas_mask"].shape[-1], batch["sub_mask"].shape[-1],
            batch["vid_mask"].shape[-1]}
    assert len(lens) == 3
    with torch.no_grad():
        want, got = sep.eval()(batch), mer.eval()(batch)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    steps = {}
    for name, c, m in (("sep", cfg, sep), ("mer", cfg_m, mer)):
        trainer = loop.Trainer(c, "cpu", model=m)
        metrics = trainer.train_step(batch, use_hard_negatives=True)
        steps[name] = (float(metrics["loss"]),
                       {k: p.grad.clone() for k, p in m.named_parameters()})
    np.testing.assert_allclose(steps["mer"][0], steps["sep"][0], rtol=1e-6)
    for k, g in steps["sep"][1].items():
        np.testing.assert_allclose(steps["mer"][1][k].numpy(), g.numpy(),
                                   rtol=2e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_merged_eval_forward_matches_jax_merged(use_pallas):
    """Port merged STAGE against JAX merged STAGE (its Pallas kernels in
    interpret mode, or its XLA chain), same weights and batch, at the bars
    of tests/test_torch_stage.py (2e-4)."""
    batch = tiny_batch()
    batch["vid_mask"][0, 1, 2:] = 0.0
    batch["sub_mask"][0, 2, 4:] = 0.0
    batch["qas_mask"][0, 2, 5:] = 0.0
    batch = to_dedup(batch)
    jcfg = tiny_cfg(use_pallas=use_pallas, add_local=True,
                    merge_input_streams=True)
    got, ref = run_both(jcfg, batch)
    assert_outputs_match(got, ref, ("answer_scores", "t_scores", "vid_raw_s",
                                    "sub_raw_s"))


def test_merged_flag_without_sub_tokens_takes_the_separate_path():
    """JAX stage.py:342-344: no ``sub_tokens`` in the batch, no merge; the
    input encoder still runs through the kernel wrapper, without a mask."""
    batch = tiny_batch()
    jcfg = tiny_cfg(use_pallas=True, add_local=True,
                    merge_input_streams=True)
    got, ref = run_both(jcfg, batch)
    assert_outputs_match(got, ref, ("answer_scores", "t_scores", "vid_raw_s",
                                    "sub_raw_s"))


def test_one_merged_train_step_matches_the_jax_trainer(tmp_path):
    """One train step with the flag against the JAX Trainer's step with it
    (its merged kernel and backward kernel in interpret mode): loss, grads
    and the Adam update at the bars of
    tests/test_torch_train.py::test_one_train_step_matches_the_jax_trainer."""
    model = check_train_step_against_jax(tmp_path, merge_input_streams=True)
    assert model.cfg.merge_input_streams
    assert model.input_encoder.stacked_encoderBlocks[0].use_kernel


def test_prediction_json_is_the_same_with_and_without_the_flag():
    """Merging is exact in float32: the same answers and spans, and the
    same grounding records (scores equal at 1e-6)."""
    cfg = Config(**TINY).finalize("cpu")
    cfg_m, sep, mer = port_pair(cfg)
    preds = [InferenceRunner(c, m, "cpu").run(
        SyntheticTVQADataset(c, 10, mode="valid"), mode="valid",
        object_word_ids=OBJECT_WORDS) for c, m in ((cfg, sep), (cfg_m, mer))]
    assert preds[0]["ts_answer"] == preds[1]["ts_answer"]
    assert len(preds[0]["raw_bbox"]) == 10
    n_rec = 0
    for ex_a, ex_b in zip(preds[0]["raw_bbox"], preds[1]["raw_bbox"]):
        assert ex_a.keys() == ex_b.keys()
        for ans in ex_a:
            assert len(ex_a[ans]) == len(ex_b[ans])
            for ra, rb in zip(ex_a[ans], ex_b[ans]):
                n_rec += 1
                np.testing.assert_allclose(ra.pop("pred"), rb.pop("pred"),
                                           rtol=0, atol=1e-6)
                assert ra == rb
    assert n_rec > 0


def test_flag_reaches_the_model_from_the_cli_and_opt_json(tmp_path):
    """``--merge_input_streams`` on the training CLI builds a merged model
    and lands in opt.json; the inference entry point reads it back from
    there (and nothing on its own command line) and runs merged."""
    run_dir, trainer = train_main(
        TINY_FLAGS + ["--merge_input_streams", "--debug", "--device", "cpu",
                      "--results_dir_base", str(tmp_path / "results")])
    assert trainer.model.cfg.merge_input_streams
    assert trainer.model.input_encoder.stacked_encoderBlocks[0].use_kernel
    with open(f"{run_dir}/opt.json") as f:
        assert json.load(f)["merge_input_streams"] is True
    calls = []
    spy = STAGE._merged_input_encode

    def counted(self, *a, **kw):
        calls.append(1)
        return spy(self, *a, **kw)
    STAGE._merged_input_encode = counted
    try:
        pred_path = main_inference(["--model_dir", run_dir, "--device",
                                    "cpu"])
    finally:
        STAGE._merged_input_encode = spy
    assert calls
    with open(pred_path) as f:
        assert len(json.load(f)["ts_answer"]) == 4
    assert not ModelConfig.from_config(Config()).merge_input_streams
    plain = STAGE(ModelConfig())
    assert not plain.input_encoder.stacked_encoderBlocks[0].use_kernel
