"""The encoder's other configurations in the PyTorch port against the JAX
package: ``MultiHeadedAttention`` (with the reference's query-row mask),
``NormalizeScale``, ``context_query_attention``, ``EncoderBlock`` /
``StackedEncoder`` with attention heads and conv depths other than 2, the
encoder kernel's route (on exactly where JAX's predicate runs its Pallas
kernel), STAGE's eval forward and one train step with heads, and the weight
bridge's attention leaves.  float32, eval unless stated, inputs from a
numpy seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_stage_model import tiny_batch, tiny_cfg
from tests.test_torch_layers import flax_params, load, rand, run_torch
from tests.test_torch_stage import assert_outputs_match, run_both, to_dedup
from tests.test_torch_train import check_train_step_against_jax
from tvqaplus_tpu.models import attention as jattn
from tvqaplus_tpu.models import layers as jl
from tvqaplus_tpu.models.stage import STAGE as JaxSTAGE
from tvqaplus_tpu.ops import pallas_encoder
from tvqaplus_tpu_torch.interop.weights import (
    _dense_to_sd,
    _dsconv_to_sd,
    _ln_to_sd,
    flax_from_params,
    params_from_flax,
)
from tvqaplus_tpu_torch.models import attention as tattn
from tvqaplus_tpu_torch.models import layers as tl
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
D = 16
HEADS = dict(cls_encoder_n_heads=4, input_encoder_n_heads=2,
             cls_encoder_n_conv=3)


def valid_mask(shape, seed):
    m = (np.random.default_rng(seed).random(shape) > 0.3).astype(np.float32)
    m[..., 0] = 1.0
    return m


def mha_sd(p, prefix=""):
    sd = {}
    for i, leaf in enumerate(("q", "k", "v", "out")):
        _dense_to_sd(sd, f"{prefix}linears.{i}", p[leaf])
    return sd


def block_sd(p, n_conv, heads, prefix=""):
    sd = {}
    for i in range(n_conv):
        _ln_to_sd(sd, f"{prefix}layer_norm.{i}", p[f"ln_{i}"])
        _dsconv_to_sd(sd, f"{prefix}conv.{i}", p[f"conv_{i}"])
    if heads:
        _ln_to_sd(sd, f"{prefix}attn_layer_norm", p["attn_ln"])
        sd.update(mha_sd(p["attn"], f"{prefix}attn."))
    _ln_to_sd(sd, f"{prefix}final_layer_norm", p["final_ln"])
    return sd


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_multi_headed_attention_matches_jax(lead):
    x = rand(lead + (7, D))
    mask = valid_mask(lead + (7,), 1)
    mod = jl.MultiHeadedAttention(num_heads=4)
    p = flax_params(mod, x, mask, train=False)
    ref = mod.apply({"params": p}, x, mask, train=False)
    got = run_torch(load(tl.MultiHeadedAttention(D, 4), mha_sd(p)), x,
                    mask)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_multi_headed_attention_masks_query_rows():
    """The reference's quirk (JAX tests/test_layers.py:134-140): the mask
    acts on the *query* rows.  A valid row attends over every key, padded
    ones included, as with no mask at all; a padded row attends uniformly,
    so its output is the output projection of the keys' mean value."""
    x = rand((1, 5, 8), seed=4)
    mask = np.array([[1, 1, 1, 0, 0]], np.float32)
    mod = jl.MultiHeadedAttention(num_heads=2)
    p = flax_params(mod, x, mask, train=False)
    ref = np.asarray(mod.apply({"params": p}, x, mask, train=False))
    block = load(tl.MultiHeadedAttention(8, 2), mha_sd(p))
    got = run_torch(block, x, mask)
    np.testing.assert_allclose(got, ref, **TOL)
    free = run_torch(block, x)
    np.testing.assert_allclose(got[:, :3], free[:, :3], **TOL)
    with torch.no_grad():
        lin = block.linears
        v = lin[2](torch.from_numpy(x)).mean(1)
        uniform = lin[3](v).numpy()
    np.testing.assert_allclose(got[0, 3:], np.repeat(uniform, 2, 0), **TOL)


def test_normalize_scale_matches_jax():
    x = rand((4, 6, D), seed=2)
    x[1] = 0.0                          # the 1e-12 floor
    mod = jl.NormalizeScale(D)
    p = flax_params(mod, x)
    ref = mod.apply({"params": p}, x)
    ours = tl.NormalizeScale(D)
    ours.load_state_dict({"weight": torch.from_numpy(np.asarray(
        p["weight"]))})
    np.testing.assert_allclose(run_torch(ours, x), np.asarray(ref), **TOL)
    assert float(tl.NormalizeScale(3).weight.detach()[0]) == 20.0


def test_context_query_attention_matches_jax():
    c, q = rand((2, 3, 6, D), 5), rand((2, 3, 5, D), 6)
    cm, qm = valid_mask((2, 3, 6), 7), valid_mask((2, 3, 5), 8)
    qm[1, 2] = 0.0                      # a context with no valid query
    ref = jattn.context_query_attention(c, q, cm, qm)
    got = tattn.context_query_attention(*map(torch.from_numpy,
                                             (c, q, cm, qm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# --------------------------------------------------------------- encoders
@pytest.mark.parametrize("n_conv,heads", [(3, 4), (2, 4), (3, 0), (1, 2)])
@pytest.mark.parametrize("reduce", [False, True])
def test_encoder_block_matches_jax(n_conv, heads, reduce):
    x = rand((2, 3, 8, D), seed=n_conv + heads)
    mask = valid_mask(x.shape[:-1], 3)
    mask[0, 1] = 0.0                     # an all-masked group
    mod = jl.EncoderBlock(D, n_conv, 5, heads, 0.1)
    p = flax_params(mod, x, mask, train=False)
    kw = {"reduce_mask": mask} if reduce else {}
    ref = mod.apply({"params": p}, x, mask, train=False, **kw)
    block = load(tl.EncoderBlock(D, n_conv, 5, heads),
                 block_sd(p, n_conv, heads))
    tkw = {"reduce_mask": torch.from_numpy(mask)} if reduce else {}
    got = run_torch(block, x, mask=torch.from_numpy(mask), **tkw)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_stacked_encoder_with_heads_matches_jax():
    x = rand((2, 5, 3, 8, D), seed=9)
    mask = valid_mask(x.shape[:-1], 10)
    mod = jl.StackedEncoder(2, 3, 5, 4, 0.1)
    p = flax_params(mod, x, mask, train=False, reduce_mask=mask)
    ref = mod.apply({"params": p}, x, mask, train=False, reduce_mask=mask)
    sd = {**block_sd(p["block_0"], 3, 4, "stacked_encoderBlocks.0."),
          **block_sd(p["block_1"], 3, 4, "stacked_encoderBlocks.1.")}
    stack = load(tl.StackedEncoder(2, 3, 5, 4, D), sd)
    got = run_torch(stack, x, reduce_mask=torch.from_numpy(mask),
                    mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("n_conv,heads", [(2, 0), (2, 4), (3, 0), (1, 0)])
@pytest.mark.parametrize("mode", ["reduce", "full", "full_zero_mask"])
def test_encoder_kernel_route_is_jax_predicate(monkeypatch, n_conv, heads,
                                               mode):
    """The port's encoder kernel runs at exactly the calls where the JAX
    block (``use_pallas``) runs its Pallas kernel: n_conv 2 and no heads;
    any other block takes the plain chain in both packages."""
    x = rand((2, 3, 8, D), seed=11)
    mask = valid_mask(x.shape[:-1], 12)
    zero = valid_mask((3, 8), 13) if mode == "full_zero_mask" else None
    calls = {"jax": 0, "port": 0}

    def jax_stub(xg, pe, params, seed, k, dtype, rate, rm, zm):
        calls["jax"] += 1
        return jnp.zeros(xg.shape if rm is None
                         else xg.shape[:-2] + xg.shape[-1:])

    def port_stub(xg, *args, **kw):
        calls["port"] += 1
        lead = xg.shape[:-2] if mode == "reduce" else xg.shape[:-1]
        return torch.zeros(lead + xg.shape[-1:])

    monkeypatch.setattr(pallas_encoder, "fused_encoder_block", jax_stub)
    monkeypatch.setattr(tl, "encoder_reduce", port_stub)
    monkeypatch.setattr(tl, "encoder_block", port_stub)
    mod = jl.EncoderBlock(D, n_conv, 5, heads, 0.1, use_pallas=True)
    p = flax_params(jl.EncoderBlock(D, n_conv, 5, heads, 0.1), x, mask,
                    train=False)
    kw = {"reduce_mask": mask} if mode == "reduce" else {"zero_mask": zero}
    mod.apply({"params": p}, x, mask, train=False, **kw)
    block = tl.EncoderBlock(D, n_conv, 5, heads, use_kernel=True)
    tkw = {k: None if v is None else torch.from_numpy(v)
           for k, v in kw.items()}
    run_torch(block, x, mask=torch.from_numpy(mask), **tkw)
    want = int(n_conv == 2 and heads == 0)
    assert calls == {"jax": want, "port": want}
    assert block.fused(torch.from_numpy(x), **tkw) == bool(want)


# ------------------------------------------------------------------ STAGE
@pytest.mark.parametrize("dedup", [False, True])
def test_stage_eval_forward_with_heads_matches_jax(dedup):
    """The tiny STAGE with heads in both encoders and a 3-conv cls encoder,
    the JAX side on its Pallas path (interpret mode): the attention and
    tri-bridge kernels fused, both encoders on the plain chain."""
    batch = tiny_batch()
    batch["qas_mask"][0, 2, 5:] = 0.0
    batch["vid_mask"][0, 1, 2:] = 0.0
    if dedup:
        batch = to_dedup(batch)
    jcfg = tiny_cfg(add_local=True, use_pallas=True, **HEADS)
    got, ref = run_both(jcfg, batch)
    assert_outputs_match(got, ref, ("answer_scores", "t_scores", "vid_raw_s",
                                    "sub_raw_s"))


def test_one_train_step_with_heads_matches_the_jax_trainer(tmp_path):
    """One train step with heads in both encoders and a 3-conv cls
    encoder; ``merge_input_streams`` is set and falls back to the separate
    streams in both packages (input-encoder heads, JAX stage.py:336-344)."""
    model = check_train_step_against_jax(tmp_path, merge_input_streams=True,
                                         **HEADS)
    names = dict(model.named_parameters())
    assert "cls_encoder.stacked_encoderBlocks.0.attn.linears.3.weight" \
        in names and "cls_encoder.stacked_encoderBlocks.0.conv.2." \
        "pointwise_conv.weight" in names
    assert float(names["input_encoder.stacked_encoderBlocks.0."
                       "attn.linears.0.weight"].grad.abs().max()) > 0


# ----------------------------------------------------------- weight bridge
def test_weight_bridge_round_trip_with_attention_leaves():
    jcfg = tiny_cfg(add_local=True, **HEADS)
    params = JaxSTAGE(jcfg).init({"params": jax.random.PRNGKey(1)},
                                 tiny_batch(), train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = params_from_flax(params, jcfg)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    model = STAGE(ModelConfig(**{n: getattr(jcfg, n) for n in names}))
    model.load_state_dict(sd, strict=True)
    attn = [k for k in sd if ".attn." in k or "attn_layer_norm" in k]
    assert len(attn) == 2 * (8 + 2)      # two encoders, 4 linears + an LN
    back = flax_from_params(model.state_dict(), jcfg)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        np.testing.assert_array_equal(flat_b[k], v, err_msg=str(k))
