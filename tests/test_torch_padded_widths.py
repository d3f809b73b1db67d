"""Hidden widths between the kernels' instantiations (ops/widths.py): a
width dv runs in the next instantiation Dp of 64, 128 and 256, its inputs
and parameters zero-padded to Dp, the kernels told dv (every LayerNorm's
statistics and the Philox keys), the outputs sliced back.  Here, on the
CPU, that route runs through the plain versions (``dv`` and the wrappers'
``pad_inputs``), which the kernels are held against on the card
(tests/test_torch_cuda.py ``other_widths``, chip_smoke.py):

* at dv 40, 96 and 200, forward and backward (autograd through the pads):
  the attention in raw modes "none" and "target", the tri bridge, and the
  encoder in reduce mode and in full-output mode with a zero mask, against
  the unpadded plain version (dropout 0 and 0.1: the same Philox keys) and
  the JAX package's Pallas kernels in interpret mode (dropout 0), float32,
  at 1e-4; the pad columns come out zero;
* STAGE's eval forward at hsz 96 against JAX's ``STAGE(use_pallas=True)``
  (tests/test_torch_stage.py's bars) and one train step at hsz 96 against
  the JAX Trainer (``check_train_step_against_jax``);
* the width rules: which instantiation a width takes, the weight layout of
  a [x; y; x*y] projection, the widths refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_stage_model import tiny_batch, tiny_cfg
from tests.test_torch_kernels import attn_inputs, bridge_inputs, encoder_inputs
from tests.test_torch_stage import assert_outputs_match, run_both, to_dedup
from tests.test_torch_train import check_train_step_against_jax
from tvqaplus_tpu.ops import pallas_attention as pa
from tvqaplus_tpu.ops import pallas_encoder as pe_mod
from tvqaplus_tpu.ops import pallas_tri_bridge as tb
from tvqaplus_tpu_torch.ops import encoder, qa_ctx_attention, tri_bridge
from tvqaplus_tpu_torch.ops import widths

torch.set_num_threads(1)
F32 = np.float32
DVS = (40, 96, 200)
TOL = dict(rtol=1e-4, atol=1e-4)
P_DROP, SEED = 0.1, 1234
TARGETS = np.array([1, 3], np.int32)
ALL_KEYS = ("answer_scores", "t_scores", "vid_raw_s", "sub_raw_s")


def leaves(arrays):
    return [torch.tensor(np.array(a, F32), requires_grad=True)
            for a in arrays]


def grads(out, inputs, cot):
    """The gradients of sum(out * cot) with respect to ``inputs``."""
    return torch.autograd.grad((out * cot).sum(), inputs)


def hold(name, got, want):
    np.testing.assert_allclose(
        np.asarray(got, F32), np.asarray(want, F32).reshape(
            np.shape(got)), err_msg=name, **TOL)


# ---------------------------------------------------------------- attention
ATT_DIFF = (0, 1, 2, 3, 6, 7, 8, 9)


def attention_padded(ts, dv, **kw):
    """The plain attention on inputs padded to the instantiation of dv,
    told dv; ``mixed`` sliced back."""
    dp = widths.padded_width(dv)
    cn, ce, qn, qe, g, b_, w, b = qa_ctx_attention.pad_inputs(
        *ts[:4], *ts[6:], dp)
    out = qa_ctx_attention.qa_ctx_attention_plain(
        cn, ce, qn, qe, ts[4], ts[5], g, b_, w, b, dv=dv, **kw)
    out = out if isinstance(out, tuple) else (out,)
    assert (out[0][..., dv:] == 0).all()
    return (out[0][..., :dv],) + out[1:]


@pytest.mark.parametrize("raw_mode", ["none", "target"])
@pytest.mark.parametrize("dv", DVS)
def test_padded_attention_matches_plain_and_pallas(dv, raw_mode):
    args = list(attn_inputs(d=dv, b=2, a=5, li=3, lqa=6, lr=7, seed=41))
    kw = dict(scale=10.0, raw_mode=raw_mode,
              targets=torch.from_numpy(TARGETS))
    tg = jnp.asarray(TARGETS) if raw_mode == "target" else None
    out_j = pa._pallas_forward(
        *(jnp.asarray(a) for a in args), scale=10.0, dropout_rate=0.0,
        seed=0, interpret=True, compute_dtype=jnp.float32,
        raw_mode=raw_mode, targets=tg)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    rng = np.random.default_rng(42)
    gm = rng.standard_normal(out_j[0].shape).astype(F32)
    gr = None
    if raw_mode == "target":    # a cotangent of the scores of valid pairs
        raw = np.asarray(out_j[1])
        gr = (raw > -1e9).astype(F32) * rng.standard_normal(
            raw.shape).astype(F32)
    ref = pa._pallas_backward(
        *(jnp.asarray(a) for a in args), jnp.asarray(gm),
        None if gr is None else jnp.asarray(gr), out_j[0], 10.0, 0.0, 0,
        interpret=True, compute_dtype=jnp.float32, raw_mode=raw_mode,
        targets=tg)

    def loss_grads(out, ins):
        total = (out[0] * torch.from_numpy(gm)).sum()
        if gr is not None:
            total = total + (out[1] * torch.from_numpy(gr)).sum()
        return torch.autograd.grad(total, ins)
    for rate in (0.0, P_DROP):
        ts, us = leaves(args), leaves(args)
        got = attention_padded(ts, dv, dropout_rate=rate, seed=SEED, **kw)
        want = qa_ctx_attention.qa_ctx_attention_plain(
            *us, dropout_rate=rate, seed=SEED, **kw)
        want = want if isinstance(want, tuple) else (want,)
        g_got = loss_grads(got, [ts[i] for i in ATT_DIFF])
        g_want = loss_grads(want, [us[i] for i in ATT_DIFF])
        for o, w in zip(got, want):
            hold(f"{dv} {raw_mode} {rate} out", o.detach(), w.detach())
        for i, a, b in zip(ATT_DIFF, g_got, g_want):
            hold(f"{dv} {raw_mode} {rate} grad {i}", a, b)
        if rate == 0.0:
            for o, r in zip(got, out_j):
                hold(f"{dv} {raw_mode} vs Pallas", o.detach(), r)
            for i, a, r in zip(ATT_DIFF, g_got, ref):
                hold(f"{dv} {raw_mode} grad {i} vs Pallas", a, r)


# --------------------------------------------------------------- tri bridge
@pytest.mark.parametrize("dv", DVS)
def test_padded_tri_bridge_matches_plain_and_pallas(dv):
    args = list(bridge_inputs(d=dv, shape=(1, 5, 3, 5), seed=43))
    g = np.random.default_rng(44).standard_normal(
        args[0].shape).astype(F32)
    fwd = tb.fused_tri_bridge(*(jnp.asarray(a) for a in args),
                              jnp.zeros((), jnp.int32), jnp.float32, 0.0)
    ref = tb._backward(*(jnp.asarray(a) for a in args), 0, jnp.asarray(g),
                       0.0, interpret=True, compute_dtype=jnp.float32)
    dp = widths.padded_width(dv)
    for rate in (0.0, P_DROP):
        ts, us = leaves(args), leaves(args)
        s, v, params = tri_bridge.pad_inputs(ts[0], ts[1], ts[2:], dp)
        out = tri_bridge.tri_bridge_plain(s, v, *params, rate, SEED, dv=dv)
        assert (out[..., dv:] == 0).all()
        got = out[..., :dv]
        want = tri_bridge.tri_bridge_plain(*us, rate, SEED)
        hold(f"{dv} {rate} out", got.detach(), want.detach())
        cot = torch.from_numpy(g)
        g_got, g_want = grads(got, ts, cot), grads(want, us, cot)
        for i, (a, b) in enumerate(zip(g_got, g_want)):
            hold(f"{dv} {rate} grad {i}", a, b)
        if rate == 0.0:
            hold(f"{dv} vs Pallas", got.detach(), fwd)
            for i, (a, r) in enumerate(zip(g_got, ref)):
                hold(f"{dv} grad {i} vs Pallas", a, r)


# ------------------------------------------------------------------ encoder
@pytest.mark.parametrize("kind", ["reduce", "zero_mask"])
@pytest.mark.parametrize("dv", DVS)
def test_padded_encoder_matches_plain_and_pallas(dv, kind):
    k = 5 if kind == "reduce" else 7
    x, pe, p, mask = encoder_inputs(d=dv, b=2, g=6, l=9, k=k, seed=45)
    zm = None
    if kind == "zero_mask":      # a (G, L) length mask of merged streams
        lens = np.array([9, 9, 7, 7, 4, 4])
        zm = (np.arange(9)[None, :] < lens[:, None]).astype(F32)
        x = x * zm[None, ..., None]
    rng = np.random.default_rng(46)
    shape = x.shape[:2] + x.shape[3:] if kind == "reduce" else x.shape
    g = rng.standard_normal(shape).astype(F32)
    if zm is not None:
        g = g * zm[None, ..., None]
    jkw = dict(reduce_mask=jnp.asarray(mask) if kind == "reduce" else None,
               zero_mask=None if zm is None else jnp.asarray(zm))
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    fwd = pe_mod.fused_encoder_block(
        jnp.asarray(x), jnp.asarray(pe), jp, jnp.zeros((), jnp.int32), k,
        jnp.float32, 0.0, **jkw)
    gx, gp = pe_mod._backward(jnp.asarray(x), jnp.asarray(pe), jp, 0,
                              jnp.asarray(g), k, 0.0, interpret=True,
                              compute_dtype=jnp.float32, **jkw)
    ref = [gx] + list(gp)
    dp = widths.padded_width(dv)
    keys = encoder.PARAM_KEYS

    def run(xt, pt, rate, padded):
        pe_t = torch.from_numpy(pe)
        kw = dict(dropout_rate=rate, seed=SEED)
        if padded:
            xt, pe_t, pt = encoder.pad_inputs(xt, pe_t, pt, dp)
            kw["dv"] = dv
        if kind == "reduce":
            out = encoder.encoder_reduce_plain(
                xt, pe_t, pt, k, torch.from_numpy(mask), **kw)
        else:
            out = encoder.encoder_block_plain(xt, pe_t, pt, k,
                                              torch.from_numpy(zm), **kw)
        if padded:       # zero, or the reduce mode's -1e10 of a group
            pad = 0.0 if kind != "reduce" else (       # with no position
                torch.from_numpy(mask).amax(-1, keepdim=True) - 1.0) * 1e10
            assert (out[..., dv:] == pad).all()
        return out[..., :dv]
    cot = torch.from_numpy(g)
    for rate in (0.0, P_DROP):
        xs, ps = leaves([x] + [p[key] for key in keys]), None
        xs, ps = xs[0], dict(zip(keys, xs[1:]))
        xu = leaves([x] + [p[key] for key in keys])
        xu, pu = xu[0], dict(zip(keys, xu[1:]))
        got, want = run(xs, ps, rate, True), run(xu, pu, rate, False)
        hold(f"{dv} {kind} {rate} out", got.detach(), want.detach())
        ins_g = [xs] + [ps[key] for key in keys]
        ins_w = [xu] + [pu[key] for key in keys]
        g_got, g_want = grads(got, ins_g, cot), grads(want, ins_w, cot)
        for name, a, b in zip(("x",) + keys, g_got, g_want):
            hold(f"{dv} {kind} {rate} grad {name}", a, b)
        if rate == 0.0:
            hold(f"{dv} {kind} vs Pallas", got.detach(), fwd)
            for name, a, r in zip(("x",) + keys, g_got, ref):
                hold(f"{dv} {kind} grad {name} vs Pallas", a, r)


# -------------------------------------------------------------------- STAGE
@pytest.mark.parametrize("merged", [False, True])
def test_eval_forward_matches_jax_pallas_at_hsz_96(merged):
    batch = tiny_batch()
    batch["vid_mask"][0, 1, 2:] = 0.0
    batch["qas_mask"][0, 2, 5:] = 0.0
    if merged:
        batch = to_dedup(batch)
    jcfg = tiny_cfg(hsz=96, use_pallas=True, add_local=True,
                    merge_input_streams=merged)
    got, ref = run_both(jcfg, batch)
    assert got["vid_raw_s"].shape == ref["vid_raw_s"].shape
    assert_outputs_match(got, ref, ALL_KEYS)


def test_one_train_step_at_hsz_96_matches_the_jax_trainer(tmp_path):
    check_train_step_against_jax(tmp_path, hsz=96)


# -------------------------------------------------------------- the rules
@pytest.mark.parametrize("dv,dp", [(4, 64), (40, 64), (64, 64), (68, 128),
                                   (96, 128), (128, 128), (200, 256),
                                   (256, 256)])
def test_each_width_runs_in_the_next_instantiation(dv, dp):
    assert widths.padded_width(dv) == dp
    widths.check_width("test", dv)


@pytest.mark.parametrize("dv", [384, 257, 98, 3, 0])
def test_widths_past_256_or_off_the_philox_groups_are_refused(dv):
    """Past 256 no instantiation is built; a width 4 does not divide would
    split a Philox call's four columns across rows."""
    with pytest.raises(ValueError, match="A10d"):
        widths.check_width("test", dv)
    with pytest.raises(ValueError, match="A10d"):
        widths.padded_width(dv)


def test_a_three_part_weight_pads_each_part_apart():
    """W (3 dv, dv) of a [x; y; x*y] input pads to [W_a; 0; W_b; 0; W_ab;
    0] by rows and zero columns past dv; a 3 dv vector third by third."""
    dv, dp = 3, 5
    w = torch.arange(9 * 3, dtype=torch.float32).reshape(9, 3) + 1
    got = widths.pad_weight(w, dp, 3)
    assert got.shape == (15, 5)
    for g in range(3):
        assert torch.equal(got[g * dp:g * dp + dv, :dv],
                           w[g * dv:(g + 1) * dv])
        assert (got[g * dp + dv:(g + 1) * dp] == 0).all()
    assert (got[:, dv:] == 0).all()
    v = torch.arange(9, dtype=torch.float32) + 1
    assert torch.equal(widths.pad_cols(v, dp, 3), torch.tensor(
        [1, 2, 3, 0, 0, 4, 5, 6, 0, 0, 7, 8, 9, 0, 0], dtype=torch.float32))
