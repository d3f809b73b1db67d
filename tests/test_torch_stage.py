"""The PyTorch port's STAGE eval forward against the JAX STAGE with the
same weights and batch: at the tiny config of tests/test_stage_model.py
with the fused Pallas path (interpret mode), and at the reference widths
(hsz 128, BERT-768 inputs, Lqa 40, 25 regions) on the plain XLA path.
Bars are those of tests/test_stage_pallas.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_reference_parity import _np_batch
from tests.test_stage_model import tiny_batch, tiny_cfg
from tvqaplus_tpu.models.stage import STAGE as JaxSTAGE
from tvqaplus_tpu.models.stage import ModelConfig as JaxModelConfig
from tvqaplus_tpu_torch.interop.weights import params_from_flax
from tvqaplus_tpu_torch.models.layers import Dropout
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig

torch.set_num_threads(1)
BARS = {"answer_scores": dict(rtol=2e-4, atol=2e-4),
        "t_scores": dict(rtol=2e-4, atol=2e-3),
        "vid_raw_s": dict(rtol=2e-4, atol=2e-4),
        "sub_raw_s": dict(rtol=2e-4, atol=2e-4)}
REF_DIMS = dict(B=2, A=5, LI=3, LQA=40, LS=10, LR=25, DE=768, DV=300,
                H=128)


def to_dedup(batch):
    """The expanded sub_bert windows re-expressed in the sub_dedup contract
    (one token stream per example, slot 0 the zero token)."""
    b = dict(batch)
    sub = b.pop("sub_bert")
    bsz, li, ls, de = sub.shape
    b["sub_tokens"] = np.concatenate(
        [np.zeros((bsz, 1, de), np.float32), sub.reshape(bsz, li * ls, de)],
        axis=1)
    idx = 1 + np.arange(li * ls, dtype=np.int32).reshape(li, ls)
    b["sub_win_idx"] = np.where(b["sub_mask"] > 0, idx[None], 0).astype(
        np.int32)
    return b


def run_both(jcfg, batch, **fwd):
    params = JaxSTAGE(dataclasses.replace(jcfg, use_pallas=False)).init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False)["params"]
    ref = JaxSTAGE(jcfg).apply({"params": params}, batch, train=False, **fwd)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    model = STAGE(ModelConfig(**{n: getattr(jcfg, n) for n in names}))
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), jcfg), strict=True)
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()}, **fwd)
    return got, ref


def assert_outputs_match(got, ref, keys):
    for k in keys:
        g, r = got[k].float().numpy(), np.asarray(ref[k])
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, err_msg=k, **BARS[k])


@pytest.mark.parametrize("variant,kw,dedup", [
    ("add_local", dict(add_local=True), False),
    ("add_local_dedup", dict(add_local=True), True),
    ("global_pool", dict(), False),
    ("t_iter", dict(add_local=True, t_iter=1), False),
])
def test_eval_forward_matches_jax_pallas_tiny(variant, kw, dedup):
    batch = tiny_batch()
    batch["vid_mask"][0, 1, 2:] = 0.0
    batch["vid_mask"][1, 3, :] = 0.0      # a frame with no regions
    batch["ts_mask"][1, 3] = 0.0
    batch["qas_mask"][0, 2, 5:] = 0.0
    if dedup:
        batch["sub_mask"][0, 2, 4:] = 0.0
        batch = to_dedup(batch)
    got, ref = run_both(tiny_cfg(use_pallas=True, **kw), batch)
    assert_outputs_match(got, ref, ("answer_scores", "t_scores", "vid_raw_s",
                                    "sub_raw_s"))


@pytest.mark.parametrize("dedup", [False, True])
def test_eval_forward_matches_jax_at_reference_widths(dedup):
    d = REF_DIMS
    jcfg = JaxModelConfig(hsz=d["H"], bridge_hsz=300, embedding_size=d["DE"],
                          vfeat_size=d["DV"], add_local=True)
    batch = _np_batch(dims=d)
    if dedup:
        batch = to_dedup(batch)
    got, ref = run_both(jcfg, batch, need_sub_raw=False)
    assert "sub_raw_s" not in got
    assert_outputs_match(got, ref, ("answer_scores", "t_scores",
                                    "vid_raw_s"))


def test_train_forward_matches_jax_pallas_tiny(max_num_proposal=2):
    """The training forward at dropout 0 (JAX: its Pallas kernels in
    interpret mode, raw mode "target"): (B, P, A) scores over the
    GT-anchored proposals, their weights, the span logits and the target
    answer's raw scores."""
    batch = tiny_batch()
    # a frame with no regions, outside the span mask (inside it, both
    # packages push the encoder's -1e10 row through LayerNorms and get
    # float32 cancellation: -4.8e7 logits in JAX, 0 here)
    batch["vid_mask"][1, 3, :] = 0.0
    batch["ts_mask"][1, 3] = 0.0
    jcfg = tiny_cfg(use_pallas=True, add_local=True, dropout=0.0,
                    max_num_proposal=max_num_proposal)
    params = JaxSTAGE(dataclasses.replace(jcfg, use_pallas=False)).init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False)["params"]
    fwd = dict(need_sub_raw=False, need_vid_raw="target")
    ref = JaxSTAGE(jcfg).apply({"params": params}, batch, train=True, **fwd)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    model = STAGE(ModelConfig(**{n: getattr(jcfg, n) for n in names}))
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), jcfg), strict=True)
    drop = Dropout(0.0, torch.Generator(), torch.Generator())
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()}, train=True, drop=drop, **fwd)
    assert got["answer_scores"].shape == (2, 1 + max_num_proposal, 5)
    for k in ("answer_scores", "proposal_weights", "t_scores",
              "vid_raw_target_s"):
        g, r = got[k].float().numpy(), np.asarray(ref[k])
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, err_msg=k, rtol=2e-4, atol=2e-3)


def test_region_less_frame_inside_the_span_mask_is_pinned():
    """A frame with no regions (``vid_mask`` all 0) that ``ts_mask`` still
    counts.  Both packages give the frame's pooled statement -1e10 in every
    channel (the encoder's masked max) and push that constant row through
    the LayerNorms of the temporal heads, whose formula is the same on
    paper (JAX layers.py:414-423, ops/plain.py layer_norm).  They part at
    the first of those LayerNorms, in the mean of D equal float32 values:
    XLA's CPU reduction adds them one after the other and rounds (at D = 16
    the mean is off by 1024, one float32 step at 1e10), torch adds them
    pairwise and is exact.  ``x - mean`` is then -1024 against 0, the
    variance clips to 0 either way, and 1/sqrt(eps) = 316 blows the
    residue up: JAX's span logits for the frame come out at about -4.8e7,
    the port's at 0.  The JAX value follows from an evaluation order that
    its source does not fix, so the port does not chase it; this test pins
    what each package gives, and that nothing else differs."""
    import jax.numpy as jnp

    from tvqaplus_tpu.models.layers import _LNParams
    from tvqaplus_tpu_torch.models.layers import LayerNorm

    row = np.full((1, 16), -1e10, np.float32)
    ln = _LNParams(16)
    jax_ln = np.asarray(ln.apply(
        ln.init(jax.random.PRNGKey(0), row, jnp.float32), row, jnp.float32))
    with torch.no_grad():
        port_ln = LayerNorm(16)(torch.from_numpy(row)).numpy()
    assert (np.abs(jax_ln) > 1e5).all()       # 1024 * 316 = 3.2e5
    assert (port_ln == 0).all()               # x - mean == 0 exactly

    batch = tiny_batch()
    batch["vid_mask"][1, 3, :] = 0.0          # ts_mask[1, 3] stays 1
    got, ref = run_both(tiny_cfg(use_pallas=True, add_local=True), batch)
    t_got, t_ref = got["t_scores"].numpy().copy(), np.array(ref["t_scores"])
    assert (t_ref[1, :, 3] < -1e6).all()      # masked in effect
    assert (t_got[1, :, 3] == 0).all()        # LN(const) = bias = 0
    t_got[1, :, 3] = t_ref[1, :, 3] = 0.0
    np.testing.assert_allclose(t_got, t_ref, **BARS["t_scores"])
    assert_outputs_match(got, ref, ("answer_scores", "vid_raw_s",
                                    "sub_raw_s"))


def test_train_mode_is_not_ported_yet():
    """Training forwards take a Dropout (rate 0 for none).  (Noun-mask
    attention, once refused here, is ported: tests/test_torch_noun_void.py
    holds it against the JAX package.)"""
    model = STAGE(ModelConfig(hsz=16, bridge_hsz=12, embedding_size=32,
                              vfeat_size=16))
    with pytest.raises(ValueError, match="drop"):
        model({}, train=True)
