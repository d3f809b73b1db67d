"""Noun-mask attention and void vectors in the port against the JAX
package: ``structured_attention`` (outputs and gradients, float32), the
STAGE eval forward and one train step from the same flax weights, the
weight bridge for ``non_visual_vectors`` and the route predicate
(``STAGE.fused_attention``: the fused kernel runs unless a site gets void
vectors or the batch carries noun masks, as JAX's ``kernel_ok``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_stage_model import A, B, LQA, tiny_batch, tiny_cfg
from tests.test_torch_stage import BARS, run_both
from tests.test_torch_train import check_train_step_against_jax
from tvqaplus_tpu.models.attention import \
    structured_attention as jax_attention
from tvqaplus_tpu.models.stage import STAGE as JaxSTAGE
from tvqaplus_tpu_torch.interop.weights import (
    flax_from_params,
    params_from_flax,
)
from tvqaplus_tpu_torch.models.attention import structured_attention
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig

torch.set_num_threads(1)
N, LI_A, LQA_A, LR_A, D_A = 2, 3, 6, 4, 8


def port_cfg(jcfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names})


def attention_inputs(seed, n_void, noun_ndim):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((N, 5, 1, LQA_A, D_A)).astype(np.float32)
    q = rng.standard_normal((N, 1, LI_A, LR_A, D_A)).astype(np.float32)
    c_mask = (rng.random((N, 5, 1, LQA_A)) > 0.3).astype(np.float32)
    q_mask = (rng.random((N, 1, LI_A, LR_A)) > 0.3).astype(np.float32)
    c_mask[..., 0] = q_mask[..., 0] = 1.0
    q_mask[0, 0, 1] = 0.0                      # a frame with no regions
    ins = {"C": c, "Q": q, "c_mask": c_mask, "q_mask": q_mask}
    if n_void:
        ins["void_vector"] = rng.standard_normal((n_void, D_A)).astype(
            np.float32)
    if noun_ndim:
        shape = (N, 5, LQA_A) if noun_ndim == 3 else (N, 5, LI_A, LQA_A)
        ins["noun_mask"] = (rng.random(shape) > 0.5).astype(np.float32)
    cot = [rng.standard_normal((N, 5, LI_A, LQA_A, D_A)).astype(np.float32),
           rng.standard_normal((N, 5, LI_A, LQA_A, LR_A)).astype(np.float32)]
    return ins, cot


@pytest.mark.parametrize("n_void,add_void,noun_ndim", [
    (0, False, 3), (0, False, 4), (1, True, 0), (1, False, 0),
    (2, True, 0), (2, False, 0), (2, True, 3), (2, False, 4)])
def test_structured_attention_matches_jax(n_void, add_void, noun_ndim):
    """A, raw S, S_mask and S_ (void columns stripped) and the gradients of
    <A, g_a> + <S_, g_s> with respect to C, Q and the void vectors."""
    ins, (ga, gs) = attention_inputs(n_void * 10 + noun_ndim, n_void,
                                     noun_ndim)
    diff = [k for k in ("C", "Q", "void_vector") if k in ins]

    def jax_loss(*xs):
        kw = dict(ins, **dict(zip(diff, xs)))
        out = jax_attention(**kw, scale=10.0, add_void=add_void)
        return jnp.sum(out[0] * ga) + jnp.sum(out[3] * gs), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=tuple(
        range(len(diff))), has_aux=True)(*(jnp.asarray(ins[k])
                                           for k in diff))
    t = {k: torch.tensor(v, requires_grad=k in diff) for k, v in ins.items()}
    got = structured_attention(**t, scale=10.0, add_void=add_void)
    (torch.sum(got[0] * torch.from_numpy(ga))
     + torch.sum(got[3] * torch.from_numpy(gs))).backward()
    for name, g, w in zip(("A", "raw_S", "S_mask", "S_"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for k, w in zip(diff, jgrads):
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_void_vectors_promote_to_float32():
    """bf16 inputs with float32 void vectors multiply in float32, as
    ``jnp.concatenate`` promotes in the JAX package (attention.py:72-77)."""
    ins, _ = attention_inputs(5, 2, 0)
    kw = {k: v for k, v in ins.items()}
    bf = {k: (torch.from_numpy(v).to(torch.bfloat16) if k in ("C", "Q")
              else torch.from_numpy(v)) for k, v in kw.items()}
    jbf = {k: (jnp.asarray(v, jnp.bfloat16) if k in ("C", "Q")
               else jnp.asarray(v)) for k, v in kw.items()}
    got = structured_attention(**bf, add_void=True)
    want = jax_attention(**jbf, add_void=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)


def noun_batch(seed=0):
    """``tiny_batch`` with noun masks: a seeded 0/1 mask, two answers'
    rows all zero."""
    batch = tiny_batch()
    masks = (np.random.default_rng(seed).random((B, A, LQA)) > 0.4).astype(
        np.float32)
    masks[0, 1] = masks[1, 4] = 0.0
    batch["qa_noun_masks"] = masks
    return batch


EVAL_CASES = {
    "noun_masks": (dict(), True),
    "void_add": (dict(non_visual=2, add_non_visual=True), False),
    "void_no_add": (dict(non_visual=2, add_non_visual=False), False),
    "void_and_noun_masks": (dict(non_visual=1, add_non_visual=True), True),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_forward_matches_jax(case):
    """JAX with its Pallas kernels (interpret mode) where its ``kernel_ok``
    lets them run; the port routes the same sites to the same branch."""
    kw, nouns = EVAL_CASES[case]
    batch = noun_batch() if nouns else tiny_batch()
    batch["vid_mask"][0, 1, 2:] = 0.0
    got, ref = run_both(tiny_cfg(use_pallas=True, add_local=True, **kw),
                        batch)
    for k in ("answer_scores", "t_scores", "vid_raw_s", "sub_raw_s"):
        g, r = got[k].float().numpy(), np.asarray(ref[k])
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, err_msg=k, **BARS[k])
    for k in ("sub_normalized_s", "vid_normalized_s"):
        assert (k in got) == (ref[k] is not None), k
        if k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=2e-4, atol=2e-5, err_msg=k)


def test_route_predicate():
    """The fused kernel runs at a site unless the site gets void vectors
    (vid only) or the batch carries noun masks (both sites)."""
    plain = STAGE(port_cfg(tiny_cfg()))
    void = STAGE(port_cfg(tiny_cfg(non_visual=2)))
    nouns = {"qa_noun_masks": torch.ones(1)}
    assert [plain.fused_attention(s, {}) for s in ("sub", "vid")] == \
        [True, True]
    assert [void.fused_attention(s, {}) for s in ("sub", "vid")] == \
        [True, False]
    for model in (plain, void):
        assert not any(model.fused_attention(s, nouns)
                       for s in ("sub", "vid"))


@pytest.mark.parametrize("case", ["noun_masks", "void"])
def test_one_train_step_matches_the_jax_trainer(tmp_path, case):
    """One train step (dropout 0, float32) with noun masks in the batch, or
    with two void vectors: loss, metrics, every gradient (the void vectors'
    included, nonzero) and the updated parameters against the JAX
    Trainer's step from the same weights."""
    if case == "void":
        model = check_train_step_against_jax(tmp_path, non_visual=2,
                                             add_non_visual=True)
        g = model.non_visual_vectors.grad
        assert g is not None and float(g.abs().max()) > 0
        return

    def add_masks(batch):
        masks = np.asarray(batch["qas_mask"]).copy()
        masks[:, :, ::3] = 0.0
        masks[0, 2] = 0.0
        return dict(batch, qa_noun_masks=jnp.asarray(masks))
    # both attention sites run unfused in either package; the JAX side's
    # encoder and tri bridge on XLA (their Pallas kernels are held against
    # XLA by the JAX package's own tests)
    check_train_step_against_jax(tmp_path, edit_batch=add_masks,
                                 use_pallas=False)


def test_weight_bridge_round_trips_the_void_vectors():
    cfg = tiny_cfg(non_visual=2)
    params = JaxSTAGE(cfg).init({"params": jax.random.PRNGKey(0)},
                                tiny_batch(), train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = params_from_flax(params, cfg)
    assert sd["non_visual_vectors"].shape == (2, cfg.hsz)
    model = STAGE(port_cfg(cfg))
    model.load_state_dict(sd, strict=True)
    back = flax_from_params(model.state_dict(), cfg)
    np.testing.assert_array_equal(back["non_visual_vectors"],
                                  params["non_visual_vectors"])
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    fresh = STAGE(port_cfg(cfg)).reset_parameters(
        torch.Generator().manual_seed(0))
    std = float(fresh.non_visual_vectors.detach().std())
    assert 0.005 < std < 0.05          # normal(0.02), JAX stage.py:162-167


def run_port(cfg, batch):
    model = STAGE(port_cfg(cfg)).reset_parameters(
        torch.Generator().manual_seed(1))
    with torch.no_grad():
        return model({k: torch.from_numpy(np.asarray(v))
                      for k, v in batch.items()})


def test_all_ones_noun_mask_is_the_identity():
    """JAX ``TestNounMask``: an all-ones mask leaves the answer scores as
    they are.  Here the masked batch runs the unfused route and the plain
    one the fused kernel's plain version, whose LayerNorm takes the fast
    variance (E[x^2] - E[x]^2) where ``c2q_down_projection`` takes the
    exact one: float32 rounding apart."""
    base = run_port(tiny_cfg(), tiny_batch())
    batch = tiny_batch()
    batch["qa_noun_masks"] = np.ones((B, A, LQA), np.float32)
    got = run_port(tiny_cfg(), batch)
    np.testing.assert_allclose(got["answer_scores"].numpy(),
                               base["answer_scores"].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_zero_noun_mask_changes_the_scores():
    base = run_port(tiny_cfg(), tiny_batch())
    batch = tiny_batch()
    batch["qa_noun_masks"] = np.zeros((B, A, LQA), np.float32)
    got = run_port(tiny_cfg(), batch)
    assert not np.allclose(got["answer_scores"].numpy(),
                           base["answer_scores"].numpy())
