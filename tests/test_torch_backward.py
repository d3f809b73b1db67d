"""Gradients of the port's three fused ops against the JAX Pallas backward
kernels (``jax.grad`` through ``fused_*``: the Pallas backward kernels in
interpret mode, dropout 0), and the dropout path of each op's wrapper on
the CPU against a mask built by hand from ops/philox.py.

The CPU wrapper's backward is autograd through the plain version: the
oracle that chip_smoke.py and tests/test_torch_cuda.py hold the CUDA
backward kernels against.  Inputs are float32 from numpy seeds; the bar is
rtol/atol 1e-4 (only summation order differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import attn_inputs, bridge_inputs, encoder_inputs
from tvqaplus_tpu.ops import pallas_attention as pa
from tvqaplus_tpu.ops import pallas_encoder as pe_mod
from tvqaplus_tpu.ops import pallas_tri_bridge as tb
from tvqaplus_tpu_torch.ops import (
    checks,
    encoder,
    philox,
    qa_ctx_attention,
    tri_bridge,
)
from tvqaplus_tpu_torch.ops.plain import layer_norm

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = np.float32
SEED0 = jnp.zeros((), jnp.int32)


def leaves(arrays):
    return [torch.tensor(np.asarray(a), requires_grad=True) for a in arrays]


def assert_grads(got, ref, names):
    for g, r, name in zip(got, ref, names):
        assert g is not None, name
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------- attention
ATT_DIFF = (0, 1, 2, 3, 6, 7, 8, 9)        # cn ce qn qe gamma beta w b
ATT_NAMES = ("cn", "ce", "qn", "qe", "gamma", "beta", "w", "b")


def raw_weight(raw):
    """Cotangent weight of the raw scores: finite entries only (masked
    scores sit at -1e10)."""
    return (raw > -1e9).astype(F32) * (
        np.random.default_rng(7).standard_normal(raw.shape).astype(F32))


@pytest.mark.parametrize("raw_mode", ["none", "target", "full"])
def test_qa_ctx_attention_grads_match_pallas_backward(raw_mode):
    args = attn_inputs(seed=3)
    bsz, num_a, lqa, d = args[0].shape
    _, li, lr, _ = args[2].shape
    targets = np.array([1, 3], np.int32)[:bsz]
    gm = np.random.default_rng(5).standard_normal(
        (bsz, num_a, li, lqa, d)).astype(F32)
    raw_ref = pa.reference_impl(*(jnp.asarray(x) for x in args),
                                scale=10.0)[1]
    if raw_mode == "target":
        raw_ref = np.asarray(raw_ref)[np.arange(bsz), targets]
    gr = raw_weight(np.asarray(raw_ref))

    def jloss(*a):
        out = pa.fused_qa_ctx_attention(
            *a, SEED0, jnp.asarray(targets) if raw_mode == "target" else
            None, 10.0, jnp.float32, 0.0, raw_mode)
        mixed, raw = out if raw_mode != "none" else (out, None)
        total = jnp.sum(mixed * gm)
        return total if raw is None else total + jnp.sum(raw * gr)

    ref = jax.grad(jloss, argnums=ATT_DIFF)(*(jnp.asarray(x) for x in args))
    ts = leaves(args)
    out = qa_ctx_attention.qa_ctx_attention(
        *ts, scale=10.0, raw_mode=raw_mode,
        targets=torch.from_numpy(targets))
    mixed, raw = out if raw_mode != "none" else (out, None)
    total = (mixed * torch.from_numpy(gm)).sum()
    if raw is not None:
        total = total + (raw * torch.from_numpy(gr)).sum()
    total.backward()
    assert_grads([ts[i].grad for i in ATT_DIFF], ref, ATT_NAMES)
    # a fully masked answer (0, 1) and frame (1, 2) give zero, finite grads
    # through the attention: qn of the masked frame gets nothing
    assert (ts[2].grad[1, 2] == 0).all()


def test_qa_ctx_attention_target_mode_is_full_at_the_target():
    args = [torch.from_numpy(np.array(a)) for a in attn_inputs(seed=4)]
    targets = torch.tensor([4, 0])
    mixed_f, raw_f = qa_ctx_attention.qa_ctx_attention(*args)
    mixed_t, raw_t = qa_ctx_attention.qa_ctx_attention(
        *args, raw_mode="target", targets=targets)
    assert torch.equal(mixed_t, mixed_f)
    assert torch.equal(raw_t, raw_f[torch.arange(2), targets])
    ref = pa.fused_qa_ctx_attention(
        *(jnp.asarray(a.numpy()) for a in args), SEED0,
        jnp.asarray(targets.numpy(), jnp.int32), 10.0, jnp.float32, 0.0,
        "target")
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(ref[1]), **TOL)


def test_qa_ctx_attention_dropout_uses_the_philox_mask():
    """p = 0.1 through the wrapper against the same function with the mask
    built by hand: forward and gradients at 1e-6."""
    p, seed = 0.1, 77
    args = attn_inputs(seed=5)
    ts, ts2 = leaves(args), leaves(args)
    mixed = qa_ctx_attention.qa_ctx_attention(*ts, raw_mode="none",
                                              dropout_rate=p, seed=seed)
    cn, ce, qn, qe, cm, qm, gamma, beta, w, b = ts2
    s = torch.einsum("bawd,bird->baiwr", cn, qn)
    smask = cm[:, :, None, :, None] * qm[:, None, :, None, :]
    z = torch.clamp((s - 1e10 * (1 - smask)) * 10.0, min=-3e4)
    att = torch.einsum("baiwr,bird->baiwd", torch.softmax(z, -1) * smask, qe)
    ce_b = ce[:, :, None].expand_as(att)
    y = layer_norm(torch.cat([ce_b, att, ce_b * att], -1), gamma, beta,
                   clip=False)
    keep = philox.keep_mask(y.numel(), seed, p).reshape(y.shape)
    assert 0.85 < keep.float().mean() < 0.95
    want = torch.relu(torch.where(keep, y * philox.scale(p), 0.0) @ w + b)
    np.testing.assert_allclose(mixed.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        mixed.shape).astype(F32))
    (mixed * g).sum().backward()
    (want * g).sum().backward()
    for a, bb in zip(ts, ts2):
        if a.grad is not None:
            np.testing.assert_allclose(a.grad.numpy(), bb.grad.numpy(),
                                       rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- tri bridge
BRIDGE_NAMES = ("s", "v", "gamma_in", "beta_in", "w", "b", "gamma_out",
                "beta_out")


def test_tri_bridge_grads_match_pallas_backward():
    args = bridge_inputs(seed=2)
    g = np.random.default_rng(3).standard_normal(args[0].shape).astype(F32)

    def jloss(*a):
        return jnp.sum(tb.fused_tri_bridge(*a, SEED0, jnp.float32, 0.0) * g)

    ref = jax.grad(jloss, argnums=tuple(range(8)))(
        *(jnp.asarray(x) for x in args))
    ts = leaves(args)
    (tri_bridge.tri_bridge(*ts) * torch.from_numpy(g)).sum().backward()
    assert_grads([t.grad for t in ts], ref, BRIDGE_NAMES)


def test_tri_bridge_dropout_uses_the_philox_mask():
    p, seed = 0.1, 123
    args = bridge_inputs(seed=4)
    ts, ts2 = leaves(args), leaves(args)
    out = tri_bridge.tri_bridge(*ts, dropout_rate=p, seed=seed)
    s, v, gin, bin_, w, b, gout, bout = ts2
    y = layer_norm(torch.cat([s, v, s * v], -1), gin, bin_)
    keep = philox.keep_mask(y.numel(), seed, p).reshape(y.shape)
    want = layer_norm(torch.relu(torch.where(keep, y * philox.scale(p), 0.0)
                                 @ w + b), gout, bout)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    out.sum().backward()
    want.sum().backward()
    for a, bb in zip(ts, ts2):
        np.testing.assert_allclose(a.grad.numpy(), bb.grad.numpy(),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ encoder
def encoder_case(seed=0):
    x, pe, p, mask = encoder_inputs(k=5, seed=seed)
    # a planted tie in the max: two positions of a group share one row
    x[1, 2, 4] = x[1, 2, 1]
    mask[1, 2, 1] = mask[1, 2, 4] = 1.0
    return x, pe, p, mask


def test_encoder_reduce_grads_match_pallas_backward():
    k = 5
    x, pe, p, mask = encoder_case(seed=1)
    g = np.random.default_rng(2).standard_normal(
        x.shape[:2] + x.shape[3:]).astype(F32)

    def jloss(xj, pj):
        return jnp.sum(pe_mod.fused_encoder_block(
            xj, jnp.asarray(pe), pj, SEED0, k, jnp.float32, 0.0,
            jnp.asarray(mask)) * g)

    jx, jp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {key: jnp.asarray(v) for key, v in p.items()})
    xt = torch.tensor(x, requires_grad=True)
    pt = {key: torch.tensor(v, requires_grad=True) for key, v in p.items()}
    out = encoder.encoder_reduce(xt, torch.from_numpy(pe), pt, k,
                                 torch.from_numpy(mask))
    # the tie is real: both tied positions give the same maximum
    (out * torch.from_numpy(g)).sum().backward()
    assert_grads([xt.grad] + [pt[key].grad for key in encoder.PARAM_KEYS],
                 [jx] + [jp[key] for key in encoder.PARAM_KEYS],
                 ("x",) + encoder.PARAM_KEYS)
    assert (xt.grad[0, 1] == 0).all()          # the all-zero mask group


def test_encoder_reduce_dropout_uses_the_philox_mask():
    k, p, seed = 5, 0.1, 9
    x, pe, params, mask = encoder_case(seed=3)
    xt = torch.tensor(x, requires_grad=True)
    x2 = torch.tensor(x, requires_grad=True)
    pt = {key: torch.from_numpy(v) for key, v in params.items()}
    out = encoder.encoder_reduce(xt, torch.from_numpy(pe), pt, k,
                                 torch.from_numpy(mask), p, seed)
    h = x2 + torch.from_numpy(pe)
    for i in (0, 1):
        t = layer_norm(h, pt[f"ln{i}_s"], pt[f"ln{i}_b"])
        if i == 0:
            keep = philox.keep_mask(t.numel(), seed, p).reshape(t.shape)
            t = torch.where(keep, t * philox.scale(p), 0.0)
        tp = torch.nn.functional.pad(t, (0, 0, 2, 2))
        c = sum(pt[f"dw{i}"][j] * tp[..., j:j + t.shape[-2], :]
                for j in range(k)) + pt[f"dwb{i}"]
        h = h + torch.relu(c @ pt[f"pw{i}"] + pt[f"pwb{i}"])
    o = layer_norm(h, pt["lnf_s"], pt["lnf_b"])
    m = torch.from_numpy(mask)[..., None]
    want = (o * m + (m - 1) * 1e10).amax(-2)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    out.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), x2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------- kernel-vs-plain helpers
def test_grad_error_bar():
    want = torch.tensor([10.0, 1.0, -2.0])
    got = want + torch.tensor([0.0, 0.0105, -0.009])
    # bar: 1e-3 * max|want| + 1e-3 * |want| -> 0.011, 0.012
    assert checks.grad_error(got, want, (1e-3, 1e-3))[1] == 0
    assert checks.grad_error(got, want, (1e-3, 0.0))[1] == 1
    got[0] = float("nan")
    assert checks.grad_error(got, want, (1.0, 1.0))[1] == 1
    with pytest.raises(AssertionError, match="1 of 3"):
        checks.grad_close("g", got, want, (1.0, 1.0))


def test_flip_rows_mark_relu_inputs_near_zero():
    """ops/checks.py marks an attention output iff its ReLU input (from the
    plain version) lies within eps of 0, and a tri-bridge row iff one of its
    ReLU inputs does; a bias that zeroes one input of row 0 marks row 0."""
    args = [torch.from_numpy(np.array(a)) for a in attn_inputs(seed=6)]
    shape = args[0].shape[:2] + (args[2].shape[1],) + args[0].shape[2:]
    assert checks.attention_flip_elements(*args, eps=1e9).all()
    none = checks.attention_flip_elements(*args, eps=0.0)
    assert none.shape == shape and not none.any()
    s, v, gin, bin_, w, b, _, _ = (torch.from_numpy(np.array(a))
                                   for a in bridge_inputs(seed=5))
    y = layer_norm(torch.cat([s, v, s * v], -1), gin, bin_)
    b = b.clone()
    b[0] -= (y @ w + b).reshape(-1, b.shape[0])[0, 0]
    flip = checks.tri_bridge_flip_rows(s, v, gin, bin_, w, b, eps=1e-4)
    assert flip.reshape(-1)[0] and flip.float().mean() < 0.5


def test_encoder_flip_groups_at_the_extreme_margins():
    x, pe, p, mask = encoder_case(seed=2)
    args = (torch.from_numpy(x), torch.from_numpy(pe),
            {k: torch.from_numpy(v) for k, v in p.items()}, 5,
            torch.from_numpy(mask))
    none = checks.encoder_flip_groups(*args, eps=0.0)
    assert none.shape == x.shape[:2] and not none.any()
    assert checks.encoder_flip_groups(*args, eps=1e9).all()
