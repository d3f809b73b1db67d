"""The QA-context attention in its bfloat16 compute mode: the port's plain
version on bfloat16 tensors (``qa_ctx_attention_plain``, the oracle that the
tensor-core CUDA kernels are held against on the card) against the JAX
Pallas kernels run with ``compute_dtype=jnp.bfloat16`` in interpret mode,
forward and backward, and the dropout path of the CPU wrapper against the
same function written out by hand with a Philox mask.

Both sides round every product's operands to bfloat16 at the same sites and
sum in float32 (pallas_attention.py:107-162, :323-379), so they differ by
the order of float32 sums, by an operand that such a difference moves across
a bf16 rounding boundary (one bf16 step, 2**-8 relative, in one term of a
sum), and by the bf16 rounding of the outputs.  Inputs come from numpy
seeds, rounded to bfloat16 so that both frameworks start from the same
values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import attn_inputs
from tvqaplus_tpu.ops import pallas_attention as pa
from tvqaplus_tpu_torch.ops import checks, philox, qa_ctx_attention
from tvqaplus_tpu_torch.ops.plain import layer_norm

torch.set_num_threads(1)
F32 = np.float32
BF16 = jnp.bfloat16
D = 128
# mixed: two bf16 steps of the value (the output rounding of each side, and
# a moved operand rounding) plus a small absolute term for values near 0;
# the JAX package's own bar for this mode is rtol 0.1, atol 0.05
MIXED_TOL = dict(rtol=2.0 ** -7, atol=2e-3)
# raw: bf16 x bf16 products are exact in float32; only the sum order differs
RAW_TOL = dict(rtol=1e-5, atol=1e-5)
# gradients: held relative to the largest entry of each gradient (sums of
# up to A*Lqa*Li rounded terms), plus two bf16 steps of the entry itself
GRAD_TOL = (1e-2, 2.0 ** -7)
NAMES = ("cn", "ce", "qn", "qe", "gamma", "beta", "w", "b")
DIFF = (0, 1, 2, 3, 6, 7, 8, 9)
TARGETS = np.array([1, 3], np.int32)


def round_bf16(x):
    return np.array(jnp.asarray(x).astype(BF16).astype(jnp.float32))


def inputs(lr, seed):
    """attn_inputs at D = 128 with the four activations rounded to bf16."""
    args = list(attn_inputs(d=D, b=2, a=5, li=4, lqa=8, lr=lr, seed=seed))
    for i in range(4):
        args[i] = round_bf16(args[i])
    return args


def torch_args(args, grad=False):
    ts = [torch.from_numpy(np.array(a)) for a in args]
    for i in range(4):
        ts[i] = ts[i].to(torch.bfloat16)
    if grad:
        for i in DIFF:
            ts[i].requires_grad_(True)
    return ts


def jax_forward(args, raw_mode):
    return pa._pallas_forward(
        *(jnp.asarray(a) for a in args), scale=10.0, dropout_rate=0.0, seed=0,
        interpret=True, compute_dtype=BF16, raw_mode=raw_mode,
        targets=jnp.asarray(TARGETS) if raw_mode == "target" else None)


def outputs(out, raw_mode):
    return (out, None) if raw_mode == "none" else out


@pytest.mark.parametrize("lr", [7, 50])
@pytest.mark.parametrize("raw_mode", ["full", "none", "target"])
def test_plain_bf16_forward_matches_pallas_bf16(raw_mode, lr):
    args = inputs(lr, seed=11)
    mixed_j, raw_j = outputs(jax_forward(args, raw_mode), raw_mode)
    mixed, raw = outputs(qa_ctx_attention.qa_ctx_attention_plain(
        *torch_args(args), scale=10.0, raw_mode=raw_mode,
        targets=torch.from_numpy(TARGETS)), raw_mode)
    assert mixed.dtype == torch.bfloat16 and mixed_j.dtype == BF16
    np.testing.assert_allclose(mixed.float().numpy(),
                               np.asarray(mixed_j.astype(jnp.float32)),
                               **MIXED_TOL)
    if raw_mode != "none":
        assert raw.dtype == torch.float32
        np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), **RAW_TOL)
    # the fully masked answer (0, 1) and frame (1, 2): att = 0, never NaN
    assert torch.isfinite(mixed.float()).all()


@pytest.mark.parametrize("lr", [7, 50])
@pytest.mark.parametrize("raw_mode", ["full", "none", "target"])
def test_plain_bf16_grads_match_pallas_bf16_backward(raw_mode, lr):
    args = inputs(lr, seed=12)
    ts = torch_args(args, grad=True)
    targets = torch.from_numpy(TARGETS)
    mixed_j, raw_j = outputs(jax_forward(args, raw_mode), raw_mode)
    # no cotangent on an output whose ReLU sign a rounding could flip between
    # the two sides (ops/checks.py), nor on a masked raw score
    flip = checks.attention_flip_elements(*torch_args(args))
    rng = np.random.default_rng(13)
    gm = round_bf16(rng.standard_normal(mixed_j.shape).astype(F32)
                    * ~flip.numpy())
    gr = None
    if raw_mode != "none":
        raw_np = np.asarray(raw_j)
        gr = (raw_np > -1e9).astype(F32) * rng.standard_normal(
            raw_np.shape).astype(F32)
    ref = pa._pallas_backward(
        *(jnp.asarray(a) for a in args), jnp.asarray(gm),
        jnp.asarray(gr) if gr is not None else None, mixed_j, 10.0, 0.0, 0,
        interpret=True, compute_dtype=BF16, raw_mode=raw_mode,
        targets=jnp.asarray(TARGETS) if raw_mode == "target" else None)
    mixed, raw = outputs(qa_ctx_attention.qa_ctx_attention(
        *ts, scale=10.0, raw_mode=raw_mode, targets=targets), raw_mode)
    total = (mixed.float() * torch.from_numpy(gm)).sum()
    if raw is not None:
        total = total + (raw * torch.from_numpy(gr)).sum()
    total.backward()
    for i, r, name in zip(DIFF, ref, NAMES):
        g = ts[i].grad
        assert g is not None and g.dtype == ts[i].dtype, name
        want = torch.from_numpy(np.asarray(jnp.asarray(r, jnp.float32)))
        err, bad = checks.grad_error(g, want, GRAD_TOL)
        assert bad == 0, f"{name}: {bad} outside {GRAD_TOL}, max err {err}"
    assert (ts[2].grad[1, 2] == 0).all()     # the fully masked frame


def by_hand(ts, raw_mode, p, seed):
    """The function with its bf16 rounding sites and the Philox mask written
    out (float32 tensors holding the bf16 values; the casts have gradient
    1)."""
    def r(x):
        return x.to(torch.bfloat16).to(torch.float32)
    cn, ce, qn, qe = (t.float() for t in ts[:4])
    cm, qm, gamma, beta, w, b = ts[4:]
    s = torch.einsum("bawd,bird->baiwr", cn, qn)
    smask = cm[:, :, None, :, None] * qm[:, None, :, None, :]
    masked = s - 1e10 * (1 - smask)
    pr = torch.softmax(torch.clamp(masked * 10.0, min=-3e4), -1) * smask
    att = torch.einsum("baiwr,bird->baiwd", r(pr), qe)
    ce_b = ce[:, :, None].expand_as(att)
    y = layer_norm(torch.cat([ce_b, att, ce_b * att], -1), gamma, beta,
                   clip=False)
    keep = philox.keep_mask(y.numel(), seed, p).reshape(y.shape)
    yd = torch.where(keep, y * philox.scale(p), 0.0)
    mixed = torch.relu(r(yd) @ r(w) + b).to(torch.bfloat16)
    if raw_mode == "target":
        masked = masked[torch.arange(masked.shape[0]),
                        torch.from_numpy(TARGETS).long()]
    return mixed, (None if raw_mode == "none" else masked)


@pytest.mark.parametrize("raw_mode", ["full", "none", "target"])
def test_wrapper_bf16_dropout_uses_the_philox_mask(raw_mode):
    """p = 0.1 through the CPU wrapper on bf16 tensors against the same
    function by hand.  Forward: the same roundings of the same float32
    values, so float32 sum order only (mixed within one bf16 step where that
    moves the output rounding).  Gradients: the wrapper's products also round
    the cotangent (as the kernels do), autograd through the hand version
    does not: 2**-9 relative per term, held at the gradient bar."""
    p, seed = 0.1, 77
    args = inputs(7, seed=14)
    ts, ts2 = torch_args(args, grad=True), torch_args(args, grad=True)
    mixed, raw = outputs(qa_ctx_attention.qa_ctx_attention(
        *ts, raw_mode=raw_mode, targets=torch.from_numpy(TARGETS),
        dropout_rate=p, seed=seed), raw_mode)
    want, raw_want = by_hand(ts2, raw_mode, p, seed)
    np.testing.assert_allclose(mixed.float().detach().numpy(),
                               want.float().detach().numpy(),
                               rtol=2.0 ** -8, atol=1e-5)
    rng = np.random.default_rng(15)
    g = torch.from_numpy(round_bf16(
        rng.standard_normal(mixed.shape).astype(F32)))
    tot, tot2 = (mixed.float() * g).sum(), (want.float() * g).sum()
    if raw is not None:
        np.testing.assert_allclose(raw.detach().numpy(),
                                   raw_want.detach().numpy(), **RAW_TOL)
        gr = (raw.detach() > -1e9).float() * torch.from_numpy(
            rng.standard_normal(raw.shape).astype(F32))
        tot, tot2 = tot + (raw * gr).sum(), tot2 + (raw_want * gr).sum()
    tot.backward()
    tot2.backward()
    for i, name in zip(DIFF, NAMES):
        err, bad = checks.grad_error(ts[i].grad, ts2[i].grad, GRAD_TOL)
        assert bad == 0, f"{name}: {bad} outside {GRAD_TOL}, max err {err}"


def test_float32_activations_take_no_rounding():
    """The float32 plain version is the exact function: on bf16-valued
    float32 inputs it differs from the bf16 mode (which rounds p, the LN
    output and W), and the bf16 mode's own output is bf16."""
    args = inputs(7, seed=16)
    f32 = [torch.from_numpy(np.array(a)) for a in args]
    exact = qa_ctx_attention.qa_ctx_attention_plain(*f32, raw_mode="none")
    mode = qa_ctx_attention.qa_ctx_attention_plain(*torch_args(args),
                                                   raw_mode="none")
    assert exact.dtype == torch.float32 and mode.dtype == torch.bfloat16
    diff = (exact - mode.float()).abs().max()
    assert 0 < float(diff) < 0.1


def test_flip_rows_take_the_bf16_margin():
    """Per output, not per row: at the bf16 margin well under 5% of the
    outputs lose their cotangent, though most rows hold such an output."""
    ts = torch_args(inputs(7, seed=17))
    assert checks.attention_flip_elements(*ts, eps=1e9).all()
    assert not checks.attention_flip_elements(*ts, eps=0.0)[1, 0].all()
    default = checks.attention_flip_elements(*ts)
    assert default.shape == (2, 5, 4, 8, D)
    wide = checks.attention_flip_elements(*ts, eps=10 * checks.BF16_EPS)
    assert default.sum() <= wide.sum() and (wide | ~default).all()
    assert 0 < float(default.float().mean()) < 0.05
