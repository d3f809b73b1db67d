"""The port's three forward kernels: each plain PyTorch version against the
JAX Pallas kernel (interpret mode, as the JAX package's own tests run it)
and the Pallas file's ``reference_impl``, and each CPU wrapper against its
plain version.  The CUDA kernels themselves are held against the plain
versions on a card by tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvqaplus_tpu.models.attention import l2_normalize as jax_l2
from tvqaplus_tpu.ops import pallas_attention as pa
from tvqaplus_tpu.ops import pallas_encoder as pe_mod
from tvqaplus_tpu.ops import pallas_tri_bridge as tb
from tvqaplus_tpu_torch.ops import encoder, qa_ctx_attention, tri_bridge

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = np.float32


def t(x):
    return torch.from_numpy(np.array(x, F32))


# ---------------------------------------------------------------- attention
def attn_inputs(d=16, b=2, a=5, li=3, lqa=6, lr=5, seed=0):
    rng = np.random.default_rng(seed)
    ce = rng.standard_normal((b, a, lqa, d)).astype(F32)
    qe = rng.standard_normal((b, li, lr, d)).astype(F32)
    cn, qn = np.asarray(jax_l2(ce)), np.asarray(jax_l2(qe))
    c_mask = (rng.random((b, a, lqa)) > 0.25).astype(F32)
    c_mask[..., 0] = 1
    c_mask[0, 1, :] = 0              # a fully masked answer: every row
    q_mask = (rng.random((b, li, lr)) > 0.25).astype(F32)
    q_mask[..., 0] = 1
    q_mask[1, 2, :] = 0              # a fully masked frame
    gamma = (rng.standard_normal(3 * d) * 0.1 + 1.0).astype(F32)
    beta = (rng.standard_normal(3 * d) * 0.1).astype(F32)
    w = (rng.standard_normal((3 * d, d)) / np.sqrt(3 * d)).astype(F32)
    bias = (rng.standard_normal(d) * 0.1).astype(F32)
    return cn, ce, qn, qe, c_mask, q_mask, gamma, beta, w, bias


@pytest.mark.parametrize("raw_mode", ["full", "none"])
def test_qa_ctx_attention_plain_matches_pallas(raw_mode):
    args = attn_inputs()
    ref = pa.fused_qa_ctx_attention(
        *(jnp.asarray(x) for x in args), jnp.zeros((), jnp.int32), None,
        10.0, jnp.float32, 0.0, raw_mode)
    ours = qa_ctx_attention.qa_ctx_attention_plain(
        *(t(x) for x in args), scale=10.0, raw_mode=raw_mode)
    if raw_mode == "none":
        ref, ours = (ref,), (ours,)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert np.isfinite(o.numpy()).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_qa_ctx_attention_plain_matches_reference_impl():
    args = attn_inputs(seed=1)
    mixed_ref, raw_ref = pa.reference_impl(*(jnp.asarray(x) for x in args),
                                           scale=10.0)
    mixed, raw = qa_ctx_attention.qa_ctx_attention_plain(
        *(t(x) for x in args), scale=10.0)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(mixed_ref), **TOL)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_ref), **TOL)


def test_qa_ctx_attention_masked_rows_attend_to_nothing():
    """A fully masked row attends to nothing: att = 0, so mixed is the
    projection of LN([ce; 0; 0]) — finite, never NaN."""
    args = attn_inputs()
    mixed, _ = qa_ctx_attention.qa_ctx_attention_plain(*(t(x) for x in args))
    cn, ce, qn, qe, cm, qm, gamma, beta, w, b = (t(x) for x in args)
    x = torch.cat([ce, torch.zeros_like(ce), torch.zeros_like(ce)], -1)
    mean = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mean ** 2
    expect = torch.relu(((x - mean) * torch.rsqrt(var + 1e-5) * gamma + beta)
                        @ w + b)
    np.testing.assert_allclose(mixed[0, 1].numpy(),
                               expect[0, 1][None].expand_as(
                                   mixed[0, 1]).numpy(), **TOL)
    np.testing.assert_allclose(mixed[1, :, 2].numpy(),
                               expect[1].numpy(), **TOL)


@pytest.mark.parametrize("raw_mode", ["full", "none"])
def test_qa_ctx_attention_cpu_wrapper_is_plain(raw_mode):
    args = [t(x) for x in attn_inputs(seed=2)]
    got = qa_ctx_attention.qa_ctx_attention(*args, raw_mode=raw_mode)
    want = qa_ctx_attention.qa_ctx_attention_plain(*args, raw_mode=raw_mode)
    for g, w in zip(got if raw_mode == "full" else (got,),
                    want if raw_mode == "full" else (want,)):
        assert torch.equal(g, w)
    with pytest.raises(NotImplementedError):
        qa_ctx_attention.qa_ctx_attention(*args, raw_mode="partial")
    with pytest.raises(ValueError, match="targets"):
        qa_ctx_attention.qa_ctx_attention(*args, raw_mode="target")


# --------------------------------------------------------------- tri bridge
def bridge_inputs(d=16, shape=(2, 5, 3, 6), seed=0):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(shape + (d,)).astype(F32)
    v = rng.standard_normal(shape + (d,)).astype(F32)
    gin = (rng.standard_normal(3 * d) * 0.1 + 1.0).astype(F32)
    bin_ = (rng.standard_normal(3 * d) * 0.1).astype(F32)
    w = (rng.standard_normal((3 * d, d)) / np.sqrt(3 * d)).astype(F32)
    b = (rng.standard_normal(d) * 0.1).astype(F32)
    gout = (rng.standard_normal(d) * 0.1 + 1.0).astype(F32)
    bout = (rng.standard_normal(d) * 0.1).astype(F32)
    return s, v, gin, bin_, w, b, gout, bout


def test_tri_bridge_plain_matches_pallas_and_reference():
    args = bridge_inputs()
    jargs = [jnp.asarray(x) for x in args]
    fused = tb.fused_tri_bridge(*jargs, jnp.zeros((), jnp.int32),
                                jnp.float32, 0.0)
    ref = tb.reference_impl(*jargs)
    ours = tri_bridge.tri_bridge_plain(*(t(x) for x in args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(fused), **TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(tri_bridge.tri_bridge(*(t(x) for x in args)), ours)


# ------------------------------------------------------------------ encoder
def encoder_inputs(d=16, b=2, g=6, l=8, k=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, g, l, d)).astype(F32)
    pe = (rng.standard_normal((l, d)) * 0.1).astype(F32)
    p = {}
    for i in (0, 1):
        p[f"ln{i}_s"] = (rng.standard_normal(d) * 0.1 + 1).astype(F32)
        p[f"ln{i}_b"] = (rng.standard_normal(d) * 0.1).astype(F32)
        p[f"dw{i}"] = (rng.standard_normal((k, d)) * 0.3).astype(F32)
        p[f"dwb{i}"] = (rng.standard_normal(d) * 0.1).astype(F32)
        p[f"pw{i}"] = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(F32)
        p[f"pwb{i}"] = (rng.standard_normal(d) * 0.1).astype(F32)
    p["lnf_s"] = (rng.standard_normal(d) * 0.1 + 1).astype(F32)
    p["lnf_b"] = (rng.standard_normal(d) * 0.1).astype(F32)
    mask = (rng.random((b, g, l)) > 0.3).astype(F32)
    mask[0, 1] = 0                   # an all-zero mask group
    return x, pe, p, mask


def test_encoder_reduce_plain_matches_pallas_and_reference():
    k = 5
    x, pe, p, mask = encoder_inputs(k=k)
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    fused = pe_mod.fused_encoder_block(jnp.asarray(x), jnp.asarray(pe), jp,
                                       jnp.zeros((), jnp.int32), k,
                                       jnp.float32, 0.0, jnp.asarray(mask))
    full = np.asarray(pe_mod.reference_impl(jnp.asarray(x), jnp.asarray(pe),
                                            jp, k))
    m = mask[..., None]
    ref = (full * m + (m - 1.0) * 1e10).max(axis=-2)
    ours = encoder.encoder_reduce_plain(t(x), t(pe),
                                        {key: t(v) for key, v in p.items()},
                                        k, t(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(fused), **TOL)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    assert (ours[0, 1] == -1e10).all()     # all-zero mask group
    assert torch.equal(
        encoder.encoder_reduce(t(x), t(pe), {key: t(v) for key, v in
                                             p.items()}, k, t(mask)), ours)
