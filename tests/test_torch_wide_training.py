"""Training at hidden widths 64 and 256 on the CPU side: the gradients the
port's backward kernels are held against on the card, and a train step.

* The gradients of the plain versions of the three fused ops (autograd
  through them: the oracle of csrc/*_bwd_wide.cu on the card) against the
  JAX package's Pallas backward kernels called directly in interpret mode
  (``_pallas_backward``, ``_backward``), dropout 0, at D = 64 and 256, in
  float32 and in the bf16 compute mode: the attention in raw modes "none"
  and "target", the tri bridge, the encoder in reduce mode and in
  full-output mode with and without a zero mask.
* One train step at hsz 64 and 256 against the JAX Trainer's
  (tests/test_torch_train.py ``check_train_step_against_jax``, its tiny
  shapes and bars).
* The backward kernels' shared memory at every width, from the sources'
  layouts (ops/widths.py), against an H100 block's limit.

Inputs come from numpy seeds (bf16 activations rounded first, so both
frameworks start from the same values).  Tolerances: float32 differs by
the order of float32 sums only (rtol / atol 1e-4, as
tests/test_torch_backward.py); bf16 at the bars of
tests/test_torch_attention_bf16.py and tests/test_torch_encoder_tri_bf16.py
(held relative to each gradient's largest entry plus two bf16 steps of the
entry; the encoder by relative L2), with no cotangent where a rounding could
flip a ReLU or move a max between the two sides (ops/checks.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import attn_inputs, bridge_inputs, encoder_inputs
from tests.test_torch_train import check_train_step_against_jax
from tvqaplus_tpu.ops import pallas_attention as pa
from tvqaplus_tpu.ops import pallas_encoder as pe_mod
from tvqaplus_tpu.ops import pallas_tri_bridge as tb
from tvqaplus_tpu_torch.ops import (
    checks,
    encoder,
    qa_ctx_attention,
    tri_bridge,
    widths,
)

torch.set_num_threads(1)
F32 = np.float32
WIDTHS = (64, 256)
MODES = ("float32", "bfloat16")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_GRAD_TOL = (1e-2, 2.0 ** -7)
ENC_REL_L2 = checks.ENC_BF16_REL_L2
TARGETS = np.array([1, 3], np.int32)


def jdt(mode):
    return jnp.float32 if mode == "float32" else jnp.bfloat16


def round_bf16(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def activation(x, mode, grad=False):
    t = torch.from_numpy(np.array(x))
    if mode == "bfloat16":
        t = t.to(torch.bfloat16)
    return t.requires_grad_(grad)


def hold(name, got, ref, mode):
    want = torch.from_numpy(np.asarray(jnp.asarray(ref, jnp.float32)))
    got = got.reshape(want.shape)
    assert torch.isfinite(got.float()).all(), name
    if mode == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name,
                                   **F32_TOL)
    else:
        err, bad = checks.grad_error(got, want, BF16_GRAD_TOL)
        assert bad == 0, f"{name}: {bad} outside {BF16_GRAD_TOL}, max {err}"


# ---------------------------------------------------------------- attention
ATT_DIFF = (0, 1, 2, 3, 6, 7, 8, 9)
ATT_NAMES = ("cn", "ce", "qn", "qe", "gamma", "beta", "w", "b")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("raw_mode", ["none", "target"])
@pytest.mark.parametrize("d", WIDTHS)
def test_attention_grads_match_pallas_backward_at_width(d, raw_mode, mode):
    args = list(attn_inputs(d=d, b=2, a=5, li=3, lqa=6, lr=7, seed=31))
    if mode == "bfloat16":
        args[:4] = [round_bf16(a) for a in args[:4]]
    tg = jnp.asarray(TARGETS) if raw_mode == "target" else None
    out_j = pa._pallas_forward(
        *(jnp.asarray(a) for a in args), scale=10.0, dropout_rate=0.0,
        seed=0, interpret=True, compute_dtype=jdt(mode), raw_mode=raw_mode,
        targets=tg)
    mixed_j, raw_j = (out_j, None) if raw_mode == "none" else out_j
    ts = [activation(a, mode) if i < 4 else torch.from_numpy(np.array(a))
          for i, a in enumerate(args)]
    rng = np.random.default_rng(32)
    gm = rng.standard_normal(mixed_j.shape).astype(F32)
    if mode == "bfloat16":      # no cotangent where a rounding flips a ReLU
        gm = round_bf16(gm * ~checks.attention_flip_elements(*ts).numpy())
    gr = None
    if raw_j is not None:
        raw_np = np.asarray(raw_j)
        gr = (raw_np > -1e9).astype(F32) * rng.standard_normal(
            raw_np.shape).astype(F32)
    ref = pa._pallas_backward(
        *(jnp.asarray(a) for a in args), jnp.asarray(gm),
        None if gr is None else jnp.asarray(gr), mixed_j, 10.0, 0.0, 0,
        interpret=True, compute_dtype=jdt(mode), raw_mode=raw_mode,
        targets=tg)
    for i in ATT_DIFF:
        ts[i].requires_grad_(True)
    out = qa_ctx_attention.qa_ctx_attention(
        *ts, scale=10.0, raw_mode=raw_mode,
        targets=torch.from_numpy(TARGETS))
    mixed, raw = (out, None) if raw_mode == "none" else out
    assert mixed.shape[-1] == d and mixed.dtype == ts[0].dtype
    total = (mixed.float() * torch.from_numpy(gm)).sum()
    if raw is not None:
        total = total + (raw * torch.from_numpy(gr)).sum()
    total.backward()
    for i, r, name in zip(ATT_DIFF, ref, ATT_NAMES):
        assert ts[i].grad.dtype == ts[i].dtype, name
        hold(f"D {d} {raw_mode} {mode} {name}", ts[i].grad.float(), r, mode)
    assert (ts[2].grad[1, 2] == 0).all()     # the fully masked frame


# --------------------------------------------------------------- tri bridge
TRI_NAMES = ("s", "v", "gamma_in", "beta_in", "w", "b", "gamma_out",
             "beta_out")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", WIDTHS)
def test_tri_bridge_grads_match_pallas_backward_at_width(d, mode):
    # 75 rows: not a multiple of 64 (the tensor-core tile) nor 16 / 32
    args = list(bridge_inputs(d=d, shape=(1, 5, 3, 5), seed=33))
    if mode == "bfloat16":
        args[:2] = [round_bf16(a) for a in args[:2]]
    ts = [activation(a, mode) if i < 2 else torch.from_numpy(np.array(a))
          for i, a in enumerate(args)]
    g = np.random.default_rng(34).standard_normal(args[0].shape).astype(F32)
    if mode == "bfloat16":
        flip = checks.tri_bridge_flip_rows(*ts[:6])
        g = round_bf16(g * ~flip.numpy()[..., None])
    ja = [jnp.asarray(a) for a in args]
    ja[:2] = [a.astype(jdt(mode)) for a in ja[:2]]
    ref = tb._backward(*ja, 0, jnp.asarray(g).astype(jdt(mode)), 0.0,
                       interpret=True, compute_dtype=jdt(mode))
    for x in ts:
        x.requires_grad_(True)
    out = tri_bridge.tri_bridge(*ts)
    assert out.shape[-1] == d and out.dtype == ts[0].dtype
    (out.float() * torch.from_numpy(g)).sum().backward()
    for x, r, name in zip(ts, ref, TRI_NAMES):
        assert x.grad.dtype == x.dtype, name
        hold(f"D {d} {mode} {name}", x.grad.float(), r, mode)


# ------------------------------------------------------------------ encoder
def enc_case(d, mode, k, seed):
    """Inputs of 2 x 6 sequences of 9 with an all-masked group in the reduce
    mask and a planted tie in the max (two positions of a group share one
    row), activations rounded to bf16 in the bf16 mode."""
    x, pe, p, mask = encoder_inputs(d=d, b=2, g=6, l=9, k=k, seed=seed)
    x[1, 2, 4] = x[1, 2, 1]
    mask[1, 2, 1] = mask[1, 2, 4] = 1.0
    if mode == "bfloat16":
        x = round_bf16(x)
    return x, pe, p, mask


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["reduce", "zero_mask", "full"])
@pytest.mark.parametrize("d", WIDTHS)
def test_encoder_grads_match_pallas_backward_at_width(d, kind, mode):
    k = 5 if kind == "reduce" else 7
    x, pe, p, mask = enc_case(d, mode, k, seed=35)
    zm = None
    if kind != "reduce":
        mask = None
    if kind == "zero_mask":      # a (G, L) length mask of merged streams
        lens = np.array([9, 9, 7, 7, 4, 4])
        zm = (np.arange(9)[None, :] < lens[:, None]).astype(F32)
        x = x * zm[None, ..., None]
    xt = activation(x, mode, grad=True)
    pt = {key: torch.tensor(v, requires_grad=True) for key, v in p.items()}
    rng = np.random.default_rng(36)
    shape = x.shape[:2] + x.shape[3:] if kind == "reduce" else x.shape
    g = rng.standard_normal(shape).astype(F32)
    if zm is not None:
        g = g * zm[None, ..., None]
    if mode == "bfloat16":
        g = round_bf16(g)
        if kind == "reduce":    # no cotangent where a rounding moves a max
            g = g * ~checks.encoder_tie_elements(
                activation(x, mode), torch.from_numpy(pe),
                {key: torch.from_numpy(v) for key, v in p.items()}, k,
                torch.from_numpy(mask)).numpy()
    kw = dict(interpret=True, compute_dtype=jdt(mode),
              reduce_mask=None if mask is None else jnp.asarray(mask),
              zero_mask=None if zm is None else jnp.asarray(zm))
    gx, gp = pe_mod._backward(
        jnp.asarray(x).astype(jdt(mode)), jnp.asarray(pe),
        {key: jnp.asarray(v) for key, v in p.items()}, 0, jnp.asarray(g), k,
        0.0, **kw)
    ref = [gx] + [gv.reshape(p[key].shape)
                  for key, gv in zip(encoder.PARAM_KEYS, gp)]
    pe_t = torch.from_numpy(pe)
    if kind == "reduce":
        out = encoder.encoder_reduce(xt, pe_t, pt, k, torch.from_numpy(mask))
    else:
        out = encoder.encoder_block(
            xt, pe_t, pt, k, None if zm is None else torch.from_numpy(zm))
    assert out.shape[-1] == d and out.dtype == xt.dtype
    (out.float() * torch.from_numpy(g)).sum().backward()
    grads = [xt.grad] + [pt[key].grad for key in encoder.PARAM_KEYS]
    assert grads[0].dtype == xt.dtype
    for name, got, r in zip(("x",) + encoder.PARAM_KEYS, grads, ref):
        tag = f"D {d} {kind} {mode} {name}"
        if mode == "float32":
            hold(tag, got, r, mode)
        else:
            want = torch.from_numpy(np.asarray(jnp.asarray(r, jnp.float32)))
            checks.rel_l2_close(tag, got.float().reshape(want.shape), want,
                                ENC_REL_L2)
    if kind == "reduce":
        assert (xt.grad[0, 1] == 0).all()          # the all-masked group


# -------------------------------------------------------------- train steps
@pytest.mark.parametrize("hsz", WIDTHS)
def test_one_train_step_at_hsz_matches_the_jax_trainer(tmp_path, hsz):
    check_train_step_against_jax(tmp_path, hsz=hsz)


# --------------------------------------------------------- shared memory
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", widths.FAMILIES)
@pytest.mark.parametrize("d", widths.BACKWARD_WIDTHS)
def test_backward_shared_memory_fits_an_h100_block(d, family, dtype):
    """At the kernels' largest shapes (Lr 64, L 56, k 9) and at the
    headline's (Lr 25 and 50, L 40 and 50, k 5 and 7)."""
    for lr, length, k in ((64, 56, 9), (25, 40, 5), (50, 50, 7)):
        assert widths.bwd_smem_bytes(family, d, dtype, lr, length, k) \
            <= widths.SMEM_LIMIT


# ------------------------------------------------------ chip_smoke's trace
def test_chip_smoke_reads_the_wide_backwards_from_a_trace():
    """``chip_smoke.py`` finds the backwards of a width other than 128 (and
    its forwards) in a train step's kernel names, and refuses a trace that
    lacks one or holds a kernel of D = 128."""
    import chip_smoke
    ns = "void (anonymous namespace)::"
    bf = "__nv_bfloat16"
    names = {f"{ns}encoder_fwd_tc_wide_kernel<5>(x)": 1,
             f"{ns}tri_bridge_fwd_tc256_kernel<true>(x)": 1,
             f"{ns}qa_ctx_bwd_tc_wide_kernel<64>(x)": 1,
             f"{ns}qa_ctx_bwd_tc_wide_kernel<32>(x)": 1,
             f"{ns}qa_ctx_gq_wide_kernel<{bf}, {bf}, 256>(x)": 2,
             f"{ns}tri_bridge_bwd_tc256_kernel(x)": 1,
             f"{ns}encoder_bwd_tc_wide_kernel<5, 256>(x)": 1,
             "void tvqa::wgrad_tc_kernel<128>(x)": 4}
    got = chip_smoke.check_wide_train_trace("train", names, False, 256)
    assert "tri_bridge_bwd_tc256_kernel" in got
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.check_wide_train_trace(
            "train", {k: v for k, v in names.items() if "gq_wide" not in k},
            False, 256)
    with pytest.raises(AssertionError, match="D = 128 kernels launched"):
        chip_smoke.check_wide_train_trace(
            "train", {**names, f"{ns}encoder_bwd_tc_kernel<5>(x)": 1}, False,
            256)
    with pytest.raises(AssertionError, match="missing"):    # empty trace
        chip_smoke.check_wide_train_trace("train", {}, False, 256)
