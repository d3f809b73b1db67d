"""The port's CUDA kernels against their plain PyTorch versions on a card:
the forwards (with and without dropout) against the plain versions, the
backwards against autograd through them with the same Philox mask, and the
inputs each kernel refuses; the bf16 steps' traces (tensor-core kernels,
no CUDA-core ones) and their CUDA-graph replays.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import dataclasses

import pytest
import torch

from tvqaplus_tpu_torch.models.attention import l2_normalize
from tvqaplus_tpu_torch.ops import (
    checks,
    encoder,
    mlp_bridge,
    qa_ctx_attention,
    tri_bridge,
    widths,
)
from tvqaplus_tpu_torch.ops._build import width_counter

D = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


def close(got, want, tol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               atol=tol[0], rtol=tol[1])


# Dropout rate and Philox seed of the training-path checks.
P_DROP, SEED = 0.1, 12345


def attn_args(dev, dt, b=2, a=5, li=4, lqa=40, lr=25, d=D):
    gen = torch.Generator().manual_seed(0)
    ce = randn(gen, b, a, lqa, d).to(dev, dt)
    qe = randn(gen, b, li, lr, d).to(dev, dt)
    c_mask = (torch.rand(b, a, lqa, generator=gen) > 0.25).float()
    if a > 1:
        c_mask[0, 1] = 0             # a fully masked answer
    q_mask = (torch.rand(b, li, lr, generator=gen) > 0.25).float()
    if li > 2:
        q_mask[1, 2] = 0             # a frame with no regions
    params = [1 + randn(gen, 3 * d, scale=0.1), randn(gen, 3 * d, scale=0.1),
              randn(gen, 3 * d, d, scale=(3 * d) ** -0.5),
              randn(gen, d, scale=0.1)]
    return [l2_normalize(ce), ce, l2_normalize(qe), qe] + [
        t.to(dev) for t in [c_mask, q_mask] + params]


# (raw_mode, Lr, A, Lqa): Lr below, at and above the 32-wide tile and at the
# 64 limit; M = A * Lqa = 200 (three 64-row tiles and 8 rows) and 39 (not a
# multiple of 16)
ATT_CASES = [("full", 25, 5, 40), ("none", 50, 5, 40), ("full", 64, 5, 40),
             ("target", 7, 3, 13), ("none", 25, 3, 13), ("target", 50, 5, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("raw_mode,lr,a,lqa", ATT_CASES)
def test_qa_ctx_attention_kernel_matches_plain(cuda, dtype, dropout,
                                               raw_mode, lr, a, lqa):
    dt = getattr(torch, dtype)
    args = attn_args(cuda, dt, a=a, lqa=lqa, lr=lr)
    kw = dict(raw_mode=raw_mode, dropout_rate=dropout, seed=SEED,
              targets=torch.tensor([2, 0], device=cuda))
    launches = qa_ctx_attention.KERNEL.launches
    got = qa_ctx_attention.qa_ctx_attention(*args, **kw)
    want = qa_ctx_attention.qa_ctx_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = qa_ctx_attention.TOL[dt]
    assert qa_ctx_attention.KERNEL.launches == launches + 1
    if raw_mode == "none":
        assert got.dtype == dt
        assert torch.isfinite(got.float()).all()
        close(got, want, tol["mixed"])
    else:
        assert got[0].dtype == dt and got[1].dtype == torch.float32
        assert torch.isfinite(got[0].float()).all()
        close(got[0], want[0], tol["mixed"])
        close(got[1], want[1], tol["raw"])


@pytest.mark.cuda
def test_qa_ctx_attention_kernel_rejects_what_it_does_not_take(cuda):
    args = attn_args(cuda, torch.float32, lr=65)
    with pytest.raises(ValueError):
        qa_ctx_attention.qa_ctx_attention(*args)
    args = attn_args(cuda, torch.float32)
    with pytest.raises(NotImplementedError):
        qa_ctx_attention.qa_ctx_attention(*args, raw_mode="partial")
    with pytest.raises(ValueError):      # "target" needs the targets
        qa_ctx_attention.qa_ctx_attention(*args, raw_mode="target")
    args[4] = args[4].cpu()          # a mask left on the host
    with pytest.raises(ValueError):
        qa_ctx_attention.qa_ctx_attention(*args)
    for dt in (torch.float32, torch.bfloat16):
        args = attn_args(cuda, dt)
        args[0] = args[0].transpose(1, 2)    # not contiguous
        with pytest.raises(ValueError):
            qa_ctx_attention.qa_ctx_attention(*args)
        args = attn_args(cuda, dt)
        wide = [torch.cat([t] * 3, -1) for t in args[:4]]   # D = 384
        with pytest.raises(ValueError, match="up to 256.*A10d"):
            qa_ctx_attention.qa_ctx_attention(*wide, *args[4:])
        with pytest.raises(ValueError):      # Lr > 64
            qa_ctx_attention.qa_ctx_attention(*attn_args(cuda, dt, lr=65))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [(2, 5, 3, 40), (1, 1, 1, 7)])
def test_tri_bridge_kernel_matches_plain(cuda, dtype, rows):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    s = randn(gen, *rows, D).to(cuda, dt)
    v = randn(gen, *rows, D).to(cuda, dt)
    params = [1 + randn(gen, 3 * D, scale=0.1), randn(gen, 3 * D, scale=0.1),
              randn(gen, 3 * D, D, scale=(3 * D) ** -0.5),
              randn(gen, D, scale=0.1), 1 + randn(gen, D, scale=0.1),
              randn(gen, D, scale=0.1)]
    params = [p.to(cuda) for p in params]
    got = tri_bridge.tri_bridge(s, v, *params)
    want = tri_bridge.tri_bridge_plain(s, v, *params)
    torch.cuda.synchronize()
    close(got, want, tri_bridge.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,k", [(40, 5), (50, 7), (9, 3)])
def test_encoder_kernel_matches_plain(cuda, dtype, l, k):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(2)
    x = randn(gen, 2, 10, l, D).to(cuda, dt)
    pe = randn(gen, l, D, scale=0.1).to(cuda)
    p = {}
    for i in (0, 1):
        p.update({f"ln{i}_s": 1 + randn(gen, D, scale=0.1),
                  f"ln{i}_b": randn(gen, D, scale=0.1),
                  f"dw{i}": randn(gen, k, D, scale=0.3),
                  f"dwb{i}": randn(gen, D, scale=0.1),
                  f"pw{i}": randn(gen, D, D, scale=D ** -0.5),
                  f"pwb{i}": randn(gen, D, scale=0.1)})
    p["lnf_s"] = 1 + randn(gen, D, scale=0.1)
    p["lnf_b"] = randn(gen, D, scale=0.1)
    p = {key: t.to(cuda) for key, t in p.items()}
    mask = (torch.rand(2, 10, l, generator=gen) > 0.3).float()
    mask[0, 1] = 0                   # all-zero group: -1e10 everywhere
    mask = mask.to(cuda)
    got = encoder.encoder_reduce(x, pe, p, k, mask)
    want = encoder.encoder_reduce_plain(x, pe, p, k, mask)
    torch.cuda.synchronize()
    close(got, want, encoder.TOL[dt])
    assert (got[0, 1].float() == want[0, 1].float()).all()


# ------------------------------------------------------------------ training


def leaves(tensors):
    return [t.detach().clone().requires_grad_(t.is_floating_point())
            for t in tensors]


def grads_of(fn, inputs, cotangents):
    """Gradients of sum(out * cotangent) over the outputs of fn(*inputs)."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward([o for o in outs],
                            [c.to(o.dtype) for o, c in zip(outs, cotangents)])
    return outs, [t.grad for t in inputs if t.requires_grad]


ATT_GRAD_INPUTS = (0, 1, 2, 3, 6, 7, 8, 9)     # cn ce qn qe gamma beta w b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("raw_mode,lr,a,lqa", ATT_CASES)
def test_qa_ctx_attention_training_kernels_match_plain(cuda, dtype, dropout,
                                                       raw_mode, lr, a, lqa):
    """Forward (with in-kernel dropout) and the backward kernel against the
    plain version (autograd, the same Philox mask) on the same inputs and
    cotangents, and the backward again for the same bits."""
    dt = getattr(torch, dtype)
    li = 4
    args = attn_args(cuda, dt, a=a, li=li, lqa=lqa, lr=lr)
    targets = torch.tensor([2, 0], device=cuda)
    kw = dict(raw_mode=raw_mode, targets=targets, dropout_rate=dropout,
              seed=SEED)
    gen = torch.Generator().manual_seed(4)
    # no cotangent on an output whose ReLU sign rounding could flip
    # (ops/checks.py), nor on a masked raw score
    flip = checks.attention_flip_elements(*args, dropout_rate=dropout,
                                          seed=SEED)
    gm = randn(gen, 2, a, li, lqa, D).to(cuda) * ~flip
    cot = [gm]
    if raw_mode == "target":
        c_t = args[4][torch.arange(2, device=cuda), targets]    # (B, Lqa)
        live = c_t[:, None, :, None] * args[5][:, :, None, :]
        cot.append(randn(gen, 2, li, lqa, lr).to(cuda) * live)
    elif raw_mode == "full":
        live = args[4][:, :, None, :, None] * args[5][:, None, :, None, :]
        cot.append(randn(gen, 2, a, li, lqa, lr).to(cuda) * live)
    fwd0, bwd0 = (qa_ctx_attention.KERNEL.launches,
                  qa_ctx_attention.BWD_KERNEL.launches)

    def kernel(*a_):
        return qa_ctx_attention.qa_ctx_attention(*a_, **kw)

    def plain(*a_):
        return qa_ctx_attention.qa_ctx_attention_plain(*a_, **kw)

    def run(fn):
        ins = leaves(args)
        ins[4].requires_grad_(False)
        ins[5].requires_grad_(False)
        return (ins,) + grads_of(fn, ins, cot)
    ins_k, out_k, g_k = run(kernel)
    _, _, g_again = run(kernel)
    _, out_p, g_p = run(plain)
    torch.cuda.synchronize()
    assert qa_ctx_attention.KERNEL.launches == fwd0 + 2
    assert qa_ctx_attention.BWD_KERNEL.launches == bwd0 + 2
    tol = qa_ctx_attention.TOL[dt]
    close(out_k[0], out_p[0], tol["mixed"])
    if raw_mode != "none":
        close(out_k[1], out_p[1], tol["raw"])
    for i, gk, ga, gp in zip(ATT_GRAD_INPUTS, g_k, g_again, g_p):
        assert gk.dtype == ins_k[i].dtype
        assert torch.equal(gk, ga), f"grad {i} differs between two runs"
        checks.grad_close(f"grad {i}", gk, gp, qa_ctx_attention.GRAD_TOL[dt])
    # the fully masked frame (1, 2) gets no qn gradient
    assert (g_k[2][1, 2] == 0).all()


# rows of the tri bridge: 1200, 39 (not a multiple of 64) and the headline
# 160,000
TRI_ROWS = [(2, 5, 3, 40), (1, 1, 1, 39), (16, 5, 50, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("rows", TRI_ROWS)
def test_tri_bridge_training_kernels_match_plain(cuda, dtype, dropout, rows):
    """Forward and backward kernels against the plain version (autograd,
    the same Philox mask), the backward twice for the same bits; bf16 runs
    the tensor-core backward."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    s = randn(gen, *rows, D).to(cuda, dt)
    v = randn(gen, *rows, D).to(cuda, dt)
    params = [1 + randn(gen, 3 * D, scale=0.1), randn(gen, 3 * D, scale=0.1),
              randn(gen, 3 * D, D, scale=(3 * D) ** -0.5),
              randn(gen, D, scale=0.1), 1 + randn(gen, D, scale=0.1),
              randn(gen, D, scale=0.1)]
    args = [s, v] + [p.to(cuda) for p in params]
    flip = checks.tri_bridge_flip_rows(*args[:6], dropout, SEED)
    cot = [randn(gen, *rows, D).to(cuda) * (~flip)[..., None]]
    bwd0 = tri_bridge.BWD_KERNEL.launches

    def kernel(*a):
        return tri_bridge.tri_bridge(*a, dropout, SEED)
    out_k, g_k = grads_of(kernel, leaves(args), cot)
    _, g_again = grads_of(kernel, leaves(args), cot)
    out_p, g_p = grads_of(
        lambda *a: tri_bridge.tri_bridge_plain(*a, dropout, SEED),
        leaves(args), cot)
    torch.cuda.synchronize()
    assert tri_bridge.BWD_KERNEL.launches == bwd0 + 2
    close(out_k[0], out_p[0], tri_bridge.TOL[dt])
    for i, (gk, ga, gp) in enumerate(zip(g_k, g_again, g_p)):
        assert torch.equal(gk, ga), f"grad {i} differs between two runs"
        checks.grad_close(f"grad {i}", gk, gp, tri_bridge.GRAD_TOL[dt])
    assert g_k[0].dtype == g_k[1].dtype == dt


def encoder_args(cuda, dt, gen, b=2, g=10, l=40, k=5, d=D):
    x = randn(gen, b, g, l, d).to(cuda, dt)
    pe = randn(gen, l, d, scale=0.1).to(cuda)
    p = {}
    for i in (0, 1):
        p.update({f"ln{i}_s": 1 + randn(gen, d, scale=0.1),
                  f"ln{i}_b": randn(gen, d, scale=0.1),
                  f"dw{i}": randn(gen, k, d, scale=0.3),
                  f"dwb{i}": randn(gen, d, scale=0.1),
                  f"pw{i}": randn(gen, d, d, scale=d ** -0.5),
                  f"pwb{i}": randn(gen, d, scale=0.1)})
    p["lnf_s"] = 1 + randn(gen, d, scale=0.1)
    p["lnf_b"] = randn(gen, d, scale=0.1)
    mask = (torch.rand(b, g, l, generator=gen) > 0.3).float()
    mask[0, 1] = 0                   # all-zero group: no gradient
    return x, pe, {key: t.to(cuda) for key, t in p.items()}, mask.to(cuda)


# (L, k) of the encoder's backward: the headline cls_encoder (40, 5) and
# input encoder (50, 7), and L 7 / 9 / 25 / 56 at k 3 / 9 / 7 / 9 (18, 14, 5
# and 2 sequences to a 128-row tile)
ENC_CASES = [(40, 5), (9, 3), (7, 3), (25, 7), (50, 7), (56, 9)]


def encoder_cotangent(x, pe, p, k, mask, dt, gen, dropout):
    """The reduce mode's cotangent, zero where a rounding could flip a
    decision (ops/checks.py): float32, whole sequences near a ReLU or max
    tie; bf16 (held by relative L2), channels near a max tie."""
    if dt == torch.bfloat16:
        keep = ~checks.encoder_tie_elements(x, pe, p, k, mask,
                                            dropout, SEED)
    else:
        keep = ~checks.encoder_flip_groups(x, pe, p, k, mask, dropout,
                                           SEED)[..., None]
    return randn(gen, x.shape[0], x.shape[1], x.shape[-1]).to(x.device) \
        * keep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("l,k", ENC_CASES)
def test_encoder_training_kernels_match_plain(cuda, dtype, dropout, l, k):
    """Reduce mode: forward and backward kernels against the plain version
    (autograd, the same Philox mask), the backward twice for the same bits;
    bf16 runs the tensor-core backward, held by relative L2."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(6)
    x, pe, p, mask = encoder_args(cuda, dt, gen, l=l, k=k)
    cot = [encoder_cotangent(x, pe, p, k, mask, dt, gen, dropout)]
    keys = encoder.PARAM_KEYS

    def run(fn):
        xs = x.detach().clone().requires_grad_(True)
        ps = {key: t.detach().clone().requires_grad_(True)
              for key, t in p.items()}
        out, _ = grads_of(lambda a: fn(a, pe, ps, k, mask, dropout, SEED),
                          [xs], cot)
        return out[0], [xs.grad] + [ps[key].grad for key in keys]
    bwd0 = encoder.BWD_KERNEL.launches
    out_k, g_k = run(encoder.encoder_reduce)
    _, g_again = run(encoder.encoder_reduce)
    out_p, g_p = run(encoder.encoder_reduce_plain)
    torch.cuda.synchronize()
    assert encoder.BWD_KERNEL.launches == bwd0 + 2
    close(out_k, out_p, encoder.TOL[dt])
    for name, gk, ga, gp in zip(("x",) + keys, g_k, g_again, g_p):
        assert torch.equal(gk, ga), f"{name} differs between two runs"
        checks.hold_grad(name, gk, gp, encoder.GRAD_TOL[dt])
    assert g_k[0].dtype == dt
    assert (g_k[0][0, 1] == 0).all()


@pytest.mark.cuda
def test_backward_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(7)
    args = attn_args(cuda, torch.float32)
    mixed = qa_ctx_attention.qa_ctx_attention(*args, raw_mode="none")
    with pytest.raises(ValueError):          # cotangent of another shape
        qa_ctx_attention.qa_ctx_attention_backward(
            *args, mixed[:, :2], None, mixed, raw_mode="none")
    s = randn(gen, 3, D).to(cuda)
    params = [torch.ones(3 * D), torch.zeros(3 * D), torch.zeros(3 * D, D),
              torch.zeros(D), torch.ones(D), torch.zeros(D)]
    with pytest.raises(ValueError):          # parameters left on the host
        tri_bridge.tri_bridge_backward(s, s, *params, s)
    x, pe, p, mask = encoder_args(cuda, torch.float32, gen, l=60)
    with pytest.raises(ValueError):          # L > MAX_LEN
        encoder.encoder_reduce_backward(
            x, pe, encoder.pack_params(p), mask, x[:, :, 0], 5)
    for dt in (torch.float32, torch.bfloat16):
        x, pe, p, mask = encoder_args(cuda, dt, gen, l=40, k=5)
        with pytest.raises(ValueError):      # an even k
            encoder.encoder_reduce_backward(
                x, pe, encoder.pack_params(p), mask, x[:, :, 0], 4)
    # bf16 rows the tensor-core kernel would copy from a misaligned start
    buf = torch.zeros(3 * D + 1, dtype=torch.bfloat16, device=cuda)
    sb = buf[1:].view(3, D)
    params = [t.to(cuda) for t in params]
    with pytest.raises(ValueError):
        tri_bridge.tri_bridge_backward(sb, sb, *params, sb)


# ---------------------------------- the forward kernels at D = 64 and 256
# The three forward families are built for hidden widths 64, 128 and 256
# (ops/widths.py): at 64 the resident design at half width, at 256 the
# weight streams (csrc/wgmma.cuh mma_streamed_w).  Each width counts its
# own launches.
WIDTHS = (64, 256)
# the widths between them: run padded to the next instantiation (96 in 128,
# 200 in 256), counted under their own width (ops/_build.py width_counter)
PADDED_WIDTHS = (96, 200)
# (raw_mode, Lr, A, Lqa): both score tiles (32 and 64 wide), M = 200 (the
# headline's, with a ragged last tile) and 39
WIDTH_ATT_CASES = [("full", 25, 5, 40), ("none", 50, 5, 40),
                   ("target", 64, 3, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS + PADDED_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("raw_mode,lr,a,lqa", WIDTH_ATT_CASES)
def test_qa_ctx_attention_kernel_matches_plain_at_other_widths(
        cuda, d, dtype, dropout, raw_mode, lr, a, lqa):
    dt = getattr(torch, dtype)
    args = attn_args(cuda, dt, a=a, lqa=lqa, lr=lr, d=d)
    kw = dict(raw_mode=raw_mode, dropout_rate=dropout, seed=SEED,
              targets=torch.tensor([2, 0], device=cuda))
    counter = width_counter(qa_ctx_attention.FWD_BY_WIDTH, d)
    launches = counter.launches
    got = qa_ctx_attention.qa_ctx_attention(*args, **kw)
    want = qa_ctx_attention.qa_ctx_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = qa_ctx_attention.TOL[dt]
    assert counter.launches == launches + 1
    got = got if raw_mode != "none" else (got,)
    want = want if raw_mode != "none" else (want,)
    assert got[0].dtype == dt and got[0].shape[-1] == d
    assert torch.isfinite(got[0].float()).all()
    close(got[0], want[0], tol["mixed"])
    if raw_mode != "none":
        close(got[1], want[1], tol["raw"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS + PADDED_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("rows", [(2, 5, 3, 40), (1, 1, 1, 7)])
def test_tri_bridge_kernel_matches_plain_at_other_widths(cuda, d, dtype,
                                                         dropout, rows):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    s = randn(gen, *rows, d).to(cuda, dt)
    v = randn(gen, *rows, d).to(cuda, dt)
    params = [1 + randn(gen, 3 * d, scale=0.1), randn(gen, 3 * d, scale=0.1),
              randn(gen, 3 * d, d, scale=(3 * d) ** -0.5),
              randn(gen, d, scale=0.1), 1 + randn(gen, d, scale=0.1),
              randn(gen, d, scale=0.1)]
    params = [p.to(cuda) for p in params]
    kw = dict(dropout_rate=dropout, seed=SEED)
    counter = width_counter(tri_bridge.FWD_BY_WIDTH, d)
    launches = counter.launches
    got = tri_bridge.tri_bridge(s, v, *params, **kw)
    want = tri_bridge.tri_bridge_plain(s, v, *params, **kw)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    assert got.shape == s.shape
    close(got, want, tri_bridge.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS + PADDED_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("l,k", [(40, 5), (50, 7), (9, 3), (56, 9)])
def test_encoder_kernel_matches_plain_at_other_widths(cuda, d, dtype,
                                                      dropout, l, k):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(2)
    x, pe, p, mask = encoder_args(cuda, dt, gen, l=l, k=k, d=d)
    kw = dict(dropout_rate=dropout, seed=SEED)
    counter = width_counter(encoder.FWD_BY_WIDTH, d)
    launches = counter.launches
    got = encoder.encoder_reduce(x, pe, p, k, mask, **kw)
    want = encoder.encoder_reduce_plain(x, pe, p, k, mask, **kw)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    close(got, want, encoder.TOL[dt])
    assert (got[0, 1].float() == want[0, 1].float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS + PADDED_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("l,k,masked", [(50, 7, True), (50, 7, False),
                                        (9, 3, True)])
def test_encoder_block_kernel_matches_plain_at_other_widths(
        cuda, d, dtype, dropout, l, k, masked):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    x, pe, p, _ = encoder_args(cuda, dt, gen, l=l, k=k, d=d)
    zm = stream_mask(x.shape[1], l).to(cuda) if masked else None
    kw = dict(dropout_rate=dropout, seed=SEED)
    counter = width_counter(encoder.BLOCK_BY_WIDTH, d)
    launches = counter.launches
    got = encoder.encoder_block(x, pe, p, k, zm, **kw)
    want = encoder.encoder_block_plain(x, pe, p, k, zm, **kw)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    assert got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    valid = 1.0 if zm is None else zm[..., None]
    close(got.float() * valid, want.float() * valid, encoder.TOL[dt])


@pytest.mark.cuda
def test_kernels_refuse_widths_past_256_and_train_at_256(cuda):
    """D = 384 is refused by every forward wrapper, naming the widths and
    ROADMAP A10d; the backward kernels take D = 256
    (csrc/encoder_bwd_tc_wide.cu, its own launch count) as they take
    128."""
    gen = torch.Generator().manual_seed(9)
    args = attn_args(cuda, torch.bfloat16, d=384)
    with pytest.raises(ValueError, match="up to 256.*A10d"):
        qa_ctx_attention.qa_ctx_attention(*args)
    s = randn(gen, 3, 384).to(cuda, torch.bfloat16)
    params = [t.to(cuda) for t in (
        torch.ones(1152), torch.zeros(1152), torch.zeros(1152, 384),
        torch.zeros(384), torch.ones(384), torch.zeros(384))]
    with pytest.raises(ValueError, match="up to 256.*A10d"):
        tri_bridge.tri_bridge(s, s, *params)
    x, pe, p, mask = encoder_args(cuda, torch.bfloat16, gen, d=384)
    with pytest.raises(ValueError, match="up to 256.*A10d"):
        encoder.encoder_reduce(x, pe, p, 5, mask)
    with pytest.raises(ValueError, match="up to 256.*A10d"):
        encoder.encoder_block(x, pe, p, 5)
    x, pe, p, mask = encoder_args(cuda, torch.bfloat16, gen, d=256)
    x.requires_grad_(True)
    out = encoder.encoder_reduce(x, pe, p, 5, mask)
    bwd0 = encoder.BWD_BY_WIDTH[256].launches
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert encoder.BWD_BY_WIDTH[256].launches == bwd0 + 1
    assert torch.isfinite(x.grad.float()).all()


def f32_table(wide, at_128):
    """The encoder's float32 backward by instantiation: ``wide`` (64, 256)
    and the D = 128 entry, which serves both compute modes."""
    return {**wide, 128: at_128}


# the backwards at the other widths: every mode the D = 128 rows of
# chip_smoke.py cover, at shapes with ragged tiles
WIDE_BWD_CASES = [("attention", "target", 25), ("attention", "none", 50),
                  ("attention", "full", 64), ("tri", None, 39),
                  ("encoder", None, 40), ("encoder", None, 9),
                  ("block", True, 50), ("block", False, 50),
                  ("block", True, 56)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS + PADDED_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,mode,n", WIDE_BWD_CASES)
def test_backward_kernels_match_plain_at_other_widths(cuda, d, dtype, family,
                                                      mode, n):
    """csrc/*_bwd_wide.cu at D = 64 and 256, dropout 0.1: the kernels'
    gradients against autograd through the plain versions (the same
    Philox mask), at the D = 128 tests' bars, and twice for the same bits;
    each launch counted on its width's counter."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(10)
    drop = dict(dropout_rate=P_DROP, seed=SEED)
    if family == "attention":
        args = attn_args(cuda, dt, a=5, li=3, lqa=8, lr=n, d=d)
        targets = torch.tensor([2, 0], device=cuda)
        kw = dict(raw_mode=mode, targets=targets, **drop)
        flip = checks.attention_flip_elements(*args, **drop)
        cot = [randn(gen, 2, 5, 3, 8, d).to(cuda) * ~flip]
        if mode == "target":
            c_t = args[4][torch.arange(2, device=cuda), targets]
            cot.append(randn(gen, 2, 3, 8, n).to(cuda)
                       * c_t[:, None, :, None] * args[5][:, :, None, :])
        elif mode == "full":
            cot.append(randn(gen, 2, 5, 3, 8, n).to(cuda)
                       * args[4][:, :, None, :, None]
                       * args[5][:, None, :, None, :])
        counter, tol = (width_counter(qa_ctx_attention.BWD_BY_WIDTH, d),
                        qa_ctx_attention.GRAD_TOL[dt])

        def kernel(*a_):
            return qa_ctx_attention.qa_ctx_attention(*a_, **kw)

        def plain(*a_):
            return qa_ctx_attention.qa_ctx_attention_plain(*a_, **kw)
        fixed = (4, 5)
    elif family == "tri":
        rows = (1, 1, 1, n)
        params = [1 + randn(gen, 3 * d, scale=0.1),
                  randn(gen, 3 * d, scale=0.1),
                  randn(gen, 3 * d, d, scale=(3 * d) ** -0.5),
                  randn(gen, d, scale=0.1), 1 + randn(gen, d, scale=0.1),
                  randn(gen, d, scale=0.1)]
        args = [randn(gen, *rows, d).to(cuda, dt),
                randn(gen, *rows, d).to(cuda, dt)] + [
            t.to(cuda) for t in params]
        flip = checks.tri_bridge_flip_rows(*args[:6], P_DROP, SEED)
        cot = [randn(gen, *rows, d).to(cuda) * (~flip)[..., None]]
        counter, tol = (width_counter(tri_bridge.BWD_BY_WIDTH, d),
                        tri_bridge.GRAD_TOL[dt])

        def kernel(*a_):
            return tri_bridge.tri_bridge(*a_, P_DROP, SEED)

        def plain(*a_):
            return tri_bridge.tri_bridge_plain(*a_, P_DROP, SEED)
        fixed = ()
    else:
        k = {40: 5, 9: 3, 50: 7, 56: 9}[n]
        # float32 counts apart from the bf16 (tensor-core) entry
        f32 = dt == torch.float32
        x, pe, p, mask = encoder_args(cuda, dt, gen, g=6, l=n, k=k, d=d)
        keys = encoder.PARAM_KEYS
        if family == "encoder":
            cot = [encoder_cotangent(x, pe, p, k, mask, dt, gen, P_DROP)]
            counter, fn_k, fn_p, m = (
                width_counter(f32_table(encoder.F32_BWD_BY_WIDTH,
                                        encoder.BWD_KERNEL)
                              if f32 else encoder.BWD_BY_WIDTH, d),
                encoder.encoder_reduce, encoder.encoder_reduce_plain, mask)
        else:
            zm = stream_mask(x.shape[1], n).to(cuda) if mode else None
            valid = torch.ones(x.shape[:3], device=cuda) if zm is None \
                else zm.expand(x.shape[:3])
            flip = checks.encoder_block_flip_groups(
                x, pe, p, k, zm, P_DROP, SEED) if dt == torch.float32 \
                else torch.zeros(x.shape[:2], dtype=torch.bool, device=cuda)
            cot = [randn(gen, *x.shape).to(cuda)
                   * (valid * ~flip[..., None])[..., None]]
            counter, fn_k, fn_p, m = (
                width_counter(f32_table(encoder.F32_BLOCK_BWD_BY_WIDTH,
                                        encoder.BLOCK_BWD_KERNEL)
                              if f32 else encoder.BLOCK_BWD_BY_WIDTH, d),
                encoder.encoder_block, encoder.encoder_block_plain, zm)
        tol = encoder.GRAD_TOL[dt]
        args = [x] + [p[key] for key in keys]

        def kernel(xa, *ps):
            return fn_k(xa, pe, dict(zip(keys, ps)), k, m, P_DROP, SEED)

        def plain(xa, *ps):
            return fn_p(xa, pe, dict(zip(keys, ps)), k, m, P_DROP, SEED)
        fixed = ()

    def run(fn):
        ins = leaves(args)
        for i in fixed:
            ins[i].requires_grad_(False)
        return grads_of(fn, ins, cot)[1]
    n0 = counter.launches
    g_k, g_again, g_p = run(kernel), run(kernel), run(plain)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert g_k[0].dtype == dt
    for i, (gk, ga, gp) in enumerate(zip(g_k, g_again, g_p)):
        assert torch.equal(gk, ga), f"grad {i} differs between two runs"
        checks.hold_grad(f"D {d} {family} grad {i}", gk, gp, tol)


# ------------------------------------- the merged encoder's group map (C5)
@pytest.mark.cuda
@pytest.mark.parametrize("d", (128, 96, 256, 200))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_block_group_map_keys_frames_as_the_whole(cuda, d, dtype):
    """The full-output kernel with dropout on one ctx rank's groups (the
    QA groups, then its frames of two streams) under the group map equals,
    bit for bit, the kernel on the whole group axis at those groups, and
    the plain version under the same map at the kernel's tolerance; its
    backward matches autograd through the plain version."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(12)
    num_a, whole, ctx, l, k = 3, 8, 2, 50, 7
    g = num_a + 2 * whole
    x, pe, p, _ = encoder_args(cuda, dt, gen, g=g, l=l, k=k, d=d)
    kw = dict(dropout_rate=P_DROP, seed=SEED)
    ref = encoder.encoder_block(x, pe, p, k, None, **kw)
    li = whole // ctx
    for c in range(ctx):
        rows = torch.cat([torch.arange(num_a),
                          num_a + c * li + torch.arange(li),
                          num_a + whole + c * li + torch.arange(li)])
        groups = (rows.to(cuda, torch.int32), g)
        xr = x[:, rows.to(cuda)].contiguous().requires_grad_(True)
        got = encoder.encoder_block(xr, pe, p, k, None, groups=groups, **kw)
        xp = xr.detach().requires_grad_(True)
        want = encoder.encoder_block_plain(xp, pe, p, k, None,
                                           groups=groups, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref[:, rows.to(cuda)]), c
        close(got, want, encoder.TOL[dt])
        cot = torch.ones_like(got, dtype=torch.float32) / got.numel()
        gk, = torch.autograd.grad(got, xr, cot.to(dt))
        gp, = torch.autograd.grad(want, xp, cot.to(dt))
        checks.hold_grad(f"group map D {d} gx", gk, gp,
                         encoder.GRAD_TOL[torch.bfloat16])


# ------------------------------------------- encoder, full output / zero mask
def stream_mask(g, l):
    """(G, L) length mask of three merged streams of different lengths."""
    lens = torch.tensor([l] * (g - 2 * (g // 3)) + [max(1, l - 3)] * (g // 3)
                        + [max(1, l // 2)] * (g // 3))
    return (torch.arange(l)[None, :] < lens[:, None]).float()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,k,masked", [(50, 7, True), (50, 7, False),
                                        (40, 5, True), (9, 3, True)])
def test_encoder_block_kernel_matches_plain(cuda, dtype, l, k, masked):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    x, pe, p, _ = encoder_args(cuda, dt, gen, l=l, k=k)
    zm = stream_mask(x.shape[1], l).to(cuda) if masked else None
    fwd0 = encoder.BLOCK_KERNEL.launches
    got = encoder.encoder_block(x, pe, p, k, zm)
    want = encoder.encoder_block_plain(x, pe, p, k, zm)
    torch.cuda.synchronize()
    assert encoder.BLOCK_KERNEL.launches == fwd0 + 1
    assert got.shape == x.shape and got.dtype == dt
    assert torch.isfinite(got.float()).all()     # the masked rows too
    valid = 1.0 if zm is None else zm[..., None]
    close(got.float() * valid, want.float() * valid, encoder.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,k,masked", [(50, 7, True), (50, 7, False),
                                        (9, 3, True), (56, 9, True),
                                        (25, 5, True), (7, 3, False)])
def test_encoder_block_training_kernels_match_plain(cuda, dtype, l, k,
                                                    masked):
    """Forward with in-kernel dropout and the backward kernel against the
    plain version (autograd, the same Philox mask on the merged tensor);
    the backward twice for the same bits."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(9)
    x, pe, p, _ = encoder_args(cuda, dt, gen, l=l, k=k)
    zm = stream_mask(x.shape[1], l).to(cuda) if masked else None
    valid = torch.ones(x.shape[:3], device=cuda) if zm is None \
        else zm.expand(x.shape[:3])
    # float32: no cotangent on sequences near a ReLU decision (ops/checks.py);
    # bf16 is held by relative L2 and keeps every sequence
    flip = checks.encoder_block_flip_groups(x, pe, p, k, zm, P_DROP, SEED) \
        if dt == torch.float32 else torch.zeros(x.shape[:2], dtype=torch.bool,
                                                device=cuda)
    cot = [randn(gen, *x.shape).to(cuda)
           * (valid * ~flip[..., None])[..., None]]
    keys = encoder.PARAM_KEYS

    def run(fn):
        xs = x.detach().clone().requires_grad_(True)
        ps = {key: t.detach().clone().requires_grad_(True)
              for key, t in p.items()}
        out, _ = grads_of(lambda a: fn(a, pe, ps, k, zm, P_DROP, SEED),
                          [xs], cot)
        return out[0], [xs.grad] + [ps[key].grad for key in keys]
    bwd0 = encoder.BLOCK_BWD_KERNEL.launches
    out_k, g_k = run(encoder.encoder_block)
    _, g_again = run(encoder.encoder_block)
    out_p, g_p = run(encoder.encoder_block_plain)
    torch.cuda.synchronize()
    assert encoder.BLOCK_BWD_KERNEL.launches == bwd0 + 2
    close(out_k.float() * valid[..., None], out_p.float() * valid[..., None],
          encoder.TOL[dt])
    for name, gk, ga, gp in zip(("x",) + keys, g_k, g_again, g_p):
        assert torch.equal(gk, ga), name
        checks.hold_grad(name, gk, gp, encoder.GRAD_TOL[dt])
    assert g_k[0].dtype == dt
    assert (g_k[0][valid == 0] == 0).all()


# --------------------------------------------------------------- MLP bridge
def mlp_bridge_args(cuda, dt, gen, rows, d_in, d_out):
    x = randn(gen, *rows, d_in).to(cuda, dt)
    params = [1 + randn(gen, d_in, scale=0.1), randn(gen, d_in, scale=0.1),
              randn(gen, d_in, d_out, scale=d_in ** -0.5),
              randn(gen, d_out, scale=0.1), 1 + randn(gen, d_out, scale=0.1),
              randn(gen, d_out, scale=0.1)]
    return [x] + [t.to(cuda) for t in params]


BRIDGE_SHAPES = [((2, 5, 40), 768, 300), ((2, 3, 25), 300, 300),
                 ((1, 1, 7), 24, 20), ((3, 33), 132, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d_in,d_out", BRIDGE_SHAPES)
def test_mlp_bridge_kernel_matches_plain(cuda, dtype, rows, d_in, d_out):
    dt = getattr(torch, dtype)
    args = mlp_bridge_args(cuda, dt, torch.Generator().manual_seed(10), rows,
                           d_in, d_out)
    fwd0 = mlp_bridge.KERNEL.launches
    got = mlp_bridge.mlp_bridge(*args)
    want = mlp_bridge.mlp_bridge_plain(*args)
    torch.cuda.synchronize()
    assert mlp_bridge.KERNEL.launches == fwd0 + 1
    assert got.shape == rows + (d_out,) and got.dtype == dt
    close(got, want, mlp_bridge.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d_in,d_out", BRIDGE_SHAPES)
def test_mlp_bridge_training_kernels_match_plain(cuda, dtype, rows, d_in,
                                                 d_out):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(11)
    args = mlp_bridge_args(cuda, dt, gen, rows, d_in, d_out)
    flip = checks.mlp_bridge_flip_rows(*args[:5], P_DROP, SEED)
    cot = [randn(gen, *rows, d_out).to(cuda) * (~flip)[..., None]]
    bwd0 = mlp_bridge.BWD_KERNEL.launches

    def kernel(*a):
        return mlp_bridge.mlp_bridge(*a, P_DROP, SEED)
    out_k, g_k = grads_of(kernel, leaves(args), cot)
    _, g_again = grads_of(kernel, leaves(args), cot)
    out_p, g_p = grads_of(
        lambda *a: mlp_bridge.mlp_bridge_plain(*a, P_DROP, SEED),
        leaves(args), cot)
    torch.cuda.synchronize()
    assert mlp_bridge.BWD_KERNEL.launches == bwd0 + 2
    close(out_k[0], out_p[0], mlp_bridge.TOL[dt])
    assert g_k[0].dtype == dt
    for i, (gk, ga, gp) in enumerate(zip(g_k, g_again, g_p)):
        assert torch.equal(gk, ga), i
        checks.grad_close(f"grad {i}", gk, gp, mlp_bridge.GRAD_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("rows,d_in,d_out", BRIDGE_SHAPES)
def test_mlp_bridge_bf16_mode_on_float32_x_matches_plain(cuda, dropout, rows,
                                                         d_in, d_out):
    """The bf16 compute mode on float32 x (``MLPBridge(use_kernel=True,
    dtype=bf16)`` on STAGE's float32 inputs), forward and backward, against
    the plain version in the same mode at ``TOL`` / ``GRAD_TOL[bf16]``:
    bf16 out, float32 gx."""
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(16)
    args = mlp_bridge_args(cuda, torch.float32, gen, rows, d_in, d_out)
    flip = checks.mlp_bridge_flip_rows(*args[:5], dropout, SEED,
                                       compute_dtype=bf16)
    cot = [randn(gen, *rows, d_out).to(cuda) * (~flip)[..., None]]
    kw = dict(dropout_rate=dropout, seed=SEED, compute_dtype=bf16)
    out_k, g_k = grads_of(lambda *a: mlp_bridge.mlp_bridge(*a, **kw),
                          leaves(args), cot)
    out_p, g_p = grads_of(lambda *a: mlp_bridge.mlp_bridge_plain(*a, **kw),
                          leaves(args), cot)
    torch.cuda.synchronize()
    assert out_k[0].dtype == bf16 and g_k[0].dtype == torch.float32
    close(out_k[0], out_p[0], mlp_bridge.TOL[bf16])
    for i, (gk, gp) in enumerate(zip(g_k, g_p)):
        checks.grad_close(f"grad {i}", gk, gp, mlp_bridge.GRAD_TOL[bf16])


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(12)
    x, pe, p, _ = encoder_args(cuda, torch.float32, gen, l=50, k=7)
    zm = stream_mask(x.shape[1], 50).to(cuda)
    with pytest.raises(ValueError):          # D != 128
        encoder.encoder_block(x[..., :64].contiguous(), pe[:, :64], p, 7, zm)
    with pytest.raises(ValueError):          # a mask left on the host
        encoder.encoder_block(x, pe, p, 7, zm.cpu())
    with pytest.raises(ValueError):          # a (B, G, L) zero mask
        encoder.encoder_block(x, pe, p, 7, zm.expand(x.shape[:3]))
    long, pe_l, p_l, _ = encoder_args(cuda, torch.float32, gen, l=60, k=7)
    with pytest.raises(ValueError):          # L > MAX_LEN
        encoder.encoder_block(long, pe_l, p_l, 7)
    with pytest.raises(ValueError):          # cotangent of another shape
        encoder.encoder_block_backward(x, pe, encoder.pack_params(p), zm,
                                       x[:, :, 0], 7)
    args = mlp_bridge_args(cuda, torch.float32, gen, (2, 3, 5), 24, 20)
    for d_in, d_out in ((22, 20), (24, 18)):         # not multiples of 4
        bad = mlp_bridge_args(cuda, torch.float32, gen, (2, 3, 5), d_in,
                              d_out)
        with pytest.raises(ValueError):
            mlp_bridge.mlp_bridge(*bad)
    with pytest.raises(ValueError):          # parameters left on the host
        mlp_bridge.mlp_bridge(args[0], *[t.cpu() for t in args[1:]])
    with pytest.raises(ValueError):          # not contiguous
        mlp_bridge.mlp_bridge(args[0].transpose(0, 1), *args[1:])
    with pytest.raises(ValueError):          # cotangent of another shape
        mlp_bridge.mlp_bridge_backward(*args, args[0])


# ------------------------------ the MLP bridge (B5) on the tensor cores
# rows at and around the 64-row tile (1, 63, 64, 65, 129), STAGE's three
# sites (3,200 qas_bert, 20,000 vid, 40,000 sub_bert rows), every width the
# kernels are tested at (Kp / Np = 768 / 320, 320 / 320, 64 / 64,
# 192 / 320, 128 / 64)
TC_BRIDGE_ROWS = (1, 63, 64, 65, 129, 3200, 20000, 40000)
TC_BRIDGE_WIDTHS = [(768, 300), (300, 300), (24, 20), (132, 260), (100, 60)]


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("d_in,d_out", TC_BRIDGE_WIDTHS)
@pytest.mark.parametrize("rows", TC_BRIDGE_ROWS)
def test_mlp_bridge_tc_kernels_match_plain(cuda, rows, d_in, d_out, dropout,
                                           x_dtype):
    """The bf16 tensor-core forward and backward on bf16 or float32 x
    against the plain version in the bf16 mode and autograd through it,
    with the same Philox mask, at ``TOL`` / ``GRAD_TOL[bf16]`` (rows whose
    ReLU input lies within ``BRIDGE_BF16_EPS`` of 0 take no cotangent);
    the backward twice for the same bits."""
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(rows + d_in)
    args = mlp_bridge_args(cuda, getattr(torch, x_dtype), gen, (rows,), d_in,
                           d_out)
    kw = dict(dropout_rate=dropout, seed=SEED, compute_dtype=bf16)
    flip = checks.mlp_bridge_flip_rows(*args[:5], dropout, SEED,
                                       compute_dtype=bf16)
    cot = [randn(gen, rows, d_out).to(cuda) * (~flip)[..., None]]
    fwd0, bwd0 = mlp_bridge.KERNEL.launches, mlp_bridge.BWD_KERNEL.launches
    out_k, g_k = grads_of(lambda *a: mlp_bridge.mlp_bridge(*a, **kw),
                          leaves(args), cot)
    _, g_again = grads_of(lambda *a: mlp_bridge.mlp_bridge(*a, **kw),
                          leaves(args), cot)
    out_p, g_p = grads_of(lambda *a: mlp_bridge.mlp_bridge_plain(*a, **kw),
                          leaves(args), cot)
    torch.cuda.synchronize()
    assert mlp_bridge.KERNEL.launches == fwd0 + 2
    assert mlp_bridge.BWD_KERNEL.launches == bwd0 + 2
    assert out_k[0].dtype == bf16 and out_k[0].shape == (rows, d_out)
    assert g_k[0].dtype == args[0].dtype
    close(out_k[0], out_p[0], mlp_bridge.TOL[bf16])
    for i, (gk, ga, gp) in enumerate(zip(g_k, g_again, g_p)):
        assert torch.equal(gk, ga), i
        checks.grad_close(f"grad {i}", gk, gp, mlp_bridge.GRAD_TOL[bf16])


@pytest.mark.cuda
@pytest.mark.parametrize("d_in,offset", [(300, 0), (768, 0), (768, 300),
                                         (768, 468), (100, 40)])
def test_mlp_bridge_tc_forward_drops_the_plain_philox_positions(cuda, d_in,
                                                                offset):
    """Parameters that make the output show the dropout mask: LN_in gives 1
    everywhere (scale 0, bias 1), W copies the dropped LN output's columns
    offset .. offset + Dout - 1 to the outputs, and LN_out centres each
    row, so an output is above 0 exactly where its input was kept (the
    three 768-wide cases see every column)."""
    d_out = 300 if d_in > 100 else 60
    gen = torch.Generator().manual_seed(20)
    shape = (3, 7, 40)
    x = randn(gen, *shape, d_in).to(cuda, torch.bfloat16)
    w = torch.zeros(d_in, d_out)
    w[offset:offset + d_out] = torch.eye(d_out)
    params = [torch.zeros(d_in), torch.ones(d_in), w, torch.zeros(d_out),
              torch.ones(d_out), torch.zeros(d_out)]
    params = [t.to(cuda) for t in params]
    got = mlp_bridge.mlp_bridge(x, *params, P_DROP, SEED)
    want = mlp_bridge.mlp_bridge_plain(x, *params, P_DROP, SEED)
    torch.cuda.synchronize()
    assert torch.equal(got > 0, want > 0)
    keep = keep_mask(shape + (d_in,), cuda)[..., offset:offset + d_out]
    both = keep.any(-1) & ~keep.all(-1)       # rows with a dropped element
    assert both.float().mean() > 0.99
    assert torch.equal((got > 0)[both], keep[both])


def bridge_module_step(cuda, seeds, gen=None):
    """A bf16 ``MLPBridge(use_kernel=True)`` (768 -> 300, dropout 0.1) and
    its train step on a (2, 5, 40, 768) batch: the output and the gradients
    of the parameters under the cotangent, the kernels' seed the next slot
    of ``seeds`` (``StepSeeds``)."""
    from tvqaplus_tpu_torch.models.layers import Dropout, MLPBridge
    gen = gen or torch.Generator().manual_seed(19)
    mod = MLPBridge(768, 300, P_DROP, torch.bfloat16, use_kernel=True)
    with torch.no_grad():              # every parameter from the generator
        for name, prm in mod.named_parameters():
            ln_scale = name in ("0.weight", "4.weight")
            prm.copy_(float(ln_scale) + randn(
                gen, *prm.shape, scale=768 ** -0.5 if prm.dim() == 2 else 0.1))
    mod = mod.to(cuda).train()
    params = list(mod.parameters())
    batch = {"x": randn(gen, 2, 5, 40, 768).to(cuda, torch.bfloat16),
             "cot": randn(gen, 2, 5, 40, 300).to(cuda, torch.bfloat16)}

    def step(b):
        out = mod(b["x"], Dropout(P_DROP, None, seeds.next()))
        return (out,) + torch.autograd.grad(out, params, b["cot"])
    return step, batch


@pytest.mark.cuda
def test_bf16_bridge_module_step_runs_the_tensor_core_kernels(cuda):
    """A bf16 ``MLPBridge(use_kernel=True)`` train step launches the
    tensor-core forward, backward and weight-gradient kernels and no
    CUDA-core kernel of the bridge (chip_smoke.py's bridge_module phase
    holds the same)."""
    from torch.profiler import ProfilerActivity, profile

    from tvqaplus_tpu_torch.ops import philox
    step, batch = bridge_module_step(cuda, philox.StepSeeds(SEED, cuda))
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    for want in ("mlp_bridge_fwd_tc_kernel", "mlp_bridge_bwd_tc_kernel",
                 "mlp_bridge_wgrad_tc_kernel"):
        assert any(want in nm for nm in names), (want, names)
    old = [nm for nm in names if "mlp_bridge_fwd_kernel" in nm
           or "mlp_bridge_bwd_kernel" in nm or "bridge_wgrad_kernel" in nm]
    assert not old, old


@pytest.mark.cuda
def test_bridge_module_train_step_replays_give_eager_bits(cuda):
    """The module's train step captured by ``StepGraphs``: the warm-up and
    each replay give the output and parameter gradients of the eager step
    with the same seed counter, bit for bit, and replays draw new masks."""
    from tvqaplus_tpu_torch.dispatch import StepGraphs
    from tvqaplus_tpu_torch.ops import philox
    eager, batch = bridge_module_step(cuda, philox.StepSeeds(SEED, cuda))
    replayed, _ = bridge_module_step(cuda, philox.StepSeeds(SEED, cuda))
    graphs = StepGraphs(cuda)
    outs = []
    for _ in range(3):
        want = eager(batch)
        got = graphs("bridge_step", replayed, batch)
        for w, g in zip(want, got):
            assert torch.equal(w, g)
        outs.append(got[0].clone())
    assert len(graphs.graphs) == 1
    assert not torch.equal(outs[1], outs[2])


# -------------------------------- the bf16 forwards on the tensor cores
# (L, k) sweep of the tensor-core encoder forward: L 1 .. 56 (128 down to 2
# sequences a 128-row tile), every odd k <= 9.  N = 23 sequences leaves a
# ragged last tile at every L.
TC_LENGTHS = (1, 9, 40, 50, 56)
TC_KS = (1, 3, 5, 7, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("k", TC_KS)
@pytest.mark.parametrize("l", TC_LENGTHS)
def test_encoder_tc_forward_matches_plain(cuda, l, k, dropout):
    """Both modes of the bf16 forward against the plain version (one or two
    bf16 steps): reduce mode with a sequence whose mask is all zero (-1e10
    in every channel), full mode with zero-mask rows (computed, finite)."""
    gen = torch.Generator().manual_seed(13)
    x, pe, p, mask = encoder_args(cuda, torch.bfloat16, gen, b=1, g=23, l=l,
                                  k=k)               # mask[0, 1] all zero
    mask[0, 2, 0] = 1                # L = 1: a live sequence beside it
    kw = dict(dropout_rate=dropout, seed=SEED)
    fwd0 = encoder.KERNEL.launches
    got = encoder.encoder_reduce(x, pe, p, k, mask, **kw)
    want = encoder.encoder_reduce_plain(x, pe, p, k, mask, **kw)
    torch.cuda.synchronize()
    assert encoder.KERNEL.launches == fwd0 + 1
    assert got.dtype == torch.bfloat16
    close(got, want, encoder.TOL[torch.bfloat16])
    neg = torch.tensor(-1e10, dtype=torch.bfloat16, device=cuda)
    assert (got[0, 1] == neg).all()
    live = mask.amax(-1) > 0
    assert (got[live].float() > -1e9).all() and live.sum() > 10
    zm = stream_mask(x.shape[1], l).to(cuda)
    zm[5, l // 2] = 0                # a zero inside a stream too
    got = encoder.encoder_block(x, pe, p, k, zm, **kw)
    want = encoder.encoder_block_plain(x, pe, p, k, zm, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    valid = zm[..., None]
    close(got.float() * valid, want.float() * valid,
          encoder.TOL[torch.bfloat16])


TC_TRI_ROWS = [(1, 1, 1, 39), (1, 1, 2, 32), (2, 5, 2, 20), (3, 7, 50, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("rows", TC_TRI_ROWS)
def test_tri_bridge_tc_forward_matches_plain(cuda, rows, dropout):
    """The bf16 forward at R < 64, R = 64, R = 400 (not a multiple of 64)
    and 42,000 rows (more tiles than blocks: the double-buffered loads)."""
    gen = torch.Generator().manual_seed(14)
    s = randn(gen, *rows, D).to(cuda, torch.bfloat16)
    v = randn(gen, *rows, D).to(cuda, torch.bfloat16)
    params = [1 + randn(gen, 3 * D, scale=0.1), randn(gen, 3 * D, scale=0.1),
              randn(gen, 3 * D, D, scale=(3 * D) ** -0.5),
              randn(gen, D, scale=0.1), 1 + randn(gen, D, scale=0.1),
              randn(gen, D, scale=0.1)]
    params = [t.to(cuda) for t in params]
    fwd0 = tri_bridge.KERNEL.launches
    got = tri_bridge.tri_bridge(s, v, *params, dropout, SEED)
    want = tri_bridge.tri_bridge_plain(s, v, *params, dropout, SEED)
    torch.cuda.synchronize()
    assert tri_bridge.KERNEL.launches == fwd0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == s.shape
    close(got, want, tri_bridge.TOL[torch.bfloat16])


def keep_mask(shape, cuda):
    """The plain Philox keep mask (ops/philox.py) of a tensor of ``shape``
    at the tests' seed."""
    from tvqaplus_tpu_torch.ops import philox
    return philox.multiplier(shape, SEED, P_DROP, cuda) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 2])
def test_tri_bridge_tc_forward_drops_the_plain_philox_positions(cuda, group):
    """Parameters that make the output show the dropout mask: LN_in gives 1
    everywhere (scale 0, bias 1), W copies group ``group`` of the dropped
    LN output to the 128 outputs, and LN_out centres each row, so an output
    is above 0 exactly where its input was kept."""
    gen = torch.Generator().manual_seed(15)
    shape = (2, 3, 7, 40)
    s = randn(gen, *shape, D).to(cuda, torch.bfloat16)
    v = randn(gen, *shape, D).to(cuda, torch.bfloat16)
    w = torch.zeros(3 * D, D)
    w[group * D:(group + 1) * D] = torch.eye(D)
    params = [torch.zeros(3 * D), torch.ones(3 * D), w, torch.zeros(D),
              torch.ones(D), torch.zeros(D)]
    params = [t.to(cuda) for t in params]
    got = tri_bridge.tri_bridge(s, v, *params, P_DROP, SEED)
    want = tri_bridge.tri_bridge_plain(s, v, *params, P_DROP, SEED)
    torch.cuda.synchronize()
    assert torch.equal(got > 0, want > 0)
    keep = keep_mask(shape + (3 * D,), cuda)[..., group * D:(group + 1) * D]
    both = keep.any(-1) & ~keep.all(-1)       # rows with a dropped element
    assert both.float().mean() > 0.99
    assert torch.equal((got > 0)[both], keep[both])


@pytest.mark.cuda
@pytest.mark.parametrize("l,k", [(40, 5), (50, 7), (9, 1), (56, 9)])
def test_encoder_tc_forward_drops_the_plain_philox_positions(cuda, l, k):
    """Parameters that make the block output show conv 0's dropout mask:
    x + pe = 0 and LN_0 gives 1 everywhere, the centre tap and pw0 copy the
    dropped LN output into h, layer 1 adds 0, and the final LN centres each
    row, so an output is above 0 exactly where its LN_0 output was kept."""
    shape = (2, 6, l, D)
    x = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    pe = torch.zeros(l, D, device=cuda)
    p = {}
    for i in (0, 1):
        dw = torch.zeros(k, D)
        dw[k // 2] = 1.0 - i
        p.update({f"ln{i}_s": torch.zeros(D),
                  f"ln{i}_b": torch.full((D,), 1.0 - i), f"dw{i}": dw,
                  f"dwb{i}": torch.zeros(D), f"pw{i}": torch.eye(D),
                  f"pwb{i}": torch.zeros(D)})
    p.update(lnf_s=torch.ones(D), lnf_b=torch.zeros(D))
    p = {key: t.to(cuda) for key, t in p.items()}
    got = encoder.encoder_block(x, pe, p, k, None, P_DROP, SEED)
    want = encoder.encoder_block_plain(x, pe, p, k, None, P_DROP, SEED)
    torch.cuda.synchronize()
    assert torch.equal(got > 0, want > 0)
    keep = keep_mask(shape, cuda)
    both = keep.any(-1) & ~keep.all(-1)
    assert both.float().mean() > 0.99
    assert torch.equal((got > 0)[both], keep[both])


def step_kernel_names(cuda, train, merged, results_dir):
    """Names of the CUDA kernels that one bf16 step of STAGE launches (a
    small batch, 12 frames): the train step, or the eval step with
    grounding."""
    from torch.profiler import ProfilerActivity, profile

    from tvqaplus_tpu_torch.config import Config
    from tvqaplus_tpu_torch.data.batching import (
        StaticShapeSpec,
        collate_static,
    )
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.train.loop import Trainer
    n, frames = 2, 12
    cfg = Config(synthetic_data=True, add_local=True, use_sup_att=train,
                 bsz=n, test_bsz=n, seed=3, merge_input_streams=merged,
                 results_dir=str(results_dir)).finalize(cuda)
    assert cfg.compute_dtype == "bfloat16"
    ds = SyntheticTVQADataset(cfg, n, mode="train" if train else "valid")
    spec = StaticShapeSpec.from_config(cfg, batch=n, train=train
                                       ).with_max_img(frames)
    arrays, _ = collate_static([ds[i] for i in range(n)], spec)
    batch = {key: torch.from_numpy(a).to(cuda) for key, a in arrays.items()}
    if train:
        trainer = Trainer(cfg, cuda)

        def step():
            return trainer.train_step(batch)
    else:
        model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
            torch.Generator().manual_seed(3)).to(cuda)
        runner = InferenceRunner(cfg, model, cuda)

        def step():
            return runner.step(batch, True, frames)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_steps_run_the_tensor_core_forwards(cuda, tmp_path, train,
                                                 merged):
    """A bf16 serve and train step, separate and merged, launch the
    tensor-core forwards of the encoder (cls_encoder k 5; merged: the input
    encoder k 7 too) and of the tri bridge, and no CUDA-core forward of
    either."""
    names = step_kernel_names(cuda, train, merged, tmp_path)
    # the D = 128 instantiations, <D, k>
    tc = [nm.replace(" ", "") for nm in names
          if "encoder_fwd_tc_kernel" in nm]
    assert any("encoder_fwd_tc_kernel<128,5>" in nm for nm in tc), names
    assert any("encoder_fwd_tc_kernel<128,7>" in nm for nm in tc) \
        == merged, tc
    assert any("tri_bridge_fwd_tc_kernel" in nm for nm in names), names
    old = [nm for nm in names
           if "encoder_fwd_kernel" in nm or "tri_bridge_fwd_kernel" in nm]
    assert not old, old


# ------------------------------------------------------------ dispatch
def step_batch(cfg, n, frames, train, device):
    """A synthetic batch of ``n`` examples at ``frames`` frames."""
    from tvqaplus_tpu_torch.data.batching import (
        StaticShapeSpec,
        collate_static,
    )
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    ds = SyntheticTVQADataset(cfg, n, mode="train" if train else "valid")
    spec = StaticShapeSpec.from_config(cfg, batch=n, train=train
                                       ).with_max_img(frames)
    arrays, _ = collate_static([ds[i] for i in range(n)], spec)
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


@pytest.mark.cuda
def test_graph_replays_draw_from_the_registered_generator(cuda):
    """A step that draws from a device generator, captured by
    ``StepGraphs``: the warm-up and each replay draw what eager draws from
    the same generator state one after the other."""
    from tvqaplus_tpu_torch.dispatch import StepGraphs
    gen = torch.Generator(device=cuda).manual_seed(0)
    graphs = StepGraphs(cuda, gen)
    x = {"x": torch.zeros(4096, device=cuda)}

    def fn(b):
        return torch.rand(b["x"].shape, generator=gen, device=cuda) + b["x"]
    got = [graphs("rand", fn, x).clone() for _ in range(4)]
    ref = torch.Generator(device=cuda).manual_seed(0)
    want = [torch.rand(4096, generator=ref, device=cuda) for _ in range(4)]
    assert len(graphs.graphs) == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[1], got[2])


@pytest.mark.cuda
def test_replays_count_the_launches_they_hold(cuda):
    """A kernel launched inside a captured step counts once for each replay
    (the warm-up once), none for the capture."""
    from tvqaplus_tpu_torch.dispatch import StepGraphs
    gen = torch.Generator().manual_seed(17)
    args = mlp_bridge_args(cuda, torch.bfloat16, gen, (2, 3, 5), 24, 20)
    graphs = StepGraphs(cuda)
    before = mlp_bridge.KERNEL.launches

    def fn(b):
        return mlp_bridge.mlp_bridge(b["x"], *args[1:])
    outs = [graphs("bridge", fn, {"x": args[0]}).clone() for _ in range(3)]
    torch.cuda.synchronize()
    assert mlp_bridge.KERNEL.launches == before + 3
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.cuda
def test_capturable_adam_reads_its_device_rate(cuda):
    """On cuda Adam is capturable with its rate in a device tensor: three
    steps match torch's default Adam at 1e-6 relative (the capturable
    formula divides in another order), and ``set_lr`` reaches a captured
    optimizer step."""
    from tvqaplus_tpu_torch.train.state import make_optimizer, set_lr
    gen = torch.Generator().manual_seed(18)
    w0 = randn(gen, 64, 32).to(cuda)
    grads = [randn(gen, 64, 32).to(cuda) for _ in range(3)]
    p, q = (torch.nn.Parameter(w0.clone()) for _ in range(2))
    ours = make_optimizer([p], 1e-3, 3e-7, cuda)
    ref = torch.optim.Adam([q], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=3e-7)
    group = ours.param_groups[0]
    assert group["capturable"] and group["lr"].device.type == "cuda"
    for g in grads:
        p.grad, q.grad = g.clone(), g.clone()
        ours.step()
        ref.step()
    close(p.detach(), q.detach(), (1e-7, 1e-6))
    graph = torch.cuda.CUDAGraph()
    p.grad = grads[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ours.step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        ours.step()
    before = p.detach().clone()
    set_lr(ours, 0.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(p.detach(), before)
    set_lr(ours, 1e-2)
    graph.replay()
    torch.cuda.synchronize()
    assert float((p.detach() - before).abs().max()) > 5e-3


@pytest.mark.cuda
def test_a_parent_format_checkpoint_resumes_on_cuda(cuda, tmp_path):
    """A checkpoint saved by the CPU Trainer (torch's default Adam: float
    rate, step counts on the CPU; the format before graphs) resumes on the
    card in the capturable mode, its counter at the saved step, and
    dispatches through a graph."""
    from tvqaplus_tpu_torch.config import Config
    from tvqaplus_tpu_torch.train.loop import Trainer
    n = 2
    cfg = Config(synthetic_data=True, add_local=True, use_sup_att=True,
                 bsz=n, test_bsz=n, seed=3, compute_dtype="float32",
                 results_dir=str(tmp_path)).finalize("cpu")
    cpu = Trainer(cfg, "cpu")
    cpu.train_step(step_batch(cfg, n, 12, True, "cpu"), True)
    cpu.save(str(tmp_path / "old.ckpt"))
    resumed = Trainer(dataclasses.replace(
        cfg, resume=str(tmp_path / "old.ckpt")).finalize(cuda), cuda)
    group = resumed.optimizer.param_groups[0]
    assert group["capturable"] and group["lr"].device.type == "cuda"
    assert all(s["step"].device.type == "cuda"
               for s in resumed.optimizer.state.values())
    assert resumed.step == 1 and int(resumed.seeds.step) == 1
    batch = step_batch(cfg, n, 12, True, cuda)
    for _ in range(2):
        loss = float(resumed.dispatch_train(batch, True)["loss"])
    assert resumed.step == 3 and len(resumed.graphs.graphs) == 1
    assert loss == loss


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True])
def test_replayed_dispatches_equal_eager_steps(cuda, tmp_path, merged,
                                               monkeypatch):
    """A small bf16 batch (2 examples, 12 frames, dropout 0.1): replayed
    serve dispatches (one batch, and two stacked) give the eager steps'
    bits; with deterministic algorithms a replayed train dispatch of two
    steps gives the loss, grad_norm and parameters of two eager steps, bit
    for bit."""
    from tvqaplus_tpu_torch.config import Config
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.train.loop import Trainer
    n, frames = 2, 12
    cfg = Config(synthetic_data=True, add_local=True, use_sup_att=True,
                 bsz=n, test_bsz=n, seed=3, merge_input_streams=merged,
                 results_dir=str(tmp_path)).finalize(cuda)
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(3))
    runner = InferenceRunner(cfg, model, cuda)
    vb = step_batch(cfg, n, frames, False, cuda)
    two = {k: torch.stack([v, v.flip(0)]) for k, v in vb.items()}
    want = [runner.step(b, True, frames) for b in (vb, {
        k: v.flip(0) for k, v in vb.items()})]
    for _ in range(3):                      # warm-up and capture, replays
        one = runner.dispatch_infer(vb, True, frames)
        both = runner.dispatch_infer(two, True, frames)
        for k in want[0]:
            assert torch.equal(one[k][0], want[0][k]), k
            assert torch.equal(both[k][0], want[0][k]), k
            assert torch.equal(both[k][1], want[1][k]), k
    assert len(runner.graphs.graphs) == 2

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        eager, graph = Trainer(cfg, cuda), Trainer(cfg, cuda)
        tb = step_batch(cfg, n, frames, True, cuda)
        stack = {k: torch.stack([v, v]) for k, v in tb.items()}
        for _ in range(3):
            ms = eager._packed("train", [eager.train_step(tb)
                                         for _ in range(2)])
            mg = graph.dispatch_train(stack)
            for i, key in enumerate(graph._names["train"]):
                assert float(mg[key]) == float(ms[i]), key
            for p, q in zip(eager.params, graph.params):
                assert torch.equal(p, q)
    finally:
        torch.use_deterministic_algorithms(False)
    assert graph.step == eager.step == 6


@pytest.mark.cuda
def test_a_mesh_of_one_in_a_world_one_nccl_group_equals_no_group(
        cuda, tmp_path, monkeypatch):
    """Mesh (1, 1, 1) in a world-1 NCCL group: the ctx and model axes of
    size 1 make no call, so a replayed train dispatch of two steps
    (deterministic algorithms, dropout 0.1, bf16) and a replayed serve
    dispatch give the bits of the same trainer and runner without a group,
    with the group's collectives (the cls counts and the gradient sum)
    captured in the replay."""
    import socket

    from tvqaplus_tpu_torch.config import Config
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.parallel import mesh as dp
    from tvqaplus_tpu_torch.train.loop import Trainer
    n, frames = 2, 12
    cfg = Config(synthetic_data=True, add_local=True, use_sup_att=True,
                 bsz=n, test_bsz=n, seed=3, results_dir=str(tmp_path)
                 ).finalize(cuda)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dp.init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        mesh = dp.make_mesh((1, 1, 1))
        assert mesh.ctx_group is None and mesh.model_group is None
        assert mesh.data_group is mesh.grad_group is mesh.group
        grouped, alone = Trainer(cfg, cuda, mesh=mesh), Trainer(cfg, cuda)
        tb = step_batch(cfg, n, frames, True, cuda)
        stack = {k: torch.stack([v, v.flip(0)]) for k, v in tb.items()}
        for _ in range(3):                  # warm-up and capture, replays
            mg = grouped.dispatch_train(stack)
            ma = alone.dispatch_train(stack)
            for key in mg:
                assert float(mg[key]) == float(ma[key]), key
            for p, q in zip(grouped.params, alone.params):
                assert torch.equal(p, q)
        assert len(grouped.graphs.graphs) == 1
        vb = step_batch(cfg, n, frames, False, cuda)
        runners = [InferenceRunner(cfg, t.model, cuda, m) for t, m in
                   ((grouped, mesh), (alone, None))]
        for _ in range(3):
            a, b = (r.dispatch_infer(vb, True, frames) for r in runners)
            for k in a:
                assert torch.equal(a[k], b[k]), k
    finally:
        torch.use_deterministic_algorithms(False)
        dp.close()


# ------------------------------------- noun masks, void vectors, dedup
def with_noun_masks(batch):
    """``batch`` with noun masks: every third word off, one answer's row
    all zero."""
    masks = batch["qas_mask"].clone()
    masks[..., ::3] = 0.0
    masks[0, 2] = 0.0
    return dict(batch, qa_noun_masks=masks)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["noun_masks", "void"])
def test_unfused_attention_train_step_replays_give_eager_bits(
        cuda, tmp_path, case, monkeypatch):
    """A bf16 train step (2 examples, 12 frames, dropout 0.1) whose
    attention sites run unfused (noun masks: both; two void vectors: vid):
    a replayed dispatch gives the eager step's loss, grad_norm and
    parameters bit for bit (deterministic algorithms), the fused attention
    kernel launches at the other sites only, and the void vectors get a
    gradient."""
    from tvqaplus_tpu_torch.config import Config
    from tvqaplus_tpu_torch.train.loop import Trainer
    n, frames = 2, 12
    void = dict(non_visual=2, add_non_visual=True) if case == "void" else {}
    cfg = Config(synthetic_data=True, add_local=True, use_sup_att=True,
                 bsz=n, test_bsz=n, seed=3, results_dir=str(tmp_path),
                 **void).finalize(cuda)
    tb = step_batch(cfg, n, frames, True, cuda)
    if case == "noun_masks":
        tb = with_noun_masks(tb)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        eager, graph = Trainer(cfg, cuda), Trainer(cfg, cuda)
        fused = [s for s in ("sub", "vid")
                 if graph.model.fused_attention(s, tb)]
        assert fused == ([] if case == "noun_masks" else ["sub"])
        for _ in range(3):
            qa_ctx_attention.KERNEL.launches = 0
            ms = eager._packed("train", [eager.train_step(tb)])
            assert qa_ctx_attention.KERNEL.launches == len(fused)
            mg = graph.dispatch_train(tb)
            for i, key in enumerate(graph._names["train"]):
                assert float(mg[key]) == float(ms[i]), key
            for p, q in zip(eager.params, graph.params):
                assert torch.equal(p, q)
            assert torch.isfinite(ms[graph._names["train"].index("loss")])
        if case == "void":
            g = eager.model.non_visual_vectors.grad
            assert g is not None and float(g.abs().max()) > 0
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_dedup_serve_dispatch_equals_the_plain_one(cuda):
    """The serving pipeline on the card with ``video_dedup`` and St buckets
    (bf16 host cast on): each replayed serve dispatch (the int32 ``ex_vid``
    gather inside the graph) gives the bits of the dispatch of the same
    batch without dedup."""
    from tvqaplus_tpu_torch.config import Config
    from tvqaplus_tpu_torch.data.pipeline import DataPipeline
    from tvqaplus_tpu_torch.data.synthetic import (
        CachedDataset,
        SharedVideoDataset,
        SyntheticTVQADataset,
    )
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    n, frames = 8, 12
    cfg = Config(synthetic_data=True, add_local=True, bsz=n, test_bsz=n,
                 seed=3, max_num_img=frames, img_buckets=[frames],
                 sub_token_buckets=[64, 96], video_buckets=[2, 4]
                 ).finalize(cuda)
    assert cfg.compute_dtype == "bfloat16"
    ds = CachedDataset(SharedVideoDataset(
        SyntheticTVQADataset(cfg, 3 * n, mode="valid"), 3))
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(3))
    runner = InferenceRunner(cfg, model, cuda)
    batches = {dedup: [b for b, _, _ in DataPipeline(
        ds, cfg, cuda, batch_size=n, video_dedup=dedup)]
        for dedup in (False, True)}
    assert all("ex_vid" in b and b["vid_u"].dtype == torch.bfloat16
               for b in batches[True])
    for _ in range(2):                    # warm-up and capture, replays
        for plain, dedup in zip(batches[False], batches[True]):
            want = {k: v.clone() for k, v in runner.dispatch_infer(
                plain, True, frames).items()}
            got = runner.dispatch_infer(dedup, True, frames)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert len(runner.graphs.graphs) >= 2


# ------------------------------------------- JAX checkpoints and heads
def small_train_config(cuda, results_dir, **kw):
    from tvqaplus_tpu_torch.config import Config
    return Config(synthetic_data=True, add_local=True, use_sup_att=True,
                  bsz=2, test_bsz=2, seed=3, results_dir=str(results_dir),
                  **kw).finalize(cuda)


def launch_counts():
    return {"qa_ctx_attention": qa_ctx_attention.KERNEL.launches,
            "qa_ctx_attention_bwd": qa_ctx_attention.BWD_KERNEL.launches,
            "tri_bridge": tri_bridge.KERNEL.launches,
            "tri_bridge_bwd": tri_bridge.BWD_KERNEL.launches,
            "encoder": encoder.KERNEL.launches,
            "encoder_bwd": encoder.BWD_KERNEL.launches,
            "encoder_block": encoder.BLOCK_KERNEL.launches}


@pytest.mark.cuda
def test_a_jax_format_checkpoint_serves_and_resumes_as_the_torch_one(
        cuda, tmp_path, monkeypatch):
    """A trainer's state after a step (bf16, dropout 0.1), written in the
    JAX trainer's flax layout: its weights serve the eval step's bits of
    the torch weights, and two steps resumed from it give the losses and
    parameters of two steps resumed from the torch checkpoint of the same
    state (deterministic algorithms on)."""
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.inference import load_weights
    from tvqaplus_tpu_torch.interop import flax_msgpack
    from tvqaplus_tpu_torch.interop.weights import flax_checkpoint_tree
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.train.loop import Trainer
    cfg = small_train_config(cuda, tmp_path)
    trainer = Trainer(cfg, cuda)
    batch = step_batch(cfg, 2, 12, True, cuda)
    trainer.train_step(batch)
    extra = {"best_acc": 0.0, "epoch": 0, "lr": trainer.scheduler.lr}
    flax_path, torch_path = str(tmp_path / "last.ckpt"), \
        str(tmp_path / "torch.ckpt")
    with open(flax_path, "wb") as f:
        f.write(flax_msgpack.dumps(flax_checkpoint_tree(
            trainer.model, trainer.optimizer, trainer.step, extra, cfg)))
    trainer.save(torch_path)
    assert flax_msgpack.sniff(flax_path) == "flax"
    eval_batch = step_batch(cfg, 2, 12, False, cuda)
    outs = []
    for sd in (load_weights(flax_path, cfg), trainer.model.state_dict()):
        model = STAGE(ModelConfig.from_config(cfg))
        model.load_state_dict(sd)
        outs.append(InferenceRunner(cfg, model.to(cuda), cuda).step(
            eval_batch, True, 12))
    for k in outs[1]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for path in (flax_path, torch_path):
            resumed = Trainer(dataclasses.replace(cfg, resume=path), cuda)
            losses = [float(resumed.train_step(batch)["loss"])
                      for _ in range(2)]
            runs.append((losses, [p.detach() for p in resumed.params],
                         resumed.step))
    finally:
        torch.use_deterministic_algorithms(False)
    (la, pa, sa), (lb, pb, sb) = runs
    assert la == lb and sa == sb == 3
    assert all(torch.equal(p, q) for p, q in zip(pa, pb))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [0, 8])
def test_encoders_with_heads_bypass_the_encoder_kernels(cuda, tmp_path,
                                                        heads):
    """JAX's predicate on the card: with attention heads in both encoders
    the serve and the train step launch no encoder kernel (plain chain),
    the attention and tri-bridge kernels still launch; without heads the
    cls encoder's kernel does."""
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.train.loop import Trainer
    cfg = small_train_config(cuda, tmp_path, cls_encoder_n_heads=heads,
                             input_encoder_n_heads=heads)
    trainer = Trainer(cfg, cuda)
    before = launch_counts()
    InferenceRunner(cfg, trainer.model, cuda).step(
        step_batch(cfg, 2, 12, False, cuda), True, 12)
    loss = float(trainer.train_step(step_batch(cfg, 2, 12, True, cuda))[
        "loss"])
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    assert loss == loss
    assert ran["qa_ctx_attention"] == 4 and ran["tri_bridge"] == 2
    assert ran["qa_ctx_attention_bwd"] == 2 and ran["tri_bridge_bwd"] == 1
    cls = 0 if heads else 1          # the cls encoder's reduce kernel
    assert (ran["encoder"], ran["encoder_bwd"]) == (2 * cls, cls)
    assert ran["encoder_block"] == 0


# ------------------------------- the bf16 backwards at D = 256, redesigned
# The encoder's rows (B, G, L, k): a persistent block over several tiles
# (200 sequences of 40, more than the SMs), the merged input encoder's 50
# and the kernel's 56 (21 sequences, and 7: ENC256_FEW), and short L where
# tiles hold several sequences and N is not a multiple of them (7
# sequences, 2 or 12 a tile), k 1 to 9.
ENC256_FEW = (1, 7, 56, 9)
ENC256_ROWS = [(2, 100, 40, 5), (1, 21, 50, 7), (1, 21, 56, 9), ENC256_FEW,
               (1, 7, 25, 3), (1, 7, 5, 1)]
# ENC256_FEW's bar.  There layer 1's vector gradients sum only 392 rows,
# and a ReLU input that rounds to the other side of 0 in the kernel than
# in the plain version moves them: at dropout 0.1 in the full-output modes
# ln1_s, ln1_b and dwb1 read 8.4e-3 to 1.0007e-2 against the plain version
# (ln1_s 1.0007e-2 in the design before this one too), every gradient of
# the other rows at most 3.4e-3; a kernel that loses one row's gradient
# reads 3.2e-2 or more in every gradient of this row
# (scripts/encoder256_readings.py; PERF.md).
ENC256_FEW_TOL = 2e-2


def enc256_call(cuda, rows, mode, dropout, gen):
    """Inputs, cotangent, kernel and plain version of the encoder backward
    at D = 256 in bf16: ``mode`` "reduce", "zero mask" or "no mask"."""
    b, g, l, k = rows
    x, pe, p, mask = encoder_args(cuda, torch.bfloat16, gen, b=b, g=g, l=l,
                                  k=k, d=256)
    if mode == "reduce":
        cot = encoder_cotangent(x, pe, p, k, mask, torch.bfloat16, gen,
                                dropout)
        fn_k, fn_p, m = encoder.encoder_reduce, encoder.encoder_reduce_plain, \
            mask
        counter = encoder.BWD_BY_WIDTH[256]
    else:
        m = stream_mask(g, l).to(cuda) if mode == "zero mask" else None
        valid = torch.ones(x.shape[:3], device=cuda) if m is None \
            else m.expand(x.shape[:3])
        cot = randn(gen, *x.shape).to(cuda) * valid[..., None]
        fn_k, fn_p = encoder.encoder_block, encoder.encoder_block_plain
        counter = encoder.BLOCK_BWD_BY_WIDTH[256]
    keys = encoder.PARAM_KEYS

    def run(fn, c=cot, dtype=torch.bfloat16):
        """The gradients of x and the parameters under cotangent ``c``,
        with x in ``dtype``."""
        xs = x.detach().to(dtype).requires_grad_(True)
        ps = {key: t.detach().clone().requires_grad_(True)
              for key, t in p.items()}
        out = fn(xs, pe, ps, k, m, dropout, SEED)
        return torch.autograd.grad(out, [xs] + [ps[key] for key in keys],
                                   c.to(out.dtype))
    run.cot = cot
    return run, fn_k, fn_p, counter


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("mode", ["reduce", "zero mask", "no mask"])
@pytest.mark.parametrize("rows", ENC256_ROWS)
def test_encoder_backward_at_256_matches_plain(cuda, rows, mode, dropout):
    """The bf16 encoder backward at D = 256 (pw through the ring, every
    per-tile state on the SM) against autograd through the plain version at
    ``encoder.GRAD_TOL`` (``ENC256_FEW`` at ``ENC256_FEW_TOL``), in both
    modes, and twice for the same bits."""
    gen = torch.Generator().manual_seed(21)
    run, fn_k, fn_p, counter = enc256_call(cuda, rows, mode, dropout, gen)
    tol = ENC256_FEW_TOL if rows == ENC256_FEW \
        else encoder.GRAD_TOL[torch.bfloat16]
    n0 = counter.launches
    g_k, g_again, g_p = run(fn_k), run(fn_k), run(fn_p)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    for name, gk, ga, gp in zip(("x",) + encoder.PARAM_KEYS, g_k, g_again,
                                g_p):
        assert torch.equal(gk, ga), f"{name} differs between two runs"
        checks.hold_grad(f"{mode} {rows} {name}", gk, gp, tol)


# (A, Lqa): M = 200 (three tiles and 8 rows), 64 (one), 65 (one and a
# row), 1
ATT256_ROWS = [(5, 40), (2, 32), (5, 13), (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("raw_mode", ["none", "target"])
@pytest.mark.parametrize("lr", [25, 50, 64])
@pytest.mark.parametrize("a,lqa", ATT256_ROWS)
def test_attention_backward_at_256_matches_plain(cuda, a, lqa, lr, raw_mode,
                                                 dropout):
    """The bf16 attention backward at D = 256 (g_yd once a tile, W through
    the ring) against autograd through the plain version at
    ``qa_ctx_attention.GRAD_TOL``, and twice for the same bits."""
    dt, d, li = torch.bfloat16, 256, 3
    gen = torch.Generator().manual_seed(22)
    args = attn_args(cuda, dt, a=a, li=li, lqa=lqa, lr=lr, d=d)
    targets = torch.tensor([min(2, a - 1), 0], device=cuda)
    kw = dict(raw_mode=raw_mode, targets=targets, dropout_rate=dropout,
              seed=SEED)
    flip = checks.attention_flip_elements(*args, dropout_rate=dropout,
                                          seed=SEED)
    cot = [randn(gen, 2, a, li, lqa, d).to(cuda) * ~flip]
    if raw_mode == "target":
        c_t = args[4][torch.arange(2, device=cuda), targets]
        cot.append(randn(gen, 2, li, lqa, lr).to(cuda)
                   * c_t[:, None, :, None] * args[5][:, :, None, :])

    def run(fn):
        ins = leaves(args)
        ins[4].requires_grad_(False)
        ins[5].requires_grad_(False)
        return grads_of(lambda *a_: fn(*a_, **kw), ins, cot)[1]
    counter = qa_ctx_attention.BWD_BY_WIDTH[256]
    n0 = counter.launches
    g_k = run(qa_ctx_attention.qa_ctx_attention)
    g_again = run(qa_ctx_attention.qa_ctx_attention)
    g_p = run(qa_ctx_attention.qa_ctx_attention_plain)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    for i, gk, ga, gp in zip(ATT_GRAD_INPUTS, g_k, g_again, g_p):
        assert torch.equal(gk, ga), f"grad {i} differs between two runs"
        checks.grad_close(f"grad {i}", gk, gp,
                          qa_ctx_attention.GRAD_TOL[dt])


def replayed(fn):
    """fn() eagerly and as a CUDA-graph replay (captured after a warm-up
    on a side stream): both results, copied."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    eager = [t.clone() for t in fn()]
    graph = torch.cuda.CUDAGraph()
    # thread-local capture, as dispatch.py's StepGraphs captures a step
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, [t.clone() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["encoder reduce", "encoder block",
                                    "attention"])
def test_backwards_at_256_replay_as_eager(cuda, family):
    """Each redesigned backward, with its forward, captured in a CUDA
    graph replays to the eager call's bits (dropout 0.1: the seed a device
    tensor, made before the capture)."""
    gen = torch.Generator().manual_seed(23)
    seed = torch.tensor(SEED, dtype=torch.int64, device=cuda)
    if family == "attention":
        args = attn_args(cuda, torch.bfloat16, a=5, li=3, lqa=40, lr=50,
                         d=256)
        ins = leaves(args)
        ins[4].requires_grad_(False)
        ins[5].requires_grad_(False)
        targets = torch.tensor([2, 0], device=cuda)
        cots = [torch.ones(2, 5, 3, 40, 256, device=cuda,
                           dtype=torch.bfloat16),
                torch.ones(2, 3, 40, 50, device=cuda)]

        def forward():
            return qa_ctx_attention.qa_ctx_attention(
                *ins, raw_mode="target", targets=targets,
                dropout_rate=P_DROP, seed=seed)
        wrt = [t for t in ins if t.requires_grad]
    else:
        reduce = "reduce" in family
        x, pe, p, mask = encoder_args(cuda, torch.bfloat16, gen, b=2, g=70,
                                      l=40 if reduce else 50, k=5, d=256)
        xs = x.detach().clone().requires_grad_(True)
        ps = {key: t.detach().clone().requires_grad_(True)
              for key, t in p.items()}
        cots = [randn(gen, *((2, 70, 256) if reduce else x.shape)).to(
            cuda, torch.bfloat16)]

        def forward():
            if reduce:
                return encoder.encoder_reduce(xs, pe, ps, 5, mask, P_DROP,
                                              seed)
            return encoder.encoder_block(xs, pe, ps, 5, None, P_DROP, seed)
        wrt = [xs] + list(ps.values())

    def backward():
        out = forward()
        return torch.autograd.grad(
            list(out) if isinstance(out, tuple) else [out], wrt, cots)
    eager, replay = replayed(backward)
    for i, (e, r) in enumerate(zip(eager, replay)):
        assert torch.equal(e, r), f"{family} grad {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("l,k", [(50, 7), (9, 3)])
def test_encoder_backward_at_256_keys_a_rank_s_rows_as_the_whole(cuda, l, k):
    """Under a ctx-style group map (the QA groups, then one rank's frames
    of two streams), the bf16 full-output backward at D = 256 gives each
    of the rank's rows the gx the whole call gives the row at its global
    group, bit for bit: a row's gx depends only on its sequence (the
    products are row by row, the row sums in one order for every row, the
    depthwise passes within the sequence), not on the tile or the tile row
    it lands in (at L = 9 seven sequences share a tile, in other company
    on the rank than in the whole call)."""
    gen = torch.Generator().manual_seed(24)
    num_a, whole, ctx = 3, 8, 2
    g = num_a + 2 * whole
    x, pe, p, _ = encoder_args(cuda, torch.bfloat16, gen, g=g, l=l, k=k,
                               d=256)
    zm = stream_mask(g, l).to(cuda)
    cot = randn(gen, *x.shape).to(cuda, torch.bfloat16)
    kw = dict(dropout_rate=P_DROP, seed=SEED)
    xw = x.detach().clone().requires_grad_(True)
    ref, = torch.autograd.grad(
        encoder.encoder_block(xw, pe, p, k, zm, **kw), xw, cot)
    li = whole // ctx
    for c in range(ctx):
        rows = torch.cat([torch.arange(num_a),
                          num_a + c * li + torch.arange(li),
                          num_a + whole + c * li + torch.arange(li)]).to(cuda)
        xr = x[:, rows].contiguous().requires_grad_(True)
        got, = torch.autograd.grad(
            encoder.encoder_block(xr, pe, p, k, zm[rows], groups=(
                rows.to(torch.int32), g), **kw), xr, cot[:, rows].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(got, ref[:, rows]), c


# rows of the tri bridge's backward at D = 256 / 200: 100, 43 x 3 = 129 and
# 1 (neither 64 nor 128 divides them), 20,655 (324 tiles: blocks walk two
# or three, so the ring runs across tiles) and the headline 160,000
TRI256_ROWS = [(1, 1, 1, 100), (1, 1, 3, 43), (1, 1, 1, 1), (3, 5, 17, 81),
               (16, 5, 50, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("rows", TRI256_ROWS)
def test_tri_bridge_backward_at_256_matches_plain(cuda, rows, d, dropout):
    """The bf16 tri bridge backward at D = 256 (g_yd once a tile, W in
    bf16 slabs through the copy engine's ring) and at 200 (padded into it)
    against autograd through the plain version at ``GRAD_TOL``, twice for
    the same bits, each launch on its true width's counter."""
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(25)
    params = [1 + randn(gen, 3 * d, scale=0.1), randn(gen, 3 * d, scale=0.1),
              randn(gen, 3 * d, d, scale=(3 * d) ** -0.5),
              randn(gen, d, scale=0.1), 1 + randn(gen, d, scale=0.1),
              randn(gen, d, scale=0.1)]
    args = [randn(gen, *rows, d).to(cuda, dt),
            randn(gen, *rows, d).to(cuda, dt)] + [t.to(cuda) for t in params]
    flip = checks.tri_bridge_flip_rows(*args[:6], dropout, SEED)
    cot = [randn(gen, *rows, d).to(cuda) * (~flip)[..., None]]
    counter = width_counter(tri_bridge.BWD_BY_WIDTH, d)

    def run(fn):
        return grads_of(lambda *a: fn(*a, dropout, SEED), leaves(args),
                        cot)[1]
    n0 = counter.launches
    g_k = run(tri_bridge.tri_bridge)
    g_again = run(tri_bridge.tri_bridge)
    g_p = run(tri_bridge.tri_bridge_plain)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert g_k[0].dtype == g_k[1].dtype == dt
    for i, (gk, ga, gp) in enumerate(zip(g_k, g_again, g_p)):
        assert torch.equal(gk, ga), f"grad {i} differs between two runs"
        checks.hold_grad(f"D {d} grad {i}", gk, gp, tri_bridge.GRAD_TOL[dt])


# (A, Lqa, Li, Lr, raw mode): M = 200 (three 64-row tiles and 8 rows) and
# 39 on 3 frames at every Lr and mode; M = 200 on 40 frames (320 tiles:
# blocks of two warpgroups walk more than one each) at the vid site's
ATT64_CASES = [(a, lqa, 3, lr, mode) for a, lqa in ((5, 40), (3, 13))
               for lr in (1, 25, 50, 64) for mode in ("none", "full",
                                                     "target")] + [
    (5, 40, 40, 25, "target")]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("a,lqa,li,lr,raw_mode", ATT64_CASES)
def test_attention_backward_at_64_matches_plain(cuda, a, lqa, li, lr,
                                                raw_mode, dropout):
    """The bf16 attention backward at D = 64 on the tensor cores (the
    warpgroups on rows of their own, the gq kernel too) against autograd
    through the plain version at ``qa_ctx_attention.GRAD_TOL``, and twice
    for the same bits."""
    dt, d = torch.bfloat16, 64
    gen = torch.Generator().manual_seed(26)
    args = attn_args(cuda, dt, a=a, li=li, lqa=lqa, lr=lr, d=d)
    targets = torch.tensor([min(2, a - 1), 0], device=cuda)
    kw = dict(raw_mode=raw_mode, targets=targets, dropout_rate=dropout,
              seed=SEED)
    flip = checks.attention_flip_elements(*args, dropout_rate=dropout,
                                          seed=SEED)
    cot = [randn(gen, 2, a, li, lqa, d).to(cuda) * ~flip]
    if raw_mode == "target":
        c_t = args[4][torch.arange(2, device=cuda), targets]
        cot.append(randn(gen, 2, li, lqa, lr).to(cuda)
                   * c_t[:, None, :, None] * args[5][:, :, None, :])
    elif raw_mode == "full":
        cot.append(randn(gen, 2, a, li, lqa, lr).to(cuda)
                   * args[4][:, :, None, :, None]
                   * args[5][:, None, :, None, :])

    def run(fn):
        ins = leaves(args)
        ins[4].requires_grad_(False)
        ins[5].requires_grad_(False)
        return grads_of(lambda *a_: fn(*a_, **kw), ins, cot)[1]
    counter = qa_ctx_attention.BWD_BY_WIDTH[64]
    n0 = counter.launches
    g_k = run(qa_ctx_attention.qa_ctx_attention)
    g_again = run(qa_ctx_attention.qa_ctx_attention)
    g_p = run(qa_ctx_attention.qa_ctx_attention_plain)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    for i, gk, ga, gp in zip(ATT_GRAD_INPUTS, g_k, g_again, g_p):
        assert torch.equal(gk, ga), f"grad {i} differs between two runs"
        checks.grad_close(f"grad {i}", gk, gp,
                          qa_ctx_attention.GRAD_TOL[dt])


# ----------------- the bf16 forwards at D = 256: W through a copy-engine ring
# csrc/encoder_fwd.cu encoder_fwd_tc_wide_kernel and
# csrc/qa_ctx_attention_fwd.cu qa_ctx_fwd_tc_wide_kernel: W rounded into
# bf16 slabs once a call and brought by the copy engine through a ring
# that a pair of CTAs shares (csrc/wgmma.cuh SlabRing).  Every length and
# tap count in both modes, and every score width and raw mode; the counts
# of sequences (69) and frames (9) are odd, so the last pair of tiles runs
# one empty tile, and L = 1 leaves a 64-row tile partly filled.  Each call
# twice: the same bits.  At the rows' existing bars.
def twice(run):
    got, again = run(), run()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    for u, v in zip(got, again):
        assert torch.equal(u, v), "two calls gave different bits"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("d", (256, 200))
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("mode", ["reduce", "zero_mask", "none"])
@pytest.mark.parametrize("l", [1, 40, 50, 56])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
def test_encoder_forward_at_256_matches_plain_twice(cuda, d, dropout, mode, l,
                                                    k):
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(10 * l + k)
    x, pe, p, mask = encoder_args(cuda, dt, gen, b=3, g=23, l=l, k=k, d=d)
    kw = dict(dropout_rate=dropout, seed=SEED)
    if mode == "reduce":
        table, valid = encoder.FWD_BY_WIDTH, 1.0
        want = encoder.encoder_reduce_plain(x, pe, p, k, mask, **kw)
        def run():
            return encoder.encoder_reduce(x, pe, p, k, mask, **kw)
    else:
        zm = stream_mask(x.shape[1], l).to(cuda) if mode == "zero_mask" \
            else None
        table, valid = encoder.BLOCK_BY_WIDTH, 1.0 if zm is None \
            else zm[..., None]
        want = encoder.encoder_block_plain(x, pe, p, k, zm, **kw)
        def run():
            return encoder.encoder_block(x, pe, p, k, zm, **kw)
    counter = width_counter(table, d)
    n0 = counter.launches
    (got,) = twice(run)
    assert counter.launches == n0 + 2
    assert got.dtype == dt and torch.isfinite(got.float()).all()
    close(got.float() * valid, want.float() * valid, encoder.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("d", (256, 200))
@pytest.mark.parametrize("mode", ["reduce", "zero_mask"])
def test_encoder_forward_at_256_walks_more_pairs_than_clusters(cuda, d,
                                                               mode):
    """4,000 sequences of 40 (the headline cls_encoder) or 1,680 of 50: a
    cluster walks many pairs of tiles, its ring running on from tile to
    tile."""
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(40)
    b, g, l, k = (100, 40, 40, 5) if mode == "reduce" else (16, 105, 50, 7)
    x, pe, p, mask = encoder_args(cuda, dt, gen, b=b, g=g, l=l, k=k, d=d)
    kw = dict(dropout_rate=P_DROP, seed=SEED)
    if mode == "reduce":
        (got,) = twice(lambda: encoder.encoder_reduce(x, pe, p, k, mask,
                                                      **kw))
        want = encoder.encoder_reduce_plain(x, pe, p, k, mask, **kw)
        close(got, want, encoder.TOL[dt])
    else:
        zm = stream_mask(g, l).to(cuda)
        (got,) = twice(lambda: encoder.encoder_block(x, pe, p, k, zm, **kw))
        want = encoder.encoder_block_plain(x, pe, p, k, zm, **kw)
        close(got.float() * zm[..., None], want.float() * zm[..., None],
              encoder.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("d", (256, 200))
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("raw_mode", ["none", "full", "target"])
@pytest.mark.parametrize("lr", [1, 25, 50, 64])
@pytest.mark.parametrize("a,lqa", [(5, 40), (3, 13)])
def test_attention_forward_at_256_matches_plain_twice(cuda, d, dropout,
                                                      raw_mode, lr, a, lqa):
    dt = torch.bfloat16
    args = attn_args(cuda, dt, b=3, a=a, li=3, lqa=lqa, lr=lr, d=d)
    kw = dict(raw_mode=raw_mode, dropout_rate=dropout, seed=SEED,
              targets=torch.tensor([2, 0, 1], device=cuda))
    counter = width_counter(qa_ctx_attention.FWD_BY_WIDTH, d)
    n0 = counter.launches
    got = twice(lambda: qa_ctx_attention.qa_ctx_attention(*args, **kw))
    want = qa_ctx_attention.qa_ctx_attention_plain(*args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    assert counter.launches == n0 + 2
    tol = qa_ctx_attention.TOL[dt]
    assert got[0].dtype == dt and torch.isfinite(got[0].float()).all()
    close(got[0], want[0], tol["mixed"])
    if raw_mode != "none":
        close(got[1], want[1], tol["raw"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", (256, 200))
def test_attention_forward_at_256_walks_more_units_than_clusters(cuda, d):
    """The headline's 16 x 50 frames of 200 rows: each cluster takes many
    (frame pair, tile) units, the frames' qn / qe loaded once each."""
    dt = torch.bfloat16
    args = attn_args(cuda, dt, b=16, a=5, li=50, lqa=40, lr=25, d=d)
    kw = dict(raw_mode="full", dropout_rate=P_DROP, seed=SEED)
    got = twice(lambda: qa_ctx_attention.qa_ctx_attention(*args, **kw))
    want = qa_ctx_attention.qa_ctx_attention_plain(*args, **kw)
    tol = qa_ctx_attention.TOL[dt]
    close(got[0], want[0], tol["mixed"])
    close(got[1], want[1], tol["raw"])


@pytest.mark.cuda
def test_forwards_at_256_replay_in_a_cuda_graph(cuda):
    """A CUDA graph captures the forwards at 256 (W's packing and the
    cluster launches among its nodes, no copy from the host) and its
    replay gives the eager bits."""
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(41)
    x, pe, p, mask = encoder_args(cuda, dt, gen, b=3, g=23, l=40, k=5,
                                  d=256)
    args = attn_args(cuda, dt, b=3, a=5, li=3, lqa=40, lr=25, d=256)

    def step():
        mixed, raw = qa_ctx_attention.qa_ctx_attention(*args,
                                                       raw_mode="full")
        return (encoder.encoder_reduce(x, pe, p, 5, mask),
                encoder.encoder_block(x, pe, p, 5, None), mixed, raw)
    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    graph.replay()
    torch.cuda.synchronize()
    for u, v in zip(out, eager):
        assert torch.equal(u, v)


# ------------- the D = 64 encoder backward and the D = 256 tri bridge
# forward, redesigned: every k, L from 5 to 56 (12 sequences to 1 a tile),
# the true widths and one padded into each
ENC64_LENGTHS = (5, 40, 50, 56)
ENC64_KS = (1, 3, 5, 7, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("dv", (64, 60))
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("k", ENC64_KS)
@pytest.mark.parametrize("length", ENC64_LENGTHS)
@pytest.mark.parametrize("full", [False, True])
def test_encoder_backward_at_64_matches_plain(cuda, full, length, k, dropout,
                                              dv):
    """The bf16 backward at D = 64 (csrc/encoder_bwd_tc_wide.cu ``Enc64``:
    the warpgroups on tiles of their own), reduce mode and full output
    with a zero mask: gradients against autograd through the plain version
    (the same Philox mask) by relative L2, twice for the same bits, one
    launch a call on the true width's counter.  80 sequences (4 to 80
    tiles: each warpgroup takes one or more): the bar is a relative L2 over
    the call, which a ReLU sign that the two sides' roundings set apart
    moves by its whole sequence; at 12 sequences one such sequence (L 56,
    k 9, no dropout) reads 0.0295, the plain version's own error against
    float32 there 0.014."""
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(20 + length + k)
    x, pe, p, mask = encoder_args(cuda, dt, gen, g=40, l=length, k=k, d=dv)
    keys = encoder.PARAM_KEYS
    if full:
        zm = stream_mask(x.shape[1], length).to(cuda)
        cot = [randn(gen, *x.shape).to(cuda)
               * zm.expand(x.shape[:3])[..., None]]
        fn_k, fn_p, m = encoder.encoder_block, encoder.encoder_block_plain, zm
        counter = width_counter(encoder.BLOCK_BWD_BY_WIDTH, dv)
    else:
        cot = [encoder_cotangent(x, pe, p, k, mask, dt, gen, dropout)]
        fn_k, fn_p, m = (encoder.encoder_reduce, encoder.encoder_reduce_plain,
                         mask)
        counter = width_counter(encoder.BWD_BY_WIDTH, dv)
    args = [x] + [p[key] for key in keys]

    def kernel(xa, *ps):
        return fn_k(xa, pe, dict(zip(keys, ps)), k, m, dropout, SEED)

    def plain(xa, *ps):
        return fn_p(xa, pe, dict(zip(keys, ps)), k, m, dropout, SEED)

    def run(fn):
        return grads_of(fn, leaves(args), cot)[1]
    n0 = counter.launches
    g_k, g_again, g_p = run(kernel), run(kernel), run(plain)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert g_k[0].dtype == dt
    for name, gk, ga, gp in zip(("x",) + keys, g_k, g_again, g_p):
        assert torch.equal(gk, ga), f"{name} differs between two runs"
        checks.hold_grad(f"D 64 (dv {dv}) {name}", gk, gp,
                         encoder.GRAD_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("d", (256, 200))
@pytest.mark.parametrize("rows", (1, 65, 129, 20655, 160000))
def test_tri_bridge_forward_at_256_matches_plain(cuda, rows, d, dropout):
    """The bf16 forward at D = 256 (csrc/tri_bridge_fwd.cu ``TriFwd256``:
    W in bf16 slabs through a ring, 128 rows a pass), a ragged last pair
    of tiles (1, 65, 129 rows), the replayed headline's 20,655 and the
    headline's 160,000, at the true width and padded from 200: against the
    plain version, twice for the same bits, one launch a call."""
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(rows % 977 + d)
    s = randn(gen, rows, d).to(cuda, dt)
    v = randn(gen, rows, d).to(cuda, dt)
    params = [1 + randn(gen, 3 * d, scale=0.1), randn(gen, 3 * d, scale=0.1),
              randn(gen, 3 * d, d, scale=(3 * d) ** -0.5),
              randn(gen, d, scale=0.1), 1 + randn(gen, d, scale=0.1),
              randn(gen, d, scale=0.1)]
    params = [t.to(cuda) for t in params]
    kw = dict(dropout_rate=dropout, seed=SEED)
    counter = width_counter(tri_bridge.FWD_BY_WIDTH, d)
    n0 = counter.launches
    got = tri_bridge.tri_bridge(s, v, *params, **kw)
    again = tri_bridge.tri_bridge(s, v, *params, **kw)
    want = tri_bridge.tri_bridge_plain(s, v, *params, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert got.shape == s.shape and got.dtype == dt
    assert torch.equal(got, again)
    close(got, want, tri_bridge.TOL[dt])


# ------------- the D = 64 attention forward and tri bridge backward,
# redesigned: the widths padded into 64 (60, 48, 32, 4) beside 64 itself
W64_DVS = (64, 60, 48, 32, 4)
# (Lr, raw mode, A, Lqa, Li): Lr 1 / 25 / 32 / 33 / 64 (both region tiles,
# each side of 32), M = 200 (three tiles and 8 rows) and 7, 1 and 50
# frames (one frame per unit, runs across units and frames)
ATT64_FWD_CASES = [(lr, mode, a, lqa, 50 if lr in (25, 33) else 1)
                   for lr in (1, 25, 32, 33, 64)
                   for mode in ("none", "full", "target")
                   for a, lqa in ((5, 40), (1, 7))]


def att64_run(cuda, args, raw_mode, dropout, a):
    kw = dict(raw_mode=raw_mode, dropout_rate=dropout, seed=SEED,
              targets=torch.tensor([min(2, a - 1), 0], device=cuda))
    got = qa_ctx_attention.qa_ctx_attention(*args, **kw)
    return (got,) if raw_mode == "none" else got, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("lr,raw_mode,a,lqa,li", ATT64_FWD_CASES)
def test_attention_forward_at_64_matches_plain(cuda, lr, raw_mode, a, lqa,
                                               li, dropout):
    """The bf16 forward at D = 64 (csrc/qa_ctx_attention_fwd.cu
    ``AttnTc64``: persistent CTAs of three warpgroups on (b, tile, frame)
    items) against the plain version at ``TOL``, twice for the same bits,
    one launch a call on the width's counter."""
    dt, d = torch.bfloat16, 64
    args = attn_args(cuda, dt, a=a, li=li, lqa=lqa, lr=lr, d=d)
    counter = width_counter(qa_ctx_attention.FWD_BY_WIDTH, d)
    n0 = counter.launches
    got, kw = att64_run(cuda, args, raw_mode, dropout, a)
    again, _ = att64_run(cuda, args, raw_mode, dropout, a)
    want = qa_ctx_attention.qa_ctx_attention_plain(*args, **kw)
    want = (want,) if raw_mode == "none" else want
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert got[0].dtype == dt and torch.isfinite(got[0].float()).all()
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)
    tol = qa_ctx_attention.TOL[dt]
    close(got[0], want[0], tol["mixed"])
    if raw_mode != "none":
        close(got[1], want[1], tol["raw"])


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("dv", W64_DVS[1:])
@pytest.mark.parametrize("lr,raw_mode,a,lqa,li", [(25, "full", 5, 40, 50),
                                                  (64, "target", 1, 7, 1)])
def test_attention_forward_at_64_padded_matches_plain(cuda, lr, raw_mode, a,
                                                      lqa, li, dv, dropout):
    """Widths padded into the D = 64 kernel against the unpadded plain
    version, each launch on its true width's counter."""
    dt = torch.bfloat16
    args = attn_args(cuda, dt, a=a, li=li, lqa=lqa, lr=lr, d=dv)
    counter = width_counter(qa_ctx_attention.FWD_BY_WIDTH, dv)
    n0 = counter.launches
    got, kw = att64_run(cuda, args, raw_mode, dropout, a)
    again, _ = att64_run(cuda, args, raw_mode, dropout, a)
    want = qa_ctx_attention.qa_ctx_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert got[0].shape[-1] == dv
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)
    tol = qa_ctx_attention.TOL[dt]
    close(got[0], want[0], tol["mixed"])
    close(got[1], want[1], tol["raw"])


@pytest.mark.cuda
@pytest.mark.parametrize("dv", W64_DVS)
def test_attention_forward_at_64_drops_philox_s_positions(cuda, dv):
    """The LN output's dropped positions are exactly ``ops/philox.py``'s:
    with W the identity (then its negative) on one LN group and the bias
    zero, ``mixed`` is that group's ReLU (of its negative), so both are 0
    exactly where the kernel dropped the value."""
    from tvqaplus_tpu_torch.ops import philox
    dt, a, lqa, li, lr = torch.bfloat16, 5, 40, 50, 25
    args = attn_args(cuda, dt, a=a, li=li, lqa=lqa, lr=lr, d=dv)
    b = args[0].shape[0]
    keep = philox.width_multiplier((b, a, li, lqa, 3 * dv), SEED, P_DROP, dv,
                                   3, cuda).reshape(b, a, li, lqa, 3, dv)
    for g in range(3):
        eye = torch.zeros(3 * dv, dv, device=cuda)
        eye[g * dv:(g + 1) * dv] = torch.eye(dv, device=cuda)
        zero = []
        for w in (eye, -eye):
            run = args[:8] + [w, torch.zeros(dv, device=cuda)]
            got, _ = att64_run(cuda, run, "none", P_DROP, a)
            zero.append(got[0] == 0)
        torch.cuda.synchronize()
        dropped = zero[0] & zero[1]
        assert torch.equal(dropped, keep[..., g, :] == 0), g
        assert 0.05 < dropped.float().mean() < 0.15


TRI64_ROWS = (1, 39, 65, 160000)


def tri64_case(cuda, rows, dv, seed):
    gen = torch.Generator().manual_seed(seed)
    params = [1 + randn(gen, 3 * dv, scale=0.1), randn(gen, 3 * dv, scale=0.1),
              randn(gen, 3 * dv, dv, scale=(3 * dv) ** -0.5),
              randn(gen, dv, scale=0.1), 1 + randn(gen, dv, scale=0.1),
              randn(gen, dv, scale=0.1)]
    args = [randn(gen, rows, dv).to(cuda, torch.bfloat16),
            randn(gen, rows, dv).to(cuda, torch.bfloat16)] + [
        t.to(cuda) for t in params]
    return args, gen


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("dv,rows", [(d, r) for d in (64, 60)
                                     for r in TRI64_ROWS]
                         + [(d, 65) for d in (48, 32, 4)])
def test_tri_bridge_backward_at_64_matches_plain(cuda, rows, dv, dropout):
    """The bf16 backward at D = 64 (csrc/tri_bridge_bwd_wide.cu ``Tri64``:
    the warpgroups on tiles of their own, g_yd once a tile) and at the
    widths padded into it, against autograd through the plain version at
    ``GRAD_TOL``, twice for the same bits, one launch a call on the true
    width's counter."""
    dt = torch.bfloat16
    args, gen = tri64_case(cuda, rows, dv, 40 + rows % 97 + dv)
    flip = checks.tri_bridge_flip_rows(*args[:6], dropout, SEED)
    cot = [randn(gen, rows, dv).to(cuda) * (~flip)[..., None]]
    counter = width_counter(tri_bridge.BWD_BY_WIDTH, dv)

    def run(fn):
        return grads_of(lambda *a: fn(*a, dropout, SEED), leaves(args),
                        cot)[1]
    n0 = counter.launches
    g_k = run(tri_bridge.tri_bridge)
    g_again = run(tri_bridge.tri_bridge)
    g_p = run(tri_bridge.tri_bridge_plain)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert g_k[0].dtype == g_k[1].dtype == dt
    for i, (gk, ga, gp) in enumerate(zip(g_k, g_again, g_p)):
        assert torch.equal(gk, ga), f"grad {i} differs between two runs"
        checks.hold_grad(f"D 64 (dv {dv}) grad {i}", gk, gp,
                         tri_bridge.GRAD_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dv", W64_DVS)
def test_tri_bridge_backward_at_64_drops_philox_s_positions(cuda, dv,
                                                            monkeypatch):
    """The yd rows the backward writes for the weight gradient are 0
    exactly where ``ops/philox.py`` drops the LN output (the replay of
    the forward's mask), in each group's true columns."""
    from tvqaplus_tpu_torch.ops import philox
    rows = 4097
    args, gen = tri64_case(cuda, rows, dv, 70 + dv)
    made, empty = [], torch.empty

    def recorded(*a, **kw):
        t = empty(*a, **kw)
        made.append(t)
        return t
    s, v, params = tri_bridge.pad_inputs(args[0], args[1], args[2:], 64)
    g = widths.pad_cols(randn(gen, rows, dv).to(cuda, torch.bfloat16), 64)
    monkeypatch.setattr(torch, "empty", recorded)
    tri_bridge.tri_bridge_backward(s, v, *params, g, P_DROP, SEED, dv)
    torch.cuda.synchronize()
    monkeypatch.undo()
    (yd,) = [t for t in made if t.shape == (rows, 3 * 64)
             and t.dtype == torch.bfloat16]
    keep = philox.width_multiplier((rows, 3 * dv), SEED, P_DROP, dv, 3, cuda)
    got = yd.reshape(rows, 3, 64)[..., :dv] == 0
    assert torch.equal(got, keep.reshape(rows, 3, dv) == 0)
    assert 0.05 < got.float().mean() < 0.15


# -------------- the D = 64 encoder and tri bridge forwards, redesigned:
# the widths padded into 64 (60, 32, 4) beside 64 itself
ENC64_FWD_DVS = (64, 60, 32, 4)
# L 1 (64 sequences a 64-row tile), 40 (the cls_encoder's: 1,000 tiles,
# more than the 396 warpgroups), 50 (the merged input's) and 56 (the
# longest the kernels take)
ENC64_FWD_LENGTHS = (1, 40, 50, 56)


def enc64_fwd_case(cuda, mode, k, length, dv, seed):
    """(wrapper, plain version, its launch table, args) of one mode of the
    bf16 encoder forward at width ``dv`` over 1,000 sequences: reduce
    mode's mask holds an all-zero sequence, full mode's zero mask three
    streams and a zero inside one."""
    gen = torch.Generator().manual_seed(seed)
    x, pe, p, mask = encoder_args(cuda, torch.bfloat16, gen, b=1, g=1000,
                                  l=length, k=k, d=dv)
    mask[0, 2, 0] = 1                # L = 1: a live sequence beside it
    if mode == "reduce":
        return (encoder.encoder_reduce, encoder.encoder_reduce_plain,
                encoder.FWD_BY_WIDTH, (x, pe, p, k, mask))
    zm = stream_mask(x.shape[1], length).to(cuda)
    zm[5, length // 2] = 0
    return (encoder.encoder_block, encoder.encoder_block_plain,
            encoder.BLOCK_BY_WIDTH, (x, pe, p, k, zm))


@pytest.mark.cuda
@pytest.mark.parametrize("dv", ENC64_FWD_DVS)
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("length", ENC64_FWD_LENGTHS)
@pytest.mark.parametrize("k", TC_KS)
@pytest.mark.parametrize("mode", ["reduce", "block"])
def test_encoder_forward_at_64_matches_plain(cuda, mode, k, length,
                                             dropout, dv):
    """The bf16 forward at D = 64 (csrc/encoder_fwd.cu ``EncFwd64``: three
    warpgroups a block on 64-row tiles of their own, the masked max from
    registers, full output through shared memory) and at the widths
    padded into it, against the plain version at ``TOL``: an all-masked
    sequence gives -1e10 in every channel, zero-mask rows are finite;
    twice for the same bits, one launch a call on the true width's
    counter."""
    dt = torch.bfloat16
    run, plain, table, args = enc64_fwd_case(cuda, mode, k, length, dv,
                                             60 + k + length + dv)
    kw = dict(dropout_rate=dropout, seed=SEED)
    counter = width_counter(table, dv)
    n0 = counter.launches
    got = run(*args, **kw)
    again = run(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert got.dtype == dt and got.shape == want.shape
    assert got.shape[-1] == dv and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    if mode == "reduce":
        close(got, want, encoder.TOL[dt])
        mask = args[-1]
        assert (got[0, 1] == torch.tensor(-1e10, dtype=dt)).all()
        live = mask.amax(-1) > 0
        assert (got[live].float() > -1e9).all() and live.sum() > 10
    else:
        valid = args[-1][..., None]
        close(got.float() * valid, want.float() * valid, encoder.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dv", ENC64_FWD_DVS)
@pytest.mark.parametrize("length,k", [(40, 5), (50, 7), (1, 1), (56, 9)])
def test_encoder_forward_at_64_drops_philox_s_positions(cuda, length, k, dv):
    """Conv 0's dropped positions are exactly ``ops/philox.py``'s: with
    x + pe = 0, LN_0 giving 1 everywhere, the centre tap and pw0 copying
    the dropped LN output into h, layer 1 adding 0 and the final LN
    centring each row, an output is above 0 exactly where its LN_0 output
    was kept (rows that keep or drop every value centre to 0).  Reduce
    mode with every row live gives the full output's max over the rows."""
    from tvqaplus_tpu_torch.ops import philox
    shape = (2, 60, length, dv)
    x = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    pe = torch.zeros(length, dv, device=cuda)
    p = {}
    for i in (0, 1):
        dw = torch.zeros(k, dv)
        dw[k // 2] = 1.0 - i
        p.update({f"ln{i}_s": torch.zeros(dv),
                  f"ln{i}_b": torch.full((dv,), 1.0 - i), f"dw{i}": dw,
                  f"dwb{i}": torch.zeros(dv), f"pw{i}": torch.eye(dv),
                  f"pwb{i}": torch.zeros(dv)})
    p.update(lnf_s=torch.ones(dv), lnf_b=torch.zeros(dv))
    p = {key: t.to(cuda) for key, t in p.items()}
    got = encoder.encoder_block(x, pe, p, k, None, P_DROP, SEED)
    red = encoder.encoder_reduce(x, pe, p, k, torch.ones(shape[:-1],
                                                         device=cuda),
                                 P_DROP, SEED)
    torch.cuda.synchronize()
    keep = philox.multiplier(shape, SEED, P_DROP, cuda) > 0
    both = keep.any(-1) & ~keep.all(-1)
    assert both.float().mean() > (0.2 if dv == 4 else 0.9)
    assert torch.equal((got > 0)[both], keep[both])
    assert torch.equal(red, got.amax(2))


TRI64_FWD_ROWS = (1, 39, 65, 193, 160000)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, P_DROP])
@pytest.mark.parametrize("dv", (64, 60, 4))
@pytest.mark.parametrize("rows", TRI64_FWD_ROWS)
def test_tri_bridge_forward_at_64_matches_plain(cuda, rows, dv, dropout):
    """The bf16 forward at D = 64 (csrc/tri_bridge_fwd.cu ``TriFwd64``:
    three warpgroups a block on 64-row tiles of their own at all 64
    columns, yd from registers) and at the widths padded into it, against
    the plain version at ``TOL``, twice for the same bits, one launch a
    call on the true width's counter."""
    dt = torch.bfloat16
    args, _ = tri64_case(cuda, rows, dv, 80 + rows % 97 + dv)
    counter = width_counter(tri_bridge.FWD_BY_WIDTH, dv)
    n0 = counter.launches
    got = tri_bridge.tri_bridge(*args, dropout, SEED)
    again = tri_bridge.tri_bridge(*args, dropout, SEED)
    want = tri_bridge.tri_bridge_plain(*args, dropout, SEED)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert got.shape == args[0].shape and got.dtype == dt
    assert torch.equal(got, again)
    close(got, want, tri_bridge.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 2])
@pytest.mark.parametrize("dv", W64_DVS)
def test_tri_bridge_forward_at_64_drops_philox_s_positions(cuda, dv, group):
    """The dropped positions of the LN output are exactly ``ops/philox.py``'s
    in each group's true columns: LN_in gives 1 everywhere (scale 0, bias
    1), W copies group ``group`` of the dropped LN output to the outputs and
    LN_out centres each row, so an output is above 0 exactly where its
    input was kept (rows that keep or drop every value centre to 0)."""
    from tvqaplus_tpu_torch.ops import philox
    rows = 4097
    args, _ = tri64_case(cuda, rows, dv, 90 + dv)
    w = torch.zeros(3 * dv, dv, device=cuda)
    w[group * dv:(group + 1) * dv] = torch.eye(dv, device=cuda)
    params = [torch.zeros(3 * dv), torch.ones(3 * dv), w, torch.zeros(dv),
              torch.ones(dv), torch.zeros(dv)]
    params = [t.to(cuda) for t in params]
    got = tri_bridge.tri_bridge(args[0], args[1], *params, P_DROP, SEED)
    torch.cuda.synchronize()
    keep = philox.width_multiplier((rows, 3 * dv), SEED, P_DROP, dv, 3,
                                   cuda).reshape(rows, 3, dv)[:, group] > 0
    both = keep.any(-1) & ~keep.all(-1)
    assert both.float().mean() > (0.2 if dv == 4 else 0.9)
    assert torch.equal((got > 0)[both], keep[both])
