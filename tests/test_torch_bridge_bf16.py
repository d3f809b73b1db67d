"""The port's MLP bridge (``ops/mlp_bridge.py``) in its bfloat16 compute
mode against the TPU kernel's (``pallas_bridge._forward`` / ``_backward``
with ``compute_dtype=bfloat16``, interpret mode): the plain version rounds
the dropped LN output and W to bf16 before the product (and g_y1 with each
in the backward), as the TPU kernel does, on bf16 and on float32 x; the
dropout path against a Philox mask built by hand; the float32 mode still
unrounded; and the ``MLPBridge`` module's kernel route in the module's
dtype against the JAX module's fused route.

Inputs come from numpy seeds; Din and Dout are multiples of 4 that are not
multiples of 32, as STAGE's 300.  The bars: every output within one bf16
step of its magnitude (at least 1's step, 2**-7), and 99% of the outputs
the same bits; every gradient element within 1e-5 of its tensor's largest
plus 2**-8 relative (a bf16 gx is rounded once; JAX returns float32)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.test_torch_layers import bridge_sd, flax_params, load
from tvqaplus_tpu.models import layers as jl
from tvqaplus_tpu.ops import pallas_bridge as br
from tvqaplus_tpu_torch.models import layers as tl
from tvqaplus_tpu_torch.ops import checks, mlp_bridge, philox
from tvqaplus_tpu_torch.ops.plain import layer_norm, round_bf16

torch.set_num_threads(1)
F32 = np.float32
SHAPE = (2, 4, 8)
WIDTHS = [(300, 300), (100, 60)]
NAMES = ("x", "gamma_in", "beta_in", "w", "b", "gamma_out", "beta_out")
BF16 = torch.bfloat16
STEP = 2.0 ** -7                # one bf16 step at magnitude 1


def bridge_inputs(seed, d_in, d_out, x_bf16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE + (d_in,)).astype(F32)
    if x_bf16:
        x = x.astype(ml_dtypes.bfloat16).astype(F32)
    return [x, (rng.standard_normal(d_in) * 0.1 + 1).astype(F32),
            (rng.standard_normal(d_in) * 0.1).astype(F32),
            (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(F32),
            (rng.standard_normal(d_out) * 0.1).astype(F32),
            (rng.standard_normal(d_out) * 0.1 + 1).astype(F32),
            (rng.standard_normal(d_out) * 0.1).astype(F32)]


def jax_args(args, x_bf16):
    return [jnp.asarray(args[0], jnp.bfloat16 if x_bf16 else jnp.float32)] \
        + [jnp.asarray(a) for a in args[1:]]


def torch_x(x, x_bf16):
    t = torch.from_numpy(x)
    return t.to(BF16) if x_bf16 else t


def assert_within_a_step(got, want):
    """|got - want| <= one bf16 step at max(|want|, 1), and 99% equal."""
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    err = np.abs(got - want)
    bar = STEP * np.maximum(np.abs(want), 1.0)
    assert (err <= bar).all(), f"{int((err > bar).sum())} outside, max " \
                               f"{err.max()}"
    assert (err == 0).mean() >= 0.99, (err == 0).mean()


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_plain_bf16_forward_matches_the_pallas_bf16_mode(d_in, d_out,
                                                         x_bf16):
    args = bridge_inputs(0, d_in, d_out, x_bf16)
    want = br._forward(*jax_args(args, x_bf16), seed=0, dropout_rate=0.0,
                       interpret=True, compute_dtype=jnp.bfloat16)
    got = mlp_bridge.mlp_bridge_plain(
        torch_x(args[0], x_bf16), *map(torch.from_numpy, args[1:]),
        compute_dtype=BF16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_within_a_step(got.float().numpy(), np.asarray(want, F32))
    # the CPU wrapper is the plain version, its mode x's type by default
    if x_bf16:
        assert torch.equal(mlp_bridge.mlp_bridge(
            torch_x(args[0], True), *map(torch.from_numpy, args[1:])), got)


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_plain_bf16_grads_match_the_pallas_bf16_backward(d_in, d_out,
                                                         x_bf16):
    """Autograd through the plain version against ``_backward`` (the
    cotangent is bf16 on both sides, as the bf16 output's)."""
    args = bridge_inputs(1, d_in, d_out, x_bf16)
    g = np.random.default_rng(2).standard_normal(SHAPE + (d_out,)).astype(
        ml_dtypes.bfloat16).astype(F32)
    ref = br._backward(*jax_args(args, x_bf16), seed=0,
                       g_out=jnp.asarray(g), dropout_rate=0.0,
                       interpret=True, compute_dtype=jnp.bfloat16)
    leaves = [torch_x(args[0], x_bf16).requires_grad_(True)] + [
        torch.tensor(a, requires_grad=True) for a in args[1:]]
    out = mlp_bridge.mlp_bridge_plain(*leaves, compute_dtype=BF16)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert leaves[0].grad.dtype == leaves[0].dtype
    for name, leaf, want in zip(NAMES, leaves, ref):
        checks.grad_close(name, leaf.grad.float(),
                          torch.from_numpy(np.array(want, F32)).reshape(
                              leaf.shape), (1e-5, 2.0 ** -8))


def test_bf16_dropout_through_the_wrapper_uses_the_philox_mask():
    """The mask of ops/philox.py on the (rows, Din) LN output, then the bf16
    product by hand (operands rounded, float32 sums): forward at 1e-6; the
    gradient of x within 2e-2 of its largest + 2e-2 relative, as the
    hand-built chain's backward does not round g_y1."""
    rate, seed = 0.1, 13
    x, gin, bin_, w, b, gout, bout = map(
        torch.from_numpy, bridge_inputs(3, 300, 300, False))
    xt = x.clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    out = mlp_bridge.mlp_bridge(xt, gin, bin_, w, b, gout, bout, rate, seed,
                                compute_dtype=BF16)
    y = layer_norm(x2, gin, bin_)
    keep = philox.keep_mask(y.numel(), seed, rate).reshape(y.shape)
    y = torch.where(keep, y * philox.scale(rate), 0.0)
    y1 = round_bf16(y) @ round_bf16(w) + b
    want = layer_norm(torch.relu(y1), gout, bout).to(BF16)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               want.detach().float().numpy(), rtol=1e-6,
                               atol=1e-6)
    out.float().sum().backward()
    want.float().sum().backward()
    checks.grad_close("x", xt.grad, x2.grad, (2e-2, 2e-2))
    assert abs(1.0 - keep.float().mean().item() - rate) < 0.01


def test_float32_mode_is_unrounded():
    """float32 x keeps the float32 product: the same bits as the unrounded
    chain."""
    x, gin, bin_, w, b, gout, bout = map(
        torch.from_numpy, bridge_inputs(4, 300, 300, False))
    want = layer_norm(torch.relu(layer_norm(x, gin, bin_) @ w + b), gout,
                      bout)
    for got in (mlp_bridge.mlp_bridge_plain(x, gin, bin_, w, b, gout, bout),
                mlp_bridge.mlp_bridge(x, gin, bin_, w, b, gout, bout,
                                      compute_dtype=torch.float32)):
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_the_kernels_refuse_float32_compute_on_bf16_x():
    x, *params = map(torch.from_numpy, bridge_inputs(5, 300, 300, True))
    with pytest.raises(ValueError, match="compute in float32"):
        mlp_bridge._check(x.to(BF16), params, torch.float32)
    assert mlp_bridge._check(x, params, BF16)[1:] == (300, 300)


def test_bf16_flip_rows_take_the_bridge_margin():
    """In the bf16 mode the flagged rows are the bf16 plain version's,
    at ``BRIDGE_BF16_EPS`` by default."""
    x, gin, bin_, w, b, _, _ = map(torch.from_numpy,
                                   bridge_inputs(6, 300, 300, False))
    pre = mlp_bridge.mlp_bridge_pre(x, gin, bin_, w, b, compute_dtype=BF16)
    want = (pre.abs() < checks.BRIDGE_BF16_EPS).any(-1)
    got = checks.mlp_bridge_flip_rows(x, gin, bin_, w, b, compute_dtype=BF16)
    assert torch.equal(got, want) and 0 < got.float().mean() < 1
    assert torch.equal(checks.mlp_bridge_flip_rows(x.to(BF16), gin, bin_, w,
                                                   b),
                       (mlp_bridge.mlp_bridge_pre(x.to(BF16), gin, bin_, w,
                                                  b).abs()
                        < checks.BRIDGE_BF16_EPS).any(-1))


def test_module_kernel_route_computes_in_the_module_dtype():
    """``MLPBridge(use_kernel=True, dtype=bf16)`` on float32 input against
    the JAX ``MLPBridge(use_pallas=True, dtype=bfloat16)`` (its fused
    kernel in interpret mode reads float32 x in the bf16 mode), eval: bf16
    out, within a bf16 step."""
    d_in, d_out = 300, 300
    x = np.random.default_rng(7).standard_normal(SHAPE + (d_in,)).astype(F32)
    p = flax_params(jl.MLPBridge(d_in, d_out, 0.1), x, train=False)
    want = jl.MLPBridge(d_in, d_out, 0.1, dtype=jnp.bfloat16,
                        use_pallas=True).apply({"params": p}, x, train=False)
    on = load(tl.MLPBridge(d_in, d_out, dtype=BF16, use_kernel=True),
              bridge_sd(p))
    with torch.no_grad():
        got = on(torch.from_numpy(x))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_within_a_step(got.float().numpy(), np.asarray(want, F32))
