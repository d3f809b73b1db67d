"""The port's fused MLP bridge (``ops/mlp_bridge.py``) against the JAX
package: its plain version and gradients against the Pallas kernel
(``pallas_bridge._forward`` / ``fused_mlp_bridge``'s custom VJP, interpret
mode) and the pure-JAX reference, the dropout path against a Philox mask
built by hand, the ``MLPBridge`` module's kernel switch, and the checks the
wrapper makes before a launch.

Inputs are float32 from numpy seeds; Din and Dout are multiples of 4 that
are not multiples of 32, as STAGE's 300.  Each tolerance is stated at its
use."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_layers import bridge_sd, flax_params, load, rand
from tvqaplus_tpu.models import layers as jl
from tvqaplus_tpu.ops import pallas_bridge as br
from tvqaplus_tpu_torch.models import layers as tl
from tvqaplus_tpu_torch.models.layers import Dropout
from tvqaplus_tpu_torch.ops import checks, mlp_bridge, philox
from tvqaplus_tpu_torch.ops.plain import layer_norm

torch.set_num_threads(1)
F32 = np.float32
B, G, L, DIN, DOUT = 2, 6, 8, 24, 20
NAMES = ("x", "gamma_in", "beta_in", "w", "b", "gamma_out", "beta_out")


def bridge_inputs(seed=0, d_in=DIN, d_out=DOUT):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, G, L, d_in)).astype(F32),
            (rng.standard_normal(d_in) * 0.1 + 1).astype(F32),
            (rng.standard_normal(d_in) * 0.1).astype(F32),
            (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(F32),
            (rng.standard_normal(d_out) * 0.1).astype(F32),
            (rng.standard_normal(d_out) * 0.1 + 1).astype(F32),
            (rng.standard_normal(d_out) * 0.1).astype(F32)]


def test_mlp_bridge_plain_matches_pallas_and_reference():
    """Forward at atol/rtol 1e-4 (float32 sums in another order)."""
    args = bridge_inputs()
    jargs = [jnp.asarray(a) for a in args]
    fused = br._forward(*jargs, seed=0, dropout_rate=0.0, interpret=True,
                        compute_dtype=jnp.float32)
    ref = br.reference_impl(*jargs)
    targs = [torch.from_numpy(a) for a in args]
    ours = mlp_bridge.mlp_bridge_plain(*targs)
    assert ours.shape == (B, G, L, DOUT) and ours.dtype == torch.float32
    for name, want in (("pallas", fused), ("reference", ref)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # the CPU wrapper is the plain version
    assert torch.equal(mlp_bridge.mlp_bridge(*targs), ours)


def test_mlp_bridge_grads_match_pallas_backward():
    """Autograd through the plain version (x and the six parameters)
    against ``fused_mlp_bridge``'s custom VJP (the Pallas backward kernel in
    interpret mode): every element within 1e-4 of the largest gradient plus
    1e-3 relative (``checks.grad_close``)."""
    args = bridge_inputs(seed=1)
    g = np.random.default_rng(2).standard_normal((B, G, L, DOUT)).astype(F32)

    def jloss(*a):
        return jnp.sum(br.fused_mlp_bridge(
            *a, jnp.zeros((), jnp.int32), jnp.float32, 0.0) * g)

    ref = jax.grad(jloss, argnums=tuple(range(7)))(
        *[jnp.asarray(a) for a in args])
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    (mlp_bridge.mlp_bridge(*leaves) * torch.from_numpy(g)).sum().backward()
    for name, leaf, want in zip(NAMES, leaves, ref):
        checks.grad_close(name, leaf.grad, torch.from_numpy(np.array(want)),
                          (1e-4, 1e-3))


def test_mlp_bridge_dropout_uses_the_philox_mask():
    """Dropout through the wrapper against a mask built by hand from
    ops/philox.py on the (rows, Din) LN output: 1e-6, forward and
    gradient."""
    rate, seed = 0.1, 13
    args = [torch.from_numpy(a) for a in bridge_inputs(seed=3)]
    x, gin, bin_, w, b, gout, bout = args
    xt = x.clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    out = mlp_bridge.mlp_bridge(xt, *args[1:], rate, seed)
    y = layer_norm(x2, gin, bin_)
    keep = philox.keep_mask(y.numel(), seed, rate).reshape(y.shape)
    y = torch.where(keep, y * philox.scale(rate), 0.0)
    want = layer_norm(torch.relu(y @ w + b), gout, bout)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    out.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), x2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    frac = 1.0 - keep.float().mean().item()
    assert abs(frac - rate) < 0.03        # 2,304 draws: 3 sd is 0.019


def test_mlp_bridge_flip_rows_mark_relu_inputs_near_zero():
    x, gin, bin_, w, b, _, _ = (torch.from_numpy(a)
                                for a in bridge_inputs(seed=5))
    assert checks.mlp_bridge_flip_rows(x, gin, bin_, w, b, eps=1e9).all()
    none = checks.mlp_bridge_flip_rows(x, gin, bin_, w, b, eps=0.0)
    assert none.shape == x.shape[:-1] and not none.any()
    b = b.clone()
    b[0] -= (layer_norm(x, gin, bin_) @ w + b).reshape(-1, DOUT)[0, 0]
    flip = checks.mlp_bridge_flip_rows(x, gin, bin_, w, b, eps=1e-4)
    assert flip.reshape(-1)[0] and flip.float().mean() < 0.5


# ------------------------------------------------------------------ module
def spy_on_kernel_route(monkeypatch):
    calls = []
    real = tl.mlp_bridge
    monkeypatch.setattr(tl, "mlp_bridge",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or real(*a, **kw))
    return calls


def test_module_switch_on_equals_off_and_matches_jax(monkeypatch):
    """``MLPBridge(use_kernel=True)`` on the CPU equals the module with the
    switch off and the JAX module with ``use_pallas=True`` (its kernel in
    interpret mode), eval, at 1e-5 / 1e-4."""
    x = rand((B, G, L, DIN), seed=4)
    p = flax_params(jl.MLPBridge(DIN, DOUT, 0.1), x, train=False)
    ref = jl.MLPBridge(DIN, DOUT, 0.1, use_pallas=True).apply(
        {"params": p}, x, train=False)
    off = load(tl.MLPBridge(DIN, DOUT), bridge_sd(p))
    on = load(tl.MLPBridge(DIN, DOUT, use_kernel=True), bridge_sd(p))
    assert set(on.state_dict()) == set(off.state_dict())
    calls = spy_on_kernel_route(monkeypatch)
    with torch.no_grad():
        want, got = off(torch.from_numpy(x)), on(torch.from_numpy(x))
    assert calls == [x.shape]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_module_takes_the_kernel_route_only_for_4d_input(monkeypatch):
    """JAX layers.py:336-337: a 3-D input (STAGE's per-token subtitle
    stream) stays on the plain chain; the default module never leaves it."""
    x = rand((B, G, L, DIN), seed=6)
    on = tl.MLPBridge(DIN, DOUT, use_kernel=True)
    off = tl.MLPBridge(DIN, DOUT)
    assert off.use_kernel is False
    calls = spy_on_kernel_route(monkeypatch)
    with torch.no_grad():
        on(torch.from_numpy(x[0]))
        on(torch.from_numpy(x[:, None]))
        off(torch.from_numpy(x))
    assert calls == []
    with torch.no_grad():
        on(torch.from_numpy(x))
    assert calls == [x.shape]


def test_module_kernel_route_draws_its_dropout_from_the_kernel_seed():
    """In training the kernel route takes (rate, seed) from
    ``Dropout.kernel_args``: the Philox mask under the step's first seed
    slot, not the plain layers' generator."""
    x = torch.from_numpy(rand((B, G, L, DIN), seed=7))
    on = tl.MLPBridge(DIN, DOUT, use_kernel=True)
    seeds = philox.StepSeeds(2, "cpu").next()
    drop = Dropout(0.1, torch.Generator().manual_seed(1), seeds)
    with torch.no_grad():
        got = on(x, drop)
        want = mlp_bridge.mlp_bridge_plain(
            x, on[0].weight, on[0].bias, on[2].weight.t(), on[2].bias,
            on[4].weight, on[4].bias, 0.1, int(seeds[0]))
    assert torch.equal(got, want) and drop.site == 1


# ----------------------------------------------------------------- refusals
def test_wrapper_refuses_what_the_kernels_do_not_take():
    """The checks that run before a launch (they need no card)."""
    args = [torch.from_numpy(a) for a in bridge_inputs()]
    params, d_in, d_out = mlp_bridge._check(args[0], args[1:])
    assert (d_in, d_out) == (DIN, DOUT) and len(params) == 6
    for d_in, d_out in ((22, 20), (24, 18), (2, 20), (1400, 300)):
        bad = [torch.from_numpy(a) for a in bridge_inputs(d_in=d_in,
                                                          d_out=d_out)]
        with pytest.raises(ValueError, match="multiples of 4"):
            mlp_bridge._check(bad[0], bad[1:])
    with pytest.raises(ValueError, match="contiguous"):
        mlp_bridge._check(args[0].transpose(1, 2), args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        mlp_bridge._check(args[0].double(), args[1:])
    with pytest.raises(ValueError, match="do not match"):
        mlp_bridge._check(args[0], [args[1][:-4]] + args[2:])
