"""The Python side of the MLP bridge's bf16 tensor-core launch
(``ops/mlp_bridge.py``), which runs without a card: the kernels' padded K
and N widths and the backward's scratch shapes at STAGE's three bridge
sites, the packed bf16 weight against JAX's bf16 cast, and the widths the
wrapper refuses.  The kernels themselves are held against the plain version
in tests/test_torch_cuda.py (marker ``cuda``)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvqaplus_tpu_torch.ops import _build, mlp_bridge

F32 = np.float32
SMS = 132                        # an H100's streaming multiprocessors
# STAGE's bridge sites at the headline shapes (batch 16, 5 answers x 40
# tokens, 50 frames x 25 regions, 50 subtitle tokens): rows, Din, Dout
SITES = {"qas_bert": (16 * 5 * 40, 768, 300),
         "vid": (16 * 50 * 25, 300, 300),
         "sub_bert": (16 * 50 * 50, 768, 300)}
SCRATCH = {
    "qas_bert": {"yd": (3200, 768), "g1": (3200, 320),
                 "vec_part": (50, 2136), "wg_part": (22, 769, 320)},
    "vid": {"yd": (20000, 320), "g1": (20000, 320),
            "vec_part": (132, 1200), "wg_part": (44, 321, 320)},
    "sub_bert": {"yd": (40000, 768), "g1": (40000, 320),
                 "vec_part": (132, 2136), "wg_part": (22, 769, 320)}}
WIDTHS = [(768, 300), (300, 300), (24, 20), (132, 260), (100, 60)]


@pytest.mark.parametrize("site", sorted(SITES))
def test_padded_widths_and_backward_scratch_at_the_stage_sites(site):
    """K and N padded to whole 64-column panels (768 stays, 300 -> 320);
    one column-sum slot per persistent block (at most one a SM); Kp / 128
    weight-gradient blocks a row chunk, one block a SM."""
    rows, d_in, d_out = SITES[site]
    assert mlp_bridge.padded_widths(d_in, d_out) == (
        {768: 768, 300: 320}[d_in], 320)
    assert mlp_bridge.tc_backward_scratch(rows, d_in, d_out,
                                          SMS) == SCRATCH[site]


def test_backward_scratch_rows_are_bf16_sized():
    """The yd and g_y1 rows the weight gradient reads take 87 MB at the
    subtitle stream in bf16 (174 MB as the float32 rows of the CUDA-core
    backward)."""
    rows, d_in, d_out = SITES["sub_bert"]
    shapes = mlp_bridge.tc_backward_scratch(rows, d_in, d_out, SMS)
    assert 2 * (np.prod(shapes["yd"]) + np.prod(shapes["g1"])) == 87_040_000
    assert 4 * rows * (d_in + d_out) == 170_880_000


@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_packed_weight_is_jax_bf16_cast_with_zero_padding(d_in, d_out):
    """``pack_weight`` rounds W once to bf16, to nearest even as JAX's
    ``astype`` (exact ties included), and pads to (Kp, Np) with zeros;
    the module's transposed view packs the same."""
    rng = np.random.default_rng(d_in * 1000 + d_out)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(F32)
    w[0, :4] = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8),
                2.0 ** -130]                  # two ties, a tie, a subnormal
    want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)).astype(F32)
    kp, np_ = mlp_bridge.padded_widths(d_in, d_out)
    for src in (torch.from_numpy(w),
                torch.from_numpy(np.ascontiguousarray(w.T)).t()):
        got = mlp_bridge.pack_weight(src)
        assert got.dtype == torch.bfloat16 and got.shape == (kp, np_)
        g = got.float().numpy()
        np.testing.assert_array_equal(g[:d_in, :d_out], want)
        assert not g[d_in:].any() and not g[:, d_out:].any()
    assert want[0, 0] == 1.0 and want[0, 1] == 1 + 2.0 ** -6


@pytest.mark.parametrize("d_in,d_out", [(772, 300), (768, 324), (1024, 8),
                                        (8, 512), (22, 20), (24, 18),
                                        (2, 20), (20, 2)])
def test_wrapper_refuses_widths_the_kernels_do_not_take(d_in, d_out):
    x = torch.zeros(3, d_in)
    params = [torch.ones(d_in), torch.zeros(d_in), torch.zeros(d_in, d_out),
              torch.zeros(d_out), torch.ones(d_out), torch.zeros(d_out)]
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="4 <= Din <= 768 and "
                                             "4 <= Dout <= 320"):
            mlp_bridge._check(x, params, dt)


@pytest.mark.parametrize("d_in,d_out", WIDTHS + [(768, 320), (4, 4)])
def test_wrapper_takes_every_stage_and_test_width(d_in, d_out):
    x = torch.zeros(3, d_in, dtype=torch.bfloat16)
    params = [torch.ones(d_in), torch.zeros(d_in), torch.zeros(d_in, d_out),
              torch.zeros(d_out), torch.ones(d_out), torch.zeros(d_out)]
    assert mlp_bridge._check(x, params, torch.bfloat16)[1:] == (d_in, d_out)


def test_the_wrapper_limits_are_the_kernels():
    """MAX_DIN / MAX_DOUT are the CUDA source's BT_MAX_DIN / BT_MAX_DOUT."""
    with open(os.path.join(_build.CSRC, "mlp_bridge_tc.cuh")) as f:
        src = f.read()
    limits = dict(re.findall(r"constexpr int (BT_MAX_D\w+) = (\d+);", src))
    assert (int(limits["BT_MAX_DIN"]), int(limits["BT_MAX_DOUT"])) == (
        mlp_bridge.MAX_DIN, mlp_bridge.MAX_DOUT)
    assert "mlp_bridge_tc.cuh" in _build._HEADERS
