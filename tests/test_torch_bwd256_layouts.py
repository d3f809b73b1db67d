"""The Python side of the bf16 backward kernels at D = 256
(``csrc/encoder_bwd_tc_wide.cu`` ``Enc256``, ``csrc/qa_ctx_attention_bwd_wide.cu``
``AttTcWide``), on the CPU: the shared memory that ``ops/widths.py``
computes for each layout is the sources' own (their ``static constexpr``
offsets evaluated here) and fits an H100 block, the rings hold at least
three stages, and the wrappers' scratch holds what the kernels address
(the encoder's packed matrices, its grid and a block's row of sums; the
attention's partial rows, where its tensor-core kernel keeps P and Q)."""
import os
import re

import pytest
import torch

from tvqaplus_tpu_torch.ops import encoder, qa_ctx_attention, widths

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(encoder.__file__))), "csrc")
# the device constants the layouts name (csrc/wgmma.cuh, common.cuh)
ENV = {"TM": 64, "TILE_PANEL": 64 * 128, "ATOM_BYTES": 1024, "NWARPS": 8,
       "NTHREADS": 256, "MAX_K": 9, "ROW_BYTES": 128}


def struct_constants(source, name, **env):
    """The ``static constexpr int`` members of ``struct name`` in
    ``source`` (template arguments given in ``env``), evaluated in order."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    body = text[text.index(f"struct {name} {{"):]
    body = body[:body.index("\n};")]
    vals = {**ENV, **env}
    for m in re.finditer(r"static constexpr int (\w+) = ([^;]+);", body):
        expr = (m.group(2).replace("tc::", "").replace("Shapes<D>::", "SH_")
                .replace("/", "//"))
        vals[m.group(1)] = eval(expr, {"__builtins__": {}},   # noqa: S307
                                {**vals, "SH_TILE_BYTES":
                                 vals.get("D", 0) // 64 * ENV["TILE_PANEL"]})
    return vals


def test_the_encoder_layout_is_the_source_s_and_fits():
    s = struct_constants("encoder_bwd_tc_wide.cu", "Enc256")
    assert s["D"] == 256
    assert s["SMEM"] == widths.bwd_smem_bytes("encoder", 256) \
        <= widths.SMEM_LIMIT
    assert (s["KP"], s["NST"]) == (widths.ENC256_KP, widths.ENC256_NST)
    assert s["NST"] >= 3 and s["STAGE"] == s["KP"] * 256 * 2
    # the ring's stages fill R1's 64 x 256 floats; panels on atoms
    assert s["NST"] * s["STAGE"] == 64 * 256 * 4
    assert s["STAGE"] % 1024 == 0 and s["O_T"] % 1024 == 0
    assert s["O_R2"] % 1024 == 0
    # R1 (rows padded by 8 floats) and H hold 64 x 256 float32 each, on the
    # SM, and the depthwise sums of both layers' taps (9 at most) and dwb
    assert s["R1S"] == 264 and s["O_H"] - s["O_R1"] == 64 * 264 * 4
    assert s["O_R2"] - s["O_H"] == 64 * 256 * 4
    assert s["O_LN"] - s["O_DW"] == 2 * 10 * 256 * 4


@pytest.mark.parametrize("length,k", [(56, 9), (40, 5), (50, 7), (5, 1)])
def test_every_encoder_shape_takes_the_one_layout(length, k):
    """The layout does not depend on L or k (the depthwise passes walk
    columns), so the largest shape fits as the headline's does."""
    s = struct_constants("encoder_bwd_tc_wide.cu", "Enc256")
    assert widths.bwd_smem_bytes("encoder", 256, length=length, k=k) \
        == s["SMEM"]


@pytest.mark.parametrize("lrp,lr", [(32, 1), (32, 25), (64, 50), (64, 64)])
def test_the_attention_layout_is_the_source_s_and_fits(lrp, lr):
    s = struct_constants("qa_ctx_attention_bwd_wide.cu", "AttTcWide",
                         LRP=lrp)
    assert s["SMEM"] == widths.bwd_smem_bytes("qa_ctx_attention", 256,
                                              lr=lr) <= widths.SMEM_LIMIT
    assert s["NST"] == widths.ATT256_NST >= 3
    assert s["NOWN"] == widths.ATT256_OWN
    assert s["SLAB"] == 2 * 64 * 128 and s["PER_TILE"] == 24
    # the slots past the ring's own room fill qn's tile, which pass A
    # does not read (qn is loaded again for gcn)
    assert (s["NST"] - s["NOWN"]) * s["SLAB"] == s["O_QE"] - s["O_QN"]
    # p0 (LRP / 2 floats a thread) waits where the cn tile was
    assert lrp // 2 * 256 * 4 <= s["TILE"] == 64 * 256 * 2
    assert s["O_RING"] % 1024 == 0


@pytest.mark.parametrize("n,length,k", [(4000, 40, 5), (1680, 50, 7),
                                        (7, 25, 3), (7, 5, 1), (200, 56, 9)])
def test_the_encoder_wrapper_s_launch_at_256(n, length, k):
    """At D = 256 the wrapper gives each block only its slot of parameter
    sums (nothing of a tile in L2); at D = 64 too (``Enc64`` keeps its
    running sums and h stash on the SM), over half as many blocks: a
    block's two warpgroups take tiles of their own."""
    sms = 132
    nv = (2 * (4 + k) + 2)
    tiles = -(-n // (64 // length))
    assert encoder.wide_tc_launch(n, length, k, 256, sms) == (
        min(tiles, sms), nv * 256)
    w64 = struct_constants("encoder_bwd_tc_wide.cu", "Enc64")
    assert w64["D"] == 64 and w64["NPART"] == 2
    assert encoder.wide_tc_launch(n, length, k, 64, sms) == (
        min(-(-tiles // 2), sms), nv * 64)


@pytest.mark.parametrize("lr", [1, 25, 32, 33, 50, 64])
def test_the_attention_wrapper_s_scratch_at_256(lr):
    """The bf16 kernel at 256 writes P and Q into its rows' float32
    gcn_part / gce_part slots (B, Li, M, D) before gcn and gce, its
    parameter sums into a slot for each block of its persistent grid (one
    a 64-row tile at most: ceil(65 / 64) = 2 a frame), and its g_s and p
    rows LRP wide in bf16."""
    bsz, li, m, d = 2, 3, 65, 256
    got = qa_ctx_attention.wide_backward_scratch(bsz, li, m, lr, d,
                                                 torch.bfloat16, 7)
    rows, lrp = bsz * li * m, 32 if lr <= 32 else 64
    assert got[0] == got[1] == ((bsz, li, m, d), torch.float32)
    assert got[2:4] == [((rows, 3 * d), torch.bfloat16),
                        ((rows, d), torch.bfloat16)]
    assert got[4] == ((bsz * li * 2, 6 * d), torch.float32)   # a tile a slot
    assert got[5] == ((7, 3 * d + 1, d), torch.float32)
    assert got[6:] == [((rows, lrp), torch.bfloat16)] * 2 + [
        ((rows, d), torch.bfloat16)]
    f32 = qa_ctx_attention.wide_backward_scratch(bsz, li, m, lr, d,
                                                 torch.float32, 7)
    assert f32[6] == ((rows, (lr + 3) & ~3), torch.float32)
    assert f32[4] == ((bsz * li, 7 * d), torch.float32)


def phase_split():
    """scripts/phase_split.py as a module (it imports torch, not JAX)."""
    import importlib.util
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "scripts",
                        "phase_split.py")
    spec = importlib.util.spec_from_file_location("phase_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("source", ["qa_ctx_attention_bwd_wide.cu",
                                    "encoder_bwd_tc_wide.cu",
                                    "tri_bridge_bwd_wide.cu"])
def test_the_phase_stamps_go_into_a_copy_of_the_kernel(source):
    """The kernels carry no measurement code; each of phase_split's stamp
    anchors occurs once in its kernel, so the stamped copy has one stamp
    for each, all inside the kernel, in the order the phases name."""
    ps = phase_split()
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    assert "TVQA_PHASE" not in text and "clock64" not in text
    assert ps.variant(text, source) == source       # the newest design
    out = ps.stamped(text, source)
    i0, i1 = ps.kernel_span(out, source)
    marks = re.findall(r"TVQA_PHASE(?:_INIT|\((\d+)\))", out[i0:i1])
    assert len(marks) == len(ps.STAMPS[source]) == out.count("TVQA_PHASE")
    assert marks[0] == "" and "" not in marks[1:]   # the clock's start
    assert {int(m) for m in marks[1:]} == set(range(len(
        ps.PHASES[source])))
    # the text outside the stamps is the source's
    assert re.sub(r"\n *TVQA_PHASE(?:_INIT|\(\d+\))", "", out) == text


@pytest.mark.parametrize("name", ["no wait a slab", "no barrier a slab",
                                  "products of one slab in four",
                                  "no W copies"])
def test_each_g_yd_ablation_edits_the_attention_kernel_once(name):
    ps = phase_split()
    src = "qa_ctx_attention_bwd_wide.cu"
    with open(os.path.join(CSRC, src)) as f:
        text = f.read()
    out = ps.edit_kernel(text, src, ps.ABLATIONS[name])
    assert out != text
    i0, i1 = ps.kernel_span(text, src)
    assert out[:i0] == text[:i0] and out.endswith(text[i1:])
    with pytest.raises(ValueError):  # an anchor the kernel lacks
        ps.edit_kernel(text, src, [("no such text\n", "")])
