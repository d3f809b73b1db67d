"""The Python side of the bf16 encoder backward at D = 64
(``csrc/encoder_bwd_tc_wide.cu`` ``Enc64``: the block's two warpgroups on
tiles of their own, every per-tile state on the SM) and of the bf16 tri
bridge forward at D = 256 (``csrc/tri_bridge_fwd.cu`` ``TriFwd256``: W in
bf16 slabs through a ring the two warpgroups share, 64 rows of its own
each), on the CPU: the shared memory that ``ops/widths.py`` computes for
each layout is the source's (its ``static constexpr`` offsets evaluated
here) and fits an H100 block; the encoder's tile schedule puts each
sequence in one tile of one warpgroup and its row passes on live rows
only; the tri bridge's pairs of tiles, its ring's slab count and the slab
scratch the wrapper hands the C entry; the wrappers' arguments and the C
entries' signatures; ``scripts/phase_split.py`` stamps and ablates the two
kernels."""
import importlib.util
import os
import re

import pytest
import torch

from tvqaplus_tpu_torch.ops import encoder, tri_bridge, widths

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(encoder.__file__))), "csrc")
# the device constants the layouts name (csrc/wgmma.cuh, common.cuh)
ENV = {"TM": 64, "TILE_PANEL": 64 * 128, "ATOM_BYTES": 1024, "NWARPS": 8,
       "NTHREADS": 256, "MAX_K": 9, "ROW_BYTES": 128, "SLAB_ROWS": 32,
       "SLAB_BYTES": 16384}
SMS = 132


def source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def struct_constants(src, name, **env):
    """The ``static constexpr int`` members of ``struct name`` in ``src``
    (template arguments given in ``env``), evaluated in order."""
    text = source(src)
    body = text[text.index(f"struct {name} {{"):]
    body = body[:body.index("\n};")]
    vals = {**ENV, **env}
    for m in re.finditer(r"static constexpr int (\w+) = ([^;]+);", body):
        expr = (m.group(2).replace("tc::", "")
                .replace("Shapes<D>::TILE_BYTES", "(D / 64 * TILE_PANEL)")
                .replace("Shapes<D>::W_BYTES", "(D / 64 * 3 * D * ROW_BYTES)")
                .replace("/", "//"))
        vals[m.group(1)] = eval(expr, {"__builtins__": {}}, vals)  # noqa: S307
    return vals


# ------------------------------------------------------------ the layouts
def test_the_encoder_layout_at_64_is_the_source_s_and_fits():
    s = struct_constants("encoder_bwd_tc_wide.cu", "Enc64")
    assert s["D"] == 64 and s["NV"] == 32       # m64n64: 32 values a thread
    assert s["SMEM"] == widths.bwd_smem_bytes("encoder", 64) \
        <= widths.SMEM_LIMIT
    # pw0 and pw1 resident in bf16: a panel of 64 rows each
    assert s["O_ROOM"] - s["O_PW"] == 2 * 64 * 128
    # a warpgroup's room: the c and t tiles in bf16, R1, g_t and the h
    # stash (32 values of 128 threads) in float32, v and m, on an atom so
    # that the tiles swizzle
    assert s["R_T"] - s["R_C"] == s["R_R1"] - s["R_T"] == 64 * 64 * 2
    assert s["R_G"] - s["R_R1"] == s["R_H"] - s["R_G"] == 64 * 64 * 4
    assert s["R_VM"] - s["R_H"] == 64 * 64 * 4
    assert s["R_C"] % 1024 == 0 and s["R_T"] % 1024 == 0
    assert s["ROOM"] % 1024 == 0 and s["ROOM"] >= s["R_VM"] + 2 * 64 * 4
    assert s["O_ROOM"] % 1024 == 0
    # the running sums on the SM: the LN sums of 8 warps, the depthwise
    # sums of both warpgroups' two column parts, both layers, 9 taps + dwb
    assert s["O_DW"] - s["O_LN"] == 8 * 6 * 64 * 4
    assert s["O_END"] - s["O_DW"] == 2 * 2 * 2 * 10 * 64 * 4


@pytest.mark.parametrize("length,k", [(56, 9), (40, 5), (50, 7), (5, 1)])
def test_every_encoder_shape_at_64_takes_the_one_layout(length, k):
    s = struct_constants("encoder_bwd_tc_wide.cu", "Enc64")
    assert widths.bwd_smem_bytes("encoder", 64, length=length, k=k) \
        == s["SMEM"]


def test_the_tri_forward_layout_at_256_is_the_source_s_and_fits():
    s = struct_constants("tri_bridge_fwd.cu", "TriFwd256")
    assert s["SMEM"] == widths.tc_smem_bytes("tri_bridge", 256) \
        <= widths.SMEM_LIMIT
    assert s["NSLOT"] == widths.TRI256_FWD_SLOTS >= 2
    assert s["PER"] == 24                        # 768 rows of W in slabs
    # s and v of each warpgroup's 64 rows at 256 columns in bf16
    assert s["O_RING"] - s["O_SV"] == 2 * 2 * 64 * 256 * 2
    assert s["O_RING"] % 1024 == 0 and s["SLAB_BYTES"] % 1024 == 0
    assert s["O_BAR"] - s["O_RING"] == s["NSLOT"] * widths.SLAB_BYTES
    # a sixth slot would not fit beside the s and v tiles
    assert s["SMEM"] + widths.SLAB_BYTES > widths.SMEM_LIMIT


@pytest.mark.parametrize("d", [64, 128])
def test_the_resident_tri_layouts_are_the_source_s(d):
    """D = 64 and 128 keep W resident, D = 128 in ``TriTc`` and D = 64 in
    ``TriFwd64`` (the D = 256 branch gone to ``TriFwd256``): the bytes
    ``ops/widths.py`` gives are the source's."""
    name = "TriTc" if d == 128 else "TriFwd64"
    s = struct_constants("tri_bridge_fwd.cu", name, D=d)
    w_end = s["O_SV"] if d == 128 else s["O_PV"] - s["O_W"]
    assert w_end == 3 * d * d * 2                       # W in bf16
    assert s["SMEM"] == widths.tc_smem_bytes("tri_bridge", d) \
        <= widths.SMEM_LIMIT


# -------------------------------------------- the encoder's tile schedule
def encoder_schedule(n, length, blocks):
    """{(block, warpgroup): [tiles]} of the D = 64 kernel's loop, and the
    sequences of each tile (64 // length a tile)."""
    nseq = 64 // length
    tiles = -(-n // nseq)
    walk = {}
    for b in range(blocks):
        for wg in (0, 1):
            walk[b, wg] = list(range(2 * b + wg, tiles, 2 * blocks))
    seqs = {t: list(range(t * nseq, min(n, (t + 1) * nseq)))
            for t in range(tiles)}
    return walk, seqs


@pytest.mark.parametrize("n,length,k", [(4000, 40, 5), (1680, 50, 7),
                                        (7, 25, 3), (7, 5, 1), (200, 56, 9)])
def test_the_encoder_schedule_at_64_takes_each_sequence_once(n, length, k):
    """Each warpgroup walks tiles of its own (the kernel's loop is the one
    simulated here), each sequence lies in exactly one tile of one
    warpgroup, whole, and a warp runs the row passes only when one of its
    16 rows is live; the grid is the wrapper's."""
    text = source("encoder_bwd_tc_wide.cu")
    assert ("for (int tile = 2 * blockIdx.x + wg; tile < tiles; tile += 2 "
            "* gridDim.x) {") in text
    assert "const bool wlive = 16 * warp < rows;" in text
    blocks, _ = encoder.wide_tc_launch(n, length, k, 64, SMS)
    walk, seqs = encoder_schedule(n, length, blocks)
    taken = [s for ts in walk.values() for t in ts for s in seqs[t]]
    assert sorted(taken) == list(range(n))
    tiles = len(seqs)
    # every block has a tile; the warpgroups' loads differ by one tile
    assert all(walk[b, 0] for b in range(blocks))
    counts = [len(ts) for ts in walk.values()]
    assert max(counts) - min(counts) <= 1 and sum(counts) == tiles
    for ts in walk.values():
        for t in ts:
            rows = len(seqs[t]) * length
            assert 0 < rows <= 64
            live_warps = [w for w in range(4) if 16 * w < rows]
            # every live row is in a live warp; a dead warp holds none
            assert all(r // 16 in live_warps for r in range(rows))
            assert all(16 * w >= rows for w in range(4)
                       if w not in live_warps)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("dv", [64, 60])
def test_the_encoder_wrapper_at_64_casts_nothing(monkeypatch, full, dv):
    """At D = 64 the kernel rounds pw0 and pw1 from the packed parameters:
    the wrapper hands no pw; the blocks' slots (one a block of
    ``wide_tc_launch``'s grid), the weight gradient's chunks and the four
    row buffers in bf16 each a buffer of its own (so that guard bands lie
    around each)."""
    calls = []
    table = encoder.BLOCK_BWD_BY_WIDTH if full else encoder.BWD_BY_WIDTH
    monkeypatch.setattr(encoder, "ptr", lambda t: t)
    monkeypatch.setattr(encoder, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(encoder, "tc_wgrad_chunks", lambda *a: 3)
    monkeypatch.setattr(table[64], "launch",
                        lambda dev, *a, **kw: calls.append(a))
    gen = torch.Generator().manual_seed(3)
    b, g, length, k = 2, 7, 40, 5
    x = torch.randn(b, g, length, 64, generator=gen).to(torch.bfloat16)
    pe = torch.randn(length, 64, generator=gen)
    shapes = {"dw0": (k, 64), "dw1": (k, 64), "pw0": (64, 64),
              "pw1": (64, 64)}
    packed = encoder.pack_params({
        key: torch.randn(*shapes.get(key, (64,)), generator=gen)
        for key in encoder.PARAM_KEYS})
    gout = torch.randn(*((b, g, length, 64) if full else (b, g, 64)),
                       generator=gen)
    mask = None if full else torch.ones(b, g, length)
    encoder._backward(x, pe, packed, mask, None, gout, k, 0.0, 0, dv,
                      full=full)
    (a,) = calls
    assert a[3] is None                                   # pw
    n = b * g
    rows = a[9:13]
    assert all(r.dtype == torch.bfloat16 and r.shape == (n * length, 64)
               for r in rows)
    blocks, row = encoder.wide_tc_launch(n, length, k, 64, SMS)
    assert blocks == 7                # 14 tiles of one sequence, two a block
    vec_part, work, wg_part = a[13:16]
    assert work is None and vec_part.shape == (blocks, row)
    assert wg_part.shape == (3, 65, 64)
    bufs = list(rows) + [a[7], a[8], vec_part, wg_part]
    assert len({t.untyped_storage().data_ptr() for t in bufs}) == len(bufs)
    assert a[8].shape == (2, 65, 64)                      # [gpw; gpwb]
    assert a[-4:] == (dv, None, 1, 1)


# ------------------------------------------ the tri bridge's pairs of tiles
def tri_schedule(rows, blocks):
    """{(block, pass): (tile of warpgroup 0, tile of warpgroup 1)} of the
    kernel's loop (a tile past the last is empty: its warpgroup takes the
    pass's slabs and writes nothing)."""
    tiles = -(-rows // 64)
    pairs = -(-tiles // 2)
    out = {}
    for b in range(blocks):
        passes = (pairs - 1 - b) // blocks + 1 if pairs > b else 0
        for j in range(passes):
            out[b, j] = tuple(2 * (b + j * blocks) + w for w in (0, 1))
    return out, tiles


@pytest.mark.parametrize("rows", [1, 65, 129, 160000])
def test_the_tri_forward_at_256_pairs_its_tiles_and_hands_the_slabs(
        monkeypatch, rows):
    """The wrapper hands the C entry W in float32 and the slab scratch (W's
    768 rows in bf16, whatever the rows); every 64-row tile lies in one
    pass of one block, both warpgroups of a pass take its 24 slabs, and
    the ring's count of a block is its passes' slabs."""
    text = source("tri_bridge_fwd.cu")
    assert "return 2 * (blockIdx.x + static_cast<long long>(j) * gridDim.x)" \
           " + wg;" in text
    assert "wp, passes * PER);" in text
    calls = []
    monkeypatch.setattr(tri_bridge, "ptr", lambda t: t)
    monkeypatch.setattr(tri_bridge.FWD_BY_WIDTH[256], "launch",
                        lambda dev, *a, **kw: calls.append(a))
    d = 256
    s = torch.zeros(rows, d, dtype=torch.bfloat16)
    params = [torch.ones(3 * d), torch.zeros(3 * d), torch.zeros(3 * d, d),
              torch.zeros(d), torch.ones(d), torch.zeros(d)]
    tri_bridge._TriBridge.forward(type("Ctx", (), {
        "save_for_backward": lambda self, *a: None})(), s, s, *params,
        0.0, 0, d)
    (a,) = calls
    wp = a[5]
    assert wp.dtype == torch.bfloat16 and wp.numel() == 3 * d * d
    assert a[4].dtype == torch.float32 and a[4].shape == (3 * d, d)
    assert a[10] == rows and a[11] == d
    blocks = min(-(-(-(-rows // 64)) // 2), SMS)
    sched, tiles = tri_schedule(rows, blocks)
    seen = [t for pair in sched.values() for t in pair if t < tiles]
    assert sorted(seen) == list(range(tiles))
    for b in range(blocks):
        passes = sum(1 for (bb, _) in sched if bb == b)
        assert passes >= 1
        assert passes * 24 * widths.SLAB_BYTES == passes * 3 * d * d * 2


@pytest.mark.parametrize("d", [64, 128])
def test_the_resident_tri_forwards_take_no_slabs(monkeypatch, d):
    calls = []
    monkeypatch.setattr(tri_bridge, "ptr", lambda t: t)
    monkeypatch.setattr(tri_bridge.FWD_BY_WIDTH[d], "launch",
                        lambda dev, *a, **kw: calls.append(a))
    s = torch.zeros(65, d, dtype=torch.bfloat16)
    params = [torch.ones(3 * d), torch.zeros(3 * d), torch.zeros(3 * d, d),
              torch.zeros(d), torch.ones(d), torch.zeros(d)]
    tri_bridge._TriBridge.forward(type("Ctx", (), {
        "save_for_backward": lambda self, *a: None})(), s, s, *params,
        0.0, 0, d)
    assert calls[0][5] is None
    assert tri_bridge.slab_scratch(s.float()) is None


def c_params(src, entry):
    text = source(src)
    sig = text[text.index(f'extern "C" int {entry}('):]
    sig = sig[sig.index("(") + 1:sig.index(")")]
    return [p.strip() for p in sig.split(",")]


def test_the_tri_c_entry_takes_what_the_wrapper_gives():
    params = c_params("tri_bridge_fwd.cu", "tri_bridge_fwd")
    kernel = tri_bridge.FWD_BY_WIDTH[256]
    assert len(params) == len(kernel.argtypes)
    assert params[5] == "void* wp" and params[-1] == "void* stream"
    for p, t in zip(params, kernel.argtypes):
        assert ("*" in p) == (t.__name__ == "c_void_p"), (p, t)


def test_the_streamed_w_helpers_are_gone():
    """The D = 256 tri forward was the last caller of the two-stage stream
    of float32 W; it and its stage size are gone."""
    for name in os.listdir(CSRC):
        text = source(name)
        assert "mma_streamed_w" not in text
        assert "stream_stage_bytes" not in text


# ----------------------------------------------------- scripts/phase_split
def phase_split():
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "scripts",
                        "phase_split.py")
    spec = importlib.util.spec_from_file_location("phase_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("key", ["ENC64", "TRI_FWD"])
def test_the_phase_stamps_and_ablations_go_into_a_copy(key):
    """The sources carry no measurement code; each stamp anchor of the new
    designs occurs once in its kernel (the D = 64 encoder kernel beside the
    D = 256 one in its source, the D = 256 tri forward beside the resident
    one), the phases are numbered in full, and each ablation edits the
    kernel alone."""
    ps = phase_split()
    src = getattr(ps, key)
    text = source(ps.source_file(src))
    assert "TVQA_PHASE" not in text and "clock64" not in text
    assert ps.variant(text, src) == src               # the newest design
    out = ps.stamped(text, src)
    i0, i1 = ps.kernel_span(out, src)
    marks = re.findall(r"TVQA_PHASE(?:_INIT|\((\d+)\))", out[i0:i1])
    assert len(marks) == len(ps.STAMPS[src]) == out.count("TVQA_PHASE")
    assert marks[0] == "" and "" not in marks[1:]
    assert {int(m) for m in marks[1:]} == set(range(len(ps.PHASES[src])))
    assert re.sub(r"\n *TVQA_PHASE(?:_INIT|\(\d+\))", "", out) == text
    j0, j1 = ps.kernel_span(text, src)
    for edits in ps.FWD_ABLATIONS.get(src, {}).values():
        got = ps.edit_kernel(text, src, edits)
        assert got != text and got[:j0] == text[:j0]
        assert got.endswith(text[j1:])
