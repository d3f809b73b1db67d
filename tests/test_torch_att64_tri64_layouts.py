"""The Python side of the bf16 attention forward at D = 64
(``csrc/qa_ctx_attention_fwd.cu`` ``AttnTc64``: persistent CTAs of three
warpgroups, each on a run of (b, 64-row tile, frame) items of its own) and
of the bf16 tri bridge backward at D = 64 (``csrc/tri_bridge_bwd_wide.cu``
``Tri64``: each of a block's two warpgroups on 64-row tiles of its own at
all 64 columns, the next tile prefetched), on the CPU: the shared memory
that ``ops/widths.py`` computes for each layout is the source's (its
``static constexpr`` offsets evaluated here) and fits an H100 block; the
attention's item schedule takes every (b, row of M, frame) once and the
tri bridge's tile schedule every row once; the wrappers' arguments and the
C entries' signatures; ``scripts/phase_split.py`` stamps both kernels."""
import importlib.util
import os
import re

import pytest
import torch

from tvqaplus_tpu_torch.ops import qa_ctx_attention, tri_bridge, widths

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(tri_bridge.__file__))), "csrc")
# the device constants the layouts name (csrc/wgmma.cuh, common.cuh)
ENV = {"TM": 64, "TILE_PANEL": 64 * 128, "ATOM_BYTES": 1024, "NWARPS": 8,
       "NTHREADS": 256, "ROW_BYTES": 128}
SMS = 132


def source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def struct_constants(src, name, **env):
    """The ``static constexpr int`` members of ``struct name`` in ``src``,
    evaluated in order."""
    text = source(src)
    body = text[text.index(f"struct {name} {{"):]
    body = body[:body.index("\n};")]
    vals = {**ENV, **env}
    for m in re.finditer(r"static constexpr int (\w+) = ([^;]+);", body):
        expr = (m.group(2).replace("tc::", "")
                .replace("Shapes<D>::W_BYTES", "(D / 64 * 3 * D * ROW_BYTES)")
                .replace("/", "//"))
        vals[m.group(1)] = eval(expr, {"__builtins__": {}}, vals)  # noqa: S307
    return vals


# ------------------------------------------------------------ the layouts
def test_the_attention_layout_at_64_is_the_source_s_and_fits():
    s = struct_constants("qa_ctx_attention_fwd.cu", "AttnTc64")
    assert s["D"] == 64 and s["NWG"] == widths.ATT64_WARPGROUPS == 3
    assert s["NT"] == 128 * s["NWG"]
    assert s["SMEM"] == widths.tc_smem_bytes("qa_ctx_attention", 64) \
        <= widths.SMEM_LIMIT
    # W (3D x D bf16) once a CTA, then the bias on an atom of its own
    assert s["O_BIAS"] - s["O_W"] == 3 * 64 * 64 * 2
    assert s["O_ROOM"] - s["O_BIAS"] >= 64 * 4
    # a room a warpgroup: the cn and ce tiles and two slots of qn, qe (64
    # rows of 128 bytes each at LRP 64) and the q mask, every tile on an
    # atom
    assert s["R_CE"] == s["TILE"] and s["R_SLOT"] == 2 * s["TILE"]
    assert s["ROOM"] == s["R_SLOT"] + 2 * s["SLOT"]
    assert s["S_QE"] == s["TILE"] == 64 * 128 and s["S_QM"] == 2 * s["TILE"]
    assert s["SLOT"] - s["S_QM"] >= 64 * 4
    for off in (s["O_ROOM"], s["ROOM"], s["SLOT"], s["TILE"], s["R_SLOT"]):
        assert off % 1024 == 0
    # the output tile (64 x 64 bf16) fits the frame's qn room
    assert s["S_QE"] >= 64 * 64 * 2


def test_the_tri_backward_layout_at_64_is_the_source_s_and_fits():
    s = struct_constants("tri_bridge_bwd_wide.cu", "Tri64")
    assert s["D"] == 64 and s["NWG"] == widths.TRI64_WARPGROUPS == 3
    assert s["NT"] == 128 * s["NWG"]
    assert s["SMEM"] == widths.bwd_smem_bytes("tri_bridge", 64) \
        <= widths.SMEM_LIMIT
    # W once in bf16 (no W^T: y1 reads it MN-major, g_yd K-major)
    assert s["O_PV"] - s["O_W"] == 3 * 64 * 64 * 2
    assert s["O_ROOM"] - s["O_PV"] == 8 * 64 * 4     # gin bin bias gout
    # a warpgroup's room: two halves of three tiles taking turns (a tile's
    # s, v and cotangent; the other's yd, three panels), g_y1; on atoms
    assert s["HALF"] == 3 * 64 * 64 * 2 and s["R_G1"] == 2 * s["HALF"]
    assert s["ROOM"] - s["R_G1"] == 64 * 64 * 2
    for off in (s["O_ROOM"], s["HALF"], s["R_G1"], s["ROOM"]):
        assert off % 1024 == 0
    # the block's sums ([12 warps][8D] float32) fit warpgroup 0's first half
    assert 4 * s["NWG"] * 8 * 64 * 4 <= s["HALF"]


def test_the_old_d64_designs_are_gone():
    """The tri bridge's D = 64 backward that split the columns (W and W^T
    resident, g_yd twice) and the attention forward's D = 64 instantiation
    of the one-block-a-frame kernel are replaced."""
    tri = source("tri_bridge_bwd_wide.cu")
    assert "tri_bridge_bwd_tc_wide_kernel" not in tri
    assert "TriBwdTc" not in tri and "tri_gyd_mma" not in tri
    att = source("qa_ctx_attention_fwd.cu")
    launch = att[att.index("int launch_tc("):]
    launch = launch[:launch.index("\n}\n")]
    assert "qa_ctx_fwd_tc64_kernel<LRP, true>" in launch
    assert "qa_ctx_fwd_tc64_kernel<LRP, false>" in launch
    assert "} else if constexpr (D == 64) {" in launch


# ---------------------------------------- the attention's item schedule
def attention_items(bsz, m, li, sms=SMS):
    """{(cta, warpgroup): [items]} of the D = 64 kernel (the C entry's grid
    and the kernel's shares, simulated here) and the rows of each item:
    item f = (b T + tile) Li + frame."""
    nwg = widths.ATT64_WARPGROUPS
    t = -(-m // 64)
    items = bsz * t * li
    ctas = min(-(-items // nwg), sms)
    nw = ctas * nwg
    shares = {(c, w): list(range(items * (c * nwg + w) // nw,
                                 items * (c * nwg + w + 1) // nw))
              for c in range(ctas) for w in range(nwg)}
    return shares, t, ctas


@pytest.mark.parametrize("m", [200, 7, 64, 65])
@pytest.mark.parametrize("li", [1, 50])
def test_the_attention_items_take_each_row_and_frame_once(m, li):
    """Every (b, row of M, frame) lies in exactly one item of one
    warpgroup, the grid fills at most the card's SMs, and the shares
    differ by one item at most; the kernel's arithmetic is the one
    simulated."""
    text = source("qa_ctx_attention_fwd.cu")
    assert "const int f0 = static_cast<int>(items * wk / nw);" in text
    assert "const int f1 = static_cast<int>(items * (wk + 1) / nw);" in text
    assert "const int k = f - f0, u = f / Li, i = f % Li;" in text
    assert "b = u / T;\n      m0 = (u % T) * TM;" in text
    assert "kern<<<static_cast<int>(ctas < sms ? ctas : sms), S::NT," in text
    bsz = 16
    shares, t, ctas = attention_items(bsz, m, li)
    assert ctas <= SMS
    seen = []
    for items in shares.values():
        for f in items:
            u, i = f // li, f % li
            b, m0 = u // t, (u % t) * 64
            seen += [(b, r, i) for r in range(m0, min(m0 + 64, m))]
    assert sorted(seen) == [(b, r, i) for b in range(bsz) for r in range(m)
                            for i in range(li)]
    counts = [len(v) for v in shares.values()]
    assert max(counts) - min(counts) <= 1
    # a run crosses few (b, tile) units: its cn rows reload only there
    units = [len({f // li for f in v}) for v in shares.values() if v]
    assert max(units) <= -(-max(counts) // li) + 1
    if (m, li) == (200, 50):   # the headline: 3,200 items on 396 warpgroups
        assert ctas == SMS and sum(counts) == 3200
        assert set(counts) == {8, 9}


@pytest.mark.parametrize("m", [200, 7, 64, 65])
def test_the_tail_tile_s_dead_warps_skip_the_row_passes(m):
    """A warp stores raw scores and output rows when one of its 16 rows is
    below M; every live row lies in such a warp."""
    text = source("qa_ctx_attention_fwd.cu")
    assert "wlive = m0 + 16 * warp < M;" in text
    for m0 in range(0, m, 64):
        live = [w for w in range(4) if m0 + 16 * w < m]
        assert all((r - m0) // 16 in live for r in range(m0, min(m0 + 64, m)))


# --------------------------------------------- the tri bridge's schedule
def tri_tiles(rows, sms=SMS):
    """{(block, warpgroup): [tiles]} of the D = 64 kernel (the C entry's
    grid: a tile a warpgroup at most, at most SMs blocks)."""
    nwg = widths.TRI64_WARPGROUPS
    tiles = -(-rows // 64)
    blocks = min(-(-rows // (64 * nwg)), sms)
    return {(b, w): list(range(nwg * b + w, tiles, nwg * blocks))
            for b in range(blocks) for w in range(nwg)}, tiles, blocks


@pytest.mark.parametrize("rows", [1, 39, 64, 65, 160000])
def test_the_tri_tiles_take_each_row_once(rows):
    text = source("tri_bridge_bwd_wide.cu")
    assert "const long long nw = static_cast<long long>(S::NWG) * gridDim.x;" \
        in text
    assert "const long long w0 = static_cast<long long>(S::NWG) * blockIdx.x" \
           " + wg;" in text
    assert "const long long want = (R + Tri64::NWG * TM - 1) / (Tri64::NWG" \
           " * TM);" in text
    walk, tiles, blocks = tri_tiles(rows)
    assert blocks <= SMS
    seen = [r for ts in walk.values() for t in ts
            for r in range(64 * t, min(64 * t + 64, rows))]
    assert sorted(seen) == list(range(rows))
    counts = [len(ts) for ts in walk.values()]
    assert max(counts) - min(counts) <= 1
    assert all(walk[b, 0] for b in range(blocks))   # no block without work
    # the slots a block's partial sums need: the wrapper's vec_part holds
    # one for each block of the grid
    assert blocks <= min(-(-rows // 64), SMS)


# ------------------------------------------------ the wrappers, the entries
def c_params(src, entry):
    text = source(src)
    sig = text[text.index(f'extern "C" int {entry}('):]
    sig = sig[sig.index("(") + 1:sig.index(")")]
    return [p.strip() for p in sig.split(",")]


@pytest.mark.parametrize("src,entry,kernel", [
    ("qa_ctx_attention_fwd.cu", "qa_ctx_attention_fwd",
     qa_ctx_attention.FWD_BY_WIDTH[64]),
    ("tri_bridge_bwd_wide.cu", "tri_bridge_bwd_wide",
     tri_bridge.BWD_BY_WIDTH[64])])
def test_the_c_entries_take_what_the_wrappers_give(src, entry, kernel):
    params = c_params(src, entry)
    assert len(params) == len(kernel.argtypes)
    assert params[-1] == "void* stream"
    for p, t in zip(params, kernel.argtypes):
        assert ("*" in p) == (t.__name__ == "c_void_p"), (p, t)


@pytest.mark.parametrize("raw_mode", ["full", "none", "target"])
@pytest.mark.parametrize("lr", [25, 50])
def test_the_attention_wrapper_at_64_hands_f32_w(monkeypatch, raw_mode, lr):
    """At D = 64 the wrapper hands W in float32 (3D x D: the kernel rounds
    it to bf16 as each CTA loads it, no cast launched) and no slab
    scratch; raw as the mode says."""
    calls = []
    monkeypatch.setattr(qa_ctx_attention, "ptr", lambda t: t)
    monkeypatch.setattr(qa_ctx_attention.FWD_BY_WIDTH[64], "launch",
                        lambda dev, *a, **kw: calls.append(a))
    d, bsz, num_a, lqa, li = 64, 2, 5, 7, 3
    dt = torch.bfloat16
    cn = torch.zeros(bsz, num_a, lqa, d, dtype=dt)
    qn = torch.zeros(bsz, li, lr, d, dtype=dt)
    w = torch.randn(3 * d, d, generator=torch.Generator().manual_seed(2))
    args = (cn, cn, qn, qn, torch.ones(bsz, num_a, lqa),
            torch.ones(bsz, li, lr), torch.ones(3 * d), torch.zeros(3 * d), w, torch.zeros(d),
            torch.zeros(bsz, dtype=torch.int32) if raw_mode == "target"
            else None, 10.0, raw_mode, 0.0, 0, d)
    qa_ctx_attention._QaCtxAttention.forward(type("Ctx", (), {
        "save_for_backward": lambda self, *a: None})(), *args)
    (a,) = calls
    assert a[8].dtype == torch.float32 and torch.equal(a[8], w)
    assert a[13] is None                                  # wp
    raw = a[12]
    if raw_mode == "none":
        assert raw is None
    else:
        assert raw.dtype == torch.float32 and raw.shape[-1] == lr
    assert a[14:20] == (bsz, num_a, lqa, li, lr, d)


@pytest.mark.parametrize("rows", [1, 39, 65])
def test_the_tri_backward_wrapper_at_64_hands_the_block_slots(monkeypatch,
                                                              rows):
    """The bf16 backward at 64 takes W in float32 (the kernel rounds it as
    each block loads it), no W^T, no P / Q rows and no slab scratch; the
    slots of the blocks' partial sums cover the kernel's grid."""
    calls = []
    monkeypatch.setattr(tri_bridge, "ptr", lambda t: t)
    monkeypatch.setattr(tri_bridge, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(tri_bridge, "tc_wgrad_chunks", lambda *a: 3)
    monkeypatch.setattr(tri_bridge.BWD_BY_WIDTH[64], "launch",
                        lambda dev, *a, **kw: calls.append(a))
    d = 64
    s = torch.zeros(rows, d, dtype=torch.bfloat16)
    params = [torch.ones(3 * d), torch.zeros(3 * d), torch.zeros(3 * d, d),
              torch.zeros(d), torch.ones(d), torch.zeros(d)]
    tri_bridge.tri_bridge_backward(s, s, *params, s, 0.0, 0, d)
    (a,) = calls
    assert a[4].dtype == torch.float32 and a[4].shape == (3 * d, d)
    assert a[5] is None                                   # W^T
    yd, gy1, vec_part, wg_part, pq, wp = a[13:19]
    assert yd.shape == (rows, 3 * d) and gy1.shape == (rows, d)
    assert yd.dtype == gy1.dtype == torch.bfloat16
    _, _, blocks = tri_tiles(rows)
    assert vec_part.shape == (min(-(-rows // 64), SMS), 8 * d)
    assert vec_part.shape[0] >= blocks
    assert wg_part.shape == (3, 3 * d + 1, d)
    assert pq is None and wp is None
    assert a[19:22] == (rows, 3, d)


# ----------------------------------------------------- scripts/phase_split
def phase_split():
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "scripts",
                        "phase_split.py")
    spec = importlib.util.spec_from_file_location("phase_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("key", ["TRI64", "ATT_FWD64"])
def test_the_phase_stamps_go_into_a_copy(key):
    """The sources carry no measurement code; each stamp anchor of the new
    designs occurs once in its kernel (each beside the D = 256 kernel of
    its source), and the phases are numbered in full."""
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


def test_the_gone_designs_left_the_script():
    """The stamps of designs no PR's parent holds any more are gone: the
    D = 64 tri bridge backward that took g_yd twice and the attention
    forward's D = 64 instantiation of the D = 128 design (each source
    stamps its own design alone)."""
    ps = phase_split()
    names = set(ps.STAMPS) | set(ps.PHASES) | set(ps.KERNEL_START)
    assert not any("columns split" in n or "W streamed" in n for n in names)
    assert not any("g_yd twice" in n or "resident" in n for n in names)
    assert ps.VARIANTS[ps.TRI64] == (ps.TRI64,)
    assert ps.VARIANTS[ps.ATT_FWD64] == (ps.ATT_FWD64,)
    assert ps.SOURCE_OF_64["tri_bridge"] == ps.TRI64
    assert ps.FWD_SOURCE_OF_64["qa_ctx_attention"] == ps.ATT_FWD64


def test_host_split_takes_the_new_rows():
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "scripts",
                        "host_split.py")
    spec = importlib.util.spec_from_file_location("host_split", path)
    hs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hs)
    assert (64, "qa_ctx_attention") in hs.FWD_CASES
    assert (64, "tri_bridge") in hs.CASES
    assert hs.chosen(hs.CASES, ["--width", "64", "--families",
                                "tri_bridge"]) == [(64, "tri_bridge")]
    assert hs.chosen(hs.FWD_CASES, ["--width", "64", "--families",
                                    "qa_ctx_attention"]) == [
        (64, "qa_ctx_attention")]
