"""The Python side of two bf16 backward kernels, on the CPU: the tri
bridge's at D = 256 (``csrc/tri_bridge_bwd_wide.cu`` ``Tri256``: W rounded
into bf16 slabs that the copy engine brings through a ring) and the
attention's at D = 64 (``csrc/qa_ctx_attention_bwd_wide.cu`` ``AttTc64``:
the tensor-core kernels, the warpgroups on rows of their own).  The shared
memory that ``ops/widths.py`` computes for each layout is the source's
(its ``static constexpr`` offsets evaluated here) and fits an H100 block;
the ring's slots are used again no sooner than the kernel's limit of slabs
in flight allows; the slab scratch holds a tile's slabs; the wrappers'
scratch holds what the kernels address for rows that 64 or 128
does not divide; and the D = 64 attention wrapper hands bf16 to the
tensor-core entry."""
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
        expr = (m.group(2).replace("tc::", "").replace("Shapes<D>::", "SH_")
                .replace("/", "//"))
        vals[m.group(1)] = eval(expr, {"__builtins__": {}},   # noqa: S307
                                {**vals, "SH_TILE_BYTES":
                                 vals.get("D", 0) // 64 * ENV["TILE_PANEL"]})
    return vals


# ------------------------------------------------- the tri bridge at 256
def tri_slot(s, k):
    """``Tri256::slot`` (the source's expression, held below)."""
    return s % k["RING"] if s < k["NY1"] else \
        (7 + (s - k["NY1"]) % k["RING"]) % k["NSLOT"]


def test_the_tri_bridge_layout_at_256_is_the_source_s_and_fits():
    k = struct_constants("tri_bridge_bwd_wide.cu", "Tri256")
    assert k["D"] == 256
    assert k["SMEM"] == widths.bwd_smem_bytes("tri_bridge", 256) \
        <= widths.SMEM_LIMIT
    assert (k["NSLOT"], k["RING"], k["AHEAD"], k["SLAB"]) == (
        widths.TRI256_SLOTS, widths.TRI256_RING, widths.TRI256_AHEAD,
        widths.TRI256_SLAB)
    assert k["RING"] >= 3 and k["SLAB"] == 16384 == 32 * 256 * 2
    assert k["PER_TILE"] == 2 * k["NY1"] == 48
    # three slots of their own; four where s and v lie; four in yd's room
    # past the g_y1 tile (a tile, 64 x 256 bf16)
    assert k["O_BAR"] - k["O_OWN"] == 3 * k["SLAB"]
    assert k["O_X"] - k["O_S"] == 4 * k["SLAB"] == 2 * k["TILE"]
    assert 3 * k["TILE"] - k["TILE"] == 4 * k["SLAB"]
    for off in ("O_S", "O_V", "O_X", "O_OWN"):
        assert k[off] % 1024 == 0
    assert k["O_EX"] - k["O_BAR"] >= 2 * k["NSLOT"] * 8     # the barriers


def test_the_tri_ring_schedule_leaves_room_for_the_slabs_in_flight():
    """The kernel hands slab j out once warp 0 has released slab j - AHEAD
    (its products done): that is safe only if no slot is used again sooner
    than AHEAD slabs later.  y1's slabs use the kernel's own slots and the
    s / v room (dead during y1), g_yd's the own slots and yd's room past
    g_y1 (dead during g_yd)."""
    text = source("tri_bridge_bwd_wide.cu")
    assert ("return s < NY1 ? s % RING : (7 + (s - NY1) % RING) % NSLOT;"
            in text)
    k = struct_constants("tri_bridge_bwd_wide.cu", "Tri256")
    last = {}
    for j in range(4 * k["PER_TILE"]):
        s = j % k["PER_TILE"]
        slot = tri_slot(s, k)
        if s < k["NY1"]:
            assert slot < 7                    # own, then s and v's room
        else:
            assert slot < 3 or slot >= 7       # own, then yd's room
        if slot in last:
            assert j - last[slot] >= k["AHEAD"], (j, slot)
        last[slot] = j
    assert sorted(last) == list(range(k["NSLOT"]))
    # a tile's first slabs (own slots) may come in during the last tile
    assert [tri_slot(s, k) for s in range(3)] == [0, 1, 2]


def test_the_tri_slab_scratch_holds_a_tile_s_slabs():
    """The wrapper's wp scratch (W in bf16, twice) is the bytes of the
    slabs a tile reads, which the kernel packs it into: y1's stages hold W
    once, g_yd's slabs once more."""
    k = struct_constants("tri_bridge_bwd_wide.cu", "Tri256")
    (shape, dt) = tri_bridge.wide_backward_scratch(100, 256, torch.bfloat16,
                                                   1, 132)[5]
    nbytes = torch.Size(shape).numel() * dt.itemsize
    assert nbytes == k["PER_TILE"] * k["SLAB"] == 2 * k["NY1"] * k["SLAB"]
    assert k["NY1"] * k["SLAB"] == 3 * 256 * 256 * 2


@pytest.mark.parametrize("rows", [1, 65, 129, 1000, 3201])
@pytest.mark.parametrize("d", [64, 256])
def test_the_tri_wrapper_s_scratch(rows, d):
    """At 256 the bf16 kernel keeps each row's P and Q in a float32 row of
    2D (rows it walks in 64-row tiles: the last tile's dead rows are not
    written); its parameter sums go to a slot a block of at most one a
    tile; the yd and g_y1 rows are bf16."""
    got = tri_bridge.wide_backward_scratch(rows, d, torch.bfloat16, 7, 132)
    assert got[:2] == [((rows, 3 * d), torch.bfloat16),
                       ((rows, d), torch.bfloat16)]
    assert got[2] == ((min(-(-rows // 64), 132), 8 * d), torch.float32)
    assert got[3] == ((7, 3 * d + 1, d), torch.float32)
    assert got[4:] == ([((rows, 2 * d), torch.float32),
                        ((2, 3 * d, d), torch.bfloat16)] if d == 256
                       else [None, None])
    f32 = tri_bridge.wide_backward_scratch(rows, d, torch.float32, 7, 132)
    assert f32[2] == ((-(-rows // (16 if d == 256 else 32)), 9 * d),
                      torch.float32)
    assert f32[4:] == [None, None]


def recording(monkeypatch, module, kernel):
    """Record ``kernel``'s launch arguments as tensors (``module.ptr`` made
    the identity) instead of launching."""
    calls = []
    monkeypatch.setattr(module, "ptr", lambda t: t)
    monkeypatch.setattr(kernel, "launch",
                        lambda dev, *a, **kw: calls.append(a))
    return calls


def test_the_tri_wrapper_hands_w_and_the_slab_scratch_at_256(monkeypatch):
    calls = recording(monkeypatch, tri_bridge, tri_bridge.BWD_BY_WIDTH[256])
    monkeypatch.setattr(tri_bridge, "sm_count", lambda dev: 132)
    gen = torch.Generator().manual_seed(1)
    rows, d = 130, 256
    s, v, g = (torch.randn(rows, d, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    w = torch.randn(3 * d, d, generator=gen)
    ones = torch.ones(3 * d)
    tri_bridge._backward_wide(s, v, ones, ones * 0, w, ones[:d], ones[:d],
                              g, torch.empty_like(s), torch.empty_like(v),
                              0.1, torch.zeros(2, dtype=torch.long), d)
    (a,) = calls
    assert a[4] is w and a[5] is None          # the kernel rounds W
    assert a[17].shape == (rows, 2 * d) and a[17].dtype == torch.float32
    assert a[18].shape == (2, 3 * d, d) and a[18].dtype == torch.bfloat16
    assert a[19:22] == (rows, a[20], d) and a[-1] == 1    # is_bf16


# --------------------------------------------------- the attention at 64
@pytest.mark.parametrize("lrp,lr", [(32, 1), (32, 25), (64, 50), (64, 64)])
def test_the_attention_layout_at_64_is_the_source_s_and_fits(lrp, lr):
    k = struct_constants("qa_ctx_attention_bwd_wide.cu", "AttTc64", LRP=lrp)
    assert k["D"] == 64
    assert k["SMEM"] == widths.bwd_smem_bytes("qa_ctx_attention", 64,
                                              lr=lr) <= widths.SMEM_LIMIT
    # W, 3D rows of 64 bf16, resident; two rooms on atoms
    assert k["W"] == 3 * 64 * 128 and k["O_ROOM"] % 1024 == 0
    assert k["ROOM"] % 1024 == 0
    assert k["R_QM"] - k["R_P0"] == lrp // 2 * 128 * 4   # p0, a thread's
    assert k["ROOM"] >= k["R_QM"] + 64 * 4
    for off in ("R_QN", "R_QE", "R_CN", "R_CE", "R_GO"):
        assert k[off] % 1024 == 0
    # the block's sums of eight warps over the two rooms at the end
    assert 8 * 6 * 64 * 4 <= 2 * k["ROOM"]


@pytest.mark.parametrize("lr", [1, 25, 32, 33, 50, 64])
@pytest.mark.parametrize("m", [200, 65, 7])
def test_the_attention_wrapper_s_scratch_at_64(lr, m):
    """The tensor-core kernels at 64 write their g_s and p rows LRP wide in
    bf16 and a slot of parameter sums for each block of their persistent
    grid (two warpgroups a block, one 64-row tile each: at most one slot
    a tile)."""
    bsz, li, d = 2, 3, 64
    got = qa_ctx_attention.wide_backward_scratch(bsz, li, m, lr, d,
                                                 torch.bfloat16, 5)
    rows, lrp = bsz * li * m, 32 if lr <= 32 else 64
    assert got[0] == got[1] == ((bsz, li, m, d), torch.float32)
    assert got[2:4] == [((rows, 3 * d), torch.bfloat16),
                        ((rows, d), torch.bfloat16)]
    assert got[4] == ((bsz * li * -(-m // 64), 6 * d), torch.float32)
    assert got[6:] == [((rows, lrp), torch.bfloat16)] * 2 + [
        ((rows, d), torch.bfloat16)]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_the_attention_wrapper_routes_d64(monkeypatch, dt):
    """bf16 goes to the tensor-core entry (is_bf16, W itself in bf16, the
    bf16 row scratch); float32 to the CUDA-core one (W^T, float32 rows)."""
    calls = recording(monkeypatch, qa_ctx_attention,
                      qa_ctx_attention.BWD_BY_WIDTH[64])
    gen = torch.Generator().manual_seed(2)
    b, a, lqa, li, lr, d = 2, 5, 4, 3, 25, 64
    cn, ce = (torch.randn(b, a, lqa, d, generator=gen).to(dt)
              for _ in range(2))
    qn, qe = (torch.randn(b, li, lr, d, generator=gen).to(dt)
              for _ in range(2))
    mixed = torch.randn(b, a, li, lqa, d, generator=gen).to(dt)
    w = torch.randn(3 * d, d, generator=gen)
    qa_ctx_attention._backward_wide(
        cn, ce, qn, qe, torch.ones(b, a, lqa), torch.ones(b, li, lr),
        torch.ones(3 * d), torch.zeros(3 * d), w, mixed, None, None, mixed,
        10.0, 0.1, torch.zeros(2, dtype=torch.long), d)
    (args,) = calls
    assert args[-1] == int(dt == torch.bfloat16)
    if dt == torch.bfloat16:
        assert torch.equal(args[8], w.to(dt))
        assert args[25].dtype == torch.bfloat16 and args[25].shape[1] == 32
    else:
        assert torch.equal(args[8], w.t().contiguous())
        assert args[25].dtype == torch.float32 and args[25].shape[1] == 28


def test_chip_smoke_reads_the_d64_backwards_from_a_trace():
    """A train step at hsz 64 shows the attention's tensor-core backward
    and gq kernels (the CUDA-core bf16 ones are gone), the tri bridge's
    backward and the forwards of their own D = 64 designs."""
    import chip_smoke
    ns = "void (anonymous namespace)::"
    names = {f"{ns}encoder_fwd_tc64_kernel<5, true>(x)": 1,
             f"{ns}tri_bridge_fwd_tc64_kernel<true>(x)": 1,
             f"{ns}qa_ctx_fwd_tc64_kernel<32, true>(x)": 1,
             f"{ns}qa_ctx_fwd_tc64_kernel<64, true>(x)": 1,
             f"{ns}qa_ctx_bwd_tc64_kernel<32>(x)": 1,
             f"{ns}qa_ctx_bwd_tc64_kernel<64>(x)": 1,
             f"{ns}qa_ctx_gq_tc64_kernel(x)": 2,
             f"{ns}tri_bridge_bwd_tc64_kernel(x)": 1,
             f"{ns}encoder_bwd_tc64_kernel<5>(x)": 1,
             "void tvqa::wgrad_tc_kernel<64>(x)": 4}
    got = chip_smoke.check_wide_train_trace("train", names, False, 64)
    assert "qa_ctx_gq_tc64_kernel" in got
    old = {k: v for k, v in names.items() if "tc64" not in k}
    old[f"{ns}qa_ctx_bwd_wide_kernel<__nv_bfloat16, 64, 4>(x)"] = 1
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.check_wide_train_trace("train", old, False, 64)


@pytest.mark.parametrize("name", ["no yd rows", "no PQ rows", "no keep bits",
                                  "no W copies"])
def test_each_tri_ablation_edits_the_tri_bridge_kernel_once(name):
    """``scripts/phase_split.py --ablations`` takes one part out of the D =
    256 kernel in a copy: each edit's text occurs once in that kernel, and
    nothing outside the kernel changes."""
    import importlib.util
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "scripts",
                        "phase_split.py")
    spec = importlib.util.spec_from_file_location("phase_split", path)
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)
    src = "tri_bridge_bwd_wide.cu"
    text = source(src)
    out = ps.edit_kernel(text, src, ps.TRI_ABLATIONS[name])
    assert out != text
    i0, i1 = ps.kernel_span(text, src)
    assert out[:i0] == text[:i0] and out.endswith(text[i1:])
