"""The Python side of the bf16 encoder and tri bridge forwards at D = 64
(``csrc/encoder_fwd.cu`` ``EncFwd64`` and ``csrc/tri_bridge_fwd.cu``
``TriFwd64``: blocks of four and of three warpgroups, each on 64-row tiles
of its own at all 64 columns), on the CPU: the shared memory that
``ops/widths.py`` computes for each layout is the source's (its ``static
constexpr`` offsets evaluated here) and fits an H100 block; the encoder's
tile schedule takes every sequence once and the tri bridge's every row
once; the encoder's
masked max from registers (a segmented suffix max over a warp's rows by
shuffles, then a sequence's pieces), simulated here, gives each sequence's
max; the wrappers' arguments and the C entries' signatures; the D = 128
designs' instantiations at D = 64 are gone; ``scripts/phase_split.py``
stamps the new kernels and, run from a parent tree, the designs they
replaced (which the D = 128 kernels keep)."""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from tvqaplus_tpu_torch.ops import encoder, tri_bridge, widths

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(encoder.__file__))), "csrc")
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
        expr = m.group(2).replace("tc::", "").replace("/", "//")
        vals[m.group(1)] = eval(expr, {"__builtins__": {}}, vals)  # noqa: S307
    return vals


def kernel_text(src, start):
    """The kernel of ``src`` that begins at ``start``, to its closing
    brace."""
    text = source(src)
    i0 = text.index(start)
    return text[i0:text.index("\n}\n", i0)]


# ------------------------------------------------------------ the layouts
def test_the_encoder_forward_layout_at_64_is_the_source_s_and_fits():
    s = struct_constants("encoder_fwd.cu", "EncFwd64")
    assert s["D"] == 64 and s["NWG"] == widths.ENC64_FWD_WARPGROUPS == 4
    assert s["NT"] == 128 * s["NWG"]
    assert s["SMEM"] == widths.tc_smem_bytes("encoder", 64) \
        <= widths.SMEM_LIMIT
    # pw0 and pw1 resident in bf16: a panel of 64 rows each
    assert s["O_ROOM"] - s["O_PW"] == 2 * 64 * 128
    # a room a warpgroup: C and X (64 x 64 bf16), R1 and H (64 x 64
    # float32), v and m of both parities
    assert s["R_X"] - s["R_C"] == s["R_R1"] - s["R_X"] == 64 * 64 * 2
    assert s["R_H"] - s["R_R1"] == s["R_VM"] - s["R_H"] == 64 * 64 * 4
    assert s["ROOM"] - s["R_VM"] >= 2 * 2 * 64 * 4
    for off in (s["O_ROOM"], s["ROOM"], s["R_C"], s["R_X"]):
        assert off % 1024 == 0
    # the output tile (64 x 64 bf16) is staged in C
    assert s["R_X"] - s["R_C"] >= 64 * 64 * 2


def test_the_tri_forward_layout_at_64_is_the_source_s_and_fits():
    s = struct_constants("tri_bridge_fwd.cu", "TriFwd64")
    assert s["D"] == 64 and s["NWG"] == widths.TRI64_FWD_WARPGROUPS == 3
    assert s["NT"] == 128 * s["NWG"]
    assert s["SMEM"] == widths.tc_smem_bytes("tri_bridge", 64) \
        <= widths.SMEM_LIMIT
    # W once in bf16 (3D rows of D), then gin, bin, bias, gout, bout
    assert s["O_PV"] - s["O_W"] == 3 * 64 * 64 * 2
    assert s["O_ROOM"] - s["O_PV"] >= 9 * 64 * 4
    # a room a warpgroup: two slots of a tile's s and v, on atoms
    assert s["SLOT"] == 2 * 64 * 64 * 2 and s["ROOM"] == 2 * s["SLOT"]
    for off in (s["O_ROOM"], s["ROOM"], s["SLOT"], s["TILE"]):
        assert off % 1024 == 0


@pytest.mark.parametrize("length", [1, 5, 40, 50, 56])
def test_every_encoder_length_fits_a_64_row_tile(length):
    """A tile holds 64 // L whole sequences; the C entry refuses L past
    64 (the wrappers, past 56)."""
    nseq = 64 // length
    assert 1 <= nseq and nseq * length <= 64
    text = source("encoder_fwd.cu")
    assert "if (L > (D == 128 ? TR : TM)) return" in text


# -------------------------------------------- the encoder's tile schedule
def encoder_walk(n, length, sms=SMS):
    """{(block, warpgroup): [tiles]} of the D = 64 kernel (the C entry's
    grid, the kernel's walk) and the tiles' count."""
    nwg = widths.ENC64_FWD_WARPGROUPS
    nseq = 64 // length
    tiles = -(-n // nseq)
    blocks = min(-(-tiles // nwg), sms)
    return {(b, w): list(range(nwg * b + w, tiles, nwg * blocks))
            for b in range(blocks) for w in range(nwg)}, tiles, blocks


@pytest.mark.parametrize("n,length,k", [(4000, 40, 5), (1680, 50, 7),
                                        (7, 25, 3), (7, 5, 1), (200, 56, 9)])
def test_the_encoder_tiles_take_each_sequence_once(n, length, k):
    """Every sequence lies in one tile of one warpgroup, whole; the grid
    fills at most the card's SMs and every block has work; the walks differ
    by one tile at most.  The kernel's and the C entry's arithmetic is the
    one simulated."""
    text = source("encoder_fwd.cu")
    assert "const int nw = S::NWG * gridDim.x, w0 = S::NWG * blockIdx.x " \
           "+ wg;" in text
    assert "for (int tile = w0; tile < tiles; tile += nw, par ^= 1) {" in text
    assert "const int nseq = TM / L, tiles = (N + nseq - 1) / nseq;\n" \
           "    const int want = (tiles + S::NWG - 1) / S::NWG;" in text
    assert "kern<<<want < sms ? want : sms, S::NT, S::SMEM, stream>>>(" \
        in text
    walk, tiles, blocks = encoder_walk(n, length)
    nseq = 64 // length
    assert blocks <= SMS
    seen = [s for ts in walk.values() for t in ts
            for s in range(t * nseq, min(t * nseq + nseq, n))]
    assert sorted(seen) == list(range(n))
    counts = [len(ts) for ts in walk.values()]
    assert max(counts) - min(counts) <= 1
    assert all(walk[b, 0] for b in range(blocks))
    if (n, length) == (4000, 40):      # the cls_encoder: 4,000 tiles
        assert blocks == SMS and set(counts) == {7, 8}


def masked_max(vals, rows, length):
    """The kernel's masked max of a tile (``vals``: 64 rows x columns of
    masked values, rows past ``rows`` garbage) by its steps: a segmented
    suffix max over each warp's row halves (lanes g + o, o = 1, 2, 4), half
    0's rows joining half 1's first row, the first row of each sequence's
    rows in a warp written to H, then a sequence's pieces at its first row
    and at each later warp's first row."""
    val = vals.copy()
    h_s = np.full_like(vals, np.nan)
    for warp in range(4):
        if 16 * warp >= rows:
            continue                           # a dead warp skips
        row = np.array([[16 * warp + g + 8 * h for h in (0, 1)]
                        for g in range(8)])    # [g][h]
        lrow = row % length
        last = np.minimum(row - lrow + length, rows) - 1
        valid = row < rows
        v = val[row]                           # [g][h][cols]
        for o in (1, 2, 4):
            shifted = np.concatenate([v[o:], v[:o]])  # lane g + o's value
            take = (np.arange(8)[:, None] + o < 8) & (row + o <= last)
            v = np.where(take[..., None], np.maximum(v, shifted), v)
        join = 16 * warp + 8 <= last[:, 0]
        v[:, 0] = np.where(join[:, None], np.maximum(v[:, 0], v[0, 1]),
                           v[:, 0])
        for g in range(8):
            for h in (0, 1):
                head = valid[g, h] and (lrow[g, h] == 0
                                        or (h == 0 and g == 0))
                if head:
                    h_s[row[g, h]] = v[g, h]
    out = []
    for sq in range(rows // length):
        first = sq * length
        mx = h_s[first].copy()
        for r in range((first // 16 + 1) * 16, first + length, 16):
            mx = np.maximum(mx, h_s[r])
        out.append(mx)
    return np.stack(out)


@pytest.mark.parametrize("length", list(range(1, 57)))
def test_the_masked_max_from_registers_is_each_sequence_s_max(length):
    """For every L the kernel takes, with full and ragged tiles, the
    simulated steps give each sequence's max over its rows and never read
    a row past the tile's sequences (they hold NaN here), nor a piece no
    warp wrote."""
    rng = np.random.default_rng(length)
    nseq = 64 // length
    for seqs in {nseq, max(1, nseq - 1), 1}:
        rows = seqs * length
        vals = rng.standard_normal((64, 8)).astype(np.float32)
        vals[rows:] = np.nan
        got = masked_max(vals, rows, length)
        want = vals[:rows].reshape(seqs, length, 8).max(1)
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(got, want)


def test_the_masked_max_steps_are_the_kernel_s():
    """The simulated steps are the ones the kernel takes."""
    text = kernel_text("encoder_fwd.cu", "  using S = EncFwd64;\n")
    for line in (
            "last[h] = min(row[h] - lrow[h] + L, rows) - 1;",
            "for (int o = 1; o < 8; o <<= 1) {",
            "__shfl_down_sync(0xffffffffu, val[j], 4 * o);",
            "if (g8 + o < 8 && row[h] + o <= last[h]) val[j] = fmaxf(val[j], "
            "p);",
            "const bool join = 16 * warp + 8 <= last[0];",
            "__shfl_sync(0xffffffffu, val[j + 2 + e], lane & 3);",
            "if (!valid[h] || (lrow[h] != 0 && (h == 1 || g8 != 0))) "
            "continue;",
            "for (int r = (first / 16 + 1) * 16; r < first + L; r += 16)"):
        assert line in text, line
    # the masked value is the TPU kernel's o m + (m - 1) 1e10
    assert "val[2 * pr] = o.x * m + (m - 1.f) * 1e10f;" in text


# --------------------------------------------- the tri bridge's schedule
def tri_walk(rows, sms=SMS):
    nwg = widths.TRI64_FWD_WARPGROUPS
    tiles = -(-rows // 64)
    blocks = min(-(-rows // (64 * nwg)), sms)
    return {(b, w): list(range(nwg * b + w, tiles, nwg * blocks))
            for b in range(blocks) for w in range(nwg)}, tiles, blocks


@pytest.mark.parametrize("rows", [1, 39, 64, 65, 160000])
def test_the_tri_tiles_take_each_row_once(rows):
    text = source("tri_bridge_fwd.cu")
    kern = kernel_text("tri_bridge_fwd.cu", "  using S = TriFwd64;\n")
    assert "const long long nw = static_cast<long long>(S::NWG) * gridDim.x;" \
        in kern
    assert "const long long w0 = static_cast<long long>(S::NWG) * blockIdx.x" \
           " + wg;" in kern
    assert "const long long want = (R + S::NWG * TM - 1) / (S::NWG * TM);" \
        in text
    walk, tiles, blocks = tri_walk(rows)
    assert blocks <= SMS
    seen = [r for ts in walk.values() for t in ts
            for r in range(64 * t, min(64 * t + 64, rows))]
    assert sorted(seen) == list(range(rows))
    counts = [len(ts) for ts in walk.values()]
    assert max(counts) - min(counts) <= 1
    assert all(walk[b, 0] for b in range(blocks))


def test_each_tri_warp_moves_its_own_rows():
    """A warp copies, stages and stores only its 16 rows, so a tile takes
    no barrier: the copy's rows, the staging's and the stores' are the
    warp's."""
    kern = kernel_text("tri_bridge_fwd.cu", "  using S = TriFwd64;\n")
    assert "bar_sync" not in kern and kern.count("__syncthreads()") == 1
    assert "for (int c = lane; c < 2 * 16 * 8; c += 32) {" in kern
    assert "r = 16 * warp + ((c >> 3) & 15)" in kern
    assert "const int r = 16 * warp + (q >> 3), ch = q & 7;" in kern
    # the copy's chunks c: s (c < 128) and v, 16 rows of 8 chunks each
    assert {((c >> 3) & 15, c & 7, c >> 7) for c in range(2 * 16 * 8)} == {
        (r, ch, which) for r in range(16) for ch in range(8)
        for which in (0, 1)}


# ------------------------------------------------ the wrappers, the entries
def c_params(src, entry):
    text = source(src)
    sig = text[text.index(f'extern "C" int {entry}('):]
    sig = sig[sig.index("(") + 1:sig.index(")")]
    return [p.strip() for p in sig.split(",")]


@pytest.mark.parametrize("src,entry,kernel", [
    ("encoder_fwd.cu", "encoder_reduce_fwd", encoder.FWD_BY_WIDTH[64]),
    ("encoder_fwd.cu", "encoder_block_fwd", encoder.BLOCK_BY_WIDTH[64]),
    ("tri_bridge_fwd.cu", "tri_bridge_fwd", tri_bridge.FWD_BY_WIDTH[64])])
def test_the_c_entries_take_what_the_wrappers_give(src, entry, kernel):
    params = c_params(src, entry)
    assert len(params) == len(kernel.argtypes)
    assert params[-1] == "void* stream" and "void* wp" in params
    for p, t in zip(params, kernel.argtypes):
        assert ("*" in p) == (t.__name__ == "c_void_p"), (p, t)


class Ctx:
    def save_for_backward(self, *a):
        pass


def recording(monkeypatch, mod, kernel):
    calls = []
    monkeypatch.setattr(mod, "ptr", lambda t: t)
    monkeypatch.setattr(kernel, "launch",
                        lambda dev, *a, **kw: calls.append((a, kw)))
    return calls


@pytest.mark.parametrize("dv", [64, 60, 32, 4])
@pytest.mark.parametrize("full", [False, True])
def test_the_encoder_wrappers_at_64_hand_no_scratch(monkeypatch, full, dv):
    """At D = 64 (and the widths padded into it) the bf16 forward gets the
    float32 packed parameters (pw0 and pw1 among them, which each block
    rounds as it loads them), no slab scratch and its true width."""
    d, b, g, length, k = 64, 2, 7, 40, 5
    table = encoder.BLOCK_BY_WIDTH if full else encoder.FWD_BY_WIDTH
    calls = recording(monkeypatch, encoder, table[d])
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(b, g, length, dv, generator=gen).to(torch.bfloat16)
    pe = torch.randn(length, dv, generator=gen)
    shapes = {"dw0": (k, dv), "dw1": (k, dv), "pw0": (dv, dv),
              "pw1": (dv, dv)}
    params = {key: torch.randn(*shapes.get(key, (dv,)), generator=gen)
              for key in encoder.PARAM_KEYS}
    x, pe, params = encoder.pad_inputs(x, pe, params, d)
    packed = encoder.pack_params(params)
    seed = torch.zeros(2, dtype=torch.long)
    if full:
        encoder._EncoderBlock.forward(Ctx(), x, pe, packed, None, k, 0.1,
                                      seed, dv, None)
    else:
        encoder._EncoderReduce.forward(Ctx(), x, pe, packed,
                                       torch.ones(b, g, length), k, 0.1,
                                       seed, dv)
    ((a, kw),) = calls
    assert kw == {"dv": dv}
    assert a[2].dtype == torch.float32 and a[2].shape == packed.shape
    assert a[5] is None                                   # wp
    dims = (b * g, g, length, k, d) if full else (b * g, length, k, d)
    assert a[6:6 + len(dims)] == dims
    assert a[-1] == 1


@pytest.mark.parametrize("rows", [1, 39, 65])
@pytest.mark.parametrize("dv", [64, 60, 4])
def test_the_tri_wrapper_at_64_hands_float32_w_and_no_scratch(monkeypatch,
                                                              rows, dv):
    """At D = 64 the bf16 forward gets W in float32 (each block rounds it
    as it loads it), no slab scratch, the rows and its true width."""
    d = 64
    calls = recording(monkeypatch, tri_bridge, tri_bridge.FWD_BY_WIDTH[d])
    s = torch.zeros(rows, dv, dtype=torch.bfloat16)
    params = [torch.ones(3 * dv), torch.zeros(3 * dv), torch.zeros(3 * dv, dv),
              torch.zeros(dv), torch.ones(dv), torch.zeros(dv)]
    s, v, params = tri_bridge.pad_inputs(s, s, params, d)
    tri_bridge._TriBridge.forward(Ctx(), s, v, *params, 0.1,
                                  torch.zeros(2, dtype=torch.long), dv)
    ((a, kw),) = calls
    assert kw == {"dv": dv}
    assert a[4].dtype == torch.float32 and a[4].shape == (3 * d, d)
    assert a[5] is None                                   # wp
    assert a[10:12] == (rows, d)
    assert a[-1] == 1


def test_the_old_d64_forward_instantiations_are_gone():
    """The encoder's and the tri bridge's D = 128 designs take D = 128
    alone; the D = 64 launches go to the new kernels; the transposed W that
    only the old tri bridge forward at 64 read is gone."""
    enc = source("encoder_fwd.cu")
    assert 'static_assert(D == 128, "D = 64 and 256 have designs of their ' \
           'own");' in enc
    launch = enc[enc.index("int launch_tc_k("):]
    launch = launch[:launch.index("\n}\n")]
    assert "} else if constexpr (D == 64) {" in launch
    assert "encoder_fwd_tc64_kernel<K, true>" in launch
    assert "encoder_fwd_tc64_kernel<K, false>" in launch
    tri = source("tri_bridge_fwd.cu")
    assert tri.count('static_assert(D == 128, "D = 64 and 256 have designs '
                     'of their own");') == 1
    assert "tri_bridge_fwd_tc64_kernel<true>" in tri
    assert "tri_bridge_fwd_tc64_kernel<false>" in tri
    assert "else if constexpr (D == 64)\n      return launch_tc64(" in tri
    for name in os.listdir(CSRC):
        assert "tri_store_wt" not in source(name)
    assert 'static_assert(D == 128, "W is resident at D = 128");' in source(
        "tri_bridge_tc.cuh")


def test_the_serving_instantiations_hold_no_philox_code():
    """DROP false: the keep bits are drawn only under DROP."""
    enc = kernel_text("encoder_fwd.cu", "  using S = EncFwd64;\n")
    assert "if (DROP) drop.load_seed();" in enc
    assert "if (DROP && wlive)\n      tc_keep_bits<" in enc
    assert enc.count("tc_keep_bits<") == 1
    tri = kernel_text("tri_bridge_fwd.cu", "  using S = TriFwd64;\n")
    assert "if (DROP) drop.load_seed();" in tri
    assert tri.count("tc_keep_bits<") == 1
    assert tri.index("if constexpr (DROP) {") < tri.index("tc_keep_bits<")


# ----------------------------------------------------- scripts/phase_split
def phase_split():
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "scripts",
                        "phase_split.py")
    spec = importlib.util.spec_from_file_location("phase_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("key", ["ENC_FWD64", "TRI_FWD64"])
def test_the_new_stamps_go_into_a_copy(key):
    """The sources carry no measurement code; each stamp anchor of the new
    kernels occurs once in its kernel, and the phases are numbered in
    full; the --forward --width 64 cases take them."""
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
    family = "tri_bridge" if key == "TRI_FWD64" else "encoder"
    assert ps.FWD_SOURCE_OF_64[family] == src


@pytest.mark.parametrize("key,parent", [("ENC_FWD64", "ENC_FWD64_SHARED"),
                                        ("TRI_FWD64", "TRI_FWD64_SHARED")])
def test_the_parents_designs_keep_their_stamps(key, parent):
    """Run from the parent tree, the script stamps the parent's D = 64
    kernels: their designs, the D = 128 kernels', are the variants after
    the new ones, and their stamps go into the D = 128 kernels that this
    tree keeps."""
    ps = phase_split()
    src, old = getattr(ps, key), getattr(ps, parent)
    assert ps.VARIANTS[src] == (src, old)
    text = source(ps.source_file(src))
    assert ps.KERNEL_START[old] in text
    out = ps.stamped(text, old)
    i0, i1 = ps.kernel_span(out, old)
    marks = re.findall(r"TVQA_PHASE(?:_INIT|\((\d+)\))", out[i0:i1])
    assert len(marks) == len(ps.STAMPS[old]) == out.count("TVQA_PHASE")
    assert {int(m) for m in marks[1:]} == set(range(len(ps.PHASES[old])))
    # the parent's text (its D = 64 kernel is the D = 128 one) picks it
    parent_text = text.replace(ps.KERNEL_START[src], "")
    assert ps.variant(parent_text, src) == old


@pytest.mark.parametrize("key,name", [
    ("ENC_FWD64", n) for n in ("three warpgroups", "conv two threads a column",
                               "conv unrolled 4x", "max fast path",
                               "keep bits inline")] + [
    ("TRI_FWD64", n) for n in ("four warpgroups", "keep bits inline")])
def test_each_d64_forward_variant_edits_its_source_once(key, name):
    """``scripts/phase_split.py --forward --width 64 --ablations`` builds
    each design variant in a copy: every edit's text occurs once (in the
    kernel, or in the whole source for a layout's), and the copy differs
    from the source."""
    ps = phase_split()
    src = getattr(ps, key)
    text = source(ps.source_file(src))
    out = ps.edit_kernel(text, src, ps.FWD_ABLATIONS[src][name])
    assert out != text
    whole = any(o.startswith(ps.WHOLE) for o, _ in ps.FWD_ABLATIONS[src][name])
    i0, i1 = ps.kernel_span(text, src)
    if not whole:
        assert out[:i0] == text[:i0]
