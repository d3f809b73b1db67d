"""The Python side of the bf16 forwards of the encoder and the attention at
D = 256 (``csrc/encoder_fwd.cu`` ``EncWide``,
``csrc/qa_ctx_attention_fwd.cu`` ``AttnWide``), on the CPU: the shared
memory that ``ops/widths.py`` computes for each layout is the source's
(its ``static constexpr`` offsets evaluated here) and fits an H100 block;
the ring (``csrc/wgmma.cuh`` ``SlabRing``: CTA 0 of a pair copies every
slab into both CTAs once both have given the slot back and CTA 1 has
armed its barrier) runs its slot schedule over several tiles without a
slot written while it is read, at most NSLOT slabs out at a time, and the
encoder's next product's first slabs in flight during this one; the
packed slabs lie as the products
read them; the slab scratch holds a call's slabs; the wrappers hand the
C entries float32 W and the scratch at D = 256 and 200; the C entries take
the arguments the wrappers give; ``scripts/phase_split.py --forward``
stamps and ablates the two kernels."""
import os
import random
import re

import pytest
import torch

from tvqaplus_tpu_torch.ops import encoder, qa_ctx_attention, widths

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(encoder.__file__))), "csrc")
# the device constants the layouts name (csrc/wgmma.cuh, common.cuh)
ENV = {"TM": 64, "TILE_PANEL": 64 * 128, "ATOM_BYTES": 1024, "NWARPS": 8,
       "NTHREADS": 256, "WD": 256, "SLAB_ROWS": 32, "SLAB_BYTES": 16384}
SOURCES = {"encoder": ("encoder_fwd.cu", "EncWide"),
           "qa_ctx_attention": ("qa_ctx_attention_fwd.cu", "AttnWide")}


def source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def struct_constants(family):
    """The ``static constexpr int`` members of the family's struct,
    evaluated in order."""
    src, name = SOURCES[family]
    text = source(src)
    body = text[text.index(f"struct {name} {{"):]
    body = body[:body.index("\n};")]
    vals = dict(ENV)
    for m in re.finditer(r"static constexpr int (\w+) = ([^;]+);", body):
        expr = (m.group(2).replace("tc::", "")
                .replace("Shapes<WD>::TILE_BYTES", "(4 * TILE_PANEL)")
                .replace("/", "//"))
        vals[m.group(1)] = eval(expr, {"__builtins__": {}}, vals)  # noqa: S307
    return vals


def wgmma_constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", source("wgmma.cuh"))
    return eval(m.group(1).replace("tc::", ""),  # noqa: S307
                {"__builtins__": {}}, {"SLAB_ROWS": 32, "ROW_BYTES": 128})


# ------------------------------------------------------------ the layouts
@pytest.mark.parametrize("family", ["encoder", "qa_ctx_attention"])
def test_the_layout_at_256_is_the_source_s_and_fits(family):
    k = struct_constants(family)
    assert k["SMEM"] == widths.tc_smem_bytes(family, 256) \
        <= widths.SMEM_LIMIT
    slots = {"encoder": widths.ENC256_FWD_SLOTS,
             "qa_ctx_attention": widths.ATT256_FWD_SLOTS}[family]
    assert k["NSLOT"] == slots >= 4
    # a tile's slabs: W in 32-row slabs, pw0 and pw1 (2 D rows) or W (3 D)
    assert k["PER"] == {"encoder": 2, "qa_ctx_attention": 3}[family] * 8
    assert (wgmma_constant("SLAB_ROWS"), wgmma_constant("SLAB_BYTES")) == (
        widths.SLAB_ROWS, widths.SLAB_BYTES) == (32, 32 * 256 * 2)
    # slots on atoms, back to back, then the barriers (full, empty)
    assert k["O_RING"] % 1024 == 0
    assert k["O_BAR"] - k["O_RING"] == slots * widths.SLAB_BYTES
    assert k["O_EX"] - k["O_BAR"] == 2 * slots * 8


def test_the_encoder_s_tiles_hold_c_and_the_next_x_in_one_room():
    """R1 (64 x 256 float32) and one bf16 tile: c, and between the last
    product and the next tile's h0, that tile's x."""
    k = struct_constants("encoder")
    assert k["O_C"] - k["O_R1"] == 64 * 256 * 4
    assert k["O_RING"] - k["O_C"] == 64 * 256 * 2
    text = source("encoder_fwd.cu")
    body = text[text.index("struct EncWide {"):]
    assert "tc_load_rows<D>(cs, TM, x +" in body      # x into c's room
    assert "enc_conv_column<K, D>(cs, r1, v_s" in body


def test_the_attention_s_yd_tile_holds_cn_p_and_the_softmax_sums():
    k = struct_constants("qa_ctx_attention")
    yd = 3 * 4 * 64 * 128                        # 64 x 3D bf16
    assert k["O_RING"] - k["O_YD"] == yd
    assert k["O_YD"] <= k["O_SX"] < k["O_P"] < k["O_YD"] + yd
    assert k["O_P"] + 64 * 128 <= k["O_YD"] + yd     # p: one panel
    assert k["O_SX"] + 2 * 64 * 2 * 4 <= k["O_P"]
    # cn (the first four panels) lies below both
    assert k["O_SX"] - k["O_YD"] >= 4 * 64 * 128


# ------------------------------------------------------ the ring's schedule
def ring_run(per, products, tiles, nslot, seed, warps=8):
    """Simulate ``SlabRing<nslot, per, 2>`` for a pair of CTAs whose eight
    warps each take a tile's ``per`` slabs in ``products`` products as
    ``mma_ring_w`` does (a slab given back once the next one's products
    are issued, the last at the product's end), interleaved at random, with
    the copy engine landing each slab some random steps after it is handed
    out.  Returns the log of events; raises on a broken rule."""
    rng = random.Random(seed)
    total = tiles * per
    ns = per // products
    full_done = [[0] * nslot for _ in range(2)]   # completed phases
    armed = [[0] * nslot for _ in range(2)]        # phases armed
    landed = [[0] * nslot for _ in range(2)]       # phases' data landed
    slot_has = [[None] * nslot for _ in range(2)]
    empty = [[0] * nslot for _ in range(2)]        # arrivals, this phase
    empty_done = [[0] * nslot for _ in range(2)]
    need = [warps + 1, warps]
    fetched = [0, min(nslot, total)]
    for k in range(fetched[1]):                     # CTA 1 arms first
        armed[1][k] = 1
    flights, log = [], []

    def complete(c, k):
        if armed[c][k] > full_done[c][k] and landed[c][k] > full_done[c][k]:
            full_done[c][k] += 1

    def arrive(c, k):
        empty[c][k] += 1
        if empty[c][k] == need[c]:
            empty[c][k] = 0
            empty_done[c][k] += 1

    def pump(c):
        while fetched[c] < total:
            f = fetched[c]
            k, use = f % nslot, f // nslot
            if empty_done[c][k] < use:              # mbar_test
                break
            armed[c][k] += 1
            if c == 0:
                assert armed[1][k] >= use + 1, "CTA 1 not armed"
                flights.append((rng.randint(1, 6), k, f))
                log.append(("copy", f))
            else:
                arrive(0, k)
            complete(c, k)
            fetched[c] += 1

    def program(c, w):
        for j in range(total):
            p = j % ns
            k, use = j % nslot, j // nslot
            while full_done[c][k] <= use:           # take
                if w == 0:
                    pump(c)
                yield
            assert slot_has[c][k] == j, (c, w, j, slot_has[c][k])
            if p > 0:
                yield from give(c, w, j - 1)
            if p == ns - 1:
                yield from give(c, w, j)

    def give(c, w, j):
        arrive(c, j % nslot)
        log.append(("give", c, w, j))
        if w == 0:
            pump(c)
        yield

    for c in (1, 0):
        pump(c)
    agents = [program(c, w) for c in range(2) for w in range(warps)]
    live = list(agents)
    for _ in range(200000):
        if not live:
            return log
        for i, (t, k, f) in enumerate(list(flights)):
            if t <= 1:
                flights.remove((t, k, f))
                for c in range(2):
                    slot_has[c][k] = f
                    landed[c][k] += 1
                    complete(c, k)
            else:
                flights[flights.index((t, k, f))] = (t - 1, k, f)
        a = rng.choice(live)
        try:
            next(a)
        except StopIteration:
            live.remove(a)
    raise AssertionError("the ring stalled")


@pytest.mark.parametrize("family", ["encoder", "qa_ctx_attention"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_ring_runs_several_tiles_without_a_slot_reused_too_soon(
        family, seed):
    k = struct_constants(family)
    products = 2 if family == "encoder" else 1
    log = ring_run(k["PER"], products, 3, k["NSLOT"], seed)
    copies = [e[1] for e in log if e[0] == "copy"]
    assert copies == list(range(3 * k["PER"]))
    # a slab is copied into its slot only after all sixteen warps gave the
    # slot's previous slab back
    for i, e in enumerate(log):
        if e[0] == "copy" and e[1] >= k["NSLOT"]:
            prev = e[1] - k["NSLOT"]
            gave = {(g[1], g[2]) for g in log[:i]
                    if g[0] == "give" and g[3] == prev}
            assert len(gave) == 16, (e, len(gave))
    # never more than NSLOT slabs handed out and not yet given back by all
    released = {}
    for e in log:
        if e[0] == "give":
            released[e[3]] = released.get(e[3], 0) + 1
        else:
            done = sum(1 for j, n in released.items() if n == 16)
            assert e[1] - done < k["NSLOT"], e
    # the encoder's next product's first slab (the next tile's, after the
    # second product) goes out while this product is still being read
    if family == "encoder":
        for b in range(8, 3 * k["PER"], 8):
            gives = [i for i, g in enumerate(log)
                     if g[0] == "give" and g[3] == b - 1]
            assert len(gives) == 16
            assert log.index(("copy", b)) < max(gives), b


def test_the_ring_pumps_between_products_only_through_refill():
    """A pump from code that the whole block runs reconverges its warp
    (an aligned block barrier may follow): the kernels call refill there,
    pump only inside take and give."""
    for src in ("encoder_fwd.cu", "qa_ctx_attention_fwd.cu"):
        text = source(src)
        assert "ring.pump()" not in text and "ring.refill();" in text
    ring = source("wgmma.cuh")
    ring = ring[ring.index("struct SlabRing {"):]
    assert "void refill() {\n    pump();\n    __syncwarp();" in ring


# ---------------------------------------------------------- the slab layout
def slab_of(q, sl):
    """(row of W, first column) of chunk q of slab sl as
    ``w_slab_pack_kernel`` writes it."""
    r = q // 8 % 32
    return 32 * sl + r, 64 * (q // 256) + 8 * ((q % 8) ^ (r % 8))


def test_the_packed_slabs_lie_as_the_products_read_them():
    """A slab is four panels of 32 rows x 64 columns, the 128-byte swizzle:
    the byte offset of (row r, column c) is panel 4096 + swz(r, c % 64),
    which is where the pack puts it; every element of W once."""
    seen = set()
    for sl in range(3):
        for q in range(1024):
            row, c0 = slab_of(q, sl)
            r, c = row - 32 * sl, c0
            swz = r * 128 + ((((c % 64) >> 3) ^ r) & 7) * 16
            assert q * 16 == (c // 64) * 4096 + swz
            seen.add((row, c0))
    assert len(seen) == 3 * 32 * 32


@pytest.mark.parametrize("family,rows", [("encoder", 512),
                                         ("qa_ctx_attention", 768)])
def test_the_slab_scratch_holds_a_call_s_slabs(family, rows):
    k = struct_constants(family)
    wp = widths.slab_scratch(family, 256, "cpu")
    assert wp.dtype == torch.bfloat16 and wp.numel() == rows * 256
    assert wp.numel() * 2 == k["PER"] * widths.SLAB_BYTES
    for d in (64, 128):
        assert widths.slab_scratch(family, d, "cpu") is None
    # the tri bridge's forward at 256 takes W's 768 rows in slabs too
    # (tests/test_torch_tri256_layouts.py holds its layout)
    assert widths.slab_scratch("tri_bridge", 256, "cpu").numel() == 768 * 256


# -------------------------------------------------------------- the wrappers
class Ctx:
    def save_for_backward(self, *a):
        self.saved = a


def recording(monkeypatch, module, kernel):
    calls = []
    monkeypatch.setattr(module, "ptr", lambda t: t)
    monkeypatch.setattr(kernel, "launch",
                        lambda dev, *a, **kw: calls.append((a, kw)))
    return calls


def encoder_inputs(b, g, length, k, d, dt, dv=None):
    gen = torch.Generator().manual_seed(b * 100 + length)
    dv = d if dv is None else dv
    x = torch.randn(b, g, length, dv, generator=gen).to(dt)
    pe = torch.randn(length, dv, generator=gen)
    params = {key: torch.randn(*shape, generator=gen) for key, shape in (
        ("ln0_s", (dv,)), ("ln0_b", (dv,)), ("dw0", (k, dv)), ("dwb0", (dv,)),
        ("pw0", (dv, dv)), ("pwb0", (dv,)), ("ln1_s", (dv,)), ("ln1_b", (dv,)),
        ("dw1", (k, dv)), ("dwb1", (dv,)), ("pw1", (dv, dv)), ("pwb1", (dv,)),
        ("lnf_s", (dv,)), ("lnf_b", (dv,)))}
    x, pe, params = encoder.pad_inputs(x, pe, params, d)
    return x, pe, params


@pytest.mark.parametrize("dv", [256, 200])
@pytest.mark.parametrize("b,g,length,k", [(1, 1, 1, 1), (1, 1, 56, 9),
                                          (3, 7, 40, 5), (100, 40, 40, 5),
                                          (2, 5, 50, 7)])
@pytest.mark.parametrize("full", [False, True])
def test_the_encoder_wrappers_hand_float32_w_and_the_scratch(
        monkeypatch, dv, b, g, length, k, full):
    """At D = 256 (and a true width padded into it) the bf16 forward gets
    the float32 packed parameters (pw0 and pw1 among them, which its C
    entry rounds) and a bf16 scratch of both matrices' slabs; float32 x
    gets none."""
    table = encoder.BLOCK_BY_WIDTH if full else encoder.FWD_BY_WIDTH
    calls = recording(monkeypatch, encoder, table[256])
    for dt in (torch.bfloat16, torch.float32):
        x, pe, params = encoder_inputs(b, g, length, k, 256, dt, dv)
        packed = encoder.pack_params(params)
        seed = torch.zeros(2, dtype=torch.long)
        if full:
            encoder._EncoderBlock.forward(Ctx(), x, pe, packed, None, k, 0.1,
                                          seed, dv, None)
        else:
            mask = torch.ones(b, g, length)
            encoder._EncoderReduce.forward(Ctx(), x, pe, packed, mask, k, 0.1,
                                           seed, dv)
    (a_bf, kw_bf), (a_f32, _) = calls
    assert kw_bf == {"dv": dv}
    assert a_bf[2].dtype == torch.float32 and a_bf[2].shape == packed.shape
    wp = a_bf[5]
    assert wp.dtype == torch.bfloat16 and wp.numel() == 2 * 256 * 256
    assert a_f32[5] is None
    n = b * g
    dims = (n, g, length, k, 256) if full else (n, length, k, 256)
    assert a_bf[6:6 + len(dims)] == dims
    assert a_bf[-1] == 1 and a_f32[-1] == 0


@pytest.mark.parametrize("d", [256, 200, 128, 64])
@pytest.mark.parametrize("raw_mode", ["full", "none", "target"])
def test_the_attention_wrapper_hands_float32_w_and_the_scratch(
        monkeypatch, d, raw_mode):
    """At D = 256 (and 200, padded into it) the bf16 forward gets W in
    float32 (its C entry rounds it into the slabs, the wrapper casts
    nothing) and the slab scratch; at 64 W in float32 too (the kernel
    rounds it as each CTA loads it) and no scratch; at 128 W in bf16 and
    no scratch."""
    dp = widths.padded_width(d)
    calls = recording(monkeypatch, qa_ctx_attention,
                      qa_ctx_attention.FWD_BY_WIDTH[dp])
    gen = torch.Generator().manual_seed(d)
    b, a, lqa, li, lr = 3, 5, 4, 3, 25
    bf = torch.bfloat16
    cn, ce = (torch.randn(b, a, lqa, d, generator=gen).to(bf)
              for _ in range(2))
    qn, qe = (torch.randn(b, li, lr, d, generator=gen).to(bf)
              for _ in range(2))
    gamma, beta = torch.ones(3 * d), torch.zeros(3 * d)
    w, bias = torch.randn(3 * d, d, generator=gen), torch.zeros(d)
    args = qa_ctx_attention.pad_inputs(cn, ce, qn, qe, gamma, beta, w, bias,
                                       dp)
    qa_ctx_attention._QaCtxAttention.forward(
        Ctx(), *args[:4], torch.ones(b, a, lqa), torch.ones(b, li, lr),
        *args[4:], torch.zeros(b, dtype=torch.int32), 10.0, raw_mode, 0.1,
        torch.zeros(2, dtype=torch.long), d)
    ((got, kw),) = calls
    assert kw == {"dv": d}
    wk, wp = got[8], got[13]
    if dp == 256:
        assert wk.dtype == torch.float32 and torch.equal(wk, args[6])
        assert wp.dtype == torch.bfloat16 and wp.numel() == 3 * 256 * 256
    elif dp == 64:
        assert wk.dtype == torch.float32 and torch.equal(wk, args[6])
        assert wp is None
    else:
        assert wk.dtype == torch.bfloat16 and wp is None
    assert got[14:20] == (b, a, lqa, li, lr, dp)


# ------------------------------------------------------------ the C entries
def c_params(src, entry):
    text = source(src)
    sig = text[text.index(f'extern "C" int {entry}('):]
    sig = sig[sig.index("(") + 1:sig.index(")")]
    return [p.strip() for p in sig.split(",")]


@pytest.mark.parametrize("src,entry,kernel", [
    ("encoder_fwd.cu", "encoder_reduce_fwd", encoder.FWD_BY_WIDTH[256]),
    ("encoder_fwd.cu", "encoder_block_fwd", encoder.BLOCK_BY_WIDTH[256]),
    ("qa_ctx_attention_fwd.cu", "qa_ctx_attention_fwd",
     qa_ctx_attention.FWD_BY_WIDTH[256])])
def test_the_c_entries_take_what_the_wrappers_give(src, entry, kernel):
    """The wrappers pass the argument types (the stream last, added by the
    launch) the entries declare, the slab scratch ``wp`` among them."""
    params = c_params(src, entry)
    assert len(params) == len(kernel.argtypes)
    assert "void* wp" in params and params[-1] == "void* stream"
    for p, t in zip(params, kernel.argtypes):
        pointer = "*" in p
        assert pointer == (t.__name__ == "c_void_p"), (p, t)


# -------------------------------------------------- phase_split --forward
def phase_split():
    import importlib.util
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "scripts",
                        "phase_split.py")
    spec = importlib.util.spec_from_file_location("phase_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("src", ["encoder_fwd.cu", "qa_ctx_attention_fwd.cu"])
def test_the_forward_stamps_and_ablations_go_into_a_copy(src):
    """Each stamp anchor occurs once in the D = 256 kernel (and only there:
    the D = 64 / 128 kernels of the same source take none), the phases
    are numbered in full, and each ablation edits the kernel alone."""
    ps = phase_split()
    text = source(src)
    assert "TVQA_PHASE" not in text and "clock64" not in text
    out = ps.stamped(text, src)
    i0, i1 = ps.kernel_span(out, src)
    marks = re.findall(r"TVQA_PHASE(?:_INIT|\((\d+)\))", out[i0:i1])
    assert len(marks) == len(ps.STAMPS[src]) == out.count("TVQA_PHASE")
    assert {int(m) for m in marks[1:]} == set(range(len(ps.PHASES[src])))
    assert re.sub(r"\n *TVQA_PHASE(?:_INIT|\(\d+\))", "", out) == text
    j0, j1 = ps.kernel_span(text, src)
    for edits in ps.FWD_ABLATIONS[src].values():
        got = ps.edit_kernel(text, src, edits)
        assert got != text and got[:j0] == text[:j0]
        assert got.endswith(text[j1:])
