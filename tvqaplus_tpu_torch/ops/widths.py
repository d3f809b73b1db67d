"""The hidden widths D the port's CUDA kernels are built for, and what each
width's instantiations hold in shared memory.

The three forward families (``csrc/qa_ctx_attention_fwd.cu``,
``csrc/tri_bridge_fwd.cu``, ``csrc/encoder_fwd.cu``) are built for 64, 128
and 256; one C entry per family takes D and refuses any other width.  At
D = 64 each bf16 (tensor-core) kernel is a design of its own, blocks of
three or four warpgroups each on 64-row tiles (or the attention's items)
of its own.  At D = 64 and 128 each bf16 kernel keeps its weight resident in
shared memory ("resident"); at D = 256
it does not fit, so the weight streams ("streamed"): rounded to bf16 once
a call into slabs of 32 rows (``slab_scratch``) that the copy engine
brings through a ring, the encoder's and the attention's shared by the
two CTAs of a cluster (``SlabRing``), the tri bridge's by the block's two
warpgroups, each on 64 rows of its own (``csrc/tri_bridge_fwd.cu``
``TriRing``).

The three backward families are built for the same widths: at D = 128 the
tensor-core designs of ``csrc/*_bwd.cu`` (bf16) beside their CUDA-core
float32 kernels, and at D = 64 and 256 ``csrc/*_bwd_wide.cu`` and
``csrc/encoder_bwd_tc_wide.cu``.  Every bf16 backward runs on the tensor
cores: the tri bridge and the encoder at both widths (the weights resident
at 64, streamed at 256; the encoder's warpgroups on 64-row tiles of their
own at 64 and splitting a tile's columns at 256; the tri bridge's W at 256
in bf16 slabs through a ring the copy engine feeds), the attention at 256 (its warpgroup columns in two
quarters) and at 64 (the two warpgroups on rows of their own).  Every bf16
weight gradient is the tensor-core pass of ``csrc/wgrad_tc.cuh``, whose
width is an argument (the same kernel at 64, 128 and 256).

Every other width dv <= 256 that 4 divides runs in the next instantiation
Dp (``padded_width``): the wrappers zero-pad the activations and the
parameters to Dp (``pad_cols``; a [x; y; x*y] weight third by third),
launch with the true width dv, which the kernels use for every
LayerNorm's statistics and the Philox keys (csrc/philox.cuh), and slice
the outputs back (the gradients through the pads' autograd).  So the card
serves and trains at any such hsz; others are refused by name
(``check_width``, ROADMAP A10d).

The byte counts below repeat the layouts of the sources (their ``SMEM``
constants and ``Layout`` / ``smem_floats`` functions); the tests hold every
one at or below an H100 block's opt-in limit.
"""
from __future__ import annotations

import torch.nn.functional as F

FORWARD_WIDTHS = (64, 128, 256)
BACKWARD_WIDTHS = (64, 128, 256)
SMEM_LIMIT = 232_448      # bytes of shared memory an H100 block may opt into

FAMILIES = ("qa_ctx_attention", "tri_bridge", "encoder")

_TM, _ROW, _ATOM = 64, 128, 1024       # wgmma rows, swizzled row, atom
_TR = 2 * _TM                          # the encoder's resident tile rows
_KC, _NWARPS = 32, 8                   # the float32 GEMM's staged rows
_MAX_LR, _MAX_LEN, _MAX_K = 64, 56, 9  # the kernels' largest shapes
# the rings of the bf16 backwards at D = 256: the encoder's pw stages of
# ENC256_KP rows in its R1 tile (csrc/encoder_bwd_tc_wide.cu Enc256), the
# attention's W slabs of 2 x 64 rows x 64 columns, ATT256_OWN of them in a
# room of their own and the others where qn was
# (qa_ctx_attention_bwd_wide.cu AttTcWide)
ENC256_KP, ENC256_NST, ATT256_NST, ATT256_OWN = 32, 4, 5, 3
# the tri bridge's bf16 backward at D = 256 (csrc/tri_bridge_bwd_wide.cu
# Tri256): slabs of 16 KB, TRI256_SLOTS slots in all, TRI256_RING of them in
# use at a time (three of their own; s and v's room during y1, yd's past
# g_y1 during g_yd), at most TRI256_AHEAD in flight
TRI256_SLOTS, TRI256_RING, TRI256_AHEAD, TRI256_SLAB = 11, 7, 6, 16384
# the bf16 forwards of the encoder and the attention at D = 256
# (csrc/encoder_fwd.cu EncWide, csrc/qa_ctx_attention_fwd.cu AttnWide): W in
# slabs of SLAB_ROWS rows x 256 columns (SLAB_BYTES) through a ring of
# ENC256_FWD_SLOTS / ATT256_FWD_SLOTS slots (csrc/wgmma.cuh SlabRing), a
# cluster of CLUSTER CTAs sharing each slab
SLAB_ROWS, SLAB_BYTES, CLUSTER = 32, 16384, 2
ENC256_FWD_SLOTS, ATT256_FWD_SLOTS = 7, 4
# the tri bridge's bf16 forward at D = 256 (csrc/tri_bridge_fwd.cu
# TriFwd256): the same slabs through TRI256_FWD_SLOTS slots, which the
# block's two warpgroups share (no cluster)
TRI256_FWD_SLOTS = 5
# the attention's bf16 forward at D = 64 (csrc/qa_ctx_attention_fwd.cu
# AttnTc64): persistent CTAs of this many warpgroups, each on (b, 64-row
# tile, frame) items of its own
ATT64_WARPGROUPS = 3
# the tri bridge's bf16 backward at D = 64 (csrc/tri_bridge_bwd_wide.cu
# Tri64): blocks of this many warpgroups, each on 64-row tiles of its own
TRI64_WARPGROUPS = 3
# the bf16 forwards of the encoder and the tri bridge at D = 64
# (csrc/encoder_fwd.cu EncFwd64, csrc/tri_bridge_fwd.cu TriFwd64): blocks of
# this many warpgroups, each on 64-row tiles of its own
ENC64_FWD_WARPGROUPS, TRI64_FWD_WARPGROUPS = 4, 3


MAX_WIDTH = 256
WIDTH_MULTIPLE = 4     # four adjacent columns share a Philox call
# every true width a launch may name
TRUE_WIDTHS = tuple(range(WIDTH_MULTIPLE, MAX_WIDTH + 1, WIDTH_MULTIPLE))


def check_width(name, d):
    """Raise unless the kernels take the true width ``d`` (in the
    instantiation ``padded_width(d)``)."""
    if not (WIDTH_MULTIPLE <= d <= MAX_WIDTH and d % WIDTH_MULTIPLE == 0):
        raise ValueError(
            f"{name}: the CUDA kernels take hidden widths that "
            f"{WIDTH_MULTIPLE} divides up to {MAX_WIDTH}, each in the next "
            f"of the instantiations 64, 128 and 256, not D = {d}; other "
            f"widths are ROADMAP A10d")


def padded_width(d):
    """The instantiation the true width ``d`` runs in: the least of
    ``FORWARD_WIDTHS`` at or above it."""
    check_width("padded_width", d)
    return min(w for w in FORWARD_WIDTHS if w >= d)


def pad_cols(t, dp, parts=1):
    """``t`` with its last dim, ``parts`` blocks of the true width, each
    zero-padded to ``dp`` (differentiable: the gradient is sliced back)."""
    if parts == 1:
        return F.pad(t, (0, dp - t.shape[-1]))
    dv = t.shape[-1] // parts
    return F.pad(t.unflatten(-1, (parts, dv)), (0, dp - dv)).flatten(-2)


def pad_weight(w, dp, parts=1):
    """A (parts dv, dv) weight (in, out) zero-padded to (parts dp, dp):
    each block of input rows padded apart, [W_a; 0; W_b; 0; ...]."""
    return pad_cols(pad_cols(w, dp).transpose(0, 1), dp,
                    parts).transpose(0, 1)


def check_forward_width(name, d):
    """Raise unless a forward kernel is built for width ``d``."""
    if d not in FORWARD_WIDTHS:
        raise ValueError(
            f"{name}: the CUDA forward kernels are built for hidden widths "
            f"64, 128 and 256, not D = {d} (a width up to 256 that 4 "
            f"divides runs padded to the next: padded_width); other widths "
            f"are ROADMAP A10d")


def check_backward_width(name, d):
    """Raise unless the backward kernels are built for width ``d``."""
    if d not in BACKWARD_WIDTHS:
        raise ValueError(
            f"{name}: the backward kernels (attention, tri bridge, encoder) "
            f"and their weight-gradient passes are built for hidden widths "
            f"64, 128 and 256, not D = {d} (a width up to 256 that 4 "
            f"divides runs padded to the next: padded_width); training at "
            f"other widths on the card is ROADMAP A10d")


def check_trainable(hsz, device):
    """Raise when a model of width ``hsz`` cannot train on ``device``: on
    ``cuda`` every train step runs the backward kernels, which take the
    widths ``check_width`` takes.  The CPU trains at any width."""
    if getattr(device, "type", device) == "cuda":
        check_width(f"training at hsz {hsz} on cuda", hsz)


def instantiation(d):
    """How the bf16 forward kernels hold their weight at width ``d``."""
    check_forward_width("instantiation", d)
    return "streamed" if d == 256 else "resident"


def _stage(d, kp):
    return kp * d * 2


def _atoms(n):
    """``n`` bytes rounded up to whole 1024-byte atoms."""
    return -(-n // _ATOM) * _ATOM


def tc_smem_bytes(family, d):
    """Dynamic shared memory of ``family``'s bf16 forward at width ``d``."""
    check_forward_width(family, d)
    panels, tile_panel = d // 64, _TM * _ROW
    tile = panels * tile_panel
    w_bytes = panels * 3 * d * _ROW
    if family == "qa_ctx_attention":
        yd = 3 * panels * tile_panel
        if d == 64:       # AttnTc64: W, the bias (an atom), then a room
            # for each of ATT64_WARPGROUPS warpgroups: its cn and ce tiles
            # and two slots of a frame's qn, qe (64 rows each) and q mask
            # (an atom)
            slot = 2 * tile + _ATOM
            return (w_bytes + _ATOM
                    + ATT64_WARPGROUPS * (2 * tile + 2 * slot) + _ATOM)
        if d == 256:      # AttnWide: qn, qe, yd (cn, p and the softmax's
            # sums first), the ring, its barriers, the LN sums, qm
            slots = ATT256_FWD_SLOTS
            return (2 * tile + yd + slots * SLAB_BYTES + 2 * slots * 8
                    + 2 * _TM * 2 * 4 + _TM * 4 + _ATOM)
        return w_bytes + 2 * tile + 2 * yd + (_TM + d) * 4 + _ATOM
    if family == "tri_bridge":
        if d == 256:      # TriFwd256: s and v of each warpgroup's rows, the
            # ring, its barriers and count, gin, bin, bias, gout, bout
            slots = TRI256_FWD_SLOTS
            return (2 * 2 * tile + slots * SLAB_BYTES + 2 * slots * 8 + 16
                    + 9 * d * 4 + _ATOM)
        if d == 64:       # TriFwd64: W; gin, bin, bias, gout, bout (to an
            # atom); a room a warpgroup of two slots of a tile's s and v
            return (_atoms(w_bytes + 9 * d * 4)
                    + TRI64_FWD_WARPGROUPS * 2 * 2 * tile + _ATOM)
        return (w_bytes + 2 * 2 * tile + 3 * panels * tile_panel  # TriTc
                + 2 * 2 * _TM * 2 * 4 + 9 * d * 4 + _ATOM)
    if family == "encoder":
        if d == 256:      # EncWide: R1, c (and x), the ring, its
            # barriers, the row sums, v and m twice
            slots = ENC256_FWD_SLOTS
            return (_TM * d * 4 + tile + slots * SLAB_BYTES
                    + 2 * slots * 8 + 2 * _TM * 2 * 4 + 2 * 2 * _TM * 4
                    + _ATOM)
        pw = panels * d * _ROW
        if d == 64:       # EncFwd64: pw0, pw1; a room a warpgroup: the c
            # tile (the output's staging) and the x tile in bf16, R1 and H
            # in float32, v and m twice (to an atom)
            room = _atoms(2 * tile + 2 * _TM * d * 4 + 2 * 2 * _TM * 4)
            return 2 * pw + ENC64_FWD_WARPGROUPS * room + _ATOM
        return (2 * pw + _TR * d * 4 + panels * _TR * _ROW      # EncTc
                + 2 * 2 * _TR * 4 + _ATOM)
    raise ValueError(f"unknown kernel family {family!r}")


def slab_scratch(family, d, device):
    """The bf16 buffer a bf16 forward of ``family`` at width ``d`` rounds
    its weight into once a call (its C entry's ``wp``): at D = 256 the
    encoder's pw0 and pw1 (2 x 256 rows), the attention's and the tri
    bridge's W (768 rows), in slabs of SLAB_ROWS rows; None where the
    kernel takes no slabs."""
    import torch
    check_forward_width(family, d)
    rows = {"encoder": 2 * d, "qa_ctx_attention": 3 * d,
            "tri_bridge": 3 * d}.get(family)
    if d != 256 or rows is None:
        return None
    return torch.empty(rows * d, dtype=torch.bfloat16, device=device)


def f32_smem_bytes(family, d):
    """Largest dynamic shared memory of ``family``'s float32 forward at width
    ``d`` (its largest Lr, L and k)."""
    check_forward_width(family, d)

    def round4(n):
        return (n + 3) & ~3
    if family == "qa_ctx_attention":               # Layout<D>(64)
        rt = (2 if d == 256 else 4) * _NWARPS
        lr = _MAX_LR
        qm = round4(2 * lr * (d + 1))
        return 4 * (qm + round4(lr) + rt * round4(lr) + rt * 3 * d + _KC * d)
    if family == "tri_bridge":
        return 4 * (4 * _NWARPS * 3 * d + _KC * d)
    if family == "encoder":                        # smem_floats<D>
        rows = -(-_MAX_LEN // _NWARPS) * _NWARPS
        w = 2 * d * d if d <= 128 else _KC * d
        return 4 * (w + 3 * rows * d + 2 * _MAX_K * d
                    + 2 * round4(_MAX_LEN))
    raise ValueError(f"unknown kernel family {family!r}")


def bwd_smem_bytes(family, d, dtype="bfloat16", lr=_MAX_LR, length=_MAX_LEN,
                   k=_MAX_K):
    """Dynamic shared memory of ``family``'s backward main kernel at width
    ``d`` in ``dtype`` ("bfloat16" or "float32"), at its largest Lr (the
    attention), L and k (the encoder) unless given."""
    check_backward_width(family, d)

    def round4(n):
        return (n + 3) & ~3
    panels, tile_panel = d // 64, _TM * _ROW
    tile = panels * tile_panel
    w_bytes = panels * 3 * d * _ROW
    if dtype == "bfloat16" and family == "tri_bridge":
        if d == 128:                         # tri_bridge_bwd_tc_kernel
            return (w_bytes + 2 * tile + 6 * tile_panel + tile
                    + 4 * 2 * _TM * 2 * 4 + 8 * d * 4 + _ATOM)
        if d == 256:    # Tri256: s, v, yd (g_y1), three own slots, the
            # barriers, four exchange rounds, gin, bin, bias, gout
            return (5 * tile + 3 * TRI256_SLAB + 256 + 4 * 2 * _TM * 2 * 4
                    + 8 * d * 4 + _ATOM)
        # Tri64: W (bf16, once); gin, bin, bias, gout; a room for each of
        # TRI64_WARPGROUPS warpgroups: two halves of three tiles (a tile's
        # s, v and cotangent, the other tile's yd), g_y1
        return (w_bytes + 8 * d * 4
                + TRI64_WARPGROUPS * (2 * 3 * tile + tile) + _ATOM)
    if dtype == "bfloat16" and family == "qa_ctx_attention" and d == 256:
        # AttTcWide<LRP>: qn, qe, cn (then p0), g_out (then g_att), ce; the
        # ring of W's slabs; two exchange rounds; the q mask; gamma, beta
        return (5 * tile + ATT256_OWN * 2 * tile_panel
                + 2 * 2 * _TM * 2 * 4 + _TM * 4 + 6 * d * 4 + _ATOM)
    if dtype == "bfloat16" and family == "qa_ctx_attention" and d == 64:
        # AttTc64<LRP>: W (3D rows); a room a warpgroup: qn, qe, cn, ce,
        # g_out (then g_att), p0 (LRP / 2 floats a thread), the q mask,
        # rounded to an atom; gamma, beta
        lrp = 32 if lr <= 32 else 64
        room = -(-(5 * tile + lrp // 2 * 128 * 4 + _TM * 4) // _ATOM) * _ATOM
        return 3 * d * _ROW + 2 * room + 6 * d * 4 + _ATOM
    if dtype == "bfloat16" and family == "encoder" and d == 256:
        # Enc256: R1 (64 x D float32, rows padded by 8; the ring of pw's
        # stages during the products) and H, the c / g_y and t tiles, the
        # running depthwise and LN sums, v and m, two exchange rounds
        assert ENC256_NST * _stage(d, ENC256_KP) <= _TM * d * 4
        return (_TM * (d + 8) * 4 + _TM * d * 4 + 2 * tile
                + 2 * (_MAX_K + 1) * d * 4 + 6 * d * 4 + 2 * _TM * 4
                + 2 * 2 * _TM * 2 * 4 + _ATOM)
    if dtype == "bfloat16" and family == "encoder" and d == 64:
        # Enc64: pw0 and pw1 (resident); a room a warpgroup (the c and t
        # tiles in bf16, R1, g_t and the h stash in float32, v and m;
        # rounded to an atom); the LN sums of 8 warps, the depthwise sums
        # of each warpgroup's two column-pass halves of both layers (9 taps
        # and dwb)
        room = -(-(2 * tile + 3 * _TM * d * 4 + 2 * _TM * 4) // _ATOM) \
            * _ATOM
        return (2 * d * _ROW + 2 * room + _NWARPS * 6 * d * 4
                + 2 * 2 * 2 * (_MAX_K + 1) * d * 4 + _ATOM)
    if d == 128 and dtype == "bfloat16":     # the tensor-core designs
        if family == "qa_ctx_attention":     # qa_ctx_bwd_tc_kernel
            return (w_bytes + 5 * tile + 32 * 256 * 4 + 2 * 2 * _TM * 2 * 4
                    + _TM * 4 + 6 * d * 4 + _ATOM)
        if family == "encoder":              # encoder_bwd_tc_kernel
            return (2 * 2 * d * _ROW + _TR * d * 4 + _TR * d * 2
                    + 2 * _TR * 4 + _ATOM)
    elif family == "qa_ctx_attention":       # Layout(lr), Layout<D, RPT>
        rpt = 4
        if d == 256:                         # 16-row tiles where they fit
            rpt = 2 if 4 * _attn_floats(lr, d, 2) <= SMEM_LIMIT else 1
        return 4 * _attn_floats(lr, d, rpt)
    elif family == "tri_bridge":             # SMEM_FLOATS, Tri<D>::SMEM
        rt = (2 if d == 256 else 4) * _NWARPS
        return 4 * (rt * 3 * d + rt * d + _KC * d + 2 * rt)
    elif family == "encoder":                # smem_floats(<D>)(L, k, rpt)
        lp = (-(-length // _NWARPS) if d == 128 else _encoder_rpt(length)) \
            * _NWARPS
        bufs = 0 if d == 256 else 7 * lp * d
        return 4 * (bufs + _KC * d + 2 * k * d + 2 * round4(length))
    raise ValueError(f"unknown kernel family {family!r}")


def _attn_floats(lr, d, rpt):
    """Floats of the attention backward's CUDA-core layout: qn and qe at
    row stride D + 1, the mask, three (RT, Lr) and five (RT, D) tiles, the
    row statistics and the staged weight rows."""
    rt, lrp = rpt * _NWARPS, (lr + 3) & ~3
    qm = (2 * lr * (d + 1) + 3) & ~3
    return qm + lrp + 3 * rt * lrp + 5 * rt * d + 2 * rt + _KC * d


def encoder_bwd_work_floats(d, length):
    """Floats of the per-block scratch that holds a sequence's seven L x D
    buffers of ``csrc/encoder_bwd_wide.cu`` at width ``d`` (0 where they
    sit in shared memory)."""
    return 7 * _encoder_rpt(length) * _NWARPS * d if d == 256 else 0


def _encoder_rpt(length):
    """Rows per warp of ``csrc/encoder_bwd_wide.cu`` (``rpt_for``)."""
    return 2 if length <= 16 else (5 if length <= 40 else 7)
