"""The hidden widths D the port's CUDA kernels are built for, and what each
width's forward instantiation holds in shared memory.

The three forward families (``csrc/qa_ctx_attention_fwd.cu``,
``csrc/tri_bridge_fwd.cu``, ``csrc/encoder_fwd.cu``) take D as a template
parameter and are built for 64, 128 and 256; one C entry per family takes D
and refuses any other width.  At D = 64 and 128 each bf16 (tensor-core)
kernel keeps its weight resident in shared memory ("resident"); at D = 256
it does not fit, so the weight streams through two stages ("streamed",
``csrc/wgmma.cuh`` ``mma_streamed_w``).  The backward kernels and the
weight-gradient pass (``csrc/wgrad_tc.cuh``) are built for D = 128 alone
(ROADMAP A10b), so training on the card takes hsz 128 only.

The byte counts below repeat the layouts of the sources (their ``SMEM``
constants and ``Layout`` / ``smem_floats`` functions); the tests hold every
one at or below an H100 block's opt-in limit.
"""
from __future__ import annotations

FORWARD_WIDTHS = (64, 128, 256)
BACKWARD_WIDTH = 128
SMEM_LIMIT = 232_448      # bytes of shared memory an H100 block may opt into

FAMILIES = ("qa_ctx_attention", "tri_bridge", "encoder")

_TM, _ROW, _ATOM = 64, 128, 1024       # wgmma rows, swizzled row, atom
_TR = 2 * _TM                          # the encoder's resident tile rows
_KC, _NWARPS = 32, 8                   # the float32 GEMM's staged rows
_MAX_LR, _MAX_LEN, _MAX_K = 64, 56, 9  # the kernels' largest shapes


def check_forward_width(name, d):
    """Raise unless a forward kernel is built for width ``d``."""
    if d not in FORWARD_WIDTHS:
        raise ValueError(
            f"{name}: the CUDA forward kernels are built for hidden widths "
            f"64, 128 and 256, not D = {d}; other widths are ROADMAP A10d")


def check_backward_width(name, d):
    """Raise unless the backward kernels are built for width ``d``."""
    if d != BACKWARD_WIDTH:
        raise ValueError(
            f"{name}: the backward kernels (attention, tri bridge, encoder) "
            f"and csrc/wgrad_tc.cuh are built for D = {BACKWARD_WIDTH} only, "
            f"not D = {d}: training at this width on the card is "
            f"ROADMAP A10b")


def check_trainable(hsz, device):
    """Raise when a model of width ``hsz`` cannot train on ``device``: on
    ``cuda`` every train step runs the backward kernels, which take
    D = 128 only.  The CPU trains at any width."""
    if getattr(device, "type", device) == "cuda" \
            and hsz != BACKWARD_WIDTH:
        check_backward_width(f"training at hsz {hsz} on cuda", hsz)


def instantiation(d):
    """How the bf16 forward kernels hold their weight at width ``d``."""
    check_forward_width("instantiation", d)
    return "streamed" if d == 256 else "resident"


def _stage(d, kp):
    return kp * d * 2


def tc_smem_bytes(family, d):
    """Dynamic shared memory of ``family``'s bf16 forward at width ``d``."""
    check_forward_width(family, d)
    panels, tile_panel = d // 64, _TM * _ROW
    tile = panels * tile_panel
    w_bytes = panels * 3 * d * _ROW
    if family == "qa_ctx_attention":
        yd = 3 * panels * tile_panel
        if d == 256:      # AttnWide: qn, qe, yd, 2 stages of 32 rows, ...
            return (2 * tile + yd + 2 * _stage(d, 32) + _TM * 4 + d * 4
                    + 2 * _TM * 2 * 4 + _ATOM)
        return w_bytes + 2 * tile + 2 * yd + (_TM + d) * 4 + _ATOM
    if family == "tri_bridge":   # TriTc
        head = 2 * _stage(d, 32) if d == 256 else w_bytes
        bufs = 1 if d == 256 else 2
        return (head + bufs * 2 * tile + 3 * panels * tile_panel
                + 2 * 2 * _TM * 2 * 4 + 9 * d * 4 + _ATOM)
    if family == "encoder":
        if d == 256:      # EncWide: R1, x, c, 2 stages of 64 rows, ...
            return (_TM * d * 4 + 2 * tile + 2 * _stage(d, 64)
                    + 2 * _TM * 2 * 4 + 2 * 2 * _TM * 4 + _ATOM)
        pw = panels * d * _ROW                       # EncTc
        return (2 * pw + _TR * d * 4 + panels * _TR * _ROW
                + 2 * 2 * _TR * 4 + _ATOM)
    raise ValueError(f"unknown kernel family {family!r}")


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
