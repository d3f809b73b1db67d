"""Where a block's time goes in the bf16 backward kernels at D = 256
(``csrc/qa_ctx_attention_bwd_wide.cu`` ``qa_ctx_bwd_tc_wide_kernel``,
``csrc/encoder_bwd_tc_wide.cu``'s ``Enc256`` kernel and
``csrc/tri_bridge_bwd_wide.cu``'s kernel at 256) and in the encoder's and
the tri bridge's at D = 64 (``--width 64 --families
encoder,encoder_block,tri_bridge``: ``Enc64`` and ``Tri64``, or a parent
tree's ``tri_bridge_bwd_tc_wide_kernel<64>``), or with ``--forward`` in the
bf16 forwards at D = 256 of the encoder, the attention and the tri bridge
(``encoder_fwd_tc_wide_kernel``, ``qa_ctx_fwd_tc_wide_kernel``,
``tri_bridge_fwd_tc256_kernel``) and, with ``--width 64``, in the
attention's, the encoder's and the tri bridge's at D = 64
(``qa_ctx_fwd_tc64_kernel``, ``encoder_fwd_tc64_kernel``,
``tri_bridge_fwd_tc64_kernel``, or a parent tree's ``encoder_fwd_tc_kernel<64,
K>`` and ``tri_bridge_fwd_tc_kernel<64>``), phase by phase, from ``clock64()``
stamps in a copy of the sources; and what parts of them cost, from copies
with those parts taken out.

    python3 scripts/phase_split.py [--width D] [--ablations] [--families F,..]
    python3 scripts/phase_split.py --forward [--ablations] [--families F,..]

Run from a tree's root (its ``chip_smoke.py`` and package are imported);
needs one NVIDIA GPU.  The sources in the tree carry no stamps: the script
copies them into ``build/phase_split/``, inserts ``TVQA_PHASE(i)`` at
the places ``STAMPS`` names (each anchor must occur once in its kernel,
``tests/test_torch_bwd256_layouts.py`` holds them to the sources) with a
buffer of 32 cycle counters in front, and builds the copies beside the
tree's libraries; thread 0 of every block adds the cycles since its last
stamp to counter i.  A source whose kernel is an older design is stamped
by that design's entry (``VARIANTS``: the D = 64 encoder and tri bridge
forwards before their redesigns, ``@64 shared tile``: the D = 128 kernels'
instantiations at half width, whose warpgroups share each tile), so the
script run from a parent tree's root splits the parent's kernel.  For each backward case of ``train_kernel_cases`` at
width D (default 256; dropout 0.1) of the families named (default: the
attention, the encoders and the tri bridge) it prints one JSON line: each
kernel's device ms per call from ``torch.profiler`` (the tree's own
build), then the stamped main kernel's cycles per phase and each phase's
share.  Thread 0 waits at the block's barriers, so a phase holds the
block's critical path through it, waits included.

``--ablations`` also builds one copy of the attention source for each of
``ABLATIONS`` (its g_yd loop with one part taken out: the results are wrong,
only the time is read) and of the tri bridge source for each of
``TRI_ABLATIONS`` (with ``--forward``: of each forward source for each of
``FWD_ABLATIONS``; at ``--width 64`` those are the encoder's and the tri
bridge's design variants, whose results stay right), and prints, for each
case of those families, the main kernel's device ms under each copy beside
the tree's own, measured just before and just after it.  ``--forward``
takes the forward cases of ``kernel_cases`` at D = 256 (the attention's, the
encoder's and the tri bridge's at D = 64 with ``--width 64``; bf16), each
at dropout 0 and 0.1.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ATT, ENC = "qa_ctx_attention_bwd_wide.cu", "encoder_bwd_tc_wide.cu"
TRI = "tri_bridge_bwd_wide.cu"
# the D = 64 kernels (keys of their own: each source holds the D = 256
# kernel too): the encoder's and the tri bridge's
ENC64 = ENC + "@64"
TRI64 = TRI + "@64"
SOURCE_OF = {"qa_ctx_attention": ATT, "encoder": ENC, "encoder_block": ENC,
             "tri_bridge": TRI}
SOURCE_OF_64 = {"encoder": ENC64, "encoder_block": ENC64,
                "tri_bridge": TRI64}
ENC_FWD, ATT_FWD = "encoder_fwd.cu", "qa_ctx_attention_fwd.cu"
TRI_FWD = "tri_bridge_fwd.cu"
# the forwards at D = 64: the attention's, the encoder's and the tri
# bridge's, and the last two before their redesign (the D = 128 kernels'
# instantiations at half width, the two warpgroups sharing each tile; the
# D = 128 kernels keep those designs, so their stamps stay in the tree)
ATT_FWD64 = ATT_FWD + "@64"
ENC_FWD64 = ENC_FWD + "@64"
TRI_FWD64 = TRI_FWD + "@64"
ENC_FWD64_SHARED = ENC_FWD + "@64 shared tile"
TRI_FWD64_SHARED = TRI_FWD + "@64 shared tile"
FWD_SOURCE_OF = {"qa_ctx_attention": ATT_FWD, "encoder": ENC_FWD,
                 "encoder_block": ENC_FWD, "tri_bridge": TRI_FWD}
FWD_SOURCE_OF_64 = {"qa_ctx_attention": ATT_FWD64, "encoder": ENC_FWD64,
                    "encoder_block": ENC_FWD64, "tri_bridge": TRI_FWD64}
# a source's designs, newest first: the first whose kernel start occurs in
# the text is the one stamped
VARIANTS = {ATT: (ATT,), ENC: (ENC,), TRI: (TRI,), ENC64: (ENC64,),
            TRI64: (TRI64,), TRI_FWD: (TRI_FWD,), ATT_FWD64: (ATT_FWD64,),
            ENC_FWD64: (ENC_FWD64, ENC_FWD64_SHARED),
            TRI_FWD64: (TRI_FWD64, TRI_FWD64_SHARED)}


def source_file(src):
    """The file of a source key (``ENC64`` names a kernel of ``ENC``)."""
    return src.split("@")[0]


def tag(src):
    """A source key as a build name."""
    return source_file(src)[:-3] + src[len(source_file(src)):].replace(
        "@", " ")
# the kernel a design's stamps go into: from this line to its closing "}"
# (the forwards' from the slab parameter, which only the D = 256 kernel
# of each has)
KERNEL_START = {ATT: "  using S = AttTcWide<LRP>;\n",
                ENC: "  using S = Enc256;\n",
                TRI: "  using S = Tri256;\n",
                TRI64: "  using S = Tri64;\n",
                ENC_FWD: " " * 27 + "const __nv_bfloat16* __restrict__ wp,\n",
                ATT_FWD: " " * 26 + "const __nv_bfloat16* __restrict__ wp,\n",
                ENC64: "  using S = Enc64;\n",
                TRI_FWD: "  using S = TriFwd256;\n",
                ATT_FWD64: "  using S = AttnTc64;\n",
                ENC_FWD64: "  using S = EncFwd64;\n",
                TRI_FWD64: "  using S = TriFwd64;\n",
                ENC_FWD64_SHARED: "  using S = EncTc<D>;\n",
                TRI_FWD64_SHARED: "  using S = TriTc<D>;\n"}
PHASES = {
    ATT: ("frame", "stage", "keep bits", "scores, softmax", "LN stats",
          "pass A rows", "pass B rows", "g_att, g_p, softmax bwd, gcn",
          "block sums", "g_yd products"),
    ENC: ("setup", "tile head", "LN fwd", "conv", "c pw", "g_y tile",
          "g_y pw^T", "conv bwd", "dw grad", "LN bwd", "t tile", "cotangent",
          "misc", "block sums"),
    TRI: ("setup", "stage", "LN_in, yd", "y1 products", "y1 end, s and v",
          "LN_out, g_y1", "g_yd products", "pass A rows", "row sums",
          "pass B", "block sums"),
    ENC_FWD64: ("setup", "tile head, keep bits", "h0, LN 0",
                "prefetch, conv 0", "c pw 0, residual", "LN 1", "conv 1",
                "c pw 1, residual", "final LN, max pieces or out tile",
                "max or rows out"),
    TRI_FWD64: ("setup", "prefetch, keep bits", "s and v wait",
                "LN_in stats", "fragments, products", "LN_out",
                "out tile, rows out"),
    ENC_FWD64_SHARED: ("setup", "tile head: v, m, keep bits, x wait",
                       "h0, LN 0", "conv, c pw", "LN 1", "residual",
                       "final LN, max or out"),
    TRI_FWD64_SHARED: ("setup", "prefetch, keep bits", "s and v wait",
                       "LN_in stats", "yd tile", "y1 products",
                       "LN_out stats", "out"),
    ENC_FWD: ("setup", "tile head", "LN", "conv", "pw products", "residual",
              "final LN, out", "end"),
    ATT_FWD: ("setup", "frame, cn", "scores, softmax, p", "att product",
              "LN, keep bits, yd", "projection", "out", "end"),
    TRI64: ("setup", "keep bits", "tile wait", "LN_in, yd tile",
            "y1 products, yd rows", "LN_out, g_y1 tile",
            "prefetch, g_y1 rows", "pass A (g_yd a group at a time)",
            "pass B, gs and gv tiles", "gs, gv rows", "block sums"),
    ATT_FWD64: ("setup", "frame wait, cn, ce", "keep bits, scores, softmax, "
                "raw", "att product", "LN stats", "fragments, projection",
                "out tile", "out rows"),
    ENC64: ("setup", "tile head", "LN fwd", "conv", "c pw", "g_y pw^T",
            "g_c to R1", "column pass: dw grad, g_t", "g_t read", "LN bwd",
            "cotangent", "gx out", "block sums"),
    TRI_FWD: ("setup", "keep bits", "s and v wait", "LN_in stats",
              "first fragments", "slabs: products, fragments",
              "LN_out stats", "out rows"),
}
# (text before, text after, indent, phase): the stamp goes between the two
# texts, whose join occurs once in the kernel; phase None is the clock's
# start.  In each source's order.
STAMPS = {
    ATT: [
        ("  drop.load_seed();\n", "", 2, None),
        ("  auto gyd = [&](float (&acc)[32]) {\n", "", 4, 5),
        ("    tc::fence_regs(acc);\n", "", 4, 9),
        ("      vg[g][u][0] = vg[g][u][1] = vb[g][u][0] = vb[g][u][1] = "
         "0.f;\n", "", 2, 0),
        ("    __syncthreads();                   // the previous item is "
         "consumed\n", "", 4, 7),
        ("", "\n    int m[2];\n", 4, 1),
        ("", "    // ---- recompute: scores and softmax", 4, 2),
        ("", "    // ---- LN statistics over", 4, 3),
        ("", "    // ---- pass A: g_yd once,", 4, 4),
        ("    for (int j = 0; j < S::NOWN; ++j) fetch_slab(used + j);\n", "",
         4, 5),
        ("", "    // ---- g_p = g_att qe^T,", 4, 6),
        ("", "  // ---- the block's parameter-vector partials", 2, 7),
        ("        ((red[k] + red[NVT + k]) + red[2 * NVT + k]) + "
         "red[3 * NVT + k];\n", "", 2, 8),
    ],
    ENC: [
        ("  drop.load_seed();\n", "", 2, None),
        ("    ++xround;\n  };\n", "", 2, 0),
        ("    __syncthreads();\n", "\n    // h0 = x + pe", 4, 1),
        ("", "    };\n    // c = depthwise_i(t v)", 6, 2),
        ("", "    };\n    // y = c pw_i + pwb_i", 6, 3),
        ("      product(acc, tc::smem_u32(r2), pw + i * D * D);\n", "", 6, 4),
        ("", "    };\n    // g_y = g (y > 0)", 6, 4),
        ("", "      product(acc, tc::smem_u32(r2), pw + (2 + i) * D * D);\n",
         6, 5),
        ("      product(acc, tc::smem_u32(r2), pw + (2 + i) * D * D);\n", "",
         6, 6),
        ("            tc::pack_bf16(tt.x, tt.y);\n      }\n", "", 6, 10),
        ("      __syncthreads();\n", "      const int cd = tid;\n", 6, 7),
        ("      run[MAX_K * D] += gdwb;\n", "", 6, 8),
        ("        acc[2 * pr + 1] = a.y;\n      }\n", "", 6, 7),
        ("", "    };\n    auto from_h = [&]", 6, 9),
        ("", "    ln_to_r1(hv, P.ln_s(1), P.ln_b(1), false);\n", 4, 12),
        ("      }\n    }\n", "    ln_bwd(", 4, 11),
        ("    load_h0(hv);\n", "    ln_to_r1(hv, P.ln_s(0)", 4, 12),
        ("    }\n", "  }\n  // ---- the block's parameter-vector", 4, 12),
        ("  }\n", "}\n", 2, 13),
    ],
    TRI: [
        ("  drop.load_seed();\n", "", 2, None),
        ("", "  int ti = 0;\n", 2, 0),
        ("", "    // ---- the recompute: LN_in statistics, yd", 4, 1),
        ("", "    open_s = ti;\n", 4, 2),
        ("", "    tc::fence_async_smem();\n    __syncthreads();"
         "                   // y1 is done", 4, 3),
        ("", "    float m2[2], i2[2];\n", 4, 4),
        ("", "    // ---- pass A: g_yd once", 4, 5),
        ("        tc::fence_regs(ac);\n", "", 8, 6),
        ("          vbi[g][u][qh] += tb[0];\n        }\n", "      }\n    }\n",
         8, 7),
        ("    tri_row_pair_sums(ex_s + 3 * 2 * TM * 2, t1, t2, wg, rl, lane);\n",
         "", 4, 8),
        ("    tile_rows_out<D>(gv + r0 * D, gv_s, rows, tid);\n", "  }\n", 4, 9),
        ("        ((red[k] + red[NVT + k]) + red[2 * NVT + k]) + "
         "red[3 * NVT + k];\n", "", 2, 10),
    ],
}
STAMPS.update({
    ENC_FWD: [
        ("  drop.load_seed();\n", "", 2, None),
        ("", "  int parity = 0;\n", 2, 0),
        ("    __syncthreads();                   // ... and v, m of every "
         "row\n", "", 4, 1),
        ("    __syncthreads();                   // R1 whole; the x tile "
         "read\n", "", 4, 2),
        ("        __syncthreads();               // R1 whole\n", "", 8, 2),
        ("      __syncthreads();                 // the c tile whole; R1's "
         "taps read\n", "", 6, 3),
        ("      mma_ring_w<S::PER / 2>(acc, tc::smem_u32(cs), ring, wg, "
         "lane);\n", "", 6, 4),
        ("                                      + acc_col(j, lane)), 0.f);\n",
         "", 6, 5),
        ("    }\n", "  }\n  tc::cluster_sync();", 4, 6),
        ("  tc::cluster_sync();                  // no CTA leaves while its "
         "pair copies\n", "", 2, 7),
    ],
    ENC64: [
        ("  drop.load_seed();\n", "", 2, None),
        ("", "  const int tiles = (N + nseq - 1) / nseq;\n", 2, 0),
        ("    wg_sync();                         // v and m\n", "", 4, 1),
        ("", "    };\n    // two threads a column: column cd", 6, 2),
        ("", "    };\n    // y = c pw_i + pwb_i in acc (c the C tile", 6, 3),
        ("", "    };\n    // g_y = g (y > 0) rounded to bf16 (A from "
         "registers, rows out), then", 6, 4),
        ("      tc::fence_regs(acc);\n", "    };\n    // acc (g_c) into R1",
         6, 5),
        ("      wg_sync();                       // g_c is whole\n", "", 6,
         6),
        ("      dsum[MAX_K * D] += gdwb;\n", "", 6, 7),
        ("        acc[2 * pr + 1] = a.y;\n      }\n",
         "    };\n    // LayerNorm backward", 6, 8),
        ("", "    };\n    auto from_h = [&]", 6, 9),
        ("", "    if (wlive) {\n      ln_bwd([&](int pr) { return "
         "make_float2(hv[2 * pr], hv[2 * pr + 1]); },", 4, 10),
        ("      }\n    }\n", "  }\n\n  // ---- the block's parameter-vector "
         "partials, written once", 4, 11),
        ("  }\n", "}\n", 2, 12),
    ],
    TRI_FWD: [
        ("  if (DROP) drop.load_seed();\n", "", 2, None),
        ("", "  for (int j = 0; j < passes; ++j) {\n", 2, 0),
        ("", "    tc::cp_async_wait<0>();\n    tc::bar_sync(1 + wg, 128);"
         "         // this tile's s and v\n", 4, 1),
        ("    tc::bar_sync(1 + wg, 128);         // this tile's s and v\n",
         "", 4, 2),
        ("", "    // the A fragments of slab p", 4, 3),
        ("    build(0, fa[0]);\n", "", 4, 4),
        ("    tc::fence_regs(acc[1]);\n", "", 4, 5),
        ("", "#pragma unroll\n    for (int hf = 0; hf < 2; ++hf)\n#pragma "
         "unroll\n      for (int pr = 0; pr < 32; ++pr) {", 4, 6),
        ("    tc::bar_sync(1 + wg, 128);         // the output tile is read\n",
         "", 4, 7),
    ],
    TRI64: [
        ("  drop.load_seed();\n", "", 2, None),
        ("", "  for (int j = 0; j < n; ++j) {\n    const long long r0", 2, 0),
        ("", "    if (j > 0) {\n      tc::cp_async_wait<0>();", 4, 1),
        ("", "    const uint8_t* s_s = half(j);\n", 4, 2),
        ("    tc::bar_sync(1 + wg, 128);         // the yd tile is whole\n",
         "", 4, 3),
        ("    tc::fence_regs(acc);\n",
         "    // ---- LN_out and ReLU backward; g_y1 into its tile", 4, 4),
        ("    tc::bar_sync(1 + wg, 128);         // the g_y1 tile is whole; "
         "yd is read\n", "", 4, 5),
        ("    tile_rows_out<D, 128>(gy1_rows + r0 * D, g1_s, rows, t);\n",
         "", 4, 6),
        ("", "    // ---- pass B: gs and gv through", 4, 7),
        ("    tc::bar_sync(1 + wg, 128);         // the gs and gv tiles are "
         "whole\n", "", 4, 8),
        ("    tile_rows_out<D, 128>(gv + r0 * D, g1_s, rows, t);\n",
         "  }\n", 4, 9),
        ("    vec_part[static_cast<size_t>(blockIdx.x) * NVT + k] = acc_k;\n"
         "  }\n", "}\n", 2, 10),
    ],
    ATT_FWD64: [
        ("  if (DROP) drop.load_seed();\n", "", 2, None),
        ("", "  int unit = -1, b = 0, m0 = 0, target = -1;\n", 2, 0),
        ("", "    const float* qm_s = reinterpret_cast<const float*>(sl + "
         "S::S_QM);\n", 4, 1),
        ("", "    float att[D / 2];\n    tc_att<LRP, 1>", 4, 2),
        ("    tc_att<LRP, 1>(att, s, cm, qm_s, tc::smem_u32(sl + S::S_QE), "
         "lane);\n", "", 4, 3),
        ("", "    // ---- the projection, yd from registers", 4, 4),
        ("    tc::fence_regs(acc);\n",
         "    // ---- bias, ReLU, out through the frame's qn slot", 4, 5),
        ("    tc::bar_sync(1 + wg, 128);         // the output tile is whole\n",
         "", 4, 6),
        ("          *reinterpret_cast<const uint4*>(sl + tc::swz_chunk(r, "
         "ch));\n    }\n", "  }\n}\n", 4, 7),
    ],
    ENC_FWD64: [
        ("  if (DROP) drop.load_seed();\n", "", 2, None),
        ("", "  int par = 0;\n", 2, 0),
        ("", "    // ---- layer 0: h0 = x + pe, LN_0", 4, 1),
        ("    wg_sync();                         // R1 is whole; X is read\n",
         "", 4, 2),
        ("    conv(0);\n    wg_sync();                         // C is whole; "
         "R1's taps are read\n", "", 4, 3),
        ("    layer(0);\n", "", 4, 4),
        ("    wg_sync();                         // R1 is whole\n", "", 4, 5),
        ("    conv(1);\n    wg_sync();                         // C is "
         "whole\n", "", 4, 6),
        ("    layer(1);\n", "", 4, 7),
        ("      wg_sync();                       // H holds every piece\n",
         "", 6, 8),
        ("      wg_sync();                       // the output tile is "
         "whole\n", "", 6, 8),
        ("    }\n", "  }\n}\n", 4, 9),
    ],
    TRI_FWD64: [
        ("  if (DROP) drop.load_seed();\n", "", 2, None),
        ("", "  for (int j = 0; j < n; ++j) {\n", 2, 0),
        ("", "    tc::cp_async_wait<1>();            // this tile's rows\n",
         4, 1),
        ("", "    uint8_t* s_s = room + (j & 1) * S::SLOT;\n", 4, 2),
        ("", "    // yd's A fragments of group g", 4, 3),
        ("    tc::fence_regs(acc);\n", "", 4, 4),
        ("", "    // ---- out in bf16 through the warp's rows", 4, 5),
        ("    __syncwarp();                      // the slot is read: it may "
         "refill\n", "", 4, 6),
    ],
    ENC_FWD64_SHARED: [
        ("  drop.load_seed();\n", "", 2, None),
        ("", "  int parity = 0;\n", 2, 0),
        ("    __syncthreads();                   // ... and v, m of every "
         "row\n", "", 4, 1),
        ("    __syncthreads();                   // R1 whole; the x tile "
         "read\n", "", 4, 2),
        ("      tc::wait_all();\n", "", 6, 3),
        ("        __syncthreads();               // R1 whole\n", "", 8, 4),
        ("        hv[j] += fmaxf(acc[j] + __ldg(P.pwb(i) + acc_col(j, lane)), "
         "0.f);\n", "", 6, 5),
        ("    }\n", "  }\n}\n", 4, 6),
    ],
    TRI_FWD64_SHARED: [
        ("  drop.load_seed();\n", "", 2, None),
        ("", "  int buf = 0;\n", 2, 0),
        ("    tri_keep_bits<D>(drop, row, lane, half, kw);\n", "", 4, 1),
        ("    __syncthreads();\n", "    const uint8_t* s_s = sm + S::O_SV",
         4, 2),
        ("    tri_ln_in_stats<D>(s_s, v_s, ex_s, mean, istd, wg, rl, lane, "
         "drop.inv3);\n", "", 4, 3),
        ("    __syncthreads();                   // the yd tile is whole\n",
         "", 4, 4),
        ("    tri_y1_mma<D>(acc, yd_s, w_s, wg);\n", "", 4, 5),
        ("    tri_ln_out_stats<D>(acc, bias_s, ex_s + 2 * TM * 2, m2, i2, wg, "
         "rl,\n                        lane, drop.inv1);\n", "", 4, 6),
        ("    }\n", "  }\n}\n", 4, 7),
    ],
    ATT_FWD: [
        ("  drop.load_seed();\n", "", 2, None),
        ("", "  int loaded = -1;", 2, 0),
        ("", "    // ---- scores of the warpgroup's regions", 4, 1),
        ("    __syncthreads();                   // the p tile is whole\n", "",
         4, 2),
        ("", "    // ---- LayerNorm over [ce; att; ce * att]", 4, 3),
        ("    __syncthreads();                   // the yd tile is whole\n",
         "", 4, 4),
        ("    mma_ring_w<S::PER>(acc, tc::smem_u32(yd_s), ring, wg, lane);\n",
         "", 4, 5),
        ("    }\n", "  }\n  tc::cluster_sync();", 4, 6),
        ("  tc::cluster_sync();                  // no CTA leaves while its "
         "pair copies\n", "", 2, 7),
    ],
})


def _resident(nks, a_addr):
    """A product of ``nks`` depth steps over ring slot 0 as it stands (W
    "resident": no slab taken), the text that replaces a ring product."""
    return (
        "{\n"
        "      const uint32_t st0 = tc::smem_u32(sm + S::O_RING)"
        " + 2 * wg * SLAB_PANEL;\n"
        "      tc::fence();\n"
        "#pragma unroll\n"
        f"      for (int ks = 0; ks < {nks}; ++ks)\n"
        "        tc::mma_ss<128, 0, 1>(acc, tc::make_desc("
        f"{a_addr} + (ks / 4) * TILE_PANEL + (ks % 4) * 32, 16),"
        " tc::make_desc(st0 + (ks % 2) * 2 * tc::ATOM_BYTES, SLAB_PANEL),"
        " ks > 0);\n"
        "      tc::commit();\n      tc::wait<0>();\n"
        "      tc::fence_regs(acc);\n    }\n")


def _ring_only(ns):
    """The slabs taken and given back with no product, the text that
    replaces a ring product."""
    return ("{\n"
            f"      for (int p = 0; p < {ns}; ++p) {{\n"
            "        ring.take();\n        ring.give(lane);\n      }\n"
            "#pragma unroll\n      for (int j = 0; j < 64; ++j) acc[j] = 0.f;"
            "\n    }\n")


# The D = 256 forwards with one part taken out (their results wrong):
# W resident (no slab copied or waited for: the ring's total is 0 and the
# products read slot 0 as it stands), the ring with no product (the slabs
# still come and go), the dropout's keep bits (as if the dropout were off).
FWD_ABLATIONS = {
    ENC_FWD: {
        "W resident": [
            ("            walk * S::PER);\n", "            0);\n"),
            ("      mma_ring_w<S::PER / 2>(acc, tc::smem_u32(cs), ring, wg, "
             "lane);\n", "      " + _resident(16, "tc::smem_u32(cs)"))],
        "no products": [
            ("      mma_ring_w<S::PER / 2>(acc, tc::smem_u32(cs), ring, wg, "
             "lane);\n", "      " + _ring_only("S::PER / 2"))],
        "no keep bits": [
            ("    if (drop.on())\n      tc_keep_bits<16, true>(",
             "    if (false)\n      tc_keep_bits<16, true>(")],
    },
    ATT_FWD: {
        "W resident": [
            ("            (u1 - u0) * S::PER);\n", "            0);\n"),
            ("    mma_ring_w<S::PER>(acc, tc::smem_u32(yd_s), ring, wg, "
             "lane);\n", "    " + _resident(48, "tc::smem_u32(yd_s)"))],
        "no products": [
            ("    mma_ring_w<S::PER>(acc, tc::smem_u32(yd_s), ring, wg, "
             "lane);\n", "    " + _ring_only("S::PER"))],
        "no keep bits": [
            ("      if (DROP)                        // a call: no product "
             "is in flight\n        tc_keep_bits<16, true>(",
             "      if (false)\n        tc_keep_bits<16, true>(")],
    },
}
# The D = 64 forwards with one design choice changed (their results
# right, so each is a design measured against the tree's own): the
# encoder's three warpgroups a block where it takes four, its conv two
# threads a column a float a row (where four threads take a column pair a
# float2 a row) and unrolled 4x, its max's fast path for a warp whose 16
# rows are one sequence's, its keep bits inline; the tri bridge's four
# warpgroups where it takes three, and its keep bits inline.  An edit's
# old text that starts with WHOLE is made in the whole source (the
# layouts lie outside the kernels).
WHOLE = "@whole:"
FWD_ABLATIONS[ENC_FWD64] = {
    "three warpgroups": [
        (WHOLE + "  static constexpr int NWG = 4;                       "
         "// warpgroups a block\n  static constexpr int NT = 128 * NWG;",
         "  static constexpr int NWG = 3;\n"
         "  static constexpr int NT = 128 * NWG;")],
    "conv two threads a column": [
        ("  const int cp = lane;\n"
         "  const int lb = warp * L / 4, le = (warp + 1) * L / 4;\n",
         "  const int cd = t & (D - 1), hf = t / D;\n"
         "  const int lb = hf ? (L + 1) / 2 : 0, le = hf ? L : (L + 1) / 2;\n"),
        ("""      float2 w[K];
#pragma unroll
      for (int j = 0; j < K; ++j) w[j] = ldg2(P.dw(i) + j * D + 2 * cp);
      const float2 bias = ldg2(P.dwb(i) + 2 * cp);
      auto tv = [&](int r) {
        const float2 a = *reinterpret_cast<const float2*>(
            r1 + r1_at<D>(r, 2 * cp));
        const float vv = v_s[r];
        return make_float2(a.x * vv, a.y * vv);
      };
      for (int base = 0; base < rows; base += L) {
        float2 win[K];                 // win[j] = t v of row l + j - pad
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
          const int l = lb + j - pad;
          win[j + 1] = l >= 0 && l < L ? tv(base + l)
                                       : make_float2(0.f, 0.f);
        }
        for (int l = lb; l < le; ++l) {
#pragma unroll
          for (int j = 0; j + 1 < K; ++j) win[j] = win[j + 1];
          win[K - 1] = l + pad < L ? tv(base + l + pad)
                                   : make_float2(0.f, 0.f);
          float2 a = bias;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            a.x = fmaf(w[j].x, win[j].x, a.x);
            a.y = fmaf(w[j].y, win[j].y, a.y);
          }
          *reinterpret_cast<uint32_t*>(c_s + tc::swz(base + l, 2 * cp)) =
              tc::pack_bf16(a.x, a.y);
        }
      }
""", """      float w[K];
#pragma unroll
      for (int j = 0; j < K; ++j) w[j] = __ldg(P.dw(i) + j * D + cd);
      const float bias = __ldg(P.dwb(i) + cd);
      auto tv = [&](int r) { return r1[r1_at<D>(r, cd)] * v_s[r]; };
      for (int base = 0; base < rows; base += L) {
        float win[K];
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
          const int l = lb + j - pad;
          win[j + 1] = l >= 0 && l < L ? tv(base + l) : 0.f;
        }
        for (int l = lb; l < le; ++l) {
#pragma unroll
          for (int j = 0; j + 1 < K; ++j) win[j] = win[j + 1];
          win[K - 1] = l + pad < L ? tv(base + l + pad) : 0.f;
          float a = bias;
#pragma unroll
          for (int j = 0; j < K; ++j) a = fmaf(w[j], win[j], a);
          *reinterpret_cast<__nv_bfloat16*>(c_s + tc::swz(base + l, cd)) =
              __float2bfloat16(a);
        }
      }
""")],
    "conv unrolled 4x": [
        ("        for (int l = lb; l < le; ++l) {\n",
         "#pragma unroll 4\n        for (int l = lb; l < le; ++l) {\n")],
    "max fast path": [
        ("        const bool join = 16 * warp + 8 <= last[0];\n",
         "        const bool join = 16 * warp + 8 <= last[0];\n"
         "        const bool whole = 16 * warp + 15 < rows\n"
         "            && 16 * warp / L == (16 * warp + 15) / L;\n"),
        ("#pragma unroll\n        for (int o = 1; o < 8; o <<= 1) {\n",
         "#pragma unroll\n        for (int o = 1; o < 8 && !(16 * warp + 15 < "
         "rows && 16 * warp / L == (16 * warp + 15) / L); o <<= 1) {\n"),
        ("            if (join) val[j + e] = fmaxf(val[j + e], p);\n",
         "            if (join && !whole) val[j + e] = fmaxf(val[j + e], p);\n"
         "            if (whole) {\n"
         "              float m = fmaxf(val[j + e], val[j + 2 + e]);\n"
         "              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));\n"
         "              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));\n"
         "              val[j + e] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, "
         "16));\n            }\n")],
    "keep bits inline": [
        ("      tc_keep_bits<D / 8, true>(drop,",
         "      tc_keep_bits<D / 8, false>(drop,")],
}
FWD_ABLATIONS[TRI_FWD64] = {
    "four warpgroups": [
        (WHOLE + "struct TriFwd64 {\n  static constexpr int D = 64;\n"
         "  static constexpr int NWG = 3;",
         "struct TriFwd64 {\n  static constexpr int D = 64;\n"
         "  static constexpr int NWG = 4;")],
    "keep bits inline": [
        ("        tc_keep_bits<D / 8, true>(\n            drop, drop.key3(",
         "        tc_keep_bits<D / 8, false>(\n            drop, drop.key3(")],
}
# The redesigned tri bridge forward at D = 256 with one part taken out
# (its results wrong): W resident (no slab copied or waited for: the
# products read slot 0 as it stands), no products (the slabs still come and
# go), no keep bits (the dropout's draws).
FWD_ABLATIONS[TRI_FWD] = {
    "W resident": [
        ("wp, passes * PER);\n", "wp, 0);\n"),
        ("      const uint32_t st = ring.take();\n",
         "      const uint32_t st = tc::smem_u32(sm + S::O_RING);\n"),
        ("      tc::wait<0>();                   // slab p's products are "
         "done\n      ring.give(lane);\n",
         "      tc::wait<0>();\n")],
    "no products": [
        ("        for (int hf = 0; hf < 2; ++hf)\n          tc::mma_rs<128, 1>(",
         "        for (int hf = 0; hf < 2 * 0; ++hf)\n"
         "          tc::mma_rs<128, 1>(")],
    "no keep bits": [
        ("    if constexpr (DROP) {\n      long long row[2];",
         "    if constexpr (false) {\n      long long row[2];")],
}
# The attention's g_yd loop with one part taken out, (old, new) edits of
# its kernel: the tensor-core wait after each slab (one wait at the end of
# the four), the barrier before each slab, the products of three slabs of
# four, the copies of W into the ring (the groups still committed).
ABLATIONS = {
    "no wait a slab": [
        ("      tc::commit();\n      tc::wait_all();\n      ++used;\n",
         "      tc::commit();\n      ++used;\n"),
        ("    tc::fence_regs(acc);\n",
         "    tc::wait_all();\n    tc::fence_regs(acc);\n")],
    "no barrier a slab": [
        ("      tc::fence_async_smem();\n      __syncthreads();\n"
         "      const int sl = used % S::PER_TILE;\n",
         "      tc::fence_async_smem();\n"
         "      const int sl = used % S::PER_TILE;\n")],
    "products of one slab in four": [
        ("#pragma unroll\n      for (int s = 0; s < 4; ++s)\n"
         "        tc::mma_ss<64, 0, 0>(acc,",
         "#pragma unroll\n      for (int s = 0; s < 4 * (kc == 0); ++s)\n"
         "        tc::mma_ss<64, 0, 0>(acc,")],
    "no W copies": [("    if (j < total) {\n", "    if (j < 0) {\n")],
}
# The tri bridge at D = 256 with one part taken out (its results wrong):
# the yd rows written out, the P and Q scratch rows (pass A's stores, pass
# B's loads), the dropout's keep bits (as if the dropout were off), W's
# copies into the ring (each slot's barrier completed with no bytes).
TRI_ABLATIONS = {
    "no yd rows": [
        ("    tile_rows_out<3 * D>(yd_rows + r0 * (3 * D), yd_s, rows, tid);\n",
         "")],
    "no PQ rows": [
        ("              if (g != 2 && live[h])\n",
         "              if (g != 2 && live[h] && R < 0)\n"),
        ("      if (live[h]) {\n        P = ", "      if (live[h] && R < 0) {\n        P = ")],
    "no keep bits": [
        ("    tri_keep_bits<D>(drop, row, lane, half, kw);\n",
         "    tri_keep_bits<D>(Dropout{}, row, lane, half, kw);\n")],
    "no W copies": [
        ("      tc::mbar_expect_tx(full + k, S::SLAB);\n", ""),
        ("      tc::bulk_g2s(S::slot_ptr(sm, k), Wp + static_cast<size_t>(sl) "
         "* (S::SLAB / 2),\n                   S::SLAB, full + k);\n",
         "      tc::mbar_arrive(full + k);\n")],
}
DEFS = r"""
#include <cuda_runtime.h>
__device__ unsigned long long tvqa_phase_cycles[32];
#define TVQA_PHASE_INIT long long tvqa_ph_last = clock64();
#define TVQA_PHASE(i)                                                      \
  if (threadIdx.x == 0) {                                                  \
    const long long tvqa_now = clock64();                                  \
    atomicAdd(&tvqa_phase_cycles[(i)],                                     \
              static_cast<unsigned long long>(tvqa_now - tvqa_ph_last));   \
    tvqa_ph_last = tvqa_now;                                               \
  }
extern "C" int tvqa_phase_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, tvqa_phase_cycles,
                                       sizeof(tvqa_phase_cycles));
  static const unsigned long long zero[32] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(tvqa_phase_cycles, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""


def variant(text, src):
    """The design of ``src`` whose kernel ``text`` holds (a key of
    ``KERNEL_START``)."""
    for name in VARIANTS.get(src, (src,)):
        if KERNEL_START[name] in text:
            return name
    raise ValueError(f"{src}: no known kernel design in the text")


def kernel_span(text, src):
    """(start, end) of the kernel in ``text`` that ``src``'s edits go
    into (``src`` a source or one of its designs)."""
    start = KERNEL_START.get(src)
    if start is None or start not in text:
        start = KERNEL_START[variant(text, src)]
    i0 = text.index(start)
    return i0, text.index("\n}\n", i0) + 3


def edit_kernel(text, src, edits):
    """``text`` with each (old, new) of ``edits`` made in ``src``'s kernel
    (an ``old`` that starts with ``WHOLE``: in the whole text); raises on an
    ``old`` that does not occur there exactly once."""
    for old, new in edits:
        if old.startswith(WHOLE):
            if text.count(old[len(WHOLE):]) != 1:
                raise ValueError(f"{src}: {text.count(old[len(WHOLE):])} "
                                 f"places for {old!r}")
            text = text.replace(old[len(WHOLE):], new)
    edits = [(o, n) for o, n in edits if not o.startswith(WHOLE)]
    i0, i1 = kernel_span(text, src)
    body = text[i0:i1]
    for old, new in edits:
        if body.count(old) != 1:
            raise ValueError(f"{src}: {body.count(old)} places for {old!r}")
        body = body.replace(old, new)
    return text[:i0] + body + text[i1:]


def stamped(text, src):
    """``text`` with the phase stamps of ``src``'s design in it inserted."""
    name = variant(text, src)
    edits = []
    for before, after, indent, phase in STAMPS[name]:
        mark = "TVQA_PHASE_INIT" if phase is None else f"TVQA_PHASE({phase})"
        edits.append((before + after,
                      before + " " * indent + mark + "\n" + after))
    return edit_kernel(text, name, edits)


def build_copies(build, copies):
    """Each (name, source, text) of ``copies`` built into
    build/phase_split, all at once; returns {name: library path}."""
    out_dir = os.path.join(os.getcwd(), "build", "phase_split")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src, text in copies:
        path = os.path.join(out_dir, name.replace(" ", "_") + ".cu")
        with open(path, "w") as f:
            f.write(DEFS + f'#line 1 "{source_file(src)}"\n' + text)
        lib = path[:-3] + ".so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", lib,
               path]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(log)
        libs[name] = lib
    return libs


def use_library(build, src, path):
    """Point every kernel of ``src`` at the library at ``path``; returns
    the library."""
    lib = ctypes.CDLL(path)
    for kernel in build.KERNELS:
        if kernel.source == source_file(src):
            fn = getattr(lib, kernel.symbol)
            fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
            kernel._fn = fn
    return lib


def device_ms(fn, reps=10):
    """{kernel name: device ms per call of ``fn``} from torch.profiler: the
    mean of the launches the trace holds times the launches a call.  Late in
    a long process the trace can miss launches (the same build once read
    k / 10 of its first reading over 10 calls), so the sum over ``reps``
    calls is not the measure."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and e.count > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0][:60]
            per_call = -(-e.count // reps)      # launches a call
            if e.count % reps:
                print(f"{name}: {e.count} launches in the trace of {reps} "
                      "calls", file=sys.stderr, flush=True)
            times[name] = (times.get(name, 0.0) + e.device_time_total
                           / e.count * per_call / 1e3)
    return times


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    d = int(args[args.index("--width") + 1]) if "--width" in args else 256
    families = args[args.index("--families") + 1].split(",") \
        if "--families" in args else list(SOURCE_OF)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tvqaplus_tpu_torch.ops import _build as build
    dev = torch.device("cuda")
    build.build_all()
    print(cs.phase_device(), flush=True)
    forward = "--forward" in args
    calls = {}
    if forward:
        srcs = FWD_SOURCE_OF_64 if d == 64 else FWD_SOURCE_OF
        families = [f for f in families if f in srcs]
        for case in cs.kernel_cases(dev, d):
            if case.key not in families or "no mask" in case.name:
                continue
            if case.key == "tri_bridge" and d not in (64, 256):
                continue
            a, kw = case.args(torch.bfloat16)
            for rate in (0.0, cs.P_DROP):
                kwr = {**kw, "dropout_rate": rate, "seed": cs.DROP_SEED}
                calls[f"{case.name} dropout {rate}"] = (
                    srcs[case.key],
                    lambda c=case, a=a, k=kwr: c.kernel(*a, **k))
    for case in [] if forward else cs.train_kernel_cases(dev, d):
        if case.key not in families or "no mask" in case.name:
            continue
        a, base_kw = case.args(torch.bfloat16)
        kw = {**base_kw, **case.kw}
        ins, leaves = cs._leaves(a, case.diff)
        outs = cs._outputs(case.kernel(*ins, **kw))
        cots = [torch.ones_like(o) for o in outs]
        src = (SOURCE_OF_64 if d == 64 else {}).get(case.key,
                                                    SOURCE_OF[case.key])
        calls[case.name] = (src, lambda o=outs, l=leaves, c=cots:
                            torch.autograd.grad(o, l, c, retain_graph=True))
    own = {name: device_ms(fn) for name, (_, fn) in calls.items()}
    texts = {}
    srcs = sorted({src for src, _ in calls.values()})
    for src in srcs:
        with open(os.path.join(build.CSRC, source_file(src))) as f:
            texts[src] = f.read()
    copies = [(f"stamped {tag(src)}", src, stamped(texts[src], src))
              for src in srcs]
    ablations = {}
    if "--ablations" in args:
        # by design: a table applies to the design the tree holds
        tables = {ATT: ABLATIONS, TRI: TRI_ABLATIONS} if not forward \
            else FWD_ABLATIONS
        for src in srcs:
            design = variant(texts[src], src)
            for name, edits in tables.get(design, {}).items():
                name = f"{name} ({tag(design)})" if forward else name
                ablations[name] = src
                copies.append((name, src,
                               edit_kernel(texts[src], design, edits)))
    libs = build_copies(build, copies)
    readers = {src: use_library(build, src, libs[f"stamped {tag(src)}"])
               .tvqa_phase_read for src in srcs}
    buf = (ctypes.c_ulonglong * 32)()
    for name, (src, fn) in calls.items():
        fn()
        torch.cuda.synchronize()
        readers[src](buf)             # reset
        fn()
        torch.cuda.synchronize()
        if readers[src](buf) != 0:
            raise RuntimeError("reading the phase counters failed")
        names = PHASES[variant(texts[src], src)]
        cycles = {names[i]: int(buf[i]) for i in range(len(names))}
        total = sum(cycles.values()) or 1
        print(json.dumps({
            "tree": os.getcwd(), "case": name, "width": d,
            "device_ms": own[name], "cycles": cycles,
            "share": {k: v / total for k, v in cycles.items()}}), flush=True)
    # each copy in turns with the tree's own build (own, copy, own), so a
    # drift of the card's clocks over the run shows in the own pair
    for ablation, src in ablations.items():
        for name, (case_src, fn) in calls.items():
            if case_src != src:
                continue
            turns = []
            for path in (build.lib_path(source_file(src)), libs[ablation],
                         build.lib_path(source_file(src))):
                use_library(build, src, path)
                turns.append(device_ms(fn))
            print(json.dumps({
                "tree": os.getcwd(), "case": name, "width": d,
                "ablation": ablation, "device_ms": turns[1],
                "own_device_ms": [turns[0], turns[2]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
