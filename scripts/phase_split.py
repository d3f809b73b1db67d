"""Where a block's time goes in the bf16 backward kernels at D = 256
(``csrc/qa_ctx_attention_bwd_wide.cu`` ``qa_ctx_bwd_tc_wide_kernel`` and
``csrc/encoder_bwd_tc_wide.cu``'s ``Enc256`` kernel), phase by phase, from
``clock64()`` stamps in a copy of the sources; and what the attention's
g_yd products cost, from copies with parts of them taken out.

    python3 scripts/phase_split.py [--width D] [--ablations]

Run from a tree's root (its ``chip_smoke.py`` and package are imported);
needs one NVIDIA GPU.  The sources in the tree carry no stamps: the script
copies the two into ``build/phase_split/``, inserts ``TVQA_PHASE(i)`` at
the places ``STAMPS`` names (each anchor must occur once in its kernel,
``tests/test_torch_bwd256_layouts.py`` holds them to the sources) with a
buffer of 32 cycle counters in front, and builds the copies beside the
tree's libraries; thread 0 of every block adds the cycles since its last
stamp to counter i.  For each backward case of ``train_kernel_cases`` at
width D (default 256; dropout 0.1) it prints one JSON line: each kernel's
device ms per call from ``torch.profiler`` (the tree's own build), then the
stamped main kernel's cycles per phase and each phase's share.  Thread 0
waits at the block's barriers, so a phase holds the block's critical path
through it, waits included.

``--ablations`` also builds one copy of the attention source for each of
``ABLATIONS`` (its g_yd loop with one part taken out: the results are wrong,
only the time is read) and prints, for each attention case, the main
kernel's device ms under each copy beside the tree's own.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ATT, ENC = "qa_ctx_attention_bwd_wide.cu", "encoder_bwd_tc_wide.cu"
# the kernel a source's stamps go into: from this line to its closing "}"
KERNEL_START = {ATT: "  using S = AttTcWide<LRP>;\n",
                ENC: "  using S = Enc256;\n"}
PHASES = {
    ATT: ("frame", "stage", "keep bits", "scores, softmax", "LN stats",
          "pass A rows", "pass B rows", "g_att, g_p, softmax bwd, gcn",
          "block sums", "g_yd products"),
    ENC: ("setup", "tile head", "LN fwd", "conv", "c pw", "g_y tile",
          "g_y pw^T", "conv bwd", "dw grad", "LN bwd", "t tile", "cotangent",
          "misc", "block sums"),
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


def kernel_span(text, src):
    """(start, end) of the kernel in ``text`` that ``src``'s edits go
    into."""
    i0 = text.index(KERNEL_START[src])
    return i0, text.index("\n}\n", i0) + 3


def edit_kernel(text, src, edits):
    """``text`` with each (old, new) of ``edits`` made in ``src``'s kernel;
    raises on an ``old`` that does not occur there exactly once."""
    i0, i1 = kernel_span(text, src)
    body = text[i0:i1]
    for old, new in edits:
        if body.count(old) != 1:
            raise ValueError(f"{src}: {body.count(old)} places for {old!r}")
        body = body.replace(old, new)
    return text[:i0] + body + text[i1:]


def stamped(text, src):
    """``text`` with ``src``'s phase stamps inserted."""
    edits = []
    for before, after, indent, phase in STAMPS[src]:
        mark = "TVQA_PHASE_INIT" if phase is None else f"TVQA_PHASE({phase})"
        edits.append((before + after,
                      before + " " * indent + mark + "\n" + after))
    return edit_kernel(text, src, edits)


def build_copies(build, copies):
    """Each (name, source, text) of ``copies`` built into
    build/phase_split, all at once; returns {name: library path}."""
    out_dir = os.path.join(os.getcwd(), "build", "phase_split")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src, text in copies:
        path = os.path.join(out_dir, name.replace(" ", "_") + ".cu")
        with open(path, "w") as f:
            f.write(DEFS + f'#line 1 "{src}"\n' + text)
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
        if kernel.source == src:
            fn = getattr(lib, kernel.symbol)
            fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
            kernel._fn = fn
    return lib


def device_ms(fn, reps=10):
    """{kernel name: device ms per call of ``fn``} from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0][:60]
            times[name] = times.get(name, 0.0) + e.device_time_total / reps / 1e3
    return times


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    d = int(args[args.index("--width") + 1]) if "--width" in args else 256
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tvqaplus_tpu_torch.ops import _build as build
    dev = torch.device("cuda")
    build.build_all()
    print(cs.phase_device(), flush=True)
    cases = [c for c in cs.train_kernel_cases(dev, d)
             if c.key in ("qa_ctx_attention", "encoder", "encoder_block")
             and "no mask" not in c.name]
    calls = {}
    for case in cases:
        a, base_kw = case.args(torch.bfloat16)
        kw = {**base_kw, **case.kw}
        ins, leaves = cs._leaves(a, case.diff)
        outs = cs._outputs(case.kernel(*ins, **kw))
        cots = [torch.ones_like(o) for o in outs]
        src = ATT if case.key == "qa_ctx_attention" else ENC
        calls[case.name] = (src, lambda o=outs, l=leaves, c=cots:
                            torch.autograd.grad(o, l, c, retain_graph=True))
    own = {name: device_ms(fn) for name, (_, fn) in calls.items()}
    texts = {}
    for src in (ATT, ENC):
        with open(os.path.join(build.CSRC, src)) as f:
            texts[src] = f.read()
    copies = [(f"stamped {src[:-3]}", src, stamped(texts[src], src))
              for src in (ATT, ENC)]
    if "--ablations" in args:
        copies += [(name, ATT, edit_kernel(texts[ATT], ATT, edits))
                   for name, edits in ABLATIONS.items()]
    libs = build_copies(build, copies)
    readers = {src: use_library(build, src, libs[f"stamped {src[:-3]}"])
               .tvqa_phase_read for src in (ATT, ENC)}
    buf = (ctypes.c_ulonglong * 32)()
    for name, (src, fn) in calls.items():
        fn()
        torch.cuda.synchronize()
        readers[src](buf)             # reset
        fn()
        torch.cuda.synchronize()
        if readers[src](buf) != 0:
            raise RuntimeError("reading the phase counters failed")
        names = PHASES[src]
        cycles = {names[i]: int(buf[i]) for i in range(len(names))}
        total = sum(cycles.values()) or 1
        print(json.dumps({
            "tree": os.getcwd(), "case": name, "width": d,
            "device_ms": own[name], "cycles": cycles,
            "share": {k: v / total for k, v in cycles.items()}}), flush=True)
    if "--ablations" in args:
        att = {name: fn for name, (src, fn) in calls.items() if src == ATT}
        for variant in ABLATIONS:
            use_library(build, ATT, libs[variant])
            for name, fn in att.items():
                print(json.dumps({
                    "tree": os.getcwd(), "case": name, "width": d,
                    "ablation": variant, "device_ms": device_ms(fn),
                    "own_device_ms": own[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
