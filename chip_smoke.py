"""On-card smoke run of the PyTorch/CUDA port (``tvqaplus_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels build for sm_90a) and the CUDA
toolkit.  Phases, each printing one JSON line:

1. device  - the card (``nvidia-smi`` name and power limit), torch/CUDA
             versions; TF32 off for matmuls and convolutions.
2. build   - builds every kernel from ``tvqaplus_tpu_torch/csrc``.
3. kernels - each kernel at the headline serving shapes (batch 16, 5
             answers, 50 frames, 40 QA tokens, 25 regions / 50 subtitle
             tokens, D 128): against its plain version in float32 and in
             bfloat16, times (CUDA events, median of 30 after warm-up) and
             the card's bound for the same work.
4. kernels (training) - each forward kernel with dropout 0.1 (the vid
             attention site in raw mode "target") and each backward kernel
             at the headline training shapes, against the plain version
             (forward) and autograd through it (backward) with the same
             Philox mask, in float32 and bfloat16, and each backward twice
             for the same bits; times and bounds as in 3.
5. main    - writes a run directory (opt.json: synthetic data at the
             headline config, 32 examples, batch 16; best_valid.pth from a
             seeded init), runs the port's inference entry point on the card,
             checks the predictions and that every kernel launched; then one
             headline batch (50 frames) on the card against the same forward
             on the CPU in float32.
6. serving - the eval step (forward, span search, grounding compaction) at
             batch 16 x 50 frames on a batch already on the card: host
             clock over 50 back-to-back steps ended by a synchronise (the
             metric: ms per batch, QA pairs per second), and the median
             CUDA-event time of one step.
7. train main - ``python -m tvqaplus_tpu_torch.main`` on the card at the
             headline training config (--use_sup_att --add_local, batch 16,
             dropout 0.1, bf16) with --debug: checks that the losses are
             finite and that all six forward/backward kernels launched, then
             runs the inference entry point on the run directory it wrote.
8. train vs cpu - one train step (50 frames, batch 4, dropout 0, float32)
             on the card against the same step on the CPU.
9. training - the headline train step (batch 16, 50 frames, bf16, dropout
             0.1) on a batch already on the card: host clock over 20 steps
             ended by a synchronise (ms per step, QA pairs trained per
             second), the median CUDA-event time of one step, and the
             device's busy time and idle share from ``torch.profiler``.

Then the ``kernels`` summary line, and last ``{"ok": true, "device": ...}``.
Any failure exits non-zero without that line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2018
B, A, LQA, LI, LR_VID, LR_SUB, D, K_CLS = 16, 5, 40, 50, 25, 50, 128, 5
# H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core rate
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
REPLACES = {
    "qa_ctx_attention": "tvqaplus_tpu/ops/pallas_attention.py:564",
    "tri_bridge": "tvqaplus_tpu/ops/pallas_tri_bridge.py:276",
    "encoder": "tvqaplus_tpu/ops/pallas_encoder.py:570",
    "qa_ctx_attention_bwd": "tvqaplus_tpu/ops/pallas_attention.py:479",
    "tri_bridge_bwd": "tvqaplus_tpu/ops/pallas_tri_bridge.py:223",
    "encoder_bwd": "tvqaplus_tpu/ops/pallas_encoder.py:493",
}
BWD_SOURCES = {"qa_ctx_attention": "csrc/qa_ctx_attention_bwd.cu",
               "tri_bridge": "csrc/tri_bridge_bwd.cu",
               "encoder": "csrc/encoder_bwd.cu"}
P_DROP, DROP_SEED = 0.1, 20181016
# whole-model tolerances on answer_scores against the CPU float32 forward:
# float32 on the card differs only in summation order (TF32 off); bf16
# activations carry ~3 significant digits through ~10 layers
FWD_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-1, 5e-2)}
SERVING_STEPS = 50
TRAIN_STEPS, PROFILE_STEPS, CPU_STEP_BATCH = 20, 10, 4
# one train step on the card (float32, TF32 off) against the CPU: the loss
# is one float32 reduction of the same values; a gradient may differ where
# a ReLU input or a max tie lies within float32 rounding of its decision
# (ops/checks.py), so it is held relative to its parameter's largest
# gradient (see phase_train_vs_cpu)
STEP_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "grad_rel": 1e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=30, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops):
    """Least time for the work on the card: bytes over the memory rate vs
    operations over the bf16 tensor-core rate, in ms, and which binds."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(got, want):
    return max(float((g.detach().float() - w.detach().float()).abs().max())
               for g, w in zip(got, want))


def assert_close(name, got, want, tol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol[0],
                                   rtol=tol[1], msg=lambda m: f"{name}: {m}")


# ------------------------------------------------------------------ phases
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "ok": True, "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from tvqaplus_tpu_torch.ops import _build
    seconds = _build.build_all()
    usage = {}
    for src in _build.SOURCES:
        with open(_build.lib_path(src)[:-3] + ".log") as f:
            usage[src] = [ln.strip() for ln in f
                          if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "build_dir": os.path.relpath(_build.BUILD_DIR, HERE),
          "ptxas": usage})


def make_masks(gen, dev):
    """Main-path-like masks: QA lengths 10..40, 5..Lr regions per frame,
    videos of 4..50 frames (frames past the end have no regions)."""
    qa_len = torch.randint(10, LQA + 1, (B, A, 1), generator=gen, device=dev)
    c_mask = (torch.arange(LQA, device=dev) < qa_len).float()
    n_img = torch.randint(4, LI + 1, (B, 1), generator=gen, device=dev)
    frame_ok = torch.arange(LI, device=dev) < n_img             # (B, Li)

    def ctx_mask(lr):
        cnt = torch.randint(5, lr + 1, (B, LI, 1), generator=gen, device=dev)
        return ((torch.arange(lr, device=dev) < cnt)
                & frame_ok[..., None]).float()
    return c_mask, ctx_mask(LR_VID), ctx_mask(LR_SUB), frame_ok.float()


def randn(gen, dev, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device=dev) * scale


def kernel_cases(dev):
    """Every kernel at the headline shapes: (name, counter key, module,
    wrapper, plain version, args(dtype) -> (args, kwargs), flops,
    source)."""
    from tvqaplus_tpu_torch.models.attention import l2_normalize
    from tvqaplus_tpu_torch.models.layers import sinusoid_table
    from tvqaplus_tpu_torch.ops import (
        encoder,
        qa_ctx_attention,
        tri_bridge,
    )
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c_mask, vmask, smask, _ = make_masks(gen, dev)
    ce = randn(gen, dev, B, A, LQA, D)
    proj = [1.0 + randn(gen, dev, 3 * D, scale=0.1),
            randn(gen, dev, 3 * D, scale=0.1),
            randn(gen, dev, 3 * D, D, scale=(3 * D) ** -0.5),
            randn(gen, dev, D, scale=0.1)]
    cases = []
    m_rows = A * LQA
    for site, lr, q_mask, raw_mode in (("vid", LR_VID, vmask, "full"),
                                       ("sub", LR_SUB, smask, "none")):
        qe = randn(gen, dev, B, LI, lr, D)

        def args(dt, qe=qe, q_mask=q_mask, raw_mode=raw_mode):
            ce_t, qe_t = ce.to(dt), qe.to(dt)
            return ((l2_normalize(ce_t), ce_t, l2_normalize(qe_t), qe_t,
                     c_mask, q_mask, *proj),
                    dict(scale=10.0, raw_mode=raw_mode))
        flops = 2 * B * LI * m_rows * (2 * lr * D + 3 * D * D)
        cases.append((f"qa_ctx_attention[{site}, raw {raw_mode}]",
                      "qa_ctx_attention", qa_ctx_attention,
                      qa_ctx_attention.qa_ctx_attention,
                      qa_ctx_attention.qa_ctx_attention_plain, args, flops,
                      "csrc/qa_ctx_attention_fwd.cu"))
    s, v = randn(gen, dev, B, A, LI, LQA, D), randn(gen, dev, B, A, LI, LQA, D)
    bridge = [1.0 + randn(gen, dev, 3 * D, scale=0.1),
              randn(gen, dev, 3 * D, scale=0.1),
              randn(gen, dev, 3 * D, D, scale=(3 * D) ** -0.5),
              randn(gen, dev, D, scale=0.1),
              1.0 + randn(gen, dev, D, scale=0.1), randn(gen, dev, D,
                                                         scale=0.1)]
    cases.append(("tri_bridge", "tri_bridge", tri_bridge,
                  tri_bridge.tri_bridge, tri_bridge.tri_bridge_plain,
                  lambda dt: ((s.to(dt), v.to(dt), *bridge), {}),
                  2 * B * A * LI * LQA * 3 * D * D,
                  "csrc/tri_bridge_fwd.cu"))
    g = A * LI
    x = randn(gen, dev, B, g, LQA, D)
    rmask = (c_mask[:, :, None, :] * vmask.amax(-1)[:, None, :, None]
             ).reshape(B, g, LQA).contiguous()
    p = {}
    for i in (0, 1):
        p.update({f"ln{i}_s": 1.0 + randn(gen, dev, D, scale=0.1),
                  f"ln{i}_b": randn(gen, dev, D, scale=0.1),
                  f"dw{i}": randn(gen, dev, K_CLS, D, scale=0.3),
                  f"dwb{i}": randn(gen, dev, D, scale=0.1),
                  f"pw{i}": randn(gen, dev, D, D, scale=D ** -0.5),
                  f"pwb{i}": randn(gen, dev, D, scale=0.1)})
    p["lnf_s"] = 1.0 + randn(gen, dev, D, scale=0.1)
    p["lnf_b"] = randn(gen, dev, D, scale=0.1)
    pe = sinusoid_table(LQA, D).to(dev)
    cases.append(("encoder_reduce", "encoder", encoder,
                  encoder.encoder_reduce, encoder.encoder_reduce_plain,
                  lambda dt: ((x.to(dt), pe, p, K_CLS, rmask), {}),
                  2 * 2 * B * g * LQA * D * D, "csrc/encoder_fwd.cu"))
    return cases


def phase_kernels(dev):
    rows = []
    for (name, key, mod, kernel, plain, args, flops, src) in kernel_cases(dev):
        errs = {}
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            a, kw = args(dt)
            got = kernel(*a, **kw)
            # the plain version computes in float32 on the same values and
            # rounds its output to the kernel's output type
            want = plain(*a, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            tol = mod.TOL[dt]
            if isinstance(tol, dict):      # per-output tolerances
                for (out, g_, w_) in zip(("mixed", "raw"), got, want):
                    assert_close(f"{name} {dname} {out}", [g_], [w_],
                                 tol[out])
            else:
                assert_close(f"{name} {dname}", got, want, tol)
            errs[dname] = max_err(got, want)
        a, kw = args(torch.bfloat16)
        outs = kernel(*a, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        moved = nbytes(*(t for t in a if torch.is_tensor(t)), *outs)
        if key == "encoder":
            moved += nbytes(*a[2].values())
        b_ms, b_by = bound(moved, flops)
        row = {"name": name, "route": "cuda",
               "source": f"tvqaplus_tpu_torch/{src}",
               "replaces": REPLACES[key],
               "max_abs_err": errs["bfloat16"],
               "max_abs_err_f32": errs["float32"],
               "ms": time_ms(lambda: kernel(*a, **kw)),
               "plain_ms": time_ms(lambda: plain(*a, **kw)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "bytes": moved, "flops": flops, "_key": key}
        emit({"phase": "kernel", "ok": True,
              **{k: v for k, v in row.items() if k != "_key"}})
        rows.append(row)
    return rows


def headline_batch(cfg, dev):
    from tvqaplus_tpu_torch.data.batching import (
        StaticShapeSpec,
        collate_static,
    )
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    ds = SyntheticTVQADataset(cfg, B, mode="valid")
    spec = StaticShapeSpec.from_config(cfg, batch=B).with_max_img(LI)
    arrays, _ = collate_static([ds[i] for i in range(B)], spec)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def phase_main(dev, kernel_mods, workdir):
    from tvqaplus_tpu_torch.config import Config
    from tvqaplus_tpu_torch.inference import main_inference
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    cfg = Config(synthetic_data=True, add_local=True, bsz=B, test_bsz=B,
                 synthetic_n_valid=32, seed=SEED)
    cfg.save(os.path.join(workdir, "opt.json"))    # compute_dtype "auto"
    cfg.finalize("cpu")
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(SEED))
    sd = model.state_dict()
    torch.save(sd, os.path.join(workdir, "best_valid.pth"))

    reset_counters(kernel_mods)
    t0 = time.perf_counter()
    pred_path = main_inference(["--model_dir", workdir, "--device", "cuda"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.KERNEL.launches
                for m in kernel_mods}
    with open(pred_path) as f:
        pred = json.load(f)
    missing = [q for q in range(32) if str(q) not in pred["ts_answer"]]
    n_records = sum(len(recs) for ex in pred["raw_bbox"]
                    for recs in ex.values())
    n_boxes = sum(len(r["bbox"]) for ex in pred["raw_bbox"]
                  for recs in ex.values() for r in recs)
    if missing or n_records == 0:
        raise AssertionError(f"predictions: missing qids {missing}, "
                             f"{n_records} grounding records")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")

    # one headline batch on the card against the CPU float32 forward
    cpu_cfg = ModelConfig.from_config(cfg)
    ref_model = STAGE(cpu_cfg).eval()
    ref_model.load_state_dict(sd)
    cpu_batch = headline_batch(cfg, "cpu")
    with torch.inference_mode():
        ref = ref_model(cpu_batch, need_sub_raw=False)["answer_scores"]
    checks = {}
    for dname in ("float32", "bfloat16"):
        gpu_model = STAGE(dataclasses.replace(cpu_cfg,
                                              compute_dtype=dname)).eval()
        gpu_model.load_state_dict(sd)
        gpu_model.to(dev)
        with torch.inference_mode():
            got = gpu_model({k: v.to(dev) for k, v in cpu_batch.items()},
                            need_sub_raw=False)["answer_scores"].float().cpu()
        err = float((got - ref).abs().max())
        top2 = ref.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        agree = got.argmax(-1) == ref.argmax(-1)
        atol, rtol = FWD_TOL[dname]
        torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
        # in float32 every argmax must agree; in bf16 every one whose f32
        # margin exceeds twice the observed error
        need = torch.ones_like(agree) if dname == "float32" \
            else margin > 2 * err
        if not bool(agree[need].all()):
            raise AssertionError(f"{dname}: argmax differs from the CPU "
                                 f"float32 forward: {agree.tolist()}")
        checks[dname] = {"max_abs_err": err, "tol": [atol, rtol],
                         "argmax_agree": int(agree.sum()), "rows": B}
    emit({"phase": "main", "ok": True, "launches": launches,
          "examples": 32, "batches": -(-32 // B), "wall_s": wall_s,
          "ts_answer": len(pred["ts_answer"]),
          "raw_bbox_records": n_records, "raw_bbox_boxes": n_boxes,
          "headline_vs_cpu_f32": checks})
    return cfg, sd, launches


def phase_serving(dev, cfg, sd):
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    model = STAGE(dataclasses.replace(ModelConfig.from_config(cfg),
                                      compute_dtype="bfloat16"))
    model.load_state_dict(sd)
    runner = InferenceRunner(cfg, model.to(dev), dev)
    batch = headline_batch(cfg, dev)
    out = {}
    for name, grounding in (("", True), ("_no_grounding", False)):
        def step(grounding=grounding):
            return runner.step(batch, grounding, LI)
        out["event_ms" + name] = time_ms(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_STEPS):
            step()
        torch.cuda.synchronize()
        out["step_ms" + name] = (time.perf_counter() - t0) / SERVING_STEPS \
            * 1e3
    emit({"phase": "serving", "ok": True, "batch": B, "frames": LI,
          "compute_dtype": "bfloat16", "steps": SERVING_STEPS,
          "qa_pairs_per_s": B / (out["step_ms"] / 1e3), **out})


# ---------------------------------------------------------------- training
def train_kernel_cases(dev):
    """The training variants of ``kernel_cases``: dropout 0.1 in every
    kernel, the vid attention site in raw mode "target".  Each case adds the
    differentiable inputs (positions in args; the encoder's parameter dict
    is differentiated as a whole), the plain version's flip rows
    (ops/checks.py) and the backward's operations."""
    from tvqaplus_tpu_torch.ops import checks
    targets = torch.randint(0, A, (B,), generator=torch.Generator(
        device=dev).manual_seed(SEED + 1), device=dev)
    drop = dict(dropout_rate=P_DROP, seed=DROP_SEED)
    cases = []
    for (name, key, mod, kernel, plain, args, flops, src) in kernel_cases(dev):
        if key == "qa_ctx_attention":
            lr = args(torch.float32)[0][2].shape[2]
            site = name[name.index("[") + 1:name.index(",")]
            raw_mode = "target" if site == "vid" else "none"
            kw = dict(raw_mode=raw_mode, targets=targets, **drop)

            def flip(a):
                return checks.attention_flip_rows(
                    *a, dropout_rate=P_DROP, seed=DROP_SEED)[..., None]
            diff = (0, 1, 2, 3, 6, 7, 8, 9)
            m_rows = A * LQA
            # recompute S and att, g_p, gqe, gcn, gqn; g_yd and gW
            bflops = 2 * B * LI * m_rows * (6 * lr * D + 6 * D * D)
            name = f"qa_ctx_attention[{site}, raw {raw_mode}, dropout]"
        elif key == "tri_bridge":
            kw = dict(drop)

            def flip(a):
                return checks.tri_bridge_flip_rows(*a[:6], P_DROP,
                                                   DROP_SEED)[..., None]
            diff = tuple(range(8))
            bflops = 3 * flops             # recompute, g_yd, gW
            name = "tri_bridge[dropout]"
        else:
            kw = dict(drop)

            def flip(a):
                return checks.encoder_flip_groups(*a, P_DROP,
                                                  DROP_SEED)[..., None]
            diff = (0, 2)
            # three D x D products forward (layer 0 twice), g_c and gpw per
            # layer
            bflops = 7 * flops // 2
            name = "encoder_reduce[dropout]"
        cases.append((name, key, mod, kernel, plain, args, kw, flip, diff,
                      flops, bflops, src))
    return cases


def _leaves(a, diff):
    """Fresh leaves of ``a`` (a tuple of args) that require grad at the
    positions in ``diff`` (a dict of tensors: every value)."""
    out, grads = [], []
    for i, t in enumerate(a):
        if i in diff and isinstance(t, dict):
            t = {k: v.detach().clone().requires_grad_(True)
                 for k, v in t.items()}
            grads += list(t.values())
        elif i in diff:
            t = t.detach().clone().requires_grad_(True)
            grads.append(t)
        out.append(t)
    return out, grads


def _outputs(o):
    return o if isinstance(o, tuple) else (o,)


def _cotangents(outs, flip, gen):
    """Random cotangents of the outputs, zero on the flip rows (and on the
    raw scores of masked positions, which sit at -1e10)."""
    cots = []
    for j, o in enumerate(outs):
        c = torch.randn(o.shape, generator=gen, device=o.device)
        if j == 0:
            c = c * ~flip
        else:
            c = c * (o > -1e9)
        cots.append(c.to(o.dtype))
    return cots


def phase_train_kernels(dev):
    """Forward kernels with dropout and the backward kernels against the
    plain version and autograd through it (same Philox mask)."""
    from tvqaplus_tpu_torch.ops import checks
    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for (name, key, mod, kernel, plain, args, kw, flip, diff, flops, bflops,
         src) in train_kernel_cases(dev):
        errs, gerrs = {}, {}
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            a, base_kw = args(dt)
            kwa = {**base_kw, **kw}
            fl = flip(a)
            results = []
            for fn in (kernel, plain):
                ins, leaves = _leaves(a, diff)
                outs = _outputs(fn(*ins, **kwa))
                if not results:
                    cots = _cotangents(outs, fl, gen)
                torch.autograd.backward(outs, cots)
                results.append((outs, [t.grad for t in leaves]))
            torch.cuda.synchronize()
            (got, g_got), (want, g_want) = results
            tol = mod.TOL[dt]
            if isinstance(tol, dict):
                for out, g_, w_ in zip(("mixed", "raw"), got, want):
                    assert_close(f"{name} {dname} {out}", [g_], [w_],
                                 tol[out])
            else:
                assert_close(f"{name} {dname}", got, want, tol)
            errs[dname] = max_err(got, want)
            gerrs[dname] = max(
                checks.grad_close(f"{name} {dname} grad {i}", g, w,
                                  mod.GRAD_TOL[dt])
                for i, (g, w) in enumerate(zip(g_got, g_want)))
        a, base_kw = args(torch.bfloat16)
        kwa = {**base_kw, **kw}
        fl = flip(a)
        graphs = {}
        for tag, fn in (("kernel", kernel), ("plain", plain)):
            ins, leaves = _leaves(a, diff)
            outs = _outputs(fn(*ins, **kwa))
            graphs[tag] = (outs, leaves, _cotangents(outs, fl, gen))
        outs, leaves, cots = graphs["kernel"]
        tensors = [t for t in a if torch.is_tensor(t)]
        if key == "encoder":
            tensors += list(a[2].values())
        moved = nbytes(*tensors, *outs)
        b_ms, b_by = bound(moved, flops)
        row = {"name": name, "route": "cuda",
               "source": f"tvqaplus_tpu_torch/{src}",
               "replaces": REPLACES[key], "max_abs_err": errs["bfloat16"],
               "max_abs_err_f32": errs["float32"],
               "ms": time_ms(lambda: kernel(*a, **kwa)),
               "plain_ms": time_ms(lambda: plain(*a, **kwa)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "bytes": moved, "flops": flops, "_key": key}
        emit({"phase": "kernel_train", "ok": True,
              **{k: v for k, v in row.items() if k != "_key"}})
        rows.append(row)

        def backward(tag):
            o, lv, c = graphs[tag]
            return torch.autograd.grad(o, lv, c, retain_graph=True)
        grads = backward("kernel")
        # the cross-block sums run in a fixed order: the same bits again
        if not all(torch.equal(g, h) for g, h in zip(grads,
                                                      backward("kernel"))):
            raise AssertionError(f"{name}: backward differs between runs")
        saved = [o for o in outs[:1]] if key == "qa_ctx_attention" else []
        bmoved = nbytes(*tensors, *saved, *cots, *grads)
        b_ms, b_by = bound(bmoved, bflops)
        row = {"name": name.replace("[", " backward["), "route": "cuda",
               "source": f"tvqaplus_tpu_torch/{BWD_SOURCES[key]}",
               "replaces": REPLACES[key + "_bwd"],
               "max_abs_err": gerrs["bfloat16"],
               "max_abs_err_f32": gerrs["float32"],
               "ms": time_ms(lambda: backward("kernel")),
               "plain_ms": time_ms(lambda: backward("plain")),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "bytes": bmoved, "flops": bflops, "deterministic": True,
               "_key": key + "_bwd"}
        emit({"phase": "kernel_train", "ok": True,
              **{k: v for k, v in row.items() if k != "_key"}})
        rows.append(row)
        del graphs, grads
    return rows


def reset_counters(kernel_mods):
    for m in kernel_mods:
        m.KERNEL.launches = 0
        m.BWD_KERNEL.launches = 0


def read_counters(kernel_mods):
    out = {}
    for m in kernel_mods:
        name = m.__name__.rsplit(".", 1)[1]
        out[name] = m.KERNEL.launches
        out[name + "_bwd"] = m.BWD_KERNEL.launches
    return out


def phase_train_main(dev, kernel_mods, workdir):
    """The training entry point on the card at the headline training
    config, then the inference entry point on the run it wrote."""
    import math
    from tvqaplus_tpu_torch.inference import main_inference
    from tvqaplus_tpu_torch.main import main as train_main
    argv = ["--synthetic_data", "--debug", "--add_local", "--use_sup_att",
            "--bsz", str(B), "--test_bsz", str(B), "--log_freq", "2",
            "--synthetic_n_valid", "32", "--seed", str(SEED),
            "--results_dir_base", os.path.join(workdir, "train", "results"),
            "--device", "cuda"]
    reset_counters(kernel_mods)
    t0 = time.perf_counter()
    run_dir, trainer = train_main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters(kernel_mods)
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    if not (opt["use_sup_att"] and opt["add_local"]
            and opt["compute_dtype"] == "bfloat16" and opt["dropout"] > 0):
        raise AssertionError(f"not the headline training config: {opt}")
    scalars = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            scalars.setdefault(rec["tag"], []).append(rec["value"])
    losses = [v for tag in ("Train/Loss", "Train/Loss_att", "Train/Loss_cls",
                            "Train/Loss_ts", "Valid/Loss")
              for v in scalars.get(tag, [])]
    if not scalars.get("Train/Loss") or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses: {scalars}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    if not os.path.exists(os.path.join(run_dir, "best_valid.pth")):
        raise AssertionError("the run wrote no best_valid.pth")
    pred_path = main_inference(["--model_dir", run_dir, "--device", "cuda"])
    with open(pred_path) as f:
        pred = json.load(f)
    if len(pred["ts_answer"]) != opt["synthetic_n_valid"]:
        raise AssertionError(f"{len(pred['ts_answer'])} predictions")
    emit({"phase": "train_main", "ok": True, "launches": launches,
          "steps": trainer.step, "wall_s": wall_s,
          "train_loss": scalars["Train/Loss"],
          "valid_acc": scalars.get("Valid/Acc"),
          "inference_answers": len(pred["ts_answer"])})
    return launches


def train_batch(cfg, dev, n):
    from tvqaplus_tpu_torch.data.batching import (
        StaticShapeSpec,
        collate_static,
    )
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    ds = SyntheticTVQADataset(cfg, n, mode="train")
    spec = StaticShapeSpec.from_config(cfg, batch=n, train=True
                                       ).with_max_img(LI)
    arrays, _ = collate_static([ds[i] for i in range(n)], spec)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def train_config(workdir, **kw):
    from tvqaplus_tpu_torch.config import Config
    return Config(synthetic_data=True, add_local=True, use_sup_att=True,
                  seed=SEED, results_dir=workdir, **kw)


def phase_train_vs_cpu(dev, workdir):
    """One train step on the card against the same step on the CPU."""
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.train.loop import Trainer
    n = CPU_STEP_BATCH
    cfg = train_config(workdir, bsz=n, dropout=0.0, compute_dtype="float32")
    cfg.finalize("cpu")
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(SEED))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    steps = {}
    for where in ("cuda", "cpu"):
        m = STAGE(ModelConfig.from_config(cfg))
        m.load_state_dict(sd)
        trainer = Trainer(cfg, where, model=m)
        metrics = trainer.train_step(train_batch(cfg, where, n),
                                     use_hard_negatives=True)
        steps[where] = (metrics, {k: p.grad.detach().float().cpu()
                                  for k, p in m.named_parameters()})
    (mg, gg), (mc, gc) = steps["cuda"], steps["cpu"]
    loss_err = abs(float(mg["loss"]) - float(mc["loss"]))
    norm_err = abs(float(mg["grad_norm"]) - float(mc["grad_norm"]))
    # relative to the parameter's largest gradient, floored at 1e-4 of the
    # largest of all: a gradient that sums to ~0 (a bias right before the
    # answer softmax) compares its rounding otherwise
    floor = 1e-4 * max(float(g.abs().max()) for g in gc.values())
    rel = {k: float((gg[k] - gc[k]).abs().max())
           / max(float(gc[k].abs().max()), floor) for k in gc}
    worst = max(rel, key=rel.get)
    checks = {"loss": loss_err / abs(float(mc["loss"])),
              "grad_norm": norm_err / float(mc["grad_norm"]),
              "grad_rel": rel[worst]}
    failed = {k: v for k, v in checks.items() if not v <= STEP_TOL[k]}
    if failed:
        raise AssertionError(f"train step on the card vs the CPU: {failed} "
                             f"(bars {STEP_TOL}; worst grad {worst})")
    emit({"phase": "train_vs_cpu", "ok": True, "batch": n, "frames": LI,
          "loss_cuda": float(mg["loss"]), "loss_cpu": float(mc["loss"]),
          "grad_norm_cuda": float(mg["grad_norm"]),
          "grad_norm_cpu": float(mc["grad_norm"]), "rel_err": checks,
          "worst_grad": worst, "tol": STEP_TOL})


def phase_training(dev, workdir):
    """The headline train step on a batch already on the card."""
    from torch.profiler import ProfilerActivity, profile

    from tvqaplus_tpu_torch.train.loop import Trainer
    cfg = train_config(workdir, bsz=B).finalize(dev)
    trainer = Trainer(cfg, dev)
    batch = train_batch(cfg, dev, B)

    def step():
        return trainer.train_step(batch)
    out = {"event_ms": time_ms(step, reps=10)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = step()
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    loss = float(metrics["loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"training loss {loss}")
    # device busy time: the kernels' own times (one stream, no overlap;
    # the profiler's annotation ranges such as the optimizer's are not
    # kernels); the idle share is taken against the unprofiled host clock,
    # as tracing slows the host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 \
        / PROFILE_STEPS
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    top = [{"kernel": k[:80], "calls_per_step": c / PROFILE_STEPS,
            "ms_per_step": t / 1e3 / PROFILE_STEPS}
           for k, (c, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:12]]
    emit({"phase": "training", "ok": True, "batch": B, "frames": LI,
          "compute_dtype": cfg.compute_dtype, "dropout": cfg.dropout,
          "steps": TRAIN_STEPS, "loss": loss,
          "qa_pairs_per_s": B / (out["step_ms"] / 1e3), **out,
          "device_busy_ms": busy_ms if kernels else None,
          "device_idle_share": (1 - busy_ms / out["step_ms"]) if kernels
          else None,
          "launches_per_step": len(kernels) / PROFILE_STEPS,
          "top_kernels": top})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from tvqaplus_tpu_torch.ops import (
            encoder,
            qa_ctx_attention,
            tri_bridge,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernel_mods = (qa_ctx_attention, tri_bridge, encoder)
    phase_device()
    phase_build()
    rows = phase_kernels(dev)
    train_rows = phase_train_kernels(dev)
    from tvqaplus_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        cfg, sd, launches = phase_main(dev, kernel_mods, workdir)
        phase_serving(dev, cfg, sd)
        train_launches = phase_train_main(dev, kernel_mods, workdir)
        phase_train_vs_cpu(dev, workdir)
        phase_training(dev, workdir)
    for row in rows:
        row["launches"] = launches[row.pop("_key")]
    for row in train_rows:
        row["launches"] = train_launches[row.pop("_key")]
    emit({"kernels": rows + train_rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - report and fail the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
