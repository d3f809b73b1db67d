"""On-card smoke run of the PyTorch/CUDA port (``tvqaplus_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels build for sm_90a) and the CUDA
toolkit.  Phases, each printing one JSON line:

1. device  - the card (``nvidia-smi`` name and power limit), torch/CUDA
             versions; TF32 off for matmuls and convolutions.
1e. evaluator - the port's TVQA+ evaluator on the in-repo val set
             (``eval_data/tvqa_plus_val.json``, 3,017 QA pairs) with the
             ground truth as the prediction (``gt_as_prediction``, reference
             eval/readme.txt:13-17): QA accuracy, mIoU and ASA must be the
             self-check's (EVAL_SELF_CHECK), the grounding mAP inside
             EVAL_MAP_RANGE.  The TVQA+ artifact loader (``data/tvqa.py``,
             needs h5py) is held by the CPU tests
             (``tests/test_torch_fixture_e2e.py``), not here.
2. build   - builds every kernel from ``tvqaplus_tpu_torch/csrc``.
3. kernels - each kernel at the headline serving shapes (batch 16, 5
             answers, 50 frames, 40 QA tokens, 25 regions / 50 subtitle
             tokens, D 128): against its plain version in float32 and in
             bfloat16, times (CUDA events, median of 30 after warm-up) and
             the card's bound for the same work.  Every row also carries
             ``f32_ms``, the float32 CUDA-core instantiation timed in the
             same call (bf16: every kernel runs on the tensor cores).  The
             encoder's full-output mode runs at the merged input's (16, 105,
             50, 128), k = 7, with the headline length mask (5 x 40, 50 x
             50, 50 x 25) and with no mask, compared on the valid
             positions; the MLP bridge at (16, 5, 40, 768), (16, 50, 25,
             300) and (16, 50, 50, 768) -> 300.  Beside these two, the
             time of what the separate-stream main path runs instead: the
             three plain ``EncoderBlock`` calls, the plain ``MLPBridge``
             chain.
3w. kernel_width - the forward kernels of the attention, the tri bridge and
             the encoder at the other hidden widths they are built for (D =
             64 and 256, ops/widths.py), at the headline shapes otherwise:
             against their plain versions in float32 and bfloat16, dropout 0
             and 0.1, and timed as in 3; their launches are phase 9w's.  The
             tri bridge's forward at dropout 0.1 (a train step's) is a row
             of its own, its launches the train path's (phase 9t), and so
             is the attention's at D = 64 (the persistent kernel's
             instantiation with the Philox draws).
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
             headline batch (50 frames) on the card, in float32 and in
             bfloat16, against the same forward on the CPU in the same
             compute type (see FWD_TOL).
6. serving - the eval step (forward, span search, grounding compaction) at
             batch 16 x 50 frames on a batch already on the card: host
             clock over 30 back-to-back steps ended by a synchronise (the
             metric: ms per batch, QA pairs per second), and the median
             CUDA-event time of one step; its ``torch.profiler`` trace must
             show the tensor-core forwards of the encoder and the tri
             bridge and no CUDA-core forward of either.  ``serving_graph``:
             the same step as a CUDA-graph replay (``dispatch_infer``, one
             step a dispatch), timed in turns with the eager step, its
             outputs the eager step's bits.
7. train main - ``python -m tvqaplus_tpu_torch.main`` on the card at the
             headline training config (--use_sup_att --add_local, batch 16,
             dropout 0.1, bf16) with --debug: checks that the losses are
             finite and that all six forward/backward kernels launched
             (counted at each graph replay), then runs the inference entry
             point on the run directory it wrote.
8. train vs cpu - one train step (50 frames, batch 4, dropout 0, float32)
             on the card against the same step on the CPU.
8d. dispatch - replayed train dispatches against eager steps at the
             headline training config: K = 1 and K = 4 replays give the
             loss, grad_norm and parameters of as many eager steps (see
             DISPATCH_TOL), and two replays from the same state draw other
             dropout masks.
9. training - the headline train step (batch 16, 50 frames, bf16, dropout
             0.1) on a batch already on the card: host clock over 12 steps
             ended by a synchronise (ms per step, QA pairs trained per
             second), the median CUDA-event time of one step, and the
             device's busy time and idle share from ``torch.profiler``,
             whose trace is held as in phase 6; eager (``train_step``) and
             as CUDA-graph replays of one step (``training_graph``) and of
             four (``training_graph_k4``, times per step), in turns.

The merged input-encoder path (``merge_input_streams``) and the bridge
kernel, each in the phase of its counterpart:
5m. merged main - the inference entry point on run directories whose
             opt.json sets ``merge_input_streams`` (same best_valid.pth):
             in float32 the answers and spans equal the separate run's and
             the grounding scores agree at 1e-4; in bf16 the headline batch
             is held against the CPU forward at phase 5's bar (that run
             dispatches two batches at once: ``eval_steps_per_dispatch``
             2).  The full-output encoder kernel launched and no plain k=7
             encoder call ran.
6m. merged serving - phase 6 with the flag, in turns with the separate
             path, each with launches per step, device busy ms and idle
             share from ``torch.profiler``.
7m. merged train main - phase 7 with ``--merge_input_streams`` and
             ``--steps_per_dispatch 2``: all eight encoder/attention/
             tri-bridge counters above zero.
7b. bridge module - ``MLPBridge`` built with its kernel switch on, loaded
             with STAGE's ``bert_word_encoding_fc`` / ``vid_fc`` weights,
             forward + backward in train mode (dropout 0.1) on the headline
             ``qas_bert`` and ``vid`` tensors against the same module with
             the switch off and the same Philox mask, float32 and bf16; the
             ``torch.profiler`` trace of a bf16 step must show the
             tensor-core forward, backward and weight-gradient kernels and
             no CUDA-core kernel of the bridge.
9m. merged training - phase 9 with the flag, in turns with the separate
             path.

The JAX package's checkpoints, attention heads and run bookkeeping:
9j. jax_checkpoint - the headline weights after two train steps of the
             port's trainer, written in the JAX trainer's flax layout
             (``flax_checkpoint_tree``, ``flax_msgpack.dumps``): served as a
             run directory's ``best_valid.ckpt``, the predictions of the
             same weights served from ``best_valid.pth`` bit for bit;
             resumed as ``last.ckpt`` for two steps, the losses and
             parameters of the torch checkpoint's resume (deterministic
             algorithms on); a file of neither format refused by name.
9h. heads  - the separate and merged headline configs with 8 attention
             heads in both encoders beside the same configs with none:
             the encoder kernels bypassed (JAX's predicate), the attention
             and tri-bridge kernels launched, the serve step within
             FWD_TOL of the CPU, replays equal to eager steps; each
             config's replayed serve and train busy ms, idle share and
             launches per step.
9b. bookkeeping - the training entry point with ``--profile_dir``: the
             trace names the hand-written kernels; ``code.zip`` holds the
             package.

Data parallelism (``tvqaplus_tpu_torch/parallel/mesh.py``):
9p. data_parallel - an in-process NCCL process group of world size 1 on
             the card: the headline separate-path trainer (batch 16, 50
             frames, bf16, dropout 0.1) for 12 K = 4 graph-replayed
             dispatches, one serve pass (``InferenceRunner.run``) and a
             validation pass with the group and without it, deterministic
             algorithms on: losses, grad norms, parameters, Adam's state,
             the predictions and the validation bit for bit; the training
             entry point in the group, as ``torchrun`` starts it.  Then,
             in the default mode, fresh trainers with and without the
             group: step ms in turns, device busy ms and idle share, and
             the replay's ``torch.profiler`` trace, which must hold the
             NCCL all-reduce kernels of every step (the cls counts and the
             2.21 MB gradient sum) with their device us.  Placed before
             ``noun_void`` and ``pipeline``.
9q. mesh_axes - the ctx and model axes.  (a) Mesh (1, 1, 1) in a world-1
             NCCL group: the headline separate-path trainer for 12 K = 4
             replays and a serve pass, deterministic algorithms on, bit for
             bit the same without a group, with data_parallel's wrapper
             launches over the 12 dispatches and the nodes a step of the
             captured graph of a trainer on data_parallel's mesh (-1, 1)
             beside it, so the axes cost nothing when they are off.  (b) Two
             processes on the one card (NCCL refuses two ranks on one
             card), joined by a gloo group over CUDA tensors that this
             harness makes (a collective gloo refuses on CUDA tensors,
             found by a probe, is staged through host copies here, never
             in the package), eager (gloo collectives cannot be captured):
             meshes (1, 2) (each rank runs the kernels at Li 25) and (1,
             1, 2) (the BERT and vid bridges split by columns) at the
             headline shapes, float32, dropout 0, deterministic algorithms
             on, against the single process: three train steps' losses
             and grad norms (the first at 1e-5, the CPU tests' bar; later
             ones drift, MESH_STEP_RTOL), the two replicas' equal bit
             for bit, the serve step's answers and spans identical and its
             grounding at 1e-4; one bf16 forward at FWD_TOL; each rank's
             eager step ms and the bytes its all-gathers received beside
             the single process's.  The (1, 1, 2) case at hsz 256 also
             records where its first-step gap to one process arises
             (ROADMAP C8): every parameter's gradient before the clip and
             every module's first output, in the forward's order, against
             one process and against one process that takes the model
             axis's column blocks (``c8_bisect``; a record, held to no
             bar).

The kernels' other hidden widths (ops/widths.py):
4w. kernel_train_width - the backward kernels of the attention (vid raw
             "target", sub raw "none"), the tri bridge and the encoder
             (reduce k 5; full output k 7 with the zero mask and without) at
             D = 64 and 256 (csrc/*_bwd_wide.cu), dropout 0.1, against
             autograd through their plain versions in float32 and bfloat16
             at the D = 128 rows' GRAD_TOL, twice for the same bits, and
             timed as in 4; their launches are phase 9t's.  After phase 4.
9w. wide_serving - STAGE served at hsz 256 and 64: the inference entry
             point on the separate and the merged path, every forward kernel
             launched at that width (its own counter) and none at D = 128;
             the hsz-256 headline batch on the card against the CPU forward
             (phase 5's bars); the replayed serve steps of hsz 128 and 256,
             both paths, equal to their eager steps, timed in turns with
             busy ms, idle share and launches; at hsz 64 the traces hold
             the forwards of their own D = 64 designs
             (``qa_ctx_fwd_tc64_kernel``, ``encoder_fwd_tc64_kernel``,
             ``tri_bridge_fwd_tc64_kernel``) and none of the D = 128
             designs' instantiations (``check_tc_forwards``).  Placed after
             ``mesh_axes``, before ``noun_void``.
9t. wide_training - STAGE trained at hsz 256 and 64: the train CLI on
             synthetic data, separate and merged (four steps, validation, a
             checkpoint), every kernel of the path launched at that width
             (its own counter) and none at D = 128; a float32 train step at
             hsz 256 on the card against the CPU (phase train_vs_cpu's
             bars); K = 4 replays at hsz 256 equal to as many eager steps
             bit for bit (deterministic algorithms on), both paths; the
             replayed train steps (K = 4) of hsz 128, 256, 64 and the
             padded widths, both paths (``train_steps``: graphs that keep
             their nodes), timed in turns, with QA/s, the graph's nodes a
             step, and from a profiled window busy ms, the idle share
             against that window's host ms and the trace's launches
             (``train_step_rows``); the traces holding their width's
             forwards and backwards and no kernel of D = 128.  After
             ``wide_serving``.

Then the ``kernels`` summary line, and last ``{"ok": true, "device": ...}``.
Any failure exits non-zero without that line.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import math
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
DEVICE = "cuda"      # where the entry points run
B, A, LQA, LI, LR_VID, LR_SUB, D, K_CLS = 16, 5, 40, 50, 25, 50, 128, 5
K_IN, D_BERT, D_VFEAT, D_BRIDGE = 7, 768, 300, 300
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
    "encoder_block": "tvqaplus_tpu/ops/pallas_encoder.py:570",
    "encoder_block_bwd": "tvqaplus_tpu/ops/pallas_encoder.py:493",
    "mlp_bridge": "tvqaplus_tpu/ops/pallas_bridge.py:204",
    "mlp_bridge_bwd": "tvqaplus_tpu/ops/pallas_bridge.py:159",
}
BWD_SOURCES = {"qa_ctx_attention": "csrc/qa_ctx_attention_bwd.cu",
               "tri_bridge": "csrc/tri_bridge_bwd.cu",
               "encoder": "csrc/encoder_bwd.cu",
               "encoder_block": "csrc/encoder_bwd.cu",
               "mlp_bridge": "csrc/mlp_bridge_bwd.cu"}


def bwd_source(key, d):
    """The source of ``key``'s bf16 backward at width ``d`` (a width
    between the instantiations: its instantiation's)."""
    d = padded_width(d)
    if d == D:
        return BWD_SOURCES[key]
    if key.startswith("encoder"):
        return "csrc/encoder_bwd_tc_wide.cu"
    return BWD_SOURCES[key].replace(".cu", "_wide.cu")


# the kernels each main path must launch (counter keys, see counters())
SEPARATE_FWD = ("qa_ctx_attention", "tri_bridge", "encoder")
SEPARATE_TRAIN = SEPARATE_FWD + tuple(k + "_bwd" for k in SEPARATE_FWD)
MERGED_FWD = SEPARATE_FWD + ("encoder_block",)
MERGED_TRAIN = SEPARATE_TRAIN + ("encoder_block", "encoder_block_bwd")
P_DROP, DROP_SEED = 0.1, 20181016
# the forward kernels' other hidden widths (ops/widths.py): their kernel
# rows, and the serving path at hsz 256 (both paths) and 64 (phase
# wide_serving); counter keys "<key>@<width>"
OTHER_WIDTHS = (64, 256)
WIDE_HSZ = 256
# the widths between the instantiations (ops/widths.py padded_width: 96 in
# the 128 instantiation, 200 in the 256): their bf16 kernel rows, and the
# replayed serve and train steps at those hsz (phases wide_serving,
# wide_training); counter keys "<key>@<width>" count their launches apart
PADDED_WIDTHS = (96, 200)


def padded_width(d):
    """The instantiation a width runs in (imported here, not at the top:
    without the port beside it this script must fail cleanly)."""
    from tvqaplus_tpu_torch.ops.widths import padded_width as instantiation
    return instantiation(d)
# whole-model tolerances: the eval forward on the card against the same
# forward on the CPU in the same compute type.  The CPU forward runs every
# kernel's plain version, none of the CUDA kernels, and (bf16) rounds where
# the card does, so the two differ by the order of float32 sums and by the
# roundings those move.  float32: TF32 is off.  bfloat16: ~3 significant
# digits through ~10 layers.  Held are the outputs that are continuous in
# the activations: the span scores and the raw attention scores everywhere,
# and the answer scores of every (question, answer) whose top-1 span both
# sides chose alike.  An answer score pools over its chosen span, so a span
# that moves on a near tie shifts it by 0.1-1.1 (1-5 of a batch's 80 in
# bf16, scripts/check_bf16_forward_noise.py): those are counted and printed.
FWD_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-1, 5e-2)}
SERVING_STEPS = 30
TRAIN_STEPS, PROFILE_STEPS, CPU_STEP_BATCH = 12, 6, 4
DISPATCH_K = 4       # the stacked dispatch of the graph phases
# a replayed train dispatch against as many eager steps, deterministic
# algorithms on: the same kernels in the same order give the same bits
DISPATCH_TOL = 0.0
# MLPBridge with the kernel switch on against the switch off, bf16: both
# round the LN output and W to bf16 before the product, but the plain chain
# (a bf16 dense layer) also rounds the product y1 to bf16, which the kernel
# keeps in float32 as the TPU kernel's bf16 mode does, so some ReLU signs
# differ and each flips one element of the gradient: relative L2 error of
# each output / gradient, measured up to 0.0165 (vid_fc's gradients; 0.0106
# bert_word_encoding_fc's) on an H100, held at three times that
BRIDGE_BF16_REL_L2 = 0.05
# one train step on the card (float32, TF32 off) against the CPU: the loss
# is one float32 reduction of the same values; a gradient may differ where
# a ReLU input or a max tie lies within float32 rounding of its decision
# (ops/checks.py), so it is held relative to its parameter's largest
# gradient (see phase_train_vs_cpu)
STEP_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "grad_rel": 1e-2}
# The GT self-check on eval_data/tvqa_plus_val.json, as the JAX package's
# evaluator gives it (tests/test_torch_evaluation.py): QA 1.0; two of the
# 3,017 GT spans have zero length (IoU 0 by definition), so mIoU and ASA are
# 3015/3017.  11 GT boxes repeat a box of their frame and label, and a
# repeated prediction meets the first one already matched (a false
# positive), so the mAP stays below 1.  Its last digits follow the order in
# which numpy's argsort leaves tied scores (all are 1.0 here):
# 0.9978110088507862 with one numpy build, 0.9978110050914022 (a stable
# sort's order) with another; it is held to the reference's ~0.999
# (eval/readme.txt:13-17) as the JAX package's test holds it (> 0.99).
EVAL_SELF_CHECK = {"qa_acc": 1.0, "miou": 3015 / 3017,
                   "ans_span_joint_acc@.5": 3015 / 3017}
EVAL_MAP_RANGE = (0.99, 1.0)    # exclusive


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


def phase_evaluator(workdir):
    """The port's evaluator self-check on the in-repo TVQA+ val set."""
    from tvqaplus_tpu_torch.data.fixtures import gt_as_prediction
    from tvqaplus_tpu_torch.evaluation.tvqa_metrics import evaluate_tvqa_plus
    gt_path = os.path.join(HERE, "eval_data", "tvqa_plus_val.json")
    w2i_path = os.path.join(HERE, "eval_data", "word2idx.json")
    t0 = time.perf_counter()
    pred = gt_as_prediction(gt_path, os.path.join(workdir, "gt_as_pred.json"))
    metrics = evaluate_tvqa_plus(pred, gt_path, w2i_path,
                                 no_preproc_pred=True)
    wall_s = time.perf_counter() - t0
    got = {k: metrics[k] for k in (*EVAL_SELF_CHECK, "overall_map")}
    off = {k: v for k, v in EVAL_SELF_CHECK.items()
           if not abs(got[k] - v) <= 1e-12}
    lo, hi = EVAL_MAP_RANGE
    if off or not lo < got["overall_map"] < hi \
            or len(metrics["metrics_per_class"]) == 0:
        raise AssertionError(f"evaluator self-check: {got}, expected "
                             f"{EVAL_SELF_CHECK}, mAP in {EVAL_MAP_RANGE}")
    emit({"phase": "evaluator", "ok": True, "qa_pairs": 3017,
          "metrics": got, "classes": len(metrics["metrics_per_class"]),
          "wall_s": wall_s})


def phase_build():
    from tvqaplus_tpu_torch.ops import _build
    seconds = _build.build_all()
    usage = {}
    for src in _build.SOURCES:
        with open(_build.lib_path(src)[:-3] + ".log") as f:
            # registers, shared memory and spills of each kernel (not the
            # compiler's notes on wgmma's own register use)
            usage[src] = [ln.strip() for ln in f
                          if ("registers" in ln or "spill" in ln)
                          and "C7519" not in ln]
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


@dataclasses.dataclass
class Case:
    """One kernel at the shapes the main path gives it."""
    name: str
    key: str               # counter key of the forward (see counters())
    mod: object            # the wrapper's module (TOL, GRAD_TOL)
    kernel: object         # the wrapper
    plain: object          # its plain PyTorch version
    args: object           # dtype -> (args, kwargs)
    flops: int
    src: str
    valid: object = None   # outputs count where this is 1 (else everywhere)
    today: object = None   # (dtype, train) -> (step, parameters): what the
    #                        separate-stream main path runs instead
    # training variant (train_kernel_cases)
    kw: dict = None        # dropout and raw-mode arguments
    flip: object = None    # args -> where the cotangent is zeroed
    diff: tuple = ()       # positions of the differentiable args
    bflops: int = 0


def encoder_params(gen, dev, k, d=D):
    p = {}
    for i in (0, 1):
        p.update({f"ln{i}_s": 1.0 + randn(gen, dev, d, scale=0.1),
                  f"ln{i}_b": randn(gen, dev, d, scale=0.1),
                  f"dw{i}": randn(gen, dev, k, d, scale=0.3),
                  f"dwb{i}": randn(gen, dev, d, scale=0.1),
                  f"pw{i}": randn(gen, dev, d, d, scale=d ** -0.5),
                  f"pwb{i}": randn(gen, dev, d, scale=0.1)})
    p["lnf_s"] = 1.0 + randn(gen, dev, d, scale=0.1)
    p["lnf_b"] = randn(gen, dev, d, scale=0.1)
    return p


def plain_encoder_calls(p, k, streams, dev):
    """The three separate plain ``EncoderBlock`` calls of today's main path
    on the merged tensor's streams: (dtype, train) -> (step, parameters);
    ``step()`` returns the three outputs."""
    from tvqaplus_tpu_torch.models.layers import Dropout, EncoderBlock

    def build(dt, train):
        block = EncoderBlock(D, 2, k, dtype=dt).to(dev)
        sd = {"final_layer_norm.weight": p["lnf_s"],
              "final_layer_norm.bias": p["lnf_b"]}
        for i in (0, 1):
            sd.update({
                f"layer_norm.{i}.weight": p[f"ln{i}_s"],
                f"layer_norm.{i}.bias": p[f"ln{i}_b"],
                f"conv.{i}.depthwise_conv.weight": p[f"dw{i}"].t()[:, None],
                f"conv.{i}.depthwise_conv.bias": p[f"dwb{i}"],
                f"conv.{i}.pointwise_conv.weight": p[f"pw{i}"].t()[..., None],
                f"conv.{i}.pointwise_conv.bias": p[f"pwb{i}"]})
        block.load_state_dict(sd)
        xs = [x.to(dt).requires_grad_(train) for x in streams]
        drop = Dropout(P_DROP, torch.Generator(device=dev).manual_seed(SEED),
                       torch.Generator().manual_seed(SEED)) if train else None
        return (lambda: [block(x, drop=drop) for x in xs],
                xs + list(block.parameters()))
    return build


def plain_bridge_chain(x, params, dev):
    """The plain ``MLPBridge`` chain of today's main path, as
    ``plain_encoder_calls``."""
    from tvqaplus_tpu_torch.models.layers import Dropout, MLPBridge

    def build(dt, train):
        gin, bin_, w, b, gout, bout = params
        mod = MLPBridge(w.shape[0], w.shape[1], P_DROP, dt).to(dev)
        mod.load_state_dict({"0.weight": gin, "0.bias": bin_,
                             "2.weight": w.t(), "2.bias": b,
                             "4.weight": gout, "4.bias": bout})
        xt = x.to(dt).requires_grad_(train)
        drop = Dropout(P_DROP, torch.Generator(device=dev).manual_seed(SEED),
                       torch.Generator().manual_seed(SEED)) if train else None
        return lambda: [mod(xt, drop)], [xt] + list(mod.parameters())
    return build


def merged_length_mask(dev):
    """The (G, L) zero mask of ``_merged_input_encode`` at the headline
    shapes: 5 answers of 40, 50 subtitle windows of 50, 50 frames of 25."""
    lens = torch.tensor([LQA] * A + [LR_SUB] * LI + [LR_VID] * LI, device=dev)
    lmax = max(LQA, LR_SUB, LR_VID)
    return (torch.arange(lmax, device=dev)[None, :] < lens[:, None]).float()


def kernel_cases(dev, d=D):
    """Every kernel at the headline shapes, at hidden width ``d``: the
    headline's D = 128, or (the forward kernels of the attention, the tri
    bridge and the encoder only) one of the other widths they are built
    for."""
    tag = "" if d == D else f", D {d}"
    from tvqaplus_tpu_torch.models.attention import l2_normalize
    from tvqaplus_tpu_torch.models.layers import sinusoid_table
    from tvqaplus_tpu_torch.ops import (
        encoder,
        mlp_bridge,
        qa_ctx_attention,
        tri_bridge,
    )
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c_mask, vmask, smask, _ = make_masks(gen, dev)
    ce = randn(gen, dev, B, A, LQA, d)
    proj = [1.0 + randn(gen, dev, 3 * d, scale=0.1),
            randn(gen, dev, 3 * d, scale=0.1),
            randn(gen, dev, 3 * d, d, scale=(3 * d) ** -0.5),
            randn(gen, dev, d, scale=0.1)]
    cases = []
    m_rows = A * LQA
    for site, lr, q_mask, raw_mode in (("vid", LR_VID, vmask, "full"),
                                       ("sub", LR_SUB, smask, "none")):
        qe = randn(gen, dev, B, LI, lr, d)

        def args(dt, qe=qe, q_mask=q_mask, raw_mode=raw_mode):
            ce_t, qe_t = ce.to(dt), qe.to(dt)
            return ((l2_normalize(ce_t), ce_t, l2_normalize(qe_t), qe_t,
                     c_mask, q_mask, *proj),
                    dict(scale=10.0, raw_mode=raw_mode))
        flops = 2 * B * LI * m_rows * (2 * lr * d + 3 * d * d)
        cases.append(Case(f"qa_ctx_attention[{site}, raw {raw_mode}{tag}]",
                          "qa_ctx_attention", qa_ctx_attention,
                          qa_ctx_attention.qa_ctx_attention,
                          qa_ctx_attention.qa_ctx_attention_plain, args,
                          flops, "csrc/qa_ctx_attention_fwd.cu"))
    s, v = randn(gen, dev, B, A, LI, LQA, d), randn(gen, dev, B, A, LI, LQA, d)
    bridge = [1.0 + randn(gen, dev, 3 * d, scale=0.1),
              randn(gen, dev, 3 * d, scale=0.1),
              randn(gen, dev, 3 * d, d, scale=(3 * d) ** -0.5),
              randn(gen, dev, d, scale=0.1),
              1.0 + randn(gen, dev, d, scale=0.1), randn(gen, dev, d,
                                                         scale=0.1)]
    cases.append(Case("tri_bridge" + (f"[D {d}]" if tag else ""),
                      "tri_bridge", tri_bridge,
                      tri_bridge.tri_bridge, tri_bridge.tri_bridge_plain,
                      lambda dt: ((s.to(dt), v.to(dt), *bridge), {}),
                      2 * B * A * LI * LQA * 3 * d * d,
                      "csrc/tri_bridge_fwd.cu"))
    g = A * LI
    x = randn(gen, dev, B, g, LQA, d)
    rmask = (c_mask[:, :, None, :] * vmask.amax(-1)[:, None, :, None]
             ).reshape(B, g, LQA).contiguous()
    p = encoder_params(gen, dev, K_CLS, d)
    pe = sinusoid_table(LQA, d).to(dev)
    cases.append(Case("encoder_reduce" + (f"[D {d}]" if tag else ""),
                      "encoder", encoder,
                      encoder.encoder_reduce, encoder.encoder_reduce_plain,
                      lambda dt: ((x.to(dt), pe, p, K_CLS, rmask), {}),
                      2 * 2 * B * g * LQA * d * d, "csrc/encoder_fwd.cu"))

    # the merged input encoder: rows past a stream's length are zero going in
    # (the merge pads with zeros) and are not compared coming out
    zm = merged_length_mask(dev)
    gm, lm = zm.shape
    xm = randn(gen, dev, B, gm, lm, d) * zm[..., None]
    pm = encoder_params(gen, dev, K_IN, d)
    pem = sinusoid_table(lm, d).to(dev)
    streams = [xm[:, :A, :LQA].contiguous(),
               xm[:, A:A + LI, :LR_SUB].contiguous(),
               xm[:, A + LI:, :LR_VID].contiguous()]
    today = plain_encoder_calls(pm, K_IN, streams, dev) if not tag else None
    # the products of the valid rows only (what the data needs)
    flops_m = 2 * 2 * B * int(zm.sum()) * d * d
    for mtag, mask in (("zero mask", zm), ("no mask", None)):
        cases.append(Case(
            f"encoder_block[{mtag}{tag}]", "encoder_block", encoder,
            encoder.encoder_block, encoder.encoder_block_plain,
            lambda dt, mask=mask: ((xm.to(dt), pem, pm, K_IN, mask), {}),
            flops_m if mask is not None else 2 * 2 * B * gm * lm * d * d,
            "csrc/encoder_fwd.cu",
            valid=zm[..., None] if mask is not None else None,
            today=today if mask is not None else None))
    if tag:
        return cases

    # the MLP bridge at its three sites' shapes
    for site, shape, d_in in (("qas_bert", (B, A, LQA), D_BERT),
                              ("vid", (B, LI, LR_VID), D_VFEAT),
                              ("sub_bert", (B, LI, LR_SUB), D_BERT)):
        xb = randn(gen, dev, *shape, d_in)
        pb = [1.0 + randn(gen, dev, d_in, scale=0.1),
              randn(gen, dev, d_in, scale=0.1),
              randn(gen, dev, d_in, D_BRIDGE, scale=d_in ** -0.5),
              randn(gen, dev, D_BRIDGE, scale=0.1),
              1.0 + randn(gen, dev, D_BRIDGE, scale=0.1),
              randn(gen, dev, D_BRIDGE, scale=0.1)]
        rows = xb.numel() // d_in
        cases.append(Case(
            f"mlp_bridge[{site} {d_in}->{D_BRIDGE}]", "mlp_bridge",
            mlp_bridge, mlp_bridge.mlp_bridge, mlp_bridge.mlp_bridge_plain,
            lambda dt, xb=xb, pb=pb: ((xb.to(dt), *pb), {}),
            2 * rows * d_in * D_BRIDGE, "csrc/mlp_bridge_fwd.cu",
            today=plain_bridge_chain(xb, pb, dev)))
    return cases


def on_valid(case, outs):
    """The outputs where the case's valid mask is 1 (float32)."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    if case.valid is None:
        return outs
    return tuple(o.float() * case.valid for o in outs)


def moved_bytes(a, *more):
    """Bytes of the tensors among the args (a parameter dict included) and
    of ``more``."""
    tensors = [t for t in a if torch.is_tensor(t)]
    for t in a:
        if isinstance(t, dict):
            tensors += list(t.values())
    return nbytes(*tensors, *more), tensors


def check_forward(case, name, dname, got, want):
    """Hold a kernel's outputs against the plain version's; returns the
    largest absolute error."""
    got, want = on_valid(case, got), on_valid(case, want)
    tol = case.mod.TOL[getattr(torch, dname)]
    if isinstance(tol, dict):      # per-output tolerances
        for (out, g_, w_) in zip(("mixed", "raw"), got, want):
            assert_close(f"{name} {dname} {out}", [g_], [w_], tol[out])
    else:
        assert_close(f"{name} {dname}", got, want, tol)
    return max_err(got, want)


def time_today(case, dt, train):
    """Times of what the separate-stream main path runs instead of the
    kernel: its forward, and (training) forward + backward as one."""
    if case.today is None:
        return {}
    step, params = case.today(dt, train)
    with torch.set_grad_enabled(train):
        out = {"today_ms": time_ms(step)}
        if train:
            cots = [torch.ones_like(o) for o in step()]

            def fwd_bwd():
                return torch.autograd.grad(step(), params, cots)
            out["today_fwd_bwd_ms"] = time_ms(fwd_bwd)
    return out


def phase_kernels(dev, d=D, rates=(0.0,), dnames=("float32", "bfloat16")):
    """Every kernel at width ``d`` (the forward kernels of the attention, the
    tri bridge and the encoder at the other widths), held against its plain
    version in each compute type of ``dnames`` at each dropout rate of
    ``rates``, and timed (dropout off).  The rows of the other widths take
    their launches from phase wide_serving."""
    rows = []
    for case in kernel_cases(dev, d):
        errs = {}
        for dname in dnames:
            for rate in rates:
                a, kw = case.args(getattr(torch, dname))
                if rate:
                    kw = {**kw, "dropout_rate": rate, "seed": DROP_SEED}
                got = case.kernel(*a, **kw)
                # the plain version computes on the same values, in bf16 with
                # the kernel's rounding sites, and rounds its output to the
                # kernel's output type
                want = case.plain(*a, **kw)
                torch.cuda.synchronize()
                errs[dname, rate] = check_forward(
                    case, f"{case.name} dropout {rate}" if rate else case.name,
                    dname, got, want)
        a, kw = case.args(torch.bfloat16)
        outs = case.kernel(*a, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        moved, _ = moved_bytes(a, *outs)
        b_ms, b_by = bound(moved, case.flops)
        row = {"name": case.name, "route": "cuda",
               "source": f"tvqaplus_tpu_torch/{case.src}",
               "replaces": REPLACES[case.key],
               "max_abs_err": errs["bfloat16", 0.0],
               "ms": time_ms(lambda: case.kernel(*a, **kw)),
               "plain_ms": time_ms(lambda: case.plain(*a, **kw)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "bytes": moved, "flops": case.flops,
               **time_today(case, torch.bfloat16, False),
               "_key": case.key if d == D else f"{case.key}@{d}"}
        if d != D:
            row["width"] = d
            row["instantiation"] = padded_width(d)
        for rate in rates[1:]:
            # the forward a train step runs (phase kernel_width times it)
            row["max_abs_err_dropout"] = errs["bfloat16", rate]
            kwd = {**kw, "dropout_rate": rate, "seed": DROP_SEED}
            row["ms_dropout"] = time_ms(lambda: case.kernel(*a, **kwd))
        if "float32" in dnames:
            row["max_abs_err_f32"] = errs["float32", 0.0]
            for rate in rates[1:]:
                row["max_abs_err_f32_dropout"] = errs["float32", rate]
            af, kwf = case.args(torch.float32)   # the float32 instantiation
            row["f32_ms"] = time_ms(lambda: case.kernel(*af, **kwf))
        emit({"phase": "kernel" if d == D else "kernel_width", "ok": True,
              **{k: v for k, v in row.items() if k != "_key"}})
        rows.append(row)
        if len(rates) > 1 and (d != D and case.key == "tri_bridge"
                               or d == 64 and case.key == "qa_ctx_attention"):
            # the dropout variant a train step at this width launches (the
            # tri bridge's at every width but 128, the attention's
            # persistent kernel at 64: an instantiation of its own), a row
            # of its own, its launches the train path's
            kwd = {**kw, "dropout_rate": rates[1], "seed": DROP_SEED}
            drow = {**{k: v for k, v in row.items()
                       if not k.endswith("_dropout") and "f32" not in k},
                    "name": f"{case.name[:-1]}, dropout {rates[1]}]",
                    "max_abs_err": errs["bfloat16", rates[1]],
                    "ms": row["ms_dropout"],
                    "plain_ms": time_ms(lambda: case.plain(*a, **kwd)),
                    "_train": True}
            emit({"phase": "kernel_width", "ok": True,
                  **{k: v for k, v in drow.items()
                     if k not in ("_key", "_train")}})
            rows.append(drow)
    return rows


def phase_width_kernels(dev):
    """The three forward kernels at D = 64 and 256 (ops/widths.py), with
    dropout 0 and P_DROP; in bf16 also at the widths padded to them,
    ``PADDED_WIDTHS``, against the unpadded plain version."""
    return [row for d in OTHER_WIDTHS
            for row in phase_kernels(dev, d, (0.0, P_DROP))] + [
        row for d in PADDED_WIDTHS
        for row in phase_kernels(dev, d, (0.0, P_DROP), ("bfloat16",))]


def phase_width_train_kernels(dev):
    """The three backward kernels at D = 64 and 256 (ops/widths.py), dropout
    P_DROP, against autograd through their plain versions; in bf16 also at
    ``PADDED_WIDTHS``."""
    return [row for d in OTHER_WIDTHS
            for row in phase_train_kernels(dev, d)] + [
        row for d in PADDED_WIDTHS
        for row in phase_train_kernels(dev, d, ("bfloat16",))]


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


def headline_config(**kw):
    """The headline serving config (synthetic data, 32 examples, batch 16;
    compute_dtype "auto": bf16 on the card) with ``kw`` set."""
    from tvqaplus_tpu_torch.config import Config
    return Config(synthetic_data=True, add_local=True, bsz=B, test_bsz=B,
                  synthetic_n_valid=32, seed=SEED, **kw)


class PlainEncoderCalls:
    """Counts the plain k=7 encoder calls: only the plain chain of
    ``EncoderBlock`` adds the position table through its module."""

    def __enter__(self):
        from tvqaplus_tpu_torch.models.layers import PositionEncoding
        self.cls, self.real, self.n = (PositionEncoding,
                                       PositionEncoding.forward, 0)

        def counted(mod, x):
            self.n += 1
            return self.real(mod, x)
        PositionEncoding.forward = counted
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.real


def run_inference(cfg, sd, run_dir, must_launch, name="best_valid.pth",
                  **opt):
    """Write ``run_dir`` (opt.json from ``cfg`` with ``opt`` set, the
    weights ``sd`` as ``name``: a state_dict, or a file's bytes), run the
    inference entry point on the card and check its predictions.  Returns
    (predictions, launches, plain k=7 encoder calls, wall seconds)."""
    from tvqaplus_tpu_torch.inference import main_inference
    os.makedirs(run_dir)
    dataclasses.replace(cfg, **opt).save(os.path.join(run_dir, "opt.json"))
    if isinstance(sd, bytes):
        with open(os.path.join(run_dir, name), "wb") as f:
            f.write(sd)
    else:
        torch.save(sd, os.path.join(run_dir, name))
    reset_counters()
    t0 = time.perf_counter()
    with PlainEncoderCalls() as plain_calls:
        pred_path = main_inference(["--model_dir", run_dir, "--device",
                                    DEVICE])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters(must_launch)
    with open(pred_path) as f:
        pred = json.load(f)
    missing = [q for q in range(32) if str(q) not in pred["ts_answer"]]
    n_records = sum(len(recs) for ex in pred["raw_bbox"]
                    for recs in ex.values())
    if missing or n_records == 0:
        raise AssertionError(f"predictions: missing qids {missing}, "
                             f"{n_records} grounding records")
    return pred, launches, plain_calls.n, wall_s


def forward_outputs(model, batch):
    """The eval forward's outputs that the checks read, float32 on the CPU."""
    with torch.inference_mode():
        out = model(batch, need_sub_raw=False)
    return {k: out[k].float().cpu()
            for k in ("answer_scores", "t_scores", "vid_raw_s")}


def cpu_forwards(cfg, sd, model_cfg=None, edit=None):
    """The headline batch (``edit``ed) and its outputs from the CPU forward
    in each compute type (the separate-stream path: merging is exact in
    float32; ``model_cfg`` when not ``cfg``'s).  On the CPU every op runs
    its plain version."""
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    cpu_cfg = model_cfg or ModelConfig.from_config(cfg)
    cpu_batch = headline_batch(cfg, "cpu")
    if edit is not None:
        cpu_batch = edit(cpu_batch)
    refs = {}
    for dname in FWD_TOL:
        model = STAGE(dataclasses.replace(cpu_cfg,
                                          compute_dtype=dname)).eval()
        model.load_state_dict(sd)
        refs[dname] = forward_outputs(model, cpu_batch)
    return cpu_cfg, cpu_batch, refs


def forward_errors(got, ref, tol):
    """Errors of one forward's outputs against a reference's (see FWD_TOL),
    and whether they meet ``tol``: the span scores and the raw attention
    scores everywhere, the answer scores where both sides chose the same
    span, every argmax of a question whose five spans agree and whose
    reference margin exceeds twice the largest error of such scores."""
    from tvqaplus_tpu_torch.models import spans
    atol, rtol = tol

    def outside(name, keep=None):
        g, r = got[name], ref[name]
        bad = (g - r).abs() > atol + rtol * r.abs()
        return bad if keep is None else bad & keep
    same = torch.stack([g == r for g, r in zip(
        spans.eval_proposals(got["t_scores"]),
        spans.eval_proposals(ref["t_scores"]))]).all(0)          # (B, A)
    scores, want = got["answer_scores"], ref["answer_scores"]
    diff = (scores - want).abs()
    err = float(diff[same].max())
    top2 = want.topk(2, dim=-1).values
    agree = scores.argmax(-1) == want.argmax(-1)
    held = same.all(-1) & (top2[:, 0] - top2[:, 1] > 2 * err)
    report = {
        "tol": [atol, rtol],
        "t_scores_max_abs_err": float(
            (got["t_scores"] - ref["t_scores"]).abs().max()),
        "vid_raw_s_max_abs_err": float(
            (got["vid_raw_s"] - ref["vid_raw_s"]).abs().max()),
        "spans_equal": int(same.sum()), "spans": same.numel(),
        "answer_scores_max_abs_err_same_span": err,
        "answer_scores_max_abs_err": float(diff.max()),
        "answer_scores_mean_abs_err": float(diff.mean()),
        "argmax_agree": int(agree.sum()), "argmax_held": int(held.sum()),
        "rows": scores.shape[0]}
    failed = {"t_scores outside": int(outside("t_scores").sum()),
              "vid_raw_s outside": int(outside("vid_raw_s").sum()),
              "answer_scores outside (same span)": int(
                  outside("answer_scores", same).sum()),
              "argmax differs (held rows)": int((held & ~agree).sum())}
    return report, {k: v for k, v in failed.items() if v}


def headline_vs_cpu(cpu, sd, dev, merged):
    """One headline batch on the card, in each compute type, against the CPU
    forward in that type (``cpu`` from ``cpu_forwards``); the bf16 forward's
    distance from the CPU float32 forward is reported beside it."""
    from tvqaplus_tpu_torch.models.stage import STAGE
    cpu_cfg, cpu_batch, refs = cpu
    checks = {}
    for dname, tol in FWD_TOL.items():
        gpu_model = STAGE(dataclasses.replace(
            cpu_cfg, compute_dtype=dname, merge_input_streams=merged)).eval()
        gpu_model.load_state_dict(sd)
        gpu_model.to(dev)
        got = forward_outputs(gpu_model,
                              {k: v.to(dev) for k, v in cpu_batch.items()})
        checks[dname], failed = forward_errors(got, refs[dname], tol)
        if dname == "float32":
            # no choice moves at float32 rounding: every score and argmax
            scores, want = got["answer_scores"], refs[dname]["answer_scores"]
            torch.testing.assert_close(scores, want, atol=tol[0], rtol=tol[1])
            if not torch.equal(scores.argmax(-1), want.argmax(-1)):
                failed["argmax differs"] = True
        else:
            checks[dname]["vs_cpu_float32"] = forward_errors(
                got, refs["float32"], tol)[0]
        if failed:
            raise AssertionError(f"{dname} forward on the card against the "
                                 f"CPU {dname} forward: {failed}; "
                                 f"{checks[dname]}")
    return checks


def n_boxes(pred):
    return sum(len(r["bbox"]) for ex in pred["raw_bbox"]
               for recs in ex.values() for r in recs)


def phase_main(dev, workdir):
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    cfg = headline_config()                    # compute_dtype "auto"
    model = STAGE(ModelConfig.from_config(
        dataclasses.replace(cfg).finalize("cpu"))).reset_parameters(
        torch.Generator().manual_seed(SEED))
    sd = model.state_dict()
    pred, launches, plain_calls, wall_s = run_inference(
        cfg, sd, os.path.join(workdir, "main"), SEPARATE_FWD)
    if launches["encoder_block"] or plain_calls <= 0:
        raise AssertionError(f"the separate path ran merged: {launches}, "
                             f"{plain_calls} plain encoder calls")
    cpu = cpu_forwards(cfg.finalize("cpu"), sd)
    emit({"phase": "main", "ok": True, "launches": launches,
          "plain_encoder_calls": plain_calls,
          "examples": 32, "batches": -(-32 // B), "wall_s": wall_s,
          "ts_answer": len(pred["ts_answer"]),
          "raw_bbox_records": sum(len(recs) for ex in pred["raw_bbox"]
                                  for recs in ex.values()),
          "raw_bbox_boxes": n_boxes(pred),
          "headline_vs_cpu": headline_vs_cpu(cpu, sd, dev, False)})
    return cfg, sd, launches, pred, cpu


def grounding_by_qid(pred):
    """A prediction JSON's grounding entries by question, and the number of
    entries without records.  The entries' order follows the dispatch
    order, which the St and U buckets change (the pipeline stacks batches
    of one shape)."""
    out, empty = {}, 0
    for ex in pred["raw_bbox"]:
        qids = {r["qid"] for recs in ex.values() for r in recs}
        if len(qids) > 1:
            raise AssertionError(f"one grounding entry holds qids {qids}")
        if qids:
            out[qids.pop()] = ex
        else:
            empty += 1
    return out, empty


def grounding_diff(got, want):
    """The largest difference of two prediction JSONs' grounding scores and
    the records compared; raises unless the records match one to one
    (question, answer, word, clip, frame)."""
    from tvqaplus_tpu_torch.infer.predict import SCORE_THD
    (by_g, empty_g), (by_w, empty_w) = map(grounding_by_qid, (got, want))
    if by_g.keys() != by_w.keys() or empty_g != empty_w:
        raise AssertionError("grounding entries differ")
    worst, n_rec = 0.0, 0
    for qid, ex_w in by_w.items():
        ex_g = by_g[qid]
        for ans in ex_w:
            if len(ex_g[ans]) != len(ex_w[ans]):
                raise AssertionError("grounding records differ")
            for rg, rw in zip(ex_g[ans], ex_w[ans]):
                if any(rg[k] != rw[k] for k in ("word", "qid", "vid_name",
                                                "img_idx")):
                    raise AssertionError(f"record {rg} vs {rw}")
                n_rec += 1
                dg, dw = ({tuple(b): v for b, v in zip(r["bbox"], r["pred"])}
                          for r in (rg, rw))
                for box in dg.keys() | dw.keys():
                    # a box accepted on one side only sits at the threshold
                    worst = max(worst, abs(dg.get(box, SCORE_THD)
                                           - dw.get(box, SCORE_THD)))
    return worst, n_rec


def same_predictions(got, want, what, tol=1e-4):
    """Two prediction JSONs of one split hold the same answers and spans
    and grounding scores within ``tol`` (JAX tests/test_video_dedup.py
    ``test_predictions_identical``); returns (largest grounding
    difference, records)."""
    if got["ts_answer"] != want["ts_answer"]:
        raise AssertionError(f"{what}: answers/spans differ")
    worst, n_rec = grounding_diff(got, want)
    if worst > tol or n_rec == 0:
        raise AssertionError(f"{what}: grounding scores differ by {worst} "
                             f"over {n_rec} records")
    return worst, n_rec


def phase_merged_main(dev, workdir, cfg, sd, pred_sep, cpu):
    """The inference entry point with ``merge_input_streams`` in opt.json:
    bf16 as phase 5, and float32 against the separate path in float32."""
    raw = dataclasses.replace(cfg, compute_dtype="auto", use_kernels=None)
    pred, launches, plain_calls, wall_s = run_inference(
        raw, sd, os.path.join(workdir, "merged"), MERGED_FWD,
        merge_input_streams=True, eval_steps_per_dispatch=2)
    if plain_calls:
        raise AssertionError(f"{plain_calls} plain k=7 encoder calls ran on "
                             f"the merged path")
    same_bf16 = sum(pred["ts_answer"][q] == pred_sep["ts_answer"][q]
                    for q in pred["ts_answer"])
    f32 = {}
    for name, merged in (("separate", False), ("merged", True)):
        f32[name] = run_inference(
            raw, sd, os.path.join(workdir, f"f32_{name}"),
            MERGED_FWD if merged else SEPARATE_FWD, compute_dtype="float32",
            merge_input_streams=merged)[0]
    # merging is exact in float32 up to the order of the kernel's sums:
    # identical answers and spans, grounding scores at 1e-4
    worst, n_rec = same_predictions(f32["merged"], f32["separate"],
                                    "float32: merged vs separate")
    emit({"phase": "merged_main", "ok": True, "launches": launches,
          "plain_encoder_calls": plain_calls, "examples": 32,
          "wall_s": wall_s, "ts_answer": len(pred["ts_answer"]),
          "raw_bbox_boxes": n_boxes(pred),
          "bf16_answers_and_spans_equal_to_separate": same_bf16,
          "f32_answers_and_spans_equal": True, "f32_records": n_rec,
          "f32_grounding_max_abs_diff": worst, "f32_grounding_tol": 1e-4,
          "headline_vs_cpu": headline_vs_cpu(cpu, sd, dev, True)})
    return launches


def profile_steps(step, n, window=None):
    """Device busy time per step (the kernels' own times: one stream, no
    overlap; the profiler's annotation ranges such as the optimizer's are
    not kernels), launches per step, the kernels by device time and every
    kernel's launches (by name), over ``n`` profiled steps; ``window``, a
    list, also gets the profiled steps' host ms a step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        if window is not None:
            window.append((time.perf_counter() - t0) * 1e3 / n)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    if not kernels:
        return None, None, [], {}
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    top = [{"kernel": k[:80], "calls_per_step": c / n,
            "ms_per_step": t / 1e3 / n}
           for k, (c, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:12]]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    return busy_ms, len(kernels) / n, top, {k: c for k, (c, _) in
                                            by_name.items()}


def profiled_window(step, n):
    """``profile_steps`` over ``n`` steps with the profiled window's own
    host ms a step and the device's idle share against it: busy and host
    time from one window (against the turns' step ms, another window, a
    busy time longer than it read a share below 0).  Returns (busy ms,
    launches, top kernels, names, window ms, idle share)."""
    window = []
    busy_ms, per_step, top, names = profile_steps(step, n, window)
    idle = None if busy_ms is None else 1 - busy_ms / window[0]
    return busy_ms, per_step, top, names, window[0], idle


# the D = 128 designs' instantiations that the forwards at D = 64 replaced
OLD_FWD64 = ("qa_ctx_fwd_tc_kernel<64", "encoder_fwd_tc_kernel<64,",
             "tri_bridge_fwd_tc_kernel<64>")


def check_tc_forwards(step, names, merged, d=D):
    """The bf16 step's trace shows the tensor-core forwards at width ``d``
    (the encoder's cls_encoder at k 5, on the merged path the input encoder
    at k 7 too, and the tri bridge; at D = 64 the attention's persistent
    kernel and the encoder's and the tri bridge's of their own designs) and
    no CUDA-core forward of the encoder or the tri bridge (at D = 64 none
    of the D = 128 designs' instantiations, ``OLD_FWD64``); returns the
    tensor-core forwards' names."""
    tc = sorted(nm for nm in names
                if "encoder_fwd_tc" in nm or "tri_bridge_fwd_tc" in nm
                or "qa_ctx_fwd_tc64_kernel" in nm)
    old = sorted(nm for nm in names if "encoder_fwd_kernel" in nm
                 or "tri_bridge_fwd_kernel" in nm
                 or (d == 64 and any(o in nm.replace(" ", "")
                                     for o in OLD_FWD64)))
    # the instantiations: <D, k> at 128; D = 256 has its own kernels, the
    # encoder's <k> and the tri bridge's <DROP>, and D = 64 its own, the
    # encoder's <k, DROP> and the tri bridge's <DROP>
    enc, tri = {256: ("encoder_fwd_tc_wide_kernel<{}>",
                      "tri_bridge_fwd_tc256_kernel<"),
                64: ("encoder_fwd_tc64_kernel<{},",
                     "tri_bridge_fwd_tc64_kernel<")}.get(
        d, (f"encoder_fwd_tc_kernel<{d},{{}}>",
            f"tri_bridge_fwd_tc_kernel<{d}>"))
    want = [enc.format(5), tri] + [enc.format(7)] * merged \
        + ["qa_ctx_fwd_tc64_kernel<"] * (d == 64)
    flat = [nm.replace(" ", "") for nm in tc]
    missing = [w for w in want if not any(w in nm for nm in flat)]
    if missing or old:
        raise AssertionError(f"{step}: tensor-core forwards missing "
                             f"{missing}, CUDA-core or older forwards "
                             f"launched {old}")
    return [nm.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0] for nm in tc]


def timed_steps(steps, n):
    """Host-clock ms per step of each named step over ``n`` back-to-back
    steps ended by a synchronise, the paths in turns (a, b, b, a): the
    median of its two turns, and both."""
    names = list(steps)
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            steps[name]()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) / n * 1e3)
    return {name: (statistics.median(t), t) for name, t in turns.items()}


def replay_equals_eager(runner, batch):
    """One replayed serve dispatch (K = 1) against the eager step on the
    same batch: the keys whose every bit agrees, and the others."""
    want = runner.step(batch, True, LI)
    got = runner.dispatch_infer(batch, True, LI)
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(got[k][0], v)) for k, v in want.items()}
    if not all(same.values()):
        raise AssertionError(f"replayed serve step differs from the eager "
                             f"step: {same}")
    return sorted(same)


def phase_serving(dev, cfg, sd):
    """The eval step of the separate and the merged path on the same batch,
    eager and as a CUDA-graph replay (``InferenceRunner.dispatch_infer``,
    one step a dispatch), in turns."""
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    batch = headline_batch(cfg, dev)
    steps, out = {}, {}
    for name, merged in (("serving", False), ("merged_serving", True)):
        model = STAGE(dataclasses.replace(
            ModelConfig.from_config(cfg), compute_dtype="bfloat16",
            merge_input_streams=merged))
        model.load_state_dict(sd)
        runner = InferenceRunner(cfg, model.to(dev), dev)
        steps[name] = lambda runner=runner: runner.step(batch, True, LI)
        steps[name + "_no_grounding"] = \
            lambda runner=runner: runner.step(batch, False, LI)
        steps[name + "_graph"] = \
            lambda runner=runner: runner.dispatch_infer(batch, True, LI)
        t0 = time.perf_counter()
        steps[name + "_graph"]()           # warm-up and capture
        torch.cuda.synchronize()
        out[name + "_graph"] = {"capture_s": time.perf_counter() - t0,
                                "equal_to_eager": replay_equals_eager(
                                    runner, batch)}
        out[name] = {"event_ms": time_ms(steps[name]),
                     "event_ms_no_grounding": time_ms(
                         steps[name + "_no_grounding"])}
        out[name + "_graph"]["event_ms"] = time_ms(steps[name + "_graph"])
    clock = timed_steps(steps, SERVING_STEPS)
    for name in ("serving", "merged_serving", "serving_graph",
                 "merged_serving_graph"):
        step_ms, turns = clock[name]
        busy_ms, launches, top, names, window_ms, idle = profiled_window(
            steps[name], PROFILE_STEPS)
        merged = name.startswith("merged")
        tc_fwd = check_tc_forwards(name, names, merged)
        extra = out[name] if not name.endswith("_graph") else {
            **out[name], "eager_step_ms": clock[name[:-6]][0]}
        if not name.endswith("_graph"):
            extra["step_ms_no_grounding"] = \
                clock[name + "_no_grounding"][0]
        emit({"phase": name, "ok": True, "batch": B, "frames": LI,
              "compute_dtype": "bfloat16", "steps": SERVING_STEPS,
              "qa_pairs_per_s": B / (step_ms / 1e3), "step_ms": step_ms,
              "step_ms_turns": turns, **extra, "device_busy_ms": busy_ms,
              "profiled_step_ms": window_ms, "device_idle_share": idle,
              "launches_per_step": launches, "tc_forwards": tc_fwd,
              "top_kernels": top})


def serve_models(hszs):
    """(config, state dict) of the seeded STAGE of the headline config at
    each width of ``hszs``."""
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    models = {}
    for hsz in hszs:
        hcfg = dataclasses.replace(headline_config(hsz=hsz)).finalize("cpu")
        models[hsz] = (hcfg, STAGE(ModelConfig.from_config(
            hcfg)).reset_parameters(torch.Generator().manual_seed(
                SEED)).state_dict())
    return models


def serve_steps(dev, models):
    """The replayed serve dispatch (K = 1, bf16) of the headline batch of
    each width of ``models`` ({hsz: (config, state dict)}), separate and
    merged path, warmed up and captured: {name: (step, runner, batch)}."""
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    steps = {}
    for hsz, (hcfg, hsd) in models.items():
        batch = headline_batch(hcfg, dev)
        for merged in (False, True):
            name = f"hsz{hsz}_{'merged' if merged else 'separate'}_graph"
            model = STAGE(dataclasses.replace(
                ModelConfig.from_config(hcfg), compute_dtype="bfloat16",
                merge_input_streams=merged))
            model.load_state_dict(hsd)
            runner = InferenceRunner(hcfg, model.to(dev), dev)

            def step(runner=runner, batch=batch):
                return runner.dispatch_infer(batch, True, LI)
            step()                         # warm-up and capture
            torch.cuda.synchronize()
            steps[name] = (step, runner, batch)
    return steps


def serve_step_rows(steps):
    """A row for each step of ``steps`` ({name: step}): host ms a step
    over ``SERVING_STEPS`` steps in turns (``timed_steps``), QA/s, and from
    ``PROFILE_STEPS`` profiled steps the device's busy ms, the window's own
    host ms a step and the idle share against it (``profiled_window``),
    the launches in the trace, the top kernels and every kernel's name
    ("names")."""
    clock = timed_steps(steps, SERVING_STEPS)
    rows = {}
    for name, step in steps.items():
        step_ms, turns = clock[name]
        busy_ms, per_step, top, names, window_ms, idle = profiled_window(
            step, PROFILE_STEPS)
        rows[name] = {
            "hsz": int(name[3:name.index("_")]), "step_ms": step_ms,
            "step_ms_turns": turns, "qa_pairs_per_s": B / (step_ms / 1e3),
            "device_busy_ms": busy_ms, "profiled_step_ms": window_ms,
            "device_idle_share": idle,
            "launches_per_step": per_step, "top_kernels": top[:6],
            "names": names}
    return rows


def phase_wide_serving(dev, workdir, cfg, sd):
    """STAGE served at hsz 256 (and 64) on the card: the inference entry
    point on the separate and the merged path, every forward kernel launched
    at that width and none at D = 128; the hsz-256 headline batch on the
    card against the CPU forward (phase 5's bars); the replayed serve steps
    of hsz 128 (``cfg``, ``sd``: phase 5's), 256, 64 and the padded widths
    ``PADDED_WIDTHS``, both paths, equal to their eager steps and timed in
    turns (``serve_step_rows``; ``scripts/train_step_turns.py --serve``
    times the hsz-256 and -200 steps of a tree against another's), with the
    device's busy time, each trace holding its width's tensor-core
    forwards (``check_tc_forwards``: at 64 the attention's own kernel, not
    the D = 128 design's); a padded width's trace holds its instantiation's
    kernels, counted under its own width (one replay's launches).  Returns
    the launches of each width's runs by counter key."""
    t_phase = time.perf_counter()
    runs, launches = {}, {}
    models = {D: (cfg, sd), **serve_models((WIDE_HSZ, 64))}
    for hsz in (WIDE_HSZ, 64):
        wcfg = headline_config(hsz=hsz)
        for merged in (False, True):
            keys = MERGED_FWD if merged else SEPARATE_FWD
            tag = f"hsz{hsz}_{'merged' if merged else 'separate'}"
            pred, got, _, wall_s = run_inference(
                wcfg, models[hsz][1], os.path.join(workdir, f"wide_{tag}"),
                tuple(f"{k}@{hsz}" for k in keys),
                merge_input_streams=merged)
            at128 = {k: got[k] for k in keys if got[k]}
            if at128:
                raise AssertionError(f"{tag}: kernels launched at D = 128: "
                                     f"{at128}")
            runs[tag] = {"launches": {k: got[f"{k}@{hsz}"] for k in keys},
                         "wall_s": wall_s, "ts_answer": len(pred["ts_answer"]),
                         "raw_bbox_boxes": n_boxes(pred)}
            launches.update({f"{k}@{hsz}": got[f"{k}@{hsz}"] for k in keys})
    models.update(serve_models(PADDED_WIDTHS))
    wcfg, wsd = models[WIDE_HSZ]
    cpu = cpu_forwards(wcfg, wsd)
    vs_cpu = {name: headline_vs_cpu(cpu, wsd, dev, merged)
              for name, merged in (("separate", False), ("merged", True))}
    replay, padded = {}, {}
    steps = serve_steps(dev, {hsz: models[hsz]
                              for hsz in (D, WIDE_HSZ, 64) + PADDED_WIDTHS})
    for name, (step, runner, batch) in steps.items():
        replay[name] = replay_equals_eager(runner, batch)
        hsz = int(name[3:name.index("_")])
        if hsz in PADDED_WIDTHS:           # one replay's launches
            merged = "merged" in name
            keys = MERGED_FWD if merged else SEPARATE_FWD
            reset_counters()
            step()
            torch.cuda.synchronize()
            got = read_counters(tuple(f"{k}@{hsz}" for k in keys))
            padded[name] = {k: got[f"{k}@{hsz}"] for k in keys}
            launches.update({f"{k}@{hsz}": got[f"{k}@{hsz}"]
                             for k in keys
                             if merged == k.startswith("encoder_block")})
    serve = serve_step_rows({name: s[0] for name, s in steps.items()})
    for name, row in serve.items():
        names = row.pop("names")
        row["tc_forwards"] = check_tc_forwards(
            name, names, "merged" in name, padded_width(row["hsz"]))
        if name in padded:
            row["launches_at_true_width"] = padded[name]
    emit({"phase": "wide_serving", "ok": True, "batch": B, "frames": LI,
          "compute_dtype": "bfloat16", "steps": SERVING_STEPS, "runs": runs,
          "headline_vs_cpu": vs_cpu, "replay_equals_eager": replay,
          "serve_steps": serve, "wall_s": time.perf_counter() - t_phase})
    return launches



# the kernels a train step at a width other than 128 must show in its trace
# (bf16): the backwards of csrc/*_bwd_wide.cu and encoder_bwd_tc_wide.cu,
# all on the tensor cores (the attention's and its gq kernel, the
# encoder's and the tri bridge's at D = 64 and the tri bridge's at 256 of
# their own design),
# and their tensor-core
# weight gradient (wgrad_tc.cuh, shared by every width: its width is an
# argument, its column tile 64 at D = 64 and 128 above); and the D = 128
# kernels it must not show (forwards and backwards, both instantiations)
def wide_bwd_trace(d):
    bf = "__nv_bfloat16"
    att = (("qa_ctx_bwd_tc_wide_kernel<", f"qa_ctx_gq_wide_kernel<{bf},{bf},256>",
            "tri_bridge_bwd_tc256_kernel") if d == 256 else
           ("qa_ctx_bwd_tc64_kernel<", "qa_ctx_gq_tc64_kernel",
            "tri_bridge_bwd_tc64_kernel"))
    enc = "encoder_bwd_tc64_kernel<5>" if d == 64 \
        else f"encoder_bwd_tc_wide_kernel<5,{d}>"
    return att + (enc, f"wgrad_tc_kernel<{64 if d == 64 else 128}>")


D128_TRACE = ("qa_ctx_fwd_tc_kernel<128,", "tri_bridge_fwd_tc_kernel<128>",
              "encoder_fwd_tc_kernel<128,", "qa_ctx_fwd_kernel<",
              "qa_ctx_bwd_tc_kernel", "qa_ctx_gq_tc_kernel",
              "tri_bridge_bwd_tc_kernel", "encoder_bwd_tc_kernel",
              "qa_ctx_bwd_kernel<", "tri_bridge_bwd_kernel<",
              "encoder_bwd_kernel<")
WIDE_TRAIN_HSZ = (WIDE_HSZ, 64)


def check_wide_train_trace(step, names, merged, d):
    """A bf16 train step at width ``d`` != 128: its trace holds the
    tensor-core forwards at ``d`` (``check_tc_forwards``) and the wide
    backwards, and no kernel of D = 128; returns the backwards' names."""
    check_tc_forwards(step, names, merged, d)
    flat = [nm.replace(" ", "") for nm in names]
    want = wide_bwd_trace(d)
    missing = [w for w in want if not any(w in nm for nm in flat)]
    at128 = sorted({nm for nm in flat for w in D128_TRACE if w in nm})
    if missing:
        raise AssertionError(f"{step}: wide backwards missing {missing}")
    if at128:
        raise AssertionError(f"{step}: D = 128 kernels launched {at128}")
    return sorted({nm.replace("(anonymousnamespace)::", "")
                   .replace("void", "").split("(")[0]
                   for nm in flat if any(w in nm for w in want)})


def wide_train_cli(dev, workdir, hsz, merged, steps_per_dispatch):
    """The train CLI at width ``hsz`` on synthetic data (the headline
    training config otherwise: one debug epoch of four steps, validation, a
    checkpoint): finite losses, best_valid.pth written, every kernel of the
    path launched at ``hsz`` and none at D = 128.  Returns the launches."""
    from tvqaplus_tpu_torch.main import main as train_main
    tag = f"wide_train_hsz{hsz}{'_merged' if merged else ''}"
    argv = ["--synthetic_data", "--debug", "--add_local", "--use_sup_att",
            "--hsz", str(hsz), "--bsz", str(B), "--test_bsz", str(B),
            "--log_freq", "2", "--seed", str(SEED),
            "--results_dir_base", os.path.join(workdir, tag, "results"),
            "--steps_per_dispatch", str(steps_per_dispatch),
            "--device", DEVICE] + ["--merge_input_streams"] * merged
    keys = MERGED_TRAIN if merged else SEPARATE_TRAIN
    reset_counters()
    t0 = time.perf_counter()
    run_dir, trainer = train_main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = read_counters(tuple(f"{k}@{hsz}" for k in keys))
    at128 = {k: got[k] for k in keys if got[k]}
    if at128:
        raise AssertionError(f"{tag}: kernels launched at D = 128: {at128}")
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    if opt["hsz"] != hsz or opt["merge_input_streams"] != merged \
            or opt["compute_dtype"] != "bfloat16" or not opt["dropout"] > 0:
        raise AssertionError(f"{tag}: not the config asked for: {opt}")
    scalars = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            scalars.setdefault(rec["tag"], []).append(rec["value"])
    losses = [v for t in ("Train/Loss", "Valid/Loss")
              for v in scalars.get(t, [])]
    if not scalars.get("Train/Loss") or not scalars.get("Valid/Acc") \
            or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: losses and validation {scalars}")
    if not os.path.exists(os.path.join(run_dir, "best_valid.pth")):
        raise AssertionError(f"{tag}: the run wrote no best_valid.pth")
    return {"launches": {k: got[f"{k}@{hsz}"] for k in keys},
            "steps": trainer.step, "steps_per_dispatch": steps_per_dispatch,
            "wall_s": wall_s, "train_loss": scalars["Train/Loss"],
            "valid_loss": scalars.get("Valid/Loss"),
            "valid_acc": scalars["Valid/Acc"]}


def replays_equal_eager_train(cfg, dev, k):
    """A K-step replayed train dispatch (capture, then a replay) against as
    many eager steps from the same seed and batch, deterministic algorithms
    on: loss, grad_norm and every parameter bit for bit."""
    from tvqaplus_tpu_torch.train.loop import Trainer
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        eager, graph = Trainer(cfg, dev), Trainer(cfg, dev)
        batch = train_batch(cfg, dev, B)
        stack = stacked(batch, k)
        out = {}
        for tag in ("capture", "replay"):
            ms = eager._packed("train", [eager.train_step(batch)
                                         for _ in range(k)])
            mg = graph.dispatch_train(stack)
            torch.cuda.synchronize()
            names = graph._names["train"]
            same = {key: float(mg[key]) == float(ms[names.index(key)])
                    for key in ("loss", "grad_norm")}
            same["parameters"] = all(torch.equal(p, q) for p, q in
                                     zip(eager.params, graph.params))
            if not all(same.values()):
                raise AssertionError(f"hsz {cfg.hsz} {tag}: replay vs eager "
                                     f"{same}")
            out[tag] = float(mg["loss"])
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def keep_graph_nodes():
    """Makes the CUDA graphs captured from here on keep their cudaGraph_t,
    whose nodes ``graph_nodes`` counts; returns the call that undoes it."""
    graph_cls = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda: graph_cls(keep_graph=True)
    return lambda: setattr(torch.cuda, "CUDAGraph", graph_cls)


def train_steps(dev, workdir, hszs):
    """The replayed train dispatch (K = 4) of four stacked headline batches
    (bf16, dropout 0.1) at each width of ``hszs``, separate and merged
    path: each a Trainer's, warmed up, captured in a graph that keeps its
    nodes and replayed once (the graph instantiated).  Returns the steps by
    name and, on the card, each graph's nodes a step."""
    from tvqaplus_tpu_torch.train.loop import Trainer
    steps, nodes = {}, {}
    restore = keep_graph_nodes()
    try:
        for hsz in hszs:
            for merged in (False, True):
                cfg = train_config(workdir, bsz=B, hsz=hsz,
                                   merge_input_streams=merged).finalize(dev)
                name = (f"hsz{hsz}_{'merged' if merged else 'separate'}"
                        "_graph_k4")
                trainer = Trainer(cfg, dev)
                four = stacked(train_batch(cfg, dev, B), DISPATCH_K)
                steps[name] = lambda t=trainer, b=four: t.dispatch_train(b)
                steps[name]()              # warm-up and capture
                steps[name]()              # the graph instantiated
                torch.cuda.synchronize()
                if DEVICE == "cuda":
                    nodes[name] = graph_nodes(trainer.graphs) / DISPATCH_K
    finally:
        restore()
    return steps, nodes


def train_step_rows(steps, nodes):
    """A row for each of ``train_steps``' steps: host ms a step over
    ``TRAIN_STEPS`` steps in turns (``timed_steps``), trained QA/s, the
    loss; from a profiled window of two dispatches the device's busy ms,
    the window's own host ms a step and the idle share against it, the
    launches in the trace, the top kernels and every kernel's name
    ("names"); the graph's nodes a step."""
    k = DISPATCH_K
    clock = timed_steps(steps, TRAIN_STEPS // k)
    rows = {}
    for name, step in steps.items():
        step_ms, turns = clock[name][0] / k, [t / k for t in clock[name][1]]
        loss = float(step()["loss"]) / k
        if not math.isfinite(loss):
            raise AssertionError(f"{name}: training loss {loss}")
        window = []
        busy_ms, per_step, top, names = profile_steps(step, 2, window)
        if busy_ms is not None:
            busy_ms, per_step = busy_ms / k, per_step / k
        window_ms = window[0] / k
        rows[name] = {
            "hsz": int(name[3:name.index("_")]), "steps_per_dispatch": k,
            "loss": loss, "step_ms": step_ms, "step_ms_turns": turns,
            "qa_pairs_per_s": B / (step_ms / 1e3),
            "device_busy_ms": busy_ms, "profiled_step_ms": window_ms,
            "device_idle_share": None if busy_ms is None
            else 1 - busy_ms / window_ms,
            "launches_per_step": per_step,
            "graph_nodes_per_step": nodes.get(name),
            "top_kernels": top[:8], "names": names}
    return rows


def phase_wide_training(workdir):
    """Runs ``wide_training`` in a process of its own (``python3
    chip_smoke.py --wide-training WORKDIR``), its lines on this process's
    output: late in the whole run's process, after some thirty profiled
    sessions, the profiler's tracing of a replayed train dispatch faulted in
    native code (a segmentation fault inside the graph's replay), while the
    same phase in a fresh process traced cleanly.  Returns the launches of
    each width's CLI runs by counter key."""
    path = os.path.join(workdir, "wide_training.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--wide-training", workdir], timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"phase wide_training exited {proc.returncode}")
    with open(path) as f:
        return json.load(f)


def wide_training_process(workdir):
    """The child of ``phase_wide_training``: the card set up as
    ``phase_device`` sets it, the phase, its launches to a file."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = wide_training(torch.device("cuda"), workdir)
    with open(os.path.join(workdir, "wide_training.json"), "w") as f:
        json.dump(launches, f)
    return 0


def wide_training(dev, workdir):
    """STAGE trained at hsz 256 (and 64) on the card: the train CLI on the
    separate and the merged path (every kernel at that width, none at D =
    128; validation and a checkpoint); a float32 train step at hsz 256
    against the CPU (``phase_train_vs_cpu``'s bars); K = 4 replays equal to
    eager steps at hsz 256, both paths; and the replayed train steps (K =
    4) of hsz 128, 256, 64 and the padded widths ``PADDED_WIDTHS``, both
    paths, timed in turns, each step's trace holding its instantiation's
    kernels only (a padded width's counted under its own width: one
    replay's launches), each graph's nodes counted (``graph_nodes``).
    Returns the launches of each width's CLI runs (a padded width's
    replay) by counter key."""
    t_phase = time.perf_counter()
    runs, launches = {}, {}
    for hsz in WIDE_TRAIN_HSZ:
        for merged in (False, True):
            run = wide_train_cli(dev, workdir, hsz, merged, 2 if merged else 1)
            runs[f"hsz{hsz}_{'merged' if merged else 'separate'}"] = run
            launches.update({f"{k}@{hsz}": n
                             for k, n in run["launches"].items()
                             if merged == k.startswith("encoder_block")})
    vs_cpu = phase_train_vs_cpu(dev, workdir, hsz=WIDE_HSZ)
    replay, padded = {}, {}
    for merged in (False, True):
        cfg = train_config(workdir, bsz=B, hsz=WIDE_HSZ,
                           merge_input_streams=merged).finalize(dev)
        name = f"hsz{WIDE_HSZ}_{'merged' if merged else 'separate'}_graph_k4"
        replay[name] = replays_equal_eager_train(cfg, dev, DISPATCH_K)
    steps, nodes = train_steps(dev, workdir, (D, WIDE_HSZ, 64)
                               + PADDED_WIDTHS)
    for name, step in steps.items():
        hsz = int(name[3:name.index("_")])
        if hsz in PADDED_WIDTHS:       # one replay's launches
            merged = "merged" in name
            keys = MERGED_TRAIN if merged else SEPARATE_TRAIN
            reset_counters()
            step()
            torch.cuda.synchronize()
            got = read_counters(tuple(f"{k}@{hsz}" for k in keys))
            padded[name] = {k: got[f"{k}@{hsz}"] for k in keys}
            launches.update({f"{k}@{hsz}": got[f"{k}@{hsz}"] for k in keys
                             if merged == k.startswith("encoder_block")})
    train = train_step_rows(steps, nodes)
    for name, row in train.items():
        hsz, merged = row["hsz"], "merged" in name
        names = row.pop("names")
        # an empty trace fails here as in every phase
        if padded_width(hsz) != D:
            row["wide_kernels"] = check_wide_train_trace(
                name, names, merged, padded_width(hsz))
        else:
            row["tc_forwards"] = check_tc_forwards(name, names, merged)
        if name in padded:
            row["launches_at_true_width"] = padded[name]
    emit({"phase": "wide_training", "ok": True, "batch": B, "frames": LI,
          "compute_dtype": "bfloat16", "dropout": 0.1, "cli_runs": runs,
          "train_vs_cpu": vs_cpu, "replay_equals_eager": replay,
          "train_steps": train, "wall_s": time.perf_counter() - t_phase})
    return launches

# ---------------------------------------------------------------- training
def train_kernel_cases(dev, d=D):
    """The training variants of ``kernel_cases`` at width ``d``: dropout 0.1
    in every kernel, the vid attention site in raw mode "target".  Each case
    adds the differentiable inputs (positions in args; the encoder's
    parameter dict is differentiated as a whole), the plain version's flip
    rows (ops/checks.py) and the backward's operations."""
    from tvqaplus_tpu_torch.ops import checks
    targets = torch.randint(0, A, (B,), generator=torch.Generator(
        device=dev).manual_seed(SEED + 1), device=dev)
    drop = dict(dropout_rate=P_DROP, seed=DROP_SEED)
    cases = []
    for case in kernel_cases(dev, d):
        name, flops = case.name, case.flops
        if case.key == "qa_ctx_attention":
            lr = case.args(torch.float32)[0][2].shape[2]
            site = name[name.index("[") + 1:name.index(",")]
            raw_mode = "target" if site == "vid" else "none"
            kw = dict(raw_mode=raw_mode, targets=targets, **drop)

            def flip(a):
                return checks.attention_flip_elements(
                    *a, dropout_rate=P_DROP, seed=DROP_SEED)
            diff = (0, 1, 2, 3, 6, 7, 8, 9)
            m_rows = A * LQA
            # recompute S and att, g_p, gqe, gcn, gqn; g_yd and gW
            bflops = 2 * B * LI * m_rows * (6 * lr * d + 6 * d * d)
            name = (f"qa_ctx_attention[{site}, raw {raw_mode}, dropout"
                    + (f", D {d}]" if d != D else "]"))
        elif case.key == "tri_bridge":
            kw = dict(drop)

            def flip(a):
                return checks.tri_bridge_flip_rows(*a[:6], P_DROP,
                                                   DROP_SEED)[..., None]
            diff = tuple(range(8))
            bflops = 3 * flops             # recompute, g_yd, gW
        elif case.key == "mlp_bridge":
            kw = dict(drop)

            def flip(a):
                return checks.mlp_bridge_flip_rows(*a[:5], P_DROP,
                                                   DROP_SEED)[..., None]
            diff = tuple(range(7))
            bflops = 3 * flops             # recompute, g_yd, gW
        elif case.key == "encoder":
            kw = dict(drop)

            def flip(a):
                # bf16 is held by relative L2: only channels near a max tie
                if a[0].dtype == torch.bfloat16:
                    return checks.encoder_tie_elements(*a, P_DROP, DROP_SEED)
                return checks.encoder_flip_groups(*a, P_DROP,
                                                  DROP_SEED)[..., None]
            diff = (0, 2)
            # three D x D products forward (layer 0 twice), g_c and gpw per
            # layer
            bflops = 7 * flops // 2
        else:
            kw = dict(drop)

            def flip(a):
                if a[0].dtype == torch.bfloat16:     # held by relative L2
                    return torch.zeros(a[0].shape[:2] + (1, 1),
                                       dtype=torch.bool, device=dev)
                return checks.encoder_block_flip_groups(
                    *a, P_DROP, DROP_SEED)[..., None, None]
            diff = (0, 2)
            bflops = 7 * flops // 2        # as the reduce mode
        if "dropout" not in name:
            name = name[:-1] + ", dropout]" if name.endswith("]") \
                else name + "[dropout]"
        cases.append(dataclasses.replace(case, name=name, kw=kw, flip=flip,
                                         diff=diff, bflops=bflops))
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


def _cotangents(outs, flip, gen, valid=None):
    """Random cotangents of the outputs, zero on the flip rows, outside the
    valid positions (and on the raw scores of masked positions, which sit
    at -1e10)."""
    cots = []
    for j, o in enumerate(outs):
        c = torch.randn(o.shape, generator=gen, device=o.device)
        if j == 0:
            c = c * ~flip
            if valid is not None:
                c = c * valid
        else:
            c = c * (o > -1e9)
        cots.append(c.to(o.dtype))
    return cots


def phase_train_kernels(dev, d=D, dnames=("float32", "bfloat16")):
    """Forward kernels with dropout and the backward kernels against the
    plain version and autograd through it (same Philox mask), at width
    ``d``; the rows of the other widths (phase ``kernel_train_width``: the
    backwards only, the forwards are phase kernel_width's) take their
    launches from phase wide_training."""
    from tvqaplus_tpu_torch.ops import checks
    rows = []
    wide = d != D
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for case in train_kernel_cases(dev, d):
        name, key, kernel, plain = (case.name, case.key, case.kernel,
                                    case.plain)
        errs, gerrs, rel = {}, {}, {}
        for dname in dnames:
            dt = getattr(torch, dname)
            a, base_kw = case.args(dt)
            kwa = {**base_kw, **case.kw}
            fl = case.flip(a)
            results = []
            for fn in (kernel, plain):
                ins, leaves = _leaves(a, case.diff)
                outs = _outputs(fn(*ins, **kwa))
                if not results:
                    cots = _cotangents(outs, fl, gen, case.valid)
                torch.autograd.backward(outs, cots)
                results.append((outs, [t.grad for t in leaves]))
            torch.cuda.synchronize()
            (got, g_got), (want, g_want) = results
            errs[dname] = check_forward(case, name, dname, got, want)
            for i, (g, w) in enumerate(zip(g_got, g_want)):
                checks.hold_grad(f"{name} {dname} grad {i}", g, w,
                                 case.mod.GRAD_TOL[dt])
            gerrs[dname] = max_err(g_got, g_want)
            rel[dname] = max(checks.rel_l2(g, w)
                             for g, w in zip(g_got, g_want))
        a, base_kw = case.args(torch.bfloat16)
        kwa = {**base_kw, **case.kw}
        fl = case.flip(a)
        graphs = {}
        for tag, fn in (("kernel", kernel), ("plain", plain)):
            ins, leaves = _leaves(a, case.diff)
            outs = _outputs(fn(*ins, **kwa))
            graphs[tag] = (outs, leaves, _cotangents(outs, fl, gen,
                                                     case.valid))
        outs, leaves, cots = graphs["kernel"]
        moved, tensors = moved_bytes(a, *outs)
        today = {} if wide else time_today(case, torch.bfloat16, True)
        if not wide:
            b_ms, b_by = bound(moved, case.flops)
            row = {"name": name, "route": "cuda",
                   "source": f"tvqaplus_tpu_torch/{case.src}",
                   "replaces": REPLACES[key],
                   "max_abs_err": errs["bfloat16"],
                   "max_abs_err_f32": errs["float32"],
                   "ms": time_ms(lambda: kernel(*a, **kwa)),
                   "plain_ms": time_ms(lambda: plain(*a, **kwa)),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "bytes": moved, "flops": case.flops,
                   **{k: v for k, v in today.items() if k == "today_ms"},
                   "_key": key}
            af, _ = case.args(torch.float32)
            row["f32_ms"] = time_ms(lambda: kernel(*af, **kwa))
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
        b_ms, b_by = bound(bmoved, case.bflops)
        row = {"name": name.replace("[", " backward[", 1), "route": "cuda",
               "source": "tvqaplus_tpu_torch/" + bwd_source(key, d),
               "replaces": REPLACES[key + "_bwd"],
               "max_abs_err": gerrs["bfloat16"],
               "grad_rel_l2": rel["bfloat16"],
               "ms": time_ms(lambda: backward("kernel")),
               "plain_ms": time_ms(lambda: backward("plain")),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "bytes": bmoved, "flops": case.bflops, "deterministic": True,
               "_key": key + "_bwd" + (f"@{d}" if wide else "")}
        if wide:
            row["width"] = d
            row["instantiation"] = padded_width(d)
        if "float32" in dnames:
            row["max_abs_err_f32"] = gerrs["float32"]
            row["grad_rel_l2_f32"] = rel["float32"]
            ins, lv = _leaves(case.args(torch.float32)[0], case.diff)
            o32 = _outputs(kernel(*ins, **kwa))
            c32 = [c.to(o.dtype) for c, o in zip(cots, o32)]
            row["f32_ms"] = time_ms(
                lambda: torch.autograd.grad(o32, lv, c32, retain_graph=True))
            del o32, lv, ins
        if "today_fwd_bwd_ms" in today:
            # beside today's forward + backward: the kernels' as one call
            def fwd_bwd():
                ins, lv = _leaves(a, case.diff)
                return torch.autograd.grad(_outputs(kernel(*ins, **kwa)), lv,
                                           cots)
            row.update(today_fwd_bwd_ms=today["today_fwd_bwd_ms"],
                       fwd_bwd_ms=time_ms(fwd_bwd))
        emit({"phase": "kernel_train_width" if wide else "kernel_train",
              "ok": True, **{k: v for k, v in row.items() if k != "_key"}})
        rows.append(row)
        del graphs, grads
    return rows


def counters():
    """Every kernel's launch counter by key."""
    from tvqaplus_tpu_torch.ops import (
        encoder,
        mlp_bridge,
        qa_ctx_attention,
        tri_bridge,
    )
    out = {"qa_ctx_attention": qa_ctx_attention.KERNEL,
           "qa_ctx_attention_bwd": qa_ctx_attention.BWD_KERNEL,
           "tri_bridge": tri_bridge.KERNEL,
           "tri_bridge_bwd": tri_bridge.BWD_KERNEL,
           "encoder": encoder.KERNEL, "encoder_bwd": encoder.BWD_KERNEL,
           "encoder_block": encoder.BLOCK_KERNEL,
           "encoder_block_bwd": encoder.BLOCK_BWD_KERNEL,
           "mlp_bridge": mlp_bridge.KERNEL,
           "mlp_bridge_bwd": mlp_bridge.BWD_KERNEL}
    from tvqaplus_tpu_torch.ops._build import width_counter
    # the entries' other widths, and the widths padded to an instantiation
    # (the launches at that true width: ``by_width``)
    for d in OTHER_WIDTHS + PADDED_WIDTHS:
        tables = {"qa_ctx_attention": qa_ctx_attention.FWD_BY_WIDTH,
                  "tri_bridge": tri_bridge.FWD_BY_WIDTH,
                  "encoder": encoder.FWD_BY_WIDTH,
                  "encoder_block": encoder.BLOCK_BY_WIDTH,
                  "qa_ctx_attention_bwd": qa_ctx_attention.BWD_BY_WIDTH,
                  "tri_bridge_bwd": tri_bridge.BWD_BY_WIDTH,
                  "encoder_bwd": encoder.BWD_BY_WIDTH,
                  "encoder_block_bwd": encoder.BLOCK_BWD_BY_WIDTH}
        out.update({f"{k}@{d}": width_counter(t, d)
                    for k, t in tables.items()})
    return out


def reset_counters():
    for kernel in counters().values():
        kernel.launches = 0


def read_counters(must_launch):
    """The counts since the last reset; raises unless every kernel in
    ``must_launch`` launched."""
    out = {key: kernel.launches for key, kernel in counters().items()}
    idle = [key for key in must_launch if out[key] <= 0]
    if idle:
        raise AssertionError(f"kernels that did not launch: {idle} ({out})")
    return out


def phase_train_main(dev, workdir, merged=False, steps_per_dispatch=1):
    """The training entry point on the card at the headline training
    config (``merged``: plus ``--merge_input_streams``), dispatching
    ``steps_per_dispatch`` steps a CUDA-graph replay, then the inference
    entry point on the run it wrote."""
    import math
    from tvqaplus_tpu_torch.inference import main_inference
    from tvqaplus_tpu_torch.main import main as train_main
    tag = "merged_train" if merged else "train"
    argv = ["--synthetic_data", "--debug", "--add_local", "--use_sup_att",
            "--bsz", str(B), "--test_bsz", str(B), "--log_freq", "2",
            "--synthetic_n_valid", "32", "--seed", str(SEED),
            "--results_dir_base", os.path.join(workdir, tag, "results"),
            "--steps_per_dispatch", str(steps_per_dispatch),
            "--device", DEVICE] + ["--merge_input_streams"] * merged
    reset_counters()
    t0 = time.perf_counter()
    with PlainEncoderCalls() as plain_calls:
        run_dir, trainer = train_main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters(MERGED_TRAIN if merged else SEPARATE_TRAIN)
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    if not (opt["use_sup_att"] and opt["add_local"]
            and opt["compute_dtype"] == "bfloat16" and opt["dropout"] > 0
            and opt["merge_input_streams"] == merged):
        raise AssertionError(f"not the headline training config: {opt}")
    if bool(plain_calls.n) == merged or \
            bool(launches["encoder_block"]) != merged:
        raise AssertionError(f"merged={merged}: {plain_calls.n} plain k=7 "
                             f"encoder calls, {launches}")
    scalars = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            scalars.setdefault(rec["tag"], []).append(rec["value"])
    losses = [v for tag_ in ("Train/Loss", "Train/Loss_att",
                             "Train/Loss_cls", "Train/Loss_ts", "Valid/Loss")
              for v in scalars.get(tag_, [])]
    if not scalars.get("Train/Loss") or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses: {scalars}")
    if not os.path.exists(os.path.join(run_dir, "best_valid.pth")):
        raise AssertionError("the run wrote no best_valid.pth")
    pred_path = main_inference(["--model_dir", run_dir, "--device", DEVICE])
    with open(pred_path) as f:
        pred = json.load(f)
    if len(pred["ts_answer"]) != opt["synthetic_n_valid"]:
        raise AssertionError(f"{len(pred['ts_answer'])} predictions")
    if trainer.steps_per_dispatch != steps_per_dispatch \
            or not trainer.graphs.graphs:
        raise AssertionError(f"{tag}: {trainer.steps_per_dispatch} steps a "
                             f"dispatch, {len(trainer.graphs.graphs)} graphs")
    emit({"phase": tag + "_main", "ok": True, "launches": launches,
          "plain_encoder_calls": plain_calls.n,
          "steps": trainer.step, "steps_per_dispatch": steps_per_dispatch,
          "graphs": len(trainer.graphs.graphs), "wall_s": wall_s,
          "train_loss": scalars["Train/Loss"],
          "valid_acc": scalars.get("Valid/Acc"),
          "inference_answers": len(pred["ts_answer"])})
    return launches


class PhiloxDrop:
    """A ``layers.Dropout`` whose plain masks are the Philox masks of the
    fused kernels (one fixed seed), so a module's plain chain and its kernel
    route drop the same elements."""

    def __init__(self, rate, seed):
        self.rate, self.seed = rate, seed

    def __call__(self, x):
        from tvqaplus_tpu_torch.ops import philox
        return x * philox.multiplier(x.shape, self.seed, self.rate,
                                     x.device).to(x.dtype)

    def kernel_args(self):
        return self.rate, self.seed


def check_bridge_tc(dev, x, sd, drop):
    """The trace of a bf16 ``MLPBridge(use_kernel=True)`` train step
    (``bert_word_encoding_fc`` on ``qas_bert``) shows the tensor-core
    forward, backward and weight-gradient kernels and no CUDA-core kernel
    of the bridge; returns the tensor-core kernels' names."""
    from tvqaplus_tpu_torch.models.layers import MLPBridge
    name = "bert_word_encoding_fc"
    weights = {k[len(name) + 1:]: v for k, v in sd.items()
               if k.startswith(name + ".")}
    d_out, d_in = weights["2.weight"].shape
    mod = MLPBridge(d_in, d_out, P_DROP, torch.bfloat16,
                    use_kernel=True).to(dev).train()
    mod.load_state_dict(weights)
    leaf = x.to(torch.bfloat16).requires_grad_(True)

    def step():
        out = mod(leaf, drop)
        return torch.autograd.grad(out, [leaf] + list(mod.parameters()),
                                   torch.ones_like(out))
    step()
    *_, names = profile_steps(step, 1)
    want = ("mlp_bridge_fwd_tc_kernel", "mlp_bridge_bwd_tc_kernel",
            "mlp_bridge_wgrad_tc_kernel")
    missing = [w for w in want if not any(w in nm for nm in names)]
    old = sorted(nm for nm in names if "mlp_bridge_fwd_kernel" in nm
                 or "mlp_bridge_bwd_kernel" in nm
                 or "bridge_wgrad_kernel" in nm)
    if missing or old:
        raise AssertionError(f"bridge module bf16: tensor-core kernels "
                             f"missing {missing}, CUDA-core kernels {old}")
    return sorted(nm.replace("(anonymous namespace)::", "")
                  .replace("void ", "").split("(")[0] for nm in names
                  if any(w in nm for w in want))


def phase_bridge_module(dev, cfg, sd):
    """``MLPBridge`` with its kernel switch on (STAGE leaves it off, as the
    JAX package does) against the switch off, forward + backward in train
    mode with the same Philox mask, on the headline batch's ``qas_bert`` and
    ``vid`` with STAGE's own bridge weights.  float32: the bars of
    ops/mlp_bridge.py, the cotangent zero on rows whose ReLU input lies
    within rounding of 0 (ops/checks.py); bf16: relative L2 error of the
    output and of every gradient (see BRIDGE_BF16_REL_L2)."""
    from tvqaplus_tpu_torch.models.attention import l2_normalize
    from tvqaplus_tpu_torch.models.layers import MLPBridge
    from tvqaplus_tpu_torch.ops import checks, mlp_bridge
    batch = headline_batch(cfg, dev)
    drop = PhiloxDrop(P_DROP, DROP_SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    reset_counters()
    report = {}
    for name, x in (("bert_word_encoding_fc", batch["qas_bert"]),
                    ("vid_fc", l2_normalize(batch["vid"].float()))):
        weights = {k[len(name) + 1:]: v for k, v in sd.items()
                   if k.startswith(name + ".")}
        d_out, d_in = weights["2.weight"].shape
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            xs = x.to(dt)
            outs = {}
            for use_kernel in (True, False):
                mod = MLPBridge(d_in, d_out, P_DROP, dt,
                                use_kernel=use_kernel).to(dev).train()
                mod.load_state_dict(weights)
                leaf = xs.clone().requires_grad_(True)
                out = mod(leaf, drop)
                if use_kernel:
                    flip = checks.mlp_bridge_flip_rows(
                        xs, mod[0].weight, mod[0].bias, mod[2].weight.t(),
                        mod[2].bias, P_DROP, DROP_SEED)[..., None]
                    cot = (torch.randn(out.shape, generator=gen, device=dev)
                           * ~flip).to(dt)
                out.backward(cot)
                outs[use_kernel] = [out.detach(), leaf.grad] + [
                    p.grad for p in mod.parameters()]
            torch.cuda.synchronize()
            names = ["out", "gx"] + [k for k, _ in mod.named_parameters()]
            if dt == torch.float32:
                assert_close(f"{name} out", outs[True][:1], outs[False][:1],
                             mlp_bridge.TOL[dt])
                errs = {n_: checks.grad_close(f"{name} {n_}", g, w,
                                              mlp_bridge.GRAD_TOL[dt])
                        for n_, g, w in zip(names[1:], outs[True][1:],
                                            outs[False][1:])}
                errs["out"] = max_err(outs[True][:1], outs[False][:1])
            else:
                errs = {n_: float((g.float() - w.float()).norm()
                                  / w.float().norm())
                        for n_, g, w in zip(names, outs[True], outs[False])}
                bad = {k: v for k, v in errs.items()
                       if not v <= BRIDGE_BF16_REL_L2}
                if bad:
                    raise AssertionError(f"{name} bf16, kernel vs plain "
                                         f"chain, relative L2: {bad}")
            report[f"{name} {dname}"] = errs
    tc_kernels = check_bridge_tc(dev, batch["qas_bert"], sd, drop)
    launches = read_counters(("mlp_bridge", "mlp_bridge_bwd"))
    emit({"phase": "bridge_module", "ok": True, "launches": launches,
          "tc_kernels": tc_kernels,
          "dropout": P_DROP, "f32_tol": {"out": mlp_bridge.TOL[torch.float32],
                                         "grad": mlp_bridge.GRAD_TOL[
                                             torch.float32]},
          "bf16_rel_l2_tol": BRIDGE_BF16_REL_L2, "errors": report})
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


def phase_train_vs_cpu(dev, workdir, hsz=D):
    """One train step on the card against the same step on the CPU, at
    width ``hsz``; returns the line it emits."""
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.train.loop import Trainer
    n = CPU_STEP_BATCH
    cfg = train_config(workdir, bsz=n, dropout=0.0, compute_dtype="float32",
                       hsz=hsz)
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
    row = {"phase": "train_vs_cpu", "ok": True, "hsz": hsz, "batch": n,
           "frames": LI, "loss_cuda": float(mg["loss"]),
           "loss_cpu": float(mc["loss"]),
           "grad_norm_cuda": float(mg["grad_norm"]),
           "grad_norm_cpu": float(mc["grad_norm"]), "rel_err": checks,
           "worst_grad": worst, "tol": STEP_TOL}
    emit(row)
    return row


def stacked(batch, k):
    """``k`` copies of a batch stacked as the pipeline stacks a dispatch."""
    return {key: torch.stack([v] * k) for key, v in batch.items()}


def state_tensors(trainer):
    """The tensors a train step updates in place: parameters and Adam's
    moments and step counts."""
    out = [p.detach() for p in trainer.params]
    for st in trainer.optimizer.state.values():
        out += [v for v in st.values() if torch.is_tensor(v)]
    return out


def phase_dispatch(dev, workdir):
    """Replayed train dispatches against eager steps at the headline
    training config (batch 16, 50 frames, bf16, dropout 0.1, separate
    path), deterministic algorithms on (``DISPATCH_TOL``): an eager and a
    graph Trainer from the same seed take the same batches, a K = 1 and a
    K = 4 dispatch (warm-up and capture), then a K = 1 and a K = 4 replay
    against one and four eager steps: loss, grad_norm and every parameter.
    Then two replays from the same state (parameters and Adam's state
    copied back): other dropout masks, so other losses."""
    from tvqaplus_tpu_torch.train.loop import Trainer
    cfg = train_config(workdir, bsz=B).finalize(dev)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        eager, graph = Trainer(cfg, dev), Trainer(cfg, dev)
        batch = train_batch(cfg, dev, B)
        four = stacked(batch, DISPATCH_K)
        checks, t0 = {}, time.perf_counter()
        for tag, k in (("capture_k1", 1), ("capture_k4", DISPATCH_K),
                       ("replay_k1", 1), ("replay_k4", DISPATCH_K)):
            # the eager metrics summed as a dispatch sums them
            ms = eager._packed("train", [eager.train_step(batch)
                                         for _ in range(k)])
            mg = graph.dispatch_train(four if k > 1 else batch)
            torch.cuda.synchronize()
            got = {key: float(mg[key]) for key in ("loss", "grad_norm")}
            want = {key: float(ms[graph._names["train"].index(key)])
                    for key in ("loss", "grad_norm")}
            param_err = max(float((p.detach() - q.detach()).abs().max())
                            for p, q in zip(eager.params, graph.params))
            checks[tag] = {"graph": got, "eager": want,
                           "param_max_abs_err": param_err}
            bad = {key: (got[key], want[key]) for key in got
                   if abs(got[key] - want[key])
                   > DISPATCH_TOL * abs(want[key])}
            if bad or param_err > DISPATCH_TOL:
                raise AssertionError(f"{tag}: graph vs eager {bad}, "
                                     f"parameters {param_err} (bar "
                                     f"{DISPATCH_TOL})")
        if len(graph.graphs.graphs) != 2 or graph.step != eager.step:
            raise AssertionError(f"{len(graph.graphs.graphs)} graphs, steps "
                                 f"{graph.step} / {eager.step}")
        saved = [t.clone() for t in state_tensors(graph)]
        losses, seeds = [], []
        for _ in range(2):
            for t, v in zip(state_tensors(graph), saved):
                t.copy_(v)
            losses.append(float(graph.dispatch_train(batch)["loss"]))
            seeds.append(graph.seeds.seeds[:4].tolist())
        if losses[0] == losses[1] or seeds[0] == seeds[1]:
            raise AssertionError(f"two replays from one state drew the same "
                                 f"masks: losses {losses}, seeds {seeds}")
    finally:
        torch.use_deterministic_algorithms(False)
    emit({"phase": "dispatch", "ok": True, "batch": B, "frames": LI,
          "dropout": cfg.dropout, "deterministic_algorithms": True,
          "tol": DISPATCH_TOL, "checks": checks,
          "same_state_replay_losses": losses, "kernel_seeds": seeds,
          "wall_s": time.perf_counter() - t0})


def phase_training(dev, workdir):
    """The headline train step of the separate and the merged path on a
    batch already on the card, in turns: eager (``train_step``), one step a
    CUDA-graph replay (``dispatch_train``, K = 1) and four (K = 4, times per
    step)."""
    from tvqaplus_tpu_torch.train.loop import Trainer
    steps, out, cfgs, per_call = {}, {}, {}, {}
    for name, merged in (("training", False), ("merged_training", True)):
        cfg = train_config(workdir, bsz=B,
                           merge_input_streams=merged).finalize(dev)
        trainer = Trainer(cfg, dev)
        batch = train_batch(cfg, dev, B)
        four = stacked(batch, DISPATCH_K)
        steps[name] = lambda t=trainer, b=batch: t.train_step(b)
        steps[name + "_graph"] = \
            lambda t=trainer, b=batch: t.dispatch_train(b)
        steps[name + "_graph_k4"] = \
            lambda t=trainer, b=four: t.dispatch_train(b)
        per_call.update({name: 1, name + "_graph": 1,
                         name + "_graph_k4": DISPATCH_K})
        for key in (name, name + "_graph", name + "_graph_k4"):
            t0 = time.perf_counter()
            steps[key]()                    # graphs: warm-up and capture
            torch.cuda.synchronize()
            out[key] = {"first_call_s": time.perf_counter() - t0,
                        "event_ms": time_ms(steps[key], reps=8)
                        / per_call[key]}
            cfgs[key] = cfg
    clock = timed_steps(steps, TRAIN_STEPS)
    for name, step in steps.items():
        k = per_call[name]
        step_ms, turns = clock[name][0] / k, [t / k for t in clock[name][1]]
        loss = float(step()["loss"]) / k
        if not torch.isfinite(torch.tensor(loss)):
            raise AssertionError(f"training loss {loss}")
        # the idle share is taken against the unprofiled host clock, as
        # tracing slows the host
        busy_ms, launches, top, names = profile_steps(step, PROFILE_STEPS)
        if busy_ms is not None:
            busy_ms, launches = busy_ms / k, launches / k
        tc_fwd = check_tc_forwards(name, names,
                                   name.startswith("merged_training"))
        cfg = cfgs[name]
        emit({"phase": name, "ok": True, "batch": B, "frames": LI,
              "compute_dtype": cfg.compute_dtype, "dropout": cfg.dropout,
              "steps": TRAIN_STEPS * k, "steps_per_dispatch": k,
              "loss": loss, "qa_pairs_per_s": B / (step_ms / 1e3),
              "step_ms": step_ms, "step_ms_turns": turns, **out[name],
              "device_busy_ms": busy_ms,
              "device_idle_share": None if busy_ms is None
              else 1 - busy_ms / step_ms,
              "launches_per_step": launches, "tc_forwards": tc_fwd,
              "top_kernels": top})


# ------------------------------------- JAX checkpoints, heads, bookkeeping
HEADS = 8            # attention heads of the heads phase: divides hsz 128


def resumed_steps(cfg, path, batch, n):
    """A Trainer resumed from ``path`` on the card and ``n`` eager steps on
    ``batch``: (losses, its parameters, step, launches)."""
    from tvqaplus_tpu_torch.train.loop import Trainer
    trainer = Trainer(dataclasses.replace(cfg, resume=path), DEVICE)
    reset_counters()
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(n)]
    launches = read_counters(SEPARATE_TRAIN)
    return losses, [p.detach() for p in trainer.params], trainer.step, \
        launches


def phase_jax_checkpoint(dev, workdir):
    """The JAX package's checkpoint format on the card.  The seeded
    headline weights take two train steps of the port's trainer (bf16,
    dropout 0.1); that state, moments included, goes through
    ``flax_checkpoint_tree`` into the JAX ``save_checkpoint`` layout and
    ``flax_msgpack.dumps`` writes it.  Served as a run directory's
    ``best_valid.ckpt`` (no .pth; the CLI picks it by content), the
    predictions must equal, bit for bit, those of the same weights served
    from ``best_valid.pth``.  Resumed as ``last.ckpt`` for two steps, the
    losses and parameters must equal those of a trainer resumed from the
    torch checkpoint of the same state (deterministic algorithms on).  The
    attention, tri-bridge and encoder kernels must launch in both, and a
    file of neither format must raise an error that names the formats."""
    from tvqaplus_tpu_torch.inference import load_weights
    from tvqaplus_tpu_torch.interop import flax_msgpack
    from tvqaplus_tpu_torch.interop.weights import flax_checkpoint_tree
    from tvqaplus_tpu_torch.train.loop import Trainer
    t0 = time.perf_counter()
    root = os.path.join(workdir, "jax_checkpoint")
    cfg = train_config(root, bsz=B).finalize(dev)
    trainer = Trainer(cfg, dev)
    batch = train_batch(cfg, dev, B)
    for _ in range(2):
        trainer.train_step(batch)
    extra = {"best_acc": 0.5, "epoch": 0, "lr": trainer.scheduler.lr}
    data = flax_msgpack.dumps(flax_checkpoint_tree(
        trainer.model, trainer.optimizer, trainer.step, extra, cfg))
    trainer.best_acc = extra["best_acc"]
    torch_ckpt = os.path.join(root, "torch_last.ckpt")
    trainer.save(torch_ckpt)
    sd = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    del trainer
    flax_pred, serve_launches, _, _ = run_inference(
        headline_config(), data, os.path.join(root, "flax_run"),
        SEPARATE_FWD, name="best_valid.ckpt")
    pth_pred = run_inference(headline_config(), sd,
                             os.path.join(root, "pth_run"), SEPARATE_FWD)[0]
    if flax_pred != pth_pred:
        raise AssertionError("predictions served from best_valid.ckpt "
                             "differ from those of best_valid.pth")
    flax_ckpt = os.path.join(root, "flax_run", "last.ckpt")
    with open(flax_ckpt, "wb") as f:
        f.write(data)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        got = resumed_steps(cfg, flax_ckpt, batch, 2)
        want = resumed_steps(cfg, torch_ckpt, batch, 2)
    finally:
        torch.use_deterministic_algorithms(False)
    param_err = max(float((p - q).abs().max())
                    for p, q in zip(got[1], want[1]))
    if got[0] != want[0] or param_err != 0.0 or (got[2], want[2]) != (4, 4):
        raise AssertionError(f"resumed from the flax file: losses {got[0]}, "
                             f"step {got[2]}; from the torch checkpoint: "
                             f"{want[0]}, step {want[2]}; parameters differ "
                             f"by {param_err}")
    junk = os.path.join(root, "notes.txt")
    with open(junk, "w") as f:
        f.write("not a checkpoint\n")
    try:
        load_weights(junk, cfg)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a text file was read as a checkpoint")
    if "flax msgpack checkpoint" not in refused:
        raise AssertionError(f"the error names no format: {refused}")
    emit({"phase": "jax_checkpoint", "ok": True, "batch": B, "frames": LI,
          "checkpoint_bytes": len(data), "predictions_equal": True,
          "questions": len(flax_pred["ts_answer"]),
          "grounding_records": sum(len(r) for ex in flax_pred["raw_bbox"]
                                   for r in ex.values()),
          "serve_launches": serve_launches, "resume_launches": got[3],
          "resumed_losses": got[0], "torch_resumed_losses": want[0],
          "resumed_step": got[2], "param_max_abs_err": param_err,
          "unknown_format_error": refused[:160],
          "wall_s": time.perf_counter() - t0})


HEAD_CASES = (("heads0", False, 0), ("heads0_merged", True, 0),
              ("heads", False, HEADS), ("heads_merged", True, HEADS))


def replay_vs_eager_train(cfg, dev, batch):
    """A train step eager and as a replayed dispatch from the same seed,
    deterministic algorithms on: the same loss, grad_norm and parameters
    (capture, then replay); returns the graph Trainer and the checks."""
    from tvqaplus_tpu_torch.train.loop import Trainer
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        eager, graph = Trainer(cfg, dev), Trainer(cfg, dev)
        checks = {}
        for tag in ("capture", "replay"):
            ms = eager._packed("train", [eager.train_step(batch)])
            mg = graph.dispatch_train(batch)
            torch.cuda.synchronize()
            got = {k: float(mg[k]) for k in ("loss", "grad_norm")}
            want = {k: float(ms[graph._names["train"].index(k)])
                    for k in ("loss", "grad_norm")}
            err = max(float((p.detach() - q.detach()).abs().max())
                      for p, q in zip(eager.params, graph.params))
            checks[tag] = {"graph": got, "eager": want,
                           "param_max_abs_err": err}
            if got != want or err > DISPATCH_TOL or \
                    not all(map(math.isfinite, got.values())):
                raise AssertionError(f"train {tag}: {checks[tag]}")
    finally:
        torch.use_deterministic_algorithms(False)
    return graph, checks


def phase_heads(dev, workdir):
    """The separate and the merged headline configs with ``HEADS``
    attention heads in the input and the cls encoder, beside the same
    configs with none, in one call.  JAX's predicate routes every encoder
    with heads to the plain chain, and heads in the input encoder keep the
    merged config's streams separate: the encoder kernels (reduce and full
    output) must not launch, the attention and tri-bridge kernels must.
    With heads: the serve step against the CPU forward (``FWD_TOL``), a
    replayed serve dispatch equal to the eager step, a replayed train
    dispatch equal to the eager step.  For all four: the replayed serve
    and train steps' host ms (in turns), device busy ms, idle share and
    launches per step."""
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    t0 = time.perf_counter()
    out, serve, train, cpu = {}, {}, {}, None
    for name, merged, heads in HEAD_CASES:
        extra = dict(merge_input_streams=merged, cls_encoder_n_heads=heads,
                     input_encoder_n_heads=heads)
        cfg = headline_config(**extra).finalize(dev)
        model_cfg = ModelConfig.from_config(cfg)
        model = STAGE(model_cfg).reset_parameters(
            torch.Generator().manual_seed(SEED))
        sd = model.state_dict()
        rec = {"compute_dtype": cfg.compute_dtype}
        if heads:
            if cpu is None:      # one CPU reference: merging falls back
                cpu = cpu_forwards(headline_config().finalize("cpu"), sd,
                                   dataclasses.replace(
                                       model_cfg, merge_input_streams=False))
            rec["headline_vs_cpu"] = headline_vs_cpu(cpu, sd, dev, merged)
        batch = headline_batch(cfg, dev)
        runner = InferenceRunner(cfg, model.to(dev), dev)
        must = SEPARATE_FWD + ("encoder_block",) * (merged and not heads)
        if heads:
            must = ("qa_ctx_attention", "tri_bridge")
        reset_counters()
        runner.step(batch, True, LI)
        torch.cuda.synchronize()
        rec["serve_launches"] = read_counters(must)
        runner.dispatch_infer(batch, True, LI)        # warm-up and capture
        if heads:
            rec["serve_replay_equal_to_eager"] = replay_equals_eager(runner,
                                                                     batch)
        tcfg = train_config(workdir, bsz=B, **extra).finalize(dev)
        tbatch = train_batch(tcfg, dev, B)
        if heads:
            reset_counters()
            trainer, rec["train_replay_vs_eager"] = replay_vs_eager_train(
                tcfg, dev, tbatch)
            rec["train_launches"] = read_counters(
                ("qa_ctx_attention", "qa_ctx_attention_bwd", "tri_bridge",
                 "tri_bridge_bwd"))
            used = {k: v for k, v in {**rec["serve_launches"],
                                      **rec["train_launches"]}.items()
                    if k.startswith("encoder") and v}
            if used:
                raise AssertionError(f"{name}: the encoder kernel launched "
                                     f"at a site with heads: {used}")
        else:
            from tvqaplus_tpu_torch.train.loop import Trainer
            trainer = Trainer(tcfg, dev)
            trainer.dispatch_train(tbatch)            # warm-up and capture
        serve[name] = lambda r=runner, b=batch: r.dispatch_infer(b, True, LI)
        train[name] = lambda t=trainer, b=tbatch: t.dispatch_train(b)
        out[name] = rec
    heads_of = {name: heads for name, _, heads in HEAD_CASES}
    for kind, steps, n in (("serve", serve, SERVING_STEPS),
                           ("train", train, TRAIN_STEPS)):
        clock = timed_steps(steps, n)
        for name, step in steps.items():
            busy_ms, launches, top, names = profile_steps(step,
                                                          PROFILE_STEPS)
            enc = sorted({nm.replace("(anonymous namespace)::", "")
                          .replace("void ", "").split("(")[0]
                          for nm in names
                          if "encoder_fwd" in nm or "encoder_bwd" in nm})
            if heads_of[name] and enc:
                raise AssertionError(f"{name} {kind}: encoder kernels in "
                                     f"the trace: {enc}")
            if not any("tri_bridge_fwd_tc_kernel" in nm for nm in names):
                raise AssertionError(f"{name} {kind}: no tri-bridge "
                                     f"forward in the trace")
            step_ms, turns = clock[name]
            out[name].update({
                f"{kind}_step_ms": step_ms, f"{kind}_step_ms_turns": turns,
                f"{kind}_busy_ms": busy_ms,
                f"{kind}_idle_share": None if busy_ms is None
                else 1 - busy_ms / step_ms,
                f"{kind}_launches_per_step": launches,
                f"{kind}_encoder_kernels": enc,
                f"{kind}_top_kernels": top[:6]})
    for name, merged, heads in HEAD_CASES:
        emit({"phase": "heads", "case": name, "ok": True, "batch": B,
              "frames": LI, "merge_input_streams": merged,
              "cls_encoder_n_heads": heads, "input_encoder_n_heads": heads,
              **out[name]})
    emit({"phase": "heads_done", "ok": True,
          "wall_s": time.perf_counter() - t0})


def phase_bookkeeping(dev, workdir):
    """The training entry point on the card with ``--profile_dir`` over 13
    or more headline batches (208 examples in their frame buckets; one
    epoch, validation at batch 0): the trace of
    dispatches 8 to 12 must exist and name the hand-written kernels of the
    train step, and the run directory must hold opt.json and ``code.zip``
    with the package's sources."""
    import zipfile

    from tvqaplus_tpu_torch.main import main as train_main
    t0 = time.perf_counter()
    prof_dir = os.path.join(workdir, "bookkeeping", "profile")
    argv = ["--synthetic_data", "--add_local", "--use_sup_att",
            "--bsz", str(B), "--test_bsz", str(B),
            "--synthetic_n_train", str(13 * B), "--synthetic_n_valid",
            str(B), "--n_epoch", "1", "--log_freq", "100000",
            "--seed", str(SEED), "--profile_dir", prof_dir,
            "--results_dir_base",
            os.path.join(workdir, "bookkeeping", "results"),
            "--device", DEVICE]
    run_dir, trainer = train_main(argv)
    torch.cuda.synchronize()
    if trainer.step < 13 or not trainer.trace_path:
        raise AssertionError(f"{trainer.step} steps, trace "
                             f"{trainer.trace_path}")
    with open(trainer.trace_path) as f:
        trace = f.read()
    want = ("encoder_bwd_tc_kernel", "encoder_fwd_tc_kernel",
            "tri_bridge_fwd_tc_kernel", "qa_ctx")
    missing = [k for k in want if k not in trace]
    if missing:
        raise AssertionError(f"the profile_dir trace names no {missing}")
    with zipfile.ZipFile(os.path.join(run_dir, "code.zip")) as z:
        names = z.namelist()
    if "code/models/stage.py" not in names or \
            not os.path.exists(os.path.join(run_dir, "opt.json")):
        raise AssertionError(f"run directory: {os.listdir(run_dir)}, "
                             f"code.zip {len(names)} files")
    emit({"phase": "bookkeeping", "ok": True, "batch": B, "frames": LI,
          "steps": trainer.step, "trace": os.path.basename(
              trainer.trace_path), "trace_mb": len(trace) / 1e6,
          "kernels_in_trace": list(want),
          "code_zip_files": len(names),
          "tensorboard_mirror": trainer.logger.tb is not None,
          "wall_s": time.perf_counter() - t0})


# ------------------------------------------------- data parallelism
DP_DISPATCHES = 12   # K = DISPATCH_K replays of each trainer, then in turns
DP_TIMED = 3         # dispatches a turn of the timing


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_stack(cfg, dev, k):
    """``k`` distinct headline training batches (50 frames) stacked as a
    K-step dispatch."""
    from tvqaplus_tpu_torch.data.batching import (
        StaticShapeSpec,
        collate_static,
    )
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    ds = SyntheticTVQADataset(cfg, k * B, mode="train")
    spec = StaticShapeSpec.from_config(cfg, batch=B, train=True
                                       ).with_max_img(LI)
    out = [collate_static([ds[i] for i in range(j * B, (j + 1) * B)],
                          spec)[0] for j in range(k)]
    return {key: torch.stack([torch.from_numpy(o[key]) for o in out]
                             ).to(dev) for key in out[0]}


def nccl_trace(step, n):
    """The NCCL kernels in ``torch.profiler``'s trace of ``n`` calls of
    ``step`` (an all-reduce over one rank launches NCCL's
    ``oneRankReduce``): (launches a call, their device us a call, the
    longest launch's us, their names)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    us = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and ("nccl" in e.name.lower() or "onerank" in e.name.lower())]
    return (len(us) / n, sum(t for _, t in us) / n,
            max((t for _, t in us), default=0.0),
            sorted({nm[:80] for nm, _ in us}))


def dp_timing(trainers, four):
    """Each trainer's K-step dispatch of ``four``: host ms a step in turns
    (``timed_steps``), device busy ms, idle share and launches a step."""
    steps = {name: (lambda t=t: t.dispatch_train(four))
             for name, t in trainers.items()}
    clock = timed_steps(steps, DP_TIMED)
    out = {}
    for name, step in steps.items():
        busy, launches, _, _ = profile_steps(step, 2)
        step_ms = clock[name][0] / DISPATCH_K
        busy = None if busy is None else busy / DISPATCH_K
        out[name] = {
            "step_ms": step_ms,
            "step_ms_turns": [t / DISPATCH_K for t in clock[name][1]],
            "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / step_ms,
            "launches_per_step": None if launches is None
            else launches / DISPATCH_K}
    return out


def dp_train_main(workdir):
    """The training entry point as ``torchrun --nproc_per_node 1`` starts
    it (its environment), in the group already up: a ``--debug`` run at
    the headline training config; opt.json holds the global batch sizes.
    Returns the run directory."""
    from tvqaplus_tpu_torch.main import main as train_main
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        run_dir, trainer = train_main([
            "--synthetic_data", "--add_local", "--use_sup_att", "--debug",
            "--bsz", str(B), "--test_bsz", str(B), "--seed", str(SEED),
            "--steps_per_dispatch", str(DISPATCH_K), "--results_dir_base",
            os.path.join(workdir, "data_parallel", "results"),
            "--device", DEVICE])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    if trainer.mesh is None or trainer.mesh.group is None \
            or (opt["bsz"], opt["test_bsz"]) != (B, B) \
            or not os.path.exists(os.path.join(run_dir, "last.ckpt")):
        raise AssertionError(f"train entry point in the group: "
                             f"{os.listdir(run_dir)}, {trainer.mesh}")
    return run_dir


def phase_data_parallel(dev, workdir, smi):
    """The headline trainer and one serve pass in a world-1 NCCL group
    against the same without a group: equal bits (deterministic algorithms
    on), the collectives inside the K-step replay, and what they cost (in
    that mode, and in the default mode with fresh trainers).  Returns the
    group trainer's wrapper launches over its 12 dispatches and its
    profiled launches a step in the deterministic mode, which phase
    mesh_axes holds its (1, 1, 1) trainer to."""
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.parallel import mesh as dp
    from tvqaplus_tpu_torch.train.loop import Trainer
    t0 = time.perf_counter()
    dp.init_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                        local_device_ids=[dev.index or 0], device=dev.type)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        mesh = dp.make_mesh()
        backend = torch.distributed.get_backend()
        cfg = train_config(workdir, bsz=B, test_bsz=B).finalize(dev)
        trainers = {"group": Trainer(cfg, dev, mesh=mesh),
                    "no_group": Trainer(cfg, dev)}
        four = train_stack(cfg, dev, DISPATCH_K)
        losses = {name: [] for name in trainers}
        launches = None
        for name, trainer in trainers.items():
            reset_counters()
            for _ in range(DP_DISPATCHES):
                m = trainer.dispatch_train(four)
                losses[name].append((float(m["loss"]),
                                     float(m["grad_norm"])))
            torch.cuda.synchronize()
            if name == "group":
                launches = read_counters(SEPARATE_TRAIN)
        tg, tn = trainers["group"], trainers["no_group"]
        if len(tg.graphs.graphs) != 1:
            raise AssertionError(f"{len(tg.graphs.graphs)} graphs")

        def same_state():
            return all(torch.equal(a, b) for a, b in
                       zip(state_tensors(tg), state_tensors(tn)))
        if losses["group"] != losses["no_group"] or not same_state():
            raise AssertionError(f"world-1 group vs no group: losses "
                                 f"{losses}, state equal {same_state()}")
        timing_det = dp_timing(trainers, four)
        if not same_state():
            raise AssertionError("the timed dispatches parted the states")

        # one serve pass of the trained weights, with and without the group
        ds = SyntheticTVQADataset(cfg, 4 * B, mode="valid")
        words = list(range(3, 1000, 4))
        preds = {name: InferenceRunner(cfg, t.model, dev,
                                       mesh if name == "group" else None
                                       ).run(ds, object_word_ids=words)
                 for name, t in trainers.items()}
        if preds["group"] != preds["no_group"] \
                or len(preds["group"]["ts_answer"]) != 4 * B:
            raise AssertionError("world-1 group vs no group: the serve "
                                 "pass's predictions differ")
        valid = {name: t.validate(ds) for name, t in trainers.items()}
        if valid["group"] != valid["no_group"]:
            raise AssertionError(f"validation: {valid}")
        run_dir = dp_train_main(workdir)

        # the default mode (what a run uses): fresh trainers, in turns
        torch.use_deterministic_algorithms(False)
        trainers = {"group": Trainer(cfg, dev, mesh=mesh),
                    "no_group": Trainer(cfg, dev)}
        for trainer in trainers.values():
            trainer.dispatch_train(four)            # warm-up and capture
        timing = dp_timing(trainers, four)
        n_nccl, nccl_us, longest_us, nccl_names = nccl_trace(
            lambda: trainers["group"].dispatch_train(four), 2)
        if n_nccl / DISPATCH_K < 1:
            raise AssertionError("no NCCL kernel in the replay")
        if nccl_trace(lambda: trainers["no_group"].dispatch_train(four),
                      1)[0]:
            raise AssertionError("NCCL kernels without a group")
        flat = torch.cat([p.detach().reshape(-1)
                          for p in trainers["group"].params])
        eager_ms = time_ms(lambda: dp.all_reduce_sum(mesh, flat.clone()))
        clone_ms = time_ms(lambda: flat.clone())
        # why the port pre-multiplies: NCCL's in-place SUM over one rank
        plain_sum = nccl_trace(lambda: torch.distributed.all_reduce(
            flat, op=torch.distributed.ReduceOp.SUM), 3)[0]
    finally:
        torch.use_deterministic_algorithms(False)
        dp.close()
    emit({"phase": "data_parallel", "ok": True, "nvidia_smi": smi,
          "world": 1, "backend": backend,
          "nccl": ".".join(map(str, torch.cuda.nccl.version())),
          "batch": B, "frames": LI, "dropout": cfg.dropout,
          "compute_dtype": cfg.compute_dtype,
          "dispatches": DP_DISPATCHES, "steps_per_dispatch": DISPATCH_K,
          "bitwise_equal": True, "losses": losses["group"][:3],
          "launches": launches, "timing": timing,
          "timing_deterministic": timing_det,
          "allreduce": {
              "params": flat.numel(), "bytes": flat.numel() * 4,
              "nccl_kernels_per_step": n_nccl / DISPATCH_K,
              "nccl_device_us_per_step": nccl_us / DISPATCH_K,
              "longest_nccl_kernel_us": longest_us, "kernels": nccl_names,
              "eager_call_event_ms": eager_ms,
              "clone_event_ms": clone_ms,
              "inplace_sum_kernels_per_call": plain_sum},
          "serve_qas": len(preds["group"]["ts_answer"]),
          "serve_records": len(preds["group"]["raw_bbox"]),
          "valid_acc": valid["group"][0],
          "train_main_run": os.listdir(run_dir),
          "wall_s": time.perf_counter() - t0})
    return launches, timing_det["group"]["launches_per_step"]


# ------------------------------------------------- the ctx and model axes
MESH_SHAPES = [(1, 2), (1, 1, 2)]   # two processes on the one card
MESH_TRAIN_STEPS = 3                 # checked eager steps a mesh
# (loss, grad norm) relative bars of the two-process steps against the
# single process, deterministic algorithms on.  The first step: 1e-5, the
# CPU tests' bar (tests/test_torch_mesh_axes.py): the same weights, the
# per-frame kernels on half the frames or the bridges on half the
# columns, float32 sums in another order.  After an Adam update the two
# trajectories part by more than that rounding, as JAX's own
# tensor-parallel test says of its step 2 (tests/test_train.py:322-352,
# held at 5e-3): Adam's first update moves every parameter by about lr,
# one whose gradient is rounding noise with a random sign, and a column
# block's product rounds otherwise on the card (cuBLAS) where the CPU's
# rounds alike.  Measured on an NVIDIA H100 80GB HBM3 (700 W): the losses
# after an update 1.2e-5 to 2.6e-3 apart, the grad norms up to 1.6% (on
# the CPU at batch 2 x 4 frames: 2.6e-5).  Later steps: the loss at JAX's
# 5e-3, the grad norm at 5e-2.
MESH_STEP_RTOL = ((1e-5, 1e-5), (5e-3, 5e-2))
MESH_GROUNDING_TOL = 1e-4
# the model axis over the kernels' weights (hsz >= 256, parallel/mesh.py
# gather_weight): the (1, 1, 2) train steps at this width, and the bar of
# each split weight's first gradient (whole) against one process's,
# relative L2.  Measured on an NVIDIA H100 80GB HBM3 (700 W): 3.1e-5 (the
# cls encoder's pointwise convs) to 2.3e-3 (the attention's projection),
# growing from the head toward the inputs as a float32 rounding that moves
# a ReLU sign or a word-max choice does (on the CPU: 5.9e-7); a gather whose
# backward summed over the two model ranks would give 1.0
MESH_WIDE_HSZ = 256
MESH_WIDE_GRAD_REL_L2 = 1e-2
# the bisect of that gap (ROADMAP C8): each module's first output is held
# at a fixed stride of at most this many values; a layer "parts" from
# another run above BISECT_PARTS relative L2
BISECT_SAMPLES = 1 << 16
BISECT_PARTS = 1e-5


def first_step_record(trainer, train, mesh):
    """One train step of ``trainer`` on ``train`` that also records, for
    the bisect of the model axis's gap (ROADMAP C8), every module's first
    output (float32, a fixed stride of at most BISECT_SAMPLES values) and
    every parameter's gradient before the clip (a weight the model axis
    splits gathered whole), each parameter placed at the innermost module
    holding it that ran, in the forward's order.  Returns (metrics,
    record)."""
    from tvqaplus_tpu_torch.parallel import mesh as dp
    from tvqaplus_tpu_torch.train import loop
    model = trainer.model
    calls, acts, hooks = {}, {}, []

    def hook(name):
        def record(mod, args, out):
            if name in calls:
                return
            calls[name] = len(calls)
            t = out if torch.is_tensor(out) else next(
                (o for o in (out if isinstance(out, (tuple, list)) else ())
                 if torch.is_tensor(o)), None)
            if t is not None and t.is_floating_point():
                flat = t.detach().float().reshape(-1)
                acts[name] = flat[::max(1, flat.numel() // BISECT_SAMPLES)][
                    :BISECT_SAMPLES].cpu()
        return record
    for name, mod in model.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(hook(name)))
    pre = {}
    clip = loop.clip_grad_norm

    def capture(params, *args, **kw):
        pre.update({id(p): p.grad.detach().clone() for p in params
                    if p.grad is not None})
        return clip(params, *args, **kw)
    loop.clip_grad_norm = capture
    try:
        metrics = trainer.train_step(train, True)
    finally:
        loop.clip_grad_norm = clip
        for h in hooks:
            h.remove()
    dims = {name: dim for name, dim in dp.sharded_parameters(
        _stage(trainer.cfg), 2).items() if name in model.shards}
    grads, at = {}, {}
    for k, (name, p) in enumerate(model.named_parameters()):
        if id(p) not in pre:
            continue
        g = pre[id(p)]
        grads[name] = (dp._gather_full(mesh, g, dims[name]) if name in dims
                       else g).cpu()
        owner = name.rsplit(".", 1)[0]
        while owner not in calls and "." in owner:
            owner = owner.rsplit(".", 1)[0]
        at[name] = (calls.get(owner, len(calls)), k)
    return metrics, {"grads": grads, "order": sorted(grads, key=at.get),
                     "acts": acts, "act_order": sorted(acts, key=calls.get)}


def halves_dense(model):
    """``models/layers.py`` ``dense`` for the one process that takes the
    model axis's order of float32 sums (the bisect of ROADMAP C8): each
    dense layer the axis splits by columns takes its two column blocks as
    two products (the two ranks' shapes), whose input gradients autograd
    sums as the ranks' all-reduce does, before the whole bias."""
    import torch.nn.functional as F
    from tvqaplus_tpu_torch.models import layers
    from tvqaplus_tpu_torch.parallel import mesh as dp
    real = layers.dense
    split = set()
    for name in dp.sharded_parameters(model, 2):
        layer, whole = dp._split_layer(model, name)
        if not whole:
            split.add(id(layer))

    def dense(x, lin, dtype):
        if id(lin) not in split:
            return real(x, lin, dtype)
        xx = x.to(dtype)
        xx = xx.view_as(xx)           # one node takes both blocks' grads
        w = lin.weight.to(dtype)
        n = w.shape[0] // 2
        h = torch.cat([F.linear(xx, w[:n].clone()),
                       F.linear(xx, w[n:].clone())], -1)
        return h + lin.bias.to(dtype)
    return dense


def rel_l2(got, want):
    den = float(want.norm())
    num = float((got - want).norm())
    return num / den if den else (0.0 if num == 0.0 else math.inf)


def bisect_report(ranks, single, halves):
    """The bisect of ROADMAP C8: for each parameter (its gradient before
    the clip) and each module output, in the forward's order, the relative
    L2 gap of rank 0 against the single process, against the single
    process that takes the ranks' order of sums (``halves``), and of rank
    1 against rank 0; and for each comparison the first layer that parts
    above BISECT_PARTS."""
    r0, r1 = ranks[0]["wide"]["bisect"], ranks[1]["wide"]["bisect"]
    pairs = {"rank0_vs_single": single, "rank0_vs_halves": halves}
    out = {"params": [], "acts": [], "first_param_over": {},
           "first_act_over": {}, "max_param": {}, "max_act": {}}
    for name in r0["order"]:
        row = {"name": name, "split": name in ranks[0]["wide"]["grads"],
               "rank1_vs_rank0": rel_l2(r1["grads"][name], r0["grads"][name])}
        for key, ref in pairs.items():
            row[key] = rel_l2(r0["grads"][name], ref["grads"][name])
        out["params"].append(row)
    for name in r0["act_order"]:
        row = {"name": name,
               "rank1_vs_rank0": rel_l2(r1["acts"][name], r0["acts"][name])}
        for key, ref in pairs.items():
            row[key] = rel_l2(r0["acts"][name], ref["acts"][name])
        out["acts"].append(row)
    for key in (*pairs, "rank1_vs_rank0"):
        for kind in ("param", "act"):
            rows = out[kind + "s"]
            first = next((r for r in rows if r[key] > BISECT_PARTS), None)
            out[f"first_{kind}_over"][key] = first and {
                "name": first["name"], "rel_l2": first[key],
                "index": rows.index(first), "of": len(rows)}
            out[f"max_{kind}"][key] = max((r[key] for r in rows),
                                          default=0.0)
    return out


def _staged(name, real):
    """``real`` (a torch.distributed collective) over host copies of its
    CUDA tensors: for a collective that gloo refuses on them."""
    def all_reduce(t, *args, **kw):
        h = t.cpu()
        work = real(h, *args, **kw)
        t.copy_(h)
        return work

    def broadcast(t, *args, **kw):
        h = t.cpu()
        work = real(h, *args, **kw)
        t.copy_(h)
        return work

    def all_gather(outs, t, *args, **kw):
        hs = [torch.empty(o.shape, dtype=o.dtype) for o in outs]
        work = real(hs, t.cpu(), *args, **kw)
        for o, h in zip(outs, hs):
            o.copy_(h)
        return work
    return {"all_reduce": all_reduce, "broadcast": broadcast,
            "all_gather": all_gather}[name]


def gloo_on_cuda(dev):
    """Probe the collectives the package calls with CUDA tensors over the
    gloo group; stage each that gloo refuses through host copies (this
    harness only).  Then count the bytes every all-gather receives.
    Returns (the staged names, the byte counter)."""
    import torch.distributed as dist
    x = torch.arange(4.0, device=dev)
    probes = {
        "all_reduce": lambda f: f(x.clone()),
        "broadcast": lambda f: f(x.clone(), src=0),
        "all_gather": lambda f: f([torch.empty_like(x) for _ in range(2)],
                                  x)}
    staged = []
    for name, probe in probes.items():
        try:
            probe(getattr(dist, name))
            if dev.type == "cuda":
                torch.cuda.synchronize()
        except RuntimeError:
            if dev.type != "cuda":
                raise
            setattr(dist, name, _staged(name, getattr(dist, name)))
            staged.append(name)
    counter = {"bytes": 0}
    gather = dist.all_gather

    def counted(outs, t, *args, **kw):
        counter["bytes"] += sum(o.numel() * o.element_size()
                                for o in outs) - t.numel() * t.element_size()
        return gather(outs, t, *args, **kw)
    dist.all_gather = counted
    return staged, counter


def mesh_steps(job, mesh, dev, counter=None, serve=True, halves=False):
    """What phase mesh_axes compares, on ``mesh`` (None: the single
    process): three eager train steps' losses and grad norms, the eager
    train step's ms (and the bytes its all-gathers received, and of them
    the whole-weight gathers'), the serve step's outputs and ms (float32,
    dropout 0), and the bf16 forward's outputs (``serve``: those two).
    Without ``serve`` (the model axis's case) the first step is recorded
    for the bisect (``first_step_record``); ``halves``: the single process
    takes the model axis's order of sums (``halves_dense``)."""
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models import layers
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.parallel import mesh as dp
    from tvqaplus_tpu_torch.train.loop import Trainer
    cfg = job["cfg"]

    def model_of(c):
        m = STAGE(ModelConfig.from_config(c))
        m.load_state_dict(job["sd"])
        return m
    train = dp.shard_batch(mesh, {k: v.to(dev) for k, v in
                                  job["train"].items()})
    trainer = Trainer(cfg, dev, model=model_of(cfg), mesh=mesh)
    trainer.graphs = None                  # eager: gloo is not captured
    out = {"train": []}
    real_dense = layers.dense
    if halves:
        layers.dense = halves_dense(trainer.model)
    try:
        for i in range(MESH_TRAIN_STEPS):
            if i == 0 and not serve:   # the model axis's case: bisected
                m, out["bisect"] = first_step_record(trainer, train, mesh)
            else:
                m = trainer.train_step(train, True)
            out["train"].append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0 and not serve:
                # the first step's gradients of the weights the model axis
                # splits, whole (after the clip), to hold against one
                # process
                shards = trainer.model.shards
                split = dp.sharded_parameters(model_of(cfg), 2)
                out["grads"] = {
                    name: (dp._gather_full(mesh, p.grad) if name in shards
                           else p.grad).cpu()
                    for name, p in trainer.model.named_parameters()
                    if name in split}
    finally:
        layers.dense = real_dense
    if halves:
        return out
    if counter is not None:
        weights = {"bytes": 0}
        gather = dp.gather_weight

        def counted(layer):
            before = counter["bytes"]
            w = gather(layer)
            weights["bytes"] += counter["bytes"] - before
            return w
        counter["bytes"] = 0
        dp.gather_weight = counted
        try:
            trainer.train_step(train, True)
        finally:
            dp.gather_weight = gather
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["train_gathered_bytes"] = counter["bytes"]
        out["train_weight_gathered_bytes"] = weights["bytes"]
        # the prediction: each whole-weight layer's other blocks, once
        out["train_weight_bytes_predicted"] = sum(
            m.weight.numel() * m.weight.element_size()
            * (m.shard.size - 1) for m in trainer.model.whole_layers)
    timed = dev.type == "cuda"       # a CPU rehearsal times nothing
    out["train_ms"] = time_ms(lambda: trainer.train_step(train, True),
                              reps=5, warmup=1) if timed else None
    if not serve:
        return out
    serve = dp.shard_batch(mesh, {k: v.to(dev) for k, v in
                                  job["serve"].items()})
    runner = InferenceRunner(cfg, model_of(cfg), dev, mesh)
    runner.graphs = None
    if counter is not None:
        counter["bytes"] = 0
    res = runner.step(serve, True, job["frames"])
    if timed:
        torch.cuda.synchronize()
    if counter is not None:
        out["serve_gathered_bytes"] = counter["bytes"]
    out["serve"] = {k: v.cpu() for k, v in res.items()}
    out["serve_ms"] = time_ms(lambda: runner.step(serve, True, job["frames"]),
                              reps=5, warmup=1) if timed else None
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    out["bf16"] = forward_outputs(
        dp.place_model(mesh, model_of(bf16).to(dev)), serve)
    return out


def merged_encoder_call(jm, mesh, dev):
    """One bf16 train step of the merged path with dropout (``jm``: its
    config, weights and global batch) on ``mesh`` (None: one process):
    the merged input encoder's call, its input, output, zero mask, rate
    and the seeds of its kernel sites (the merged dropout probe of phase
    mesh_axes, ROADMAP C5)."""
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    from tvqaplus_tpu_torch.parallel import mesh as dp
    from tvqaplus_tpu_torch.train.loop import Trainer
    model = STAGE(ModelConfig.from_config(jm["cfg"]))
    model.load_state_dict(jm["sd"])
    trainer = Trainer(jm["cfg"], dev, model=model, mesh=mesh)
    trainer.graphs = None
    seen = []

    def hook(mod, args, kwargs, out):
        if kwargs.get("zero_mask") is not None and not seen:
            drop = kwargs["drop"]
            n = len(mod.stacked_encoderBlocks)
            seen.append({"x": args[0].detach().cpu(),
                         "out": out.detach().cpu(),
                         "zero_mask": kwargs["zero_mask"].cpu(),
                         "rate": drop.rate,
                         "seeds": drop.seeds[drop.site - n:].cpu()})
    model.input_encoder.register_forward_hook(hook, with_kwargs=True)
    trainer.train_step(dp.shard_batch(mesh, {k: v.to(dev) for k, v in
                                             jm["train"].items()}), True)
    return seen[0]


def merged_frames_vs_single(jm, calls, dev):
    """The single process's merged input encoder (kernel) on the ctx
    ranks' calls put together (QA groups, then each stream's frames in rank
    order), under their seeds: whether each rank's QA and frame rows equal
    its rows at the same global groups bit for bit."""
    from tvqaplus_tpu_torch.models.layers import Dropout
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    num_a = jm["train"]["qas_bert"].shape[1]
    li = (calls[0]["x"].shape[1] - num_a) // 2

    def cat(key):
        dim = 0 if key == "zero_mask" else 1
        t = [c[key] for c in calls]
        return torch.cat([t[0].narrow(dim, 0, num_a)]
                         + [u.narrow(dim, num_a, li) for u in t]
                         + [u.narrow(dim, num_a + li, li) for u in t], dim)
    model = STAGE(ModelConfig.from_config(jm["cfg"]))
    model.load_state_dict(jm["sd"])
    model.to(dev).train()
    drop = Dropout(calls[0]["rate"], torch.Generator(device=dev),
                   calls[0]["seeds"].to(dev))
    with torch.no_grad():
        ref = model.input_encoder(cat("x").to(dev), drop=drop,
                                  zero_mask=cat("zero_mask").to(dev)).cpu()
    whole, same = li * len(calls), {}
    for c, call in enumerate(calls):
        got, sub, vid = call["out"], num_a + c * li, num_a + whole + c * li
        same[c] = {"qa": torch.equal(got[:, :num_a], ref[:, :num_a]),
                   "sub": torch.equal(got[:, num_a:num_a + li],
                                      ref[:, sub:sub + li]),
                   "vid": torch.equal(got[:, num_a + li:],
                                      ref[:, vid:vid + li])}
    return same


def mesh_rank(rank, port, path):
    """One of phase mesh_axes's two processes: the card, a gloo group of
    two over ``tcp://127.0.0.1:port``, ``mesh_steps`` on each mesh of the
    job, the merged path's encoder call at (1, 2) with dropout and the
    train steps at hsz ``MESH_WIDE_HSZ`` on (1, 1, 2); what it saw goes to
    ``<path>.rank<rank>``."""
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from tvqaplus_tpu_torch.parallel import mesh as dp
    job = torch.load(path, weights_only=False)
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)   # both ranks: LOCAL_RANK 1 names no card
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        staged, counter = gloo_on_cuda(dev)
        out = {"staged": staged}
        for shape in MESH_SHAPES:
            mesh = dp.make_mesh(shape)
            res = mesh_steps(job, mesh, dev, counter)
            res["coords"], res["sharded"] = mesh.coords, sorted(
                dp.sharded_parameters(
                    _stage(job["cfg"]), mesh.model_size))
            out[str(shape)] = res
        out["merged_call"] = merged_encoder_call(
            job["merged"], dp.make_mesh((1, 2)), dev)
        out["wide"] = mesh_steps(job["wide"], dp.make_mesh((1, 1, 2)), dev,
                                 counter, serve=False)
        torch.save(out, f"{path}.rank{rank}")
    finally:
        dist.destroy_process_group()


def _stage(cfg):
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    return STAGE(ModelConfig.from_config(cfg))


def graph_nodes(graphs):
    """The nodes of the one CUDA graph a ``StepGraphs`` holds
    (``cudaGraphGetNodes`` through the CUDA runtime torch loaded, else the
    toolkit's)."""
    import ctypes
    (graph,) = graphs.graphs.values()
    with open("/proc/self/maps") as f:
        lib = next((line.split()[-1] for line in f if "libcudart" in line),
                   os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                "lib64", "libcudart.so"))
    cudart = ctypes.CDLL(lib)
    cudart.cudaGraphGetNodes.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    cudart.cudaGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = cudart.cudaGraphGetNodes(
        ctypes.c_void_p(graph.graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cudaGraphGetNodes: error {err}")
    return n.value


def mesh_off(dev, workdir, dp_launches, dp_per_step):
    """Part (a) of phase mesh_axes: mesh (1, 1, 1) in a world-1 NCCL
    group against no group, deterministic algorithms on."""
    from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.parallel import mesh as dp
    from tvqaplus_tpu_torch.train.loop import Trainer
    dp.init_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                        local_device_ids=[dev.index or 0], device=dev.type)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    restore = keep_graph_nodes()     # the trainers' graphs' nodes counted
    try:
        mesh = dp.make_mesh((1, 1, 1))
        if mesh.ctx_group is not None or mesh.model_group is not None:
            raise AssertionError("groups for axes of size 1")
        cfg = train_config(workdir, bsz=B, test_bsz=B).finalize(dev)
        trainers = {"mesh_111": Trainer(cfg, dev, mesh=mesh),
                    "no_group": Trainer(cfg, dev)}
        four = train_stack(cfg, dev, DISPATCH_K)
        losses, launches = {name: [] for name in trainers}, None
        for name, trainer in trainers.items():
            reset_counters()
            for _ in range(DP_DISPATCHES):
                m = trainer.dispatch_train(four)
                losses[name].append((float(m["loss"]),
                                     float(m["grad_norm"])))
            torch.cuda.synchronize()
            if name == "mesh_111":
                launches = read_counters(SEPARATE_TRAIN)
        tm, tn = trainers["mesh_111"], trainers["no_group"]
        same = all(torch.equal(a, b) for a, b in
                   zip(state_tensors(tm), state_tensors(tn)))
        if losses["mesh_111"] != losses["no_group"] or not same:
            raise AssertionError(f"(1, 1, 1) vs no group: {losses}, state "
                                 f"equal {same}")
        # launches a step: the nodes of each trainer's captured K-step
        # graph (exact, where a profiler trace can drop events), beside a
        # fresh trainer on data_parallel's mesh, (-1, 1) in the same group
        trainers["mesh_data"] = Trainer(cfg, dev, mesh=dp.make_mesh())
        trainers["mesh_data"].dispatch_train(four)   # warm-up and capture
        per_step = {name: graph_nodes(t.graphs) / DISPATCH_K
                    for name, t in trainers.items()}
        if launches != dp_launches \
                or per_step["mesh_111"] != per_step["mesh_data"]:
            raise AssertionError(
                f"(1, 1, 1) launches {launches}, graph nodes a step "
                f"{per_step}; data_parallel's {dp_launches}")
        ds = SyntheticTVQADataset(cfg, 2 * B, mode="valid")
        words = list(range(3, 1000, 4))
        preds = {name: InferenceRunner(cfg, trainers[name].model, dev,
                                       mesh if name == "mesh_111" else None
                                       ).run(ds, object_word_ids=words)
                 for name in ("mesh_111", "no_group")}
        if preds["mesh_111"] != preds["no_group"]:
            raise AssertionError("(1, 1, 1) vs no group: the serve pass's "
                                 "predictions differ")
    finally:
        restore()
        torch.use_deterministic_algorithms(False)
        dp.close()
    return {"bitwise_equal": True, "launches": launches,
            "graph_nodes_per_step": per_step,
            "data_parallel_profiled_launches_per_step": dp_per_step,
            "losses": losses["mesh_111"][:3],
            "serve_qas": len(preds["mesh_111"]["ts_answer"])}


def phase_mesh_axes(dev, workdir, smi, dp_launches, dp_per_step):
    """The ctx and model axes on the card: (a) ``mesh_off``; (b) two
    processes at (1, 2) and (1, 1, 2) against the single process."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    off = mesh_off(dev, workdir, dp_launches, dp_per_step)
    cfg = train_config(workdir, bsz=B, test_bsz=B, dropout=0.0,
                       compute_dtype="float32").finalize(dev)
    sd = _stage(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).state_dict()
    job = {"cfg": cfg, "sd": sd, "train": train_batch(cfg, "cpu", B),
           "serve": headline_batch(cfg, "cpu"), "device": DEVICE,
           "frames": LI}
    # the merged path's input encoder with dropout (the main path's bf16),
    # and the model axis at hsz MESH_WIDE_HSZ (float32, dropout 0)
    mcfg = train_config(workdir, bsz=B, test_bsz=B,
                        merge_input_streams=True).finalize(dev)
    job["merged"] = {"cfg": mcfg, "sd": sd, "train": job["train"]}
    wcfg = train_config(workdir, bsz=B, test_bsz=B, dropout=0.0,
                        compute_dtype="float32",
                        hsz=MESH_WIDE_HSZ).finalize(dev)
    job["wide"] = {"cfg": wcfg, "sd": _stage(wcfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).state_dict(),
        "train": train_batch(wcfg, "cpu", B)}
    path = os.path.join(workdir, "mesh_axes_job")
    torch.save(job, path)
    t_spawn = time.perf_counter()
    mp.start_processes(mesh_rank, args=(free_port(), path), nprocs=2,
                       join=True, start_method="spawn")
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False)
             for r in range(2)]
    spawn_s = time.perf_counter() - t_spawn
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        single = mesh_steps(job, None, dev)
        single_wide = mesh_steps(job["wide"], None, dev, serve=False)
        halves_wide = mesh_steps(job["wide"], None, dev, serve=False,
                                 halves=True)
        merged = merged_frames_vs_single(
            job["merged"], [r["merged_call"] for r in ranks], dev)
    finally:
        torch.use_deterministic_algorithms(False)
    # where the model axis's first-step gap arises (ROADMAP C8): a record,
    # held to no bar
    bisect = bisect_report(ranks, single_wide["bisect"],
                           halves_wide["bisect"])
    report, failed = {}, []
    # the model axis at hsz MESH_WIDE_HSZ: losses at MESH_STEP_RTOL's bars;
    # grad norms at its after-update bar from the first step on, since the
    # first step's norm parts by 3.1e-5 on an H100 80GB HBM3 (700 W),
    # where the CPU's parts by 6.6e-8: at this width the input embedding
    # and the linear wrappers split by columns too, and cuBLAS rounds a
    # column block's float32 product otherwise than the whole one's; each
    # split weight's first gradient whole against one process's by
    # relative L2 (a gather whose backward summed over the model ranks
    # would give 1.0: twice the gradient)
    if not all(all(v.values()) for v in merged.values()):
        failed.append(f"(1, 2) merged, dropout {P_DROP}: rows not the "
                      f"single process's at the global groups: {merged}")
    wide = []
    for r, rank in enumerate(ranks):
        got = rank["wide"]
        for i, ((lg, ng), (lw, nw)) in enumerate(zip(got["train"],
                                                     single_wide["train"])):
            bar_l, bar_n = MESH_STEP_RTOL[min(i, 1)][0], MESH_STEP_RTOL[1][1]
            if abs(lg - lw) > bar_l * abs(lw) \
                    or abs(ng - nw) > bar_n * abs(nw):
                failed.append(f"(1, 1, 2) hsz {MESH_WIDE_HSZ} rank {r} step "
                              f"{i}: loss {lg} vs {lw}, grad_norm {ng} vs "
                              f"{nw}")
        if got["train_weight_gathered_bytes"] \
                != got["train_weight_bytes_predicted"] \
                or not got["train_weight_gathered_bytes"]:
            failed.append(f"(1, 1, 2) hsz {MESH_WIDE_HSZ} rank {r}: weight "
                          f"gathers received "
                          f"{got['train_weight_gathered_bytes']} bytes, "
                          f"predicted {got['train_weight_bytes_predicted']}")
        rel = {name: float((g - single_wide["grads"][name]).norm()
                           / single_wide["grads"][name].norm())
               for name, g in got["grads"].items()}
        worst = max(rel.values())
        if not worst <= MESH_WIDE_GRAD_REL_L2:
            failed.append(f"(1, 1, 2) hsz {MESH_WIDE_HSZ} rank {r}: split "
                          f"weights' gradients vs one process {rel}")
        wide.append({"rank": r, "losses": got["train"],
                     "split_grads_rel_l2_max": worst,
                     "split_grads": len(rel),
                     "train_step_ms": got["train_ms"],
                     "train_gathered_bytes": got["train_gathered_bytes"],
                     "train_weight_gathered_bytes":
                         got["train_weight_gathered_bytes"],
                     "train_weight_bytes_predicted":
                         got["train_weight_bytes_predicted"]})
    for shape in MESH_SHAPES:
        rows = []
        for r, rank in enumerate(ranks):
            got = rank[str(shape)]
            for i, ((lg, ng), (lw, nw)) in enumerate(zip(got["train"],
                                                         single["train"])):
                bar_l, bar_n = MESH_STEP_RTOL[min(i, 1)]
                if abs(lg - lw) > bar_l * abs(lw) \
                        or abs(ng - nw) > bar_n * abs(nw):
                    failed.append(f"{shape} rank {r} step {i}: loss {lg} vs "
                                  f"{lw}, grad_norm {ng} vs {nw}")
            g, w = got["serve"], single["serve"]
            for k in ("pred_ids", "span_st", "span_ed", "grd_nacc",
                      "grd_nvalid"):
                if not torch.equal(g[k], w[k]):
                    failed.append(f"{shape} rank {r}: serve {k} differs")
            diff = (g["grd_scores"] - w["grd_scores"]).abs()
            diff[g["grd_scores"] == w["grd_scores"]] = 0.0   # +inf tails
            grd = float(diff.max())
            if not grd <= MESH_GROUNDING_TOL:
                failed.append(f"{shape} rank {r}: grounding {grd}")
            bf16, bad = forward_errors(got["bf16"], single["bf16"],
                                       FWD_TOL["bfloat16"])
            failed += [f"{shape} rank {r} bf16: {bad}"] if bad else []
            if got["train"] != ranks[0][str(shape)]["train"]:
                failed.append(f"{shape} rank {r}: the replicas' losses part")
            rows.append({
                "rank": r, "coords": got["coords"],
                "sharded": got["sharded"],
                "losses": got["train"], "grounding_max_abs_err": grd,
                "bf16_vs_single": bf16,
                "train_step_ms": got["train_ms"],
                "serve_step_ms": got["serve_ms"],
                "train_gathered_bytes": got["train_gathered_bytes"],
                "serve_gathered_bytes": got["serve_gathered_bytes"]})
        report[str(shape)] = rows
    if failed:
        raise AssertionError(f"mesh_axes: {failed}")
    emit({"phase": "mesh_axes", "ok": True, "nvidia_smi": smi,
          "mesh_off": off, "gloo_staged": ranks[0]["staged"],
          "batch": B, "frames": LI, "compute_dtype": "float32",
          "single": {"losses": single["train"],
                     "train_step_ms": single["train_ms"],
                     "serve_step_ms": single["serve_ms"]},
          "meshes": report, "merged_dropout_rows_equal": merged,
          "model_axis_wide": {"hsz": MESH_WIDE_HSZ, "mesh": [1, 1, 2],
                              "single_losses": single_wide["train"],
                              "single_train_step_ms": single_wide["train_ms"],
                              "ranks": wide},
          "c8_bisect": {k: bisect[k] for k in (
              "first_param_over", "first_act_over", "max_param", "max_act")},
          "two_process_s": spawn_s, "wall_s": time.perf_counter() - t0})
    return bisect


# ------------------------------------------- noun masks, void vectors
NOUN_VOID = {"noun_masks": {}, "void": {"non_visual": 2,
                                        "add_non_visual": True}}
ATTENTION_FWD, ATTENTION_BWD = "qa_ctx_fwd", "qa_ctx_bwd"


def add_noun_masks(batch):
    """``batch`` with noun masks drawn from a seed: each valid word kept
    with probability 0.6, every fifth example's third answer all zero."""
    gen = torch.Generator().manual_seed(SEED + 7)
    keep = (torch.rand(batch["qas_mask"].shape, generator=gen) < 0.6)
    masks = batch["qas_mask"] * keep.to(batch["qas_mask"].device)
    masks[::5, 2] = 0.0
    return dict(batch, qa_noun_masks=masks)


def noun_void_batch(case, batch):
    return add_noun_masks(batch) if case == "noun_masks" else batch


def attention_launches(names):
    """Launches of the attention forward and backward kernels by name in a
    trace's ``{kernel name: launches}``."""
    return {k: sum(c for nm, c in names.items() if k in nm)
            for k in (ATTENTION_FWD, ATTENTION_BWD)}


def phase_noun_void(dev, workdir, cfg):
    """The separate path with noun masks in every batch, and with two void
    vectors: its serve step against the CPU forward (both compute types, as
    ``headline_vs_cpu``), a replayed serve dispatch against the eager step,
    a replayed train dispatch against the eager step (deterministic
    algorithms), and which attention sites launch the fused kernel: those
    ``STAGE.fused_attention`` names, nowhere else; each step's device busy
    time and launches (the replays, ``torch.profiler``)."""
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    for case, extra in NOUN_VOID.items():
        t0 = time.perf_counter()
        model_cfg = dataclasses.replace(ModelConfig.from_config(cfg),
                                        **extra)
        model = STAGE(model_cfg).reset_parameters(
            torch.Generator().manual_seed(SEED))
        sd = model.state_dict()
        edit = lambda b, case=case: noun_void_batch(case, b)  # noqa: E731
        vs_cpu = headline_vs_cpu(cpu_forwards(cfg, sd, model_cfg, edit), sd,
                                 dev, False)
        batch = edit(headline_batch(cfg, dev))
        fused = [site for site in ("sub", "vid")
                 if model.fused_attention(site, batch)]
        want_fused = [] if case == "noun_masks" else ["sub"]
        if fused != want_fused:
            raise AssertionError(f"{case}: fused sites {fused}")
        must = tuple(k for k in SEPARATE_FWD
                     if k != "qa_ctx_attention" or fused)
        bf16 = STAGE(dataclasses.replace(model_cfg,
                                         compute_dtype="bfloat16"))
        bf16.load_state_dict(sd)
        runner = InferenceRunner(cfg, bf16, dev)
        reset_counters()
        runner.step(batch, True, LI)
        torch.cuda.synchronize()
        serve_launches = read_counters(must)
        runner.dispatch_infer(batch, True, LI)        # warm-up and capture
        equal = replay_equals_eager(runner, batch)
        busy_ms, per_step, _, names = profile_steps(
            lambda: runner.dispatch_infer(batch, True, LI), PROFILE_STEPS)
        names = {k: c / PROFILE_STEPS for k, c in names.items()}
        tc_fwd = check_tc_forwards(f"{case} serving", names, False)
        serve_att = attention_launches(names)
        if serve_launches["qa_ctx_attention"] != len(fused) or \
                serve_att[ATTENTION_FWD] != len(fused):
            raise AssertionError(f"{case}: attention launches "
                                 f"{serve_launches}, trace {serve_att}, "
                                 f"fused sites {fused}")
        train = phase_noun_void_train(dev, workdir, case, extra, fused)
        emit({"phase": "noun_void", "case": case, "ok": True, "batch": B,
              "frames": LI, "fused_attention_sites": fused,
              "serve_launches": serve_launches,
              "serve_trace_attention": serve_att, "tc_forwards": tc_fwd,
              "serve_busy_ms": busy_ms, "serve_launches_per_step": per_step,
              "replay_equal_to_eager": equal, "headline_vs_cpu": vs_cpu,
              **train, "wall_s": time.perf_counter() - t0})


def phase_noun_void_train(dev, workdir, case, extra, fused):
    """One bf16 train step (batch 16, dropout 0.1) of ``case`` eager and
    as a replayed dispatch from the same seed, deterministic algorithms
    on: the same loss, grad_norm and parameters (``DISPATCH_TOL``), a
    finite loss, a nonzero void-vector gradient, the fused attention's
    forward and backward at the fused sites only."""
    from tvqaplus_tpu_torch.train.loop import Trainer
    cfg = train_config(workdir, bsz=B, **extra).finalize(dev)
    batch = noun_void_batch(case, train_batch(cfg, dev, B))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        eager, graph = Trainer(cfg, dev), Trainer(cfg, dev)
        must = tuple(k for k in SEPARATE_TRAIN
                     if not k.startswith("qa_ctx_attention") or fused)
        reset_counters()
        ms = eager._packed("train", [eager.train_step(batch)])
        torch.cuda.synchronize()
        launches = read_counters(must)
        checks = {}
        for tag in ("capture", "replay"):
            if tag == "replay":
                ms = eager._packed("train", [eager.train_step(batch)])
            mg = graph.dispatch_train(batch)
            torch.cuda.synchronize()
            got = {k: float(mg[k]) for k in ("loss", "grad_norm")}
            want = {k: float(ms[graph._names["train"].index(k)])
                    for k in ("loss", "grad_norm")}
            param_err = max(float((p.detach() - q.detach()).abs().max())
                            for p, q in zip(eager.params, graph.params))
            checks[tag] = {"graph": got, "eager": want,
                           "param_max_abs_err": param_err}
            if got != want or param_err > DISPATCH_TOL or \
                    not all(map(math.isfinite, got.values())):
                raise AssertionError(f"{case} train {tag}: {checks[tag]}")
        void_grad = None
        if case == "void":
            void_grad = float(eager.model.non_visual_vectors.grad.abs().max())
            if not void_grad > 0:
                raise AssertionError("the void vectors got no gradient")
    finally:
        torch.use_deterministic_algorithms(False)
    busy_ms, per_step, _, names = profile_steps(
        lambda: graph.dispatch_train(batch), PROFILE_STEPS)
    att = attention_launches({k: c / PROFILE_STEPS for k, c in names.items()})
    if launches["qa_ctx_attention"] != len(fused) or \
            launches["qa_ctx_attention_bwd"] != len(fused) or \
            att[ATTENTION_FWD] != len(fused):
        raise AssertionError(f"{case} train: attention launches {launches}, "
                             f"trace {att}, fused sites {fused}")
    return {"train_launches": launches, "train_trace_attention": att,
            "train_busy_ms": busy_ms, "train_launches_per_step": per_step,
            "train_replay_vs_eager": checks,
            "void_vectors_grad_max_abs": void_grad}


# ------------------------------------------------------------- pipeline
PIPELINE_QAS = 560         # 35 batches of 16, 7 QAs a clip
# (name, video_dedup, host cast, St buckets): the four layouts with the St
# buckets, and the fixed St cap that the bucketed run must reproduce
PIPELINE_RUNS = [("fixed_st", False, False, False),
                 ("dedup_off_cast_off", False, False, True),
                 ("dedup_on_cast_off", True, False, True),
                 ("dedup_off_cast_on", False, True, True),
                 ("dedup_on_cast_on", True, True, True)]
# grounding records for one synthetic word id in four: the share of object
# words among TVQA+ val's QA words (22.4 of ~93 words a QA, 24%, by
# eval_data/eval_object_vocab.json).  The inference CLI takes every
# synthetic id as an object word, and its record assembly on the host then
# takes most of a run (~2,200 records a QA, PERF.md).
PIPELINE_OBJECT_WORDS = list(range(3, 1000, 4))


class HostCast:
    """Turns the pipeline's bf16 host cast on or off for the serving runs
    of one layout (it is on whenever the compute type is bfloat16)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        from tvqaplus_tpu_torch.data.pipeline import DataPipeline
        self.cls, self.real = DataPipeline, DataPipeline.__init__
        on = self.on

        def init(pipe, *a, **k):
            self.real(pipe, *a, **k)
            pipe.cast_bf16 = on
        DataPipeline.__init__ = init
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.real


def timed_run(runner, dataset, words):
    """``InferenceRunner.run`` over ``dataset``: (predictions, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = runner.run(dataset, "valid", object_word_ids=words)
    torch.cuda.synchronize()
    return pred, time.perf_counter() - t0


def phase_pipeline(dev, workdir):
    """The serving CLI's path (``InferenceRunner.run``: the producer
    thread's collate, cast, pin and upload, replayed dispatches of
    ``eval_steps_per_dispatch`` batches, answers and spans) over a split of
    560 QAs that share clips 7 to 1, at the headline widths in bf16, for
    each layout of ``PIPELINE_RUNS``: wall s and QA/s of a first run (graph
    captures included) and a second (replays only), the device's busy time
    over a profiled third and its idle share against the second, graphs
    captured and the peak of allocated device memory, each stage's host ms
    per batch and the bytes a batch uploads
    (``scripts/profile_torch_pipeline.py``); then a run with grounding
    records (``PIPELINE_OBJECT_WORDS``).  Fails unless dedup gives the
    predictions of the same layout without it, and the St buckets those of
    the fixed St cap (answers and spans identical, grounding at 1e-4)."""
    from scripts.profile_torch_pipeline import (
        host_stages,
        layout_pipeline,
        serving_config,
        shared_split,
    )
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    cfg = serving_config(seed=SEED)
    model = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    dataset = shared_split(cfg, PIPELINE_QAS)
    make_s = time.perf_counter() - t0
    preds = {}
    for name, dedup, cast, st in PIPELINE_RUNS:
        run_cfg = dataclasses.replace(
            cfg, video_dedup=dedup,
            sub_token_buckets=cfg.sub_token_buckets if st else [])
        runner = InferenceRunner(run_cfg, model, dev)
        with HostCast(cast):
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counters()
            _, wall_first = timed_run(runner, dataset, ())
            launches = read_counters(SEPARATE_FWD)
            peak = torch.cuda.max_memory_allocated(dev)
            graphs = len(runner.graphs.graphs)
            _, wall = timed_run(runner, dataset, ())
            busy_ms, n_kernels, top, _ = profile_steps(
                lambda: runner.run(dataset, "valid"), 1)
            preds[name], wall_grounding = timed_run(
                runner, dataset, PIPELINE_OBJECT_WORDS)
            stages = host_stages(layout_pipeline(run_cfg, "cuda", dedup,
                                                 cast),
                                 dataset, 20, "cuda")
        if len(preds[name]["ts_answer"]) != PIPELINE_QAS:
            raise AssertionError(f"{name}: {len(preds[name]['ts_answer'])} "
                                 f"answers")
        emit({"phase": "pipeline", "ok": True, "run": name,
              "video_dedup": dedup, "host_cast": cast,
              "st_buckets": run_cfg.sub_token_buckets, "qas": PIPELINE_QAS,
              "batch": B,
              "eval_steps_per_dispatch": cfg.eval_steps_per_dispatch,
              "wall_s_first": wall_first, "wall_s": wall,
              "qa_pairs_per_s_first": PIPELINE_QAS / wall_first,
              "qa_pairs_per_s": PIPELINE_QAS / wall,
              "device_busy_ms": busy_ms,
              "device_idle_share": None if busy_ms is None
              else 1 - busy_ms / 1e3 / wall,
              "kernels_per_run": n_kernels, "top_kernels": top[:6],
              "graphs": graphs, "peak_allocated_bytes": peak,
              "launches": launches,
              "wall_s_with_grounding": wall_grounding,
              "qa_pairs_per_s_with_grounding": PIPELINE_QAS / wall_grounding,
              "graphs_with_grounding": len(runner.graphs.graphs),
              **stages})
    checks = {}
    for got, want in (("dedup_off_cast_off", "fixed_st"),
                      ("dedup_on_cast_off", "dedup_off_cast_off"),
                      ("dedup_on_cast_on", "dedup_off_cast_on")):
        checks[f"{got} vs {want}"] = same_predictions(
            preds[got], preds[want], f"pipeline {got} vs {want}")
    # the host cast rounds vid before l2_normalize and the bridges' inputs
    # before their LayerNorm: reported, not held
    on, off = preds["dedup_on_cast_on"], preds["dedup_on_cast_off"]
    cast_diff = {
        "answers_equal": sum(on["ts_answer"][q][1] == off["ts_answer"][q][1]
                             for q in on["ts_answer"]),
        "answers_and_spans_equal": sum(on["ts_answer"][q] ==
                                       off["ts_answer"][q]
                                       for q in on["ts_answer"]),
        "grounding_max_abs_diff": grounding_diff(on, off)[0]}
    emit({"phase": "pipeline_checks", "ok": True, "make_dataset_s": make_s,
          "equal_within_1e-4": {k: {"grounding_max_abs_diff": w,
                                    "records": n}
                                for k, (w, n) in checks.items()},
          "host_cast_vs_float32_uploads": cast_diff})


def main():
    # a fault in native code (a driver, the profiler, a collective) prints
    # every thread's Python stack before the process dies
    faulthandler.enable(all_threads=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from tvqaplus_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    rows = phase_kernels(dev)
    width_rows = phase_width_kernels(dev)
    train_rows = phase_train_kernels(dev)
    width_train_rows = phase_width_train_kernels(dev)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        phase_evaluator(workdir)
        cfg, sd, launches, pred, cpu = phase_main(dev, workdir)
        merged = phase_merged_main(dev, workdir, cfg, sd, pred, cpu)
        phase_serving(dev, cfg, sd)
        train_launches = phase_train_main(dev, workdir)
        merged_train = phase_train_main(dev, workdir, merged=True,
                                        steps_per_dispatch=2)
        bridge = phase_bridge_module(dev, cfg, sd)
        phase_train_vs_cpu(dev, workdir)
        phase_dispatch(dev, workdir)
        phase_training(dev, workdir)
        phase_jax_checkpoint(dev, workdir)
        phase_heads(dev, workdir)
        phase_bookkeeping(dev, workdir)
        dp_launches, dp_per_step = phase_data_parallel(dev, workdir, smi)
        phase_mesh_axes(dev, workdir, smi, dp_launches, dp_per_step)
        # after the phases whose profiler traces it could thin (placed
        # after `serving`, its four profiled sessions left the bridge
        # module's bf16 trace without its forward kernel), before noun_void
        # and pipeline
        wide_launches = phase_wide_serving(dev, workdir, cfg, sd)
        wide_train_launches = phase_wide_training(workdir)
        phase_noun_void(dev, workdir, cfg)
        phase_pipeline(dev, workdir)
    # each row's launches: the count of the main path that runs its kernel
    # (separate, merged, or the bridge module), read right after that path
    launches = {**launches, "encoder_block": merged["encoder_block"],
                "mlp_bridge": bridge["mlp_bridge"]}
    train_launches = {
        **train_launches, "mlp_bridge": bridge["mlp_bridge"],
        "mlp_bridge_bwd": bridge["mlp_bridge_bwd"],
        "encoder_block": merged_train["encoder_block"],
        "encoder_block_bwd": merged_train["encoder_block_bwd"]}
    for row in rows:
        row["launches"] = launches[row.pop("_key")]
    for row in train_rows:
        row["launches"] = train_launches[row.pop("_key")]
    for row in width_rows:       # the runs of phase wide_serving
        # (a dropout row: the CLI runs of phase wide_training)
        row["launches"] = (wide_train_launches if row.pop("_train", False)
                           else wide_launches)[row.pop("_key")]
    for row in width_train_rows:     # the CLI runs of phase wide_training
        row["launches"] = wide_train_launches[row.pop("_key")]
    emit({"kernels": rows + width_rows + train_rows + width_train_rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--wide-training"]:     # phase_wide_training's
            faulthandler.enable(all_threads=True)
            sys.path.insert(0, HERE)
            code = wide_training_process(sys.argv[2])
        else:
            code = main()
    except Exception:  # noqa: BLE001 - report and fail the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
