"""The kernels' outputs at the headline shapes, for a bit-for-bit
comparison of two trees (a change and its parent): run ``save`` (or
``save_backward``) from each tree's root, then ``compare``.  Needs one
NVIDIA GPU for ``save`` and ``save_backward``.

    python3 scripts/forward_bits.py save OUT.pt [WIDTH]
    python3 scripts/forward_bits.py save_backward OUT.pt [WIDTH]
    python3 scripts/forward_bits.py compare A.pt B.pt

``save`` runs every forward kernel of ``chip_smoke.py``'s ``kernel_cases``
at width WIDTH (default 128) in float32 and bfloat16, dropout 0 and 0.1,
stores the outputs and prints each bf16 kernel's time (CUDA events, median
of 30), dropout 0 and 0.1, as one JSON line.  ``save_backward`` does the same for every
backward kernel of ``train_kernel_cases`` at width WIDTH (default 128: the
attention, tri bridge, encoder and MLP bridge backwards; another width, the
first three): the gradients of
its case's differentiable inputs under seeded cotangents, in float32 and
bfloat16, dropout 0 and 0.1, and each bf16 backward's time.  ``compare``
prints, for each case, whether the two files hold the same bits, and exits
1 if any differ.  Run the trees in turns in one call (parent, change,
change, parent) to compare the times.
"""
import json
import os
import sys

import torch


def save(path, d):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tvqaplus_tpu_torch.ops import _build
    _build.build_all(("qa_ctx_attention_fwd.cu", "tri_bridge_fwd.cu",
                      "encoder_fwd.cu", "mlp_bridge_fwd.cu"))
    dev = torch.device("cuda")
    outs, times, drop_times = {}, {}, {}
    # (a tree from before the widths takes no width: D = 128)
    for case in (cs.kernel_cases(dev, d) if d != 128
                 else cs.kernel_cases(dev)):
        for dname in ("float32", "bfloat16"):
            for rate in (0.0, cs.P_DROP):
                a, kw = case.args(getattr(torch, dname))
                kw = {**kw, "dropout_rate": rate, "seed": cs.DROP_SEED}
                got = case.kernel(*a, **kw)
                got = got if isinstance(got, tuple) else (got,)
                outs[f"{case.name} {dname} dropout {rate}"] = [
                    g.cpu() for g in got]
        a, kw = case.args(torch.bfloat16)
        times[case.name] = cs.time_ms(lambda: case.kernel(*a, **kw))
        kwd = {**kw, "dropout_rate": cs.P_DROP, "seed": cs.DROP_SEED}
        drop_times[case.name] = cs.time_ms(lambda: case.kernel(*a, **kwd))
    torch.save(outs, path)
    print(json.dumps({"tree": os.getcwd(), "width": d, "bf16_ms": times,
                      "bf16_dropout_ms": drop_times}), flush=True)
    return 0


def save_backward(path, d):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tvqaplus_tpu_torch.ops import _build
    _build.build_all()
    dev = torch.device("cuda")
    outs, times = {}, {}
    for case in (cs.train_kernel_cases(dev, d) if d != 128
                 else cs.train_kernel_cases(dev)):
        for dname in ("float32", "bfloat16"):
            for rate in (0.0, cs.P_DROP):
                a, base_kw = case.args(getattr(torch, dname))
                kw = {**base_kw, **case.kw, "dropout_rate": rate}
                ins, leaves = cs._leaves(a, case.diff)
                got = cs._outputs(case.kernel(*ins, **kw))
                gen = torch.Generator(device=dev).manual_seed(cs.SEED)
                cots = cs._cotangents(got, case.flip(a), gen, case.valid)
                grads = torch.autograd.grad(got, leaves, cots)
                outs[f"{case.name} backward {dname} dropout {rate}"] = [
                    g.cpu() for g in grads]
        a, base_kw = case.args(torch.bfloat16)
        kw = {**base_kw, **case.kw}
        ins, leaves = cs._leaves(a, case.diff)
        got = cs._outputs(case.kernel(*ins, **kw))
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        cots = cs._cotangents(got, case.flip(a), gen, case.valid)
        times[case.name] = cs.time_ms(lambda: torch.autograd.grad(
            got, leaves, cots, retain_graph=True))
    torch.save(outs, path)
    print(json.dumps({"tree": os.getcwd(), "width": d,
                      "bf16_backward_ms": times}),
          flush=True)
    return 0


def same_bits(x, y):
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    view = torch.int16 if x.element_size() == 2 else torch.int32
    return torch.equal(x.view(view), y.view(view))


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    differ = 0
    for key in a:
        same = key in b and all(same_bits(x, y) for x, y in zip(a[key],
                                                                b[key]))
        differ += not same
        print(f"{'same bits' if same else 'DIFFERENT'}: {key}")
    return 1 if differ or a.keys() != b.keys() else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["save"]:
        sys.exit(save(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3
                      else 128))
    if sys.argv[1:2] == ["save_backward"]:
        sys.exit(save_backward(sys.argv[2], int(sys.argv[3])
                               if len(sys.argv) > 3 else 128))
    if sys.argv[1:2] == ["compare"]:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
