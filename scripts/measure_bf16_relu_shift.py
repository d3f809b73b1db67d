"""How far a moved bf16 rounding shifts the ReLU inputs and the gradients of
the encoder block, the tri bridge and the MLP bridge in their bfloat16
compute mode: the source of the bf16 bars of
tvqaplus_tpu_torch/ops/checks.py (``TRI_BF16_EPS``, ``BRIDGE_BF16_EPS``)
and ops/encoder.py (``GRAD_TOL[bfloat16]``).

    python3 scripts/measure_bf16_relu_shift.py

Runs on the CPU.  The plain versions round the products' operands to bf16
where the kernels do, so a kernel and its plain version differ by the order
of float32 sums and by the roundings that such a difference moves.  The
script makes that difference without a kernel: it runs each plain version
twice on the same data, once with the D channels permuted (the same
function, other float32 sum orders), and prints the largest shift of a ReLU
input, the share of rows / sequences that a margin flags and (encoder) the
largest shift of a final LN output and the relative L2 error of every
gradient, the cotangent zero on reduce-mode channels whose masked max is
within ``checks.ENC_TIE_BF16_EPS`` of a tie.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tvqaplus_tpu_torch.ops import (  # noqa: E402
    checks,
    encoder,
    mlp_bridge,
    tri_bridge,
)

D = 128


def enc_params(k, gen):
    p = {}
    for i in (0, 1):
        p.update({f"ln{i}_s": 1 + 0.1 * torch.randn(D, generator=gen),
                  f"ln{i}_b": 0.1 * torch.randn(D, generator=gen),
                  f"dw{i}": 0.3 * torch.randn(k, D, generator=gen),
                  f"dwb{i}": 0.1 * torch.randn(D, generator=gen),
                  f"pw{i}": torch.randn(D, D, generator=gen) * D ** -0.5,
                  f"pwb{i}": 0.1 * torch.randn(D, generator=gen)})
    p["lnf_s"] = 1 + 0.1 * torch.randn(D, generator=gen)
    p["lnf_b"] = 0.1 * torch.randn(D, generator=gen)
    return p


def permuted(p, perm):
    return {k: (t[perm][:, perm] if k.startswith("pw") and t.dim() == 2
                else t[..., perm]) for k, t in p.items()}


def encoder_shift(gen):
    for l, k, g in ((40, 5, 100), (50, 7, 100)):
        x = torch.randn(4, g, l, D, generator=gen).to(torch.bfloat16)
        pe = 0.1 * torch.randn(l, D, generator=gen)
        p = enc_params(k, gen)
        perm = torch.randperm(D, generator=gen)
        inv = torch.argsort(perm)
        oa, pa = encoder.block_layers(x, pe, p, k)
        ob, pb = encoder.block_layers(x[..., perm].contiguous(), pe[:, perm],
                                      permuted(p, perm), k)
        shift = max(float((a - b[..., inv]).abs().max())
                    for a, b in zip(pa, pb))
        print(f"encoder L {l} k {k}: largest shift of a final LN output "
              f"{float((oa - ob[..., inv]).abs().max())}")
        flagged = float(sum((a.abs() < 1e-3).flatten(-2).any(-1)
                            for a in pa).gt(0).float().mean())
        print(f"encoder L {l} k {k}: ReLU inputs {2 * pa[0].numel()}, "
              f"largest shift {shift}, sequences with one within 1e-3 "
              f"of 0: {flagged}")


def encoder_grads(gen):
    for l, k, g, mode in ((40, 5, 250, "reduce"), (50, 7, 105, "block")):
        x = torch.randn(2, g, l, D, generator=gen).to(torch.bfloat16)
        pe = 0.1 * torch.randn(l, D, generator=gen)
        p = enc_params(k, gen)
        perm = torch.randperm(D, generator=gen)
        inv = torch.argsort(perm)
        mask = (torch.rand(2, g, l, generator=gen) > 0.3).float()
        cot = torch.randn((2, g, D) if mode == "reduce" else (2, g, l, D),
                          generator=gen)
        if mode == "reduce":
            tie = checks.encoder_tie_elements(x, pe, p, k, mask)
            cot = cot * ~tie
            print(f"encoder reduce: channels near a tie "
                  f"{float(tie.float().mean())}")

        def run(x, pe, p, cot):
            xs = x.clone().requires_grad_(True)
            ps = {k_: t.clone().requires_grad_(True) for k_, t in p.items()}
            out = (encoder.encoder_reduce_plain(xs, pe, ps, k, mask)
                   if mode == "reduce"
                   else encoder.encoder_block_plain(xs, pe, ps, k))
            (out.float() * cot).sum().backward()
            return {"x": xs.grad, **{k_: ps[k_].grad for k_ in ps}}
        ga = run(x, pe, p, cot)
        gb = run(x[..., perm].contiguous(), pe[:, perm], permuted(p, perm),
                 cot[..., perm])
        gb = {"x": gb["x"][..., inv],
              **permuted({k_: v for k_, v in gb.items() if k_ != "x"}, inv)}
        errs = {k_: float((ga[k_].float() - gb[k_].float()).norm()
                          / gb[k_].float().norm()) for k_ in ga}
        worst = max(errs, key=errs.get)
        print(f"encoder {mode} L {l} k {k}: largest relative L2 error of a "
              f"gradient {errs[worst]} ({worst})")


def tri_bridge_shift(gen):
    rows = 20000
    s = torch.randn(rows, D, generator=gen).to(torch.bfloat16)
    v = torch.randn(rows, D, generator=gen).to(torch.bfloat16)
    gin = 1 + 0.1 * torch.randn(3 * D, generator=gen)
    bin_ = 0.1 * torch.randn(3 * D, generator=gen)
    w = torch.randn(3 * D, D, generator=gen) * (3 * D) ** -0.5
    b = 0.1 * torch.randn(D, generator=gen)
    perm = torch.randperm(D, generator=gen)
    inv = torch.argsort(perm)
    p3 = torch.cat([perm, perm + D, perm + 2 * D])
    ya = tri_bridge.tri_bridge_pre(s, v, gin, bin_, w, b)
    yb = tri_bridge.tri_bridge_pre(
        s[:, perm].contiguous(), v[:, perm].contiguous(), gin[p3], bin_[p3],
        w[p3][:, perm], b[perm])[:, inv]
    print(f"tri bridge: ReLU inputs {ya.numel()}, largest shift "
          f"{float((ya - yb).abs().max())}")
    for eps in (2e-3, 4e-3, 5e-3):
        print(f"  rows with one within {eps} of 0: "
              f"{float((ya.abs() < eps).any(-1).float().mean())}")


def mlp_bridge_shift(gen):
    """The MLP bridge at STAGE's widths (768 -> 300, 300 -> 300), bf16
    compute on float32 x (the module's kernel route), with the Din channels
    permuted (the LN_in sums and the product's 768 terms in other orders)."""
    rows = 20000
    for d_in, d_out in ((768, 300), (300, 300)):
        x = torch.randn(rows, d_in, generator=gen)
        gin = 1 + 0.1 * torch.randn(d_in, generator=gen)
        bin_ = 0.1 * torch.randn(d_in, generator=gen)
        w = torch.randn(d_in, d_out, generator=gen) * d_in ** -0.5
        b = 0.1 * torch.randn(d_out, generator=gen)
        perm = torch.randperm(d_in, generator=gen)
        kw = dict(compute_dtype=torch.bfloat16)
        ya = mlp_bridge.mlp_bridge_pre(x, gin, bin_, w, b, **kw)
        yb = mlp_bridge.mlp_bridge_pre(x[:, perm].contiguous(), gin[perm],
                                       bin_[perm], w[perm], b, **kw)
        print(f"mlp bridge {d_in} -> {d_out}: ReLU inputs {ya.numel()}, "
              f"largest shift {float((ya - yb).abs().max())}")
        for eps in (2e-3, 4e-3, 8e-3):
            print(f"  rows with one within {eps} of 0: "
                  f"{float((ya.abs() < eps).any(-1).float().mean())}")


def main():
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    gen = torch.Generator().manual_seed(1)
    encoder_shift(gen)
    encoder_grads(gen)
    tri_bridge_shift(gen)
    mlp_bridge_shift(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
