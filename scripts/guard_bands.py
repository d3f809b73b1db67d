"""Out-of-bounds writes of the kernels, looked for with guard bands: every
CUDA tensor that a kernel wrapper allocates (outputs, gradients, scratch
slots) is placed between two 1 MiB bands filled with the byte 0xA5, and
after each forward + backward the bands must still hold that byte.  The
same call is made once without bands first: the banded call must give the
same bits (a wrapper that relied on what ``torch.empty`` returns would
differ), and the inputs must be unchanged.  Needs one NVIDIA GPU.

    python3 scripts/guard_bands.py [--widths 64,128,256]
                                   [--dtypes float32,bfloat16] [--only NAME]
                                   [--edges]

It runs ``chip_smoke.py``'s ``train_kernel_cases`` at each width (the
headline shapes, dropout 0.1), prints one JSON line a case and dtype, and
exits 1 if any band, output or input is wrong.  ``--edges`` runs instead
the bf16 backwards of their own designs at the edges of their layouts
(``EDGES``: at D = 256 the encoder at L 56 / k 9, L 5 / k 1 and 40 / k 5
over more tiles than SMs, reduce and full output, the attention at M 1,
65 and 200 with Lr 1, 33 and 64, the tri bridge at 1, 65, 100 and 129
rows and at 20,655 (more tiles than SMs, its rings run on into the next
tile; the forward's last pair of tiles ragged or half empty); at D = 64
the attention at M 1, 65 and 200 with Lr 1, 33 and 64 and the encoder
at L 56 / k 9, L 5 / k 1 (12 sequences a tile) and 40 / k 5 over more
tiles than two a SM, reduce and full output; the attention's forward
also at M 200 on 50 frames, where a warpgroup's run of frames crosses
(b, tile) units, and at M 7 on one frame; the tri bridge at 1, 39, 65,
193 and 40,001 rows, more tiles than the 396 warpgroups), where a tile is
ragged, a ring runs on into the next tile or p0 fills its room; and the
bf16 forwards alone at D = 64 (``encoder_fwd64``, ``tri_fwd64``): the
encoder at L 1, 5, 40, 50 and 56 with every odd k <= 9, reduce and full
output, on 1,002 sequences (a ragged last tile at every L but 1 and 50,
more tiles than the 396 warpgroups at L >= 40), the tri bridge at 1, 39,
65, 193 and 160,001 rows.  A kernel's addressing
depends only on its shapes and pointers, so a call captured in a CUDA graph
writes where the eager call writes.
"""
import argparse
import json
import os
import sys

import torch

BAND = 1 << 20
CANARY = 0xA5


class Bands:
    """While active, ``torch.empty`` and ``torch.empty_like`` place each
    CUDA tensor between two canary bands."""

    def __init__(self):
        self.bufs, self.active = [], False
        self._empty, self._like = torch.empty, torch.empty_like

    def _banded(self, shape, dtype, device):
        es = self._empty((), dtype=dtype).element_size()
        n = 1
        for s in shape:
            n *= s
        base = self._empty(2 * BAND // es + n, dtype=dtype, device=device)
        base.view(torch.uint8).fill_(CANARY)
        self.bufs.append((base, n * es))
        return base[BAND // es:BAND // es + n].view(shape)

    def empty(self, *args, **kw):
        t = self._empty(*args, **kw)
        if not self.active or t.device.type != "cuda":
            return t
        return self._banded(tuple(t.shape), t.dtype, t.device)

    def empty_like(self, x, **kw):
        t = self._like(x, **kw)
        if not self.active or t.device.type != "cuda":
            return t
        return self._banded(tuple(t.shape), t.dtype, t.device)

    def __enter__(self):
        self.bufs, self.active = [], True
        torch.empty, torch.empty_like = self.empty, self.empty_like
        return self

    def __exit__(self, *exc):
        self.active = False
        torch.empty, torch.empty_like = self._empty, self._like

    def broken(self):
        """(buffers checked, buffers whose bands changed)."""
        bad = 0
        for base, nbytes in self.bufs:
            b = base.view(torch.uint8)
            if not (bool((b[:BAND] == CANARY).all())
                    and bool((b[BAND + nbytes:] == CANARY).all())):
                bad += 1
        return len(self.bufs), bad


def run(cs, case, dt, gen_seed):
    """Forward + backward of the kernel wrapper: the inputs it was given
    (as they are after the call), their copies from before it, and the
    outputs and gradients."""
    a, base_kw = case.args(dt)
    kwa = {**base_kw, **case.kw}
    ins, leaves = cs._leaves(a, case.diff)
    before = [t.clone() for t in flat(ins)]
    outs = cs._outputs(case.kernel(*ins, **kwa))
    gen = torch.Generator(device=outs[0].device).manual_seed(gen_seed)
    cots = cs._cotangents(outs, case.flip(a), gen, case.valid)
    torch.autograd.backward(outs, cots)
    torch.cuda.synchronize()
    return (list(flat(ins)), before,
            [o.detach() for o in outs] + [t.grad for t in leaves])


# (family, shape): encoder (B, G, L, k, mode), attention at 256 and 64
# (A, Lqa, Lr, raw[, Li], 3 frames unless given), tri bridge at 256 and
# 64 (rows,); the forwards alone at 64 (encoder_fwd64, tri_fwd64)
EDGES = [("encoder", (1, 7, 56, 9, "reduce")), ("encoder", (1, 7, 5, 1,
                                                           "block")),
         ("encoder", (2, 100, 40, 5, "reduce")),
         ("encoder", (1, 7, 50, 7, "block")),
         ("attention", (1, 1, 1, "none")), ("attention", (5, 13, 33,
                                                          "target")),
         ("attention", (5, 40, 64, "target")),
         ("tri", (1,)), ("tri", (65,)), ("tri", (100,)), ("tri", (129,)),
         ("tri", (20655,)),
         ("encoder64", (1, 7, 56, 9, "reduce")),
         ("encoder64", (2, 6, 5, 1, "block")),
         ("encoder64", (2, 200, 40, 5, "reduce")),
         ("encoder64", (2, 200, 40, 5, "block")),
         ("encoder64", (1, 7, 50, 7, "block")),
         ("attention64", (1, 1, 1, "none")),
         ("attention64", (5, 13, 33, "full")),
         ("attention64", (5, 40, 64, "target")),
         ("attention64", (5, 40, 25, "full", 50)),
         ("attention64", (1, 7, 32, "target", 1)),
         ("tri64", (1,)), ("tri64", (39,)), ("tri64", (65,)),
         ("tri64", (193,)), ("tri64", (40001,))] + [
    ("encoder_fwd64", (2, 501, length, k, mode))
    for length in (1, 5, 40, 50, 56) for k in (1, 3, 5, 7, 9)
    for mode in ("reduce", "block")] + [
    ("tri_fwd64", (rows,)) for rows in (1, 39, 65, 193, 160001)]


def edge_call(dev, family, shape):
    """Forward + backward of one EDGES case in bf16 (D = 64 for a family
    that ends in 64, else 256), dropout 0.1, on inputs made from a seed: as
    ``run``; the forward alone for "encoder_fwd64" and "tri_fwd64"."""
    from tvqaplus_tpu_torch.models.attention import l2_normalize
    from tvqaplus_tpu_torch.ops import encoder, qa_ctx_attention, tri_bridge
    gen = torch.Generator().manual_seed(25)
    d, bf = (64 if family.endswith("64") else 256), torch.bfloat16
    family = family[:-2] if family.endswith("64") else family
    fwd_only = family.endswith("_fwd")
    family = {"encoder_fwd": "encoder", "tri_fwd": "tri"}.get(family, family)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen) * scale
    if family == "encoder":
        b, g, l, k, mode = shape
        x = rnd(b, g, l, d).to(dev, bf).requires_grad_(True)
        pe = rnd(l, d, scale=0.1).to(dev)
        p = {}
        for i in (0, 1):
            p.update({f"ln{i}_s": 1 + rnd(d, scale=0.1),
                      f"ln{i}_b": rnd(d, scale=0.1),
                      f"dw{i}": rnd(k, d, scale=0.3),
                      f"dwb{i}": rnd(d, scale=0.1),
                      f"pw{i}": rnd(d, d, scale=d ** -0.5),
                      f"pwb{i}": rnd(d, scale=0.1)})
        p.update(lnf_s=1 + rnd(d, scale=0.1), lnf_b=rnd(d, scale=0.1))
        p = {key: t.to(dev).requires_grad_(True) for key, t in p.items()}
        if mode == "reduce":
            mask = (torch.rand(b, g, l, generator=gen) > 0.3).float().to(dev)
            out = encoder.encoder_reduce(x, pe, p, k, mask, 0.1, 12345)
        else:
            out = encoder.encoder_block(x, pe, p, k, None, 0.1, 12345)
        ins, leaves = [x, pe] + list(p.values()), [x] + list(p.values())
    elif family == "tri":
        (rows,) = shape
        ins = [rnd(rows, d).to(dev, bf), rnd(rows, d).to(dev, bf),
               (1 + rnd(3 * d, scale=0.1)).to(dev),
               rnd(3 * d, scale=0.1).to(dev),
               rnd(3 * d, d, scale=(3 * d) ** -0.5).to(dev),
               rnd(d, scale=0.1).to(dev), (1 + rnd(d, scale=0.1)).to(dev),
               rnd(d, scale=0.1).to(dev)]
        ins = [t.detach().requires_grad_(True) for t in ins]
        out = tri_bridge.tri_bridge(*ins, 0.1, 12345)
        leaves = ins
    else:
        a, lqa, lr, raw, li = shape + (3,) * (len(shape) == 4)
        ce = rnd(2, a, lqa, d).to(dev, bf)
        qe = rnd(2, li, lr, d).to(dev, bf)
        ins = [l2_normalize(ce), ce, l2_normalize(qe), qe,
               (torch.rand(2, a, lqa, generator=gen) > 0.25).float().to(dev),
               (torch.rand(2, li, lr, generator=gen) > 0.25).float().to(dev),
               (1 + rnd(3 * d, scale=0.1)).to(dev),
               rnd(3 * d, scale=0.1).to(dev),
               rnd(3 * d, d, scale=(3 * d) ** -0.5).to(dev),
               rnd(d, scale=0.1).to(dev)]
        ins = [t.detach().requires_grad_(i not in (4, 5))
               for i, t in enumerate(ins)]
        out = qa_ctx_attention.qa_ctx_attention(
            *ins, raw_mode=raw, targets=torch.tensor([0, a - 1], device=dev),
            dropout_rate=0.1, seed=12345)
        leaves = [t for t in ins if t.requires_grad]
    outs = list(out) if isinstance(out, tuple) else [out]
    before = [t.detach().clone() for t in ins]
    if fwd_only:
        torch.cuda.synchronize()
        return ([t.detach() for t in ins], before,
                [o.detach() for o in outs])
    grads = torch.autograd.grad(outs, leaves,
                                [rnd(*o.shape).to(dev, o.dtype)
                                 for o in outs])
    torch.cuda.synchronize()
    return ([t.detach() for t in ins], before,
            [o.detach() for o in outs] + list(grads))


def flat(a):
    for t in a:
        if isinstance(t, dict):
            yield from t.values()
        elif isinstance(t, torch.Tensor):
            yield t


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--widths", default="64,128,256")
    p.add_argument("--dtypes", default="float32,bfloat16")
    p.add_argument("--only", default="")
    p.add_argument("--edges", action="store_true")
    opt = p.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tvqaplus_tpu_torch.ops import _build
    _build.build_all()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    failed = 0
    for family, shape in EDGES if opt.edges else ():
        _, _, want = edge_call(dev, family, shape)
        with Bands() as bands:
            ins, before, got = edge_call(dev, family, shape)
        n_bufs, bad = bands.broken()
        same_in = all(torch.equal(x, y) for x, y in zip(ins, before))
        same_out = all(torch.equal(x, y) for x, y in zip(got, want))
        ok = bad == 0 and same_in and same_out
        failed += not ok
        print(json.dumps({"edge": family, "shape": shape,
                          "width": 64 if family.endswith("64") else 256,
                          "banded_buffers": n_bufs, "bands_broken": bad,
                          "same_bits_as_unbanded": same_out,
                          "inputs_unchanged": same_in, "ok": ok}), flush=True)
    for d in (() if opt.edges else (int(w) for w in opt.widths.split(","))):
        for case in cs.train_kernel_cases(dev, d):
            if opt.only and opt.only not in case.name:
                continue
            for dname in opt.dtypes.split(","):
                dt = getattr(torch, dname)
                _, _, want = run(cs, case, dt, cs.SEED + 3)
                with Bands() as bands:
                    ins, before, got = run(cs, case, dt, cs.SEED + 3)
                n_bufs, bad = bands.broken()
                same_in = all(torch.equal(x, y) for x, y in zip(ins, before))
                same_out = all(torch.equal(x, y) for x, y in zip(got, want))
                ok = bad == 0 and same_in and same_out
                failed += not ok
                print(json.dumps({"case": case.name, "width": d,
                                  "dtype": dname, "banded_buffers": n_bufs,
                                  "bands_broken": bad,
                                  "same_bits_as_unbanded": same_out,
                                  "inputs_unchanged": same_in, "ok": ok}),
                      flush=True)
    print(json.dumps({"guard_bands_ok": failed == 0, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
