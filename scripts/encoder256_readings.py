"""What the bf16 encoder backward at D = 256 reads against its plain
version, sound and wrong, at the rows ``tests/test_torch_cuda.py``
holds it to (``ENC256_ROWS``, both modes, dropout 0 and 0.1, the test's
inputs): the readings behind the tolerance each row is held to.

    python3 scripts/encoder256_readings.py

Run from the tree's root; needs one NVIDIA GPU.  One JSON line a case,
each reading a relative L2 error for each gradient (x and the encoder's
parameters):

- ``kernel``: the kernel against the plain version, both in bf16, as the
  test compares them (a sound run);
- ``one value off`` / ``one row off``: the kernel under the cotangent with
  one value, or one row (a position of sequence 0; in reduce mode
  sequence 0's output row), set to zero, against the plain version under
  the whole cotangent: what a kernel that loses that much of the gradient
  reads;
- ``plain bf16``: the plain version in bf16 against itself with x in
  float32, the reference's own rounding;
- ``kernel to float32``: the kernel against the plain version with x in
  float32.
"""
import importlib.util
import json
import os
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    # by path: another installed package may be named "tests"
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", os.path.join("tests", "test_torch_cuda.py"))
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)
    from tvqaplus_tpu_torch.ops import checks, encoder
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    names = ("x",) + encoder.PARAM_KEYS
    for rows in tc.ENC256_ROWS:
        for mode in ("reduce", "zero mask", "no mask"):
            for dropout in (0.0, tc.P_DROP):
                gen = torch.Generator().manual_seed(21)
                run, fn_k, fn_p, _ = tc.enc256_call(dev, rows, mode, dropout,
                                                    gen)
                one_value = run.cot.clone()
                one_value.view(-1)[0] = 0
                one_row = run.cot.clone()
                one_row[(0, 0) if mode == "reduce" else (0, 0, 0)] = 0
                got = {
                    "kernel": run(fn_k),
                    "one value off": run(fn_k, one_value),
                    "one row off": run(fn_k, one_row),
                }
                want = run(fn_p)
                f32 = run(fn_p, dtype=torch.float32)
                readings = {key: {n: checks.rel_l2(g, w) for n, g, w in
                                  zip(names, grads, want)}
                            for key, grads in got.items()}
                readings["plain bf16"] = {
                    n: checks.rel_l2(w, f) for n, w, f in
                    zip(names, want, f32)}
                readings["kernel to float32"] = {
                    n: checks.rel_l2(g, f) for n, g, f in
                    zip(names, got["kernel"], f32)}
                print(json.dumps({"rows": rows, "mode": mode,
                                  "dropout": dropout,
                                  "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
