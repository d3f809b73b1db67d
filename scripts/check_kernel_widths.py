"""The kernels at their other hidden widths, alone: ``chip_smoke.py``'s
phases ``device``, ``build`` (every source, with each kernel's registers
and spills), ``kernel_width`` (the attention, tri bridge and encoder
forwards at D = 64 and 256 against their plain versions in float32 and
bfloat16, dropout 0 and 0.1, and their times) and ``kernel_train_width``
(their backwards at D = 64 and 256, dropout 0.1, against autograd through
the plain versions, and their times); with ``--all`` also ``kernels``
(every kernel at D = 128).  ``--backward`` runs the backwards only,
``--forward`` the forwards only.  Needs one NVIDIA GPU.

    python3 scripts/check_kernel_widths.py [--all] [--forward | --backward]

One JSON line a phase and a row, as ``chip_smoke.py`` prints them; exits
non-zero at the first kernel that does not hold.  A quicker card run than
``chip_smoke.py`` after a change to the kernels of those widths.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv):
    dev = torch.device("cuda")
    cs.phase_device()
    cs.phase_build()
    if "--all" in argv:
        cs.phase_kernels(dev)
    if "--backward" not in argv:
        cs.phase_width_kernels(dev)
    if "--forward" not in argv:
        cs.phase_width_train_kernels(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
