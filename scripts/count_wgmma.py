"""Count the tensor-core instructions (HGMMA: wgmma) in each kernel of the
port's libraries, to show which kernels multiply on the tensor cores.

    python3 scripts/count_wgmma.py [SOURCE.cu ...]

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``): it builds the sources
first (default: every source of ``ops/_build.py``) and prints, for each
kernel of each library, its HGMMA count, its instruction count and its
symbol.
"""
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from compare_kernel_sass import functions  # noqa: E402
from tvqaplus_tpu_torch.ops import _build  # noqa: E402


def main():
    sources = tuple(sys.argv[1:]) or _build.SOURCES
    _build.build_all(sources)
    for src in sources:
        for name, code in sorted(functions(_build.lib_path(src)).items()):
            n = sum(1 for ins in code if re.search(r"\bHGMMA\.", ins))
            print(f"{src}: {n:4d} HGMMA of {len(code):6d}  {name}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
