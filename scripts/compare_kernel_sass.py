"""Compare the machine code (SASS) of kernels between two builds of the
port's kernel libraries, e.g. a commit and its parent, to show whether a
refactor of shared device code changed what a kernel runs.

    python3 scripts/compare_kernel_sass.py OLD.so NEW.so NAME [NAME ...]

Needs the CUDA toolkit's ``cuobjdump`` (``$CUDA_HOME/bin`` or on PATH).
``NAME`` is a substring of the demangled-looking kernel symbol, e.g.
``encoder_bwd_tc_kernelILi5E``; ``OLD=NEW`` names a kernel whose symbol
changed (a template parameter added: ``encoder_fwd_tc_kernelILi5E=
encoder_fwd_tc_kernelILi128ELi5E``); ``--all`` compares every kernel whose
symbol both libraries hold.  For each it prints whether the instruction
sequences are identical once addresses, encodings and the per-file
anonymous-namespace tag are dropped, and the instruction counts.  Exits 1
when a NAME is missing from either library.
"""
import os
import re
import shutil
import subprocess
import sys


def cuobjdump():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "cuobjdump")
    return path if os.path.exists(path) else shutil.which("cuobjdump")


def functions(lib):
    """{symbol without its file tag: [instruction text, ...]}."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON", m[1])
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append(re.sub(r"\s+", " ", m[1]))
    return funcs


def main():
    if len(sys.argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = functions(sys.argv[1]), functions(sys.argv[2])
    wants = sys.argv[3:]
    if wants == ["--all"]:
        wants = sorted(set(old) & set(new))
    code = 0
    for want in wants:
        want_old, _, want_new = want.partition("=")
        a = [k for k in old if want_old in k]
        b = [k for k in new if (want_new or want_old) in k]
        if len(a) != 1 or len(b) != 1:
            print(f"{want}: {len(a)} match(es) in the old build, {len(b)} "
                  f"in the new")
            code = 1
            continue
        ia, ib = old[a[0]], new[b[0]]
        print(f"{want}: {'identical' if ia == ib else 'DIFFERENT'} "
              f"({len(ia)} / {len(ib)} instructions)")
    return code


if __name__ == "__main__":
    sys.exit(main())
