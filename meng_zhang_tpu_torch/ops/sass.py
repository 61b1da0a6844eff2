"""Resource and SASS counts of the built kernels, per kernel instance.

    python -m meng_zhang_tpu_torch.ops.sass [--match TEXT] [lib.so ...]

Without libraries it builds `csrc/*.cu` as `ops/kernels.py` does (at first
use, so on a machine with nvcc) and reads every library of that build. For
each kernel whose demangled name contains TEXT it prints one line:

    registers, stack and local-memory bytes (`cuobjdump -res-usage`), the
    instruction count, how many of them are FMAs (FFMA / DFMA), shuffles
    (SHFL) and shared-memory atomics (ATOMS), and the length in instructions
    of every loop, innermost first by address (`cuobjdump -sass`: a loop is
    a branch to an earlier address, its length the instructions from the
    target to the branch).

The counts are static: what the compiler emitted, not what a run executes
(that is the loops' lengths times their trip counts on the run's data). A
branch back from out-of-line code counts as a loop too.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys

_INSTR = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRANCH = re.compile(r"\bBRA\b.*?\b0x([0-9a-f]+)\s*$")


def _run(*cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout


def _demangle(names):
    if not names or shutil.which("c++filt") is None:
        return dict(zip(names, names))
    out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def resources(lib):
    """{mangled name: {"REG": n, "STACK": n, "LOCAL": n, "SHARED": n}}."""
    res, name = {}, None
    for line in _run("cuobjdump", "-res-usage", lib).splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif name and line.startswith("REG:"):
            res[name] = {k: int(v) for k, v in
                         re.findall(r"([A-Z]+)(?:\[\d+\])?:(\d+)", line)}
            name = None
    return res


def sass(lib):
    """{mangled name: [(address, instruction text), ...]}."""
    fns, cur = {}, None
    for line in _run("cuobjdump", "-sass", lib).splitlines():
        if "Function :" in line:
            cur = fns.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return fns


def loops(instrs):
    """Lengths in instructions of the loops (branches to an earlier
    address), ordered by the branch's address."""
    addrs = [a for a, _ in instrs]
    out = []
    for i, (addr, text) in enumerate(instrs):
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            target = int(m.group(1), 16)
            out.append(i - next(j for j, a in enumerate(addrs)
                                if a >= target) + 1)
    return out


def report(lib, match=""):
    res, fns = resources(lib), sass(lib)
    names = _demangle(sorted(fns))
    lines = []
    for mangled, instrs in fns.items():
        name = names[mangled]
        if match not in name:
            continue
        r = res.get(mangled, {})
        short = name.replace("(anonymous namespace)::", "").removeprefix(
            "void ").split("(")[0]

        def count(op):
            return sum(bool(re.search(op, t)) for _, t in instrs)

        lines.append(
            f"{short}: REG {r.get('REG')} STACK "
            f"{r.get('STACK')} LOCAL {r.get('LOCAL')} SHARED "
            f"{r.get('SHARED')}; {len(instrs)} instructions, "
            f"{count('[FD]FMA')} FMA, {count('SHFL')} SHFL, "
            f"{count('ATOMS')} ATOMS; loops {loops(instrs)}")
    return sorted(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match", default="", help="substring of the kernel's "
                    "demangled name, e.g. g_cos_kernel<float, 19>")
    ap.add_argument("libs", nargs="*")
    args = ap.parse_args(argv)
    libs = args.libs
    if not libs:
        from . import kernels
        libs = sorted(kernels.build()[0].values())
    for lib in libs:
        print(f"== {lib}")
        for line in report(lib, args.match):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
