"""Compare the machine code (SASS) of the port's kernels in two checkouts.

    python scripts/sass_compare.py OLD_CHECKOUT NEW_CHECKOUT

Builds each checkout's kernels with its own ``kzg_torch/ops/_build.py`` (in
a subprocess, cwd the checkout), disassembles both libraries with
``cuobjdump -sass`` and prints, for every function, whether its SASS is the
same in both, differs, or exists in one only. A refactor of the device code
that leaves a kernel's SASS the same leaves its registers, spills and time
the same. Needs nvcc and cuobjdump (the CUDA toolkit), not a card. Exits 1
if a function of OLD_CHECKOUT is missing or differs in NEW_CHECKOUT.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import sys

_BUILD = "from kzg_torch.ops import _build; print(_build.build())"


def _key(name: str) -> str:
    """A function's name without what a refactor or the checkout's path may
    change: a kernel's parameter types (``_build._demangle``'s form), a
    file-local helper's path hash (kept: its file)."""
    m = re.match(r"_ZN3kzg(\d+)", name)
    if m:
        ident = name[m.end():m.end() + int(m.group(1))]
        arg = re.match(r"IL([bi])(\d+)E", name[m.end() + len(ident):])
        return ident + (f"<{arg.group(2)}>" if arg else "")
    m = re.search(r"_INTERNAL_[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+(\d+)kzg(\d+)", name)
    if m:
        start = m.end()
        return f"{m.group(1)}.cu:{name[start:start + int(m.group(3))]}"
    return name


def _sass(checkout: str) -> dict:
    lib = subprocess.run([sys.executable, "-c", _BUILD], cwd=checkout, check=True,
                         capture_output=True, text=True).stdout.strip().splitlines()[-1]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", os.path.join(checkout, lib)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
        name = _key(name)
        # drop the addresses and encodings: keep the instructions
        instrs = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", body)
        out[name] = hashlib.sha256("\n".join(instrs).encode()).hexdigest()[:16], len(instrs)
    return out


def main(old: str, new: str) -> int:
    a, b = _sass(old), _sass(new)
    bad = 0
    for name in sorted(set(a) | set(b)):
        if name not in b:
            verdict, bad = "only in old", bad + 1
        elif name not in a:
            verdict = "only in new"
        elif a[name] == b[name]:
            verdict = "same"
        else:
            verdict, bad = "differs", bad + 1
        sizes = " -> ".join(str(s[name][1]) for s in (a, b) if name in s)
        print(f"sass {verdict:12s} {name} ({sizes} instructions)")
    print(f"sass: {len(a)} old functions, {len(b)} new, {bad} missing or changed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
