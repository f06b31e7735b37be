#!/usr/bin/env python3
"""K9, G2's point formulas (kzg_torch/csrc/g2_point.cu), against variants of
its source on one card.

Each variant is g2_point.cu with the headers it includes, copied into
build/g2_point_probe/<variant>/ and compiled alone with the library's nvcc
flags (one process a variant, all at once): "kernel" is the committed
source; "late_add" computes jac_add's equal-x tests (g1.cuh) after the
formula, as the add first did, so that more values stay live across
the multiplies; "early_madd" moves jac_madd_core's tests up to where H and
dS are formed, as jac_add has them (VARIANTS); with --parent DIR, "parent"
is DIR's csrc (an older checkout, unpacked with git archive). Per variant:
ptxas's registers, spills and shared memory; its double, add and madd at
2^16 lanes (the setup load's subgroup check and the 2^16 setup's chunks)
against the plain versions on the card, bit for bit (a mismatch fails the
run); then ms a call of each by CUDA events over 10 launches after 2
warm-up launches, in turns: the variants in order, then in reverse.

    python3 scripts/g2_point_probe.py [--parent DIR]
    python3 scripts/g2_point_probe.py --patch-tree DIR VARIANT

The second form applies VARIANT to DIR/kzg_torch/csrc/g1.cuh and exits, to
build a whole checkout with it (for chip_smoke.py in turns, or
scripts/sass_compare.py: the tests' order also changes the G1 kernels).
Needs a CUDA card and nvcc otherwise. Prints one JSON line last.
"""

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from kzg_torch.ops import _build, curve as cv, genmul  # noqa: E402
from kzg_torch.ops.field import FR  # noqa: E402

HEADERS = ("field.cuh", "g1.cuh", "g2.cuh")
ADD_LATE = (
    '''  const El H = Ops::sub(Ops::mul(q.x, Z1Z1), U1);
  const bool same_x = Ops::is_zero(H);
  const El S1 = Ops::mul(p.y, Ops::mul(q.z, Z2Z2));
  const El dS = Ops::sub(Ops::mul(q.y, Ops::mul(p.z, Z1Z1)), S1);
  const bool same_y = Ops::is_zero(dS);
  const El H2 = Ops::dbl(H);
  const El I = Ops::sqr(H2);
  const El J = Ops::mul(H, I);
  const El r = Ops::dbl(dS);
''',
    '''  const El U2 = Ops::mul(q.x, Z1Z1);
  const El S1 = Ops::mul(p.y, Ops::mul(q.z, Z2Z2));
  const El S2 = Ops::mul(q.y, Ops::mul(p.z, Z1Z1));
  const El H = Ops::sub(U2, U1);
  const El H2 = Ops::dbl(H);
  const El I = Ops::sqr(H2);
  const El J = Ops::mul(H, I);
  const El dS = Ops::sub(S2, S1);
  const El r = Ops::dbl(dS);
''')
ADD_LATE_TESTS = (
    '''  out.z = Ops::mul(Ops::mul(p.z, q.z), H2);
''',
    '''  out.z = Ops::mul(Ops::mul(p.z, q.z), H2);

  const bool same_x = Ops::is_zero(H);
  const bool same_y = Ops::is_zero(dS);
''')
EARLY_MADD = (
    '''  const El U2 = Ops::mul(x2, Z1Z1);
  const El S2 = Ops::mul(y2, Ops::mul(p.z, Z1Z1));
  const El H = Ops::sub(U2, p.x);
  const El H2 = Ops::dbl(H);
  const El I = Ops::sqr(H2);
  const El J = Ops::mul(H, I);
  const El dS = Ops::sub(S2, p.y);
  const El r = Ops::dbl(dS);
''',
    '''  const El H = Ops::sub(Ops::mul(x2, Z1Z1), p.x);
  same_x = Ops::is_zero(H);
  const El dS = Ops::sub(Ops::mul(y2, Ops::mul(p.z, Z1Z1)), p.y);
  same_y = Ops::is_zero(dS);
  const El H2 = Ops::dbl(H);
  const El I = Ops::sqr(H2);
  const El J = Ops::mul(H, I);
  const El r = Ops::dbl(dS);
''')
EARLY_MADD_TESTS = (
    '''  out.z = Ops::mul(H2, p.z);
  same_x = Ops::is_zero(H);
  same_y = Ops::is_zero(dS);
''',
    '''  out.z = Ops::mul(H2, p.z);
''')
# variant -> its (committed g1.cuh text, replacement) pairs
VARIANTS = {"kernel": [], "late_add": [ADD_LATE, ADD_LATE_TESTS],
            "early_madd": [EARLY_MADD, EARLY_MADD_TESTS]}
ENTRIES = {"double": "kzg_g2_double", "add": "kzg_g2_add", "madd": "kzg_g2_madd"}
LANES = 1 << 16
SEED = 20240521
OUT = ROOT / "build" / "g2_point_probe"


def patched(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"g1.cuh no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(parent) -> dict:
    """Compile every variant at once; returns name -> (library, ptxas usage
    by kernel)."""
    dirs = {}
    for name, subs in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in HEADERS + ("g2_point.cu",):
            shutil.copy(_build.CSRC / f, d / f)
        (d / "g1.cuh").write_text(patched((_build.CSRC / "g1.cuh").read_text(), subs))
        dirs[name] = d
    if parent:
        d = OUT / "parent"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(pathlib.Path(parent) / "kzg_torch" / "csrc", d)
        dirs["parent"] = d
    procs = {}
    for name, d in dirs.items():
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               str(d / "g2_point.cu"), "-o", str(d / "k9.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (dirs[name] / "ptxas.txt").write_text(log)
        if proc.returncode:
            print(log, flush=True)
            raise RuntimeError(f"nvcc failed on variant {name}")
        lib = ctypes.CDLL(str(dirs[name] / "k9.so"))
        for entry in ENTRIES.values():
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        usage = _build.ptxas_usage(dirs[name] / "ptxas.txt")
        out[name] = (lib, {op: usage[f"g2_{op}_kernel"] for op in ENTRIES})
    return out


def launcher(lib, op, operands):
    n = operands[0].shape[-1]
    out = tuple(torch.empty_like(operands[0]) for _ in range(3))
    args = tuple(c.data_ptr() for c in operands + out) + (n,)
    fn = getattr(lib, ENTRIES[op])

    def run():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{ENTRIES[op]} failed to launch: cudaError {code}")
        return out

    return run


def time_ms(run, reps: int = 10) -> float:
    for _ in range(2):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def operands(device) -> dict:
    """Seeded G2 points at LANES lanes: P, Q Jacobian (made by the window
    fold, so Z != 1), Q affine; lane 0 of Q equals P (the doubling lanes)."""
    gen = torch.Generator().manual_seed(SEED)
    ks = [FR.tensor([int(v) for v in torch.randint(1, 1 << 62, (LANES,), generator=gen)],
                    device, mont=False) for _ in range(2)]
    p = genmul.mul_gen(ks[0], group=cv.G2)
    q = genmul.mul_gen(ks[1], group=cv.G2)
    q = tuple(torch.cat([a[..., :1], b[..., 1:]], -1) for a, b in zip(p, q))
    (qx, qy), _ = cv.g2_to_affine(q)
    return {"double": (p,), "add": (p, q), "madd": (p, (qx, qy))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--patch-tree", nargs=2, metavar=("DIR", "VARIANT"))
    args = ap.parse_args()
    if args.patch_tree:
        tree, variant = args.patch_tree
        g1 = pathlib.Path(tree) / "kzg_torch" / "csrc" / "g1.cuh"
        g1.write_text(patched(g1.read_text(), VARIANTS[variant]))
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    variants = build_variants(args.parent)
    report = {}
    for name, (_, usage) in variants.items():
        report[name] = {op: dict(u, ms_per_call=[]) for op, u in usage.items()}
        print(f"{name}: " + ", ".join(
            f"{op} {u['registers']} registers, {u['spill_stores']} / {u['spill_loads']} B "
            f"spill stores / loads, {u['smem']} B smem" for op, u in usage.items()), flush=True)
    ops = operands(device)
    plain = {"double": cv.g2_double_plain, "add": cv.g2_add_plain, "madd": cv.g2_madd_plain}
    runs = {}
    for op, args_ in ops.items():
        want = plain[op](*args_)
        flat = tuple(c for a in args_ for c in a)
        for name, (lib, _) in variants.items():
            runs[name, op] = launcher(lib, op, flat)
            got = runs[name, op]()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} {op} differs from its plain version")
    print(f"{LANES} lanes: every variant bit-identical to the plain versions", flush=True)
    names = list(variants)
    for name in names + names[::-1]:
        for op in ENTRIES:
            report[name][op]["ms_per_call"].append(time_ms(runs[name, op]))
    for name, r in report.items():
        print(f"{name}: " + ", ".join(
            f"{op} {' / '.join(f'{t:.4f}' for t in u['ms_per_call'])} ms"
            for op, u in r.items()) + f" a call at 2^16 lanes ({card})", flush=True)
    print(json.dumps({"card": card, "g2_point_variants": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
