#!/usr/bin/env python3
"""K5, the ceremony's window fold (kzg_torch/csrc/gen_fold.cu
gen_fold_kernel), against variants of its design on one card: what each
choice of the kernel's header is worth.

Each variant is made from the committed gen_fold.cu by text substitution
(VARIANTS) and compiled with the library's nvcc flags (one process a
variant, all at once) into build/gen_fold_probe/; "kernel" is the source as
committed. Per variant: ptxas's registers, spills and shared memory, a
check against genmul.gen_fold_plain at n = 1, 127, 128, 129, 25,600 (a
partial wave) and 2^16 on the cases of kzg_torch/utils/fold_cases.py
(bit-identical expected; a mismatch fails the run), then its time at the
ceremony's shape (2^16 lanes, 16 calls: ms a call by CUDA events over 10
launches, after 2 warm-up launches, times 16), in turns: the variants in
order, then in reverse.

    python3 scripts/gen_fold_probe.py

Needs a CUDA card and nvcc. Prints one JSON line last.
"""

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from kzg_torch.ops import _build, genmul  # noqa: E402
from kzg_torch.utils import fold_cases  # noqa: E402

EXACT_MADD = (
    '''  bool need;
  jac_t sum = jac_madd_fast<FoldOps>(acc, qx, qy, need);
  asm volatile("" ::: "memory");
  need = need && !skip;
  if (__any_sync(0xffffffffu, need)) {
    const jac_t d = jac_double<FoldOps>(acc);
    if (need) sum = d;
    asm volatile("" ::: "memory");
  }
''',
    '''  const jac_t sum = jac_madd<FoldOps>(acc, qx, qy);
  asm volatile("" ::: "memory");
''')
INLINE = ("using FoldOps = FieldCalled;", "using FoldOps = FieldInline;")
# variant -> its (committed text, replacement) pairs
VARIANTS = {
    "kernel": [],
    "inline": [INLINE],
    "exact": [EXACT_MADD],
    "inline_exact": [INLINE, EXACT_MADD],
    "128_threads": [("kFoldThreads = 256;", "kFoldThreads = 128;")],
    "2_blocks": [("__launch_bounds__(kFoldThreads)", "__launch_bounds__(kFoldThreads, 2)")],
}
CHECK_SIZES = (1, 127, 128, 129, 25600, 1 << 16)
LANES = 1 << 16
CALLS = 16  # the 2^20 ceremony's chunks of 2^16
SEED = 20240521
OUT = ROOT / "build" / "gen_fold_probe"


def build_variants() -> dict:
    """Compile every variant at once; returns name -> (library, ptxas usage)."""
    OUT.mkdir(parents=True, exist_ok=True)
    committed = (_build.CSRC / "gen_fold.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        src = committed
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"gen_fold.cu no longer holds {old!r}")
            src = src.replace(old, new)
        (OUT / f"{name}.cu").write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
               "-shared", str(OUT / f"{name}.cu"), "-o", str(OUT / f"{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (OUT / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode:
            print(log, flush=True)
            raise RuntimeError(f"nvcc failed on variant {name}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.kzg_gen_fold.argtypes = _build.SIGNATURES["kzg_gen_fold"]
        out[name] = (lib, _build.ptxas_usage(OUT / f"{name}.ptxas.txt")["gen_fold_kernel"])
    return out


def launcher(lib, tables, digits):
    n = digits.shape[1]
    out = tuple(torch.empty(12, n, dtype=torch.int32, device=digits.device) for _ in range(3))
    args = (tables[0].data_ptr(), tables[1].data_ptr(), digits.data_ptr(),
            *(o.data_ptr() for o in out), n)

    def run():
        code = lib.kzg_gen_fold(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"kzg_gen_fold failed to launch: cudaError {code}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    variants = build_variants()
    tables = genmul.gen_tables(device)
    report = {}
    for name, (_, usage) in variants.items():
        report[name] = dict(usage, ms_per_call=[])
        print(f"{name}: {usage['registers']} registers, {usage['spill_stores']} / "
              f"{usage['spill_loads']} B spill stores / loads, {usage['smem']} B smem", flush=True)
    for n in CHECK_SIZES:
        digits = fold_cases.fold_digits(n, SEED + n, device)
        want = genmul.gen_fold_plain(*tables, digits.long())
        for name, (lib, _) in variants.items():
            got = launcher(lib, tables, digits)()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} differs from gen_fold_plain at n = {n}")
        print(f"n = {n}: every variant bit-identical to gen_fold_plain", flush=True)
    digits = fold_cases.fold_digits(LANES, SEED, device)
    runs = {name: launcher(lib, tables, digits) for name, (lib, _) in variants.items()}
    for name in list(runs) + list(runs)[::-1]:
        report[name]["ms_per_call"].append(time_ms(runs[name]))
    for name, r in report.items():
        r["ms_per_ceremony"] = [CALLS * t for t in r["ms_per_call"]]
        print(f"{name}: {' / '.join(f'{t:.4f}' for t in r['ms_per_ceremony'])} ms for "
              f"{CALLS} calls of 2^16 lanes ({card})", flush=True)
    print(json.dumps({"card": card, "gen_fold_variants": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
