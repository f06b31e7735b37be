#!/usr/bin/env python3
"""The scalar-multiplication ladders (kzg_torch/csrc/mul_ladder.cu) against
variants of their design on one card: what each choice of the launch shape
and of Mode B's piece width is worth.

Each variant is made from the committed mul_ladder.cu by text substitution
(VARIANTS) and compiled with the library's nvcc flags (one process a
variant, all at once) into build/mul_ladder_probe/; "kernel" is the source
as committed. Per variant: ptxas's registers, spills and shared memory of
the four kernels; a check against the plain versions (bit-identical
expected; a mismatch fails the run; a refused launch is reported and the
variant left out); then its times, in turns (the
variants in order, then in reverse; ms a call by CUDA events over a few
launches after a warm-up one):

- Mode A, G1: [r] P at 2^20 lanes (the SRS decompression's subgroup check)
  and 2^16 (a 2^16 load's); Mode A, G2: [r] P at 2^16 lanes. Checked on
  129 lanes and on the first and last 256 lanes of the 2^20 call, the
  point of order 3 among them.
- Mode B, both groups, at 1, 64 and 511 lanes (the verify, a batch of 64,
  the largest call below GENMUL_TABLE_THRESHOLD), the variants' piece
  width with its own constant bases (piece_bases). Checked on
  mul_cases.gen_case's 64 lanes: the committed width against
  gen_ladder_plain bit for bit, every width against hostmath by group
  element (gen_ladder_plain has the committed width only).

Then GENMUL_TABLE_THRESHOLD's crossover on the committed kernels: each
group's Mode B at 511 to 2^16 lanes against the generator tables' fold at
as many lanes (CUDA events) and the tables' one-time build (host clock
after a synchronize). Timed scalars are seeded, none of the case scalars.

    python3 scripts/mul_ladder_probe.py

Needs a CUDA card and nvcc. Prints the card's name and power limit first
and one JSON line last.
"""

import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from kzg_torch.ops import _build, genmul  # noqa: E402
from kzg_torch.ops import curve as cv  # noqa: E402
from kzg_torch.utils import hostmath as hm  # noqa: E402
from kzg_torch.utils import mul_cases  # noqa: E402

G1_THREADS = "constexpr int kG1LadderThreads = 256;"
G1_BOUNDS = "__launch_bounds__(kG1LadderThreads) g1_ladder_kernel"
G2_THREADS = "constexpr int kG2LadderThreads = 64;"
PIECE_BITS = "constexpr int kGenPieceBits = 4;"
G1_OPS = "naf_ladder<FieldCalled, kG1LadderThreads>"
# variant -> its (committed text, replacement) pairs
VARIANTS = {
    "kernel": [],
    "g1_64_threads": [(G1_THREADS, G1_THREADS.replace("256", "64"))],
    "g1_128_threads": [(G1_THREADS, G1_THREADS.replace("256", "128"))],
    "g1_128_threads_4_blocks": [
        (G1_THREADS, G1_THREADS.replace("256", "128")),
        (G1_BOUNDS, G1_BOUNDS.replace("(kG1LadderThreads)", "(kG1LadderThreads, 4)"))],
    "g1_inline": [(G1_OPS, G1_OPS.replace("FieldCalled", "FieldInline"))],
    "g2_32_threads": [(G2_THREADS, G2_THREADS.replace("64", "32"))],
    "g2_128_threads": [(G2_THREADS, G2_THREADS.replace("64", "128"))],
    "pieces_8_bits": [(PIECE_BITS, PIECE_BITS.replace("4", "8"))],
    "pieces_16_bits": [(PIECE_BITS, PIECE_BITS.replace("4", "16"))],
}
KERNELS = ("g1_ladder_kernel", "g2_ladder_kernel", "g1_gen_ladder_kernel",
           "g2_gen_ladder_kernel")
ENTRIES = ("kzg_g1_ladder", "kzg_g2_ladder", "kzg_g1_gen_ladder", "kzg_g2_gen_ladder")
MODE_A = (("G1", 1 << 20), ("G1", 1 << 16), ("G2", 1 << 16))
MODE_B = (1, 64, 511)
CROSSOVER_LANES = (511, 4096, 16384, 1 << 16)
SEED = 20240521
OUT = ROOT / "build" / "mul_ladder_probe"


def piece_bits(name: str) -> int:
    subs = dict(VARIANTS[name])
    return int(subs.get(PIECE_BITS, PIECE_BITS).split("=")[1].strip(" ;"))


def build_variants() -> dict:
    """Compile every variant at once; returns name -> (library, ptxas usage)."""
    OUT.mkdir(parents=True, exist_ok=True)
    committed = (_build.CSRC / "mul_ladder.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        src = committed
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"mul_ladder.cu no longer holds {old!r}")
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
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        usage = _build.ptxas_usage(OUT / f"{name}.ptxas.txt")
        out[name] = (lib, {k: usage[k] for k in KERNELS})
    return out


def call(lib, entry, *args):
    code = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"{entry} failed to launch: cudaError {code}")


def launcher(lib, entry, tensors, *args):
    """A call of lib's entry on these arguments; the closure holds the
    tensors whose pointers are among them, so that they outlive it."""
    return lambda: call(lib, entry, *args) or tensors[-3:]


def mode_a(lib, group, x, y, plus, minus, inf):
    """[r] P through a variant's Mode A entry: (x, y) affine words, plus and
    minus r's (9, 1) NAF columns (lane stride 0), inf the flagged lanes."""
    n = x.shape[-1]
    out = tuple(torch.empty_like(x) for _ in range(3))
    entry = "kzg_g1_ladder" if group is cv.G1 else "kzg_g2_ladder"
    return launcher(lib, entry, (x, y, plus, minus, inf) + out, x.data_ptr(), y.data_ptr(),
                    plus.data_ptr(), minus.data_ptr(), 0, inf.data_ptr(),
                    *(o.data_ptr() for o in out), n)


def piece_bases(group, bits, device):
    """A variant's constant bases: the affine words of [2^(bits j)] G,
    j < 256 / bits (curve.split_bases at another width)."""
    pts = cv.gen_pow2(group)[::bits]
    return tuple(group.words([p[c] for p in pts], device) for c in (0, 1))


def mode_b(lib, group, k, bits):
    n = k.shape[1]
    bx, by = piece_bases(group, bits, k.device)
    out = tuple(torch.empty(group.coord + (n,), dtype=torch.int32, device=k.device)
                for _ in range(3))
    entry = "kzg_g1_gen_ladder" if group is cv.G1 else "kzg_g2_gen_ladder"
    return launcher(lib, entry, (bx, by, k) + out, bx.data_ptr(), by.data_ptr(), bx.shape[-1],
                    k.data_ptr(), *(o.data_ptr() for o in out), n)


def time_ms(run, reps: int) -> float:
    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a, b))


def public_points(group, n, device):
    """public_case's points (the point of order 3 or the negated
    off-subgroup point among them) on n lanes, as (x, y), inf."""
    p, _ = mul_cases.public_case(group, n, SEED + n, device)
    return (p[0].contiguous(), p[1].contiguous()), group.is_inf(p).contiguous()


def check_variants(variants, device, failed):
    """Every variant against the plain versions, bit for bit: Mode A on the
    first 129 and last 256 lanes of each group's widest call, Mode B on
    gen_case's 64 lanes (at another piece width than the committed one, by
    group element against hostmath). A variant whose launch is refused goes
    into ``failed`` (name -> the error) and is not timed."""
    groups = {"G1": cv.G1, "G2": cv.G2}

    def run(name, fn):
        if name in failed:
            return None
        try:
            out = fn()
            torch.cuda.synchronize()
            return out
        except RuntimeError as err:
            failed[name] = str(err)
            print(f"{name}: {err}", flush=True)
            return None

    plus, minus = (c.contiguous() for c in cv.naf_masks(hm.R, 1, device))
    for gname, group in groups.items():
        n = max(m for g, m in MODE_A if g == gname)
        (x, y), inf = public_points(group, n, device)
        idx = torch.cat([torch.arange(129, device=device), torch.arange(n - 256, n, device=device)])
        want = cv.naf_ladder_plain((x[..., idx], y[..., idx]), plus.expand(9, idx.numel()),
                                   minus.expand(9, idx.numel()), inf[idx], group)
        for name, (lib, _) in variants.items():
            got = run(name, mode_a(lib, group, x, y, plus, minus, inf))
            if got is not None and not same(tuple(c[..., idx] for c in got), want):
                raise AssertionError(f"{name}: Mode A {gname} differs from naf_ladder_plain")
        print(f"Mode A {gname}: every variant that launched bit-identical to naf_ladder_plain",
              flush=True)
        k = mul_cases.gen_case(64, SEED, device)
        want, host = cv.gen_ladder_plain(k, group), mul_cases.gen_oracle(group, k, range(64))
        for name, (lib, _) in variants.items():
            got = run(name, mode_b(lib, group, k, piece_bits(name)))
            if got is None:
                continue
            if piece_bits(name) == cv.GEN_SPLIT_BITS and not same(got, want):
                raise AssertionError(f"{name}: Mode B {gname} differs from gen_ladder_plain")
            if group.host_affine(*group.to_affine(got)) != host:
                raise AssertionError(f"{name}: Mode B {gname} differs from hostmath")
        print(f"Mode B {gname}: every variant that launched equal to hostmath, those of "
              f"{cv.GEN_SPLIT_BITS}-bit pieces bit-identical to gen_ladder_plain", flush=True)


def seeded_scalars(n, seed, device):
    """n seeded 256-bit scalars, none of mul_cases' case scalars."""
    return mul_cases.gen_case(n + len(mul_cases.SCALARS), seed, device)[:, len(mul_cases.SCALARS):]


def host_ms(fn) -> float:
    """ms of one call of fn by the host clock, after a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def crossover(device) -> dict:
    """Each group's generator multiplication of CROSSOVER_LANES lanes
    through Mode B (the committed kernel, CUDA events) against the window
    tables' fold (genmul.mul_gen, CUDA events) and the tables' one-time
    build (host clock after a synchronize)."""
    out = {}
    for group in (cv.G1, cv.G2):
        genmul._tables.clear()
        build = host_ms(lambda: genmul.gen_tables(device, group))
        tables = genmul.gen_tables(device, group)
        out[group.name] = {"table_build_ms": build}
        for n in CROSSOVER_LANES:
            k = seeded_scalars(n, SEED + n, device)
            ladder = time_ms(lambda: group.gen_ladder(k), 5)
            fold = time_ms(lambda: genmul.mul_gen(k, tables, group), 5)
            out[group.name][n] = {"gen_ladder_ms": ladder, "fold_ms": fold}
            print(f"{group.name} at {n} lanes: Mode B {ladder:.4f} ms, the tables' fold "
                  f"{fold:.4f} ms (their build {build:.1f} ms once)", flush=True)
    genmul._tables.clear()
    return out


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
    report = {name: {"usage": usage, "ms": {}} for name, (_, usage) in variants.items()}
    for name, (_, usage) in variants.items():
        print(f"{name}: " + ", ".join(f"{k} {u['registers']} regs, {u['spill_stores']} / "
                                      f"{u['spill_loads']} B spilled" for k, u in usage.items()),
              flush=True)
    failed = {}
    check_variants(variants, device, failed)
    variants = {name: v for name, v in variants.items() if name not in failed}
    groups = {"G1": cv.G1, "G2": cv.G2}
    plus, minus = (c.contiguous() for c in cv.naf_masks(hm.R, 1, device))
    runs = {}
    for gname, n in MODE_A:
        (x, y), inf = public_points(groups[gname], n, device)
        for name, (lib, _) in variants.items():
            runs[(name, f"[r] P {gname} {n}")] = (
                mode_a(lib, groups[gname], x, y, plus, minus, inf), 3 if n > 1 << 16 else 5)
    for gname, group in groups.items():
        for n in MODE_B:
            k = seeded_scalars(n, SEED + n, device)
            for name, (lib, _) in variants.items():
                runs[(name, f"[k] G {gname} {n}")] = (
                    mode_b(lib, group, k, piece_bits(name)), 10)
    order = list(runs)
    for key in order + order[::-1]:
        run, reps = runs[key]
        report[key[0]]["ms"].setdefault(key[1], []).append(time_ms(run, reps))
    for name, r in report.items():
        for label, ts in r["ms"].items():
            print(f"{name}: {label}: {' / '.join(f'{t:.4f}' for t in ts)} ms ({card})",
                  flush=True)
    cross = crossover(device)
    print(json.dumps({"card": card, "mul_ladder_variants": report, "refused": failed,
                      "crossover": cross}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
