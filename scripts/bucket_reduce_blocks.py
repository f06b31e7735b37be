#!/usr/bin/env python3
"""The bucket reduction's block shape on the card: the kernel as committed
(256 threads a block, thread 0 forming V_top after its own V_b: 18 dependent
adds) against a variant with a ninth warp that forms V_top beside the V_b
(17 adds, but a 288-thread block is held to fewer registers a thread).

    python3 scripts/bucket_reduce_blocks.py

The variant is made from kzg_torch/csrc/bucket_reduce.cu by text
substitution and built with the same nvcc flags into build/. Prints each
form's registers and spills (-Xptxas -v), checks both against
bucket_reduce_plain at the commit's shapes (2^15 + 1 buckets, C = 2^17) and
times them in turns by CUDA events. Needs a CUDA card and nvcc.
"""

import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kzg_torch.ops import _build, msm  # noqa: E402
from kzg_torch.ops.field import FP  # noqa: E402

# the committed kernel's text -> the 288-thread variant's
EXTRA_WARP = [
    ("__launch_bounds__(kLeaves)", "__launch_bounds__(kLeaves + 32)"),
    ("  bucket_v(in, blockIdx.x * kLeaves + t, pts + t, opnd + t);\n"
     "  if (t == 0) bucket_v(in, kTop, top, top + 1);\n",
     "  if (t < kLeaves) bucket_v(in, blockIdx.x * kLeaves + t, pts + t, opnd + t);\n"
     "  else if (t == kLeaves) bucket_v(in, kTop, top, top + 1);\n"),
    ("  pts[t].y = fsub(zero<12>(), pts[t].y);\n"
     "  asm volatile(\"\" ::: \"memory\");\n"
     "  pts[t] = jac_add<BrOps>(top[0], pts[t]);\n",
     "  if (t < kLeaves) {\n"
     "    pts[t].y = fsub(zero<12>(), pts[t].y);\n"
     "    asm volatile(\"\" ::: \"memory\");\n"
     "    pts[t] = jac_add<BrOps>(top[0], pts[t]);\n"
     "  }\n"),
    ("<<<kBrBlocks, kLeaves, smem,", "<<<kBrBlocks, kLeaves + 32, smem,"),
]


def build_variant():
    """Compile the 288-thread variant; returns (library, ptxas usage)."""
    src = (_build.CSRC / "bucket_reduce.cu").read_text()
    for old, new in EXTRA_WARP:
        if old not in src:
            raise RuntimeError(f"bucket_reduce.cu no longer holds {old!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bucket_reduce_288.cu").write_text(src)
    so = out / "libbucket_reduce_288.so"
    log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-I", str(_build.CSRC), "-shared", str(out / "bucket_reduce_288.cu"),
                          "-o", str(so)], capture_output=True, text=True, check=True).stderr
    usage = re.search(r"bucket_reduce_kernel.*?(\d+) bytes spill stores, (\d+) bytes spill loads"
                      r".*?Used (\d+) registers", log, re.S)
    lib = ctypes.CDLL(str(so))
    lib.kzg_bucket_reduce.argtypes = _build.SIGNATURES["kzg_bucket_reduce"]
    lib.kzg_bucket_reduce.restype = ctypes.c_int
    return lib, {"registers": int(usage[3]), "spill_stores": int(usage[1]),
                 "spill_loads": int(usage[2])}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    _build.build()
    lib, var_usage = build_variant()
    print(f"256 threads: {_build.ptxas_usage()['bucket_reduce_kernel']}", flush=True)
    print(f"288 threads: {var_usage}", flush=True)
    ctx = cs.Ctx(torch, torch.device("cuda", 0))
    inputs = cs.reduce_case(ctx, 1 << 17)
    U, off, slot, c, valid = inputs

    def variant():
        scratch = torch.empty(msm.BR_SCRATCH_POINTS * 3 * FP.L + 1, dtype=torch.int32,
                              device=ctx.device)
        out = torch.empty(3, FP.L, dtype=torch.int32, device=ctx.device)
        code = lib.kzg_bucket_reduce(*(t.data_ptr() for t in U + off), slot.data_ptr(),
                                     c.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
                                     out.data_ptr(), U[0].shape[1], off[0].shape[1],
                                     torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the 288-thread variant failed to launch: cudaError {code}")
        return out[0], out[1], out[2]

    forms = {"256 threads": lambda: msm.bucket_reduce(*inputs), "288 threads": variant}
    want = msm.bucket_reduce_plain(*inputs)
    for name, fn in forms.items():
        cs.check(ctx, f"{name}, C = 2^17", fn(), want)
    order = ["256 threads", "288 threads", "288 threads", "256 threads"]
    for name in order:
        print(f"{name}: {ctx.time_cuda(forms[name], reps=50):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
