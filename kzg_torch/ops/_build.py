"""Build, load and count the port's CUDA kernels.

Every ``kzg_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), linked into one shared library
with a plain C interface, and loaded with ctypes. The library lands in
``build/kzg_torch_kernels/`` under the checkout, named by a hash of the
sources and flags, so an unchanged tree reuses it and a changed one rebuilds.
Nothing is built when a module is imported: the first kernel launch builds.

Each source is compiled with ``-Xptxas -v``; the log is kept beside the
library and ``ptxas_usage`` reads each kernel's registers, spills, shared
memory and stack from it. Each C entry point returns ``cudaGetLastError()``
after its launch; ``launch`` raises on a non-zero code. ``LAUNCHES`` counts launches
per kernel name, one per launch and nowhere else, so a run can show which
kernels it went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kzg_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (pointers and the stream as void*, ints as int)
SIGNATURES = {
    "kzg_mont_mul": [_P, _P, _P, _I, _I, _P],
    "kzg_g1_double": [_P] * 6 + [_I, _P],
    "kzg_g1_add": [_P] * 9 + [_I, _P],
    "kzg_g1_madd": [_P] * 8 + [_P, _I, _P],
    "kzg_scan_madd": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "kzg_scan_buckets": [_P] * 9 + [_I, _I, _I, _P],
    "kzg_inv_up": [_P, _P, _P, _I, _I, _I, _P],
    "kzg_inv_top": [_P, _P, _I, _I, _P],
    "kzg_inv_down": [_P, _P, _P, _I, _I, _I, _P],
    "kzg_hs_scan_block": [_P] * 6 + [_I, _I, _I, _P],
    "kzg_hs_scan_runs": [_P] * 12 + [_I, _I, _I, _I, _I, _P],
    "kzg_hs_scan_offsets": [_P] * 9 + [_I, _I, _I, _I, _P],
    "kzg_hs_scan_apply": [_P] * 9 + [_I, _I, _I, _I, _I, _P],
    "kzg_gen_fold": [_P] * 6 + [_I, _P],
    "kzg_fold_entries": [_P] * 5 + [_I, _I, _P],
    "kzg_dbl_chain": [_P] * 6 + [_I, _I, _I, _I, _P],
    "kzg_fr_eval": [_P, _I, _I, _I, _P, _P, _I, _P, _P],
    "kzg_fr_div_top": [_P, _I, _P, _P, _P],
    "kzg_fr_div_down": [_P, _I, _P, _P, _I, _P, _P, _P],
    "kzg_bucket_reduce": [_P] * 11 + [_I, _I, _P],
    "kzg_ladder_msm": [_P] * 6 + [_I, _P],
    "kzg_g2_double": [_P] * 6 + [_I, _P],
    "kzg_g2_add": [_P] * 9 + [_I, _P],
    "kzg_g2_madd": [_P] * 8 + [_I, _P],
    "kzg_g1_ladder": [_P] * 4 + [_I] + [_P] * 4 + [_I, _P],
    "kzg_g2_ladder": [_P] * 4 + [_I] + [_P] * 4 + [_I, _P],
    "kzg_g1_gen_ladder": [_P, _P, _I] + [_P] * 4 + [_I, _P],
    "kzg_g2_gen_ladder": [_P, _P, _I] + [_P] * 4 + [_I, _P],
    "kzg_miller_loop": [_P] * 5 + [_I, _P],
    "kzg_final_exp": [_P] * 3 + [_I, _P],
}

_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libkzg_torch_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link them; returns the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cu, _ = _sources()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in cu:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed, logs = [], []
    for src, proc in procs:
        log, _ = proc.communicate()
        logs.append(f"[nvcc {src.name}]\n{log}")
        if verbose or proc.returncode:
            print(logs[-1], flush=True)
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
    out.with_suffix(".ptxas.txt").write_text("\n".join(logs))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def _demangle(name: str) -> str:
    """``_ZN3kzg16scan_madd_kernelILb1EEEv...`` -> ``scan_madd_kernel<true>``:
    the kernel's name and its one bool or int template argument, if any."""
    m = re.match(r"_ZN3kzg(\d+)", name)
    if not m:
        return name
    start = m.end()
    ident = name[start:start + int(m.group(1))]
    arg = re.match(r"IL([bi])(\d+)E", name[start + len(ident):])
    if arg:
        val = arg.group(2)
        ident += "<" + ({"1": "true", "0": "false"}[val] if arg.group(1) == "b" else val) + ">"
    return ident


def ptxas_usage(log: Path | None = None) -> dict:
    """Per kernel, from the build's ``-Xptxas -v`` log (or another such
    log): registers a thread, spill stores and loads (bytes), static shared
    memory (bytes), stack frame (bytes; the out-of-line helpers' frames are
    their own, reported apart)."""
    log = log or library_path().with_suffix(".ptxas.txt")
    usage, current = {}, None
    for line in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = _demangle(m.group(1))
            usage[current] = {"registers": None, "spill_stores": 0, "spill_loads": 0,
                              "smem": 0, "stack": 0}
            continue
        # a device function's own properties (a __noinline__ helper) follow
        # its callers' reports: they are not the kernel's
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = _demangle(m.group(1))
            current = name if name in usage else None
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            usage[current]["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage[current]["spill_stores"] = int(m.group(1))
            usage[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[current]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            usage[current]["smem"] = int(sm.group(1)) if sm else 0
    return usage


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(counter: str, entry: str, *args) -> None:
    """Call C entry ``entry`` on the current stream; count one launch of
    ``counter``; raise if the launch was refused."""
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(library(), entry)(*args, stream)
    if code != 0:
        raise RuntimeError(f"{entry} failed to launch: cudaError {code}")
    LAUNCHES[counter] += 1


def check_cuda(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous int32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel operands must lie on one CUDA device")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operands must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def reset_launches() -> None:
    LAUNCHES.clear()
