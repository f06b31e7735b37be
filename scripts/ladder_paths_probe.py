"""Time the paths that run the scalar-multiplication ladders, in two
checkouts in turns on one card.

    python scripts/ladder_paths_probe.py OLD_CHECKOUT NEW_CHECKOUT

Runs each checkout's kzg_torch in a process of its own (cwd the checkout,
which builds its own kernels), in the order old, new, new, old, and times
in each, with no generator tables first (as a verifier's process has none):
``Evaluation.verify_proof`` of a 10-coefficient opening (V = 1),
``verify_proofs_batch`` at V = 1, 16 and 64 (item 7 given a wrong y; its
x G2 and y G1 the ladders), ``generate_setup`` of 10 points; then
``load_setup`` of a 2^16-point file that ``generate_setup`` wrote (both
groups' subgroup checks) and ``g1_decompress_batch`` of the 2^20 SRS
points of ``chunked_srs_g1``, subgroup-checked. Each is one first run, then
the median of 3 warm runs (2 for the load), host clock after a
synchronize, with the launches by kernel of one warm run and the verdicts
and words checked (hostmath's openings; the decompression gives the
ceremony's words back). Prints the card's name and power limit, one JSON
line a run, then each path's times in the four runs.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

SEED = 20240521
VERIFY_SIZES = (1, 16, 64)
LOG_LOAD, LOG_DECOMPRESS = 16, 20


def _compress_g1(x, y):
    """Affine Montgomery words (12, n) -> n 48-byte ZCash encodings (no
    point at infinity)."""
    import numpy as np
    from kzg_torch.ops import codec
    from kzg_torch.ops.field import FP

    xs = np.ascontiguousarray(FP.from_mont(x).cpu().numpy().view("<u4").T)
    raw = np.ascontiguousarray(xs.view(np.uint8)[:, ::-1])
    sign = codec._gt_half(FP.from_mont(y)).cpu().numpy()
    raw[:, 0] |= np.uint8(0x80) | (sign.astype(np.uint8) << 5)
    return [row.tobytes() for row in raw]


def measure() -> dict:
    """The paths in the current checkout (cwd); see the module docstring."""
    sys.path.insert(0, os.getcwd())
    import torch
    from kzg_torch import G1Point, G2Point, Scalar, generate_setup
    from kzg_torch import artifacts as art
    from kzg_torch.ops import _build, codec, genmul
    from kzg_torch.ops.field import FP
    from kzg_torch.polynomial import Evaluation, verify_proofs_batch
    from kzg_torch.trusted_setup import SetupArtifact
    from kzg_torch.utils import hostmath as hm

    dev = torch.device("cuda", 0)
    _build.build()
    out = {}

    def timed(label, fn, check, reps=3):
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps + 1):
            if len(runs) == reps:  # the last warm run: its launches
                _build.reset_launches()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
            if not check(res):
                raise AssertionError(f"{label}: wrong result")
        warm = sorted(runs[1:])
        out[label] = {"first_ms": runs[0], "ms": warm[len(warm) // 2], "runs_ms": runs,
                      "launches": dict(_build.LAUNCHES)}

    rnd = random.Random(SEED)
    s = rnd.randrange(1, hm.R)
    coeffs = [rnd.randrange(hm.R) for _ in range(10)]

    def poly(x):
        return sum(c * pow(x, i, hm.R) for i, c in enumerate(coeffs)) % hm.R

    setup = [SetupArtifact(G1Point.from_affine(hm.G1_GEN), G2Point.from_affine(hm.G2_GEN)),
             SetupArtifact(G1Point.from_affine(hm.g1_mul(hm.G1_GEN, s)),
                           G2Point.from_affine(hm.g2_mul(hm.G2_GEN, s)))]
    c = G1Point.from_affine(hm.g1_mul(hm.G1_GEN, poly(s)))
    proofs, evs = [], []
    for i in range(max(VERIFY_SIZES)):
        x = rnd.randrange(hm.R)
        y = poly(x)
        proofs.append(G1Point.from_affine(
            hm.g1_mul(hm.G1_GEN, (poly(s) - y) * pow(s - x, -1, hm.R) % hm.R)))
        evs.append(Evaluation(Scalar(x), Scalar((y + (i == 7)) % hm.R)))
    genmul._tables.clear()
    timed("verify_proof", lambda: evs[0].verify_proof(proofs[0], c, setup, device=dev),
          lambda ok: ok is True)
    for v in VERIFY_SIZES:
        timed(f"verify_proofs_batch {v}",
              lambda v=v: verify_proofs_batch(proofs[:v], [c] * v, evs[:v], setup, device=dev),
              lambda got, v=v: got == [i != 7 for i in range(v)])
    want10 = [(hm.g1_mul(hm.G1_GEN, pow(s, k, hm.R)), hm.g2_mul(hm.G2_GEN, pow(s, k, hm.R)))
              for k in range(10)]
    timed("generate_setup 10", lambda: generate_setup(Scalar(s), 10, device=dev),
          lambda items: [(a.g1.affine(), a.g2.affine()) for a in items] == want10)

    folder = os.path.join(os.getcwd(), "build", "ladder_paths_probe")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "setup.json")
    art.save_setup(generate_setup(Scalar(s), 1 << LOG_LOAD, device=dev), path)
    with open(path) as f:
        text = f.read()
    timed(f"load_setup 2^{LOG_LOAD}", lambda: art.load_setup(path, device=dev),
          lambda items: art.dumps([a.to_json() for a in items]) == text, reps=2)
    gx, gy = genmul.chunked_srs_g1(s, 1 << LOG_DECOMPRESS, device=dev)
    blobs = _compress_g1(gx, gy)
    timed(f"g1_decompress_batch 2^{LOG_DECOMPRESS}",
          lambda: codec.g1_decompress_batch(blobs, True, dev),
          lambda jac: bool(torch.equal(jac[0], gx) and torch.equal(jac[1], gy)
                           and torch.equal(jac[2], FP.one_like(gx))))
    return out


def main() -> int:
    if sys.argv[1:] == ["--run"]:
        print("PROBE " + json.dumps(measure()), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (os.path.abspath(p) for p in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for tag, checkout in (("A", old), ("B", new), ("B", new), ("A", old)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run"], cwd=checkout,
                              capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("PROBE ")), None)
        if proc.returncode or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(line[len("PROBE "):])
        runs.append((tag, res))
        print(json.dumps({"run": tag, "checkout": checkout, "paths": res}), flush=True)
    for label in runs[0][1]:
        cells = ", ".join(f"{tag} {res[label]['ms']:.1f} (first {res[label]['first_ms']:.1f})"
                          for tag, res in runs)
        print(f"{label}: {cells} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
