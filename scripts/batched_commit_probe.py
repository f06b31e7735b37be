#!/usr/bin/env python3
"""The batched-affine commit (n = 8192, below the fixed-base threshold) in
one checkout, timed alone: median of 7 warm runs (host clock after a sync),
then again after one bucket reduction at the commit's shapes (2^15 + 1
buckets, C = 2^17).

    python3 scripts/batched_commit_probe.py [CHECKOUT]

CHECKOUT (default: this one) is a checkout of the repository whose
kzg_torch and chip_smoke.py are imported, so that two trees can be run in
turns on one card. Needs a CUDA card and nvcc.
"""

import pathlib
import random
import sys

ROOT = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                    pathlib.Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kzg_torch import Polynomial  # noqa: E402
from kzg_torch.ops import _build, msm  # noqa: E402
from kzg_torch.ops import curve as cv  # noqa: E402
from kzg_torch.ops.field import FR  # noqa: E402
from kzg_torch.trusted_setup import DeviceSRS  # noqa: E402
from kzg_torch.utils import hostmath as hm  # noqa: E402

N = 8192
RUNS = 7


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    _build.build()
    ctx = cs.Ctx(torch, torch.device("cuda", 0))
    rnd = random.Random(cs.SEED)
    s = rnd.randrange(1, hm.R)
    k = FR.tensor([pow(s, i, hm.R) for i in range(N)], ctx.device, mont=False)
    (gx, gy), _ = cv.to_affine(cv.mul_scalar_affine(cv.g1_gen_affine(ctx.device, N), k))
    srs = DeviceSRS(gx.contiguous(), gy.contiguous(), None, [], N)
    poly = Polynomial.from_ints([rnd.randrange(hm.R) for _ in range(N)], device=ctx.device)

    def median() -> float:
        return sorted(ctx.time_once(lambda: poly.commit(srs))[0] for _ in range(RUNS))[RUNS // 2]

    poly.commit(srs)
    before = median()
    msm.bucket_reduce(*cs.reduce_case(ctx, 1 << 17))
    ctx.sync()
    after = median()
    print(f"{ROOT.name}: batched {N} commit, median of {RUNS} warm runs {before:.2f} ms, "
          f"{after:.2f} ms after a bucket reduction", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
