#!/usr/bin/env python3
"""The batched-affine commit (n = 8192, below the fixed-base threshold) in
one checkout, timed alone: median of 7 warm runs (host clock after a sync),
then again after one bucket reduction at the commit's shapes (2^15 + 1
buckets, C = 2^17); then the reference CLI's size, a 10-coefficient commit
and its opening proof against the same SRS, medians of 7 warm runs each.
Each line also gives the kernel launches of one run. Last, the batched MSM
(K2b, one launch) against the route it replaced (msm_batched_plain on K2's
double, madd and add: 525 launches at n = 8192) on seeded inputs at
n = 8192: bit-identical, then timed by CUDA events over each call (the
route's host gaps included) in turns K2b, route, route, K2b.

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
from kzg_torch import Polynomial, Scalar  # noqa: E402
from kzg_torch.ops import _build, msm  # noqa: E402
from kzg_torch.ops import curve as cv  # noqa: E402
from kzg_torch.ops.field import FP, FR  # noqa: E402
from kzg_torch.trusted_setup import DeviceSRS  # noqa: E402
from kzg_torch.utils import hostmath as hm  # noqa: E402

N = 8192
REF_N = 10  # the reference CLI's polynomials (degree 9)
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

    def launches(fn) -> dict:
        _build.reset_launches()
        fn()
        ctx.sync()
        return dict(_build.LAUNCHES)

    def median(fn) -> float:
        return sorted(ctx.time_once(fn)[0] for _ in range(RUNS))[RUNS // 2]

    def commit():
        return poly.commit(srs)

    small = Polynomial.from_ints([rnd.randrange(hm.R) for _ in range(REF_N)], device=ctx.device)
    x = Scalar(rnd.randrange(hm.R))

    def small_commit():
        return small.commit(srs)

    def small_proof():
        return small.evaluate(x).generate_proof(small, srs)

    counts = launches(commit)
    before = median(commit)
    msm.bucket_reduce(*cs.reduce_case(ctx, 1 << 17))
    ctx.sync()
    after = median(commit)
    print(f"{ROOT.name}: batched {N} commit, median of {RUNS} warm runs {before:.2f} ms, "
          f"{after:.2f} ms after a bucket reduction; launches {counts}", flush=True)
    for label, fn in ((f"{REF_N}-coefficient commit", small_commit),
                      (f"{REF_N}-coefficient proof", small_proof)):
        counts = launches(fn)
        print(f"{ROOT.name}: {label}, median of {RUNS} warm runs {median(fn):.2f} ms; "
              f"launches {counts}", flush=True)
    if not hasattr(msm, "msm_batched_plain"):
        return 0  # a checkout from before K2b
    x, y, ks = ctx.rand_field(FP, N), ctx.rand_field(FP, N), ctx.rand_field(FR, N)
    kern = lambda: msm.msm_batched_affine((x, y), ks)  # noqa: E731
    route = lambda: msm.msm_batched_plain((x, y), ks, add=cv.g1_add,  # noqa: E731
                                          madd=cv.g1_madd, double=cv.g1_double)
    cs.check(ctx, f"ladder_msm against the K2 route it replaced (n={N})", kern(), route())
    t = [ctx.time_cuda(f, reps=3) for f in (kern, route, route, kern)]
    chain = cs.ladder_chain(ks)
    print(f"{ROOT.name}: ladder_msm {t[0]:.4f} / {t[3]:.4f} ms against the K2 route "
          f"{t[1]:.4f} / {t[2]:.4f} ms (n={N}); chain {chain}, "
          f"{(t[0] + t[3]) / 2 / sum(chain.values()) * 1e3:.2f} us a point operation", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
