"""K9's exceptional lanes (``ops.curve.g2_double`` / ``g2_add`` /
``g2_madd``), as the tests and the on-card smoke check build them: G2
operands whose first lanes are the cases, on curve points in Jacobian form
with seeded Z, and seeded canonical words in the other lanes (the formulas
take any canonical input, and kernel and plain version must agree on all
of it); and the host oracle of the case lanes."""

from __future__ import annotations

import numpy as np
import torch

from . import hostmath as hm
from ..ops import fp2
from ..ops.field import FP

# lane -> case. For madd, q's Jacobian Z is dropped (its affine (x, y) is
# taken) and where q is infinite its affine words are (0, 0), the entry the
# generator fold feeds the madd for a zero digit.
CASES = (
    "p at infinity (zero words; madd's first lane)",
    "q at infinity",
    "both at infinity",
    "P == Q (add and madd double)",
    "P == -Q (infinity)",
    "p at infinity, X and Y not zero",
    "P == Q in the same words",
    "two distinct curve points",
)
CASE_LANES = len(CASES)
_P_INF, _Q_INF, _BOTH_INF, _EQUAL, _OPPOSITE, _P_INF_XY, _SAME_WORDS = range(7)


def _jacobian(pt, lam):
    """Affine pt -> (lam^2 x, lam^3 y, lam); None -> zero words."""
    if pt is None:
        return ((0, 0), (0, 0), (0, 0))
    lam2 = hm.fp2_sq(lam)
    return (hm.fp2_mul(pt[0], lam2), hm.fp2_mul(pt[1], hm.fp2_mul(lam, lam2)), lam)


def case_host(seed: int):
    """The case lanes as host Jacobian Fp2 triples (p, q) and the affine
    points they stand for (P, Q)."""
    rng = np.random.default_rng(seed)
    pts = [hm.g2_mul(hm.G2_GEN, int(k) + 2) for k in rng.integers(0, 1 << 60, CASE_LANES)]
    lams = [(int(a) % hm.P, int(b) % hm.P) for a, b in rng.integers(1, 1 << 62, (2 * CASE_LANES, 2))]
    P, Q = list(pts), list(pts[1:]) + pts[:1]
    P[_P_INF] = P[_BOTH_INF] = P[_P_INF_XY] = None
    Q[_Q_INF] = Q[_BOTH_INF] = None
    P[_SAME_WORDS] = Q[_EQUAL] = Q[_SAME_WORDS] = P[_EQUAL]
    Q[_OPPOSITE] = hm.g2_neg(P[_OPPOSITE])
    p = [_jacobian(pt, lams[i]) for i, pt in enumerate(P)]
    q = [_jacobian(pt, lams[CASE_LANES + i]) for i, pt in enumerate(Q)]
    q[_SAME_WORDS] = p[_SAME_WORDS] = p[_EQUAL]
    x, y, _ = _jacobian(pts[_P_INF_XY], lams[0])
    p[_P_INF_XY] = (x, y, (0, 0))
    return p, q, P, Q


def case_points(n: int, seed: int, device):
    """(p, q, qa): G2 operands of n lanes, (12, 2, n) words each. p and q
    are Jacobian (add, double), qa = (x, y) affine (madd); the first
    min(n, CASE_LANES) lanes are the cases, the others seeded words."""
    rng = np.random.default_rng(seed + 1)
    w = rng.integers(0, 1 << 32, size=(9, FP.L, 2, n), dtype=np.uint64).astype(np.uint32)
    w[:, -1] %= np.uint32(hm.P >> (32 * (FP.L - 1)))
    coords = torch.from_numpy(w.view(np.int32)).to(device)
    p, q, qa = list(coords[0:3]), list(coords[3:6]), list(coords[6:8])
    m = min(n, CASE_LANES)
    if m:
        hp, hq, _, Q = case_host(seed)
        for c in range(3):
            p[c][..., :m] = fp2.tensor([pt[c] for pt in hp[:m]], device)
            q[c][..., :m] = fp2.tensor([pt[c] for pt in hq[:m]], device)
        for c in range(2):
            qa[c][..., :m] = fp2.tensor([(0, 0) if pt is None else pt[c] for pt in Q[:m]], device)
    return tuple(p), tuple(q), tuple(qa)


def oracle(seed: int, op: str) -> dict:
    """lane -> the affine result (None for infinity) of each case lane
    whose result is a point: op is "double" (2P), "add" (P + Q) or "madd"
    (P + Q, on the lanes where q is not infinite: affine has no infinity)."""
    _, _, P, Q = case_host(seed)
    if op == "double":
        return {i: hm.g2_add(a, a) for i, a in enumerate(P)}
    return {i: hm.g2_add(a, b) for i, (a, b) in enumerate(zip(P, Q))
            if op == "add" or b is not None}
