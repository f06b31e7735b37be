"""Batched G1 and G2 Jacobian arithmetic on word tensors.

Counterpart of ``kzg_tpu/ops/curve.py``. A G1 point is an ``(X, Y, Z)``
triple of ``(12, *batch)`` int32 Fp tensors in Montgomery form, a G2 point a
triple of ``(12, 2, *batch)`` Fp2 tensors (``ops/fp2.py``); ``Z == 0``
marks infinity. An affine point is ``(x, y)`` with an ``inf`` mask beside it
where lanes may be infinite.

G1's three formulas (double, add, madd) are kernel K2 (``csrc/g1_point.cu``,
device functions in ``csrc/g1.cuh``) on CUDA tensors and their plain versions
on CPU tensors; G2's are kernel K9 (``csrc/g2_point.cu``, ``csrc/g2.cuh``).
A scalar multiplication of either group is one launch of its ladder kernel
(``csrc/mul_ladder.cu``): the signed-digit ladder on any affine base
(``g1_ladder`` / ``g2_ladder``), or the generator's scalar split into
pieces (``g1_gen_ladder`` / ``g2_gen_ladder``); their plain versions run
the same steps on the plain formulas.
The plain versions follow ``kzg_tpu/ops/curve.py:82-170`` term for term,
exceptional lanes included, so kernel, plain version and the JAX package
agree bit for bit: G1's on 16-bit limbs in int64, G2's on ``fp2``'s
operations (whose products are K1 on a CUDA tensor).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from . import _build
from . import fp2
from . import limbs as lb
from .field import FP, FR
from ..utils import hostmath as hm

# ---------------------------------------------------------------------------
# Plain versions on 16-bit limbs (tuples of (24, N) int64 tensors)
# ---------------------------------------------------------------------------


def _sel(mask, a, b):
    return torch.where(mask.unsqueeze(0), a, b)


def _sel_pt(mask, p, q):
    return tuple(_sel(mask, a, b) for a, b in zip(p, q))


def _is_zero16(a):
    return (a == 0).all(dim=0)


def double16(p):
    """dbl-2009-l (a = 0): 2M + 5S. Maps infinity to infinity."""
    F = FP
    X, Y, Z = p
    A = F.mul16(X, X)
    B = F.mul16(Y, Y)
    C = F.mul16(B, B)
    xb = F.add16(X, B)
    t = F.mul16(xb, xb)
    D0 = F.sub16(F.sub16(t, A), C)
    D = F.add16(D0, D0)
    E = F.add16(F.add16(A, A), A)
    Fq = F.mul16(E, E)
    X3 = F.sub16(Fq, F.add16(D, D))
    C2 = F.add16(C, C)
    C4 = F.add16(C2, C2)
    eightC = F.add16(C4, C4)
    Y3 = F.sub16(F.mul16(E, F.sub16(D, X3)), eightC)
    YZ = F.mul16(Y, Z)
    Z3 = F.add16(YZ, YZ)
    return (X3, Y3, Z3)


def _with_double(mask, p, out):
    """out with the lanes in mask replaced by double(p), the doubling
    computed only when some lane needs it."""
    if not bool(mask.any()):
        return out
    return _sel_pt(mask, double16(p), out)


def _on_lanes(mask, out, fn, *points):
    """out with the lanes in mask replaced by fn(*points) computed on those
    lanes alone (mask has the batch shape; each point a tuple of limbs)."""
    if bool(mask.all()):
        return fn(*points)
    if not bool(mask.any()):
        return out
    idx = mask.reshape(-1).nonzero().squeeze(1)
    sub = [tuple(c.reshape(c.shape[0], -1)[:, idx] for c in pt) for pt in points]
    res = fn(*sub)
    merged = []
    for o, r in zip(out, res):
        o = o.reshape(o.shape[0], -1).clone()
        o[:, idx] = r
        merged.append(o.reshape((o.shape[0],) + mask.shape))
    return tuple(merged)


def _add_finite16(p, q):
    """add-2007-bl on lanes where neither operand is infinity: 11M + 5S,
    P == Q doubles, P == -Q gives infinity."""
    F = FP
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = F.mul16(Z1, Z1)
    Z2Z2 = F.mul16(Z2, Z2)
    U1 = F.mul16(X1, Z2Z2)
    U2 = F.mul16(X2, Z1Z1)
    S1 = F.mul16(Y1, F.mul16(Z2, Z2Z2))
    S2 = F.mul16(Y2, F.mul16(Z1, Z1Z1))
    H = F.sub16(U2, U1)
    H2 = F.add16(H, H)
    I = F.mul16(H2, H2)
    J = F.mul16(H, I)
    dS = F.sub16(S2, S1)
    r = F.add16(dS, dS)
    V = F.mul16(U1, I)
    X3 = F.sub16(F.sub16(F.mul16(r, r), J), F.add16(V, V))
    S1J = F.mul16(S1, J)
    Y3 = F.sub16(F.mul16(r, F.sub16(V, X3)), F.add16(S1J, S1J))
    Z3 = F.mul16(F.mul16(Z1, Z2), H2)
    out = (X3, Y3, Z3)
    same_x = _is_zero16(H)
    same_y = _is_zero16(dS)
    out = _with_double(same_x & same_y, p, out)
    return _sel_pt(same_x & ~same_y, tuple(torch.zeros_like(c) for c in out), out)


def add16(p, q):
    """add-2007-bl with the exceptional lanes (curve.py:103-135). A lane with
    an infinite operand returns the other operand (p when both are), exactly
    the JAX package's last two selects, so the formula runs only on the
    lanes where both are finite."""
    p_inf, q_inf = _is_zero16(p[2]), _is_zero16(q[2])
    out = _sel_pt(q_inf, p, q)
    return _on_lanes(~p_inf & ~q_inf, out, _add_finite16, p, q)


def _madd_core16(p, q_affine):
    F = FP
    X1, Y1, Z1 = p
    X2, Y2 = q_affine
    Z1Z1 = F.mul16(Z1, Z1)
    U2 = F.mul16(X2, Z1Z1)
    S2 = F.mul16(Y2, F.mul16(Z1, Z1Z1))
    H = F.sub16(U2, X1)
    H2 = F.add16(H, H)
    I = F.mul16(H2, H2)
    J = F.mul16(H, I)
    dS = F.sub16(S2, Y1)
    r = F.add16(dS, dS)
    V = F.mul16(X1, I)
    X3 = F.sub16(F.sub16(F.mul16(r, r), J), F.add16(V, V))
    Y1J = F.mul16(Y1, J)
    Y3 = F.sub16(F.mul16(r, F.sub16(V, X3)), F.add16(Y1J, Y1J))
    Z3 = F.mul16(H2, Z1)
    out = (X3, Y3, Z3)
    same_x, same_y = _is_zero16(H), _is_zero16(dS)
    out = _sel_pt(same_x & ~same_y, tuple(torch.zeros_like(c) for c in out), out)
    return out, same_x & same_y


def _madd_finite16(p, q_affine):
    out, need = _madd_core16(p, q_affine)
    return _with_double(need, p, out)


def _madd_fast_finite16(p, q_affine):
    out, need = _madd_core16(p, q_affine)
    return out + (need.to(torch.int64).unsqueeze(0),)


def _affine_as_jac16(q_affine, ref):
    one = FP.const16("ONE", ref.device).reshape((FP.L16,) + (1,) * (ref.dim() - 1))
    return (q_affine[0], q_affine[1], one.expand_as(ref))


def madd16(p, q_affine):
    """madd-2007-bl (Z2 = 1) with the exceptional lanes: 7M + 4S
    (curve.py:137-170). A lane with p at infinity returns (x2, y2, ONE); the
    formula runs on the others. q_affine must not be a lane at infinity."""
    p_inf = _is_zero16(p[2])
    out = _affine_as_jac16(q_affine, p[0])
    return _on_lanes(~p_inf, out, _madd_finite16, p, q_affine)


def madd_fast16(p, q_affine):
    """The 11-mul madd without the inline doubling (pallas_curve._madd_pt_fast):
    returns (point, needs_double); a needs_double lane's point is not the sum."""
    p_inf = _is_zero16(p[2])
    out = _affine_as_jac16(q_affine, p[0]) + (torch.zeros_like(p[0][:1]),)
    res = _on_lanes(~p_inf, out, _madd_fast_finite16, p, q_affine)
    return res[:3], res[3][0] != 0


def to16(p):
    return tuple(lb.words_to_limbs16(c) for c in p)


def from16(p):
    return tuple(lb.limbs16_to_words(c) for c in p)


# ---------------------------------------------------------------------------
# K2: the point formulas. Plain versions on word tensors, and the wrappers.
# ---------------------------------------------------------------------------


def g1_double_plain(p):
    return from16(double16(to16(p)))


def g1_add_plain(p, q):
    return from16(add16(to16(p), to16(q)))


def g1_madd_plain(p, q_affine, fast: bool = False):
    """Plain madd; with fast=True returns (point, needs_double) like K2's fast
    launch."""
    if fast:
        out, nd = madd_fast16(to16(p), to16(q_affine))
        return from16(out), nd
    return from16(madd16(to16(p), to16(q_affine)))


def _flat(coords):
    shape = coords[0].shape
    if any(c.shape != shape for c in coords) or shape[0] != FP.L:
        raise ValueError("point coordinates must share one (12, *batch) shape")
    n = coords[0].numel() // FP.L
    flat = tuple(c.reshape(FP.L, n).contiguous() for c in coords)
    _build.check_cuda(*flat)
    return flat, shape, n


def g1_double(p):
    """K2 double: CPU tensors take the plain version, CUDA tensors launch
    ``kzg_g1_double``."""
    if p[0].device.type == "cpu":
        return g1_double_plain(p)
    flat, shape, n = _flat(p)
    out = tuple(torch.empty_like(c) for c in flat)
    _build.launch("g1_double", "kzg_g1_double", *(c.data_ptr() for c in flat + out), n)
    return tuple(o.reshape(shape) for o in out)


def g1_add(p, q):
    """K2 add (exact, every exceptional lane)."""
    if p[0].device.type == "cpu":
        return g1_add_plain(p, q)
    flat, shape, n = _flat(tuple(p) + tuple(q))
    out = tuple(torch.empty_like(c) for c in flat[:3])
    _build.launch("g1_add", "kzg_g1_add", *(c.data_ptr() for c in flat + out), n)
    return tuple(o.reshape(shape) for o in out)


def g1_madd(p, q_affine, fast: bool = False):
    """K2 mixed add of a Jacobian p and an affine q (same shape). fast=True
    runs the 11-mul formula and also returns the (batch,) needs-double mask."""
    if p[0].device.type == "cpu":
        return g1_madd_plain(p, q_affine, fast)
    flat, shape, n = _flat(tuple(p) + tuple(q_affine))
    out = tuple(torch.empty_like(c) for c in flat[:3])
    need = torch.empty(n, dtype=torch.int32, device=flat[0].device) if fast else None
    _build.launch("g1_madd", "kzg_g1_madd", *(c.data_ptr() for c in flat + out),
                  need.data_ptr() if fast else None, n)
    res = tuple(o.reshape(shape) for o in out)
    return (res, need.reshape(shape[1:]) != 0) if fast else res


# ---------------------------------------------------------------------------
# K7: the doubling chain, and its windowed form for the table build
# ---------------------------------------------------------------------------


def dbl_chain_plain(p, steps: int):
    """Plain K7: ``steps`` doublings, 2^steps p."""
    for _ in range(steps):
        p = g1_double_plain(p)
    return p


def dbl_chain(p, steps: int):
    """K7: 2^steps p for a Jacobian (12, *batch) p, steps >= 0. CPU tensors
    take the plain version; CUDA tensors launch ``kzg_dbl_chain``
    (csrc/dbl_chain.cu), which keeps the point in registers between steps."""
    if steps < 0:
        raise ValueError("steps must be >= 0")
    if p[0].device.type == "cpu":
        return dbl_chain_plain(p, steps)
    flat, shape, n = _flat(p)
    out = tuple(torch.empty_like(c) for c in flat)
    if n:
        _build.launch("dbl_chain", "kzg_dbl_chain", *(c.data_ptr() for c in flat + out),
                      steps, 0, 1, n)
    return tuple(o.reshape(shape) for o in out)


def dbl_windows_plain(p_affine, steps: int, windows: int):
    """Plain windowed K7: the loop of g1_double_plain the table build ran.
    Returns (12, windows * n) coordinates, window k = 2^(steps k) p in
    columns [k n, k n + n)."""
    x, y = p_affine
    cur = (x, y, FP.one_like(x))
    out = [cur]
    for _ in range(1, windows):
        cur = dbl_chain_plain(cur, steps)
        out.append(cur)
    return tuple(torch.cat([w[k] for w in out], dim=1) for k in range(3))


def dbl_windows(p_affine, steps: int, windows: int):
    """Windowed K7 on affine (x, y) (12, n) words (z the Montgomery one):
    2^(steps k) p for k < windows as one (12, windows * n) Jacobian triple,
    window k in columns [k n, k n + n). CPU tensors take the plain version;
    CUDA tensors launch ``kzg_dbl_chain`` once, writing each window from
    registers."""
    if steps < 0 or windows < 1:
        raise ValueError("need steps >= 0 and windows >= 1")
    x, y = p_affine
    if x.shape != y.shape or x.dim() != 2 or x.shape[0] != FP.L:
        raise ValueError("dbl_windows takes (12, n) affine coordinates")
    if x.device.type == "cpu":
        return dbl_windows_plain(p_affine, steps, windows)
    _build.check_cuda(x, y)
    n = x.shape[1]
    out = tuple(torch.empty(FP.L, windows * n, dtype=x.dtype, device=x.device) for _ in range(3))
    if n:
        _build.launch("dbl_windows", "kzg_dbl_chain", x.data_ptr(), y.data_ptr(), None,
                      *(c.data_ptr() for c in out), 0, steps, windows, n)
    return out


# ---------------------------------------------------------------------------
# The G1 group on word tensors
# ---------------------------------------------------------------------------


def is_inf(p):
    return FP.is_zero(p[2])


def select(mask, p, q):
    """p where mask (of the batch shape), else q: points of either group."""
    return tuple(torch.where(mask, a, b) for a, b in zip(p, q))


def inf_like(p):
    return tuple(torch.zeros_like(c) for c in p)


def neg(p):
    return (p[0], FP.neg(p[1]), p[2])


def to_affine(p):
    """Jacobian -> affine ((x, y), inf): one batched inversion over every
    lane. Infinity lanes return (0, 0): the inversion maps their Z = 0 to 0,
    and the products with it are 0."""
    X, Y, Z = p
    zi = FP.inv_batch(Z)
    zi2 = FP.square(zi)
    x = FP.mul(X, zi2)
    y = FP.mul(Y, FP.mul(zi, zi2))
    return (x, y), is_inf(p)


def scalar_bit(k: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i (0 = LSB) of standard-form Fr words k (8, *batch)."""
    return ((k[i // 32] >> (i % 32)) & 1) == 1


# ---------------------------------------------------------------------------
# G2 over Fp2. Plain versions: the JAX package's formulas on ``fp2``.
# ---------------------------------------------------------------------------


def g2_is_inf(p):
    return fp2.is_zero(p[2])


def g2_double_plain(p):
    """dbl-2009-l (a = 0): 2M + 5S. Maps infinity to infinity."""
    F = fp2
    X, Y, Z = p
    A = F.square(X)
    B = F.square(Y)
    C = F.square(B)
    t = F.square(F.add(X, B))
    D = F.dbl(F.sub(F.sub(t, A), C))
    E = F.add(F.dbl(A), A)
    Fq = F.square(E)
    X3 = F.sub(Fq, F.dbl(D))
    eightC = F.dbl(F.dbl(F.dbl(C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), eightC)
    Z3 = F.dbl(F.mul(Y, Z))
    return (X3, Y3, Z3)


def _g2_exceptional(p, out, same_x, same_y):
    """The equal-x lanes: P == Q doubles P (computed only when some lane
    needs it), P == -Q gives the zero words of infinity."""
    need = same_x & same_y
    if bool(need.any()):
        out = select(need, g2_double_plain(p), out)
    return select(same_x & ~same_y, inf_like(out), out)


def g2_add_plain(p, q):
    """add-2007-bl with the exceptional lanes in the JAX package's order
    (curve.py:103-135): P == Q doubles, P == -Q gives infinity, then a lane
    with p at infinity takes q and one with q at infinity takes p."""
    F = fp2
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = F.square(Z1)
    Z2Z2 = F.square(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
    S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H = F.sub(U2, U1)
    I = F.square(F.dbl(H))
    J = F.mul(H, I)
    dS = F.sub(S2, S1)
    r = F.dbl(dS)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.square(r), J), F.dbl(V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.dbl(F.mul(S1, J)))
    Z3 = F.mul(F.mul(Z1, Z2), F.dbl(H))
    out = _g2_exceptional(p, (X3, Y3, Z3), F.is_zero(H), F.is_zero(dS))
    out = select(g2_is_inf(p), q, out)
    return select(g2_is_inf(q), p, out)


def g2_madd_plain(p, q_affine):
    """madd-2007-bl (Z2 = 1) with the exceptional lanes (curve.py:137-170):
    a lane with p at infinity returns (x2, y2, ONE). q_affine must not be a
    lane at infinity (callers mask those lanes)."""
    F = fp2
    X1, Y1, Z1 = p
    X2, Y2 = q_affine
    Z1Z1 = F.square(Z1)
    U2 = F.mul(X2, Z1Z1)
    S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H = F.sub(U2, X1)
    I = F.square(F.dbl(H))
    J = F.mul(H, I)
    dS = F.sub(S2, Y1)
    r = F.dbl(dS)
    V = F.mul(X1, I)
    X3 = F.sub(F.sub(F.square(r), J), F.dbl(V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.dbl(F.mul(Y1, J)))
    Z3 = F.mul(F.dbl(H), Z1)
    out = _g2_exceptional(p, (X3, Y3, Z3), F.is_zero(H), F.is_zero(dS))
    q_jac = (X2.expand_as(X1), Y2.expand_as(Y1), F.one(X1))
    return select(g2_is_inf(p), q_jac, out)


# ---------------------------------------------------------------------------
# K9: G2's double, add and madd. Wrappers.
# ---------------------------------------------------------------------------


def _flat2(coords):
    shape = coords[0].shape
    if any(c.shape != shape for c in coords) or tuple(shape[:2]) != (FP.L, 2):
        raise ValueError("G2 point coordinates must share one (12, 2, *batch) shape")
    n = coords[0].numel() // (2 * FP.L)
    flat = tuple(c.reshape(FP.L, 2, n).contiguous() for c in coords)
    _build.check_cuda(*flat)
    return flat, shape, n


def _g2_launch(counter, entry, operands, n_out):
    flat, shape, n = _flat2(operands)
    out = tuple(torch.empty_like(c) for c in flat[:n_out])
    if n:
        _build.launch(counter, entry, *(c.data_ptr() for c in flat + out), n)
    return tuple(o.reshape(shape) for o in out)


def g2_double(p):
    """K9 double: CPU tensors take the plain version, CUDA tensors launch
    ``kzg_g2_double`` (csrc/g2_point.cu)."""
    if p[0].device.type == "cpu":
        return g2_double_plain(p)
    return _g2_launch("g2_double", "kzg_g2_double", tuple(p), 3)


def g2_add(p, q):
    """K9 add (exact, every exceptional lane): ``kzg_g2_add`` on CUDA tensors."""
    if p[0].device.type == "cpu":
        return g2_add_plain(p, q)
    return _g2_launch("g2_add", "kzg_g2_add", tuple(p) + tuple(q), 3)


def g2_madd(p, q_affine):
    """K9 mixed add of a Jacobian p and an affine q (same shape):
    ``kzg_g2_madd`` on CUDA tensors."""
    if p[0].device.type == "cpu":
        return g2_madd_plain(p, q_affine)
    return _g2_launch("g2_madd", "kzg_g2_madd", tuple(p) + tuple(q_affine), 3)


def g2_to_affine(p):
    """Jacobian -> affine ((x, y), inf) over Fp2: one batched inversion of
    the Z norms over every lane (fp2.inv). Infinity lanes return (0, 0)."""
    X, Y, Z = p
    zi = fp2.inv(Z)
    zi2 = fp2.square(zi)
    return (fp2.mul(X, zi2), fp2.mul(Y, fp2.mul(zi, zi2))), g2_is_inf(p)


# ---------------------------------------------------------------------------
# Host <-> device points (IO boundary; exact python ints)
# ---------------------------------------------------------------------------


def g1_to_device(points, device):
    """Host affine points (x, y) or None -> Jacobian word triple (12, n)."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0); ys.append(0); zs.append(0)
        else:
            xs.append(pt[0]); ys.append(pt[1]); zs.append(1)
    return tuple(FP.tensor(v, device) for v in (xs, ys, zs))


def g1_from_device(p) -> list:
    """Jacobian word triple (12, *batch) -> list of host affine ints (None = infinity)."""
    X, Y, Z = (FP.from_words_many(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = hm.fp_inv(z)
        zi2 = zi * zi % hm.P
        out.append((x * zi2 % hm.P, y * zi2 * zi % hm.P))
    return out


def g1_gen_affine(device, n: int = 1):
    """The generator as affine Montgomery words, broadcast to (12, n)."""
    gx, gy = (FP.tensor([c], device) for c in hm.G1_GEN)
    return gx.expand(FP.L, n).contiguous(), gy.expand(FP.L, n).contiguous()


def g2_to_device(points, device):
    """Host affine G2 points ((x0, x1), (y0, y1)) or None -> Jacobian
    (12, 2, n) words."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append((0, 0)); ys.append((0, 0)); zs.append((0, 0))
        else:
            xs.append(pt[0]); ys.append(pt[1]); zs.append((1, 0))
    return tuple(fp2.tensor(v, device) for v in (xs, ys, zs))


def g2_from_device(p) -> list:
    """Jacobian (12, 2, *batch) words -> list of host affine G2 points (None
    = infinity)."""
    X, Y, Z = (fp2.to_ints(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == (0, 0):
            out.append(None)
            continue
        zi = hm.fp2_inv(z)
        zi2 = hm.fp2_sq(zi)
        out.append((hm.fp2_mul(x, zi2), hm.fp2_mul(y, hm.fp2_mul(zi, zi2))))
    return out


def g2_gen_affine(device, n: int = 1):
    """G2's generator as affine Montgomery words, broadcast to (12, 2, n)."""
    gx, gy = (fp2.tensor([c], device) for c in hm.G2_GEN)
    return gx.expand(FP.L, 2, n).contiguous(), gy.expand(FP.L, 2, n).contiguous()


# ---------------------------------------------------------------------------
# The two groups as records, for the functions that serve both
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Group:
    """What a function serving both groups needs of one of them."""

    name: str
    coord: tuple  # the leading axes of a coordinate's words
    double: Callable  # the kernels: K2 for G1, K9 for G2
    add: Callable
    madd: Callable
    ladder: Callable  # a scalar multiplication in one launch (g1_ladder, g2_ladder)
    gen_ladder: Callable  # [k] G in one launch (g1_gen_ladder, g2_gen_ladder)
    is_inf: Callable
    to_affine: Callable
    words: Callable  # (host ints, device) -> Montgomery words
    to_ints: Callable  # Montgomery words -> flat list of host ints
    one: Callable  # words -> the Montgomery one in their shape
    gen_affine: Callable  # (device, n) -> the generator's affine words
    gen: tuple  # the generator, host affine ints
    host_add: Callable  # hostmath's affine add

    def host_affine(self, xy, inf) -> list:
        """Affine words (x, y) and their infinity mask -> host points, None
        at infinity."""
        pts = zip(self.to_ints(xy[0]), self.to_ints(xy[1]))
        return [None if i else p for p, i in zip(pts, inf.reshape(-1).tolist())]


# The kernels are looked up when called, so that a module function swapped
# for a wrapper (chip_smoke.py's call log) is the one that runs.
G1 = Group("G1", (FP.L,), lambda p: g1_double(p), lambda p, q: g1_add(p, q),
           lambda p, q: g1_madd(p, q), lambda p, k, inf=None: g1_ladder(p, k, inf),
           lambda k: g1_gen_ladder(k), is_inf,
           to_affine, FP.tensor, FP.from_words_many, FP.one_like, g1_gen_affine, hm.G1_GEN,
           hm.g1_add)
G2 = Group("G2", (FP.L, 2), lambda p: g2_double(p), lambda p, q: g2_add(p, q),
           lambda p, q: g2_madd(p, q), lambda p, k, inf=None: g2_ladder(p, k, inf),
           lambda k: g2_gen_ladder(k), g2_is_inf,
           g2_to_affine, fp2.tensor, fp2.to_ints, fp2.one, g2_gen_affine, hm.G2_GEN, hm.g2_add)


# ---------------------------------------------------------------------------
# K2 and K9 as the scalar multiplications use them: one ladder launch a call
# ---------------------------------------------------------------------------


def _top_bit(k: torch.Tensor) -> int:
    """The highest set bit of any lane of (W, n) words, -1 if none."""
    used = (k != 0).any(dim=1).nonzero()
    if used.numel() == 0:
        return -1
    w = int(used[-1])
    return 32 * w + int((k[w].to(torch.int64) & 0xFFFFFFFF).max()).bit_length() - 1


def ladder_plain(p_affine, k: torch.Tensor, inf=None, group=G1):
    """The binary double-and-add ladder on the group's plain formulas (any
    device): the lanes flagged in ``inf`` take the scalar 0, then from the
    highest set bit of any lane down, acc = 2 acc and acc + P where the bit
    is set (a select keeps acc elsewhere; a step where no lane has the bit
    skips the madd). Above that bit every acc is the zero words of
    infinity, as in the JAX package's 256 steps (curve.py:228-245), so the
    words are its. The pieces of gen_ladder_plain run it."""
    double, madd = ((g1_double_plain, g1_madd_plain) if group is G1
                    else (g2_double_plain, g2_madd_plain))
    if inf is not None:
        k = torch.where(inf, 0, k)
    x, y = p_affine
    acc = inf_like((x, x, x))
    for i in range(_top_bit(k), -1, -1):
        acc = double(acc)
        bit = scalar_bit(k, i)
        if bool(bit.any()):
            acc = select(bit, madd(acc, (x, y)), acc)
    return acc


# ---------------------------------------------------------------------------
# Mode A: the signed-digit (NAF) ladder, for any affine base
# ---------------------------------------------------------------------------

NAF_WORDS = 9  # a NAF of a 256-bit scalar has up to 257 digits
_MASK32 = 0xFFFFFFFF


def naf_int(k: int) -> tuple[int, int]:
    """The non-adjacent form of k >= 0 as two masks (plus, minus), k = plus -
    minus, digit i non-zero in at most one of them and never in two
    neighbours: with h = 3 k, digit i is bit i + 1 of h minus bit i + 1 of
    k, so plus = (h & ~k) >> 1 and minus = (k & ~h) >> 1."""
    h = 3 * k
    return (h & ~k) >> 1, (k & ~h) >> 1


def _signed32(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def naf_words(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """naf_int of every lane of (8, n) standard-form words, as plain tensor
    operations on k's device: (plus, minus), each (NAF_WORDS, n) int32."""
    k64 = k.to(torch.int64) & _MASK32
    kw = torch.cat([k64, torch.zeros_like(k64[:1])])  # (9, n): 3 k < 2^258
    h, carry = [], torch.zeros_like(k64[0])
    for w in range(NAF_WORDS):  # h = k + 2 k, word by word with carries
        two = ((kw[w] << 1) | (kw[w - 1] >> 31 if w else 0)) & _MASK32
        total = kw[w] + two + carry
        h.append(total & _MASK32)
        carry = total >> 32
    h = torch.stack(h)
    out = []
    for a in (h & ~kw & _MASK32, kw & ~h & _MASK32):  # then >> 1 across the words
        nxt = torch.cat([a[1:], torch.zeros_like(a[:1])])
        out.append(_signed32((a >> 1) | ((nxt & 1) << 31)))
    return out[0], out[1]


@functools.cache
def _naf_column(k: int, device):
    """naf_int(k mod 2^256) as two (NAF_WORDS, 1) int32 tensors on device,
    made once and kept."""
    masks = naf_int(k % (1 << 256))
    return tuple(torch.from_numpy(lb.ints_to_words([m], NAF_WORDS)).to(device) for m in masks)


def naf_masks(k, n: int, device):
    """The NAF masks (plus, minus) of n lanes, each (NAF_WORDS, n) int32: a
    python int's (kept on the device) broadcast to every lane, or naf_words
    of (8, n) words."""
    if isinstance(k, int):
        return tuple(c.expand(NAF_WORDS, n) for c in _naf_column(k, torch.device(device)))
    return naf_words(k)


def _group_neg(y, group):
    return FP.neg(y) if group is G1 else fp2.neg(y)


def naf_ladder_plain(p_affine, plus, minus, inf=None, group=G1):
    """Plain version of the Mode A kernels (any device), in their order:
    the lanes flagged in ``inf`` take the digits 0; at the highest non-zero
    digit of any lane acc is (x, y, ONE), (x, -y, ONE) or infinity (the madd
    onto infinity); below it acc = 2 acc, then acc + (x, y) where the
    digit is +1 and acc + (x, -y) where it is -1, kept by a select (a step
    where no lane has a non-zero digit skips the madd), on the group's plain
    formulas. plus, minus: (NAF_WORDS, n) masks (naf_words)."""
    double, madd = ((g1_double_plain, g1_madd_plain) if group is G1
                    else (g2_double_plain, g2_madd_plain))
    if inf is not None:
        plus, minus = torch.where(inf, 0, plus), torch.where(inf, 0, minus)
    x, y = p_affine
    ny = _group_neg(y, group)
    nonzero = plus | minus
    acc = inf_like((x, x, x))
    top = _top_bit(nonzero)
    if top >= 0:
        start = (x, torch.where(scalar_bit(minus, top), ny, y), group.one(x))
        acc = select(scalar_bit(nonzero, top), start, acc)
    for i in range(top - 1, -1, -1):
        acc = double(acc)
        take = scalar_bit(nonzero, i)
        if bool(take.any()):
            acc = select(take, madd(acc, (x, torch.where(scalar_bit(minus, i), ny, y))), acc)
    return acc


def _ladder(counter, entry, group, p_affine, k, inf):
    coord = group.coord
    x, y = p_affine
    n = x.shape[-1]
    if x.shape != coord + (n,) or y.shape != x.shape or (
            not isinstance(k, int) and tuple(k.shape) != (FR.L, n)):
        raise ValueError(f"the ladder takes {coord + ('n',)} coordinates and (8, n) scalars or "
                         f"an int, got {tuple(x.shape)}, {tuple(y.shape)} and "
                         f"{k if isinstance(k, int) else tuple(k.shape)}")
    if inf is not None and tuple(inf.shape) != (n,):
        raise ValueError(f"inf must have shape ({n},)")
    if x.device.type == "cpu":
        return naf_ladder_plain(p_affine, *naf_masks(k, n, x.device), inf, group)
    plus, minus = _naf_column(k, x.device) if isinstance(k, int) else naf_words(k)
    x, y = x.contiguous(), y.contiguous()
    _build.check_cuda(x, y, plus, minus)
    if inf is not None and (inf.dtype != torch.bool or inf.device != x.device
                            or not inf.is_contiguous()):
        raise ValueError("inf must be a contiguous bool tensor on the operands' device")
    out = tuple(torch.empty_like(x) for _ in range(3))
    if n:
        _build.launch(counter, entry, x.data_ptr(), y.data_ptr(), plus.data_ptr(),
                      minus.data_ptr(), int(not isinstance(k, int)),
                      None if inf is None else inf.data_ptr(), *(o.data_ptr() for o in out), n)
    return out


def g1_ladder(p_affine, k, inf=None):
    """[k_i] P_i on every lane by the signed-digit ladder: p_affine (x, y)
    (12, n) affine Montgomery words, k (8, n) standard-form scalar words or a
    python int (one scalar for every lane, mod 2^256), inf an (n,) bool mask
    or None (a flagged lane's product is infinity). Returns a Jacobian
    (12, n) triple. The scalars' NAF masks: an int's computed once and kept
    on the device, words' by naf_words. CPU tensors take
    ``naf_ladder_plain``; CUDA tensors launch ``kzg_g1_ladder``
    (csrc/mul_ladder.cu Mode A, one launch counted as ``g1_ladder``), whose
    output equals the plain version's word for word."""
    return _ladder("g1_ladder", "kzg_g1_ladder", G1, p_affine, k, inf)


def g2_ladder(p_affine, k, inf=None):
    """G2's ladder, as g1_ladder on (12, 2, n) coordinates: ``kzg_g2_ladder``
    on CUDA tensors, counted as ``g2_ladder``."""
    return _ladder("g2_ladder", "kzg_g2_ladder", G2, p_affine, k, inf)


# ---------------------------------------------------------------------------
# Mode B: the generator's scalar split into pieces, a thread a piece
# ---------------------------------------------------------------------------

# bits a piece, as csrc/mul_ladder.cu's kGenPieceBits: the kernels refuse
# bases of another piece count
GEN_SPLIT_BITS = 4
GEN_SPLIT_PIECES = 256 // GEN_SPLIT_BITS


@functools.cache
def gen_pow2(group=G1) -> tuple:
    """The host-exact affine points 2^j G for j < 256, G the group's
    generator."""
    out = [group.gen]
    for _ in range(255):
        out.append(group.host_add(out[-1], out[-1]))
    return tuple(out)


@functools.cache
def split_bases(group=G1, device="cpu"):
    """Mode B's constant bases: the affine words of [2^(GEN_SPLIT_BITS j)] G
    for j < GEN_SPLIT_PIECES, each coordinate of the group's shape with
    GEN_SPLIT_PIECES lanes, on device; made on the host once a group and
    device and kept."""
    pts = gen_pow2(group)[::GEN_SPLIT_BITS]
    return tuple(group.words([p[c] for p in pts], device) for c in (0, 1))


def gen_ladder_plain(k: torch.Tensor, group=G1):
    """Plain version of the Mode B kernels (any device), in their order:
    piece j of each lane's (8, n) scalar words (bits [b j, b j + b), b =
    GEN_SPLIT_BITS) times [2^(b j)] G by ladder_plain, then at h = 1, 2, 4, ..
    piece j + h added into piece j, j a multiple of 2 h, by the group's
    exact plain add (a level's sums halve the pieces' axis). Returns the
    Jacobian [k_i] G triple of n lanes."""
    add = g1_add_plain if group is G1 else g2_add_plain
    bits, pieces = GEN_SPLIT_BITS, GEN_SPLIT_PIECES
    n = k.shape[1]
    k64 = k.to(torch.int64) & _MASK32
    digits = torch.stack([(k64[(bits * j) // 32] >> ((bits * j) % 32)) & ((1 << bits) - 1)
                          for j in range(pieces)])  # (pieces, n)
    words = torch.zeros(FR.L, pieces * n, dtype=torch.int32, device=k.device)
    words[0] = _signed32(digits.reshape(-1))
    bx, by = (c.unsqueeze(-1).expand(c.shape + (n,)).reshape(group.coord + (-1,))
              for c in split_bases(group, k.device))
    acc = tuple(c.reshape(group.coord + (pieces, n))
                for c in ladder_plain((bx, by), words, None, group))
    while acc[0].shape[-2] > 1:  # the sums of pieces j and j + h sit side by side
        acc = add(tuple(c[..., 0::2, :] for c in acc), tuple(c[..., 1::2, :] for c in acc))
    return tuple(c[..., 0, :].contiguous() for c in acc)


def _gen_ladder(counter, entry, group, k):
    if k.dim() != 2 or k.shape[0] != FR.L:
        raise ValueError(f"the generator's ladder takes (8, n) scalar words, got "
                         f"{tuple(k.shape)}")
    n = k.shape[1]
    if k.device.type == "cpu":
        return gen_ladder_plain(k, group)
    k = k.contiguous()
    bx, by = split_bases(group, k.device)
    _build.check_cuda(k, bx, by)
    out = tuple(torch.empty(group.coord + (n,), dtype=torch.int32, device=k.device)
                for _ in range(3))
    if n:
        _build.launch(counter, entry, bx.data_ptr(), by.data_ptr(), bx.shape[-1],
                      k.data_ptr(), *(o.data_ptr() for o in out), n)
    return out


def g1_gen_ladder(k):
    """[k_i] G1 for (8, n) standard-form scalar words, not reduced mod r
    (the sum is [k_i mod r] G1): a Jacobian (12, n) triple. CPU tensors take
    ``gen_ladder_plain``; CUDA tensors launch ``kzg_g1_gen_ladder``
    (csrc/mul_ladder.cu Mode B: two warps a lane, a thread a 4-bit piece
    on its constant base, then a tree of adds; one launch counted as
    ``g1_gen_ladder``), whose output equals the plain version's word for
    word."""
    return _gen_ladder("g1_gen_ladder", "kzg_g1_gen_ladder", G1, k)


def g2_gen_ladder(k):
    """[k_i] G2, as g1_gen_ladder on (12, 2, n) output: ``kzg_g2_gen_ladder``
    on CUDA tensors, counted as ``g2_gen_ladder``."""
    return _gen_ladder("g2_gen_ladder", "kzg_g2_gen_ladder", G2, k)


def mul_scalar(p, k, group=G1):
    """[k] p for Jacobian base points (curve.py:205-226). k is either a
    python int, one scalar for every lane (the codec's [r] P), or (8, n)
    standard-form Fr words, a scalar a lane.

    With an int, p's finite lanes must have Z = 1 (points as the codec and
    g1_to_device / g2_to_device make them) and the group's signed-digit
    ladder runs it in one launch, with mixed adds on (X, Y) and (X, -Y) and
    the lanes at infinity flagged: the same group elements as the JAX
    package's double-and-add over adds (with Z2 = 1 a mixed add is the
    add), in other Jacobian words. With words, every step adds on the
    group's formula kernels and a select keeps it where the bit is set (no
    path calls this form)."""
    if isinstance(k, int):
        inf = group.is_inf(p)
        z_one = (p[2] == group.one(p[2])).flatten(0, len(group.coord) - 1).all(dim=0)
        if not bool((z_one | inf).all()):
            raise ValueError("mul_scalar with an int scalar takes points with Z = 1 or at "
                             "infinity")
        return group.ladder((p[0], p[1]), k, inf)
    double, add = group.double, group.add
    acc = inf_like(p)
    for i in range(255, -1, -1):
        acc = double(acc)
        acc = select(scalar_bit(k, i), add(acc, p), acc)
    return acc


def mul_scalar_affine(p_affine, k: torch.Tensor, double=None, madd=None, group=G1):
    """[k] p for affine base points: MSB-first double-and-add with mixed adds
    (curve.py:228-245). p_affine (x, y) (12, n) or (12, 2, n) words; k (8, n)
    standard-form Fr words. Lanes must not be infinite (callers mask them).
    Without ``double`` and ``madd``: the group's signed-digit ladder, one
    launch on CUDA tensors (g1_ladder, g2_ladder; the same group elements,
    other Jacobian words). With them: the 256 steps on those formulas, one
    call of each a step, the JAX package's words (msm.msm_batched_plain; on
    the card K2's wrappers replay the route the ladder kernels replaced)."""
    if double is None and madd is None:
        return group.ladder(p_affine, k)
    double, madd = double or group.double, madd or group.madd
    x, y = p_affine
    acc = inf_like((x, x, x))
    for i in range(255, -1, -1):
        acc = double(acc)
        acc = select(scalar_bit(k, i), madd(acc, (x, y)), acc)
    return acc


def fr_std_words(values, device) -> torch.Tensor:
    """Python-int scalars -> (8, n) standard-form Fr words."""
    return FR.tensor(values, device, mont=False)
