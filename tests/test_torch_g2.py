"""kzg_torch's Fp2 and G2 on the CPU: ``ops/fp2.py`` and the plain versions
of K9 (``curve.g2_*_plain``) bit for bit against kzg_tpu.ops.fp2 and
kzg_tpu.ops.curve.G2 (JAX on the CPU, run eagerly), on seeded words and on
the exceptional lanes of ``kzg_torch/utils/g2_cases.py``; the case lanes,
the G2 generator multiplication by both routes (the 256-step ladder and the
window tables), the affine conversion and the scalar multiplication
against exact python ints. Tolerance: exact equality (integer arithmetic)."""

import numpy as np
import pytest
import torch

from kzg_torch import convert
from kzg_torch.ops import curve as cv
from kzg_torch.ops import fp2, genmul
from kzg_torch.ops.field import FP, FR
from kzg_torch.utils import g2_cases
from kzg_torch.utils import hostmath as hm

SEED = 20240
N = 16


def _rand2(n, seed):
    """(12, 2, n) canonical words from a numpy seed."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(FP.L, 2, n), dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(hm.P >> (32 * (FP.L - 1)))
    return torch.from_numpy(w.view(np.int32))


def _jax(t):
    import jax.numpy as jnp

    return jnp.asarray(convert.to_jax_limbs(t))


def _same(got, want) -> bool:
    if isinstance(got, tuple):
        return len(got) == len(want) and all(_same(g, w) for g, w in zip(got, want))
    return np.array_equal(convert.to_jax_limbs(got), np.asarray(want))


def test_fp2_bit_identical_to_kzg_tpu():
    """Every Fp2 operation on 16 seeded lanes, lane 0 of a zero (inv maps it
    to zero), lane 1 of b equal to a (eq, select)."""
    from kzg_tpu.ops import fp2 as jfp2

    a, b, k = _rand2(N, 1), _rand2(N, 2), _rand2(N, 3)[:, 0]
    a[..., 0] = 0
    b[..., 1] = a[..., 1]
    ja, jb, jk = _jax(a), _jax(b), _jax(k)
    for name in ("add", "sub", "mul"):
        assert _same(getattr(fp2, name)(a, b), getattr(jfp2, name)(ja, jb)), name
    for name in ("neg", "dbl", "square", "conj", "inv"):
        assert _same(getattr(fp2, name)(a), getattr(jfp2, name)(ja)), name
    assert _same(fp2.mul_by_fp(a, k), jfp2.mul_by_fp(ja, jk))
    assert np.array_equal(fp2.is_zero(a).numpy(), np.asarray(jfp2.is_zero(ja)))
    assert np.array_equal(fp2.eq(a, b).numpy(), np.asarray(jfp2.eq(ja, jb)))
    mask = torch.arange(N) % 3 == 0
    assert _same(fp2.select(mask, a, b), jfp2.select(mask.numpy(), ja, jb))
    assert _same(fp2.one(a), np.broadcast_to(jfp2.one(ja), ja.shape))
    assert fp2.to_ints(fp2.pow_const(a, 5)) == [
        hm.fp2_mul(hm.fp2_sq(hm.fp2_sq(v)), v) for v in fp2.to_ints(a)]


@pytest.fixture(scope="module")
def case_operands():
    return g2_cases.case_points(N, SEED, "cpu")


def test_g2_formulas_bit_identical_to_kzg_tpu(case_operands):
    """The plain double, add and madd against JAX's G2 (eager) on the case
    table's lanes and seeded words."""
    from kzg_tpu.ops.curve import G2

    p, q, qa = case_operands
    jp, jq, jqa = (tuple(_jax(c) for c in pt) for pt in (p, q, qa))
    assert _same(cv.g2_double_plain(p), G2.double(jp))
    assert _same(cv.g2_add_plain(p, q), G2.add(jp, jq))
    assert _same(cv.g2_madd_plain(p, qa), G2.madd(jp, jqa))


@pytest.mark.parametrize("op", ["double", "add", "madd"])
def test_g2_cases_hold_their_exceptional_lanes(case_operands, op):
    """Each case lane against the host oracle; the wrappers on CPU tensors
    take the plain versions."""
    p, q, qa = case_operands
    got = {"double": lambda: cv.g2_double(p), "add": lambda: cv.g2_add(p, q),
           "madd": lambda: cv.g2_madd(p, qa)}[op]()
    plain = {"double": lambda: cv.g2_double_plain(p), "add": lambda: cv.g2_add_plain(p, q),
             "madd": lambda: cv.g2_madd_plain(p, qa)}[op]()
    assert all(torch.equal(g, w) for g, w in zip(got, plain))
    aff = cv.g2_from_device(tuple(c[..., : g2_cases.CASE_LANES] for c in got))
    for lane, want in g2_cases.oracle(SEED, op).items():
        assert aff[lane] == want, (op, g2_cases.CASES[lane])


def test_g2_affine_and_device_round_trip():
    """g2_to_device / g2_from_device and the batched affine conversion,
    an infinity lane included, against host points."""
    pts = [hm.g2_mul(hm.G2_GEN, k) for k in (1, 2, 77)] + [None]
    jac = cv.g2_to_device(pts, "cpu")
    assert cv.g2_from_device(jac) == pts
    lam = fp2.tensor([(3, 5)] * 4, "cpu")
    lam2 = fp2.square(lam)
    scaled = (fp2.mul(jac[0], lam2), fp2.mul(jac[1], fp2.mul(lam, lam2)), fp2.mul(jac[2], lam))
    (x, y), inf = cv.g2_to_affine(scaled)
    assert inf.tolist() == [False, False, False, True]
    assert [(a, b) for a, b in zip(fp2.to_ints(x), fp2.to_ints(y))][:3] == pts[:3]
    assert fp2.to_ints(x)[3] == fp2.to_ints(y)[3] == (0, 0)
    neg = cv.neg(jac)
    assert cv.g2_from_device(neg) == [hm.g2_neg(pt) for pt in pts]


KS = [0, 1, 2, hm.R - 1, 255, 256, 0x5D2A13FC6B4E8D0F9A7C3B1E6F2D4A8B0C9E7F1A3B5D7C9E1F3A5B7C9D1E3F5A]


def test_mul_g2_gen_both_routes_match_hostmath(monkeypatch):
    """mul_g2_gen below the threshold without tables (the generator
    ladder's plain version: the scalar's 4-bit pieces on constant bases),
    then through the window tables (seven madds and one affine conversion
    to build, then the fold): the same points as hostmath's k G2. The G2
    tables live beside G1's under their own key."""
    monkeypatch.setattr(genmul, "_tables", {})
    k = FR.tensor(KS, "cpu", mont=False)
    want = [hm.g2_mul(hm.G2_GEN, v) for v in KS]
    assert cv.g2_from_device(genmul.mul_g2_gen(k)) == want
    assert not genmul.tables_built("cpu", cv.G2)
    tx, ty = genmul.gen_tables("cpu", cv.G2)
    assert tx.shape == ty.shape == (FP.L, 2, genmul.GEN_WINDOWS, genmul.GEN_ENTRIES)
    assert genmul.tables_built("cpu", cv.G2) and not genmul.tables_built("cpu", cv.G1)
    assert fp2.to_ints(tx[:, :, 31, 1:2]) == [hm.g2_mul(hm.G2_GEN, 1 << 248)[0]]
    assert fp2.to_ints(tx[:, :, 0, 0:1]) == fp2.to_ints(ty[:, :, 0, 0:1]) == [(0, 0)]
    assert cv.g2_from_device(genmul.mul_g2_gen(k)) == want
    one = genmul.mul_gen(FR.tensor([7], "cpu", mont=False)[:, 0], group=cv.G2)
    assert one[0].shape == (FP.L, 2)
    assert cv.g2_from_device(tuple(c[..., None] for c in one)) == [hm.g2_mul(hm.G2_GEN, 7)]


def test_mul_scalar_both_forms_match_hostmath():
    """mul_scalar with a Jacobian base, one scalar a lane (words) and one
    scalar for every lane (a python int), against hostmath; an infinity
    lane stays infinity."""
    pts = [hm.g1_mul(hm.G1_GEN, k) for k in (3, 1 << 200)] + [None]
    p = cv.g1_to_device(pts, "cpu")
    ks = [5, hm.R - 1, 9]
    got = cv.g1_from_device(cv.mul_scalar(p, FR.tensor(ks, "cpu", mont=False)))
    assert got == [hm.g1_mul(pt, k) if pt else None for pt, k in zip(pts, ks)]
    assert cv.g1_from_device(cv.mul_scalar(p, 6)) == [hm.g1_mul(pt, 6) if pt else None
                                                      for pt in pts]
    assert cv.g1_from_device(cv.mul_scalar(p, 0)) == [None] * 3
    q = cv.g2_to_device([hm.G2_GEN, None], "cpu")
    assert cv.g2_from_device(cv.mul_scalar(q, 11, group=cv.G2)) == [
        hm.g2_mul(hm.G2_GEN, 11), None]
