"""kzg_torch G1 layer on the CPU: the plain versions of K2 bit for bit
against kzg_tpu.ops.curve.G1 (XLA on the CPU), exceptional lanes included,
and the ladder and affine conversion against exact python ints.
Tolerance: exact equality (integer arithmetic)."""

import numpy as np
import pytest
import torch

from kzg_torch import convert
from kzg_torch.ops import curve as cv
from kzg_torch.ops.field import FP
from kzg_torch.utils import hostmath as hm

N = 64


def _random_points(n, seed):
    rng = np.random.default_rng(seed)
    ks = [int(k) + 2 for k in rng.integers(0, 1 << 62, size=n)]
    return [hm.g1_mul(hm.G1_GEN, k) for k in ks], rng


def _jacobian(points, zs):
    """Host affine points -> Jacobian words with the given Z (None -> infinity)."""
    xs, ys, out_z = [], [], []
    for p, z in zip(points, zs):
        if p is None:
            xs.append(0); ys.append(0); out_z.append(0)
        else:
            xs.append(p[0] * z * z % hm.P); ys.append(p[1] * z * z * z % hm.P); out_z.append(z)
    return tuple(FP.tensor(v, "cpu") for v in (xs, ys, out_z))


@pytest.fixture(scope="module")
def lanes():
    """p, q (Jacobian, random Z) and q_affine over 64 lanes: 0-3 P == Q (other
    Z), 4-7 P == -Q, 8-11 P at infinity, 12-15 Q at infinity, 16-19 both."""
    pts, rng = _random_points(2 * N, 11)
    p_aff, q_aff = pts[:N], pts[N:]
    for i in range(4):
        q_aff[i] = p_aff[i]
        q_aff[4 + i] = hm.g1_neg(p_aff[4 + i])
    zp = [int(z) % hm.P + 1 for z in rng.integers(0, 1 << 62, size=N)]
    zq = [int(z) % hm.P + 1 for z in rng.integers(0, 1 << 62, size=N)]
    p_host = [None if 8 <= i < 12 or 16 <= i < 20 else pt for i, pt in enumerate(p_aff)]
    q_host = [None if 12 <= i < 20 else pt for i, pt in enumerate(q_aff)]
    p = _jacobian(p_host, zp)
    q = _jacobian(q_host, zq)
    qa = (FP.tensor([pt[0] for pt in q_aff], "cpu"), FP.tensor([pt[1] for pt in q_aff], "cpu"))
    return {"p": p, "q": q, "qa": qa, "p_host": p_host, "q_host": q_host, "q_aff": q_aff}


@pytest.fixture(scope="module")
def jax_g1():
    """The JAX package's G1 formulas, run eagerly: they then share the JAX
    package's compiled Fp operations (each jitted at its method boundary)
    instead of compiling one program each, about a tenth of the time on one
    CPU core; the words they return are the same."""
    from kzg_tpu.ops.curve import G1

    return {"double": G1.double, "add": G1.add, "madd": G1.madd}


def _to_jax(p):
    import jax.numpy as jnp

    return tuple(jnp.asarray(convert.to_jax_limbs(c)) for c in p)


def _from_jax(p):
    return tuple(convert.from_jax_limbs(np.asarray(c), "cpu") for c in p)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_double_bit_identical_to_kzg_tpu(lanes, jax_g1):
    got = cv.g1_double(lanes["p"])
    _assert_same(got, _from_jax(jax_g1["double"](_to_jax(lanes["p"]))))
    want = [hm.g1_add(pt, pt) for pt in lanes["p_host"]]
    assert cv.g1_from_device(got) == want


def test_add_bit_identical_to_kzg_tpu(lanes, jax_g1):
    got = cv.g1_add(lanes["p"], lanes["q"])
    _assert_same(got, _from_jax(jax_g1["add"](_to_jax(lanes["p"]), _to_jax(lanes["q"]))))
    want = [hm.g1_add(a, b) for a, b in zip(lanes["p_host"], lanes["q_host"])]
    assert cv.g1_from_device(got) == want


def test_madd_bit_identical_to_kzg_tpu(lanes, jax_g1):
    got = cv.g1_madd(lanes["p"], lanes["qa"])
    _assert_same(got, _from_jax(jax_g1["madd"](_to_jax(lanes["p"]), _to_jax(lanes["qa"]))))
    want = [hm.g1_add(a, b) for a, b in zip(lanes["p_host"], lanes["q_aff"])]
    assert cv.g1_from_device(got) == want


def test_madd_fast_flags_exactly_the_doubling_lanes(lanes):
    exact = cv.g1_madd(lanes["p"], lanes["qa"])
    fast, need = cv.g1_madd(lanes["p"], lanes["qa"], fast=True)
    assert need.tolist() == [i < 4 for i in range(N)]
    keep = ~need
    for e, f in zip(exact, fast):
        assert torch.equal(e[:, keep], f[:, keep])


def test_to_affine_and_device_round_trip(lanes):
    (x, y), inf = cv.to_affine(lanes["p"])
    assert inf.tolist() == [pt is None for pt in lanes["p_host"]]
    assert not bool(x[:, inf].any()) and not bool(y[:, inf].any())  # (0, 0)
    got = cv.g1_from_device((x, y, FP.select(inf, torch.zeros_like(x), FP.one_like(x))))
    assert got == lanes["p_host"]
    assert cv.g1_from_device(cv.g1_to_device(lanes["p_host"], "cpu")) == lanes["p_host"]
    assert cv.g1_from_device(cv.neg(lanes["p"])) == [hm.g1_neg(pt) for pt in lanes["p_host"]]


def test_mul_scalar_affine_matches_host():
    pts, _ = _random_points(3, 12)
    ks = [hm.R - 1, 0x1234567890ABCDEF1234567890ABCDEF, 1]
    x, y, _ = cv.g1_to_device(pts, "cpu")
    got = cv.mul_scalar_affine((x, y), cv.fr_std_words(ks, "cpu"))
    assert cv.g1_from_device(got) == [hm.g1_mul(p, k) for p, k in zip(pts, ks)]
    zero = cv.mul_scalar_affine((x[:, :1], y[:, :1]), cv.fr_std_words([0], "cpu"))
    assert cv.g1_from_device(zero) == [None]


def test_point_wrappers_check_shapes(lanes):
    p = lanes["p"]
    with pytest.raises(ValueError):
        cv._flat((p[0], p[1][:, :3], p[2]))
