"""kzg_torch's scalar multiplications on the CPU: the plain version of the
ladder kernels (``curve.ladder_plain``, what ``g1_ladder`` / ``g2_ladder``
take on CPU tensors), reached through ``mul_scalar_affine`` (one scalar a
lane) and ``mul_scalar`` with a python-int scalar (one for every lane), on
the case table of ``kzg_torch/utils/mul_cases.py`` for both groups: against
exact python ints, and word for word against the JAX package's
mul_scalar_affine / mul_scalar (``slow``: each compiles a 256-step JAX
program, 25-66 s cold); the routing of the generator multiplication, the
subgroup check and the batched verify through one ladder call a group and no
formula kernel; the operand checks; and chip_smoke.py's bound of the ladder
kernels. Tolerance: exact equality (integer arithmetic)."""

from collections import Counter

import numpy as np
import pytest
import torch

from kzg_torch import G1Point, G2Point, Scalar, convert
from kzg_torch.ops import codec, genmul
from kzg_torch.ops import curve as cv
from kzg_torch.ops.field import FP, FR
from kzg_torch.polynomial import Evaluation, verify_proofs_batch
from kzg_torch.trusted_setup import SetupArtifact
from kzg_torch.utils import hostmath as hm
from kzg_torch.utils import mul_cases

GROUPS = {"G1": cv.G1, "G2": cv.G2}


def _host(group, jac) -> list:
    return group.host_affine(*group.to_affine(jac))


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_affine_cases_match_host(name):
    """mul_scalar_affine on 64 lanes, the case lanes k = 0, 1, r - 1,
    2^256 - 1, r (acc == -P at the last step) and r + 2 (acc == P: the exact
    madd doubles) on lanes 0-5 and k = r + 2 on three lanes of warp 1,
    against [k b] G; the other lanes seeded words."""
    group = GROUPS[name]
    (x, y), k, base = mul_cases.affine_case(group, 64, 7, "cpu")
    got = _host(group, cv.mul_scalar_affine((x, y), k, group=group))
    for lane, want in mul_cases.affine_oracle(group, base).items():
        assert got[lane] == want, (name, lane)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_public_cases_match_host(name):
    """mul_scalar(p, r) on a subgroup point, an infinity lane, an on-curve
    point outside the subgroup and a second subgroup point, against [r] P
    unreduced: infinity but on the third lane. mul_scalar(p, 0) gives the
    zero words."""
    group = GROUPS[name]
    p, pts = mul_cases.public_case(group, 4, 8, "cpu")
    got = _host(group, cv.mul_scalar(p, mul_cases.PUBLIC, group=group))
    assert got == mul_cases.public_oracle(group, pts)
    assert got[2] is not None and got.count(None) == 3
    assert all(not bool(c.any()) for c in cv.mul_scalar(p, 0, group=group))


def _jax_limbs(t):
    import jax.numpy as jnp

    return jnp.asarray(convert.to_jax_limbs(t))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_ladder_plain_bit_identical_to_kzg_tpu(name):
    """Word for word against kzg_tpu's G.mul_scalar_affine on the case lanes
    r - 1, 2^256 - 1, r and r + 2, and its G.mul_scalar (adds on a Jacobian
    base) with r on every lane of public_case's four (the int route takes
    mixed adds: the same words). Slow: each call compiles its 256-step
    loop, 25-66 s with a cold cache; test_affine_cases_match_host and
    test_public_cases_match_host hold the same lanes to the host oracle."""
    from kzg_tpu.ops import curve as jcv

    group = GROUPS[name]
    jgroup = getattr(jcv, name)
    (x, y), k, _ = mul_cases.affine_case(group, 6, 9, "cpu")
    x, y, k = x[..., 2:], y[..., 2:], k[:, 2:]
    got = cv.mul_scalar_affine((x, y), k, group=group)
    want = jgroup.mul_scalar_affine((_jax_limbs(x), _jax_limbs(y)), _jax_limbs(k))
    for g, w in zip(got, want):
        assert np.array_equal(convert.to_jax_limbs(g), np.asarray(w))
    p, _ = mul_cases.public_case(group, 4, 10, "cpu")
    got = cv.mul_scalar(p, mul_cases.PUBLIC, group=group)
    r_words = cv.scalar_on_lanes(hm.R, 4, "cpu").contiguous()
    want = jgroup.mul_scalar(tuple(_jax_limbs(c) for c in p), _jax_limbs(r_words))
    for g, w in zip(got, want):
        assert np.array_equal(convert.to_jax_limbs(g), np.asarray(w))


def _count(monkeypatch, names):
    """Wrap each curve function of ``names`` in a counter; returns the counts."""
    counts = Counter()
    for name in names:
        fn = getattr(cv, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(cv, name, counted)
    return counts


FORMULAS = ["g1_double", "g1_madd", "g1_add", "g2_double", "g2_madd", "g2_add"]


@pytest.mark.parametrize("entry", ["mul_gen_auto", "subgroup check", "verify_proofs_batch"])
def test_scalar_multiplications_run_one_ladder_a_group(monkeypatch, entry):
    """Without generator tables, the generator multiplication of each group
    (genmul.mul_gen_auto), the codec's subgroup check ([r] P) and
    verify_proofs_batch (x G2 and y G1) each make one ladder call a group
    and no call of the point formulas' kernels, but verify's one add of
    each group; the results are hostmath's (a valid opening verifies, a
    wrong y does not)."""
    monkeypatch.setattr(genmul, "_tables", {})
    counts = _count(monkeypatch, ["g1_ladder", "g2_ladder"] + FORMULAS)
    adds = {}
    if entry == "mul_gen_auto":
        k = FR.tensor([3, 10], "cpu", mont=False)
        assert cv.g1_from_device(genmul.mul_g1_gen(k)) == [hm.g1_mul(hm.G1_GEN, 3),
                                                         hm.g1_mul(hm.G1_GEN, 10)]
        assert cv.g2_from_device(genmul.mul_g2_gen(k)) == [hm.g2_mul(hm.G2_GEN, 3),
                                                         hm.g2_mul(hm.G2_GEN, 10)]
    elif entry == "subgroup check":
        for group in (cv.G1, cv.G2):
            jac, _ = mul_cases.public_case(group, 2, 11, "cpu")  # a subgroup point, infinity
            assert codec._check(jac, torch.ones(2, dtype=torch.bool), group, True) is jac
    else:
        s, a, b, xs = 5, 9, 7, [3, 4]  # P(X) = a + b X; the proof of P at x is b G1
        setup = [SetupArtifact(G1Point.from_affine(hm.G1_GEN), G2Point.from_affine(hm.G2_GEN)),
                 SetupArtifact(G1Point.from_affine(hm.g1_mul(hm.G1_GEN, s)),
                               G2Point.from_affine(hm.g2_mul(hm.G2_GEN, s)))]
        c = G1Point.from_affine(hm.g1_mul(hm.G1_GEN, a + b * s))
        pi = G1Point.from_affine(hm.g1_mul(hm.G1_GEN, b))
        evs = [Evaluation(Scalar(x), Scalar(a + b * x + i)) for i, x in enumerate(xs)]
        assert verify_proofs_batch([pi] * 2, [c] * 2, evs, setup, device="cpu") == [True, False]
        adds = {"g1_add": 1, "g2_add": 1}
    assert counts == Counter(g1_ladder=1, g2_ladder=1, **adds)


def test_ladder_checks_operands():
    x = torch.zeros(FP.L, 4, dtype=torch.int32)
    k = torch.zeros(FR.L, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cv.g1_ladder((x, x[:, :3]), k)
    with pytest.raises(ValueError):
        cv.g1_ladder((x, x), k[:, :3])
    with pytest.raises(ValueError):
        cv.g2_ladder((x, x), k)
    with pytest.raises(ValueError):
        cv.g1_ladder((x, x), 5, inf=torch.zeros(3, dtype=torch.bool))
    p = cv.g1_to_device([hm.G1_GEN, None], "cpu")
    doubled = cv.g1_double(p)  # Z = 2 y, not one
    with pytest.raises(ValueError):
        cv.mul_scalar(doubled, 3)
    assert cv.g1_from_device(cv.mul_scalar(p, 3)) == [hm.g1_mul(hm.G1_GEN, 3), None]


def test_mul_cost_counts_what_the_scalar_multiplication_needs():
    """chip_smoke.py's bound for the ladder kernels counts, a live lane with
    k != 0, bitlen(k) - 1 doublings and the fewer mixed adds of the lane's
    own ladder (popcount - 1) and a fixed 4-bit window (a 14-point table,
    then one a non-zero window below the top one): k = 11 (0b1011), 3
    doublings and 2 madds; k = 2^256 - 1, 255 doublings and 14 + 63 madds;
    k = 2^255 + 1, 255 and 1; a flagged lane and k = 0 nothing. Its chain:
    a doubling a step from the top set bit of any lane, a madd a step where
    some lane has the bit."""
    import chip_smoke as cs

    full = (1 << 256) - 1
    nbytes, ops = cs.mul_cost([11, full, (1 << 255) + 1, 0], 5, True, False)
    assert ops == ((3 + 255 + 255) * cs.G1_DBL_OPS + (2 + 77 + 1) * cs.G1_MADD_OPS)
    assert nbytes == 5 * (2 * 48 + 32 + 1) + 5 * 3 * 48
    assert cs.mul_cost([11], 1, False, True)[1] == 3 * cs.G2_DBL_OPS + 2 * cs.G2_MADD_OPS
    assert cs.mul_chain([11, 4]) == {"doubles": 4, "madds": 4}
    assert cs.mul_chain([]) == {"doubles": 0, "madds": 0}
