"""kzg_torch's pairing and verification on the CPU: the plain Miller loop
steps against kzg_tpu's (JAX on the CPU, run eagerly), one batched plain
pairing against kzg_tpu.utils.hostmath.pairing (a seeded pair, the
generator pair, infinity lanes), ``bilinear_map``, the hard part's integer
identity, and one ``verify_proofs_batch`` call with a valid item, three
tampered ones and a constant polynomial, plus its two ProtocolErrors.
Tolerance: exact equality (canonical words, the oracle's ints).

The comparisons with kzg_tpu's device pairing, ``bilinear_map`` and
``verify_proofs_batch`` on the same inputs are ``slow`` (minutes of JAX
compile with a cold cache); each has a tier-1 twin above it. On a CPU
tensor the wrappers (``pairing.miller_loop``, ``final_exponentiation``)
take their plain versions, so these tests run the plain route."""

import random

import numpy as np
import pytest
import torch

from kzg_torch import G1Point, G2Point, ProtocolError, Scalar, bilinear_map, convert
from kzg_torch.ops import curve as cv
from kzg_torch.ops import fp2, fp12
from kzg_torch.ops import pairing as pr
from kzg_torch.ops.field import FP
from kzg_torch.polynomial import Evaluation, verify_proofs_batch
from kzg_torch.trusted_setup import SetupArtifact
from kzg_torch.utils import hostmath as hm

SETUP_SECRET = 99991  # kzg_tpu's tests/test_pairing.py setup6
SETUP_N = 6


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(FP.L,) + shape, dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(hm.P >> (32 * (FP.L - 1)))
    return torch.from_numpy(w.view(np.int32))


def _jax(t):
    import jax.numpy as jnp

    return jnp.asarray(convert.to_jax_limbs(t))


def _same(got, want) -> bool:
    return np.array_equal(convert.to_jax_limbs(got), np.asarray(want))


def _same_line(got, want) -> bool:
    """A line as an Fp12 tensor against kzg_tpu's nested tuple."""
    flat = np.stack([np.stack([np.asarray(c) for c in c6], axis=2) for c6 in want], axis=3)
    return np.array_equal(convert.to_jax_limbs(got), flat)


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_steps_bit_identical_to_kzg_tpu(step):
    """One doubling step and one addition step on 4 seeded lanes: T random
    Jacobian words, Q the G2 generator, P random words."""
    from kzg_tpu.ops import pairing as jpr

    T = tuple(_rand((2, 4), s) for s in (1, 2, 3))
    xP, yP = _rand((4,), 4), _rand((4,), 5)
    Q = cv.g2_gen_affine("cpu", 4)
    jT, jQ = tuple(_jax(c) for c in T), tuple(_jax(c) for c in Q)
    if step == "dbl":
        got, want = pr._dbl_step(T, xP, yP), jpr._dbl_step(jT, _jax(xP), _jax(yP))
    else:
        got, want = pr._add_step(T, Q, xP, yP), jpr._add_step(jT, jQ, _jax(xP), _jax(yP))
    assert all(_same(g, w) for g, w in zip(got[0], want[0]))
    assert _same_line(got[1], want[1])


def _pairing_lanes():
    """(P, Q) lanes: a seeded pair, the generators, P at infinity, Q at
    infinity."""
    rnd = random.Random(3)
    p = hm.g1_mul(hm.G1_GEN, rnd.randrange(1, hm.R))
    q = hm.g2_mul(hm.G2_GEN, rnd.randrange(1, hm.R))
    return [p, hm.G1_GEN, None, hm.G1_GEN], [q, hm.G2_GEN, hm.G2_GEN, None]


def _pair(ps, qs, device="cpu"):
    x1, y1, z1 = cv.g1_to_device(ps, device)
    x2, y2, z2 = cv.g2_to_device(qs, device)
    return pr.pairing((x1, y1), FP.is_zero(z1), (x2, y2), fp2.is_zero(z2))


def test_plain_pairing_equals_oracle():
    """One batched plain pairing (4 lanes) against kzg_tpu's integer oracle:
    the pairs' canonical GT values, one on the infinity lanes."""
    from kzg_tpu.utils import hostmath as jhm

    ps, qs = _pairing_lanes()
    got = fp12.to_ints_many(_pair(ps, qs))
    assert got[:2] == [jhm.pairing(p, q) for p, q in zip(ps[:2], qs[:2])]
    assert got[2:] == [jhm.FP12_ONE] * 2


def test_bilinear_map_equals_oracle():
    rnd = random.Random(5)
    a, b = rnd.randrange(2, 1000), rnd.randrange(2, 1000)
    p, q = hm.g1_mul(hm.G1_GEN, a), hm.g2_mul(hm.G2_GEN, b)
    got = bilinear_map(G1Point.from_affine(p), G2Point.from_affine(q), device="cpu")
    assert got == hm.pairing(p, q)


def test_hard_part_decomposition_exact():
    """The canonical hard-part chain's integer identity (host ints)."""
    p, r, x = hm.P, hm.R, hm.BLS_X
    z = -x
    assert (z - 1) ** 2 % 3 == 0
    e = (z - 1) ** 2 // 3
    assert e == pr._E_HARD
    assert sum(b << i for i, b in enumerate(pr._E_BITS)) == e
    assert sum(b << i for i, b in enumerate(pr._X_BITS)) == x
    assert (p**4 - p**2 + 1) % r == 0
    assert e * (z + p) * (z * z + p * p - 1) + 1 == (p**4 - p**2 + 1) // r


def test_kernel_constants_match_the_exponents():
    """csrc/pairing.cu's constants are |x| and (|x| + 1)^2 / 3."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(pr.__file__), "..", "csrc", "pairing.cu")).read()
    consts = re.findall(r"constexpr unsigned long long (\w+) = (0x[0-9a-f]+)", src)
    val = {k: int(v, 16) for k, v in consts}
    bits = {k: int(v) for k, v in re.findall(r"constexpr int (\w+Bits) = (\d+);", src)}
    assert val["kBlsX"] == hm.BLS_X and bits["kBlsXBits"] == len(pr._X_BITS)
    assert (val["kEHardHi"] << 64) | val["kEHardLo"] == pr._E_HARD
    assert bits["kEHardBits"] == len(pr._E_BITS)


def _setup():
    """generate_setup(99991, 6)'s items from the host oracle (the port's
    generate_setup gives these points: tests/test_torch_setup.py)."""
    pw = [pow(SETUP_SECRET, k, hm.R) for k in range(SETUP_N)]
    return [SetupArtifact(G1Point.from_affine(hm.g1_mul(hm.G1_GEN, s)),
                          G2Point.from_affine(hm.g2_mul(hm.G2_GEN, s))) for s in pw]


def _items():
    """(proof, commitment, evaluation) host points of 5 openings: valid, a
    wrong y, pi + G1, C + G1, a constant polynomial (pi at infinity)."""
    rnd = random.Random(9)
    s, out = SETUP_SECRET, []
    for k in range(5):
        coeffs = [rnd.randrange(hm.R) for _ in range(5)] if k < 4 else [42]
        x = rnd.randrange(hm.R)
        y = sum(c * pow(x, i, hm.R) for i, c in enumerate(coeffs)) % hm.R
        ps = sum(c * pow(s, i, hm.R) for i, c in enumerate(coeffs)) % hm.R
        c, pi = hm.g1_mul(hm.G1_GEN, ps), hm.g1_mul(hm.G1_GEN, (ps - y) * pow(s - x, -1, hm.R))
        if k == 1:
            y = (y + 1) % hm.R
        if k == 2:
            pi = hm.g1_add(pi, hm.G1_GEN)
        if k == 3:
            c = hm.g1_add(c, hm.G1_GEN)
        out.append((pi, c, x, y))
    return out


def test_verify_proofs_batch_on_cpu():
    setup = _setup()
    items = _items()
    proofs = [G1Point.from_affine(i[0]) for i in items]
    comms = [G1Point.from_affine(i[1]) for i in items]
    evs = [Evaluation(Scalar(i[2]), Scalar(i[3])) for i in items]
    assert items[4][0] is None
    assert verify_proofs_batch(proofs, comms, evs, setup, device="cpu") == [True, False, False,
                                                                            False, True]
    with pytest.raises(ProtocolError, match="At least 2 setup artifacts"):
        verify_proofs_batch(proofs, comms, evs, setup[:1], device="cpu")
    with pytest.raises(ProtocolError, match="length mismatch"):
        verify_proofs_batch(proofs, comms[:4], evs, setup, device="cpu")
    assert verify_proofs_batch([], [], [], setup, device="cpu") == []


@pytest.mark.slow
def test_pairing_matches_kzg_tpu_device_pairing():
    """kzg_tpu's device pairing (JAX on the CPU) on the same lanes: the same
    words. Twin: test_plain_pairing_equals_oracle."""
    import jax.numpy as jnp
    from kzg_tpu.ops import pairing as jpr

    ps, qs = _pairing_lanes()
    x1, y1, z1 = cv.g1_to_device(ps, "cpu")
    x2, y2, z2 = cv.g2_to_device(qs, "cpu")
    want = jpr.pairing((_jax(x1), _jax(y1)), jnp.asarray(FP.is_zero(z1).numpy()),
                       (_jax(x2), _jax(y2)), jnp.asarray(fp2.is_zero(z2).numpy()))
    assert _same_line(_pair(ps, qs), want)


@pytest.mark.slow
def test_bilinear_map_matches_kzg_tpu():
    """Twin: test_bilinear_map_equals_oracle."""
    from kzg_tpu import G1Point as JG1, G2Point as JG2, bilinear_map as jbilinear

    rnd = random.Random(5)
    a, b = rnd.randrange(2, 1000), rnd.randrange(2, 1000)
    got = bilinear_map(G1Point.from_affine(hm.g1_mul(hm.G1_GEN, a)),
                       G2Point.from_affine(hm.g2_mul(hm.G2_GEN, b)), device="cpu")
    assert got == jbilinear(JG1.from_i128(a), JG2.from_i128(b))


@pytest.mark.slow
def test_verify_proofs_batch_matches_kzg_tpu():
    """kzg_tpu's verify_proofs_batch on its own generate_setup(99991, 6) and
    the same items: the same verdicts. Twin: test_verify_proofs_batch_on_cpu."""
    from kzg_tpu import G1Point as JG1, Scalar as JScalar, generate_setup
    from kzg_tpu.polynomial import Evaluation as JEvaluation
    from kzg_tpu.polynomial import verify_proofs_batch as jverify

    setup = generate_setup(JScalar.from_be_bytes(SETUP_SECRET.to_bytes(32, "big")), SETUP_N)
    assert [(a.g1.affine(), a.g2.affine()) for a in setup] == [
        (a.g1.affine(), a.g2.affine()) for a in _setup()]
    items = _items()
    evs = [JEvaluation(JScalar.from_int(i[2]), JScalar.from_int(i[3])) for i in items]
    want = jverify([JG1.from_affine(i[0]) for i in items], [JG1.from_affine(i[1]) for i in items],
                   evs, setup)
    assert want == [True, False, False, False, True]
