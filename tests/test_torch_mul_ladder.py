"""kzg_torch's scalar multiplications on the CPU: the plain versions of the
ladder kernels' two modes, which ``g1_ladder`` / ``g2_ladder`` (Mode A, the
signed-digit ladder) and ``g1_gen_ladder`` / ``g2_gen_ladder`` (Mode B, the
generator's scalar split into pieces) take on CPU tensors. Mode A is reached
through ``mul_scalar_affine`` (one scalar a lane) and ``mul_scalar`` with a
python-int scalar (one for every lane), Mode B through
``genmul.mul_gen_auto``. The NAF recoding against its identity; both modes
on the case table of ``kzg_torch/utils/mul_cases.py`` for both groups
against exact python ints, by group element (the Jacobian words differ
from the JAX package's binary ladder: every caller reduces the result to
an affine point or an infinity flag), and against the JAX package's
mul_scalar_affine / mul_scalar after the affine conversion (``slow``: each
compiles a 256-step JAX program, 25-66 s cold); Mode B's constant bases;
the routing of the generator multiplication, the subgroup check and the
batched verify through one ladder call a group and no formula kernel; the
operand checks; and chip_smoke.py's bound and chain of the ladder kernels.
Tolerance: exact equality (integer arithmetic)."""

from collections import Counter

import numpy as np
import pytest
import torch

from kzg_torch import G1Point, G2Point, Scalar, convert
from kzg_torch.errors import SerializationError
from kzg_torch.ops import codec, genmul
from kzg_torch.ops import curve as cv
from kzg_torch.ops import limbs as lb
from kzg_torch.ops.field import FP, FR
from kzg_torch.polynomial import Evaluation, verify_proofs_batch
from kzg_torch.trusted_setup import SetupArtifact
from kzg_torch.utils import hostmath as hm
from kzg_torch.utils import mul_cases

GROUPS = {"G1": cv.G1, "G2": cv.G2}


def _host(group, jac) -> list:
    return group.host_affine(*group.to_affine(jac))


def _seeded_scalars(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") >> int(rng.integers(0, 256))
            for _ in range(n)]


@pytest.mark.parametrize("which", ["cases", "seeded"])
def test_naf_recoding_holds_its_identity(which):
    """naf_int and the device pass naf_words give the same masks, and they
    are a NAF: plus - minus = k, no digit in both, no two adjacent non-zero
    digits, the top digit at most bit 256 (NAF_WORDS words). On 0, 1,
    r - 1, r, r + 2, r - 2, 2^256 - 1 and Mode B's doubling scalar, or on
    seeded scalars of every length. r has weight 60: 59 madds after the
    first digit, against 133 for its 134 set bits."""
    ks = list(mul_cases.SCALARS) if which == "cases" else _seeded_scalars(3, 200)
    plus, minus = cv.naf_words(torch.from_numpy(lb.ints_to_words(ks, FR.L)))
    assert plus.shape == minus.shape == (cv.NAF_WORDS, len(ks))
    for k, p, m in zip(ks, lb.words_to_ints(plus), lb.words_to_ints(minus)):
        assert (p, m) == cv.naf_int(k)
        assert p - m == k and p & m == 0 and (p | m) & ((p | m) >> 1) == 0
        assert (p | m).bit_length() <= k.bit_length() + 1 <= 257
    p, m = cv.naf_int(hm.R)
    assert bin(p).count("1") + bin(m).count("1") == 60 and bin(hm.R).count("1") == 134
    assert cv.naf_int((1 << 256) - 1) == (1 << 256, 1)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_affine_cases_match_host(name):
    """Mode A through mul_scalar_affine on 64 lanes: the case lanes k = 0,
    1, r - 1, 2^256 - 1 (NAF top digit 256), r (acc == -P at the last step),
    r + 2, r - 2 (acc == -P and digit -1: the exact madd doubles) and Mode
    B's doubling scalar on lanes 0-7 and k = r - 2 on three lanes of warp 1,
    against [k b] G by group element; the other lanes seeded words."""
    group = GROUPS[name]
    (x, y), k, base = mul_cases.affine_case(group, 64, 7, "cpu")
    got = _host(group, cv.mul_scalar_affine((x, y), k, group=group))
    for lane, want in mul_cases.affine_oracle(group, base).items():
        assert got[lane] == want, (name, lane)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_public_cases_match_host(name):
    """Mode A with one scalar, mul_scalar(p, r), on a subgroup point, an
    infinity lane, an on-curve point outside the subgroup, a second
    subgroup point, and (G1) the point (0, 2) of order 3, which meets acc ==
    P, acc == -P and infinity inside the ladder, or (G2) the off-subgroup
    point's negative: against [r] P unreduced, infinity but on the points
    outside the subgroup. mul_scalar(p, 0) gives the zero words."""
    group = GROUPS[name]
    p, pts = mul_cases.public_case(group, 5, 8, "cpu")
    got = _host(group, cv.mul_scalar(p, mul_cases.PUBLIC, group=group))
    assert got == mul_cases.public_oracle(group, pts)
    assert got[2] is not None and got[4] is not None and got.count(None) == 3
    assert name == "G2" or got[4] == (0, 2)  # r = 1 mod 3
    assert all(not bool(c.any()) for c in cv.mul_scalar(p, 0, group=group))


def test_subgroup_check_rejects_a_point_of_order_3():
    """A G1 batch holding (0, 2), of order 3, beside subgroup points and
    infinity fails the subgroup check with kzg_tpu's message; without
    the check it decodes (G2's rejection: test_torch_codec.py)."""
    pts = [hm.g1_mul(hm.G1_GEN, 5), None, (0, 2)]
    blobs = [hm.g1_compress(pt) for pt in pts]
    with pytest.raises(SerializationError, match="Point not in the prime-order subgroup"):
        codec.g1_decompress_batch(blobs, subgroup_check=True, device="cpu")
    assert cv.g1_from_device(codec.g1_decompress_batch(blobs, device="cpu")) == pts


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_gen_ladder_cases_match_host(name):
    """Mode B (gen_ladder_plain, what g1_gen_ladder / g2_gen_ladder take on
    the CPU) on 36 lanes: the case scalars 0, 1, r - 1, 2^256 - 1, r (the
    last level adds -Q to Q), r + 2, r - 2 and SPLIT_DOUBLE (whose halves
    are one group element: the last level doubles), then seeded 256-bit
    scalars, not reduced: [k mod r] G on every lane."""
    group = GROUPS[name]
    k = mul_cases.gen_case(36, 12, "cpu")
    assert _host(group, group.gen_ladder(k)) == mul_cases.gen_oracle(group, k, range(36))
    low = mul_cases.SPLIT_DOUBLE % (1 << 128)
    assert (mul_cases.SPLIT_DOUBLE - low) % hm.R == low


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_split_bases_match_hostmath(name):
    """Mode B's constant bases [2^(4 j)] G, j < 64, on the device as the
    group's affine words: hostmath's, and gen_pow2 is 2^j G."""
    group = GROUPS[name]
    bx, by = cv.split_bases(group, "cpu")
    assert bx.shape == by.shape == group.coord + (cv.GEN_SPLIT_PIECES,)
    mul = hm.g1_mul if name == "G1" else hm.g2_mul
    want = [mul(group.gen, 1 << (cv.GEN_SPLIT_BITS * j)) for j in range(cv.GEN_SPLIT_PIECES)]
    assert list(zip(group.to_ints(bx), group.to_ints(by))) == want
    assert cv.gen_pow2(group)[255] == mul(group.gen, 1 << 255)


def _jax_limbs(t):
    import jax.numpy as jnp

    return jnp.asarray(convert.to_jax_limbs(t))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_ladder_plain_bit_identical_to_kzg_tpu(name):
    """Against kzg_tpu's G.mul_scalar_affine on the case lanes r - 1,
    2^256 - 1, r, r + 2, r - 2 and SPLIT_DOUBLE, and its G.mul_scalar (adds
    on a Jacobian base) with r on every lane of public_case's five: the same
    affine points and infinity flags (the signed-digit ladder's Jacobian
    words are not the binary ladder's). Slow: each call compiles its
    256-step loop, 25-66 s with a cold cache; test_affine_cases_match_host
    and test_public_cases_match_host hold the same lanes to the host
    oracle."""
    from kzg_tpu.ops import curve as jcv

    group = GROUPS[name]
    jgroup = getattr(jcv, name)

    def affine(jac):
        (x, y), inf = group.to_affine(jac)
        return [np.asarray(convert.to_jax_limbs(c)) for c in (x, y)], inf.numpy()

    def jax_affine(jac):
        return affine(tuple(convert.from_jax_limbs(np.asarray(c), "cpu") for c in jac))

    (x, y), k, _ = mul_cases.affine_case(group, 8, 9, "cpu")
    x, y, k = x[..., 2:], y[..., 2:], k[:, 2:]
    got = affine(cv.mul_scalar_affine((x, y), k, group=group))
    want = jax_affine(jgroup.mul_scalar_affine((_jax_limbs(x), _jax_limbs(y)), _jax_limbs(k)))
    for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
        assert np.array_equal(g, w)
    p, _ = mul_cases.public_case(group, 5, 10, "cpu")
    got = affine(cv.mul_scalar(p, mul_cases.PUBLIC, group=group))
    r_words = torch.from_numpy(lb.ints_to_words([hm.R] * 5, FR.L))
    want = jax_affine(jgroup.mul_scalar(tuple(_jax_limbs(c) for c in p), _jax_limbs(r_words)))
    for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
        assert np.array_equal(g, w)


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
LADDERS = ["g1_ladder", "g2_ladder", "g1_gen_ladder", "g2_gen_ladder"]


@pytest.mark.parametrize("entry", ["mul_gen_auto", "subgroup check", "verify_proofs_batch"])
def test_scalar_multiplications_run_one_ladder_a_group(monkeypatch, entry):
    """Without generator tables, the generator multiplication of each group
    (genmul.mul_gen_auto, Mode B), the codec's subgroup check ([r] P, Mode
    A) and verify_proofs_batch (x G2 and y G1, Mode B) each make one ladder
    call a group and no call of the point formulas' kernels, but verify's
    one add of each group; the results are hostmath's (a valid opening
    verifies, a wrong y does not)."""
    monkeypatch.setattr(genmul, "_tables", {})
    counts = _count(monkeypatch, LADDERS + FORMULAS)
    adds = {}
    if entry == "mul_gen_auto":
        k = FR.tensor([3, 10], "cpu", mont=False)
        assert cv.g1_from_device(genmul.mul_g1_gen(k)) == [hm.g1_mul(hm.G1_GEN, 3),
                                                         hm.g1_mul(hm.G1_GEN, 10)]
        assert cv.g2_from_device(genmul.mul_g2_gen(k)) == [hm.g2_mul(hm.G2_GEN, 3),
                                                         hm.g2_mul(hm.G2_GEN, 10)]
        ladders = {"g1_gen_ladder": 1, "g2_gen_ladder": 1}
    elif entry == "subgroup check":
        for group in (cv.G1, cv.G2):
            jac, _ = mul_cases.public_case(group, 2, 11, "cpu")  # a subgroup point, infinity
            assert codec._check(jac, torch.ones(2, dtype=torch.bool), group, True) is jac
        ladders = {"g1_ladder": 1, "g2_ladder": 1}
    else:
        s, a, b, xs = 5, 9, 7, [3, 4]  # P(X) = a + b X; the proof of P at x is b G1
        setup = [SetupArtifact(G1Point.from_affine(hm.G1_GEN), G2Point.from_affine(hm.G2_GEN)),
                 SetupArtifact(G1Point.from_affine(hm.g1_mul(hm.G1_GEN, s)),
                               G2Point.from_affine(hm.g2_mul(hm.G2_GEN, s)))]
        c = G1Point.from_affine(hm.g1_mul(hm.G1_GEN, a + b * s))
        pi = G1Point.from_affine(hm.g1_mul(hm.G1_GEN, b))
        evs = [Evaluation(Scalar(x), Scalar(a + b * x + i)) for i, x in enumerate(xs)]
        assert verify_proofs_batch([pi] * 2, [c] * 2, evs, setup, device="cpu") == [True, False]
        ladders = {"g1_gen_ladder": 1, "g2_gen_ladder": 1}
        adds = {"g1_add": 1, "g2_add": 1}
    assert counts == Counter(**ladders, **adds)


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
    with pytest.raises(ValueError):
        cv.g1_gen_ladder(k[0])
    with pytest.raises(ValueError):
        cv.g2_gen_ladder(k[:7])
    p = cv.g1_to_device([hm.G1_GEN, None], "cpu")
    doubled = cv.g1_double(p)  # Z = 2 y, not one
    with pytest.raises(ValueError):
        cv.mul_scalar(doubled, 3)
    assert cv.g1_from_device(cv.mul_scalar(p, 3)) == [hm.g1_mul(hm.G1_GEN, 3), None]


def test_mul_cost_counts_what_the_scalar_multiplication_needs():
    """chip_smoke.py's bound for Mode A counts, a live lane with k != 0, the
    cheapest of three ladders on that lane's scalar: binary (bitlen(k) - 1
    doublings, popcount - 1 madds), a fixed 4-bit window (bitlen(k) - 1
    doublings, a 14-point table, then a madd a non-zero window below the top
    one) and the NAF (its top digit's index in doublings, weight - 1
    madds): k = 11 (0b1011), 3 doublings and 2 madds; k = 2^256 - 1, 256
    doublings and 1 madd; k = 2^255 + 1, 255 and 1; r, 255 and 59; a flagged
    lane and k = 0 nothing. Its chain: a doubling a step below the top
    non-zero digit of any lane, a madd a step where some lane has one: [r] P
    is 255 doublings and 59 madds. Mode B's (gen_cost, gen_chain): a madd
    for each table point after a lane's first, by the least of the binary
    method on the bases 2^j G, its signed form and genmul's 8-bit windows,
    on k mod r (k = 2^8 + 3: two windows, one madd; 2^200 - 1: the NAF's two
    digits, one madd, against 199 and 24; r + 2: one point, no madd), and
    the table points it uses read once; a chain of the pieces' steps and
    log2(64) adds, at most 12."""
    import chip_smoke as cs

    full = (1 << 256) - 1
    nbytes, ops = cs.mul_cost([11, full, (1 << 255) + 1, 0], 5, True, False)
    assert ops == ((3 + 256 + 255) * cs.G1_DBL_OPS + (2 + 1 + 1) * cs.G1_MADD_OPS)
    assert nbytes == 5 * (2 * 48 + 32 + 1) + 5 * 3 * 48
    assert cs.mul_cost([11], 1, False, True)[1] == 3 * cs.G2_DBL_OPS + 2 * cs.G2_MADD_OPS
    assert cs.mul_cost([hm.R], 1, False, False)[1] == 255 * cs.G1_DBL_OPS + 59 * cs.G1_MADD_OPS
    assert cs.mul_chain([11, 4]) == {"doubles": 4, "madds": 2}
    assert cs.mul_chain([hm.R]) == {"doubles": 255, "madds": 59}
    assert cs.mul_chain([]) == {"doubles": 0, "madds": 0}
    nbytes, ops = cs.gen_cost([(1 << 8) + 3, 0], 2, False)
    assert ops == cs.G1_MADD_OPS
    assert nbytes == 2 * 2 * 48 + 2 * (32 + 3 * 48)
    assert cs.gen_cost([(1 << 200) - 1], 1, True) == (2 * 2 * 96 + 32 + 3 * 96, cs.G2_MADD_OPS)
    assert cs.gen_cost([hm.R + 2], 1, False) == (2 * 48 + 32 + 3 * 48, 0)
    assert cs.gen_chain([0x0102]) == {"doubles": 1, "madds": 1, "adds": 6}
    assert cs.gen_chain(_seeded_scalars(4, 64)) == {"doubles": 3, "madds": 3, "adds": 6}
