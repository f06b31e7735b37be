"""kzg_torch field layer on the CPU: the plain versions of K1 and the other
field operations against exact python ints, and bit for bit against the JAX
package's FP.mul / FR.mul. Tolerance: exact equality (integer arithmetic)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kzg_torch import convert
from kzg_torch.ops import field as fld
from kzg_torch.ops import limbs as lb
from kzg_torch.ops.field import FP, FR
from kzg_torch.utils import hostmath as hm
from kzg_torch.utils.device import resolve_device

FIELDS = {"Fp": FP, "Fr": FR}
CSRC = Path(__file__).resolve().parent.parent / "kzg_torch" / "csrc"


def _values(F, n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, F.L), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % F.modulus for row in words]
    return vals + [0, 1, F.modulus - 1]


def test_constants_match_hostmath():
    """The kernels' embedded moduli and Montgomery constants (field.cuh) are
    the ones hostmath derives."""
    src = (CSRC / "field.cuh").read_text()

    def words(name):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
        vals = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9a-f]+u", body)]
        return sum(v << (32 * i) for i, v in enumerate(vals))

    def scalar(name):
        return int(re.search(name + r" = (0x[0-9a-f]+)u;", src).group(1), 16)

    assert words("FP_N") == hm.P
    assert words("FR_N") == hm.R
    assert words("FP_ONE") == (1 << 384) % hm.P
    assert scalar("FP_N0") == (-pow(hm.P, -1, 1 << 32)) % (1 << 32)
    assert scalar("FR_N0") == (-pow(hm.R, -1, 1 << 32)) % (1 << 32)
    assert hm.P == FP.modulus and hm.R == FR.modulus


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_ring_ops_match_python_ints(name):
    F = FIELDS[name]
    xs = _values(F, 61, 1)
    ys = _values(F, 61, 2)[::-1]
    a, b = F.tensor(xs, "cpu"), F.tensor(ys, "cpu")
    m = F.modulus
    assert F.from_words_many(F.mul(a, b)) == [x * y % m for x, y in zip(xs, ys)]
    assert F.from_words_many(F.square(a)) == [x * x % m for x in xs]
    assert F.from_words_many(F.add(a, b)) == [(x + y) % m for x, y in zip(xs, ys)]
    assert F.from_words_many(F.sub(a, b)) == [(x - y) % m for x, y in zip(xs, ys)]
    assert F.from_words_many(F.neg(a)) == [-x % m for x in xs]
    assert F.from_words_many(F.dbl(a)) == [2 * x % m for x in xs]


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_inversions_match_python_ints(name):
    F = FIELDS[name]
    xs = _values(F, 13, 3)
    a = F.tensor(xs, "cpu")
    m = F.modulus
    want = [pow(x, m - 2, m) for x in xs]  # inv(0) = 0
    assert F.from_words_many(F.inv_batch(a)) == want
    assert F.from_words_many(F.inv(a[:, :4])) == want[:4]
    assert F.from_words_many(F.pow_const(a, 5)) == [pow(x, 5, m) for x in xs]


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_montgomery_conversions(name):
    F = FIELDS[name]
    xs = _values(F, 20, 4)
    mont = F.tensor(xs, "cpu")
    std = F.from_mont(mont)
    assert lb.words_to_ints(std) == xs
    assert torch.equal(F.to_mont(std), mont)
    assert torch.equal(F.tensor(xs, "cpu", mont=False), std)


def test_inv_batch_keeps_shape_and_zero_lanes():
    xs = _values(FP, 5, 5)
    a = FP.tensor(xs + xs, "cpu").reshape(FP.L, 2, len(xs))
    inv = FP.inv_batch(a)
    assert inv.shape == a.shape
    want = [pow(x, hm.P - 2, hm.P) for x in xs] * 2
    assert FP.from_words_many(inv) == want


def test_word_limb_layouts_round_trip():
    vals = _values(FP, 40, 6)
    w = lb.ints_to_words(vals, FP.L)
    assert w.dtype == np.int32 and w.shape == (FP.L, len(vals))
    assert lb.words_to_ints(w) == vals
    t = torch.from_numpy(w)
    limbs = lb.words_to_limbs16(t)
    assert [sum(int(limbs[i, j]) << (16 * i) for i in range(FP.L16)) for j in range(3)] == vals[:3]
    assert torch.equal(lb.limbs16_to_words(limbs), t)
    with pytest.raises(ValueError):
        lb.ints_to_words([1 << 384], FP.L)


def test_normalize_resolves_long_carry_chains():
    rng = np.random.default_rng(7)
    cols = torch.from_numpy(rng.integers(0, 1 << 37, size=(48, 9), dtype=np.int64))
    cols[:, 0] = 0
    cols[3:30, 1] = 0xFFFF  # a carry that ripples through 27 limbs
    cols[2, 1] = 1 << 16
    cols[:, 2] = 0xFFFF
    cols[0, 2] = 0x10000
    limbs, carry = lb.normalize(cols.clone())
    for j in range(cols.shape[1]):
        value = sum(int(c) << (16 * k) for k, c in enumerate(cols[:, j]))
        got = sum(int(c) << (16 * k) for k, c in enumerate(limbs[:, j]))
        assert got + (int(carry[j]) << (16 * 48)) == value
        assert int(limbs[:, j].max()) <= 0xFFFF


def test_mont_mul_wrapper_checks_operands():
    a = FP.tensor([1, 2], "cpu")
    with pytest.raises(ValueError):
        fld.mont_mul(a, a[:, :1], FP)
    with pytest.raises(ValueError):
        fld.mont_mul(a[:8], a[:8], FP)
    assert torch.equal(fld.mont_mul(a, a, FP), fld.mont_mul_plain(a, a, FP))


def test_entry_points_need_a_card_or_an_explicit_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_mul_bit_identical_to_kzg_tpu(name):
    """64 lanes (the JAX package's Pallas threshold; XLA path on the CPU)
    through convert: the port's words are the JAX limbs regrouped."""
    from kzg_tpu.ops import field as jfield

    F = FIELDS[name]
    JF = {"Fp": jfield.FP, "Fr": jfield.FR}[name]
    xs = _values(F, 61, 8)
    ys = _values(F, 61, 9)[::-1]
    ja, jb = JF.many_to_limbs(xs), JF.many_to_limbs(ys)
    a, b = convert.from_jax_limbs(ja), convert.from_jax_limbs(jb)
    assert torch.equal(a, F.tensor(xs, "cpu"))
    want = np.asarray(JF.mul(ja, jb))
    got = F.mul(a, b)
    assert np.array_equal(convert.to_jax_limbs(got), want)
    assert torch.equal(got, convert.from_jax_limbs(want))
