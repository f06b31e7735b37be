"""kzg_torch's Fp6 and Fp12 towers on the CPU: ``ops/fp6.py`` and
``ops/fp12.py`` bit for bit against kzg_tpu.ops.fp6 and kzg_tpu.ops.fp12
(JAX on the CPU, run eagerly) on four seeded lanes, and the port's copy of
the integer oracle (``kzg_torch/utils/hostmath.py``'s tower, Frobenius
tables and pairing) against kzg_tpu.utils.hostmath. Tolerance: exact
equality (integer arithmetic, canonical words)."""

import random

import numpy as np
import pytest
import torch

from kzg_torch import convert
from kzg_torch.ops import fp6, fp12
from kzg_torch.ops.field import FP
from kzg_torch.utils import hostmath as hm

N = 4


def _rand(shape, seed):
    """(12, *shape) canonical Fp words from a numpy seed."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(FP.L,) + shape, dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(hm.P >> (32 * (FP.L - 1)))
    return torch.from_numpy(w.view(np.int32))


def _jax6(t):
    """(12, 2, 3, *batch) words -> kzg_tpu's Fp6 tuple of (24, 2, *batch)."""
    import jax.numpy as jnp

    a = jnp.asarray(convert.to_jax_limbs(t))
    return tuple(a[:, :, k] for k in range(3))


def _jax12(t):
    return tuple(_jax6(t[:, :, :, h]) for h in range(2))


def _stack(x):
    """kzg_tpu's Fp6 or Fp12 tuple -> (24, 2, 3[, 2], *batch) limbs."""
    if isinstance(x[0], tuple):
        return np.stack([_stack(c) for c in x], axis=3)
    return np.stack([np.asarray(c) for c in x], axis=2)


def _same(got, want) -> bool:
    return np.array_equal(convert.to_jax_limbs(got), _stack(want))


def _cases6():
    a, b = _rand((2, 3, N), 1), _rand((2, 3, N), 2)
    a[..., 0] = 0  # a zero lane: inv maps it to zero
    b[..., 1] = a[..., 1]
    return a, b, _rand((2, N), 3)


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "square", "mul_by_v", "mul_by_fp2",
                                "inv", "eq"])
def test_fp6_bit_identical_to_kzg_tpu(op):
    from kzg_tpu.ops import fp6 as jfp6

    a, b, k = _cases6()
    ja, jb = _jax6(a), _jax6(b)
    if op in ("add", "sub", "mul"):
        assert _same(getattr(fp6, op)(a, b), getattr(jfp6, op)(ja, jb))
    elif op == "mul_by_fp2":
        import jax.numpy as jnp

        jk = jnp.asarray(convert.to_jax_limbs(k))
        assert _same(fp6.mul_by_fp2(a, k), jfp6.mul_by_fp2(ja, jk))
    elif op == "eq":
        assert np.array_equal(fp6.eq(a, b).numpy(), np.asarray(jfp6.eq(ja, jb)))
        assert fp6.eq(a, b).tolist() == [False, True] + [False] * (N - 2)
    else:
        assert _same(getattr(fp6, op)(a), getattr(jfp6, op)(ja))


def test_fp6_mul_many_is_each_product():
    a, b, _ = _cases6()
    c = _rand((2, 3, N), 4)
    got = fp6.mul_many([(a, b), (c, a), (b, b)])
    assert all(torch.equal(g, fp6.mul(x, y)) for g, (x, y) in zip(got, [(a, b), (c, a), (b, b)]))


def _cases12():
    a, b = _rand((2, 3, 2, N), 5), _rand((2, 3, 2, N), 6)
    a[..., 0] = 0
    b[..., 1] = a[..., 1]
    return a, b


@pytest.mark.parametrize("op", ["mul", "square", "inv", "conj", "frobenius1", "frobenius2",
                                "frobenius3", "select", "eq"])
def test_fp12_bit_identical_to_kzg_tpu(op):
    from kzg_tpu.ops import fp12 as jfp12

    a, b = _cases12()
    ja, jb = _jax12(a), _jax12(b)
    if op == "mul":
        assert _same(fp12.mul(a, b), jfp12.mul(ja, jb))
    elif op.startswith("frobenius"):
        k = int(op[-1])
        assert _same(fp12.frobenius(a, k), jfp12.frobenius(ja, k))
    elif op == "select":
        import jax.numpy as jnp

        mask = torch.arange(N) % 2 == 0
        assert _same(fp12.select(mask, a, b), jfp12.select(jnp.asarray(mask.numpy()), ja, jb))
    elif op == "eq":
        assert np.array_equal(fp12.eq(a, b).numpy(), np.asarray(jfp12.eq(ja, jb)))
    else:
        assert _same(getattr(fp12, op)(a), getattr(jfp12, op)(ja))


def test_fp12_ints_round_trip_and_one():
    """tensor / to_ints_many / from_ints / to_ints in kzg_tpu's tuple
    format, one_like the oracle's one, pow_const the oracle's power."""
    rnd = random.Random(7)
    vs = [tuple(tuple((rnd.randrange(hm.P), rnd.randrange(hm.P)) for _ in range(3))
                for _ in range(2)) for _ in range(3)]
    t = fp12.tensor(vs, "cpu")
    assert t.shape == (FP.L, 2, 3, 2, 3)
    assert fp12.to_ints_many(t) == vs
    assert fp12.to_ints(fp12.from_ints(vs[1], "cpu")) == vs[1]
    assert fp12.to_ints_many(fp12.one_like(t)) == [hm.FP12_ONE] * 3
    assert fp12.to_ints_many(fp12.pow_const(t, 77)) == [hm.fp12_pow(v, 77) for v in vs]


def test_oracle_tower_equals_kzg_tpu_hostmath():
    """The copied tower, Frobenius tables and constants give kzg_tpu's
    hostmath's values."""
    from kzg_tpu.utils import hostmath as jhm

    rnd = random.Random(11)
    r2 = lambda: (rnd.randrange(hm.P), rnd.randrange(hm.P))  # noqa: E731
    a = ((r2(), r2(), r2()), (r2(), r2(), r2()))
    b = ((r2(), r2(), r2()), (r2(), r2(), r2()))
    assert hm._frob_tables() == jhm._frob_tables()
    assert (hm.XI, hm.FP12_ONE, hm.BLS_X, hm.BLS_X_IS_NEG) == (jhm.XI, jhm.FP12_ONE, jhm.BLS_X,
                                                               jhm.BLS_X_IS_NEG)
    for name in ("fp12_mul", "fp12_sub", "fp12_add"):
        assert getattr(hm, name)(a, b) == getattr(jhm, name)(a, b), name
    for name in ("fp12_sq", "fp12_conj", "fp12_inv"):
        assert getattr(hm, name)(a) == getattr(jhm, name)(a), name
    for k in (1, 2, 3):
        assert hm.fp12_frobenius(a, k) == jhm.fp12_frobenius(a, k)
    assert hm.fp6_inv(a[0]) == jhm.fp6_inv(a[0])
    assert hm.fp2_pow(a[0][0], 12345) == jhm.fp2_pow(a[0][0], 12345)
    assert hm.untwist(hm.G2_GEN) == jhm.untwist(jhm.G2_GEN)


def test_oracle_pairing_equals_kzg_tpu_hostmath():
    """hostmath.pairing on two seeded pairs, and its bilinearity."""
    from kzg_tpu.utils import hostmath as jhm

    p, q = hm.g1_mul(hm.G1_GEN, 1234567), hm.g2_mul(hm.G2_GEN, 7654321)
    e = hm.pairing(p, q)
    assert e == jhm.pairing(p, q)
    assert hm.pairing(hm.G1_GEN, hm.G2_GEN) == jhm.pairing(jhm.G1_GEN, jhm.G2_GEN)
    assert e == hm.fp12_pow(hm.pairing(hm.G1_GEN, hm.G2_GEN), 1234567 * 7654321 % hm.R)
