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
    assert words("FR_ONE") == (1 << 256) % hm.R
    assert words("FP_PM2") == hm.P - 2
    assert words("FR_PM2") == hm.R - 2
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


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_inv_batch_plain_bit_identical_to_kzg_tpu(name):
    """inv_batch_plain on 64 lanes (zeros at both ends and inside, 1, N - 1,
    R mod N) against the JAX package's Field.inv_batch on the CPU, word for
    word; the wrapper takes the plain version on a CPU tensor."""
    from kzg_tpu.ops import field as jfield

    F = FIELDS[name]
    JF = {"Fp": jfield.FP, "Fr": jfield.FR}[name]
    xs = [0] + _values(F, 57, 10)[:57] + [1, F.modulus - 1, F.R_int % F.modulus, 0, 0, 0]
    xs[30] = 0
    a = F.tensor(xs, "cpu")
    got = F.inv_batch_plain(a)
    want = np.asarray(JF.inv_batch(JF.many_to_limbs(xs)))
    assert np.array_equal(convert.to_jax_limbs(got), want)
    assert torch.equal(F.inv_batch(a), got)
    assert torch.equal(fld.inv_batch(a, F), got)


def test_inv_batch_wrapper_checks_operands():
    a = FP.tensor([3, 0, 5], "cpu")
    with pytest.raises(ValueError):
        fld.inv_batch(a[:8], FP)  # words of the other field
    with pytest.raises(ValueError):
        fld.inv_batch(a[:, 0], FP)  # no lane axis
    with pytest.raises(TypeError):
        fld.inv_batch(a.to(torch.int64), FP)
    assert FP.from_words_many(fld.inv_batch(a, FP)) == [pow(3, hm.P - 2, hm.P), 0,
                                                       pow(5, hm.P - 2, hm.P)]
    assert fld.inv_batch(a[:, :0], FP).shape == (FP.L, 0)


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
    a, b = convert.from_jax_limbs(ja, "cpu"), convert.from_jax_limbs(jb, "cpu")
    assert torch.equal(a, F.tensor(xs, "cpu"))
    want = np.asarray(JF.mul(ja, jb))
    got = F.mul(a, b)
    assert np.array_equal(convert.to_jax_limbs(got), want)
    assert torch.equal(got, convert.from_jax_limbs(want, "cpu"))


def _ptx_chains(L):
    """The asm blocks of field.cuh's Ptx<L>, by function: a list of
    (instructions, operand expressions) per block."""
    src = (CSRC / "field.cuh").read_text()
    body = src.split(f"template <> struct Ptx<{L}> {{")[1].split("\n};")[0]
    funcs = {}
    for name, fbody in re.findall(r"__forceinline__ \w+ (\w+)\((.*?)\n  \}", body, re.S):
        blocks = []
        for asm in re.findall(r"asm volatile\((.*?)\);", fbody, re.S):
            text, outs, ins = asm.split(":")
            instrs = [s.strip() for s in "".join(re.findall(r'"(.*?)"', text)).replace(
                "\\n", "").replace("\\t", "").split(";") if s.strip()]
            ops = re.findall(r'"[+=]?r"\((.*?)\)', outs + ":" + ins)
            blocks.append((instrs, ops))
        funcs[name] = blocks
    return funcs


def _run_ptx(blocks, env):
    """Interpret the carry-chain instructions on python ints (u32 words)."""
    M = (1 << 32) - 1
    for instrs, ops in blocks:
        cc = 0

        def val(tok):
            tok = tok.strip()
            return env[ops[int(tok[1:])]] if tok.startswith("%") else int(tok, 0)

        for ins in instrs:
            opcode, args = ins.split(None, 1)
            args = args.split(",")
            dst = ops[int(args[0].strip()[1:])]
            parts = opcode.split(".")
            base, carry_in = parts[0].rstrip("c"), parts[0] in ("madc", "addc", "subc")
            assert base in ("mad", "mul", "add", "sub"), opcode
            cin = cc if carry_in else 0
            if base in ("mad", "mul"):
                prod = val(args[1]) * val(args[2])
                prod = prod & M if parts[1] == "lo" else prod >> 32
                full = prod + (val(args[3]) + cin if base == "mad" else 0)
            elif base == "add":
                full = val(args[1]) + val(args[2]) + cin
            else:  # sub: the carry flag holds the borrow
                full = val(args[1]) - val(args[2]) - cin
            if ".cc" in opcode:
                cc = (full >> 32) & 1 if base != "sub" else int(full < 0)
            env[dst] = full & M
    return env


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_ptx_carry_chains_compute_the_montgomery_product(name):
    """field.cuh's multiply, add, subtract and (Fp) square, with every asm
    carry chain of Ptx<L> interpreted instruction by instruction, equal
    exact python ints on random values and on 0, 1, N - 1 and R mod N: the
    chains' operand numbers, carries and immediates are what the CIOS loop
    and the square's reduction need."""
    F = FIELDS[name]
    L, N = F.L, F.modulus
    chains = _ptx_chains(L)
    assert set(chains) == {"mul_row", "red_row", "sub_n", "add", "sub"} | (
        {"sqr_wide"} if L == 12 else set())
    n0 = (-pow(N, -1, 1 << 32)) % (1 << 32)
    rinv = pow(F.R_int, -1, N)

    def words(v):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(L)]

    def value(w):
        return sum(x << (32 * i) for i, x in enumerate(w))

    def env_of(**arrays):
        env = {}
        for key, arr in arrays.items():
            if isinstance(arr, list):
                env.update({f"{key}[{j}]": x for j, x in enumerate(arr)})
            else:
                env[key] = arr
        return env

    def cond_sub(t, hi):
        e = _run_ptx(chains["sub_n"], env_of(d=list(t), hi=hi, r=0))
        take = e["r"] < (1 << 31)
        return [e[f"d[{j}]"] for j in range(L)] if take else list(t)

    def mont_mul(a, b):
        t = [0] * L + [0xDEAD]  # t[L] is written before it is read
        for i in range(L):
            e = _run_ptx(chains["mul_row"], env_of(t=t, a=a, b=b[i]))
            t = [e[f"t[{j}]"] for j in range(L + 1)]
            e = _run_ptx(chains["red_row"], env_of(t=t, m=t[0] * n0 % (1 << 32)))
            t = [e[f"t[{j}]"] for j in range(L + 1)]
            assert t[0] == 0
            t = t[1:] + [0xDEAD]
        return cond_sub(t[:L], 0)

    def add(a, b):
        e = _run_ptx(chains["add"], env_of(s=list(a), b=b, c=0))
        return cond_sub([e[f"s[{j}]"] for j in range(L)], e["c"])

    def sub(a, b):
        e = _run_ptx(chains["sub"], env_of(d=list(a), b=b, r=0))
        d = [e[f"d[{j}]"] for j in range(L)]
        nb = [w & e["r"] for w in words(N)]
        e = _run_ptx(chains["add"], env_of(s=d, b=nb, c=0))
        return [e[f"s[{j}]"] for j in range(L)]

    def mont_sqr(a):
        """The Fp square: sqr_wide (its first row's low products are C
        code), reduction rows on the low half, the high half added."""
        t = [0xDEAD] * (2 * L)  # every word is written before it is read
        t[1:L] = [a[0] * a[k] % (1 << 32) for k in range(1, L)]
        e = _run_ptx(chains["sqr_wide"], env_of(t=t, a=a, c=0xDEAD, junk=0xDEAD))
        t = [e[f"t[{j}]"] for j in range(2 * L)]
        assert value(t) == value(a) ** 2
        u = t[:L] + [0]
        for _ in range(L):
            e = _run_ptx(chains["red_row"], env_of(t=u, m=u[0] * n0 % (1 << 32)))
            u = [e[f"t[{j}]"] for j in range(L + 1)]
            assert u[0] == 0
            u = u[1:] + [0]
        e = _run_ptx(chains["add"], env_of(s=u[:L], b=t[L:], c=0))
        return cond_sub([e[f"s[{j}]"] for j in range(L)], e["c"])

    vals = _values(F, 24, 7) + [F.R_int % N]
    for x, y in zip(vals, vals[::-1]):
        a, b = words(x), words(y)
        assert value(mont_mul(a, b)) == x * y * rinv % N
        assert value(add(a, b)) == (x + y) % N
        assert value(sub(a, b)) == (x - y) % N
        if "sqr_wide" in chains:
            assert value(mont_sqr(a)) == x * x * rinv % N
