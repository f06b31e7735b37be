"""kzg_torch polynomial layer on the CPU: ops.poly against kzg_tpu.ops.poly
(XLA on the CPU) at n = 16, the runs-plain versions (the decomposition of
the evaluation and division kernels, at a run and a block of 4) against it
at the decomposition's boundaries, Polynomial.evaluate / sub /
divide_by_root with the reference's edge cases, and the opening proof
against the golden evaluation.json bytes. Tolerance: exact equality, max
word error 0 (integer arithmetic).

The JAX functions run eagerly: ``powers`` as it is, ``evaluate`` and
``synthetic_divide`` through ``__wrapped__`` (the body their jit compiles),
so that they share the JAX package's compiled Fr operations instead of each
compiling a program of its own (a third of the time on one CPU core); the
words they return are the same."""

import json
import os

import numpy as np
import pytest
import torch

from kzg_torch import Evaluation, Polynomial, ProtocolError, Scalar, convert
from kzg_torch import artifacts as art
from kzg_torch.errors import CliError
from kzg_torch.ops import poly
from kzg_torch.ops.field import FR
from kzg_torch.utils import hostmath as hm

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
COEFFS = [5**i + 10 for i in range(10)]
SECRET = int.from_bytes(bytes(range(32)), "big") % hm.R
N = 16


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % hm.R for _ in range(n)]


def _jax(words):
    import jax.numpy as jnp

    return jnp.asarray(convert.to_jax_limbs(words))


def _from_jax(a):
    return convert.from_jax_limbs(np.asarray(a), "cpu")


@pytest.fixture(scope="module")
def inputs():
    coeffs = _ints(N, 1)
    x, root = _ints(2, 2)
    return {"coeffs": coeffs, "x": x, "root": root,
            "c": FR.tensor(coeffs, "cpu"), "xw": FR.tensor([x], "cpu")[:, 0],
            "rw": FR.tensor([root], "cpu")[:, 0]}


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % hm.R
    return acc


def test_powers_bit_identical_to_kzg_tpu(inputs):
    from kzg_tpu.ops import poly as jpoly

    got = poly.power_sequence(inputs["xw"], N)
    assert torch.equal(got, _from_jax(jpoly.powers(_jax(inputs["xw"]), N)))
    assert FR.from_words_many(got) == [pow(inputs["x"], i, hm.R) for i in range(N)]
    assert poly.powers(inputs["xw"], 0).shape == (FR.L, 0)
    assert FR.from_words_many(poly.powers(inputs["xw"], 1)) == [1]


def test_evaluate_bit_identical_to_kzg_tpu(inputs):
    from kzg_tpu.ops import poly as jpoly

    got = poly.evaluate(inputs["c"], inputs["xw"])
    want = jpoly.evaluate.__wrapped__(_jax(inputs["c"]), _jax(inputs["xw"]), N)
    assert torch.equal(got, _from_jax(want))
    assert FR.from_words_many(got[:, None]) == [_horner(inputs["coeffs"], inputs["x"])]


def test_synthetic_divide_bit_identical_to_kzg_tpu(inputs):
    from kzg_tpu.ops import poly as jpoly

    q, rebuilt = poly.synthetic_divide(inputs["c"], inputs["rw"])
    jq, jrebuilt = jpoly.synthetic_divide.__wrapped__(_jax(inputs["c"]), _jax(inputs["rw"]), N)
    assert torch.equal(q, _from_jax(jq))
    assert torch.equal(rebuilt, _from_jax(jrebuilt))
    # host: q_i = p_{i+1} + root q_{i+1}, top down
    coeffs, root = inputs["coeffs"], inputs["root"]
    want, acc = [0] * (N - 1), coeffs[-1]
    for i in range(N - 2, -1, -1):
        want[i] = acc
        acc = (coeffs[i] + root * acc) % hm.R
    assert FR.from_words_many(q) == want


RUN = BLOCK = 4  # the runs-plain versions' run and block in these tests


# 1, 2, 3, a run, a run and one, a tile (run * block), a tile and one, and
# past block tiles, where the top pass takes three tiles a thread
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 16, 17, 131])
def test_runs_plain_bit_identical_to_kzg_tpu(n):
    """evaluate_runs_plain and synthetic_divide_runs_plain at RUN = BLOCK = 4,
    and the wrappers (the pair-up plain versions on the CPU), equal kzg_tpu's
    evaluate and synthetic_divide at x or root = 0, 1, r - 1 and a seeded
    point."""
    from kzg_tpu.ops import poly as jpoly

    c = FR.tensor(_ints(n, 30 + n), "cpu")
    for x in (0, 1, hm.R - 1, _ints(1, 40 + n)[0]):
        xw = FR.tensor([x], "cpu")[:, 0]
        want = _from_jax(jpoly.evaluate.__wrapped__(_jax(c), _jax(xw), n))
        assert torch.equal(poly.evaluate_runs_plain(c, xw, RUN, BLOCK), want)
        assert torch.equal(poly.evaluate(c, xw), want)
        if n < 2:
            continue
        jq, jrebuilt = jpoly.synthetic_divide.__wrapped__(_jax(c), _jax(xw), n)
        for q, rebuilt in (poly.synthetic_divide_runs_plain(c, xw, RUN, BLOCK),
                           poly.synthetic_divide(c, xw)):
            assert torch.equal(q, _from_jax(jq))
            assert torch.equal(rebuilt, _from_jax(jrebuilt))


def test_wrappers_check_operands():
    c, x = FR.tensor([1, 2, 3], "cpu"), FR.tensor([5], "cpu")
    with pytest.raises(ValueError):
        poly.evaluate(c, x)  # the point is (8, 1), not (8,)
    with pytest.raises(TypeError):
        poly.synthetic_divide(c.long(), x[:, 0])
    with pytest.raises(ValueError, match="at least two coefficients"):
        poly.synthetic_divide(c[:, :1], x[:, 0])
    assert torch.equal(poly.evaluate(c[:, :0], x[:, 0]), torch.zeros(FR.L, dtype=torch.int32))


@pytest.mark.parametrize("n", [1, 2, 5, 17])
def test_tree_sum_and_scans_at_odd_sizes(n):
    vals = _ints(n, 10 + n)
    assert FR.from_words_many(poly.tree_sum(FR.tensor(vals, "cpu"))[:, None]) == [sum(vals) % hm.R]
    x = _ints(1, 20 + n)[0]
    xw = FR.tensor([x], "cpu")[:, 0]
    assert FR.from_words_many(poly.powers(xw, n)) == [pow(x, i, hm.R) for i in range(n)]
    if n >= 2:
        q, _ = poly.synthetic_divide(FR.tensor(vals, "cpu"), xw)
        want, acc = [0] * (n - 1), vals[-1]
        for i in range(n - 2, -1, -1):
            want[i] = acc
            acc = (vals[i] + x * acc) % hm.R
        assert FR.from_words_many(q) == want


def test_evaluate_and_sub():
    p = Polynomial.from_ints(COEFFS, device="cpu")
    ev = p.evaluate(Scalar(42))
    assert ev.point.to_int() == 42 and ev.result.to_int() == _horner(COEFFS, 42)
    assert Polynomial.from_ints([], device="cpu").evaluate(Scalar(3)).result.to_int() == 0
    q = Polynomial.from_ints([1, 2], device="cpu")
    assert p.sub(q).coefficient_ints() == [COEFFS[0] - 1, COEFFS[1] - 2] + COEFFS[2:]
    assert q.sub(p).coefficient_ints() == [(a - b) % hm.R for a, b in
                                           zip([1, 2] + [0] * 8, COEFFS)]
    # cancellation truncates after the last non-zero coefficient; all zero keeps one zero
    assert p.sub(Polynomial.from_ints(COEFFS[:5] + [7] + COEFFS[6:], device="cpu")
                 ).coefficient_ints() == [0] * 5 + [(COEFFS[5] - 7) % hm.R]
    assert p.sub(p).coefficient_ints() == [0]


def test_divide_by_root_edge_cases():
    assert Polynomial.from_ints([], device="cpu").divide_by_root(Scalar(3)).num_coefficients == 0
    lone_zero = Polynomial.from_ints([0], device="cpu")
    assert lone_zero.num_coefficients == 1
    assert lone_zero.divide_by_root(Scalar(3)).num_coefficients == 0
    with pytest.raises(ProtocolError, match="Unable to divide a constant polynomial"):
        Polynomial.from_ints([5], device="cpu").divide_by_root(Scalar(3))
    p = Polynomial.from_ints(COEFFS, device="cpu")
    with pytest.raises(ProtocolError, match="constant terms do not add up"):
        p.divide_by_root(Scalar(42))
    # (x - 3)(x + 4) = x^2 + x - 12; i128-style negative coefficient
    q = Polynomial.from_ints([-12, 1, 1], device="cpu").divide_by_root(Scalar(3))
    assert q.coefficient_ints() == [4, 1]
    # x^3 at root 0: quotient x^2
    assert Polynomial.from_ints([0, 0, 0, 1], device="cpu").divide_by_root(
        Scalar(0)).coefficient_ints() == [0, 0, 1]


def test_evaluation_bytes_match_golden(tmp_path):
    """evaluate + generate_proof on the golden setup give evaluation.json
    byte for byte, and the file round-trips."""
    setup = art.load_setup(os.path.join(GOLDEN, "setup.json"))
    p = Polynomial.from_ints(COEFFS, device="cpu")
    ev = p.evaluate(Scalar(42))
    proof = ev.generate_proof(p, setup)
    path = str(tmp_path / "evaluation.json")
    art.save_evaluation(art.EvaluationArtifact(evaluation=ev, proof=proof), path)
    with open(path) as f, open(os.path.join(GOLDEN, "evaluation.json")) as g:
        assert f.read() == g.read()
    loaded = art.load_evaluation(path)
    assert loaded.proof == proof
    assert loaded.evaluation.point.to_int() == 42
    assert loaded.evaluation.result.to_int() == ev.result.to_int()
    assert Evaluation.from_json(json.loads(json.dumps(ev.to_json()))).result.to_int() == \
        ev.result.to_int()
    # the proof is the commitment to the quotient: (P(s) - y) / (s - x) G1
    want = (_horner(COEFFS, SECRET) - ev.result.to_int()) * pow(SECRET - 42, -1, hm.R) % hm.R
    assert proof.affine() == hm.g1_mul(hm.G1_GEN, want)
    with pytest.raises(CliError, match="Evaluation artifact has not been found"):
        art.load_evaluation(str(tmp_path / "missing.json"))
