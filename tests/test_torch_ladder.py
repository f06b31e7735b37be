"""kzg_torch's batched-affine MSM (K2b, ``ops.msm.msm_batched_affine``) on
the CPU: its plain version, ``msm_batched_plain``, bit for bit against the
JAX package's msm_batched_affine and against exact python ints on the
ladder's and the tree's exceptional inputs; its pairing; and the commit and
proof against a list of setup artifacts against the golden bytes.
Tolerance: exact equality (integer arithmetic)."""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from kzg_torch import Polynomial, Scalar, convert
from kzg_torch import artifacts as art
from kzg_torch.ops import curve as cv
from kzg_torch.ops import msm
from kzg_torch.ops.field import FP, FR
from kzg_torch.utils import hostmath as hm
from kzg_torch.utils.ladder_cases import edge_lanes, oracle, scalar_words

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _case(n, seed):
    """n seeded points base_i G on the host, seeded scalars below r, then the
    exceptional lanes of ladder_cases.edge_lanes. Returns (x, y, k, mask,
    base, ks)."""
    rng = np.random.default_rng(seed)
    base = [int(v) + 2 for v in rng.integers(0, 1 << 62, size=n)]
    x, y, _ = cv.g1_to_device([hm.g1_mul(hm.G1_GEN, b) for b in base], "cpu")
    ks = [int.from_bytes(rng.bytes(32), "little") % hm.R for _ in range(n)]
    mask = edge_lanes(x, y, base, ks)
    return x, y, scalar_words(ks, "cpu"), mask, base, ks


def _affine(p):
    return cv.g1_from_device(tuple(c.reshape(FP.L, 1) for c in p))


@pytest.mark.parametrize("n,masked", [(3, False),
                                      pytest.param(10, True, marks=pytest.mark.slow)])
def test_ladder_plain_bit_identical_to_kzg_tpu(n, masked):
    """msm_batched_plain against kzg_tpu's msm_batched_affine on G1 (run
    eagerly: one compile of its ladder and tree), word for word: n = 3 (two
    equal lanes and a scalar 0; the JAX tree pads to 4) unmasked, and n =
    10 on every exceptional lane of edge_lanes with lanes 3 and 9 flagged
    infinite (slow: about 64 s with a cold JAX cache; the host oracle holds
    the same lanes in test_ladder_plain_matches_host)."""
    from kzg_tpu.ops import msm as jmsm
    from kzg_tpu.ops.curve import G1

    x, y, k, mask, base, ks = _case(n, 40 + n)
    mask = mask if masked else None
    got = msm.msm_batched_plain((x, y), k, mask)
    want = jmsm.msm_batched_affine(
        G1, (convert.to_jax_limbs(x), convert.to_jax_limbs(y)), convert.to_jax_limbs(k),
        None if mask is None else mask.numpy())
    for g, w in zip(got, want):
        assert torch.equal(g, convert.from_jax_limbs(np.asarray(w), "cpu"))
    assert _affine(got) == oracle(base, ks, mask)


def _counted(fn, counts, name):
    def wrapper(*args):
        counts[name] += 1
        return fn(*args)
    return wrapper


@pytest.mark.parametrize("n", [1, 2, 3, 10])
def test_ladder_plain_matches_host(n):
    """The plain version on the exceptional lanes of edge_lanes against the
    host oracle, unmasked: n = 1 (the ladder meets acc == P; no add), n = 2
    (P and -P with one scalar: infinity), n = 3 (two equal lanes: the
    tree's add doubles), n = 10 (every lane). With counting formulas: 256
    doublings, 256 madds and one add a tree level."""
    x, y, k, _, base, ks = _case(n, 50 + n)
    counts = Counter()
    got = msm.msm_batched_plain(
        (x, y), k, add=_counted(cv.g1_add_plain, counts, "add"),
        madd=_counted(cv.g1_madd_plain, counts, "madd"),
        double=_counted(cv.g1_double_plain, counts, "double"))
    assert counts == Counter(double=256, madd=256, add=(n - 1).bit_length()) - Counter()
    assert _affine(got) == oracle(base, ks)
    if n == 2:
        assert _affine(got) == [None]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64, 129, 300])
def test_tree_reduce_adjacent_follows_the_jax_pairing(n):
    """The pairs tree_reduce_adjacent adds, recorded by lane id, are the JAX
    package's tree_reduce pairs: at distance s, lane j with lane j + s for j
    a multiple of 2 s and j + s < n (a partner in the JAX tree's padding is
    infinity, which its add passes over)."""
    seen = []

    def add(p, q):
        seen.append(list(zip(p[0][0].tolist(), q[0][0].tolist())))
        return p

    lanes = torch.arange(n, dtype=torch.int32).expand(FP.L, n)
    out = msm.tree_reduce_adjacent((lanes, lanes, lanes), add)
    want, s = [], 1
    while s < n:
        want.append([(j, j + s) for j in range(0, n - s, 2 * s)])
        s *= 2
    assert seen == want and int(out[0][0]) == 0


def test_ladder_cost_counts_the_cheaper_of_ladder_and_buckets():
    """chip_smoke.py's bound for K2b counts what sum_i k_i P_i needs: one
    lane of scalar 11 (0b1011) by its ladder, 3 doublings and 2 madds (the
    buckets need 3 doublings and 3 adds); 64 lanes of scalar 1 by one
    bucket, 63 madds (the ladders' tree needs 63 adds); a flagged lane and a
    scalar r count nothing. bucket_ops at c = 2 on the scalars 6 and 7
    (digits (2, 1) and (3, 1)): 1 madd in the top window's bucket, 1 + 2
    adds for the bottom window's running sum, 2 doublings and 1 add."""
    import chip_smoke as cs

    assert cs.ladder_cost(scalar_words([11], "cpu"), None)[1] == (
        3 * cs.G1_DBL_OPS + 2 * cs.G1_MADD_OPS)
    mask = torch.zeros(66, dtype=torch.bool)
    mask[0] = True
    nbytes, ops = cs.ladder_cost(scalar_words([5] + [1] * 64 + [hm.R], "cpu"), mask)
    assert ops == 63 * cs.G1_MADD_OPS and nbytes == 66 * (2 * 48 + 32 + 1) + 3 * 48
    assert cs.bucket_ops([6, 7], 2) == cs.G1_MADD_OPS + 4 * cs.G1_ADD_OPS + 2 * cs.G1_DBL_OPS


def test_msm_batched_affine_checks_operands():
    x = torch.zeros(FP.L, 4, dtype=torch.int32)
    k = torch.zeros(FR.L, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        msm.msm_batched_affine((x, x[:, :3]), k)
    with pytest.raises(ValueError):
        msm.msm_batched_affine((x, x), k[:, :3])
    with pytest.raises(ValueError):
        msm.msm_batched_affine((x, x), k, inf_mask=torch.zeros(3, dtype=torch.bool))
    empty = torch.zeros(FP.L, 0, dtype=torch.int32)
    out = msm.msm_batched_affine((empty, empty), k[:, :0])
    assert all(c.shape == (FP.L,) and not bool(c.any()) for c in out)


def test_setup_list_commit_and_proof_run_the_batched_msm(monkeypatch):
    """A list of SetupArtifact sends every commit through
    msm_batched_affine: the 10-coefficient commit and its opening proof at
    x = 42 (9 quotient coefficients) give the golden commitment.json and
    evaluation.json bytes."""
    setup = art.load_setup(os.path.join(GOLDEN, "setup.json"))
    calls = []
    batched = msm.msm_batched_affine

    def counted(pts, scalars, inf_mask=None):
        calls.append(scalars.shape[1])
        return batched(pts, scalars, inf_mask)

    monkeypatch.setattr(msm, "msm_batched_affine", counted)
    poly = Polynomial.from_ints([5**i + 10 for i in range(10)], device="cpu")
    commitment = poly.commit(setup)
    ev = poly.evaluate(Scalar(42))
    proof = ev.generate_proof(poly, setup)
    assert calls == [10, 9]
    with open(os.path.join(GOLDEN, "commitment.json")) as f:
        assert commitment.to_json() == json.load(f)["commitment"]
    with open(os.path.join(GOLDEN, "evaluation.json")) as f:
        assert proof.to_json() == json.load(f)["proof"]
