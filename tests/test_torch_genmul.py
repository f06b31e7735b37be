"""kzg_torch generator tables, window fold (plain K5/K8), doubling chain
(plain K7) and G1 ceremony on the CPU, against kzg_tpu.ops.genmul (XLA on
the CPU) and against exact python ints. Tolerance: exact equality (integer
arithmetic).

Each JAX function is compiled at most once in this file; the JAX table
build (about a minute on the CPU) is only in the slow test."""

import numpy as np
import pytest
import torch

from kzg_torch import convert
from kzg_torch.ops import curve as cv
from kzg_torch.ops import genmul
from kzg_torch.ops.field import FP, FR
from kzg_torch.utils import fold_cases as fc
from kzg_torch.utils import hostmath as hm

# eight lanes: zero, a lone digit in window 16, digit 0 in window 0, k = r - 1,
# every word with bit 31 set, two seeded scalars, and 255
_BIT31 = sum(0x80000001 << (32 * j) for j in range(7)) + (0x70000000 << 224)
KS = [0, 1 << 128, 256, hm.R - 1, _BIT31,
      0x5D2A13FC6B4E8D0F9A7C3B1E6F2D4A8B0C9E7F1A3B5D7C9E1F3A5B7C9D1E3F5A, 12345678901234567, 255]


def _tables():
    return genmul.gen_tables("cpu")


def test_digits8_match_kzg_tpu():
    from kzg_tpu.ops import curve as jcv
    from kzg_tpu.ops import genmul as jgm

    got = genmul._digits8(FR.tensor(KS, "cpu", mont=False))
    want = np.asarray(jgm._digits8(jcv.fr_to_device(KS, batch=True)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    for j, k in enumerate(KS):
        assert sum(int(d) << (8 * i) for i, d in enumerate(got[:, j])) == k


def test_level_bases_match_kzg_tpu():
    from kzg_tpu.ops import curve as jcv
    from kzg_tpu.ops import genmul as jgm

    for k in (0, genmul.GEN_WINDOW_BITS - 1):  # the first and last level
        assert genmul._level_bases(k) == jgm._level_bases(jcv.G1, k)


def test_tables_hold_window_multiples():
    """Rows w = 0 and w = 31 in full (T[w][d] = d 2^(8w) G, d = 0 stored as
    (0, 0)) and 64 seeded (w, d) entries."""
    tx, ty = _tables()
    assert tx.shape == ty.shape == (FP.L, genmul.GEN_WINDOWS, genmul.GEN_ENTRIES)
    bases = [hm.G1_GEN]  # 2^(8w) G, by host doublings
    for _ in range(8 * (genmul.GEN_WINDOWS - 1)):
        bases.append(hm.g1_add(bases[-1], bases[-1]))
    bases = bases[::8]
    for w in (0, genmul.GEN_WINDOWS - 1):
        base, acc, want = bases[w], None, []
        for _ in range(genmul.GEN_ENTRIES):
            want.append(acc if acc is not None else (0, 0))
            acc = hm.g1_add(acc, base)
        got = list(zip(FP.from_words_many(tx[:, w]), FP.from_words_many(ty[:, w])))
        assert got == want
    rng = np.random.default_rng(7)
    for w, d in zip(rng.integers(0, 32, 64), rng.integers(1, 256, 64)):
        w, d = int(w), int(d)
        got = (FP.from_words_many(tx[:, w, d])[0], FP.from_words_many(ty[:, w, d])[0])
        assert got == hm.g1_mul(bases[w], d)


def test_fold_bit_identical_to_kzg_tpu_mul_gen():
    """The plain fold against the JAX package's fori_loop fold, both on the
    port's tables (passed to JAX as 16-bit limbs): the same Jacobian words,
    infinity (k = 0) and digit-0 windows included."""
    import jax.numpy as jnp

    from kzg_tpu.ops import curve as jcv
    from kzg_tpu.ops import genmul as jgm

    tx, ty = _tables()
    got = genmul.mul_gen(FR.tensor(KS, "cpu", mont=False))
    jtables = tuple(jnp.asarray(convert.to_jax_limbs(t)) for t in (tx, ty))
    want = jgm.mul_gen(jcv.G1, jcv.fr_to_device(KS, batch=True), tables=jtables)
    for g, w in zip(got, want):
        assert torch.equal(g, convert.from_jax_limbs(np.asarray(w), "cpu"))
    assert cv.g1_from_device(got) == [hm.g1_mul(hm.G1_GEN, k) if k else None for k in KS]
    digits = genmul._digits8(FR.tensor(KS, "cpu", mont=False))
    for g, s in zip(got, genmul.gen_fold_warp_plain(tx, ty, digits)):
        assert torch.equal(g, s)


def test_fold_cases_hold_their_exceptional_lanes():
    """The case table's lanes are what they claim: each doubling lane's
    partial sum after windows 0-30 is its window-31 entry (the madd
    doubles), lane 1 is k = 0 and lane 2 k = r - 1, lane 3 + w has digit 0
    in window w; and the plain fold gives the host oracle on them."""
    tx, ty = _tables()
    digits = fc.fold_digits(fc.CASE_LANES, 3, "cpu")
    lanes = list(fc.DOUBLING_LANES)
    head = digits[:, lanes].long().clone()
    head[-1] = 0
    (px, py), inf = cv.to_affine(genmul.gen_fold_plain(tx, ty, head))
    entry = head.new_tensor([fc.COLLIDE_DIGITS[-1]] * len(lanes))
    assert not bool(inf.any())
    assert torch.equal(px, tx[:, -1, entry]) and torch.equal(py, ty[:, -1, entry])
    assert fc.lane_scalar(digits, 1) == 0 and fc.lane_scalar(digits, 2) == hm.R - 1
    assert all(int(digits[w, lane]) == 0 for w, lane in enumerate(fc.ZERO_DIGIT_LANES))
    check = [0, 1, 2, 3, 35]
    got = genmul.gen_fold_plain(tx, ty, digits[:, check].long())
    assert cv.g1_from_device(got) == fc.oracle(digits, check)
    assert cv.g1_from_device(tuple(c[:, :1] for c in got)) == [
        hm.g1_mul(hm.G1_GEN, 2 * fc.COLLIDE % hm.R)]


@pytest.mark.parametrize("n", [1, fc.CASE_LANES, 70])
def test_gen_fold_warp_plain_equals_gen_fold_plain(n):
    """The kernel's order (lanes padded to whole warps, window 0 copied, the
    fast madd with the doubling computed only for a warp that needs it),
    emulated on the CPU, gives gen_fold_plain's words on the case table:
    one lane in a warp of 32, every case (two warps that double), and 70
    lanes in three warps, the last partial."""
    tx, ty = _tables()
    digits = fc.fold_digits(n, 11, "cpu").long()
    got = genmul.gen_fold_warp_plain(tx, ty, digits)
    assert all(torch.equal(a, b) for a, b in zip(got, genmul.gen_fold_plain(tx, ty, digits)))


def test_fold_entries_skips_sentinels_and_doubles():
    """K8's plain version: (0, 0) entries keep the accumulator, an all-(0, 0)
    lane is infinity, and a partial sum equal to the next entry doubles (the
    exact madd). It agrees with gen_fold on the entries gen_fold gathers, on
    every lane of the fold's case table and on KS (long runs of skipped
    windows: 1 << 128 has one entry, in window 16; 255 one, in window 0),
    and with the host oracle on KS and the case table's first lanes."""
    tx, ty = _tables()
    digits = torch.cat([fc.fold_digits(fc.CASE_LANES, 5, "cpu").long(),
                        genmul._digits8(FR.tensor(KS, "cpu", mont=False))], 1)
    idx = torch.arange(genmul.GEN_WINDOWS)[:, None]
    xs, ys = tx[:, idx, digits].permute(1, 0, 2), ty[:, idx, digits].permute(1, 0, 2)
    got = genmul.fold_entries(xs, ys)
    assert all(torch.equal(a, b) for a, b in zip(got, genmul.gen_fold(tx, ty, digits)))
    lanes = [0, 1, 2, 3, 35] + list(range(fc.CASE_LANES, fc.CASE_LANES + len(KS)))
    assert cv.g1_from_device(tuple(c[:, lanes] for c in got)) == fc.oracle(digits, lanes)
    # lane 0: P, P, (0, 0), P -> 3P; lane 1: all (0, 0); lane 2: P, Q, (0, 0), -P -> Q
    P, Q = hm.g1_mul(hm.G1_GEN, 5), hm.g1_mul(hm.G1_GEN, 11)
    lanes = [[P, P, (0, 0), P], [(0, 0)] * 4, [P, Q, (0, 0), hm.g1_neg(P)]]
    xs = torch.stack([FP.tensor([lane[w][0] for lane in lanes], "cpu") for w in range(4)])
    ys = torch.stack([FP.tensor([lane[w][1] for lane in lanes], "cpu") for w in range(4)])
    got = cv.g1_from_device(genmul.fold_entries(xs, ys))
    assert got == [hm.g1_mul(hm.G1_GEN, 15), None, Q]


def test_gen_fold_rejects_bad_input():
    tx, ty = _tables()
    bad = torch.zeros(genmul.GEN_WINDOWS, 2, dtype=torch.int64)
    bad[3, 1] = 256
    with pytest.raises(ValueError):
        genmul.gen_fold(tx, ty, bad)
    with pytest.raises(ValueError):
        genmul.gen_fold(tx, ty, -bad)
    with pytest.raises(ValueError):
        genmul.gen_fold(tx[:, :31], ty[:, :31], bad.clamp(max=0))
    with pytest.raises(ValueError):
        genmul.fold_entries(tx[:, 0], ty[:, 0])


def test_chunked_srs_g1_matches_oracle():
    """Three chunks of 4, the last one ragged: its padding must not leak."""
    s, n = 987654321, 10
    x, y = genmul.chunked_srs_g1(s, n, chunk=4, device="cpu")
    assert x.shape == y.shape == (FP.L, n)
    got = list(zip(FP.from_words_many(x), FP.from_words_many(y)))
    assert got == [hm.g1_mul(hm.G1_GEN, pow(s, k, hm.R)) for k in range(n)]
    with pytest.raises(ValueError):
        genmul.chunked_srs_g1(s, 0, device="cpu")


def test_chunked_srs_g1_refuses_an_infinity_lane(monkeypatch):
    """An infinity lane out of the fold is an upstream fault: the ceremony
    raises rather than encode it as (0, 0)."""
    def broken(k, tables=None):
        return tuple(torch.zeros((FP.L,) + tuple(k.shape[1:]), dtype=torch.int32)
                     for _ in range(3))

    monkeypatch.setattr(genmul, "mul_gen", broken)
    with pytest.raises(AssertionError, match="infinity"):
        genmul.chunked_srs_g1(3, 4, device="cpu")


def test_mul_gen_auto_routes_by_tables_and_size(monkeypatch):
    """Without tables and below the threshold: the generator ladder
    (cv.g1_gen_ladder, held to the oracle in test_torch_mul_ladder.py), no
    table build; at the threshold: the tables are built."""
    built = _tables()
    monkeypatch.setattr(genmul, "_tables", {})
    monkeypatch.setattr(genmul, "_build_tables", lambda device, group: built)
    ladder = []
    monkeypatch.setattr(cv, "g1_gen_ladder",
                        lambda k: ladder.append(k.shape) or genmul.mul_gen(k, built))
    ks = [3, hm.R - 2, 0]
    k = FR.tensor(ks, "cpu", mont=False)
    want = [hm.g1_mul(hm.G1_GEN, v) if v else None for v in ks]
    assert cv.g1_from_device(genmul.mul_g1_gen(k)) == want
    assert ladder == [(FR.L, 3)] and not genmul.tables_built("cpu")
    monkeypatch.setattr(genmul, "GENMUL_TABLE_THRESHOLD", 3)
    assert cv.g1_from_device(genmul.mul_gen_auto(k)) == want
    assert genmul.tables_built("cpu")
    one = genmul.mul_gen(FR.tensor([7], "cpu", mont=False)[:, 0])
    assert one[0].shape == (FP.L,)
    assert cv.g1_from_device(tuple(c[:, None] for c in one)) == [hm.g1_mul(hm.G1_GEN, 7)]


@pytest.mark.parametrize("steps", [1, 5])
def test_dbl_chain_bit_identical_to_kzg_tpu(steps):
    """The plain K7 against the JAX package's G1.double applied steps
    times, an infinity lane included. G1.double runs eagerly on the JAX
    package's compiled Fp operations (less than half the time of jitting it
    whole on one CPU core)."""
    from kzg_tpu.ops.curve import G1

    rng = np.random.default_rng(3)
    pts = [hm.g1_mul(hm.G1_GEN, int(k) + 1) for k in rng.integers(0, 1 << 62, 7)]
    zs = [int(z) % hm.P + 1 for z in rng.integers(0, 1 << 62, 7)]
    p = tuple(FP.tensor(v + [0], "cpu") for v in (
        [pt[0] * z * z % hm.P for pt, z in zip(pts, zs)],
        [pt[1] * z * z * z % hm.P for pt, z in zip(pts, zs)], zs))
    got = cv.dbl_chain(p, steps)
    want = tuple(convert.to_jax_limbs(c) for c in p)
    for _ in range(steps):
        want = G1.double(want)
    for g, w in zip(got, want):
        assert torch.equal(g, convert.from_jax_limbs(np.asarray(w), "cpu"))
    assert cv.g1_from_device(got) == [hm.g1_mul(pt, 1 << steps) for pt in pts] + [None]
    assert all(torch.equal(a, b) for a, b in zip(cv.dbl_chain(p, 0), p))


def test_dbl_windows_equals_the_old_loop_and_kzg_tpu():
    """The windowed K7's plain version (the table build's doubling chain)
    against the loop it replaced (g1_double, then a stack of the windows)
    and against the JAX package's G1.double run eagerly, on affine inputs
    with z the Montgomery one; every window equals 2^(steps k) P."""
    from kzg_tpu.ops.curve import G1

    steps, windows = 2, 3
    rng = np.random.default_rng(5)
    pts = [hm.g1_mul(hm.G1_GEN, int(k) + 1) for k in rng.integers(0, 1 << 62, 5)]
    x, y = (FP.tensor([pt[i] for pt in pts], "cpu") for i in range(2))
    got = cv.dbl_windows((x, y), steps, windows)
    cur = (x, y, FP.one_like(x))
    old = [cur]
    for _ in range(1, windows):
        for _ in range(steps):
            cur = cv.g1_double(cur)
        old.append(cur)
    old = tuple(torch.stack([w[k] for w in old], dim=1).reshape(FP.L, -1) for k in range(3))
    assert all(torch.equal(g, o) for g, o in zip(got, old))
    want = tuple(convert.to_jax_limbs(c) for c in (x, y, FP.one_like(x)))
    for k in range(windows):
        if k:
            for _ in range(steps):
                want = G1.double(want)
        for g, w in zip(got, want):
            assert torch.equal(g[:, k * 5 : (k + 1) * 5],
                               convert.from_jax_limbs(np.asarray(w), "cpu"))
    assert cv.g1_from_device(got) == [hm.g1_mul(pt, 1 << (steps * k))
                                      for k in range(windows) for pt in pts]


@pytest.mark.slow
def test_tables_equal_kzg_tpu_tables():
    """The JAX package's own table build (a minute on the CPU) gives the
    port's tables word for word, through convert.gen_tables_from_jax."""
    from kzg_tpu.ops import curve as jcv
    from kzg_tpu.ops import genmul as jgm

    jtx, jty = jgm._build_tables(jcv.G1)
    for got, want in zip(convert.gen_tables_from_jax(np.asarray(jtx), np.asarray(jty), "cpu"),
                         _tables()):
        assert torch.equal(got, want)
