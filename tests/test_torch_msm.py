"""kzg_torch MSM layer on the CPU: the plain versions of K3 (bucket scan) and
K4 (point prefix scan) against the JAX package's CPU paths, the signed-digit
rewrite, and the fixed-base MSM against exact python ints.
Tolerance: exact equality (integer arithmetic)."""

import numpy as np
import pytest
import torch

from kzg_torch import convert
from kzg_torch.ops import curve as cv
from kzg_torch.ops import msm, scans
from kzg_torch.ops.field import FP
from kzg_torch.utils import hostmath as hm
from kzg_torch.utils.reduce_cases import BUCKET_CASES, TOP, bucket_case, weighted_oracle


def _points(n, seed):
    rng = np.random.default_rng(seed)
    ks = [int(k) + 2 for k in rng.integers(0, 1 << 62, size=n)]
    return ks, [hm.g1_mul(hm.G1_GEN, k) for k in ks]


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % hm.R for row in words]


def _affine(p):
    return cv.g1_from_device(tuple(c.reshape(FP.L, -1) for c in p))


@pytest.fixture(scope="module")
def tables64():
    """64 SRS-like points i * G (i = 1..64), one of them flagged infinite,
    and their fixed-base tables."""
    pts = [hm.g1_mul(hm.G1_GEN, i + 1) for i in range(64)]
    x, y, _ = cv.g1_to_device(pts, "cpu")
    mask = torch.zeros(64, dtype=torch.bool)
    mask[7] = True
    return pts, (x, y), mask, msm.precompute_g1_tables((x, y), mask)


def test_scan_bit_identical_to_kzg_tpu_lax_scan():
    """m = 8 steps over C = 16 chunks, chunk 3 meeting P == Q at step 1 (the
    fast mode flags it and the exact mode reruns), against kzg_tpu's
    lax.scan of exact madds on the same sorted stream."""
    from kzg_tpu.ops import msm as jmsm

    m, C = 8, 16
    _, pts = _points(m * C, 21)
    pts[3 * m + 1] = pts[3 * m]
    x, y, _ = cv.g1_to_device(pts, "cpu")  # (12, P), pair c * m + j
    xs = x.view(FP.L, C, m).permute(2, 0, 1)
    ys = y.view(FP.L, C, m).permute(2, 0, 1)
    _, flag = scans.scan_prefix_madd(xs, ys, fast=True)
    assert bool(flag)
    runs, _ = scans.scan_prefix_madd(xs, ys, fast=False)
    want_flat, want_totals = jmsm._fb_scan_cond_jit(
        convert.to_jax_limbs(x), convert.to_jax_limbs(y), m)
    for r, w, t in zip(runs, want_flat, want_totals):
        assert torch.equal(r.permute(1, 2, 0).reshape(FP.L, C * m),
                           convert.from_jax_limbs(np.asarray(w), "cpu"))
        assert torch.equal(r[-1], convert.from_jax_limbs(np.asarray(t), "cpu"))
    sums = _affine(tuple(r[-1] for r in runs))
    for c in (0, 3):
        acc = None
        for j in range(m):
            acc = hm.g1_add(acc, pts[c * m + j])
        assert sums[c] == acc


def test_hs_scan_bit_identical_to_kzg_tpu():
    """Suffix sums at W = 32 over 3 rows (the JAX package's weighted bucket
    reduction takes them), against kzg_tpu's _hs_scan_points (one block, so
    bit for bit)."""
    import jax

    from kzg_tpu.ops import msm as jmsm

    _, pts = _points(3 * 32, 22)
    pts[5] = None
    pts[40] = pts[41]
    jac = tuple(c.view(FP.L, 3, 32) for c in cv.g1_to_device(pts, "cpu"))
    got = scans.hs_scan_points(*jac, reverse=True)
    fn = jax.jit(lambda p: jmsm._hs_scan_points(p, axis=2, reverse=True))
    want = fn(tuple(convert.to_jax_limbs(c) for c in jac))
    for g, w in zip(got, want):
        assert torch.equal(g, convert.from_jax_limbs(np.asarray(w), "cpu"))


def _host_scan(pts, reverse, exclusive):
    """The host's prefix (or, reversed, suffix) sums of pts, inclusive or
    exclusive."""
    W = len(pts)
    order = range(W - 1, -1, -1) if reverse else range(W)
    want = [None] * W
    acc = None
    for k in order:
        if not exclusive:
            acc = hm.g1_add(acc, pts[k])
        want[k] = acc
        if exclusive:
            acc = hm.g1_add(acc, pts[k])
    return want


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("W", [5, 32, 300, 257, 1101])
def test_hs_scan_modes_match_host_sums(reverse, exclusive, W):
    """Every mode, within one block (W <= 256) and in the wide grouping: W =
    257 and 300 are one segment of runs of HS_RUN lanes (the last run
    partial); W = 1101 is two segments, the second one partial and ending in
    a partial run, whose totals are scanned in a second level. As group
    elements."""
    assert scans.HS_RUN * scans.HS_WIDE_BLOCK < 1101 < 2 * scans.HS_RUN * scans.HS_WIDE_BLOCK
    _, base = _points(8, 23)
    pts = [base[(3 * i) % 8] if i % 9 else None for i in range(W)]
    jac = tuple(c.view(FP.L, 1, W) for c in cv.g1_to_device(pts, "cpu"))
    got = _affine(scans.hs_scan_points(*jac, reverse=reverse, exclusive=exclusive))
    assert got == _host_scan(pts, reverse, exclusive)


@pytest.mark.parametrize("run,block", [(1, 2), (3, 5)])
@pytest.mark.parametrize("reverse", [False, True])
def test_hs_scan_wide_grouping_matches_host_sums(monkeypatch, run, block, reverse):
    """The wide grouping at other run and block sizes, over two rows of W =
    600: runs of 1 in segments of 2 make 300 segments, whose totals take the
    wide grouping again (a third level); runs of 3 in segments of 5 leave a
    partial run in a partial segment."""
    monkeypatch.setattr(scans, "HS_RUN", run)
    monkeypatch.setattr(scans, "HS_WIDE_BLOCK", block)
    _, base = _points(8, 24)
    W = 600
    pts = [base[(5 * i) % 8] if i % 7 else None for i in range(2 * W)]
    jac = tuple(c.view(FP.L, 2, W) for c in cv.g1_to_device(pts, "cpu"))
    got = _affine(scans.hs_scan_points(*jac, reverse=reverse))
    assert got == _host_scan(pts[:W], reverse, False) + _host_scan(pts[W:], reverse, False)


def test_signed_digits_recompose_and_match_kzg_tpu():
    from kzg_tpu.ops import msm as jmsm

    ks = _scalars(40, 24) + [0, 1, hm.R - 1, (1 << 16) - 1, 1 << 15, (1 << 15) + 1]
    k = cv.fr_std_words(ks, "cpu")
    absd, negd = msm.signed_digits(k)
    assert int(absd.max()) <= 1 << 15
    for j, kj in enumerate(ks):
        e = [(-1 if bool(negd[w, j]) else 1) * int(absd[w, j]) for w in range(16)]
        assert sum(ew << (16 * w) for w, ew in enumerate(e)) == kj
    ja, jn = jmsm._fb_digits_signed(convert.to_jax_limbs(k))
    assert np.array_equal(absd.numpy(), np.asarray(ja).astype(np.int64))
    assert np.array_equal(negd.numpy(), np.asarray(jn))


def test_tables_hold_window_multiples(tables64):
    pts, _, _, (tx, ty) = tables64
    n2 = 64
    assert tx.shape == (FP.L, 16 * n2)
    cols = [3, 7, 2 * n2 + 5, 15 * n2 + 63]
    got = cv.g1_from_device((tx[:, cols], ty[:, cols], FP.one_like(tx[:, cols])))
    # lane 7 is flagged infinite: its table column holds the generator's multiples
    want = [hm.g1_mul(pts[3], 1), hm.G1_GEN, hm.g1_mul(pts[5], 1 << 32),
            hm.g1_mul(pts[63], 1 << 240)]
    assert got == want


def test_msm_g1_fixed_matches_host(tables64):
    _, _, mask, tables = tables64
    ks = _scalars(64, 25)
    ks[0], ks[1], ks[2] = 0, 1, hm.R - 1
    ks[10] = ks[11] = 1 << 16  # a shared bucket
    got = msm.msm_g1_fixed(msm.point_table(tables), cv.fr_std_words(ks, "cpu"), inf_mask=mask)
    expect = sum((i + 1) * k for i, k in enumerate(ks) if i != 7) % hm.R
    assert _affine(got) == [hm.g1_mul(hm.G1_GEN, expect)]


def test_msm_g1_fixed_fewer_scalars_than_table(tables64):
    tables = msm.point_table(tables64[3])
    ks = _scalars(5, 26)
    got = msm.msm_g1_fixed(tables, cv.fr_std_words(ks, "cpu"), chunk=64)
    expect = sum((i + 1) * k for i, k in enumerate(ks)) % hm.R
    assert _affine(got) == [hm.g1_mul(hm.G1_GEN, expect)]
    with pytest.raises(ValueError):
        msm.msm_g1_fixed(tables, cv.fr_std_words(ks, "cpu"), chunk=48)
    with pytest.raises(ValueError):
        msm.msm_g1_fixed(tables, cv.fr_std_words(_scalars(65, 27), "cpu"))


def _scan_case(table_rows, m, C, seed):
    """Keys and sorted digits for a fused-scan test: digit 0 first, a run of
    2m + 3 equal digits (a whole chunk of one digit, and runs across chunk
    boundaries), absent digits, negative digits throughout, and at the start
    of chunk 2 a pair equal to its predecessor (P == Q: the madd doubles) and
    at chunk 3 its negation (P == -Q: the sum is infinity)."""
    P = m * C
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, table_rows, P)
    neg = rng.integers(0, 2, P).astype(bool)
    rows[2 * m + 1], neg[2 * m + 1] = rows[2 * m], neg[2 * m]
    rows[3 * m + 1], neg[3 * m + 1] = rows[3 * m], ~neg[3 * m]
    keys = torch.from_numpy(np.where(neg, rows | -(1 << 31), rows).astype(np.int32))
    digits = np.concatenate([np.zeros(5), np.full(2 * m + 3, 9),
                             rng.integers(10, 1 << 15, P - 2 * m - 8)])
    return keys, torch.from_numpy(np.sort(digits).astype(np.int32))


@pytest.mark.parametrize("m,C", [(8, 16), (16, 5)])
def test_scan_buckets_plain_equals_the_two_step_path(tables64, m, C):
    """The fused scan's plain version against the streaming path it
    replaces: gather the table points (negating y for a negative digit), the
    exact streaming scan (every prefix), then the chunk totals and the
    prefix at each digit's last position."""
    table = msm.point_table(tables64[3])
    keys, ds = _scan_case(table.shape[0], m, C, 30 + m)
    totals, U = scans.scan_buckets(table, keys, ds, m)
    assert all(int(c.abs().sum()) for c in totals)
    rows = (keys & 0x7FFFFFFF).long()
    neg = keys < 0
    x = table[rows, : FP.L].t()
    y = FP.select(neg, FP.neg(table[rows, FP.L :].t().contiguous()), table[rows, FP.L :].t())
    xs = x.reshape(FP.L, C, m).permute(2, 0, 1)
    ys = y.reshape(FP.L, C, m).permute(2, 0, 1)
    runs, _ = scans.scan_prefix_madd_plain(xs, ys, fast=False)
    for t, r in zip(totals, runs):
        assert torch.equal(t, r[-1])
    P = m * C
    last = [p for p in range(P) if p == P - 1 or ds[p] != ds[p + 1]]
    assert len(last) < P and int(ds[0]) == 0
    slots = ds[last].long()
    for u, r in zip(U, runs):
        assert torch.equal(u[:, slots], torch.stack([r[p % m, :, p // m] for p in last], dim=1))
        rest = torch.ones(u.shape[1], dtype=torch.bool)
        rest[slots] = False
        assert int(u[:, rest].abs().sum()) == 0
    # chunk 3's first two points cancel: its prefix after step 1 is infinity
    assert cv.g1_from_device(tuple(r[1, :, 3:4] for r in runs)) == [None]


def test_scan_buckets_checks_its_operands(tables64):
    table = msm.point_table(tables64[3])
    keys, ds = _scan_case(table.shape[0], 8, 4, 40)
    with pytest.raises(ValueError):
        scans.scan_buckets(table, keys, ds, 5)  # 5 does not divide 32
    with pytest.raises(ValueError):
        scans.scan_buckets(table[:, :12], keys, ds, 8)
    with pytest.raises(ValueError):
        scans.scan_buckets(table, keys, ds[:-1], 8)


def test_sort_pairs_keys_follow_a_stable_sort():
    """One sort of the composite key gives the stable sort's order: ties in
    pair order, the sign in bit 31 of the key."""
    rng = np.random.default_rng(41)
    absd = torch.from_numpy(rng.integers(0, 6, (16, 12)))
    negd = torch.from_numpy(rng.integers(0, 2, (16, 12)).astype(bool))
    keys, ds = msm.sort_pairs(absd, negd)
    want_ds, order = torch.sort(absd.reshape(-1), stable=True)
    assert torch.equal(ds.long(), want_ds)
    assert torch.equal((keys & 0x7FFFFFFF).long(), order)
    assert torch.equal(keys < 0, negd.reshape(-1)[order])


def test_point_table_is_point_major(tables64):
    tx, ty = tables64[3]
    table = msm.point_table((tx, ty))
    assert table.shape == (tx.shape[1], 24) and table.is_contiguous()
    assert torch.equal(table[:, :12], tx.t()) and torch.equal(table[:, 12:], ty.t())


def test_fb_chunk_size():
    assert msm.fb_chunk_size(16 * (1 << 20)) == 128  # 131,072 chunks at 2^20 points
    assert msm.fb_chunk_size(16 * 64) == 64
    assert msm.fb_chunk_size(32, 64) == 32


def test_tree_reduce_and_batched_affine_msm():
    ks, pts = _points(5, 28)
    jac = cv.g1_to_device(pts + [None], "cpu")
    total = _affine(msm.tree_reduce(jac))
    assert total == [hm.g1_mul(hm.G1_GEN, sum(ks))]
    x, y, _ = cv.g1_to_device(pts, "cpu")
    sc = [3, 0, hm.R - 1, 5, 7]
    mask = torch.tensor([False, False, False, True, False])
    got = msm.msm_batched_affine((x, y), cv.fr_std_words(sc, "cpu"), inf_mask=mask)
    expect = sum(k * s for k, s, m in zip(ks, sc, mask.tolist()) if not m) % hm.R
    assert _affine(got) == [hm.g1_mul(hm.G1_GEN, expect)]


@pytest.mark.slow
def test_msm_on_kzg_tpu_tables(tables64):
    """The port's MSM on the JAX package's own precompute_g1_tables output,
    and the port's tables (one windowed doubling chain) equal to it. Slow:
    compiling the JAX table build takes over a minute on a cold cache."""
    import jax.numpy as jnp

    from kzg_tpu.ops import msm as jmsm

    _, (x, y), mask, _ = tables64
    jt = jmsm.precompute_g1_tables(
        (jnp.asarray(convert.to_jax_limbs(x)), jnp.asarray(convert.to_jax_limbs(y))),
        jnp.asarray(mask.numpy()))
    # the windowed doubling chain's tables equal the JAX package's word for word
    for got, want in zip(tables64[3], jt[:2]):
        assert torch.equal(got, convert.from_jax_limbs(np.asarray(want), "cpu"))
    tables = convert.tables_from_jax(np.asarray(jt[0]), np.asarray(jt[1]), device="cpu")
    assert torch.equal(tables, msm.point_table(tables64[3]))
    ks = _scalars(64, 29)
    got = msm.msm_g1_fixed(tables, cv.fr_std_words(ks, "cpu"), inf_mask=mask)
    expect = sum((i + 1) * k for i, k in enumerate(ks) if i != 7) % hm.R
    assert _affine(got) == [hm.g1_mul(hm.G1_GEN, expect)]


def test_bucket_indices_pick_the_last_position_at_or_below_each_bucket():
    """slot_b is the largest present digit <= b, c_b the chunk of its last
    position, and buckets below the smallest digit are not valid."""
    ds = torch.tensor([2, 2, 2, 5, 9, 9, 9, 9], dtype=torch.int32)
    slot, c, valid = msm.bucket_indices(ds, 3)
    assert slot.dtype == c.dtype == torch.int32 and slot.shape == (scans.N_BUCKET_SLOTS,)
    assert valid[:2].tolist() == [False, False] and bool(valid[2:].all())
    assert slot[2:12].tolist() == [2, 2, 2, 5, 5, 5, 5, 9, 9, 9]
    assert c[2:12].tolist() == [0, 0, 0, 1, 1, 1, 1, 2, 2, 2]
    assert int(slot[-1]) == 9 and int(c[-1]) == 2


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_bucket_reduce_plain_matches_host(case):
    """The reduction's plain version (msm.bucket_reduce on a CPU tensor) on
    sparse bucket sums: (sum_b b k_b) G."""
    buckets = BUCKET_CASES[case]
    got = msm.bucket_reduce(*bucket_case(buckets, valid=case != "every bucket empty"))
    assert _affine(got) == weighted_oracle(buckets)


@pytest.mark.slow
def test_bucket_reduce_plain_matches_kzg_tpu_fbs_reduce():
    """kzg_tpu's _fbs_reduce (grid trees, suffix-weighted sums, Horner) on
    bucket sums S_b = k_b G built on the host from the bucket table, against
    the plain version (the telescoped tree) on the matching inputs: the same
    group element, and both the host oracle. Slow: the JAX reduction takes
    463-504 s on one CPU core, with a warm compile cache or a cold one."""
    from kzg_tpu.ops import msm as jmsm

    buckets = {**BUCKET_CASES["equal sums in a tree"], 0: 5, TOP: 9, TOP - 1: 2, 777: 3}
    S = cv.g1_to_device([hm.g1_mul(hm.G1_GEN, buckets[b]) if b in buckets else None
                         for b in range(scans.N_BUCKET_SLOTS)], "cpu")
    want = jmsm._fbs_reduce(tuple(convert.to_jax_limbs(c) for c in S))
    want = tuple(convert.from_jax_limbs(np.asarray(w), "cpu") for w in want)
    got = msm.bucket_reduce_plain(*bucket_case(buckets))
    assert _affine(got) == _affine(want) == weighted_oracle(buckets)


def test_bucket_reduce_checks_its_operands():
    inputs = bucket_case({})
    U, off, slot, c, valid = inputs
    with pytest.raises(ValueError):
        msm.bucket_reduce(tuple(u[:, :-1] for u in U), off, slot[:-1], c[:-1], valid[:-1])
    with pytest.raises(ValueError):
        msm.bucket_reduce(U, (off[0], off[1], off[2][:, :1].reshape(-1)), slot, c, valid)
