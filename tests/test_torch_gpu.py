"""kzg_torch kernels on the card against their plain versions, bit for bit,
at small shapes. Marked ``gpu``: each test skips where there is no CUDA
device. Run on a machine with a card:

    python -m pytest tests/test_torch_gpu.py -q -m gpu

(``chip_smoke.py`` runs the same comparisons at the 2^20 paths' shapes.)
"""

import numpy as np
import pytest
import torch

from kzg_torch.ops import curve as cv
from kzg_torch.ops import field as fld
from kzg_torch.ops import genmul, scans
from kzg_torch.ops import poly
from kzg_torch.ops.field import FP, FR
from kzg_torch.utils import fold_cases
from kzg_torch.utils import hostmath as hm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(F, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(F.L, n), dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(F.modulus >> (32 * (F.L - 1)))
    return torch.from_numpy(w.view(np.int32))


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_mont_mul_kernel_matches_plain(cuda, name):
    F = {"Fp": FP, "Fr": FR}[name]
    a, b = _rand(F, 1000, 1).to(cuda), _rand(F, 1000, 2).to(cuda)
    assert _same(fld.mont_mul(a, b, F), fld.mont_mul_plain(a, b, F))


def test_point_kernels_match_plain(cuda):
    p = tuple(_rand(FP, 300, s).to(cuda) for s in (3, 4, 5))
    q = tuple(_rand(FP, 300, s).to(cuda) for s in (6, 7, 8))
    q = (torch.cat([p[0][:, :4], q[0][:, 4:]], 1), torch.cat([p[1][:, :4], q[1][:, 4:]], 1),
         torch.cat([p[2][:, :4], q[2][:, 4:]], 1))
    p[2][:, 10:14] = 0
    assert _same(cv.g1_double(p), cv.g1_double_plain(p))
    assert _same(cv.g1_add(p, q), cv.g1_add_plain(p, q))
    assert _same(cv.g1_madd(p, q[:2]), cv.g1_madd_plain(p, q[:2]))
    got, need = cv.g1_madd(p, q[:2], fast=True)
    want, want_need = cv.g1_madd_plain(p, q[:2], fast=True)
    assert _same(got, want) and torch.equal(need.cpu(), want_need.cpu())


@pytest.mark.parametrize("fast", [True, False])
def test_scan_kernel_matches_plain(cuda, fast):
    m, C = 6, 37
    xs = _rand(FP, m * C, 9).to(cuda).view(FP.L, m, C).permute(1, 0, 2)
    ys = _rand(FP, m * C, 10).to(cuda).view(FP.L, m, C).permute(1, 0, 2)
    xs[1, :, 2] = xs[0, :, 2]
    ys[1, :, 2] = ys[0, :, 2]
    got, flag = scans.scan_prefix_madd(xs, ys, fast=fast)
    want, want_flag = scans.scan_prefix_madd_plain(xs, ys, fast=fast)
    assert _same(got, want) and bool(flag) == bool(want_flag) == fast


@pytest.mark.parametrize("W", [32, 257, 700, 2641])
def test_hs_scan_kernel_matches_plain(cuda, W):
    """One block (W = 32), one segment with a partial run (257), and several
    segments (700; 2641 ends in a partial run of a partial segment), with
    infinity lanes whose x and y are not zero."""
    pts = tuple(_rand(FP, 2 * W, s).to(cuda).view(FP.L, 2, W) for s in (11, 12, 13))
    pts[2][:, :, ::5] = 0
    for reverse in (False, True):
        got = scans.hs_scan_points(*pts, reverse=reverse)
        assert _same(got, scans.hs_scan_points_plain(*pts, reverse=reverse))


@pytest.mark.parametrize("name", ["Fp", "Fr"])
@pytest.mark.parametrize("n", [1, 2, 300, 8192 + 300 + 7])
def test_inv_batch_kernel_matches_plain(cuda, name, n):
    """The inversion kernel against inv_batch_plain: zero lanes at the ends
    and at run and block boundaries, 1, N - 1 and R mod N; every non-zero
    lane times its inverse is Montgomery one."""
    F = {"Fp": FP, "Fr": FR}[name]
    a = _rand(F, n, 23).to(cuda)
    a[:, 0] = 0
    if n >= 300:
        a[:, [31, 32, 255, 256, n - 1]] = 0
        a[:, 1:4] = F.tensor([1, F.modulus - 1, F.R_int % F.modulus], cuda, mont=False)
    got = F.inv_batch(a)
    assert _same(got, F.inv_batch_plain(a))
    nz = ~F.is_zero(a)
    prod = fld.mont_mul_plain(a, got, F)
    assert bool((prod[:, nz] == F.const("ONE", cuda)).all())
    assert _same(F.inv_batch(torch.zeros_like(a)), torch.zeros_like(a))


@pytest.mark.parametrize("n", [1, 127, 128, 129, 256, 257, 100 * 256, 1 << 16])
def test_fold_kernels_match_plain(cuda, n):
    """K5 and K8 on the case table of kzg_torch/utils/fold_cases.py (a
    doubling lane, k = 0, k = r - 1, a zero digit in every window, a warp
    with three doubling lanes) and seeded digits: one lane, four warps and
    a partial one, one block of 256 and one lane past it, a partial wave
    (100 blocks of 256 on 132 SMs) and the ceremony's 2^16. K5 also
    against the CPU emulation of its warp order at n = 129."""
    tx, ty = genmul.gen_tables(cuda)
    digits = fold_cases.fold_digits(n, 14, cuda)
    got = genmul.gen_fold(tx, ty, digits)
    assert _same(got, genmul.gen_fold_plain(tx, ty, digits.long()))
    w = torch.arange(32, device=cuda)[:, None]
    xs = tx[:, w, digits.long()].permute(1, 0, 2)
    ys = ty[:, w, digits.long()].permute(1, 0, 2)
    assert _same(genmul.fold_entries(xs, ys), got)
    if n == 129:
        assert _same(genmul.gen_fold_warp_plain(tx, ty, digits.long()), got)
        assert _same(genmul.fold_entries_plain(xs, ys), got)
    lanes = [lane for lane in (0, 1, 2, 3, 35) if lane < n]
    assert cv.g1_from_device(tuple(c[:, lanes] for c in got)) == fold_cases.oracle(digits, lanes)


@pytest.mark.parametrize("steps", [1, 5, 16])
def test_dbl_chain_kernel_matches_plain(cuda, steps):
    p = tuple(_rand(FP, 200, s).to(cuda) for s in (15, 16, 17))
    p[2][:, 7:9] = 0
    assert _same(cv.dbl_chain(p, steps), cv.dbl_chain_plain(p, steps))


def test_mont_mul_kernel_on_edge_values(cuda):
    """Every pair of p - 1, 0, 1 and R mod p (Montgomery one), both fields:
    the carry chains' extremes."""
    for F in (FP, FR):
        edge = [F.modulus - 1, 0, 1, F.R_int % F.modulus]
        a = F.tensor([x for x in edge for _ in edge], cuda, mont=False)
        b = F.tensor([y for _ in edge for y in edge], cuda, mont=False)
        assert _same(fld.mont_mul(a, b, F), fld.mont_mul_plain(a, b, F))


def test_scan_buckets_kernel_matches_plain(cuda):
    """The fused scan on m = 8, C = 37: digit 0, absent digits, a run across
    chunks and a chunk of one digit, P == Q (chunk 2) and P == -Q (chunk 3)
    at a chunk's start."""
    m, C = 8, 37
    P = m * C
    rng = np.random.default_rng(18)
    table = torch.cat([_rand(FP, 64, 19), _rand(FP, 64, 20)]).t().contiguous().to(cuda)
    rows = rng.integers(0, 64, P)
    neg = rng.integers(0, 2, P).astype(bool)
    rows[2 * m + 1], neg[2 * m + 1] = rows[2 * m], neg[2 * m]
    rows[3 * m + 1], neg[3 * m + 1] = rows[3 * m], ~neg[3 * m]
    keys = torch.from_numpy(np.where(neg, rows | -(1 << 31), rows).astype(np.int32)).to(cuda)
    digits = np.concatenate([np.zeros(5), np.full(2 * m + 3, 9),
                             rng.integers(10, 1 << 15, P - 2 * m - 8)])
    ds = torch.from_numpy(np.sort(digits).astype(np.int32)).to(cuda)
    got = scans.scan_buckets(table, keys, ds, m)
    assert _same(got, scans.scan_buckets_plain(table, keys, ds, m))


@pytest.mark.parametrize("steps,windows", [(3, 4), (16, 2)])
def test_dbl_windows_kernel_matches_plain(cuda, steps, windows):
    p = (_rand(FP, 200, 21).to(cuda), _rand(FP, 200, 22).to(cuda))
    assert _same(cv.dbl_windows(p, steps, windows), cv.dbl_windows_plain(p, steps, windows))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9, 16, 17, 131, 1024, 1025, 128 * 1024 + 5])
def test_fr_poly_kernels_match_plain(cuda, n):
    """K1e and K1d against their plain versions, bit for bit (max word error
    0), at x = 0, 1, r - 1 and a seeded point: the CPU tests' sizes, a run
    and one (9), a tile (1024) and a tile and one, and 128 tiles and five
    (above 2^16: the top pass takes two tiles a thread)."""
    c = _rand(FR, n, 25).to(cuda)
    seeded = int(np.random.default_rng(26).integers(1, 1 << 62))
    for x in (0, 1, hm.R - 1, seeded):
        xw = FR.tensor([x], cuda)[:, 0]
        assert _same(poly.evaluate(c, xw), poly.evaluate_plain(c, xw))
        if n >= 2:
            assert _same(poly.synthetic_divide(c, xw), poly.synthetic_divide_plain(c, xw))


@pytest.mark.parametrize("case", ["every bucket empty", "equal sums in a tree",
                                  "P and -P in a tree", "P and -P at a block-tree level",
                                  "P and -P in the last tree", "random"])
def test_bucket_reduce_kernel_matches_plain(cuda, case):
    """The bucket reduction against bucket_reduce_plain, and against that
    route replayed on K2's add, bit for bit: every bucket invalid; equal
    leaves (the add doubles); P and -P meeting at a block-tree level and in
    the last block's tree (infinity); seeded words at C = 37 with infinity
    lanes and the first buckets invalid."""
    from kzg_torch.ops import msm
    from kzg_torch.utils.reduce_cases import BUCKET_CASES, bucket_case

    nb = scans.N_BUCKET_SLOTS
    if case == "random":
        U = tuple(_rand(FP, nb, s).to(cuda) for s in (27, 28, 29))
        U[2][:, 1::7] = 0
        off = tuple(_rand(FP, 37, s).to(cuda) for s in (30, 31, 32))
        rng = np.random.default_rng(33)
        slot = torch.from_numpy(np.sort(rng.integers(0, nb, nb)).astype(np.int32)).to(cuda)
        c = torch.from_numpy(np.sort(rng.integers(0, 37, nb)).astype(np.int32)).to(cuda)
        inputs = (U, off, slot, c, torch.arange(nb, device=cuda) >= 3)
        got = msm.bucket_reduce(*inputs)
    else:
        buckets = BUCKET_CASES[case]
        inputs = bucket_case(buckets, cuda, valid=case != "every bucket empty")
        want = sum(b * k for b, k in buckets.items()) % hm.R
        got = msm.bucket_reduce(*inputs)
        assert cv.g1_from_device(tuple(g[:, None] for g in got)) == [
            hm.g1_mul(hm.G1_GEN, want) if want else None]
    assert _same(got, msm.bucket_reduce_plain(*inputs))
    assert _same(got, msm.bucket_reduce_plain(*inputs, add=cv.g1_add))


def _ladder_case(cuda, n, seed):
    """n points base_i G on the card (K2's ladder, then to_affine) from
    seeded base_i, seeded scalars below r, then the exceptional lanes of
    ladder_cases.edge_lanes. Returns (x, y, k, mask, base, ks)."""
    from kzg_torch.utils.ladder_cases import edge_lanes, scalar_words

    rng = np.random.default_rng(seed)
    base = [int(v) + 2 for v in rng.integers(0, 1 << 62, size=n)]
    (x, y), _ = cv.to_affine(cv.mul_scalar_affine(cv.g1_gen_affine(cuda, n),
                                                  scalar_words(base, cuda)))
    ks = [int.from_bytes(rng.bytes(32), "little") % hm.R for _ in range(n)]
    mask = edge_lanes(x, y, base, ks)
    return x, y, scalar_words(ks, cuda), mask, base, ks


@pytest.mark.parametrize("n", [1, 2, 3, 127, 128, 129, 8192, 16383, 65536])
def test_ladder_msm_kernel_matches_plain(cuda, n):
    """K2b against msm_batched_plain and against that route replayed on K2's
    kernels, bit for bit, and against the host oracle, with and without the
    mask, on the exceptional lanes of ladder_cases.edge_lanes: a partial
    block (1, 2, 3, 127), one whole block (128), a block and one lane (129),
    the 8192-point commit's 64 blocks, 128 blocks less a lane, and 512
    blocks (the last block's levels take several sums a thread)."""
    from kzg_torch.ops import _build, msm
    from kzg_torch.utils.ladder_cases import oracle

    x, y, k, mask, base, ks = _ladder_case(cuda, n, 70 + n % 97)
    for m in (None, mask):
        before = _build.LAUNCHES["ladder_msm"]
        got = msm.msm_batched_affine((x, y), k, m)
        assert _build.LAUNCHES["ladder_msm"] == before + 1
        assert _same(got, msm.msm_batched_plain((x, y), k, m))
        assert _same(got, msm.msm_batched_plain((x, y), k, m, add=cv.g1_add, madd=cv.g1_madd,
                                                double=cv.g1_double))
        assert cv.g1_from_device(tuple(c[:, None] for c in got)) == oracle(base, ks, m)


def test_batched_commit_launches_the_ladder_only(cuda):
    """An 8192-coefficient commit against an 8192-point DeviceSRS (below the
    fixed-base threshold) launches K2b once and K2 never, and equals the
    host oracle (sum a_i k_i) G for the SRS points k_i G."""
    from kzg_torch import DeviceSRS, Polynomial
    from kzg_torch.ops import _build
    from kzg_torch.utils.ladder_cases import scalar_words

    n = 8192
    rng = np.random.default_rng(80)
    base = [int(v) + 2 for v in rng.integers(0, 1 << 62, size=n)]
    (x, y), _ = cv.to_affine(cv.mul_scalar_affine(cv.g1_gen_affine(cuda, n),
                                                  scalar_words(base, cuda)))
    coeffs = [int.from_bytes(rng.bytes(32), "little") % hm.R for _ in range(n)]
    poly = Polynomial.from_ints(coeffs, device=cuda)
    srs = DeviceSRS(x.contiguous(), y.contiguous(), None, [], n)
    _build.reset_launches()
    c = poly.commit(srs)
    launches = dict(_build.LAUNCHES)
    assert launches.get("ladder_msm") == 1
    assert not any(launches.get(k) for k in ("g1_double", "g1_madd", "g1_add"))
    assert c.affine() == hm.g1_mul(hm.G1_GEN, sum(a * b for a, b in zip(coeffs, base)) % hm.R)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1 << 16])
def test_g2_point_kernels_match_plain(cuda, n):
    """K9's double, add and madd against their plain versions (fp2 on the
    card's FP.mul) on the case table of kzg_torch/utils/g2_cases.py (p, q
    or both at infinity, P == Q, P == -Q, madd's first lane at infinity)
    and seeded words: one lane, a partial block of 64, two whole blocks,
    two and a lane, and the 2^16 setup's width; one launch each; the case
    lanes against the host oracle."""
    from kzg_torch.ops import _build
    from kzg_torch.utils import g2_cases

    p, q, qa = g2_cases.case_points(n, 90 + n % 13, cuda)
    for op, kern, plain, args in (("double", cv.g2_double, cv.g2_double_plain, (p,)),
                                  ("add", cv.g2_add, cv.g2_add_plain, (p, q)),
                                  ("madd", cv.g2_madd, cv.g2_madd_plain, (p, qa))):
        before = _build.LAUNCHES[f"g2_{op}"]
        got = kern(*args)
        assert _build.LAUNCHES[f"g2_{op}"] == before + 1
        assert _same(got, plain(*args)), op
        m = min(n, g2_cases.CASE_LANES)
        aff = cv.g2_from_device(tuple(c[..., :m] for c in got))
        for lane, want in g2_cases.oracle(90 + n % 13, op).items():
            assert lane >= m or aff[lane] == want, (op, g2_cases.CASES[lane])


@pytest.mark.parametrize("mode", ["a scalar a lane", "[r] P", "[k] G"])
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_mul_ladder_kernels_match_plain(cuda, name, mode):
    """The ladder kernels against their plain versions on the card, bit for
    bit, on the case table of mul_cases at n = 1, 9, 127, 128, 129 and 2^16.
    Mode A (g1_ladder, g2_ladder; naf_ladder_plain): mul_scalar_affine on
    affine_case (k = 0, 1, r - 1, 2^256 - 1, r, r + 2, r - 2, SPLIT_DOUBLE,
    and r - 2 on three lanes of warp 1) or mul_scalar(p, r) on public_case
    (a subgroup point, infinity, a point outside the subgroup, G1's point of
    order 3 or G2's off-subgroup point negated). Mode B (g1_gen_ladder,
    g2_gen_ladder; gen_ladder_plain): gen_case's scalars, not reduced. One
    launch a call; the plain version once over every size's lanes side by
    side (its cost is its steps); the case lanes against the host oracles
    by group element. Mode B's entry refuses bases of another piece count
    than its own (cudaErrorInvalidValue), so that curve.GEN_SPLIT_BITS
    cannot drift from the kernel's width unseen."""
    from kzg_torch.ops import _build
    from kzg_torch.utils import mul_cases

    group = {"G1": cv.G1, "G2": cv.G2}[name]
    counter = f"{name.lower()}_{'gen_' if mode == '[k] G' else ''}ladder"
    parts, outs = [], []
    for n in (1, 9, 127, 128, 129, 1 << 16):
        before = _build.LAUNCHES[counter]
        if mode == "a scalar a lane":
            (x, y), k, base = mul_cases.affine_case(group, n, 100 + n, cuda)
            out = cv.mul_scalar_affine((x, y), k, group=group)
            inf = torch.zeros(n, dtype=torch.bool, device=cuda)
            lanes, want = sorted(base), mul_cases.affine_oracle(group, base)
            want = [want[lane] for lane in lanes]
        elif mode == "[r] P":
            p, pts = mul_cases.public_case(group, n, 100 + n, cuda)
            out = cv.mul_scalar(p, mul_cases.PUBLIC, group=group)
            (x, y), inf = p[:2], group.is_inf(p)
            k = mul_cases.PUBLIC
            lanes, want = list(range(len(pts))), mul_cases.public_oracle(group, pts)
        else:
            k = mul_cases.gen_case(n, 100 + n, cuda)
            out = group.gen_ladder(k)
            lanes = list(range(min(n, len(mul_cases.SCALARS))))
            want = mul_cases.gen_oracle(group, k, lanes)
        assert _build.LAUNCHES[counter] == before + 1
        assert group.host_affine(*group.to_affine(tuple(c[..., lanes] for c in out))) == want
        parts.append((k,) if mode == "[k] G" else (x, y, *cv.naf_masks(k, n, cuda), inf))
        outs.append(out)
    cat = [torch.cat([p[j] for p in parts], -1) for j in range(len(parts[0]))]
    got = tuple(torch.cat([o[j] for o in outs], -1) for j in range(3))
    if mode == "[k] G":
        assert _same(got, cv.gen_ladder_plain(cat[0], group))
        bx, by = (c[..., :cv.GEN_SPLIT_PIECES // 2].contiguous()
                  for c in cv.split_bases(group, cuda))
        entry = getattr(_build.library(), f"kzg_{name.lower()}_gen_ladder")
        assert entry(bx.data_ptr(), by.data_ptr(), bx.shape[-1], k.data_ptr(),
                     *(o.data_ptr() for o in out), 1,
                     torch.cuda.current_stream().cuda_stream) == 1
    else:
        assert _same(got, cv.naf_ladder_plain(cat[:2], *cat[2:], group=group))


def test_scalar_multiplications_launch_one_ladder_a_group(cuda, monkeypatch):
    """Without generator tables, the generator multiplications of 9 lanes
    launch one Mode B ladder a group, the subgroup check of a decompressed
    batch one Mode A ladder a group, and none of K2's or K9's formulas."""
    from kzg_torch.ops import _build, codec

    monkeypatch.setattr(genmul, "_tables", {})
    k = FR.tensor([3, 10, hm.R - 1] * 3, cuda, mont=False)
    _build.reset_launches()
    g1 = genmul.mul_g1_gen(k)
    g2 = genmul.mul_g2_gen(k)
    codec.g1_decompress_batch([hm.g1_compress(p) for p in cv.g1_from_device(g1)], True, cuda)
    codec.g2_decompress_batch([hm.g2_compress(p) for p in cv.g2_from_device(g2)], True, cuda)
    launches = dict(_build.LAUNCHES)
    assert launches.get("g1_gen_ladder") == launches.get("g2_gen_ladder") == 1
    assert launches.get("g1_ladder") == launches.get("g2_ladder") == 1
    assert not any(launches.get(f"{g}_{op}") for g in ("g1", "g2") for op in ("double", "madd",
                                                                              "add"))
    assert cv.g2_from_device(g2)[:3] == [hm.g2_mul(hm.G2_GEN, v) for v in (3, 10, hm.R - 1)]


def test_g2_wrappers_refuse_mismatched_operands(cuda):
    p = tuple(torch.zeros(FP.L, 2, 4, dtype=torch.int32, device=cuda) for _ in range(3))
    with pytest.raises(ValueError):
        cv.g2_add(p, tuple(c[..., :3] for c in p))
    with pytest.raises(TypeError):
        cv.g2_double(tuple(c.long() for c in p))


def test_setup_on_the_card_equals_golden(cuda, monkeypatch):
    """generate_setup of 10 points from the golden secret on the card (the
    ladder kernel of each group without tables, then the tables) gives
    tests/golden/setup.json's bytes."""
    import os

    from kzg_torch import Scalar, generate_setup
    from kzg_torch import artifacts as art
    from kzg_torch.ops import genmul

    with open(os.path.join(os.path.dirname(__file__), "golden", "setup.json")) as f:
        want = f.read()
    secret = Scalar.from_be_bytes(bytes(range(32)))
    monkeypatch.setattr(genmul, "_tables", {})
    for built in (False, True):
        if built:
            genmul.gen_tables(cuda, cv.G1)
            genmul.gen_tables(cuda, cv.G2)
        setup = generate_setup(secret, 10, device=cuda)
        assert art.dumps([a.to_json() for a in setup]) == want, built


def _pairing_lanes(n, cuda):
    """Affine P (12, n), Q (12, 2, n): lane 0 the generators, the last lane
    (n > 1) the zero words of an infinity lane, the rest seeded canonical
    words (the Miller loop takes any)."""
    p = [_rand(FP, n, 40 + k).to(cuda) for k in range(2)]
    q = [_rand(FP, 2 * n, 42 + k).view(FP.L, 2, n).to(cuda) for k in range(2)]
    gens = cv.g1_gen_affine(cuda) + cv.g2_gen_affine(cuda)
    for c, g in zip(p + q, gens):
        c[..., :1] = g
        if n > 1:
            c[..., -1] = 0
    return tuple(p), tuple(q)


@pytest.mark.parametrize("n", [1, 33, 128])
def test_pairing_kernels_match_plain(cuda, n):
    """K10 and K11 against their plain versions (the towers on the card's
    FP.mul), one launch each; K11 on K10's outputs and a lane of random
    words; lane 0 (the generators) against hostmath's pairing."""
    from kzg_torch.ops import _build, fp12
    from kzg_torch.ops import pairing as pr

    p, q = _pairing_lanes(n, cuda)
    before = dict(_build.LAUNCHES)
    f = pr.miller_loop(p, q)
    assert _same(f, pr.miller_loop_plain(p, q))
    f = torch.cat([f, _rand(FP, 12, 44).view(FP.L, 2, 3, 2, 1).to(cuda)], dim=-1)
    g = pr.final_exponentiation(f)
    assert _same(g, pr.final_exponentiation_plain(f))
    for name in ("miller_loop", "final_exp"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    assert fp12.to_ints(g[..., 0]) == hm.pairing(hm.G1_GEN, hm.G2_GEN)


def test_pairing_wrappers_refuse_mismatched_operands(cuda):
    from kzg_torch.ops import pairing as pr

    p, q = _pairing_lanes(4, cuda)
    with pytest.raises(ValueError):
        pr.miller_loop(p, (q[0][..., :3], q[1][..., :3]))
    with pytest.raises(ValueError):
        pr.miller_loop((p[0].cpu(), p[1].cpu()), q)
    f = torch.zeros(FP.L, 2, 3, 2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pr.final_exponentiation(f[:, :, :2])
    with pytest.raises(TypeError):
        pr.final_exponentiation(f.long())
