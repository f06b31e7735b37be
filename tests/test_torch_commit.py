"""kzg_torch commit slice on the CPU: the golden commitment.json bytes (the
file the JAX package's own test_golden.py holds kzg_tpu to), the routing of
Polynomial.commit, its error cases, the JAX-state converters, and that
importing kzg_torch pulls in neither jax nor kzg_tpu."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kzg_torch import DeviceSRS, G1Point, Polynomial, ProtocolError, Scalar, convert
from kzg_torch import artifacts as art
from kzg_torch.errors import KzgError, SerializationError
from kzg_torch.ops import msm
from kzg_torch.ops.field import FP, FR
from kzg_torch.trusted_setup import SetupArtifact
from kzg_torch.utils import hostmath as hm

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
COEFFS = [5**i + 10 for i in range(10)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(name: str) -> str:
    with open(os.path.join(GOLDEN, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def setup10():
    return art.load_setup(os.path.join(GOLDEN, "setup.json"))


def test_setup_json_round_trips(setup10, tmp_path):
    assert len(setup10) == 10
    path = str(tmp_path / "setup.json")
    art.save_setup(setup10, path)
    with open(path) as f:
        assert f.read() == _read("setup.json")


def test_commitment_bytes_match_golden(setup10, tmp_path):
    poly = Polynomial.from_ints(COEFFS, device="cpu")
    commitment = poly.commit(setup10)
    path = str(tmp_path / "commitment.json")
    art.save_commitment(art.CommitmentArtifact(polynomial=poly, commitment=commitment), path)
    with open(path) as f:
        assert f.read() == _read("commitment.json")
    loaded = art.load_commitment(path, device="cpu")
    assert loaded.commitment == commitment
    assert loaded.polynomial.coefficient_ints() == COEFFS


def test_device_srs_commit_equals_golden(setup10):
    srs = DeviceSRS.from_artifacts(setup10, device="cpu")
    assert len(srs) == 10 and srs.g1_inf is None
    commitment = Polynomial.from_ints(COEFFS[:4], device="cpu").commit(srs)
    s = sum(c * pow(0x000102030405060708090A0B0C0D0E0F101112131415161718191A1B1C1D1E1F, i, hm.R)
            for i, c in enumerate(COEFFS[:4]))
    assert commitment.affine() == hm.g1_mul(hm.G1_GEN, s)


def test_commit_routes_by_size(monkeypatch):
    """n >= FIXED_BASE_THRESHOLD goes to the fixed-base MSM against the SRS
    tables; smaller n to the batched ladder."""
    calls = []

    def fixed(tables, scalars, inf_mask=None, chunk=None):
        calls.append(("fixed", scalars.shape[1]))
        return tuple(torch.zeros(FP.L, dtype=torch.int32) for _ in range(3))

    def batched(pts, scalars, inf_mask=None):
        calls.append(("batched", scalars.shape[1]))
        return tuple(torch.zeros(FP.L, dtype=torch.int32) for _ in range(3))

    monkeypatch.setattr(msm, "msm_g1_fixed", fixed)
    monkeypatch.setattr(msm, "msm_batched_affine", batched)
    width = msm.FIXED_BASE_THRESHOLD
    srs = DeviceSRS(torch.zeros(FP.L, width, dtype=torch.int32),
                    torch.zeros(FP.L, width, dtype=torch.int32), None, [], width)
    srs._fb_tables = ("tables",)
    for n in (width, width - 1, 1):
        Polynomial.from_ints([1] * n, device="cpu").commit(srs)
    assert calls == [("fixed", width), ("batched", width - 1), ("batched", 1)]


def test_commit_errors_and_edge_polynomials(setup10):
    with pytest.raises(ProtocolError):
        Polynomial.from_ints(list(range(1, 12)), device="cpu").commit(setup10)
    empty = Polynomial.from_ints([], device="cpu")
    assert empty.num_coefficients == 0 and empty.degree() == 0
    assert empty.commit(setup10).is_infinity()
    assert empty.commit(setup10).to_json() == [0xC0] + [0] * 47
    zeros = Polynomial.from_ints([0, 0, 0], device="cpu")
    assert zeros.coefficient_ints() == [0]
    trimmed = Polynomial.from_ints([3, -1, 0, 0], device="cpu")
    assert trimmed.coefficient_ints() == [3, hm.R - 1] and trimmed.degree() == 1
    assert Polynomial.from_constant(Scalar.from_int(0), device="cpu").num_coefficients == 0


def test_scalar_semantics():
    assert Scalar.from_i128(-1).to_int() == hm.R - 1
    with pytest.raises(KzgError):
        Scalar.from_i128(2**127)
    s = Scalar.from_int(12345)
    assert Scalar.from_json(s.to_json()) == s
    assert Scalar.from_be_bytes(s.to_be_bytes()) == s
    assert s.mul(s).sub(s).add(s.neg().neg()).to_int() == 12345**2 % hm.R
    assert s.pow(3).to_int() == 12345**3 % hm.R
    assert FR.from_words_many(s.mont("cpu")[:, None]) == [12345] and str(s) == "12345"
    with pytest.raises(KzgError):
        Scalar.from_json([0] * 31)


def test_point_serialization_errors():
    g = G1Point.from_affine(hm.G1_GEN)
    assert G1Point.from_json(g.to_json()) == g
    with pytest.raises(SerializationError):
        G1Point.from_json([0] * 47)
    with pytest.raises(SerializationError):
        G1Point.from_json([0] * 48)  # no compression flag
    with pytest.raises(SerializationError):
        SetupArtifact.from_json({"g1": g.to_json(), "g2": [0] * 95})


def test_jax_state_converts_both_ways():
    from kzg_tpu.ops.field import FP as JFP

    vals = [0, 1, hm.P - 1, 0xDEADBEEF << 300]
    limbs = JFP.many_to_limbs(vals)
    words = convert.from_jax_limbs(limbs, "cpu")
    assert torch.equal(words, FP.tensor(vals, "cpu"))
    assert np.array_equal(convert.to_jax_limbs(words), limbs)
    pts = [hm.g1_mul(hm.G1_GEN, k) for k in (2, 3)]
    srs = convert.srs_from_jax(JFP.many_to_limbs([p[0] for p in pts]),
                               JFP.many_to_limbs([p[1] for p in pts]), device="cpu")
    assert len(srs) == 2
    assert torch.equal(srs.g1_x, FP.tensor([p[0] for p in pts], "cpu"))


def test_from_jax_limbs_runs_on_the_card_unless_asked():
    """Like every entry point, from_jax_limbs takes the card when no device
    is given, and raises where there is none; the CPU only when asked."""
    limbs = np.zeros((2 * FP.L, 3), np.uint32)
    if torch.cuda.is_available():
        assert convert.from_jax_limbs(limbs).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.from_jax_limbs(limbs)
    assert convert.from_jax_limbs(limbs, "cpu").device.type == "cpu"


def test_import_pulls_in_neither_jax_nor_kzg_tpu():
    code = ("import sys, kzg_torch, kzg_torch.artifacts, kzg_torch.convert, kzg_torch.ops.scans,"
            " kzg_torch.ops.genmul, kzg_torch.ops.poly, kzg_torch.ops.fp2, kzg_torch.ops.codec,"
            " kzg_torch.ops.fp6, kzg_torch.ops.fp12, kzg_torch.ops.pairing,"
            " kzg_torch.curves, kzg_torch.trusted_setup, kzg_torch.utils.g2_cases;"
            "from kzg_torch import bilinear_map;"
            "from kzg_torch.polynomial import verify_proofs_batch;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'kzg_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_without_the_card_or_the_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device, and when it stands alone without kzg_torch beside it."""
    script = os.path.join(REPO, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(script).read())
    runs = [alone]
    if not torch.cuda.is_available():
        runs.append(script)
    for path in runs:
        res = subprocess.run([sys.executable, str(path)], cwd=os.path.dirname(str(path)),
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
