"""kzg_torch's setup.json on the CPU: SetupArtifact.from_json checks each G2
point as kzg_tpu's G2Point.from_json does (the same SerializationError
message for each malformed encoding), and the golden setup.json loads and
writes back byte for byte; generate_setup and SetupArtifactsGenerator make
its bytes; DeviceSRS.load and load_setup's device batches give the
per-point path's points and kzg_tpu's rejections."""

import os

import pytest
import torch

from kzg_torch import artifacts as art
from kzg_torch.errors import SerializationError
from kzg_torch.trusted_setup import SetupArtifact
from kzg_torch.utils import hostmath as hm

GOLDEN_SETUP = os.path.join(os.path.dirname(__file__), "golden", "setup.json")


def _x_with_square(want_square: bool) -> tuple[int, int]:
    """The first x = (k, 0), k = 1, 2, ..., for which x^3 + 4(1 + u) is (or is
    not) a square in Fp2. A point on the curve found this way lies outside
    the prime-order subgroup (its cofactor is about 2^381)."""
    k = 1
    while True:
        x = (k, 0)
        rhs = hm.fp2_add(hm.fp2_mul(hm.fp2_sq(x), x), hm.B_G2)
        if (hm.fp2_sqrt(rhs) is not None) == want_square:
            return x
        k += 1


def _encode_x(x, flags: int = 0x80) -> list[int]:
    data = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    data[0] |= flags
    return list(data)


def _negatives():
    from kzg_tpu.utils import hostmath as jhm

    gen = jhm.g2_compress(jhm.G2_GEN)
    no_flag = bytearray(gen)
    no_flag[0] &= 0x7F
    inf = [0xC0] + [0] * 95
    stray = list(inf)
    stray[50] = 1
    return {
        "no_compression_flag": list(no_flag),
        "infinity_with_sign_bit": [0xE0] + [0] * 95,
        "infinity_with_stray_byte": stray,
        "x0_not_below_p": list(gen[:48]) + list(hm.P.to_bytes(48, "big")),
        "x1_not_below_p": _encode_x((1, hm.P)),
        "off_curve": _encode_x(_x_with_square(False)),
        "off_subgroup": _encode_x(_x_with_square(True)),
    }


@pytest.mark.parametrize("case", ["no_compression_flag", "infinity_with_sign_bit",
                                  "infinity_with_stray_byte", "x0_not_below_p",
                                  "x1_not_below_p", "off_curve", "off_subgroup"])
def test_setup_artifact_refuses_g2_as_kzg_tpu_does(case):
    from kzg_tpu.curves import G2Point
    from kzg_tpu.errors import SerializationError as JaxSerializationError

    g2 = _negatives()[case]
    with pytest.raises(JaxSerializationError) as want:
        G2Point.from_json(g2)
    g1 = list(hm.g1_compress(hm.G1_GEN))
    with pytest.raises(SerializationError) as got:
        SetupArtifact.from_json({"g1": g1, "g2": g2})
    assert str(got.value) == str(want.value)


def test_golden_setup_round_trips_byte_for_byte(tmp_path):
    setup = art.load_setup(GOLDEN_SETUP)
    path = str(tmp_path / "setup.json")
    art.save_setup(setup, path)
    with open(path, "rb") as f, open(GOLDEN_SETUP, "rb") as g:
        assert f.read() == g.read()
    # the point at infinity encodes as flags 0xC0 and 95 zero bytes
    assert hm.g2_decompress(bytes([0xC0] + [0] * 95)) is None


SECRET = bytes(range(32))  # the golden setup.json's (tests/golden/make_golden.py)


@pytest.fixture(scope="module")
def gen_tables():
    """Both groups' generator tables on the CPU, built once for this file:
    with them, the generator multiplications below the threshold take the
    fold instead of the 256-step ladder (the same words; both routes are
    held to hostmath in tests/test_torch_g2.py)."""
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import genmul

    genmul.gen_tables("cpu", cv.G1)
    genmul.gen_tables("cpu", cv.G2)


def _golden_bytes() -> str:
    with open(GOLDEN_SETUP) as f:
        return f.read()


def test_generate_setup_equals_golden(gen_tables):
    """generate_setup of 10 points from the golden secret gives the bytes of
    tests/golden/setup.json, the file kzg_tpu's test_golden.py is held to;
    its artifacts hold G2Points; 0 and 1 points are the edge counts."""
    from kzg_torch import G2Point, Scalar, generate_setup

    setup = generate_setup(Scalar.from_be_bytes(SECRET), 10, chunk=4, device="cpu")
    assert art.dumps([a.to_json() for a in setup]) == _golden_bytes()
    assert all(isinstance(a.g2, G2Point) for a in setup)
    assert setup[0].g2.affine() == hm.G2_GEN
    assert generate_setup(Scalar.from_be_bytes(SECRET), 0, device="cpu") == []
    assert len(generate_setup(Scalar.from_be_bytes(SECRET), 1, device="cpu")) == 1


@pytest.mark.parametrize("chunk", [2, 3, 16])
def test_setup_generator_equals_golden(gen_tables, chunk):
    """SetupArtifactsGenerator's items across chunk edges (its running power
    carried from chunk to chunk) give the golden bytes."""
    from kzg_torch import SetupArtifactsGenerator

    items = SetupArtifactsGenerator(SECRET, chunk=chunk, device="cpu").take(10)
    assert art.dumps([a.to_json() for a in items]) == _golden_bytes()


@pytest.mark.slow
def test_generate_setup_bytes_match_kzg_tpu(gen_tables):
    """Three points from the same secret in both packages: the same
    setup.json bytes. Slow: the JAX package's two 256-step ladders compile
    for minutes on one CPU core with a cold cache (51 s warm);
    test_generate_setup_equals_golden is its tier-1 twin."""
    from kzg_tpu import artifacts as jart
    from kzg_tpu.scalar import Scalar as JaxScalar
    from kzg_tpu.trusted_setup import generate_setup as jax_generate_setup

    from kzg_torch import Scalar, generate_setup

    secret = bytes(range(100, 132))
    ours = generate_setup(Scalar.from_be_bytes(secret), 3, device="cpu")
    theirs = jax_generate_setup(JaxScalar.from_be_bytes(secret), 3)
    assert art.dumps([a.to_json() for a in ours]) == jart._dumps([a.to_json() for a in theirs])


def test_device_srs_load_equals_from_artifacts():
    """DeviceSRS.load (the G1 points in one device batch, subgroup-checked)
    gives DeviceSRS.from_artifacts' words and the same two G2 points."""
    from kzg_torch import DeviceSRS

    loaded = DeviceSRS.load(GOLDEN_SETUP, device="cpu")
    want = DeviceSRS.from_artifacts(art.load_setup(GOLDEN_SETUP), device="cpu")
    assert len(loaded) == len(want) == 10 and loaded.g1_inf is None
    assert torch.equal(loaded.g1_x, want.g1_x) and torch.equal(loaded.g1_y, want.g1_y)
    assert loaded.g2 == want.g2 and len(loaded.g2) == 2


def test_load_setup_batched_path(monkeypatch, tmp_path):
    """load_setup's device batches (from _BULK_LOAD_MIN points; here every
    size): the golden file gives the per-point path's artifacts and writes
    back byte for byte; a short entry, an off-curve G1 point and x >= p
    raise kzg_tpu's messages."""
    import json

    from kzg_tpu import artifacts as jart
    from kzg_tpu.errors import SerializationError as JaxSerializationError

    per_point = art.load_setup(GOLDEN_SETUP)
    monkeypatch.setattr(art, "_BULK_LOAD_MIN", 1)
    monkeypatch.setattr(jart, "_BULK_LOAD_MIN", 1)
    batched = art.load_setup(GOLDEN_SETUP, device="cpu")
    assert [(a.g1, a.g2) for a in batched] == [(a.g1, a.g2) for a in per_point]
    path = str(tmp_path / "setup.json")
    art.save_setup(batched, path)
    assert open(path).read() == _golden_bytes()
    raw = json.loads(_golden_bytes())
    off_curve = [0x80] + [0] * 46 + [1]
    while hm.fp_sqrt(off_curve[-1] ** 3 + hm.B_G1) is not None:
        off_curve[-1] += 1
    for key, value in (("g2", [0xC0] + [0] * 94), ("g1", off_curve),
                       ("g1", list(bytes([0x80 | (hm.P >> 376)]) + hm.P.to_bytes(48, "big")[1:]))):
        bad = [dict(a) for a in raw]
        bad[3][key] = value
        with open(path, "w") as f:
            json.dump(bad, f)
        with pytest.raises(JaxSerializationError) as want:
            jart.load_setup(path)
        with pytest.raises(SerializationError) as got:
            art.load_setup(path, device="cpu")
        assert str(got.value) == str(want.value)
