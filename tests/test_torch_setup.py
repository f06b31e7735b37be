"""kzg_torch's setup.json on the CPU: SetupArtifact.from_json checks each G2
point as kzg_tpu's G2Point.from_json does (the same SerializationError
message for each malformed encoding), and the golden setup.json loads and
writes back byte for byte."""

import os

import pytest

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
