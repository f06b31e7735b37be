"""kzg_torch's batched point decompression (``ops/codec.py``) on the CPU
against kzg_tpu.ops.codec on the same blobs: the parsed words, sign and
infinity flags, every parse rejection with the same message (the first
malformed blob of a batch decides), the decompressed Jacobian words of both
groups, and the off-curve and off-subgroup rejections. Tolerance: exact
equality (integer arithmetic)."""

import numpy as np
import pytest

from kzg_torch import convert
from kzg_torch.errors import SerializationError
from kzg_torch.ops import codec
from kzg_torch.utils import hostmath as hm

KS = [1, 2, 3, hm.R - 1, 0x5D2A13FC6B4E8D0F9A7C3B1E6F2D4A8B0C9E7F1A3B5D7C9E1F3A5B7C9D1E3F5A]


def _g1_blobs():
    return [hm.g1_compress(hm.g1_mul(hm.G1_GEN, k)) for k in KS] + [hm.g1_compress(None)]


def _g2_blobs():
    return [hm.g2_compress(hm.g2_mul(hm.G2_GEN, k)) for k in KS] + [hm.g2_compress(None)]


def _off_curve_x(width: int):
    """The first x = 1, 2, ... with no point on the curve (G1) or x = (k, 0)
    with none on G2's, as compressed bytes."""
    k = 1
    while True:
        if width == 48 and hm.fp_sqrt(k ** 3 + hm.B_G1) is None:
            return bytes([0x80]) + k.to_bytes(47, "big")
        x = (k, 0)
        if width == 96 and hm.fp2_sqrt(hm.fp2_add(hm.fp2_mul(hm.fp2_sq(x), x), hm.B_G2)) is None:
            return bytes([0x80]) + bytes(47) + k.to_bytes(48, "big")
        k += 1


def _off_subgroup_g2() -> bytes:
    """An on-curve G2 point outside the prime-order subgroup: x = (k, 0) for
    the first k with a root (the cofactor is about 2^381)."""
    k = 1
    while True:
        x = (k, 0)
        y = hm.fp2_sqrt(hm.fp2_add(hm.fp2_mul(hm.fp2_sq(x), x), hm.B_G2))
        if y is not None:
            return hm.g2_compress((x, y))
        k += 1


def _tampered(width: int) -> dict:
    """One malformed blob per parse check, and two at once (the first
    decides)."""
    good = (_g1_blobs if width == 48 else _g2_blobs)()[0]
    p_bytes = hm.P.to_bytes(48, "big")
    return {
        "short": good[:-1],
        "no_compression_flag": bytes([good[0] & 0x7F]) + good[1:],
        "infinity_with_sign_bit": bytes([0xE0]) + bytes(width - 1),
        "infinity_with_stray_byte": bytes([0xC0]) + bytes(width - 2) + b"\x01",
        "infinity_with_x_bits": bytes([0xC1]) + bytes(width - 1),
        "x_not_below_p": bytes([0x80 | p_bytes[0]]) + p_bytes[1:] + good[48:],
        "x0_not_below_p": good[:48] + p_bytes if width == 96 else None,
    }


def _jax_error(fn, blobs):
    from kzg_tpu.errors import SerializationError as JaxSerializationError

    with pytest.raises(JaxSerializationError) as err:
        fn(blobs)
    return str(err.value)


@pytest.mark.parametrize("width", [48, 96])
def test_parse_matches_kzg_tpu(width):
    from kzg_tpu.ops import codec as jcodec

    blobs = (_g1_blobs if width == 48 else _g2_blobs)()
    ours = codec.parse_g1_compressed if width == 48 else codec.parse_g2_compressed
    theirs = jcodec.parse_g1_compressed if width == 48 else jcodec.parse_g2_compressed
    x, signs, inf = ours(blobs, "cpu")
    jx, jsigns, jinf = theirs(blobs)
    assert np.array_equal(convert.to_jax_limbs(x), np.asarray(jx))
    assert np.array_equal(signs.numpy(), np.asarray(jsigns))
    assert np.array_equal(inf.numpy(), np.asarray(jinf))
    for case, bad in _tampered(width).items():
        if bad is None:
            continue
        for batch in ([bad], blobs[:2] + [bad] + blobs[2:], [bad, _tampered(width)["short"]]):
            want = _jax_error(theirs, batch)
            with pytest.raises(SerializationError) as got:
                ours(batch, "cpu")
            assert str(got.value) == want, case


@pytest.mark.parametrize("group", ["G1", pytest.param("G2", marks=pytest.mark.slow)])
def test_decompress_bit_identical_to_kzg_tpu(group):
    """The Jacobian words of a batch (an infinity lane included), then an
    off-curve point's rejection, against the JAX package's batch (no
    subgroup check: its JAX scalar ladder is minutes on the CPU). G2 is
    slow: its JAX decompression compiles for 113 s on one core with a cold
    cache; test_decompress_matches_hostmath[G2] is its tier-1 twin."""
    from kzg_tpu.ops import codec as jcodec

    g1 = group == "G1"
    blobs = _g1_blobs() if g1 else _g2_blobs()
    ours = codec.g1_decompress_batch if g1 else codec.g2_decompress_batch
    theirs = jcodec.g1_decompress_batch if g1 else jcodec.g2_decompress_batch
    got, want = ours(blobs, device="cpu"), theirs(blobs)
    assert all(np.array_equal(convert.to_jax_limbs(a), np.asarray(b)) for a, b in zip(got, want))
    bad = blobs[:2] + [_off_curve_x(48 if g1 else 96)]
    with pytest.raises(SerializationError) as err:
        ours(bad, device="cpu")
    assert str(err.value) == _jax_error(theirs, bad) == "Point not on curve"


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_decompress_matches_hostmath(group):
    """The decompressed points (Z the Montgomery one, infinity in zero
    words) against the blobs' host points, and the off-curve rejection with
    hostmath's (and kzg_tpu's) message."""
    from kzg_torch.ops import curve as cv

    g1 = group == "G1"
    blobs = _g1_blobs() if g1 else _g2_blobs()
    ours = codec.g1_decompress_batch if g1 else codec.g2_decompress_batch
    want = [(hm.g1_decompress if g1 else hm.g2_decompress)(b) for b in blobs]
    jac = ours(blobs, device="cpu")
    assert (cv.g1_from_device if g1 else cv.g2_from_device)(jac) == want
    assert all(bool((c[..., -1] == 0).all()) for c in jac)
    bad = _off_curve_x(48 if g1 else 96)
    with pytest.raises(ValueError) as host:
        (hm.g1_decompress if g1 else hm.g2_decompress)(bad)
    with pytest.raises(SerializationError) as err:
        ours(blobs[:2] + [bad], device="cpu")
    assert str(err.value) == str(host.value) == "Point not on curve"


def test_subgroup_check_rejects_as_kzg_tpu_does():
    """With the subgroup check ([r] P == infinity through mul_scalar), a
    batch holding one on-curve G2 point outside the subgroup raises
    kzg_tpu's message (its host decoder's, the same string its batch
    raises); without the check it decodes. (Batches of subgroup points pass
    the check in tests/test_torch_setup.py.)"""
    from kzg_tpu.curves import G2Point
    from kzg_tpu.errors import SerializationError as JaxSerializationError

    bad = _g2_blobs()[-2:] + [_off_subgroup_g2()]
    with pytest.raises(JaxSerializationError) as want:
        G2Point.from_json(list(bad[-1]))
    with pytest.raises(SerializationError) as got:
        codec.g2_decompress_batch(bad, subgroup_check=True, device="cpu")
    assert str(got.value) == str(want.value) == "Point not in the prime-order subgroup"
    codec.g2_decompress_batch(bad, device="cpu")  # on the curve: no check, no error
