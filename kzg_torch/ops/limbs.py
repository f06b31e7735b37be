"""Field-element layouts of the port: 32-bit words, limb-major.

An element of Fp (Fr) is held as an ``(L32, *batch)`` int32 tensor whose words
are the u32 digits of the value, least significant first: L32 = 12 for Fp and
8 for Fr. The limb axis leads, so neighbouring lanes of one limb sit on
neighbouring addresses and a kernel's loads coalesce. Regrouping the JAX
package's 16-bit limbs two at a time gives these words, so the two packages'
values compare bit for bit (``kzg_torch.convert``).

PyTorch has no unsigned 32-bit arithmetic on the CPU, so the plain (non-kernel)
versions work on 16-bit limbs widened to int64: ``words_to_limbs16`` and back.
A product of two limbs is below 2^32 and a column of 24 such products below
2^37, far inside int64.
"""

from __future__ import annotations

import numpy as np
import torch

MASK16 = 0xFFFF


def ints_to_words(values, n_words: int) -> np.ndarray:
    """Iterable of non-negative ints -> (n_words, len(values)) int32 words."""
    width = 4 * n_words
    try:
        raw = b"".join(v.to_bytes(width, "little") for v in values)
    except OverflowError:
        raise ValueError(f"value out of range for {n_words} words") from None
    arr = np.frombuffer(raw, dtype="<u4").reshape(-1, n_words)
    return arr.T.copy().view(np.int32)


def words_to_ints(words) -> list[int]:
    """(n_words, *batch) int32 words (tensor or array) -> flat list of ints."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    arr = np.asarray(words)
    flat = arr.reshape(arr.shape[0], -1).view(np.uint32).astype("<u4")
    raw = np.ascontiguousarray(flat.T).tobytes()
    width = 4 * arr.shape[0]
    return [int.from_bytes(raw[i : i + width], "little") for i in range(0, len(raw), width)]


def words_to_limbs16(w: torch.Tensor) -> torch.Tensor:
    """(L32, *batch) int32 -> (2*L32, *batch) int64 16-bit limbs."""
    w64 = w.to(torch.int64)
    lo = w64 & MASK16
    hi = (w64 >> 16) & MASK16
    return torch.stack([lo, hi], dim=1).reshape((2 * w.shape[0],) + tuple(w.shape[1:]))


def limbs16_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(2*L32, *batch) int64 canonical 16-bit limbs -> (L32, *batch) int32."""
    v = limbs[0::2] | (limbs[1::2] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


_SHIFTS: dict = {}


def local_passes(cols: torch.Tensor, passes: int):
    """Move each column's bits above 16 into the next column, ``passes``
    times (value kept; carries out of the top column are returned, not
    dropped). Columns below 2^(16 + 6 * 2^(passes - 1)) end in [0, 2^16]:
    one pass for a sum of two canonical numbers, three for product columns."""
    c = cols
    top = torch.zeros_like(c[0])
    for _ in range(passes):
        hi = c >> 16
        top = top + hi[-1]
        c = c & MASK16
        c[1:] += hi[:-1]
    return c, top


def normalize(cols: torch.Tensor, passes: int = 3):
    """Carry-normalize non-negative int64 columns to 16-bit limbs in a few
    whole-tensor steps.

    ``local_passes`` leaves every column in [0, 2^16] with only 0/1 carries
    pending. The rest is the carry chain of a binary addition: a column equal
    to 2^16 generates a carry, one equal to 0xFFFF propagates one, and with
    at most 62 columns the generate and propagate bits of a lane fit one
    int64, where a single add resolves the whole chain (the carry into bit k
    of A + B is bit k of (A + B) ^ A ^ B, with A = g | p and B = g).

    Returns (limbs, carry_out): limbs in [0, 2^16), carry_out the value
    carried out of the top column."""
    K = cols.shape[0]
    if K > 62:
        raise ValueError("normalize takes at most 62 columns")
    key = (K, cols.dim(), str(cols.device))
    if key not in _SHIFTS:
        sh = torch.arange(K, dtype=torch.int64, device=cols.device)
        sh = sh.reshape((K,) + (1,) * (cols.dim() - 1))
        _SHIFTS[key] = (sh, torch.ones_like(sh) << sh)
    sh, weight = _SHIFTS[key]
    c, top = local_passes(cols, passes)
    g = c >> 16
    a = g | (c == MASK16).to(torch.int64)
    gbits = (g * weight).sum(0)
    abits = (a * weight).sum(0)
    carries = (abits + gbits) ^ abits ^ gbits
    limbs = (c + ((carries.unsqueeze(0) >> sh) & 1)) & MASK16
    return limbs, top + ((carries >> K) & 1)
