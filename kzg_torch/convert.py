"""Carry state across from the JAX package.

The JAX package holds a field element as (24 | 16, ...) uint32 16-bit limbs;
the port as (12 | 8, ...) int32 words. With the same R the words are the
limbs regrouped in pairs, so the conversion is exact both ways. This module
imports neither JAX nor kzg_tpu: it takes and returns numpy arrays (pass
``np.asarray`` of a JAX array).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import msm as msmops
from .trusted_setup import DeviceSRS
from .utils.device import resolve_device


def from_jax_limbs(limbs, device=None) -> torch.Tensor:
    """(2L, ...) uint32 16-bit limbs -> (L, ...) int32 words on ``device``
    (the card unless asked for the CPU)."""
    device = resolve_device(device)
    a = np.asarray(limbs, dtype=np.uint32)
    if a.shape[0] % 2 or a.max(initial=0) > 0xFFFF:
        raise ValueError("expected an even number of 16-bit limbs")
    words = (a[0::2] | (a[1::2] << 16)).astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)


def to_jax_limbs(words: torch.Tensor) -> np.ndarray:
    """(L, ...) int32 words -> (2L, ...) uint32 16-bit limbs."""
    w = words.detach().cpu().numpy().view(np.uint32)
    out = np.empty((2 * w.shape[0],) + w.shape[1:], np.uint32)
    out[0::2] = w & 0xFFFF
    out[1::2] = w >> 16
    return out


def srs_from_jax(g1_x, g1_y, g1_inf=None, device=None) -> DeviceSRS:
    """A JAX DeviceSRS's G1 arrays -> a port DeviceSRS holding the same points
    (no G2 points: commit does not use them)."""
    device = resolve_device(device)
    x = from_jax_limbs(g1_x, device)
    y = from_jax_limbs(g1_y, device)
    inf = None if g1_inf is None else torch.from_numpy(np.asarray(g1_inf, bool)).to(device)
    return DeviceSRS(x, y, inf, [], x.shape[1])


def tables_from_jax(tx, ty, device=None):
    """The JAX package's fixed-base tables (24, 16 n2) -> the port's
    point-major (16 n2, 24) table, ready for ops.msm.msm_g1_fixed."""
    device = resolve_device(device)
    return msmops.point_table((from_jax_limbs(tx, device), from_jax_limbs(ty, device)))


def gen_tables_from_jax(tx, ty, device=None):
    """The JAX package's G1 generator tables, (24, 32, 256) uint32 limbs
    each, -> the port's (12, 32, 256) words, ready for ops.genmul.mul_gen."""
    device = resolve_device(device)
    return from_jax_limbs(tx, device), from_jax_limbs(ty, device)
