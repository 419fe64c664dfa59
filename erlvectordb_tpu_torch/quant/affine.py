"""Affine (min/max) 8-bit and 4-bit quantization, batched on the device.

Counterpart of ``erlvectordb_tpu/quant/affine.py``: per-vector min/max
affine scaling to unsigned codes, with nibble packing for 4-bit (first value
in the high nibble), as torch functions on the tensor's device.  The codes,
minima and scales are bit-identical to the JAX package's.  The dequantizers
reproduce what XLA compiles ``codes / 255 * scale + mn`` to inside ``jit``:
``codes * (scale * f32(1/255)) + mn`` with one rounding (a fused
multiply-add).

Round-trip error bounds: 8-bit max-abs error <= range/255, 4-bit <= range/15.
"""

from __future__ import annotations

from typing import Tuple

import torch

from erlvectordb_tpu_torch.ops.fused_topk import _fma, mul_recip


def _minmax_scale(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mn = torch.amin(x, dim=-1, keepdim=True)
    mx = torch.amax(x, dim=-1, keepdim=True)
    rng = mx - mn
    scale = torch.where(rng > 0, rng, torch.ones_like(rng))
    return mn, scale


def _codes(x: torch.Tensor, levels: float):
    x = x.to(torch.float32)
    mn, scale = _minmax_scale(x)
    codes = torch.clamp(torch.round((x - mn) / scale * levels), 0, levels)
    return codes.to(torch.uint8), mn, scale


def quantize_u8(x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., D] f32 -> (codes uint8 [..., D], min [..., 1], scale [..., 1])."""
    return _codes(x, 255.0)


def dequantize_u8(codes: torch.Tensor, mn: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    return _fma(codes.to(torch.float32), mul_recip(scale, 255.0), mn)


def quantize_u4(x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., D] f32 -> (packed uint8 [..., ceil(D/2)], min, scale).  D is
    padded to even with a zero code before packing."""
    codes, mn, scale = _codes(x, 15.0)
    if codes.shape[-1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    return (codes[..., 0::2] << 4) | codes[..., 1::2], mn, scale


def unpack_u4(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """packed uint8 [..., P] -> f32 codes [..., dim] (high nibble first)."""
    codes = torch.stack([packed >> 4, packed & 0xF], dim=-1)
    return codes.reshape(*packed.shape[:-1], -1)[..., :dim].to(torch.float32)


def dequantize_u4(packed: torch.Tensor, mn: torch.Tensor, scale: torch.Tensor,
                  *, dim: int) -> torch.Tensor:
    return _fma(unpack_u4(packed, dim), mul_recip(scale, 15.0), mn)
