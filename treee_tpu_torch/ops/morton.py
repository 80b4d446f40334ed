"""Morton (Z-order) encoding, 10 bits per axis, as in ``treee_tpu/ops/morton.py``.

Bits are spread in int32: every intermediate of the magic-number dilation is
below 2^30, so no value needs the unsigned type that torch supports poorly.
(The ``<< 8`` step shifts only the low byte; the JAX package shifts all of it
in uint32 and drops the two bits that pass bit 31, which its mask clears.)
"""

from __future__ import annotations

import torch

MORTON_BITS = 10          # bits per axis
MORTON_SIZE = 1 << MORTON_BITS


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Dilate the low 10 bits of ``x`` (int32) so they occupy every 3rd bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | ((x & 0xFF) << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def quantize(pos: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Map f32[N,3] positions into int32[N,3] grid coords in [0, 1024)."""
    extent = torch.clamp((hi - lo).max(), min=1e-6)
    scaled = (pos - lo) / extent * (MORTON_SIZE - 1)
    return torch.clamp(scaled, 0, MORTON_SIZE - 1).to(torch.int32)


def encode(cell: torch.Tensor) -> torch.Tensor:
    """Interleave int32[N,3] grid coords into int32[N] Morton keys (x,y,z order)."""
    return (
        _spread3(cell[..., 0])
        | (_spread3(cell[..., 1]) << 1)
        | (_spread3(cell[..., 2]) << 2)
    )


def encode_positions(pos: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """f32[N,3] positions -> int32[N] Morton keys over the [lo, hi] bounding cube."""
    return encode(quantize(pos, lo, hi))


def _compact3(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_spread3`: gather every 3rd bit of ``x`` (int32)."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def decode(key: torch.Tensor) -> torch.Tensor:
    """Recover int32[..., 3] grid coords from int32 Morton keys.

    Shifts are arithmetic on int32, where the JAX package shifts the uint32
    image logically.  The two differ only in the top two bits of ``key >> 1``
    and ``key >> 2``, and the first mask of :func:`_compact3` (highest bit
    27) clears those, so every int32 key decodes as in the JAX package: the
    keys below 2^30, and the wrapped ``INVALID_KEY << s`` of a padded node
    table too."""
    return torch.stack([_compact3(key), _compact3(key >> 1),
                        _compact3(key >> 2)], dim=-1)


def sort_by_key(keys: torch.Tensor, *values: torch.Tensor
                ) -> tuple[torch.Tensor, ...]:
    """STABLE sort of ``values`` by ``keys`` (``jax.lax.sort``'s default):
    equal keys keep their input order, which the octree's ranks rely on."""
    keys_sorted, perm = torch.sort(keys, stable=True)
    return (keys_sorted,) + tuple(v[perm] for v in values)
