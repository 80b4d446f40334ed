"""Segmented cumulative max: the CUDA kernel ``csrc/seg_cummax.cu`` and its
plain version.

Counterpart of ``segmented_cummax_pallas`` (``treee_tpu/ops/pallas_kernels.py``)
and of ``treee_tpu/characteristics.py::_segmented_cummax``.
"""

from __future__ import annotations

import torch

from ..f32 import order, unorder
from . import build

MAX_CHANNELS = 16


def _check(key: torch.Tensor, val: torch.Tensor) -> None:
    if key.dtype != torch.int32 or key.dim() != 1:
        raise ValueError(f"segmented_cummax: need i32[N] keys, got "
                         f"{key.dtype}{list(key.shape)}")
    if (val.dtype != torch.float32 or val.dim() not in (1, 2)
            or val.shape[0] != key.shape[0]):
        raise ValueError(f"segmented_cummax: need f32[N] or f32[N,C] values "
                         f"for {key.shape[0]} keys, got "
                         f"{val.dtype}{list(val.shape)}")
    if val.dim() == 2 and not 1 <= val.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"segmented_cummax: 1..{MAX_CHANNELS} channels, "
                         f"got {val.shape[1]}")
    if val.device != key.device:
        raise ValueError("segmented_cummax: keys and values on different devices")


def segmented_cummax_plain(key: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Forward inclusive cumulative max of ``val`` (f32[N] or f32[N,C])
    within runs of equal ``key`` (i32[N], sorted ascending): shifted-doubling
    passes, each combining an element with the one ``s`` rows back when both
    lie in the same run.

    The max is taken over :func:`order` of the values, so its result does
    not depend on the order of combination: of +0.0 and -0.0 it is +0.0 (as
    XLA's maximum gives), and from the first NaN of a run on it is the NaN
    0x7FC00000."""
    _check(key, val)
    n = key.shape[0]
    out = order(val)
    s = 1
    while s < n:
        same = key[s:] == key[:-s]
        if out.dim() == 2:
            same = same[:, None]
        tail = torch.where(same, torch.maximum(out[s:], out[:-s]), out[s:])
        out = torch.cat([out[:s], tail])
        s *= 2
    return unorder(out)


def segmented_cummax(key: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Segmented cumulative max (see :func:`segmented_cummax_plain`): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(key, val)
    if not build.on_cuda(key, "segmented_cummax"):
        return segmented_cummax_plain(key, val)
    n = key.shape[0]
    c = 1 if val.dim() == 1 else val.shape[1]
    out = torch.empty_like(val, memory_format=torch.contiguous_format)
    if n == 0:
        return out
    key = build.aligned(key)
    val = build.aligned(val)
    lib = build.library()
    scratch = torch.empty(lib.treee_seg_cummax_scratch_bytes(n, c),
                          dtype=torch.uint8, device=key.device)
    build.launch(lib.treee_seg_cummax, "segmented_cummax", key,
                 key.data_ptr(), val.data_ptr(), out.data_ptr(), n, c,
                 scratch.data_ptr())
    segmented_cummax.launches += 1
    return out


segmented_cummax.launches = 0
