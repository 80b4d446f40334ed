"""Segmented cumulative sum: the CUDA kernel ``csrc/seg_cumsum.cu`` and its
plain version.

Counterpart of ``segmented_cumsum_pallas`` (``treee_tpu/ops/pallas_kernels.py``).
A float sum depends on its order, and the order is part of what the TPU
kernel computes, so both versions here keep it: blocks of ``block`` rows,
shifted-doubling steps inside a block, then a carry chained from block to
block.  The plain version equals the Pallas kernel (in interpret mode) bit
for bit on the CPU, and the CUDA kernel equals the plain version on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

BLOCK = 8192
MAX_BLOCK = 8192
MAX_CHANNELS = 16


def _check(key: torch.Tensor, val: torch.Tensor, block: int) -> None:
    if key.dtype != torch.int32 or key.dim() != 1:
        raise ValueError(f"segmented_cumsum: need i32[N] keys, got "
                         f"{key.dtype}{list(key.shape)}")
    if (val.dtype != torch.float32 or val.dim() not in (1, 2)
            or val.shape[0] != key.shape[0]):
        raise ValueError(f"segmented_cumsum: need f32[N] or f32[N,C] values "
                         f"for {key.shape[0]} keys, got "
                         f"{val.dtype}{list(val.shape)}")
    if val.dim() == 2 and not 1 <= val.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"segmented_cumsum: 1..{MAX_CHANNELS} channels, "
                         f"got {val.shape[1]}")
    if not (1 <= block <= MAX_BLOCK and block & (block - 1) == 0):
        raise ValueError(f"segmented_cumsum: block must be a power of two in "
                         f"[1, {MAX_BLOCK}], got {block}")
    if val.device != key.device:
        raise ValueError("segmented_cumsum: keys and values on different devices")


def segmented_cumsum_plain(key: torch.Tensor, val: torch.Tensor,
                           block: int = BLOCK) -> torch.Tensor:
    """Forward inclusive sum of ``val`` (f32[N] or f32[N,C]) within runs of
    equal ``key`` (i32[N], sorted ascending); each run's last row holds the
    run total.

    The order of the additions is the Pallas kernel's: the rows are cut into
    blocks of ``block``; inside a block, steps s = 1, 2, 4, ... < block add
    ``where(same run as the row s back, its value, 0)`` to every row (so a
    -0.0 becomes +0.0 as in JAX); then block by block, rows whose key equals
    the previous block's last key add that row's final value.
    """
    _check(key, val, block)
    n = key.shape[0]
    if n == 0:
        return val.clone()
    v = val[:, None] if val.dim() == 1 else val
    c = v.shape[1]
    nb = -(-n // block)
    pad = nb * block - n
    # padded rows follow the real ones, and a row only reads rows before it
    k = torch.cat([key, key.new_zeros(pad)]).view(nb, block)
    x = torch.cat([v, v.new_zeros(pad, c)]).view(nb, block, c)
    s = 1
    while s < block:
        same = (k[:, s:] == k[:, :-s])[..., None]
        cand = torch.zeros_like(x)
        cand[:, s:] = torch.where(same, x[:, :-s], 0.0)
        x = x + cand
        s *= 2
    if nb > 1:
        # the carry: block i-1's last row after its own carry, a sequential
        # recurrence over nb rows, run on the host in f32
        last_key = k[:, -1].cpu().numpy()
        last_val = x[:, -1].cpu().numpy()
        carry = np.zeros((nb, c), np.float32)
        has = np.zeros(nb, bool)
        inc = last_val[0]
        for i in range(1, nb):
            carry[i] = inc
            has[i] = True
            inc = (last_val[i] + inc if last_key[i] == last_key[i - 1]
                   else last_val[i])
        ck = torch.from_numpy(np.concatenate([[0], last_key[:-1]])
                              .astype(np.int32)).to(k.device)
        lead = torch.from_numpy(has).to(k.device)[:, None] & (k == ck[:, None])
        x = torch.where(lead[..., None],
                        x + torch.from_numpy(carry).to(x.device)[:, None, :],
                        x)
    out = x.reshape(nb * block, c)[:n]
    return out[:, 0].contiguous() if val.dim() == 1 else out.contiguous()


def segmented_cumsum(key: torch.Tensor, val: torch.Tensor,
                     block: int = BLOCK) -> torch.Tensor:
    """Segmented cumulative sum (see :func:`segmented_cumsum_plain`): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(key, val, block)
    if not build.on_cuda(key, "segmented_cumsum"):
        return segmented_cumsum_plain(key, val, block)
    n = key.shape[0]
    c = 1 if val.dim() == 1 else val.shape[1]
    out = torch.empty_like(val, memory_format=torch.contiguous_format)
    if n == 0:
        return out
    key = build.aligned(key)
    val = build.aligned(val)
    lib = build.library()
    scratch = torch.empty(lib.treee_seg_cumsum_scratch_bytes(n, c, block),
                          dtype=torch.uint8, device=key.device)
    build.launch(lib.treee_seg_cumsum, "segmented_cumsum", key,
                 key.data_ptr(), val.data_ptr(), out.data_ptr(), n, c, block,
                 scratch.data_ptr())
    segmented_cumsum.launches += 1
    return out


segmented_cumsum.launches = 0
