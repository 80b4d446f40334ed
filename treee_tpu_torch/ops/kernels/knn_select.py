"""The focused view's exact k-NN selection: the CUDA kernel
``csrc/knn_select.cu`` and its plain version.

No TPU kernel of the JAX package does this: it selects with ``lax.top_k``
over tiles of distances (``treee_tpu/ops/neighbors.py::knn_bruteforce``).
The plain version below is the port's tiled brute force: a ``[tile, N]``
block of squared distances, then ``smallest_k``'s int64 keys (distance bits
above the row) through ``torch.topk``.  The kernel stages the candidates in
shared memory and keeps each row's k least keys in registers (see the
source's note); the two agree bit for bit.  The kernel's lists hold at most
``MAX_K`` rows; the plain version, and so the CPU, takes any k.
"""

from __future__ import annotations

import torch

from . import build

INF = 3.0e38
MAX_K = 64


def _check(pos, valid, k: int, tile: int) -> None:
    if pos.dtype != torch.float32 or pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"knn_select: need f32[N,3] positions, got "
                         f"{pos.dtype}{list(pos.shape)}")
    if valid.dtype != torch.bool or valid.shape != pos.shape[:1]:
        raise ValueError(f"knn_select: need bool{list(pos.shape[:1])} row "
                         f"flags, got {valid.dtype}{list(valid.shape)}")
    if k < 1:
        raise ValueError(f"knn_select: k must be at least 1, got {k}")
    if 0 < pos.shape[0] < k:
        raise ValueError(f"knn_select: k={k} exceeds the {pos.shape[0]} "
                         "rows")
    if tile < 1:
        raise ValueError(f"knn_select: tile must be >= 1, got {tile}")
    if pos.device != valid.device:
        raise ValueError("knn_select: inputs on different devices")


def smallest_k(d: torch.Tensor, k: int):
    """(position i64[T,k], value f32[T,k]) of the k smallest of each row of
    d f32[T,M] >= 0, ascending, ties to the lower position: one int64 key
    (the value's bits above the position) makes every entry distinct."""
    m = d.shape[1]
    pos = torch.arange(m, dtype=torch.int64, device=d.device)
    key = (d.view(torch.int32).to(torch.int64) << 32) | pos
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return top & 0xFFFFFFFF, (top >> 32).to(torch.int32).view(torch.float32)


def _pairwise_sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """|q_i - p_j|^2 for f32[T,3] x f32[N,3] -> f32[T,N]: the differences
    squared and summed as ``(dx^2 + dy^2) + dz^2``, in place."""
    d = q[:, 0:1] - p[:, 0]
    d.mul_(d)
    for c in (1, 2):
        t = q[:, c:c + 1] - p[:, c]
        d += t.mul_(t)
    return d


def knn_select_plain(pos: torch.Tensor, valid: torch.Tensor, k: int,
                     tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(indices i32[N,k], sqdist f32[N,k]) of every row's k nearest rows
    among the valid ones, in query tiles of ``tile`` rows.  Invalid rows sit
    at distance INF, so a query with fewer than k valid rows is padded with
    them, lowest index first; ascending, ties to the lower index."""
    _check(pos, valid, k, tile)
    n = pos.shape[0]
    idx = torch.empty((n, k), dtype=torch.int32, device=pos.device)
    dist = torch.empty((n, k), dtype=torch.float32, device=pos.device)
    for t0 in range(0, n, tile):
        d = _pairwise_sqdist(pos[t0:t0 + tile], pos)
        d = torch.where(valid[None, :], d, INF)
        i, v = smallest_k(d, k)
        idx[t0:t0 + tile] = i.to(torch.int32)
        dist[t0:t0 + tile] = v
    return idx, dist


def knn_select(pos: torch.Tensor, valid: torch.Tensor, k: int, tile: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN (see :func:`knn_select_plain`): the kernel on CUDA
    tensors, the plain version on CPU tensors.  ``tile`` is the plain
    version's; the kernel stages the candidates as shared memory allows.
    On CUDA tensors ``k`` is at most ``MAX_K``."""
    _check(pos, valid, k, tile)
    if not build.on_cuda(pos, "knn_select"):
        return knn_select_plain(pos, valid, k, tile)
    if k > MAX_K:
        raise ValueError(f"knn_select: the kernel keeps at most {MAX_K} "
                         f"neighbours a row, got k={k}")
    n = pos.shape[0]
    idx = torch.empty((n, k), dtype=torch.int32, device=pos.device)
    dist = torch.empty((n, k), dtype=torch.float32, device=pos.device)
    if n == 0:
        return idx, dist
    pos, valid = pos.contiguous(), valid.contiguous()
    build.launch(build.library().treee_knn_select, "knn_select", pos,
                 pos.data_ptr(), valid.data_ptr(), idx.data_ptr(),
                 dist.data_ptr(), n, k)
    knn_select.launches += 1
    return idx, dist


knn_select.launches = 0
