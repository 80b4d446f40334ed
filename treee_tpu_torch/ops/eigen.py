"""Closed-form eigenvalues and the smallest eigenvector of symmetric 3x3
matrices, batched; the port of ``treee_tpu/ops/eigen.py``.

Used by the curvature property: the eigenvalues of the 31-neighbour
covariance matrix, curve = 3*lambda_min / trace (treee/src/calculations.rs:
328-373,467-498).  The trigonometric solution is elementwise work over
``[..., 3, 3]``, no iteration.

Arithmetic follows the JAX package op for op: divisions by constants divide
two tensors (on CUDA ``tensor / float`` is a multiply by the reciprocal,
rounded twice), ``p**-3`` is ``1 / (p * (p * p))`` as ``lax.integer_pow``
computes it, and sums of three terms are ``(a + b) + c``.  ``acos`` and
``cos`` may differ from XLA's in the last bits, so the eigenvalues agree
with the JAX package to a few ulps of the matrix's scale.
"""

from __future__ import annotations

import math

import torch

from .f32 import div, full, sum3

TWO_THIRDS_PI = 2.0 * math.pi / 3.0


def eigvals_sym3(m: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (descending) of symmetric 3x3 matrices f32[..., 3, 3] ->
    f32[..., 3]."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a11, a12, a22 = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]

    p1 = sum3(a01 * a01, a02 * a02, a12 * a12)
    q = div(sum3(a00, a11, a22), 3.0)
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = sum3(b00 * b00, b11 * b11, b22 * b22) + 2.0 * p1
    p = torch.sqrt(torch.clamp(div(p2, 6.0), min=1e-30))

    # det(m - q I) by cofactor expansion
    det_b = (b00 * (b11 * b22 - a12 * a12)
             - a01 * (a01 * b22 - a12 * a02)
             + a02 * (a01 * a12 - b11 * a02))
    inv_p3 = torch.div(full(1.0, p), p * (p * p))
    r = torch.clamp(div(det_b, 2.0) * inv_p3, -1.0, 1.0)
    phi = div(torch.acos(r), 3.0)

    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + TWO_THIRDS_PI)
    e2 = 3.0 * q - e1 - e3

    eig = torch.stack([e1, e2, e3], dim=-1)
    # diagonal matrices (p1 == 0): the eigenvalues are the diagonal entries
    diag = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1,
                      descending=True).values
    return torch.where((p1 <= 1e-30)[..., None], diag, eig)


def curvature_from_cov(cov: torch.Tensor) -> torch.Tensor:
    """curve = 3*lambda_3 / (l1 + l2 + l3)  (calculations.rs:367-368)."""
    e = eigvals_sym3(cov)
    tr = sum3(e[..., 0], e[..., 1], e[..., 2])
    return torch.where(tr > 1e-20, torch.div(3.0 * e[..., 2], tr),
                       torch.zeros_like(tr))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, as separate products and differences."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _sq(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 over the last axis of size 3, keeping it."""
    return sum3(v[..., 0] * v[..., 0], v[..., 1] * v[..., 1],
                v[..., 2] * v[..., 2])[..., None]


def smallest_eigenvector(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue, f32[..., 3, 3] ->
    [..., 3]: the local surface normal of a neighbourhood covariance.

    The eigenvector spans the null space of (A - lambda_min I): the
    largest-norm pairwise cross product of its rows, which stays stable when
    one row degenerates.  Rank-deficient neighbourhoods (isolated points,
    perfect lines: no defined normal) fall back to +y; the sign is fixed so
    that y >= 0, for consistent shading of an aerial scan.
    """
    lam = eigvals_sym3(cov)[..., 2]
    a01, a02, a12 = cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]
    r0 = torch.stack([cov[..., 0, 0] - lam, a01, a02], dim=-1)
    r1 = torch.stack([a01, cov[..., 1, 1] - lam, a12], dim=-1)
    r2 = torch.stack([a02, a12, cov[..., 2, 2] - lam], dim=-1)
    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01, n02, n12 = _sq(c01), _sq(c02), _sq(c12)
    v = torch.where(n01 >= n02, c01, c02)
    nv = torch.maximum(n01, n02)
    v = torch.where(nv >= n12, v, c12)
    nv = torch.maximum(nv, n12)
    norm = torch.sqrt(torch.clamp(nv, min=1e-30))
    up = torch.zeros_like(v)
    up[..., 1] = 1.0
    v = torch.where(nv > 1e-24, v / norm, up)
    return torch.where(v[..., 1:2] < 0, -v, v)
