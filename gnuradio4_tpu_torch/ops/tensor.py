"""Tensor math helpers (≈ reference core Tensor.hpp / TensorMath.hpp /
math/gemm_simd.hpp).

The reference built its own N-D tensor + SIMD GEMM because C++ lacks one; here
torch *is* the tensor library — this module provides the named operations the
reference exposes (norms, GEMM/GEMV with accumulation control, outer/kron,
solve) so callers porting from GR4 find the same vocabulary. Every float32
product runs in full float32: :func:`~.precision.check_f32_matmul` refuses a
process that allows TF32.
"""

from __future__ import annotations

import torch

from .precision import check_f32_matmul


def _f32(x: torch.Tensor) -> torch.Tensor:
    """The operand as the product sees it: float32 accumulation (the JAX
    package's ``preferred_element_type=float32``); complex stays complex64."""
    return x if x.is_complex() else x.to(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, site: str) -> torch.Tensor:
    check_f32_matmul(site)
    return torch.matmul(_f32(a), _f32(b))


def gemm(a: torch.Tensor, b: torch.Tensor, *, alpha=1.0, beta=0.0,
         c: torch.Tensor | None = None) -> torch.Tensor:
    """alpha·A@B + beta·C (≈ gemm_simd.hpp:17), float32 accumulation."""
    out = alpha * _matmul(a, b, "gemm")
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


def gemv(a: torch.Tensor, x: torch.Tensor, *, alpha=1.0, beta=0.0,
         y: torch.Tensor | None = None) -> torch.Tensor:
    out = alpha * _matmul(a, x[..., None], "gemv")[..., 0]
    if y is not None and beta != 0.0:
        out = out + beta * y
    return out


def _dims(x: torch.Tensor, axis) -> tuple[int, ...]:
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def norm_l1(x: torch.Tensor, axis=None) -> torch.Tensor:
    return torch.sum(torch.abs(x), dim=_dims(x, axis))


def norm_l2(x: torch.Tensor, axis=None) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.abs(x) ** 2, dim=_dims(x, axis)))


def norm_inf(x: torch.Tensor, axis=None) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=_dims(x, axis))


def frobenius(a: torch.Tensor) -> torch.Tensor:
    return norm_l2(a.reshape(-1))


def outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.outer(x.reshape(-1), y.reshape(-1))


def kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.kron(a, b)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve(a, b)


def lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution, through the SVD as the JAX
    package's ``jnp.linalg.lstsq`` finds it (singular values below
    ``eps·max(M, N)·σ_max`` dropped), so a rank-deficient ``a`` takes the
    same answer on the card as on the CPU."""
    return _matmul(torch.linalg.pinv(a), b, "lstsq")


def matrix_power(a: torch.Tensor, n: int) -> torch.Tensor:
    check_f32_matmul("matrix_power")
    return torch.linalg.matrix_power(a, n)
