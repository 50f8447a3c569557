"""Batched distance computation (port of `scintirete_tpu/ops/distance.py`).

  L2:      sqrt(max(|q|^2 + |v|^2 - 2 q.v, 0))
  COSINE:  1 - clamp(q.v / (|q| |v|), -1, 1); any zero vector -> 1.0
  IP:      -(q.v)  (negated so lower-is-better everywhere)

Products run in f32: bf16 inputs are widened first (a bf16 x bf16 product is
exact in f32, which is what the JAX version's f32 accumulation gives), and
f32 inputs multiply in full f32 (TF32 is off, see the package docstring).
The numpy versions are copies of the JAX package's host oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from scintirete_tpu_torch.types import DistanceMetric

_L2 = int(DistanceMetric.L2)
_COSINE = int(DistanceMetric.COSINE)
_IP = int(DistanceMetric.INNER_PRODUCT)

_EPS = 1e-30


def preprocess_norms(base: torch.Tensor) -> torch.Tensor:
    """Squared L2 row norms of the base matrix, f32 [N]."""
    b = base.float()
    return (b * b).sum(dim=-1)


def pairwise_distance(
    queries: torch.Tensor,  # [B, D] float
    base: torch.Tensor,  # [N, D] float (f32 or bf16)
    metric: int,
    base_sq_norms: torch.Tensor | None = None,  # [N] f32, optional precompute
) -> torch.Tensor:
    """All-pairs distances [B, N], f32, lower is better for every metric."""
    q = queries
    if q.dtype != base.dtype:
        # the JAX version meets at the base's storage dtype
        q = q.to(base.dtype)
    dots = q.float() @ base.float().T  # [B, N]
    if metric == _IP:
        return -dots
    if base_sq_norms is None:
        base_sq_norms = preprocess_norms(base)
    q32 = queries.float()  # norms from the ORIGINAL precision
    q_sq = (q32 * q32).sum(dim=-1, keepdim=True)
    return dist_from_dots(dots, q_sq, base_sq_norms[None, :], metric)


def dist_from_dots(dots, q_sq, b_sq, metric: int):
    """Metric formulas given dot products and squared norms (broadcastable)."""
    if metric == _IP:
        return -dots
    if metric == _L2:
        sq = q_sq + b_sq - 2.0 * dots
        return torch.sqrt(torch.clamp(sq, min=0.0))
    if metric == _COSINE:
        denom = torch.sqrt(q_sq) * torch.sqrt(b_sq)
        cos = torch.where(
            denom > _EPS, dots / torch.clamp(denom, min=_EPS), 0.0
        )
        cos = torch.clamp(cos, -1.0, 1.0)
        # reference: zero query or zero base vector -> distance 1.0
        zero = (q_sq <= _EPS) | (b_sq <= _EPS)
        return torch.where(zero, 1.0, 1.0 - cos)
    raise ValueError(f"unsupported metric code: {metric}")


# ---------------------------------------------------------------------------
# Host (numpy) versions — the correctness oracle and the host-side build path.
# ---------------------------------------------------------------------------


def distance_np(
    queries: np.ndarray, base: np.ndarray, metric: int | DistanceMetric
) -> np.ndarray:
    """Numpy mirror of `pairwise_distance`; accepts [D] or [B,D] queries."""
    metric = int(metric)
    q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    b = np.asarray(base, dtype=np.float32)
    single = np.asarray(queries).ndim == 1
    dots = q @ b.T
    if metric == _IP:
        out = -dots
    else:
        q_sq = np.sum(q * q, axis=-1, keepdims=True)
        b_sq = np.sum(b * b, axis=-1)
        if metric == _L2:
            out = np.sqrt(np.maximum(q_sq + b_sq[None, :] - 2.0 * dots, 0.0))
        elif metric == _COSINE:
            denom = np.sqrt(q_sq) * np.sqrt(b_sq[None, :])
            with np.errstate(divide="ignore", invalid="ignore"):
                cos = np.where(denom > _EPS, dots / np.maximum(denom, _EPS), 0.0)
            cos = np.clip(cos, -1.0, 1.0)
            zero = (q_sq <= _EPS) | (b_sq[None, :] <= _EPS)
            out = np.where(zero, 1.0, 1.0 - cos)
        else:
            raise ValueError(f"unsupported metric code: {metric}")
    return out[0] if single else out


def normalize_np(v: np.ndarray) -> np.ndarray:
    """Unit-normalize rows; zero rows stay zero."""
    v = np.asarray(v, dtype=np.float32)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(norm > _EPS, v / np.maximum(norm, _EPS), v)
