"""The reference's order rules for min and max, shared by the states'
merges and the kernels' plain versions (the CUDA kernels code the same
rules in ``kernels/csrc/common.cuh``).

- Minimum follows Spark's NaN-largest order: NaN never wins, so it is the
  identity of a min.
- Maximum propagates NaN.
- Between zeros, -0.0 wins a min and +0.0 wins a max whatever the order of
  the operands, as XLA's min and max do in the reference.
"""

from __future__ import annotations

import torch


def min_nan_largest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise min under the NaN-largest order."""
    both_zero = (a == 0) & (b == 0)
    zero_min = torch.where(torch.signbit(a), a, b)
    mn = torch.where(both_zero, zero_min, torch.minimum(a, b))
    return torch.where(torch.isnan(a), b, torch.where(torch.isnan(b), a, mn))


def max_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise max with NaN propagation."""
    both_zero = (a == 0) & (b == 0)
    zero_max = torch.where(torch.signbit(a), b, a)
    return torch.where(both_zero, zero_max, torch.maximum(a, b))


def masked_min(v: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Min of ``v[keep]``, which holds no NaN; +inf when nothing is kept."""
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    mn = torch.where(keep, v, inf).amin() if v.numel() else inf
    neg_zero = (keep & (v == 0) & torch.signbit(v)).any()
    zero = torch.zeros_like(mn)
    return torch.where(mn == 0, torch.where(neg_zero, -zero, zero), mn)


def masked_max(v: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Max of ``v[keep]``, NaN if it holds one; -inf when nothing is kept."""
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    mx = torch.where(keep, v, -inf).amax() if v.numel() else -inf
    pos_zero = (keep & (v == 0) & ~torch.signbit(v)).any()
    zero = torch.zeros_like(mx)
    return torch.where(mx == 0, torch.where(pos_zero, zero, -zero), mx)
