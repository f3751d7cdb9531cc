"""LinearLU, the invertible 1x1 feature mixer of every shipped preset.

Counterpart of `flowcompare_tpu/flows/permuters.py` (`init_linear_lu`,
`linear_lu_forward`, `linear_lu_prepare_stack`). W = L @ U with a unit
lower triangle and an upper triangle whose diagonal is softplus(.) + eps;
z = x @ W^T and log|det W| = sum(log diag).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_linear_lu(num_features: int, *, eps: float = 1e-3) -> dict:
    """Identity init (the only one the model uses): W = I up to eps."""
    n_tri = (num_features - 1) * num_features // 2
    constant = math.log(math.exp(1 - eps) - 1)
    return {
        "lower_entries": torch.zeros(n_tri),
        "upper_entries": torch.zeros(n_tri),
        "unconstrained_upper_diag": torch.full((num_features,), constant),
    }


def _lu_matrices(params: dict, eps: float):
    """Stacked or single (..., D, D) lower, upper and the (..., D) diagonal."""
    diag_raw = params["unconstrained_upper_diag"]
    d = diag_raw.shape[-1]
    lead = diag_raw.shape[:-1]
    tril = torch.tril_indices(d, d, offset=-1, device=diag_raw.device)
    triu = torch.triu_indices(d, d, offset=1, device=diag_raw.device)
    lower = torch.eye(d, dtype=diag_raw.dtype, device=diag_raw.device).expand(
        *lead, d, d).clone()
    lower[..., tril[0], tril[1]] = params["lower_entries"]
    upper_diag = F.softplus(diag_raw) + eps
    upper = torch.zeros(*lead, d, d, dtype=diag_raw.dtype, device=diag_raw.device)
    upper[..., triu[0], triu[1]] = params["upper_entries"]
    idx = torch.arange(d, device=diag_raw.device)
    upper[..., idx, idx] = upper_diag
    return lower, upper, upper_diag


def linear_lu_forward(params: dict, x: torch.Tensor, *, eps: float = 1e-3):
    lower, upper, upper_diag = _lu_matrices(params, eps)
    z = (x @ upper.T) @ lower.T
    ldj = torch.log(upper_diag.float()).sum().expand(x.shape[:-1])
    return z, ldj


def linear_lu_prepare_stack(stacked: dict, *, eps: float = 1e-3, dtype=None):
    """Fold a stack of LinearLU params (leading layer axis) into dense
    weights W = L @ U and per-layer log-dets: {"w_folded": (L, D, D),
    "ldj": (L,)}. dtype rounds W to the compute dtype, as the JAX package
    does under the bf16 policy."""
    lower, upper, diag = _lu_matrices(stacked, eps)
    w = torch.matmul(lower, upper)
    if dtype is not None:
        w = w.to(dtype)
    ldj = torch.log(diag.float()).sum(-1)
    return {"w_folded": w, "ldj": ldj}
