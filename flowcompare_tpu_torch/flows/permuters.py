"""Invertible 1x1 feature mixers and permuters.

Counterpart of `flowcompare_tpu/flows/permuters.py`:

* LinearLU, the mixer of every shipped preset (`init_linear_lu`,
  `linear_lu_forward`, `linear_lu_prepare_stack`,
  `linear_lu_prepare_inverse_stack`, `linear_lu_inverse`): W = L @ U with a
  unit lower triangle and an upper triangle whose diagonal is softplus(.)
  + eps; z = x @ W^T and log|det W| = sum(log diag). The inverse solves
  L t = z^T (unit diagonal) and then U x^T = t;
* fixed permutations (`init_permuter`, `init_reverse`, `permuter_forward`
  / `_inverse`): integer index vectors, log-det 0;
* FullCombiner: a dense W from an orthogonal init, log-det slogdet(W) and
  the inverse through inv(W);
* ExponentialCombiner: W = rescale * tanh(scale * w + shift) + reshift +
  eps, z = expm(W) x with log-det trace(W), the inverse expm(-W) z.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.initializers import orthogonal
from ..utils import expm


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
    """params is one layer's `linear_lu_prepare_stack` entry ({"w_folded",
    "ldj"}: one product with float32 sums, its operand cast to W's dtype)
    or its raw LinearLU params."""
    if "w_folded" in params:
        w = params["w_folded"]
        z = torch.matmul(x.to(w.dtype).float(), w.float().T).to(x.dtype)
        return z, params["ldj"].expand(x.shape[:-1])
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


def linear_lu_prepare_inverse_stack(stacked: dict, *, eps: float = 1e-3) -> dict:
    """Stacked (L, D, D) lower and upper matrices for the inverse solves."""
    lower, upper, _ = _lu_matrices(stacked, eps)
    return {"lower": lower, "upper": upper}


def linear_lu_inverse(params: dict, z: torch.Tensor, *, eps: float = 1e-3) -> torch.Tensor:
    """x with x @ W^T = z, by two triangular solves over all points at once.
    params is one layer's `linear_lu_prepare_inverse_stack` entry or its raw
    LinearLU params."""
    if "lower" in params:
        lower, upper = params["lower"], params["upper"]
    else:
        lower, upper, _ = _lu_matrices(params, eps)
    zt = z.reshape(-1, z.shape[-1]).T
    t = torch.linalg.solve_triangular(lower, zt, upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(upper, t, upper=True)
    return x.T.reshape(z.shape)


# ------------------------------------------------------- fixed permutations

def _with_inverse(perm: torch.Tensor) -> dict:
    return {"permutation": perm, "inv_permutation": torch.argsort(perm)}


def init_permuter(gen: torch.Generator, dim: int) -> dict:
    """A random permutation of the features and its inverse (int64 buffers)."""
    return _with_inverse(torch.randperm(dim, generator=gen))


def init_reverse(dim: int) -> dict:
    return _with_inverse(torch.arange(dim - 1, -1, -1))


def permuter_forward(params: dict, x: torch.Tensor):
    y = x.index_select(-1, params["permutation"].long())
    return y, torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)


def permuter_inverse(params: dict, y: torch.Tensor) -> torch.Tensor:
    return y.index_select(-1, params["inv_permutation"].long())


# ------------------------------------------------------------ FullCombiner

def init_full_combiner(gen: torch.Generator, dim: int) -> dict:
    return {"w": orthogonal(gen, dim)}


def full_combiner_forward(params: dict, x: torch.Tensor):
    _, logdet = torch.linalg.slogdet(params["w"].float())
    return x @ params["w"].T, logdet.expand(x.shape[:-1])


def full_combiner_inverse(params: dict, y: torch.Tensor) -> torch.Tensor:
    return y @ torch.linalg.inv(params["w"]).T


# ----------------------------------------------------- ExponentialCombiner

def init_exponential_combiner(gen: torch.Generator, dim: int) -> dict:
    return {"w": torch.randn(dim, dim, generator=gen), "scale": torch.ones(1) / 8,
            "shift": torch.zeros(1), "rescale": torch.ones(1), "reshift": torch.zeros(1)}


def _exp_combiner_mat(params: dict, eps: float) -> torch.Tensor:
    return (params["rescale"] * torch.tanh(params["scale"] * params["w"] + params["shift"])
            + params["reshift"] + eps)


def exponential_combiner_forward(params: dict, x: torch.Tensor, *, eps: float = 1e-8):
    w_mat = _exp_combiner_mat(params, eps)
    ldj = torch.diagonal(w_mat.float()).sum()
    return x @ expm(w_mat).T, ldj.expand(x.shape[:-1])


def exponential_combiner_inverse(params: dict, y: torch.Tensor, *,
                                 eps: float = 1e-8) -> torch.Tensor:
    return y @ expm(-_exp_combiner_mat(params, eps)).T
