"""Multi-temporal point-cloud co-registration (offline, host-side).

Counterpart of `flowcompare_tpu/data/registration.py`, the same code with
the same seeds, so the registered clouds are equal bit for bit. The
original FlowCompare delegates to Open3D's pipelines (voxel downsample ->
normals -> FPFH -> RANSAC global registration -> point-to-plane ICP ->
final downsample); here they are numpy and scipy's cKDTree, one-time
offline preprocessing that never runs on the device.

Algorithms:
  * voxel_downsample — grid binning + per-cell centroid (positions AND
    attributes averaged, as o3d does).
  * estimate_normals — k-NN PCA (smallest eigenvector), orientation fixed
    towards +z half-space for determinism.
  * fpfh — Fast Point Feature Histograms (Rusu et al., ICRA'09): per-point
    SPFH over the (alpha, phi, theta) Darboux angles in 11 bins each,
    then inverse-distance-weighted neighbour aggregation.
  * ransac_global_registration — 3-point feature-correspondence RANSAC with
    Kabsch/Umeyama rigid estimation and edge-length pruning.
  * icp_point_to_plane — Gauss-Newton on the linearised point-to-plane
    objective (6-DoF twist), NN correspondences via scipy cKDTree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
from scipy.spatial import cKDTree


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """(N, D>=3) -> one centroid row per occupied voxel."""
    xyz = points[:, :3]
    lo = xyz.min(axis=0)
    cell = np.floor((xyz - lo) / voxel_size).astype(np.int64)
    # ravel index on the occupied bounding grid
    dims = cell.max(axis=0) + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    pts_s = points[order]
    boundaries = np.flatnonzero(np.diff(key_s)) + 1
    groups = np.split(pts_s, boundaries)
    return np.stack([g.mean(axis=0) for g in groups])


def estimate_normals(xyz: np.ndarray, *, knn: int = 30) -> np.ndarray:
    tree = cKDTree(xyz)
    k = min(knn, len(xyz))
    _, idx = tree.query(xyz, k=k)
    nbrs = xyz[idx]                           # (N, k, 3)
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    _, vecs = np.linalg.eigh(cov)             # ascending eigenvalues
    normals = vecs[:, :, 0]
    flip = normals[:, 2] < 0
    normals[flip] = -normals[flip]
    return normals


def _darboux_angles(p1, n1, p2, n2):
    """(alpha, phi, theta) pair features between oriented points."""
    d = p2 - p1
    dist = np.linalg.norm(d, axis=-1)
    dist = np.where(dist < 1e-12, 1.0, dist)
    du = d / dist[..., None]
    u = n1
    v = np.cross(du, u)
    vn = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.where(vn < 1e-12, 1.0, vn)
    w = np.cross(u, v)
    alpha = np.einsum("...i,...i->...", v, n2)
    phi = np.einsum("...i,...i->...", u, du)
    theta = np.arctan2(np.einsum("...i,...i->...", w, n2),
                       np.einsum("...i,...i->...", u, n2))
    return alpha, phi, theta


def fpfh(xyz: np.ndarray, normals: np.ndarray, *, radius: float,
         max_nn: int = 64, bins: int = 11) -> np.ndarray:
    """(N, 3) + normals -> (N, 33) FPFH descriptors."""
    n = len(xyz)
    tree = cKDTree(xyz)
    k = min(max_nn, n)
    dist, idx = tree.query(xyz, k=k, distance_upper_bound=radius)
    valid = np.isfinite(dist) & (dist > 0)
    idx = np.where(valid, idx, 0)

    # SPFH: histogram the pair features of each point vs its neighbours
    p1 = np.repeat(xyz[:, None, :], k, axis=1)
    n1 = np.repeat(normals[:, None, :], k, axis=1)
    p2, n2 = xyz[idx], normals[idx]
    alpha, phi, theta = _darboux_angles(p1, n1, p2, n2)

    def hist(vals, lo, hi):
        b = np.clip(((vals - lo) / (hi - lo) * bins).astype(np.int64), 0, bins - 1)
        h = np.zeros((n, bins), np.float64)
        rows = np.repeat(np.arange(n), k)
        np.add.at(h, (rows, b.reshape(-1)),
                  valid.reshape(-1).astype(np.float64))
        return h

    spfh = np.concatenate(
        [hist(alpha, -1, 1), hist(phi, -1, 1), hist(theta, -np.pi, np.pi)], axis=1)
    counts = valid.sum(axis=1, keepdims=True)
    spfh = spfh / np.maximum(counts, 1)

    # FPFH: self SPFH + inverse-distance-weighted neighbour SPFHs
    w = np.where(valid, 1.0 / np.maximum(dist, 1e-6), 0.0)
    nbr = np.einsum("nk,nkf->nf", w, spfh[idx])
    denom = np.maximum(valid.sum(axis=1), 1)
    out = spfh + nbr / denom[:, None]
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.where(norms < 1e-12, 1.0, norms)


def _kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid transform (4x4) minimising |R src + t - dst|^2."""
    cs, cd = src.mean(0), dst.mean(0)
    h = (src - cs).T @ (dst - cd)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    t = cd - r @ cs
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = r, t
    return m


def _transform(xyz: np.ndarray, m: np.ndarray) -> np.ndarray:
    return xyz @ m[:3, :3].T + m[:3, 3]


class RegistrationResult(NamedTuple):
    transformation: np.ndarray
    fitness: float
    inlier_rmse: float


def ransac_global_registration(
        src_xyz: np.ndarray, dst_xyz: np.ndarray,
        src_feat: np.ndarray, dst_feat: np.ndarray, *,
        distance_threshold: float, n_iters: int = 4000,
        n_sample: int = 3, seed: int = 0) -> RegistrationResult:
    """Feature-correspondence RANSAC (dataset_utils.py:24-40 analogue)."""
    rng = np.random.default_rng(seed)
    feat_tree = cKDTree(dst_feat)
    _, corr = feat_tree.query(src_feat, k=1)
    dst_corr = dst_xyz[corr]
    dst_tree = cKDTree(dst_xyz)

    best = RegistrationResult(np.eye(4), 0.0, np.inf)
    n = len(src_xyz)
    for _ in range(n_iters):
        pick = rng.choice(n, n_sample, replace=False)
        s, d = src_xyz[pick], dst_corr[pick]
        # edge-length pruning (cheap reject before SVD)
        es = np.linalg.norm(s[0] - s[1]) + np.linalg.norm(s[1] - s[2])
        ed = np.linalg.norm(d[0] - d[1]) + np.linalg.norm(d[1] - d[2])
        if not (0.8 < (es + 1e-9) / (ed + 1e-9) < 1.25):
            continue
        m = _kabsch(s, d)
        moved = _transform(src_xyz, m)
        dd, _ = dst_tree.query(moved, k=1, distance_upper_bound=distance_threshold)
        inliers = np.isfinite(dd)
        fitness = inliers.mean()
        if fitness > best.fitness:
            rmse = float(np.sqrt(np.mean(dd[inliers] ** 2))) if inliers.any() else np.inf
            best = RegistrationResult(m, float(fitness), rmse)
    return best


def icp_point_to_plane(src_xyz: np.ndarray, dst_xyz: np.ndarray,
                       dst_normals: np.ndarray, *,
                       max_correspondence_distance: float,
                       init: Optional[np.ndarray] = None,
                       max_iters: int = 30,
                       tol: float = 1e-7) -> RegistrationResult:
    """Point-to-plane ICP refine (dataset_utils.py:56-64 analogue)."""
    m = np.eye(4) if init is None else init.copy()
    tree = cKDTree(dst_xyz)
    prev_err = np.inf
    fitness, rmse = 0.0, np.inf
    for _ in range(max_iters):
        moved = _transform(src_xyz, m)
        dist, idx = tree.query(moved, k=1,
                               distance_upper_bound=max_correspondence_distance)
        mask = np.isfinite(dist)
        if mask.sum() < 6:
            break
        p = moved[mask]
        q = dst_xyz[idx[mask]]
        nq = dst_normals[idx[mask]]
        r = np.einsum("ni,ni->n", p - q, nq)          # residuals
        a = np.concatenate([np.cross(p, nq), nq], axis=1)  # (M, 6) jacobian
        x, *_ = np.linalg.lstsq(a, -r, rcond=None)
        # twist -> SE(3) increment (small-angle)
        wx, wy, wz, tx, ty, tz = x
        dr = np.array([[1, -wz, wy], [wz, 1, -wx], [-wy, wx, 1]])
        u, _, vt = np.linalg.svd(dr)                  # re-orthonormalise
        dr = u @ vt
        dm = np.eye(4)
        dm[:3, :3], dm[:3, 3] = dr, (tx, ty, tz)
        m = dm @ m
        err = float(np.mean(r ** 2))
        fitness = float(mask.mean())
        rmse = float(np.sqrt(err))
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return RegistrationResult(m, fitness, rmse)


def registration_pipeline(clouds: list[np.ndarray], *,
                          voxel_size_icp: float = 0.05,
                          voxel_size_final: float = 0.07,
                          seed: int = 0) -> list[np.ndarray]:
    """Register clouds[1:] onto clouds[0] and final-downsample all.

    Mirrors dataset_utils.registration_pipeline (dataset_utils.py:92-144):
    downsample -> normals -> FPFH -> RANSAC (distance 1.5*voxel) ->
    point-to-plane ICP (distance 0.4*voxel) -> transform + final downsample.
    Clouds are (N, D>=3); attribute channels are carried through untouched.
    """
    target = clouds[0]
    tgt_ds = voxel_downsample(target, voxel_size_icp)
    tgt_xyz = tgt_ds[:, :3]
    tgt_normals = estimate_normals(tgt_xyz)
    tgt_feat = fpfh(tgt_xyz, tgt_normals, radius=voxel_size_icp * 5)

    out = [voxel_downsample(target, voxel_size_final)]
    for ci, cloud in enumerate(clouds[1:]):
        src_ds = voxel_downsample(cloud, voxel_size_icp)
        src_xyz = src_ds[:, :3]
        src_normals = estimate_normals(src_xyz)
        src_feat = fpfh(src_xyz, src_normals, radius=voxel_size_icp * 5)
        coarse = ransac_global_registration(
            src_xyz, tgt_xyz, src_feat, tgt_feat,
            distance_threshold=voxel_size_icp * 1.5, seed=seed + ci)
        fine = icp_point_to_plane(
            src_xyz, tgt_xyz, tgt_normals,
            max_correspondence_distance=voxel_size_icp * 0.4,
            init=coarse.transformation)
        registered = cloud.copy()
        registered[:, :3] = _transform(cloud[:, :3], fine.transformation)
        out.append(voxel_downsample(registered, voxel_size_final))
    return out
