"""Trajectory evaluation on the host (numpy): ATE with an optional Umeyama
SE(3) alignment, RPE, the KITTI drift metric, and the accuracy envelopes of
`eval/envelopes/`. The same functions as the JAX package's `eval/metrics.py`,
kept here so that the port stands alone."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning est -> gt. (N,3) each.
    Returns (R (3,3), t (3,), s)."""
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    cov = g.T @ e / est.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / max(e.var(0).sum(), 1e-12)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE (m) after optional SE(3) Umeyama alignment."""
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if align and est.shape[0] >= 3:
        R, t, s = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(N,4) [x,y,z,w] quaternions -> (N,3,3) rotation matrices."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """(N,3,3) rotation matrices -> (N,4) [x,y,z,w] quaternions (Shepperd's
    branch-free variant via the largest diagonal pivot). Used to thread
    ground-truth orientations from KITTI pose files into kitti_drift."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R, axis1=-2, axis2=-1)
    q = np.empty(R.shape[:-2] + (4,))
    # four candidate formulations; pick per-row by the largest pivot
    cand = np.stack([1.0 + t,
                     1.0 + 2.0 * R[:, 0, 0] - t,
                     1.0 + 2.0 * R[:, 1, 1] - t,
                     1.0 + 2.0 * R[:, 2, 2] - t], axis=-1)
    pivot = np.argmax(cand, axis=-1)
    s = 2.0 * np.sqrt(np.maximum(np.take_along_axis(cand, pivot[:, None], -1)[:, 0], 1e-12))
    for k in range(R.shape[0]):
        p, sk = pivot[k], s[k]
        m = R[k]
        if p == 0:
            q[k] = [(m[2, 1] - m[1, 2]) / sk, (m[0, 2] - m[2, 0]) / sk,
                    (m[1, 0] - m[0, 1]) / sk, 0.25 * sk]
        elif p == 1:
            q[k] = [0.25 * sk, (m[0, 1] + m[1, 0]) / sk,
                    (m[0, 2] + m[2, 0]) / sk, (m[2, 1] - m[1, 2]) / sk]
        elif p == 2:
            q[k] = [(m[0, 1] + m[1, 0]) / sk, 0.25 * sk,
                    (m[1, 2] + m[2, 1]) / sk, (m[0, 2] - m[2, 0]) / sk]
        else:
            q[k] = [(m[0, 2] + m[2, 0]) / sk, (m[1, 2] + m[2, 1]) / sk,
                    0.25 * sk, (m[1, 0] - m[0, 1]) / sk]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def rpe_rmse(
    est: np.ndarray,
    gt: np.ndarray,
    delta: int = 1,
    est_q: np.ndarray | None = None,
    gt_q: np.ndarray | None = None,
) -> float:
    """Standard TUM/KITTI relative-pose translation error RMSE over a frame
    delta: err_k = || trans( (gt_k^-1 gt_{k+d})^-1 (est_k^-1 est_{k+d}) ) ||.

    With orientations (`est_q`/`gt_q`, xyzw) the per-frame deltas are
    expressed in each trajectory's local frame — the exact metric. Without
    them the world-frame displacement *vectors* are differenced (direction-
    aware; unlike round 1's |de|-|dg| it cannot score zero on heading drift).
    """
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    if est_q is not None and gt_q is not None:
        Re = _quat_to_mat(np.asarray(est_q)[:-delta])
        Rg = _quat_to_mat(np.asarray(gt_q)[:-delta])
        de = np.einsum("nij,nj->ni", Re.transpose(0, 2, 1), de)
        dg = np.einsum("nij,nj->ni", Rg.transpose(0, 2, 1), dg)
    err = np.linalg.norm(de - dg, axis=1)
    return float(np.sqrt((err**2).mean()))


def _traj_to_mats(t: np.ndarray, q: np.ndarray | None) -> np.ndarray:
    """(N,3) positions [+ (N,4) xyzw quats] -> (N,4,4) homogeneous poses."""
    t = np.asarray(t, dtype=np.float64)
    N = t.shape[0]
    T = np.tile(np.eye(4), (N, 1, 1))
    T[:, :3, 3] = t
    if q is not None:
        T[:, :3, :3] = _quat_to_mat(np.asarray(q))
    return T


def kitti_drift(
    est: np.ndarray,
    gt: np.ndarray,
    est_q: np.ndarray | None = None,
    gt_q: np.ndarray | None = None,
    lengths: tuple = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0),
    step: int = 10,
) -> dict:
    """The official KITTI odometry metric: average translational error (% of
    segment length) and rotational error (deg/m) over all subsequences of the
    given lengths, evaluated every `step` frames. This is the number the
    SURVEY section 6 envelope cites (A-LOAM class ~= 0.55-0.8% drift).

    est/gt are (N,3) positions; est_q/gt_q optional (N,4) xyzw orientations
    (without them rotational error is reported as nan and translational error
    uses world-frame endpoint error, exact when gt_q is identity-aligned).
    Lengths with no complete segment are skipped; returns
    {"t_rel_pct", "r_deg_per_m", "n_segments", "per_length": {L: pct}}.
    """
    Te = _traj_to_mats(est, est_q)
    Tg = _traj_to_mats(gt, gt_q)
    N = Te.shape[0]
    seg = np.linalg.norm(np.diff(Tg[:, :3, 3], axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(seg)])

    t_errs, r_errs, per_len = [], [], {}
    for L in lengths:
        errs_L = []
        for i in range(0, N, step):
            # first frame at least L meters of gt path past frame i
            j = int(np.searchsorted(dist, dist[i] + L))
            if j >= N:
                break
            rel_g = np.linalg.inv(Tg[i]) @ Tg[j]
            rel_e = np.linalg.inv(Te[i]) @ Te[j]
            E = np.linalg.inv(rel_g) @ rel_e
            t_err = np.linalg.norm(E[:3, 3]) / L
            cosang = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            r_err = np.degrees(np.arccos(cosang)) / L
            errs_L.append((t_err, r_err))
        if errs_L:
            arr = np.asarray(errs_L)
            per_len[float(L)] = float(arr[:, 0].mean() * 100.0)
            t_errs.extend(arr[:, 0])
            r_errs.extend(arr[:, 1])
    if not t_errs:
        return {"t_rel_pct": float("nan"), "r_deg_per_m": float("nan"),
                "n_segments": 0, "per_length": {}}
    has_rot = est_q is not None and gt_q is not None
    return {
        "t_rel_pct": float(np.mean(t_errs) * 100.0),
        "r_deg_per_m": float(np.mean(r_errs)) if has_rot else float("nan"),
        "n_segments": len(t_errs),
        "per_length": per_len,
    }


# --- accuracy-gate envelopes (a runner's --gate) ----------------------------

def check_envelope(summary: dict, envelope: dict) -> list:
    """Compare a run summary against an accuracy envelope; return the list of
    breach messages (empty = within envelope).

    Envelope keys (all optional; only present keys are checked):
      ate_m        max aligned ATE RMSE (m)
      ate_raw_m    max unaligned ATE RMSE (m)
      t_rel_pct    max KITTI translational drift (%)
      r_deg_per_m  max KITTI rotational drift (deg/m)
      min_scans    minimum processed scan count (guards silent truncation)
      min_scans_per_s  minimum throughput (the 10 Hz real-time budget,
                       A-LOAM scanRegistration.cpp:480)
    A metric the envelope names but the run could not compute (e.g. no ground
    truth) is itself a breach — the gate never passes vacuously.
    """
    breaches = []
    checks = [
        ("ate_m", "ATE RMSE (aligned)", "m", False),
        ("ate_raw_m", "ATE RMSE (raw)", "m", False),
        ("t_rel_pct", "KITTI translational drift", "%", False),
        ("r_deg_per_m", "KITTI rotational drift", "deg/m", False),
        ("min_scans", "processed scans", "", True),
        ("min_scans_per_s", "throughput", "scans/s", True),
    ]
    key_map = {"min_scans": "n_scans", "min_scans_per_s": "scans_per_s"}
    for key, label, unit, is_min in checks:
        if key not in envelope:
            continue
        bound = float(envelope[key])
        val = summary.get(key_map.get(key, key))
        if val is None or (isinstance(val, float) and np.isnan(val)):
            breaches.append(f"{label}: unavailable in this run "
                            f"(envelope requires {'>=' if is_min else '<='} "
                            f"{bound} {unit})".rstrip())
            continue
        ok = val >= bound if is_min else val <= bound
        if not ok:
            op = ">=" if is_min else "<="
            breaches.append(
                f"{label}: {val:.4g} {unit} breaches envelope {op} {bound} {unit}"
            )
    return breaches


def load_envelope(spec: str) -> dict:
    """Resolve a --gate spec: a JSON file path, a named envelope shipped in
    eval/envelopes/, or an inline 'key=value,key=value' string."""
    import json
    import os

    if os.path.exists(spec):
        with open(spec) as f:
            return json.load(f)
    named = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "envelopes", spec + ".json")
    if os.path.exists(named):
        with open(named) as f:
            return json.load(f)
    if "=" in spec:
        env = {}
        for part in spec.split(","):
            k, v = part.split("=")
            env[k.strip()] = float(v)
        return env
    raise ValueError(
        f"--gate {spec!r}: not a file, a named envelope, or key=value pairs")
