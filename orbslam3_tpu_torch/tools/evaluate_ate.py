"""Absolute trajectory error between two TUM-format trajectory files.

The reference evaluates EuRoC runs with an ATE script (associate by
timestamp, Umeyama-align, RMSE — evaluation/evaluate_ate_scale.py in the
upstream ORB-SLAM3 tree; the fork ships its MH01 outputs as
f_dataset-MH01_stereo.txt / kf_dataset-MH01_stereo.txt).  This is the
matching evaluator for this repo's savers (utils/trajectory.py): it reads
both files, associates stamps within a tolerance, solves the closed-form
Umeyama alignment (SE3, or Sim3 with --scale for monocular), and prints
one JSON line.

Usage: python -m orbslam3_tpu_torch.tools.evaluate_ate est.txt gt.txt [--scale] [--max-dt s]
"""

import json
import sys

import numpy as np



def load_tum_xyz(path: str):
    """(stamps (N,), xyz (N, 3)) from a TUM-format file (t x y z qx qy qz qw)."""
    rows = np.loadtxt(path, comments="#", usecols=(0, 1, 2, 3))
    rows = np.atleast_2d(rows)
    return rows[:, 0], rows[:, 1:4]


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float):
    """Indices (ia, ib) of mutually-nearest stamp pairs within max_dt."""
    ib = np.searchsorted(t_b, t_a)
    ib = np.clip(ib, 1, len(t_b) - 1)
    left = t_b[ib - 1]
    right = t_b[ib]
    ib = np.where(np.abs(t_a - left) <= np.abs(t_a - right), ib - 1, ib)
    dt = np.abs(t_a - t_b[ib])
    keep = dt <= max_dt
    ia = np.nonzero(keep)[0]
    ib = ib[keep]
    # one-to-one: keep the closest a for each b
    best = {}
    for a, b in zip(ia, ib):
        if b not in best or abs(t_a[a] - t_b[b]) < abs(t_a[best[b]] - t_b[b]):
            best[b] = a
    ib = np.array(sorted(best), dtype=int)
    ia = np.array([best[b] for b in ib], dtype=int)
    return ia, ib


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool):
    """(s, R, t) minimising ||dst - (s R src + t)||^2 (closed form)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1.0
    rot = u @ sgn @ vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(d) @ sgn) / var_s)
    else:
        s = 1.0
    t = mu_d - s * rot @ mu_s
    return s, rot, t


def evaluate(est_path: str, gt_path: str, with_scale: bool, max_dt: float):
    t_e, p_e = load_tum_xyz(est_path)
    t_g, p_g = load_tum_xyz(gt_path)
    # normalise nanosecond stamps (the fork writes ns) to seconds
    scale_t = 1e-9 if max(t_e.max(), t_g.max()) > 1e14 else 1.0
    ia, ib = associate(t_e * scale_t, t_g * scale_t, max_dt)
    if len(ia) < 3:
        return {"error": "fewer than 3 associated pairs", "pairs": int(len(ia))}
    s, rot, t = umeyama(p_e[ia], p_g[ib], with_scale)
    err = p_g[ib] - (s * p_e[ia] @ rot.T + t)
    en = np.linalg.norm(err, axis=1)
    return {
        "metric": "ate_rmse_m",
        "value": float(np.sqrt((en**2).mean())),
        "mean_m": float(en.mean()),
        "median_m": float(np.median(en)),
        "max_m": float(en.max()),
        "pairs": int(len(ia)),
        "scale": s,
    }


def main(argv):
    args = [a for a in argv if not a.startswith("--")]
    with_scale = "--scale" in argv
    max_dt = 0.02
    if "--max-dt" in argv:
        max_dt = float(argv[argv.index("--max-dt") + 1])
        args = [a for a in args if a != str(max_dt)]
    res = evaluate(args[0], args[1], with_scale, max_dt)
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in res.items()}))


if __name__ == "__main__":
    main(sys.argv[1:])
