"""Two-view reconstruction for monocular initialization.

Role-parity with ORB_SLAM3/include/TwoViewReconstruction.h:31-60 /
src/TwoViewReconstruction.cc (929 LoC): from matched keypoints in two
views, RANSAC both a fundamental matrix (normalized 8-point) and a
homography (normalized DLT), score them by symmetric transfer error,
pick the model by the H/(H+F) score ratio, recover (R, t) — four-way
cheirality + parallax disambiguation for F via the essential matrix,
OpenCV homography decomposition for H — and triangulate the inliers.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.optim.triangulate import triangulate_linear
from orbslam3_tpu_torch.utils.lie import SE3, project_to_so3


def _normalize(pts):
    mu = pts.mean(0)
    d = np.abs(pts - mu).mean(0)
    d = np.where(d < 1e-9, 1.0, d)
    t = np.array([[1 / d[0], 0, -mu[0] / d[0]], [0, 1 / d[1], -mu[1] / d[1]], [0, 0, 1]])
    return (pts - mu) / d, t


def _eight_point(p1, p2):
    n1, t1 = _normalize(p1)
    n2, t2 = _normalize(p2)
    a = np.column_stack([
        n2[:, 0] * n1[:, 0], n2[:, 0] * n1[:, 1], n2[:, 0],
        n2[:, 1] * n1[:, 0], n2[:, 1] * n1[:, 1], n2[:, 1],
        n1[:, 0], n1[:, 1], np.ones(len(p1)),
    ])
    _, _, vt = np.linalg.svd(a)
    f = vt[-1].reshape(3, 3)
    u, d, vt2 = np.linalg.svd(f)
    f = u @ np.diag([d[0], d[1], 0.0]) @ vt2
    return t2.T @ f @ t1


def _dlt_homography(p1, p2):
    n1, t1 = _normalize(p1)
    n2, t2 = _normalize(p2)
    n = len(p1)
    a = np.zeros((2 * n, 9))
    a[0::2, 0:2] = n1
    a[0::2, 2] = 1
    a[0::2, 6:8] = -n2[:, 0:1] * n1
    a[0::2, 8] = -n2[:, 0]
    a[1::2, 3:5] = n1
    a[1::2, 5] = 1
    a[1::2, 6:8] = -n2[:, 1:2] * n1
    a[1::2, 8] = -n2[:, 1]
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    return np.linalg.inv(t2) @ h @ t1


def _score_f(f, p1, p2, sigma=1.0):
    """Symmetric epipolar score (TwoViewReconstruction::CheckFundamental)."""
    p1h = np.column_stack([p1, np.ones(len(p1))])
    p2h = np.column_stack([p2, np.ones(len(p2))])
    l2 = p1h @ f.T
    l1 = p2h @ f
    num2 = (l2 * p2h).sum(1)
    num1 = (l1 * p1h).sum(1)
    d2 = num2**2 / np.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12)
    d1 = num1**2 / np.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12)
    th, th_score = 3.841 * sigma**2, 5.991 * sigma**2
    inl = (d1 < th) & (d2 < th)
    score = np.where(d1 < th, th_score - d1, 0) + np.where(d2 < th, th_score - d2, 0)
    return float(score[inl].sum()), inl


def _score_h(h, p1, p2, sigma=1.0):
    p1h = np.column_stack([p1, np.ones(len(p1))])
    q2 = p1h @ h.T
    q2 = q2[:, :2] / np.maximum(np.abs(q2[:, 2:3]), 1e-12) * np.sign(q2[:, 2:3])
    hinv = np.linalg.inv(h)
    p2h = np.column_stack([p2, np.ones(len(p2))])
    q1 = p2h @ hinv.T
    q1 = q1[:, :2] / np.maximum(np.abs(q1[:, 2:3]), 1e-12) * np.sign(q1[:, 2:3])
    d2 = ((q2 - p2) ** 2).sum(1)
    d1 = ((q1 - p1) ** 2).sum(1)
    th = 5.991 * sigma**2
    inl = (d1 < th) & (d2 < th)
    score = np.where(d1 < th, th - d1, 0) + np.where(d2 < th, th - d2, 0)
    return float(score[inl].sum()), inl


def _opposite_of_minor(m, row, col):
    x1, x2 = (1 if col == 0 else 0), (1 if col == 2 else 2)
    y1, y2 = (1 if row == 0 else 0), (1 if row == 2 else 2)
    return m[y1, x2] * m[y2, x1] - m[y1, x1] * m[y2, x2]


def _sign(x):
    return 1.0 if x >= 0 else -1.0


def _rotation_from(h, t_star, n, v):
    """R = H (I - (2 / v) t* n^T), its sign flipped when det(R) < 0."""
    r = h @ (np.eye(3) - (2.0 / v) * np.outer(t_star, n))
    return -r if np.linalg.det(r) < 0 else r


def decompose_homography(h, k):
    """cv2.decomposeHomographyMat(h, k) as a list of (R, t, n): OpenCV's
    HomographyDecompInria (Malis & Vargas 2007, calib3d
    homography_decomp.cpp), the same solutions in the same order —
    (Ra, ta, na), (Ra, -ta, -na), (Rb, tb, nb), (Rb, -tb, -nb) — or one
    (H, 0, 0) when the normalised H is a rotation."""
    hn = np.linalg.inv(k) @ np.asarray(h, np.float64) @ k
    hn = hn * (1.0 / np.linalg.svd(hn, compute_uv=False)[1])
    s = hn.T @ hn - np.eye(3)
    if np.abs(s).max() < 1e-3:
        return [(hn, np.zeros(3), np.zeros(3))]
    m00, m11, m22 = (_opposite_of_minor(s, i, i) for i in range(3))
    rt00, rt11, rt22 = np.sqrt(m00), np.sqrt(m11), np.sqrt(m22)
    e01 = _sign(_opposite_of_minor(s, 0, 1))
    e12 = _sign(_opposite_of_minor(s, 1, 2))
    e02 = _sign(_opposite_of_minor(s, 0, 2))
    # the row of the largest |S_ii| gives the two normals
    a00, a11, a22 = abs(s[0, 0]), abs(s[1, 1]), abs(s[2, 2])
    idx = (2 if a11 < a22 else 1) if a00 < a11 else (2 if a00 < a22 else 0)
    if idx == 0:
        npa = np.array([s[0, 0], s[0, 1] + rt22, s[0, 2] + e12 * rt11])
        npb = np.array([s[0, 0], s[0, 1] - rt22, s[0, 2] - e12 * rt11])
    elif idx == 1:
        npa = np.array([s[0, 1] + rt22, s[1, 1], s[1, 2] - e02 * rt00])
        npb = np.array([s[0, 1] - rt22, s[1, 1], s[1, 2] + e02 * rt00])
    else:
        npa = np.array([s[0, 2] + e01 * rt11, s[1, 2] + rt00, s[2, 2]])
        npb = np.array([s[0, 2] - e01 * rt11, s[1, 2] - rt00, s[2, 2]])
    trace = s[0, 0] + s[1, 1] + s[2, 2]
    v = 2.0 * np.sqrt(1 + trace - m00 - m11 - m22)
    r = np.sqrt(2 + trace + v)
    n_t = np.sqrt(2 + trace - v)
    na = npa / np.linalg.norm(npa)
    nb = npb / np.linalg.norm(npb)
    esii_r = _sign(s[idx, idx]) * r
    ta_star = 0.5 * n_t * (esii_r * nb - n_t * na)
    tb_star = 0.5 * n_t * (esii_r * na - n_t * nb)
    ra = _rotation_from(hn, ta_star, na, v)
    rb = _rotation_from(hn, tb_star, nb, v)
    ta, tb = ra @ ta_star, rb @ tb_star
    return [(ra, ta, na), (ra, -ta, -na), (rb, tb, nb), (rb, -tb, -nb)]


def _check_rt(r, t, p1n, p2n, inl, th2=16.0):
    """Count cheirality+parallax-consistent points for one (R, t)."""
    T1 = SE3()
    T2 = SE3(r, t)
    pw = triangulate_linear(
        np.column_stack([p1n, np.ones(len(p1n))]),
        np.column_stack([p2n, np.ones(len(p2n))]),
        T1, T2,
    )
    z1 = pw[:, 2]
    p2c = T2.apply(pw)
    z2 = p2c[:, 2]
    # parallax
    n1 = pw
    n2 = pw - (-r.T @ t)
    cosp = (n1 * n2).sum(1) / np.maximum(
        np.linalg.norm(n1, axis=1) * np.linalg.norm(n2, axis=1), 1e-12
    )
    e1 = ((pw[:, :2] / np.maximum(z1[:, None], 1e-12)) - p1n) ** 2
    e2 = ((p2c[:, :2] / np.maximum(z2[:, None], 1e-12)) - p2n) ** 2
    good = (
        inl
        & (z1 > 0)
        & (z2 > 0)
        & (cosp < 0.99998)
        & (e1.sum(1) < th2 * 1e-6)
        & (e2.sum(1) < th2 * 1e-6)
    )
    return good, pw, cosp


class TwoViewReconstruction:
    """Reconstruct(kps1, kps2, matches) -> (ok, SE3 T21, points, good mask)."""

    def __init__(self, camera, sigma: float = 1.0, ransac_iters: int = 200, seed: int = 0):
        self.camera = camera
        self.sigma = sigma
        self.iters = ransac_iters
        self.rng = np.random.default_rng(seed)

    def reconstruct(self, kps1: np.ndarray, kps2: np.ndarray):
        """kps1/kps2: (N, 2) matched pixel pairs."""
        n = len(kps1)
        if n < 12:
            return False, None, None, None
        best_f, best_f_score, best_f_inl = None, -1.0, None
        best_h, best_h_score, best_h_inl = None, -1.0, None
        for _ in range(self.iters):
            idx = self.rng.choice(n, 8, replace=False)
            f = _eight_point(kps1[idx], kps2[idx])
            s, inl = _score_f(f, kps1, kps2, self.sigma)
            if s > best_f_score:
                best_f, best_f_score, best_f_inl = f, s, inl
            h = _dlt_homography(kps1[idx[:4]], kps2[idx[:4]])
            if np.abs(np.linalg.det(h)) > 1e-9:
                s, inl = _score_h(h, kps1, kps2, self.sigma)
                if s > best_h_score:
                    best_h, best_h_score, best_h_inl = h, s, inl

        ratio_h = best_h_score / max(best_h_score + best_f_score, 1e-9)
        k = self.camera.K()
        kinv = np.linalg.inv(k)
        p1n = (np.column_stack([kps1, np.ones(n)]) @ kinv.T)[:, :2]
        p2n = (np.column_stack([kps2, np.ones(n)]) @ kinv.T)[:, :2]

        candidates = []
        if ratio_h > 0.40 and best_h is not None:  # reference RH>0.40 gate
            # homography path: OpenCV decomposition (4 candidates)
            for r, t, _ in decompose_homography(best_h, k):
                tn = t.ravel()
                if np.linalg.norm(tn) > 1e-9:
                    tn = tn / np.linalg.norm(tn)
                candidates.append((project_to_so3(r), tn, best_h_inl))
        if not candidates and best_f is not None:
            e = k.T @ best_f @ k
            u, _, vt = np.linalg.svd(e)
            if np.linalg.det(u) < 0:
                u = -u
            if np.linalg.det(vt) < 0:
                vt = -vt
            w = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
            r1 = project_to_so3(u @ w @ vt)
            r2 = project_to_so3(u @ w.T @ vt)
            t = u[:, 2]
            t = t / max(np.linalg.norm(t), 1e-12)
            inl = best_f_inl
            candidates = [(r1, t, inl), (r1, -t, inl), (r2, t, inl), (r2, -t, inl)]

        best = None
        counts = []
        for r, t, inl in candidates:
            good, pw, cosp = _check_rt(r, t, p1n, p2n, inl)
            counts.append(int(good.sum()))
            if best is None or counts[-1] > best[0]:
                best = (counts[-1], r, t, good, pw, cosp, inl)
        # Winner must triangulate nearly every RANSAC inlier AND dominate the
        # runner-up hypothesis (reference ReconstructF: nMinGood =
        # max(0.9*N, minTriangulated=50), nsimilar>1 rejection).  The 0.9*N
        # bound is the main defense against near-zero-baseline pairs: with a
        # dense init extractor they produce plenty of matches, but most fail
        # the per-point parallax/cheirality checks, so nGood << 0.9*N.
        if best is None:
            return False, None, None, None
        n_inl = int(np.count_nonzero(best[6]))  # chosen hypothesis' inliers
        if best[0] < max(int(0.9 * n_inl), 50):
            return False, None, None, None
        second = sorted(counts)[-2] if len(counts) > 1 else 0
        if second > 0.75 * best[0]:
            return False, None, None, None
        _, r, t, good, pw, cosp, _inl = best
        # Minimum-parallax gate (reference CheckRT minParallax=1 deg over the
        # sorted-cos element at min(50, n-1)): with a dense init extractor a
        # near-zero-baseline pair can satisfy every count gate, but its
        # triangulated map is depth-degenerate — the reference waits for
        # ~50 points with >=1 degree of parallax before accepting the init.
        cos_sorted = np.sort(cosp[good])
        idx = min(50, len(cos_sorted) - 1)
        parallax_deg = np.degrees(np.arccos(np.clip(cos_sorted[idx], -1, 1)))
        if parallax_deg < 1.0:
            return False, None, None, None
        return True, SE3(r, t), pw, good
