"""Synthetic stereo sequence generator with exact ground truth.

No datasets ship with this repo (zero-egress environment), so dataset-level
regression (SURVEY §4.4 — the reference's de-facto system test on
EuRoC/KITTI) runs on synthetic imagery instead: a large textured plane in
3D, rendered into a moving calibrated stereo rig by exact plane-homography
sampling.  Ground-truth poses are known, so ATE is measurable to
sub-millimeter.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3, so3_exp, so3_log
from orbslam3_tpu_torch.utils.raster import fill_poly


def _smooth_noise(size: int, coarse: int, rng) -> np.ndarray:
    """Aperiodic smooth background: bilinear-upsampled coarse noise."""
    g = rng.normal(0, 1.0, (coarse, coarse))
    xs = np.linspace(0, coarse - 1, size)
    x0 = np.minimum(xs.astype(np.int64), coarse - 2)
    fx = xs - x0
    rows = g[:, x0] * (1 - fx) + g[:, x0 + 1] * fx
    out = rows[x0, :] * (1 - fx)[:, None] + rows[x0 + 1, :] * fx[:, None]
    return out


def make_texture(size: int = 2048, seed: int = 0) -> np.ndarray:
    """Aperiodic texture: layered smooth noise + random blobs + fine noise.

    Deliberately NO periodic components — a repeating pattern makes ORB
    descriptors identical across lattice sites, and any drift larger than
    half a period locks tracking onto a shifted self-consistent match set
    (found the hard way; real imagery is aperiodic).
    """
    rng = np.random.default_rng(seed)
    img = (
        120
        + 55 * _smooth_noise(size, 48, rng)
        + 30 * _smooth_noise(size, 192, rng)
        + rng.normal(0, 8, (size, size))
    )
    # Diverse sharp structure: randomly rotated polygons of varied vertex
    # count, size, and intensity.  Texture design matters a lot here:
    #  - large smooth circles are scale-invariant -> detection flickers
    #    across pyramid octaves and cross-octave descriptors don't match;
    #  - identical axis-aligned primitives make *different* corners look
    #    alike (Hamming 30-60), and those aliased matches pass TH_HIGH and
    #    feed a drift-consistent wrong pose (found the hard way).
    # cv2.fillPoly's pixels, drawn in numpy (utils/raster.py)
    img8 = np.clip(img, 0, 255).astype(np.uint8)
    for _ in range(size):
        cx, cy = rng.integers(12, size - 12, 2)
        n_v = int(rng.integers(3, 7))
        radius = rng.uniform(2.5, 11.0)
        angs = np.sort(rng.uniform(0, 2 * np.pi, n_v))
        pts = np.stack(
            [cx + radius * np.cos(angs), cy + radius * rng.uniform(0.4, 1.6) * np.sin(angs)],
            axis=1,
        ).astype(np.int32)
        v = int(rng.integers(0, 256))
        fill_poly(img8, pts, v)
    return img8


class PlaneWorld:
    """A textured plane: X on the plane maps to texture pixels.

    Plane frame: origin p0, axes (ex, ey) spanning the plane with
    `scale` meters per texture pixel; normal n = ex x ey.
    """

    def __init__(self, texture: np.ndarray, p0, ex, ey, scale: float):
        self.tex = texture.astype(np.float32)
        self.p0 = np.asarray(p0, np.float64)
        self.ex = np.asarray(ex, np.float64)
        self.ey = np.asarray(ey, np.float64)
        self.scale = scale
        self.n = np.cross(self.ex, self.ey)
        self.n /= np.linalg.norm(self.n)

    def intersect(self, c: np.ndarray, rays_w: np.ndarray):
        """(t, texval, valid) for rays from center c (world frame)."""
        denom = rays_w @ self.n
        tplane = ((self.p0 - c) @ self.n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        pts = c + rays_w * tplane[:, None]
        rel = pts - self.p0
        u = (rel @ self.ex) / self.scale
        v = (rel @ self.ey) / self.scale
        th, tw = self.tex.shape
        inside = (u >= 0) & (u < tw - 1) & (v >= 0) & (v < th - 1) & (tplane > 0.05)
        u = np.clip(u, 0, tw - 1.001)
        v = np.clip(v, 0, th - 1.001)
        u0 = u.astype(np.int64)
        v0 = v.astype(np.int64)
        fu = (u - u0).astype(np.float32)
        fv = (v - v0).astype(np.float32)
        t = self.tex
        val = (
            t[v0, u0] * (1 - fu) * (1 - fv)
            + t[v0, u0 + 1] * fu * (1 - fv)
            + t[v0 + 1, u0] * (1 - fu) * fv
            + t[v0 + 1, u0 + 1] * fu * fv
        )
        return tplane, val, inside

    def render(self, camera, Tcw: SE3, h: int, w: int) -> np.ndarray:
        return render_world([self], camera, Tcw, h, w)


def render_world(
    planes: list, camera, Tcw: SE3, h: int, w: int, return_depth: bool = False
):
    """Nearest-hit rendering of multiple textured planes.
    With return_depth, also returns the exact per-pixel camera z-depth map
    (0 where no plane is hit) — ground truth for the RGB-D configuration.

    Renders through the camera's FULL model: a Pinhole with distortion
    coefficients produces a distorted (unrectified) image — pixels are
    undistorted to rays before plane intersection — so rectification
    pipelines can be tested end-to-end without datasets."""
    Twc = Tcw.inverse()
    c = Twc.t
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    if getattr(camera, "dist", None) is not None:
        rays_c = camera.unproject(camera.undistort_points(pix))
    else:
        rays_c = camera.unproject(pix)
    rays_w = rays_c @ Twc.R.T
    best_t = np.full(len(rays_w), np.inf)
    best_v = np.full(len(rays_w), 127.0, np.float32)
    for pl in planes:
        t, v, ok = pl.intersect(c, rays_w)
        take = ok & (t < best_t)
        best_t = np.where(take, t, best_t)
        best_v = np.where(take, v, best_v)
    img = np.clip(best_v.reshape(h, w), 0, 255).astype(np.uint8)
    if return_depth:
        # rays are unprojected at z=1, so the hit parameter IS camera z-depth
        depth = np.where(np.isfinite(best_t), best_t, 0.0).reshape(h, w)
        return img, depth
    return img


def make_world(seed: int = 0) -> list:
    """Multi-plane "room": a back wall, tilted side walls, near posters.

    A single plane is pose-degenerate (plane-induced homography ambiguity
    leaves flat cost directions); three non-parallel planes fully constrain
    the pose.  Depth diversity is essential: with all structure at one depth
    z0, a yaw-compensated lateral translation (theta = tx/z0) moves every
    projection by <1 px per several cm — an unobservable soft mode that
    random-walks until tracking collapses.  Near posters + mid walls + a far
    back wall spread 1/z by ~10x, stiffening the mode."""
    walls = [
        PlaneWorld(  # far back wall
            make_texture(2048, seed),
            p0=[-7.0, -5.0, 7.0], ex=[1.0, 0.0, -0.08], ey=[0.0, 1.0, 0.05],
            scale=0.008,
        ),
        PlaneWorld(  # mid wall fragment on the right
            make_texture(1024, seed + 1),
            p0=[0.6, -2.4, 3.2], ex=[1.0, 0.0, -0.25], ey=[0.0, 1.0, 0.1],
            scale=0.004,
        ),
        PlaneWorld(  # left wall, strongly angled: mid-range points
            make_texture(1024, seed + 2),
            p0=[-2.4, -3.0, -0.5], ex=[0.45, 0.0, 1.0], ey=[0.0, 1.0, 0.0],
            scale=0.007,
        ),
    ]
    poster_rng = np.random.default_rng(seed + 100)
    k_p = 0
    for gx in (-1.6, -0.8, 0.0, 0.8, 1.6):
        for gy in (-0.6, 0.4):
            k_p += 1
            pz = float(poster_rng.uniform(1.0, 2.8))
            px_ = gx + float(poster_rng.uniform(-0.25, 0.25))
            py_ = gy + float(poster_rng.uniform(-0.2, 0.2))
            tilt = poster_rng.uniform(-0.2, 0.2, 2)
            walls.append(
                PlaneWorld(
                    make_texture(512, seed + 10 + k_p),
                    p0=[px_ - 0.35, py_ - 0.35, pz],
                    ex=[1.0, 0.0, tilt[0]], ey=[0.0, 1.0, tilt[1]],
                    scale=0.0014,
                )
            )
    return walls


def rgbd_sequence(
    n_frames: int,
    camera,
    h: int,
    w: int,
    seed: int = 0,
    step: float = 0.05,
    pose_fn=None,
    depth_noise: float = 0.0,
    depth_factor: float = 1.0,
):
    """Yields (img, depth_map, Tcw ground truth): the RGB-D analog of
    stereo_sequence.  depth_map is float meters * depth_factor (pass
    depth_factor=5000 and cast uint16 downstream to emulate a TUM-style
    sensor), with optional multiplicative noise."""
    walls = make_world(seed)
    rng = np.random.default_rng(seed + 999)
    frames = []
    for k in range(n_frames):
        Twc = pose_fn(k) if pose_fn is not None else trajectory_pose(k, step)
        Tcw = Twc.inverse()
        img, depth = render_world(walls, camera, Tcw, h, w, return_depth=True)
        if depth_noise > 0:
            depth = depth * (1 + rng.normal(0, depth_noise, depth.shape))
        frames.append((img, depth * depth_factor, Tcw))
    return frames


def stereo_sequence(
    n_frames: int,
    camera,
    baseline: float,
    h: int,
    w: int,
    seed: int = 0,
    step: float = 0.05,
    pose_fn=None,
    camera_r=None,
    T_rl: SE3 | None = None,
):
    """Yields (img_left, img_right, Tcw_left ground truth) along a smooth
    lateral+forward trajectory in front of a tilted textured plane.

    camera_r / T_rl configure an UNRECTIFIED rig: a distinct right camera
    (own intrinsics/distortion) and a full SE3 left-cam-point -> right-cam
    transform (x_r = T_rl x_l) with rotation — the raw EuRoC-style geometry
    the rectification pipeline must undo.  Defaults keep the legacy ideal
    rectified rig (identity rotation, x-baseline)."""
    walls = make_world(seed)
    if T_rl is None:
        T_rl = SE3(np.eye(3), np.array([-baseline, 0.0, 0.0]))  # left point -> right cam
    cam_r = camera_r if camera_r is not None else camera
    frames = []
    for k in range(n_frames):
        Twc = pose_fn(k) if pose_fn is not None else trajectory_pose(k, step)
        Tcw = Twc.inverse()
        img_l = render_world(walls, camera, Tcw, h, w)
        img_r = render_world(walls, cam_r, T_rl * Tcw, h, w)
        frames.append((img_l, img_r, Tcw))
    return frames


def trajectory_pose(k: float, step: float = 0.05) -> SE3:
    """Analytic camera-in-world pose at (fractional) frame index k.

    Smooth oscillating sweep: bounded displacement keeps revisiting mapped
    territory (per-frame stereo-depth noise induces ~3 mm/frame of
    structured drift; an unbounded sweep accumulates past the matching
    gates before loop closing can correct it)."""
    s = k * step
    t = np.array(
        [0.5 * np.sin(0.35 * s * np.pi), 0.06 * np.sin(0.4 * k), 0.25 * np.sin(0.22 * s * np.pi)]
    )
    w_rot = np.array([0.002 * np.sin(0.2 * k), -0.12 * np.sin(0.3 * s * np.pi), 0.0])
    return SE3(so3_exp(w_rot), t)


def imu_samples_between(
    k0: float, k1: float, fps: float = 20.0, imu_rate: float = 200.0,
    step: float = 0.05, bias_acc=None, bias_gyro=None, Tbc: SE3 | None = None,
    pose_fn=None,
):
    """Exact-ish IMU (specific force + body rates) between frames k0 and k1
    of the analytic trajectory, by central finite differences.

    Returns (acc (N, 3), gyro (N, 3), dts (N,)) in the body frame — the
    camera frame by default, or offset by the camera-in-body extrinsics
    `Tbc` (x_b = Tbc x_c), differentiating the body trajectory
    Twb = Twc * Tbc^-1 exactly (lever-arm effects included).  Gravity
    included, optional constant biases added."""
    g = np.array([0.0, 0.0, -9.81])
    Tcb = Tbc.inverse() if Tbc is not None else None
    pf = pose_fn if pose_fn is not None else (lambda k: trajectory_pose(k, step))
    n = max(1, int(round((k1 - k0) * imu_rate / fps)))
    dt = (k1 - k0) / fps / n
    dk = (k1 - k0) / n
    eps_k = 1e-3
    accs, gyros, dts = [], [], []
    for i in range(n):
        km = k0 + (i + 0.5) * dk  # midpoint of the sample interval
        T = pf(km)
        Tp = pf(km + eps_k)
        Tm = pf(km - eps_k)
        if Tcb is not None:
            T, Tp, Tm = T * Tcb, Tp * Tcb, Tm * Tcb
        dt_k = eps_k / fps  # seconds per eps_k frames
        # body rates from relative rotation
        w_body = so3_log(T.R.T @ Tp.R) / dt_k
        # world acceleration by central second difference
        a_w = (Tp.t - 2 * T.t + Tm.t) / (dt_k * dt_k)
        f_body = T.R.T @ (a_w - g)
        accs.append(f_body + (bias_acc if bias_acc is not None else 0.0))
        gyros.append(w_body + (bias_gyro if bias_gyro is not None else 0.0))
        dts.append(dt)
    return np.asarray(accs), np.asarray(gyros), np.asarray(dts)


def ate_rmse(est: list, gt: list, with_scale: bool = False) -> float:
    """Absolute trajectory error after Umeyama alignment (SE3, or Sim3 with
    `with_scale` for monocular's free scale)."""
    p_est = np.stack([T.inverse().t for T in est])
    p_gt = np.stack([T.inverse().t for T in gt])
    mu_e, mu_g = p_est.mean(0), p_gt.mean(0)
    xe, xg = p_est - mu_e, p_gt - mu_g
    cov = xg.T @ xe / len(xe)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    if with_scale:
        var_e = (xe**2).sum() / len(xe)
        scale = float(np.trace(np.diag(d) @ s_mat) / max(var_e, 1e-12))
    else:
        scale = 1.0
    t = mu_g - scale * (r @ mu_e)
    aligned = scale * (p_est @ r.T) + t
    return float(np.sqrt(np.mean(np.sum((aligned - p_gt) ** 2, axis=1))))
