"""Visual-inertial pose optimization for inertial tracking.

Role-parity with Optimizer::PoseInertialOptimizationLastFrame /
LastKeyFrame (ORB_SLAM3/src/Optimizer6.cc:48,432) and the EdgeInertial
factor (include/G2oTypes.h:495): optimize the current frame's 15-dof state
[body pose (6), velocity (3), gyro bias (3), acc bias (3)] against

 - monocular/stereo reprojection residuals of its matched map points,
 - the IMU preintegration residual to the previous (fixed) state
   (Forster rotation/velocity/position residuals, weighted by the
   propagated preintegration covariance),
 - bias random-walk residuals.

Gauss-Newton with numeric Jacobians over the 15-dof left-increment — at
per-frame problem sizes (a few hundred residual rows) the finite-difference
evaluation is microseconds and removes a whole class of hand-derivation
bugs (this repo once lost days to an analytically-plausible sign).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from orbslam3_tpu_torch.imu.preintegration import GRAVITY, Bias, Preintegrated
from orbslam3_tpu_torch.utils.lie import SE3, so3_exp, so3_log


@dataclass
class VIState:
    Twb: SE3          # body-in-world pose
    v: np.ndarray     # world-frame velocity
    bias: Bias

    def copy(self):
        return VIState(self.Twb.copy(), self.v.copy(), self.bias.copy())


def _apply_inc(s: VIState, dx: np.ndarray) -> VIState:
    return VIState(
        (SE3.exp(dx[:6]) * s.Twb.inverse()).inverse().normalized(),
        s.v + dx[6:9],
        Bias(s.bias.ba + dx[12:15], s.bias.bg + dx[9:12]),
    )


def _residuals(
    s: VIState,
    prev: VIState,
    pre: Preintegrated,
    obs_pw: np.ndarray,
    obs_uv: np.ndarray,
    obs_ur: np.ndarray,
    inv_sigma2: np.ndarray,
    camera,
    mbf: float,
    Tcb: SE3,
    w_inertial: np.ndarray,
    w_bias: np.ndarray,
    is_right: np.ndarray | None = None,
    camera2=None,
    Trl: SE3 | None = None,
) -> np.ndarray:
    """Stacked weighted residual vector.

    `is_right`/`camera2`/`Trl`: fisheye dual-camera rows project through
    the rig's right camera (the reference's EdgeMono with camera index 1,
    include/G2oTypes.h — VertexPose carries both cameras)."""
    out = []
    # --- visual (camera = Tcb * body^-1 in world) -------------------------
    Tcw = Tcb * s.Twb.inverse()
    pc = obs_pw @ Tcw.R.T + Tcw.t
    z = np.maximum(pc[:, 2], 1e-9)
    if is_right is not None and is_right.any():
        uv = np.empty((len(pc), 2))
        il = ~is_right
        if il.any():
            uv[il] = camera.project(pc[il])
        pc_r = pc[is_right] @ Trl.R.T + Trl.t
        uv[is_right] = camera2.project(pc_r)
    else:
        uv = camera.project(pc)
    w = np.sqrt(inv_sigma2)
    r_uv = (obs_uv - uv) * w[:, None]
    # huber on the visual rows (delta ~ sqrt(5.991))
    e = np.linalg.norm(r_uv, axis=1)
    hub = np.sqrt(np.maximum(2.447 * (2 * e - 2.447), 0.0))
    scale = np.where(e > 2.447, hub / np.maximum(e, 1e-12), 1.0)
    out.append((r_uv * scale[:, None]).ravel())
    stereo = obs_ur >= 0
    if stereo.any():
        ur_pred = uv[:, 0] - mbf / z
        r_ur = (obs_ur - ur_pred) * w
        out.append(np.where(stereo, r_ur, 0.0))
    # --- inertial ----------------------------------------------------------
    dt = pre.dT
    r1, p1, v1 = prev.Twb.R, prev.Twb.t, prev.v
    r2, p2, v2 = s.Twb.R, s.Twb.t, s.v
    dr = pre.get_delta_rotation(s.bias)
    res_r = so3_log(dr.T @ r1.T @ r2)
    res_v = r1.T @ (v2 - v1 - GRAVITY * dt) - pre.get_delta_velocity(s.bias)
    res_p = (
        r1.T @ (p2 - p1 - v1 * dt - 0.5 * GRAVITY * dt * dt)
        - pre.get_delta_position(s.bias)
    )
    r9 = np.concatenate([res_r, res_v, res_p])
    # w_inertial: (9,9) whitener (full off-diagonal information) or (9,)
    # per-row weights (legacy/diagonal form)
    out.append(w_inertial @ r9 if w_inertial.ndim == 2 else w_inertial * r9)
    # --- bias random walk ---------------------------------------------------
    out.append(w_bias * np.concatenate([s.bias.bg - prev.bias.bg,
                                        s.bias.ba - prev.bias.ba]))
    return np.concatenate(out)


@dataclass
class ConstraintPoseImu:
    """Marginalized prior on a 15-dof VI state (the reference's
    ConstraintPoseImu consumed by EdgePriorPoseImu,
    include/G2oTypes.h:732-792): linearization point + information matrix
    produced by Optimizer::Marginalize (ORB_SLAM3/src/
    Optimizer4.cc:625) after the previous frame's optimization."""

    state: VIState
    H: np.ndarray  # (15, 15) information in the order [pose(6), v(3), bg(3), ba(3)]

    def whitener(self) -> np.ndarray:
        h = 0.5 * (self.H + self.H.T)
        # eigenvalue floor keeps the prior positive-semidefinite after
        # numeric marginalization (the reference clamps negative eigs too)
        w, v = np.linalg.eigh(h)
        w = np.clip(w, 0.0, 1e12)
        return (v * np.sqrt(w)) @ v.T

    def residual(self, s: VIState) -> np.ndarray:
        """15-vector error of s against the linearization point, same
        left-increment convention as _apply_inc."""
        d_pose = (s.Twb.inverse() * self.state.Twb).inverse().log()
        return np.concatenate(
            [
                d_pose,
                s.v - self.state.v,
                s.bias.bg - self.state.bias.bg,
                s.bias.ba - self.state.bias.ba,
            ]
        )


def marginalize(h: np.ndarray, keep: slice, drop: slice) -> np.ndarray:
    """Schur-complement marginalization of the `drop` block out of a joint
    information matrix (Optimizer::Marginalize role, Optimizer4.cc:625)."""
    h = 0.5 * (h + h.T)
    h_kk = h[keep, keep]
    h_kd = h[keep, drop]
    h_dd = h[drop, drop]
    # pseudo-inverse: dropped block can be rank-deficient (e.g. biases
    # unobserved during a visual dropout)
    h_dd_inv = np.linalg.pinv(h_dd, rcond=1e-12)
    return h_kk - h_kd @ h_dd_inv @ h_kd.T


def pose_inertial_optimization_prior(
    cur: VIState,
    prev: VIState,
    pre: Preintegrated,
    obs_pw: np.ndarray,
    obs_uv: np.ndarray,
    obs_ur: np.ndarray,
    inv_sigma2: np.ndarray,
    camera,
    mbf: float = 0.0,
    Tcb: SE3 | None = None,
    prior: ConstraintPoseImu | None = None,
    prev_fixed: bool = False,
    n_iters: int = 8,
    sigma_floor: tuple = (2e-3, 0.03, 3e-3),
    is_right: np.ndarray | None = None,
    camera2=None,
    Trl: SE3 | None = None,
) -> tuple[VIState, VIState, ConstraintPoseImu]:
    """Frame-to-frame VI optimization with marginalized-prior carry-over.

    Role-parity with PoseInertialOptimizationLastKeyFrame (prev_fixed=True:
    previous state held constant, ORB_SLAM3/src/Optimizer6.cc:48) and
    PoseInertialOptimizationLastFrame (prev free, bound by the
    EdgePriorPoseImu prior from the previous optimization,
    Optimizer6.cc:432), followed by Optimizer::Marginalize
    (Optimizer4.cc:625) producing the next frame's 15-dof prior.

    Returns (optimized cur, optimized prev (== input when fixed), the
    marginalized ConstraintPoseImu on cur for the NEXT frame)."""
    Tcb = Tcb or SE3()
    floor = np.repeat(np.asarray(sigma_floor) ** 2, 3)
    cov = 0.5 * (pre.C[:9, :9] + pre.C[:9, :9].T) + np.diag(floor + 1e-12)
    try:
        w_inertial = np.linalg.cholesky(np.linalg.inv(cov)).T
    except np.linalg.LinAlgError:
        w_inertial = np.diag(1.0 / np.sqrt(np.maximum(np.diagonal(cov), 1e-12)))
    walk_var = np.maximum(np.diagonal(pre.C[9:15, 9:15]), 1e-14)
    w_bias = 1.0 / np.sqrt(walk_var + 1e-8)
    w_prior = prior.whitener() if prior is not None else None

    ndof = 15 if prev_fixed else 30

    def unpack(s_prev, s_cur, dx):
        if prev_fixed:
            return s_prev, _apply_inc(s_cur, dx)
        return _apply_inc(s_prev, dx[:15]), _apply_inc(s_cur, dx[15:])

    def res(s_prev, s_cur):
        parts = [
            _residuals(
                s_cur, s_prev, pre, obs_pw, obs_uv, obs_ur, inv_sigma2,
                camera, mbf, Tcb, w_inertial, w_bias,
                is_right=is_right, camera2=camera2, Trl=Trl,
            )
        ]
        if w_prior is not None and not prev_fixed:
            parts.append(w_prior @ prior.residual(s_prev))
        return np.concatenate(parts)

    sp, sc = prev.copy(), cur.copy()
    lam = 1e-4
    r0 = res(sp, sc)
    cost = float(r0 @ r0)
    eps = 1e-6
    jac = np.empty((len(r0), ndof))
    for _ in range(n_iters):
        r0 = res(sp, sc)
        for k in range(ndof):
            d = np.zeros(ndof)
            d[k] = eps
            pp, cp = unpack(sp, sc, d)
            pm, cm = unpack(sp, sc, -d)
            jac[:, k] = (res(pp, cp) - res(pm, cm)) / (2 * eps)
        h = jac.T @ jac
        g = jac.T @ r0
        stepped = False
        for _ in range(6):
            try:
                dx = np.linalg.solve(
                    h + lam * np.diag(np.maximum(np.diag(h), 1e-9)), -g
                )
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            sp_n, sc_n = unpack(sp, sc, dx)
            r_new = res(sp_n, sc_n)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                sp, sc, cost = sp_n, sc_n, c_new
                lam = max(lam / 3, 1e-9)
                stepped = True
                break
            lam *= 10
        if not stepped:
            break
    # final Hessian at the solution -> next frame's prior
    r0 = res(sp, sc)
    for k in range(ndof):
        d = np.zeros(ndof)
        d[k] = eps
        pp, cp = unpack(sp, sc, d)
        pm, cm = unpack(sp, sc, -d)
        jac[:, k] = (res(pp, cp) - res(pm, cm)) / (2 * eps)
    h = jac.T @ jac
    if prev_fixed:
        h_cur = h
    else:
        h_cur = marginalize(h, keep=slice(15, 30), drop=slice(0, 15))
    next_prior = ConstraintPoseImu(sc.copy(), h_cur)
    return sc, sp, next_prior


def pose_inertial_optimization(
    cur: VIState,
    prev: VIState,
    pre: Preintegrated,
    obs_pw: np.ndarray,
    obs_uv: np.ndarray,
    obs_ur: np.ndarray,
    inv_sigma2: np.ndarray,
    camera,
    mbf: float = 0.0,
    Tcb: SE3 | None = None,
    n_iters: int = 10,
    prior_sigma: tuple = (2e-3, 0.03, 3e-3),
) -> VIState:
    """GN over the current state; previous state and map points fixed.

    prior_sigma = (rot rad, vel m/s, pos m) floors added to the
    preintegration stddevs.  The previous state is held FIXED here but is
    itself an estimate; without this floor a low-noise IMU makes the
    inertial residual arbitrarily stiff and the optimization dead-reckons
    from the previous state's noise instead of listening to vision.  (The
    reference solves the same problem with a marginalized prior on the
    previous state — EdgePriorPoseImu, include/G2oTypes.h:732.)
    """
    Tcb = Tcb or SE3()
    # full 9x9 whitener from the propagated preintegration covariance
    # (EdgeInertial uses the full information matrix too), with the
    # prior-sigma floor added on the diagonal
    floor = np.repeat(np.asarray(prior_sigma) ** 2, 3)
    cov = 0.5 * (pre.C[:9, :9] + pre.C[:9, :9].T) + np.diag(floor + 1e-12)
    try:
        w_inertial = np.linalg.cholesky(np.linalg.inv(cov)).T
    except np.linalg.LinAlgError:
        w_inertial = 1.0 / np.sqrt(np.maximum(np.diagonal(cov), 1e-12))
    walk_var = np.maximum(np.diagonal(pre.C[9:15, 9:15]), 1e-14)
    w_bias = 1.0 / np.sqrt(walk_var + 1e-8)

    def res(s):
        return _residuals(
            s, prev, pre, obs_pw, obs_uv, obs_ur, inv_sigma2, camera, mbf,
            Tcb, w_inertial, w_bias,
        )

    s = cur.copy()
    lam = 1e-4
    r0 = res(s)
    cost = float(r0 @ r0)
    eps = 1e-6
    for _ in range(n_iters):
        r0 = res(s)
        jac = np.empty((len(r0), 15))
        for k in range(15):
            d = np.zeros(15)
            d[k] = eps
            jac[:, k] = (res(_apply_inc(s, d)) - res(_apply_inc(s, -d))) / (2 * eps)
        h = jac.T @ jac
        g = jac.T @ r0
        stepped = False
        for _ in range(6):
            try:
                dx = np.linalg.solve(h + lam * np.diag(np.maximum(np.diag(h), 1e-9)), -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            s_new = _apply_inc(s, dx)
            r_new = res(s_new)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                s, cost = s_new, c_new
                lam = max(lam / 3, 1e-9)
                stepped = True
                break
            lam *= 10
        if not stepped:
            break
    return s
