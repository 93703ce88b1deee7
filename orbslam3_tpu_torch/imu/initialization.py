"""Visual-inertial initialization: gyro bias, gravity, scale, velocities.

Role-parity with the reference's IMU initialization stack —
LocalMapping::InitializeIMU (ORB_SLAM3/src/LocalMapping.cc:1173),
Optimizer::InertialOptimization (Optimizer4.cc:707,892) and
ScaleRefinement (LocalMapping.cc:1429): given keyframe poses from visual
SLAM and preintegrated IMU between them, estimate the gyroscope bias
(nonlinear 3-dof GN on the rotation residuals), then gravity direction,
metric scale, and per-keyframe velocities (linear least squares on the
velocity/position preintegration equations), as in classic VI alignment.
The reference solves the same unknowns with g2o factor graphs.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.imu.preintegration import GRAVITY, Bias
from orbslam3_tpu_torch.utils.lie import so3_exp, so3_log, so3_left_jacobian


def estimate_gyro_bias(rotations: list[np.ndarray], preints: list) -> np.ndarray:
    """rotations: world->body R_wb per keyframe (N); preints: N-1 windows.
    GN on sum ||log((dR exp(JRg bg))^T R_i^T R_j)||^2."""
    bg = np.zeros(3)
    for _ in range(10):
        h = np.zeros((3, 3))
        b = np.zeros(3)
        for i, pre in enumerate(preints):
            ri, rj = rotations[i], rotations[i + 1]
            dr_meas = pre.dR @ so3_exp(pre.JRg @ bg)
            r = so3_log(dr_meas.T @ ri.T @ rj)
            # d r / d bg ~ Jr^-1 * ... ~ JRg (first order)
            j = so3_left_jacobian(-r) @ pre.JRg  # right-Jacobian-corrected
            h += j.T @ j
            b += j.T @ r
        try:
            d = np.linalg.solve(h + 1e-12 * np.eye(3), b)
        except np.linalg.LinAlgError:
            break
        bg = bg + d
        if np.linalg.norm(d) < 1e-12:
            break
    return bg


def align_visual_inertial(
    Twb_list: list,
    preints: list,
    fix_scale: bool = False,
    fix_gravity_norm: bool = True,
):
    """Linear VI alignment.  Twb_list: N body poses (world->body SE3 inverses
    NOT required — these are Twb, body in visual-world frame); preints: N-1.

    Unknowns: scale s (1), gravity g (3), velocities v_i (3N), solved from
      s*(p_{i+1}-p_i) = v_i dT + 0.5 g dT^2 + R_i dP_i
      v_{i+1} = v_i + g dT + R_i dV_i
    With `fix_gravity_norm` the free 3-dof gravity of the first solve is
    refined on the 2-dof tangent of the |g| = 9.81 sphere (re-solved
    iteratively) — a free-norm gravity absorbs scale error for low-dynamics
    trajectories, which is exactly the mono-inertial failure mode (the
    reference constrains |g| the same way via VertexGDir,
    include/G2oTypes.h:274).
    Returns (s, g_world, velocities (N, 3))."""
    n = len(Twb_list)
    m = n - 1
    n_s = 0 if fix_scale else 1
    nu = n_s + 3 + 3 * n
    a = np.zeros((6 * m, nu))
    rhs = np.zeros(6 * m)
    for i, pre in enumerate(preints):
        ri = Twb_list[i].R
        pi, pj = Twb_list[i].t, Twb_list[i + 1].t
        dt = pre.dT
        r0 = 6 * i
        # position rows: s*(pj-pi) - 0.5 g dt^2 - v_i dt = R_i dP_i
        a[r0 : r0 + 3, n_s : n_s + 3] = -0.5 * dt * dt * np.eye(3)
        a[r0 : r0 + 3, n_s + 3 + 3 * i : n_s + 6 + 3 * i] = -dt * np.eye(3)
        if fix_scale:
            rhs[r0 : r0 + 3] = ri @ pre.dP - (pj - pi)
        else:
            a[r0 : r0 + 3, 0] = pj - pi
            rhs[r0 : r0 + 3] = ri @ pre.dP
        # velocity rows
        r1 = r0 + 3
        a[r1 : r1 + 3, n_s : n_s + 3] = dt * np.eye(3)
        a[r1 : r1 + 3, n_s + 3 + 3 * i : n_s + 6 + 3 * i] = np.eye(3)
        a[r1 : r1 + 3, n_s + 3 + 3 * (i + 1) : n_s + 6 + 3 * (i + 1)] = -np.eye(3)
        rhs[r1 : r1 + 3] = -Twb_list[i].R @ pre.dV
    x, *_ = np.linalg.lstsq(a, rhs, rcond=None)
    if fix_scale:
        s = 1.0
        g = x[0:3]
        v = x[3:].reshape(n, 3)
    else:
        s = float(x[0])
        g = x[1:4]
        v = x[4:].reshape(n, 3)
    if not fix_gravity_norm:
        return s, g, v

    # --- refine on the fixed-|g| sphere -----------------------------------
    g_mag = float(np.linalg.norm(GRAVITY))
    g_hat = g / max(np.linalg.norm(g), 1e-12)
    for _ in range(4):
        # tangent basis at g_hat
        ref = np.array([1.0, 0.0, 0.0])
        if abs(g_hat @ ref) > 0.9:
            ref = np.array([0.0, 1.0, 0.0])
        b1 = np.cross(g_hat, ref)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(g_hat, b1)
        # unknowns: [s?] + [w1 w2] + velocities; g = g_mag*g_hat + w1 b1 + w2 b2
        nu2 = n_s + 2 + 3 * n
        a2 = np.zeros((6 * m, nu2))
        rhs2 = np.zeros(6 * m)
        g0 = g_mag * g_hat
        for i, pre in enumerate(preints):
            ri = Twb_list[i].R
            pi, pj = Twb_list[i].t, Twb_list[i + 1].t
            dt = pre.dT
            r0 = 6 * i
            a2[r0 : r0 + 3, n_s] = -0.5 * dt * dt * b1
            a2[r0 : r0 + 3, n_s + 1] = -0.5 * dt * dt * b2
            a2[r0 : r0 + 3, n_s + 2 + 3 * i : n_s + 5 + 3 * i] = -dt * np.eye(3)
            base = ri @ pre.dP + 0.5 * dt * dt * g0
            if fix_scale:
                rhs2[r0 : r0 + 3] = base - (pj - pi)
            else:
                a2[r0 : r0 + 3, 0] = pj - pi
                rhs2[r0 : r0 + 3] = base
            r1 = r0 + 3
            a2[r1 : r1 + 3, n_s] = dt * b1
            a2[r1 : r1 + 3, n_s + 1] = dt * b2
            a2[r1 : r1 + 3, n_s + 2 + 3 * i : n_s + 5 + 3 * i] = np.eye(3)
            a2[r1 : r1 + 3, n_s + 2 + 3 * (i + 1) : n_s + 5 + 3 * (i + 1)] = -np.eye(3)
            rhs2[r1 : r1 + 3] = -ri @ pre.dV - dt * g0
        x2, *_ = np.linalg.lstsq(a2, rhs2, rcond=None)
        if fix_scale:
            s = 1.0
            w1, w2 = x2[0], x2[1]
            v = x2[2:].reshape(n, 3)
        else:
            s = float(x2[0])
            w1, w2 = x2[1], x2[2]
            v = x2[3:].reshape(n, 3)
        g_new = g0 + w1 * b1 + w2 * b2
        g_hat = g_new / max(np.linalg.norm(g_new), 1e-12)
        if abs(w1) + abs(w2) < 1e-9:
            break
    return s, g_mag * g_hat, v


class _CorrectedPre:
    """Bias-corrected view of a Preintegrated (first-order delta getters)."""

    def __init__(self, pre, bias: Bias):
        self.dT = pre.dT
        self.dR = pre.get_delta_rotation(bias)
        self.dV = pre.get_delta_velocity(bias)
        self.dP = pre.get_delta_position(bias)


def initialize_imu_chain(Twb_list: list, preints: list, fix_scale: bool):
    """Full VI init on a temporal keyframe chain (InitializeIMU role):
    gyro bias from rotation residuals, then linear scale/gravity/velocity
    alignment with the bias-corrected deltas.
    Returns (bg, scale, gravity_world, velocities (N,3))."""
    bg = estimate_gyro_bias([T.R for T in Twb_list], preints)
    corr = [_CorrectedPre(p, Bias(np.zeros(3), bg)) for p in preints]
    s, g, v = align_visual_inertial(Twb_list, corr, fix_scale)
    return bg, s, g, v


def gravity_alignment_rotation(g_est: np.ndarray) -> np.ndarray:
    """Rotation taking the estimated gravity to the canonical -z axis
    (used with Map::ApplyScaledRotation to re-level the world)."""
    gn = g_est / max(np.linalg.norm(g_est), 1e-12)
    gz = GRAVITY / np.linalg.norm(GRAVITY)
    v = np.cross(gn, gz)
    c = float(gn @ gz)
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    ang = np.arccos(np.clip(c, -1, 1))
    return so3_exp(v / np.linalg.norm(v) * ang)
