"""Local inertial bundle adjustment over the temporal keyframe window.

Role-parity with Optimizer::LocalInertialBA (ORB_SLAM3/src/
Optimizer4.cc:48) and the visual-inertial factor graph of G2oTypes
(EdgeInertial include/G2oTypes.h:495, EdgeGyroRW :635, EdgeAccRW :671,
EdgeMono/EdgeStereo :342-466): jointly refine the 15-dof states
[Rwb, twb, v, bg, ba] of the last N temporal keyframes against

 - reprojection residuals of their map points,
 - Forster preintegration residuals between consecutive states,
 - bias random-walk residuals,

with the state before the window held fixed (the reference fixes the
window's temporal predecessor the same way, Optimizer4.cc:100 region).

Design deviation from the reference (deliberate, documented): g2o solves
one sparse graph with both pose and landmark vertices; here landmark
refinement is delegated to the vectorized Schur BA (local_ba.py) and this
module solves the dense 15N-state chain with landmarks fixed — a
block-coordinate split.  At window sizes <= 10 the chain system is a
150x150 dense solve, microseconds in LAPACK, and the alternation converges
in 2 passes on SLAM-conditioned problems.  All Jacobians are analytic;
tests check them against central differences.

State increments (matching the reference's ImuCamPose update,
src/G2oTypes.cc VertexPose::oplusImpl): R <- R Exp(phi), p <- p + R dp,
v <- v + dv, biases additive.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from orbslam3_tpu_torch.imu.preintegration import GRAVITY, Bias
from orbslam3_tpu_torch.utils.lie import SE3, hat, so3_exp, so3_log, so3_left_jacobian

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


@dataclass
class NavState:
    """15-dof visual-inertial state of one keyframe (body frame)."""

    R: np.ndarray   # Rwb
    p: np.ndarray   # twb
    v: np.ndarray   # world velocity
    bg: np.ndarray
    ba: np.ndarray

    def copy(self):
        return NavState(self.R.copy(), self.p.copy(), self.v.copy(),
                        self.bg.copy(), self.ba.copy())


def _retract(s: NavState, dx: np.ndarray) -> NavState:
    return NavState(
        s.R @ so3_exp(dx[0:3]),
        s.p + s.R @ dx[3:6],
        s.v + dx[6:9],
        s.bg + dx[9:12],
        s.ba + dx[12:15],
    )


def _inv_right_jacobian(phi: np.ndarray) -> np.ndarray:
    """Inverse of the SO(3) right Jacobian Jr(phi)."""
    th = np.linalg.norm(phi)
    if th < 1e-8:
        return np.eye(3) + 0.5 * hat(phi)
    k = hat(phi)
    return (
        np.eye(3)
        + 0.5 * k
        + (1.0 / th**2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th))) * (k @ k)
    )


def _right_jacobian(phi: np.ndarray) -> np.ndarray:
    return so3_left_jacobian(-phi)


# ---------------------------------------------------------------------------
# Residual blocks.  Each returns (residual, {state_index: jacobian}) with the
# residual already whitened (premultiplied by the sqrt information).
# ---------------------------------------------------------------------------

def _visual_block(states, Tcb: SE3, obs, log_scale: float = 0.0,
                  scale_center: np.ndarray | None = None):
    """Reprojection residuals of fixed landmarks vs the window states.

    obs: dict with kf_idx (O,), pw (O,3), uv (O,2), ur (O,), inv_sigma2 (O,).
    Returns residual rows (O,3) (3rd row zero for mono), jacobians (O,3,6)
    w.r.t. [phi, dp] of the owning state, the jacobian column (O,3) w.r.t.
    a global landmark log-scale (landmarks enter as
    c + e^sigma * (pw - c), scaled about the anchor `scale_center` so the
    fixed anchor pose stays consistent — the mono-inertial scale variable),
    mask of stereo rows, chi2 (O,).
    """
    Rcb, tcb = Tcb.R, Tcb.t
    R = np.stack([states[i].R for i in range(len(states))])[obs["kf_idx"]]
    p = np.stack([states[i].p for i in range(len(states))])[obs["kf_idx"]]
    c0 = np.zeros(3) if scale_center is None else scale_center
    pw_rel = (obs["pw"] - c0) * np.exp(log_scale)
    pw = c0 + pw_rel
    pb = ((pw - p)[:, None, :] @ R)[:, 0, :]          # R^T (pw - p)
    pc = pb @ Rcb.T + tcb
    camera = obs["camera"]
    ir = obs.get("is_right")
    if ir is not None and ir.any():
        # fisheye right-camera rows: project through Trl + camera2 with
        # Trl.R folded into the projection Jacobian (the reference's
        # EdgeMono with camera index 1)
        trl = obs["Trl"]
        cam2 = obs["camera2"]
        uv = np.empty((len(pc), 2))
        jproj = np.empty((len(pc), 2, 3))
        il = ~ir
        if il.any():
            uv[il] = camera.project(pc[il])
            jproj[il] = camera.project_jac(pc[il])
        pc_r = pc[ir] @ trl.R.T + trl.t
        uv[ir] = cam2.project(pc_r)
        jproj[ir] = cam2.project_jac(pc_r) @ trl.R
    else:
        uv = camera.project(pc)
        jproj = camera.project_jac(pc)                 # (O, 2, 3)
    res_uv = obs["uv"] - uv
    stereo = obs["ur"] >= 0
    z = np.maximum(pc[:, 2], 1e-9)
    ur_pred = uv[:, 0] - obs["mbf"] / z
    res_ur = np.where(stereo, obs["ur"] - ur_pred, 0.0)
    res = np.concatenate([res_uv, res_ur[:, None]], axis=1)   # (O, 3)

    # d pb / d(phi, dp) = [hat(pb), -I]; d pc = Rcb @ that
    o = len(pw)
    dpb = np.concatenate([hat(pb), -np.broadcast_to(np.eye(3), (o, 3, 3))], axis=2)
    dpc = np.einsum("ij,ojk->oik", Rcb, dpb)           # (O, 3, 6)
    j_uv = jproj @ dpc                                 # (O, 2, 6)
    mz = (obs["mbf"] / (z * z))[:, None]
    j_ur = np.where(stereo[:, None], j_uv[:, 0, :] + mz * dpc[:, 2, :], 0.0)
    jac = np.concatenate([j_uv, j_ur[:, None, :]], axis=1)    # (O, 3, 6)
    # global log-scale column: d pb/d sigma = R^T e^s (pw-c); d pc = Rcb @ .
    dpc_s = (pw_rel[:, None, :] @ R)[:, 0, :] @ Rcb.T          # (O, 3)
    j_uv_s = np.einsum("orj,oj->or", jproj, dpc_s)             # (O, 2)
    j_ur_s = np.where(stereo, j_uv_s[:, 0] + mz[:, 0] * dpc_s[:, 2], 0.0)
    jac_s = np.concatenate([j_uv_s, j_ur_s[:, None]], axis=1)  # (O, 3)
    # residual = obs - pred -> d res = -jac
    chi2 = np.where(stereo, (res**2).sum(1), (res[:, :2] ** 2).sum(1)) * obs["inv_sigma2"]
    return res, -jac, -jac_s, stereo, chi2


def _inertial_block(s1: NavState, s2: NavState, pre):
    """Forster residual r = [r_R, r_v, r_p] (9,) + analytic jacobians.

    Returns (r, J1 (9,15) wrt state1, J2 (9,15) wrt state2) — raw
    (unwhitened).  Bias columns bind to state1's bias (EdgeInertial
    semantics: the preintegration was corrected with b1).
    """
    b1 = Bias(s1.ba, s1.bg)
    dt = pre.dT
    dR = pre.get_delta_rotation(b1)
    dV = pre.get_delta_velocity(b1)
    dP = pre.get_delta_position(b1)
    R1, p1, v1 = s1.R, s1.p, s1.v
    R2, p2, v2 = s2.R, s2.p, s2.v

    eR = dR.T @ R1.T @ R2
    r_R = so3_log(eR)
    dv_w = v2 - v1 - GRAVITY * dt
    dp_w = p2 - p1 - v1 * dt - 0.5 * GRAVITY * dt * dt
    r_v = R1.T @ dv_w - dV
    r_p = R1.T @ dp_w - dP
    r = np.concatenate([r_R, r_v, r_p])

    invJr = _inv_right_jacobian(r_R)
    J1 = np.zeros((9, 15))
    J2 = np.zeros((9, 15))
    # rotation rows
    J1[0:3, 0:3] = -invJr @ R2.T @ R1
    J2[0:3, 0:3] = invJr
    # d r_R / d bg1: dR depends on b1 through Exp(JRg db); first-order
    dbg = s1.bg - pre.b.bg
    J1[0:3, 9:12] = -invJr @ eR.T @ _right_jacobian(pre.JRg @ dbg) @ pre.JRg
    # velocity rows
    J1[3:6, 0:3] = hat(R1.T @ dv_w)
    J1[3:6, 6:9] = -R1.T
    J2[3:6, 6:9] = R1.T
    J1[3:6, 9:12] = -pre.JVg
    J1[3:6, 12:15] = -pre.JVa
    # position rows (p <- p + R dp: d(R1^T(p2-p1))/d dp1 = -I, /d dp2 = R1^T R2)
    J1[6:9, 0:3] = hat(R1.T @ dp_w)
    J1[6:9, 3:6] = -np.eye(3)
    J2[6:9, 3:6] = R1.T @ R2
    J1[6:9, 6:9] = -R1.T * dt
    J1[6:9, 9:12] = -pre.JPg
    J1[6:9, 12:15] = -pre.JPa
    return r, J1, J2


def _sqrt_info(cov: np.ndarray, floor: float) -> np.ndarray:
    """Upper-triangular sqrt of cov^-1 (whitener)."""
    c = 0.5 * (cov + cov.T) + floor * np.eye(len(cov))
    try:
        L = np.linalg.cholesky(np.linalg.inv(c))
        return L.T
    except np.linalg.LinAlgError:
        w, v = np.linalg.eigh(np.linalg.pinv(c))
        return (v * np.sqrt(np.maximum(w, 0))).T


# ---------------------------------------------------------------------------
# The window optimizer
# ---------------------------------------------------------------------------

def optimize_inertial_window(
    states: list[NavState],
    preints: list,
    visual_obs: dict | None,
    Tcb: SE3,
    fixed: np.ndarray,
    n_iters: int = 8,
    huber: bool = True,
    opt_scale: bool = False,
    ba_prior_sigma: float | None = None,
    abort_flag=None,
):
    """GN/LM over the chain.  states: N NavStates; preints: N-1 windows
    (preints[i] spans states[i] -> states[i+1]); visual_obs as in
    _visual_block (kf_idx indexes `states`); fixed: (N,) bool.

    `ba_prior_sigma` adds an absolute prior pulling every free state's
    accelerometer bias toward zero (the reference's priorA edges,
    Optimizer4.cc InertialOptimization priors): without it the weakly
    excited accel-bias direction silently absorbs map-scale error during
    the visual-inertial initialization phase.

    With `opt_scale` a global landmark log-scale joins the state (landmarks
    enter the visual residuals as e^sigma * pw while poses stay free): the
    joint solve recovers mono-inertial metric scale without the
    errors-in-variables attenuation that biases any poses-fixed linear
    alignment (Optimizer::InertialOptimization-with-scale role,
    ORB_SLAM3/src/Optimizer5.cc:52).

    Returns (new states, final visual chi2 or None) — and with opt_scale,
    (states, chi2, scale) where scale = e^sigma to apply to the map.
    """
    n = len(states)
    free_idx = np.nonzero(~np.asarray(fixed))[0]
    slot = {int(i): k for k, i in enumerate(free_idx)}
    nf = len(free_idx)
    if nf == 0:
        return [s.copy() for s in states], None
    states = [s.copy() for s in states]
    nvar = 15 * nf + (1 if opt_scale else 0)
    sigma = 0.0
    scale_center = None
    if opt_scale:
        anchors = np.nonzero(np.asarray(fixed))[0]
        scale_center = (
            states[int(anchors[0])].p.copy() if len(anchors) else np.zeros(3)
        )

    # whiteners for the inertial and walk blocks (fixed across iterations —
    # the covariances are measurement properties, not state-dependent)
    w_in = [_sqrt_info(p.C[:9, :9], 1e-10) for p in preints]
    w_gw = [_sqrt_info(p.C[9:12, 9:12], 1e-14) for p in preints]
    w_aw = [_sqrt_info(p.C[12:15, 12:15], 1e-12) for p in preints]

    def build(st, sig):
        h = np.zeros((nvar, nvar))
        g = np.zeros(nvar)
        cost = 0.0
        chi2_vis = None
        # --- visual ---
        if visual_obs is not None and len(visual_obs["pw"]):
            res, jac, jac_s, stereo, chi2 = _visual_block(
                st, Tcb, visual_obs, sig, scale_center
            )
            chi2_vis = chi2
            w = visual_obs["inv_sigma2"].copy()
            if huber:
                delta = np.where(stereo, np.sqrt(CHI2_STEREO), np.sqrt(CHI2_MONO))
                e = np.sqrt(np.maximum(chi2, 1e-18))
                w = w * np.where(e <= delta, 1.0, delta / e)
                rho = np.where(
                    e <= delta, chi2, 2 * delta * e - delta**2
                )
                cost += float(rho.sum())
            else:
                cost += float(chi2.sum())
            # mono rows already have zero 3rd residual/jacobian row
            jw = jac * (w[:, None, None])
            h_blk = np.einsum("ori,orj->oij", jw, jac)        # (O, 6, 6)
            g_blk = np.einsum("ori,or->oi", jw, res)          # (O, 6)
            slot_arr = np.full(n, -1)
            for ki, k in slot.items():
                slot_arr[ki] = k
            sl = slot_arr[visual_obs["kf_idx"]]
            m = sl >= 0
            h66 = np.zeros((nf, 6, 6))
            g6 = np.zeros((nf, 6))
            np.add.at(h66, sl[m], h_blk[m])
            np.add.at(g6, sl[m], g_blk[m])
            for k in range(nf):
                h[k * 15 : k * 15 + 6, k * 15 : k * 15 + 6] += h66[k]
                g[k * 15 : k * 15 + 6] += g6[k]
            if opt_scale:
                sc = nvar - 1
                jsw = jac_s * w[:, None]                       # (O, 3)
                h[sc, sc] += float(np.einsum("or,or->", jsw, jac_s))
                g[sc] += float(np.einsum("or,or->", jsw, res))
                # pose-scale cross terms (including obs on fixed states:
                # their pose block is absent but sigma is global)
                cross = np.einsum("ori,or->oi", jw, jac_s)     # (O, 6)
                c6 = np.zeros((nf, 6))
                np.add.at(c6, sl[m], cross[m])
                for k in range(nf):
                    h[k * 15 : k * 15 + 6, sc] += c6[k]
                    h[sc, k * 15 : k * 15 + 6] += c6[k]
        # --- inertial + walk ---
        for i, pre in enumerate(preints):
            r, J1, J2 = _inertial_block(st[i], st[i + 1], pre)
            rw = w_in[i] @ r
            J1w = w_in[i] @ J1
            J2w = w_in[i] @ J2
            cost += float(rw @ rw)
            parts = []
            if int(i) in slot:
                parts.append((slot[i] * 15, J1w))
            if int(i + 1) in slot:
                parts.append((slot[i + 1] * 15, J2w))
            for sa, Ja in parts:
                g[sa : sa + 15] += Ja.T @ rw
                for sb, Jb in parts:
                    h[sa : sa + 15, sb : sb + 15] += Ja.T @ Jb
            # absolute accel-bias prior (priorA role)
            if ba_prior_sigma is not None and int(i + 1) in slot:
                wp = 1.0 / ba_prior_sigma
                sa = slot[i + 1] * 15 + 12
                r_ba = wp * st[i + 1].ba
                cost += float(r_ba @ r_ba)
                h[sa : sa + 3, sa : sa + 3] += wp * wp * np.eye(3)
                g[sa : sa + 3] += wp * r_ba
            # bias random walk between i and i+1 (binds both bias blocks)
            r_g = st[i + 1].bg - st[i].bg
            r_a = st[i + 1].ba - st[i].ba
            for (rr, wmat, off) in ((r_g, w_gw[i], 9), (r_a, w_aw[i], 12)):
                rw2 = wmat @ rr
                cost += float(rw2 @ rw2)
                entries = []
                if int(i) in slot:
                    entries.append((slot[i] * 15 + off, -wmat))
                if int(i + 1) in slot:
                    entries.append((slot[i + 1] * 15 + off, wmat))
                for sa, Ja in entries:
                    g[sa : sa + 3] += Ja.T @ rw2
                    for sb, Jb in entries:
                        h[sa : sa + 3, sb : sb + 3] += Ja.T @ Jb
        return h, g, cost, chi2_vis

    lam = 1e-4
    h, g, cost, chi2_vis = build(states, sigma)
    if opt_scale:
        # 1-D line search along the scale ray (poses+velocities+landmarks
        # scaled together about the anchor) before the joint solve: the
        # coupled problem has a visually-consistent local minimum where the
        # accel biases absorb the inertial misfit — the ray scan jumps the
        # valley that separates it from the metric optimum.
        def _solve_velocities(st):
            """Exact LSQ velocities given poses/biases (residuals are
            linear in v); one dense solve over 3N unknowns."""
            nn = len(st)
            hh = np.zeros((3 * nn, 3 * nn))
            gg = np.zeros(3 * nn)
            for i, pre in enumerate(preints):
                r, J1, J2 = _inertial_block(st[i], st[i + 1], pre)
                rw = w_in[i] @ r
                j1 = w_in[i] @ J1[:, 6:9]
                j2 = w_in[i] @ J2[:, 6:9]
                s1, s2 = 3 * i, 3 * (i + 1)
                hh[s1 : s1 + 3, s1 : s1 + 3] += j1.T @ j1
                hh[s2 : s2 + 3, s2 : s2 + 3] += j2.T @ j2
                hh[s1 : s1 + 3, s2 : s2 + 3] += j1.T @ j2
                hh[s2 : s2 + 3, s1 : s1 + 3] += j2.T @ j1
                gg[s1 : s1 + 3] += j1.T @ rw
                gg[s2 : s2 + 3] += j2.T @ rw
            try:
                dv = np.linalg.solve(hh + 1e-9 * np.eye(3 * nn), -gg)
            except np.linalg.LinAlgError:
                return st
            return [
                NavState(s.R, s.p, s.v + dv[3 * i : 3 * i + 3], s.bg, s.ba)
                for i, s in enumerate(st)
            ]

        def ray_states(lam_s):
            # Scale EVERY state's position about the anchor (which is
            # therefore invariant) — including fixed states: the solver
            # can't touch them, so the ray must carry them, else their
            # edges pin the scale.  Velocities are RE-SOLVED exactly for
            # each candidate scale (the stored estimates may sit at a
            # different effective scale than the positions — inertial
            # refinements pull them metric-ward while vision holds the
            # positions), and accel biases reset to zero (they may have
            # absorbed scale error), so the scan profiles a self-consistent
            # trajectory at each candidate scale.
            st = [
                NavState(
                    s.R.copy(),
                    scale_center + lam_s * (s.p - scale_center),
                    lam_s * s.v,
                    s.bg.copy(),
                    np.zeros(3),
                )
                for s in states
            ]
            return _solve_velocities(st)

        best_c, best_lam = cost, 1.0
        for lam_try in np.exp(np.linspace(np.log(0.4), np.log(2.5), 25)):
            _, _, c_try, _ = build(ray_states(lam_try), float(np.log(lam_try)))
            if c_try < best_c:
                best_c, best_lam = c_try, float(lam_try)
        if best_lam != 1.0:
            states = ray_states(best_lam)
            sigma = float(np.log(best_lam))
            h, g, cost, chi2_vis = build(states, sigma)
    for _ in range(n_iters):
        if abort_flag is not None and abort_flag:
            break  # interrupted (mbAbortBA) — return the partial result
        stepped = False
        for _ in range(6):
            hd = h + lam * np.diag(np.maximum(np.diag(h), 1e-8))
            try:
                dx = np.linalg.solve(hd, -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            st_new = [s.copy() for s in states]
            for ki, k in slot.items():
                st_new[ki] = _retract(states[ki], dx[k * 15 : k * 15 + 15])
            sig_new = sigma + (float(dx[-1]) if opt_scale else 0.0)
            h2, g2, c2, chi2_new = build(st_new, sig_new)
            if c2 < cost:
                states, h, g, cost, chi2_vis = st_new, h2, g2, c2, chi2_new
                sigma = sig_new
                lam = max(lam / 3, 1e-9)
                stepped = True
                break
            lam *= 10
        if not stepped:
            break
    if opt_scale:
        return states, chi2_vis, float(np.exp(sigma)), scale_center
    return states, chi2_vis


# ---------------------------------------------------------------------------
# SLAM-facing entry: gather the window from the map, alternate with the
# visual Schur BA, write back.
# ---------------------------------------------------------------------------

def local_inertial_ba(kf, map_, calib, window: int = 10, recent_gba: bool = False,
                      ba_prior_sigma: float | None = None, abort_flag=None):
    """Optimizer::LocalInertialBA role: take the temporal chain ending at
    `kf` (linked via kf.prev_kf with preintegrations), refine its states and
    the local landmarks.  Landmarks move in the visual Schur pass
    (local_ba), states move in the inertial chain pass; two alternations.
    """
    from orbslam3_tpu_torch.optim.local_ba import local_bundle_adjustment

    chain = [kf]
    while (
        len(chain) < window
        and chain[-1].prev_kf is not None
        and not chain[-1].prev_kf.bad
        and chain[-1].imu_preint is not None
    ):
        chain.append(chain[-1].prev_kf)
    chain.reverse()
    if len(chain) < 3:
        return 0
    Tbc = calib.Tbc
    Tcb = Tbc.inverse()

    for _pass in range(2):
        if abort_flag is not None and abort_flag:
            break
        # visual pass: poses + landmarks (camera parameterization)
        local_bundle_adjustment(kf, map_, abort_flag=abort_flag)
        # chain pass: 15-dof states, landmarks fixed
        states = []
        for k in chain:
            # Twb = Twc * Tcb (Tbc maps camera->body coords, x_b = Tbc x_c)
            Twb = (k.Twc * Tcb).normalized()
            states.append(
                NavState(
                    Twb.R,
                    Twb.t,
                    k.velocity if k.velocity is not None else np.zeros(3),
                    k.imu_bias.bg.copy(),
                    k.imu_bias.ba.copy(),
                )
            )
        preints = [chain[i + 1].imu_preint for i in range(len(chain) - 1)]
        if any(p is None for p in preints):
            return 0
        kf_idx, pw, uv, ur, is2, isr = [], [], [], [], [], []
        for i, k in enumerate(chain):
            for j, mp in k.get_map_point_indices():
                kf_idx.append(i)
                pw.append(mp.position)
                uv.append(k.kps_un[j])
                ur.append(k.u_right[j])
                is2.append(k.inv_level_sigma2[k.octave[j]])
                isr.append(j >= getattr(k, "n_left", len(k.kps_un)))
        obs = dict(
            kf_idx=np.asarray(kf_idx),
            pw=np.asarray(pw, np.float64),
            uv=np.asarray(uv, np.float64),
            ur=np.asarray(ur, np.float64),
            inv_sigma2=np.asarray(is2, np.float64),
            camera=kf.camera,
            mbf=kf.mbf,
            is_right=(
                np.asarray(isr, bool)
                if getattr(kf, "camera2", None) is not None
                else None
            ),
            camera2=getattr(kf, "camera2", None),
            Trl=getattr(kf, "Trl", None),
        )
        fixed = np.zeros(len(chain), bool)
        fixed[0] = True  # temporal anchor (reference fixes the predecessor)
        states, _ = optimize_inertial_window(
            states, preints, obs, Tcb, fixed, ba_prior_sigma=ba_prior_sigma,
            abort_flag=abort_flag,
        )
        for k, s in zip(chain, states):
            Twb = SE3(s.R, s.p).normalized()
            k.set_pose((Twb * Tbc).inverse())
            k.velocity = s.v.copy()
            k.imu_bias = Bias(s.ba.copy(), s.bg.copy())
            if k.imu_preint is not None:
                k.imu_preint.set_new_bias(k.imu_bias)
    map_.info_changed()
    return len(chain)
