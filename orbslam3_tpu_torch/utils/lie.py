"""SO(3)/SE(3)/Sim(3) Lie-group utilities (NumPy, vectorized).

The reference does all pose algebra with the vendored Sophus library
(ORB_SLAM3/Thirdparty/Sophus/sophus/{so3,se3,sim3}.hpp).  This module
re-derives the small subset the SLAM stack needs — exp/log maps, the
left-Jacobian, composition/inverse, point action — in batched NumPy form
(every function accepts stacked inputs) so residual/Jacobian evaluation in
the optimizers stays fully vectorized.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-9


def hat(w: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    w = np.asarray(w)
    out = np.zeros(w.shape[:-1] + (3, 3), w.dtype)
    out[..., 0, 1] = -w[..., 2]
    out[..., 0, 2] = w[..., 1]
    out[..., 1, 0] = w[..., 2]
    out[..., 1, 2] = -w[..., 0]
    out[..., 2, 0] = -w[..., 1]
    out[..., 2, 1] = w[..., 0]
    return out


def so3_exp(w: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]  # (..., 1, 1)
    k = hat(w)
    k2 = k @ k
    th2 = th * th
    small = th < 1e-7
    a = np.where(small, 1.0 - th2 / 6.0, np.sin(th) / np.where(small, 1.0, th))
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / np.where(small, 1.0, th2))
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye + a * k + b * k2


def so3_log(r: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation -> (..., 3) axis-angle."""
    r = np.asarray(r, np.float64)
    tr = np.clip((np.trace(r, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(tr)[..., None]
    v = np.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        axis=-1,
    )
    small = th < 1e-7
    near_pi = th > np.pi - 1e-5
    scale = np.where(small, 0.5 + th * th / 12.0, th / (2.0 * np.where(small, 1.0, np.sin(th))))
    w = v * scale
    if np.any(near_pi):
        # diagonal method for angles near pi
        idx = np.nonzero(near_pi[..., 0])
        for i in zip(*idx):
            ri = r[i]
            d = np.diagonal(ri)
            k = int(np.argmax(d))
            axis = np.sqrt(np.maximum((np.array([ri[0, 0], ri[1, 1], ri[2, 2]]) + 1.0) / 2.0, 0))
            axis[(k + 1) % 3] = ri[k, (k + 1) % 3] / (2 * axis[k] + 1e-12) if axis[k] > 0 else axis[(k + 1) % 3]
            axis[(k + 2) % 3] = ri[k, (k + 2) % 3] / (2 * axis[k] + 1e-12) if axis[k] > 0 else axis[(k + 2) % 3]
            axis = axis / (np.linalg.norm(axis) + 1e-12)
            # sign from off-diagonals
            s = np.array([ri[2, 1] - ri[1, 2], ri[0, 2] - ri[2, 0], ri[1, 0] - ri[0, 1]])
            if s @ axis < 0:
                axis = -axis
            w[i] = axis * th[i + (0,)]
    return w


def so3_left_jacobian(w: np.ndarray) -> np.ndarray:
    """Left Jacobian J_l of SO(3): exp(w) p' integration factor."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = hat(w)
    k2 = k @ k
    th2 = th * th
    small = th < 1e-7
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / np.where(small, 1.0, th2))
    c = np.where(small, 1.0 / 6.0 - th2 / 120.0, (th - np.sin(th)) / np.where(small, 1.0, th2 * th))
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye + b * k + c * k2


class SE3:
    """Rigid transform; thin wrapper over (R (..., 3, 3), t (..., 3))."""

    __slots__ = ("R", "t")

    def __init__(self, R=None, t=None):
        self.R = np.eye(3) if R is None else np.asarray(R, np.float64)
        self.t = np.zeros(3) if t is None else np.asarray(t, np.float64)

    def normalized(self) -> "SE3":
        """Re-orthonormalize R (nearest rotation by SVD).

        Long composition chains (per-frame re-anchoring against reference
        keyframes) compound float error, and `inverse()` uses the transpose
        — only exact for orthonormal R — so tiny errors AMPLIFY
        exponentially through inverse/multiply cycles (observed 1e-9 ->
        1e-2 over 20 frames, silently displacing Gauss-Newton fixed points
        off the cost minimum).  Persistent pose state must pass through
        this."""
        return SE3(project_to_so3(self.R), self.t)

    @staticmethod
    def exp(xi: np.ndarray) -> "SE3":
        """xi = (..., 6): [rho (trans), phi (rot)] -> SE3 (Sophus convention)."""
        xi = np.asarray(xi, np.float64)
        rho, phi = xi[..., :3], xi[..., 3:]
        r = so3_exp(phi)
        t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
        return SE3(r, t)

    def log(self) -> np.ndarray:
        phi = so3_log(self.R)
        jl = so3_left_jacobian(phi)
        rho = np.linalg.solve(jl, self.t[..., None] if self.t.ndim == phi.ndim else self.t[..., None])[..., 0]
        return np.concatenate([rho, phi], axis=-1)

    def inverse(self) -> "SE3":
        rt = np.swapaxes(self.R, -1, -2)
        return SE3(rt, -(rt @ self.t[..., None])[..., 0])

    def __mul__(self, other):
        if isinstance(other, SE3):
            return SE3(self.R @ other.R, (self.R @ other.t[..., None])[..., 0] + self.t)
        p = np.asarray(other)
        return (self.R @ p[..., None])[..., 0] + self.t

    def apply(self, pts: np.ndarray) -> np.ndarray:
        """(..., N, 3) or (N, 3) points."""
        return pts @ np.swapaxes(self.R, -1, -2) + self.t

    def matrix(self) -> np.ndarray:
        m = np.zeros(self.R.shape[:-2] + (4, 4))
        m[..., :3, :3] = self.R
        m[..., :3, 3] = self.t
        m[..., 3, 3] = 1.0
        return m

    @staticmethod
    def from_matrix(m: np.ndarray) -> "SE3":
        m = np.asarray(m)
        return SE3(m[..., :3, :3], m[..., :3, 3])

    def copy(self) -> "SE3":
        return SE3(self.R.copy(), self.t.copy())

    def __repr__(self):
        return f"SE3(t={np.round(self.t, 4)})"


class Sim3:
    """Similarity transform (s, R, t) for loop closing (Sophus sim3 analog)."""

    __slots__ = ("s", "R", "t")

    def __init__(self, s=1.0, R=None, t=None):
        self.s = float(s)
        self.R = np.eye(3) if R is None else np.asarray(R, np.float64)
        self.t = np.zeros(3) if t is None else np.asarray(t, np.float64)

    def inverse(self) -> "Sim3":
        rt = self.R.T
        return Sim3(1.0 / self.s, rt, -(rt @ self.t) / self.s)

    def __mul__(self, other):
        if isinstance(other, Sim3):
            return Sim3(self.s * other.s, self.R @ other.R, self.s * (self.R @ other.t) + self.t)
        if isinstance(other, SE3):
            return Sim3(self.s, self.R @ other.R, self.s * (self.R @ other.t) + self.t)
        p = np.asarray(other)
        return self.s * (self.R @ p[..., None])[..., 0] + self.t

    def apply(self, pts: np.ndarray) -> np.ndarray:
        return self.s * (pts @ self.R.T) + self.t

    def to_se3(self) -> SE3:
        """Drop scale (used when applying a corrected Sim3 as a pose)."""
        return SE3(self.R, self.t / self.s)

    @staticmethod
    def from_se3(T: SE3, s: float = 1.0) -> "Sim3":
        return Sim3(s, T.R.copy(), T.t.copy())

    def normalized(self) -> "Sim3":
        return Sim3(self.s, project_to_so3(self.R), self.t)

    @staticmethod
    def exp(xi: np.ndarray) -> "Sim3":
        """xi = [rho(3), phi(3), sigma(1)] -> Sim3 (approximate W: uses the
        SE3 left-Jacobian for translation plus exact scale — adequate for
        pose-graph increments, which are small)."""
        rho, phi, sigma = xi[:3], xi[3:6], float(xi[6])
        s = float(np.exp(sigma))
        r = so3_exp(phi)
        # first-order scale coupling: t = s_factor * J_l(phi) rho
        jl = so3_left_jacobian(phi)
        if abs(sigma) < 1e-7:
            a = 1.0 + sigma / 2.0
        else:
            a = (s - 1.0) / sigma
        t = a * (jl @ rho)
        return Sim3(s, r, t)

    def log(self) -> np.ndarray:
        sigma = float(np.log(self.s))
        phi = so3_log(self.R)
        jl = so3_left_jacobian(phi)
        if abs(sigma) < 1e-7:
            a = 1.0 + sigma / 2.0
        else:
            a = (self.s - 1.0) / sigma
        rho = np.linalg.solve(a * jl, self.t)
        return np.concatenate([rho, phi, [sigma]])


_I3 = np.eye(3)


def project_to_so3(r: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix (polar factor).

    Hot path (persistent poses are re-normalized every frame) — for the
    near-orthonormal inputs this sees (E = RᵀR − I with ‖E‖ ≲ 1e-6 of
    accumulated float drift) the polar factor R(RᵀR)^(-1/2) is computed
    with the 2-term inverse-sqrt series I − E/2 + 3E²/8 (error O(‖E‖³),
    below double ulp for ‖E‖ < 1e-5) at ~20x the speed of the SVD, which
    remains the general fallback (and the spec: both compute the same
    polar factor / nearest rotation)."""
    if r.shape == (3, 3):
        e = r.T @ r
        e.flat[::4] -= 1.0
        n = np.abs(e).max()
        # the series projects onto the nearest ORTHOGONAL matrix; require
        # det > 0 so reflections still take the SVD's proper-rotation fix
        if n < 1e-5 and np.linalg.det(r) > 0:
            if n < 1e-15:
                return r.copy()  # never alias the caller's array
            return r @ (_I3 - 0.5 * e + 0.375 * (e @ e))
    u, _, vt = np.linalg.svd(r)
    d = np.sign(np.linalg.det(u @ vt))
    return u @ np.diag([1.0, 1.0, d]) @ vt
