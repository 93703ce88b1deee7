"""Camera models: Pinhole (+ radial-tangential undistortion) and
KannalaBrandt8 fisheye.

Parity surface (re-derived, vectorized NumPy — not a translation):
 - abstract interface mirrors GeometricCamera
   (ORB_SLAM3/include/CameraModels/GeometricCamera.h:61-86):
   project / unproject / project_jac / epipolar constraint /
   two-view reconstruction hook / triangulate_matches (fisheye).
 - Pinhole: ORB_SLAM3/src/CameraModels/Pinhole.cpp (project :44-60,
   unproject :62-81, jacobian :83-?); distortion handling lives in
   Frame::UndistortKeyPoints via cv::undistortPoints — here the model owns
   its distortion coefficients and exposes undistort_points directly.
 - KannalaBrandt8: equidistant model r(theta) = theta + k0 theta^3 +
   k1 theta^5 + k2 theta^7 + k3 theta^9 with Newton inversion
   (ORB_SLAM3/src/CameraModels/KannalaBrandt8.cpp: project :44-77,
   unproject via theta solve :96-146, TriangulateMatches :177-433).
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3


class GeometricCamera:
    """Abstract camera. Points are (N, 3) camera-frame; pixels (N, 2)."""

    CAM_PINHOLE = 0
    CAM_FISHEYE = 1

    def __init__(self, params: np.ndarray, cam_type: int):
        self.params = np.asarray(params, np.float64)
        self.cam_type = cam_type

    # --- core interface -------------------------------------------------
    def project(self, p3d: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def unproject(self, p2d: np.ndarray) -> np.ndarray:
        """Pixels -> unit-depth bearing points (N, 3) with z=1 scaling."""
        raise NotImplementedError

    def project_jac(self, p3d: np.ndarray) -> np.ndarray:
        """(N, 2, 3) d pixel / d camera-point."""
        raise NotImplementedError

    # --- shared helpers --------------------------------------------------
    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[1]

    @property
    def cx(self):
        return self.params[2]

    @property
    def cy(self):
        return self.params[3]

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]]
        )

    def epipolar_constrain(
        self,
        other: "GeometricCamera",
        kp1: np.ndarray,
        kp2: np.ndarray,
        R12: np.ndarray,
        t12: np.ndarray,
        sigma2: float,
        unc: float = 5.991,
    ) -> np.ndarray:
        """Symmetric epipolar test used by SearchForTriangulation
        (GeometricCamera::epipolarConstrain semantics).  Returns bool (N,)."""
        t12 = np.asarray(t12).reshape(3)
        tx = np.array(
            [[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]]
        )
        e12 = self.K_inv_T() @ tx @ R12 @ other.K_inv()
        kp1h = np.concatenate([kp1, np.ones((len(kp1), 1))], axis=1)
        kp2h = np.concatenate([kp2, np.ones((len(kp2), 1))], axis=1)
        a = kp1h @ e12  # (N, 3) line coefficients in image 2
        num = np.sum(a * kp2h, axis=1)
        den = a[:, 0] ** 2 + a[:, 1] ** 2
        dsqr = num * num / np.maximum(den, 1e-12)
        return dsqr < unc * sigma2

    def K_inv(self) -> np.ndarray:
        return np.linalg.inv(self.K())

    def K_inv_T(self) -> np.ndarray:
        return np.linalg.inv(self.K()).T


class Pinhole(GeometricCamera):
    """params = [fx, fy, cx, cy]; dist = [k1, k2, p1, p2(, k3)] or None."""

    def __init__(self, params, dist=None):
        super().__init__(params, self.CAM_PINHOLE)
        self.dist = None if dist is None or not np.any(dist) else np.asarray(dist, np.float64)

    def project(self, p3d: np.ndarray) -> np.ndarray:
        p3d = np.asarray(p3d, np.float64)
        z = p3d[..., 2]
        x = p3d[..., 0] / z
        y = p3d[..., 1] / z
        return np.stack([self.fx * x + self.cx, self.fy * y + self.cy], axis=-1)

    def unproject(self, p2d: np.ndarray) -> np.ndarray:
        p2d = np.asarray(p2d, np.float64)
        x = (p2d[..., 0] - self.cx) / self.fx
        y = (p2d[..., 1] - self.cy) / self.fy
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    def project_jac(self, p3d: np.ndarray) -> np.ndarray:
        p3d = np.asarray(p3d, np.float64)
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        zi = 1.0 / z
        zi2 = zi * zi
        jac = np.zeros(p3d.shape[:-1] + (2, 3))
        jac[..., 0, 0] = self.fx * zi
        jac[..., 0, 2] = -self.fx * x * zi2
        jac[..., 1, 1] = self.fy * zi
        jac[..., 1, 2] = -self.fy * y * zi2
        return jac

    def distort_normalized(self, xy: np.ndarray) -> np.ndarray:
        """Apply radial-tangential distortion to normalized coords."""
        if self.dist is None:
            return xy
        k = np.zeros(5)
        k[: len(self.dist)] = self.dist
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1 + k[0] * r2 + k[1] * r2 * r2 + k[4] * r2 * r2 * r2
        xd = x * radial + 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
        yd = y * radial + k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
        return np.stack([xd, yd], axis=-1)

    def undistort_points(self, pts: np.ndarray, iters: int = 10) -> np.ndarray:
        """Pixel -> undistorted pixel (cv::undistortPoints fixed-point iteration)."""
        if self.dist is None:
            return np.asarray(pts, np.float64)
        pts = np.asarray(pts, np.float64)
        xd = (pts[..., 0] - self.cx) / self.fx
        yd = (pts[..., 1] - self.cy) / self.fy
        x, y = xd.copy(), yd.copy()
        k = np.zeros(5)
        k[: len(self.dist)] = self.dist
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1 + k[0] * r2 + k[1] * r2 * r2 + k[4] * r2 * r2 * r2
            dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
            dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return np.stack([self.fx * x + self.cx, self.fy * y + self.cy], axis=-1)


class KannalaBrandt8(GeometricCamera):
    """Fisheye equidistant model; params = [fx, fy, cx, cy, k0, k1, k2, k3]."""

    def __init__(self, params, precision: float = 1e-6):
        super().__init__(params, self.CAM_FISHEYE)
        self.precision = precision

    def _theta_d(self, theta: np.ndarray) -> np.ndarray:
        k = self.params[4:8]
        t2 = theta * theta
        return theta * (1 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))

    def project(self, p3d: np.ndarray) -> np.ndarray:
        p3d = np.asarray(p3d, np.float64)
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        r = np.sqrt(x * x + y * y)
        theta = np.arctan2(r, z)
        td = self._theta_d(theta)
        scale = np.where(r > 1e-8, td / np.maximum(r, 1e-8), 1.0 / np.maximum(z, 1e-8))
        # for r ~ 0 the limit is (fx*x/z + cx): theta/r -> 1/z
        u = np.where(r > 1e-8, self.fx * scale * x + self.cx, self.fx * x / z + self.cx)
        v = np.where(r > 1e-8, self.fy * scale * y + self.cy, self.fy * y / z + self.cy)
        return np.stack([u, v], axis=-1)

    def unproject(self, p2d: np.ndarray) -> np.ndarray:
        """Newton-solve theta from theta_d (KannalaBrandt8::unprojectEig)."""
        p2d = np.asarray(p2d, np.float64)
        mx = (p2d[..., 0] - self.cx) / self.fx
        my = (p2d[..., 1] - self.cy) / self.fy
        td = np.sqrt(mx * mx + my * my)
        td_c = np.minimum(np.maximum(-np.pi / 2, td), np.pi / 2)
        k = self.params[4:8]
        theta = td_c.copy()
        for _ in range(10):
            t2 = theta * theta
            t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
            f = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8) - td_c
            fp = 1 + 3 * k[0] * t2 + 5 * k[1] * t4 + 7 * k[2] * t6 + 9 * k[3] * t8
            theta = theta - f / fp
        scale = np.where(td > 1e-8, np.tan(theta) / np.maximum(td, 1e-8), 1.0)
        return np.stack([mx * scale, my * scale, np.ones_like(mx)], axis=-1)

    def project_jac(self, p3d: np.ndarray) -> np.ndarray:
        p3d = np.asarray(p3d, np.float64)
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        r2 = x * x + y * y
        r = np.sqrt(r2)
        r = np.maximum(r, 1e-12)
        theta = np.arctan2(r, z)
        t2 = theta * theta
        k = self.params[4:8]
        td = theta * (1 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
        dtd_dth = 1 + 3 * k[0] * t2 + 5 * k[1] * t2 * t2 + 7 * k[2] * t2 ** 3 + 9 * k[3] * t2 ** 4
        n2 = r2 + z * z
        dth_dx = x * z / (n2 * r)
        dth_dy = y * z / (n2 * r)
        dth_dz = -r / n2
        f = td / r
        dfx_dx = self.fx * (dtd_dth * dth_dx * x / r + f * (1 - x * x / r2))
        dfx_dy = self.fx * (dtd_dth * dth_dy * x / r - f * x * y / r2)
        dfx_dz = self.fx * (dtd_dth * dth_dz * x / r)
        dfy_dx = self.fy * (dtd_dth * dth_dx * y / r - f * x * y / r2)
        dfy_dy = self.fy * (dtd_dth * dth_dy * y / r + f * (1 - y * y / r2))
        dfy_dz = self.fy * (dtd_dth * dth_dz * y / r)
        jac = np.stack(
            [
                np.stack([dfx_dx, dfx_dy, dfx_dz], axis=-1),
                np.stack([dfy_dx, dfy_dy, dfy_dz], axis=-1),
            ],
            axis=-2,
        )
        return jac

    def triangulate_matches(
        self,
        other: "KannalaBrandt8",
        kp1: np.ndarray,
        kp2: np.ndarray,
        sigma1: np.ndarray,
        sigma2: np.ndarray,
        T12: SE3,
        cos_parallax_max: float = 0.9998,
        unc: float = 5.991,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Fisheye-stereo triangulation with parallax + reprojection gating.

        Returns (p3d1 (N, 3) in cam-1 frame, depth z (N,); z <= 0 marks
        rejects) — KannalaBrandt8::TriangulateMatches semantics.
        """
        from orbslam3_tpu_torch.optim.triangulate import triangulate_linear

        r1 = self.unproject(kp1)
        r2 = other.unproject(kp2)
        r1 = r1 / np.linalg.norm(r1, axis=-1, keepdims=True)
        r2 = r2 / np.linalg.norm(r2, axis=-1, keepdims=True)
        # parallax between rays in a common frame
        r2_in1 = r2 @ T12.R.T
        cos_par = np.sum(r1 * r2_in1, axis=-1)
        ok = cos_par < cos_parallax_max

        T21 = T12.inverse()
        p1 = SE3()  # identity
        p3d = triangulate_linear(kp_bearing1=self.unproject(kp1), kp_bearing2=other.unproject(kp2), T1=p1, T2=T21)
        z1 = p3d[..., 2]
        p3d2 = T21.apply(p3d)
        z2 = p3d2[..., 2]
        ok &= (z1 > 0) & (z2 > 0)
        e1 = self.project(p3d) - kp1
        e2 = other.project(p3d2) - kp2
        ok &= np.sum(e1 * e1, axis=-1) < unc * sigma1
        ok &= np.sum(e2 * e2, axis=-1) < unc * sigma2
        z = np.where(ok, z1, -1.0)
        return p3d, z
