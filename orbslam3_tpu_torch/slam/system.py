"""The port's `System`: the reference host back-end over the torch front-end.

Subclasses ``orbslam3_tpu.slam.system.System``, whose Atlas, Tracking,
LocalMapping and trajectory savers hold no JAX, and replaces the seams
where the reference reaches its device front-end: stereo extraction,
`track_stereo` (whose trace ranges import JAX in the reference), the
prefetch pair, and `track_monocular` / `track_rgbd` (whose bodies import
JAX in the reference).  Entry points whose front-end is not ported yet
raise `NotImplementedError` naming their ROADMAP item instead of falling
into JAX code.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu.slam.frame import Frame
from orbslam3_tpu.slam.system import System as _ReferenceSystem
from orbslam3_tpu.slam.tracking import TrackingState
from orbslam3_tpu_torch._device import resolve_device
from orbslam3_tpu_torch.frontend.stereo_frame import front_end, unpack_host_features
from orbslam3_tpu_torch.ops.extractor import FusedKernels, feature_extractor, pack_features
from orbslam3_tpu_torch.utils.benchmark import Benchmark, trace_range

# Benchmark tags of the front-end's stream window per frame, one per entry
# point: CUDA events recorded before and after it on the stream.  The
# window holds the gaps while the host dispatches ops, so it reads host
# dispatch plus device work, not device-busy time (which only a profiler
# shows).
FRONT_END_STREAM_TAG = "1.1_GrabImageStereo.extract.stream"
MONO_STREAM_TAG = "1.1_GrabImageMonocular.extract.stream"
RGBD_STREAM_TAG = "1.1_GrabImageRGBD.extract.stream"


class System(_ReferenceSystem):
    """Pinhole SLAM (stereo, mono, RGB-D and their IMU variants) with the
    front-end on an explicit torch device.

    `device` defaults to "cuda" and raises when no GPU is present; pass
    "cpu" to run the plain PyTorch versions of the kernels.  `fused` picks
    the front-end's kernels for every entry point (`FusedKernels`, the
    reference's three ORBSLAM3_TPU_PALLAS_* switches; all off by
    default)."""

    def __init__(
        self, *args, device: str | torch.device = "cuda",
        fused: FusedKernels = FusedKernels(), **kwargs,
    ):
        self.device = resolve_device(device)
        self.fused = FusedKernels(*fused)
        super().__init__(*args, **kwargs)
        self._side_stream = None

    def _front_end(self, hw: tuple):
        return front_end(
            self.orb_params, tuple(hw), float(self.mbf), float(self.camera.fx),
            str(self.device), self.fused,
        )

    def _pair(self, img_l: np.ndarray, img_r: np.ndarray) -> torch.Tensor:
        pair = torch.from_numpy(np.ascontiguousarray(np.stack([img_l, img_r])))
        return pair.to(self.device, non_blocking=True)

    def _on_device(self, tag: str, run) -> dict:
        """run() -> a (K, 40) packed block on `self.device`; returns the
        compacted numpy feature arrays, recording the stream window of
        run() and the copy to the host under `tag` on CUDA."""
        if self.device.type != "cuda":
            return unpack_host_features(run().numpy())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        packed = run()
        end.record()
        host = packed.cpu().numpy()  # waits for the front-end
        end.synchronize()
        Benchmark.the().push_sample(tag, start.elapsed_time(end))
        return unpack_host_features(host)

    def _extract_stereo(self, img_l: np.ndarray, img_r: np.ndarray):
        """Front-end on `self.device` -> compacted numpy feature arrays."""
        fe = self._front_end(img_l.shape)
        return self._on_device(FRONT_END_STREAM_TAG, lambda: fe(self._pair(img_l, img_r)))

    def _extract_mono(self, img: np.ndarray, params, tag: str):
        """One-camera extraction on `self.device` (the reference's
        `extract_features_jit`) -> compacted numpy feature arrays."""
        fe = feature_extractor(params, tuple(img.shape), self.fused, str(self.device))

        def run():
            image = torch.from_numpy(np.ascontiguousarray(img)).to(self.device, non_blocking=True)
            return pack_features(fe(image))

        return self._on_device(tag, run)

    def track_stereo(
        self,
        img_l: np.ndarray,
        img_r: np.ndarray,
        timestamp: float,
        imu: tuple | None = None,
    ):
        """System::TrackStereo: preprocess, front-end on the device, track."""
        if self.lapping1 is not None:
            raise NotImplementedError(
                "stereo fisheye (lapping areas) is not ported yet: ROADMAP A10"
            )
        with trace_range("1.0_GrabImageStereo.preprocess", self.device):
            img_l, img_r = self._preprocess_stereo(img_l, img_r)
        with trace_range("1.1_GrabImageStereo.extract", self.device):
            feats = self._extract_stereo(img_l, img_r)
        bounds = (0, 0, img_l.shape[1], img_l.shape[0])
        with trace_range("2_Track", self.device):
            pose = self.track_stereo_features(feats, timestamp, bounds, imu=imu)
        if self.viewer is not None:
            self.viewer.update(img_l)
        return pose

    def prefetch_stereo(self, img_l: np.ndarray, img_r: np.ndarray):
        """Start the front-end for a FUTURE frame without blocking; returns
        a handle for `track_stereo_prefetched`.  On CUDA the work and the
        copy of the (K, 40) block into a pinned host buffer run on a side
        stream, so the host can track the previous frame meanwhile."""
        if self.lapping1 is not None:
            raise NotImplementedError(
                "stereo fisheye (lapping areas) is not ported yet: ROADMAP A10"
            )
        img_l, img_r = self._preprocess_stereo(img_l, img_r)
        fe = self._front_end(img_l.shape)
        if self.device.type != "cuda":
            return (fe(self._pair(img_l, img_r)).numpy(), None, None, img_l.shape)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        stream = self._side_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            packed = fe(self._pair(img_l, img_r))
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        # `packed` rides in the handle so its memory outlives the copy
        return (host, done, packed, img_l.shape)

    def track_stereo_prefetched(self, handle, timestamp: float, imu: tuple | None = None):
        """Consume a `prefetch_stereo` handle and run the tracker."""
        host, done, _packed, shape = handle
        if done is not None:
            done.synchronize()
            host = host.numpy()
        feats = unpack_host_features(host)
        return self.track_stereo_features(feats, timestamp, (0, 0, shape[1], shape[0]), imu=imu)

    def prefetch_stereo_batch(self, pairs: list):
        raise NotImplementedError(
            "batched prefetch is not ported yet: ROADMAP queue A, prefetch_stereo_batch"
        )

    def track_rgbd(
        self,
        img: np.ndarray,
        depth_map: np.ndarray,
        timestamp: float,
        imu: tuple | None = None,
    ):
        """System::TrackRGBD: one-camera extraction on the device, then the
        reference's host code line for line — per-keypoint depth sampled
        from the depth image (nearest-resampled when resizing, divided by
        `depth_map_factor`) and u_right = u_undistorted - mbf / z."""
        if self.resize_to is not None:
            img = self._resize(img, self.resize_to)
            # depth is resampled nearest (interpolating across depth
            # discontinuities invents structure)
            h, w = depth_map.shape[:2]
            xi = np.clip(
                (np.arange(self.resize_to[0]) * w) // self.resize_to[0], 0, w - 1
            )
            yi = np.clip(
                (np.arange(self.resize_to[1]) * h) // self.resize_to[1], 0, h - 1
            )
            depth_map = depth_map[np.ix_(yi, xi)]
        feats = self._extract_mono(img, self.orb_params, RGBD_STREAM_TAG)
        kps = feats["kps"]
        factor = getattr(self, "depth_map_factor", 1.0)
        dm = np.asarray(depth_map, np.float64)
        if factor != 1.0:
            dm = dm / factor
        h, w = dm.shape[:2]
        ui = np.clip(np.round(kps[:, 0]).astype(np.int64), 0, w - 1)
        vi = np.clip(np.round(kps[:, 1]).astype(np.int64), 0, h - 1)
        z = dm[vi, ui]
        kps_un = (
            self.camera.undistort_points(kps)
            if hasattr(self.camera, "undistort_points")
            else kps
        )
        valid_z = z > 0
        u_right = np.where(
            valid_z, kps_un[:, 0] - self.mbf / np.maximum(z, 1e-9), -1.0
        )
        depth = np.where(valid_z, z, -1.0)
        frame = Frame(
            kps=kps,
            octave=feats["octave"],
            angle=feats["angle"],
            response=feats["response"],
            desc=feats["desc"],
            camera=self.camera,
            scale_factors=self.scale_factors,
            timestamp=timestamp,
            u_right=u_right,
            depth=depth,
            mbf=self.mbf,
        )
        frame.set_image_bounds(0, 0, img.shape[1], img.shape[0])
        if self.vocabulary is not None:
            frame.bow_vec, frame.feat_vec = self.vocabulary.transform(frame.desc)
        else:
            frame.feat_vec = None
        if imu is not None:
            frame.imu_preint = self._preintegrate(imu)
        with trace_range("2_Track", self.device):
            pose = self.tracker.track_frame(frame)
        if self.viewer is not None:
            self.viewer.update(img)
        return pose

    def track_monocular(
        self, img: np.ndarray, timestamp: float, imu: tuple | None = None
    ):
        """System::TrackMonocular: one-camera extraction on the device with
        the reference's 5x-feature init extractor while uninitialised (and,
        for pure mono, for max_frames after init), then the reference's
        host code line for line."""
        if self.resize_to is not None:
            img = self._resize(img, self.resize_to)
        # 5x-feature init extractor while uninitialized; pure mono keeps it
        # for max_frames after init (Tracking2.cc:413, mpIniORBextractor)
        params = self.orb_params
        if self.ini_orb_params is not None:
            if self.tracker.state in (
                TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED
            ):
                params = self.ini_orb_params
                self._mono_frames_since_init = 0
            elif self.sensor == self.MONOCULAR:
                self._mono_frames_since_init += 1
                if self._mono_frames_since_init < self.tracker.max_frames:
                    params = self.ini_orb_params
        feats = self._extract_mono(img, params, MONO_STREAM_TAG)
        frame = Frame(
            kps=feats["kps"],
            octave=feats["octave"],
            angle=feats["angle"],
            response=feats["response"],
            desc=feats["desc"],
            camera=self.camera,
            scale_factors=self.scale_factors,
            timestamp=timestamp,
            mbf=0.0,
        )
        frame.set_image_bounds(0, 0, img.shape[1], img.shape[0])
        if self.vocabulary is not None:
            frame.bow_vec, frame.feat_vec = self.vocabulary.transform(frame.desc)
        else:
            frame.feat_vec = None
        if imu is not None:
            frame.imu_preint = self._preintegrate(imu)
        pose = self.tracker.track_frame(frame)
        if self.viewer is not None:
            self.viewer.update(img)
        return pose
