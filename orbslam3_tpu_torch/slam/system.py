"""The port's `System`: the reference host back-end over the torch front-end.

Subclasses ``orbslam3_tpu.slam.system.System``, whose Atlas, Tracking,
LocalMapping and trajectory savers hold no JAX, and replaces the seams
where the reference reaches its device front-end: stereo extraction,
`track_stereo` (whose trace ranges import JAX in the reference) and the
prefetch pair.  Entry points whose front-end is not ported yet raise
`NotImplementedError` naming their ROADMAP item instead of falling into
JAX code.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu.slam.system import System as _ReferenceSystem
from orbslam3_tpu_torch._device import resolve_device
from orbslam3_tpu_torch.frontend.stereo_frame import front_end, unpack_host_features
from orbslam3_tpu_torch.utils.benchmark import Benchmark, trace_range

# Benchmark tag of the front-end's stream window per frame: CUDA events
# recorded before and after it on the stream.  The window holds the gaps
# while the host dispatches ops, so it reads host dispatch plus device
# work, not device-busy time (which only a profiler shows).
FRONT_END_STREAM_TAG = "1.1_GrabImageStereo.extract.stream"


class System(_ReferenceSystem):
    """Stereo pinhole SLAM with the front-end on an explicit torch device.

    `device` defaults to "cuda" and raises when no GPU is present; pass
    "cpu" to run the plain PyTorch versions of the kernels."""

    def __init__(self, *args, device: str | torch.device = "cuda", **kwargs):
        self.device = resolve_device(device)
        super().__init__(*args, **kwargs)
        self._side_stream = None

    def _front_end(self, hw: tuple):
        return front_end(
            self.orb_params, tuple(hw), float(self.mbf), float(self.camera.fx), str(self.device)
        )

    def _pair(self, img_l: np.ndarray, img_r: np.ndarray) -> torch.Tensor:
        pair = torch.from_numpy(np.ascontiguousarray(np.stack([img_l, img_r])))
        return pair.to(self.device, non_blocking=True)

    def _extract_stereo(self, img_l: np.ndarray, img_r: np.ndarray):
        """Front-end on `self.device` -> compacted numpy feature arrays."""
        fe = self._front_end(img_l.shape)
        if self.device.type != "cuda":
            return unpack_host_features(fe(self._pair(img_l, img_r)).numpy())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        packed = fe(self._pair(img_l, img_r))
        end.record()
        host = packed.cpu().numpy()  # waits for the front-end
        end.synchronize()
        Benchmark.the().push_sample(FRONT_END_STREAM_TAG, start.elapsed_time(end))
        return unpack_host_features(host)

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

    def track_monocular(self, img, timestamp, imu=None):
        raise NotImplementedError("monocular front-end is not ported yet: ROADMAP A10")

    def track_rgbd(self, img, depth_map, timestamp, imu=None):
        raise NotImplementedError("RGB-D front-end is not ported yet: ROADMAP A10")
