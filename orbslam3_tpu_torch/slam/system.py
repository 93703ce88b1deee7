"""System facade: lifecycle, per-frame entry points, trajectory output.

Role-parity with ORB_SLAM3/include/System.h + src/System.cc
(TrackStereo :246, SaveTrajectoryTUM :544, SaveTrajectoryKITTI,
Shutdown :490): owns the Atlas, the device front-end, Tracking and
LocalMapping (sequential by default for determinism; threaded mode runs
LocalMapping on a worker like the reference's std::thread spawn at
System.cc:197).

The front-end runs on an explicit torch `device` ("cuda" by default,
raising when no GPU is present; "cpu" runs the kernels' plain versions),
with the kernels `fused` picks (`FusedKernels`).  On CUDA each frame's
front-end is one dispatch, as the reference's one `jax.jit` call a frame:
the replay of a CUDA graph of its geometry and configuration
(`StereoFrontEnd.forward` / `.pair_block`, `FeatureExtractor.packed`),
captured at the first frame; a batched prefetch replays the per-frame
graph once a row.  The upload of the images and the copy of the packed
block to the host stay outside the graph.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from orbslam3_tpu_torch._device import resolve_device
from orbslam3_tpu_torch.frontend import fisheye
from orbslam3_tpu_torch.frontend.stereo_frame import front_end, unpack_host_features
from orbslam3_tpu_torch.ops.extractor import FusedKernels, feature_extractor
from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams, resize_linear_u8
from orbslam3_tpu_torch.slam.frame import Frame
from orbslam3_tpu_torch.slam.local_mapping import LocalMapping
from orbslam3_tpu_torch.slam.map import Atlas
from orbslam3_tpu_torch.slam.tracking import Tracking, TrackingState
from orbslam3_tpu_torch.utils.benchmark import Benchmark, clock_ns, trace_range
from orbslam3_tpu_torch.utils.lie import SE3

# Benchmark tags of the front-end's stream window per frame, one per entry
# point: CUDA events recorded before and after it on the stream.  The
# window holds the gaps while the host dispatches ops, so it reads host
# dispatch plus device work, not device-busy time (which only a profiler
# shows).
FRONT_END_STREAM_TAG = "1.1_GrabImageStereo.extract.stream"
MONO_STREAM_TAG = "1.1_GrabImageMonocular.extract.stream"
RGBD_STREAM_TAG = "1.1_GrabImageRGBD.extract.stream"
# the batched prefetch's stream window divided by its B frames
BATCH_STREAM_TAG = "1.1_GrabImageStereo.extract_batch.stream"
# the fisheye stereo front-end's extra Frame fields (None on the pinhole path)
FISHEYE_FIELDS = ("n_left", "camera2", "Tlr", "left_to_right", "right_to_left", "stereo_p3d")


class _SharedBatchFetch:
    """One (B, K, 40) batch result shared by B frame handles
    (prefetch_stereo_batch).  On CUDA `out` is a pinned host tensor that a
    side-stream copy fills and `done` the event recorded after it, with
    `keep` (the device block) held until then; the first consumer waits on
    the event, the rest read the cached host array."""

    __slots__ = ("out", "done", "keep", "window", "_host")

    def __init__(self, out: torch.Tensor, done=None, keep=None, window=None):
        self.out = out
        self.done = done
        self.keep = keep
        # (start event, B, host time the event was queued) of the batch's
        # stream window
        self.window = window
        self._host = None

    def host(self) -> np.ndarray:
        if self._host is None:
            if self.done is not None:
                self.done.synchronize()
                start, n, queued = self.window
                Benchmark.the().push_sample(BATCH_STREAM_TAG, start.elapsed_time(self.done) / n,
                                            start_ns=queued)
            self._host = self.out.numpy()
            self.out = self.done = self.keep = self.window = None
        return self._host


class _BatchRow:
    """np.asarray-able view of one frame's row in a _SharedBatchFetch —
    duck-types the per-frame device array that track_stereo_prefetched
    consumes."""

    __slots__ = ("fetch", "i")

    def __init__(self, fetch: _SharedBatchFetch, i: int):
        self.fetch = fetch
        self.i = i

    def __array__(self, dtype=None, copy=None):
        a = self.fetch.host()[self.i]
        return a.astype(dtype) if dtype is not None else a


class System:
    STEREO = "stereo"
    MONOCULAR = "mono"
    RGBD = "rgbd"
    IMU_STEREO = "stereo_inertial"
    IMU_MONOCULAR = "mono_inertial"
    IMU_RGBD = "rgbd_inertial"

    def __init__(
        self,
        camera,
        mbf: float,
        orb_params: PyramidParams = PyramidParams(),
        sensor: str = STEREO,
        sequential: bool = True,
        use_device: bool = True,
        max_frames: int = 30,
        vocabulary=None,
        imu_calib=None,
        camera2=None,
        Tlr=None,
        lapping1: tuple | None = None,
        lapping2: tuple | None = None,
        rectifier=None,
        resize_to: tuple | None = None,
        *,
        device: str | torch.device = "cuda",
        fused: FusedKernels = FusedKernels(),
    ):
        self.device = resolve_device(device)
        self.fused = FusedKernels(*fused)
        self._side_stream = None
        # input preprocessing (reference System::TrackStereo remap/resize,
        # src/System.cc:253-263): rectifier remaps raw unrectified stereo
        # pairs into the common pinhole frame before extraction; resize_to
        # downscales inputs when Camera.newWidth/newHeight ask for it
        self.rectifier = rectifier
        self.resize_to = resize_to
        # fisheye stereo configuration (KannalaBrandt8 + lapping areas):
        # stereo depth comes from kNN matching in the overlap + KB8
        # triangulation instead of the rectified row matcher
        self.camera2 = camera2
        self.Tlr = Tlr
        self.lapping1 = lapping1
        self.lapping2 = lapping2
        self.camera = camera
        self.mbf = mbf
        self.orb_params = orb_params
        # Monocular initialization extracts 5x the features (the reference's
        # mpIniORBextractor, Tracking1.cc:601 / Tracking2.cc:413-416): the
        # two-view init needs a dense match set, and pure mono keeps the
        # dense extractor for max_frames after init.
        self.ini_orb_params = (
            dataclasses.replace(
                orb_params, n_features=5 * orb_params.n_features
            )
            if "mono" in sensor
            else None
        )
        self._mono_frames_since_init = 0
        self.sensor = sensor
        self.use_device = use_device
        self.vocabulary = vocabulary
        self.imu_calib = imu_calib
        self.atlas = Atlas()
        self.atlas.add_camera(camera)
        self.local_mapper = LocalMapping(
            self.atlas, monocular=("mono" in sensor), sequential=sequential,
            imu_calib=imu_calib,
        )
        self.kf_database = None
        self.loop_closer = None
        relocalizer = None
        if vocabulary is not None:
            from orbslam3_tpu_torch.vocab.keyframe_database import KeyFrameDatabase
            from orbslam3_tpu_torch.slam.relocalization import Relocalizer
            from orbslam3_tpu_torch.slam.loop_closing import LoopClosing

            self.kf_database = KeyFrameDatabase(vocabulary)
            self.local_mapper.kf_database = self.kf_database
            relocalizer = Relocalizer(self.kf_database)
            self.loop_closer = LoopClosing(
                self.atlas, self.kf_database,
                fix_scale=(sensor != self.MONOCULAR),
                imu_calib=imu_calib,
            )
            self.local_mapper.loop_closer = self.loop_closer
            self.loop_closer.local_mapper = self.local_mapper
        self.tracker = Tracking(
            self.atlas,
            self.local_mapper,
            camera,
            mbf,
            max_frames=max_frames,
            relocalizer=relocalizer,
            imu_calib=imu_calib,
            device=self.device,
        )
        self.local_mapper.tracker = self.tracker
        self.viewer = None  # optional Viewer (caller-polled or worker)
        self._mapper_thread = None
        self._loop_thread = None
        if not sequential:
            self._mapper_thread = threading.Thread(
                target=self.local_mapper.spin, daemon=True
            )
            self._mapper_thread.start()
            if self.loop_closer is not None:
                # reference spawns LoopClosing on its own thread
                # (System.cc:214); KFs flow mapper -> loop queue
                self.loop_closer.sequential = False
                self._loop_thread = threading.Thread(
                    target=self.loop_closer.spin, daemon=True
                )
                self._loop_thread.start()
        self.scale_factors = orb_params.scale_factors

    # ------------------------------------------------------------------
    def _preprocess_stereo(self, img_l: np.ndarray, img_r: np.ndarray):
        """Rectify (unrectified pinhole stereo, on `self.device`) or resize
        raw inputs before extraction — System::TrackStereo,
        src/System.cc:253-263."""
        if self.rectifier is not None:
            return self.rectifier.rectify(img_l, img_r, self.device)
        if self.resize_to is not None:
            img_l = self._resize(img_l, self.resize_to)
            img_r = self._resize(img_r, self.resize_to)
        return img_l, img_r

    @staticmethod
    def _resize(img: np.ndarray, size: tuple) -> np.ndarray:
        """cv2.resize(img, size, INTER_LINEAR), bit for bit, in numpy."""
        w, h = size
        return resize_linear_u8(img, h, w)

    def _front_end(self, hw: tuple):
        return front_end(
            self.orb_params, tuple(hw), float(self.mbf), float(self.camera.fx),
            str(self.device), self.fused,
        )

    def _pair(self, img_l, img_r) -> torch.Tensor:
        """(2, H, W) uint8 on `self.device` from two numpy images, or from
        the two tensors the rectifier left there."""
        if isinstance(img_l, torch.Tensor):
            if self.device.type == "cuda":
                # made on the stream that was current then; this one may be
                # the side stream, so their memory must outlive its reads
                stream = torch.cuda.current_stream(self.device)
                img_l.record_stream(stream)
                img_r.record_stream(stream)
            return torch.stack([img_l, img_r])
        pair = torch.from_numpy(np.ascontiguousarray(np.stack([img_l, img_r])))
        return pair.to(self.device, non_blocking=True)

    def _on_device(self, tag: str, run, unpack=None):
        """run() -> a packed block on `self.device`; returns unpack() of it
        on the host (by default `unpack_host_features`: the compacted numpy
        feature arrays), recording the stream window of run() and the copy
        to the host under `tag` on CUDA."""
        unpack = unpack or unpack_host_features
        if self.device.type != "cuda":
            return unpack(run().numpy())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        queued = clock_ns()
        start.record()
        packed = run()
        end.record()
        host = packed.cpu().numpy()  # waits for the front-end
        end.synchronize()
        Benchmark.the().push_sample(tag, start.elapsed_time(end), start_ns=queued)
        return unpack(host)

    def _extract_stereo(self, img_l: np.ndarray, img_r: np.ndarray):
        """Front-end on `self.device` (on CUDA one graph replay) ->
        compacted numpy feature arrays."""
        fe = self._front_end(img_l.shape)
        return self._on_device(FRONT_END_STREAM_TAG, lambda: fe(self._pair(img_l, img_r)))

    def _extract_mono(self, img: np.ndarray, params, tag: str):
        """One-camera extraction on `self.device` (the reference's
        `extract_features_jit`; on CUDA one graph replay of the extractor
        of `params`) -> compacted numpy feature arrays."""
        fe = feature_extractor(params, tuple(img.shape), self.fused, str(self.device))

        def run():
            image = torch.from_numpy(np.ascontiguousarray(img)).to(self.device, non_blocking=True)
            return fe.packed(image)

        return self._on_device(tag, run)

    def _extract_stereo_fisheye(self, img_l: np.ndarray, img_r: np.ndarray):
        """Fisheye stereo front-end (Frame fisheye ctor role,
        ORB_SLAM3/src/Frame.cc:1089-1191): per-camera extraction on
        `self.device` with lapping split, kNN overlap matching, KB8
        triangulation -> depths."""
        fe = self._front_end(img_l.shape)
        fl, fr = self._on_device(
            FRONT_END_STREAM_TAG,
            lambda: fe.pair_block(self._pair(img_l, img_r)),
            lambda host: fisheye.split_pair_block(host, self.lapping1, self.lapping2),
        )
        level_sigma2 = np.asarray(self.scale_factors, np.float64) ** 2
        tlr = self.Tlr if self.Tlr is not None else SE3()
        depth_l, l2r, r2l, p3d_l = fisheye.compute_stereo_fisheye_matches(
            fl, fr, self.camera, self.camera2 or self.camera,
            tlr, level_sigma2,
        )
        # Concatenated Nleft/Nright frame layout (reference fisheye Frame
        # ctor, src/Frame.cc:1089-1135): left block then right block; right
        # keypoints are first-class observation slots.
        n_l, n_r = len(fl["kps"]), len(fr["kps"])
        return dict(
            kps=np.concatenate([fl["kps"], fr["kps"]]),
            octave=np.concatenate([fl["octave"], fr["octave"]]),
            angle=np.concatenate([fl["angle"], fr["angle"]]),
            response=np.concatenate([fl["response"], fr["response"]]),
            desc=np.concatenate([fl["desc"], fr["desc"]]),
            u_right=np.full(n_l + n_r, -1.0),
            depth=np.concatenate([depth_l, np.full(n_r, -1.0)]),
            n_left=n_l,
            camera2=self.camera2 or self.camera,
            Tlr=tlr,
            left_to_right=l2r,
            right_to_left=r2l,
            stereo_p3d=p3d_l,
        )

    def track_stereo(
        self,
        img_l: np.ndarray,
        img_r: np.ndarray,
        timestamp: float,
        imu: tuple | None = None,
    ):
        """imu: optional (acc (N,3), gyro (N,3), dts (N,)) samples covering
        the interval since the previous frame (System::TrackStereo's vImuMeas
        role); preintegrated and attached for IMU prediction/dead-reckoning."""
        with trace_range("System.track_stereo", self.device, frame=Frame._next_id):
            with trace_range("1.0_GrabImageStereo.preprocess", self.device):
                img_l, img_r = self._preprocess_stereo(img_l, img_r)
            with trace_range("1.1_GrabImageStereo.extract", self.device):
                if self.lapping1 is not None:
                    feats = self._extract_stereo_fisheye(img_l, img_r)
                else:
                    feats = self._extract_stereo(img_l, img_r)
            frame = self._frame(
                feats, timestamp, (0, 0, img_l.shape[1], img_l.shape[0]), imu,
                u_right=feats["u_right"], depth=feats["depth"], mbf=self.mbf,
                **{k: feats.get(k) for k in FISHEYE_FIELDS},
            )
            pose = self.tracker.track_frame(frame)
            if self.viewer is not None:
                self.viewer.update(
                    np.asarray(img_l.cpu()) if isinstance(img_l, torch.Tensor) else img_l)
        return pose

    def _frame(self, feats: dict, timestamp: float, bounds, imu, **fields) -> Frame:
        """Every entry point's frame assembly: the tracker's Frame of the
        compacted features (`fields`: what the sensor adds, as Frame takes
        it), its image bounds (x0, y0, x1, y1), its bag-of-words vectors and
        its IMU preintegration."""
        with trace_range("1.2_Frame", self.device, frame=Frame._next_id):
            frame = Frame(
                kps=feats["kps"],
                octave=feats["octave"],
                angle=feats["angle"],
                response=feats["response"],
                desc=feats["desc"],
                camera=self.camera,
                scale_factors=self.scale_factors,
                timestamp=timestamp,
                **fields,
            )
            frame.set_image_bounds(*bounds)
            if self.vocabulary is not None:
                with trace_range("1.2.1_BoW", self.device):
                    frame.bow_vec, frame.feat_vec = self.vocabulary.transform(frame.desc)
            else:
                frame.feat_vec = None
            if imu is not None:
                frame.imu_preint = self._preintegrate(imu)
        return frame

    # --- frame pipelining (the reference's intended async design,
    # src/ORBExtractorCUDA.cc:691-744: extraction of frame N+1 runs on the
    # card on a side stream while the host tracks frame N) ----------------
    def prefetch_stereo(self, img_l: np.ndarray, img_r: np.ndarray):
        """Start the front-end for a FUTURE frame without blocking; returns
        a handle for `track_stereo_prefetched`.  On CUDA the work and the
        copy of the (K, 40) block into a pinned host buffer run on a side
        stream, so the host can track the previous frame meanwhile.  As in
        the reference, this is the pinhole program whatever the camera:
        not meaningful for the fisheye path (host-side kNN matching)."""
        img_l, img_r = self._preprocess_stereo(img_l, img_r)
        fe = self._front_end(img_l.shape)
        if self.device.type != "cuda":
            return (fe(self._pair(img_l, img_r)).numpy(), None, None, img_l.shape)
        with self._on_side_stream():
            packed = fe(self._pair(img_l, img_r))
            host, done = self._to_pinned(packed)
        # `packed` rides in the handle so its memory outlives the copy
        return (host, done, packed, img_l.shape)

    def _on_side_stream(self):
        """The side stream as the current stream, ordered after the work
        queued so far on the current one."""
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        self._side_stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._side_stream)

    @staticmethod
    def _to_pinned(packed: torch.Tensor):
        """(pinned host tensor, event): the copy of `packed` queued on the
        current stream and the event recorded after it."""
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        return host, done

    def prefetch_stereo_batch(self, pairs: list):
        """Batched prefetch: start the front-end for B future frames as one
        batch program (`StereoFrontEnd.batch`, the frames one after the
        other into one (B, K, 40) block, on CUDA one replay of the
        per-frame graph a row) and return one handle per frame, each
        consumable by track_stereo_prefetched in order.

        On CUDA the program and one copy of the block into pinned host
        memory run on the side stream, with one event after the copy; the
        first handle consumed waits on it.  On the CPU the same program
        runs synchronously.  The throughput mode for mapping-rate /
        multi-robot workloads.  `pairs` is a list of (img_l, img_r)."""
        if not pairs:
            raise ValueError("prefetch_stereo_batch needs at least one (img_l, img_r) pair")
        pre = [self._preprocess_stereo(il, ir) for il, ir in pairs]
        shape = pre[0][0].shape
        fe = self._front_end(shape)
        if self.device.type != "cuda":
            fetch = _SharedBatchFetch(fe.batch(torch.stack([self._pair(*p) for p in pre])))
        else:
            with self._on_side_stream():
                start = torch.cuda.Event(enable_timing=True)
                queued = clock_ns()
                start.record()
                packed = fe.batch(torch.stack([self._pair(*p) for p in pre]))
                host, done = self._to_pinned(packed)
            fetch = _SharedBatchFetch(host, done, packed, (start, len(pre), queued))
        return [(_BatchRow(fetch, i), None, None, p[0].shape) for i, p in enumerate(pre)]

    def track_stereo_prefetched(
        self, handle, timestamp: float, imu: tuple | None = None
    ):
        """Consume a prefetch_stereo handle (synchronizes on the device
        results, which by now overlapped with the previous frame's host
        tracking) and run the tracker.  Equivalent to track_stereo."""
        host, done, _packed, shape = handle
        if done is not None:
            done.synchronize()
            host = host.numpy()
        feats = unpack_host_features(np.asarray(host))
        return self.track_stereo_features(
            feats, timestamp, (0, 0, shape[1], shape[0]), imu=imu
        )

    def track_rgbd(
        self,
        img: np.ndarray,
        depth_map: np.ndarray,
        timestamp: float,
        imu: tuple | None = None,
    ):
        """RGB-D per-frame entry (System::TrackRGBD,
        ORB_SLAM3/include/System.h:115; Tracking::GrabImageRGBD +
        Frame::ComputeStereoFromRGBD): mono device extraction, per-keypoint
        depth sampled from the depth image, synthetic right-view coordinate
        u_right = u_undistorted - mbf/z.  Everything downstream reuses the
        stereo-depth map-point machinery unchanged.  `imu` enables the
        IMU_RGBD configuration.  depth_map: raw sensor units scaled by
        Settings' DepthMapFactor (self.depth_map_factor), or meters if 1.0."""
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
        frame = self._frame(feats, timestamp, (0, 0, img.shape[1], img.shape[0]), imu,
                            u_right=u_right, depth=depth, mbf=self.mbf)
        pose = self.tracker.track_frame(frame)
        if self.viewer is not None:
            self.viewer.update(img)
        return pose

    def _preintegrate(self, imu: tuple):
        """Per-frame preintegration with the tracker's current bias estimate
        (Tracking::PreintegrateIMU role)."""
        from orbslam3_tpu_torch.imu.preintegration import Calib, Preintegrated
        from orbslam3_tpu_torch.utils.lie import SE3 as _SE3

        calib = self.imu_calib or Calib(_SE3())
        pre = Preintegrated(self.tracker.current_bias(), calib)
        pre.integrate_batch(*imu)
        return pre

    def track_monocular(
        self, img: np.ndarray, timestamp: float, imu: tuple | None = None
    ):
        """Monocular per-frame entry (System::TrackMonocular role; `imu`
        mirrors the vImuMeas argument for the mono-inertial configuration)."""
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
        frame = self._frame(feats, timestamp, (0, 0, img.shape[1], img.shape[0]), imu, mbf=0.0)
        pose = self.tracker.track_frame(frame)
        if self.viewer is not None:
            self.viewer.update(img)
        return pose

    def track_stereo_features(self, feats: dict, timestamp: float, bounds,
                              imu: tuple | None = None):
        """Entry point when features come precomputed (batch device runs)."""
        frame = self._frame(feats, timestamp, bounds, imu, u_right=feats["u_right"],
                            depth=feats["depth"], mbf=self.mbf)
        return self.tracker.track_frame(frame)

    # ------------------------------------------------------------------
    @classmethod
    def from_files(
        cls,
        voc_file: str | None,
        settings_file: str,
        sensor: str = "stereo",
        use_viewer: bool = False,
        viewer_dir: str = "viewer_out",
        sequential: bool = True,
        *,
        device: str | torch.device = "cuda",
        fused: FusedKernels = FusedKernels(),
    ) -> "System":
        """Reference-ctor parity: System(vocFile, settingsFile, sensor,
        bUseViewer) (include/System.h:105).  Vocabulary files ending in
        .txt load the DBoW2 text format (ORBvoc.txt), .npz the native one.
        `device` and `fused` as in the constructor."""
        from orbslam3_tpu_torch.utils.settings import load_settings

        st = load_settings(settings_file, sensor)
        voc = None
        if voc_file:
            from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary

            if voc_file.endswith(".npz"):
                voc = BinaryVocabulary.load(voc_file)
            else:
                voc = BinaryVocabulary.load_orbvoc_text(voc_file)
        imu_calib = None
        if "imu" in sensor or "inertial" in sensor:
            from orbslam3_tpu_torch.imu.preintegration import Calib
            from orbslam3_tpu_torch.utils.lie import SE3 as _SE3

            tbc = _SE3.from_matrix(st.Tbc) if st.Tbc is not None else _SE3()
            imu_calib = Calib(
                Tbc=tbc,
                noise_gyro=st.imu_noise_gyro or 1.7e-4,
                noise_acc=st.imu_noise_acc or 2.0e-3,
                walk_gyro=st.imu_walk_gyro or 1.9e-5,
                walk_acc=st.imu_walk_acc or 3.0e-3,
            )
        fisheye_kwargs = {}
        if st.camera_type == "KannalaBrandt8" and st.lapping1 is not None:
            tlr = None
            if st.Tlr is not None:
                mat = np.asarray(st.Tlr, np.float64)
                if mat.shape == (3, 4):
                    mat = np.vstack([mat, [0.0, 0.0, 0.0, 1.0]])
                from orbslam3_tpu_torch.utils.lie import SE3 as _SE3

                tlr = _SE3.from_matrix(mat)
            fisheye_kwargs = dict(
                camera2=st.make_camera(2) if st.camera2 is not None else None,
                Tlr=tlr,
                lapping1=st.lapping1,
                lapping2=st.lapping2,
            )
        # input preprocessing: unrectified pinhole stereo -> precompute
        # rectification maps; the rectified pinhole replaces the raw
        # calibration and bf comes from P2 (Settings.cc:467-502).  Plain
        # resize scales the calibration instead (Settings.cc:346-375).
        rectifier = None
        resize_to = None
        camera = st.make_camera(1)
        mbf = st.bf
        if st.needs_rectify and st.dist1 is not None:
            rectifier = st.make_rectifier()
            camera = rectifier.camera
            mbf = rectifier.bf
            if imu_calib is not None:
                # camera-1 frame rotated by R1: Tbc follows
                # (Settings.cc:496-501  Tbc_ = Tbc_ * T_r1_u1.inverse())
                from orbslam3_tpu_torch.utils.lie import SE3 as _SE3

                t_r1_u1 = _SE3(rectifier.R1, np.zeros(3))
                imu_calib.Tbc = imu_calib.Tbc * t_r1_u1.inverse()
        elif st.needs_resize:
            resize_to = (st.new_width, st.new_height)
            from orbslam3_tpu_torch.cameras.models import Pinhole

            if st.camera_type in ("PinHole", "Rectified"):
                camera = Pinhole(st.scaled_camera_params()[:4], st.dist1)
            mbf = st.bf * (st.new_width / st.width)
        sysm = cls(
            camera=camera,
            mbf=mbf,
            orb_params=st.make_orb_params(),
            sensor=sensor,
            sequential=sequential,
            vocabulary=voc,
            max_frames=int(st.fps),
            imu_calib=imu_calib,
            rectifier=rectifier,
            resize_to=resize_to,
            **fisheye_kwargs,
            device=device,
            fused=fused,
        )
        sysm.settings = st
        sysm.depth_map_factor = st.depth_map_factor
        # apply deviation-knob overrides (Tuning.* YAML keys): restores the
        # reference's values for real-data runs if the defaults tuned on the
        # synthetic world underperform there
        if st.tuning:
            from orbslam3_tpu_torch.slam import matchers as _m

            _m.set_tuning(
                match_th=st.tuning.get("matchTh"),
                same_octave_first=st.tuning.get("sameOctaveFirst"),
            )
            if "monoInitMinMatches" in st.tuning:
                sysm.tracker.mono_init_min_matches = int(
                    st.tuning["monoInitMinMatches"]
                )
            if "voPointsInFinalVote" in st.tuning:
                sysm.tracker.vo_points_in_final_vote = bool(
                    st.tuning["voPointsInFinalVote"]
                )
        sysm.tracker.depth_th = (mbf / camera.fx) * st.depth_th_factor if mbf else 0
        if st.load_atlas:
            sysm.load_atlas(st.load_atlas)
        if use_viewer:
            from orbslam3_tpu_torch.utils.viewer import Viewer

            sysm.viewer = Viewer(sysm, viewer_dir)
            # worker render thread (reference spawns the Viewer thread in
            # the System ctor, src/System.cc:233)
            sysm.viewer.start()
        return sysm

    # --- control (System.h:125-135) ---------------------------------------
    def activate_localization_mode(self):
        """Tracking-only: stop inserting keyframes / growing the map
        (System::ActivateLocalizationMode -> mbOnlyTracking)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False

    def reset(self):
        """Full reset: fresh Atlas (System::Reset role).  In threaded mode
        the workers are drained first so no in-flight keyframe mutates the
        old Atlas while it is being swapped out."""
        from orbslam3_tpu_torch.slam.tracking import TrackingState

        self.local_mapper.request_stop()
        try:
            self.atlas = Atlas()
            self.atlas.add_camera(self.camera)
            self.local_mapper.atlas = self.atlas
            self.local_mapper.clear_queue()
            self.tracker.atlas = self.atlas
            self.tracker.state = TrackingState.NO_IMAGES_YET
            self.tracker.last_kf = None
            self.tracker.ref_kf = None
            self.tracker.velocity = None
            self.tracker.last_frame = None
            self.tracker.trajectory = []
            self.tracker._imu_meas_since_kf = []
            self.tracker._ini_frame = None
            if self.kf_database is not None:
                self.kf_database.clear()
            if self.loop_closer is not None:
                self.loop_closer.held.clear()  # keyframes of the old Atlas
        finally:
            self.local_mapper.resume()

    def reset_active_map(self):
        self.tracker._handle_lost()

    # --- persistence (System.cc:1348,1380) --------------------------------
    def save_atlas(self, path: str):
        from orbslam3_tpu_torch.utils.persistence import save_atlas

        save_atlas(path, self.atlas, self.vocabulary)

    def load_atlas(self, path: str):
        """Load a prior session's atlas and arm the tracker to CONTINUE in
        it (System::LoadAtlas contract, System.cc:157: load at startup,
        then SLAM — localize into / extend the loaded maps).

        If the loaded current map has keyframes, tracking resumes in
        RECENTLY_LOST: the next frame relocalizes into the loaded map and
        keeps mapping there; if relocalization keeps failing (unseen
        territory), the standard lost ladder forks a fresh map that
        LoopClosing can later merge back into the loaded one — the
        reference's CreateNewMap-after-load + MergeLocal path."""
        from orbslam3_tpu_torch.slam.tracking import TrackingState
        from orbslam3_tpu_torch.utils.persistence import load_atlas

        self.atlas = load_atlas(path, self.vocabulary, self.kf_database)
        self.local_mapper.atlas = self.atlas
        self.tracker.atlas = self.atlas
        if self.loop_closer is not None:
            self.loop_closer.atlas = self.atlas
        m = self.atlas.get_current_map()
        if m is not None and m.n_keyframes() > 0:
            t = self.tracker
            t.state = TrackingState.RECENTLY_LOST
            t.velocity = None
            t.last_frame = None
            t.last_kf = None
            t.frames_since_lost = 0
            t._imu_meas_since_kf = []

    def shutdown(self):
        """System::Shutdown role: ask LocalMapping, then LoopClosing, to
        finish, and wait until each has, with no time limit, as upstream
        waits on their isFinished: a thread still in a local BA, a loop
        correction or a merge when the caller goes on to read the map would
        hand it half-moved poses."""
        if self.viewer is not None:
            self.viewer.request_finish()
        self.local_mapper.request_finish()
        if self._mapper_thread is not None:
            self._mapper_thread.join()
        if self.loop_closer is not None:
            self.loop_closer.run_held()  # sequential mode: none is held between frames
            self.loop_closer.request_finish()
        if self._loop_thread is not None:
            self._loop_thread.join()
        if self.loop_closer is not None:
            # after the spin thread stops (no new spawns), let an in-flight
            # transient GBA write back before the atlas is persisted
            self.loop_closer.join_gba()
        st = getattr(self, "settings", None)
        if st is not None and st.save_atlas:
            self.save_atlas(st.save_atlas)
        self._shut_down = True

    def is_shutdown(self) -> bool:
        """System::isShutDown role (System.cc:538)."""
        return getattr(self, "_shut_down", False)

    def is_finished(self) -> bool:
        """System::isFinished role — the reference defines it as
        GetTimeFromIMUInit() > 0.1 (System.cc:1316); matched verbatim."""
        return self.get_time_from_imu_init() > 0.1

    def change_dataset(self):
        """System::ChangeDataset role (System.cc:1318-1327): a current map
        with <12 keyframes is reset in place, otherwise a fresh map is
        forked (CreateMapInAtlas) — either way the inertial temporal chain
        is cleared so no preintegration spans the dataset boundary, and the
        dataset counter bumps (mpTracker->NewDataset(), Tracking5.cc:488)."""
        self.tracker.n_dataset = getattr(self.tracker, "n_dataset", 0) + 1
        m = self.atlas.get_current_map()
        if m is None:
            return
        if m.n_keyframes() < 12:
            self.tracker._reset_active_map()
        else:
            self.tracker._fork_map()

    def get_image_scale(self) -> float:
        """System/Tracking::GetImageScale role (System.cc:1329): the
        resize factor applied to raw inputs, 1.0 when none configured."""
        st = getattr(self, "settings", None)
        if st is not None and st.needs_resize:
            return float(st.new_width) / float(st.width)
        return 1.0

    def insert_rect_time(self, ms: float):
        """System::InsertRectTime role (REGISTER_TIMES analog): record an
        externally-measured stereo-rectification duration."""
        Benchmark.the().push_sample("0.0_Stereo_Rectification", ms)

    def insert_resize_time(self, ms: float):
        Benchmark.the().push_sample("0.1_Image_Resize", ms)

    def insert_track_time(self, ms: float):
        Benchmark.the().push_sample("1.0_Track", ms)

    def get_tracking_state(self):
        return self.tracker.state

    def is_lost(self) -> bool:
        """System::isLost role."""
        from orbslam3_tpu_torch.slam.tracking import TrackingState

        return self.tracker.state in (
            TrackingState.LOST, TrackingState.RECENTLY_LOST
        )

    def get_time_from_imu_init(self) -> float:
        """Seconds of tracking since VI initialization of the active map
        (System::GetTimeFromIMUInit role); 0 when not initialized."""
        m = self.atlas.get_current_map()
        t0 = getattr(m, "imu_init_time", None)
        f = self.tracker.current
        if not getattr(m, "imu_initialized", False) or t0 is None or f is None:
            return 0.0
        return float(f.timestamp - t0)

    def map_changed(self) -> bool:
        """True once after every big map change — loop closure, merge, VI
        re-scale (System::MapChanged role, tracked via the map change
        index)."""
        m = self.atlas.get_current_map()
        cur = getattr(m, "change_idx", 0)
        last = getattr(self, "_last_change_index", 0)
        self._last_change_index = cur
        return cur > last

    def get_tracked_map_points(self):
        f = self.tracker.current
        if f is None:
            return []
        return [mp for mp, o in zip(f.map_points, f.outlier) if mp is not None and not o]

    def map_stats(self):
        m = self.atlas.get_current_map()
        return dict(n_keyframes=m.n_keyframes(), n_map_points=m.n_map_points())

    # --- trajectory output (System.cc:544+) ------------------------------
    def _biggest_map(self):
        """The no-arg reference savers target the map with the most
        keyframes (System.cc:644-655)."""
        maps = self.atlas.get_all_maps()
        if not maps:
            return None
        return max(maps, key=lambda mp: mp.n_keyframes())

    def _first_kf_anchor(self, body_frame: bool, m) -> SE3:
        """The reference's trajectory anchor: poses are expressed relative
        to the FIRST keyframe (lowest id) of the target map — Two =
        vpKFs[0]->GetPoseInverse() (System.cc SaveTrajectoryTUM, which
        spans ALL maps when `m` is None), or the first KF's body pose
        Twb0 = (Tbc * Tcw0)^-1 for the inertial EuRoC saver
        (System.cc:634+, per-map System.cc:758-767)."""
        if m is None:
            kfs = sorted(
                (
                    kf
                    for mp in self.atlas.get_all_maps()
                    for kf in mp.get_all_keyframes()
                ),
                key=lambda k: k.id,
            )
        else:
            kfs = sorted(m.get_all_keyframes(), key=lambda k: k.id)
        if not kfs:
            return SE3()
        tcw0 = kfs[0].Tcw
        if body_frame and self.imu_calib is not None:
            return (self.imu_calib.Tbc * tcw0).inverse()  # Twb0
        return tcw0.inverse()  # Two

    def frame_trajectory(
        self, body_frame: bool = False, map_filter=None
    ) -> list[tuple[float, SE3]]:
        """(timestamp, Twc) replaying relative poses against (possibly
        optimized) reference keyframes — SaveTrajectoryTUM semantics,
        anchored at the first keyframe like the reference
        (ORB_SLAM3/src/System.cc:544+: Trw = ... * Two).

        With `body_frame` (inertial configs), poses are IMU/body poses
        Twb = (Tbc * Tcr * Trw)^-1 against the first KF's body anchor —
        the reference's SaveTrajectoryEuRoC inertial branch
        (System.cc:634-745); EuRoC/TUM-VI ground truth lives in the body
        frame, so dataset ATE must compare in it."""
        body = body_frame and self.imu_calib is not None
        # map_filter semantics: None → TUM/KITTI savers (all maps, anchor
        # at the globally-first KF, System.cc:552-557); "biggest" → the
        # no-arg EuRoC saver's biggest-map target (System.cc:644-655); a
        # Map → the per-map overloads (System.cc:746).  When a target map
        # is set, frames whose surviving reference KF lives in another
        # map are skipped (System.cc:715-718)
        target = (
            self._biggest_map() if map_filter == "biggest" else map_filter
        )
        anchor = self._first_kf_anchor(body, target)
        tbc = self.imu_calib.Tbc if body else None
        out = []
        for fid, ts, tcr, ref, lost in self.tracker.trajectory:
            if lost or ref is None:
                continue
            # walk up through culled reference KFs composing the relative
            # poses stored at cull time (mTcp), exactly as the reference's
            # SaveTrajectoryTUM: Trw = Trw * mTcp ... * parent.Tcw
            # (ORB_SLAM3/src/System.cc:544+)
            kf = ref
            trw = SE3()
            while kf.bad and kf.parent is not None:
                trw = trw * getattr(kf, "Tcp", SE3())
                kf = kf.parent
            if target is not None and kf.map is not target:
                continue
            tcw = tcr * trw * kf.Tcw * anchor
            if body:
                out.append((ts, (tbc * tcw).inverse()))
            else:
                out.append((ts, tcw.inverse()))
        return out

    def save_trajectory_tum(self, path: str):
        from orbslam3_tpu_torch.utils.trajectory import save_tum

        save_tum(path, self.frame_trajectory())

    def save_trajectory_kitti(self, path: str):
        from orbslam3_tpu_torch.utils.trajectory import save_kitti

        save_kitti(path, self.frame_trajectory())

    def save_trajectory_euroc(self, path: str, map_=None):
        """SaveTrajectoryEuRoC role (System.cc:634; per-map overload
        System.cc:746 via `map_`): ns timestamps, and — for inertial
        configs — IMU/body poses against the first KF's body anchor
        (EuRoC/TUM-VI ground truth is in the body frame)."""
        from orbslam3_tpu_torch.utils.trajectory import save_euroc

        save_euroc(
            path,
            self.frame_trajectory(
                body_frame=self.imu_calib is not None,
                map_filter=map_ if map_ is not None else "biggest",
            ),
        )

    def save_debug_data(self, init_idx: int, out_dir: str = "."):
        """SaveDebugData role (System.cc:1219): dump the last VI-init
        diagnostics as the reference's init_* file set — init-section
        trajectory, scale, gravity direction (Rwg rows), computational
        cost, and biases.  Appending files keyed by the init section
        counter, exactly like the reference (including its
        'FrameTrajectoy' artifact filename)."""
        import os

        dbg = getattr(self.local_mapper, "init_debug", None)
        if dbg is None:
            return
        sect = getattr(self.local_mapper, "init_sect", 0)
        self.save_trajectory_euroc(
            os.path.join(out_dir, f"init_FrameTrajectoy_{sect}_{init_idx}.txt")
        )
        with open(os.path.join(out_dir, f"init_Scale_{sect}.txt"), "a") as f:
            f.write(f"{dbg['scale']:.6f}\n")
        with open(os.path.join(out_dir, f"init_GDir_{sect}.txt"), "a") as f:
            for row in dbg["Rwg"]:
                f.write(",".join(f"{v:.6f}" for v in row) + "\n")
        with open(os.path.join(out_dir, f"init_CompCost_{sect}.txt"), "a") as f:
            f.write(f"{dbg['cost_time']:.6f}\n")
        with open(os.path.join(out_dir, f"init_Biases_{sect}.txt"), "a") as f:
            f.write(",".join(f"{v:.6f}" for v in dbg["bg"]) + "\n")
            f.write(",".join(f"{v:.6f}" for v in dbg["ba"]) + "\n")

    def get_tracked_keypoints_un(self):
        """Undistorted keypoints of tracked map points
        (System::GetTrackedKeyPointsUn role, include/System.h:178)."""
        f = self.tracker.current
        if f is None:
            return np.zeros((0, 2))
        idx = [
            i
            for i, (mp, o) in enumerate(zip(f.map_points, f.outlier))
            if mp is not None and not o
        ]
        return f.kps_un[idx] if idx else np.zeros((0, 2))

    def _keyframe_poses(self, body_frame: bool = False, map_=None) -> list:
        """Sorted-by-id good keyframes of the current map (or `map_`) as
        (ts, Twc) or body (ts, Twb) — the reference's KF savers sort by
        mnId, skip bad, and write GetImuPose for inertial sensors
        (System.cc SaveKeyFrameTrajectoryTUM/EuRoC + per-map overload)."""
        m = map_ if map_ is not None else self.atlas.get_current_map()
        kfs = sorted(m.get_all_keyframes(), key=lambda k: k.id)
        body = body_frame and self.imu_calib is not None
        out = []
        for kf in kfs:
            if kf.bad:
                continue
            if body:
                out.append((kf.timestamp, (self.imu_calib.Tbc * kf.Tcw).inverse()))
            else:
                out.append((kf.timestamp, kf.Twc))
        return out

    def save_keyframe_trajectory_tum(self, path: str):
        from orbslam3_tpu_torch.utils.trajectory import save_tum

        save_tum(path, self._keyframe_poses())

    def save_keyframe_trajectory_euroc(self, path: str, map_=None):
        """SaveKeyFrameTrajectoryEuRoC role (per-map overload via `map_`,
        System.h:159): ns stamps; body poses for inertial configs
        (System.cc: GetImuPosition/GetImuRotation).  With no `map_` the
        no-arg reference overload targets the BIGGEST map (System.cc:
        1020-1040) — matching save_trajectory_euroc, so the frame and KF
        artifacts of a multi-map session come from the same map."""
        from orbslam3_tpu_torch.utils.trajectory import save_euroc

        save_euroc(
            path,
            self._keyframe_poses(
                body_frame=self.imu_calib is not None,
                map_=map_ if map_ is not None else self._biggest_map(),
            ),
        )
