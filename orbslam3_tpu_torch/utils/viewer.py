"""Headless visualization: frame overlays and map renders to image files.

Role-parity with the reference's Viewer/FrameDrawer/MapDrawer
(ORB_SLAM3/src/Viewer.cc, FrameDrawer.cc, MapDrawer.cc) minus the
interactive Pangolin window (no display in this environment): FrameDrawer
overlays tracked keypoints/matches on the current image; MapDrawer renders
keyframe frusta, the covisibility graph, and map points; Viewer ties both
to a SLAM System and writes PNG frames to a directory (consumable as a
video or inspected per frame).

Two drive modes, mirroring the reference:
  * caller-polled: `viewer.update(image)` draws synchronously;
  * worker thread (`Viewer::Run` role, ORB_SLAM3/src/Viewer.cc:162):
    `start()` spawns a render thread; `update(image)` then only snapshots
    the tracked-frame state under the caller's lock (FrameDrawer::Update
    role) and the thread does the expensive drawing/PNG encode off the
    tracking path, latest-wins.  Pause/resume/step controls mirror the
    reference's Stop/Step UI flags; `request_finish()` joins the thread.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from orbslam3_tpu_torch.utils import imageio
from orbslam3_tpu_torch.utils.raster import (
    circle_pixels,
    line_pixels,
    put_text,
    rectangle_pixels,
    stamp,
    unique_offsets,
)


class FrameDrawer:
    """Overlay renderer with a snapshot stage (FrameDrawer::Update /
    ::DrawFrame split): `update` copies cheap state on the tracking thread;
    `draw_snapshot` renders from the copy on any thread."""

    def __init__(self, system):
        self.system = system
        self._snap = None

    def update(self, image: np.ndarray):
        tracker = self.system.tracker
        f = tracker.current
        stats = self.system.map_stats()
        state = tracker.state.name
        inliers = tracker.matches_inliers
        if f is None:
            self._snap = (image.copy(), None, None, state, stats, inliers)
            return
        matched = np.fromiter(
            (
                f.map_points[i] is not None and not f.outlier[i]
                for i in range(f.n)
            ),
            bool,
            f.n,
        )
        self._snap = (
            image.copy(), f.kps[: f.n].copy(), matched, state, stats, inliers
        )

    def draw_snapshot(self) -> np.ndarray | None:
        """The overlay as cv2 5.x draws it, pixel for pixel, in numpy
        (utils/raster.py): the grey image as BGR; per keypoint in order, a
        matched one a 7x7 rectangle of thickness 1 and a filled radius-1
        circle in green, any other the circle in grey, each clipped to the
        image; the status line in FONT_HERSHEY_PLAIN at scale 1,
        anti-aliased as cv2 5.x draws it (cv2 4.x draws it without)."""
        if self._snap is None:
            return None
        image, kps, matched, state, stats, inliers = self._snap
        img = np.repeat(image.reshape(*image.shape[:2], 1), 3, axis=2)  # GRAY2BGR
        if kps is not None and len(kps):
            dot = circle_pixels((0, 0), 1)
            marks = [unique_offsets(dot), unique_offsets(rectangle_pixels((-3, -3), (3, 3)), dot)]
            colors = np.where(matched[:, None], np.uint8([0, 255, 0]), np.uint8([120, 120, 120]))
            xy = np.stack([kps[:, 0], kps[:, 1]], axis=1).astype(np.int64)  # int(): toward zero
            stamp(img, xy, marks, colors, matched.astype(np.int64))
        txt = (
            f"{state}  KFs: {stats['n_keyframes']}  MPs: {stats['n_map_points']}"
            f"  inliers: {inliers}"
        )
        put_text(img, txt, (10, img.shape[0] - 10), (255, 255, 255))
        return img

    def draw(self, image: np.ndarray) -> np.ndarray:
        """Synchronous snapshot + render (caller-polled mode)."""
        self.update(image)
        return self.draw_snapshot()


class MapDrawer:
    def __init__(self, system):
        self.system = system

    def render(self, path: str):
        """A plan view of the current map as an 880x660 BGR PNG, drawn and
        written in numpy (no matplotlib, whose PNG writer needs PIL): x to
        the right, z up, scaled to fit; map points grey, the keyframe
        centres in blue joined in the map's order, each keyframe's three
        best covisibility edges in green."""
        w, h = 880, 660
        img = np.full((h, w, 3), 255, np.uint8)
        m = self.system.atlas.get_current_map()
        pts = np.array([mp.position for mp in m.get_all_map_points()]).reshape(-1, 3)
        kfs = m.get_all_keyframes()
        centers = np.array([kf.camera_center() for kf in kfs]).reshape(-1, 3)
        every = np.concatenate([pts, centers])
        every = every[np.isfinite(every).all(axis=1)]
        if len(every):
            lo, hi = every[:, [0, 2]].min(axis=0), every[:, [0, 2]].max(axis=0)
            scale = min((w - 41) / max(hi[0] - lo[0], 1e-9), (h - 41) / max(hi[1] - lo[1], 1e-9))

            def px(p):
                p = np.nan_to_num(np.asarray(p, np.float64).reshape(-1, 3))
                x = 20 + (p[:, 0] - lo[0]) * scale
                y = h - 21 - (p[:, 2] - lo[1]) * scale
                return np.stack([x, y], axis=1).round().clip(-1, max(w, h)).astype(np.int64)

            stamp(img, px(pts), np.zeros((1, 2), np.int64), (160, 160, 160))
            c = px(centers)
            index = {id(kf): i for i, kf in enumerate(kfs)}
            segments = [(index[id(kf)], index[id(nb)], (0, 160, 0)) for kf in kfs
                        for nb in kf.get_best_covisibility_keyframes(3) if id(nb) in index]
            segments += [(i - 1, i, (255, 0, 0)) for i in range(1, len(kfs))]
            for a, b, colour in segments:
                xs, ys = line_pixels(c[a], c[b], (w, h))
                img[ys, xs] = colour
            stamp(img, c, unique_offsets(circle_pixels((0, 0), 2)), (255, 0, 0))
        imageio.imwrite(path, img)


class Viewer:
    """Writes frame overlays + periodic map renders to out_dir.

    Caller-polled by default; `start()` switches to a worker render thread
    (Viewer::Run role) consuming latest-wins snapshots."""

    def __init__(self, system, out_dir: str, map_every: int = 20):
        self.system = system
        self.out_dir = out_dir
        self.map_every = map_every
        self.frame_drawer = FrameDrawer(system)
        self.map_drawer = MapDrawer(system)
        self.count = 0
        os.makedirs(out_dir, exist_ok=True)
        # worker-thread state (Viewer.cc mbStopped/mbStepByStep analogs)
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._finish = threading.Event()
        self._paused = False
        self._step = 0
        self._lock = threading.Lock()
        self._pending = False
        self.frames_drawn = 0

    # --- worker-thread mode (Viewer::Run, src/Viewer.cc:162 role) ---------
    def start(self):
        if self._thread is not None:
            return
        self._finish.clear()
        self._thread = threading.Thread(
            target=self._run, name="viewer", daemon=True
        )
        self._thread.start()

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def request_pause(self):
        """Viewer 'Stop' control: keep snapshotting, stop rendering."""
        with self._lock:
            self._paused = True

    def resume(self):
        with self._lock:
            self._paused = False
        self._wake.set()

    def step(self):
        """Render exactly one pending frame while paused (step control)."""
        with self._lock:
            self._step += 1
        self._wake.set()

    def request_finish(self):
        """Drain + join the render thread (RequestFinish/isFinished role)."""
        if self._thread is None:
            return
        self._finish.set()
        self._wake.set()
        self._thread.join(timeout=10)
        self._thread = None

    def _run(self):
        while True:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            with self._lock:
                paused = self._paused
                if paused and self._step > 0:
                    self._step -= 1
                    paused = False
                pending = self._pending
                if pending and not paused:
                    self._pending = False
            if pending and not paused:
                self._render_one()
            if self._finish.is_set():
                with self._lock:
                    pending = self._pending
                    self._pending = False
                if pending and not self._paused:
                    self._render_one()  # drain the last snapshot
                return

    def _render_one(self):
        img = self.frame_drawer.draw_snapshot()
        if img is None:
            return
        imageio.imwrite(os.path.join(self.out_dir, f"frame_{self.count:05d}.png"), img)
        if self.count % self.map_every == 0:
            self.map_drawer.render(
                os.path.join(self.out_dir, f"map_{self.count:05d}.png")
            )
        self.count += 1
        self.frames_drawn += 1

    # --- per-frame entry ---------------------------------------------------
    def update(self, image: np.ndarray):
        """Caller-polled: draw synchronously.  Worker mode: snapshot only
        (cheap, on the tracking thread) and wake the render thread."""
        if self.running():
            self.frame_drawer.update(image)
            with self._lock:
                self._pending = True
            self._wake.set()
            return
        img = self.frame_drawer.draw(image)
        imageio.imwrite(os.path.join(self.out_dir, f"frame_{self.count:05d}.png"), img)
        if self.count % self.map_every == 0:
            self.map_drawer.render(
                os.path.join(self.out_dir, f"map_{self.count:05d}.png")
            )
        self.count += 1
