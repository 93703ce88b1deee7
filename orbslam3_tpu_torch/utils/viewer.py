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
        import cv2

        if self._snap is None:
            return None
        image, kps, matched, state, stats, inliers = self._snap
        img = cv2.cvtColor(image, cv2.COLOR_GRAY2BGR)
        if kps is not None:
            for i in range(len(kps)):
                x, y = int(kps[i, 0]), int(kps[i, 1])
                if matched[i]:
                    cv2.rectangle(
                        img, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0), 1
                    )
                    cv2.circle(img, (x, y), 1, (0, 255, 0), -1)
                else:
                    cv2.circle(img, (x, y), 1, (120, 120, 120), -1)
        txt = (
            f"{state}  KFs: {stats['n_keyframes']}  MPs: {stats['n_map_points']}"
            f"  inliers: {inliers}"
        )
        cv2.putText(img, txt, (10, img.shape[0] - 10), cv2.FONT_HERSHEY_PLAIN, 1,
                    (255, 255, 255), 1)
        return img

    def draw(self, image: np.ndarray) -> np.ndarray:
        """Synchronous snapshot + render (caller-polled mode)."""
        self.update(image)
        return self.draw_snapshot()


class MapDrawer:
    def __init__(self, system):
        self.system = system

    def render(self, path: str):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        m = self.system.atlas.get_current_map()
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        mps = m.get_all_map_points()
        if mps:
            pts = np.stack([mp.position for mp in mps])
            ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.5, c="k", alpha=0.4)
        kfs = m.get_all_keyframes()
        if kfs:
            centers = np.stack([kf.camera_center() for kf in kfs])
            ax.plot(centers[:, 0], centers[:, 2], -centers[:, 1], "b-", lw=1)
            ax.scatter(centers[:, 0], centers[:, 2], -centers[:, 1], s=8, c="b")
            # covisibility edges
            for kf in kfs:
                c0 = kf.camera_center()
                for nb in kf.get_best_covisibility_keyframes(3):
                    c1 = nb.camera_center()
                    ax.plot([c0[0], c1[0]], [c0[2], c1[2]], [-c0[1], -c1[1]],
                            "g-", lw=0.3, alpha=0.5)
        ax.set_xlabel("x")
        ax.set_ylabel("z")
        ax.set_zlabel("-y")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)


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
        import cv2

        img = self.frame_drawer.draw_snapshot()
        if img is None:
            return
        cv2.imwrite(os.path.join(self.out_dir, f"frame_{self.count:05d}.png"), img)
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
        import cv2

        img = self.frame_drawer.draw(image)
        cv2.imwrite(os.path.join(self.out_dir, f"frame_{self.count:05d}.png"), img)
        if self.count % self.map_every == 0:
            self.map_drawer.render(
                os.path.join(self.out_dir, f"map_{self.count:05d}.png")
            )
        self.count += 1
