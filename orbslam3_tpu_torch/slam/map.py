"""Map + Atlas: the multi-map landmark/keyframe store.

Role-parity with ORB_SLAM3/include/Map.h (208 LoC) and Atlas.h
(170 LoC): keyframe/map-point sets, reference map points for drawing,
change index, ApplyScaledRotation for inertial gravity/scale alignment;
Atlas holds many maps, one current, and creates a fresh map on tracking
loss (the reference's elastic-recovery mechanism, SURVEY §5.3).
"""

from __future__ import annotations

import threading

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3


class LandmarkTable:
    """Contiguous per-map mirror of hot landmark attributes.

    The tracking hot loops (_search_local_points, _optimize_current_pose,
    the projection matchers) need (position, normal, distance range,
    descriptor, n_obs) for thousands of map points every frame; np.stack
    over per-object attributes was the single largest host-loop cost
    (the reference keeps these as pointer graphs and pays the same walk,
    ORB_SLAM3/src/Tracking4.cc:273+).  Map points attach on
    Map.add_map_point, detach on erase, and write through from their
    mutators (MapPoint property setters / _sync helpers), so a gather is
    one fancy-index per array.

    Slots are recycled: a detached point's slot may be reused, so slot
    indices must be re-read from the MapPoint (`slots_of`) at use time,
    never cached across mutations; `valid` guards the gap between a
    detach and the next reuse.
    """

    def __init__(self, cap: int = 2048):
        self.cap = cap
        self.pos = np.zeros((cap, 3))
        self.normal = np.zeros((cap, 3))
        self.min_d = np.zeros(cap)
        self.max_d = np.zeros(cap)
        self.desc = np.zeros((cap, 32), np.uint8)
        self.n_obs = np.zeros(cap, np.int32)
        self.valid = np.zeros(cap, bool)
        # frame-id stamp marking "already matched in frame X" (avoids a
        # per-object attribute read when excluding in-frame points)
        self.seen_stamp = np.full(cap, -1, np.int64)
        self._free = list(range(cap - 1, -1, -1))

    def _grow(self):
        old = self.cap
        self.cap = old * 2
        for name in ("pos", "normal", "min_d", "max_d", "desc", "n_obs",
                     "valid", "seen_stamp"):
            a = getattr(self, name)
            shape = (self.cap,) + a.shape[1:]
            b = np.zeros(shape, a.dtype)
            if name == "seen_stamp":
                b[:] = -1
            b[:old] = a
            setattr(self, name, b)
        self._free.extend(range(self.cap - 1, old - 1, -1))

    def attach(self, mp) -> None:
        # getattr: duck-typed stand-ins (tests) may lack the mirror fields
        prev = getattr(mp, "_table", None)
        if prev is self:
            return
        if prev is not None:
            prev.detach(mp)
        if not self._free:
            self._grow()
        s = self._free.pop()
        self.pos[s] = mp.position
        self.normal[s] = getattr(mp, "normal", 0.0)
        self.min_d[s] = getattr(mp, "min_distance", 0.0)
        self.max_d[s] = getattr(mp, "max_distance", 0.0)
        desc = getattr(mp, "descriptor", None)
        if desc is not None:
            self.desc[s] = desc
        self.n_obs[s] = getattr(mp, "n_obs", 0)
        self.valid[s] = not getattr(mp, "bad", False)
        self.seen_stamp[s] = -1
        mp._table = self
        mp._slot = s

    def detach(self, mp) -> None:
        if getattr(mp, "_table", None) is not self:
            return
        s = mp._slot
        self.valid[s] = False
        self._free.append(s)
        mp._table = None
        mp._slot = -1

    def slots_of(self, mps) -> np.ndarray:
        """Current slot per point; -1 where the point is not attached here."""
        from orbslam3_tpu_torch.native import hostops

        return hostops.slots_of(mps, self)


class Map:
    _next_id = 0

    def __init__(self):
        self.id = Map._next_id
        Map._next_id += 1
        self.keyframes: set = set()
        self.map_points: set = set()
        self.ref_map_points: list = []
        self.max_kf_id = 0
        self.init_kf_id = 0
        self.change_idx = 0
        self.imu_initialized = False
        self.iniertial_ba1 = False
        self.iniertial_ba2 = False
        self.is_inertial = False
        self.bad = False
        self.lock = threading.RLock()
        # coarse map-update mutex (mMutexMapUpdate role): held by Tracking
        # for a whole frame and by loop correction / merge / BA write-backs;
        # distinct from `lock`, which guards the containers fine-grained
        self.update_lock = threading.RLock()
        self.origin_kfs: list = []
        self.landmarks = LandmarkTable()

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("lock", None)
        state.pop("update_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.lock = threading.RLock()
        self.update_lock = threading.RLock()

    def add_keyframe(self, kf):
        with self.lock:
            if not self.keyframes:
                # per-map initial keyframe (Map::GetInitKFid role) — culling
                # and SetBadFlag protect it, not the process-global id 0
                self.init_kf_id = kf.id
            self.keyframes.add(kf)
            if kf.id > self.max_kf_id:
                self.max_kf_id = kf.id
            if not self.origin_kfs:
                self.origin_kfs.append(kf)

    def add_map_point(self, mp):
        with self.lock:
            self.map_points.add(mp)
            self.landmarks.attach(mp)

    def erase_map_point(self, mp):
        with self.lock:
            self.map_points.discard(mp)
            self.landmarks.detach(mp)

    def erase_keyframe(self, kf):
        with self.lock:
            self.keyframes.discard(kf)

    def get_all_keyframes(self) -> list:
        with self.lock:
            return sorted(self.keyframes, key=lambda k: k.id)

    def get_all_map_points(self) -> list:
        with self.lock:
            return list(self.map_points)

    def n_map_points(self) -> int:
        return len(self.map_points)

    def n_keyframes(self) -> int:
        return len(self.keyframes)

    def info_changed(self):
        with self.lock:
            self.change_idx += 1

    def apply_scaled_rotation(self, T: SE3, scale: float, scale_vel: bool = False):
        """Align the map to a new gravity/scale frame (Map::ApplyScaledRotation):
        every KF pose and MP position is transformed by (s, R, t)."""
        with self.lock:
            r, t = T.R, T.t
            for kf in self.keyframes:
                twc = kf.Twc
                twc_new = SE3(r @ twc.R, scale * (r @ twc.t) + t)
                kf.set_pose(twc_new.inverse())
                if hasattr(kf, "velocity") and kf.velocity is not None and scale_vel:
                    kf.velocity = scale * (r @ kf.velocity)
            for mp in self.map_points:
                mp.position = scale * (r @ mp.position) + t
                mp.update_normal_and_depth()
            self.change_idx += 1


class Atlas:
    def __init__(self):
        self.maps: list[Map] = []
        self.current: Map | None = None
        self.cameras: list = []
        self.lock = threading.RLock()
        self.create_new_map()

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.lock = threading.RLock()

    def create_new_map(self) -> Map:
        with self.lock:
            m = Map()
            self.maps.append(m)
            self.current = m
            return m

    def change_map(self, m: Map):
        with self.lock:
            self.current = m

    def add_camera(self, cam):
        if cam not in self.cameras:
            self.cameras.append(cam)
        return cam

    def get_current_map(self) -> Map:
        return self.current

    def get_all_maps(self) -> list[Map]:
        return list(self.maps)

    def set_map_bad(self, m: Map):
        m.bad = True

    def remove_bad_maps(self):
        self.maps = [m for m in self.maps if not m.bad]

    def count_maps(self) -> int:
        return len(self.maps)

    # aggregate views
    def add_keyframe(self, kf):
        self.current.add_keyframe(kf)

    def add_map_point(self, mp):
        self.current.add_map_point(mp)
