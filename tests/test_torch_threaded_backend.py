"""The threaded back-end's faults found by the soak at the camera's pace.

`System.shutdown` in threaded mode waits until the back-end threads end:
a caller reads the map right after `shutdown` (the soak's replayed
trajectory, `save_atlas`): a LocalMapping or LoopClosing thread still at
work then would hand it poses half moved.  The keyframe work here is a
stand-in that outlasts five seconds, the time limit the shutdown once
gave each thread.  `MapPoint.replace` never closes a cycle of
replacements.

The map locking around merges and loop corrections, as upstream's
LoopClosing holds it: a merge holds both maps' update locks until its
welding BA ends; a frame that waited through a merge tracks holding the
lock of the map it tracks on; a correction resolves loop matches gone
stale since detection; keyframes queued for LocalMapping join the map
before a merge or a correction moves it, and a paused mapper takes none
from its queue.  Each of these fails on the code before the repair,
deterministically: stand-ins block on events.
"""

import threading
import time

import numpy as np
import pytest

from orbslam3_tpu_torch import Pinhole, PyramidParams
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary

BUSY_S = 5.5


def _busy(started: threading.Event, done: threading.Event):
    def work(_kf):
        started.set()
        time.sleep(BUSY_S)
        done.set()

    return work


def test_shutdown_waits_for_the_mapper_mid_keyframe():
    sysm = System(Pinhole([150.0, 150.0, 80.0, 60.0]), 18.0, PyramidParams(),
                  sequential=False, device="cpu")
    started, done = threading.Event(), threading.Event()
    sysm.local_mapper._process = _busy(started, done)
    sysm.local_mapper.kf_queue.put(object())
    assert started.wait(10)
    t0 = time.perf_counter()
    sysm.shutdown()
    assert done.is_set(), "shutdown returned while the mapper was mid-keyframe"
    assert time.perf_counter() - t0 > 0.5 * BUSY_S
    assert not sysm._mapper_thread.is_alive()
    assert sysm.is_shutdown()


def test_shutdown_waits_for_the_loop_closer_mid_keyframe():
    rng = np.random.default_rng(0)
    voc = BinaryVocabulary.train(rng.integers(0, 256, (200, 32), dtype=np.uint8), k=4, depth=2)
    sysm = System(Pinhole([150.0, 150.0, 80.0, 60.0]), 18.0, PyramidParams(),
                  sequential=False, vocabulary=voc, device="cpu")
    started, done = threading.Event(), threading.Event()
    sysm.loop_closer._handle = _busy(started, done)
    sysm.loop_closer.kf_queue.put(object())
    assert started.wait(10)
    sysm.shutdown()
    assert done.is_set(), "shutdown returned while the loop closer was mid-keyframe"
    assert not sysm._loop_thread.is_alive() and not sysm._mapper_thread.is_alive()


def test_replace_never_closes_a_cycle():
    """The threaded soak's stop: a loop correction fused the current point
    into a loop point that LocalMapping had fused into the current point
    meanwhile, and the tracker's `get_replaced` then ran round the cycle
    holding the map lock."""
    from orbslam3_tpu_torch.slam.map_point import MapPoint

    cur, loop = MapPoint(np.zeros(3), None, None), MapPoint(np.ones(3), None, None)
    loop.replace(cur)  # LocalMapping's fuse
    cur.replace(loop)  # the correction's stale match
    assert loop.replaced_by is cur and cur.replaced_by is None and not cur.bad
    assert loop.get_replaced() is cur
    third = MapPoint(np.full(3, 2.0), None, None)
    third.replace(loop)
    assert third.get_replaced() is cur


# --- map locking under merges and loop corrections -----------------------
# A hand-made atlas: the old map holds the matched keyframe, the young
# (current) map the current one; each keyframe sees its own few points.
# Nothing in these tests solves anything: the welding BA and the
# detection are stand-ins, so only the lock discipline around them runs.
WAIT_S = 10.0


def _frame(seed: int, n: int = 12):
    from orbslam3_tpu_torch.slam.frame import Frame
    from orbslam3_tpu_torch.utils.lie import SE3

    rng = np.random.default_rng(seed)
    f = Frame(
        kps=rng.uniform([10, 10], [150, 110], (n, 2)), octave=np.zeros(n, np.int32),
        angle=np.zeros(n, np.float32), response=np.ones(n, np.float32),
        desc=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        camera=Pinhole([150.0, 150.0, 80.0, 60.0]), scale_factors=1.2 ** np.arange(8),
        mbf=18.0,
    )
    f.set_image_bounds(0, 0, 160, 120)
    f.set_pose(SE3())
    return f


def _keyframe(m, seed: int, n_points: int = 4):
    from orbslam3_tpu_torch.slam.keyframe import KeyFrame
    from orbslam3_tpu_torch.slam.map_point import MapPoint

    kf = KeyFrame(_frame(seed), m)
    m.add_keyframe(kf)
    rng = np.random.default_rng(100 + seed)
    for i in range(n_points):
        mp = MapPoint(rng.uniform([-1, -1, 3], [1, 1, 6]), kf, m)
        mp.descriptor = kf.desc[i].copy()
        mp.add_observation(kf, i)
        kf.add_map_point(mp, i)
        m.add_map_point(mp)
    return kf


def _two_maps(sysm):
    """(old map, young map, matched keyframe, current keyframe); the young
    map is the atlas's current one."""
    m_old = sysm.atlas.get_current_map()
    kf_match = _keyframe(m_old, 1)
    m_young = sysm.atlas.create_new_map()
    kf_cur = _keyframe(m_young, 2)
    return m_old, m_young, kf_match, kf_cur


def _threaded_system():
    rng = np.random.default_rng(0)
    voc = BinaryVocabulary.train(rng.integers(0, 256, (200, 32), dtype=np.uint8), k=4, depth=2)
    return System(Pinhole([150.0, 150.0, 80.0, 60.0]), 18.0, PyramidParams(),
                  sequential=False, vocabulary=voc, device="cpu")


def _held_elsewhere(lock) -> bool:
    """Whether a thread other than the caller holds `lock` (a probe thread
    fails to take it within 0.2 s)."""
    out = []

    def probe():
        got = lock.acquire(timeout=0.2)
        if got:
            lock.release()
        out.append(not got)

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return out[0]


def test_merge_holds_both_maps_until_the_welding_ba_ends(monkeypatch):
    """Upstream's MergeLocal holds both maps' update locks.  Holding only
    the young one lets a frame that starts once the atlas has switched to
    the old map track during the welding BA, and LocalMapping take the old
    map's lock to write its own BA back."""
    from orbslam3_tpu_torch.optim import local_ba
    from orbslam3_tpu_torch.utils.lie import Sim3

    sysm = _threaded_system()
    try:
        m_old, m_young, kf_match, kf_cur = _two_maps(sysm)
        in_ba, release = threading.Event(), threading.Event()

        def welding_ba(kf, m, **_):
            assert m is m_old
            in_ba.set()
            release.wait(WAIT_S)

        monkeypatch.setattr(local_ba, "local_bundle_adjustment", welding_ba)
        sysm.loop_closer.detect_loop = lambda kf: (kf_match, Sim3(), {})
        entered = threading.Event()
        sysm.tracker._track_frame_locked = lambda frame: entered.set()
        merge = threading.Thread(target=sysm.loop_closer._handle, args=(kf_cur,))
        merge.start()
        assert in_ba.wait(WAIT_S)
        assert sysm.atlas.get_current_map() is m_old
        tracker = threading.Thread(target=sysm.tracker.track_frame, args=(object(),))
        tracker.start()
        try:
            assert not entered.wait(0.5), "a frame tracked during the welding BA"
            assert _held_elsewhere(m_old.update_lock), "the old map was free during the merge"
            assert _held_elsewhere(m_young.update_lock)
        finally:
            release.set()
            merge.join(WAIT_S)
        assert entered.wait(WAIT_S)
        tracker.join(WAIT_S)
        assert kf_cur.map is m_old and m_young.bad
    finally:
        sysm.shutdown()


class _SignallingLock:
    """A map's update lock that says when a thread starts to wait on it."""

    def __init__(self, lock):
        self.lock, self.waiting = lock, threading.Event()

    def acquire(self, *a, **kw):
        self.waiting.set()
        return self.lock.acquire(*a, **kw)

    def release(self):
        self.lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def test_a_frame_that_waited_through_a_merge_holds_the_map_it_tracks_on():
    """A frame took the young map's lock as the merge began and waited;
    the merge moved the atlas to the old map; the frame must track holding
    the old map's lock, which LocalMapping takes for its BA."""
    sysm = System(Pinhole([150.0, 150.0, 80.0, 60.0]), 18.0, PyramidParams(),
                  sequential=False, device="cpu")
    try:
        m_old, m_young, _, _ = _two_maps(sysm)
        lock = m_young.update_lock = _SignallingLock(m_young.update_lock)
        seen = []

        def track_locked(frame):
            seen.append((sysm.atlas.get_current_map(),
                         _held_elsewhere(sysm.atlas.get_current_map().update_lock)))

        sysm.tracker._track_frame_locked = track_locked
        lock.acquire()  # the merge's hold on the young map
        tracker = threading.Thread(target=sysm.tracker.track_frame, args=(object(),))
        tracker.start()
        assert lock.waiting.wait(WAIT_S)
        sysm.atlas.change_map(m_old)  # what merge_maps does under the lock
        lock.release()
        tracker.join(WAIT_S)
        assert not tracker.is_alive()
        assert seen == [(m_old, True)], "the frame tracked on a map whose lock it did not hold"
    finally:
        sysm.shutdown()


def _loop_scene():
    """A one-map atlas with the current keyframe and an old loop keyframe,
    sequential, no global BA."""
    sysm = System(Pinhole([150.0, 150.0, 80.0, 60.0]), 18.0, PyramidParams(), device="cpu")
    m = sysm.atlas.get_current_map()
    loop_kf = _keyframe(m, 3)
    kf = _keyframe(m, 4, n_points=2)
    return sysm, m, loop_kf, kf


def test_a_correction_resolves_matches_gone_stale_since_detection():
    """`detect_loop` finds its matches while LocalMapping still runs; by
    `correct_loop` a loop point may have been culled or fused into
    another.  The correction attaches no culled point to the current
    keyframe and fuses into the replacement."""
    from orbslam3_tpu_torch.slam.loop_closing import LoopClosing
    from orbslam3_tpu_torch.slam.map_point import MapPoint
    from orbslam3_tpu_torch.utils.lie import Sim3

    sysm, m, loop_kf, kf = _loop_scene()
    culled, fused, survivor = (mp for _, mp in loop_kf.get_map_point_indices()[:3])
    cur_point = kf.map_points[1]
    culled.set_bad()
    fused.replace(survivor)
    # slots 2 and 3 of kf hold no point; slot 1 holds one of its own
    matches = {2: culled, 3: fused, 1: MapPoint(np.ones(3), loop_kf, m)}
    matches[1].replace(survivor)
    lc = LoopClosing(sysm.atlas, None, run_gba=False)
    lc.correct_loop(kf, loop_kf, Sim3(), matches)
    assert not any(mp is not None and mp.bad for mp in kf.map_points), \
        "a culled or replaced loop point was attached to the current keyframe"
    assert kf.map_points[2] is None
    assert kf.map_points[3] is survivor or kf.map_points[1] is survivor
    assert cur_point.bad and cur_point.get_replaced() is survivor
    assert kf in survivor.observations


@pytest.mark.parametrize("kind", ["merge", "loop"])
def test_keyframes_queued_for_the_mapper_join_the_map_before_it_is_corrected(kind, monkeypatch):
    """A keyframe the tracker made just before a merge or a correction may
    still wait in LocalMapping's queue: it is in no map's keyframes yet.
    Upstream's MergeLocal and CorrectLoop empty that queue first
    (LocalMapping::EmptyQueue), so the merge moves it into the old map
    with the young map's others and the correction moves it with its map.
    Left queued, it joins the map later at a pose in the young map's
    frame, and a replay against the old map loses its frames."""
    from orbslam3_tpu_torch.optim import local_ba
    from orbslam3_tpu_torch.utils.lie import SE3, Sim3

    sysm = _threaded_system()
    try:
        m_old, m_young, kf_match, kf_cur = _two_maps(sysm)
        mapper = sysm.local_mapper
        mapper.request_finish()
        sysm._mapper_thread.join(WAIT_S)  # the queue now stays as it is
        queued = _keyframe(m_young, 5)
        m_young.erase_keyframe(queued)
        queued.set_pose(SE3(np.eye(3), np.array([0.3, 0.0, 0.0])))
        mapper.kf_queue.put(queued)
        monkeypatch.setattr(local_ba, "local_bundle_adjustment", lambda kf, m, **_: None)
        shift = Sim3(1.0, np.eye(3), np.array([0.0, 0.0, 0.5]))
        if kind == "merge":
            sysm.loop_closer.detect_loop = lambda kf: (kf_match, shift, {})
        else:
            loop_kf = _keyframe(m_young, 6)
            seen = []
            sysm.loop_closer.detect_loop = lambda kf: (loop_kf, shift, {})
            sysm.loop_closer.correct_loop = lambda kf, cand, s, matches: seen.append(
                queued in kf.map.get_all_keyframes())
        t_before = queued.Tcw.t.copy()
        sysm.loop_closer._handle(kf_cur)
        assert mapper.kf_queue.empty()
        if kind == "merge":
            assert queued.map is m_old and queued in m_old.get_all_keyframes()
            assert not np.allclose(queued.Tcw.t, t_before), "the queued keyframe was not moved"
        else:
            assert seen == [True]
    finally:
        sysm.shutdown()


def test_a_paused_mapper_leaves_new_keyframes_in_its_queue():
    """The mapper popped a keyframe and then waited on its run lock while
    the loop closer held it: the keyframe was in no queue and no map when
    the closer emptied the queue and merged, so the merge did not move it.
    A paused mapper takes nothing from its queue."""
    sysm = System(Pinhole([150.0, 150.0, 80.0, 60.0]), 18.0, PyramidParams(),
                  sequential=False, device="cpu")
    try:
        mapper = sysm.local_mapper
        processed = []
        mapper._process = processed.append
        mapper.request_stop()  # the loop closer's pause
        try:
            mapper.kf_queue.put("kf")
            time.sleep(0.3)
            assert mapper.kf_queue.qsize() == 1, "the paused mapper took a keyframe"
            assert processed == []
        finally:
            mapper.resume()
        deadline = time.perf_counter() + WAIT_S
        while not processed and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert processed == ["kf"]
    finally:
        sysm.shutdown()
