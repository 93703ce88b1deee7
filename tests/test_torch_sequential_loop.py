"""A merge or a loop correction fired inside a sequential frame.

In sequential mode the keyframe a frame makes runs LocalMapping and then
LoopClosing inside that frame's `track_frame`.  A merge or a correction
there moves the frame's reference keyframe (the new keyframe itself),
while the frame's pose is still in the coordinates it was tracked in.
Upstream's LoopClosing is a thread: `Track()` has logged the frame
against its reference keyframe before the loop closer takes the
keyframe.  The port's sequential loop closer holds the keyframe until
the frame is logged, so the frame's logged pose relative to its keyframe
is the tracked one, and the replay (that relative pose composed with the
keyframe's pose) moves with the keyframe.  Before the repair the log read
the shift the merge or correction applied, half a metre here.

The tracker is armed to take the frame at its own pose and make it a
keyframe; LocalMapping only adds the keyframe to the map and passes it
on; the detection is a stand-in, the merge and the correction run.
"""

import numpy as np
import pytest

from orbslam3_tpu_torch import Pinhole, PyramidParams
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.slam.tracking import TrackingState
from orbslam3_tpu_torch.utils.lie import SE3, Sim3
from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary

from test_torch_threaded_backend import _frame, _keyframe, _two_maps

SHIFT = Sim3(1.0, np.eye(3), np.array([0.0, 0.0, 0.5]))


def _sequential_system():
    rng = np.random.default_rng(0)
    voc = BinaryVocabulary.train(rng.integers(0, 256, (200, 32), dtype=np.uint8), k=4, depth=2)
    sysm = System(Pinhole([150.0, 150.0, 80.0, 60.0]), 18.0, PyramidParams(),
                  vocabulary=voc, device="cpu")
    sysm.loop_closer.run_gba = False
    return sysm


def _arm(sysm, ref_kf):
    """The tracker takes the next frame at the pose it carries and makes
    it a keyframe; LocalMapping adds the keyframe to the map and hands it
    to the loop closer, as its sequential `_process` ends."""
    t, mapper = sysm.tracker, sysm.local_mapper
    t.state = TrackingState.OK
    t.ref_kf = t.last_kf = ref_kf
    t.last_frame = _frame(7)
    t._track_reference_keyframe = lambda: True
    t._track_local_map = lambda: True
    t._need_new_keyframe = lambda: True

    def process(kf):
        mapper._process_new_keyframe(kf)
        mapper.loop_closer.insert_keyframe(kf)

    mapper._process = process


def _track_fired_frame(sysm):
    """Track one frame whose keyframe fires; (its log line, its keyframe's
    pose before the loop closer ran)."""
    frame = _frame(8)
    frame.set_pose(SE3(np.eye(3), np.array([0.05, -0.02, 0.01])))
    before = []
    handle = sysm.loop_closer._handle

    def handle_and_note(kf):
        before.append(kf.Tcw.copy())
        handle(kf)

    sysm.loop_closer._handle = handle_and_note
    assert sysm.tracker.track_frame(frame) is not None
    assert len(before) == 1, "the frame's keyframe did not reach the loop closer"
    return sysm.tracker.trajectory[-1], before[0]


def _check_log(log, kf_before):
    frame_id, _, tcr, ref_kf, lost = log
    assert not lost
    assert not np.allclose(ref_kf.Tcw.t, kf_before.t), "the keyframe did not move"
    # the frame is its keyframe: logged against it, it sits on it
    assert np.linalg.norm(tcr.t) < 0.01, f"logged {np.linalg.norm(tcr.t):.3f} m off its keyframe"
    replayed = tcr * ref_kf.Tcw
    np.testing.assert_allclose(replayed.t, ref_kf.Tcw.t, atol=1e-9)
    np.testing.assert_allclose(replayed.R, ref_kf.Tcw.R, atol=1e-9)


@pytest.mark.parametrize("kind", ["merge", "loop"])
def test_a_frame_whose_keyframe_fires_is_logged_against_the_moved_keyframe(kind, monkeypatch):
    from orbslam3_tpu_torch.optim import local_ba

    monkeypatch.setattr(local_ba, "local_bundle_adjustment", lambda kf, m, **_: None)
    sysm = _sequential_system()
    closer = sysm.loop_closer
    if kind == "merge":
        m_old, m_young, kf_match, kf_prev = _two_maps(sysm)
        closer.detect_loop = lambda kf: (kf_match, SHIFT, {})
    else:
        m = sysm.atlas.get_current_map()
        loop_kf = _keyframe(m, 3)
        kf_prev = _keyframe(m, 4)
        closer.detect_loop = lambda kf: (loop_kf, SHIFT, {})
    _arm(sysm, kf_prev)
    log, kf_before = _track_fired_frame(sysm)
    ref_kf = log[3]
    assert ref_kf is sysm.tracker.ref_kf and ref_kf is not kf_prev
    if kind == "merge":
        assert ref_kf.map is m_old and m_young.bad and closer.n_merges == 1
    else:
        assert closer.n_loops_closed == 1
    _check_log(log, kf_before)
    assert closer.held == [], "a keyframe stayed held after track_frame returned"
    sysm.shutdown()


def test_no_keyframe_stays_held_past_track_frame():
    """Nothing fires: the keyframe is handled in the same call, after the
    frame's log line, and the sequential loop closer holds none after."""
    sysm = _sequential_system()
    m = sysm.atlas.get_current_map()
    kf_prev = _keyframe(m, 4)
    seen = []

    def detect(kf):
        seen.append((kf, len(sysm.tracker.trajectory)))
        return None

    sysm.loop_closer.detect_loop = detect
    _arm(sysm, kf_prev)
    n_logged = len(sysm.tracker.trajectory)
    sysm.tracker.track_frame(_frame(8))
    assert [kf for kf, _ in seen] == [sysm.tracker.ref_kf]
    assert seen[0][1] == n_logged + 1, "the loop closer ran before the frame was logged"
    assert sysm.loop_closer.held == []
    # a keyframe inserted outside a frame is handled by the shutdown
    late = _keyframe(m, 5)
    sysm.loop_closer.insert_keyframe(late)
    sysm.shutdown()
    assert [kf for kf, _ in seen] == [sysm.tracker.ref_kf, late]
    assert sysm.loop_closer.held == []
