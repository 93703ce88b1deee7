"""The threaded back-end's faults found by the soak at the camera's pace.

`System.shutdown` in threaded mode waits until the back-end threads end:
a caller reads the map right after `shutdown` (the soak's replayed
trajectory, `save_atlas`): a LocalMapping or LoopClosing thread still at
work then would hand it poses half moved.  The keyframe work here is a
stand-in that outlasts five seconds, the time limit the shutdown once
gave each thread.  `MapPoint.replace` never closes a cycle of
replacements.
"""

import threading
import time

import numpy as np

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
