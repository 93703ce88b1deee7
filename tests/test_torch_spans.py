"""The port's span record (`orbslam3_tpu_torch/utils/benchmark.py`) and the
spans, counters and benchmark readers built on it.

The record: a span names its parent and frame, an after-the-fact span
keeps the start and end it was given, the ring stays bounded, the export
is Chrome-trace JSON on torch.profiler's clock, `trace_range` still fills
`Benchmark.records`.  The program: a threaded `System` fed features
(`track_stereo_features`, no front-end) records each frame's stages and
each keyframe's queue wait and mapping; one `track_stereo` call records
the whole call and its children; the tracker's keyframe counters add up.
The readers of `slambench/metrics/` give the means they name.  CPU only.
"""

import json
import statistics
import threading
import time

import numpy as np
import pytest

from orbslam3_tpu_torch.utils.benchmark import (
    RING_SPANS, Benchmark, Span, clock_ns, off_cpu, trace_range,
)

FRAME_SPANS = ("2_Track", "2_Track.offcpu", "2.0_Track.map_lock", "1.2_Frame", "1.2.1_BoW")


def _spans_since(mark: int) -> list:
    """The process-wide ring's spans with an id above `mark`, as `Span`s."""
    return [Span(*s) for s in list(Benchmark.the().spans) if s[4] > mark]


def _last_id() -> int:
    spans = Benchmark.the().spans
    return spans[-1][4] if spans else 0


# --- the record ------------------------------------------------------------------

def test_nested_spans_name_their_parent_and_inherit_the_frame():
    mark = _last_id()
    with trace_range("nest.outer", frame=7):
        with trace_range("nest.inner"):
            Benchmark.the().push_sample("nest.after", 0.5)
        with trace_range("nest.other", frame=9):
            pass
    got = {s.name: s for s in _spans_since(mark)}
    outer, inner = got["nest.outer"], got["nest.inner"]
    assert outer.parent is None and outer.frame == 7
    assert inner.parent == outer.id and inner.frame == 7
    assert got["nest.after"].parent == inner.id and got["nest.after"].frame == 7
    assert got["nest.other"].parent == outer.id and got["nest.other"].frame == 9
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert len({s.tid for s in got.values()}) == 1


def test_spans_on_another_thread_have_their_own_parents():
    mark = _last_id()
    with trace_range("thread.main", frame=1):
        t = threading.Thread(target=lambda: trace_range("thread.worker").__enter__().__exit__(),
                             name="span-worker")
        t.start()
        t.join()
    got = {s.name: s for s in _spans_since(mark)}
    worker = got["thread.worker"]
    assert worker.parent is None and worker.frame is None
    assert worker.tid == t.native_id != got["thread.main"].tid


def test_after_the_fact_spans_keep_their_start_and_end():
    b = Benchmark.the()
    mark = _last_id()
    start = clock_ns() - 5_000_000
    b.push_sample("after.given", 2.5, start, frame=3)
    before = clock_ns()
    b.push_sample("after.now", 1.25)
    got = {s.name: s for s in _spans_since(mark)}
    given = got["after.given"]
    assert (given.start_ns, given.end_ns, given.frame) == (start, start + 2_500_000, 3)
    now = got["after.now"]
    assert now.end_ns - now.start_ns == 1_250_000 and now.end_ns >= before
    assert b.records["after.given"][-1] == 2.5 and b.records["after.now"][-1] == 1.25


def test_the_ring_stays_bounded():
    b = Benchmark()
    for k in range(RING_SPANS + 12):
        b.push_sample("ring", k)
    with b.measure("ring.last"):
        pass
    assert len(b.spans) == RING_SPANS
    assert [s[0] for s in b.spans][-2:] == ["ring", "ring.last"]
    assert b.spans[0][2] - b.spans[0][1] == 13_000_000  # the 14th sample, 13 ms
    assert len(b.records["ring"]) == RING_SPANS + 12


def test_the_export_loads_as_chrome_trace_json(tmp_path):
    b = Benchmark()
    with b.measure("export.outer"):
        with b.measure("export.inner"):
            pass
        b.push_sample("export.after", 0.5, frame=4)
    path = tmp_path / "spans.json"
    b.export_chrome_trace(str(path), base_ns=1_000)
    doc = json.loads(path.read_text())
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert set(xs) == {"export.outer", "export.inner", "export.after"}
    outer, inner = xs["export.outer"], xs["export.inner"]
    s_outer = Span(*b.spans[2])
    assert outer["ts"] == (s_outer.start_ns - 1_000) / 1e3 and outer["dur"] >= inner["dur"] >= 0
    assert inner["args"]["parent"] == xs["export.after"]["args"]["parent"] == outer["args"]["id"]
    assert xs["export.after"]["args"]["frame"] == 4 and outer["args"]["frame"] is None
    assert xs["export.after"]["dur"] == 500.0
    assert inner["args"]["thread"] == threading.current_thread().name
    names = [e for e in doc["traceEvents"] if e["ph"] == "M" and e["tid"] == inner["tid"]]
    assert names and names[0]["args"]["name"] == threading.current_thread().name
    assert doc["baseTimeNanoseconds"] == 1_000


def test_spans_share_the_profilers_clock(tmp_path):
    """Spans exported with the profiler trace's `baseTimeNanoseconds` share
    the profiler's clock to within 0.2 ms.  The profiler stamps a range
    before the span's clock reads at entry and after it at exit, so on one
    clock each span lies inside its profiler event: none starts 0.2 ms
    before its event or ends 0.2 ms after it, and the median distances of
    starts and of ends are under 0.2 ms (a thread descheduled between the
    two stamps, as under a loaded host, only widens the enclosure).  The
    session's first range is a throwaway: the profiler stamps it and then
    sets itself up inside it (about a millisecond on a desktop CPU)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = [f"clock.{k}{part}" for k in range(3) for part in ("", ".inner")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("clock.first"):
            pass
        for k in range(3):
            with trace_range(f"clock.{k}"):
                time.sleep(0.004)
                with trace_range(f"clock.{k}.inner"):
                    time.sleep(0.002)
    prof.export_chrome_trace(str(tmp_path / "profiler.json"))
    theirs_doc = json.loads((tmp_path / "profiler.json").read_text())
    base = int(theirs_doc.get("baseTimeNanoseconds", 0))
    Benchmark.the().export_chrome_trace(str(tmp_path / "spans.json"), base_ns=base)
    ours_doc = json.loads((tmp_path / "spans.json").read_text())

    def by_name(doc):
        return {e["name"]: e for e in doc["traceEvents"]
                if e.get("ph") == "X" and e.get("name") in names}

    ours, theirs = by_name(ours_doc), by_name(theirs_doc)
    assert set(ours) == set(theirs) == set(names)
    starts = [ours[n]["ts"] - theirs[n]["ts"] for n in names]
    ends = [ours[n]["ts"] + ours[n]["dur"] - theirs[n]["ts"] - theirs[n]["dur"] for n in names]
    assert min(starts) > -200 and max(ends) < 200, (starts, ends)
    assert abs(statistics.median(starts)) < 200 and abs(statistics.median(ends)) < 200, (
        starts, ends)


def test_trace_range_fills_the_records():
    b = Benchmark.the()
    before = len(b.records["records.range"])
    with trace_range("records.range", "cpu"):
        time.sleep(0.001)
    assert len(b.records["records.range"]) == before + 1
    assert b.records["records.range"][-1] >= 0.9


def test_off_cpu_reads_the_time_a_thread_waited():
    mark = _last_id()
    with trace_range("offcpu.block"):
        with off_cpu("offcpu.wait"):
            time.sleep(0.03)
    got = {s.name: s for s in _spans_since(mark)}
    wait = got["offcpu.wait"]
    assert 25e6 <= wait.end_ns - wait.start_ns <= got["offcpu.block"].end_ns - wait.start_ns
    assert wait.parent == got["offcpu.block"].id


# --- the program -------------------------------------------------------------------

def _feature_world():
    from orbslam3_tpu_torch.tools import profile_host as ph

    pts, descs, rng = ph._world()
    return ph, pts, descs, rng


def _vocabulary(descs):
    from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary

    return BinaryVocabulary.train(descs[:3000], k=4, depth=3, seed=0)


def test_a_threaded_system_spans_each_frame_and_each_keyframe():
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
    from orbslam3_tpu_torch.slam.system import System

    ph, pts, descs, rng = _feature_world()
    sysm = System(ph.CAM, ph.MBF, PyramidParams(n_features=800), sequential=False,
                  max_frames=6, vocabulary=_vocabulary(descs), device="cpu")
    b = Benchmark.the()
    marks = {tag: len(b.records[tag]) for tag in FRAME_SPANS + ("LM.keyframe", "LM.queue_wait")}
    mark = _last_id()
    frames = []
    t = sysm.tracker
    try:
        for k in range(24):
            feats = ph._feats_at(pts, descs, rng, ph._pose(k))
            assert sysm.track_stereo_features(feats, k / 20.0, (0, 0, ph.W, ph.H)) is not None
            frames.append(t.current.id)
        # the stereo initialisation's keyframe and each inserted one; the
        # mapper stops at shutdown with what it has not taken left queued,
        # so wait (bounded) until it has processed them all
        made = t.n_kf_inserted + 1
        deadline = time.perf_counter() + 60
        while (len(b.records["LM.keyframe"]) - marks["LM.keyframe"] < made
               and time.perf_counter() < deadline):
            time.sleep(0.01)
    finally:
        sysm.shutdown()
    count = {tag: len(b.records[tag]) - n for tag, n in marks.items()}
    for tag in FRAME_SPANS:
        assert count[tag] == len(frames), (tag, count)
    spans = _spans_since(mark)
    track = [s for s in spans if s.name == "2_Track"]
    assert [s.frame for s in track] == frames
    tracker_tid = track[0].tid
    for name in FRAME_SPANS[1:]:
        assert [s.frame for s in spans if s.name == name] == frames, name
    assert t.n_kf_wanted == t.n_kf_inserted + t.n_kf_refused_busy and t.n_kf_inserted > 0
    assert sysm.loop_closer.n_loops_closed == 0 and not getattr(sysm.loop_closer, "n_merges", 0)
    assert count["LM.keyframe"] == count["LM.queue_wait"] == made, count
    mapped = [s for s in spans if s.name == "LM.keyframe"]
    queued = [s for s in spans if s.name == "LM.queue_wait"]
    assert [s.frame for s in mapped] == [s.frame for s in queued]
    assert set(s.frame for s in mapped) <= set(frames)
    assert all(s.tid != tracker_tid and s.parent is None for s in mapped + queued)
    for q, m in zip(queued, mapped):
        assert q.end_ns <= m.start_ns


def test_keyframe_counters_add_up_when_the_mapper_is_busy():
    """A sequential System whose mapper reads busy with 3 keyframes queued
    from frame 13 on (after its first inserted keyframe): the frames that
    want a keyframe from then on are refused, and wanted = inserted +
    refused."""
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
    from orbslam3_tpu_torch.slam.system import System

    ph, pts, descs, rng = _feature_world()
    sysm = System(ph.CAM, ph.MBF, PyramidParams(n_features=800), sequential=True,
                  max_frames=4, device="cpu")
    lm, t = sysm.local_mapper, sysm.tracker
    interrupts = []
    for k in range(36):
        if k == 13:
            inserted, wanted = t.n_kf_inserted, t.n_kf_wanted
            lm.accept_keyframes = lambda: False
            lm.queue_size = lambda: 3
            # a busy mapper's running BA is interrupted once per refusal
            lm.interrupt_ba = lambda: interrupts.append(t.current.id)
        sysm.track_stereo_features(ph._feats_at(pts, descs, rng, ph._pose(k)), k / 20.0,
                                   (0, 0, ph.W, ph.H))
    sysm.shutdown()
    assert t.n_kf_inserted == inserted > 0 and wanted == inserted
    assert t.n_kf_refused_busy == len(interrupts) == len(set(interrupts)) > 0
    assert t.n_kf_wanted == t.n_kf_inserted + t.n_kf_refused_busy


def test_track_stereo_spans_the_whole_call():
    from orbslam3_tpu_torch import Pinhole, PyramidParams, stereo_sequence
    from orbslam3_tpu_torch.slam.system import System

    cam = Pinhole([150.0, 150.0, 80.0, 60.0])
    descs = np.random.default_rng(0).integers(0, 256, (300, 32), dtype=np.uint8)
    sysm = System(cam, 18.0, PyramidParams(n_features=300), vocabulary=_vocabulary(descs),
                  device="cpu")
    (left, right, _), = stereo_sequence(1, cam, 0.12, 120, 160, seed=1)
    mark = _last_id()
    sysm.track_stereo(left, right, 0.0)
    sysm.shutdown()
    spans = {s.name: s for s in _spans_since(mark)}
    call = spans["System.track_stereo"]
    frame = sysm.tracker.current.id
    assert call.parent is None and call.frame == frame
    for child in ("1.0_GrabImageStereo.preprocess", "1.1_GrabImageStereo.extract", "1.2_Frame",
                  "2_Track"):
        s = spans[child]
        assert s.parent == call.id and s.frame == frame, child
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns, child
    assert spans["1.2.1_BoW"].parent == spans["1.2_Frame"].id
    for child in ("2_Track.offcpu", "2.0_Track.map_lock"):
        assert spans[child].parent == spans["2_Track"].id, child
    order = [spans[n].start_ns for n in ("1.0_GrabImageStereo.preprocess",
                                         "1.1_GrabImageStereo.extract", "1.2_Frame", "2_Track")]
    assert order == sorted(order)


# --- the benchmark's readers -------------------------------------------------------------

RUN_RECORDS = {
    "System.track_stereo": [40.0, 42.0],
    "1.0_GrabImageStereo.preprocess": [1.0, 1.0],
    "1.1_GrabImageStereo.extract": [6.0, 8.0],
    "1.2_Frame": [5.0, 6.0],
    "2_Track": [20.0, 22.0],
    "2.2_Track.local_map": [9.0, 12.0],
    "2.0_Track.map_lock": [0.5, 1.5],
    "2_Track.offcpu": [3.0, 5.0],
    "LM.queue_wait": [2.0, 30.0, 4.0],
    "LM.keyframe": [80.0, 100.0],
    "LC.keyframe": [7.0],
}
READINGS = {
    "entry_self_ms.live": 41.0 - 1.0 - 7.0 - 5.5 - 21.0,
    "frame_build_ms.live": 5.5,
    "track_local_map_ms.live": 10.5,
    "track_lock_wait_ms.live": 1.0,
    "track_offcpu_ms.live": 4.0,
    "kf_queue_ms.live": 12.0,
    "mapping_kf_ms.live": 90.0,
    "loop_kf_ms.live": 7.0,
}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_gives_its_mean(metric):
    from slambench import harness

    read = harness.reader_of(metric)
    run = {"records": {k: list(v) for k, v in RUN_RECORDS.items()}, "host": {}, "trace": None,
           "least_s": 1e-5}
    assert read(run) == pytest.approx(READINGS[metric])
    assert read({"records": {}, "host": {}, "trace": None, "least_s": 1e-5}) is None


def test_threads_lose_no_span_under_a_short_switch_interval():
    """Sixteen threads record spans at once, the interpreter switching every
    microsecond: every span keeps a record, a unique id and its thread's
    parent."""
    import sys

    b = Benchmark()
    per, n = 500, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(per):
                with b.measure(f"stress.{k}"):
                    b.push_sample("stress.after", 0.0, frame=k)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = [Span(*s) for s in b.spans]
    assert len(spans) == 2 * n * per and len({s.id for s in spans}) == len(spans)
    assert len(b.records["stress.after"]) == n * per
    assert all(len(b.records[f"stress.{k}"]) == per for k in range(n))
    ranges = {s.id: s for s in spans if s.name != "stress.after"}
    for s in spans:
        if s.name == "stress.after":
            assert ranges[s.parent].tid == s.tid and ranges[s.parent].name == f"stress.{s.frame}"


def test_records_read_while_threads_add_tags():
    """A reader loops over `records.items()`, as the benchmark's harness
    does, while another thread adds tags (until the reader has looped 50
    times, or 20000 tags), as the mapping threads do with their first
    spans, the interpreter switching every microsecond: the loop never
    sees the dict change size."""
    import sys

    b = Benchmark()
    for k in range(2000):
        b.push_sample(f"old.{k}", 0.0)

    reads = []

    def add():
        for k in range(20000):
            if len(reads) >= 50:
                break
            b.push_sample(f"new.{k}", 0.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    adder = threading.Thread(target=add)
    try:
        adder.start()
        while adder.is_alive():
            reads.append({tag: len(v) for tag, v in b.records.items()})
        adder.join()
    finally:
        sys.setswitchinterval(old)
    assert reads and all(2000 <= len(r) <= 22000 for r in reads)
