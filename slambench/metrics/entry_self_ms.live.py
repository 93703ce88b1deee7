"""The entry point's self time, ms a frame: the mean of the program's
`System.track_stereo` records (its span around the whole call) minus the
means of its four children's (`1.0_GrabImageStereo.preprocess`,
`1.1_GrabImageStereo.extract`, `1.2_Frame`, `2_Track`) over the traced
window's frames: the part of a call no span explains.  Moves
`frame_ms_mean`."""

import statistics

TAG = "System.track_stereo"
CHILDREN = ("1.0_GrabImageStereo.preprocess", "1.1_GrabImageStereo.extract", "1.2_Frame",
            "2_Track")


def read(run: dict):
    records = run["records"]
    if not all(records.get(tag) for tag in (TAG,) + CHILDREN):
        return None
    return statistics.fmean(records[TAG]) - sum(statistics.fmean(records[t]) for t in CHILDREN)
