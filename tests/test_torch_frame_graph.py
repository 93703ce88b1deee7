"""The port's frame programs as CUDA graphs (`utils.frame_graph.FrameGraph`).

On the CPU: the launch-count registry (`utils.launches`: snapshot, add,
and what a capture records and takes back), `FrameGraph` refusing a CPU
device, a module dropping its graphs when it is moved or cast, the
entries' plumbing on a CPU module (where no graph is made: each entry is
the program the port ran before it had graphs, `batch` writes every row,
the shape and device checks refuse), and every frame program free of
what a capture refuses: run on the meta device under a dispatch mode, no
op reads a value back to the host and none copies from the host.  No CPU
test can hold a graph against its eager program; that is done on the
card only.

The rectifier's remap of a raw pair (`StereoRectifier.rectify`): on the
CPU its map holder runs it eagerly and equals `remap_bilinear`; on the
meta device it reads nothing back and uploads nothing.

On the card (`cuda`-marked, skipped without one): graphed equal to eager
bit for bit for each program the System runs and for the rectifier's
remap, with the same launches per frame, every batch row equal to a single frame, prefetch on the side
stream interleaved with track_stereo, and a program with an `.item()`
failing its capture with nothing run eagerly in its place.  The file
needs no fixture of conftest.py, so on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_frame_graph.py -q
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import orbslam3_tpu_torch as port
from orbslam3_tpu_torch import FusedKernels, Pinhole, PyramidParams, stereo_sequence
from orbslam3_tpu_torch.frontend import stereo_frame as sf
from orbslam3_tpu_torch.ops import brief, extractor as ex, fast, orientation, select
from orbslam3_tpu_torch.ops import window_gather as wg
from orbslam3_tpu_torch.utils import launches
from orbslam3_tpu_torch.utils.frame_graph import FrameGraph, TableModule

MBF, FX = 15.0, 150.0
# the flat geometry at a small size, and one that is not flat (the top
# level inactive, the upper levels below their quota: `_extract_single`)
FLAT = ((240, 320), PyramidParams(n_features=500))
NON_FLAT = ((120, 160), PyramidParams())
FUSED = FusedKernels(True, True, True)


def _pair(hw, seed=1) -> torch.Tensor:
    cam = Pinhole([FX, FX, hw[1] / 2, hw[0] / 2])
    return torch.from_numpy(np.stack(stereo_sequence(1, cam, 0.12, *hw, seed=seed)[0][:2]))


# --- the launch-count registry --------------------------------------------


def test_registry_snapshot_add_and_reset():
    before = launches.snapshot()
    assert set(before) == {
        "fast_score", "gather_windows", "detect_fused", "window_moments", "sample_windows",
        "brief_descriptors", "fast_variant_t1", "fast_variant_t2", "fast_variant_t3",
        "fast_variant_t4", "grid_pool", "stereo_hamming", "sad_refine",
    }
    assert port.kernel_launches() == before
    launches.add({"fast_score": 1, "gather_windows": 2})
    after = launches.snapshot()
    assert after == dict(before, fast_score=before["fast_score"] + 1,
                         gather_windows=before["gather_windows"] + 2)
    assert fast.raw_score_map.launches == after["fast_score"]
    port.reset_kernel_launches()
    assert set(launches.snapshot().values()) == {0}
    launches.add(before)
    assert launches.snapshot() == before


def test_recorded_takes_back_what_a_capture_added_and_replays_add_it():
    """FrameGraph's accounting: the capture's counts are recorded and taken
    back (it launched nothing on the card), each replay adds them."""
    before = launches.snapshot()
    with launches.recorded() as per_frame:
        fast.raw_score_map.launches += 1  # as a capture of one stereo frame counts
        wg.gather_windows.launches += 2
    assert per_frame == {"fast_score": 1, "gather_windows": 2}
    assert launches.snapshot() == before
    for _ in range(3):  # three replays
        launches.add(per_frame)
    assert launches.snapshot() == dict(before, fast_score=before["fast_score"] + 3,
                                       gather_windows=before["gather_windows"] + 6)
    launches.add({k: -3 * n for k, n in per_frame.items()})
    with pytest.raises(RuntimeError):
        with launches.recorded() as failed:
            brief.brief_descriptors.launches += 1
            raise RuntimeError("a capture that fails")
    assert failed == {"brief_descriptors": 1}
    assert launches.snapshot() == before


# --- FrameGraph refuses the CPU --------------------------------------------


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_frame_graph_refuses_the_cpu(device):
    with pytest.raises(ValueError, match="CUDA device"):
        FrameGraph(lambda x: x + 1, device)


def test_cpu_module_runs_the_program_itself():
    """A CPU front-end holds no graph: the caller asked for the CPU, so
    `replay` calls the program and creates no FrameGraph."""
    hw, params = FLAT
    fe = sf.StereoFrontEnd.from_reference(params, hw, MBF, FX)
    pair = _pair(hw)
    assert torch.equal(fe(pair), fe.eager(pair))
    assert fe.graphs == {}
    calls = []
    assert fe.replay("any", lambda x: calls.append(x) or x + 1, pair).equal(pair + 1)
    assert len(calls) == 1 and fe.graphs == {}


def test_moving_or_casting_a_module_drops_its_graphs():
    """A graph reads the module's buffers at their addresses at its
    capture: `.to()` and casts reallocate them, so the graphs go."""
    hw, params = NON_FLAT
    fe = sf.StereoFrontEnd.from_reference(params, hw, MBF, FX)
    x = ex.FeatureExtractor.from_reference(params, hw)
    for module, move in ((fe, lambda m: m.double()), (x, lambda m: m.cpu()),
                         (fe, lambda m: m.to("meta")), (x, lambda m: m.to("meta"))):
        module.graphs["packed"] = object()  # stands for a captured graph
        assert move(module) is module
        assert module.graphs == {}


# --- the entries' plumbing on a CPU module (no graph there) ---------------


@pytest.mark.parametrize("fused", [FusedKernels(), FUSED], ids=["default", "fused"])
@pytest.mark.parametrize("geometry", [FLAT, NON_FLAT], ids=["flat", "non_flat"])
def test_stereo_cpu_entries_run_the_program(geometry, fused):
    """On the CPU `forward`, `batch` and `pair_block` call the program the
    port ran before it had graphs; `batch` writes each row of its block."""
    hw, params = geometry
    fe = sf.front_end(params, hw, MBF, FX, "cpu", fused)
    pairs = torch.stack([_pair(hw, seed) for seed in (1, 2)])
    # the packed program the port ran before it had graphs
    want = [
        sf._pack_features(
            sf._extract_and_match_stereo_impl(pair, params, MBF, FX, tables=fe, fused=fused)
        )
        for pair in pairs
    ]
    assert torch.equal(fe.eager(pairs[0]), want[0])
    assert torch.equal(fe(pairs[0]), want[0])
    assert torch.equal(sf.extract_and_match_stereo_packed(pairs[0], params, MBF, FX, fused), want[0])
    got = fe.batch(pairs)
    assert got.shape == (2, *want[0].shape)
    for b in range(2):
        assert torch.equal(got[b], want[b])
    block = torch.stack([ex.pack_features(f) for f in fe.extract(pairs[1])])
    assert torch.equal(fe.pair_block(pairs[1]), block)
    assert torch.equal(fe.pair_block_eager(pairs[1]), block)
    assert fe.graphs == {}
    for bad in (pairs[0][:, :-1], pairs[0].float(), pairs[0].to("meta")):
        with pytest.raises(ValueError, match="pair"):
            fe(bad)


@pytest.mark.parametrize("fused", [FusedKernels(), FUSED], ids=["default", "fused"])
def test_extractor_cpu_entries_run_the_program(fused):
    """On the CPU `packed` calls `pack_features` of `extract_features`,
    and refuses an image of another shape."""
    hw, params = FLAT
    image = _pair(hw)[0]
    for p in (params, PyramidParams(n_features=5 * params.n_features)):  # mono's two
        x = ex.feature_extractor(p, hw, fused, "cpu")
        want = ex.pack_features(ex.extract_features(image, p, x, fused))
        assert torch.equal(x.eager(image), want)
        assert torch.equal(x.packed(image), want)
    with pytest.raises(ValueError, match="uint8 image"):
        x.packed(image[:, :-1])


# --- nothing a capture refuses: the programs on the meta device -----------

# ops that read a device value back to the host
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.item", "aten.equal")


class _CaptureProbe(TorchDispatchMode):
    """Records every op that reads a device value back to the host or
    copies a tensor from the host onto the device."""

    def __init__(self):
        super().__init__()
        self.refused = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        name = str(func)
        if name.startswith(HOST_READS):
            self.refused.append(name)
        if name.startswith(("aten._to_copy", "aten.copy_")):
            src = args[1] if name.startswith("aten.copy_") else args[0]
            if isinstance(src, torch.Tensor) and src.device.type == "cpu":
                self.refused.append(f"{name} from the host")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def meta_wrappers(monkeypatch):
    """The kernel wrappers as their plain twins for the meta device (a
    wrapper takes a CPU or a CUDA tensor only)."""

    def many(jobs):
        return [wg.gather_windows_plain(*job) for job in jobs]

    def moments(img, row0, col0, weights, fused=False):
        if fused:
            return wg.window_moments_plain(img, row0, col0, weights)
        return real_moments(img, row0, col0, weights)

    def descriptors(img, xy, ang, trig=None, pattern=None, fused=False):
        if fused:
            return brief.brief_descriptors_plain(img, xy, ang, trig, pattern)
        return real_brief(img, xy, ang, trig, pattern)

    real_moments, real_brief = wg.window_moments, brief.brief_descriptors
    monkeypatch.setattr(fast, "raw_score_map", fast.raw_score_map_plain)
    monkeypatch.setattr(fast, "detect_fused", fast.detect_fused_plain)
    monkeypatch.setattr(ex, "gather_windows_many", many)
    monkeypatch.setattr(sf, "gather_windows_many", many)
    monkeypatch.setattr(orientation, "window_moments", moments)
    monkeypatch.setattr(ex, "brief_descriptors", descriptors)
    monkeypatch.setattr(select, "candidate_pools", select.candidate_pools_plain)
    monkeypatch.setattr(sf, "stereo_pairs", sf.stereo_pairs_plain)
    monkeypatch.setattr(sf, "sad_refine", sf.sad_refine_plain)


@pytest.mark.parametrize("fused", [FusedKernels(), FUSED], ids=["default", "fused"])
@pytest.mark.parametrize("geometry", [FLAT, NON_FLAT], ids=["flat", "non_flat"])
def test_frame_programs_read_nothing_back_and_upload_nothing(meta_wrappers, geometry, fused):
    hw, params = geometry
    fe = sf.StereoFrontEnd.from_reference(params, hw, MBF, FX, fused).to("meta")
    x = ex.FeatureExtractor.from_reference(params, hw, fused).to("meta")
    pair = torch.empty((2, *hw), dtype=torch.uint8, device="meta")
    k = sum(int(q) for q in params.features_per_level())
    for name, program, shape in (
        ("stereo", lambda: fe.eager(pair), (k, ex.PACK_COLS)),
        ("pair block", lambda: fe.pair_block_eager(pair), (2, k, ex.PACK_COLS)),
        ("one camera", lambda: x.eager(pair[0]), (k, ex.PACK_COLS)),
    ):
        with _CaptureProbe() as probe:
            out = program()
        assert tuple(out.shape) == shape, name
        assert probe.ops > 500, name
        assert not probe.refused, (name, probe.refused)


def test_capture_probe_sees_a_read_back_and_an_upload():
    """The probe above finds what it looks for."""
    t = torch.zeros(4, device="meta")
    with _CaptureProbe() as probe:
        torch.from_numpy(np.arange(4, dtype=np.float32)).to("meta")
        try:
            t.sum().item()
        except (RuntimeError, NotImplementedError):
            pass  # meta tensors hold no value; the op was dispatched all the same
    assert any("from the host" in r for r in probe.refused), probe.refused
    assert any(r.startswith("aten._local_scalar_dense") for r in probe.refused), probe.refused


# --- the rectifier's remap ------------------------------------------------
RIG_HW = (120, 160)


def _rig():
    """A distorted stereo rig (EuRoC's radtan coefficients, the right
    camera turned a few mrad), its rectifier and three raw pairs."""
    from orbslam3_tpu_torch.frontend.rectify import StereoRectifier
    from orbslam3_tpu_torch.utils.lie import SE3, so3_exp

    h, w = RIG_HW
    cam_l = Pinhole([150.0, 150.0, 80.0, 60.0], [-0.28, 0.07, 0.0002, 0.00002])
    cam_r = Pinhole([151.0, 149.5, 82.0, 59.0], [-0.27, 0.075, -0.0001, -0.00003])
    t_rl = SE3(so3_exp(np.array([0.004, -0.006, 0.002])), np.array([-0.11, 0.001, -0.0008]))
    frames = stereo_sequence(3, cam_l, 0.11, h, w, seed=3, camera_r=cam_r, T_rl=t_rl)
    return StereoRectifier(cam_l, cam_r, t_rl.inverse(), (w, h)), [f[:2] for f in frames]


def _eager_remap(rect, raw, device):
    from orbslam3_tpu_torch.frontend.rectify import remap_bilinear

    maps = [torch.from_numpy(np.stack(m)).to(device)
            for m in ((rect.map1x, rect.map2x), (rect.map1y, rect.map2y))]
    return remap_bilinear(torch.from_numpy(np.stack(raw)).to(device), *maps)


def test_rectifier_remap_holder_on_the_cpu_runs_the_remap():
    """On the CPU the rectifier's map holder (a TableModule) runs the
    remap itself, keeps no graph, and equals the eager remap."""
    rect, pairs = _rig()
    for raw in pairs:
        got = rect.rectify(*raw, "cpu")
        assert all(g.dtype == torch.uint8 and tuple(g.shape) == RIG_HW for g in got)
        assert torch.equal(torch.stack(got), _eager_remap(rect, raw, "cpu"))
    holder = rect._device_maps[torch.device("cpu")]
    assert isinstance(holder, TableModule) and holder.graphs == {}
    assert torch.equal(holder.mapx[0], torch.from_numpy(rect.map1x))


def test_rectifier_remap_reads_nothing_back_and_uploads_nothing():
    from orbslam3_tpu_torch.frontend.rectify import remap_bilinear

    pair = torch.empty((2, *RIG_HW), dtype=torch.uint8, device="meta")
    mapx, mapy = (torch.empty((2, *RIG_HW), dtype=torch.float32, device="meta") for _ in range(2))
    with _CaptureProbe() as probe:
        out = remap_bilinear(pair, mapx, mapy)
    assert tuple(out.shape) == (2, *RIG_HW) and out.dtype == torch.uint8
    assert probe.ops > 20
    assert not probe.refused, probe.refused


# --- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phase 20 runs these checks on the H100")
    return torch.device("cuda")


def _graphed_vs_eager(graphed, eager, inputs):
    """Every input through the graph (the first call captures) and the
    eager program: equal bit for bit, with the same launches."""
    for x in inputs:
        with launches.recorded() as by_graph:
            got = graphed(x)
        with launches.recorded() as by_eager:
            want = eager(x)
        assert torch.equal(got, want)
        assert by_graph == by_eager
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [FusedKernels(), FUSED], ids=["default", "fused"])
@pytest.mark.parametrize("geometry", [((480, 752), PyramidParams()), NON_FLAT],
                         ids=["flat", "non_flat"])
def test_graphed_equals_eager_on_card(card, geometry, fused):
    hw, params = geometry
    fe = sf.front_end(params, hw, MBF, FX, str(card), fused)
    pairs = [_pair(hw, seed).to(card) for seed in (1, 2, 3)]
    _graphed_vs_eager(fe, fe.eager, pairs)
    _graphed_vs_eager(fe.pair_block, fe.pair_block_eager, pairs)
    assert set(fe.graphs) == {"packed", "pair_block"}
    assert all(g.replays >= len(pairs) - 1 for g in fe.graphs.values())
    for p in (params, PyramidParams(n_features=5 * params.n_features)):  # mono's two, RGB-D's
        x = ex.feature_extractor(p, hw, fused, str(card))
        _graphed_vs_eager(x.packed, x.eager, [pair[0] for pair in pairs])
    batch = torch.stack(pairs)
    rows = fe.batch(batch)
    for b in range(len(pairs)):
        assert torch.equal(rows[b], fe.eager(pairs[b]))


@pytest.mark.cuda
def test_prefetch_interleaved_with_track_equals_eager(card):
    from orbslam3_tpu_torch.slam.system import System

    # the smoke's 752x480 rig, on which every frame tracks
    hw, params, fx, mbf = (480, 752), PyramidParams(), 435.2, 435.2 * 0.11
    cam = Pinhole([fx, fx, hw[1] / 2, hw[0] / 2])
    frames = stereo_sequence(8, cam, 0.11, *hw, seed=1)
    ref = System(cam, mbf, params, device=str(card))
    fe = ref._front_end(hw)
    ref._front_end = lambda _hw: fe.eager  # every frame op by op
    want = [ref.track_stereo(l, r, timestamp=k / 20.0) for k, (l, r, _) in enumerate(frames)]
    ref.shutdown()
    inter = System(cam, mbf, params, device=str(card))
    assert inter._front_end(hw) is fe
    got = []
    for k in range(0, len(frames), 2):
        ahead = inter.prefetch_stereo(frames[k + 1][0], frames[k + 1][1])  # side stream
        got.append(inter.track_stereo(frames[k][0], frames[k][1], timestamp=k / 20.0))
        host, done, _, _ = ahead
        done.synchronize()
        eager = fe.eager(torch.from_numpy(np.stack(frames[k + 1][:2])).to(card)).cpu()
        assert torch.equal(host, eager)
        got.append(inter.track_stereo_prefetched(ahead, timestamp=(k + 1) / 20.0))
    inter.shutdown()
    assert fe.graphs["packed"].replays > 0
    assert len(got) == len(want) and all(p is not None for p in want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.matrix(), b.matrix())


@pytest.mark.cuda
def test_capture_with_a_host_read_raises_and_never_runs_eagerly(card):
    calls = []

    def program(x):
        calls.append(1)
        return x * int((x > 0).sum().item())  # a host synchronisation

    graph = FrameGraph(program, card)
    x = torch.arange(8, dtype=torch.float32, device=card)
    before = launches.snapshot()
    for _ in range(2):
        with pytest.raises(RuntimeError):
            graph(x)
        assert graph.graph is None
    # each call ran the warm-up and then the capture: nothing in place of it
    assert len(calls) == 4
    assert launches.snapshot() == before
    assert torch.equal(x + 1, torch.arange(1, 9, dtype=torch.float32, device=card))


@pytest.mark.cuda
def test_rectifier_remap_graph_equals_eager_on_card(card):
    """The rectifier's remap: captured at the first call, replayed after
    it, bit for bit the eager remap; moving nothing, it keeps its graph."""
    rect, pairs = _rig()
    for raw in pairs:
        got = torch.stack(rect.rectify(*raw, card))
        assert torch.equal(got, _eager_remap(rect, raw, card))
    graph = rect._device_maps[card].graphs["remap"]
    assert graph.replays == len(pairs) - 1
