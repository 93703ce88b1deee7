"""What users launch, in the port, that reads no dataset tree: the
synthetic and multi-robot examples, the extraction demo, the entry hook
and the ATE tool, each on the CPU.  The dataset drivers are in
tests/test_torch_drivers.py."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_synthetic_and_multi_robot_examples_on_the_cpu():
    from orbslam3_tpu_torch.examples import run_multi_robot, run_synth

    sysm, est, gt, rmse = run_synth.main(7, 240, 320, device="cpu")
    assert len(est) == 7 and rmse < 0.02
    systems, est, gt = run_multi_robot.main(2, 3, 900, 384, 512, device="cpu")
    assert [len(e) for e in est] == [3, 3]


def test_demo_extract_on_the_cpu():
    from orbslam3_tpu_torch.examples import demo_extract

    feat, left = demo_extract.main("cpu")
    assert int(feat.valid.sum()) > 900 and int(left.valid.sum()) > 900


def test_entry_matches_reference():
    """The entry hook's step on the CPU against the reference's
    (`__graft_entry__.entry`: its params and pair, its stereo program) on
    the same pair: integer columns equal."""
    sys.path.insert(0, REPO)
    import __graft_entry__
    from orbslam3_tpu.frontend import stereo_frame as ref_sf
    from orbslam3_tpu_torch.entry import entry

    fn, (pair,) = entry("cpu")
    _, (ref_pair,) = __graft_entry__.entry()
    np.testing.assert_array_equal(pair.numpy(), ref_pair)
    got = fn(pair)
    want = ref_sf.extract_and_match_stereo(
        ref_pair, __graft_entry__._params(), ref_sf.DEFAULT_MBF, ref_sf.DEFAULT_FX
    )
    for side in ("left", "right"):
        g, w = getattr(got, side), getattr(want, side)
        for col in ("xy", "octave", "response", "valid"):
            np.testing.assert_array_equal(getattr(g, col).numpy(), np.asarray(getattr(w, col)))
    ok = (got.u_right >= 0).numpy()
    assert ok.sum() > 100
    np.testing.assert_array_equal(ok, np.asarray(want.u_right) >= 0)


def test_evaluate_ate_matches_reference(tmp_path):
    """The port's ATE tool prints the reference's JSON line."""
    rng = np.random.default_rng(3)
    t = np.arange(50) * 0.05
    gt = np.column_stack([t, np.cumsum(rng.normal(0, 0.02, (50, 3)), 0), np.zeros((50, 3)),
                          np.ones(50)])
    est = gt.copy()
    est[:, 1:4] = est[:, 1:4] @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]) + 0.3
    est[:, 1:4] += rng.normal(0, 0.003, (50, 3))
    est[:, 0] += 0.004
    paths = [str(tmp_path / n) for n in ("est.txt", "gt.txt")]
    for p, rows in zip(paths, (est, gt)):
        np.savetxt(p, rows)
    outs = [
        subprocess.run([sys.executable, *cmd, *paths, "--scale"], capture_output=True, text=True,
                       cwd=REPO, timeout=120, env=dict(os.environ, PYTHONPATH=REPO)).stdout
        for cmd in (["-m", "orbslam3_tpu_torch.tools.evaluate_ate"], ["tools/evaluate_ate.py"])
    ]
    assert outs[0] and outs[0] == outs[1]
    assert '"pairs": 50' in outs[0]
