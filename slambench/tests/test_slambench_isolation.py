"""Nothing the benchmark runs imports JAX or the JAX package: the check on
whole top-level names, and a process that refuses them while it loads
every module of the benchmark (each configuration's sensor among them) and
the program's modules it drives."""

import subprocess
import sys
import textwrap

from slambench import harness
from slambench.run import FORBIDDEN, forbidden_modules


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("orbslam3_tpu_torch", "orbslam3_tpu_torch.slam.system", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in FORBIDDEN:
        sys.modules.pop(name, None)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "orbslam3_tpu.ops", sys)
    assert forbidden_modules() == ["orbslam3_tpu"]


def test_benchmark_loads_without_jax_or_the_jax_package():
    readers = [p.stem for p in (harness.HERE / "metrics").glob("*.py")]
    code = textwrap.dedent(f"""
        import importlib.abc, sys
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        import json
        import slambench.run, slambench.control, slambench.sweep
        from slambench import harness
        for p in (harness.HERE / "configs").glob("*.json"):
            harness.sensor_of(json.load(open(p)))
        for m in {readers!r}:
            harness.reader_of(m)
        import orbslam3_tpu_torch.slam.system, orbslam3_tpu_torch.vocab.vocabulary
        import orbslam3_tpu_torch.utils.benchmark
        from slambench.run import forbidden_modules
        assert forbidden_modules() == [], forbidden_modules()
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
