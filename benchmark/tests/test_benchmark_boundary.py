"""Nothing the benchmark runs on the card loads JAX or the JAX package, and
the plain reference loads nothing of the measured program. Top-level
module names are compared whole: ws3d_tpu_torch begins with ws3d_tpu."""
from __future__ import annotations

import json
import subprocess
import sys

from benchmark.tests.helpers import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "ws3d_tpu")


def loaded_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); {imports}; "
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_program_load_no_jax():
    tops = loaded_after(
        "import benchmark.run, benchmark.harness, benchmark.trace, "
        "benchmark.calibrate, benchmark.drivers.infer_loop, "
        "benchmark.drivers.train_loop, benchmark.reference.pipeline, "
        "benchmark.reference.train, benchmark.reference.compare, "
        "ws3d_tpu_torch.pipeline, ws3d_tpu_torch.training.trainer, "
        "ws3d_tpu_torch.models, ws3d_tpu_torch.weights")
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
    assert "ws3d_tpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = loaded_after(
        "import benchmark.reference.net, benchmark.reference.pipeline, "
        "benchmark.reference.train, benchmark.reference.loader, "
        "benchmark.reference.compare, benchmark.reference.optim, "
        "benchmark.gen.scenes, benchmark.gen.proposals, "
        "benchmark.roofline.counts")
    assert not tops & (set(FORBIDDEN) | {"ws3d_tpu_torch"})


def test_the_run_checks_the_whole_top_level_name(monkeypatch):
    import types
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "ws3d_tpu_torch.fake",
                        types.ModuleType("ws3d_tpu_torch.fake"))
    assert harness.jax_modules() == []
    monkeypatch.setitem(sys.modules, "ws3d_tpu.fake",
                        types.ModuleType("ws3d_tpu.fake"))
    assert harness.jax_modules() == ["ws3d_tpu"]
