"""What the benchmark's processes load: the reference nothing of the
program, and neither the reference nor the harness JAX or the JAX
package, compared by whole top-level names (``cpm_tpu_torch`` is not
``cpm_tpu``)."""

import json
import subprocess
import sys

from cpmbench.tests.conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import importlib
for m in {modules!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""

REFERENCE = ["cpmbench.reference." + m for m in (
    "pipeline", "tracer", "splat", "sweep_render", "emit", "importance",
    "path_importance", "select", "minmax", "majorant", "rng", "sampling")]
HARNESS = ["cpmbench.harness." + m for m in (
    "cell", "backends", "check", "session", "registry", "spans",
    "devtrace", "stats")] + ["cpmbench.roofline.sweep",
                             "cpmbench.roofline.trace"] + [
    f"cpmbench.{p.parent.name}.{p.stem}"
    for d in ("ops", "lights", "data")
    for p in sorted((ROOT / "cpmbench" / d).glob("*.py"))
    if p.stem != "__init__"]


def loaded(modules) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                           modules=modules)],
        capture_output=True, text=True, check=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program_or_jax():
    names = loaded(REFERENCE)
    assert not names & {"cpm_tpu_torch", "cpm_tpu", "jax", "jaxlib", "flax"}
    assert "cpmbench" in names


def test_harness_loads_no_jax_nor_the_jax_package():
    names = loaded(HARNESS + ["cpm_tpu_torch.pipeline.step"])
    assert "cpm_tpu_torch" in names
    assert not names & {"cpm_tpu", "jax", "jaxlib", "flax"}
