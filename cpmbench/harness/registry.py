"""Where the harness finds a cell's pieces: ``BENCHMARK.json`` at the root
of the checkout names the cells, metrics and configurations, and every
piece is a file of its own under ``cpmbench/``, found by its name:

- ``configs/<config>.json``: the configuration's sizes;
- ``traffic/<mix>.json``: the traffic mix's parameters, a list of steps
  that the one generator (:mod:`cpmbench.harness.session`) drives;
- ``ops/<op>.py``: a step a mix may name, with the program's call, the
  reference's and the check of what it produced (:mod:`cpmbench.ops`);
- ``lights/<type>.py``: a light type a configuration may name, built for
  either side;
- ``data/<kind>.py``: a volume kind a configuration may name, made on the
  device from the run's seed;
- ``metrics/<metric>.py``: the metric's reader, ``read(run)``, and the
  spans it reads, ``SPANS``;
- ``limits/<workload>.json``: the numbers a cell compares and their limits.

Adding a configuration, a mix, a step, a light, a volume kind or a metric
adds files and entries; no existing file changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Registry:
    """The benchmark rooted at ``root`` (the directory that holds
    ``BENCHMARK.json`` and ``cpmbench/``)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json in {self.root}")
        self.bench = json.loads(path.read_text())
        self._modules: dict = {}

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        path = self.root / "cpmbench" / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        return json.loads(path.read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)["limits"]

    def metrics(self, workload: str, traced: bool) -> list[dict]:
        """The metric entries a run of ``workload`` reports: the per-layer
        ones with ``traced``, else the end-to-end ones; an entry with a
        ``workloads`` key only in the cells it lists."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])]

    def module(self, kind: str, name: str):
        """The module ``cpmbench/<kind>/<name>.py`` of this root, loaded
        once."""
        path = self.root / "cpmbench" / kind / f"{name}.py"
        if (kind, name) not in self._modules:
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} module {path} for "
                                        f"{name!r}")
            tag = hashlib.sha1(str(path).encode()).hexdigest()[:10]
            mod_name = f"cpmbench_{kind}_{name}_{tag}".replace(
                ".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module
            spec.loader.exec_module(module)
            self._modules[kind, name] = module
        return self._modules[kind, name]

    def reader(self, metric: str):
        """The ``read`` function of ``cpmbench/metrics/<metric>.py``."""
        return self.module("metrics", metric).read

    def op(self, name: str):
        return self.module("ops", name)

    def light(self, kind: str):
        return self.module("lights", kind)

    def volume(self, kind: str):
        return self.module("data", kind)
