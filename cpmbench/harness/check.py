"""The comparison that decides ``correct``: the plain reference
(:mod:`cpmbench.reference`, exact float32) works out again what the timed
path produced, from the same inputs, and each number compared is held to
its limit (``cpmbench/limits/<workload>.json``).

What is compared, at the timed sizes: the start, the set-up's full trace
(emission, guided where the configuration says so, the trace and the
splat) from the seed; then each interaction the session kept, step by
step, by the ``check`` of the step's module (``cpmbench/ops/``); then,
for the steps whose module has a ``final``, the window's last state.

The numbers, each the largest over the comparisons of a run:

- ``photons_differ``: the share of light samples whose stored photons
  (positions, powers, directions, exit power and direction) differ in any
  bit from the reference's;
- ``light_volume_err``: max |program - reference| / max |reference| of
  the light volume;
- ``accum_err``: the same of the progressive running mean;
- ``image_err``: the same of the sampled image rows (all four channels);
- ``drift_err``: the same of the last state's light volume, which the
  window's correlated batches updated in place, against the reference's
  splat of the last photon map.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

PHOTON_FIELDS = ("positions", "powers", "directions")
LANE_FIELDS = ("exit_power", "exit_direction")


def lanes_differ(got, want) -> float:
    """The share of lanes whose photons differ in any bit (NaN equals
    NaN) between two photon maps of the same shape."""
    n = want.positions.shape[1]
    if got.positions.shape != want.positions.shape:
        return 1.0
    diff = torch.zeros(n, dtype=torch.bool, device=want.positions.device)

    def unequal(a, b):
        a, b = a.to(torch.float32), b.to(torch.float32)
        return (a != b) & ~(torch.isnan(a) & torch.isnan(b))

    for f in PHOTON_FIELDS:
        diff |= unequal(getattr(got, f), getattr(want, f)).any(2).any(0)
    for f in LANE_FIELDS:
        d = unequal(getattr(got, f), getattr(want, f))
        diff |= d if d.dim() == 1 else d.any(1)
    return float(diff.sum()) / max(n, 1)


def same_tf(a, b) -> bool:
    """Whether two TFs' (positions, colours) are the same points."""
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def rel_err(got: Tensor, want: Tensor) -> float:
    """max |got - want| / max |want|; infinite where the shapes or the
    NaNs disagree."""
    if got.shape != want.shape:
        return math.inf
    g, w = got.to(torch.float32), want.to(torch.float32)
    if bool((torch.isnan(g) != torch.isnan(w)).any()):
        return math.inf
    d = torch.nan_to_num(g - w, nan=0.0, posinf=math.inf, neginf=math.inf)
    scale = float(torch.nan_to_num(w, nan=0.0).abs().max()) if w.numel() else 0
    return float(d.abs().max()) / max(scale, 1e-30) if d.numel() else 0.0


class Checker:
    """Works the kept interactions of ``session`` out again through the
    exact reference and gathers the numbers compared.

    What a step module's ``check`` uses: ``ref``, the exact reference
    side; ``base``, its scene as configured; ``start``, its state after
    the set-up's full trace; :meth:`scene` and :meth:`full_trace` for the
    scene a step saw; ``picks``, the seeded stream samples are drawn from;
    ``carry``, what one check hands the next within an interaction (a
    ``light_volume`` the reference made); :meth:`note`."""

    def __init__(self, session):
        from cpmbench.harness.backends import ReferenceBackend
        self.s = session
        self.device = session.device
        self.ref = ReferenceBackend(session.cfg, session.device,
                                    session.registry)
        self.picks = session.picks
        self.numbers: dict = {}
        self.trace_work: dict | None = None
        self.carry: dict = {}
        self._traces: list = []

    def note(self, name: str, value: float) -> None:
        self.numbers[name] = max(self.numbers.get(name, 0.0), float(value))

    def scene(self, tf=None, camera=None, lights=None):
        """The reference's scene as configured, with the TF points
        (positions, colours), the camera or the lights given."""
        scene = self.base
        if tf is not None:
            scene = self.ref.with_tf(scene, *tf)
        if camera is not None:
            scene = self.ref.with_camera(scene, camera)
        if lights is not None:
            scene = self.ref.with_lights(scene, lights)
        return scene

    def full_trace(self, tf=None, lights=None):
        """The reference's full trace of the start's samples and streams
        in the scene with ``tf`` and ``lights``: the start where they are
        the configured ones."""
        cfg = self.s.cfg
        tf = tf or (np.asarray(cfg["tf"]["positions"], np.float32),
                    np.asarray(cfg["tf"]["colors"], np.float32))
        lights = lights or cfg["lights"]
        for (t, ls), state in self._traces:
            if same_tf(t, tf) and ls == lights:
                return state
        state = self.ref.full_trace_step(self.scene(tf=tf, lights=lights),
                                         self.start)
        self._traces = self._traces[:1] + [((tf, lights), state)]
        return state

    def run(self, kept: list, final_state) -> dict:
        """The numbers of the start, the records ``kept`` and the window's
        last state ``final_state``."""
        from cpmbench.harness.session import program_seed
        s, ref = self.s, self.ref
        self.base = ref.scene(s.volume, dict(s.cfg["camera"]))
        state0 = ref.init_state(self.base, program_seed(s.seed))
        self.start, self.trace_work = ref.full_trace_step(
            self.base, state0, counts=True)
        configured = ((np.asarray(s.cfg["tf"]["positions"], np.float32),
                       np.asarray(s.cfg["tf"]["colors"], np.float32)),
                      s.cfg["lights"])
        self._traces = [(configured, self.start)]
        self.note("photons_differ", lanes_differ(s.start.photons,
                                                 self.start.photons))
        self.note("light_volume_err", rel_err(s.start.light_volume,
                                              self.start.light_volume))
        for rec in kept:
            self.carry = {}
            for op, fields in rec.steps:
                s.registry.op(op).check(self, fields)
        for step in s.steps:
            if hasattr(step.op, "final"):
                step.op.final(self, step, final_state)
        return self.numbers


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number compared at or
    under its limit, and every limit's number present."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None:
            ok = False
            out[name] = {"value": None, "limit": limit}
            continue
        ok = ok and value <= limit
        out[name] = {"value": value, "limit": limit}
    return ok, out
