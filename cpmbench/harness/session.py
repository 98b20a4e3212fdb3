"""The benchmark's one traffic generator: it reads a traffic mix's
parameters (``cpmbench/traffic/<mix>.json``) and drives a side through the
mix's steps, one interaction at a time, with every input drawn from the
run's seed.

A mix is a closed loop: an interaction's steps run in order, the caller
waits for the card after the last one, and the next interaction starts
when it is done. Each step names its module, ``cpmbench/ops/<op>.py``
(:mod:`cpmbench.ops` sets out what one holds); the step's other keys are
its parameters.

An interaction chosen for the check keeps, by reference, what the check
needs: per step, the fields its module's ``check`` reads.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Record:
    """What the check reads of one interaction: its index and, per step,
    (op, fields)."""

    index: int
    steps: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Step:
    """One step of the mix: its module, its parameters, and what the
    module keeps from one interaction to the next."""

    name: str
    op: object
    params: dict
    mem: dict = dataclasses.field(default_factory=dict)


class Session:
    """One cell's run: its configuration ``cfg``, traffic ``mix`` and
    ``seed`` on ``side`` (a :mod:`cpmbench.harness.backends` side), with
    the step modules from ``registry``.

    What the steps share: ``scene`` and ``state``, the current TF points
    (``tf_pos``, ``tf_col``) and ``camera``; ``draws``, the stream every
    input is drawn from, and ``picks``, the check's; ``counts``, what the
    window did, by name, for the metrics; ``notes``, what a traced window
    keeps for them (``traced`` is set)."""

    def __init__(self, side, cfg: dict, mix: dict, seed: int, device,
                 registry):
        self.side, self.cfg, self.mix = side, cfg, mix
        self.registry = registry
        self.seed = int(seed)
        self.device = torch.device(device)
        self.draws = np.random.default_rng([self.seed, 0])
        self.picks = np.random.default_rng([self.seed, 1])
        self.counts = collections.Counter()
        self.notes = collections.defaultdict(list)
        self.traced = False
        self.steps = [Step(s["op"], registry.op(s["op"]), s)
                      for s in mix["steps"]]
        self.start = self.scene = self.state = None

    def on(self, program, reference):
        """``program`` or ``reference``, whichever is this side's, with
        the side bound as its first argument."""
        fn = program if self.side.kind == "program" else reference
        return lambda *args, **kwargs: fn(self.side, *args, **kwargs)

    # --- set-up ---------------------------------------------------------

    def setup(self):
        """The inputs from the seed, the scene, a fresh state and its
        first full trace (the start the check follows from), then each
        step module's own set-up."""
        vol = self.cfg["volume"]
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        self.volume = self.registry.volume(vol["kind"]).make(
            vol, g, self.device).contiguous()
        self.tf_pos = np.asarray(self.cfg["tf"]["positions"], np.float32)
        self.tf_col = np.asarray(self.cfg["tf"]["colors"], np.float32)
        self.camera = dict(self.cfg["camera"])
        self.lights = [dict(s) for s in self.cfg["lights"]]
        self.scene = self.side.scene(self.volume, self.camera)
        self.state = self.side.init_state(self.scene,
                                          program_seed(self.seed))
        self.state = self.side.full_trace_step(self.scene, self.state)
        self.start = self.state
        for step in self.steps:
            if hasattr(step.op, "setup"):
                step.op.setup(self, step)

    # --- one interaction ------------------------------------------------

    def interaction(self, record: Record | None = None) -> Record | None:
        """Run one interaction's steps; the caller waits for the card.
        ``ctx`` carries what one step hands the next within it."""
        ctx: dict = {}
        for step in self.steps:
            if self.traced:
                with torch.profiler.record_function(
                        f"cpmbench.op.{step.name}"):
                    step.op.run(self, step, ctx, record)
            else:
                step.op.run(self, step, ctx, record)
        self.counts["interactions"] += 1
        return record


class Reservoir:
    """A uniform sample of ``size`` interactions of the window, drawn from
    the session's seeded stream before each interaction runs."""

    def __init__(self, size: int, picks: np.random.Generator):
        self.size, self.picks = size, picks
        self.kept: list = []
        self.seen = 0

    def record(self) -> Record | None:
        """A record for the next interaction if the sample takes it."""
        self.seen += 1
        rec = Record(index=self.seen - 1)
        if len(self.kept) < self.size:
            self.kept.append(rec)
            return rec
        j = int(self.picks.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = rec
            return rec
        return None


def program_seed(seed: int) -> int:
    """The program's state seed (a 32-bit signed int) from the run's."""
    return int(seed) % (1 << 31)
