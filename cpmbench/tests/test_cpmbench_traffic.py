"""The traffic generator: the same seed gives the same inputs, another
seed others, and the reservoir's sample is drawn from the seed."""

import dataclasses

import numpy as np

from cpmbench.harness.registry import Registry
from cpmbench.harness.session import Reservoir, Session


@dataclasses.dataclass
class Inputs:
    """A side that only records the inputs it is handed."""

    seen: list = dataclasses.field(default_factory=list)
    kind: str = "program"

    def with_tf(self, scene, positions, colors):
        self.seen.append(("tf", positions.tolist(), colors.tolist()))
        return scene

    def with_camera(self, scene, camera):
        self.seen.append(("camera", list(camera["eye"])))
        return scene


# The steps that draw the traffic's inputs; the others call the side.
DRAWS = ("edit_tf", "orbit_camera")


def drive(traffic: str, seed: int, n: int = 20) -> list:
    reg = Registry()
    w = next(x for x in reg.bench["workloads"] if x["traffic"] == traffic)
    side = Inputs()
    mix = reg.traffic(traffic)
    mix = dict(mix, steps=[x for x in mix["steps"] if x["op"] in DRAWS])
    s = Session(side, reg.config(w["config"]), mix, seed, "cpu", reg)
    s.tf_pos = np.asarray(s.cfg["tf"]["positions"], np.float32)
    s.tf_col = np.asarray(s.cfg["tf"]["colors"], np.float32)
    s.camera = dict(s.cfg["camera"])
    s.scene = object()
    for _ in range(n):
        s.interaction()
    return side.seen


def test_tf_edits_repeat_by_seed_and_stay_bounded():
    a, b = drive("tf_edit", 2 ** 32 + 11), drive("tf_edit", 2 ** 32 + 11)
    assert a == b
    assert a != drive("tf_edit", 12)
    for _, pos, col in a:
        assert all(x < y for x, y in zip(pos, pos[1:]))
        assert all(0.0 <= c[3] <= 1.0 for c in col)


def test_orbits_repeat_by_seed_and_stay_outside_the_box():
    a, b = drive("orbit", 5), drive("orbit", 5)
    assert a == b
    assert a != drive("orbit", 6)
    for _, eye in a:
        assert np.linalg.norm(np.subtract(eye, 0.5)) > 1.9
        assert not all(0.0 <= e <= 1.0 for e in eye)


def test_reservoir_sample_repeats_by_seed():
    def kept(seed):
        r = Reservoir(2, np.random.default_rng([seed, 1]))
        for _ in range(500):
            r.record()
        return [k.index for k in r.kept]
    assert kept(3) == kept(3)
    assert len(set(kept(3))) == 2
    assert kept(3) != kept(4) or kept(3) != kept(5)
