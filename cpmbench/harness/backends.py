"""The two sides a cell can run on: the program (``cpm_tpu_torch``'s entry
points, what the benchmark times) and the plain reference
(:mod:`cpmbench.reference.pipeline`), which serves as the program's
control when it computes in a lower precision.

A side builds the scene from the benchmark's inputs (a configuration's
sizes, the seeded volume, TF points, a camera, lights through their
modules in ``cpmbench/lights/``) and makes the start a run steps from: a
fresh state and its first full trace. Everything a traffic mix does after
that is a step module's (``cpmbench/ops/``), which calls the side's own
functions: :attr:`ProgramBackend.step` and :attr:`ReferenceBackend.P`.
States and photon maps are the side's own objects; the checks read their
fields by name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

Tensor = torch.Tensor


def _tf_points(cfg: dict):
    """(positions, colours, scattering colours) as float32 numpy arrays:
    the scattering TF's opacity sets the albedo a / (a + opacity)."""
    pos = np.asarray(cfg["tf"]["positions"], np.float32)
    col = np.asarray(cfg["tf"]["colors"], np.float32)
    albedo = float(cfg["scattering_albedo"])
    scat = col.copy()
    scat[:, 3] = col[:, 3] * albedo / max(1.0 - albedo, 1e-3)
    return pos, col, scat


def pipeline_config(C, cfg: dict):
    """The ``PipelineConfig`` of configuration ``cfg`` from the config
    module ``C`` (the program's ``core/config.py`` or the reference's
    frozen copy, field for field the same)."""
    rc = cfg["recompute"]
    return C.PipelineConfig(
        photons_x=cfg["photons_x"], photons_y=cfg["photons_y"],
        tracer=C.TracerConfig(max_interactions=cfg["max_interactions"],
                              max_steps=cfg["max_steps"],
                              brick_scale=cfg.get("brick_scale", 2)),
        recompute=C.RecomputeConfig(
            max_photons_fraction=rc["max_photons_fraction"],
            importance_quadrature_samples=rc["importance_quadrature_samples"],
            grid_cell_size=rc["grid_cell_size"]),
        render=C.RenderConfig(width=cfg["image"]["width"],
                              height=cfg["image"]["height"]),
        guided_emission=bool(cfg.get("guided_emission", False)))


class _Side:
    """What both sides share: lights through their modules, and scene
    edits by ``dataclasses.replace``."""

    kind = ""

    def __init__(self, cfg: dict, device, registry):
        self.cfg, self.registry = cfg, registry
        self.device = torch.device(device)

    def light(self, spec: dict):
        make = getattr(self.registry.light(spec["type"]), self.kind)
        return make(self._Light, spec)

    def lights(self, specs) -> tuple:
        return tuple(self.light(s) for s in specs)

    def with_tf(self, scene, positions: np.ndarray, colors: np.ndarray):
        return dataclasses.replace(scene, tf=self._TF.from_points(
            positions, colors, device=self.device))

    def with_camera(self, scene, camera: dict):
        return dataclasses.replace(scene, camera=self.camera(camera))

    def with_lights(self, scene, specs):
        return dataclasses.replace(scene, lights=self._lights_type(
            self.lights(specs)))

    def camera(self, camera: dict):
        return self._Camera.create(
            eye=camera["eye"], center=camera["center"], up=camera["up"],
            fov_y=camera["fov_y"], device=self.device)


class ProgramBackend(_Side):
    """``cpm_tpu_torch`` driven through its entry points, as an
    application would drive it: :attr:`step` is its
    ``pipeline/step.py``, :attr:`flags` its ``DirtyFlags``."""

    kind = "program"

    def __init__(self, cfg: dict, device, registry):
        super().__init__(cfg, device, registry)
        from cpm_tpu_torch.core import config as C
        from cpm_tpu_torch.core.camera import Camera
        from cpm_tpu_torch.core.lights import Light
        from cpm_tpu_torch.core.scene import Scene
        from cpm_tpu_torch.core.types import TransferFunction, Volume
        from cpm_tpu_torch.pipeline import step
        from cpm_tpu_torch.pipeline.state import DirtyFlags
        self._Camera, self._Light, self._Scene = Camera, Light, Scene
        self._TF, self._Volume = TransferFunction, Volume
        self._lights_type = list
        self.step, self.flags = step, DirtyFlags
        self.config = pipeline_config(C, cfg)

    def scene(self, volume: Tensor, camera: dict):
        pos, col, scat = _tf_points(self.cfg)
        return self._Scene.create(
            self._Volume.from_data(volume, device=self.device),
            self._TF.from_points(pos, col, device=self.device),
            self._TF.from_points(pos, scat, device=self.device),
            list(self.lights(self.cfg["lights"])), self.camera(camera))

    def init_state(self, scene, seed: int):
        grid = None
        if self.config.guided_emission:
            grid = self.step.build_importance_grid(scene, self.config)
        return self.step.init_state(scene, self.config, seed=seed,
                                    importance_grid=grid)

    def full_trace_step(self, scene, state):
        return self.step.full_trace_step(scene, state, self.config)


@dataclass
class RefState:
    """The reference's state: what the port's ``PhotonMapState`` holds
    that the checks read."""

    photons: object
    light_samples: object
    light_volume: Tensor
    light_volume_accum: Tensor
    key: tuple
    retraced: Tensor


class ReferenceBackend(_Side):
    """The plain reference in the program's place: the control of a cell
    when ``precision`` (a :class:`cpmbench.reference.pipeline.Precision`)
    is below the exact one. :attr:`P` is its pipeline, :attr:`p` the
    precision."""

    kind = "reference"

    def __init__(self, cfg: dict, device, registry, precision=None):
        super().__init__(cfg, device, registry)
        from cpmbench.reference import config as C
        from cpmbench.reference import pipeline as P
        from cpmbench.reference.camera import Camera
        from cpmbench.reference.lights import Light
        from cpmbench.reference.types import TransferFunction, Volume
        self._Camera, self._Light = Camera, Light
        self._TF, self._Volume = TransferFunction, Volume
        self._lights_type = tuple
        self.P = P
        self.p = precision or P.EXACT
        self.config = pipeline_config(C, cfg)

    def scene(self, volume: Tensor, camera: dict):
        pos, col, scat = _tf_points(self.cfg)
        return self.P.Scene(
            volume=self._Volume.from_data(volume, device=self.device),
            tf=self._TF.from_points(pos, col, device=self.device),
            tf_scattering=self._TF.from_points(pos, scat,
                                               device=self.device),
            lights=self.lights(self.cfg["lights"]),
            camera=self.camera(camera))

    def init_state(self, scene, seed: int):
        grid = (self.P.build_importance_grid(scene, self.config)
                if self.config.guided_emission else None)
        key, samples = self.P.light_samples(scene, self.config, seed, grid)
        return RefState(photons=None, light_samples=samples,
                        light_volume=None, light_volume_accum=None, key=key,
                        retraced=torch.zeros(samples.n, dtype=torch.bool,
                                             device=self.device))

    def full_trace_step(self, scene, state, counts: bool = False):
        out = self.P.full_trace(scene, state.light_samples, state.key,
                                self.config, p=self.p, counts=counts)
        new = dataclasses.replace(state, photons=out[0], light_volume=out[1],
                                  light_volume_accum=out[1])
        return (new, out[2]) if counts else new
