"""Carry scenes and pipeline state across from the reference package as
numpy arrays.

Leaves are keyed by the reference objects' field paths, e.g.
``photons.positions``, ``light_samples.tspan``, ``tf.colors``. A reference
``Scene``/``PhotonMapState`` flattened to such a dict builds the port's
objects, so both packages can start from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.device import resolve
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      TransferFunction, Volume)
from cpm_tpu_torch.ops.tracer import TraceEvents
from cpm_tpu_torch.pipeline.state import PhotonMapState

_PHOTON_ARRAYS = ("positions", "powers", "directions", "exit_power",
                  "exit_direction")
_SAMPLE_ARRAYS = ("origins", "directions", "powers", "tspan")


def _tensor(a, device, keep_float: bool = False) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device``: floats become float32
    unless ``keep_float`` keeps their saved type (photon fields, which may
    be stored in float16)."""
    a = np.asarray(a)
    float32 = a.dtype.kind == "f" and not keep_float
    a = np.array(a, dtype=np.float32 if float32 else a.dtype, order="C",
                 copy=True)
    return torch.from_numpy(a).to(device)


def scene_from_numpy(leaves: dict, lights, device=None) -> Scene:
    """The port's Scene from ``volume.*``, ``tf.*``, ``tf_scattering.*`` and
    ``camera.*`` arrays, on the card unless ``device`` names another;
    ``lights`` are host-side ``Light`` objects (the port's or the
    reference's: emission reads only their fields)."""
    device = resolve(device)
    def tf(prefix):
        return TransferFunction(
            positions=_tensor(leaves[f"{prefix}.positions"], device),
            colors=_tensor(leaves[f"{prefix}.colors"], device),
            lut=_tensor(leaves[f"{prefix}.lut"], device))

    volume = Volume(data=_tensor(leaves["volume.data"], device),
                    basis=_tensor(leaves["volume.basis"], device),
                    offset=_tensor(leaves["volume.offset"], device))
    camera = Camera(eye=_tensor(leaves["camera.eye"], device),
                    center=_tensor(leaves["camera.center"], device),
                    up=_tensor(leaves["camera.up"], device),
                    fov_y=float(np.float32(leaves["camera.fov_y"])))
    return Scene(volume=volume, tf=tf("tf"),
                 tf_scattering=tf("tf_scattering"), camera=camera,
                 lights=tuple(lights))


def photons_from_numpy(leaves: dict, device=None) -> PhotonData:
    """The port's PhotonData from the reference's ``photons.*`` arrays, on
    the card unless ``device`` names another; the photon fields keep their
    float type."""
    device = resolve(device)
    return PhotonData(
        **{f: _tensor(leaves[f"photons.{f}"], device, keep_float=True)
           for f in _PHOTON_ARRAYS},
        radius_rel=float(np.float32(leaves["photons.radius_rel"])),
        scene_radius=float(np.float32(leaves["photons.scene_radius"])),
        iteration=int(leaves["photons.iteration"]))


def samples_from_numpy(leaves: dict, device=None) -> LightSamples:
    """The port's LightSamples from the reference's ``light_samples.*``
    arrays, on the card unless ``device`` names another."""
    device = resolve(device)
    return LightSamples(
        **{f: _tensor(leaves[f"light_samples.{f}"], device)
           for f in _SAMPLE_ARRAYS},
        iteration=int(leaves["light_samples.iteration"]))


def state_from_numpy(leaves: dict, device=None) -> PhotonMapState:
    """The port's PhotonMapState from the reference state's arrays, on the
    card unless ``device`` names another. Photon fields keep their float
    type (float16 storage stays float16); every other float leaf is
    float32."""
    device = resolve(device)
    photons = photons_from_numpy(leaves, device)
    samples = samples_from_numpy(leaves, device)
    key = np.asarray(leaves["key"]).astype(np.uint32)
    prev = leaves.get("prev_minmax")
    return PhotonMapState(
        photons=photons, light_samples=samples,
        light_volume=_tensor(leaves["light_volume"], device),
        light_volume_accum=_tensor(leaves["light_volume_accum"], device),
        key=(int(key[0]), int(key[1])),
        retraced=_tensor(leaves["retraced"], device).to(torch.bool),
        n_remaining=int(leaves["n_remaining"]),
        recompute_phase=int(leaves["recompute_phase"]),
        prev_minmax=None if prev is None else _tensor(prev, device))


def events_from_numpy(leaves: dict, device=None) -> TraceEvents:
    """The port's TraceEvents from the reference tape's ``events.*``
    arrays, on the card unless ``device`` names another: positions and
    majorants float32, types and counts int32."""
    device = resolve(device)

    def ints(name):
        return torch.from_numpy(np.array(leaves[f"events.{name}"],
                                         dtype=np.int32)).to(device)

    return TraceEvents(
        positions=_tensor(leaves["events.positions"], device),
        majorants=_tensor(leaves["events.majorants"], device),
        types=ints("types"), counts=ints("counts"))


def state_to_numpy(state: PhotonMapState) -> dict:
    """The inverse of :func:`state_from_numpy`."""
    def arr(t):
        return t.detach().cpu().numpy()

    ph, ls = state.photons, state.light_samples
    out = {f"photons.{f}": arr(getattr(ph, f)) for f in _PHOTON_ARRAYS}
    out.update({
        "photons.radius_rel": np.float32(ph.radius_rel),
        "photons.scene_radius": np.float32(ph.scene_radius),
        "photons.iteration": np.int32(ph.iteration),
    })
    out.update({f"light_samples.{f}": arr(getattr(ls, f))
                for f in _SAMPLE_ARRAYS})
    out.update({
        "light_samples.iteration": np.int32(ls.iteration),
        "light_volume": arr(state.light_volume),
        "light_volume_accum": arr(state.light_volume_accum),
        "key": np.asarray(state.key, np.uint32),
        "retraced": arr(state.retraced),
        "n_remaining": np.int32(state.n_remaining),
        "recompute_phase": np.int32(state.recompute_phase),
    })
    if state.prev_minmax is not None:
        out["prev_minmax"] = arr(state.prev_minmax)
    return out
