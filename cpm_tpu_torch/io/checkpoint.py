"""Checkpoint save/load of the progressive photon-mapping state, in the
reference's file format (``cpm_tpu/io/checkpoint.py``), so a checkpoint
either package wrote loads in the other.

Format: one ``.npz`` holding the state's arrays as ``leaf_NNN`` in the
field order of ``PhotonMapState`` (photons, light samples, light volumes,
key, drain bookkeeping, then ``prev_minmax`` where there is one) plus a
JSON header with the configuration. The configurations and the whole state
are saved, so a resumed run continues bit-identically. Scene content
(volume, TFs, lights, camera) is not part of a checkpoint.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from cpm_tpu_torch.core import config as config_mod
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.pipeline.state import PhotonMapState

_HEADER_KEY = "__cpm_header__"
_FORMAT_VERSION = 1

# The state's leaves in file order; ``prev_minmax`` follows when present.
LEAF_ORDER = (
    "photons.positions", "photons.powers", "photons.directions",
    "photons.exit_power", "photons.exit_direction", "photons.radius_rel",
    "photons.scene_radius", "photons.iteration",
    "light_samples.origins", "light_samples.directions",
    "light_samples.powers", "light_samples.tspan", "light_samples.iteration",
    "light_volume", "light_volume_accum", "key", "retraced", "n_remaining",
    "recompute_phase")


def _config_from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in names})


def _normalize(path: str) -> str:
    """np.savez appends '.npz' to a path without it; save and load agree
    on the name on disk."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: PhotonMapState,
                    config: config_mod.PipelineConfig) -> None:
    """Write state + config to ``path`` (.npz appended if missing)."""
    leaves = convert.state_to_numpy(state)
    order = LEAF_ORDER + (("prev_minmax",) if "prev_minmax" in leaves else ())
    arrays = {f"leaf_{i:03d}": np.asarray(leaves[k])
              for i, k in enumerate(order)}
    header = {
        "version": _FORMAT_VERSION,
        "n_leaves": len(order),
        "has_prev_minmax": "prev_minmax" in leaves,
        "config": {
            "photons_x": config.photons_x,
            "photons_y": config.photons_y,
            "tracer": dataclasses.asdict(config.tracer),
            "splat": dataclasses.asdict(config.splat),
            "recompute": dataclasses.asdict(config.recompute),
            "render": dataclasses.asdict(config.render),
        },
    }
    arrays[_HEADER_KEY] = np.frombuffer(json.dumps(header).encode(),
                                        dtype=np.uint8)
    np.savez(_normalize(path), **arrays)


def load_checkpoint(path: str, device=None):
    """Read (state, config) back; the state's tensors land on the card
    unless ``device`` names another, and the photon fields keep their
    saved float type (float16 storage loads as float16)."""
    with np.load(_normalize(path)) as z:
        header = json.loads(bytes(z[_HEADER_KEY].tobytes()).decode())
        if header["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {header['version']}")
        order = LEAF_ORDER + (("prev_minmax",)
                              if header.get("has_prev_minmax") else ())
        if header["n_leaves"] != len(order):
            raise ValueError(
                f"checkpoint has {header['n_leaves']} leaves, expected "
                f"{len(order)} for this state")
        leaves = {k: z[f"leaf_{i:03d}"] for i, k in enumerate(order)}

    hc = header["config"]
    config = config_mod.PipelineConfig(
        photons_x=hc["photons_x"], photons_y=hc["photons_y"],
        tracer=_config_from_dict(config_mod.TracerConfig, hc["tracer"]),
        splat=_config_from_dict(config_mod.SplatConfig, hc["splat"]),
        recompute=_config_from_dict(config_mod.RecomputeConfig,
                                    hc["recompute"]),
        render=_config_from_dict(config_mod.RenderConfig, hc["render"]))
    return convert.state_from_numpy(leaves, device=device), config
