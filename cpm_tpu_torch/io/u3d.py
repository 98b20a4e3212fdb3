"""UniformGrid3D ``.u3d`` file IO and Inviwo-style ``.dat``/``.raw`` volume IO.

Format parity with the reference's reader/writer pair
(modules/uniformgridcl/uniformgrid3dreader.cpp:58-185 /
uniformgrid3dwriter.cpp:47-105): a dat-style ASCII key:value header
(RawFile / Resolution (4D: grid dims + sequence count) / Format /
ModelMatrix / WorldMatrix / CellDimensions) next to a raw little-endian
binary blob holding the whole grid sequence.

Host-side numpy only: arrays become tensors at the pipeline boundary. The
port's own copy of ``cpm_tpu/io/u3d.py``; the tests hold the two against
each other, and each reads the other's files.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

# Inviwo DataFormat name -> numpy dtype and channel count
# (reference format strings produced by DataFormatBase::getString()).
_FORMATS = {
    "uint8": (np.uint8, 1), "int8": (np.int8, 1),
    "uint16": (np.uint16, 1), "int16": (np.int16, 1),
    "uint32": (np.uint32, 1), "int32": (np.int32, 1),
    "uint64": (np.uint64, 1), "int64": (np.int64, 1),
    "float16": (np.float16, 1), "float32": (np.float32, 1),
    "float64": (np.float64, 1),
}
for _n in (2, 3, 4):
    for _base, (_dt, _) in list(_FORMATS.items()):
        if not _base[-1].isdigit():
            continue
        _FORMATS.setdefault(f"vec{_n}{_base}", (_dt, _n))
_NUMPY_TO_FORMAT = {
    (np.dtype(np.uint8), 1): "UINT8", (np.dtype(np.uint16), 1): "UINT16",
    (np.dtype(np.uint32), 1): "UINT32", (np.dtype(np.float32), 1): "FLOAT32",
    (np.dtype(np.float64), 1): "FLOAT64",
    (np.dtype(np.uint16), 2): "Vec2UINT16", (np.dtype(np.float32), 2): "Vec2FLOAT32",
    (np.dtype(np.float32), 3): "Vec3FLOAT32", (np.dtype(np.float32), 4): "Vec4FLOAT32",
}


@dataclass
class GridFile:
    """A parsed .u3d file: a sequence of grids plus spatial metadata."""

    data: np.ndarray  # (T, gz, gy, gx[, C])
    cell_dimensions: tuple = (8, 8, 8)
    model_matrix: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    world_matrix: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))


def _parse_header(path: str) -> dict:
    kv = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in "#/":
                continue
            line = line.split("#")[0]
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            kv[key.strip().lower()] = value.strip()
    return kv


def _parse_format(name: str):
    fmt = _FORMATS.get(name.lower())
    if fmt is None:
        raise ValueError(f"unsupported data format {name!r}")
    return fmt


def _parse_mat4(value: str) -> np.ndarray:
    vals = [float(x) for x in re.split(r"\s+", value.strip())]
    if len(vals) != 16:
        raise ValueError(f"ModelMatrix/WorldMatrix needs 16 floats, got {len(vals)}")
    # The reference writes glm::transpose(mat) row-by-row -> file is row-major.
    return np.array(vals, np.float32).reshape(4, 4)


def read_u3d(path: str) -> GridFile:
    """Read a .u3d header + .raw blob into a GridFile.

    ``Resolution: gx gy gz count`` — the raw blob is ``count`` grids of
    x-fastest data (matching the reference's linear cell buffer layout).
    Returned array is (count, gz, gy, gx[, C]).
    """
    kv = _parse_header(path)
    raw_name = kv.get("rawfile") or kv.get("objectfilename")
    if raw_name is None:
        raise ValueError(f"{path}: missing RawFile")
    raw_path = os.path.join(os.path.dirname(os.path.abspath(path)), raw_name)
    gx, gy, gz, count = [int(x) for x in re.split(r"\s+", kv["resolution"])][:4]
    dtype, channels = _parse_format(kv.get("format", "float32"))
    blob = np.fromfile(raw_path, dtype=dtype)
    per = gx * gy * gz * channels
    count = max(count, 1)
    if blob.size < per * count:
        raise ValueError(
            f"{raw_path}: expected {per * count} values, found {blob.size}")
    shape = (count, gz, gy, gx) + ((channels,) if channels > 1 else ())
    data = blob[:per * count].reshape(shape)
    cell = tuple(int(x) for x in re.split(
        r"\s+", kv.get("celldimensions", "8 8 8")))[:3]
    out = GridFile(data=data, cell_dimensions=cell)
    if "modelmatrix" in kv:
        out.model_matrix = _parse_mat4(kv["modelmatrix"])
    if "worldmatrix" in kv:
        out.world_matrix = _parse_mat4(kv["worldmatrix"])
    return out


def write_u3d(path: str, grid: GridFile | np.ndarray, cell_dimensions=None,
              model_matrix=None, world_matrix=None) -> None:
    """Write a grid sequence as .u3d header + .raw blob
    (uniformgrid3dwriter.cpp:47-105 key set)."""
    if isinstance(grid, np.ndarray):
        grid = GridFile(data=grid,
                        cell_dimensions=cell_dimensions or (8, 8, 8))
    if cell_dimensions is not None:
        grid.cell_dimensions = tuple(cell_dimensions)
    if model_matrix is not None:
        grid.model_matrix = np.asarray(model_matrix, np.float32)
    if world_matrix is not None:
        grid.world_matrix = np.asarray(world_matrix, np.float32)

    data = np.asarray(grid.data)
    if data.ndim == 3:
        data = data[None]
    if data.ndim == 4:
        channels = 1
    elif data.ndim == 5:
        channels = data.shape[-1]
    else:
        raise ValueError(f"grid must be (T, gz, gy, gx[, C]); got {data.shape}")
    count, gz, gy, gx = data.shape[:4]
    fmt = _NUMPY_TO_FORMAT.get((data.dtype, channels))
    if fmt is None:
        raise ValueError(f"unsupported dtype/channels {data.dtype}/{channels}")

    base = os.path.splitext(path)[0]
    raw_path = base + ".raw"
    mm = " ".join(f"{x:g}" for x in np.asarray(grid.model_matrix).reshape(-1))
    wm = " ".join(f"{x:g}" for x in np.asarray(grid.world_matrix).reshape(-1))
    cd = " ".join(str(int(x)) for x in grid.cell_dimensions)
    with open(path, "w") as f:
        f.write(f"RawFile: {os.path.basename(raw_path)}\n")
        f.write(f"Resolution: {gx} {gy} {gz} {count}\n")
        f.write(f"Format: {fmt}\n")
        f.write(f"ModelMatrix: {mm}\n")
        f.write(f"WorldMatrix: {wm}\n")
        f.write(f"CellDimensions: {cd}\n")
    data.tofile(raw_path)


def read_dat_volume(path: str):
    """Read an Inviwo-style volume ``.dat`` header + ``.raw`` blob.

    Returns (data (D, H, W) float32 normalized to [0, 1], basis (3, 3),
    offset (3,)) ready for :class:`cpm_tpu.core.types.Volume`. Integer
    formats are normalized by their type range (the reference samples
    volumes through normalized textures, samplers.cl getNormalizedVoxel).
    """
    kv = _parse_header(path)
    raw_name = kv.get("rawfile") or kv.get("objectfilename")
    if raw_name is None:
        raise ValueError(
            f"{path}: .dat header has neither RawFile nor ObjectFileName")
    if "resolution" not in kv:
        raise ValueError(f"{path}: .dat header is missing Resolution")
    raw_path = os.path.join(os.path.dirname(os.path.abspath(path)), raw_name)
    w, h, d = [int(x) for x in re.split(r"\s+", kv["resolution"])][:3]
    dtype, channels = _parse_format(kv.get("format", "uint8"))
    if channels != 1:
        raise ValueError("volume .dat must be scalar")
    blob = np.fromfile(raw_path, dtype=dtype, count=w * h * d)
    if blob.size < w * h * d:
        raise ValueError(
            f"{raw_path}: raw blob holds {blob.size} values, expected "
            f"{w * h * d} for Resolution {w}x{h}x{d}")
    data = blob.reshape(d, h, w).astype(np.float32)
    if np.issubdtype(dtype, np.integer):
        data /= float(np.iinfo(dtype).max)
    basis = np.eye(3, dtype=np.float32) * 2.0
    offset = np.array([-1.0, -1.0, -1.0], np.float32)
    if "basisvector1" in kv:
        basis = np.stack([
            [float(x) for x in re.split(r"\s+", kv[f"basisvector{i}"])]
            for i in (1, 2, 3)], axis=1).astype(np.float32)
    if "offset" in kv:
        offset = np.array([float(x) for x in re.split(r"\s+", kv["offset"])],
                          np.float32)
    return data, basis, offset


def write_dat_volume(path: str, data: np.ndarray, basis=None, offset=None) -> None:
    """Write (D, H, W) data as .dat/.raw (uint16 if float in [0,1])."""
    data = np.asarray(data)
    d, h, w = data.shape
    if np.issubdtype(data.dtype, np.floating):
        blob = np.clip(data, 0.0, 1.0)
        blob = (blob * np.iinfo(np.uint16).max + 0.5).astype(np.uint16)
        fmt = "UINT16"
    else:
        blob = data
        fmt = {np.dtype(np.uint8): "UINT8",
               np.dtype(np.uint16): "UINT16"}[data.dtype]
    base = os.path.splitext(path)[0]
    raw_path = base + ".raw"
    with open(path, "w") as f:
        f.write(f"RawFile: {os.path.basename(raw_path)}\n")
        f.write(f"Resolution: {w} {h} {d}\n")
        f.write(f"Format: {fmt}\n")
        if basis is not None:
            b = np.asarray(basis)
            for i in range(3):
                f.write(f"BasisVector{i+1}: "
                        + " ".join(f"{x:g}" for x in b[:, i]) + "\n")
        if offset is not None:
            f.write("Offset: " + " ".join(f"{x:g}" for x in offset) + "\n")
    blob.tofile(raw_path)
