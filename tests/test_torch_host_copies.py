"""The port's own copies of the reference's numpy-only host modules
(constants, lights, lightplane, synthetic, u3d) and of the numpy function
``importance.tf_difference_points`` held against the originals so they
cannot drift (files either copy of u3d writes are read back equal by the
other), and the port's default device: tensors are made on the CUDA card
unless the caller names another device."""

import dataclasses
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cpm_tpu.core import constants as jconstants
from cpm_tpu.core import lights as jlights
from cpm_tpu.io import synthetic as jsynthetic
from cpm_tpu.io import u3d as ju3d
from cpm_tpu.ops import importance as jimportance
from cpm_tpu.ops import lightplane as jlightplane
from cpm_tpu_torch.core import camera as tcamera
from cpm_tpu_torch.core import constants as tconstants
from cpm_tpu_torch.core import device as tdevice
from cpm_tpu_torch.core import lights as tlights
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.io import synthetic as tsynthetic
from cpm_tpu_torch.io import u3d as tu3d
from cpm_tpu_torch.ops import importance as timportance
from cpm_tpu_torch.ops import intersect as tintersect
from cpm_tpu_torch.ops import lightplane as tlightplane
from cpm_tpu_torch.ops import rng as trng
from cpm_tpu_torch.ops import sampling as tsampling
from cpm_tpu_torch.pipeline import timevarying as ttimevarying

TESTS = Path(__file__).resolve().parent
PAIRS = {"constants": (jconstants, tconstants), "lights": (jlights, tlights),
         "lightplane": (jlightplane, tlightplane),
         "synthetic": (jsynthetic, tsynthetic), "u3d": (ju3d, tu3d)}


def _public(module, kind):
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and kind(v)
                  and getattr(v, "__module__", module.__name__)
                  == module.__name__)


def _is_value(v):
    return isinstance(v, (int, float, np.floating, np.integer))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_copy_has_the_originals_public_names(name):
    want, got = PAIRS[name]
    assert _public(got, _is_value) == _public(want, _is_value)
    assert _public(got, inspect.isfunction) == _public(want,
                                                       inspect.isfunction)
    assert _public(got, inspect.isclass) == _public(want, inspect.isclass)
    assert not any(m in vars(got) for m in ("jax", "jnp", "cpm_tpu"))


@pytest.mark.parametrize("name", ["constants", "lights"])
def test_copied_constants_are_equal(name):
    want, got = PAIRS[name]
    names = _public(want, _is_value)
    assert len(names) >= 4
    for n in names:
        a, b = getattr(want, n), getattr(got, n)
        assert type(a) is type(b) and a == b, n


@pytest.mark.parametrize("make", ["directional", "point", "cone",
                                  "cone_fov", "area", "default"])
def test_copied_light_constructors_field_for_field(make):
    args = {
        "directional": ("directional", ((0.3, -1.0, 0.2),),
                        dict(radiance=(1.0, 0.5, 0.25))),
        "point": ("point", ((0.1, 0.2, 0.3),), dict(radiance=(2, 3, 4))),
        "cone": ("cone", ((0.5, 2.0, 0.5), (0.0, -1.0, 0.1)), {}),
        "cone_fov": ("cone", ((0.5, 2.0, 0.5), (0.0, -1.0, 0.1)),
                     dict(cos_fov=0.7)),
        "area": ("area", ((0.5, 2.0, 0.5), (0.0, -2.0, 0.0)),
                 dict(size=(0.5, 0.25))),
    }
    if make == "default":
        want = jlights.Light(type=jlights.DIRECTIONAL)
        got = tlights.Light(type=tlights.DIRECTIONAL)
    else:
        fn, a, kw = args[make]
        want = getattr(jlights.Light, fn)(*a, **kw)
        got = getattr(tlights.Light, fn)(*a, **kw)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copied_lightplane_is_bit_equal(seed):
    rs = np.random.default_rng(seed)
    pts2 = rs.normal(size=(40, 2))
    hull_w = jlightplane.convex_hull_2d(pts2)
    hull_g = tlightplane.convex_hull_2d(pts2)
    np.testing.assert_array_equal(hull_g, hull_w)
    for a, b in zip(tlightplane.minimum_bounding_rectangle(hull_g),
                    jlightplane.minimum_bounding_rectangle(hull_w)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    corners_w = jlightplane.unit_box_corners(-0.25, 1.5)
    np.testing.assert_array_equal(tlightplane.unit_box_corners(-0.25, 1.5),
                                  corners_w)
    np.testing.assert_array_equal(tlightplane.unit_box_corners(),
                                  jlightplane.unit_box_corners())
    direction = rs.normal(size=3)
    direction /= np.linalg.norm(direction)
    for a, b in zip(tlightplane.fit_light_plane(corners_w, direction),
                    jlightplane.fit_light_plane(corners_w, direction)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn,args", [
    ("sphere_in_box", dict(dim=12, radius=0.35, center=(0.4, 0.5, 0.6))),
    ("smoke_cloud", dict(dim=16, seed=3)),
    ("smoke_cloud", dict(dim=12, seed=6, octaves=3)),
    ("time_varying_sequence", dict(dim=8, steps=3)),
    ("default_tf_points", {}),
    ("default_scattering_points", {}),
    ("default_scattering_points", dict(albedo=0.5)),
    ("ct_head_like", dict(dim=16)),
])
def test_copied_synthetic_is_bit_equal(fn, args):
    want = getattr(jsynthetic, fn)(**args)
    got = getattr(tsynthetic, fn)(**args)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["edit", "self", "other_points", "eps"])
def test_copied_tf_difference_points_is_bit_equal(case):
    rs = np.random.default_rng(7)
    pa = np.array([0.0, 0.2, 0.45, 0.55, 1.0], np.float32)
    ca = rs.random((5, 4)).astype(np.float32)
    pb, cb, kw = pa, ca.copy(), {}
    if case == "edit":
        cb[2:4] = rs.random((2, 4))
    elif case == "other_points":
        pb = np.array([0.0, 0.3, 0.5, 1.0], np.float32)
        cb = rs.random((4, 4)).astype(np.float32)
    elif case == "eps":
        cb = ca + np.float32(5e-4)
        kw = dict(eps=1e-3)
    want = jimportance.tf_difference_points(pa, ca, pb, cb, **kw)
    got = timportance.tf_difference_points(pa, ca, pb, cb, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert (got[1].max() > 0.0) == (case in ("edit", "other_points"))


# Each case of tests/test_io.py: (writer, data, keyword arguments).
U3D_CASES = {
    "scalar_sequence": ("write_u3d", lambda rs: rs.random(
        (4, 5, 6, 7)).astype(np.float32), dict(cell_dimensions=(8, 8, 8))),
    "minmax_vec2": ("write_u3d", lambda rs: rs.integers(
        0, 65535, (2, 3, 4, 5, 2)).astype(np.uint16),
        dict(cell_dimensions=(4, 4, 4))),
    "matrices": ("write_u3d", lambda rs: np.zeros((1, 2, 2, 2), np.float32),
                 dict(model_matrix=np.arange(16, dtype=np.float32).reshape(
                     4, 4), world_matrix=np.eye(4, dtype=np.float32) * 2)),
    "single_grid": ("write_u3d", lambda rs: rs.random(
        (3, 4, 5)).astype(np.float64), {}),
    "vec4": ("write_u3d", lambda rs: rs.random(
        (1, 2, 3, 4, 4)).astype(np.float32), {}),
    "dat_float": ("write_dat_volume", lambda rs: rs.random(
        (8, 9, 10)).astype(np.float32), {}),
    "dat_uint8": ("write_dat_volume", lambda rs: np.arange(
        8, dtype=np.uint8).reshape(2, 2, 2) * 32, {}),
    "dat_basis_offset": ("write_dat_volume", lambda rs: np.zeros(
        (2, 2, 2), np.float32), dict(
            basis=np.diag([1.0, 2.0, 3.0]).astype(np.float32),
            offset=np.array([-0.5, -1.0, -1.5], np.float32))),
}


@pytest.mark.parametrize("writer_is_port", [True, False])
@pytest.mark.parametrize("case", sorted(U3D_CASES))
def test_u3d_files_cross_between_the_copies(tmp_path, case, writer_is_port):
    """A file one copy writes, the other reads back equal, and as the
    writer's own reader does; both copies write the same bytes."""
    fn, make, kw = U3D_CASES[case]
    data = make(np.random.default_rng(0))
    writer, reader = (tu3d, ju3d) if writer_is_port else (ju3d, tu3d)
    ext = ".dat" if fn == "write_dat_volume" else ".u3d"
    path = str(tmp_path / f"a{ext}")
    getattr(writer, fn)(path, data, **kw)
    other = str(tmp_path / f"b{ext}")
    getattr(reader, fn)(other, data, **kw)
    for suffix in (ext, ".raw"):
        with open(path[:-4] + suffix, "rb") as f, \
                open(other[:-4] + suffix, "rb") as g:
            assert f.read().replace(b"a.raw", b"b.raw") == g.read(), suffix
    read = "read_dat_volume" if fn == "write_dat_volume" else "read_u3d"
    got, want = getattr(reader, read)(path), getattr(writer, read)(path)
    if read == "read_u3d":
        want_data = data[None] if data.ndim == 3 else data
        np.testing.assert_array_equal(got.data, want_data)
        assert got.cell_dimensions == want.cell_dimensions
        for m in ("model_matrix", "world_matrix"):
            np.testing.assert_array_equal(getattr(got, m), getattr(want, m))
            if m in kw:
                np.testing.assert_allclose(getattr(got, m), kw[m])
    else:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[0], data.astype(np.float32) / (
            255.0 if data.dtype == np.uint8 else 1.0), atol=1.0 / 65535)


# --- the default device -------------------------------------------------


def test_resolve_none_is_the_card():
    assert tdevice.resolve(None) == torch.device("cuda")
    assert tdevice.resolve() == torch.device("cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert tdevice.resolve("cuda:1") == torch.device("cuda", 1)
    assert tdevice.resolve(torch.device("cpu")) == torch.device("cpu")


CONSTRUCTORS = {
    "Volume.from_data": (ttypes, lambda **kw: ttypes.Volume.from_data(
        np.zeros((2, 2, 2), np.float32), **kw).data),
    "TransferFunction.from_points": (
        ttypes, lambda **kw: ttypes.TransferFunction.from_points(
            [0.0, 1.0], [(0, 0, 0, 0), (1, 1, 1, 1)], **kw).lut),
    "PhotonData.create": (ttypes, lambda **kw: ttypes.PhotonData.create(
        4, 2, **kw).positions),
    "Camera.create": (tcamera, lambda **kw: tcamera.Camera.create(**kw).eye),
    "stratified_grid_2d": (tsampling, lambda **kw:
                           tsampling.stratified_grid_2d(3, 2, **kw)),
    "rng.uniform": (trng, lambda **kw: trng.uniform((0, 1), (3, 2), **kw)),
    "VolumeSequence.prepare": (
        ttimevarying, lambda **kw: ttimevarying.VolumeSequence.prepare(
            np.zeros((2, 8, 8, 8), np.float32), **kw).volumes),
    "box_mesh": (tintersect, lambda **kw: tintersect.box_mesh(**kw)[0]),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_without_a_device_asks_for_the_card(name, monkeypatch):
    """No card is needed to see it: record what the constructor's
    ``resolve`` hands to torch, then let it make the tensor on the CPU."""
    module, make = CONSTRUCTORS[name]
    seen = []

    def spy(device=None):
        seen.append(tdevice.resolve(device))
        return torch.device("cpu")

    monkeypatch.setattr(module, "resolve", spy)
    make()
    assert seen and all(d == torch.device("cuda") for d in seen), seen
    seen.clear()
    assert make(device="cpu").device.type == "cpu"
    assert seen and all(d == torch.device("cpu") for d in seen), seen


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_does_not_fall_back_to_the_cpu(name):
    """Without a card, device=None raises torch's own error and no tensor
    is made on the CPU instead."""
    if torch.cuda.is_available():
        assert CONSTRUCTORS[name][1]().device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        CONSTRUCTORS[name][1]()


def test_converters_without_a_device_ask_for_the_card(monkeypatch):
    seen = []
    monkeypatch.setattr(convert, "resolve",
                        lambda device=None: seen.append(
                            tdevice.resolve(device)) or torch.device("cpu"))
    leaves = {f"{p}.{f}": np.zeros(s, np.float32)
              for p in ("tf", "tf_scattering")
              for f, s in (("positions", 2), ("colors", (2, 4)),
                           ("lut", (4, 4)))}
    leaves.update({"volume.data": np.zeros((2, 2, 2), np.float32),
                   "volume.basis": np.eye(3, dtype=np.float32),
                   "volume.offset": np.zeros(3, np.float32),
                   "camera.eye": np.zeros(3, np.float32),
                   "camera.center": np.ones(3, np.float32),
                   "camera.up": np.ones(3, np.float32),
                   "camera.fov_y": np.float32(45.0)})
    convert.scene_from_numpy(leaves, [])
    assert seen == [torch.device("cuda")]


CALL = re.compile(
    r"\b(?:t\w*|sampling|convert|intersect|rng)\.(?:Volume\.from_data|"
    r"TransferFunction\.from_points|PhotonData\.create|Camera\.create|"
    r"stratified_grid_2d|scene_from_numpy|state_from_numpy|uniform|"
    r"VolumeSequence\.prepare|box_mesh)\(")


def _call_text(src: str, start: int) -> str:
    depth = 0
    for i in range(start, len(src)):
        depth += src[i] == "("
        depth -= src[i] == ")"
        if depth == 0 and src[i] == ")":
            return src[start:i + 1]
    raise AssertionError("unbalanced call")


def test_every_port_test_names_its_device():
    """The port's tests run on the CPU because they say so: every call of
    a constructor of the port in tests/test_torch_*.py (this file's
    device tests aside) passes ``device=``."""
    calls = []
    for path in sorted(TESTS.glob("test_torch_*.py")):
        if path.name == Path(__file__).name:
            continue
        src = path.read_text()
        for m in CALL.finditer(src):
            calls.append((path.name, _call_text(src, m.end() - 1),
                          m.group(0)))
    assert len(calls) >= 20, len(calls)
    missing = [(f, head) for f, text, head in calls if "device=" not in text]
    assert not missing, missing
