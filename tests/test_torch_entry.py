"""The port's entry points (``cpm_tpu_torch/entry.py``) and its config 1
demo (``examples/render_sphere_torch.py``) against the JAX reference's
(``__graft_entry__.py``, ``examples/render_sphere.py``), on the CPU at
small sizes, and the multi-device dry run in a world of 2 gloo
processes."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from cpm_tpu.core.camera import Camera as JCamera
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.core.lights import Light as JLight
from cpm_tpu.core.types import TransferFunction as JTransferFunction
from cpm_tpu.core.types import Volume as JVolume
from cpm_tpu.io import synthetic
from cpm_tpu.ops import emit as jemit
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu.ops import splat as jsplat
from cpm_tpu.ops import sweep_render as jsweep
from cpm_tpu.ops import tracer as jtracer
from cpm_tpu_torch import entry
from cpm_tpu_torch.io import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Whole frames from the same state, or the same seeds, in two frameworks:
# relative L1 (tests/test_torch_pipeline.py's FRAME_REL_L1).
FRAME_REL_L1 = 1e-2
# The demo at a small size: 16^3 sphere, 32^2 photons, 32^2 pixels.
DEMO = dict(vol_dim=16, photons_side=32, width=32)


def leaves_of(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def rel_l1(got, want):
    return float(np.abs(got - want).sum() / np.abs(want).sum())


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread beside JAX's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_forward_matches_reference():
    """entry()'s forward from the reference's own scene and state."""
    jforward, (jscene, jstate) = graft.entry()
    want = np.asarray(jforward(jscene, jstate))
    forward, (scene, state) = entry.entry(device="cpu")
    scene = convert.scene_from_numpy(leaves_of(jscene), jscene.lights,
                                     device="cpu")
    state = convert.state_from_numpy(leaves_of(jstate), device="cpu")
    got = forward(scene, state).numpy()
    err = rel_l1(got, want)
    print(f"entry forward: image rel L1 {err:.3e}")
    assert got.shape == want.shape == (32, 32, 4)
    assert want[..., 3].max() > 0.1
    assert err < FRAME_REL_L1


def test_entry_builds_on_the_named_device():
    forward, (scene, state) = entry.entry(device="cpu")
    assert scene.device.type == state.light_volume.device.type == "cpu"
    assert state.light_samples.n == 32 * 32


@pytest.mark.parametrize("n_devices", [2, 3])
def test_dryrun_multichip_on_gloo(n_devices):
    """Two ranks run the sharded and the 2-host step; three ranks (an odd
    world, 33^2 photons and pixels) the sharded step alone. Each rank holds
    its frame against the single-device one and raises if it differs."""
    entry.dryrun_multichip(n_devices, backend="gloo", device="cpu")


def _demo():
    path = os.path.join(REPO, "examples", "render_sphere_torch.py")
    spec = importlib.util.spec_from_file_location("render_sphere_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_matches_reference(capsys):
    """The demo's body at 16^3 / 32^2 photons / 32^2 pixels against the
    reference's calls with PRNGKey(7): light volume and image."""
    out = _demo().render_sphere("cpu", **DEMO)
    printed = capsys.readouterr().out
    for line in ("photons traced: 1024", "light volume: (65, 65, 65, 3)",
                 "image: (32, 32, 4)", "timings (first call",
                 "steady-state: trace"):
        assert line in printed, printed

    volume = JVolume.from_data(synthetic.sphere_in_box(DEMO["vol_dim"]))
    tf = JTransferFunction.from_points(*synthetic.default_tf_points())
    tf_s = JTransferFunction.from_points(
        *synthetic.default_scattering_points())
    light = JLight.directional((0.0, -1.0, 0.3), radiance=(1.0, 0.95, 0.9))
    n = DEMO["photons_side"]
    ls = jemit.emit(light, jsampling.stratified_grid_2d(n, n))
    photons = jtracer.trace_photons(volume, tf, tf_s, ls,
                                    jax.random.PRNGKey(7),
                                    JTracerConfig(max_interactions=4))
    dim = jsplat.light_volume_dim(float(photons.radius_rel))
    lv = np.asarray(jsplat.splat_all(photons, (dim, dim, dim),
                                     method="auto"))
    w = DEMO["width"]
    img = np.asarray(jsweep.sweep_render(
        volume, tf, lv, JCamera.create(eye=(0.5, 0.7, -1.6)),
        JRenderConfig(width=w, height=w)))

    got_lv = out["light_volume"].numpy()
    got_img = out["image"].numpy()
    print(f"demo: light volume rel L1 {rel_l1(got_lv, lv):.3e}, image "
          f"{rel_l1(got_img, img):.3e}")
    assert got_lv.shape == lv.shape and got_img.shape == img.shape
    assert float(np.abs(lv).sum()) > 0.0 and img[..., 3].max() > 0.1
    assert rel_l1(got_lv, lv) < FRAME_REL_L1
    assert rel_l1(got_img, img) < FRAME_REL_L1
    assert len(out["first_ms"]) == len(out["steady_ms"]) == 3
