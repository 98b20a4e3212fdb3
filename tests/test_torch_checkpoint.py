"""Checkpoints cross between the packages: one that the JAX reference
saved loads in the port leaf for leaf, and the reverse; a run resumed from
a checkpoint continues bit-identically within the port (CPU)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import camera as jcamera
from cpm_tpu.core import lights as jlights
from cpm_tpu.core import scene as jscene
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import PipelineConfig as JPipelineConfig
from cpm_tpu.core.config import RecomputeConfig as JRecomputeConfig
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import checkpoint as jcheckpoint
from cpm_tpu.io import synthetic
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core.config import (PipelineConfig, RecomputeConfig,
                                       RenderConfig, TracerConfig)
from cpm_tpu_torch.io import checkpoint as tcheckpoint
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.pipeline import step as tstep
from cpm_tpu_torch.pipeline.state import DirtyFlags

CONFIG = dict(photons_x=24, photons_y=24)  # 576 photons, batches of 256
TRACER = dict(max_interactions=2, max_steps=1500, clip_max=(1.0, 0.9, 1.0))
RENDER = dict(width=16, height=16)
RECOMPUTE = dict(max_photons_fraction=0.25, importance_mode="dda")


def leaves_of(tree) -> dict:
    """A reference pytree as {field path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


@pytest.fixture(scope="module")
def both():
    scene = jscene.Scene.create(
        jtypes.Volume.from_data(synthetic.smoke_cloud(16, seed=6)),
        jtypes.TransferFunction.from_points(*synthetic.default_tf_points()),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create())
    jcfg = JPipelineConfig(tracer=JTracerConfig(**TRACER),
                           render=JRenderConfig(**RENDER),
                           recompute=JRecomputeConfig(**RECOMPUTE), **CONFIG)
    tcfg = PipelineConfig(tracer=TracerConfig(**TRACER),
                          render=RenderConfig(**RENDER),
                          recompute=RecomputeConfig(**RECOMPUTE), **CONFIG)
    jstate = jstep.full_trace_step(
        scene, jstep.init_state(scene, jcfg, seed=4), jcfg)
    jstate = jstate.replace(n_remaining=jnp.int32(7),
                            recompute_phase=jnp.int32(2),
                            retraced=jstate.retraced.at[3].set(True))
    tscene = convert.scene_from_numpy(leaves_of(scene), scene.lights,
                                      device="cpu")
    return scene, jcfg, jstate, tscene, tcfg


def _same_config(a, b):
    for part in ("tracer", "splat", "recompute", "render"):
        assert (dataclasses.asdict(getattr(a, part))
                == dataclasses.asdict(getattr(b, part))), part
    assert (a.photons_x, a.photons_y) == (b.photons_x, b.photons_y)


@pytest.mark.parametrize("prev_minmax", [False, True])
def test_reference_checkpoint_loads_in_the_port(both, tmp_path, prev_minmax):
    _, jcfg, jstate, _, tcfg = both
    if prev_minmax:
        jstate = jstate.replace(prev_minmax=jnp.arange(
            16, dtype=jnp.float32).reshape(2, 2, 2, 2))
    path = str(tmp_path / "ref_state")
    jcheckpoint.save_checkpoint(path, jstate, jcfg)
    state, config = tcheckpoint.load_checkpoint(path, device="cpu")
    _same_config(config, tcfg)
    assert config == tcfg
    want = leaves_of(jstate)
    got = convert.state_to_numpy(state)
    assert sorted(got) == sorted(want)
    assert len(want) == 19 + prev_minmax
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert state.key == tuple(int(x) for x in np.asarray(jstate.key))
    assert state.n_remaining == 7 and state.recompute_phase == 2
    assert state.light_volume.device.type == "cpu"


@pytest.mark.parametrize("prev_minmax", [False, True])
def test_port_checkpoint_loads_in_the_reference(both, tmp_path, prev_minmax):
    _, jcfg, jstate, _, tcfg = both
    tstate = convert.state_from_numpy(leaves_of(jstate), device="cpu")
    if prev_minmax:
        tstate = dataclasses.replace(
            tstate, prev_minmax=torch.arange(16.0).reshape(2, 2, 2, 2))
    path = str(tmp_path / "port_state.npz")
    tcheckpoint.save_checkpoint(path, tstate, tcfg)
    state, config = jcheckpoint.load_checkpoint(path)
    _same_config(config, jcfg)
    want = convert.state_to_numpy(tstate)
    got = leaves_of(state)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # The file itself: the reference's leaves in the reference's order.
    ref_path = str(tmp_path / "ref_again.npz")
    jcheckpoint.save_checkpoint(ref_path, state, jcfg)
    with np.load(path) as mine, np.load(ref_path) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for name in mine.files:
            if name.startswith("leaf_"):
                assert mine[name].dtype == theirs[name].dtype, name
                np.testing.assert_array_equal(mine[name], theirs[name],
                                              err_msg=name)


def test_resume_is_bit_identical(both, tmp_path):
    """Save mid-drain, load, and step both states: equal bit for bit."""
    _, _, _, tscene, tcfg = both
    state = tstep.full_trace_step(tscene, tstep.init_state(tscene, tcfg,
                                                           seed=4), tcfg)
    ig = tstep.build_importance_grid(tscene, tcfg)
    ones = dataclasses.replace(ig, data=torch.ones_like(ig.data))
    state = tstep.step(tscene, state, tcfg, DirtyFlags(tf=True), ones)
    assert state.n_remaining > 0
    path = str(tmp_path / "mid_drain")
    tcheckpoint.save_checkpoint(path, state, tcfg)
    loaded, config = tcheckpoint.load_checkpoint(path, device="cpu")
    assert config == tcfg
    for flags in (DirtyFlags(progressive=True), DirtyFlags(progressive=True),
                  DirtyFlags(light=True)):
        state = tstep.step(tscene, state, tcfg, flags, ones)
        loaded = tstep.step(tscene, loaded, config, flags, ones)
        a, b = convert.state_to_numpy(state), convert.state_to_numpy(loaded)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _rewrite_header(path, **changes):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays["__cpm_header__"].tobytes()).decode())
    header.update(changes)
    arrays["__cpm_header__"] = np.frombuffer(json.dumps(header).encode(),
                                             dtype=np.uint8)
    np.savez(path, **arrays)


@pytest.mark.parametrize("changes", [dict(n_leaves=18),
                                     dict(n_leaves=20),
                                     dict(has_prev_minmax=True),
                                     dict(version=2)])
def test_mismatched_checkpoint_raises(both, tmp_path, changes):
    _, jcfg, jstate, _, _ = both
    path = str(tmp_path / "bad.npz")
    jcheckpoint.save_checkpoint(path, jstate, jcfg)
    tcheckpoint.load_checkpoint(path, device="cpu")  # loads as written
    _rewrite_header(path, **changes)
    with pytest.raises(ValueError):
        tcheckpoint.load_checkpoint(path, device="cpu")


def _half(jstate):
    """The reference state with float16 photon storage, as a trace with
    ``photon_dtype="float16"`` leaves it (unused slots +inf)."""
    ph = jstate.photons
    return jstate.replace(photons=ph.replace(
        positions=ph.positions.astype(jnp.float16),
        powers=ph.powers.astype(jnp.float16),
        directions=ph.directions.astype(jnp.float16)))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_float16_photons_keep_their_dtype(both, tmp_path, writer):
    """A float16 photon state crosses between the packages, either way,
    through a checkpoint and through ``convert``, with its dtype: the
    three deposit fields stay float16 (+inf sentinels included), every
    other leaf as it was."""
    _, jcfg, jstate, _, tcfg = both
    jcfg = dataclasses.replace(jcfg, tracer=dataclasses.replace(
        jcfg.tracer, photon_dtype="float16"))
    tcfg = dataclasses.replace(tcfg, tracer=dataclasses.replace(
        tcfg.tracer, photon_dtype="float16"))
    jhalf = _half(jstate)
    want = leaves_of(jhalf)
    assert np.isinf(want["photons.positions"]).any()
    tstate = convert.state_from_numpy(want, device="cpu")
    for f in ("positions", "powers", "directions"):
        assert getattr(tstate.photons, f).dtype == torch.float16, f
    assert tstate.photons.exit_power.dtype == torch.float32
    path = str(tmp_path / "half")
    if writer == "reference":
        jcheckpoint.save_checkpoint(path, jhalf, jcfg)
        state, config = tcheckpoint.load_checkpoint(path, device="cpu")
        assert config.tracer.photon_dtype == "float16"
        got = convert.state_to_numpy(state)
    else:
        tcheckpoint.save_checkpoint(path, tstate, tcfg)
        state, config = jcheckpoint.load_checkpoint(path + ".npz")
        assert config.tracer.photon_dtype == "float16"
        got = leaves_of(state)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
