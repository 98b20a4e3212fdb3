"""The port's photon splat against the JAX reference: the plain product
splat against ``splat_product_xla`` and the interpreted Pallas kernel, the
radial scatter against the float64 oracle, the dispatch and its device
rule, the wrapper's input checks, the splat's backward (its plain version
against autograd, the adjoint identity, unused slots, ``SplatProduct``),
and (on a card only) the Hopper kernels against their plain versions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import constants
from cpm_tpu.core import types as jtypes
from cpm_tpu.oracle.reference import splat_oracle
from cpm_tpu.ops import splat as jsplat
from cpm_tpu.pallas.splat_mxu import splat_product_pallas
from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.kernels import splat_product as sp
from cpm_tpu_torch.ops import splat as tsplat

# Product splat, plain version vs XLA twin and interpreted Pallas kernel:
# the same float32 weights summed in another order (tests/test_splat.py).
PRODUCT_RTOL, PRODUCT_ATOL = 1e-5, 1e-7
# Radial scatter vs the float64 oracle: float32 weights and sums.
RADIAL_RTOL, RADIAL_ATOL = 1e-4, 1e-6


def _deposits(m, seed, sentinel_frac=0.3, lo=0.05, hi=0.95):
    rs = np.random.default_rng(seed)
    pos = rs.uniform(lo, hi, (m, 3)).astype(np.float32)
    pw = rs.uniform(0.1, 2.0, (m, 3)).astype(np.float32)
    unused = rs.random(m) < sentinel_frac
    pos[unused] = constants.FLT_MAX
    pw[unused] = 0.0
    return pos, pw


def _photons(n, max_i, seed, radius):
    rs = np.random.default_rng(seed)
    pos = rs.uniform(0.05, 0.95, (max_i, n, 3)).astype(np.float32)
    pw = rs.uniform(0.1, 2.0, (max_i, n, 3)).astype(np.float32)
    pos[rs.random((max_i, n)) < 0.3] = constants.FLT_MAX
    common = dict(directions=np.zeros((max_i, n, 2), np.float32),
                  exit_power=np.zeros(n, np.float32),
                  exit_direction=np.zeros((n, 2), np.float32))
    jph = jtypes.PhotonData(
        positions=jnp.asarray(pos), powers=jnp.asarray(pw),
        **{k: jnp.asarray(v) for k, v in common.items()},
        radius_rel=jnp.float32(radius), scene_radius=jnp.float32(1.0),
        iteration=jnp.int32(0))
    tph = ttypes.PhotonData(
        positions=torch.from_numpy(pos), powers=torch.from_numpy(pw),
        **{k: torch.from_numpy(v) for k, v in common.items()},
        radius_rel=float(np.float32(radius)), scene_radius=1.0)
    return jph, tph, pos, pw


@pytest.mark.parametrize("m,dim,radius", [(64, (16, 16, 16), 0.09),
                                          (300, (17, 23, 29), 0.07),
                                          (1000, (65, 65, 65), 0.0153866)])
def test_plain_product_matches_xla(m, dim, radius):
    pos, pw = _deposits(m, seed=m)
    want = jsplat.splat_product_xla(jnp.asarray(pos), jnp.asarray(pw),
                                    jnp.float32(radius), dim)
    got = sp.splat_product_torch(torch.from_numpy(pos), torch.from_numpy(pw),
                                 radius, dim)
    assert got.shape == dim + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=PRODUCT_RTOL, atol=PRODUCT_ATOL)


@pytest.mark.parametrize("m,dim", [(64, (16, 16, 16)), (40, (9, 11, 13))])
def test_plain_product_matches_interpreted_pallas(m, dim):
    pos, pw = _deposits(m, seed=7 + m)
    want = splat_product_pallas(jnp.asarray(pos), jnp.asarray(pw),
                                jnp.float32(0.09), dim, interpret=True)
    got = sp.splat_product(torch.from_numpy(pos), torch.from_numpy(pw),
                           0.09, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=PRODUCT_RTOL, atol=PRODUCT_ATOL)


@pytest.mark.parametrize("method", ["matmul", "scatter", "auto"])
def test_splat_all_matches_reference(method):
    """Dispatch, irradiance scale, PRODUCT_KERNEL_MATCH and the validity
    mask: the port's splat_all against the reference's, same method (on
    CPU "auto" is the plain product in both)."""
    jph, tph, _, _ = _photons(48, 2, seed=1, radius=0.09)
    dim = (16, 16, 16)
    want = jsplat.splat_all(jph, dim, footprint=5, method=method)
    got = tsplat.splat_all(tph, dim, footprint=5, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=PRODUCT_RTOL, atol=PRODUCT_ATOL)


@pytest.mark.parametrize("n,radius,dim,footprint", [
    (48, 0.09, (16, 16, 16), 5), (40, 0.12, (8, 8, 8), 4),
    (30, 0.07, (9, 12, 10), 4)])
def test_radial_scatter_matches_oracle(n, radius, dim, footprint):
    _, tph, pos, pw = _photons(n, 2, seed=n, radius=radius)
    got = tsplat.splat_all(tph, dim, footprint=footprint, method="scatter")
    flat_pos, flat_pw = pos.reshape(-1, 3), pw.reshape(-1, 3)
    scale = float(constants.ISOTROPIC_PHASE
                  * jtypes.relative_irradiance_scale(n, jnp.float32(radius)))
    want = splat_oracle(flat_pos.astype(np.float64),
                        flat_pw.astype(np.float64), flat_pos[:, 0] < 1e30,
                        float(np.float32(radius)), scale, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=RADIAL_RTOL,
                               atol=RADIAL_ATOL)


def test_helpers_match_reference():
    x = np.linspace(-0.2, 1.3, 301).astype(np.float32)
    np.testing.assert_array_equal(
        tsplat.epanechnikov(torch.from_numpy(x)).numpy(),
        np.asarray(jsplat.epanechnikov(jnp.asarray(x))))
    for r in (0.0153866, 0.09, 0.5, 1 / 64):
        assert tsplat.light_volume_dim(r) == jsplat.light_volume_dim(r)
    assert tsplat.PRODUCT_KERNEL_MATCH == jsplat.PRODUCT_KERNEL_MATCH


def test_default_method_follows_the_tensors_device():
    assert tsplat.default_method(torch.device("cpu")) == "matmul"
    assert tsplat.default_method(torch.device("cuda", 0)) == "cuda"
    assert tsplat.default_method("cuda") == "cuda"


def test_wrapper_takes_cpu_tensors_to_the_plain_version():
    pos, pw = _deposits(200, seed=3)
    tpos, tpw = torch.from_numpy(pos), torch.from_numpy(pw)
    counted = ("splat_product_direct", "splat_product_tiled",
               "bin_deposits")
    before = [telemetry.launches(name) for name in counted]
    got = sp.splat_product(tpos, tpw, 0.07, (10, 12, 14))
    # No kernel on the CPU.
    assert [telemetry.launches(name) for name in counted] == before
    torch.testing.assert_close(
        got, sp.splat_product_torch(tpos, tpw, 0.07, (10, 12, 14)),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["float64", "shape", "strided", "length",
                                 "meta", "radius", "out_dim"])
def test_wrapper_raises_on_inputs_it_does_not_take(bad):
    pos, pw = (torch.from_numpy(a) for a in _deposits(32, seed=4))
    r, dim = 0.07, (8, 8, 8)
    if bad == "float64":
        pos = pos.double()
    elif bad == "shape":
        pos = pos[:, :2].contiguous()
    elif bad == "strided":
        pos = torch.cat([pos, pos], dim=1)[:, ::2]
    elif bad == "length":
        pw = pw[:-1]
    elif bad == "meta":
        pos, pw = pos.to("meta"), pw.to("meta")
    elif bad == "radius":
        r = float("nan")
    else:
        dim = (8, 0, 8)
    with pytest.raises((TypeError, ValueError)):
        sp.splat_product(pos, pw, r, dim)


# The splat's backward, plain version vs autograd of the plain splat: the
# same float32 products summed in another order.
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
# <splat(P), G> = <P, splat^T(G)> in float64 sums of float32 terms.
ADJOINT_RTOL = 1e-5


def _grid_grad(dim, seed):
    rs = np.random.default_rng(seed)
    return torch.from_numpy(rs.standard_normal((*dim, 3)).astype(np.float32))


@pytest.mark.parametrize("m,dim,radius", [(300, (17, 23, 29), 0.07),
                                          (2000, (65, 65, 65), 0.0153866)])
def test_backward_plain_version_is_autograd_of_the_splat(m, dim, radius):
    pos, pw = _deposits(m, seed=5)
    tpos = torch.from_numpy(pos)
    tpw = torch.from_numpy(pw).requires_grad_(True)
    g = _grid_grad(dim, seed=6)
    out = sp.splat_product_torch(tpos, tpw, radius, dim)
    want, = torch.autograd.grad((out * g).sum(), tpw)
    got = sp.splat_product_grad_torch(tpos, g, radius, dim)
    torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    lhs = float((out.detach().double() * g.double()).sum())
    rhs = float((tpw.detach().double() * got.double()).sum())
    assert abs(lhs - rhs) <= ADJOINT_RTOL * abs(lhs)


def test_backward_is_zero_on_unused_slots():
    """FLT_MAX and float16's +inf both mark an unused slot: its gradient
    is exactly 0, never NaN (0 * NaN would survive the validity mask)."""
    pos, _ = _deposits(64, seed=7, sentinel_frac=0.0)
    pos[:4] = constants.FLT_MAX
    pos[4:8] = np.inf
    dim = (16, 16, 16)
    got = sp.splat_product_grad(torch.from_numpy(pos), _grid_grad(dim, 8),
                                0.09, dim)
    assert torch.equal(got[:8], torch.zeros(8, 3))
    assert bool(torch.isfinite(got).all()) and bool((got[8:] != 0).any())


def test_splat_product_function_raises_on_positions_that_require_grad():
    pos, pw = _deposits(32, seed=9)
    tpos = torch.from_numpy(pos).requires_grad_(True)
    with pytest.raises(ValueError, match="positions"):
        sp.SplatProduct.apply(tpos, torch.from_numpy(pw), 0.09, (8, 8, 8))


def test_cuda_method_is_differentiable_in_the_powers():
    """``splat_all(method="cuda")`` goes through SplatProduct (on the CPU:
    the plain forward and the plain backward); its gradient with respect
    to the photons' powers equals autograd's through the plain splat."""
    _, tph, _, _ = _photons(200, 3, seed=10, radius=0.07)
    g = _grid_grad((15, 15, 15), seed=11)
    grads = {}
    for method in ("cuda", "matmul"):
        powers = tph.powers.clone().requires_grad_(True)
        ph = dataclasses.replace(tph, powers=powers)
        out = tsplat.splat_all(ph, (15, 15, 15), method=method)
        grads[method], = torch.autograd.grad((out * g).sum(), powers)
    torch.testing.assert_close(grads["cuda"], grads["matmul"],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_n_total_scales_the_kernel_path_as_the_plain_path():
    """``n_total`` is applied to the powers before the dispatch, so the
    kernel's wrapper (``method="cuda"``; the plain version for CPU
    tensors) and the plain path get the same list; with the doubled count
    the grid is half as bright, and it equals the reference's."""
    jph, tph, _, _ = _photons(64, 2, seed=16, radius=0.09)
    dim = (16, 16, 16)
    got = {m: tsplat.splat_all(tph, dim, n_total=128, method=m)
           for m in ("cuda", "matmul")}
    torch.testing.assert_close(got["cuda"], got["matmul"], rtol=0, atol=0)
    torch.testing.assert_close(
        2.0 * got["cuda"], tsplat.splat_all(tph, dim, method="cuda"),
        rtol=PRODUCT_RTOL, atol=PRODUCT_ATOL)
    pos, pw = tsplat.product_deposits(tph, n_total=128)
    torch.testing.assert_close(
        got["cuda"], sp.splat_product(pos, pw, tph.radius_rel, dim),
        rtol=0, atol=0)
    want = jsplat.splat_all(jph, dim, n_total=128, method="matmul")
    np.testing.assert_allclose(got["cuda"].numpy(), np.asarray(want),
                               rtol=PRODUCT_RTOL, atol=PRODUCT_ATOL)


@pytest.mark.parametrize("bad", ["float64", "shape", "strided"])
def test_backward_wrapper_raises_on_a_grid_gradient_it_does_not_take(bad):
    pos, _ = _deposits(16, seed=12)
    g = _grid_grad((8, 8, 8), seed=13)
    g = {"float64": g.double(), "shape": g[:4],
         "strided": g.transpose(0, 1)}[bad]
    with pytest.raises((TypeError, ValueError)):
        sp.splat_product_grad(torch.from_numpy(pos), g, 0.09, (8, 8, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["seeded", "traced"])
def test_backward_kernel_matches_plain_on_the_card(cuda_device, source):
    """On the card: the backward kernel against its plain version on the
    main path's 262,144 slots into 65^3, seeded or a traced default frame's
    own deposits. Tolerance: the kernel sums in another order (rtol 1e-4,
    atol 1e-6 of the largest value)."""
    dim, r = (65, 65, 65), 0.0153866
    if source == "seeded":
        pos, _ = _deposits(262144, seed=14, lo=0.0, hi=1.0)
        tpos = torch.from_numpy(pos).to(cuda_device)
    else:
        import chip_smoke
        from cpm_tpu_torch.pipeline import step
        scene, config = chip_smoke.build_frame()
        state = step.full_trace_step(scene, step.init_state(scene, config),
                                     config)
        tpos, _ = tsplat.product_deposits(state.photons)
        r = state.photons.radius_rel
    g = _grid_grad(dim, seed=15).to(cuda_device)
    before = telemetry.launches("splat_product_grad_cuda")
    got = sp.splat_product_grad(tpos, g, r, dim)
    torch.cuda.synchronize()
    assert telemetry.launches("splat_product_grad_cuda") == before + 1
    assert tpos.shape[0] == 262144
    ref = sp.splat_product_grad_torch(tpos, g, r, dim)
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["direct", "tiled", "chosen"])
def test_kernel_matches_plain_on_the_card(cuda_device, design):
    """On the card: each kernel design, and the one the wrapper chooses, vs
    the plain version at the main path's shape. Tolerance: atomics reorder
    the float32 sums (rtol 1e-4, atol 1e-6 of the largest value)."""
    pos, pw = _deposits(262144, seed=0, lo=0.0, hi=1.0)
    tpos = torch.from_numpy(pos).to(cuda_device)
    tpw = torch.from_numpy(pw).to(cuda_device)
    dim = (65, 65, 65)
    fn = {"direct": sp.splat_product_direct, "tiled": sp.splat_product_tiled,
          "chosen": sp.splat_product}[design]
    # The wrapper that launches counts; the chooser launches nothing itself.
    if design == "chosen":
        design = sp.choose_design(tpos.shape[0], 0.0153866, dim)
    counter = {"direct": "splat_product_direct",
               "tiled": "splat_product_tiled"}[design]
    before = telemetry.launches(counter)
    got = fn(tpos, tpw, 0.0153866, dim)
    ref = sp.splat_product_torch(tpos, tpw, 0.0153866, dim)
    torch.cuda.synchronize()
    assert telemetry.launches(counter) == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
