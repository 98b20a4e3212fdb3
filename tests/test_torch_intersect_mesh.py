"""The port's triangle-mesh light intersection (``ops/intersect.py``,
Moller-Trumbore) against the JAX reference, and the reference's own checks
(tests/test_intersect_mesh.py) on the port: the 12-triangle cube equals the
slab test, and a tetrahedron is not a box (CPU, 256 random rays)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.ops import intersect as jintersect
from cpm_tpu_torch.ops import intersect

# The same float32 formulas in two frameworks; where the spans of the cube
# and the slab test agree on a hit (tests/test_intersect_mesh.py:38-40).
ATOL = 1e-6
SPAN_RTOL, SPAN_ATOL = 1e-4, 1e-5

TETRA = (np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                   [0.0, 0.0, 1.0]], np.float32),
         np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32))


def _random_rays(n, seed=0, aimed=False):
    """Origins in [-1, 2]^3 and random directions, or (``aimed``) half of
    them aimed at points of [0, 0.45]^3, inside both meshes."""
    rs = np.random.RandomState(seed)
    o = rs.rand(n, 3).astype(np.float32) * 3.0 - 1.0
    d = rs.randn(n, 3).astype(np.float32)
    if aimed:
        d[::2] = rs.rand(n // 2, 3).astype(np.float32) * 0.45 - o[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("box", [((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                                 ((0.1, 0.2, 0.0), (0.9, 0.7, 0.5))])
def test_box_mesh_matches(box):
    want_v, want_f = jintersect.box_mesh(*box)
    got_v, got_f = intersect.box_mesh(*box, device="cpu")
    assert got_v.dtype == torch.float32 and got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("mesh", ["box", "tetra"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ray_triangles_and_spans_match(mesh, seed):
    o, d = _random_rays(256, seed, aimed=True)
    if mesh == "box":
        v, f = (np.asarray(a) for a in jintersect.box_mesh())
    else:
        v, f = TETRA
    jv0, jv1, jv2 = (jnp.asarray(v[f[:, k]]) for k in range(3))
    jhit, jt = jintersect.ray_triangles(jnp.asarray(o), jnp.asarray(d), jv0,
                                        jv1, jv2)
    hit, t = intersect.ray_triangles(_t(o), _t(d), _t(v[f[:, 0]]),
                                     _t(v[f[:, 1]]), _t(v[f[:, 2]]))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(t.numpy()[hit.numpy()],
                               np.asarray(jt)[np.asarray(jhit)], rtol=1e-5,
                               atol=ATOL)
    want = np.asarray(jintersect.light_sample_mesh_intersection(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.asarray(f)))
    got = intersect.light_sample_mesh_intersection(_t(o), _t(d), _t(v),
                                                   _t(f))
    assert got.shape == (256, 2) and (want[:, 1] >= want[:, 0]).sum() > 20
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=ATOL)


def test_box_mesh_matches_slab():
    """The 12-triangle cube reproduces the slab spans: the same hit set
    (edge grazes may differ) and the same spans where both hit."""
    o, d = _random_rays(256)
    verts, faces = intersect.box_mesh(device="cpu")
    sm = intersect.light_sample_mesh_intersection(_t(o), _t(d), verts,
                                                  faces).numpy()
    sb = intersect.light_sample_box_intersection(_t(o), _t(d)).numpy()
    hit_m, hit_b = sm[:, 1] >= sm[:, 0], sb[:, 1] >= sb[:, 0]
    assert (hit_m == hit_b).mean() > 0.99
    both = hit_m & hit_b
    assert both.sum() > 20
    np.testing.assert_allclose(sm[both], sb[both], rtol=SPAN_RTOL,
                               atol=SPAN_ATOL)


def test_tetrahedron_is_not_a_box():
    """A ray through the cube's corner outside the inscribed tetrahedron
    hits the box and misses the tetrahedron; one through the centroid
    region enters at z = 0 as the box's and leaves on the slanted face
    x + y + z = 1, before the box's exit."""
    verts, faces = _t(TETRA[0]), _t(TETRA[1])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    corner = torch.tensor([[0.9, 0.9, -1.0]])
    span_t = intersect.light_sample_mesh_intersection(corner, d, verts,
                                                      faces)[0]
    span_b = intersect.light_sample_box_intersection(corner, d)[0]
    assert span_b[1] > span_b[0] and span_t[1] < span_t[0]
    o2 = torch.tensor([[0.2, 0.2, -1.0]])
    span_t2 = intersect.light_sample_mesh_intersection(o2, d, verts,
                                                       faces)[0]
    span_b2 = intersect.light_sample_box_intersection(o2, d)[0]
    assert span_t2[1] > span_t2[0]
    assert float(span_t2[0]) == pytest.approx(float(span_b2[0]), abs=1e-5)
    assert float(span_t2[1]) < float(span_b2[1]) - 0.1
    o3 = torch.tensor([[0.1, 0.3, -0.5]])
    span = intersect.light_sample_mesh_intersection(o3, d, verts, faces)[0]
    assert float(span[1]) == pytest.approx((1.0 - 0.1 - 0.3) + 0.5,
                                           abs=1e-5)


def test_origin_inside_the_mesh_starts_at_zero():
    """An odd count of forward hits: the origin is inside the closed mesh
    and the span starts at the origin."""
    verts, faces = intersect.box_mesh(device="cpu")
    o = torch.tensor([[0.5, 0.5, 0.5], [0.2, 0.7, 0.4], [0.5, 0.5, -1.0]])
    d = torch.nn.functional.normalize(
        torch.tensor([[0.3, -0.2, 1.0], [-1.0, 0.1, 0.2], [0.0, 0.0, 1.0]]),
        dim=-1)
    got = intersect.light_sample_mesh_intersection(o, d, verts, faces)
    want = intersect.light_sample_box_intersection(o, d)
    np.testing.assert_allclose(got[:2, 0].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert float(got[2, 0]) == pytest.approx(1.0, abs=1e-6)
