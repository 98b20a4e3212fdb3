"""The sweep renderer's plain form, frozen: a shear-warp march over
constant-coordinate planes along the camera's principal axis. On each plane
the perspective ray bundle meets the plane in a separable scaled grid, so
the trilinear fetch of a whole plane is a lerp between two slabs and two
hat-matrix products in full float32. Classify through the TF, light from
the light volume, composite front to back, then warp the intermediate image
to the screen with one bilinear resample. An eye inside the volume's slab
range renders two sweeps, one per marching sign, and sums them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from cpmbench.reference import constants
from cpmbench.reference.camera import Camera
from cpmbench.reference.config import RenderConfig
from cpmbench.reference.types import (TransferFunction, Volume)

Tensor = torch.Tensor

_EPS_PARALLEL = 1e-4


def principal_axis(camera: Camera) -> tuple[int, int]:
    """(axis, sign) of the dominant camera-forward component (host)."""
    fwd = camera.host("center") - camera.host("eye")
    a = int(np.argmax(np.abs(fwd)))
    return a, (1 if fwd[a] >= 0 else -1)


def _axis_perm(axis: int):
    """Coordinate axes (b, c) and the permutation of [z, y, x] storage to
    (a-slabs, c-rows, b-cols)."""
    b_axis, c_axis = [i for i in range(3) if i != axis]
    perm = (2 - axis, 2 - c_axis, 2 - b_axis)
    return b_axis, c_axis, perm


def _hat_matrix(coords: Tensor, n: int) -> Tensor:
    """(M, n) linear-interpolation matrix with CLAMP_TO_EDGE: row i holds
    the two-tap hat weights of texture coordinate coords[i]."""
    v = torch.clamp(coords * n - 0.5, 0.0, n - 1.0)
    k = torch.arange(n, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(v[:, None] - k[None, :]), min=0.0)


@dataclass
class SweepSchedule:
    """Per-frame quantities shared by the plane scan and the warp."""

    za: Tensor  # (S,) plane coordinates in marching order
    z_base: Tensor  # () reference plane: first plane in front of the eye
    w_planes: Tensor  # (S,) per-plane base-grid scale
    valid: Tensor  # (S,) plane in front of the eye
    depth0: Tensor  # () |z_base - o_a|
    o_a: Tensor
    o_b: Tensor
    o_c: Tensor
    u_lo: Tensor
    u_hi: Tensor
    v_lo: Tensor
    v_hi: Tensor
    d: Tensor  # (P, 3) screen ray directions
    safe_da: Tensor  # (P,)
    pix_ok: Tensor  # (P,) bool


def _plane_schedule(camera: Camera, axis: int, sign: int, n_planes: int,
                    width: int, height: int) -> SweepSchedule:
    a = axis
    b_axis, c_axis, _ = _axis_perm(a)
    S = n_planes
    dev = camera.eye.device
    o = camera.eye
    o_a, o_b, o_c = o[a], o[b_axis], o[c_axis]

    ks = torch.arange(S, dtype=torch.float32, device=dev)
    za = (ks + 0.5) / S if sign > 0 else (S - 0.5 - ks) / S
    in_front = (za - o_a) * float(sign) > 1e-6
    k0 = torch.argmax(in_front.to(torch.int32))
    z_base = za[k0]
    depth0 = (z_base - o_a) * float(sign)
    w_planes = (za - o_a) / torch.where(torch.abs(z_base - o_a) < 1e-8,
                                        1e-8, z_base - o_a)
    valid = in_front & (w_planes > 1e-6)

    _, dirs = camera.rays(width, height)
    d = dirs.reshape(-1, 3)
    d_a = d[:, a]
    pix_ok = d_a * float(sign) > _EPS_PARALLEL
    safe_da = torch.where(pix_ok, d_a, 1.0)
    rb = torch.where(pix_ok, d[:, b_axis] / safe_da, 0.0)
    rc = torch.where(pix_ok, d[:, c_axis] / safe_da, 0.0)

    def base_range(o_bc, r):
        r_lo = torch.amin(torch.where(pix_ok, r, torch.inf))
        r_hi = torch.amax(torch.where(pix_ok, r, -torch.inf))
        # Footprint at each plane, clipped to the box, back-projected to the
        # base plane; the union over planes is the base-grid range.
        dz_k = za - o_a
        lo_k = torch.minimum(dz_k * r_lo, dz_k * r_hi)
        hi_k = torch.maximum(dz_k * r_lo, dz_k * r_hi)
        blo = torch.clamp(o_bc + lo_k, 0.0, 1.0)
        bhi = torch.clamp(o_bc + hi_k, 0.0, 1.0)
        wk = torch.clamp(w_planes, min=1e-6)
        ub1 = o_bc + (blo - o_bc) / wk
        ub2 = o_bc + (bhi - o_bc) / wk
        lo = torch.amin(torch.where(valid, torch.minimum(ub1, ub2), torch.inf))
        hi = torch.amax(torch.where(valid, torch.maximum(ub1, ub2),
                                    -torch.inf))
        lo = torch.where(torch.isfinite(lo), lo, 0.0)
        hi = torch.where(torch.isfinite(hi), hi, 1.0)
        span = torch.clamp(hi - lo, min=1e-5)
        return lo, lo + span

    u_lo, u_hi = base_range(o_b, rb)
    v_lo, v_hi = base_range(o_c, rc)
    return SweepSchedule(za=za, z_base=z_base, w_planes=w_planes,
                         valid=valid, depth0=depth0, o_a=o_a, o_b=o_b,
                         o_c=o_c, u_lo=u_lo, u_hi=u_hi, v_lo=v_lo,
                         v_hi=v_hi, d=d, safe_da=safe_da, pix_ok=pix_ok)


def _slab_indices(na: int, za: Tensor):
    """Per-plane slab pair and lerp weight along the marching axis of a
    volume of ``na`` slabs: (k0 (S,) int64, k1 (S,) int64, fz (S,))."""
    zf = torch.clamp(za * na - 0.5, 0.0, na - 1.0)
    k0 = torch.floor(zf)
    fz = zf - k0
    k0 = k0.to(torch.int64)
    k1 = torch.clamp(k0 + 1, max=na - 1)
    return k0, k1, fz


class ScanConstants(NamedTuple):
    """What the plane scan reads: the slab pairs and lerp
    weights of the volume (``k0``, ``k1``, ``fz``) and of the light volume
    (``lk0``, ``lk1``, ``lfz``), the planes' validity as float32 and their
    base-grid scales, the per-ray path length of one plane step ``dl``
    (V, U), the eye's in-plane coordinates (0-dim tensors), the extinction
    scale ``sbi``. All tensors stay on the device."""

    k0: Tensor
    k1: Tensor
    fz: Tensor
    lk0: Tensor
    lk1: Tensor
    lfz: Tensor
    valid: Tensor  # (S,) float32
    w_planes: Tensor  # (S,)
    dl: Tensor  # (V, U)
    o_b: Tensor
    o_c: Tensor
    sbi: float


def scan_constants(vol_p: Tensor, light_p: Tensor, sched: SweepSchedule,
                   u: Tensor, v: Tensor) -> ScanConstants:
    """The plane scan's constants for base-grid columns ``u`` and rows
    ``v`` (no host read)."""
    S = sched.za.shape[0]
    o_b, o_c = sched.o_b, sched.o_c
    # Path length per plane step, per intermediate ray (constant over k).
    dz = 1.0 / S
    sec = torch.sqrt((u[None, :] - o_b) ** 2 + (v[:, None] - o_c) ** 2
                     + sched.depth0 ** 2) / torch.clamp(sched.depth0,
                                                        min=1e-6)
    dl = dz * sec  # (V, U)
    k0, k1, fz = _slab_indices(vol_p.shape[0], sched.za)
    lk0, lk1, lfz = _slab_indices(light_p.shape[0], sched.za)
    return ScanConstants(
        k0=k0, k1=k1, fz=fz, lk0=lk0, lk1=lk1, lfz=lfz,
        valid=sched.valid.to(torch.float32), w_planes=sched.w_planes, dl=dl,
        o_b=o_b, o_c=o_c,
        sbi=float(np.float32(constants.SAMPLING_BASE_INTERVAL_RCP)))


def _scan_planes_torch(vol_p: Tensor, light_p: Tensor, tf: TransferFunction,
                       c: ScanConstants, u: Tensor, v: Tensor,
                       ambient: float) -> Tensor:
    """The plane scan's plain version: one torch step per plane."""
    nc, nb = vol_p.shape[1:]
    nc2, nb2 = light_p.shape[1:3]
    S = c.fz.shape[0]
    sbi = c.sbi
    o_b, o_c = c.o_b, c.o_c
    dl = c.dl

    s0, s1, fz = vol_p[c.k0], vol_p[c.k1], c.fz
    l0, l1, fz2 = light_p[c.lk0], light_p[c.lk1], c.lfz
    valid = c.valid

    V, U = v.shape[0], u.shape[0]
    rgb = torch.zeros((V, U, 3), dtype=torch.float32, device=u.device)
    trans = torch.ones((V, U), dtype=torch.float32, device=u.device)
    for k in range(S):
        slab = (1.0 - fz[k]) * s0[k] + fz[k] * s1[k]  # (Nc, Nb)
        lslab = (1.0 - fz2[k]) * l0[k] + fz2[k] * l1[k]  # (Nc2, Nb2, 3)
        w_k = c.w_planes[k]
        b_k = o_b + w_k * (u - o_b)  # (U,)
        c_k = o_c + w_k * (v - o_c)  # (V,)
        Rb, Rc = _hat_matrix(b_k, nb), _hat_matrix(c_k, nc)
        Rb2, Rc2 = _hat_matrix(b_k, nb2), _hat_matrix(c_k, nc2)
        in_b = ((b_k >= 0.0) & (b_k <= 1.0)).to(torch.float32)
        in_c = ((c_k >= 0.0) & (c_k <= 1.0)).to(torch.float32)
        mask = (in_c[:, None] * in_b[None, :]) * valid[k]

        field = (Rc @ slab) @ Rb.T  # (V, U): the exact trilinear sample
        light = torch.einsum("vc,cbk,ub->vuk", Rc2, lslab, Rb2)  # (V, U, 3)

        rgba = tf.sample(field)  # (V, U, 4)
        tau = rgba[..., 3] * sbi * dl * mask
        seg_t = torch.exp(-tau)
        emit = rgba[..., :3] * (light + ambient)
        rgb = rgb + (trans * (1.0 - seg_t))[..., None] * emit
        trans = trans * seg_t
    return torch.cat([rgb, (1.0 - trans)[..., None]], dim=-1)


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """a * b + c rounded to float32 from float64, where the float32
    product is exact: a fused multiply-add's result but for rare ties."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _warp_taps(sched: SweepSchedule, axis: int, U: int, V: int):
    """The bilinear warp's taps per screen pixel: (drawn, wi, wj, i0, i1,
    j0, j1)."""
    b_axis, c_axis, _ = _axis_perm(axis)
    d, safe_da, pix_ok = sched.d, sched.safe_da, sched.pix_ok
    t_base = (sched.z_base - sched.o_a) / safe_da
    # The outermost rays land exactly on the edge of the intermediate image
    # (its range is their own footprint), so whether an edge pixel is drawn
    # hangs on the last bit of o + t * d. Round it once, as a fused
    # multiply-add does.
    bb = _fma(t_base, d[:, b_axis], sched.o_b)
    cc = _fma(t_base, d[:, c_axis], sched.o_c)
    fi = (bb - sched.u_lo) / (sched.u_hi - sched.u_lo) * U - 0.5
    fj = (cc - sched.v_lo) / (sched.v_hi - sched.v_lo) * V - 0.5
    in_img = (fi > -0.5) & (fi < U - 0.5) & (fj > -0.5) & (fj < V - 0.5)
    fi = torch.clamp(fi, 0.0, U - 1.0)
    fj = torch.clamp(fj, 0.0, V - 1.0)
    i0f, j0f = torch.floor(fi), torch.floor(fj)
    wi, wj = fi - i0f, fj - j0f
    i0, j0 = i0f.to(torch.int64), j0f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=U - 1)
    j1 = torch.clamp(j0 + 1, max=V - 1)
    return (pix_ok & in_img, wi, wj, i0, i1, j0, j1)


def _warp(inter: Tensor, sched: SweepSchedule, axis: int,
          width: int, height: int) -> Tensor:
    """Final 2D bilinear warp: intermediate image -> (H, W, 4) screen."""
    V, U = inter.shape[:2]
    inside, wi, wj, i0, i1, j0, j1 = _warp_taps(sched, axis, U, V)
    flat = inter.reshape(-1, 4)
    img = (flat[j0 * U + i0] * ((1 - wj) * (1 - wi))[:, None]
           + flat[j0 * U + i1] * ((1 - wj) * wi)[:, None]
           + flat[j1 * U + i0] * (wj * (1 - wi))[:, None]
           + flat[j1 * U + i1] * (wj * wi)[:, None])
    img = torch.where(inside[:, None], img, 0.0)
    return img.reshape(height, width, 4)


def base_grid(sched: SweepSchedule, inter_u: int, inter_v: int):
    """The (u, v) base-plane intermediate grid."""
    dev = sched.za.device
    u = sched.u_lo + (torch.arange(inter_u, dtype=torch.float32, device=dev)
                      + 0.5) / inter_u * (sched.u_hi - sched.u_lo)
    v = sched.v_lo + (torch.arange(inter_v, dtype=torch.float32, device=dev)
                      + 0.5) / inter_v * (sched.v_hi - sched.v_lo)
    return u, v


def permute_volumes(vol_data: Tensor, light_data: Tensor, axis: int):
    _, _, perm = _axis_perm(axis)
    return (vol_data.permute(perm).contiguous(),
            light_data.permute(perm + (3,)).contiguous())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class SweepPlan(NamedTuple):
    """The plane scans of one :func:`sweep_render`: the marching axis, the
    volume and light volume permuted to it, and (schedule, u, v) of each
    sweep, two (one per marching sign) for an eye inside the volume's
    slab range."""

    axis: int
    vol_p: Tensor
    light_p: Tensor
    scans: list


def sweep_plan(volume: Volume, light_volume: Tensor, camera: Camera,
               config: RenderConfig) -> SweepPlan:
    """What :func:`sweep_render` scans for ``config``:
    ``config.sampling_rate`` planes per slab of the marching axis (at
    least 2) and an intermediate image of ``config.inter_scale`` times the
    screen, rounded up to a multiple of 128."""
    axis, sign = principal_axis(camera)
    na = volume.data.shape[2 - axis]
    n_planes = max(2, int(na * config.sampling_rate))
    U = _round_up(int(config.width * config.inter_scale), 128)
    V = _round_up(int(config.height * config.inter_scale), 128)
    eye_a = float(camera.host("eye")[axis])
    z_first = 0.5 / n_planes if sign > 0 else 1.0 - 0.5 / n_planes
    inside = (z_first - eye_a) * sign <= 1e-6
    vol_p, light_p = permute_volumes(volume.data, light_volume, axis)
    scans = []
    for s in ((1, -1) if inside else (sign,)):
        sched = _plane_schedule(camera, axis, s, n_planes, config.width,
                                config.height)
        scans.append((sched, *base_grid(sched, U, V)))
    return SweepPlan(axis, vol_p, light_p, scans)


def sweep_render(volume: Volume, tf: TransferFunction, light_volume: Tensor,
                 camera: Camera, config: RenderConfig,
                 rows: Tensor | None = None) -> Tensor:
    """Render an (H, W, 4) RGBA image from the (D, H, W, 3) light volume
    over the scans of :func:`sweep_plan`; an eye inside the slab range
    sums its two sweeps' images. With ``rows`` (int64 image rows) only the
    intermediate rows that those image rows read are scanned, and only
    those image rows are returned, (len(rows), W, 4)."""
    plan = sweep_plan(volume, light_volume, camera, config)
    img = None
    for sched, u, v in plan.scans:
        if rows is None:
            inter = scan_planes(plan.vol_p, plan.light_p, tf, sched, u, v,
                                config.ambient)
            part = _warp(inter, sched, plan.axis, config.width,
                         config.height)
        else:
            need = _rows_read(sched, plan.axis, v.shape[0], u.shape[0],
                              config.width, config.height, rows)
            inter = torch.full((v.shape[0], u.shape[0], 4), float("nan"),
                               dtype=torch.float32, device=u.device)
            inter[need] = scan_planes(plan.vol_p, plan.light_p, tf, sched,
                                      u, v[need], config.ambient)
            part = _warp(inter, sched, plan.axis, config.width,
                         config.height)[rows]
        img = part if img is None else img + part
    return img


def scan_planes(vol_p: Tensor, light_p: Tensor, tf: TransferFunction,
                sched: SweepSchedule, u: Tensor, v: Tensor,
                ambient: float) -> Tensor:
    """Front-to-back composite over all planes for base-grid columns ``u``
    and rows ``v`` -> (len(v), len(u), 4) intermediate image."""
    c = scan_constants(vol_p, light_p, sched, u, v)
    return _scan_planes_torch(vol_p, light_p, tf, c, u, v, ambient)


def _rows_read(sched: SweepSchedule, axis: int, V: int, U: int, width: int,
               height: int, rows: Tensor) -> Tensor:
    """The intermediate rows that the warp reads for image ``rows``: the
    rows of :func:`_warp`'s two taps, (sorted unique int64)."""
    _, _, _, _, _, j0, j1 = _warp_taps(sched, axis, U, V)
    j0 = j0.reshape(height, width)[rows]
    j1 = j1.reshape(height, width)[rows]
    return torch.unique(torch.cat([j0.reshape(-1), j1.reshape(-1)]))
