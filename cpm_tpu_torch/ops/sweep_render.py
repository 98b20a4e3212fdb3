"""Shear-warp sweep renderer (``cpm_tpu/ops/sweep_render.py:93-395``).

March over constant-coordinate planes along the camera's principal axis.
On each plane the perspective ray bundle meets the plane in a separable
scaled grid, so the trilinear fetch of a whole plane is a lerp between two
slabs and two hat-matrix products. Classify through the TF, light from the
light volume, composite front to back, then warp the intermediate image
to the screen with one bilinear resample.

The hat-matrix products are plain ``torch.matmul``/``einsum`` in full
float32 (TF32 off); the reference's ``BF16_BF16_F32_X3`` passes are
likewise fp32-accurate. An eye inside the volume's slab range renders two
sweeps, one per marching sign, and sums them. :func:`march_zplanes_oracle`
is the sweep's exact oracle: a per-ray march over the same planes.

On the card the plane scan runs as kernels (``csrc/sweep_scan.cu``,
behind ``kernels/sweep_scan.py``): the forward prepares each plane once (a
pre-pass) and marches each intermediate ray over the prepared planes, and
the backward yields the gradients that autograd takes through the plain
loop; the transfer function may have any number of points. Both forms read
:func:`scan_constants`; ``method="auto"`` takes the kernels for CUDA
tensors and the plain loop (:func:`_scan_planes_torch`, whose backward's
plain version is :func:`_scan_planes_grad_torch`) for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from cpm_tpu_torch.core import constants
from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import RenderConfig
from cpm_tpu_torch.core.types import (TransferFunction, Volume,
                                      full_fp32_matmul)
from cpm_tpu_torch.kernels import sweep_scan
from cpm_tpu_torch.ops.sampling import (sample_volume_trilinear,
                                        sample_volume_trilinear_vec)

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
    """What both forms of the plane scan read: the slab pairs and lerp
    weights of the volume (``k0``, ``k1``, ``fz``) and of the light volume
    (``lk0``, ``lk1``, ``lfz``), the planes' validity as float32 and their
    base-grid scales, the per-ray path length of one plane step ``dl``
    (V, U), the eye's in-plane coordinates (0-dim tensors), the extinction
    scale ``sbi``, and the non-finite texels of each plane's lerped slab
    (``nonfinite`` (S,) of the volume, ``lnonfinite`` (S, 3) of the light
    volume's channels), which only the forward kernel reads. All tensors
    stay on the device."""

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
    nonfinite: Tensor  # (S,) int32
    lnonfinite: Tensor  # (S, 3) int32


def _plane_nonfinite(vol_p: Tensor, k0: Tensor, k1: Tensor) -> Tensor:
    """Non-finite texels of each plane's lerped slab, (S,) or (S, C)
    int32: those of slab k0 or slab k1, since 0 x inf is NaN. The plain
    loop samples a plane through products with hat matrices, in which
    every texel of the slab meets every ray (mostly with weight 0), so
    one such texel makes every ray's sample NaN but where the ray's own
    taps hold every one of them; the kernel, which reads only its taps,
    compares its count with this one."""
    bad = ~torch.isfinite(vol_p)
    per = bad.flatten(1, 2).sum(1)
    # k1 is k0 + 1, or k0 itself at the last slab.
    both = torch.cat([(bad[:-1] & bad[1:]).flatten(1, 2).sum(1), per[-1:]])
    return (per[k0] + per[k1] - both[k0]).to(torch.int32)


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
        sbi=float(np.float32(constants.SAMPLING_BASE_INTERVAL_RCP)),
        nonfinite=_plane_nonfinite(vol_p, k0, k1),
        lnonfinite=_plane_nonfinite(light_p, lk0, lk1))


def _scan_method(method: str, device: torch.device) -> str:
    """Resolve the plane scan's backend: "auto" is the kernels for CUDA
    tensors and the plain loop for any other."""
    if method == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if method not in ("torch", "cuda"):
        raise ValueError(f"unknown sweep method {method!r}")
    if method == "cuda" and device.type != "cuda":
        raise ValueError(f"the sweep kernels take CUDA tensors; the volume "
                         f"is on {device}")
    return method


def _scan_planes(vol_p: Tensor, light_p: Tensor, tf: TransferFunction,
                 sched: SweepSchedule, u: Tensor, v: Tensor,
                 ambient: float, method: str = "auto") -> Tensor:
    """Front-to-back composite over all planes for base-grid columns ``u``
    and rows ``v`` -> (len(v), len(u), 4) intermediate image, by
    ``method``: "auto" (the kernels of ``csrc/sweep_scan.cu`` for CUDA
    tensors, differentiable through ``kernels/sweep_scan.SweepScan``; the
    plain loop for CPU tensors), "torch" (the plain loop) or "cuda"."""
    method = _scan_method(method, vol_p.device)
    c = scan_constants(vol_p, light_p, sched, u, v)
    if method == "cuda":
        return sweep_scan.sweep_scan(vol_p, light_p, tf.positions,
                                     tf.colors, c, u, v, ambient)
    return _scan_planes_torch(vol_p, light_p, tf, c, u, v, ambient)


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


def _tf_sample_grad(p: Tensor, c: Tensor, x: Tensor, g: Tensor):
    """The adjoint of ``TransferFunction.sample`` at ``x`` for the
    cotangent ``g`` (..., 4): (dx, d positions (P,), d colours (P, 4)),
    with autograd's subgradients of the plain form: only the last segment
    with ``x >= p[s]`` survives the ``where`` chain (the first colour below
    ``p[0]``), ``clip`` halves the gradient where ``t`` sits on 0 or 1, and
    the ``clamp(min=1e-12)`` of a segment's width passes it from 1e-12
    up."""
    n = p.shape[0]
    sel = torch.full(x.shape, -1, dtype=torch.int64, device=x.device)
    for s in range(n - 1):
        sel = torch.where(x >= p[s], s, sel)
    gx = torch.zeros_like(x)
    gp = torch.zeros_like(p)
    gc = torch.zeros_like(c)
    gc[0] += torch.where((sel < 0)[..., None], g, 0.0).reshape(-1, 4).sum(0)
    for s in range(n - 1):
        gs = torch.where((sel == s)[..., None], g, 0.0)
        diff = p[s + 1] - p[s]
        w = torch.clamp(diff, min=1e-12)
        num = x - p[s]
        t_raw = num / w
        t = torch.clamp(t_raw, 0.0, 1.0)
        dclip = torch.where((t_raw > 0.0) & (t_raw < 1.0), 1.0,
                            torch.where((t_raw == 0.0) | (t_raw == 1.0),
                                        0.5, 0.0))
        gt = gs * t[..., None]
        gc[s] += (gs - gt).reshape(-1, 4).sum(0)
        gc[s + 1] += gt.reshape(-1, 4).sum(0)
        g_raw = (gs * (c[s + 1] - c[s])).sum(-1) * dclip
        g_num = g_raw / w
        gx = gx + g_num
        g_w = (-g_raw * num / (w * w)).sum() * (diff >= 1e-12).to(p.dtype)
        gp[s] += -g_num.sum() - g_w
        gp[s + 1] += g_w
    return gx, gp, gc


def _scan_planes_grad_torch(vol_p: Tensor, light_p: Tensor,
                            tf: TransferFunction, c: ScanConstants,
                            u: Tensor, v: Tensor, ambient: float,
                            out: Tensor, grad_out: Tensor, planes=None):
    """The plane scan's backward, plain version of the backward kernel:
    (d vol_p, d light_p, d tf.positions, d tf.colors) for the cotangent
    ``grad_out`` of the forward's ``out`` (V, U, 4). Each plane is sampled
    through hat-matrix products, or with ``planes`` (every plane's, from
    ``sweep_scan._prepare_planes_torch``) by the kernels' taps; either way
    the cotangents go back through the hat matrices.

    The closed-form recurrence of front-to-back compositing: with C and
    T_final from ``out``, each ray is marched again with its transmittance
    T_k and its colour so far C_<=k, and then dL/de_k = g_rgb T_k a_k and
    dL/dtau_k = g_rgb . (T_k s_k e_k - (C - C_<=k)) + g_a T_final, for the
    emission e_k, the opacity a_k = 1 - s_k and the segment transmittance
    s_k = exp(-tau_k). The TF's adjoint and the trilinear weights carry
    them to the inputs."""
    nc, nb = vol_p.shape[1:]
    nc2, nb2 = light_p.shape[1:3]
    S = c.fz.shape[0]
    sbi, o_b, o_c, dl = c.sbi, c.o_b, c.o_c, c.dl
    s0, s1, fz = vol_p[c.k0], vol_p[c.k1], c.fz
    l0, l1, fz2 = light_p[c.lk0], light_p[c.lk1], c.lfz
    g_p_vol, g_p_light = torch.zeros_like(s0), torch.zeros_like(l0)
    p, cols = tf.positions.detach(), tf.colors.detach()
    g_pos, g_cols = torch.zeros_like(p), torch.zeros_like(cols)

    big_c, t_final = out[..., :3], 1.0 - out[..., 3]
    g_rgb, g_alpha = grad_out[..., :3], grad_out[..., 3]
    g_final = g_alpha * t_final
    V, U = v.shape[0], u.shape[0]
    rgb = torch.zeros((V, U, 3), dtype=torch.float32, device=u.device)
    trans = torch.ones((V, U), dtype=torch.float32, device=u.device)
    for k in range(S):
        slab = (1.0 - fz[k]) * s0[k] + fz[k] * s1[k]
        lslab = (1.0 - fz2[k]) * l0[k] + fz2[k] * l1[k]
        w_k = c.w_planes[k]
        b_k = o_b + w_k * (u - o_b)
        c_k = o_c + w_k * (v - o_c)
        Rb, Rc = _hat_matrix(b_k, nb), _hat_matrix(c_k, nc)
        Rb2, Rc2 = _hat_matrix(b_k, nb2), _hat_matrix(c_k, nc2)
        in_b = ((b_k >= 0.0) & (b_k <= 1.0)).to(torch.float32)
        in_c = ((c_k >= 0.0) & (c_k <= 1.0)).to(torch.float32)
        mask = (in_c[:, None] * in_b[None, :]) * c.valid[k]
        if planes is None:
            field = (Rc @ slab) @ Rb.T
            light = torch.einsum("vc,cbk,ub->vuk", Rc2, lslab, Rb2)
        else:
            field, light, _ = _fetch_plane_torch(planes, k)
        rgba = tf.sample(field).detach()
        tau = rgba[..., 3] * sbi * dl * mask
        seg_t = torch.exp(-tau)
        emit = rgba[..., :3] * (light + ambient)
        weight = trans * (1.0 - seg_t)
        rgb = rgb + weight[..., None] * emit
        g_tau = (g_rgb * ((trans * seg_t)[..., None] * emit
                          - (big_c - rgb))).sum(-1) + g_final
        trans = trans * seg_t

        g_emit = g_rgb * weight[..., None]
        g_rgba = torch.cat([g_emit * (light + ambient),
                            (g_tau * mask * dl * sbi)[..., None]], dim=-1)
        g_x, gp, gc = _tf_sample_grad(p, cols, field, g_rgba)
        g_pos += gp
        g_cols += gc
        g_p_vol[k] = Rc.T @ g_x @ Rb  # (Nc, Nb)
        g_p_light[k] = torch.einsum("vc,vuk,ub->cbk", Rc2,
                                    g_emit * rgba[..., :3], Rb2)
    g_vol, g_light = _fold_plane_grads_torch(
        torch.zeros_like(vol_p), torch.zeros_like(light_p), g_p_vol,
        g_p_light, c, 0, S)
    return g_vol, g_light, g_pos, g_cols


def _fold_plane_grads_torch(g_vol: Tensor, g_light: Tensor, g_p_vol: Tensor,
                            g_p_light: Tensor, c: ScanConstants, lo: int,
                            hi: int) -> tuple:
    """The fold kernel's plain version: the gradient planes of planes
    ``lo`` to ``hi``, the volume's ``g_p_vol`` (hi - lo, Nc, Nb) and the
    light's ``g_p_light`` (hi - lo, Nc2, Nb2, 3, or 4 with the kernels'
    pad), added through each plane's slab lerp into ``g_vol`` and
    ``g_light`` in place: (1 - fz) into slab k0, then fz into slab k1, in
    the planes' order. Returns (g_vol, g_light)."""
    ks = slice(lo, hi)
    fz = c.fz[ks][:, None, None]
    lfz = c.lfz[ks][:, None, None, None]
    g_p_light = g_p_light[..., :3]
    g_vol.index_add_(0, c.k0[ks], (1.0 - fz) * g_p_vol).index_add_(
        0, c.k1[ks], fz * g_p_vol)
    g_light.index_add_(0, c.lk0[ks], (1.0 - lfz) * g_p_light).index_add_(
        0, c.lk1[ks], lfz * g_p_light)
    return g_vol, g_light


def _fetch_taps_torch(plane: Tensor, ri0: Tensor, ri1: Tensor, ci0: Tensor,
                      ci1: Tensor, rw0: Tensor, rw1: Tensor, cw0: Tensor,
                      cw1: Tensor, bad: Tensor) -> Tensor:
    """The kernels' trilinear value of a prepared plane (``tap_value`` and
    ``nan_rule`` in the source): ``plane`` (Nc * Nb, C) flat, the rows'
    taps (premultiplied by Nb) and weights (V,), the columns' (U,), the
    plane's non-finite counts ``bad`` (C,) -> (V, U, C). A clamped second
    tap (equal to the first) is not read."""
    one_r = (ri1 == ri0)[:, None, None]
    one_c = (ci1 == ci0)[None, :, None]
    r0, r1 = ri0.long()[:, None], ri1.long()[:, None]
    c0, c1 = ci0.long()[None, :], ci1.long()[None, :]
    zero = plane.new_zeros(())
    a00 = plane[r0 + c0]
    a10 = torch.where(one_r, zero, plane[r1 + c0])
    a01 = torch.where(one_c, zero, plane[r0 + c1])
    a11 = torch.where(one_r | one_c, zero, plane[r1 + c1])
    rw0, rw1 = rw0[:, None, None], rw1[:, None, None]
    cw0, cw1 = cw0[None, :, None], cw1[None, :, None]
    col0 = torch.where(one_r, rw0 * a00, rw0 * a00 + rw1 * a10)
    col1 = torch.where(one_r, rw0 * a01, rw0 * a01 + rw1 * a11)
    val = torch.where(one_c, cw0 * col0, cw0 * col0 + cw1 * col1)
    read = sum((~torch.isfinite(t)).to(torch.int32)
               for t in (a00, a10, a01, a11))
    return torch.where(bad > read, torch.nan, val)


def _fetch_plane_torch(planes, kl: int) -> tuple:
    """The kernels' fetch of plane ``kl`` of a chunk's prepared planes
    (``fetch_plane`` in the source), for every ray: (field (V, U), light
    (V, U, 3), mask (V, U))."""
    ri, ci = planes.row_i[kl], planes.col_i[kl]
    rw, cw = planes.row_w[kl], planes.col_w[kl]
    bad = planes.counts[kl]
    field = _fetch_taps_torch(
        planes.vol[kl].reshape(-1, 1), ri[:, 0], ri[:, 1], ci[:, 0],
        ci[:, 1], rw[:, 0], rw[:, 1], cw[:, 0], cw[:, 1], bad[:1])[..., 0]
    light = _fetch_taps_torch(
        planes.light[kl].reshape(-1, 4)[:, :3], ri[:, 2], ri[:, 3], ci[:, 2],
        ci[:, 3], rw[:, 2], rw[:, 3], cw[:, 2], cw[:, 3], bad[1:])
    mask = planes.row_m[kl][:, None] * planes.col_m[kl][None, :]
    return field, light, mask


def _row_scatter_torch(g_plane: Tensor, ri0: Tensor, ri1: Tensor,
                       ci0: Tensor, ci1: Tensor, rw0: Tensor, rw1: Tensor,
                       cw0: Tensor, cw1: Tensor, vals: Tensor,
                       n_col: int) -> None:
    """The gradient march's scatter, in torch: each ray's cotangents
    ``vals`` (V, U, C) times its two column weights, summed per row over
    the rays that share the first column tap, then times the row's two
    weights into the four texels of the taps of ``g_plane`` (Nc * Nb, C,
    flat), in place; a clamped second tap takes nothing."""
    V, U, C = vals.shape
    c0 = ci0.long()
    sums = [vals.new_zeros((V, n_col, C)).index_add_(1, c0, vals * w[:, None])
            for w in (cw0, cw1)]
    # A column's second tap by its first (the same for every ray).
    first = torch.arange(n_col, device=vals.device)
    second = first.clone()
    second[c0] = ci1.long()
    one_c = second == first
    one_r = ri1 == ri0
    for row, w, skip_r in ((ri0.long(), rw0, torch.zeros_like(one_r)),
                           (ri1.long(), rw1, one_r)):
        for col, ssum, skip_c in ((first, sums[0], torch.zeros_like(one_c)),
                                  (second, sums[1], one_c)):
            drop = (skip_r[:, None] | skip_c[None, :])[..., None]
            val = torch.where(drop, 0.0, w[:, None, None] * ssum)
            g_plane.index_add_(0, (row[:, None] + col[None, :]).reshape(-1),
                               val.reshape(-1, C))


def _scan_planes_grad_chunked_torch(vol_p: Tensor, light_p: Tensor,
                                    tf: TransferFunction, c: ScanConstants,
                                    u: Tensor, v: Tensor, ambient: float,
                                    out: Tensor, grad_out: Tensor,
                                    budget: int | None = None):
    """The backward kernels' plain version, chunk by chunk as
    ``kernels/sweep_scan._backward`` launches them (``budget`` bytes of
    ``sweep_scan.grad_plane_bytes`` a plane, ``sweep_scan.PLANE_BUDGET``
    by default): per chunk the prepared planes
    (``sweep_scan._prepare_planes_torch``), each plane's fetch by the
    kernels' taps, the recurrence of :func:`_scan_planes_grad_torch` with
    each ray's colour and transmittance carried from chunk to chunk, the
    cotangents scattered per row into the chunk's gradient planes
    (:func:`_row_scatter_torch`), the transfer function's sums of the chunk
    flushed at its end, and the fold (:func:`_fold_plane_grads_torch`).
    Returns (d vol_p, d light_p, d tf.positions, d tf.colors)."""
    nc, nb = vol_p.shape[1:]
    nc2, nb2 = light_p.shape[1:3]
    V, U = v.shape[0], u.shape[0]
    sbi, dl = c.sbi, c.dl
    plan = sweep_scan.chunk_plan(
        c.fz.shape[0], sweep_scan.grad_plane_bytes(nc, nb, nc2, nb2, U, V),
        sweep_scan.PLANE_BUDGET if budget is None else budget)
    p, cols = tf.positions.detach(), tf.colors.detach()
    g_vol, g_light = torch.zeros_like(vol_p), torch.zeros_like(light_p)
    g_pos, g_cols = torch.zeros_like(p), torch.zeros_like(cols)
    big_c, g_rgb = out[..., :3], grad_out[..., :3]
    g_final = grad_out[..., 3] * (1.0 - out[..., 3])
    rgb = torch.zeros((V, U, 3), dtype=torch.float32, device=u.device)
    trans = torch.ones((V, U), dtype=torch.float32, device=u.device)
    for lo, hi in plan:
        planes = sweep_scan._prepare_planes_torch(vol_p, light_p, c, u, v,
                                                  lo, hi)
        g_p_vol = vol_p.new_zeros((hi - lo, nc * nb, 1))
        g_p_light = light_p.new_zeros((hi - lo, nc2 * nb2, 3))
        run_pos, run_cols = torch.zeros_like(p), torch.zeros_like(cols)
        for kl in range(hi - lo):
            field, light, mask = _fetch_plane_torch(planes, kl)
            rgba = tf.sample(field).detach()
            tau = ((rgba[..., 3] * sbi) * dl) * mask
            seg_t = torch.exp(-tau)
            weight = trans * (1.0 - seg_t)
            emit = rgba[..., :3] * (light + ambient)
            rgb = rgb + weight[..., None] * emit
            g_tau = (g_rgb * ((trans * seg_t)[..., None] * emit
                              - (big_c - rgb))).sum(-1) + g_final
            trans = trans * seg_t
            g_emit = g_rgb * weight[..., None]
            g_rgba = torch.cat([g_emit * (light + ambient),
                                (((g_tau * mask) * dl) * sbi)[..., None]],
                               dim=-1)
            g_x, gp, gc = _tf_sample_grad(p, cols, field, g_rgba)
            run_pos += gp
            run_cols += gc
            ri, ci = planes.row_i[kl], planes.col_i[kl]
            rw, cw = planes.row_w[kl], planes.col_w[kl]
            _row_scatter_torch(g_p_vol[kl], ri[:, 0], ri[:, 1], ci[:, 0],
                               ci[:, 1], rw[:, 0], rw[:, 1], cw[:, 0],
                               cw[:, 1], g_x[..., None], nb)
            _row_scatter_torch(g_p_light[kl], ri[:, 2], ri[:, 3], ci[:, 2],
                               ci[:, 3], rw[:, 2], rw[:, 3], cw[:, 2],
                               cw[:, 3], g_emit * rgba[..., :3], nb2)
        g_pos += run_pos
        g_cols += run_cols
        _fold_plane_grads_torch(g_vol, g_light,
                                g_p_vol.view(hi - lo, nc, nb),
                                g_p_light.view(hi - lo, nc2, nb2, 3), c, lo,
                                hi)
    return g_vol, g_light, g_pos, g_cols


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """a * b + c rounded to float32 from float64, where the float32
    product is exact: a fused multiply-add's result but for rare ties."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _warp(inter: Tensor, sched: SweepSchedule, axis: int,
          width: int, height: int) -> Tensor:
    """Final 2D bilinear warp: intermediate image -> (H, W, 4) screen."""
    V, U = inter.shape[:2]
    b_axis, c_axis, _ = _axis_perm(axis)
    d, safe_da, pix_ok = sched.d, sched.safe_da, sched.pix_ok
    t_base = (sched.z_base - sched.o_a) / safe_da
    # The outermost rays land exactly on the edge of the intermediate image
    # (its range is their own footprint), so whether an edge pixel is drawn
    # hangs on the last bit of o + t * d. Round it once, as the reference's
    # compiled program does with a fused multiply-add.
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
    flat = inter.reshape(-1, 4)
    img = (flat[j0 * U + i0] * ((1 - wj) * (1 - wi))[:, None]
           + flat[j0 * U + i1] * ((1 - wj) * wi)[:, None]
           + flat[j1 * U + i0] * (wj * (1 - wi))[:, None]
           + flat[j1 * U + i1] * (wj * wi)[:, None])
    img = torch.where((pix_ok & in_img)[:, None], img, 0.0)
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


def _sweep_core(vol_data: Tensor, tf: TransferFunction, light_data: Tensor,
                camera: Camera, *, axis: int, sign: int, n_planes: int,
                inter_u: int, inter_v: int, width: int, height: int,
                ambient: float, method: str = "auto"):
    """One sweep: (image (H, W, 4), intermediate (V, U, 4),
    (u_lo, u_hi, v_lo, v_hi, za)); ``method`` as :func:`_scan_planes`."""
    full_fp32_matmul()
    vol_p, light_p = permute_volumes(vol_data, light_data, axis)
    sched = _plane_schedule(camera, axis, sign, n_planes, width, height)
    u, v = base_grid(sched, inter_u, inter_v)
    inter = _scan_planes(vol_p, light_p, tf, sched, u, v, ambient, method)
    img = _warp(inter, sched, axis, width, height)
    return img, inter, (sched.u_lo, sched.u_hi, sched.v_lo, sched.v_hi,
                        sched.za)


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
                 return_intermediate: bool = False, method: str = "auto"):
    """Render an (H, W, 4) RGBA image from the (D, H, W, 3) light volume
    over the scans of :func:`sweep_plan`; an eye inside the slab range
    sums its two sweeps' images, each of which masks the pixels whose rays
    point the other way. ``method`` picks the plane scan's form
    (:func:`_scan_planes`): "auto", "torch" or "cuda"."""
    full_fp32_matmul()
    plan = sweep_plan(volume, light_volume, camera, config)
    if return_intermediate and len(plan.scans) > 1:
        eye_a = float(camera.host("eye")[plan.axis])
        raise ValueError(
            f"sweep_render: eye (axis {plan.axis} coord {eye_a:.3f}) lies "
            "inside the volume slab range; no single sweep intermediate "
            "exists")
    img = None
    for sched, u, v in plan.scans:
        inter = _scan_planes(plan.vol_p, plan.light_p, tf, sched, u, v,
                             config.ambient, method)
        part = _warp(inter, sched, plan.axis, config.width, config.height)
        img = part if img is None else img + part
    if return_intermediate:
        return img, inter, (sched.u_lo, sched.u_hi, sched.v_lo, sched.v_hi,
                            sched.za)
    return img


def march_zplanes_oracle(volume: Volume, tf: TransferFunction,
                         light_volume: Tensor, o: Tensor, d: Tensor,
                         za: Tensor, axis: int, ambient: float) -> Tensor:
    """Per-ray march over the sweep's own plane quadrature, with gathers:
    rays (N, 3) meet the planes ``za`` (in marching order) perpendicular
    to ``axis``, and each sample goes through the same trilinear fetch, TF
    and compositing as the sweep. The sweep's intermediate image must
    equal it (``cpm_tpu/ops/sweep_render.py:398-434``). Returns (N, 4)."""
    sbi = constants.SAMPLING_BASE_INTERVAL_RCP
    dz = 1.0 / za.shape[0]
    d_a = d[:, axis]
    sec = torch.linalg.vector_norm(d, dim=-1) / torch.clamp(
        torch.abs(d_a), min=1e-12)
    b_axis, c_axis, _ = _axis_perm(axis)
    n = o.shape[0]
    rgb = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    trans = torch.ones(n, dtype=torch.float32, device=o.device)
    for k in range(za.shape[0]):
        t = (za[k] - o[:, axis]) / d_a
        p = o + t[:, None] * d
        inside = ((t > 0) & (p[:, b_axis] >= 0.0) & (p[:, b_axis] <= 1.0)
                  & (p[:, c_axis] >= 0.0) & (p[:, c_axis] <= 1.0))
        rgba = tf.sample(sample_volume_trilinear(volume.data, p))
        light = sample_volume_trilinear_vec(light_volume, p)
        tau = rgba[:, 3] * sbi * dz * sec * inside.to(torch.float32)
        seg_t = torch.exp(-tau)
        emit = rgba[:, :3] * (light + ambient)
        rgb = rgb + (trans * (1.0 - seg_t))[:, None] * emit
        trans = trans * seg_t
    return torch.cat([rgb, (1.0 - trans)[:, None]], dim=-1)
