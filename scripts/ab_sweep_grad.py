"""The sweep's backward and forward kernels of one checkout, timed on one
card at the default frame, to compare two checkouts in turns.

    python3 scripts/ab_sweep_grad.py [TREE] [--points 4,17,64,256]
        [--reps N] [--windows W] [--label NAME]

TREE (this repo by default) is the checkout whose ``cpm_tpu_torch`` and
``chip_smoke.py`` are imported. At chip_smoke's default frame (a 128^3
smoke cloud, 256 x 256 photons, a 512^2 image; one sweep of 768^2 rays
over 128 planes) and for a transfer function of each number of points
(the frame's own at 4, ``chip_smoke.many_point_tf`` otherwise) it takes
the cotangent of the intermediate image under chip_smoke's image loss
and times, after one warm-up:

- ``sweep_scan_backward`` (all four gradients): the device time of each
  sweep kernel it launches (``chip_smoke.device_ms`` under the tree's own
  ``RECORDS["sweep grad"]``: the mean over ``--reps`` calls of a
  ``torch.profiler`` window, ``--windows`` windows) and their sum, and
  the call (``chip_smoke.cuda_ms``, CUDA events);
- ``sweep_scan_forward`` likewise (its pre-pass and march, one chunk).

It prints one JSON line with the card's name and power limit. Run one
process per turn (A B B A), each tree from its own checkout, so that each
builds and loads its own library.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--points", default="4,17,64,256")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))

    import torch

    import chip_smoke as cs
    from cpm_tpu_torch.kernels import sweep_scan as ss
    from cpm_tpu_torch.ops import sweep_render

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs.RECORDS["ab forward"] = {"sweep_planes_kernel": 1,
                                "sweep_scan_kernel": 1}

    def kernel_ms(what: str, fn) -> list[dict]:
        """Per window: the mean device ms a call of each sweep kernel."""
        out = []
        for _ in range(a.windows):
            by_name = cs.device_ms(what, fn, a.reps, by_name=True)
            out.append({**by_name, "total": sum(by_name.values())})
        return out

    scene, config = cs.build_frame()
    state, _ = cs.run_frame(scene, config)
    rc, lv = config.render, state.light_volume_accum
    axis, vol_p, light_p, scans = sweep_render.sweep_plan(
        scene.volume, lv, scene.camera, rc)
    sched, u, v = scans[0]
    u = u.contiguous()
    c = sweep_render.scan_constants(vol_p, light_p, sched, u, v)
    weight = torch.tensor((*cs.GRAD_CHANNELS, 0.0), dtype=torch.float64,
                          device=vol_p.device)
    out = {}
    for n in (int(x) for x in a.points.split(",")):
        tf = scene.tf if n == scene.tf.positions.shape[0] else \
            cs.many_point_tf(scene.tf, n)
        pos, cols = tf.positions.contiguous(), tf.colors.contiguous()
        inter = ss.sweep_scan_forward(vol_p, light_p, pos, cols, c, u, v,
                                      rc.ambient).requires_grad_(True)
        img = sweep_render._warp(inter, sched, axis, rc.width, rc.height)
        g_inter, = torch.autograd.grad((img.double() * weight).sum(), inter)
        inter = inter.detach()

        def backward():
            return ss.sweep_scan_backward(vol_p, light_p, pos, cols, c, u, v,
                                          rc.ambient, inter, g_inter)

        def forward():
            return ss.sweep_scan_forward(vol_p, light_p, pos, cols, c, u, v,
                                         rc.ambient)

        out[n] = {"backward": kernel_ms("sweep grad", backward),
                  "backward_call_ms": cs.cuda_ms(backward, a.reps),
                  "forward": kernel_ms("ab forward", forward),
                  "forward_call_ms": cs.cuda_ms(forward, a.reps)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": a.label or a.tree, "card": card,
                      "tf_points": out}))


if __name__ == "__main__":
    main()
