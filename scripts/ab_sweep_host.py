"""The sweep's forward and the frames that run it, timed on one card for
the port of one checkout, to compare two checkouts in turns.

    python3 scripts/ab_sweep_host.py [TREE] [--reps N] [--label NAME]

TREE (this repo by default) is the checkout whose ``cpm_tpu_torch`` and
``chip_smoke.py`` are imported. At chip_smoke's default frame (a 128^3
smoke cloud, 256 x 256 photons, a 512^2 image) it times, after one warm-up
each:

- the host's part of one ``sweep_scan_forward`` call (``time.perf_counter``
  around the call, the card idle before it, nothing waited for): what the
  wrapper adds before its launches are enqueued;
- the whole call with CUDA events (the card's time of its launches when
  the host keeps ahead);
- ``render_state`` and a packed ``interactive_frame`` (chip_smoke's sweep
  phase's turn: a transfer-function edit, a fresh round), each call timed
  on its own with CUDA events.

Each is ``--reps`` calls (30 by default); it prints one JSON line with
the median, the least and the most of each, the card's name and power
limit. Run one process per turn (A B B A) so that each tree builds and
loads its own libraries.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _stats(xs: list[float]) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))

    import torch

    import chip_smoke as cs
    from cpm_tpu_torch.kernels import sweep_scan as ss
    from cpm_tpu_torch.ops import sweep_render
    from cpm_tpu_torch.pipeline import packed, step

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    def events(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return t

    scene, config = cs.build_frame()
    state, _ = cs.run_frame(scene, config)
    rc, lv = config.render, state.light_volume_accum
    _, vol_p, light_p, scans = sweep_render.sweep_plan(
        scene.volume, lv, scene.camera, rc)
    sched, u, v = scans[0]
    c = sweep_render.scan_constants(vol_p, light_p, sched, u, v)
    args = (vol_p, light_p, scene.tf.positions, scene.tf.colors, c,
            u.contiguous(), v, rc.ambient)
    edited = cs.edit_tf(scene)
    grid = step.build_importance_grid(edited, config)
    budget = step.recompute_budget(config, state.light_samples.n)
    packed_state = packed.pack_state(state)
    runs = {
        "forward host": (host_ms, lambda: ss.sweep_scan_forward(*args)),
        "forward call": (events, lambda: ss.sweep_scan_forward(*args)),
        "render_state": (events, lambda: step.render_state(scene, state,
                                                           config)),
        "interactive_frame": (events, lambda: packed.interactive_frame(
            edited, packed_state, scene.camera, grid, config, budget,
            fresh_round=True)),
    }
    out = {}
    for name, (timer, fn) in runs.items():
        timer(fn)
        out[name] = _stats([timer(fn) for _ in range(a.reps)])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": a.label or a.tree, "card": card,
                      "ms": out}))


if __name__ == "__main__":
    main()
