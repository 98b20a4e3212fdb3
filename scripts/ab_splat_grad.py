"""The splat's backward kernel of one checkout, timed on one card on the
deposit lists it runs on, to compare two checkouts in turns.

    python3 scripts/ab_splat_grad.py --save LISTS.pt
    python3 scripts/ab_splat_grad.py [TREE] --lists LISTS.pt [--reps N]
        [--windows W] [--label NAME]

``--save`` builds the lists with this checkout's ``chip_smoke.py``, as its
phases build them, and writes their positions, radii and grids to
LISTS.pt: "default" (the default frame's 262,144 deposit slots), "delta"
(a default correlated step's 53,248 signed delta slots), "config3"
(config 3's guided frame's 262,144) and "large" (the large frame's
16,777,216).

TREE (this repo by default) is the checkout whose ``cpm_tpu_torch`` and
``chip_smoke.py`` are imported. For each list of LISTS.pt it times, after
one warm-up, ``splat_product_grad`` on a seeded grid gradient: the
kernel's device time (``chip_smoke.device_ms`` under
``RECORDS["grad"]``, the mean over ``--reps`` calls of a
``torch.profiler`` window, ``--windows`` windows; a tenth of the calls on
the large list) and the wrapper's (``chip_smoke.cuda_ms``, CUDA events).

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

HERE = Path(__file__).resolve().parent.parent


def save(path: str) -> None:
    """Build the lists with this checkout's chip_smoke and write them."""
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from cpm_tpu_torch.ops import splat
    from cpm_tpu_torch.pipeline import step

    def entry(pos, config):
        return {"pos": pos.cpu(), "r": cs.f32_scalar(
            config.tracer.radius_rel),
                "dim": tuple(step.light_volume_shape(config))}

    lists = {}
    scene, config = cs.build_frame()
    state = step.full_trace_step(scene, step.init_state(scene, config),
                                 config)
    lists["default"] = entry(splat.product_deposits(state.photons)[0], config)
    _, _, first = cs.correlated_edit(scene, state, config)
    lists["delta"] = entry(cs.batch_deposits(state, first, config)[0], config)
    del scene, state, first
    scene, config = cs.build_config3()
    guided = cs.dataclasses.replace(config, guided_emission=True)
    grid = step.build_importance_grid(scene, config)
    state = step.full_trace_step(
        scene, step.init_state(scene, guided, importance_grid=grid), guided)
    lists["config3"] = entry(splat.product_deposits(state.photons)[0],
                             guided)
    del scene, state
    torch.cuda.empty_cache()
    scene, config = cs.build_frame(**cs.LARGE_FRAME)
    state = step.full_trace_step(scene, step.init_state(scene, config),
                                 config)
    lists["large"] = entry(splat.product_deposits(state.photons)[0], config)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(lists, path)
    print(json.dumps({name: {"slots": e["pos"].shape[0],
                             "live": int((e["pos"][:, 0] < 1e30).sum()),
                             "r": e["r"], "dim": e["dim"]}
                      for name, e in lists.items()}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=str(HERE))
    ap.add_argument("--save", default=None)
    ap.add_argument("--lists", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    if a.save:
        save(a.save)
        return
    sys.path.insert(0, str(Path(a.tree).resolve()))

    import numpy as np
    import torch

    import chip_smoke as cs
    from cpm_tpu_torch.kernels import splat_product as sp

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    lists = torch.load(a.lists)
    out = {}
    for name, e in lists.items():
        pos, r, dim = e["pos"].to(dev), e["r"], tuple(e["dim"])
        g = torch.from_numpy(np.random.default_rng(30).standard_normal(
            (*dim, 3)).astype(np.float32)).to(dev)
        reps = max(1, a.reps // 10) if pos.shape[0] > 1 << 22 else a.reps

        def grad():
            return sp.splat_product_grad(pos, g, r, dim)

        res = {"slots": pos.shape[0],
               "kernel_ms": [cs.device_ms("grad", grad, reps)
                             for _ in range(a.windows)],
               "wrapper_ms": cs.cuda_ms(grad, 4 * reps)}
        out[name] = res
        print(json.dumps({name: res}), file=sys.stderr)
        del pos, g
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": a.label or a.tree, "card": card,
                      "lists": out}))


if __name__ == "__main__":
    main()
