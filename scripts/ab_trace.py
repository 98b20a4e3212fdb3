"""The trace of one checkout, timed on one card on the lists the driven
paths trace, to compare two checkouts in turns.

    python3 scripts/ab_trace.py [TREE] [--lists default,retrace,config4,
        config3,large] [--reps N] [--windows W] [--variants B:K,...]
        [--label NAME]

TREE (this repo by default) is the checkout whose ``cpm_tpu_torch`` and
``chip_smoke.py`` are imported; its ``chip_smoke.trace_lists`` builds the
lists, as that checkout's phases build the lists they check and time
(default, retrace, config4, config3, large: see there).

For each it times, after one warm-up, the trace kernel's device time
(``chip_smoke.device_ms`` under ``RECORDS["trace"]``, the mean over
``--reps`` calls of a ``torch.profiler`` window, ``--windows`` windows),
the grids' pre-pass where the checkout has one (``RECORDS["grids"]``),
and the whole ``trace_photons`` call (``chip_smoke.cuda_ms``, CUDA
events). With ``--variants`` (a checkout with ``LaunchShape``) it also
times the kernel under each launch of widest block B and K flights
between compactions where the list exceeds what the card keeps resident
(K = 0: never).

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
    ap.add_argument("--lists", default="default,retrace,config4,config3,"
                                       "large")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--variants", default="")
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))

    import torch

    import chip_smoke as cs
    from cpm_tpu_torch.kernels import woodcock_trace as wt
    from cpm_tpu_torch.ops import tracer

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    def windows(what, fn, reps):
        return [cs.device_ms(what, fn, reps) for _ in range(a.windows)]

    variants = [tuple(int(x) for x in v.split(":"))
                for v in a.variants.split(",") if v]
    out = {}
    for name, scene, samples, key, tcfg, ids in cs.trace_lists(
            a.lists.split(",")):
        reps = max(1, a.reps // 5) if name == "large" else a.reps

        def trace():
            return tracer.trace_photons(
                scene.volume, scene.tf, scene.tf_scattering, samples, key,
                tcfg, lane_ids=ids)

        res = {"lanes": samples.n, "kernel_ms": windows("trace", trace, reps),
               "call_ms": cs.cuda_ms(trace, reps)}
        if "grids" in cs.RECORDS:
            res["grids_ms"] = windows(
                "grids", lambda: tracer.majorant_grids(
                    scene.volume, scene.tf, tcfg), reps)
        for block, k in variants:
            saved = wt.BLOCKS, wt.COMPACT_EVERY
            wt.BLOCKS = tuple(b for b in (256, 128, 64, 32) if b <= block)
            wt.COMPACT_EVERY = k
            try:
                trace()
                res[f"kernel_ms {block}:{k}"] = windows("trace", trace, reps)
                res[f"launch {block}:{k}"] = list(wt.trace_woodcock_cuda
                                                  .last_shape)
            finally:
                wt.BLOCKS, wt.COMPACT_EVERY = saved
        out[name] = res
        print(json.dumps({name: res}), file=sys.stderr)
        del scene, samples
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": a.label or a.tree, "card": card,
                      "lists": out}))


if __name__ == "__main__":
    main()
