"""The trace of one checkout, timed on one card on the lists the driven
paths trace, to compare two checkouts in turns.

    python3 scripts/ab_trace.py [TREE] [--lists default,retrace,config4,
        config3,large,config5] [--tf-points 17,64,...]
        [--tf-in-device-memory] [--reps N] [--windows W]
        [--variants B:K,...] [--label NAME]

TREE (this repo by default) is the checkout whose ``cpm_tpu_torch`` is
imported; this repo's ``chip_smoke.trace_lists`` builds the lists through
it, as the phases build the lists they check and time (default, retrace,
config4, config3, large, config5: see there), so that every tree is timed
on the same lists. With ``--tf-points`` the default list is also timed
with its transfer function replaced by one of each number of points
(``chip_smoke.many_point_tf``). With ``--tf-in-device-memory`` (a tree
whose wrappers place the transfer functions by ``shared_limit``) the
kernels read them from device memory on every list, as past a block's
shared memory: time it in turns with a run without the flag to compare
the two forms.

For each it times, after one warm-up, the trace kernel's device time
(``chip_smoke.device_ms`` under ``RECORDS["trace"]``, or its twin's, the
mean over ``--reps`` calls of a ``torch.profiler`` window, ``--windows``
windows, with the kernels' counters off; ``tf_global``, the form the
last call launched),
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
    ap.add_argument("--tf-points", default="")
    ap.add_argument("--tf-in-device-memory", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))

    import dataclasses
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from cpm_tpu_torch.kernels import woodcock_trace as wt
    from cpm_tpu_torch.ops import tracer

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    trace_records, grids_records = "trace", "grids"
    if a.tf_in_device_memory:
        wt.shared_limit = lambda index, kernel: 0
        trace_records = "trace, TFs in device memory"
        grids_records = "grids, TF in device memory"

    def windows(what, fn, reps):
        return [cs.device_ms(what, fn, reps) for _ in range(a.windows)]

    variants = [tuple(int(x) for x in v.split(":"))
                for v in a.variants.split(",") if v]
    points = [int(p) for p in a.tf_points.split(",") if p]

    def lists():
        for name, scene, samples, key, tcfg, ids in cs.trace_lists(
                a.lists.split(",")):
            yield name, scene, samples, key, tcfg, ids
            if name == "default":
                for p in points:
                    yield (f"default, {p}-point TF", dataclasses.replace(
                        scene, tf=cs.many_point_tf(scene.tf, p)), samples,
                        key, tcfg, ids)

    out = {}
    for name, scene, samples, key, tcfg, ids in lists():
        # At least two calls a window: from some point of a run on, the
        # profiler drops a window's first record.
        reps = max(2, a.reps // 5) if name in ("large", "config5") \
            else a.reps

        def trace():
            return tracer.trace_photons(
                scene.volume, scene.tf, scene.tf_scattering, samples, key,
                tcfg, lane_ids=ids)

        res = {"lanes": samples.n,
               "kernel_ms": windows(trace_records, trace, reps),
               "call_ms": cs.cuda_ms(trace, reps),
               "tf_global": getattr(wt.trace_woodcock_cuda, "tf_global",
                                    None)}
        if a.tf_in_device_memory and not res["tf_global"]:
            raise SystemExit(f"{name}: the transfer functions stayed in "
                             "shared memory")
        if "grids" in cs.RECORDS:
            res["grids_ms"] = windows(
                grids_records, lambda: tracer.majorant_grids(
                    scene.volume, scene.tf, tcfg), reps)
        for block, k in variants:
            saved = wt.BLOCKS, wt.COMPACT_EVERY
            wt.BLOCKS = tuple(b for b in (256, 128, 64, 32) if b <= block)
            wt.COMPACT_EVERY = k
            try:
                trace()
                res[f"kernel_ms {block}:{k}"] = windows(trace_records, trace,
                                                        reps)
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
