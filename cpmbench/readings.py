"""The readings that a cell's limits are set from: the numbers compared of
sound runs of the program over many seeds, or of a control (the plain
reference in the program's place at a lower precision: ``tf32``, its
matrix products in TF32, or ``bfloat16``, every volume, photon field, light
volume and image stored in bfloat16), each seed a run of the cell in this
one process.

    python3 cpmbench/readings.py --workload NAME --seeds 1,2,3 \\
        [--seconds 2] [--control tf32|bfloat16]

One JSON line a seed: the side, the seed, ``correct`` under the limits in
force and the numbers compared. The benchmark's own runs do not run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", choices=("tf32", "bfloat16"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from cpmbench.harness.backends import ReferenceBackend
    from cpmbench.harness.cell import run_cell
    from cpmbench.reference.pipeline import CONTROLS

    for seed in (int(s) for s in args.seeds.split(",")):
        side = mix = None
        if args.control:
            side = functools.partial(ReferenceBackend,
                                     precision=CONTROLS[args.control])
            mix = {"warmup": 0}
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, STARTED,
                     device=args.device, root=ROOT, side=side,
                     mix_overrides=mix)
        print(json.dumps({
            "side": args.control or "program",
            "workload": args.workload, "seed": seed,
            "correct": r["correct"], "attempted": r["attempted"],
            "seconds": time.perf_counter() - t,
            "numbers": {k: v["value"] for k, v in r["checks"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
