"""Run one cell of the port's benchmark once and print its result.

    python3 cpmbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``, ``cpmbench/``
and the program, ``cpm_tpu_torch``, on a machine with the cards the cell
asks for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit;
the same numbers are the last lines of standard error. Without a card, or
with fewer than the cell asks for, it exits with 2 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "cpm_tpu_torch"


def fail(msg: str) -> int:
    print(f"cpmbench: {msg}", file=sys.stderr, flush=True)
    return 2


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / PROGRAM).is_dir():
        return fail(f"no {PROGRAM} beside {ROOT / 'cpmbench'}")
    # Build and kernel caches at fixed paths inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    # One host thread: the host's share of each interaction, not a pool's.
    torch.set_num_threads(1)

    from cpmbench.harness.cell import forbidden_modules, run_cell
    from cpmbench.harness.registry import Registry

    chips = Registry(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available():
        return fail("no CUDA card; the benchmark does not run on the CPU")
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards, "
                    f"{torch.cuda.device_count()} here")

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), STARTED, device="cuda", root=ROOT)
    card = power_limit()
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"],
                        "card": card}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        return fail(f"the run loaded {found}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
