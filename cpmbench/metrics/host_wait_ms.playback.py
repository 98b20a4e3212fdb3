"""host_wait_ms.playback: the host's time blocked in the program's
host-wait spans (``wait.<site>``: every read of device values and upload
of host values on the path) per frame of playback, from the program's
recorder (:mod:`cpmbench.metrics._program`). The sites with their counts a
frame are logged, and beside them the waits a frame that torch's sync
debug mode counts after the window, which the named count should
equal."""

import sys

from cpmbench.metrics._program import snapshot, waits


def read(run):
    snap = snapshot()
    if snap is None or not run.count("frames"):
        return None
    by_site = waits(snap)
    if not by_site:
        return None
    n = run.count("frames")
    counts = {k[len("wait."):]: v for k, v in snap["counters"].items()
              if k.startswith("wait.")}
    print(f"program host waits a frame: {sum(counts.values()) / n:.2f} named"
          f", {run.host_waits} by sync debug mode (site: count, ms): "
          + ", ".join(f"{site}: {counts.get(site, 0) / n:.2f}, "
                      f"{1e3 * t / n:.3f}" for site, t in
                      sorted(by_site.items(), key=lambda x: -x[1])),
          file=sys.stderr, flush=True)
    return sum(by_site.values()) * 1e3 / n
