"""host_wait_ms.frame: the host's time blocked in the program's host-wait
spans (``wait.<site>``: every read of device values and upload of host
values on the path) per interaction, from the program's recorder
(:mod:`cpmbench.metrics._program`); the sites are logged."""

import sys

from cpmbench.metrics._program import snapshot, waits


def read(run):
    snap = snapshot()
    if snap is None or not run.interactions:
        return None
    by_site = waits(snap)
    if not by_site:
        return None
    n = run.interactions
    counts = {k[len("wait."):]: v for k, v in snap["counters"].items()
              if k.startswith("wait.")}
    print("program host waits an interaction (site: count, ms): " + ", ".join(
        f"{site}: {counts.get(site, 0) / n:.2f}, {1e3 * t / n:.3f}"
        for site, t in sorted(by_site.items(), key=lambda x: -x[1])),
          file=sys.stderr, flush=True)
    return sum(by_site.values()) * 1e3 / n
