"""playback_idle_ms.playback: the device's idle time under the program's
playback spans (``playback.advance_time`` and the mix, the time-varying
importance grid and the correlated batch inside it) per frame, from the
program's recorder (:mod:`cpmbench.metrics._program`). The frames and the
frames that reached a new step (the host counters ``playback.frames`` and
``playback.new_step``, counted over the whole run) are logged. A program
without the playback spans gives no reading."""

import sys

from cpmbench.metrics._program import layer_idle_ms, snapshot


def read(run):
    got = layer_idle_ms(run, "playback", run.count("frames"))
    if got is not None:
        counters = snapshot()["counters"]
        print("program playback counters: frames "
              f"{counters.get('playback.frames', 0)}, new step "
              f"{counters.get('playback.new_step', 0)}", file=sys.stderr,
              flush=True)
    return got
