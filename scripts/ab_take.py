"""Forward gathers through ``index_select`` against advanced indexing, in
turns on one card: ``cpm_tpu_torch/ops/sampling._take`` gathers the eight
trilinear corners of every volume and light-volume fetch, so the trace and
the sweep of the default frame (chip_smoke.build_frame) both go through it.

Each round times one ``full_trace_step`` and one ``render_state`` with
CUDA events for each variant in the order A B B A (A = ``index_select``,
the port's, B = ``flat[idx]``), after checking that both trace the same
photons bit for bit and give the same light volume and image within
chip_smoke's kernel tolerance (the splat adds with atomics, so its sums
differ from run to run in the last bits).

Run from the repo root on a CUDA machine: python3 scripts/ab_take.py [rounds]
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from cpm_tpu_torch.ops import sampling  # noqa: E402
from cpm_tpu_torch.pipeline import step  # noqa: E402

VARIANTS = {
    "index_select": sampling._take,
    "flat[idx]": lambda flat, idx: flat[idx],
}


def timed(fn):
    """(result, milliseconds) of one call of ``fn`` from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main(rounds: int = 4) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.manual_seed(0)
    scene, config = chip_smoke.build_frame()
    outs = {}
    for name, take in VARIANTS.items():
        sampling._take = take
        state, img = chip_smoke.run_frame(scene, config)  # warm-up
        outs[name] = (state.photons, state.light_volume, img)
    (ph_a, lv_a, img_a), (ph_b, lv_b, img_b) = outs.values()
    for f in ("positions", "powers", "directions", "exit_power"):
        assert torch.equal(getattr(ph_a, f), getattr(ph_b, f)), f
    chip_smoke.compare(lv_b, lv_a, "light volume, flat[idx] vs index_select")
    chip_smoke.compare(img_b, img_a, "image, flat[idx] vs index_select")
    times = {name: {"trace": [], "render": []} for name in VARIANTS}
    names = list(VARIANTS)
    for _ in range(rounds):
        for name in (names[0], names[1], names[1], names[0]):
            sampling._take = VARIANTS[name]
            state = step.init_state(scene, config)
            state, t_trace = timed(
                lambda: step.full_trace_step(scene, state, config))
            _, t_render = timed(
                lambda: step.render_state(scene, state, config))
            times[name]["trace"].append(t_trace)
            times[name]["render"].append(t_render)
    sampling._take = VARIANTS["index_select"]
    print(chip_smoke.card())
    for name, t in times.items():
        print(f"{name}: full_trace_step mean {statistics.mean(t['trace']):.3f}"
              f" ms {[round(x, 3) for x in t['trace']]}; render_state mean "
              f"{statistics.mean(t['render']):.3f} ms "
              f"{[round(x, 3) for x in t['render']]}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
