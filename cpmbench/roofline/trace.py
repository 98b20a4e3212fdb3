"""The trace and its majorant grids' pre-pass: operations and bytes of
one trace of N light samples, from the work the reference's trace of the
same inputs did (its active lane-flights, acceptance tests and
interactions; :func:`cpmbench.reference.tracer.trace_photons` with
``counts``).

Operations, from what each event of Woodcock tracking needs:

- a flight of an active lane: one threefry-2x32 evaluation of 20 rounds
  (an add, a rotate of two shifts and an or, a xor: 5 a round; five key
  injections of 3) for the distance's and the acceptance's uniforms (2
  each), the free path (a log, a clamp, a product, a quotient: 4), the
  position (3 multiply-adds, 6), the exit of the lane's block of cells (4
  a axis, 12) and the skip and exit tests (6);
- an acceptance test: the voxel coordinates and their fractions (12), the
  trilinear fetch (7 lerps, 14), the majorant cell's index (8), the TF's
  opacity (:mod:`cpmbench.roofline.tf`, one channel) and the compare (2);
- an interaction: two more threefry evaluations (the albedo's and the
  phase's uniforms, 2 each), the scattering TF's opacity (one channel),
  the albedo (3), the powers (6), the stored direction (10), the
  isotropic phase sample (15) and the exit of the box (18).

Integer operations are counted at the float32 rate, so the bound is never
above the least time.

Bytes: the volume read once, the light samples read once (origins,
directions, powers: 36 B, span 8 B), every interaction slot written once
(positions, powers, directions: 32 B) and the exit fields (12 B) a lane;
the grids' pre-pass reads the volume once and writes an 8-byte cell.
"""

from __future__ import annotations

from cpmbench.roofline import peaks, tf

THREEFRY_OPS = 20 * 5 + 5 * 3
FLIGHT_OPS = THREEFRY_OPS + 4 + 4 + 6 + 12 + 6
TEST_OPS = 12 + 14 + 8 + 2  # with a TF evaluation of one channel
INTERACTION_OPS = 2 * (THREEFRY_OPS + 4) + 3 + 6 + 10 + 15 + 18


def trace_work(work: dict, lanes: int, max_interactions: int,
               volume_shape: tuple, tf_points: int,
               scattering_points: int) -> tuple[float, float]:
    """(operations, bytes) of one trace that did ``work``."""
    ops = (work["lane_flights"] * FLIGHT_OPS
           + work["tests"] * (TEST_OPS + tf.eval_ops(tf_points, 1))
           + work["interactions"] * (INTERACTION_OPS
                                     + tf.eval_ops(scattering_points, 1)))
    d, h, w = volume_shape
    nbytes = (4 * d * h * w + 44 * lanes + 32 * max_interactions * lanes
              + 12 * lanes)
    return ops, nbytes


def grids_work(volume_shape: tuple, cell: int) -> tuple[float, float]:
    """(operations, bytes) of the majorant grids' pre-pass: a min and a
    max a voxel; the volume read once, 8 B a cell written."""
    d, h, w = volume_shape
    cells = -(-d // cell) * -(-h // cell) * -(-w // cell)
    return 2.0 * d * h * w, 4.0 * d * h * w + 8.0 * cells


def bound_s(work: dict, lanes: int, max_interactions: int,
            volume_shape: tuple, tf_points: int, scattering_points: int,
            cell: int = 8) -> float:
    """The least time of one trace and its grids' pre-pass."""
    return (peaks.bound_s(*trace_work(work, lanes, max_interactions,
                                      volume_shape, tf_points,
                                      scattering_points))
            + peaks.bound_s(*grids_work(volume_shape, cell)))
