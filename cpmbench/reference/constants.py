"""Physical and numerical constants of the photon-mapping pipeline.

These mirror the tuned constants of the reference implementation
(ResearchDaniel/Correlated-Photon-Mapping-...):

- ``SAMPLING_BASE_INTERVAL_RCP``: global extinction scale converting transfer
  function opacity into extinction per unit texture-space distance
  (reference: modules/progressivephotonmapping/cl/transmittance.cl:40).
- ``DEFAULT_RADIUS_REL``: default photon radius relative to the scene radius
  (reference: modules/progressivephotonmapping/photondata.cpp:36).
- ``DEFAULT_SCENE_RADIUS``: 0.5*|(2,2,2)| for a [-1,1]^3 scene box
  (reference: photondata.cpp:37).
- ``SCALE_LIGHT_POWER_DIRECTIONAL``: 1/pi brightness normalization so a
  directional light of power one is visible (reference: photondata.cpp:38).
- ``DEFAULT_NUM_PHOTONS``: 256*256 (reference: photondata.h:145).

The port's own copy of ``cpm_tpu/core/constants.py``; the tests hold the
two against each other.
"""

import numpy as np

SAMPLING_BASE_INTERVAL_RCP = 150.0
DEFAULT_RADIUS_REL = 0.0153866
DEFAULT_SCENE_RADIUS = 1.1447142425533318678080422119397  # 0.5 * |(2,2,2)|
SCALE_LIGHT_POWER_DIRECTIONAL = 1.0 / np.pi
DEFAULT_NUM_PHOTONS = 256 * 256
RUSSIAN_ROULETTE_P = 0.9
ISOTROPIC_PHASE = 1.0 / (4.0 * np.pi)
FLT_MAX = np.float32(3.4028235e38)

# Default min/max uniform grid cell size in voxels
# (reference: modules/uniformgridcl/processors/volumeminmaxclprocessor.cpp:63).
DEFAULT_GRID_CELL_SIZE = 8

# Progressive refinement timer tick in seconds
# (reference: processor/progressivephotontracercl.cpp:103).
PROGRESSIVE_TICK_S = 0.1
