"""Constants of the path tracer (same names and values as rtjax.constants)."""

import math

PI = math.pi
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi

# Maximum BVH depth of the build (the builder's depth cap).
BVH_MAX_DEPTH = 30

# Number of persistent path slots in the wavefront pool when no explicit or
# workload-derived size applies.
NUM_WORKING_PATHS = 1 << 20

# Russian roulette: start after this many bounces, when max(beta) drops below
# the threshold.
RR_THRESHOLD = 1.0
RR_START = 4

RAND_SEED = 1

# Sentinel bounce count marking a slot as dead / awaiting regeneration.
DEAD_BOUNCES = 2 ** 30

# Sentinel index meaning "no primitive / no light".
INVALID_INDEX = -1
