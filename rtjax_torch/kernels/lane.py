"""Lane closest-hit and any-hit BVH traversal over the wide tables.

``lane_traverse_closest`` / ``lane_traverse_anyhit`` replace
rtjax/kernels/pallas_lane.py's functions of the same names (the Pallas
kernels ``_make_lane_closest_kernel`` and ``_make_lane_anyhit_kernel``),
whose 128-ray sublanes each walk the tree on their own cursor.  They
compute the packet kernels' function with smaller groups, so here they are
the group walk of kernels/wide.py with one-warp groups of LANE rays: the
same CUDA library (``csrc/packet_traverse.cu``, the ``rtjax_lane_*``
entry points) for CUDA tensors and the same plain version, at ``group`` =
LANE, for CPU tensors.  Contract: persist.py's, at any tree depth.
"""

from __future__ import annotations

from ..accel.wide import WideTables
from .wide import group_anyhit, group_closest

LANE = 32  # rays per lane group: one warp (csrc/packet_traverse.cu kLane)

# kernel launches (wrapper, CUDA path), by kernel; the plain version's calls
# count in kernels/wide.py REF_CALLS
LAUNCHES = {"closest": 0, "anyhit": 0}


def lane_traverse_closest(tables: WideTables, origin, direction, tmax,
                          active):
    """Closest hit of every active ray by lane groups: ``(hit, t, prim,
    normal)``."""
    return group_closest("lane", LANE, LAUNCHES, tables, origin, direction,
                         tmax, active)


def lane_traverse_anyhit(tables: WideTables, origin, direction, tmax,
                         exclude, active):
    """Occlusion of every active ray by lane groups, ignoring its
    ``exclude`` prim."""
    return group_anyhit("lane", LANE, LAUNCHES, tables, origin, direction,
                        tmax, exclude, active)
