"""Greedy max-weight set packing.

Used for the lower bound in exact pruning
(cf. ``superdsm/maxsetpack.py:8-24``): repeatedly accept the
highest-energy object and drop everything overlapping its footprint.
"""

from .output import get_output
from ._stability import dq, fp_order


def solve_maxsetpack(objects, out=None):
    """Returns a greedily chosen footprint-disjoint subset of ``objects``
    maximizing the total energy (decision-quantized energy order with a
    deterministic footprint tie-break, :mod:`superdsm_tpu_torch._stability`)."""
    out = get_output(out)
    accepted_objects = []
    remaining_objects = sorted(objects,
                               key=lambda c: (-dq(c.energy), fp_order(c)))
    while remaining_objects:
        best_object = remaining_objects[0]
        accepted_objects.append(best_object)
        remaining_objects = [c for c in remaining_objects[1:]
                             if not (c.footprint & best_object.footprint)]
    out.write(f'MAXSETPACK - GREEDY accepted objects: {len(accepted_objects)}')
    return accepted_objects
