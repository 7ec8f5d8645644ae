"""Recompile-stable discrete decisions (VERDICT r3 item 1).

The segmentation is chosen by discrete decisions (c2f split accepts, gem
pruning/selection thresholds, min-set-cover greedy selection, postprocess
filters) whose inputs are solver energies. Those energies are *trajectory
snapshots*: near-separable solves truncate on the logistic creep, so any
recompile-class change (gram kernel variant, transfer format, bucket
ladder/packing) shifts them. The measurements below were taken on the JAX
package, with its tools (``tools/ab_decision_drift.py``,
``tools/ab_bbbc033.py``, ``tools/probe_packing_invariance.py``, none of
them ported), on the bench image, 2026-08-20:

* same config, two runs: bitwise identical (the pipeline is deterministic);
* the JAX package's ``SDSM_GRAM_BANDED`` / ``SDSM_MASK_TRANSFERS`` A/B:
  bitwise identical (those paths are exact by construction). The port has
  neither knob: its gram takes the banded mode whenever it is given a band
  table, and the card tests hold that mode bitwise equal to the unbanded
  one; the bit-packed mask transfers have no port;
* a forced bucket-ladder change (``SDSM_DROP_BUCKETS``, which the port
  reads too): converged-class
  energies drift ~1e-3 relative, while truncated (LM-stalling) solves are
  chaotic — up to 27% on one singleton — because the packing perturbs the
  reduction rounding and the LM accept/reject branches amplify it.

No deterministic function of a continuously drifting input can be flip-free
(the discontinuity only moves). Measured honestly: on the 4 synthetic
bench-class images the decisions survive ladder repacks even with
quantization DISABLED — real-object decision gaps are wide — and the one
BBBC033 ambiguous-pair flip survives quantization (chaotic drift exceeds
any grid). Quantization is therefore defense-in-depth, not the load-bearing
mechanism: it shrinks the near-tie flip window ~8x and makes greedy
selections deterministic under exact ties, at zero cost:

1. **Quantization**: every decision comparison runs on :func:`dq`-rounded
   values — the mantissa is rounded to ``SDSM_DECISION_QUANT_BITS``
   (default 7, a relative grid of 2^-8..2^-7 ~ 0.4-0.8%). Values whose
   true gap exceeds the grid compare identically under any sub-grid drift
   unless one lands within drift of a single grid edge (probability ~
   drift/grid instead of ~1 whenever two raw values are within drift of
   each other).
2. **Deterministic tie-breaks**: greedy selections (min-set-cover prices,
   max-set-pack, the merge sweep) order exact quantized ties by the
   footprint label tuple — an integer key that is bit-stable across
   recompiles — so the near-tie case (two candidates within drift) becomes
   an exact tie with a stable winner instead of a coin flip.

The raw energies are NOT modified — reports, exports, and regression CSVs
keep full precision; only comparisons are quantized. The reference has no
equivalent mechanism (it pins BLAS versions and keeps per-hostname goldens
instead, ``README.rst:25-31``).

**What is and is not guaranteed** (measured on the JAX package with the
tools above, bench seed 0 + BBBC033, 2026-08-20):

* Same configuration, repeated runs: bitwise identical (incl. label maps).
* The JAX package's ``SDSM_GRAM_BANDED`` / ``SDSM_MASK_TRANSFERS`` /
  quantization-knob A/B (of these the port reads only
  ``SDSM_DECISION_QUANT_BITS``): identical decisions on both images; label
  maps bitwise on the bench image, one object's boundary +-0.5% area on
  BBBC033 (kernel rounding).
* Bucket-ladder / batch-shape changes (``SDSM_DROP_BUCKETS``; the JAX
  package's mesh ``min_batch`` padding, whose mesh has no port): SEPARABLE (junk/ambiguous) solves truncate
  CHAOTICALLY on the logistic creep (measured 43.9 vs 1174 on one junk
  singleton; see the scale-sweep note in ``dsm/solver.py``), so their
  energies used to depend on the packing and ``P_BUCKETS``/chunking had
  to be declared part of the pinned numerical contract (rounds 3-4).
  **Round 5 removed that pin**: every non-converged DSM lane is re-solved
  at a FROZEN canonical shape (``dsm/batching.py``,
  ``_CANONICAL_P_LADDER``; ``SDSM_CANONICAL_RESOLVE=0`` turns it off in
  both packages — measured basis: a lane's trajectory is bitwise
  independent of the other lanes and of lane order, and depends only on
  the program shape; ``tools/probe_packing_invariance.py``). Flagged-lane
  energies are therefore a pure function of the problem; the remaining
  (converged-class) drift measured max 4.2e-3 relative across the full
  pipeline (was 0.27 from the chaotic class), with every decision layer
  (atoms, cover, postprocess, object count) identical on bench seeds 0-3
  AND BBBC033 (the round-4 16<->17 flip is gone: 16/16 matched at
  (3 px, 10%), Dice 0.9997). Ladder and
  chunking changes are now ordinary perf knobs, re-validated in the JAX
  package by ``tests/test_canonical_resolve.py`` and the decision A/Bs
  (``tools/ab_decision_drift.py``); the port's knobs are held to the JAX
  package's by ``tests/test_torch_knobs.py``. Residual caveat: a flagged lane whose
  WARM START came from a converged parent inherits that parent's ~1e-5
  parameter drift, which chaos can amplify — not observed to flip a
  decision, and the zero-flip gate guards it.

``SDSM_DECISION_QUANT_BITS=0`` disables quantization (raw comparisons).
"""

import math
import os

#: Mantissa bits kept by :func:`dq`. 7 bits = relative grid 2^-8..2^-7,
#: an order of magnitude above the converged-class recompile drift (~1e-3)
#: and well below meaningful decision gaps.
BITS = int(os.environ.get('SDSM_DECISION_QUANT_BITS', '7'))
_SCALE = float(1 << BITS) if BITS > 0 else None


def dq(x):
    """Decision-quantize: round the mantissa of ``x`` to :data:`BITS` bits.

    Idempotent, monotone (preserves <= of raw values), sign-symmetric, and
    exact on zero/inf/nan. Use on BOTH sides of every decision comparison.
    """
    x = float(x)
    if _SCALE is None or x == 0.0 or not math.isfinite(x):
        return x
    m, e = math.frexp(x)  # x = m * 2**e with 0.5 <= |m| < 1
    return math.ldexp(round(m * _SCALE) / _SCALE, e)


def fp_order(obj):
    """Deterministic tie-break key: the sorted footprint label tuple."""
    return tuple(sorted(obj.footprint))
