"""Stage 3: coarse-to-fine region analysis (atom extraction).

Port of :mod:`superdsm_tpu.c2freganal` (host code on the
:func:`~superdsm_tpu_torch.dsm.batching.solve_problems` seam). Counterpart of the reference's ``C2F_RegionAnalysis``
(``superdsm/c2freganal.py:82-287``). The recursive region
splitting is inherently sequential *within* a cluster, but independent
*across* clusters; the reference runs one Ray task per cluster. Here every
cluster is a generator ("worker") that yields normalized-energy solve
requests, and a lockstep driver advances all workers together, packing the
pending 6-parameter convex solves of *all* clusters into padded device
batches each round (see :func:`superdsm_tpu_torch.dsm.batching.solve_problems`).
This keeps the device fed with large batches even though each cluster's split
queue is branchy host-side logic.

Outputs: ``y_mask``, ``atoms``, ``adjacencies``, ``seeds``, ``clusters``.
"""

import hashlib
import math
import os as _os
import queue
import sys
import threading

import numpy as np
import scipy.ndimage as ndi

from . import trace
from .pipeline import Stage
from ._aux import copy_dict
from ._stability import dq
from .image import Image
from .objects import Object
from .atoms import AtomAdjacencyGraph
from .ops.watershed import watershed
from .ops.edt import edt
from .ops.morphology import disk, binary_erosion, max_filter3
from ._device import on_cpu
from .dsm import batching as _batching
from .dsm.batching import make_problem, solve_problems


def _get_next_seed(region, where, score_img, connectivity=4):
    """Connected component of local maxima maximizing the max of
    ``score_img`` over the component
    (cf. ``superdsm/c2freganal.py:15-29``).

    The local-maximum locus depends only on (region intensities,
    connectivity), while the split loop calls this once per split attempt
    with a different ``where`` — the maximum filter is memoized on the
    region object (profiled: it dominated the seed-search host time). The
    per-component scores come from one labeled-max pass (``ndi.maximum``)
    instead of a Python loop of full-crop comparisons; the float max over
    identical pixels is order-independent, and ties keep the frozenset
    iteration order of the original loop, so seed choices are unchanged."""
    if connectivity not in (4, 8):
        raise ValueError(f'unknown connectivity: {connectivity}')
    cache = getattr(region, '_max_locus_cache', None)
    if cache is None or cache[0] != connectivity:
        image_max = max_filter3(region.model, connectivity)
        cache = (connectivity, image_max == region.model)
        region._max_locus_cache = cache
    mask = np.logical_and(region.mask, where)
    max_mask = np.logical_and(cache[1], mask)
    if max_mask.any():
        maxima = ndi.label(max_mask)[0]
        # component labels are consecutive small ints, so the previous
        # ``frozenset(maxima.reshape(-1))`` iterated ascending (CPython small-
        # int sets are collision-free here) and ``max`` kept the smallest
        # label on score ties; ``np.unique`` + first-argmax reproduces that
        # choice exactly, without the O(crop) Python-level set build
        labels_arr = np.unique(maxima[max_mask])
        scores = np.atleast_1d(
            ndi.maximum(score_img, labels=maxima, index=labels_arr))
        j = int(np.argmax(scores))
        if scores[j] > -np.inf:
            return (maxima == labels_arr[j])
    return None


def _watershed_split(region, *markers):
    """Splits a region into one part per marker by intensity watershed
    (cf. ``superdsm/c2freganal.py:32-38``)."""
    markers_map = np.zeros(region.model.shape, int)
    for marker_label, marker in enumerate(markers, start=1):
        assert markers_map[marker].max() == 0
        markers_map[marker] = marker_label
    relief = region.model.max() - region.model.clip(0, np.inf)
    labels = watershed(relief, markers_map, mask=region.mask)
    return [labels == marker_label for marker_label in range(1, len(markers) + 1)]


def _normalize_labels_map(labels, first_label=0, skip_labels=[]):
    """Renumbers labels consecutively from ``first_label`` (single LUT pass)."""
    skip = set(skip_labels)
    lut = np.zeros(int(labels.max()) + 1 if labels.size else 1, labels.dtype)
    label_translation = {}
    next_label = first_label
    for old_label in np.flatnonzero(np.bincount(labels.reshape(-1), minlength=1)):
        if old_label in skip:
            continue
        lut[old_label] = next_label
        label_translation[old_label] = next_label
        next_label += 1
    return lut[labels], label_translation


def _hash_mask(mask):
    # packbits first: 8x less data through sha1 (key stays injective for the
    # per-cluster fixed mask shape the cache is scoped to)
    return hashlib.sha1(np.packbits(mask)).digest()


class SpecStats:
    """Per-image speculation telemetry (VERDICT r2 item 9): speculative
    solves issued vs later consumed as cache hits, so the speculation
    ``budget`` is tunable from data (``SDSM_SOLVE_TELEMETRY=1`` prints the
    per-image hit rate)."""

    def __init__(self):
        # cluster workers advance on concurrent threads (_advance_workers)
        self.lock = threading.Lock()
        self.issued = 0
        self.hits = 0
        self.spec_keys = set()

    def line(self):
        rate = self.hits / self.issued if self.issued else float('nan')
        return (f'speculation issued={self.issued} hits={self.hits} '
                f'hit_rate={rate:.2f}')


def _norm_energies(cache, masked_cluster, bg_edt, objs, atoms_map, background_margin,
                   extra_masks=None, stats=None):
    """Sub-generator computing normalized energies r(ω) for several objects.

    Yields at most ONE solve request (``('solve', [cp_mask, ...])``) covering
    every cache miss, so a split iteration's two children cost one driver
    round; the driver sends the list of raw energies ψ back. Returns one
    value per object: ψ / #ω, or ``None`` for degenerate regions whose
    offset intensities are single-signed
    (cf. ``superdsm/c2freganal.py:58-79``).

    ``extra_masks`` is a zero-arg callable producing speculative region masks
    (see ``_speculate_children``) whose energies ride the same device round
    and enter only the cache. It is invoked only when the round happens
    anyway (a real cache miss exists) — speculation never creates a round of
    its own, and a fully-cached call pays no simulation cost.
    """
    pending = []

    def classify(raw_mask, speculative=False):
        # ONE derivation + degeneracy rule for real and speculative masks —
        # the energy cache is keyed by the cp-mask hash, so any divergence
        # here would silently turn speculation into dead compute
        cp_mask = raw_mask & masked_cluster.mask & (bg_edt <= background_margin)
        key = _hash_mask(cp_mask)
        if key not in cache and all(k != key for k, _ in pending):
            vals = masked_cluster.model[cp_mask]
            if vals.size == 0 or (vals > 0).all() or (vals < 0).all():
                cache[key] = None
            else:
                pending.append((key, cp_mask))
                if speculative and stats is not None:
                    with stats.lock:
                        stats.issued += 1
                        stats.spec_keys.add(key)
        if not speculative and stats is not None:
            with stats.lock:
                if key in stats.spec_keys:
                    stats.spec_keys.discard(key)  # count each speculative solve once
                    stats.hits += 1
        return key

    keys = [classify(obj.get_mask(atoms_map)) for obj in objs]
    if pending:
        if extra_masks is not None:
            for m in extra_masks():
                classify(m, speculative=True)
        energies = yield ('solve', [mask for _, mask in pending])
        for (key, cp_mask), energy in zip(pending, energies):
            cache[key] = None if energy is None else energy / cp_mask.sum()
    return [cache[key] for key in keys]


#: Speculative pre-solving of the next split level (kill switch for A/B runs).
_SPECULATE = _os.environ.get('SDSM_C2F_SPECULATE', '1') == '1'


class _SplitMemo:
    """Cluster-scoped memo for the pure split-step computations (seed
    search, seed EDT, watershed split) that the speculation simulation and
    the real split loop both perform. Speculation hit rates are ~1.0 on the
    bench fields, i.e. the real loop used to redo nearly every EDT /
    watershed / labeled-max the simulation had already run. Keys are content
    hashes of the defining masks (all crop-shaped within one cluster, same
    scoping argument as the energy cache); seed-distance maps are keyed by
    their construction token (root seed + sequence of subtracted seeds)
    instead of hashing the float array. Values are shared arrays — every
    consumer treats them as read-only."""

    #: Entry cap per cluster: a deep mosaic cluster's split tree would
    #: otherwise retain dozens of full-crop float64 EDTs for the generator's
    #: whole lifetime (x8 concurrently advancing workers). FIFO eviction
    #: bounds residency; the spec->real reuse window is one driver round, so
    #: evicted entries just recompute.
    MAX_ENTRIES = 192

    def __init__(self, cluster, masked_cluster):
        self.cluster = cluster
        self.masked_cluster = masked_cluster
        self.d = {}

    def _put(self, key, value):
        if len(self.d) >= self.MAX_ENTRIES:
            self.d.pop(next(iter(self.d)))
        self.d[key] = value
        return value

    def seed(self, mask_key, c0_mask, sd, sd_tok, connectivity):
        """Next-seed search on ``model > 0 & c0_mask & sd >= 1`` scored by
        ``sd`` (the split-loop configuration); the ``where`` construction
        itself is skipped on a hit."""
        key = ('seed', mask_key, sd_tok, connectivity)
        if key not in self.d:
            where = np.all((self.cluster.model > 0, c0_mask, sd >= 1), axis=0)
            return self._put(key, _get_next_seed(self.masked_cluster, where,
                                                 sd, connectivity))
        return self.d[key]

    def seed_edt(self, seed, seed_key):
        key = ('edt', seed_key)
        if key not in self.d:
            return self._put(key, edt(~seed))
        return self.d[key]

    def split(self, mask_key, mask, seed1, seed1_key, seed2, seed2_key):
        key = ('ws', mask_key, seed1_key, seed2_key)
        if key not in self.d:
            return self._put(key, _watershed_split(
                self.cluster.get_region(mask), seed1, seed2))
        return self.d[key]


#: Sentinel energy for simulation nodes whose solve is still in flight.
_E_UNKNOWN = object()

#: Per-yield caps: number of speculative solve masks, and total simulation
#: steps (the retry paths re-enqueue nodes without emitting masks, so the
#: mask budget alone would not bound host time).
_SPEC_BUDGET = int(_os.environ.get('SDSM_C2F_SPEC_BUDGET', '12'))

#: Maximum ASSUMED decisions along any simulated path: replaying known
#: decisions is exact, but each unknown-energy assumption (a region assumed
#: to split, an accept/reject assumed accepted) multiplies the chance the
#: real loop never requests the predicted masks. Unbounded assumption
#: chains measured on BBBC033: issued 218 / hit rate 0.31 (the budget kept
#: refilling with fresh-but-deep wrong guesses each round) vs 137 / 0.42
#: for the round-2 all-accept BFS.
_SPEC_DEPTH = int(_os.environ.get('SDSM_C2F_SPEC_DEPTH', '2'))


def _simulate_split_loop(memo, energy_lookup, nodes, seed_distances,
                         sd_token, max_atom_norm_energy,
                         min_norm_energy_improvement, min_atom_size,
                         seed_connectivity, budget=None):
    """Simulates the cluster's remaining split-queue iterations and returns
    the region masks whose energies the real loop will request next
    (FIFO order, capped by ``budget``).

    Unlike the round-2 all-accept BFS (bench-field hit rate 1.00, BBBC033
    0.42), this replays the REAL loop's control flow from the current queue
    state: the deterministic retry paths (a too-small or degenerate child
    puts the parent back with the next seed — no energy needed) are followed
    exactly, and the accept / reject / leaf decisions use the TRUE
    normalized energies wherever the cache already has them, falling back to
    the accept assumption only for energies still in flight this round.
    Each driver round re-simulates from the then-current state, so a
    mispredicted decision costs one round and then self-corrects.

    Correctness is untouched regardless of prediction quality: speculative
    energies enter only the mask-keyed cache, and a miss simply solves in a
    later round (see ``_norm_energies``).

    ``nodes`` are ``(mask, seed, seed_key, energy)`` in real queue order
    (``energy`` is a float for already-solved regions, ``_E_UNKNOWN`` for
    regions whose solve rides the current round).
    """
    import collections
    if budget is None:
        budget = _SPEC_BUDGET
    masks = []
    sd, sd_tok = seed_distances, sd_token
    q = collections.deque((n[0], n[1], n[2], n[3], 0) for n in nodes)
    steps = 4 * budget + 32
    while q and len(masks) < budget and steps > 0:
        steps -= 1
        mask, seed, seed_key, energy, assumed = q.popleft()
        if seed is None:
            continue
        if energy is None:
            continue  # degenerate region: the real loop keeps it as a leaf
        if energy is not _E_UNKNOWN \
                and not dq(energy) > dq(max_atom_norm_energy):
            continue  # known leaf
        if energy is _E_UNKNOWN:
            if assumed >= _SPEC_DEPTH:
                continue  # too many stacked assumptions along this path
            assumed += 1  # assume the region turns out splittable
        if mask.sum() < 2 * min_atom_size:
            continue  # too small to split
        mask_key = _hash_mask(mask)
        s2 = memo.seed(mask_key, mask, sd, sd_tok, seed_connectivity)
        if s2 is None:
            continue  # no admissible second seed: leaf
        s2_key = _hash_mask(s2)
        sd = np.minimum(sd, memo.seed_edt(s2, s2_key))
        sd_tok = sd_tok + (s2_key,)
        m1, m2 = memo.split(mask_key, mask, seed, seed_key, s2, s2_key)
        # deterministic retry paths — the real loop re-queues the parent
        # with an updated seed choice, no solve involved
        if m1.sum() < min_atom_size:
            q.append((mask, s2, s2_key, energy, assumed))
            continue
        if m2.sum() < min_atom_size:
            q.append((mask, seed, seed_key, energy, assumed))
            continue
        e1 = energy_lookup(m1)
        e2 = energy_lookup(m2)
        for m, e in ((m1, e1), (m2, e2)):
            if e is _E_UNKNOWN:
                masks.append(m)
        # degenerate child: the real loop retries the parent (seed swaps to
        # s2 when the FIRST child was degenerate)
        if e1 is None and e2 is None:
            q.append((mask, seed, seed_key, energy, assumed))
            continue
        if e1 is None:
            q.append((mask, s2, s2_key, energy, assumed))
            continue
        if e2 is None:
            q.append((mask, seed, seed_key, energy, assumed))
            continue
        # accept/reject: exact when all three energies are known, assumed
        # accepted otherwise
        if energy is not _E_UNKNOWN and e1 is not _E_UNKNOWN \
                and e2 is not _E_UNKNOWN:
            improvement = 1 - max(e1, e2) / energy
            if dq(improvement) < dq(min_norm_energy_improvement):
                q.append((mask, seed, seed_key, energy, assumed))  # rejected
                continue
        else:
            if assumed >= _SPEC_DEPTH:
                continue
            assumed += 1  # assume the split gets accepted
        q.append((m1, seed, seed_key, e1, assumed))
        q.append((m2, s2, s2_key, e2, assumed))
    return masks


def _cluster_worker(cluster, masked_cluster, max_atom_norm_energy, min_atom_radius,
                    min_norm_energy_improvement, background_margin, seed_connectivity,
                    speculate=None, stats=None):
    """Generator running the split-queue loop of one cluster
    (semantics of ``superdsm/c2freganal.py:193-287``).

    Yields solve requests; the driver sends raw energies back. Returns
    ``(root_candidate, leaf_candidates, atoms_map, max_normalized_energy)``.
    Counts on the recorder's ``sdsm.c2f.cluster`` span of the advance that
    makes them (:mod:`.trace`): ``splits_tried``, each watershed split of a
    region, and ``splits_kept``, each split accepted.
    """
    min_atom_size = math.pi * (min_atom_radius ** 2)
    if speculate is None:
        speculate = _SPECULATE
    cache = {}
    memo = _SplitMemo(cluster, masked_cluster)
    bg_edt = edt(masked_cluster.model <= 0)

    root_candidate = Object()
    root_candidate.footprint = frozenset([1])
    root_candidate.seed = _get_next_seed(masked_cluster, cluster.model > 0,
                                         cluster.model, seed_connectivity)
    atoms_map = cluster.mask.astype(int)

    leaf_candidates = []
    split_queue = queue.Queue()

    def _energy_lookup(raw_mask):
        """Normalized energy of a region: float if already in the cache,
        ``None`` if degenerate (single-signed offsets — never solved),
        ``_E_UNKNOWN`` otherwise. MUST mirror ``_norm_energies.classify``'s
        cp-mask derivation, or speculation silently turns into dead
        compute."""
        cp_mask = raw_mask & masked_cluster.mask & (bg_edt <= background_margin)
        key = _hash_mask(cp_mask)
        if key in cache:
            return cache[key]
        vals = masked_cluster.model[cp_mask]
        if vals.size == 0 or (vals > 0).all() or (vals < 0).all():
            return None
        return _E_UNKNOWN

    def _spec_thunk(fresh_nodes, sd, sd_tok):
        """Lazy speculation: the split-loop simulation only runs when the
        driver round happens anyway; a failure never breaks the loop.
        ``sd`` may be a zero-arg callable producing the seed-distance map —
        clusters that never split (and runs with speculation off) then skip
        that EDT entirely (memoized, so the split loop shares the result).
        The simulation starts from the REAL queue state: pending siblings
        (whose energies are known) in FIFO order, then the fresh nodes whose
        solve rides this round."""
        pending = [(c, c.seed, c._seed_key, c.normalized_energy)
                   for c in list(split_queue.queue)]

        def run():
            if not speculate:
                return ()
            try:
                sd_val = sd() if callable(sd) else sd
                nodes = [(c.get_mask(atoms_map), s, k, e)
                         for c, s, k, e in pending] + \
                        [(m, s, k, _E_UNKNOWN) for m, s, k in fresh_nodes]
                return _simulate_split_loop(
                    memo, _energy_lookup, nodes, sd_val, sd_tok,
                    max_atom_norm_energy, min_norm_energy_improvement,
                    min_atom_size, seed_connectivity)
            except Exception:
                return ()
        return run

    if root_candidate.seed is not None:
        root_seed_key = _hash_mask(root_candidate.seed)
        sd_token = ('root', root_seed_key)
        # the root seed-distance EDT is LAZY: never-split clusters (and
        # speculation-off paths — mosaic/pipelined) never need it; the memo
        # shares one computation between speculation and the split loop
        get_root_sd = (lambda: memo.seed_edt(root_candidate.seed,
                                             root_seed_key))
        root_spec = _spec_thunk(
            [(root_candidate.get_mask(atoms_map), root_candidate.seed,
              root_seed_key)],
            get_root_sd, sd_token)
    else:
        root_spec = None
    root_candidate.normalized_energy = (yield from _norm_energies(
        cache, masked_cluster, bg_edt, [root_candidate], atoms_map,
        background_margin, extra_masks=root_spec, stats=stats))[0]
    if root_candidate.normalized_energy is None:
        root_candidate.normalized_energy = 0.0
    if root_candidate.seed is None:
        # no admissible seed: keep the cluster as a single atom
        leaf_candidates.append(root_candidate)
    elif dq(root_candidate.normalized_energy) > dq(max_atom_norm_energy):
        # split decisions are decision-quantized (recompile stability,
        # superdsm_tpu_torch._stability) — they sit on thresholds that raw
        # trajectory-snapshot energies cross per recompile
        split_queue.put(root_candidate)
    else:
        leaf_candidates.append(root_candidate)
    root_candidate._seed_key = root_seed_key if root_candidate.seed is not None \
        else None
    seed_distances = _LAZY_SD if root_candidate.seed is not None else None
    while not split_queue.empty():
        if seed_distances is _LAZY_SD:
            seed_distances = get_root_sd()
        c0 = split_queue.get()
        c0_mask = c0.get_mask(atoms_map)

        if c0_mask.sum() < 2 * min_atom_size:
            leaf_candidates.append(c0)  # the region is too small to be split
            continue

        c1 = Object()
        c2 = Object()
        c1.seed = c0.seed
        c1._seed_key = c0._seed_key
        c0_mask_key = _hash_mask(c0_mask)
        c2.seed = memo.seed(c0_mask_key, c0_mask, seed_distances, sd_token,
                            seed_connectivity)
        if c2.seed is None:
            leaf_candidates.append(c0)
            continue
        assert not np.logical_and(c1.seed, c2.seed).any()
        c2._seed_key = _hash_mask(c2.seed)
        seed_distances = np.min(
            [seed_distances, memo.seed_edt(c2.seed, c2._seed_key)], axis=0)
        sd_token = sd_token + (c2._seed_key,)

        new_atom_label = atoms_map.max() + 1
        c1_mask, c2_mask = memo.split(c0_mask_key, c0_mask,
                                      c1.seed, c1._seed_key,
                                      c2.seed, c2._seed_key)
        trace.count('splits_tried')

        if c1_mask.sum() < min_atom_size:
            c0.seed = c2.seed    # change the seed for current region...
            c0._seed_key = c2._seed_key
            split_queue.put(c0)  # ...and try again with different seed
            continue

        if c2_mask.sum() < min_atom_size:
            split_queue.put(c0)  # try again with different seed
            continue

        atoms_map_previous = atoms_map.copy()
        atoms_map[c2_mask] = new_atom_label
        c1.footprint = frozenset(c0.footprint)
        c2.footprint = frozenset([new_atom_label])

        spec = _spec_thunk([(c1_mask, c1.seed, c1._seed_key),
                            (c2_mask, c2.seed, c2._seed_key)],
                           seed_distances, sd_token)
        try:
            child_energies = yield from _norm_energies(
                cache, masked_cluster, bg_edt, [c1, c2], atoms_map,
                background_margin, extra_masks=spec, stats=stats)
        except Exception:
            child_energies = [None, None]
        c1.normalized_energy, c2.normalized_energy = child_energies

        if c1.normalized_energy is None and c2.normalized_energy is None:
            split_queue.put(c0)
            atoms_map = atoms_map_previous
            continue
        if c1.normalized_energy is None:
            c0.seed = c2.seed
            c0._seed_key = c2._seed_key
            split_queue.put(c0)
            atoms_map = atoms_map_previous
            continue
        if c2.normalized_energy is None:
            split_queue.put(c0)
            atoms_map = atoms_map_previous
            continue

        norm_energy_improvement = 1 - max((c1.normalized_energy, c2.normalized_energy)) / c0.normalized_energy
        if dq(norm_energy_improvement) < dq(min_norm_energy_improvement):
            split_queue.put(c0)  # try again with different seed
            atoms_map = atoms_map_previous
        else:
            trace.count('splits_kept')
            for c in (c1, c2):
                if dq(c.normalized_energy) > dq(max_atom_norm_energy):
                    split_queue.put(c)
                else:
                    leaf_candidates.append(c)

    root_candidate.footprint = frozenset(atoms_map.reshape(-1)) - {0}
    max_normalized_energy = max(
        (c.normalized_energy for c in leaf_candidates if c.normalized_energy is not None),
        default=0.0)
    return root_candidate, leaf_candidates, atoms_map, max_normalized_energy


def _advance_workers(pool, workers, payloads, results, waiting):
    """Advances the given workers concurrently (one thread per generator —
    generators are independent per cluster, and the host work between yields
    is scipy EDT / watershed / maximum-filter, which release the GIL).
    Fills ``waiting`` with new yield values and ``results`` with returns."""
    def advance(item):
        label, payload = item
        gen = workers[label]
        with trace.span('sdsm.c2f.cluster'):
            try:
                value = next(gen) if payload is _FIRST else gen.send(payload)
                return label, value, None, False
            except StopIteration as stop:
                return label, None, stop.value, True
    items = sorted(payloads.items())
    outcomes = pool.map(trace.carry(advance), items) if pool is not None and len(items) > 1 \
        else map(advance, items)
    for label, value, result, done in outcomes:
        if done:
            results[label] = result
        else:
            waiting[label] = value


_FIRST = object()  # sentinel payload: advance with next() instead of send()
_LAZY_SD = object()  # sentinel: root seed-distance EDT not yet materialized


def _drive_cluster_workers(workers, clusters_by_label, img_shape, out,
                           status_line='Analyzing clusters',
                           newton_maxiter=None, timeout=None):
    """Advances all cluster workers in lockstep, batch-solving the pending
    normalized-energy requests of every active cluster each round.

    The lockstep barrier is DELIBERATE: dispatch composition (which
    problems share a padded batch) must be a pure function of the input,
    because batch shape perturbs reduction rounding and the LM branches
    amplify it on ambiguous solves (_stability.py). A completion-ordered
    stream would make outputs depend on thread timing. The barrier's cost
    is bounded: speculation collapses bench images to ONE device round, and
    the per-cluster host work between yields is native/GIL-releasing and
    thread-pooled (advance0 ~0.3 s on a 196-cluster dense tile)."""
    from concurrent.futures import ThreadPoolExecutor
    from .dsm.solver import DEFAULT_MAXITER
    if newton_maxiter is None:
        newton_maxiter = DEFAULT_MAXITER
    results = {}
    waiting = {}
    pool = ThreadPoolExecutor(max_workers=8) if len(workers) > 1 else None
    rounds = []  # (advance, pack) spans of each round, for the telemetry line
    try:
        with trace.span('sdsm.c2f.advance', round=0) as advance:
            _advance_workers(pool, workers, {label: _FIRST for label in workers},
                             results, waiting)
        rounds.append((advance, None))
        round_no = 0
        while waiting:
            round_no += 1
            with trace.span('sdsm.c2f.pack', round=round_no) as pack:
                problems = []
                for label, (kind, cp_masks) in sorted(waiting.items()):
                    assert kind == 'solve'
                    cluster = clusters_by_label[label]
                    for idx, cp_mask in enumerate(cp_masks):
                        region = Image(model=cluster.model, mask=cp_mask, offset=cluster.offset)
                        problems.append(make_problem(region, img_shape=img_shape,
                                                     smooth_amount=np.inf, tag=(label, idx)))
            out.intermediate(f'{status_line}... round {round_no}: '
                             f'{len(problems)} solves, {len(results)} / '
                             f'{len(results) + len(waiting)} clusters done')
            solved = solve_problems(problems, out=out, fetch='energy',
                                    maxiter=newton_maxiter, timeout=timeout)
            with trace.span('sdsm.c2f.advance', round=round_no) as advance:
                energies_by_label = {}
                for res in solved:
                    label, idx = res.tag
                    energies_by_label.setdefault(label, {})[idx] = res.energy
                payloads = {
                    label: [energies_by_label[label][idx] for idx in range(len(cp_masks))]
                    for label, (kind, cp_masks) in waiting.items()}
                waiting = {}
                _advance_workers(pool, workers, payloads, results, waiting)
            rounds.append((advance, pack))
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
    if _batching._TELEMETRY:
        # a round's solve: from its pack's end to its advance's start
        marks = [f'advance0={rounds[0][0].end - rounds[0][0].start:.3f}']
        for n, (advance, pack) in enumerate(rounds[1:], start=1):
            marks += [f'pack{n}={pack.end - pack.start:.3f}',
                      f'solve{n}={advance.start - pack.end:.3f}',
                      f'advance{n}={advance.end - advance.start:.3f}']
        print('[c2f-drive] ' + ' '.join(marks), file=sys.stderr, flush=True)
    return results


class C2F_RegionAnalysis(Stage):
    """Coarse-to-fine atom extraction stage.

    Hyperparameters (namespace ``c2f-region-analysis``): ``seed_connectivity``
    (default 8), ``min_atom_radius`` (default 15; auto
    ``AF_min_atom_radius * radius``), ``max_atom_norm_energy`` (default 0.05),
    ``min_norm_energy_improvement`` (default 0.1),
    ``max_cluster_marker_irregularity`` (default 0.2) — semantics of
    ``superdsm/c2freganal.py:118-185``.
    """

    ENABLED_BY_DEFAULT = True

    def __init__(self):
        super().__init__('c2f-region-analysis',
                         inputs=['y', 'dsm_cfg'],
                         outputs=['y_mask', 'atoms', 'adjacencies', 'seeds', 'clusters'])

    def process(self, input_data, cfg, out, log_root_dir):
        seed_connectivity = cfg.get('seed_connectivity', 8)
        min_atom_radius = cfg.get('min_atom_radius', 15)
        max_atom_norm_energy = cfg.get('max_atom_norm_energy', 0.05)
        min_norm_energy_improvement = cfg.get('min_norm_energy_improvement', 0.1)
        max_cluster_marker_irregularity = cfg.get('max_cluster_marker_irregularity', 0.2)
        # split-tree speculation trades a few % extra device compute for a
        # ~halved sequential round count: on for latency-bound single-image
        # runs, off in the device-saturated pipelined throughput path
        speculate = bool(cfg.get('speculate', _SPECULATE))
        # the normalized energies only feed threshold comparisons
        # (max_atom_norm_energy, min_norm_energy_improvement), so the split
        # loop can run a lower Newton iteration cap than the gem-stage solves
        # whose energies enter the set cover; default keeps the global cap
        newton_maxiter = cfg.get('newton_maxiter', None)

        dsm_cfg = copy_dict(input_data['dsm_cfg'])
        background_margin = dsm_cfg.get('background_margin', 20)

        with trace.span('sdsm.c2f.markers') as markers:
            out.intermediate('Analyzing cluster markers...')
            y = Image.create_from_array(input_data['y'], normalize=False)
            fg_mask = (y.model > 0)
            fg_bd = np.logical_xor(fg_mask, binary_erosion(fg_mask, disk(1)))
            y_mask = np.ones(y.model.shape, bool)
            cluster_markers = ndi.label(fg_mask)[0]
            # irregularity = boundary pixels / marker size, per label in one pass
            n_markers = int(cluster_markers.max())
            if n_markers:
                sizes = np.bincount(cluster_markers.ravel(), minlength=n_markers + 1)
                bd_counts = np.bincount(cluster_markers[fg_bd], minlength=n_markers + 1)
                with np.errstate(divide='ignore', invalid='ignore'):
                    irregular = (bd_counts / np.maximum(sizes, 1)) > max_cluster_marker_irregularity
                irregular[0] = False
                if irregular.any():
                    y_mask[irregular[cluster_markers]] = False

            cluster_markers[~y_mask] = 0
            cluster_markers = _normalize_labels_map(cluster_markers, first_label=0)[0]
            out.write(f'Extracted {cluster_markers.max()} cluster markers')

            clusters = watershed(edt(cluster_markers == 0),
                                 cluster_markers)
            atoms_map = np.full(y.model.shape, 0)
            atom_candidate_by_label = {}

        with trace.span('sdsm.c2f.workers_init') as workers_init:
            cluster_labels = [int(l) for l in np.flatnonzero(
                np.bincount(clusters.reshape(-1), minlength=1)) if l != 0]
            workers = {}
            clusters_by_label = {}
            spec_stats = SpecStats()
            # bbox-local crops: `clusters == label` / bbox scans over the full
            # frame cost O(n_clusters * H * W) on dense fields (110-cluster 4K
            # tiles spent ~0.3 s here); find_objects gives every bbox in one pass
            cluster_slices = ndi.find_objects(clusters)
            for cluster_label in cluster_labels:
                sl = cluster_slices[cluster_label - 1]
                cluster = Image(y.model[sl], clusters[sl] == cluster_label,
                                offset=(sl[0].start, sl[1].start))
                masked_cluster = cluster.get_region(cluster.shrink_mask(y_mask))
                clusters_by_label[cluster_label] = cluster
                workers[cluster_label] = _cluster_worker(
                    cluster, masked_cluster, max_atom_norm_energy, min_atom_radius,
                    min_norm_energy_improvement, background_margin, seed_connectivity,
                    speculate=speculate, stats=spec_stats)

        with trace.span('sdsm.c2f.drive') as drive:
            results = _drive_cluster_workers(
                workers, clusters_by_label, y.model.shape, out,
                newton_maxiter=newton_maxiter,
                # wedged-card guard, CUDA only (see objects.compute_objects)
                timeout=None if on_cpu() else dsm_cfg.get('cp_timeout', 300))

        with trace.span('sdsm.c2f.finalize') as finalize:
            max_normalized_energy = -np.inf
            # running label high-water mark (atoms_map.max() is a full-frame scan
            # per cluster); assignments below are disjoint, so the max after each
            # cluster is offset + that cluster's local max
            next_label_offset = 0
            for cluster_label in cluster_labels:
                root_candidate, cluster_atoms, cluster_atoms_map, cluster_max_ne = results[cluster_label]
                cluster = clusters_by_label[cluster_label]
                cluster_label_offset = next_label_offset
                next_label_offset = cluster_label_offset + int(cluster_atoms_map.max())
                max_normalized_energy = max(cluster_max_ne, max_normalized_energy)
                view = atoms_map[cluster.offset[0]: cluster.offset[0] + cluster.mask.shape[0],
                                 cluster.offset[1]: cluster.offset[1] + cluster.mask.shape[1]]
                view[cluster.mask] = cluster_label_offset + cluster_atoms_map[cluster.mask]
                for atom_candidate in cluster_atoms:
                    label = cluster_label_offset + next(iter(atom_candidate.footprint))
                    atom_candidate_by_label[label] = atom_candidate
                    # centroid of a bool mask = mean of its True coordinates
                    # (identical to ndi.center_of_mass, which profiled 0.13 s
                    # per call via scipy's labeled-stats machinery)
                    mask = atom_candidate.seed if atom_candidate.seed is not None \
                        else cluster.mask
                    seed = np.array([c.mean() for c in np.nonzero(mask)]).round().astype(int)
                    atom_candidate.seed = seed + cluster.offset

            atoms_map, label_translation = _normalize_labels_map(atoms_map, first_label=1, skip_labels=[0])
            for old_label, atom_candidate in dict(atom_candidate_by_label).items():
                atom_candidate_by_label[label_translation[old_label]] = atom_candidate
            out.write(f'Extracted {atoms_map.max()} atoms (max energy rate: {max_normalized_energy:g})')

        with trace.span('sdsm.c2f.adjacency') as adjacency:
            atom_nodes = [atom_candidate_by_label[atom_label].seed
                          for atom_label in sorted(label_translation.values())]
            adjacencies = AtomAdjacencyGraph(atoms_map, clusters, fg_mask, atom_nodes, out)
        if _batching._TELEMETRY:
            phases = dict(markers=markers, workers_init=workers_init, drive=drive,
                          finalize=finalize, adjacency=adjacency)
            split = ' '.join(f'{n}={sp.end - sp.start:.3f}' for n, sp in phases.items())
            print(f'[c2f] {spec_stats.line()} | {split}', file=sys.stderr, flush=True)

        return {
            'y_mask': y_mask,
            'atoms': atoms_map,
            'adjacencies': adjacencies,
            'seeds': atom_nodes,
            'clusters': clusters,
        }

    def configure_ex(self, scale, radius, diameter):
        return {
            'min_atom_radius': (radius, 0.33, dict(type=int)),
        }
