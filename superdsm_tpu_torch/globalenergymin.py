"""Stage 4: global energy minimization (Algorithm 1 + Criterion 2).

Counterpart of the reference's ``GlobalEnergyMinimization``
(``superdsm/globalenergymin.py:97-368``): singleton atoms and
per-cluster universes are solved first; clusters satisfying Criterion 2
(universe energy <= beta + sum of atom energies) are solved in closed form;
the remaining clusters grow candidate footprints generation by generation,
pruned either exactly (MSC upper bound minus remaining-singleton lower bound,
with a maxsetpack bound) or greedily (ISBI 2024). The combinatorics run on
the host; every generation's surviving candidates are solved in one padded
device batch via :func:`superdsm_tpu_torch.objects.compute_objects` — the hottest
fan-out of the whole pipeline, which the reference distributes over Ray
workers one object at a time.
"""

import numpy as np

from .pipeline import Stage
from ._aux import join_path, mkdir, copy_dict
from .output import get_output, Text
from .objects import compute_objects, Object
from .minsetcover import MinSetCover, DEFAULT_MAX_ITER, DEFAULT_GAMMA
from .maxsetpack import solve_maxsetpack
from .image import Image
from ._stability import dq


DEFAULT_MAX_WORK_AMOUNT = 10 ** 6


def _get_generation_log_dir(log_root_dir, generation_number):
    if log_root_dir is None:
        return None
    gen_dir = join_path(log_root_dir, f'gen{generation_number}')
    mkdir(gen_dir)
    return gen_dir


def _ratio(numerator, denominator):
    """numerator/denominator, NaN on an empty denominator."""
    return numerator / denominator if denominator else np.nan


class PerformanceReport:
    """Pruning-performance telemetry, aggregated per image and per task into
    ``performance.csv`` (counter names and column order are the on-disk
    contract; cf. ``superdsm/globalenergymin.py:23-94``).

    Counters: ``direct_solution_trial_count`` (Criterion 2 evaluated) /
    ``direct_solution_success_count`` (it yielded a closed-form solution);
    ``iterative_[computed_]object_count`` (bruteforce vs Algorithm 1);
    ``overall_[computed_]object_count`` (without vs with Alg. 1 + Crit. 2);
    ``nontrivial_[computed_]object_count`` (excluding clusters of <= 2
    atoms). Derived success/pruning rates are properties.
    """

    attributes = [
        'direct_solution_trial_count',
        'direct_solution_success_count',
        'iterative_object_count',
        'iterative_computed_object_count',
        'overall_object_count',
        'overall_computed_object_count',
        'nontrivial_object_count',
        'nontrivial_computed_object_count',
    ]

    def __init__(self, **counts):
        unknown = set(counts) - set(self.attributes)
        assert not unknown, unknown
        self.__dict__.update({key: counts.get(key, 0)
                              for key in self.attributes})

    @property
    def direct_solution_success(self):
        return _ratio(self.direct_solution_success_count,
                      self.direct_solution_trial_count)

    @property
    def iterative_pruning_success(self):
        return 1 - _ratio(self.iterative_computed_object_count,
                          self.iterative_object_count)

    @property
    def overall_pruning_success(self):
        return 1 - _ratio(self.overall_computed_object_count,
                          self.overall_object_count)

    @property
    def nontrivial_pruning_success(self):
        """Pruned fraction within non-trivial clusters — the key indicator."""
        return 1 - _ratio(self.nontrivial_computed_object_count,
                          self.nontrivial_object_count)

    def __iadd__(self, other):
        for key in self.attributes:
            self.__dict__[key] += getattr(other, key)
        return self

    def _assert_integrity(self):
        for value in (self.direct_solution_success, self.iterative_pruning_success,
                      self.nontrivial_pruning_success, self.overall_pruning_success):
            assert np.isnan(value) or (0 <= value <= 1)


class GlobalEnergyMinimization(Stage):
    """Global energy minimization stage.

    Hyperparameters (namespace ``global-energy-minimization``): ``pruning``
    ('exact' or 'isbi24', default 'exact'), ``beta`` (default 0; auto
    ``AF_beta * scale^2`` with AF_beta=0.66), ``max_iter`` (default 5),
    ``gamma`` (default 0.8), ``max_seed_distance`` (default inf; auto
    ``AF_max_seed_distance * diameter``), ``max_work_amount`` (default 1e6).
    """

    ENABLED_BY_DEFAULT = True

    def __init__(self):
        super().__init__('global-energy-minimization',
                         inputs=['y', 'y_mask', 'atoms', 'adjacencies', 'dsm_cfg'],
                         outputs=['y_img', 'cover', 'objects', 'performance'])

    def process(self, input_data, cfg, out, log_root_dir):
        y_img = Image.create_from_array(input_data['y'], normalize=False,
                                        mask=input_data['y_mask'])
        atoms = input_data['atoms']
        adjacencies = input_data['adjacencies']
        pruning = cfg.get('pruning', 'exact')
        beta = cfg.get('beta', 0)
        max_iter = cfg.get('max_iter', DEFAULT_MAX_ITER)
        gamma = cfg.get('gamma', DEFAULT_GAMMA)
        max_seed_distance = cfg.get('max_seed_distance', np.inf)
        max_work_amount = cfg.get('max_work_amount', DEFAULT_MAX_WORK_AMOUNT)

        assert 0 < gamma < 1
        assert pruning in ('exact', 'isbi24')

        dsm_cfg = copy_dict(input_data['dsm_cfg'])
        cover, objects, performance = _compute_generations(
            adjacencies, y_img, atoms, log_root_dir, pruning, dsm_cfg, beta,
            max_iter, gamma, max_seed_distance, max_work_amount, out)[2:]

        return {
            'y_img': y_img,
            'cover': cover,
            'objects': objects,
            'performance': performance,
        }

    def configure_ex(self, scale, radius, diameter):
        return {
            'beta': (scale ** 2, 0.66),
            'max_seed_distance': (diameter, np.inf),
        }


def _compute_generations(adjacencies, y_img, atoms_map, log_root_dir, pruning,
                         dsm_cfg, beta=np.nan, max_iter=DEFAULT_MAX_ITER,
                         gamma=DEFAULT_GAMMA, max_seed_distance=np.inf,
                         max_work_amount=DEFAULT_MAX_WORK_AMOUNT, out=None):
    out = get_output(out)

    def _candidate(footprint):
        obj = Object()
        obj.footprint = set(footprint)
        return obj

    atoms = [_candidate({label}) for label in sorted(adjacencies.atom_labels)]
    out.write('\nIteration 1:')

    cluster_labels = sorted(adjacencies.cluster_labels)
    universes = [_candidate(adjacencies.get_atoms_in_cluster(label))
                 for label in cluster_labels]
    # atoms and universes are solved in ONE batched pass (the reference runs
    # two separate Ray fan-outs, globalenergymin.py:186-199)
    compute_objects(atoms + universes, y_img, atoms_map, dsm_cfg,
                    _get_generation_log_dir(log_root_dir, 1),
                    ('Computing atom and universe costs',
                     'Atom and universe costs computed'), out=out)

    atom_by_label = {next(iter(c.footprint)): c for c in atoms}
    directly_solved_cluster_labels = set()  # solved via Criterion 2
    trivial_cluster_labels = set()          # universe cardinality 1 or 2
    for cluster_label, universe in zip(cluster_labels, universes):
        if len(universe.footprint) <= 2:
            trivial_cluster_labels |= {cluster_label}
        atoms_in_cluster = [atom_by_label[atom_label]
                            for atom_label in adjacencies.get_atoms_in_cluster(cluster_label)]
        if not all(atom.is_optimal for atom in atoms_in_cluster):
            continue
        atom_energies_sum = sum(atom.energy for atom in atoms_in_cluster)
        # decision-quantized Criterion 2 (recompile stability, _stability.py)
        if dq(universe.energy) <= dq(beta + atom_energies_sum):
            directly_solved_cluster_labels |= {cluster_label}

    cover = MinSetCover(atoms, beta, adjacencies, max_iter=max_iter, gamma=gamma)
    cover.update(universes, get_output(None).derive(muted=True))
    costs = [cover.costs]
    out.write(f'Solution costs: {costs[-1]:,g}')
    out.write(f'Clusters solved directly: {len(directly_solved_cluster_labels)} / '
              f'{len(cluster_labels)}')
    performance = PerformanceReport(
        direct_solution_trial_count=len(cluster_labels),
        direct_solution_success_count=len(directly_solved_cluster_labels))

    def __estimate_progress(**kwargs):
        return _estimate_progress(generations, adjacencies, max_seed_distance,
                                  max_amount=max_work_amount, skip_last=True, **kwargs)

    generations = [atoms]
    objects = atoms + universes
    performance.nontrivial_object_count = __estimate_progress(
        ignored_cluster_labels=trivial_cluster_labels)[1]
    performance.overall_object_count = performance.nontrivial_object_count + len(objects)
    performance.iterative_object_count = __estimate_progress(
        ignored_cluster_labels=directly_solved_cluster_labels)[1]
    performance.overall_computed_object_count = len(objects)

    if len(directly_solved_cluster_labels) < len(cluster_labels):
        while True:
            generation_number = 1 + len(generations)
            generation_label = f'Iteration {generation_number}'
            out.write('')
            out.intermediate(f'{generation_label}...')

            finished_amount, remaining_amount = __estimate_progress(
                ignored_cluster_labels=directly_solved_cluster_labels)
            total_amount = finished_amount + remaining_amount
            progress_text = ('progress unknown' if np.isnan(total_amount)
                             else f'(finished '
                                  f'{100 * finished_amount / total_amount:.0f}% '
                                  f'or more)')
            out.write(f'{generation_label}: {Text.style(progress_text, Text.BOLD)}')

            new_generation, new_objects = _process_generation(
                cover, objects, generations[-1], y_img, atoms_map, adjacencies,
                dsm_cfg, max_seed_distance,
                _get_generation_log_dir(log_root_dir, generation_number),
                pruning, directly_solved_cluster_labels, out)
            objects += new_objects
            performance.iterative_computed_object_count += len(new_objects)

            if len(new_generation) == 0:
                break
            generations.append(new_generation)

            cover.update(new_generation, get_output(None).derive(muted=True))
            costs.append(cover.costs)
            out.write(f'Solution costs: {costs[-1]:,g}')

    performance.nontrivial_computed_object_count += performance.iterative_computed_object_count
    performance.overall_computed_object_count += performance.iterative_computed_object_count
    performance._assert_integrity()

    out.write('')
    out.write(f'Non-trivial pruning: {100 * performance.nontrivial_pruning_success:.1f}% '
              f'(computed {performance.nontrivial_computed_object_count} / '
              f'{performance.nontrivial_object_count})')
    return generations, costs, cover, objects, performance


def _get_max_distance(footprint, new_atom_label, adjacencies):
    """Maximum distance between the new atom's seed and the footprint seeds."""
    assert new_atom_label not in footprint
    if not footprint:  # keep the pre-vectorization contract (benign 0)
        return 0.0
    new_atom_seed = np.asarray(adjacencies.get_seed(new_atom_label), float)
    seeds = np.asarray([adjacencies.get_seed(label) for label in footprint],
                       float)
    return float(np.linalg.norm(seeds - new_atom_seed, axis=1).max())


def _is_within_max_seed_distance(footprint, new_atom_label, adjacencies, max_seed_distance):
    if np.isinf(max_seed_distance):
        return True
    return _get_max_distance(footprint, new_atom_label, adjacencies) <= max_seed_distance


class _FootprintExpansion:
    """Deduplicated one-atom footprint growth — the expansion step of
    Algorithm 1 (TPAMI 2023). Each candidate of a generation is an existing
    footprint plus one adjacent atom within the seed-distance cap; a grown
    footprint reachable from several parents is attributed to the first
    parent only (parents in caller order, frontier atoms in sorted label
    order — part of the determinism contract, see docs/stability.md).

    One instance holds the dedup set for one generation; call :meth:`grow`
    once per parent footprint.
    """

    def __init__(self, adjacencies, max_seed_distance,
                 ignored_cluster_labels=frozenset(), skip_last=False):
        self._adjacencies = adjacencies
        self._max_seed_distance = max_seed_distance
        self._ignored = ignored_cluster_labels
        self._skip_last = skip_last
        self._seen = set()

    def _expandable(self, footprint, cluster_label):
        if cluster_label in self._ignored:
            return False
        if not self._skip_last:
            return True
        # growing by one atom would reach the full cluster = the universe,
        # which is always solved upfront — skip re-deriving it
        cluster_size = len(self._adjacencies.get_atoms_in_cluster(cluster_label))
        return len(footprint) + 1 != cluster_size

    def _frontier(self, footprint):
        adjacent = set()
        for atom_label in footprint:
            adjacent |= self._adjacencies[atom_label]
        return sorted(adjacent - footprint)

    def grow(self, footprint):
        """Yields ``(grown_footprint, added_label)`` for each fresh one-atom
        extension of ``footprint``."""
        cluster_label = self._adjacencies.get_cluster_label(next(iter(footprint)))
        if not self._expandable(footprint, cluster_label):
            return
        for added_label in self._frontier(footprint):
            if not _is_within_max_seed_distance(footprint, added_label,
                                                self._adjacencies,
                                                self._max_seed_distance):
                continue
            grown = frozenset(footprint | {added_label})
            if grown not in self._seen:
                self._seen.add(grown)
                yield grown, added_label


def _estimate_progress(generations, adjacencies, max_seed_distance,
                       max_amount=DEFAULT_MAX_WORK_AMOUNT,
                       ignored_cluster_labels=set(), skip_last=False):
    """(finished, remaining) candidate counts for Algorithm 1's progress
    display: simulates the full remaining expansion wavefront by wavefront
    (footprints only, nothing solved) and raises :class:`ValueError` once
    the count exceeds ``max_amount`` — the ``max_work_amount`` guard."""
    finished_amount = sum(len(generation) for generation in generations)
    frontier = [obj.footprint for obj in generations[-1]]
    remaining_amount = 0
    while frontier:
        expansion = _FootprintExpansion(adjacencies, max_seed_distance,
                                        ignored_cluster_labels, skip_last)
        frontier = [grown for footprint in frontier
                    for grown, _ in expansion.grow(footprint)]
        remaining_amount += len(frontier)
        if remaining_amount > max_amount:
            raise ValueError('estimated work amount is too large')
    return finished_amount, remaining_amount


def _exact_candidate_bounds(cover, objects, adjacencies, parent, added_label,
                            footprint, cluster_costs):
    """(lower, upper) cost bounds for one candidate under exact pruning.

    Upper bound: the cluster's current MSC solution costs minus a lower
    bound for covering the atoms outside the candidate (their singleton
    energies) — if the candidate is part of a better cover, its costs
    cannot exceed this. Lower bound: ``beta`` plus the better of the
    monotonicity bound (parent energy + added atom energy) and the
    max-set-packing bound over already-solved optimal subsets of the
    candidate. ``cluster_costs`` memoizes MSC costs per cluster.
    """
    cluster_label = adjacencies.get_cluster_label(added_label)
    if cluster_label not in cluster_costs:
        cluster_costs[cluster_label] = cover.get_cluster_costs(cluster_label)
    uncovered = adjacencies.get_atoms_in_cluster(cluster_label) - footprint
    upper = cluster_costs[cluster_label] \
        - sum(cover.get_atom(label).energy for label in uncovered)
    solved_subsets = [obj for obj in objects
                      if obj.is_optimal and obj.footprint.issubset(footprint)]
    packing_energy = sum(obj.energy for obj in solve_maxsetpack(
        solved_subsets, out=get_output(None).derive(muted=True)))
    lower = cover.beta + max(
        parent.energy + cover.get_atom(added_label).energy, packing_energy)
    return lower, upper


def _process_generation(cover, objects, previous_generation, y, atoms_map,
                        adjacencies, dsm_cfg, max_seed_distance, log_root_dir,
                        pruning, ignored_cluster_labels, out):
    """Grows the next generation of candidates, prunes them by cost bounds
    ('exact': Algorithm 1 bounds; 'isbi24': greedy threshold), batch-solves
    the survivors on device in ONE :func:`compute_objects` call, and applies
    the post-solve survival threshold. Returns ``(next_generation,
    new_objects)`` where the former feeds the following iteration."""
    expansion = _FootprintExpansion(adjacencies, max_seed_distance,
                                    ignored_cluster_labels, skip_last=True)
    candidates, thresholds = [], []
    discarded = 0
    cluster_costs = {}
    for parent in previous_generation:
        for footprint, added_label in expansion.grow(parent.footprint):
            candidate = Object()
            candidate.footprint = footprint
            candidate.init_from = parent  # warm-start from the parent's solution
            if pruning == 'exact':
                lower, upper = _exact_candidate_bounds(
                    cover, objects, adjacencies, parent, added_label,
                    footprint, cluster_costs)
                # decision-quantized pruning bound (recompile stability):
                # discarding is conservative, so a stable-near-tie keeps the
                # candidate (it is then pruned or kept by its own solved
                # energy)
                if dq(upper) < dq(lower):
                    discarded += 1
                    continue
                thresholds.append(upper - cover.beta)
            elif pruning == 'isbi24':
                thresholds.append(parent.energy
                                  + cover.get_atom(added_label).energy
                                  + cover.beta)
            else:
                raise ValueError(f'Unknown pruning mode "{pruning}"')
            candidates.append(candidate)

    compute_objects(candidates, y, atoms_map, dsm_cfg, log_root_dir, out=out)

    next_generation = []
    for cidx, (candidate, threshold) in enumerate(zip(candidates, thresholds)):
        candidate.cidx = cidx
        # decision-quantized survival threshold (recompile stability)
        if dq(candidate.energy) < dq(threshold):
            next_generation.append(candidate)
        else:
            discarded += 1
            candidate.fg_fragment = None  # only footprint + energy still needed
    out.write(f'Next iteration: {len(next_generation)} '
              f'({discarded} discarded, {pruning} pruning)')
    return next_generation, candidates
