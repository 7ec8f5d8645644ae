"""Min-weight set cover of atomic regions by candidate objects.

Implements Algorithm 2 of Kostrykin & Rohr (TPAMI 2023) with the same
semantics as the reference (``superdsm/minsetcover.py``):
greedy price-driven selection, a merge step that replaces groups of accepted
objects by a cheaper superset, and recursive retries with a reduced sparsity
parameter ``beta <- gamma * beta``, keeping the cheaper solution.

:class:`MinSetCover` maintains per-cluster candidate pools so that adding new
candidate objects only re-solves the touched clusters.
"""

from .output import get_output
from ._stability import dq, fp_order

DEFAULT_MAX_ITER = 5
DEFAULT_GAMMA = 0.8


def _merge_step(objects, accepted_objects, beta):
    """Replaces groups of accepted objects by a cheaper superset object.

    All weight comparisons are decision-quantized with a footprint
    tie-break (:mod:`superdsm_tpu_torch._stability`): the sweep order and the
    replacement test would otherwise flip on recompile-class energy drift.
    """
    replacements_count = 0
    w = lambda c: c.energy + beta
    accepted = list(accepted_objects)
    accepted_set = set(map(id, accepted))
    for c_new in sorted((c for c in objects if id(c) not in accepted_set),
                        key=lambda c: (dq(w(c)), fp_order(c))):
        blockers = []
        valid_replacement = True
        for c in accepted:
            overlap = len(c.footprint & c_new.footprint)
            if overlap == 0:
                continue
            if overlap < len(c.footprint):
                valid_replacement = False
                break
            blockers.append(c)
        if not valid_replacement:
            continue
        if dq(w(c_new)) < dq(sum(w(c) for c in blockers)):
            replacements_count += len(blockers)
            blocker_ids = set(map(id, blockers))
            accepted = [c for c in accepted if id(c) not in blocker_ids] + [c_new]
    return accepted, replacements_count


def _solve_greedy(objects, beta, merge=True, out=None):
    out = get_output(out)
    w = lambda c: c.energy + beta
    accepted_objects = []
    remaining_objects = list(objects)
    uncovered_atoms = set()
    for c in objects:
        uncovered_atoms |= c.footprint

    while remaining_objects:
        # price argmin on quantized values with a deterministic footprint
        # tie-break — near-tie candidates (within recompile drift of each
        # other) select stably instead of flipping per recompile
        best_object = min(remaining_objects,
                          key=lambda c: (dq(w(c) / len(c.footprint & uncovered_atoms)),
                                         fp_order(c)))
        accepted_objects.append(best_object)
        uncovered_atoms -= best_object.footprint
        remaining_objects = [c for c in remaining_objects
                             if len(c.footprint & uncovered_atoms) > 0]

    out.write(f'MINSETCOVER - GREEDY accepted objects: {len(accepted_objects)}')
    if merge:
        accepted_objects, replacements_count = _merge_step(objects, accepted_objects, beta)
        out.write(f'MINSETCOVER - MERGED objects: {replacements_count}')
    return accepted_objects


def solve_minsetcover(objects, beta, merge=True, max_iter=DEFAULT_MAX_ITER,
                      gamma=DEFAULT_GAMMA, out=None):
    """Approximate min-weight set cover (Algorithm 2, TPAMI 2023).

    :param objects: Candidate sets; ``c.energy`` is the set energy ν(X).
    :param beta: Sparsity parameter β >= 0.
    :param merge: Whether to run the merge step.
    :param max_iter: Retries with increasingly conservative merging.
    :param gamma: β reduction factor per retry (0 < γ < 1).
    """
    assert beta >= 0
    assert 0 < gamma < 1
    out = get_output(out)
    solution1 = _solve_greedy(objects, beta, merge, out)
    if max_iter > 1 and beta > 0:
        new_beta = beta * gamma
        out.write(f'MINSETCOVER retry with lower beta: {new_beta:g}')
        solution2 = solve_minsetcover(objects, new_beta, merge, max_iter - 1, gamma, out)
        solution1_value = _cover_value(solution1, beta)
        solution2_value = _cover_value(solution2, beta)
        if dq(solution2_value) < dq(solution1_value):
            out.write(f'MINSETCOVER solution for beta={beta:g} improved by '
                      f'{solution2_value - solution1_value:,g} '
                      f'(-{100 * (1 - solution2_value / solution1_value):.2f}%)')
            return solution2
    return solution1


def _cover_value(family, beta):
    """Σ (β + ν(X)) of a candidate family."""
    return sum(c.energy for c in family) + beta * len(family)


class MinSetCover:
    """An incrementally maintained min-weight set-cover instance.

    The candidate family starts with the singleton atoms; :meth:`update`
    adds new candidate objects and re-solves only the clusters they touch.
    """

    def __init__(self, atoms, beta, adjacencies, **solve_minsetcover_kwargs):
        self.beta = beta
        self.adjacencies = adjacencies
        self.solve_minsetcover_kwargs = solve_minsetcover_kwargs
        self.atoms = {}
        self.objects_by_cluster = {cluster: []
                                   for cluster in adjacencies.cluster_labels}
        for atom in atoms:
            (label,) = atom.footprint  # singletons by construction
            self.atoms[label] = atom
            self.objects_by_cluster[adjacencies.get_cluster_label(label)] \
                .append(atom)
        # the initial per-cluster solution IS the atom family (aliased on
        # purpose: update() re-solves a cluster right after appending to it)
        self.solution_by_cluster = dict(self.objects_by_cluster)

    def get_atom(self, atom_label):
        """The singleton object of an atomic region."""
        return self.atoms[atom_label]

    def update(self, new_objects, out=None):
        """Adds candidates and re-solves the clusters they touch."""
        touched = set()
        for new_object in new_objects:
            cluster = self.adjacencies.get_cluster_label(
                next(iter(new_object.footprint)))
            self.objects_by_cluster[cluster].append(new_object)
            touched.add(cluster)
        for cluster in touched:
            self.solution_by_cluster[cluster] = solve_minsetcover(
                self.objects_by_cluster[cluster], self.beta, out=out,
                **self.solve_minsetcover_kwargs)

    def get_cluster_costs(self, cluster_label):
        """MSC value restricted to one cluster."""
        return _cover_value(self.solution_by_cluster[cluster_label], self.beta)

    @property
    def solution(self):
        """The selected family of objects (all clusters)."""
        return [c for partial in self.solution_by_cluster.values()
                for c in partial]

    @property
    def costs(self):
        """Total cover cost Σ (β + ν(X))."""
        return _cover_value(self.solution, self.beta)
