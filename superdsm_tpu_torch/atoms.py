"""Adjacency graph of atomic image regions.

Counterpart of the reference's ``AtomAdjacencyGraph``
(``superdsm/atoms.py:19-291``). The construction is
vectorized: instead of dilating each atom mask separately, one pass over the
4/8-neighbor shifted label maps collects all adjacent label pairs inside the
cluster foreground at once.
"""

import numpy as np

from .output import get_output


def _find_seed_of_region(region, seeds):
    assert isinstance(region, np.ndarray) and region.dtype == bool
    candidates = [tuple(seed) for seed in seeds if region[tuple(seed)]]
    assert len(candidates) == 1, \
        f'There is no (unique) seed. Number of possible seeds: {len(candidates)}'
    return candidates[0]


class AtomAdjacencyGraph:
    """Graph of atomic image regions that touch within a cluster.

    Two atoms are adjacent iff their masks touch within the foreground of the
    cluster they belong to (disk(1) dilation semantics, i.e. 4-neighborhood,
    cf. ``superdsm/atoms.py:53-75``).

    :param atoms: Integer label map of atomic regions.
    :param clusters: Integer label map of cluster regions.
    :param fg_mask: Rough foreground mask (y > 0).
    :param seeds: Seed point (tuple) per atom, used for rendering edges.
    """

    def __init__(self, atoms, clusters, fg_mask, seeds, out=None):
        out = get_output(out)
        n_atoms = int(atoms.max())
        self._adjacencies = {atom_label: set() for atom_label in range(1, n_atoms + 1)}
        self._atoms_by_cluster = dict()
        self._cluster_by_atom = dict()
        self._seeds = dict()

        cluster_fg = np.where(fg_mask, clusters, 0)

        # collect touching (label, label) pairs via axis shifts; a pair is
        # adjacent iff the neighboring pixel lies in the same cluster's fg
        pairs = set()
        for dr, dc in ((0, 1), (1, 0)):
            a = atoms[: atoms.shape[0] - dr, : atoms.shape[1] - dc]
            b = atoms[dr:, dc:]
            ca = clusters[: atoms.shape[0] - dr, : atoms.shape[1] - dc]
            fb = cluster_fg[dr:, dc:]
            fa = cluster_fg[: atoms.shape[0] - dr, : atoms.shape[1] - dc]
            # neighbor must be foreground of the same cluster, labels differ
            sel = (a != b) & (a > 0) & (b > 0) & ((fb == ca) | (fa == clusters[dr:, dc:]))
            if sel.any():
                # dedup via scalar keys (np.unique over rows sorts rows —
                # much slower than over an int64 vector)
                keys = np.unique(a[sel].astype(np.int64) * (n_atoms + 1) + b[sel])
                for key in keys:
                    pairs.add((int(key // (n_atoms + 1)), int(key % (n_atoms + 1))))

        # per-atom cluster label in one labeled pass (atoms lie within exactly
        # one cluster, so the labeled minimum IS the label); seeds map back to
        # their atom by lookup — no full-frame scan per atom
        import scipy.ndimage as ndi
        present_labels = np.flatnonzero(np.bincount(
            atoms.ravel(), minlength=n_atoms + 1))
        present_labels = present_labels[present_labels > 0]
        present = set()
        if len(present_labels):
            cluster_of = ndi.minimum(clusters, labels=atoms, index=present_labels)
            for l0, cluster_label in zip(present_labels, cluster_of):
                l0, cluster_label = int(l0), int(cluster_label)
                present.add(l0)
                if cluster_label not in self._atoms_by_cluster:
                    self._atoms_by_cluster[cluster_label] = set()
                self._cluster_by_atom[l0] = cluster_label
                self._atoms_by_cluster[cluster_label] |= {l0}
        for seed in seeds:
            l0 = int(atoms[tuple(seed)])
            assert l0 in present and l0 not in self._seeds, \
                f'There is no (unique) seed for atom {l0}'
            self._seeds[l0] = tuple(seed)
        assert set(self._seeds) == present, 'There is no (unique) seed'
        for u, v in pairs:
            if u in self._cluster_by_atom and v in self._cluster_by_atom:
                self._adjacencies[u] |= {v}
                self._adjacencies[v] |= {u}
        out.write('Computed adjacency graph')
        assert self._is_symmetric()

    def __getitem__(self, atom_label):
        return self._adjacencies[atom_label]

    def get_cluster_label(self, atom_label):
        """Label of the cluster an atom belongs to."""
        return self._cluster_by_atom[atom_label]

    def get_atoms_in_cluster(self, cluster_label):
        """Set of atom labels in a cluster."""
        return self._atoms_by_cluster[cluster_label]

    @property
    def cluster_labels(self):
        return frozenset(self._atoms_by_cluster.keys())

    @property
    def atom_labels(self):
        return frozenset(self._cluster_by_atom.keys())

    def get_seed(self, atom_label):
        """Seed point (coordinate tuple) of an atom."""
        return self._seeds[atom_label]

    def get_edge_lines(self, accept='all', reduce=True):
        """List of seed-to-seed lines for the graph edges (for rendering)."""
        if isinstance(accept, str) and accept == 'all':
            accept = lambda atom_label: True
        assert callable(accept), f'Not a callable: {str(accept)}'
        lines = []
        for l in self.atom_labels:
            seed_l = self.get_seed(l)
            if not accept(l):
                continue
            for k in self[l]:
                seed_k = self.get_seed(k)
                if not accept(k):
                    continue
                if reduce and l > k:
                    continue
                lines.append((seed_l, seed_k))
        return lines

    @property
    def max_degree(self):
        return max(self.get_atom_degree(atom_label) for atom_label in self.atom_labels)

    def get_atom_degree(self, atom_label):
        """Number of adjacent atomic regions."""
        return len(self[atom_label])

    def _is_symmetric(self):
        for atom1 in self.atom_labels:
            if not all(atom1 in self[atom2] for atom2 in self[atom1]):
                return False
        return True
