"""The environment knobs that both packages read, held to the same values.

Each knob is read once, when its module is imported, so the env names go to
one fresh interpreter per package with every knob set off its default; each
constant the knob sets must come out the same in both. The defaults are
compared in this process. Then ``SDSM_CANONICAL_RESOLVE=0`` is held by its
behaviour: with the re-solve off, a lane left unconverged keeps its
batch-solve result in both packages, and the port's energies and
foregrounds match the JAX package's within ``tests/test_torch_solver.py``'s
tolerances.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from superdsm_tpu.dsm import batching as jbatching
from superdsm_tpu.dsm import solver as jsolver
from superdsm_tpu.image import Image as JImage
from superdsm_tpu.ops import gaussian as jgaussian

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import batching as tbatching
from superdsm_tpu_torch.dsm import solver as tsolver
from superdsm_tpu_torch.image import Image as TImage
from superdsm_tpu_torch.ops import gaussian as tgaussian
from test_torch_solver import _blob_images

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Every knob off its default (the bucket list drops two pixel buckets).
KNOB_ENV = {'SDSM_CANONICAL_RESOLVE': '0', 'SDSM_CHOL_MAX_N': '200',
            'SDSM_DROP_BUCKETS': '6144, 24576', 'SDSM_GAUSS_TOEPLITZ_TAPS': '33'}

#: Per knob, the constant it sets: (module, attribute), the same in both
#: packages.
CONSTANTS = {'SDSM_CANONICAL_RESOLVE': ('dsm.batching', '_CANONICAL_RESOLVE'),
             'SDSM_CHOL_MAX_N': ('dsm.solver', 'CHOLESKY_MAX_N'),
             'SDSM_DROP_BUCKETS': ('dsm.batching', 'P_BUCKETS'),
             'SDSM_GAUSS_TOEPLITZ_TAPS': ('ops.gaussian', 'TOEPLITZ_MIN_TAPS')}

_READ = """
import importlib, json, sys
out = {}
for knob, (module, attr) in json.loads(sys.argv[2]).items():
    out[knob] = getattr(importlib.import_module(sys.argv[1] + '.' + module), attr)
print(json.dumps(out))
"""


@pytest.fixture(scope='module')
def knob_values():
    """The constants as each package sets them under :data:`KNOB_ENV`, each
    package in a fresh interpreter."""
    env = {k: v for k, v in os.environ.items() if not k.startswith('SDSM_')}
    env.update(KNOB_ENV, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    values = {}
    for package in ('superdsm_tpu', 'superdsm_tpu_torch'):
        proc = subprocess.run([sys.executable, '-c', _READ, package,
                               json.dumps(CONSTANTS)], env=env, cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        values[package] = json.loads(proc.stdout.strip().splitlines()[-1])
    return values


@pytest.mark.parametrize('knob', sorted(CONSTANTS))
def test_knob_sets_the_same_constant_in_both_packages(knob, knob_values):
    jax_value = knob_values['superdsm_tpu'][knob]
    assert knob_values['superdsm_tpu_torch'][knob] == jax_value
    module, attr = CONSTANTS[knob]
    default = getattr({'dsm.batching': tbatching, 'dsm.solver': tsolver,
                       'ops.gaussian': tgaussian}[module], attr)
    # the knob moved the constant off its default
    assert jax_value != default, (knob, jax_value)


def test_knob_defaults_agree():
    """This process's constants agree between the packages (both read the
    same environment), and are the defaults where the knob is unset."""
    assert tbatching._CANONICAL_RESOLVE is jbatching._CANONICAL_RESOLVE
    assert tsolver.CHOLESKY_MAX_N == jsolver.CHOLESKY_MAX_N
    assert tbatching.P_BUCKETS == jbatching.P_BUCKETS
    assert tgaussian.TOEPLITZ_MIN_TAPS == jgaussian.TOEPLITZ_MIN_TAPS
    defaults = {'SDSM_CANONICAL_RESOLVE': (tbatching._CANONICAL_RESOLVE, True),
                'SDSM_CHOL_MAX_N': (tsolver.CHOLESKY_MAX_N, 300),
                'SDSM_DROP_BUCKETS': (len(tbatching.P_BUCKETS), 10),
                'SDSM_GAUSS_TOEPLITZ_TAPS': (tgaussian.TOEPLITZ_MIN_TAPS, 64)}
    for knob, (value, default) in defaults.items():
        if not os.environ.get(knob):
            assert value == default, knob
    # the frozen canonical ladders never follow the runtime ladder
    assert tbatching._CANONICAL_P_LADDER == jbatching._CANONICAL_P_LADDER
    assert tbatching._CANONICAL_K_LADDER == jbatching._CANONICAL_K_LADDER


@pytest.mark.parametrize('case', ['cold', 'warm', 'dropped bucket'])
def test_canonical_resolve_kept_lanes_are_bitwise_resolved(monkeypatch, case):
    """A flagged lane whose chunk already had its canonical buckets and
    start keeps its batch result: re-solving it anyway (as before the skip)
    gives every lane the same bits. The lanes of the truncated six-problem
    solve, cold, all warm-started from a short cold solve, and cold with
    their canonical pixel buckets dropped from the ladder (as
    ``SDSM_DROP_BUCKETS`` does), where every flagged lane is re-solved."""
    images = _blob_images(7, 6)
    kw = dict(smooth_amount=4, smooth_subsample=6)
    solve = dict(alpha=0.05, smooth_amount=4, maxiter=4)
    with T.use_device('cpu'):
        tp = [tbatching.make_problem(TImage(model=y), tag=i, **kw)
              for i, y in enumerate(images)]
        if case == 'warm':
            starts = tbatching.solve_problems(tp, **dict(solve, maxiter=2))
            for p, r in zip(tp, starts):
                p.init_params = r.params
        if case == 'dropped bucket':
            drop = {tbatching._canonical_buckets(p)[0] for p in tp}
            monkeypatch.setattr(tbatching, 'P_BUCKETS',
                                [b for b in tbatching.P_BUCKETS if b not in drop])
        canonical = tbatching._batch_was_canonical
        decided = []

        def recording(p, *args):
            decided.append(canonical(p, *args))
            return decided[-1]
        monkeypatch.setattr(tbatching, '_batch_was_canonical', recording)
        kept = tbatching.solve_problems(tp, **solve)
        assert decided, 'the fixture must leave a lane unconverged'
        assert any(decided) == (case != 'dropped bucket')
        monkeypatch.setattr(tbatching, '_batch_was_canonical', lambda *a: False)
        before = tbatching.device_accounting()['canonical_lanes']
        forced = tbatching.solve_problems(tp, **solve)
        assert (tbatching.device_accounting()['canonical_lanes'] - before
                == len(tbatching._LAST_FLAGGED))
    for a, b in zip(kept, forced):
        assert a.energy == b.energy and a.status == b.status
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.fg, b.fg)


def test_canonical_resolve_off_keeps_truncated_lanes(monkeypatch):
    """The six DSM problems of ``tests/test_torch_solver.py``'s lane-by-lane
    test, cut to 4 Newton iterations so that four lanes stay unconverged
    (at its 25 every lane converges). With the re-solve on, those lanes are
    flagged, and each whose chunk was not already canonical is solved again
    (alone, giving its batch result bitwise: a lane's result does not
    depend on its batch); with it off (the constant
    ``SDSM_CANONICAL_RESOLVE=0`` sets), neither package flags or re-solves
    any lane, every lane keeps its result bitwise, and the port matches the
    JAX package: the same status, foregrounds on >= 99% of the pixels,
    converged energies to rtol 1e-4."""
    images = _blob_images(7, 6)
    kw = dict(smooth_amount=4, smooth_subsample=6)
    jp = [jbatching.make_problem(JImage(model=y), tag=i, **kw)
          for i, y in enumerate(images)]
    tp = [tbatching.make_problem(TImage(model=y), tag=i, **kw)
          for i, y in enumerate(images)]
    solve = dict(alpha=0.05, smooth_amount=4, maxiter=4)
    resolved = lambda: tbatching.device_accounting()['canonical_lanes']
    canonical = tbatching._batch_was_canonical
    kept = {}  # tag -> the lane's chunk was canonical (no re-solve)

    def recording(p, *args):
        kept[p.tag] = canonical(p, *args)
        return kept[p.tag]
    monkeypatch.setattr(tbatching, '_batch_was_canonical', recording)
    with T.use_device('cpu'):
        before = resolved()
        on_t = tbatching.solve_problems(tp, **solve)
        flagged = list(tbatching._LAST_FLAGGED)
        assert flagged, 'the fixture must leave a lane unconverged'
        assert sorted(kept) == sorted(flagged)
        assert resolved() - before == sum(not k for k in kept.values())
        monkeypatch.setattr(tbatching, '_CANONICAL_RESOLVE', False)
        monkeypatch.setattr(jbatching, '_CANONICAL_RESOLVE', False)
        before = resolved()
        off_t = tbatching.solve_problems(tp, **solve)
        assert tbatching._LAST_FLAGGED == []
        assert resolved() == before
    off_j = jbatching.solve_problems(jp, **solve)
    assert jbatching._LAST_FLAGGED == []
    for i, (a, b, on) in enumerate(zip(off_t, off_j, on_t)):
        assert a.status == b.status
        assert (a.fg == b.fg).mean() >= 0.99
        if i in flagged:
            # the batch solve's result (no lane was re-solved, counted
            # above); the canonical re-solve, a batch of one in these
            # buckets, gave it bitwise again: a lane's result does not
            # depend on its batch
            assert a.energy == on.energy
            np.testing.assert_allclose(a.params, on.params, rtol=0, atol=0)
        else:
            assert a.energy == on.energy
            np.testing.assert_allclose(a.params, on.params, rtol=0, atol=0)
            np.testing.assert_allclose(a.energy, b.energy, rtol=1e-4)
