"""The port's ``objects.Energy``, ``objects.cvxprog`` and the
``SDSM_DEBUG_FOOTPRINT`` dump against the JAX package's, on the CPU.

- ``Energy``: the port's evaluator at the JAX solution's parameters equals
  the JAX ``Energy`` there to rtol 1e-6.
- ``cvxprog`` on the 48x48 disk of ``tests/test_objects.py``: status
  ``optimal`` in both packages, foreground IoU >= 0.99 between them.
- The debug dump of ``tests/test_objects.py`` (a 32x32 disk, footprint
  ``{1}``): the same keys, footprint, ``n_pixels``, ``n_deform`` and trace
  length as the JAX record, the final energy to rtol 1e-3.
"""

import json

import numpy as np
import pytest
import torch

import superdsm_tpu_torch as T

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with T.use_device('cpu'):
        yield


def _disk48():
    rr, cc = np.indices((48, 48))
    return (((rr - 24) ** 2 + (cc - 24) ** 2) < 144).astype(float) - 0.5


CVX_ARGS = dict(smooth_amount=4, smooth_subsample=8, alpha=0.1)


@pytest.fixture(scope='module')
def cvx_pair():
    from superdsm_tpu.image import Image as JImage
    from superdsm_tpu.objects import cvxprog as jcvxprog
    from superdsm_tpu_torch.image import Image as PImage
    from superdsm_tpu_torch.objects import cvxprog as pcvxprog
    y = _disk48()
    with T.use_device('cpu'):
        return (jcvxprog(JImage(y), **CVX_ARGS), pcvxprog(PImage(y), **CVX_ARGS), y)


def test_energy_equals_jax_at_the_jax_solution(cvx_pair):
    (J_jax, model_jax, _), (J_port, _, _), _ = cvx_pair
    assert J_port.p.n_deform == J_jax.p.n_deform > 0
    np.testing.assert_allclose(J_port.smooth_mat, J_jax.smooth_mat, rtol=1e-6,
                               atol=1e-7)
    for params in (model_jax, np.asarray(model_jax.array) * 0.5):
        np.testing.assert_allclose(J_port(params), J_jax(params), rtol=1e-6)


def test_cvxprog_matches_jax(cvx_pair):
    (J_jax, model_jax, status_jax), (J_port, model_port, status_port), y = cvx_pair
    assert status_jax == status_port == 'optimal'
    assert np.isfinite(J_port(model_port))
    grid = np.stack(np.indices((48, 48))).astype(float) / 47.0
    fg_jax, fg_port = model_jax.s(grid) > 0, model_port.s(grid) > 0
    assert (fg_jax & fg_port).sum() / (fg_jax | fg_port).sum() >= 0.99
    true = y > 0
    assert (fg_port & true).sum() / (fg_port | true).sum() > 0.9


def _debug_record(pkg, tmp_path, monkeypatch):
    import importlib
    image = importlib.import_module(f'{pkg}.image')
    objects = importlib.import_module(f'{pkg}.objects')
    H, W = 32, 32
    rr, cc = np.indices((H, W))
    disk = ((rr - 16.0) ** 2 + (cc - 16.0) ** 2) <= 8.0 ** 2
    y = image.Image(model=disk.astype(np.float32) - 0.5)
    obj = objects.Object()
    obj.footprint = frozenset([1])
    monkeypatch.setenv('SDSM_DEBUG_FOOTPRINT', '1')
    dsm_cfg = {'smooth_amount': 4, 'smooth_subsample': 6, 'alpha': 0.05,
               'background_margin': 6, 'newton_maxiter': 8}
    out = tmp_path / pkg
    objects.compute_objects([obj], y, disk.astype(int), dsm_cfg, log_root_dir=str(out))
    return json.loads((out / 'debug_object_1.json').read_text())


def test_debug_footprint_dump_matches_jax(tmp_path, monkeypatch):
    ref = _debug_record('superdsm_tpu', tmp_path, monkeypatch)
    got = _debug_record('superdsm_tpu_torch', tmp_path, monkeypatch)
    assert sorted(got) == sorted(ref)
    assert got['footprint'] == ref['footprint'] == [1]
    for key in ('n_pixels', 'n_deform', 'warm_started', 'status'):
        assert got[key] == ref[key], key
    assert len(got['energy_trace']) == len(ref['energy_trace']) >= 2
    assert [t['iterations'] for t in got['energy_trace']] == \
        [t['iterations'] for t in ref['energy_trace']]
    np.testing.assert_allclose(got['energy'], ref['energy'], rtol=1e-3)
    energies = [t['energy'] for t in got['energy_trace']]
    assert energies[-1] <= energies[0] + 1e-6


def test_debug_footprint_dump_to_stderr(monkeypatch, capsys):
    """Without a log directory the record goes to stderr."""
    from superdsm_tpu_torch.image import Image
    from superdsm_tpu_torch.objects import Object, compute_objects
    rr, cc = np.indices((24, 24))
    disk = ((rr - 12.0) ** 2 + (cc - 12.0) ** 2) <= 6.0 ** 2
    obj = Object()
    obj.footprint = frozenset([1])
    monkeypatch.setenv('SDSM_DEBUG_FOOTPRINT', '1')
    compute_objects([obj], Image(model=disk.astype(np.float32) - 0.5),
                    disk.astype(int), {'smooth_amount': 4, 'smooth_subsample': 6,
                                       'newton_maxiter': 4})
    lines = [line for line in capsys.readouterr().err.splitlines()
             if line.startswith('[SDSM_DEBUG_FOOTPRINT] ')]
    assert len(lines) == 1
    record = json.loads(lines[0].split(' ', 1)[1])
    assert record['footprint'] == [1] and record['n_pixels'] == int(disk.sum())
