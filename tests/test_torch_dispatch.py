"""The port's solver entry points outside the image path, against the JAX
package's, on the CPU.

- ``dsm.batching.warmup`` on two tiny shapes (one per transfer format)
  returns the JAX package's keys (read from the JAX function itself, on
  an empty shape list), counts two programs, arms the solve deadline for
  both shapes and normalizes 4-tuples with its statics, as there; the
  shipped shape lists are the JAX package's.
- ``dsm.solve_dsm_batch`` at (B, P, K) = (2, 256, 6) gives the JAX
  package's converged energies to rtol 1e-4 (``tests/test_torch_solver.py``'s
  tolerance) and its flags; ``superdsm_tpu_torch.dsm`` exports the JAX
  package's three names.
"""

import json
import os

import numpy as np
import pytest
import torch

import superdsm_tpu.dsm as jdsm
from superdsm_tpu.dsm import batching as jbatching

import superdsm_tpu_torch as T
import superdsm_tpu_torch.dsm as tdsm
from superdsm_tpu_torch.dsm import batching

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with T.use_device('cpu'):
        yield


TINY = [('poly-m', 2048, 0, 1), ('dsm', 2048, 26, 2, 1e-5, 4.0, 16)]


def test_warmup_keys_and_programs(monkeypatch):
    monkeypatch.setattr(batching, '_WARM_SHAPES', set())
    stats = batching.warmup(shapes=TINY, threads=2)
    assert set(stats) == set(jbatching.warmup(shapes=[]))
    assert stats['n_programs'] == 2
    assert stats['aot_deserialize_thread_s'] == 0.0
    assert stats['compile_thread_s'] == 0.0  # nothing to build on the CPU
    assert stats['load_s'] > 0 and stats['wall_s'] >= stats['compile_s'] + stats['load_s'] - 1e-6
    # a 4-tuple takes this call's statics, as in the JAX package
    assert batching._WARM_SHAPES == {('poly-m', 2048, 0, 1, 1e-5),
                                     ('dsm', 2048, 26, 2, 1e-5, 4.0, 16)}
    assert batching._all_warm([('poly-m', 2048, 0, 1, 1e-5)])


def test_warmup_compile_only_runs_nothing(monkeypatch):
    monkeypatch.setattr(batching, '_WARM_SHAPES', set())
    stats = batching.warmup(shapes=TINY, compile_only=True)
    assert stats['n_programs'] == 2 and stats['load_s'] == 0.0
    assert not batching._WARM_SHAPES


@pytest.mark.parametrize('name', ['warmup_shapes.json', 'warmup_shapes_large.json'])
def test_shipped_shape_lists_are_the_jax_packages(name):
    here = os.path.dirname(batching.__file__)
    there = os.path.dirname(jbatching.__file__)
    with open(os.path.join(here, name)) as a, open(os.path.join(there, name)) as b:
        assert json.load(a) == json.load(b)
    large = name.endswith('large.json')
    assert batching._warmup_shapes(include_large=large) == \
        jbatching._warmup_shapes(include_large=large)


def test_dsm_exports_the_jax_packages_names():
    for name in ('solve_polynomial_batch', 'solve_dsm_batch', 'SolverResult'):
        assert hasattr(jdsm, name) and hasattr(tdsm, name)


def _dsm_batch_case(B=2, side=16, K=6, seed=5):
    rng = np.random.RandomState(seed)
    rr, cc = np.indices((side, side))
    pix = np.stack([rr, cc], -1).reshape(-1, 2).astype(np.float32)
    coords = pix / (side - 1)
    sub = np.array([[4, 4], [4, 11], [11, 4], [11, 11], [8, 2], [2, 8]], np.float32)
    Y = np.zeros((B, side * side), np.float32)
    for b in range(B):
        r0, c0 = rng.uniform(6, 10, 2)
        disk = ((rr - r0) ** 2 / rng.uniform(12, 20) + (cc - c0) ** 2 / rng.uniform(12, 20)) < 1
        Y[b] = (disk.astype(np.float32) - 0.5).reshape(-1) \
            + rng.randn(side * side).astype(np.float32) * 0.3
    return dict(coords=np.tile(coords[None], (B, 1, 1)), pix=np.tile(pix[None], (B, 1, 1)),
                sub=np.tile(sub[None, :K], (B, 1, 1)), kmask=np.ones((B, K), np.float32),
                yv=Y, w=np.ones((B, side * side), np.float32),
                params0=np.zeros((B, 6 + K), np.float32),
                alpha=np.full(B, 0.05, np.float32), epsilon=1.0, sigma=3.0, cutoff=8)


def test_solve_dsm_batch_matches_jax():
    case = _dsm_batch_case()
    mine = tdsm.solve_dsm_batch(**case)
    theirs = jdsm.solve_dsm_batch(**case)
    assert isinstance(mine, tdsm.SolverResult)
    assert mine.params.shape == theirs.params.shape == (2, 12)
    assert mine.surface.shape == theirs.surface.shape == (2, 256)
    assert np.array_equal(mine.converged, theirs.converged) and mine.converged.all()
    np.testing.assert_allclose(mine.energy, theirs.energy, rtol=1e-4)
    assert 0 < mine.iterations <= 50
    assert ((mine.surface > 0) == (theirs.surface > 0)).mean() >= 0.99
