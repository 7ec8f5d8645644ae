"""The port against the JAX package under one numerics contract.

The port sums the pixels of its Newton systems in float64; the JAX package
sums them in float32. ``tests/data/torch_port/f64sums.py`` swaps, at
runtime, the JAX package's two functions whose sums the port takes to
float64 (``solver._data_grad_hess`` and ``solver._lsq_init``) for versions
with float64 sums, and restores them afterwards.

The problem: bench seed 3's object of atom 17 (5055 pixels, 86 deformation
points; ``stall-seed3-atom17.npz``, written by ``make_stall_fixture.py``,
with the exact float64 minimum of its energy, 74.6173). With float32 sums
the JAX package's solve stalls far above the minimum; with float64 sums it
reaches it, as the port does. Energies are read with one energy function,
the JAX package's (``batching._host_energy_fg``), at each solution, and
against the minimum with the same function in float64 on the quantized
intensities the solvers see (``exact_min.energy``).

Stated tolerances: the port's energy at most half the float32 JAX
package's; the port and the float64-sum JAX package within rtol 1e-2 of
each other, and each within 1e-2 of the exact minimum. Where a solve stops
on the logistic creep near the minimum moves with the rounding of the
linear-algebra library: under the JAX energy function the JAX package
alone, with the same float64 sums, ends at 74.3961 jitted and at 74.5540
run op by op (2.1e-3 apart), the port at 74.7426
(``make_stall_fixture.py --report``), so a tolerance of 1e-3 between two
libraries is below the problem's own noise.
"""

import os

import numpy as np
import pytest
import torch

from tests.data.torch_port import exact_min, f64sums

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, 'data', 'torch_port', 'stall-seed3-atom17.npz')
C2F_FIXTURE = os.path.join(HERE, 'data', 'torch_port', 'stall-seed3-c2f-279-380.npz')
STALL_RATIO = 0.5
RTOL = 1e-2


def _problem(batching, fx):
    return batching.Problem(pts=fx['pts'], offset=fx['offset'],
                            img_shape=tuple(int(v) for v in fx['img_shape']),
                            yv=fx['yv'], sub=fx['sub'])


def _settings(fx):
    return dict(alpha=float(fx['alpha']), epsilon=float(fx['epsilon']),
                smooth_amount=float(fx['smooth_amount']),
                gaussian_shape_multiplier=int(fx['gaussian_shape_multiplier']))


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """This module's solves on one torch thread (the stalls are the
    libraries' arithmetic, the same on every run); the count restored
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def solved():
    """The fixture's problem solved by the JAX package as it is, by the JAX
    package with float64 sums, and by the port; each solution's energy
    under the JAX package's energy function."""
    from superdsm_tpu.dsm import batching as jbatching
    from superdsm_tpu.dsm.smooth import smooth_matrix_params
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.dsm import batching as pbatching

    fx = dict(np.load(FIXTURE))
    kw = _settings(fx)
    params = {'f32': jbatching.solve_problems([_problem(jbatching, fx)], **kw)[0].params}
    with f64sums.f64_sums():
        params['f64'] = jbatching.solve_problems([_problem(jbatching, fx)], **kw)[0].params
    with T.use_device('cpu'):
        params['port'] = pbatching.solve_problems([_problem(pbatching, fx)], **kw)[0].params
    _, cutoff = smooth_matrix_params(kw['smooth_amount'], kw['gaussian_shape_multiplier'])
    problem = _problem(jbatching, fx)
    args = (kw['alpha'], kw['epsilon'], kw['smooth_amount'], cutoff)
    return {'jax': {name: float(jbatching._host_energy_fg(problem, p, *args)[0])
                    for name, p in params.items()},
            'exact': {name: exact_min.energy(problem, p, *args)
                      for name, p in params.items()},
            'minimum': float(fx['exact_energy'])}


def test_fixture_is_atom17_of_seed3():
    fx = np.load(FIXTURE)
    assert len(fx['pts']) == 5055 and len(fx['yv']) == 5055
    assert len(fx['sub']) > 0


def test_float32_sums_stall_where_the_port_does_not(solved):
    e = solved['jax']
    assert e['port'] <= STALL_RATIO * e['f32'], e


def test_port_agrees_with_float64_sum_reference(solved):
    e = solved['jax']
    assert e['port'] == pytest.approx(e['f64'], rel=RTOL), e


@pytest.mark.parametrize('name', ['f64', 'port'])
def test_float64_sums_reach_the_exact_minimum(solved, name):
    e, e_min = solved['exact'], solved['minimum']
    assert e_min <= e[name] <= e_min * (1 + RTOL), (e, e_min)
    assert e['f32'] > 2 * e_min, (e, e_min)


def test_reference_stalls_at_the_seed3_split_with_float64_sums():
    """Bench seed 3's split at (406.7, 430.1) against the float64-sum golden:
    the c2f solve at crop offset (279, 380) (six parameters; the fixture of
    ``make_stall_fixture.py --c2f``). Under the port's numerics contract the
    JAX package still stops at 559.92, 5.9x the exact float64 minimum 95.02,
    and its normalized energy lands on the other side of c2f's split
    threshold (``max_atom_norm_energy`` 0.05, decision-quantized) from the
    minimum's; with that one energy set to the minimum the JAX package gives
    the port's rows (``diverge.py --f64-sums --seed 3 --c2f-exact 430 407``)."""
    from superdsm_tpu._stability import dq
    from superdsm_tpu.dsm import batching as jbatching
    fx = np.load(C2F_FIXTURE)
    problem = jbatching.Problem(pts=fx['pts'], offset=fx['offset'],
                                img_shape=tuple(int(v) for v in fx['img_shape']),
                                yv=fx['yv'], sub=np.zeros((0, 2), np.int32))
    e_min = float(fx['exact_energy'])
    assert exact_min.exact_minimum(problem) == pytest.approx(e_min, rel=1e-9)
    with f64sums.f64_sums():
        e = jbatching.solve_problems([problem], smooth_amount=np.inf,
                                     fetch='energy')[0].energy
    assert e == pytest.approx(float(fx['energy_f64sums']), rel=1e-6)
    assert e > 5 * e_min
    n = problem.n_pixels
    assert dq(e / n) > dq(0.05) >= dq(e_min / n)


def test_swap_is_installed_once_and_restored():
    from superdsm_tpu.dsm import solver
    originals = {name: getattr(solver, name) for name in f64sums.REPLACEMENTS}
    with f64sums.f64_sums():
        f64sums.install()  # a second call is a no-op
        assert all(getattr(solver, name) is fn
                   for name, fn in f64sums.REPLACEMENTS.items())
        with f64sums.f64_sums():
            pass
        assert f64sums.installed()
    assert not f64sums.installed()
    assert all(getattr(solver, name) is fn for name, fn in originals.items())


@pytest.mark.parametrize('n', [6, 128])
def test_swapped_gram_equals_the_port_plain_gram(n):
    """The swapped ``_data_grad_hess`` under ``vmap`` (one callback for the
    batch) against the port's ``grad_hess_plain``: the same float64 sums of
    float32 logistic weights, which the two libraries round apart by an
    ulp."""
    import jax
    from superdsm_tpu.dsm import solver
    from superdsm_tpu_torch.dsm import gram
    rng = np.random.RandomState(n)
    B, P = 3, 512
    Bf = rng.randn(B, P, n).astype(np.float32)
    s, yv = (rng.randn(B, P).astype(np.float32) for _ in range(2))
    w = (rng.rand(B, P) > 0.2).astype(np.float32)
    with f64sums.f64_sums():
        g, H = jax.jit(jax.vmap(solver._data_grad_hess))(Bf, s, yv, w)
    g_ref, H_ref = gram.grad_hess_plain(*map(torch.from_numpy, (Bf, s, yv, w)))
    np.testing.assert_allclose(np.asarray(g), g_ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(H), H_ref.numpy(), rtol=1e-5, atol=1e-5)


def test_swapped_lsq_init_equals_the_port():
    import jax
    from superdsm_tpu.dsm import solver
    from superdsm_tpu_torch.dsm import solver as psolver
    rng = np.random.RandomState(7)
    Q = rng.randn(4, 700, 6).astype(np.float32)
    yv = rng.randn(4, 700).astype(np.float32)
    w = (rng.rand(4, 700) > 0.1).astype(np.float32)
    with f64sums.f64_sums():
        theta = jax.jit(solver._lsq_init)(Q, yv, w)
    ref = psolver._lsq_init(*map(torch.from_numpy, (Q, yv, w)))
    np.testing.assert_allclose(np.asarray(theta), ref.numpy(), rtol=1e-5, atol=1e-6)
