"""The port's device meshes, sharded Newton solves and pipeline mesh against
the JAX package's, on the CPU.

- The sharded poly and DSM solvers on ``['cpu'] * 8`` as a (4, 2) mesh give
  the JAX package's sharded solvers' energies on its 8 virtual CPU devices
  (the same problems as ``tests/test_parallel.py``) to rtol 1e-3; a 1x1
  mesh of the same problems gives the (4, 2) mesh's converged energies to
  rtol 1e-4, which isolates the shard sums.
- The pipeline mesh over ``['cpu'] * 8`` against no mesh, on the 120x120
  three-blob field of ``tests/test_parallel.py``: three objects in both,
  at most 10 label pixels differ, per-object IoU >= 0.99, energies to rtol
  5e-3 (that test's bounds); a 1-device mesh equals no mesh bitwise.
- The sharded DSM solver at K = 1018 (n = 1024) on a (1, 2) mesh against
  the JAX package's, two Newton iterations: energies to rtol 1e-4.
- The sharded solvers' direction and sums go through the lane ops (the
  kernels on the card), and a lane alone gives its bits in a batch.
- The sharded loop that reads its convergence flags every few iterations
  is bitwise the loop that reads them every iteration, over (1, 2) and
  (2, 1) meshes.
- ``parse_mesh_spec``, ``apply_env_mesh`` and the batch CLI's ``--mesh``
  on the cases of ``tests/test_parallel.py``, with the port's device
  enumeration monkeypatched to 8 CPU devices.
"""

import numpy as np
import pytest
import torch

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import batching
from superdsm_tpu_torch.parallel import mesh as pm
from superdsm_tpu_torch.parallel.newton import (make_sharded_dsm_solver,
                                                make_sharded_poly_solver)
from superdsm_tpu_torch.render import rasterize_labels

torch.set_num_threads(1)

CPUS = ['cpu'] * 8


@pytest.fixture(autouse=True)
def _cpu():
    with T.use_device('cpu'):
        yield


@pytest.fixture
def eight_cpus(monkeypatch):
    monkeypatch.setattr(pm, 'local_devices', lambda: [torch.device('cpu')] * 8)


def _problems(B=8, H=16, W=32, seed=0):
    rng = np.random.RandomState(seed)
    rr, cc = np.indices((H, W))
    coords = np.stack([rr, cc], -1).reshape(-1, 2).astype(np.float32) \
        / np.array([H - 1, W - 1], np.float32)
    P = H * W
    C = np.tile(coords[None], (B, 1, 1))
    Y = np.zeros((B, P), np.float32)
    for b in range(B):
        r0, c0 = rng.randint(4, 12), rng.randint(8, 24)
        Y[b] = ((((rr - r0) ** 2 + (cc - c0) ** 2) < 25).astype(np.float32) - 0.5).reshape(-1)
        Y[b] += rng.randn(P).astype(np.float32) * 0.1
    return C, Y, np.ones((B, P), np.float32)


def _dsm_inputs(B=8, H=16, W=32, K=8):
    C, Y, Wt = _problems(B=B, H=H, W=W)
    rr, cc = np.indices((H, W))
    pix = np.tile(np.stack([rr, cc], -1).reshape(-1, 2).astype(np.float32)[None],
                  (B, 1, 1))
    sub = np.random.RandomState(1).randint(0, 16, (B, K, 2)).astype(np.float32)
    return C, Y, Wt, pix, sub, np.ones((B, K), np.float32)


@pytest.fixture(scope='module')
def jax_sharded():
    """The JAX package's sharded poly and DSM solves on its (4, 2) mesh."""
    import jax
    import jax.numpy as jnp
    from superdsm_tpu.parallel import make_mesh
    from superdsm_tpu.parallel.newton import (make_sharded_dsm_solver as jdsm,
                                              make_sharded_poly_solver as jpoly)
    mesh = make_mesh(n_batch=4, n_pixel=2)
    C, Y, Wt, pix, sub, km = _dsm_inputs()
    p_ell, f_ell, _ = jax.block_until_ready(
        jpoly(mesh)(jnp.zeros((8, 6), jnp.float32), C, Y, Wt))
    p0 = np.concatenate([np.asarray(p_ell), np.zeros((8, 8), np.float32)], axis=1)
    _, fd, cd = jax.block_until_ready(jdsm(mesh, sigma=3.0, cutoff=12)(
        p0, C, pix, sub, km, Y, Wt, np.full(8, 0.1, np.float32)))
    return dict(f_ell=np.asarray(f_ell), p0=p0, f_dsm=np.asarray(fd),
                conv_dsm=np.asarray(cd))


def _host(*tensors):
    return [t.cpu().numpy() for t in tensors]


def test_sharded_poly_matches_jax(jax_sharded):
    C, Y, Wt = _problems()
    _, f, conv = _host(*make_sharded_poly_solver(pm.make_mesh(4, 2, CPUS))(
        np.zeros((8, 6), np.float32), C, Y, Wt))
    np.testing.assert_allclose(f, jax_sharded['f_ell'], rtol=1e-3, atol=1e-4)
    _, f1, conv1 = _host(*make_sharded_poly_solver(pm.make_mesh(1, 1, CPUS))(
        np.zeros((8, 6), np.float32), C, Y, Wt))
    both = conv & conv1
    assert both.any()
    np.testing.assert_allclose(f[both], f1[both], rtol=1e-4)


def test_sharded_dsm_matches_jax(jax_sharded):
    C, Y, Wt, pix, sub, km = _dsm_inputs()
    args = (jax_sharded['p0'], C, pix, sub, km, Y, Wt, np.full(8, 0.1, np.float32))
    _, fd, cd = _host(*make_sharded_dsm_solver(pm.make_mesh(4, 2, CPUS),
                                               sigma=3.0, cutoff=12)(*args))
    np.testing.assert_allclose(fd, jax_sharded['f_dsm'], rtol=1e-3)
    assert (fd <= jax_sharded['f_ell'] + 1e-3).all()
    _, f1, c1 = _host(*make_sharded_dsm_solver(pm.make_mesh(1, 1, CPUS),
                                               sigma=3.0, cutoff=12)(*args))
    both = cd & c1
    assert both.any()
    np.testing.assert_allclose(fd[both], f1[both], rtol=1e-4)


def test_sharded_dsm_at_k1018_matches_jax():
    """The sharded DSM solver at K = 1018 (n = 1024, the bucket whose
    direction takes ``lane_cholesky``'s clusters of 16 blocks on the card;
    LAPACK here) on a (1, 2) mesh against the JAX package's on its (1, 2)
    mesh: two lanes of 512 pixels, two Newton iterations (``maxiter`` 2,
    neither converged): energies to rtol 1e-4, params to 1e-4 of their
    largest magnitude (float32 sums in other orders, two steps apart)."""
    import jax
    from superdsm_tpu.parallel import make_mesh
    from superdsm_tpu.parallel.newton import make_sharded_dsm_solver as jdsm
    C, Y, Wt, pix, sub, km = _dsm_inputs(B=2, K=1018)
    args = (np.zeros((2, 1024), np.float32), C, pix, sub, km, Y, Wt,
            np.full(2, 0.1, np.float32))
    pj, fj, cj = (np.asarray(a) for a in jax.block_until_ready(
        jdsm(make_mesh(n_batch=1, n_pixel=2), sigma=3.0, cutoff=12, maxiter=2)(*args)))
    p, f, c = _host(*make_sharded_dsm_solver(pm.make_mesh(1, 2, CPUS), sigma=3.0,
                                             cutoff=12, maxiter=2)(*args))
    assert p.shape == (2, 1024) and not c.any() and not cj.any()
    np.testing.assert_allclose(f, fj, rtol=1e-4)
    np.testing.assert_allclose(p, pj, rtol=0, atol=1e-4 * float(np.abs(pj).max()))


def test_sharded_solver_goes_through_the_lane_ops(monkeypatch):
    """The sharded solver's direction and its guard go through
    ``lane.newton_direction`` (the ``lane_chol_step`` kernel on the card,
    LAPACK and the guard's plain version here) and its sums through the
    lane ops: every Newton iteration calls each of them."""
    from superdsm_tpu_torch.dsm import lane
    calls = {}

    def spy(module, name):
        original = getattr(module, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return original(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)

    for name in ('newton_direction', 'lane_sum', 'lane_dot', 'softplus_energies'):
        spy(lane, name)
    C, Y, Wt, pix, sub, km = _dsm_inputs(B=4)
    make_sharded_dsm_solver(pm.make_mesh(1, 2, CPUS), sigma=3.0, cutoff=12)(
        np.zeros((4, 14), np.float32), C, pix, sub, km, Y, Wt, np.full(4, 0.1, np.float32))
    iterations = calls['newton_direction']
    assert iterations > 1
    # the line search and scale sweep of each shard, the energy at the end
    assert calls['softplus_energies'] >= 2 * 3 * iterations
    assert calls['lane_dot'] >= 2 * iterations
    assert calls['lane_sum'] >= 3 * iterations


@pytest.mark.parametrize('kind', ['poly', 'dsm'])
def test_sharded_lane_alone_equals_lane_in_batch(kind):
    """A lane solved alone by the sharded solver on a (1, 2) mesh gives its
    params, energy and convergence flag in a batch of four, bitwise."""
    C, Y, Wt, pix, sub, km = _dsm_inputs(B=4)
    mesh = pm.make_mesh(1, 2, CPUS)
    if kind == 'poly':
        solve = make_sharded_poly_solver(mesh)
        args = (np.zeros((4, 6), np.float32), C, Y, Wt)
    else:
        solve = make_sharded_dsm_solver(mesh, sigma=3.0, cutoff=12)
        args = (np.zeros((4, 14), np.float32), C, pix, sub, km, Y, Wt,
                np.full(4, 0.1, np.float32))
    batch = _host(*solve(*args))
    for b in (0, 3):
        alone = _host(*solve(*(a[b:b + 1] for a in args)))
        for x, x1 in zip(batch, alone):
            assert np.array_equal(x[b:b + 1], x1)


@pytest.mark.parametrize('maxiter', [50, 3])
@pytest.mark.parametrize('shape', [(1, 2), (2, 1)])
def test_sharded_loop_reads_convergence_in_chunks(monkeypatch, shape, maxiter):
    """The sharded loop that reads its convergence flags every
    ``solver.SYNC_EVERY`` iterations (4 and 3) is bitwise the loop that
    reads them every iteration (``SYNC_EVERY = 1``, the oracle), poly then
    DSM from the poly solve's params: at ``maxiter`` 50 every lane
    converges and the iterations after the last one change no bit; at 3
    the poly lanes have not, and no chunk runs past ``maxiter``."""
    from superdsm_tpu_torch.dsm import solver
    C, Y, Wt, pix, sub, km = _dsm_inputs()
    mesh = pm.make_mesh(*shape, CPUS)
    runs = {}
    for every in (1, 4, 3):
        monkeypatch.setattr(solver, 'SYNC_EVERY', every)
        solver.reset_loop_stats()
        poly = _host(*make_sharded_poly_solver(mesh, maxiter=maxiter)(
            np.zeros((8, 6), np.float32), C, Y, Wt))
        p0 = np.concatenate([poly[0], np.zeros((8, 8), np.float32)], axis=1)
        dsm = _host(*make_sharded_dsm_solver(mesh, sigma=3.0, cutoff=12, maxiter=maxiter)(
            p0, C, pix, sub, km, Y, Wt, np.full(8, 0.1, np.float32)))
        stats = dict(solver.LOOP_STATS)
        rows = 2 * shape[0]  # two solves of each mesh row
        assert stats['solves'] == rows
        assert stats['iterations'] <= rows * maxiter
        assert stats['syncs'] <= -(-stats['iterations'] // every) + rows
        runs[every] = (poly, dsm, stats)
    oracle = runs[1]
    assert oracle[0][2].all() == oracle[1][2].all() == (maxiter == 50)
    for every in (4, 3):
        for got, want in zip(runs[every][:2], oracle[:2]):
            for x, y in zip(got, want):
                assert np.array_equal(x, y)
        assert runs[every][2]['syncs'] < oracle[2]['syncs']


def _three_blobs():
    rng = np.random.RandomState(0)
    rr, cc = np.indices((120, 120))
    g = sum(np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * (rad * 0.7) ** 2)))
            for r0, c0, rad in [(40, 40, 14), (40, 66, 12), (90, 90, 14)])
    g = (g + rng.randn(120, 120) * 0.02).astype(np.float32)
    cfg = T.Config()
    cfg['c2f-region-analysis/min_atom_radius'] = 6
    cfg['global-energy-minimization/beta'] = 0.5
    return g, cfg


def _segment_under(mesh, g, cfg):
    batching.set_pipeline_mesh(mesh)
    try:
        data, _, _ = T.create_default_pipeline().process_image(g, cfg.copy())
    finally:
        batching.set_pipeline_mesh(None)
    return data, rasterize_labels(data)


def test_pipeline_mesh_equivalence():
    g, cfg = _three_blobs()
    data1, seg1 = _segment_under(None, g, cfg)
    data8, seg8 = _segment_under(pm.make_mesh(8, 1, CPUS), g, cfg)
    assert len(data1['postprocessed_objects']) == len(data8['postprocessed_objects']) == 3
    assert (seg1 > 0).sum() > 0
    assert int((seg1 != seg8).sum()) <= 10
    for label in range(1, seg1.max() + 1):
        m1 = seg1 == label
        label8 = np.bincount(seg8[m1]).argmax()
        assert label8 > 0
        m8 = seg8 == label8
        assert (m1 & m8).sum() / (m1 | m8).sum() >= 0.99
    e1 = np.sort([float(o.energy) for o in data1['objects']])
    e8 = np.sort([float(o.energy) for o in data8['objects']])
    np.testing.assert_allclose(e1, e8, rtol=5e-3)
    # a 1-device mesh is the single-device path
    data_one, seg_one = _segment_under(pm.make_mesh(1, 1, CPUS), g, cfg)
    assert np.array_equal(seg_one, seg1)
    assert [o.energy for o in data_one['objects']] == [o.energy for o in data1['objects']]


def test_lane_split_keeps_lane_order():
    """``solve_on_devices`` over 3 devices gives the lanes of the one-device
    solve, in lane order (uneven shares)."""
    from superdsm_tpu_torch.dsm.solver import _solve_poly_packed, solve_on_devices
    C, Y, _ = _problems(B=6)
    pix = np.round(C * np.array([15, 31])).astype(np.int16)
    yq = np.round(Y / np.abs(Y).max(1, keepdims=True) * 32767).astype(np.int16)
    args = (pix, np.zeros((6, 2), np.int32), np.full(6, 512, np.int32), yq,
            np.abs(Y).max(1).astype(np.float32), np.array([15.0, 31.0], np.float32),
            np.zeros((6, 6), np.float32), 30, 1e-5)
    whole = solve_on_devices(_solve_poly_packed, args, None)
    split = solve_on_devices(_solve_poly_packed, args, [torch.device('cpu')] * 3)
    for a, b in zip(whole, split):
        assert a.shape == b.shape
    np.testing.assert_allclose(split[1].numpy(), whole[1].numpy(), rtol=1e-5)
    assert torch.equal(split[4], whole[4])


def test_parse_mesh_spec_and_env_apply(monkeypatch, eight_cpus):
    assert pm.parse_mesh_spec('8').shape == {'batch': 8, 'pixel': 1}
    assert pm.parse_mesh_spec('batch:4').shape == {'batch': 4, 'pixel': 1}
    assert pm.parse_mesh_spec('batch:4,pixel:2').shape == {'batch': 4, 'pixel': 2}
    assert pm.parse_mesh_spec('batch:4,pixel:2').size == 8
    assert pm.parse_mesh_spec('') is None
    with pytest.raises(ValueError):
        pm.parse_mesh_spec('bogus:2')
    with pytest.raises(ValueError, match='needs more than 8 devices'):
        pm.parse_mesh_spec('16')

    monkeypatch.setenv('SUPERDSM_TPU_MESH', 'batch:8')
    monkeypatch.setattr(pm, '_APPLIED_SPEC', None)
    try:
        mesh = pm.apply_env_mesh()
        assert mesh.shape == {'batch': 8, 'pixel': 1}
        assert batching.get_pipeline_mesh() is mesh
        # idempotent: a second call (another task/thread) reuses the install
        assert pm.apply_env_mesh() is mesh
    finally:
        batching.set_pipeline_mesh(None)
        pm._APPLIED_SPEC = None


def test_mesh_of_the_selected_device_type():
    """The default device list is the CPU on the CPU; a listed CUDA device
    that is not present raises."""
    assert pm.make_mesh().shape == {'batch': 1, 'pixel': 1}
    with pytest.raises(ValueError, match='needs more than 1 devices'):
        pm.parse_mesh_spec('2')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            pm.make_mesh(1, 1, devices=['cuda:0'])


def test_batch_cli_mesh_flag_rejects_bad_spec(tmp_path, eight_cpus):
    from superdsm_tpu_torch.batch import run_cli
    with pytest.raises(SystemExit):
        run_cli([str(tmp_path), '--mesh', 'nonsense'])


def test_batch_cli_mesh_flag_installs_the_mesh(tmp_path, monkeypatch, eight_cpus,
                                               capsys):
    """``--mesh`` sets ``SUPERDSM_TPU_MESH``, and the task installs the mesh
    before it segments."""
    import json
    from superdsm_tpu_torch.batch import run_cli
    from superdsm_tpu_torch.io import imread, imsave
    rr, cc = np.indices((80, 80))
    g = np.exp(-(((rr - 40) ** 2 + (cc - 40) ** 2) / (2 * 9.0 ** 2)))
    imsave(str(tmp_path / 'img0.png'), g + np.random.RandomState(0).randn(80, 80) * 0.01)
    (tmp_path / 'task').mkdir()
    (tmp_path / 'task' / 'task.json').write_text(json.dumps(dict(
        runnable=True, file_ids=[0], img_pathpattern='{ROOTDIR}/../img%d.png',
        seg_pathpattern='seg/%d.png', config={'AF_scale': 9})))
    monkeypatch.setenv('SUPERDSM_TPU_MESH', '')  # restored after the test
    monkeypatch.setattr(pm, '_APPLIED_SPEC', None)
    try:
        run_cli([str(tmp_path / 'task'), '--run', '--no-fork', '--mesh', 'batch:8',
                 '--report', str(tmp_path / 'status')])
        assert batching.get_pipeline_mesh().shape == {'batch': 8, 'pixel': 1}
    finally:
        batching.set_pipeline_mesh(None)
        pm._APPLIED_SPEC = None
    assert "Pipeline mesh: {'batch': 8, 'pixel': 1} over 8 devices" in capsys.readouterr().out
    assert imread(str(tmp_path / 'task' / 'seg' / '0.png')).max() == 1
