"""The port's batched Newton solver against the JAX package's.

The cases of ``tests/test_solver.py`` run on both packages: the same inputs,
made from numpy seeds, go through ``superdsm_tpu.dsm.solver`` (JAX on the
CPU) and ``superdsm_tpu_torch.dsm.solver`` (torch on the CPU). Stated
tolerances: 1e-5 relative on closed-form energies and 1e-4 on reductions
over pixels (float32 sums in different orders); converged Newton lanes
agree to rtol 1e-4 on energies. Truncated (LM-stalled) lanes are chaotic
under any rounding change, so they are compared only through what the
canonical re-solve and the decisions they drive produce: the same lanes are
flagged, with the same status, and foregrounds agree on >= 99% of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdsm_tpu.dsm import solver as jsolver
from superdsm_tpu.dsm import batching as jbatching
from superdsm_tpu.image import Image as JImage

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import solver as tsolver
from superdsm_tpu_torch.dsm import batching as tbatching
from superdsm_tpu_torch.dsm.smooth import build_smooth_matrix as t_smooth
from superdsm_tpu_torch.image import Image as TImage

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    with T.use_device('cpu'):
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _reference_energy(params, Q, G, yv, w, alpha, epsilon):
    """Independent NumPy implementation of ψ (softplus data term + smooth L1)."""
    s = Q @ params[:6] + G @ params[6:]
    data = np.sum(w * np.logaddexp(0.0, -yv * s))
    xi = params[6:]
    return data + alpha * np.sum(np.sqrt(xi ** 2 + epsilon) - np.sqrt(epsilon))


def test_energy_matches_reference_formula():
    rng = np.random.RandomState(0)
    P, K = 50, 4
    coords = rng.rand(P, 2).astype(np.float32)
    G = rng.rand(P, K).astype(np.float32)
    yv = rng.randn(P).astype(np.float32)
    w = np.ones(P, np.float32)
    params = rng.randn(6 + K).astype(np.float32) * 0.1
    kmask = np.ones(K, np.float32)
    Q = tsolver._poly_basis(_t(coords))
    s = tsolver._surface(_t(params), Q, _t(G), _t(kmask))
    actual = float(tsolver._energy_from_surface(
        s, _t(params[6:]), _t(yv), _t(w), 0.5, 1.0, _t(kmask)))
    expected = _reference_energy(params.astype(float), Q.numpy().astype(float),
                                 G, yv, w, 0.5, 1.0)
    np.testing.assert_allclose(actual, expected, rtol=1e-5)
    jQ = jsolver._poly_basis(jnp.asarray(coords))
    js = jsolver._surface(jnp.asarray(params), jQ, jnp.asarray(G), jnp.asarray(kmask))
    jax_val = float(jsolver._energy_from_surface(
        js, jnp.asarray(params[6:]), jnp.asarray(yv), jnp.asarray(w), 0.5, 1.0,
        jnp.asarray(kmask)))
    np.testing.assert_allclose(actual, jax_val, rtol=1e-5)


def test_grad_hess_match_autodiff_and_jax():
    rng = np.random.RandomState(1)
    P, K = 40, 3
    coords, G = rng.rand(P, 2), rng.rand(P, K)
    yv = rng.randn(P)
    params = rng.randn(6 + K) * 0.1
    kmask, w = np.ones(K), np.ones(P)
    Q = tsolver._poly_basis(_t(coords))
    args = (_t(yv), _t(w), 0.5, 1.0, _t(kmask))

    def f(p):
        s = tsolver._surface(p, Q, _t(G), _t(kmask))
        return tsolver._energy_from_surface(s, p[6:], *args)

    p = _t(params)
    g_auto = torch.func.grad(f)(p)
    H_auto = torch.func.hessian(f)(p)
    s = tsolver._surface(p, Q, _t(G), _t(kmask))
    g, H = tsolver._grad_hess(p, s, Q, _t(G), *args[:2], 0.5, 1.0, _t(kmask))
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(H.numpy(), H_auto.numpy(), rtol=1e-3, atol=1e-4)

    jQ = jsolver._poly_basis(jnp.asarray(coords, jnp.float32))
    jp = jnp.asarray(params, jnp.float32)
    jG, jk = jnp.asarray(G, jnp.float32), jnp.asarray(kmask, jnp.float32)
    js = jsolver._surface(jp, jQ, jG, jk)
    jg, jH = jsolver._grad_hess(jp, js, jQ, jG, jnp.asarray(yv, jnp.float32),
                                jnp.asarray(w, jnp.float32), 0.5, 1.0, jk)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-4, atol=1e-5)


def _disk_inputs():
    H, W = 40, 40
    rr, cc = np.indices((H, W))
    y = (((rr - 20) ** 2 + (cc - 20) ** 2) < 100).astype(np.float32) - 0.5
    pts = np.argwhere(np.ones((H, W), bool)).astype(np.float32)
    coords = (pts / np.array([H - 1, W - 1], np.float32))[None]
    return coords, y.reshape(1, -1), np.ones((1, H * W), np.float32), y > 0


def test_elliptical_solve_segments_disk():
    coords, yv, w, true = _disk_inputs()
    r = tsolver.solve_polynomial_batch(coords, yv, w)
    rj = jsolver.solve_polynomial_batch(coords, yv, w)
    fg = (r.surface[0] > 0).reshape(true.shape)
    fg_j = (rj.surface[0] > 0).reshape(true.shape)
    iou = (fg & true).sum() / (fg | true).sum()
    assert iou == 1.0
    assert np.array_equal(fg, fg_j)


def test_padding_invariance():
    """Padded pixels (w=0) must not influence the solution."""
    rng = np.random.RandomState(2)
    H, W = 20, 20
    rr, cc = np.indices((H, W))
    y = (((rr - 10) ** 2 + (cc - 10) ** 2) < 36).astype(np.float32) - 0.5
    y += rng.randn(H, W).astype(np.float32) * 0.3  # non-separable => unique optimum
    pts = np.argwhere(np.ones((H, W), bool)).astype(np.float32)
    coords = pts / np.array([H - 1, W - 1], np.float32)
    P, pad = H * W, 137
    C2 = np.concatenate([coords, rng.rand(pad, 2).astype(np.float32)])[None]
    Y2 = np.concatenate([y.reshape(-1), rng.randn(pad).astype(np.float32)])[None]
    W2 = np.concatenate([np.ones(P), np.zeros(pad)]).astype(np.float32)[None]
    r1 = tsolver.solve_polynomial_batch(coords[None], y.reshape(1, -1),
                                        np.ones((1, P), np.float32))
    r2 = tsolver.solve_polynomial_batch(C2, Y2, W2)
    np.testing.assert_allclose(r1.energy, r2.energy, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r1.params, r2.params, rtol=1e-2, atol=1e-3)
    rj = jsolver.solve_polynomial_batch(C2, Y2, W2)
    np.testing.assert_allclose(r2.energy, rj.energy, rtol=1e-4)


def test_cg_matches_cholesky_and_jax_lane_freeze():
    """Batched PCG with per-lane freezing: well-conditioned lanes solve
    their systems (1e-3 of the exact solution, the CG tolerance) and agree
    with the JAX package's vmapped while_loop (1e-4); a lane that finishes
    early keeps exactly its iterate while harder lanes iterate on."""
    rng = np.random.RandomState(5)
    B, n = 4, 40
    Hs = []
    for b in range(B):
        U, _ = np.linalg.qr(rng.randn(n, n))
        cond = 10.0 ** (b + 1)  # lanes converge after different iterations
        Hs.append(U @ np.diag(np.geomspace(1.0, cond, n)) @ U.T)
    H = np.stack(Hs).astype(np.float32)
    bvec = rng.randn(B, n).astype(np.float32)
    x = tsolver._pcg_solve(_t(H), _t(bvec)).numpy()
    x_ref = np.linalg.solve(H.astype(float), bvec.astype(float)[..., None])[..., 0]
    xj = np.asarray(jax.vmap(jsolver._pcg_solve)(jnp.asarray(H), jnp.asarray(bvec)))
    for b in range(2):
        np.testing.assert_allclose(x[b], x_ref[b], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(x[b], xj[b], rtol=1e-4, atol=1e-5)
    # lane 0 (condition 10) is done within 24 iterations: stopping the
    # batch there or running the harder lanes on to 64 leaves it bitwise
    # unchanged, while the hardest lane is still moving
    x24 = tsolver._pcg_solve(_t(H), _t(bvec), iters=24).numpy()
    np.testing.assert_array_equal(x24[0], x[0])
    assert not np.array_equal(x24[3], x[3])
    assert np.all(np.isfinite(x))


def test_cholesky_failure_falls_back_to_gradient_step():
    """A lane whose damped Hessian is not positive definite gets the
    guarded gradient step (torch.linalg.cholesky_ex reports the failure
    instead of raising), as the JAX package's NaN guard gives."""
    rng = np.random.RandomState(6)
    B, P, n = 2, 64, 6
    Bf = rng.rand(B, P, n).astype(np.float32)
    s = rng.randn(B, P).astype(np.float32)
    yv = np.sign(rng.randn(B, P)).astype(np.float32)
    w = np.ones((B, P), np.float32)
    params = np.zeros((B, n), np.float32)
    g = rng.randn(B, n).astype(np.float32)
    Hm = np.stack([np.eye(n), -np.eye(n)]).astype(np.float32)  # lane 1 not PD
    f0 = np.full(B, 100.0, np.float32)
    mu = np.full(B, 1e-6, np.float32)
    out_t = tsolver._newton_step(_t(params), _t(mu), _t(s), _t(f0), _t(g), _t(Hm),
                                 _t(Bf), _t(yv), _t(w), torch.zeros(B), 1.0,
                                 torch.zeros((B, 0)), 1e-5)
    step = jax.vmap(jsolver._newton_step,
                    in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None, 0, None))
    out_j = step(*map(jnp.asarray, (params, mu, s, f0, g, Hm, Bf, yv, w)),
                 jnp.zeros(B), 1.0, jnp.zeros((B, 0)), 1e-5)
    assert np.all(np.isfinite(out_t[0].numpy()))
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    for a, b in zip(out_t[3:], out_j[3:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lsq_init_matches_jax_and_guards_singular_lane():
    H, W = 40, 40
    rr, cc = np.indices((H, W))
    disk = ((rr - 20.0) ** 2 + (cc - 20.0) ** 2) <= 10.0 ** 2
    yv = np.stack([disk.reshape(-1) - 0.5] * 2).astype(np.float32)
    coords = np.stack([rr, cc], -1).reshape(1, -1, 2).astype(np.float32) / (H - 1.0)
    coords = np.concatenate([coords] * 2)
    w = np.ones((2, H * W), np.float32)
    w[1] = 0.0  # an empty (padding) lane: singular system
    theta = tsolver._lsq_init(tsolver._poly_basis(_t(coords)), _t(yv), _t(w)).numpy()
    theta_j = np.asarray(jsolver._lsq_init(jsolver._poly_basis(jnp.asarray(coords)),
                                           jnp.asarray(yv), jnp.asarray(w)))
    # float32 normal equations of condition ~1e4: agreement to 1e-3 of the
    # largest coefficient
    np.testing.assert_allclose(theta[0], theta_j[0], rtol=1e-3,
                               atol=1e-3 * np.abs(theta_j[0]).max())
    assert not np.any(theta[1]) and not np.any(theta_j[1])
    s = (tsolver._poly_basis(_t(coords[0])).numpy() @ theta[0]).reshape(H, W)
    assert s[20, 20] > 0 and ((s > 0) & ~disk).sum() == 0


def test_fallback_on_numerical_failure():
    """NaN intensities (a NaN quantization scale) must give status
    'fallback' with the initialization restored verbatim."""
    H, W = 32, 32
    rr, cc = np.indices((H, W))
    disk = ((rr - 16.0) ** 2 + (cc - 16.0) ** 2) <= 8.0 ** 2
    region = TImage(model=disk.astype(np.float32) - 0.5)
    ok = tbatching.make_problem(region, smooth_amount=4, smooth_subsample=6)
    assert ok.n_deform > 0
    assert tbatching.solve_problems([ok], alpha=0.05, smooth_amount=4)[0].status == 'optimal'
    bad = tbatching.make_problem(region, smooth_amount=4, smooth_subsample=6)
    warm = np.zeros(6 + bad.n_deform, np.float32)
    warm[:6] = [-1.0, -1.0, 0.0, 0.55, 0.55, -0.55]
    bad.init_params = warm
    bad._yscale = float('nan')
    res = tbatching.solve_problems([bad], alpha=0.05, smooth_amount=4)[0]
    assert res.status == 'fallback'
    np.testing.assert_allclose(res.params, warm, atol=1e-6)
    poly = tbatching.make_problem(region, smooth_amount=np.inf)
    poly._yscale = float('nan')
    assert tbatching.solve_problems([poly], smooth_amount=np.inf)[0].status == 'fallback'


def _blob_images(seed, count, H=40, W=40, noise=0.01):
    rng = np.random.RandomState(seed)
    rr, cc = np.indices((H, W))
    out = []
    for _ in range(count):
        r0, c0 = rng.randint(14, 26, 2)
        rad, ecc = rng.uniform(6, 11), rng.uniform(0.85, 1.2)
        disk = (((rr - r0) / ecc) ** 2 + ((cc - c0) * ecc) ** 2) <= rad ** 2
        out.append(disk.astype(np.float32) - 0.5
                   + rng.randn(H, W).astype(np.float32) * noise)
    return out


def _both_problems(images, **kw):
    jp = [jbatching.make_problem(JImage(model=y), tag=i, **kw) for i, y in enumerate(images)]
    tp = [tbatching.make_problem(TImage(model=y), tag=i, **kw) for i, y in enumerate(images)]
    for a, b in zip(jp, tp):
        assert np.array_equal(a.pts, b.pts) and np.array_equal(a.sub, b.sub)
    return jp, tp


def test_packed_poly_solves_lane_by_lane():
    images = _blob_images(8, 6, noise=0.3)
    jp, tp = _both_problems(images, smooth_amount=np.inf)
    kw = dict(maxiter=50, pb=2048, Bp=8)
    res_t = tsolver.pack_and_solve_poly(tp, tp[0].img_shape, **kw)
    res_j = jsolver.pack_and_solve_poly(jp, jp[0].img_shape, **kw)
    both = [a[2] and b[2] for a, b in zip(res_t, res_j)]
    assert sum(both) >= 4  # noisy (non-separable) lanes converge
    for (params, f, _, fg), (jparams, jf, _, jfg), ok in zip(res_t, res_j, both):
        if ok:
            np.testing.assert_allclose(f, jf, rtol=1e-4)
        assert (fg == jfg).mean() >= 0.99


def test_dsm_solves_match_lane_by_lane():
    images = _blob_images(7, 6)
    jp, tp = _both_problems(images, smooth_amount=4, smooth_subsample=6)
    kw = dict(alpha=0.05, smooth_amount=4, maxiter=25)
    res_t = tbatching.solve_problems(tp, **kw)
    flagged_t = list(tbatching._LAST_FLAGGED)
    res_j = jbatching.solve_problems(jp, **kw)
    flagged_j = list(jbatching._LAST_FLAGGED)
    # truncated lanes: the same lanes go to the canonical re-solve
    assert sorted(flagged_t) == sorted(flagged_j)
    for i, (a, b) in enumerate(zip(res_t, res_j)):
        assert a.status == b.status
        assert (a.fg == b.fg).mean() >= 0.99
        if i not in flagged_t:  # converged lanes
            np.testing.assert_allclose(a.energy, b.energy, rtol=1e-4)


def test_smooth_matrix_matches_jax():
    from superdsm_tpu.dsm.smooth import build_smooth_matrix as j_smooth
    rng = np.random.RandomState(3)
    pix = rng.randint(0, 30, (64, 2)).astype(np.float32)
    sub = pix[::7]
    km = (rng.rand(len(sub)) < 0.8).astype(np.float32)
    Gt = t_smooth(_t(pix), _t(sub), 5.0, 20, _t(km)).numpy()
    Gj = np.asarray(j_smooth(pix, sub, 5.0, 20, km))
    np.testing.assert_allclose(Gt, Gj, rtol=1e-5, atol=1e-7)


def test_dsm_chunk_sizes_policy():
    import functools
    sizes = functools.partial(tbatching._dsm_chunk_sizes, on_cpu_=False)
    assert sizes(19, 32, 12288, 250) == [16, 3]
    assert sizes(32 + 19, 32, 12288, 250) == [32, 16, 3]
    assert sizes(5, 16, 16384, 506) == [5]
    assert sizes(19, 32, 2048, 26) == [19]
    assert tbatching._dsm_chunk_sizes(19, 32, 32768, 506, on_cpu_=True) == [19]


def _hybrid_problem(B=2, side=22, P=512, K=122, sigma=4.0, cutoff=16):
    """B lanes of one DSM problem size n = 6 + K = 128 at P = 512: a square
    region with a noisy disk (non-separable, so lanes can converge)."""
    from superdsm_tpu.dsm.smooth import build_smooth_matrix as j_smooth
    from superdsm_tpu.dsm.smooth import subsample_grid
    mask = np.ones((side, side), bool)
    pts = np.argwhere(mask).astype(np.float32)
    sub = np.argwhere(subsample_grid(mask, 2) & mask)[:K]
    PIX = np.zeros((P, 2), np.float32)
    PIX[:len(pts)] = pts
    W = np.zeros(P, np.float32)
    W[:len(pts)] = 1.0
    SUB = np.full((K, 2), -10.0 * (cutoff + 1), np.float32)
    SUB[:len(sub)] = sub
    KM = np.zeros(K, np.float32)
    KM[:len(sub)] = 1.0
    rng = np.random.RandomState(11)
    rr, cc = np.indices((side, side))
    yv = np.zeros((B, P), np.float32)
    for b in range(B):
        disk = (rr - 10.5 - b) ** 2 + (cc - 11.0) ** 2 <= (6.0 + b) ** 2
        y = disk - 0.5 + rng.randn(side, side) * 0.4
        yv[b, :len(pts)] = y.reshape(-1)
    coords = (PIX + 40.0) / np.float32(199.0)
    Q = np.asarray(jsolver._poly_basis(jnp.asarray(coords)))
    G = np.asarray(j_smooth(jnp.asarray(PIX), jnp.asarray(SUB), sigma, cutoff,
                            jnp.asarray(KM)))
    tile = lambda a: np.stack([a] * B)
    return dict(params0=np.zeros((B, 6 + K), np.float32), Q=tile(Q), G=tile(G),
                yv=yv, w=tile(W), alpha=np.full(B, 0.05, np.float32),
                kmask=tile(KM))


@pytest.fixture
def jax_hybrid(monkeypatch):
    """The JAX package's Pallas path in interpret mode with HYBRID_ITERS = 4
    (all three are read while tracing, so the caches are cleared around)."""
    from superdsm_tpu.dsm import pallas_kernels as pk
    monkeypatch.setattr(pk, 'pallas_available', lambda: True)
    monkeypatch.setattr(pk, '_FORCE_INTERPRET', True)
    monkeypatch.setattr(pk, 'HYBRID_ITERS', 4)
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_hybrid_solve_matches_jax(jax_hybrid, monkeypatch):
    """HYBRID_ITERS = 4 at B = 2, P = 512, n = 128: the first 4 Newton
    iterations take the 1-pass dense gram. Converged lanes agree on the
    energy to rtol 1e-4; truncated lanes through the foreground they give
    (>= 99% of pixels)."""
    from superdsm_tpu_torch.dsm import gram
    pr = _hybrid_problem()
    keys = ('params0', 'Q', 'G', 'yv', 'w', 'alpha')
    out_j = jsolver._solve_batch_impl(
        *(jnp.asarray(pr[k]) for k in keys), 1.0, jnp.asarray(pr['kmask']),
        50, 1e-5)
    monkeypatch.setattr(gram, 'HYBRID_ITERS', 4)
    cheap_flags = []
    dispatch = gram.fused_grad_hess_batched

    def spy(*args, cheap=False, **kwargs):
        cheap_flags.append(cheap)
        return dispatch(*args, cheap=cheap, **kwargs)

    monkeypatch.setattr(gram, 'fused_grad_hess_batched', spy)
    out_t = tsolver._solve_batch_impl(
        *(_t(pr[k]) for k in keys), 1.0, _t(pr['kmask']), 50, 1e-5)
    assert cheap_flags[:4] == [True] * 4 and not any(cheap_flags[4:])
    assert len(cheap_flags) > 4
    _, f_t, conv_t, _, s_t, _ = (t.numpy() if hasattr(t, 'numpy') else t
                                 for t in out_t)
    _, f_j, conv_j, _, s_j, _ = (np.asarray(a) for a in out_j)
    w = pr['w'] > 0
    for b in range(2):
        if conv_t[b] and conv_j[b]:
            np.testing.assert_allclose(f_t[b], f_j[b], rtol=1e-4)
        agree = ((s_t[b] > 0) == (s_j[b] > 0))[w[b]].mean()
        assert agree >= 0.99, (b, agree)
    assert conv_t.any() and conv_j.any()
