"""The JAX package's Newton-system pixel sums taken to float64 at runtime.

The PyTorch port sums the pixels of its Newton systems in float64 and
rounds once to float32 (``superdsm_tpu_torch/dsm/gram.py``
``grad_hess_plain`` and the CUDA kernels' running sums; ``solver._lsq_init``);
the JAX package sums them in float32. :func:`install` swaps, in
``superdsm_tpu.dsm.solver``, exactly the two functions whose sums the port
takes to float64, and nothing else:

- ``_data_grad_hess``: g = Bfᵀ·term1 and H = Bfᵀ·diag(κ)·Bf, the gram of
  every CPU Newton step;
- ``_lsq_init``: A = Qᵀ·diag(w)·Q and b = Qᵀ·z of the elliptical
  initialization.

Each replacement keeps the package's own float32 arithmetic for everything
but those sums (the logistic weights, the ridge, the 6x6 solve); the sums
run on the host in float64 through ``jax.pure_callback`` (one callback per
batch: ``vmap_method='broadcast_all'``) and are rounded once to float32.
Every other reduction (energies, line search, scale sweep) stays float32 in
both packages. Files of the JAX package are not touched: the swap replaces
module attributes, which the solver reads when it is traced, and clears
JAX's caches so that no program traced before the swap is reused.

Usage::

    from tests.data.torch_port import f64sums
    with f64sums.f64_sums():
        ...   # the JAX package under the port's numerics contract

or ``f64sums.install()`` before the first solve of a script (a second call
is a no-op) and ``f64sums.uninstall()`` to restore the originals.
"""

import contextlib

import numpy as np

_ORIGINAL = {}


def _gram_sums(Bf, term1, kappa):
    """g (..., n) and H (..., n, n): float64 pixel sums of float32
    operands, rounded once to float32, lane by lane."""
    Bf, term1, kappa = (np.asarray(a) for a in (Bf, term1, kappa))
    lead, (P, n) = Bf.shape[:-2], Bf.shape[-2:]
    Bf = Bf.reshape(-1, P, n)
    term1 = np.broadcast_to(term1, lead + (P,)).reshape(-1, P)
    kappa = np.broadcast_to(kappa, lead + (P,)).reshape(-1, P)
    g = np.empty((Bf.shape[0], n), np.float32)
    H = np.empty((Bf.shape[0], n, n), np.float32)
    for b in range(Bf.shape[0]):
        Bd = Bf[b].astype(np.float64)
        g[b] = Bd.T @ term1[b].astype(np.float64)
        H[b] = (Bd * kappa[b].astype(np.float64)[:, None]).T @ Bd
    return g.reshape(lead + (n,)), H.reshape(lead + (n, n))


def _lsq_sums(Q, w, z):
    """A (..., 6, 6) and b (..., 6) of the elliptical initialization."""
    Qd = np.asarray(Q, np.float64)
    A = np.einsum('...pi,...pj->...ij', Qd * np.asarray(w, np.float64)[..., None], Qd)
    b = np.einsum('...pi,...p->...i', Qd, np.asarray(z, np.float64))
    return A.astype(np.float32), b.astype(np.float32)


def _data_grad_hess(Bf, s, yv, w):
    """``solver._data_grad_hess`` with float64 pixel sums."""
    import jax
    import jax.numpy as jnp
    t = yv * s
    sig = jax.nn.sigmoid(-t)
    term1 = -yv * sig * w
    kappa = w * yv * yv * sig * (1.0 - sig)
    n = Bf.shape[-1]
    shapes = (jax.ShapeDtypeStruct(Bf.shape[:-2] + (n,), jnp.float32),
              jax.ShapeDtypeStruct(Bf.shape[:-2] + (n, n), jnp.float32))
    return jax.pure_callback(_gram_sums, shapes, Bf, term1, kappa,
                             vmap_method='broadcast_all')


def _lsq_init(Q, yv, w, margin=2.0, ridge=1e-6):
    """``solver._lsq_init`` with float64 pixel sums."""
    import jax
    import jax.numpy as jnp
    z = margin * jnp.sign(yv) * w
    shapes = (jax.ShapeDtypeStruct(Q.shape[:-2] + (6, 6), jnp.float32),
              jax.ShapeDtypeStruct(Q.shape[:-2] + (6,), jnp.float32))
    A, b = jax.pure_callback(_lsq_sums, shapes, Q, w, z,
                             vmap_method='broadcast_all')
    A = A + ridge * jnp.trace(A, axis1=1, axis2=2)[:, None, None] * \
        jnp.eye(6, dtype=Q.dtype)[None]
    theta = jnp.linalg.solve(A, b[..., None])[..., 0]
    return jnp.where(jnp.isfinite(theta), theta, 0.0)


REPLACEMENTS = {'_data_grad_hess': _data_grad_hess, '_lsq_init': _lsq_init}


def _clear():
    import jax
    from superdsm_tpu.dsm import aot
    jax.clear_caches()
    aot._REGISTRY.clear()


def installed():
    return bool(_ORIGINAL)


def install():
    """Swaps the float64-sum versions in; a no-op when they are in."""
    if _ORIGINAL:
        return
    from superdsm_tpu.dsm import solver
    for name, fn in REPLACEMENTS.items():
        _ORIGINAL[name] = getattr(solver, name)
        setattr(solver, name, fn)
    _clear()


def uninstall():
    """Restores the JAX package's own functions; a no-op when they are."""
    if not _ORIGINAL:
        return
    from superdsm_tpu.dsm import solver
    for name, fn in _ORIGINAL.items():
        setattr(solver, name, fn)
    _ORIGINAL.clear()
    _clear()


@contextlib.contextmanager
def f64_sums():
    """The swap for the enclosed block (restored on exit, unless it was in
    before)."""
    was = installed()
    install()
    try:
        yield
    finally:
        if not was:
            uninstall()
