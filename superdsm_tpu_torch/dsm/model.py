"""Deformable shape model parameters.

Counterpart of the reference's ``DeformableShapeModel``
(``superdsm/dsm.py:22-128``). A model is the parameter vector
``(a1, a2, a3, b1, b2, c, xi...)`` of the surface

    s(x) = x^T A x + 2 b^T x + c + (G_omega xi)(x),

with ``A = [[a1, a3], [a3, a2]]`` (note the factor 2 on the linear term,
matching the reference's ``s()`` evaluation, not its docstring).
"""

import numpy as np


def polynomial_basis(coords):
    """Second-order basis features for coordinates ``coords`` of shape (..., 2).

    Returns shape (..., 6): ``(x1^2, x2^2, 2 x1 x2, 2 x1, 2 x2, 1)`` — the
    derivative maps of the surface w.r.t. theta
    (cf. ``superdsm/dsm.py:242-250``).
    """
    x1 = coords[..., 0]
    x2 = coords[..., 1]
    if isinstance(coords, np.ndarray):
        return np.stack([x1 * x1, x2 * x2, 2 * x1 * x2, 2 * x1, 2 * x2,
                         np.ones_like(x1)], axis=-1)
    import torch
    return torch.stack([x1 * x1, x2 * x2, 2 * x1 * x2, 2 * x1, 2 * x2,
                        torch.ones_like(x1)], dim=-1)


class DeformableShapeModel:
    """Fixed parameters of a deformable shape model.

    :ivar array: Full parameter vector ``(theta, xi)``.
    :ivar a: ``(a1, a2, a3)``.
    :ivar b: ``(b1, b2)``.
    :ivar c: scalar offset.
    :ivar ξ: deformation parameters.
    """

    def __init__(self, *args):
        if len(args) == 1 and len(args[0]) >= 6:
            self.array = np.asarray(args[0]).astype(float).reshape(-1)
            self.a = self.array[:3]
            self.b = self.array[3:5]
            self.c = self.array[5]
            self.ξ = self.array[6:]
        elif len(args) >= 1:
            assert isinstance(args[0], (int, np.ndarray))
            self.ξ = np.zeros(args[0]) if isinstance(args[0], int) else np.asarray(args[0]).reshape(-1)
            self.a = np.array([1., 1., 0.]) if len(args) < 2 else np.asarray(args[1]).flat[np.array([0, 3, 1])]
            self.b = np.zeros(2) if len(args) < 3 else np.asarray(args[2]).astype(float)
            self.c = 0. if len(args) < 4 else float(args[3])
            self.array = np.concatenate([self.a, self.b, np.array([self.c]), self.ξ])
        else:
            raise ValueError('Initialization failed')

    # alias for ASCII access
    @property
    def xi(self):
        return self.ξ

    @staticmethod
    def get_model(params):
        model = params if isinstance(params, DeformableShapeModel) else DeformableShapeModel(params)
        assert not np.isnan(model.array).any()
        return model

    def copy(self):
        return DeformableShapeModel(self.array.copy())

    @property
    def A(self):
        return np.array([self.a[0], self.a[2], self.a[2], self.a[1]]).reshape((2, 2))

    def s_polynomial(self, coords):
        """Polynomial part of the surface at ``coords`` (..., 2)."""
        theta = self.array[:6]
        return polynomial_basis(np.asarray(coords)) @ theta

    def s(self, x, smooth_mat=None):
        """Surface values at points ``x`` ((2, ...) stacked coordinate maps
        or a (2, P) list of points), plus the deformation term if a smooth
        matrix is given (rows aligned with the flattened points)."""
        xdim = x.ndim - 1 if isinstance(x, np.ndarray) else 0
        xvec = np.array(x, dtype=float).reshape((2, -1))
        svec = self.s_polynomial(xvec.T)
        if smooth_mat is not None and getattr(smooth_mat, 'shape', (0, 0))[1] > 0:
            svec = svec + smooth_mat @ self.ξ
        return svec.reshape(x.shape[-xdim:]) if isinstance(x, np.ndarray) else svec

    @staticmethod
    def create_ellipse(ξ, center, halfaxis1_len, halfaxis2_len, U=None):
        """Model of a (possibly deformed) ellipse with the given half axes."""
        ev = lambda half_length: (1. / np.square(half_length))
        if U is None:
            q, _ = np.linalg.qr(np.random.randn(2, 2))
            U = q
        A = U.dot(np.diag((ev(halfaxis1_len), ev(halfaxis2_len)))).dot(U.T)
        b = A.dot(center)
        c = np.inner(center, b) - 1
        return DeformableShapeModel(ξ, -A, b, -c)

    def map_to_image_pixels(self, g, roi, pad=0):
        """Transfers the model from normalized region coordinates to
        (optionally padded) full-image pixel coordinates
        (cf. ``superdsm/dsm.py:113-128``)."""
        assert pad >= 0 and isinstance(pad, int)
        g_shape = np.array(g.model.shape)
        roi_max_coord = np.array(roi.model.shape) - 1.
        del g_shape
        G = np.diag(1. / roi_max_coord)
        v = -G.dot(np.add(roi.offset, pad))
        A = G.dot(self.A).dot(G)
        b = G.dot(self.A.dot(v) + self.b)
        c = np.inner(v, self.A.dot(v)) + 2 * np.inner(self.b, v) + self.c
        return DeformableShapeModel(self.ξ, A, b, c)
