"""Stage 2: DSM hyperparameter materialization.

Fetches the ``dsm/*`` hyperparameter namespace into the ``dsm_cfg`` output
dictionary so downstream stages can consume it
(cf. ``superdsm/dsmcfg.py:6-97``).

Notes on design differences: ``cachesize``/``cachetest`` (cvxopt callback
caching), ``smooth_mat_dtype`` and ``smooth_mat_max_allocations`` (POSIX
semaphore throttling) are accepted for config compatibility but have no
effect — the batched solver has a static iteration bound
(``dsm/newton_maxiter``). ``cp_timeout`` bounds the wall clock of copying
each batched solve round's results to the host on the card; on expiry the
round's problems fall back to their initializations, the batched analog of
the reference's per-solve SIGALRM (``superdsm/dsm.py:478-490``). It is off
on the CPU, where large rounds legitimately take minutes.
"""

import numpy as np

from .pipeline import Stage


DSM_CONFIG_DEFAULTS = {
    'cachesize': 1,
    'cachetest': None,
    'sparsity_tol': 0,
    'init': 'elliptical',
    'smooth_amount': 10,
    'epsilon': 1.0,
    'alpha': 0.5,
    'scale': 1000,
    'smooth_subsample': 20,
    'gaussian_shape_multiplier': 2,
    'smooth_mat_dtype': 'float32',
    'smooth_mat_max_allocations': np.inf,
    'background_margin': 20,
    'cp_timeout': 300,
    'newton_maxiter': 50,
    'newton_tol': 1e-5,
}


class DSM_Config(Stage):

    ENABLED_BY_DEFAULT = True

    def __init__(self):
        super().__init__('dsm', inputs=[], outputs=['dsm_cfg'])

    def process(self, input_data, cfg, out, log_root_dir):
        dsm_cfg = {
            key: cfg.get(key, DSM_CONFIG_DEFAULTS[key]) for key in DSM_CONFIG_DEFAULTS.keys()
        }
        return {
            'dsm_cfg': dsm_cfg
        }

    def configure_ex(self, scale, radius, diameter):
        return {
            'alpha': (scale ** 2, 0.0005),
            'smooth_amount': (scale, 0.2, dict(type=int, min=4)),
            'smooth_subsample': (scale, 0.4, dict(type=int, min=8)),
            'background_margin': (scale, 0.4, dict(type=int, min=8)),
        }
