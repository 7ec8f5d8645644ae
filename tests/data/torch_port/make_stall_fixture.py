#!/usr/bin/env python
"""Writes ``stall-seed3-atom17.npz``: the arrays of one convex problem of
bench seed 3, the object of atom 17 alone, as ``diverge.py --footprint 17``
builds it (the JAX package's ``make_problem`` on its own atoms after
``c2f-region-analysis``, ``AF_scale=12``), with the solve's settings and
the exact float64 minimum of its energy (``exact_min.exact_minimum``, about
a minute).

Its JAX-package solve with float32 pixel sums stalls far above the optimum
that float64 sums reach; ``tests/test_torch_f64sums.py`` solves it in both
packages from these arrays.

``--c2f`` writes ``stall-seed3-c2f-279-380.npz`` instead: the c2f-region-
analysis solve of bench seed 3 at crop offset (279, 380) (4022 pixels, six
parameters, float64 sums), whose stall decides the split at (406.7, 430.1)
(``diverge.py --f64-sums --seed 3 --c2f-exact 430 407``), with its exact
minimum.

``--report`` solves the atom-17 problem instead: in the JAX package as
it is, with float64 sums (``f64sums``) jitted and op by op
(``jax.disable_jit``), and in the port on the CPU; it prints each
solution's energy under the JAX package's energy function
(``batching._host_energy_fg``) and under ``exact_min.energy``, beside the
exact minimum. Then it solves the c2f problem in both packages (the JAX
package with float32 and with float64 sums), alone and as each lane of a
batch of two copies, and prints each energy beside the exact minimum: a
lane's result in a six-parameter solve may depend on its batch.

Usage::

    JAX_PLATFORMS=cpu python tests/data/torch_port/make_stall_fixture.py [--c2f | --report]
"""

import os
import pathlib
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

SEED = 3
FOOTPRINT = (17,)
PATH = HERE / 'stall-seed3-atom17.npz'
C2F_OFFSET = (279, 380)
C2F_PATH = HERE / 'stall-seed3-c2f-279-380.npz'


def main():
    import numpy as np
    from bench import make_image
    from superdsm_tpu.automation import create_config
    from superdsm_tpu.config import Config
    from superdsm_tpu.image import Image
    from superdsm_tpu.output import get_output
    from superdsm_tpu.pipeline import create_default_pipeline
    from superdsm_tpu.dsm.smooth import smooth_matrix_params
    from tests.data.torch_port.diverge import footprint_problem
    from tests.data.torch_port.exact_min import exact_minimum

    g, _ = make_image(SEED)
    pipe = create_default_pipeline()
    cfg, _ = create_config(pipe, Config({'AF_scale': 12}), g)
    data = None
    for i, stage in enumerate(['preprocess', 'dsm', 'c2f-region-analysis']):
        data, _, _ = pipe.process_image(g, cfg, first_stage=None if i == 0 else stage,
                                        last_stage=stage, data=data,
                                        out=get_output(None).derive(muted=True))
    # the y_img that the global-energy-minimization stage builds
    data = dict(data, y_img=Image.create_from_array(data['y'], normalize=False,
                                                    mask=data['y_mask']))
    p = footprint_problem(FOOTPRINT, data)
    dsm_cfg = data['dsm_cfg']
    multiplier = dsm_cfg.get('gaussian_shape_multiplier', 2)
    _, cutoff = smooth_matrix_params(dsm_cfg['smooth_amount'], multiplier)
    e_min = exact_minimum(p, dsm_cfg['alpha'], dsm_cfg['epsilon'],
                          dsm_cfg['smooth_amount'], cutoff)
    np.savez_compressed(
        PATH, pts=p.pts, offset=p.offset, img_shape=np.asarray(p.img_shape),
        yv=p.yv, sub=p.sub, crop_shape=np.asarray(p.crop_shape),
        alpha=dsm_cfg['alpha'], epsilon=dsm_cfg['epsilon'],
        smooth_amount=dsm_cfg['smooth_amount'], gaussian_shape_multiplier=multiplier,
        exact_energy=e_min)
    print(f'wrote {PATH}: {p.n_pixels} pixels, {len(p.sub)} deformation points, '
          f'offset {tuple(int(v) for v in p.offset)}, exact minimum {e_min:.6f}')


def c2f_fixture():
    import numpy as np
    from bench import make_image
    from superdsm_tpu import c2freganal
    from superdsm_tpu.automation import create_config
    from superdsm_tpu.config import Config
    from superdsm_tpu.output import get_output
    from superdsm_tpu.pipeline import create_default_pipeline
    from tests.data.torch_port import f64sums
    from tests.data.torch_port.exact_min import exact_minimum

    f64sums.install()
    found = []
    solve = c2freganal.solve_problems

    def recording(problems, **kwargs):
        results = solve(problems, **kwargs)
        found.extend((p, r.energy) for p, r in zip(problems, results)
                     if tuple(int(v) for v in p.offset) == C2F_OFFSET)
        return results
    c2freganal.solve_problems = recording
    g, _ = make_image(SEED)
    pipe = create_default_pipeline()
    cfg, _ = create_config(pipe, Config({'AF_scale': 12}), g)
    pipe.process_image(g, cfg, last_stage='c2f-region-analysis',
                       out=get_output(None).derive(muted=True))
    c2freganal.solve_problems = solve
    (p, e_ref), = found
    e_min = exact_minimum(p)
    np.savez_compressed(C2F_PATH, pts=p.pts, offset=p.offset,
                        img_shape=np.asarray(p.img_shape), yv=p.yv,
                        energy_f64sums=e_ref, exact_energy=e_min)
    print(f'wrote {C2F_PATH}: {p.n_pixels} pixels, energy with float64 sums '
          f'{e_ref:.4f}, exact minimum {e_min:.4f}')


def report():
    import jax
    import numpy as np
    import superdsm_tpu_torch as T
    from superdsm_tpu.dsm import batching as jbatching
    from superdsm_tpu.dsm.smooth import smooth_matrix_params
    from superdsm_tpu_torch.dsm import batching as pbatching
    from tests.data.torch_port import exact_min, f64sums

    fx = dict(np.load(PATH))
    kw = dict(alpha=float(fx['alpha']), epsilon=float(fx['epsilon']),
              smooth_amount=float(fx['smooth_amount']),
              gaussian_shape_multiplier=int(fx['gaussian_shape_multiplier']))

    def problem(batching):
        return batching.Problem(pts=fx['pts'], offset=fx['offset'],
                                img_shape=tuple(int(v) for v in fx['img_shape']),
                                yv=fx['yv'], sub=fx['sub'])

    def solve(batching):
        return batching.solve_problems([problem(batching)], **kw)[0].params

    params = {'JAX, float32 sums': solve(jbatching)}
    with f64sums.f64_sums():
        params['JAX, float64 sums'] = solve(jbatching)
        with jax.disable_jit():
            params['JAX, float64 sums, op by op'] = solve(jbatching)
    T.set_device('cpu')
    params['port (CPU)'] = solve(pbatching)
    _, cutoff = smooth_matrix_params(kw['smooth_amount'], kw['gaussian_shape_multiplier'])
    args = (kw['alpha'], kw['epsilon'], kw['smooth_amount'], cutoff)
    for name, p in params.items():
        print(f'{name}: JAX energy function '
              f'{float(jbatching._host_energy_fg(problem(jbatching), p, *args)[0]):.4f}, '
              f'exact_min.energy {exact_min.energy(problem(jbatching), p, *args):.4f}')
    print(f'exact minimum {float(fx["exact_energy"]):.4f}')

    c2f = np.load(C2F_PATH)

    def c2f_energies(batching, B):
        p = batching.Problem(pts=c2f['pts'], offset=c2f['offset'],
                             img_shape=tuple(int(v) for v in c2f['img_shape']),
                             yv=c2f['yv'], sub=np.zeros((0, 2), np.int32))
        return [float(r.energy) for r in batching.solve_problems(
            [p] * B, smooth_amount=np.inf, fetch='energy')]

    energies = {}
    for B in (1, 2):
        energies[f'JAX, float32 sums, B = {B}'] = c2f_energies(jbatching, B)
        with f64sums.f64_sums():
            energies[f'JAX, float64 sums, B = {B}'] = c2f_energies(jbatching, B)
        energies[f'port (CPU), B = {B}'] = c2f_energies(pbatching, B)
    for name, e in energies.items():
        print(f'c2f problem at {C2F_OFFSET}, {name}: own energy '
              + ', '.join(f'{v:.4f}' for v in e))
    print(f'c2f problem exact minimum {float(c2f["exact_energy"]):.4f}')


if __name__ == '__main__':
    {'--report': report, '--c2f': c2f_fixture}.get(
        (sys.argv[1:] or [None])[0], main)()
