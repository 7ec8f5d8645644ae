#!/usr/bin/env python
"""Finds where the port's label map of a bench field leaves the JAX-CPU
golden, on the CPU.

1. Runs the JAX package on bench seed N (``AF_scale=12``) stage by stage,
   resumes the port from the JAX state before each of c2f, gem and
   postprocess (``interop.from_jax``), and matches each result against
   ``bench-seed{N}.csv`` (center 3 px, size 10%).
2. ``--near ROW COL``: the solves of c2f whose crop offset lies within 40 px
   of (ROW, COL), with their energies in each package, both resumed from
   the same JAX state after the ``dsm`` stage.
3. ``--footprint L [L ...]`` (or ``--at X Y``, the atom under that pixel):
   the object of those atom labels re-solved alone in each package
   (``compute_objects`` on the JAX package's atoms), and the JAX package's
   own energy (``batching._host_energy_fg``) at each package's solution: a
   far lower JAX energy at the port's parameters than at the reference's
   shows a stalled reference solve, not a port fault.

``--mosaic-tile ROW COL`` takes the 1184x1184 crop at (ROW, COL) of the
2048x2048 mosaic of ``mosaic-2048-seed0.csv`` (one default tile with its
halo; speculation off) instead of a bench field, and runs only step 3.

``--mosaic-witness LABELS`` takes the port's label map of that mosaic (the
``labels`` array of the ``.npz`` that ``chip_smoke.py`` phase 10 writes),
matches it against ``mosaic-2048-seed0.csv`` (center 3 px, size 10%) and, for
every row left unmatched, re-solves the atom under the row's center in the
tile whose core holds it, in each package, as step 3 does. It writes one
witness row per unmatched row to ``mosaic-2048-seed0-witness.csv``: the
row, its tile and atom, and the JAX package's energy function at the
reference's solution (``e_ref``) and at the port's (``e_port``). A row
without an energy witness (``e_port > WITNESS_RATIO * e_ref``) also gets
the exact float64 minimum of the atom's energy (``e_min``,
``exact_min.exact_minimum``; about a minute each) and the cause that it
shows (:func:`stall_cause`); ``chip_smoke.py`` fails on such a row without
a cause or with ``not isolated``.

``--c2f-exact ROW COL``: the c2f solves whose region holds pixel (ROW,
COL), in each package (resumed from the JAX state after ``dsm``), each with
the exact float64 minimum of its energy (``exact_min.exact_minimum``); then
the JAX package once more from that state to the end, with the energy of
each such solve replaced by its exact minimum, matched against the golden:
when that run gives the port's rows, the difference is the reference's
stalled solve there.

``--object-at X Y [X Y ...]``: the objects holding pixel (X, Y) in the JAX package's
label map and in the port's resumed from the JAX state after c2f (so both
work on the same atoms), each object's footprint re-solved alone in each
package as step 3 does, with the exact float64 minimum of its energy
(``exact_min.exact_minimum``; about a minute each). With ``--mosaic-tile``
the tile runs through postprocess for this.

``--f64-sums`` runs the JAX package with its Newton-system pixel sums in
float64 (``f64sums.install``), the port's numerics contract, and matches
against the goldens it wrote (``*-f64sums.csv``).

Usage::

    JAX_PLATFORMS=cpu python tests/data/torch_port/diverge.py --seed 3 \\
        --near 430 407 --footprint 17
    JAX_PLATFORMS=cpu python tests/data/torch_port/diverge.py --f64-sums \\
        --seed 3 --c2f-exact 430 407
    JAX_PLATFORMS=cpu python tests/data/torch_port/diverge.py \\
        --mosaic-tile 0 0 --at 344 811
    JAX_PLATFORMS=cpu python tests/data/torch_port/diverge.py \\
        --mosaic-witness chiprun_out/mosaic-2048-seed0-labels.npz
"""

import argparse
import os
import pathlib
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))


STAGES = ['dsm', 'c2f-region-analysis', 'global-energy-minimization', 'postprocess']
MOSAIC = dict(size=2048, tile=1024, halo=160)
#: Suffix of the goldens matched against: ``'-f64sums'`` under ``--f64-sums``.
SUFFIX = ''
WITNESS_COLUMNS = ['kind', 'size', 'x', 'y', 'tile_row', 'tile_col', 'atom',
                   'n_pixels', 'e_ref', 'e_port', 'e_min', 'cause']
#: A row has its energy witness when ``e_port <= WITNESS_RATIO * e_ref``
#: (``chip_smoke.WITNESS_RATIO``).
WITNESS_RATIO = 0.5
#: A solve stalls when it ends above this multiple of the exact minimum.
STALL_RATIO = 1.5


def stall_cause(e_ref, e_port, e_min):
    """What the exact minimum ``e_min`` of the atom's energy says of a row
    without an energy witness: which package's solve of the atom alone
    stops above :data:`STALL_RATIO` times it."""
    ref, port = e_ref > STALL_RATIO * e_min, e_port > STALL_RATIO * e_min
    if ref and port:
        return 'both solves stall'
    if ref:
        return 'reference solve stalls'
    if port:
        return 'port solve stalls'
    return 'not isolated'



def _match(tag, seg, seed):
    from tests.regression.validate import load_csv, match_rows, summarize_label_map
    matched, spurious, missing = match_rows(
        summarize_label_map(seg), load_csv(HERE / f'bench-seed{seed}{SUFFIX}.csv'),
        center_tol=3.0, size_tol=0.1)
    print(f'{tag}: {matched} matched, spurious {spurious}, missing {missing}')


def footprint_problem(footprint, c2f):
    """The JAX package's convex problem of the object of ``footprint`` (a
    set of atom labels) on the state ``c2f`` (atoms, ``y_img``,
    ``dsm_cfg``), as ``compute_objects`` builds it for a cold solve."""
    from superdsm_tpu import objects as jobjects
    from superdsm_tpu.dsm import batching as jbatching
    dsm_cfg = c2f['dsm_cfg']
    o = jobjects.Object()
    o.footprint = set(footprint)
    region = o.get_cvxprog_region(c2f['y_img'], c2f['atoms'],
                                  dsm_cfg['background_margin'])
    return jbatching.make_problem(
        region, img_shape=c2f['y_img'].model.shape,
        smooth_amount=dsm_cfg['smooth_amount'],
        smooth_subsample=dsm_cfg['smooth_subsample'])


def _energies(footprints, c2f):
    """Each footprint (a set of atom labels) re-solved alone in each package
    (``compute_objects`` on the JAX package's atoms); returns per footprint
    ``(n_pixels, e_ref, e_port)``: the JAX package's own energy function
    (``batching._host_energy_fg``) at the JAX package's solution and at the
    port's."""
    from superdsm_tpu import objects as jobjects
    from superdsm_tpu.dsm import batching as jbatching
    from superdsm_tpu.dsm.smooth import smooth_matrix_params
    from superdsm_tpu.output import get_output as jget_output
    from superdsm_tpu_torch import objects as pobjects
    from superdsm_tpu_torch.interop import from_jax
    from superdsm_tpu_torch.output import get_output

    dsm_cfg = dict(c2f['dsm_cfg'])
    _, cutoff = smooth_matrix_params(dsm_cfg['smooth_amount'], 2)
    solved = {}
    for name, objects, d, output in (('JAX', jobjects, c2f, jget_output),
                                     ('port', pobjects, from_jax(c2f), get_output)):
        solved[name] = [objects.Object() for _ in footprints]
        for o, footprint in zip(solved[name], footprints):
            o.footprint = set(footprint)
        objects.compute_objects(solved[name], d['y_img'], d['atoms'], dsm_cfg,
                                out=output(None).derive(muted=True))
    result = []
    for footprint, jo, po in zip(footprints, solved['JAX'], solved['port']):
        problem = footprint_problem(footprint, c2f)
        e_ref, e_port = (jbatching._host_energy_fg(
            problem, o._dsm_params, dsm_cfg['alpha'], dsm_cfg['epsilon'],
            dsm_cfg['smooth_amount'], cutoff)[0] for o in (jo, po))
        result.append((problem.n_pixels, float(e_ref), float(e_port)))
    return result


def mosaic_witness(labels_path):
    """``--mosaic-witness``: one witness row per row of the port's mosaic
    label map left unmatched against the golden (see the module doc)."""
    import csv
    import numpy as np
    from tools.mosaic_bench import make_mosaic
    from superdsm_tpu.automation import create_config
    from superdsm_tpu.config import Config
    from superdsm_tpu.image import Image
    from superdsm_tpu.output import get_output as jget_output
    from superdsm_tpu.dsm.smooth import smooth_matrix_params
    from superdsm_tpu.pipeline import create_default_pipeline
    from tests.data.torch_port.exact_min import exact_minimum
    from tests.regression.validate import load_csv, match_rows, summarize_label_map

    golden = HERE / f'mosaic-{MOSAIC["size"]}-seed0{SUFFIX}.csv'
    _, spurious, missing = match_rows(
        summarize_label_map(np.load(labels_path)['labels']), load_csv(golden),
        center_tol=3.0, size_tol=0.1)
    print(f'{len(spurious)} spurious and {len(missing)} missing rows against {golden.name}')
    size, tile, halo = MOSAIC['size'], MOSAIC['tile'], MOSAIC['halo']

    by_tile = {}  # core origin -> rows whose center it holds
    for kind, rows in (('spurious', spurious), ('missing', missing)):
        for row in rows:
            core = (int(row[2]) // tile * tile, int(row[1]) // tile * tile)
            by_tile.setdefault(core, []).append((kind, row))
    g_all = make_mosaic(size, seed=0)[0]
    jpipe = create_default_pipeline()
    out_rows = []
    for (cr, cc), rows in sorted(by_tile.items()):
        r0, c0 = max(0, cr - halo), max(0, cc - halo)  # the padded tile
        g = g_all[r0:min(size, cr + tile + halo), c0:min(size, cc + tile + halo)]
        cfg, _ = create_config(jpipe, Config({'AF_scale': 12, 'c2f-region-analysis':
                                              {'speculate': False}}), g)
        data = None
        for i, stage in enumerate(['preprocess'] + STAGES[:2]):
            data, _, _ = jpipe.process_image(
                g, cfg, first_stage=None if i == 0 else stage, last_stage=stage,
                data=data, out=jget_output(None).derive(muted=True))
        # the y_img that the global-energy-minimization stage builds
        data = dict(data, y_img=Image.create_from_array(data['y'], normalize=False,
                                                        mask=data['y_mask']))
        atoms = np.asarray(data['atoms'])
        under = [int(atoms[int(round(row[2])) - r0, int(round(row[1])) - c0])
                 for _, row in rows]
        labels = sorted({a for a in under if a})
        energies = dict(zip(labels, _energies([[a] for a in labels], data)))
        dsm_cfg = data['dsm_cfg']
        _, cutoff = smooth_matrix_params(dsm_cfg['smooth_amount'], 2)
        for (kind, row), atom in zip(rows, under):
            n_pixels, e_ref, e_port = energies.get(atom, (0, float('nan'), float('nan')))
            e_min, cause = '', ''
            if atom and not e_port <= WITNESS_RATIO * e_ref:
                e_min = exact_minimum(footprint_problem([atom], data), dsm_cfg['alpha'],
                                      dsm_cfg['epsilon'], dsm_cfg['smooth_amount'],
                                      cutoff)
                cause = stall_cause(e_ref, e_port, e_min)
                e_min = f'{e_min:.4f}'
            out_rows.append([kind, row[0], row[1], row[2], r0, c0, atom, n_pixels,
                             f'{e_ref:.4f}', f'{e_port:.4f}', e_min, cause])
            print(f'tile ({r0}, {c0}) {kind} {row}: atom {atom}, {n_pixels} pixels, '
                  f'e_ref {e_ref:.4f}, e_port {e_port:.4f}'
                  + (f', exact minimum {e_min}: {cause}' if cause else ''), flush=True)
    path = HERE / f'mosaic-{size}-seed0{SUFFIX}-witness.csv'
    with open(path, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(WITNESS_COLUMNS)
        writer.writerows(out_rows)
    print(f'wrote {path}: {len(out_rows)} rows')


def c2f_exact(pixel, solves, jc2f, jpipe, g, cfg, state, seed):
    """``--c2f-exact``: see the module doc."""
    import numpy as np
    from superdsm_tpu.output import get_output as jget_output
    from superdsm_tpu.render import rasterize_labels as jrasterize
    from tests.data.torch_port.exact_min import exact_minimum, start_condition
    exact, problems = {}, {}
    for name, rows in solves.items():
        for n_pixels, offset, e, p in rows:
            pts = p.pts.astype(int) + p.offset
            if not ((pts[:, 0] == pixel[0]) & (pts[:, 1] == pixel[1])).any():
                continue
            key = (offset, n_pixels)
            if key not in exact:
                exact[key], problems[key] = exact_minimum(p), p
            q = problems[key]
            same = bool(np.array_equal(p.pts, q.pts) and np.array_equal(p.yv, q.yv))
            print(f'{name} c2f solve holding {tuple(pixel)}: offset {offset}, '
                  f'{n_pixels} pixels, energy {e:.4f}, exact minimum {exact[key]:.4f}, '
                  f'first Newton system condition {start_condition(p):.3g}; '
                  f"pixels and intensities equal to the JAX package's: {same}")
    solve = jc2f.solve_problems

    def exact_energies(problems, **kwargs):
        results = solve(problems, **kwargs)
        for p, r in zip(problems, results):
            key = (tuple(int(x) for x in p.offset), p.n_pixels)
            if key in exact:
                r.energy = exact[key]
        return results
    jc2f.solve_problems = exact_energies
    data = dict(state['dsm'])
    for stage in STAGES[1:]:
        data, _, _ = jpipe.process_image(g, cfg, first_stage=stage, last_stage=stage,
                                         data=data, out=jget_output(None).derive(muted=True))
    jc2f.solve_problems = solve
    _match(f'JAX package with the exact minima of the c2f solves holding {tuple(pixel)}',
           jrasterize(data), seed)


def object_at(pixels, state, c2f, g, cfg):
    """``--object-at``: see the module doc."""
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.interop import from_jax
    from superdsm_tpu_torch.output import get_output
    pdata, _, _ = T.create_default_pipeline().process_image(
        g, T.Config(cfg.entries), first_stage='global-energy-minimization',
        data=from_jax(state['c2f-region-analysis']), out=get_output(None).derive(muted=True))
    for x, y in pixels:
        _objects_at(x, y, state['postprocess'], pdata, c2f)


def _objects_at(x, y, jdata, pdata, c2f):
    import numpy as np
    from superdsm_tpu.dsm.smooth import smooth_matrix_params
    from tests.data.torch_port.exact_min import exact_minimum
    from tests.regression.validate import summarize_label_map
    dsm_cfg = c2f['dsm_cfg']
    _, cutoff = smooth_matrix_params(dsm_cfg['smooth_amount'], 2)
    footprints = []
    for name, objects in (('JAX', jdata['postprocessed_objects']),
                          ('port', pdata['postprocessed_objects'])):
        for obj in objects:
            r, c = y - obj.fg_offset[0], x - obj.fg_offset[1]
            frag = obj.fg_fragment
            if 0 <= r < frag.shape[0] and 0 <= c < frag.shape[1] and frag[r, c]:
                labels = np.zeros(frag.shape, np.int32)
                labels[frag] = 1
                row = summarize_label_map(labels)[0]
                fp = sorted(int(a) for a in obj.original.footprint)
                print(f'{name} object holding ({x}, {y}): footprint {fp}, '
                      f'{int(frag.sum())} pixels, center ({row[1] + obj.fg_offset[1]:.1f}, '
                      f'{row[2] + obj.fg_offset[0]:.1f}) in the crop, energy '
                      f'{float(obj.original.energy):.4f}')
                if fp not in footprints:
                    footprints.append(fp)
    if not footprints:
        print(f'no object of either package holds ({x}, {y}) on the JAX '
              "package's atoms: a row there comes from the stages before "
              'global-energy-minimization')
    for fp, (n_pixels, e_ref, e_port) in zip(footprints, _energies(footprints, c2f)):
        e_min = exact_minimum(footprint_problem(fp, c2f), dsm_cfg['alpha'],
                              dsm_cfg['epsilon'], dsm_cfg['smooth_amount'], cutoff)
        print(f'footprint {fp} ({n_pixels} pixels) alone: the JAX energy function '
              f"at the JAX package's solution {e_ref:.4f}, at the port's "
              f'{e_port:.4f}; exact minimum {e_min:.4f}', flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=3)
    parser.add_argument('--near', type=int, nargs=2, default=None)
    parser.add_argument('--footprint', type=int, nargs='*', default=None)
    parser.add_argument('--at', type=int, nargs=2, default=None, metavar=('X', 'Y'))
    parser.add_argument('--mosaic-tile', type=int, nargs=2, default=None,
                        metavar=('ROW', 'COL'))
    parser.add_argument('--mosaic-witness', default=None, metavar='LABELS')
    parser.add_argument('--object-at', type=int, nargs='+', default=None,
                        metavar='X Y', help='one or more pixels, X Y each')
    parser.add_argument('--c2f-exact', type=int, nargs=2, default=None,
                        metavar=('ROW', 'COL'))
    parser.add_argument('--f64-sums', action='store_true',
                        help='the JAX package with float64 Newton-system pixel sums')
    args = parser.parse_args()
    if args.f64_sums:
        global SUFFIX
        from tests.data.torch_port import f64sums
        f64sums.install()
        SUFFIX = '-f64sums'
    if args.mosaic_witness:
        import superdsm_tpu_torch as T
        T.set_device('cpu')
        return mosaic_witness(args.mosaic_witness)

    from bench import make_image
    from superdsm_tpu import c2freganal as jc2f
    from superdsm_tpu.automation import create_config
    from superdsm_tpu.config import Config
    from superdsm_tpu.output import get_output as jget_output
    from superdsm_tpu.pipeline import create_default_pipeline
    from superdsm_tpu.render import rasterize_labels as jrasterize
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch import c2freganal as pc2f
    from superdsm_tpu_torch.interop import from_jax
    from superdsm_tpu_torch.output import get_output
    from superdsm_tpu_torch.render import rasterize_labels

    T.set_device('cpu')
    base = {'AF_scale': 12}
    if args.mosaic_tile:
        from tools.mosaic_bench import make_mosaic
        row, col = args.mosaic_tile
        g = make_mosaic(2048, seed=0)[0][row:row + 1184, col:col + 1184]
        base['c2f-region-analysis'] = {'speculate': False}
        stages = STAGES if args.object_at else STAGES[:-1]
    else:
        g, _ = make_image(args.seed)
        stages = STAGES
    jpipe = create_default_pipeline()
    cfg, _ = create_config(jpipe, Config(base), g)
    state, data = {}, None
    for i, stage in enumerate(['preprocess'] + stages):
        data, _, _ = jpipe.process_image(g, cfg, first_stage=None if i == 0 else stage,
                                         last_stage=stage, data=data,
                                         out=jget_output(None).derive(muted=True))
        state[stage] = dict(data)
    if not args.mosaic_tile:
        _match('JAX package', jrasterize(data), args.seed)

    solves = {'JAX': [], 'port': []}
    if args.near is not None or args.c2f_exact is not None:
        def spy(module, name):
            solve = module.solve_problems

            def recording(problems, **kwargs):
                results = solve(problems, **kwargs)
                solves[name] += [(p.n_pixels, tuple(int(x) for x in p.offset),
                                  float(r.energy), p) for p, r in zip(problems, results)]
                return results
            module.solve_problems = recording
        spy(jc2f, 'JAX')
        spy(pc2f, 'port')
        jpipe.process_image(g, cfg, first_stage='c2f-region-analysis',
                            last_stage='c2f-region-analysis', data=dict(state['dsm']),
                            out=jget_output(None).derive(muted=True))

    ppipe = T.create_default_pipeline()
    for before, stage in zip(STAGES, STAGES[1:]) if not args.mosaic_tile else ():
        pdata, _, _ = ppipe.process_image(g, T.Config(cfg.entries), first_stage=stage,
                                          data=from_jax(state[before]),
                                          out=get_output(None).derive(muted=True))
        _match(f'port from {stage}', rasterize_labels(pdata), args.seed)
    # only the resume from c2f runs c2f, so each package recorded one c2f run
    for name, rows in solves.items():
        if args.near:
            near = [r[:3] for r in rows if abs(r[1][0] - args.near[0]) <= 40
                    and abs(r[1][1] - args.near[1]) <= 40]
            print(f'{name} c2f solves near {tuple(args.near)} (pixels, offset, '
                  f'energy): {near}')
    if args.c2f_exact:
        c2f_exact(args.c2f_exact, solves, jc2f, jpipe, g, cfg, state, args.seed)

    c2f = state['global-energy-minimization']  # atoms and y_img of c2f
    if args.object_at:
        object_at(list(zip(args.object_at[::2], args.object_at[1::2])), state, c2f, g, cfg)
    if args.at:
        args.footprint = [int(c2f['atoms'][args.at[1], args.at[0]])]
    if args.footprint:
        ((n_pixels, e_ref, e_port),) = _energies([args.footprint], c2f)
        print(f'footprint {sorted(args.footprint)} ({n_pixels} pixels): the JAX '
              f"energy function at the JAX package's solution {e_ref:.4f}, at the "
              f"port's {e_port:.4f}")

if __name__ == '__main__':
    main()
