"""The comparison that decides ``correct``.

Once the window has closed, what the timed path produced is judged. A
configuration's ``limits/<config>.json`` names the numbers compared for it,
each with its limit, from these:

- ``label_error_share``, the label maps, through all five stages: every
  label map the window finished, against the nuclei the benchmark's own
  generator planted in that image (:func:`label_stats`). A planted nucleus
  is found when exactly one object covers its centre, that object covers
  no other planted centre, and its centroid lies within
  ``label_centroid_tol`` radii of the centre. The number is (planted
  nuclei not found + objects that cover no planted centre) over the
  planted nuclei, summed over the images. A wrong split in the
  coarse-to-fine region analysis, a wrong choice of the set cover or a
  wrong filter in the postprocessing moves it.
- ``label_spurious_share``, the label maps as above: the objects that
  cover no planted centre, over the planted nuclei.
- ``y_lsb``, the start: the offset image each sampled window image got from
  the preprocessing stage, against the reference's float64 offset image of
  the same raw image; the widest gap in int16 steps of the reference's
  ``max |y|``.
- ``solve_far_share``, the solve seam under the label maps: a sample of the
  window's convex region problems (drawn from the seed, the largest always
  in it), each minimized again in float64 from its definition by the plain
  reference; of those whose minimum exists, the share whose reported energy
  lies more than ``solve_far_gap`` times ``max(E_min, 1)`` from the
  minimum. A share and not a widest gap: the program's Newton loop stops
  some lanes far above the minimum on sound runs (PERF.md, Open
  questions); a fault that moves many lanes moves the share.
"""

import math
import time

import numpy as np
import torch

from portbench.reference import dsm, offsets


def sample_images(records, rng, count):
    idx = sorted(records)
    if len(idx) <= count:
        return idx
    return sorted(rng.choice(idx, size=count, replace=False).tolist())


def y_numbers(run, pick, device, dtype=torch.float64):
    """Widest gap (int16 steps) of each picked image's program offsets from
    the float64 reference's; with a lower ``dtype`` the reference computed
    in it stands in the program's place (the control)."""
    out = {}
    config = run.config['config']
    for i in pick:
        img = run.image(i)
        ref = offsets.offsets(img, config, torch.float64, device)
        lsb = float(np.abs(ref).max()) / 32767.0
        if dtype == torch.float64:
            got = run.records[i]['y']
        else:
            got = offsets.quantized(offsets.offsets(img, config, dtype, device))
        out[i] = float(np.abs(got - ref).max()) / lsb
    return out


def label_stats(labels, nuclei):
    """A label map against its planted nuclei ``(n, 3)`` (row, column,
    radius): ``(planted, spurious, distances)``, where ``distances`` holds,
    for each planted nucleus whose centre is covered by an object that
    covers no other planted centre, the distance of that object's centroid
    from the centre in radii (the others cannot be found)."""
    labels = np.asarray(labels)
    H, W = labels.shape
    r = np.clip(np.rint(nuclei[:, 0]).astype(np.int64), 0, H - 1)
    c = np.clip(np.rint(nuclei[:, 1]).astype(np.int64), 0, W - 1)
    flat = labels.ravel().astype(np.int64)
    flat = np.where(flat > 0, flat, 0)
    top = int(flat.max()) if flat.size else 0
    area = np.bincount(flat, minlength=top + 1).astype(np.float64)
    rows, cols = np.divmod(np.arange(flat.size), W)
    with np.errstate(invalid='ignore', divide='ignore'):
        cr = np.bincount(flat, weights=rows, minlength=top + 1) / area
        cc = np.bincount(flat, weights=cols, minlength=top + 1) / area
    at = flat[r * W + c]
    hits = np.bincount(at[at > 0], minlength=top + 1)
    one = (at > 0) & (hits[at] == 1)
    dist = np.hypot(cr[at] - nuclei[:, 0], cc[at] - nuclei[:, 1]) / nuclei[:, 2]
    present = area > 0
    present[0] = False
    spurious = int(np.sum(present & (hits == 0)))
    return len(nuclei), spurious, dist[one].tolist()


def label_error_share(stats, tol):
    """(not found + spurious) over planted, summed over ``stats``, each
    ``(planted, spurious, distances)``."""
    planted = sum(s[0] for s in stats)
    found = sum(int(np.sum(np.asarray(s[2]) <= tol)) for s in stats)
    spurious = sum(s[1] for s in stats)
    return (planted - found + spurious) / planted if planted else math.nan


def sample_problems(solves, images_done, rng, count):
    """``[(solve, problem index)]``: the largest problem (pixels times
    parameters) of the window and others drawn from ``rng``."""
    items = [(s, j) for s in solves if s['image'] in images_done
             for j, r in enumerate(s['results'])
             if r is not None and r.status == 'optimal']
    if not items:
        return []
    size = [len(s['problems'][j].pts) * (6 + len(s['problems'][j].sub)) for s, j in items]
    first = int(np.argmax(size))
    rest = [k for k in range(len(items)) if k != first]
    take = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [items[first]] + [items[rest[k]] for k in sorted(take)]


def solve_numbers(picked, device):
    """Per picked problem: the reference's minimum, whether it exists, and
    the gap of the program's reported energy from it."""
    rows = []
    for s, j in picked:
        p, r, a = s['problems'][j], s['results'][j], s['args']
        region = dsm.Region(p.pts, p.offset, p.img_shape, p.yv, p.sub,
                            a['alpha'] * getattr(p, 'alpha_scale', 1.0), a['epsilon'],
                            a['smooth_amount'], a['gaussian_shape_multiplier'], device)
        e_min, converged, iters = dsm.minimize(region)
        exists = dsm.has_minimum(region, e_min, converged)
        gap = abs(float(r.energy) - e_min) / max(abs(e_min), 1.0)
        rows.append(dict(P=len(p.pts), n=region.Bf.shape[1], e_min=e_min, e=float(r.energy),
                         exists=exists, iters=iters, gap=gap))
        del region
    return rows


def judge(run, limits, seed, device):
    """``(correct, numbers, notes)``: each number that ``limits`` names, with
    its limit. The readings behind the numbers are kept in
    ``run.check_details``."""
    t_start = time.perf_counter()
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 7])
    done = {i for i, rec in run.records.items() if rec.get('error') is None}
    notes = []
    values = {}
    ok = True
    if run.failed:
        ok = False
        notes.append(f'{run.failed} image(s) failed')
    stats = {i: label_stats(run.records[i]['labels'], run.truth(i)) for i in sorted(done)}
    planted = sum(s[0] for s in stats.values())
    spurious = sum(s[1] for s in stats.values())
    if 'label_error_share' in limits:
        values['label_error_share'] = label_error_share(list(stats.values()),
                                                        limits['label_centroid_tol'])
    if 'label_spurious_share' in limits:
        values['label_spurious_share'] = spurious / planted if planted else math.nan
    pick = sample_images({i: run.records[i] for i in done}, rng, limits['y_images'])
    ys = y_numbers(run, pick, device)
    values['y_lsb'] = max(ys.values()) if ys else math.nan
    picked = sample_problems(run.recorder.solves, done, rng, limits['solve_sample'])
    rows = solve_numbers(picked, device)
    judged = [r['gap'] for r in rows if r['exists']]
    far = sum(g > limits['solve_far_gap'] for g in judged)
    values['solve_far_share'] = far / len(judged) if judged else math.nan
    numbers = {k: dict(value=v, limit=limits[k]) for k, v in values.items()}
    notes.append(f'label maps {len(stats)}, planted {planted}, spurious {spurious}; '
                 f'problems sampled {len(rows)}, with a minimum {len(judged)}, far {far}, '
                 f'largest P {rows[0]["P"] if rows else 0} n {rows[0]["n"] if rows else 0}')
    for num in numbers.values():
        if not (num['value'] <= num['limit']):
            ok = False
    if not (stats and ys and judged):
        ok = False
        notes.append('nothing to judge')
    notes.append(f'reference {time.perf_counter() - t_start:.1f} s')
    run.check_details = dict(labels=stats, y=ys, problems=rows)
    return ok, numbers, notes
