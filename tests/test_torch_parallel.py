"""The port's threaded image stream and solve-seam guards, on the CPU.

- ``process_images_pipelined`` with 2 threads gives the serial results
  (equal label maps and energies), also with its workers spread over a
  device list; a list naming absent cards raises.
- The ``cp_timeout`` fallback rows equal the JAX package's
  ``_fallback_results_after_timeout`` on the same problems (energies to
  rtol 1e-6, masks and parameters equal), and ``solve_problems`` arms the
  deadline only on shapes that have run once.
- ``device_accounting()['wall_s']`` counts overlapping rounds of two
  threads once (the JAX package summed them).
- The gram launch counter loses no count under concurrent threads.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import batching, gram
from superdsm_tpu_torch.output import get_output
from superdsm_tpu_torch.parallel import process_images_pipelined, worker_stream
from superdsm_tpu_torch.render import rasterize_labels

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with T.use_device('cpu'):
        yield


def _field(seed):
    rr, cc = np.indices((110, 110))
    rng = np.random.RandomState(seed)
    g = np.zeros((110, 110))
    for _ in range(3):
        r0, c0 = rng.randint(25, 85, 2)
        g += np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * 8.0 ** 2)))
    return (g + rng.randn(110, 110) * 0.02).astype(np.float32)


def test_pipelined_equals_serial():
    cfg = T.Config({'AF_scale': 10, 'global-energy-minimization': {'beta': 0.5}})
    images = [_field(seed) for seed in (0, 1, 2)]
    threaded = process_images_pipelined(T.create_default_pipeline, cfg, images,
                                        threads=2)
    for img, data in zip(images, threaded):
        serial_cfg = cfg.copy()
        serial_cfg.set_default('c2f-region-analysis/speculate', False)
        ref, _, _ = T.automation.process_image(
            T.create_default_pipeline(), serial_cfg, img,
            out=get_output(None).derive(muted=True))
        assert np.array_equal(rasterize_labels(data), rasterize_labels(ref))
        assert [o.energy for o in data['objects']] == \
            [o.energy for o in ref['objects']]
        assert len(ref['postprocessed_objects']) >= 2


def test_pipelined_refuses_several_devices():
    """A device list naming cards that are not present raises before any
    image is processed."""
    with pytest.raises(RuntimeError, match='no CUDA device|not present'):
        process_images_pipelined(T.create_default_pipeline, T.Config(), [],
                                 devices=['cuda:0', 'cuda:99'])


def test_pipelined_stream_across_devices():
    """Workers round-robin over a device list, each pinned to its device,
    with the shared-device stream's results."""
    cfg = T.Config({'AF_scale': 10, 'global-energy-minimization': {'beta': 0.5}})
    images = [_field(seed) for seed in (0, 1)]
    shared = process_images_pipelined(T.create_default_pipeline, cfg, images,
                                      threads=2)
    per_device = process_images_pipelined(T.create_default_pipeline, cfg, images,
                                          threads=2, devices=['cpu', 'cpu'])
    for a, b in zip(shared, per_device):
        assert np.array_equal(rasterize_labels(a), rasterize_labels(b))


def test_worker_stream_is_a_no_op_on_the_cpu():
    with worker_stream() as stream:
        assert stream is None


def _problem_pairs():
    """The same regions as problems of both packages: cold, warm-started,
    deformation-free, and one pixel-subsampled (oversized) stand-in."""
    import superdsm_tpu.dsm.batching as jb
    from superdsm_tpu.image import Image as JImage
    from superdsm_tpu_torch.image import Image as PImage
    rng = np.random.RandomState(5)
    rr, cc = np.indices((90, 100))
    y = (np.exp(-(((rr - 40) ** 2 + (cc - 55) ** 2) / 300.0)) - 0.3
         + rng.randn(90, 100) * 0.05).astype(np.float32)
    masks = [(rr - 40) ** 2 + (cc - 55) ** 2 < r * r for r in (20, 26, 14)]
    pairs = []
    for k, mask in enumerate(masks):
        smooth = np.inf if k == 2 else 10
        made = [pkg.make_problem(img(model=y, mask=mask), smooth_amount=smooth,
                                 smooth_subsample=8, tag=k)
                for pkg, img in ((jb, JImage), (batching, PImage))]
        if k == 1:
            init = rng.randn(6 + made[0].n_deform).astype(np.float32) * 0.1
            for p in made:
                p.init_params = init
        pairs.append(made)
    jax_problems, port_problems = (list(x) for x in zip(*pairs))
    oversized = []
    for mod, problems in ((jb, jax_problems), (batching, port_problems)):
        orig = problems[0]
        sub = mod.Problem(pts=orig.pts[::3].copy(), offset=orig.offset,
                          img_shape=orig.img_shape, yv=orig.yv[::3].copy(),
                          sub=orig.sub, tag=orig.tag, alpha_scale=1 / 3)
        oversized.append({3: (3.0, orig)})
        problems.append(sub)
    return jb, jax_problems, port_problems, oversized


@pytest.mark.parametrize('fetch', ['full', 'energy'])
def test_fallback_rows_equal_jax(fetch):
    jb, jax_problems, port_problems, (jax_over, port_over) = _problem_pairs()
    args = (0.5, 1.0, 10.0, 16, fetch)
    ref = jb._fallback_results_after_timeout(jax_problems, jax_over, *args)
    got = batching._fallback_results_after_timeout(port_problems, port_over, *args)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.status == r.status == 'fallback' and g.tag == r.tag
        np.testing.assert_allclose(g.energy, r.energy, rtol=1e-6)
        if fetch == 'full':
            assert np.array_equal(g.params, r.params)
            assert np.array_equal(g.fg, r.fg)
        else:
            assert g.params is None and g.fg is None


def test_timeout_arms_on_warm_shapes_and_falls_back(monkeypatch):
    _, _, problems, _ = _problem_pairs()
    problems = problems[:3]
    seen = []
    real_fetch = batching._fetch_with_deadline

    def fetch(sel, timeout):
        seen.append(timeout)
        if timeout is not None:
            raise batching.SolveTimeout('simulated')
        return real_fetch(sel, timeout)

    monkeypatch.setattr(batching, '_WARM_SHAPES', set())
    monkeypatch.setattr(batching, '_fetch_with_deadline', fetch)
    solved = batching.solve_problems(problems, smooth_amount=10, timeout=5)
    assert seen[0] is None  # cold shapes: no deadline
    assert all(r.status == 'optimal' for r in solved)
    fallback = batching.solve_problems(problems, smooth_amount=10, timeout=5)
    assert seen[-1] == 5
    cutoff = batching.smooth_matrix_params(10, 2)[1]
    ref = batching._fallback_results_after_timeout(problems, {}, 0.5, 1.0, 10,
                                                   cutoff, 'full')
    assert [r.energy for r in fallback] == [r.energy for r in ref]
    assert all(r.status == 'fallback' for r in fallback)
    seen.clear()
    batching.solve_problems(problems, smooth_amount=10, timeout=0)
    assert seen == [0]  # <= 0 disables the deadline


def test_fetch_with_deadline_on_the_cpu(monkeypatch):
    x = torch.arange(6.0)
    assert np.array_equal(batching._fetch_with_deadline([{'x': x}], 10)[0]['x'],
                          np.arange(6.0))
    real = batching._to_host

    def slow(tree):
        time.sleep(0.5)
        return real(tree)

    monkeypatch.setattr(batching, '_to_host', slow)
    with pytest.raises(batching.SolveTimeout):
        batching._fetch_with_deadline([x], 0.05)


def test_wall_time_counts_overlapping_rounds_once(monkeypatch):
    barrier = threading.Barrier(2)

    def round_(*args):
        barrier.wait()
        time.sleep(0.3)
        return []

    monkeypatch.setattr(batching, '_solve_problems', round_)
    before = batching.device_accounting()['wall_s']
    t0 = time.perf_counter()
    threads = [threading.Thread(target=batching.solve_problems, args=([object()],))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    elapsed = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads)
    wall = batching.device_accounting()['wall_s'] - before
    assert 0.3 <= wall <= elapsed


class _YieldingCounts(dict):
    """Launch counts whose every read yields the interpreter lock, so an
    unlocked read-modify-write would interleave with other threads'."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counter_loses_no_count(monkeypatch):
    """More threads than cores, with a shortened switch interval, count at
    once; a lost read-modify-write would show as a missing count."""
    monkeypatch.setattr(gram, 'LAUNCHES', _YieldingCounts(gram.LAUNCHES))
    gram.reset_launch_counts()
    n_threads, per_thread = 16, 1000

    def count():
        for _ in range(per_thread):
            gram._count_launch('dense')
            gram._count_launch('banded-1pass')

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert dict(gram.LAUNCHES)['dense'] == dict(gram.LAUNCHES)['banded-1pass'] == \
        n_threads * per_thread
