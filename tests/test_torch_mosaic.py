"""The port's tiled mosaics against the JAX package's, on the CPU.

- The 200x320 four-blob field of ``tests/test_parallel.py`` (tile 160,
  halo 48, ``AF_scale=10``) through both packages' ``process_mosaic``: the
  same object count, every object matched at center 3 px and size 10% with
  none unmatched.
- In the port: 1 and 2 threads per device give bitwise equal label maps;
  the halo guard warns on a blob wider than 0.8 * halo; an absent device
  raises; threads keep their assigned device, and a device scope holds in
  its own thread only; ``rasterize_mosaic_labels`` on overlapping bounding
  boxes equals the JAX function bitwise.
- ``interop.from_jax`` carries a JAX ``process_mosaic`` result into the
  port's ``MosaicObject``.
"""

import warnings

import numpy as np
import pytest
import torch

from tests.regression.validate import match_rows, summarize_label_map

import superdsm_tpu_torch as T
from superdsm_tpu_torch.interop import from_jax
from superdsm_tpu_torch.output import get_output
from superdsm_tpu_torch.parallel import (MosaicObject, process_mosaic,
                                         rasterize_mosaic_labels)

torch.set_num_threads(1)

SHAPE = (200, 320)
CENTERS = [(50, 50), (50, 200), (150, 100), (150, 270)]


@pytest.fixture(autouse=True)
def _cpu():
    with T.use_device('cpu'):
        yield


def _field(seed):
    rng = np.random.RandomState(seed)
    rr, cc = np.indices(SHAPE)
    g = np.zeros(SHAPE, np.float32)
    for (r0, c0) in CENTERS:
        g += np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * 9.0 ** 2)))
    return g + rng.randn(*SHAPE).astype(np.float32) * 0.02


def _muted():
    return get_output(None).derive(muted=True)


#: Both packages' configuration (speculation pinned off, as the threaded
#: run turns it off anyway).
CFG = {'AF_scale': 10, 'c2f-region-analysis': {'speculate': False}}


@pytest.fixture(scope='module')
def jax_mosaic():
    from superdsm_tpu.config import Config
    from superdsm_tpu.output import get_output as jget_output
    from superdsm_tpu.parallel.mosaic import process_mosaic as jprocess_mosaic
    from superdsm_tpu.pipeline import create_default_pipeline
    objects, n_tiles = jprocess_mosaic(create_default_pipeline(), Config(CFG),
                                       _field(0), tile=(160, 160), halo=48,
                                       out=jget_output(None).derive(muted=True))
    return objects, n_tiles


@pytest.fixture(scope='module')
def port_mosaic():
    with T.use_device('cpu'):
        return process_mosaic(T.create_default_pipeline(), T.Config(CFG), _field(0),
                              tile=(160, 160), halo=48, out=_muted())


def test_mosaic_matches_jax(jax_mosaic, port_mosaic):
    from superdsm_tpu.parallel.mosaic import rasterize_mosaic_labels as jraster
    jax_objects, jax_tiles = jax_mosaic
    objects, n_tiles = port_mosaic
    assert n_tiles == jax_tiles == 4
    assert len(objects) == len(jax_objects) == len(CENTERS)
    assert all(isinstance(o, MosaicObject) for o in objects)
    matched, spurious, missing = match_rows(
        summarize_label_map(rasterize_mosaic_labels(SHAPE, objects)),
        summarize_label_map(jraster(SHAPE, jax_objects)), center_tol=3.0,
        size_tol=0.1)
    assert (matched, spurious, missing) == (len(CENTERS), [], [])


def test_mosaic_threads_deterministic(port_mosaic):
    one = rasterize_mosaic_labels(SHAPE, port_mosaic[0])
    objects, _ = process_mosaic(T.create_default_pipeline, T.Config(CFG), _field(0),
                                tile=(160, 160), halo=48, out=_muted(),
                                threads_per_device=2)
    assert one.max() == len(CENTERS)
    assert np.array_equal(rasterize_mosaic_labels(SHAPE, objects), one)


def test_thread_device_assigner_and_scope():
    """Each thread keeps the device it was first given, round-robin over
    the list; a scope selects the device in its own thread only."""
    import threading
    from superdsm_tpu_torch.dsm.batching import device_scope, thread_device_assigner
    assign = thread_device_assigner(['a', 'b'])
    seen = {}
    barrier = threading.Barrier(3)

    def worker(k):
        seen[k] = [assign()]
        barrier.wait(timeout=30)
        seen[k].append(assign())

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert all(a == b for a, b in seen.values())
    assert sorted(a for a, _ in seen.values()) == ['a', 'a', 'b']

    with T.use_device('cuda'):
        with device_scope('cpu'):
            assert T.get_device() == torch.device('cpu')
            inner = []
            thread = threading.Thread(
                target=lambda: inner.append(T._device.scoped_device()))
            thread.start()
            thread.join(timeout=30)
            assert inner == [None]
        with device_scope(None):
            assert T._device.scoped_device() is None


def test_mosaic_halo_guard_warns_on_truncation():
    rng = np.random.RandomState(0)
    rr, cc = np.indices((160, 160))
    # one blob with diameter ~ 40 px, processed with halo=24 -> extent >= 0.8*halo
    g = np.exp(-(((rr - 80) ** 2 + (cc - 80) ** 2) / (2 * 12.0 ** 2))).astype(np.float32)
    g += rng.randn(160, 160).astype(np.float32) * 0.02
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        _, n_tiles = process_mosaic(T.create_default_pipeline(),
                                    T.Config({'AF_scale': 10}), g,
                                    tile=(80, 80), halo=24, out=_muted())
    assert n_tiles == 4
    assert [w for w in caught if issubclass(w.category, RuntimeWarning)
            and 'halo' in str(w.message)]


def test_mosaic_refuses_absent_device():
    with pytest.raises(RuntimeError, match='no CUDA device|not present'):
        process_mosaic(T.create_default_pipeline(), T.Config({'AF_scale': 10}),
                       _field(0), tile=(160, 160), halo=48, devices=['cuda:99'])


class _Obj:
    def __init__(self, off, frag):
        self.fg_offset = np.asarray(off)
        self.fg_fragment = frag


def test_rasterize_mosaic_labels_overlapping_bboxes_equals_jax():
    from superdsm_tpu.parallel.mosaic import (MosaicObject as JMosaicObject,
                                              rasterize_mosaic_labels as jraster)
    frag_a = np.zeros((6, 6), bool)
    frag_a[:, :2] = True
    frag_b = np.zeros((6, 6), bool)
    frag_b[:, 4:] = True
    for off_b in ((0, 0), (0, 3)):   # b's bbox covers a's pixels, then not
        objs = [(_Obj((0, 0), frag_a), (0, 0)), (_Obj(off_b, frag_b), (0, 0))]
        got = rasterize_mosaic_labels((8, 10), [MosaicObject(*o) for o in objs])
        ref = jraster((8, 10), [JMosaicObject(*o) for o in objs])
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        assert (got[:6, :2] == 1).all()


def test_from_jax_carries_mosaic_objects(jax_mosaic):
    jax_objects, _ = jax_mosaic
    carried = from_jax(jax_objects)
    assert [type(o) for o in carried] == [MosaicObject] * len(jax_objects)
    for got, ref in zip(carried, jax_objects):
        assert np.array_equal(got.fg_offset, ref.fg_offset)
        assert np.array_equal(got.fg_fragment, ref.fg_fragment)
        assert type(got.original).__module__.startswith('superdsm_tpu_torch.')
        assert type(got.original).__name__ == type(ref.original).__name__
    assert np.array_equal(rasterize_mosaic_labels(SHAPE, carried),
                          rasterize_mosaic_labels(SHAPE, jax_objects))
