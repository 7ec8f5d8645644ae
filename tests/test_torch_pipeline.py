"""The port's whole image path against the JAX package's, on the CPU.

``automation.process_image`` of both packages segments the same images: the
three-blob field of the verify recipe, and a reduced bench field
(``bench.make_image`` at 200x260 with 8 nuclei, ``AF_scale=12``). Stated
tolerances: equal object counts; label summaries matched with the
repository's regression matcher (center within 3 px, size within 10%) with
at most one unmatched object — the cross-backend allowance of one boundary
flip; foreground Dice >= 0.99. The JAX runs are shared through
module-scoped fixtures.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from bench import make_image
from tests.regression.validate import match_rows, summarize_label_map

import superdsm_tpu_torch as T
from superdsm_tpu_torch import interop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_jax(g, cfg_dict, pipeline_cfg=None):
    from superdsm_tpu.automation import process_image
    from superdsm_tpu.config import Config
    from superdsm_tpu.output import get_output
    from superdsm_tpu.pipeline import create_default_pipeline
    from superdsm_tpu.render import rasterize_labels
    cfg = Config(cfg_dict)
    data, _, _ = process_image(create_default_pipeline(), cfg, g,
                               out=get_output(None).derive(muted=True))
    return data, rasterize_labels(data)


def _run_port(g, cfg_dict, **kwargs):
    from superdsm_tpu_torch.automation import process_image
    from superdsm_tpu_torch.output import get_output
    from superdsm_tpu_torch.render import rasterize_labels
    with T.use_device('cpu'):
        data, cfg, _ = process_image(T.create_default_pipeline(), T.Config(cfg_dict),
                                     g, out=get_output(None).derive(muted=True),
                                     **kwargs)
    return data, rasterize_labels(data), cfg


def _three_blobs():
    rr, cc = np.indices((120, 120))
    g = sum(np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * (rad * 0.7) ** 2)))
            for r0, c0, rad in [(40, 40, 14), (40, 66, 12), (90, 90, 14)])
    g += np.random.RandomState(0).randn(120, 120) * 0.02
    return g.astype(np.float32)


_BLOB_CFG = {'AF_scale': 12, 'c2f-region-analysis/min_atom_radius': 6,
             'global-energy-minimization/beta': 0.5}


@pytest.fixture(scope='module')
def field():
    g, n = make_image(0, H=200, W=260, n_nuclei=8)
    jax_data, jax_seg = _run_jax(g, {'AF_scale': 12})
    port_data, port_seg, port_cfg = _run_port(g, {'AF_scale': 12})
    return dict(g=g, n=n, jax_data=jax_data, jax_seg=jax_seg,
                port_data=port_data, port_seg=port_seg, port_cfg=port_cfg)


def _assert_parity(seg, ref_seg, min_dice=0.99):
    rows, ref_rows = summarize_label_map(seg), summarize_label_map(ref_seg)
    _, spurious, missing = match_rows(rows, ref_rows, center_tol=3.0, size_tol=0.1)
    assert len(spurious) <= 1 and len(missing) <= 1, (spurious, missing)
    a, b = seg > 0, ref_seg > 0
    dice = 2.0 * (a & b).sum() / max(1, a.sum() + b.sum())
    assert dice >= min_dice, dice


def test_three_blobs_split_like_jax():
    g = _three_blobs()
    jax_data, jax_seg = _run_jax(g, _BLOB_CFG)
    port_data, port_seg, _ = _run_port(g, _BLOB_CFG)
    assert len(port_data['postprocessed_objects']) == 3
    assert len(jax_data['postprocessed_objects']) == 3
    _assert_parity(port_seg, jax_seg)


def test_reduced_bench_field_matches_jax(field):
    assert len(field['port_data']['postprocessed_objects']) == \
        len(field['jax_data']['postprocessed_objects']) == field['n']
    _assert_parity(field['port_seg'], field['jax_seg'])


def test_preprocess_offsets_match_jax(field):
    """Both packages quantize the offsets to int16 of the same range: they
    agree to one quantum (the float32 filters differ in summation order)."""
    y, y_ref = field['port_data']['y'], field['jax_data']['y']
    quantum = np.abs(y_ref).max() / 32767.0
    assert np.abs(y - y_ref).max() <= 1.5 * quantum


def test_gaussian_filter_matches_scipy():
    from superdsm_tpu_torch.ops.gaussian import gaussian_filter
    img = np.random.RandomState(4).rand(70, 90).astype(np.float32)
    for sigma in (np.sqrt(2), 12.0, 40.0):  # conv, Toeplitz, pad > size
        out = gaussian_filter(torch.from_numpy(img), sigma).numpy()
        ref = ndi.gaussian_filter(img.astype(np.float64), sigma, truncate=4.0)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_resume_from_jax_c2f_stage(field):
    """The batch pickup contract across packages: the JAX run's data after
    c2f-region-analysis, carried over with ``interop.from_jax``, resumes in
    the port at global-energy-minimization."""
    from superdsm_tpu_torch.output import get_output
    from superdsm_tpu_torch.render import rasterize_labels
    data = interop.from_jax(field['jax_data'])
    assert type(data['adjacencies']).__module__ == 'superdsm_tpu_torch.atoms'
    with T.use_device('cpu'):
        data, _, timings = T.create_default_pipeline().process_image(
            field['g'], field['port_cfg'], first_stage='global-energy-minimization',
            data=data, out=get_output(None).derive(muted=True))
    assert list(timings) == ['global-energy-minimization', 'postprocess']
    assert len(data['postprocessed_objects']) == field['n']
    _assert_parity(rasterize_labels(data), field['jax_seg'])


def test_import_leaves_jax_unloaded():
    code = ('import sys, superdsm_tpu_torch, superdsm_tpu_torch.automation, '
            'superdsm_tpu_torch.interop\n'
            'from superdsm_tpu_torch.dsm import batching, gram, solver\n'
            'bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")'
            ' or m.startswith("jaxlib") or m == "superdsm_tpu" '
            'or m.startswith("superdsm_tpu."))\n'
            'print(bad)\nsys.exit(1 if bad else 0)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_is_never_a_silent_fallback():
    with T.use_device('cuda'):
        if torch.cuda.is_available():
            assert T.get_device().type == 'cuda'
        else:
            with pytest.raises(RuntimeError):
                T.get_device()


def test_scale_estimation_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        T.automation.create_config(T.create_default_pipeline(), T.Config(),
                                   np.zeros((8, 8), np.float32))
