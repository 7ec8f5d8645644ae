"""The port's native host library against the JAX package's.

The port builds its own copy of the C++ source
(``superdsm_tpu_torch/csrc/watershed.cpp``) and names no file of the JAX
package as something to read, build or import. Both compiled libraries are
loaded here (not their pure-Python fallbacks) and every entry point of the
port must equal the JAX package's bitwise on seeded inputs.
"""

import os
import re

import numpy as np
import pytest

import superdsm_tpu.native as jax_native
import superdsm_tpu_torch.native as port_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'superdsm_tpu_torch')


@pytest.fixture(scope='module')
def libs():
    port_lib, jax_lib = port_native.get_lib(), jax_native.get_lib()
    assert port_lib is not None, 'the port native library did not build'
    assert jax_lib is not None, 'the JAX package native library did not build'
    return port_lib, jax_lib


def test_port_native_source_lies_in_the_port(libs):
    src = os.path.realpath(port_native._SRC)
    assert src.startswith(os.path.realpath(PORT) + os.sep)
    assert os.path.isfile(src)
    assert os.path.realpath(port_native._LIB).startswith(
        os.path.realpath(port_native.BUILD_DIR) + os.sep)
    # the library was built from the port's source: it is newer than it
    assert os.path.getmtime(port_native._LIB) >= os.path.getmtime(src)


_IMPORT = re.compile(r'^\s*(import\s+superdsm_tpu(\s|\.|$|,)|'
                     r'from\s+superdsm_tpu(\s|\.))', re.M)
_PATH_JOIN = re.compile(r"""['"]superdsm_tpu['"]\s*[,)]|['"]superdsm_tpu/""")


def _sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(root, name)
    yield os.path.join(REPO, 'chip_smoke.py')


def _code_lines(text):
    """The text without docstrings and comments (a docstring may cite the
    reference)."""
    text = re.sub(r'("""|\'\'\')(.|\n)*?\1', '', text)
    return '\n'.join(line.split('#', 1)[0] for line in text.splitlines())


def test_port_reads_nothing_of_the_jax_package():
    files = list(_sources())
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as fin:
            code = _code_lines(fin.read())
        if _IMPORT.search(code):
            offenders.append((path, 'imports superdsm_tpu'))
        for m in _PATH_JOIN.finditer(code):
            line = code[:m.start()].rsplit('\n', 1)[-1] + code[m.start():].split('\n', 1)[0]
            # chip_smoke.py cites the TPU kernels' file:line in its JSON table
            if 'pallas_kernels.py' in line and path.endswith('chip_smoke.py'):
                continue
            offenders.append((path, line.strip()))
    assert not offenders, offenders


def test_scan_catches_an_import_and_a_path_join():
    assert _IMPORT.search(_code_lines('import superdsm_tpu.native\n'))
    assert _IMPORT.search(_code_lines('from superdsm_tpu.dsm import gram\n'))
    assert not _IMPORT.search(_code_lines('import superdsm_tpu_torch\n'))
    assert not _IMPORT.search(_code_lines('"""\nfrom superdsm_tpu import x\n"""\n'))
    assert _PATH_JOIN.search(_code_lines("os.path.join(r, 'superdsm_tpu', 'x')\n"))
    assert not _PATH_JOIN.search(_code_lines("os.path.join(r, 'superdsm_tpu_torch')\n"))


def _blobs(seed, H=61, W=83):
    rng = np.random.RandomState(seed)
    img = rng.rand(H, W).astype(np.float32)
    mask = rng.rand(H, W) < 0.7
    markers = np.zeros((H, W), np.int32)
    idx = rng.choice(H * W, 12, replace=False)
    markers.flat[idx] = np.arange(1, 13)
    return img, mask, markers


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('connectivity', [4, 8])
@pytest.mark.parametrize('masked', [False, True])
def test_watershed_equals_jax_native(libs, seed, connectivity, masked):
    img, mask, markers = _blobs(seed)
    m = mask if masked else None
    ours = port_native.watershed_native(img, markers, m, connectivity)
    ref = jax_native.watershed_native(img, markers, m, connectivity)
    assert ours is not None and ref is not None
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert len(np.unique(ours)) > 2


@pytest.mark.parametrize('seed', [0, 1])
def test_edt_equals_jax_native(libs, seed):
    _, mask, _ = _blobs(seed)
    ours, ref = port_native.edt_native(mask), jax_native.edt_native(mask)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert ours.max() > 1


@pytest.mark.parametrize('connectivity', [4, 8])
def test_maxfilt3_equals_jax_native(libs, connectivity):
    img = np.random.RandomState(connectivity).randn(47, 59)
    ours = port_native.maxfilt3_native(img, connectivity)
    ref = jax_native.maxfilt3_native(img, connectivity)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize('stride,offset', [(4, (0, 0)), (5, (2, 3)), (8, (-1, 9))])
def test_subsample_grid_equals_jax_native(libs, stride, offset):
    _, mask, _ = _blobs(stride)
    ours = port_native.subsample_grid_native(mask, stride, offset)
    ref = jax_native.subsample_grid_native(mask, stride, offset)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert ours.any()


@pytest.mark.parametrize('seed', [0, 1])
def test_chessboard_edt_equals_jax_native(libs, seed):
    rng = np.random.RandomState(seed)
    sources = rng.rand(53, 71) < 0.02
    ours = port_native.chessboard_edt_native(sources)
    ref = jax_native.chessboard_edt_native(sources)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert ours.max() > 2 and (ours[sources] == 0).all()
