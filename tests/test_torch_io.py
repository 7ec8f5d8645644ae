"""The port's image codecs against Pillow and the JAX package's ``io``.

``superdsm_tpu_torch.io`` decodes and encodes PNG and baseline TIFF itself.
Held bitwise, in both directions, on the same numpy arrays: what the port
writes, Pillow and ``superdsm_tpu.io.imread`` read back as the same array
(dtype, shape and values), and what ``superdsm_tpu.io.imsave`` (Pillow)
writes, the port reads back as ``superdsm_tpu.io.imread`` does — with and
without ``as_gray``.
"""

import struct
import sys
import zlib

import numpy as np
import PIL.Image
import pytest

import superdsm_tpu.io as jax_io
from superdsm_tpu_torch import io as port_io

REPO_IMAGE = 'tests/regression/data/nih3t3-glare.png'

_RNG = np.random.RandomState(0)
CASES = {
    'gray8': _RNG.randint(0, 256, (37, 53)).astype(np.uint8),
    'gray16': _RNG.randint(0, 65536, (37, 53)).astype(np.uint16),
    'rgb': _RNG.randint(0, 256, (37, 53, 3)).astype(np.uint8),
    'rgba': _RNG.randint(0, 256, (37, 53, 4)).astype(np.uint8),
    'bool': _RNG.rand(37, 53) > 0.5,
    'float': _RNG.randn(37, 53),
    'float_rgb': _RNG.rand(37, 53, 3).astype(np.float32),
    'int32_labels': _RNG.randint(-3, 80000, (37, 53)).astype(np.int32),
    'int64': _RNG.randint(0, 300, (37, 53)),
}


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize('ext', ['png', 'tif'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_roundtrip_against_pillow_and_jax(tmp_path, name, ext):
    img = CASES[name]
    port_file, jax_file = tmp_path / f'port.{ext}', tmp_path / f'jax.{ext}'
    port_io.imsave(str(port_file), img)
    jax_io.imsave(str(jax_file), img)
    for as_gray in (False, True):
        ref = jax_io.imread(str(jax_file), as_gray=as_gray)
        assert _same(jax_io.imread(str(port_file), as_gray=as_gray), ref)
        assert _same(port_io.imread(str(jax_file), as_gray=as_gray), ref)
        assert _same(port_io.imread(str(port_file), as_gray=as_gray), ref)
    with PIL.Image.open(port_file) as im:
        assert _same(np.asarray(im), jax_io.imread(str(jax_file), as_gray=False))


def test_int32_label_map_is_16bit_png_clipped(tmp_path):
    labels = np.array([[0, 1, 300], [65535, 70000, -5]], np.int32)
    port_io.imsave(str(tmp_path / 'seg.png'), labels)
    with PIL.Image.open(tmp_path / 'seg.png') as im:
        assert im.mode == 'I;16'
    assert _same(jax_io.imread(str(tmp_path / 'seg.png')),
                 np.array([[0, 1, 300], [65535, 65535, 0]], np.uint16))


def _stack(dtype):
    return (np.random.RandomState(1).rand(3, 20, 30) * 250).astype(dtype)


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.int32])
def test_multipage_tiff_written_by_the_port(tmp_path, dtype):
    stack = _stack(dtype)
    port_io.imsave(str(tmp_path / 'port.tif'), stack)
    assert _same(jax_io.imread(str(tmp_path / 'port.tif')), stack)


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.int32, np.float32])
def test_multipage_tiff_read_by_the_port(tmp_path, dtype):
    stack = _stack(dtype)
    pages = [PIL.Image.fromarray(page) for page in stack]
    pages[0].save(tmp_path / 'pil.tif', save_all=True, append_images=pages[1:])
    assert _same(port_io.imread(str(tmp_path / 'pil.tif')), stack)


def test_bbbc039_style_16bit_tiff(tmp_path):
    field = np.random.RandomState(2).randint(0, 4096, (520, 696)).astype(np.uint16)
    PIL.Image.fromarray(field).save(tmp_path / 'field.tif')
    assert _same(port_io.imread(str(tmp_path / 'field.tif')), field)
    port_io.imsave(str(tmp_path / 'port.tif'), field)
    assert _same(jax_io.imread(str(tmp_path / 'port.tif')), field)


def test_nih3t3_png_equals_jax_imread():
    assert _same(port_io.imread(REPO_IMAGE), jax_io.imread(REPO_IMAGE))


def _png_with_filters(rows, depth, color, ftypes):
    """A PNG of the given raw rows (uint8, bytes per row) whose row ``r`` is
    filtered with ``ftypes[r]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[color] * depth // 8
    height, width = rows.shape[0], rows.shape[1] // bpp
    prev = np.zeros(rows.shape[1], int)
    out = []
    for r, t in enumerate(ftypes):
        cur = rows[r].astype(int)
        filt = np.zeros_like(cur)
        for x in range(len(cur)):
            a = cur[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) \
                else (b if abs(p - b) <= abs(p - c) else c)
            pred = [0, a, b, (a + b) // 2, paeth][t]
            filt[x] = (cur[x] - pred) % 256
        out.append(bytes([t]) + bytes(filt.astype(np.uint8)))
        prev = cur

    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, depth, color, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(out)))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('depth,color', [(8, 0), (16, 0), (8, 2), (8, 4), (8, 6),
                                         (16, 2), (16, 6), (16, 4)])
def test_every_filter_type(tmp_path, depth, color):
    rng = np.random.RandomState(depth + color)
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[color] * depth // 8
    rows = rng.randint(0, 256, (15, 11 * bpp)).astype(np.uint8)
    path = tmp_path / 'filtered.png'
    path.write_bytes(_png_with_filters(rows, depth, color,
                                       [r % 5 for r in range(15)]))
    with PIL.Image.open(path) as im:
        ref = np.asarray(im)
    assert _same(port_io.imread(str(path), as_gray=False), ref)
    only_up = tmp_path / 'up.png'
    only_up.write_bytes(_png_with_filters(rows, depth, color, [2, 1, 0] * 5))
    with PIL.Image.open(only_up) as im:
        assert _same(port_io.imread(str(only_up), as_gray=False), np.asarray(im))


def test_pillow_only_features_raise_without_pillow(tmp_path, monkeypatch):
    img = np.zeros((4, 4), np.uint8)
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError, match='JPEG'):
        port_io.imsave(str(tmp_path / 'x.jpg'), img)
    with pytest.raises(ImportError, match='shape='):
        port_io.imsave(str(tmp_path / 'x.png'), img, shape=(8, 8))
    with pytest.raises(ValueError, match='extension'):
        port_io.imsave(str(tmp_path / 'x.bmp'), img)
    port_io.imsave(str(tmp_path / 'x.png'), img)  # the own codecs need nothing
    assert _same(port_io.imread(str(tmp_path / 'x.png')), img)


def test_pillow_only_features_with_pillow(tmp_path):
    img = (np.random.RandomState(3).rand(16, 16) * 255).astype(np.uint8)
    port_io.imsave(str(tmp_path / 'small.png'), img, shape=(8, 8))
    jax_io.imsave(str(tmp_path / 'small_jax.png'), img, shape=(8, 8))
    assert _same(port_io.imread(str(tmp_path / 'small.png')),
                 jax_io.imread(str(tmp_path / 'small_jax.png')))
    jax_io.imsave(str(tmp_path / 'x.jpg'), img)
    assert _same(port_io.imread(str(tmp_path / 'x.jpg')),
                 jax_io.imread(str(tmp_path / 'x.jpg')))
