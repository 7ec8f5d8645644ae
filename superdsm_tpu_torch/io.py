"""Image file I/O with codecs of its own.

Port of :mod:`superdsm_tpu.io`, which reads and writes through Pillow. The
formats the batch and export CLIs use are decoded and encoded here in numpy
with :mod:`zlib` and :mod:`struct`, so the CLIs run where no imaging library
is installed:

- PNG, read and write: 8- and 16-bit gray, 8-bit gray+alpha, RGB and RGBA
  (16-bit RGB and RGBA on read), every filter type;
- baseline uncompressed TIFF, read and write: 8-, 16- and 32-bit gray
  (32-bit integer or float) and 8-bit RGB and RGBA, single or multi-page.

Both decode to the arrays Pillow 12 gives (``np.asarray`` of the opened
image; Pillow keeps only the high byte of 16-bit RGB and RGBA PNG samples,
and so does this reader) and write what Pillow writes for the same array: an
int32 label map becomes a 16-bit gray PNG clipped to [0, 65535] (a 32-bit
gray TIFF keeps it whole). The semantics of :func:`imread` and
:func:`imsave` are the JAX package's.

Other formats and variants (JPEG, compressed or tiled TIFF, palette,
sub-byte or interlaced PNG) and the ``shape=`` resize import Pillow when
they are used, and raise an :class:`ImportError` naming the feature where it
is not installed.
"""

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_SUFFIXES = ('png', 'jpg', 'jpeg', 'tif', 'tiff')
#: Luminance weights of ``as_gray`` (skimage's ``rgb2gray``).
_GRAY_WEIGHTS = np.array([0.2125, 0.7154, 0.0721])


class _NeedsPillow(Exception):
    """The file is in a variant this module does not decode."""


def _pillow(feature):
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f'{feature} needs Pillow, which is not '
                          'installed') from None
    return Image


def _suffix(filepath):
    suffix = str(filepath).lower().rsplit('.', 1)[-1]
    if suffix not in _SUFFIXES:
        raise ValueError(f'unknown file extension: .{suffix}')
    return suffix


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

#: channels per PNG color type (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunks(data):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError('not a PNG file')
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IEND':
            return


def _unfilter_rows(ftype, F):
    """Rows of filter types 0-2 only: each row at once."""
    R = np.empty_like(F)
    prev = np.zeros(F.shape[1:], np.uint8)
    for r, t in enumerate(ftype):
        if t == 0:
            cur = F[r]
        elif t == 1:
            cur = np.cumsum(F[r], axis=0, dtype=np.uint8)  # wraps mod 256
        else:
            cur = F[r] + prev
        R[r] = prev = cur
    return R


def _unfilter_wavefront(ftype, F):
    """Any filter types: a byte depends on its left, upper and upper-left
    neighbors, so every anti-diagonal of pixels is reconstructed at once."""
    H, W, bpp = F.shape
    Rp = np.zeros((H + 1, W + 1, bpp), np.int16)  # one row/column of zeros
    Fi = F.astype(np.int16)
    types = ftype.astype(np.int16)
    for d in range(H + W - 1):
        rr = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        xx = d - rr
        a, b, c = Rp[rr + 1, xx], Rp[rr, xx + 1], Rp[rr, xx]
        t = types[rr][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        Rp[rr + 1, xx + 1] = (Fi[rr, xx] + pred) & 255
    return Rp[1:, 1:].astype(np.uint8)


def _png_decode(data):
    header, idat = None, []
    for kind, chunk in _png_chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', chunk)
        elif kind == b'IDAT':
            idat.append(chunk)
    if header is None:
        raise ValueError('PNG without IHDR')
    width, height, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _PNG_CHANNELS or interlace:
        raise _NeedsPillow(f'PNG of bit depth {depth}, color type {color}, '
                           f'interlace {interlace}')
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    raw = raw[:height * (1 + width * bpp)].reshape(height, 1 + width * bpp)
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError('PNG row with an unknown filter type')
    F = raw[:, 1:].reshape(height, width, bpp)
    R = (_unfilter_rows if not np.isin(ftype, (3, 4)).any()
         else _unfilter_wavefront)(ftype, F)
    if depth == 8:
        return R[..., 0] if channels == 1 else R
    if channels == 1:  # big-endian samples
        return R.view('>u2')[..., 0].astype(np.uint16)
    hi = R[..., 0::2]  # Pillow keeps the high byte of 16-bit color samples
    if channels == 2:  # ... and reads 16-bit gray+alpha as RGBA
        hi = hi[..., [0, 0, 0, 1]]
    return np.ascontiguousarray(hi)


def _png_chunk(kind, payload):
    return (struct.pack('>I', len(payload)) + kind + payload
            + struct.pack('>I', zlib.crc32(kind + payload) & 0xffffffff))


def _png_encode(img):
    """``img``: uint8 (H, W) or (H, W, 2|3|4), or uint16 (H, W). Every row
    is written with the Up filter."""
    height, width = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    depth = 16 if img.dtype == np.uint16 else 8
    R = (img.astype('>u2') if depth == 16 else img).view(np.uint8)
    R = np.ascontiguousarray(R).reshape(height, -1)
    F = R.copy()
    F[1:] -= R[:-1]  # wraps mod 256
    raw = np.concatenate([np.full((height, 1), 2, np.uint8), F], axis=1)
    return (_PNG_SIGNATURE
            + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, depth,
                                              color, 0, 0, 0))
            + _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b'IEND', b''))


def _png_array(img):
    """The array Pillow would store for ``img`` in a PNG."""
    if img.dtype == np.int32 and img.ndim == 2:
        return img.clip(0, 65535).astype(np.uint16)
    if img.dtype == np.uint16 and img.ndim == 2:
        return img
    if img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and
                                                    img.shape[2] in (2, 3, 4))):
        return img
    raise TypeError(f'cannot write a {img.dtype} array of shape {img.shape} '
                    'as PNG')


# ---------------------------------------------------------------------------
# TIFF (baseline, uncompressed)
# ---------------------------------------------------------------------------

#: bytes per value of the TIFF field types
_TIFF_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                   10: 8, 11: 4, 12: 8, 16: 8}
_TIFF_TYPE_FMT = {1: 'B', 3: 'H', 4: 'I', 6: 'b', 8: 'h', 9: 'i', 11: 'f',
                  12: 'd', 16: 'Q'}
#: (bits per sample, sample format) -> dtype, for the variants decoded here
_TIFF_DTYPES = {(8, 1): 'u1', (16, 1): 'u2', (32, 2): 'i4', (32, 3): 'f4'}


def _tiff_ifds(data):
    order = {b'II': '<', b'MM': '>'}.get(data[:2])
    if order is None:
        raise ValueError('not a TIFF file')
    magic, offset = struct.unpack(order + 'HI', data[2:8])
    if magic != 42:
        raise _NeedsPillow(f'TIFF variant {magic}')
    while offset:
        (count,) = struct.unpack(order + 'H', data[offset:offset + 2])
        tags = {}
        for i in range(count):
            entry = data[offset + 2 + 12 * i:offset + 14 + 12 * i]
            tag, typ, n = struct.unpack(order + 'HHI', entry[:8])
            if typ not in _TIFF_TYPE_FMT:
                continue  # ASCII, rationals, undefined: not needed here
            size = _TIFF_TYPE_SIZE[typ] * n
            if size <= 4:
                raw = entry[8:8 + size]
            else:
                (ptr,) = struct.unpack(order + 'I', entry[8:12])
                raw = data[ptr:ptr + size]
            tags[tag] = struct.unpack(order + _TIFF_TYPE_FMT[typ] * n, raw)
        (offset,) = struct.unpack(order + 'I', data[offset + 2 + 12 * count:
                                                     offset + 6 + 12 * count])
        yield order, tags


def _tiff_page(data, order, tags):
    width, height = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))
    fmt = tags.get(339, (1,))
    photometric = tags.get(262, (None,))[0]
    variant = (f'TIFF page (compression {tags.get(259, (1,))[0]}, photometric '
               f'{photometric}, {spp} x {bps[0]}-bit samples)')
    if (tags.get(259, (1,))[0] != 1 or 322 in tags or len(set(bps)) != 1
            or len(set(fmt)) != 1 or (spp > 1 and tags.get(284, (1,))[0] != 1)):
        raise _NeedsPillow(variant)
    dtype = _TIFF_DTYPES.get((bps[0], fmt[0]))
    gray = photometric == 1 and spp == 1 and dtype is not None
    color = (photometric == 2 and dtype == 'u1'
             and (spp == 3 or (spp == 4 and tags.get(338, (0,))[0] == 2)))
    if not (gray or color):
        raise _NeedsPillow(variant)
    nbytes = width * height * spp * bps[0] // 8
    buf = b''.join(data[o:o + c] for o, c in zip(tags[273], tags[279]))
    page = np.frombuffer(buf[:nbytes], np.dtype(dtype).newbyteorder(order))
    page = page.astype(np.dtype(dtype)).reshape(height, width, spp)
    return page[..., 0] if spp == 1 else page


def _tiff_decode(data):
    return [_tiff_page(data, order, tags) for order, tags in _tiff_ifds(data)]


def _tiff_pages(img):
    """The pages of ``img`` to write: a 2D array or an (H, W, 3|4) uint8
    color image is one page; any other 3D array is a stack, pages first."""
    if img.ndim == 2 or (img.ndim == 3 and img.dtype == np.uint8
                         and img.shape[2] in (3, 4)):
        pages = [img]
    elif img.ndim in (3, 4):
        pages = list(img)
    else:
        raise TypeError(f'cannot write an array of shape {img.shape} as TIFF')
    for page in pages:
        ok = (page.ndim == 2 and page.dtype in (np.uint8, np.uint16, np.int32,
                                                np.float32)) \
            or (page.ndim == 3 and page.dtype == np.uint8 and page.shape[2] in (3, 4))
        if not ok:
            raise TypeError(f'cannot write a {page.dtype} page of shape '
                            f'{page.shape} as TIFF')
    return pages


def _tiff_encode(pages):
    """Little-endian baseline TIFF: per page the pixels in one strip, then
    its IFD and the IFD's out-of-line values."""
    out = bytearray(b'II*\x00\x00\x00\x00\x00')
    link = 4  # where the offset of the next IFD goes
    for page in pages:
        page = np.ascontiguousarray(page)
        height, width = page.shape[:2]
        spp = 1 if page.ndim == 2 else page.shape[2]
        bps = page.dtype.itemsize * 8
        fmt = {'u': 1, 'i': 2, 'f': 3}[page.dtype.kind]
        pixels = page.astype(page.dtype.newbyteorder('<')).tobytes()
        strip = len(out)
        out += pixels
        if len(out) % 2:
            out += b'\x00'
        entries = [(256, 4, [width]), (257, 4, [height]), (258, 3, [bps] * spp),
                   (259, 3, [1]), (262, 3, [2 if spp > 1 else 1]),
                   (273, 4, [strip]), (277, 3, [spp]), (278, 4, [height]),
                   (279, 4, [len(pixels)]), (284, 3, [1])]
        if spp == 4:
            entries.append((338, 3, [2]))  # unassociated alpha
        entries.append((339, 3, [fmt] * spp))
        ifd = len(out)
        struct.pack_into('<I', out, link, ifd)
        extra = ifd + 2 + 12 * len(entries) + 4
        body, tail = bytearray(struct.pack('<H', len(entries))), bytearray()
        for tag, typ, values in entries:
            raw = struct.pack('<' + _TIFF_TYPE_FMT[typ] * len(values), *values)
            if len(raw) <= 4:
                field = raw.ljust(4, b'\x00')
            else:
                field = struct.pack('<I', extra + len(tail))
                tail += raw + (b'\x00' if len(raw) % 2 else b'')
            body += struct.pack('<HHI', tag, typ, len(values)) + field
        link = ifd + len(body)
        out += body + b'\x00\x00\x00\x00' + tail
    return bytes(out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _pillow_frames(filepath, feature):
    Image = _pillow(feature)
    with Image.open(filepath) as im:
        frames = []
        for idx in range(getattr(im, 'n_frames', 1)):
            im.seek(idx)
            frames.append(np.asarray(im))
    return frames


def imread(filepath, as_gray=True):
    """Loads an image from ``filepath`` (PNG/TIF/TIFF; JPEG through Pillow).

    Multi-page TIFFs are returned as a 3D array (pages first). Color images
    are converted to grayscale when ``as_gray`` (luminance weighting as in
    skimage's ``rgb2gray``).
    """
    filepath = str(filepath)
    suffix = _suffix(filepath)
    if suffix in ('jpg', 'jpeg'):
        frames = _pillow_frames(filepath, 'reading JPEG')
    else:
        with open(filepath, 'rb') as fin:
            data = fin.read()
        try:
            frames = [_png_decode(data)] if suffix == 'png' else _tiff_decode(data)
        except _NeedsPillow as variant:
            frames = _pillow_frames(filepath, f'reading this {variant}')
    if as_gray:
        frames = [f[..., :3].astype(np.float64) @ _GRAY_WEIGHTS if f.ndim == 3
                  else f for f in frames]
    return frames[0] if len(frames) == 1 else np.stack(frames)


def imsave(filepath, img, shape=None, antialias=True, normalize=True):
    """Saves image ``img`` to ``filepath``.

    Float images are normalized to the full ``uint8`` range when
    ``normalize`` is set; integer and boolean images are written as-is
    (other integer types as int32). ``shape`` optionally resizes the output
    (through Pillow). A 3D array that is not an RGB(A) image is written as a
    multi-page TIFF, pages first.
    """
    img = np.asarray(img)
    if img.dtype == bool:
        img = img.astype(np.uint8) * 255
    elif np.issubdtype(img.dtype, np.floating):
        if normalize:
            lo, hi = float(img.min()), float(img.max())
            span = (hi - lo) if hi > lo else 1.0
            img = (255 * (img - lo) / span).round()
        img = img.clip(0, 255).astype(np.uint8)
    elif img.dtype not in (np.uint8, np.uint16, np.int32):
        img = img.astype(np.int32)
    filepath = str(filepath)
    suffix = _suffix(filepath)
    if shape is not None or suffix in ('jpg', 'jpeg'):
        Image = _pillow('resizing (shape=)' if shape is not None
                        else 'writing JPEG')
        pil = Image.fromarray(img)
        if shape is not None:
            resample = Image.LANCZOS if antialias else Image.NEAREST
            pil = pil.resize((int(shape[1]), int(shape[0])), resample=resample)
        pil.save(filepath)
        return
    data = (_png_encode(_png_array(img)) if suffix == 'png'
            else _tiff_encode(_tiff_pages(img)))
    with open(filepath, 'wb') as fout:
        fout.write(data)
