"""Visualization and label rasterization.

Port of :mod:`superdsm_tpu.render` (counterpart of the reference's
``superdsm/render.py:13-509``): host numpy code, carried over as is, apart
from the colormaps. The JAX package looks them up in matplotlib; the port
carries the three its renderers and CLIs name by default (``bwr`` for
:func:`render_ymap`, ``gist_rainbow`` for :func:`colorize_labels`,
``seismic`` for the export CLI's ``--ymap``) as lookup tables of its own,
built and applied exactly as matplotlib's ``LinearSegmentedColormap`` does
(:func:`get_cmap`). Any other colormap name imports matplotlib when it is
used.
"""

import numpy as np
import scipy.ndimage as ndi

from ._aux import render_objects_foregrounds
from .ops.morphology import disk as _disk_footprint
from .ops.morphology import binary_dilation, binary_erosion
from .ops.watershed import watershed

#: Color lists of the carried colormaps (matplotlib's ``_cm`` data; a list
#: of colors spreads evenly over [0, 1], (value, color) pairs place them).
_CMAP_DATA = {
    'bwr': ((0.0, 0.0, 1.0), (1.0, 1.0, 1.0), (1.0, 0.0, 0.0)),
    'seismic': ((0.0, 0.0, 0.3), (0.0, 0.0, 1.0), (1.0, 1.0, 1.0),
                (1.0, 0.0, 0.0), (0.5, 0.0, 0.0)),
    'gist_rainbow': ((0.000, (1.00, 0.00, 0.16)), (0.030, (1.00, 0.00, 0.00)),
                     (0.215, (1.00, 1.00, 0.00)), (0.400, (0.00, 1.00, 0.00)),
                     (0.586, (0.00, 1.00, 1.00)), (0.770, (0.00, 0.00, 1.00)),
                     (0.954, (1.00, 0.00, 1.00)), (1.000, (1.00, 0.00, 0.75))),
}
_CMAP_N = 256


def _lookup_table(N, x, y):
    """matplotlib's ``_create_lookup_table`` for a continuous segment list
    (``y0 == y1``, gamma 1)."""
    x = x * (N - 1)
    xind = (N - 1) * np.linspace(0, 1, N) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1],
                          [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


class LookupColormap:
    """A colormap as a table of ``N`` RGBA colors plus the under, over and
    bad colors (matplotlib's ``_lut`` layout), called as matplotlib's
    ``Colormap.__call__`` is on arrays: floats in [0, 1] scale by ``N`` and
    truncate, 1.0 takes the last color, values below 0 and at or above 1
    clip to the first and last colors, NaN is transparent black; integers
    index the table."""

    def __init__(self, name, colors, N=_CMAP_N):
        if len(colors[0]) == 2:
            vals, colors = zip(*colors)
        else:
            vals = np.linspace(0, 1, len(colors))
        vals = np.asarray(vals, float)
        rgb = np.asarray(colors, float)
        self.name, self.N = name, N
        self._lut = np.ones((N + 3, 4), float)
        for i in range(3):
            self._lut[:-3, i] = _lookup_table(N, vals, rgb[:, i])
        self._lut[N] = self._lut[0]           # under
        self._lut[N + 1] = self._lut[N - 1]   # over
        self._lut[N + 2] = 0.0                # bad

    def __call__(self, X):
        xa = np.array(X, copy=True)
        if not xa.dtype.isnative:
            xa = xa.byteswap().view(xa.dtype.newbyteorder())
        if xa.dtype.kind == 'f':
            xa *= self.N
            xa[xa == self.N] = self.N - 1
        mask_under = xa < 0
        mask_over = xa >= self.N
        mask_bad = np.isnan(xa)
        with np.errstate(invalid='ignore'):
            xa = xa.astype(int)
        xa[mask_under] = self.N
        xa[mask_over] = self.N + 1
        xa[mask_bad] = self.N + 2
        return self._lut.take(xa, axis=0, mode='clip')


_CMAPS = {}


def get_cmap(cmap):
    """The colormap named ``cmap`` (a callable passes through): the carried
    tables for ``bwr``, ``seismic`` and ``gist_rainbow``; any other name
    from matplotlib."""
    if not isinstance(cmap, str):
        return cmap
    if cmap in _CMAP_DATA:
        if cmap not in _CMAPS:
            _CMAPS[cmap] = LookupColormap(cmap, _CMAP_DATA[cmap])
        return _CMAPS[cmap]
    try:
        import matplotlib
    except ImportError:
        raise ImportError(f'colormap {cmap!r} needs matplotlib, which is not '
                          f'installed (carried: {", ".join(sorted(_CMAP_DATA))})'
                          ) from None
    return matplotlib.colormaps[cmap]


def draw_line(p1, p2, thickness, shape):
    """Binary (float) mask of a straight line between two endpoints.

    Computed as the set of pixels within ``(thickness + 1) / 2`` of the
    segment (cf. ``superdsm/render.py:13-44``, which obtains
    the same set via an EDT of the rasterized line).
    """
    assert thickness >= 1
    threshold = (thickness + 1) / 2
    p1 = np.asarray(p1, float)
    p2 = np.asarray(p2, float)
    lo = np.floor(np.minimum(p1, p2) - threshold).astype(int).clip(0)
    hi = np.ceil(np.maximum(p1, p2) + threshold).astype(int) + 1
    hi = np.minimum(hi, shape)
    if (hi <= lo).any():
        return np.zeros(shape)
    rr, cc = np.mgrid[lo[0]:hi[0], lo[1]:hi[1]]
    d = p2 - p1
    len2 = float(d @ d)
    if len2 == 0:
        dist = np.hypot(rr - p1[0], cc - p1[1])
    else:
        t = (((rr - p1[0]) * d[0] + (cc - p1[1]) * d[1]) / len2).clip(0, 1)
        dist = np.hypot(rr - (p1[0] + t * d[0]), cc - (p1[1] + t * d[1]))
    result = np.zeros(shape)
    result[lo[0]:hi[0], lo[1]:hi[1]] = (dist < threshold).astype(float)
    return result


def _disk_mask(center, radius, shape):
    """Boolean mask of a filled disk (clipped to ``shape``)."""
    rr, cc = np.indices(shape)
    return (rr - center[0]) ** 2 + (cc - center[1]) ** 2 <= radius ** 2


def render_adjacencies(data, normalize_img=True, edge_thickness=3, endpoint_radius=5,
                       endpoint_edge_thickness=2, edge_color=(1, 0, 0),
                       endpoint_color=(1, 0, 0), endpoint_edge_color=(0, 0, 0),
                       override_img=None):
    """Renders the atom adjacency graph over the image
    (cf. ``superdsm/render.py:47-99``)."""
    if override_img is not None:
        assert override_img.ndim == 3 and override_img.shape[2] >= 3
        img = override_img[:, :, :3].copy()
        if (img > 1).any():
            img = img / 255
    else:
        img = np.dstack([_fetch_image_from_data(data, normalize_img)] * 3)
        img = img / img.max()
    lines = data['adjacencies'].get_edge_lines()
    shape = img.shape[:2]
    for endpoint in data['seeds']:
        perim_mask = _disk_mask(endpoint, endpoint_radius + endpoint_edge_thickness, shape)
        for i in range(3):
            img[:, :, i][perim_mask] = endpoint_edge_color[i]
    for line in lines:
        line_buf = draw_line(line[0], line[1], edge_thickness, shape=shape)
        line_mask = (line_buf > 0)
        line_vals = line_buf[line_mask]
        for i in range(3):
            img[:, :, i][line_mask] = line_vals * edge_color[i]
    for endpoint in data['seeds']:
        circle_mask = _disk_mask(endpoint, endpoint_radius, shape)
        for i in range(3):
            img[:, :, i][circle_mask] = endpoint_color[i]
    return (255 * img).clip(0, 255).astype('uint8')


def render_ymap(data, clim=None, cmap='bwr'):
    """Colormapped offset intensities (cf. ``superdsm/render.py:102-134``)."""
    y = data['y'] if isinstance(data, dict) else data
    if clim is None:
        clim = (-y.std(), +y.std())
    z = np.full((1, y.shape[1]), clim[0])
    z[0, -1] = clim[1]
    y = np.concatenate((z, y), axis=0)
    cmap = get_cmap(cmap)
    y = y.clip(*clim)
    y = y - y.min()
    y = y / y.max()
    ymap = cmap(y)[1:]
    if ymap.ndim == 3 and ymap.shape[2] == 4:
        ymap = ymap[:, :, :3]
    return ymap


def normalize_image(img, spread=1, ret_minmax=False):
    """Contrast enhancement by mean +/- ``spread`` std clipping
    (cf. ``superdsm/render.py:137-165``)."""
    if not np.allclose(img.std(), 0):
        minval = max([img.min(), img.mean() - spread * img.std()])
        maxval = min([img.max(), img.mean() + spread * img.std()])
        img = img.clip(minval, maxval)
    else:
        minval, maxval = 0, 1
    img = img - img.min()
    img = img / img.max()
    return (img, minval, maxval) if ret_minmax else img


def _fetch_image_from_data(data, normalize_img=True):
    img = data['g_raw']
    if normalize_img:
        img = normalize_image(img)
    return img


def _fetch_rgb_image_from_data(data, normalize_img=True, override_img=None):
    if override_img is not None:
        img = override_img if override_img.ndim == 3 else np.dstack([override_img] * 3)
    elif 'g_rgb' in data:
        img = data['g_rgb']
        if img.max() > 1:
            img = img / 255
    else:
        img = data['g_raw']
        if normalize_img:
            img = normalize_image(img)
        img = np.dstack([img] * 3)
    img = img.copy()
    img[img < 0] = 0
    img[img > 1] = 1
    return img


def render_atoms(data, normalize_img=True, discarded_color=(0.3, 1, 0.3, 0.1),
                 border_radius=2, border_color=(0, 1, 0), override_img=None):
    """Renders the borders of the atomic image regions."""
    img = _fetch_image_from_data(data, normalize_img) if override_img is None else override_img
    return render_regions_over_image(img / img.max(), data['atoms'], background_label=0,
                                     bg=discarded_color, radius=border_radius,
                                     color=border_color)


def render_foreground_clusters(data, normalize_img=True, discarded_color=(0.3, 1, 0.3, 0.1),
                               border_radius=2, border_color=(0, 1, 0), override_img=None):
    """Renders the borders of the clusters of possibly clustered objects."""
    img = _fetch_image_from_data(data, normalize_img) if override_img is None else override_img
    return render_regions_over_image(img / img.max(), data['clusters'], background_label=0,
                                     bg=discarded_color, radius=border_radius,
                                     color=border_color)


def rasterize_regions(regions, background_label=None, radius=3):
    """Region borders + optional background interior, in one vectorized pass.

    A pixel belongs to a border iff its disk(``radius``) neighborhood contains
    a different label — equivalent to the reference's per-label
    ``mask & ~erosion(mask)`` union (``superdsm/render.py:246-260``).
    """
    fp = _disk_footprint(radius).astype(bool)
    lo = ndi.minimum_filter(regions, footprint=fp, mode='nearest')
    hi = ndi.maximum_filter(regions, footprint=fp, mode='nearest')
    borders = (lo != hi)
    if background_label is not None:
        background = np.logical_and(regions == background_label, ~borders)
    else:
        background = np.zeros(regions.shape, bool)
    return borders, background


def render_regions_over_image(img, regions, background_label=None, color=(0, 1, 0),
                              bg=(0.6, 1, 0.6, 0.3), **kwargs):
    """Renders region borders (and shaded background) over an image."""
    assert img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3)), \
        f'image has wrong dimensions: {img.shape}'
    if img.ndim == 2 or img.shape[2] == 1:
        result = np.dstack([img.reshape(img.shape[:2])] * 3).astype(float)
    else:
        result = img.copy().astype(float)
    borders, background = rasterize_regions(regions, background_label, **kwargs)
    for i in range(3):
        result[:, :, i][borders] = color[i]
    for i in range(3):
        result[background, i] = bg[i] * bg[3] + result[background, i] * (1 - bg[3])
    return (255 * result).clip(0, 255).astype('uint8')


COLORMAP = {'r': [0], 'g': [1], 'b': [2], 'y': [0, 1], 't': [1, 2], 'w': [0, 1, 2]}


class ContourPaint:
    """Yields contour masks of objects (inner / center / outer placement;
    cf. ``superdsm/render.py:291-323``)."""

    def __init__(self, fg_mask, radius, where='center'):
        self.fg_mask = fg_mask
        self.where = where
        self.radius = radius
        self.selem = _disk_footprint(self.radius if where == 'center' else self.radius * 2)
        if where == 'outer':
            self.center_paint = ContourPaint(fg_mask, radius, where='center')

    def get_contour_mask(self, mask):
        """Returns the binary contour mask of an object mask."""
        if self.where == 'center':
            contour = np.logical_xor(binary_erosion(mask, self.selem),
                                     binary_dilation(mask, self.selem))
        elif self.where == 'outer':
            contour = np.logical_xor(mask, binary_dilation(mask, self.selem))
            mask2 = np.logical_and(self.fg_mask, contour)
            contour = np.logical_and(contour, ~mask2)
            mask3 = binary_dilation(mask2, self.center_paint.selem)
            contour = np.logical_or(contour,
                                    np.logical_and(mask3, self.center_paint.get_contour_mask(mask)))
        elif self.where == 'inner':
            contour = np.logical_xor(mask, binary_erosion(mask, self.selem))
        return contour


def render_result_over_image(data, objects='postprocessed_objects',
                             merge_overlap_threshold=np.inf, normalize_img=True,
                             border_width=6, border_position='center',
                             override_img=None, color='g'):
    """Renders the contours of the segmentation result over the image."""
    assert border_width % 2 == 0
    assert color in COLORMAP.keys()

    im_seg = _fetch_rgb_image_from_data(data, normalize_img, override_img)
    im_seg = im_seg / im_seg.max()
    seg_objects = rasterize_labels(data, objects, merge_overlap_threshold=merge_overlap_threshold)
    cp = ContourPaint(seg_objects > 0, radius=border_width // 2, where=border_position)
    for label in set(seg_objects.flatten()) - {0}:
        seg_bnd = cp.get_contour_mask(seg_objects == label)
        colorchannels = COLORMAP[color]
        for i in range(3):
            im_seg[seg_bnd, i] = (1 if i in colorchannels else 0)
    return (255 * im_seg).round().clip(0, 255).astype('uint8')


def rasterize_objects(data, objects, dilate=0):
    """Yields the full-frame segmentation mask of each object."""
    if isinstance(objects, str):
        objects = [c for c in data[objects]]

    for foreground in render_objects_foregrounds(data['g_raw'].shape, objects):
        if dilate > 0:
            foreground = binary_dilation(foreground, _disk_footprint(dilate))
        elif dilate < 0:
            foreground = binary_erosion(foreground, _disk_footprint(-dilate))
        if foreground.any():
            yield foreground.copy()


def rasterize_labels(data, objects='postprocessed_objects',
                     merge_overlap_threshold=np.inf, dilate=0, background_label=0):
    """Unique-label map of the segmentation masks: merge above-threshold
    overlaps, resolve remaining overlaps by EDT watershed, then fix exactly
    coincident objects (cf. ``superdsm/render.py:388-451``)."""
    assert background_label <= 0
    objects = [obj for obj in rasterize_objects(data, objects, dilate)]

    # determine which objects overlap sufficiently
    merge_list = []
    if merge_overlap_threshold <= 1:
        for i1 in range(len(objects)):
            for i2 in range(i1):
                obj1, obj2 = objects[i1], objects[i2]
                overlap = np.logical_and(obj1, obj2).sum() / (0. + min([obj1.sum(), obj2.sum()]))
                if overlap > merge_overlap_threshold:
                    merge_list.append((i1, i2))

    # associate a (potentially shared) label to each object
    labels = list(range(1, 1 + len(objects)))
    obj_indices_by_label = {label: [idx] for label, idx in zip(labels, range(len(objects)))}
    for merge_idx, merge_data in enumerate(merge_list):
        merge_label0 = len(objects) + 1 + merge_idx
        merge_labels = [labels[idx] for idx in merge_data]
        if merge_labels[0] == merge_labels[1]:
            continue  # can occur due to transitivity
        merge_indices = obj_indices_by_label[merge_labels[0]] + obj_indices_by_label[merge_labels[1]]
        for obj_idx in merge_indices:
            labels[obj_idx] = merge_label0
        obj_indices_by_label[merge_label0] = merge_indices
        for label in merge_labels:
            del obj_indices_by_label[label]

    # merge the rasterized objects and resolve residual overlaps
    objects = [(np.sum([objects[k] for k in group], axis=0) > 0)
               for group in obj_indices_by_label.values()]
    result = np.zeros(data['g_raw'].shape, 'uint16')
    if len(objects) > 0:
        # accumulate counts in place (np.sum over a list stacks n full frames)
        counts = np.zeros(result.shape, np.uint16)
        for obj in objects:
            counts += obj
        overlaps = counts > 1
        for label, obj in enumerate(objects, 1):
            result[obj] = label
        background = (result == 0).copy()
        result[overlaps] = 0
        from .ops.edt import edt as _edt
        dist = _edt(result == 0)
        result = watershed(dist, result.astype(np.int32),
                           mask=np.logical_not(background)).astype('uint16')

    # exactly coincident objects eliminate each other above; restore them
    covered = result > 0
    next_label = int(result.max()) if len(objects) > 0 else 0
    for obj in objects:
        obj_mask = obj & ~covered
        if obj_mask.any():
            next_label += 1
            result[obj_mask] = next_label
            covered |= obj_mask

    result[result == 0] = background_label
    return result


def shuffle_labels(labels, bg_label=None, seed=None):
    """Randomly shuffles the label values of an integer-valued image."""
    label_values0 = frozenset(labels.flatten())
    if bg_label is not None:
        label_values0 -= {bg_label}
    label_values0 = list(label_values0)
    if seed is not None:
        np.random.seed(seed)
    label_values1 = np.asarray(label_values0).copy()
    np.random.shuffle(label_values1)
    label_map = dict(zip(label_values0, label_values1))
    result = np.zeros_like(labels)
    for label in label_map.keys():
        cc = (labels == label)
        result[cc] = label_map[label]
    return result


def colorize_labels(labels, bg_label=0, cmap='gist_rainbow', bg_color=(0, 0, 0), shuffle=None):
    """Colorizes an integer-valued label image."""
    if shuffle is not None:
        labels = shuffle_labels(labels, bg_label=bg_label, seed=shuffle)
    cmap = get_cmap(cmap)
    denom = float(labels.max() - labels.min())
    img = cmap((labels - labels.min()) / (denom if denom > 0 else 1))
    if img.shape[2] > 3:
        img = img[:, :, :3]
    if bg_label is not None:
        bg = (labels == bg_label)
        img[bg] = np.asarray(bg_color)[None, None, :]
    return img
