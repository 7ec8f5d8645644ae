"""Images, masks, and image regions.

Counterpart of the reference's ``superdsm/image.py``
(``superdsm/image.py:6-103``). An :class:`Image` couples an
intensity array (``model``) with a boolean region mask and the offset of the
crop within the full image, and provides pixel-coordinate maps used by the
DSM energies.
"""

import numpy as np


def get_pixel_map(shape, normalized=False):
    """Returns row/column pixel-coordinate maps stacked into a (2, H, W) array.

    Coordinates are divided by ``shape - 1`` when ``normalized``
    (cf. ``superdsm/image.py:6-21``).
    """
    z = (np.array(shape) - 1. if normalized else np.ones(2))[..., None, None]
    z[z == 0] = 1
    return np.indices(shape) / z


def bbox(mask, include_end=False):
    """Returns the bounding box of a boolean mask.

    :return: ``(box, sel)`` where ``box[0]`` is the row range, ``box[1]`` the
        column range, and ``sel`` a numpy slice for that region. The end
        indices are exclusive unless ``include_end``.
    """
    mask_a0 = mask.any(axis=0)
    mask_a1 = mask.any(axis=1)
    ret = np.array([np.where(mask_a1)[0][[0, -1]], np.where(mask_a0)[0][[0, -1]]])
    if not include_end:
        ret += np.array([0, 1])
    return ret, np.s_[ret[0][0]: ret[0][1], ret[1][0]: ret[1][1]]


def normalize_image(img):
    """Normalizes intensities to [0, 1] without modifying the input."""
    img_diff = img.max() - img.min()
    if img_diff == 0:
        img_diff = 1
    return (img - img.min()).astype(float) / img_diff


class Image:
    """An intensity array with an associated region mask.

    :ivar model: The intensity array (possibly a crop of the full image).
    :ivar mask: Boolean mask selecting the region within ``model``.
    :ivar full_mask: The mask in the full-image frame (defaults to ``mask``).
    :ivar offset: Offset of ``model`` within the full image.
    """

    def __init__(self, model=None, mask=None, full_mask=None, offset=(0, 0)):
        self.model = model
        self.mask = mask if mask is not None else np.ones(model.shape, bool)
        self.full_mask = full_mask if full_mask is not None else self.mask
        self.offset = offset

    def shrink_mask(self, mask):
        """Crops a full-frame mask to this image's extent."""
        return mask[self.offset[0]: self.offset[0] + self.mask.shape[0],
                    self.offset[1]: self.offset[1] + self.mask.shape[1]]

    def get_region(self, mask, shrink=False):
        """Returns the sub-region selected by ``mask`` (ANDed with own mask).

        With ``shrink``, the result is cropped to the bounding box of the
        combined mask and carries the appropriate ``offset``/``full_mask``.
        """
        mask = np.logical_and(self.mask, mask)
        if shrink:
            _bbox = bbox(mask)
            return Image(self.model[_bbox[1]], mask[_bbox[1]], full_mask=mask, offset=tuple(_bbox[0][:, 0]))
        return Image(self.model, mask)

    @staticmethod
    def create_from_array(img, mask=None, normalize=True):
        """Creates an :class:`Image` from an array and an optional mask."""
        assert mask is None or (isinstance(mask, np.ndarray) and mask.dtype == bool)
        if normalize:
            img = normalize_image(img)
        return Image(model=img, mask=mask)

    def get_map(self, normalized=True, pad=0):
        """Returns the pixel-coordinate map of this image (optionally padded)."""
        assert pad >= 0 and isinstance(pad, int)
        return get_pixel_map(np.add(self.model.shape, 2 * pad), normalized)
