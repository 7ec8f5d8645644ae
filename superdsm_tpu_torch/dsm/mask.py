"""The decode of the solver's bit-packed crop masks on the card.

A problem whose crop fits goes to the card as its bit-packed crop mask
(``solver._solve_{poly,dsm}_packed_mask``). :func:`mask_to_pix_kernel` turns
the masks back into crop-local pixel coordinates in one launch of
``csrc/mask_ops.cu`` (built and loaded as the gram kernels are,
:mod:`superdsm_tpu_torch.dsm.gram`), bitwise ``solver._mask_to_pix``, its
plain version, which the CPU path takes (``solver._decode_mask``
dispatches). The kernel launches on the current stream and reads nothing
back to the host, so the decode makes no host sync.

Every launch adds one to :data:`LAUNCHES` (through
:func:`gram._count_launch`).
"""

import torch

from . import gram

#: Kernel launches of the decode.
LAUNCHES = {'mask_to_pix': 0}


def reset_launch_counts():
    gram.reset_launch_counts(LAUNCHES)


def mask_to_pix_kernel(mb, wd, cnt, pb):
    """``solver._mask_to_pix(mb, wd, cnt, pb)`` on the card: (B, nbytes)
    uint8 MSB-first crop masks, crop widths ``wd`` (B,) int32 (at least 1)
    and pixel counts ``cnt`` (B,) int32 -> (B, pb, 2) int32 crop-local (r,
    c) in ``np.argwhere`` order, one launch of a cluster of blocks a row
    (``csrc/mask_ops.cu``). Raises on a tensor that is not on the card, on
    other dtypes or shapes, and when the launch fails: there is no other
    route."""
    if not all(isinstance(t, torch.Tensor) for t in (mb, wd, cnt)):
        raise ValueError('mask_to_pix_kernel takes tensors')
    if mb.dim() != 2 or mb.dtype != torch.uint8:
        raise ValueError(f'mask_to_pix_kernel takes mb (B, nbytes) uint8, got '
                         f'{tuple(mb.shape)} {mb.dtype}')
    B, nbytes = mb.shape
    pb = int(pb)
    if pb < 0 or nbytes * 8 >= 2 ** 31 or B >= 2 ** 28:
        raise ValueError(f'mask_to_pix_kernel: sizes B={B}, nbytes={nbytes}, pb={pb} out of '
                         'range')
    for name, t in (('wd', wd), ('cnt', cnt)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f'mask_to_pix_kernel takes {name} ({B},) int32, got '
                             f'{tuple(t.shape)} {t.dtype}')
    dev = mb.device
    for name, t in (('mb', mb), ('wd', wd), ('cnt', cnt)):
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError(f'mask_to_pix_kernel needs CUDA tensors on one device, got '
                             f'{name} on {t.device}')
    mb, wd, cnt = mb.contiguous(), wd.contiguous(), cnt.contiguous()
    out = torch.empty((B, pb, 2), dtype=torch.int32, device=dev)
    lib = gram._load(gram.MASK_SRC)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdsm_mask_to_pix(mb.data_ptr(), wd.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                                   B, nbytes, pb, stream)
        if err != 0:
            raise RuntimeError(f'mask_to_pix launch failed: CUDA error {err}')
        gram._count_launch('mask_to_pix', table=LAUNCHES)
    return out
