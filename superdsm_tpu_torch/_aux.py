"""Small shared helpers.

Counterpart of the reference's ``superdsm/_aux.py``. The reference's Ray
helpers and POSIX-semaphore memory throttling
(``superdsm/_aux.py:44-114``) have no equivalent here: the
batched design packs all per-region work into padded, fixed-shape device
batches, so there is no per-process fan-out to stream or to throttle.
"""

import os
import numpy as np


def copy_dict(d):
    """Returns a shallow copy of a dictionary."""
    return dict(d)


def join_path(*args):
    return os.path.join(*args)


def mkdir(path):
    os.makedirs(path, exist_ok=True)


def is_subpath(path, subpath):
    """Checks whether ``subpath`` lies within ``path``."""
    if isinstance(path, str) or not isinstance(path, (list, tuple)):
        path = [str(path)]
    path = os.path.join(*[str(p) for p in path])
    path = os.path.abspath(path)
    subpath = os.path.abspath(str(subpath))
    return os.path.commonpath([path]) == os.path.commonpath([path, subpath])


def render_objects_foregrounds(shape, objects):
    """Yields the foreground mask of each object, reusing one buffer."""
    buffer = np.zeros(shape, bool)
    for obj in objects:
        sel = obj.fill_foreground(buffer)
        yield buffer
        buffer[sel].fill(False)
