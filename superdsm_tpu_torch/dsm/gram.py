"""The Newton gram: fused logistic gradient and Gauss-Newton Hessian.

The per-iteration hot op of the batched solver is, for each lane, given the
feature matrix ``Bf (P, n)``, the carried surface ``s`` and data ``yv, w``::

    term1 = -yv * sigmoid(-yv s) * w            (P,)
    kappa =  w  * yv^2 * sig * (1 - sig)        (P,)
    g     = Bf^T term1                          (n,)
    H     = Bf^T diag(kappa) Bf                 (n, n)

Two implementations of the same function live here:

- :func:`grad_hess_kernel`, the hand-written CUDA kernels, compiled with
  ``nvcc`` for ``sm_90a`` into the build directory on first use and bound
  with ``ctypes``: ``csrc/gram_grad_hess.cu`` (float32 products) and
  ``csrc/gram_grad_hess_bf16.cu`` (bf16 tensor-core products, 1 or 3
  passes);
- :func:`grad_hess_plain`, the plain PyTorch version (batched matmuls with
  float64 sums), which the solver also uses for the sizes the kernels do
  not serve (n = 6, 32, 64).

:func:`fused_grad_hess_batched` dispatches: a CPU tensor takes the plain
version; a CUDA tensor launches a kernel or raises — there is no fallback.
It keeps the JAX package's selection rule (``pallas_kernels.py``): the
kernels serve n % 128 == 0, in banded mode for n in {512, 1024} when a band
table is given, in triangle mode for 256 <= n <= 1024 otherwise and in
dense mode at n = 128 and 2048; ``cheap`` (the early iterations of the
hybrid schedule) takes the 1-pass dense gram at every n.

Precision knobs, read from the environment at import as in the JAX package
and at every call from these module attributes (tests set them):

- :data:`GRAM_PASSES` (``SDSM_GRAM_PASSES``): 6 = float32 products (the
  default), 3 = the bf16 hi/lo split with the lo*lo term dropped,
  1 = one bf16 pass;
- :data:`HYBRID_ITERS` (``SDSM_GRAM_HYBRID_ITERS``): the solver's first
  this many Newton iterations take ``cheap=True``.

Both kernels split the pixel loop across blocks when a launch has too
few (lane, tile pair) work items to fill the card (split-P,
:func:`split_plan`). Each pixel segment sums its float64 partial into
scratch that :func:`grad_hess_kernel` allocates, and a second kernel sums
the segments in a fixed order and writes ``H`` and ``g``. The float32
kernel takes that path at one segment too; the bf16 kernel writes ``H`` and
``g`` itself when it runs one segment (in its full mode the partials would
take twice the bytes of ``H``). Both kernels' plans depend on ``(P, n)``
only, so a lane's sums are the same in every batch; their lanes launch in
groups when the scratch would pass its cap. Neither plan depends on how
many lanes are active.

Every launch adds one to :data:`LAUNCHES` under the route it stands for
(:func:`count_replayed` adds a captured CUDA graph's launches at each
replay):
``'dense'`` (the full dense Pallas kernel, n = 128 and n = 2048),
``'triangle'`` (the triangle-blocked one, 256 <= n <= 1024 without a band)
and ``'banded'``, each with a ``-3pass`` or ``-1pass`` suffix for the
reduced-precision bodies.
"""

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from ..native import BUILD_DIR

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     'csrc')

#: Column tile and pixel-row chunk of both kernels (checked against the
#: compiled libraries on load).
TILE = 64
ROWS = 32
#: Chunks a float32 partial of either kernel covers before it goes into
#: its float64 running sum (64 pixel rows; checked on load).
FLUSH_CHUNKS = 2

#: Split-P rule of both kernels (:func:`split_plan`): a launch with fewer
#: than this many (lane, tile pair) work items splits its pixels into
#: segments until it has about this many, some 5 waves of the kernels' 3
#: resident 128-thread blocks on each of an H100's 132 SMs (with fewer
#: waves, the last one leaves most SMs idle) ...
TARGET_ITEMS = 2048
#: ... with segments of at least this many chunks (128 pixel rows), so that
#: a segment keeps the copy ring busy and the reduction stays small.
MIN_SEG_CHUNKS = 4
#: Most pixel segments of a launch. Its plan is that of one lane
#: (:func:`split_plan`), so a launch of many lanes splits as finely as one
#: of a single lane; this bounds the scratch traffic that costs it.
MAX_SEGMENTS = 16
#: Bound of a split launch's float64 scratch: a gram whose lanes would need
#: more launches in groups of lanes that fit (:func:`lanes_per_launch`),
#: with either kernel. A float32 launch of one segment needs B x tile
#: pairs tiles, at most 1.5 times the bytes of the ``H`` it returns; a bf16
#: launch of one segment needs none (its full mode would need twice the
#: bytes of ``H``). ``tests/test_torch_gram.py`` checks every (P, K) bucket
#: at every batch size up to its GPU cap, for both kernels.
SCRATCH_CAP_BYTES = 2 ** 28

#: Problem sizes n = 6 + K that take the banded mode (the JAX package's
#: ``_NBAND_BY_N`` keys).
BANDED_N = (512, 1024)

#: The triangle and banded modes of the reduced-precision gram mirror whole
#: blocks of this many columns, as the TPU kernels do (a bf16 product and
#: its mirror differ: the operand that carries kappa swaps).
MIRROR_BLOCK = 128

#: MXU passes of the gram product (``SDSM_GRAM_PASSES``): 6 float32, 3 the
#: bf16 hi/lo split, 1 one bf16 pass. Rejected on the TPU as defaults: the
#: reduced-precision steps stalled the LM solver and lost objects.
GRAM_PASSES = int(os.environ.get('SDSM_GRAM_PASSES', '6'))
if GRAM_PASSES not in (1, 3, 6):
    raise ValueError(f'SDSM_GRAM_PASSES must be 1, 3 or 6, got {GRAM_PASSES}')

#: Newton iterations of each solve that take the 1-pass dense gram
#: (``SDSM_GRAM_HYBRID_ITERS``; 0 = off, the default).
HYBRID_ITERS = int(os.environ.get('SDSM_GRAM_HYBRID_ITERS', '0'))

_ROUTES = ('dense', 'triangle', 'banded')

#: Kernel launches per route; only :func:`grad_hess_kernel` adds to them,
#: through :func:`_count_launch` (worker threads launch concurrently).
LAUNCHES = {f'{route}{suffix}': 0 for suffix in ('', '-3pass', '-1pass')
            for route in _ROUTES}

#: The last ``nvcc`` build's output per source (``-Xptxas -v``: registers,
#: shared memory, spills).
BUILD_LOG = {}

#: Shared library, symbol prefix, entry points (name: pointer, int and, where
#: given, float argument counts, in that order; every entry point ends with
#: the stream) and compiled constants of each kernel source. The gram entry
#: points take the pointers Bf, s, yv, w, active, band, g, H, scratch; the
#: ints B, P, n, seg_chunks (and the bf16 kernel's passes and mode).
_KERNELS = {
    'gram_grad_hess.cu': ('libsdsm_gram.so', 'sdsm_gram', {'grad_hess': (9, 4)},
                          dict(tile=TILE, rows=ROWS, flush=FLUSH_CHUNKS)),
    'gram_grad_hess_bf16.cu': ('libsdsm_gram_bf16.so', 'sdsm_gram_bf16',
                               {'grad_hess': (9, 6)},
                               dict(tile=TILE, rows=ROWS, flush=FLUSH_CHUNKS)),
    # the solver's per-lane products and sums (superdsm_tpu_torch.dsm.lane)
    'lane_ops.cu': ('libsdsm_lane.so', 'sdsm_lane',
                    {'matvec': (3, 4), 'strided_sum': (2, 6), 'dot': (3, 2),
                     'softplus_energies': (6, 4), 'softplus': (2, 1),
                     'pcg': (3, 3, 2), 'cholesky': (4, 2)},
                    dict(warp=32, small_n=8, row_threads=256,
                         chol_shared_max_n=335)),
}
_F32_SRC, _BF16_SRC, LANE_SRC = _KERNELS
LANE_CONSTANTS = _KERNELS[LANE_SRC][3]

_lock = threading.Lock()
_libs = {}
_count_lock = threading.Lock()
_capture = threading.local()

#: Callables told of every gram launch, with the launch's
#: ``(Bf shape, active, banded, passes, full)``: under a replayed CUDA graph
#: (:func:`count_replayed`) ``active`` is the graph's own tensor, holding
#: that replay's values once the replay's work before it has run.
LAUNCH_HOOKS = []


def reset_launch_counts(table=None):
    table = LAUNCHES if table is None else table
    with _count_lock:
        for key in table:
            table[key] = 0


def _add_launch(table, route, info, hooks):
    with _count_lock:
        table[route] += 1
    if info is not None:
        for hook in hooks:
            hook(*info)


def _count_launch(route, info=None, table=None, hooks=None):
    """Adds one launch of ``route`` to ``table`` (:data:`LAUNCHES` by
    default) and tells ``hooks`` (:data:`LAUNCH_HOOKS` by default) of its
    ``info``; the read-modify-write is locked, so launches from concurrent
    threads are never lost. While this thread captures a CUDA graph
    (:func:`recording_launches`) the launch is recorded instead: a capture
    launches nothing, and each replay counts it."""
    table = LAUNCHES if table is None else table
    hooks = LAUNCH_HOOKS if hooks is None else hooks
    records = getattr(_capture, 'records', None)
    if records is not None:
        records.append((table, route, info, hooks))
    else:
        _add_launch(table, route, info, hooks)


@contextlib.contextmanager
def recording_launches():
    """Records, instead of counting, the kernel launches this thread makes
    in the block (a CUDA graph capture); yields the list that
    :func:`count_replayed` counts once per replay of the graph."""
    if getattr(_capture, 'records', None) is not None:
        raise RuntimeError('launches are already being recorded in this thread')
    _capture.records = records = []
    try:
        yield records
    finally:
        _capture.records = None


def count_replayed(records):
    """Counts the launches of one replay of a captured graph."""
    for table, route, info, hooks in records:
        _add_launch(table, route, info, hooks)


def route_for(n, banded, passes=6, full=False):
    """The TPU kernel a launch at size ``n`` stands for (``full``: the full
    dense gram whatever ``n``)."""
    if banded:
        route = 'banded'
    elif full:
        route = 'dense'
    else:
        route = 'triangle' if 2 <= n // 128 <= 8 else 'dense'
    return route if passes == 6 else f'{route}-{passes}pass'


def _logistic_weights(s, yv, w):
    t = yv * s
    sig = torch.sigmoid(-t)
    term1 = -yv * sig * w
    kappa = w * yv * yv * sig * (1.0 - sig)
    return term1, kappa


def _bf16_parts(x, passes):
    """The float32 operand ``x`` as the bf16 parts a reduced-precision gram
    multiplies, widened to float64: ``[hi]`` for 1 pass, ``[hi, lo]`` for 3,
    with ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` (round to nearest even,
    as ``_dot_rows_3pass`` and ``_gram_dot_1pass`` round)."""
    hi = x.to(torch.bfloat16)
    if passes == 1:
        return [hi.double()]
    lo = (x - hi.float()).to(torch.bfloat16)
    return [hi.double(), lo.double()]


def _mirror_blocks(H):
    """Replaces the strictly lower :data:`MIRROR_BLOCK` blocks of ``H`` by
    the transpose of the upper ones (the triangle and banded modes)."""
    blk = torch.arange(H.shape[-1], device=H.device) // MIRROR_BLOCK
    return torch.where(blk[:, None] > blk[None, :], H.transpose(-1, -2), H)


def grad_hess_plain(Bf, s, yv, w, active=None, passes=6, mirror=False):
    """Plain PyTorch version: ``(g (..., n), H (..., n, n))`` float32.

    The float32 inputs are multiplied and summed over the pixels in float64
    and rounded once: a float32 reduction over 10^4 pixels in the order a
    library picks (cuBLAS sums a long ``k`` almost sequentially, measured
    4e-5 relative error on the n = 6 gram on an H100) is too coarse for the
    near-singular Newton systems, whose condition reaches ~1e5. The kernels
    get the same effect from float64 running sums. A lane's sums do not
    depend on its batch (see the comment in the body). Frozen lanes
    (``active == 0``) give zeros, as the kernels' do.

    ``passes`` (1 or 3) rounds H's operands ``Bf kappa`` (computed in
    float32) and ``Bf`` to their bf16 parts (:func:`_bf16_parts`) and sums
    ``hi hi`` (+ ``hi lo + lo hi``); bf16 products are exact in float64, so
    only the order of the sums differs from the kernel's. ``g`` keeps full
    precision. ``mirror`` writes the strictly lower blocks as the transpose
    of the upper ones, as the triangle and banded modes do."""
    term1, kappa = _logistic_weights(s, yv, w)

    def lane(Bf, term1, kappa):
        Bd = Bf.double()
        g = (Bd.transpose(-1, -2) @ term1.double()[..., None])[..., 0]
        if passes == 6:
            return g, (Bd * kappa.double()[..., None]).transpose(-1, -2) @ Bd
        a = _bf16_parts(Bf * kappa[..., None], passes)
        b = _bf16_parts(Bf, passes)
        H = a[0].transpose(-1, -2) @ b[0]
        if passes == 3:
            H = H + a[0].transpose(-1, -2) @ b[1] + a[1].transpose(-1, -2) @ b[0]
        return g, H

    # on the CPU one product per lane: MKL splits a batched product's long
    # pixel sum over its threads by the batch, so a lane's sums would
    # depend on the lanes beside it. On the card cuBLAS's batched float64
    # product gives each lane the bits of that lane alone at every batch
    # size from two (tests/data/torch_port/linalg_routes.py, held by
    # chip_smoke.py phase 12); a batch of one, which takes another route,
    # goes in as the same lane twice.
    B = Bf.shape[0] if Bf.dim() == 3 else 1
    if Bf.is_cuda and B == 1 and Bf.dim() == 3:
        g, H = lane(*(t.expand((2,) + tuple(t.shape[1:])).contiguous()
                      for t in (Bf, term1, kappa)))
        g, H = g[:1], H[:1]
    elif Bf.is_cuda or B == 1:
        g, H = lane(Bf, term1, kappa)
    else:
        lanes = [lane(Bf[b:b + 1], term1[b:b + 1], kappa[b:b + 1]) for b in range(B)]
        g = torch.cat([gl for gl, _ in lanes])
        H = torch.cat([Hl for _, Hl in lanes])
    if mirror:
        H = _mirror_blocks(H)
    g, H = g.float(), H.float()
    if active is not None:
        keep = active != 0
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        g = torch.where(keep[:, None], g, zero)
        H = torch.where(keep[:, None, None], H, zero)
    return g, H


def band_ranges(Bf, w):
    """Per-(lane, row chunk) band table of the kernel's banded mode.

    :return: ``(B, P // ROWS, 3)`` int32: whether column tile 0 is nonzero,
        and the first and last column tile >= 1 holding a nonzero entry
        among the chunk's valid pixels (``w > 0``); an empty range is
        ``(nt, 0)``. Padded pixels contribute exact zeros, so they are left
        out. Any band width is allowed.
    """
    B, P, n = Bf.shape
    nt, nc = n // TILE, P // ROWS
    nz = (Bf != 0) & (w > 0)[..., None]
    nz = nz.view(B, nc, ROWS, nt, TILE).any(dim=4).any(dim=2)  # (B, nc, nt)
    idx = torch.arange(1, nt, device=Bf.device, dtype=torch.int32)
    rest = nz[..., 1:]
    lo = torch.where(rest, idx, nt).amin(dim=-1)
    hi = torch.where(rest, idx, 0).amax(dim=-1)
    return torch.stack([nz[..., 0].to(torch.int32), lo.to(torch.int32),
                        hi.to(torch.int32)], dim=-1).contiguous()


def tile_pairs(n, passes=6, full=False):
    """Column-tile pairs a launch computes: the upper triangle (u <= v) of
    the float32 kernel's tiles; the bf16 kernel's every pair in full mode,
    else four per upper-triangle :data:`MIRROR_BLOCK` block pair."""
    nt = n // TILE
    if passes == 6:
        return nt * (nt + 1) // 2
    if full:
        return nt * nt
    nb = n // MIRROR_BLOCK
    return nb * (nb + 1) // 2 * (MIRROR_BLOCK // TILE) ** 2


def split_plan(B, P, n, passes=6, full=False):
    """A kernel's split of the pixel loop: ``(seg_chunks, n_segments)``.

    Both kernels, the float32 one (``passes`` 6) and the bf16 one (1 or 3),
    plan from ``(P, n)`` alone, as for one lane, and ``B`` is not read:
    every lane's float64 partials are then summed over the same segments in
    the same order whatever its batch (a plan from ``B`` made a lane's H
    differ between a batch of one and of two).

    One lane's ``tile_pairs(n, passes, full)`` work items, if they reach
    :data:`TARGET_ITEMS`, run one segment (the whole pixel loop in each
    block). Fewer split the ``P / ROWS`` chunks into segments of
    ``seg_chunks`` chunks, at least :data:`MIN_SEG_CHUNKS` and a multiple of
    :data:`FLUSH_CHUNKS` (so the float32 partials do not depend on the
    split), as few as bring the work items up to about
    :data:`TARGET_ITEMS`, at most :data:`MAX_SEGMENTS`. Only static shapes
    count: frozen lanes are not known on the host without a sync."""
    nchunks = P // ROWS
    items = tile_pairs(n, passes, full)
    if items >= TARGET_ITEMS or nchunks <= MIN_SEG_CHUNKS:
        return nchunks, 1
    want = min(-(-TARGET_ITEMS // items), MAX_SEGMENTS)
    seg = max(MIN_SEG_CHUNKS, -(-nchunks // want))
    seg = -(-seg // FLUSH_CHUNKS) * FLUSH_CHUNKS
    if seg >= nchunks:
        return nchunks, 1
    return seg, -(-nchunks // seg)


def scratch_entries(B, P, n, passes=6, full=False):
    """float64 entries of the scratch of one launch of ``B`` lanes: each
    segment's partial tile of every (lane, tile pair), then its g; none for
    a bf16 launch of one segment, which writes ``H`` and ``g`` itself."""
    _, nsegs = split_plan(B, P, n, passes, full)
    if passes != 6 and nsegs == 1:
        return 0
    return nsegs * B * (tile_pairs(n, passes, full) * TILE * TILE + n)


def lanes_per_launch(B, P, n, passes=6, full=False):
    """Lanes of one kernel launch: a gram of ``B`` lanes split over pixel
    segments launches in groups of lanes whose scratch stays within
    :data:`SCRATCH_CAP_BYTES` (its plan does not shrink with ``B``); a
    launch of one segment takes all ``B``."""
    if split_plan(B, P, n, passes, full)[1] == 1:
        return B
    return max(1, min(B, SCRATCH_CAP_BYTES
                      // (8 * scratch_entries(1, P, n, passes, full))))


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the gram kernels are built from '
                       f'{_CSRC} with the CUDA toolkit')


def _lib_path(src):
    return os.path.join(BUILD_DIR, _KERNELS[src][0])


def build():
    """Compiles every kernel library anew, one ``nvcc`` per source, all
    started together; returns the seconds the build took."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    procs = {}
    for src in _KERNELS:
        tmp = f'{_lib_path(src)}.{os.getpid()}.tmp'
        cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-Xptxas', '-v', '-shared',
               '-Xcompiler', '-fPIC', '-o', tmp, os.path.join(_CSRC, src)]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            failed.append(f'{src}: nvcc failed ({proc.returncode}):\n{out}')
        else:
            os.replace(tmp, _lib_path(src))
    if failed:
        raise RuntimeError('\n'.join(failed))
    return time.time() - t0


def _load(src=_F32_SRC):
    """Builds (if missing or stale) and loads one kernel library."""
    lib = _libs.get(src)
    if lib is not None:
        return lib
    with _lock:
        if src in _libs:
            return _libs[src]
        path = _lib_path(src)
        if (not os.path.exists(path) or os.path.getmtime(path)
                < os.path.getmtime(os.path.join(_CSRC, src))):
            build()
        lib = ctypes.CDLL(path)
        _, prefix, entries, constants = _KERNELS[src]
        for name, (n_ptrs, n_ints, *n_floats) in entries.items():
            fn = getattr(lib, f'{prefix}_{name}')
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + \
                [ctypes.c_float] * sum(n_floats) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name, value in constants.items():
            const = getattr(lib, f'{prefix}_{name}')
            const.restype = ctypes.c_int
            if const() != value:
                raise RuntimeError(f'{src}: library has {name}={const()}, '
                                   f'expected {value}')
        _libs[src] = lib
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {shape}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: not contiguous')


def grad_hess_kernel(Bf, s, yv, w, active, band=None, passes=6, full=False):
    """Launches a CUDA kernel on the current stream; returns ``(g, H)``.

    ``passes`` 6 launches the float32 kernel (``band``, from
    :func:`band_ranges`, selects its banded mode); 1 or 3 the bf16 kernel,
    in full mode with ``full`` (every tile pair straight), else in triangle
    mode, or banded mode with a ``band``."""
    B, P, n = Bf.shape
    dev = Bf.device
    if dev.type != 'cuda':
        raise ValueError(f'grad_hess_kernel needs CUDA tensors, got {dev}')
    if passes not in (1, 3, 6):
        raise ValueError(f'passes must be 1, 3 or 6, got {passes}')
    if passes == 6 and full:
        raise ValueError('the float32 kernel has no full mode')
    if full and band is not None:
        raise ValueError('full mode takes no band table')
    cols = TILE if passes == 6 or full else MIRROR_BLOCK
    if n % cols or P % ROWS:
        raise ValueError(f'gram kernel needs n % {cols} == 0 and '
                         f'P % {ROWS} == 0, got n={n}, P={P}')
    f32 = torch.float32
    _check('Bf', Bf, f32, (B, P, n), dev)
    for name, t in (('s', s), ('yv', yv), ('w', w)):
        _check(name, t, f32, (B, P), dev)
    _check('active', active, torch.int32, (B,), dev)
    if band is not None:
        _check('band', band, torch.int32, (B, P // ROWS, 3), dev)
    for name, t in (('Bf', Bf), ('s', s), ('yv', yv), ('w', w)):
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    lib = _load(_F32_SRC if passes == 6 else _BF16_SRC)
    g = torch.empty((B, n), dtype=f32, device=dev)
    H = torch.empty((B, n, n), dtype=f32, device=dev)
    seg_chunks, _ = split_plan(B, P, n, passes, full)
    group = lanes_per_launch(B, P, n, passes, full)
    route = route_for(n, band is not None, passes, full)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, group):
            lanes = slice(b0, min(B, b0 + group))
            nb = lanes.stop - b0
            entries = scratch_entries(nb, P, n, passes, full)
            part = torch.empty((entries,), dtype=torch.float64, device=dev) \
                if entries else None
            args = tuple(t[lanes].data_ptr() for t in (Bf, s, yv, w, active)) + (
                None if band is None else band[lanes].data_ptr(),
                g[lanes].data_ptr(), H[lanes].data_ptr(),
                None if part is None else part.data_ptr(), nb, P, n, seg_chunks)
            if passes == 6:
                err = lib.sdsm_gram_grad_hess(*args, stream)
            else:
                mode = 0 if full else (1 if band is None else 2)
                err = lib.sdsm_gram_bf16_grad_hess(*args, passes, mode, stream)
            if err != 0:
                raise RuntimeError(f'gram kernel launch failed: CUDA error {err}')
            _count_launch(route, ((nb, P, n), active[lanes], band is not None,
                                  passes, full))
    return g, H


def fused_grad_hess_batched(Bf, s, yv, w, active=None, band=None, cheap=False):
    """Fused logistic gradient and Gauss-Newton Hessian, batched.

    :param Bf: (B, P, n) float32 feature matrices, n a multiple of 128.
    :param s, yv, w: (B, P) float32 surface, intensities, pixel weights.
    :param active: optional (B,) per-lane activity flag (1 = compute);
        frozen lanes return zeros (the Newton driver discards their g/H).
    :param band: optional band table (:func:`band_ranges`); used for
        n in :data:`BANDED_N`.
    :param cheap: the 1-pass bf16 gram, full dense at every n (the early
        iterations of the hybrid schedule, :data:`HYBRID_ITERS`).
    :return: ``(g (B, n), H (B, n, n))`` float32. The product precision is
        :data:`GRAM_PASSES` unless ``cheap``.
    """
    B, P, n = Bf.shape
    passes = 1 if cheap else GRAM_PASSES
    if active is None:
        active = torch.ones((B,), dtype=torch.int32, device=Bf.device)
    else:
        active = active.to(torch.int32)
    # B1's reduced-precision bodies compute every block pair straight; B2
    # and B3 mirror the lower blocks
    full = cheap or (passes != 6 and route_for(n, False) == 'dense')
    if Bf.device.type == 'cpu':
        return grad_hess_plain(Bf, s, yv, w, active, passes=passes,
                               mirror=passes != 6 and not full)
    if n % 128:
        raise ValueError(f'the gram kernel serves n % 128 == 0, got n={n}')
    use_band = band if n in BANDED_N and not full else None
    return grad_hess_kernel(Bf.contiguous(), s.contiguous(), yv.contiguous(),
                            w.contiguous(), active.contiguous(), use_band,
                            passes=passes, full=full)
