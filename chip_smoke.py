#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``superdsm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
result lines):

1. environment: torch/CUDA versions, whether triton imports, the card's name
   and power limit; exits non-zero without CUDA or without the package;
2. build: compiles both gram kernels (``superdsm_tpu_torch/csrc/
   gram_grad_hess.cu`` and ``gram_grad_hess_bf16.cu``) with one nvcc each,
   started together, for sm_90a; prints the build seconds and ptxas'
   registers, shared memory and spills;
3. every gram route against its plain PyTorch version on the card at the
   main path's shapes, with feature matrices built from real row-major disk
   regions and a quarter of the lanes frozen; the float32 routes and the
   hybrid schedule's 1-pass full gram (``dense-1pass``) also at few-lane
   shapes the main path launches ((1, 8192, 128), (1, 32768, 512) banded
   for float32, (64, 8192, 128) with 4 lanes active; the kernels split
   their pixel loop across blocks), and ``dense-1pass`` at (8, 16384, 1024),
   a launch that fills the card in one segment, where the bf16 kernel
   writes H itself: the float32 kernel to
   rtol = atol = 1e-4; the bf16 kernel at 3 passes to rtol = atol = 1e-4,
   at 1 pass within bf16's unit roundoff elementwise
   (|dH| <= 2^-7 |Bf|^T diag(kappa) |Bf| + 1e-4) and to 1e-4 on >= 99% of
   the entries; banded mode bitwise equal to the unbanded mode, frozen lanes
   exactly zero, two runs bitwise equal. Times are device ms per call (one
   call captured in a CUDA graph, replayed 10 times between CUDA events,
   median of 3; a single call with its host overhead is printed beside the
   kernel's), beside each launch's bound (the larger of its operations
   over the card's published peak and its bytes over the memory rate,
   counted from this run's inputs) and the time of ``torch.bmm`` of the
   kappa-scaled active lanes against Bf in float32 (TF32 off);
4. the main path: ``automation.process_image`` on seed 0 of the bench's
   520x696 synthetic nuclei field at ``AF_scale=12`` (cold, then timed with
   the kernel launch counts), the label map held against the JAX-CPU golden
   ``tests/data/torch_port/bench-seed0.csv`` (center 3 px, size 10%, at
   most one unmatched object); then one more run under ``torch.profiler``:
   the float32 gram's device ms per image against the first kernel's
   208 ms, the device's idle share of the wall, and the gram launches by
   (B, active lanes, P, n, route, pixel segments);
5. the real NIH3T3 crop ``tests/regression/data/nih3t3-glare.png`` through
   the default entry point with no ``AF_scale``: the estimated scale must be
   the JAX estimator's (30 sqrt 2 = 42.4264...) and all 5 objects must
   match ``tests/regression/expected/nih3t3/nih3t3-glare.csv``;
6. the precision knobs: the bench field at ``AF_scale=12`` in one
   subprocess each with ``SDSM_GRAM_PASSES=3``, ``SDSM_GRAM_PASSES=1`` and
   ``SDSM_GRAM_HYBRID_ITERS=16``; each must exit 0 and launch its bf16
   routes. Objects, matches against the golden and seconds are printed, not
   gated: the TPU lost objects under these knobs;
7. the batch CLI (``superdsm_tpu_torch.batch``) over a task tree in a
   temporary directory: ``bench/`` (bench seeds 0-3 as 16-bit PNGs written
   by the port's ``imsave``, ``AF_scale`` 12, seg/overlay/adjacency outputs),
   ``nih3t3/`` (the repository's NIH3T3 crop, scale estimated) and
   ``bench/post/`` (a child of ``bench/`` with one ``postprocess`` key
   changed).
   (a) in process, ``run_cli([root, '--run', '--no-fork', '--force',
   '--fresh', '--task', 'bench'])`` serial (``SUPERDSM_TPU_TASK_THREADS=1``)
   and then with the default 3 threads, each on its own CUDA stream: each
   threaded seg map within one unmatched object of the serial one (center
   3 px, size 10%), every float32 gram route launched by the threaded run;
   images per second of both printed. The deadline fetch of the solve seam
   on a busy non-default stream: ``SolveTimeout`` under a short deadline,
   the producer's values under a long one.
   (b) ``python -m superdsm_tpu_torch.batch <root> --run --task nih3t3 --task
   bench/post`` in a subprocess, forked per task: exit 0, the NIH3T3 seg map
   5/5 against its golden, ``bench/post`` picked up at ``postprocess`` (its
   log starts no stage before it; it writes its seg maps and, by the
   on-disk contract, no results of its own), and the results
   (``nih3t3/`` and ``bench/data.dill.gz``, which ``bench/post`` picked up)
   load with ``pickle`` and hold no ``torch.Tensor``;
8. the export CLI: ``python -m superdsm_tpu_torch.export <root> nih3t3
   --mode seg``, then ``--mode adj``, in subprocesses: exit 0, one PNG of the
   image's height and width per image, and ``ymap_legend.png`` for ``adj``.

The line before the last is the kernel table as JSON (``launches``: the
float32 routes' counts from phase 4's timed run, the bf16 routes' from
their knob run of phase 6); the last line is ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --ab ROOT_A ROOT_B`` compares the port of two
checkouts instead (for example the parent commit unpacked with ``git
archive`` into the gitignored ``scratch/``, against ``.``): one fresh
process per turn, in the order A, B, B, A, each building its own
checkout's kernels and printing one JSON line: the device ms of every
phase-3 launch, the float32 routes' first and then the bf16 routes' (each
checked against the plain version first, as phase 3 checks it), then bench
seeds 0-3 at ``AF_scale=12`` (after one cold run of seed 0),
:data:`AB_REPS` times each, with each run's seconds, its
global-energy-minimization seconds, lane Newton iterations, solve calls
and canonically re-solved lanes (``batching.device_accounting``), gram
launches per route and objects, and seed 0's match against the golden.
"""

import gzip
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: Expected scale of the NIH3T3 crop: the JAX package's blob-detector
#: estimate (``superdsm_tpu.automation._estimate_scale`` on the CPU),
#: 30 * sqrt(2); the port's estimate must agree to 1e-9 relative.
NIH3T3_SCALE = 42.426406871192846

#: Main-path shapes of phase 3: (B, P, n, route, active lanes) — the
#: n = 128, 256 and 512 bucket chunks of the bench field with a quarter of
#: the lanes frozen (every precision) ...
KERNEL_SHAPES = [(64, 8192, 128, 'dense', 48), (32, 12288, 256, 'triangle', 24),
                 (16, 32768, 512, 'banded', 12)]
#: ... and few-lane launches the main path makes (the B = 1 canonical
#: re-solves, a batch with most lanes converged), float32 only: the kernel
#: splits their pixel loop across blocks.
FEW_LANE_SHAPES = [(1, 8192, 128, 'dense', 1), (1, 32768, 512, 'banded', 1),
                   (64, 8192, 128, 'dense', 4)]
#: A 1-pass full launch that fills the card in one segment (the hybrid
#: schedule's cheap gram at n = 1024): the bf16 kernel's direct write of H.
ONE_SEGMENT_SHAPES = [(8, 16384, 1024, 'dense', 8)]


def _cases():
    """Phase 3's launches: each shape with the ``(passes, full)`` of every
    route it runs: all routes at the table shapes (the bf16 kernel in full
    mode where the base route is dense), the float32 route and the 1-pass
    full gram at the few-lane shapes, the 1-pass full gram at the
    one-segment shape."""
    for shape in KERNEL_SHAPES:
        full = shape[3] == 'dense'
        yield shape, [(6, False), (3, full), (1, full)]
    for shape in FEW_LANE_SHAPES:
        yield shape, [(6, False), (1, True)]
    for shape in ONE_SEGMENT_SHAPES:
        yield shape, [(1, True)]


def _phase3_inputs(B, P, n, base, n_active):
    """The inputs of a phase-3 shape, made from the seed ``n`` on the card:
    ``(Bf, s, yv, w, active, band)``, band None unless ``base`` is
    banded."""
    import torch
    from superdsm_tpu_torch.dsm import gram
    rng = np.random.RandomState(n)
    lanes = [_lane_features(rng, P, n - 6) for _ in range(B)]
    Bf, s, yv, w = (torch.stack(t).contiguous() for t in zip(*lanes))
    del lanes
    band = gram.band_ranges(Bf, w) if base == 'banded' else None
    torch.cuda.synchronize()
    return Bf, s, yv, w, _active(B, n_active), band
#: Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
#: float32 outside the tensor cores, bf16 tensor cores, HBM3 bytes per second.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
_PK = 'superdsm_tpu/dsm/pallas_kernels.py'
#: The Pallas kernel (or reduced-precision body) each route replaces.
REPLACES = {'dense': f'{_PK}:436', 'triangle': f'{_PK}:292',
            'banded': f'{_PK}:346',
            'dense-3pass': f'{_PK}:50', 'triangle-3pass': f'{_PK}:50',
            'banded-3pass': f'{_PK}:50',
            'dense-1pass': f'{_PK}:123', 'triangle-1pass': f'{_PK}:72',
            'banded-1pass': f'{_PK}:72'}


def _source(route):
    """The kernel source of a route: the reduced-precision routes run the
    bf16 kernel."""
    bf16 = '_bf16' if route.endswith('pass') else ''
    return f'superdsm_tpu_torch/csrc/gram_grad_hess{bf16}.cu'


#: Phase 6: the environment of each knob run, and the routes whose launch
#: counts the kernel table takes from that run.
KNOB_RUNS = [({'SDSM_GRAM_PASSES': '3'},
              ('dense-3pass', 'triangle-3pass', 'banded-3pass')),
             ({'SDSM_GRAM_PASSES': '1'}, ('triangle-1pass', 'banded-1pass')),
             ({'SDSM_GRAM_HYBRID_ITERS': '16'}, ('dense-1pass',))]
RTOL = ATOL = 1e-4
#: 1 pass: least share of H entries within rtol = atol = 1e-4 of the plain
#: version (single bf16 roundings may flip on a one-ulp kappa difference).
ONE_PASS_MIN_SHARE = 0.99


def fail(msg):
    print(f'[FAIL] {msg}', flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_environment():
    if not os.path.isfile(os.path.join(REPO, 'superdsm_tpu_torch', '__init__.py')):
        fail('superdsm_tpu_torch not found beside chip_smoke.py')
    sys.path.insert(0, REPO)
    import torch
    say(f'[env] python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}')
    try:
        import triton
        say(f'[env] triton {triton.__version__} imports')
    except ImportError:
        say('[env] triton does not import')
    for lib in ('PIL', 'matplotlib', 'dill'):
        try:
            __import__(lib)
            say(f'[env] {lib} imports (the port does not need it)')
        except ImportError:
            say(f'[env] {lib} does not import')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0].strip()
    say(f'[env] device {torch.cuda.get_device_name(0)} '
        f'(count {torch.cuda.device_count()})')
    return card


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------

def _lane_features(rng, P, K, img_shape=(520, 696), sigma=4.0, cutoff=16,
                   stride=8):
    """One lane of a DSM chunk from a real row-major disk region: pixels in
    argwhere order, the greedy subsample grid, padding to (P, 6 + K)."""
    import torch
    from superdsm_tpu_torch.dsm.smooth import build_smooth_matrix, subsample_grid
    from superdsm_tpu_torch.dsm.solver import _poly_basis
    npix_target = int(P * rng.uniform(0.8, 0.98))
    radius = int(np.sqrt(npix_target / np.pi))
    side = 2 * radius + 3
    rr, cc = np.mgrid[:side, :side]
    ecc = rng.uniform(0.85, 1.15)
    mask = (((rr - side // 2) / ecc) ** 2 + ((cc - side // 2) * ecc) ** 2
            <= radius ** 2)
    pts = np.argwhere(mask)[:P]
    npix = len(pts)
    sub = np.argwhere(subsample_grid(mask, stride) & mask)[:K]
    k = len(sub)
    off = np.array([rng.randint(0, img_shape[0] - side),
                    rng.randint(0, img_shape[1] - side)])
    PIX = np.zeros((P, 2), np.float32)
    PIX[:npix] = pts
    W = np.zeros(P, np.float32)
    W[:npix] = 1.0
    SUB = np.full((K, 2), -10.0 * (cutoff + 1), np.float32)
    SUB[:k] = sub
    KM = np.zeros(K, np.float32)
    KM[:k] = 1.0
    dev = torch.device('cuda')
    coords = torch.from_numpy(((PIX + off) / (np.asarray(img_shape) - 1.0))
                              .astype(np.float32)).to(dev)
    G = build_smooth_matrix(torch.from_numpy(PIX).to(dev), torch.from_numpy(SUB).to(dev),
                            sigma, cutoff, torch.from_numpy(KM).to(dev))
    Bf = torch.cat([_poly_basis(coords), G], dim=1)
    yv = (np.sign(rng.randn(P)) * rng.uniform(0.05, 1.0, P) * W).astype(np.float32)
    s = (rng.randn(P) * 2.0).astype(np.float32)
    return Bf, torch.from_numpy(s).to(dev), torch.from_numpy(yv).to(dev), \
        torch.from_numpy(W).to(dev)


def _call_ms(fn, reps=10):
    """Median ms of single calls of ``fn`` between two CUDA events: the
    device's time plus the host's time to issue the call (its argument
    checks, allocations and launches), while the card waits."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _event_ms(fn, reps=10):
    """Device ms per call of ``fn``: after a warm-up call, one call captured
    in a CUDA graph and replayed ``reps`` times back to back between two
    CUDA events; the median of 3 such runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def _bound(route, passes, Bf, active, band):
    """Least time (ms) the card could take for one launch, and what bounds
    it (``'operations'`` or ``'bytes'``).

    Operations: the products of the active lanes' H and g. H counts its
    upper triangle (H is symmetric); the reduced-precision triangle mode
    also the lower half of each diagonal 128-column block (its blocks are
    mirrored, not its entries), the full mode all n x n; a banded route only
    the (chunk, 64-column tile pair) cells that the band table leaves, as
    the kernel's granularity sees the data. Float32 products at the float32
    peak, bf16 ones at the tensor cores' bf16 peak times the passes. Bytes:
    each input read once (Bf of the active lanes, of a banded route only the
    band's tiles; s, yv, w; active and the band table) and g and H written
    once."""
    from superdsm_tpu_torch.dsm import gram
    B, P, n = Bf.shape
    T, R = gram.TILE, gram.ROWS
    on = active != 0
    act = int(on.sum())
    if band is None:
        tiles = act * (P // R) * (n // T)
        if passes != 6 and route.startswith('dense'):
            per_row = n * n
        else:
            per_row = n * (n + 1) // 2
            if passes != 6:
                mb = gram.MIRROR_BLOCK
                per_row += (n // mb) * mb * (mb - 1) // 2
        h_ops = 2.0 * act * P * per_row
        g_ops = 2.0 * act * P * n
    else:
        bt = band[on].cpu().numpy().astype(np.int64)
        m = (bt[..., 0] != 0) + np.maximum(bt[..., 2] - bt[..., 1] + 1, 0)
        tiles = int(m.sum())
        h_ops = 2.0 * R * float((m * (m - 1) // 2).sum() * T * T
                                + m.sum() * (T * (T + 1) // 2))
        g_ops = 2.0 * R * T * float(m.sum())
    ops_s = (h_ops / PEAK_FP32 if passes == 6 else passes * h_ops / PEAK_BF16) \
        + g_ops / PEAK_FP32
    nbytes = 4.0 * (tiles * R * T + 3 * act * P + B + B * (n + n * n))
    if band is not None:
        nbytes += 4.0 * band.numel()
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, 'operations' if ops_s >= bytes_s else 'bytes'


def _library_ms(Bf, s, yv, w, active):
    """The one PyTorch call that carries the gram's work: ``torch.bmm`` of
    the kappa-scaled active lanes, transposed, against their Bf, in float32
    with TF32 off (a yardstick; the port never calls it)."""
    import torch
    from superdsm_tpu_torch.dsm import gram
    keep = (active != 0).nonzero()[:, 0]
    A = Bf[keep]
    _, kappa = gram._logistic_weights(s[keep], yv[keep], w[keep])
    Ak = (A * kappa[..., None]).transpose(1, 2)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _event_ms(lambda: torch.bmm(Ak, A))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _agreement(passes, mirror, Bf, s, yv, w, active, g, H):
    """Holds a kernel's ``(g, H)`` against the plain version with the
    route's tolerance; returns ``(max_abs_err, report, ok)``."""
    from superdsm_tpu_torch.dsm import gram
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active, passes=passes,
                                        mirror=mirror)
    err = max(float((g - g_ref).abs().max()), float((H - H_ref).abs().max()))
    excess_g = float(((g - g_ref).abs() - RTOL * g_ref.abs()).max())
    excess = max(excess_g, float(((H - H_ref).abs() - RTOL * H_ref.abs()).max()))
    if passes != 1:
        return err, (f'max_abs_err {err:.3e}, max(|d| - rtol|ref|) '
                     f'{excess:.3e} (atol {ATOL})'), excess <= ATOL
    _, kappa = gram._logistic_weights(s, yv, w)
    absBf = Bf.abs().double()
    bound = 2.0 ** -7 * (absBf * kappa.double()[..., None]).transpose(1, 2) @ absBf
    over = float(((H - H_ref).abs().double() - bound).max())
    share = float(((H - H_ref).abs() <= ATOL + RTOL * H_ref.abs()).double().mean())
    ok = over <= 1e-4 and share >= ONE_PASS_MIN_SHARE and excess_g <= ATOL
    return err, (f'max_abs_err {err:.3e}, max(|dH| - 2^-7 |Bf|^T k |Bf|) '
                 f'{over:.3e} (<= 1e-4), share within 1e-4 {share:.5f} '
                 f'(>= {ONE_PASS_MIN_SHARE}), max(|dg| - rtol|ref|) '
                 f'{excess_g:.3e} (atol {ATOL})'), ok


def _check_route(route, passes, Bf, s, yv, w, active, band):
    """Holds one route against its plain version; returns its table row."""
    import torch
    from superdsm_tpu_torch.dsm import gram
    full = passes != 6 and route.startswith('dense')
    mirror = passes != 6 and not full

    def kernel(band_=band):
        return gram.grad_hess_kernel(Bf, s, yv, w, active, band_, passes=passes,
                                     full=full)

    B, P, n = Bf.shape
    act = int((active != 0).sum())
    tag = f'{route} ({B}, {P}, {n}), {act} active'
    g, H = kernel()
    torch.cuda.synchronize()
    g2, H2 = kernel()
    torch.cuda.synchronize()
    if not (torch.equal(g, g2) and torch.equal(H, H2)):
        fail(f'{tag}: two runs differ (not reproducible)')
    if not (torch.isfinite(g).all() and torch.isfinite(H).all()):
        fail(f'{tag}: non-finite output')
    frozen = active == 0
    if g[frozen].any() or H[frozen].any():
        fail(f'{tag}: frozen lanes are not exactly zero')
    err, report, ok = _agreement(passes, mirror, Bf, s, yv, w, active, g, H)
    say(f'[kernel] {tag}: {report}')
    if not ok:
        fail(f'{tag}: kernel disagrees with the plain version')
    if band is not None:
        g_d, H_d = kernel(None)
        torch.cuda.synchronize()
        if not (torch.equal(g, g_d) and torch.equal(H, H_d)):
            fail(f'{tag}: banded mode is not bitwise equal to the unbanded mode')
        unbanded_ms = _event_ms(lambda: kernel(None))
        say(f'[kernel] {tag}: banded mode bitwise equals the unbanded '
            f'(triangle) mode, which takes {unbanded_ms:.3f} ms at this shape')
    del g2, H2
    ms = _event_ms(kernel)
    call_ms = _call_ms(kernel)
    plain_ms = _event_ms(lambda: gram.grad_hess_plain(
        Bf, s, yv, w, active, passes=passes, mirror=mirror))
    library_ms = _library_ms(Bf, s, yv, w, active)
    bound_ms, bound_by = _bound(route, passes, Bf, active, band)
    segments = gram.split_plan(B, P, n, passes, full)[1]
    say(f'[kernel] {tag}: kernel {ms:.3f} ms ({segments} pixel segment'
        f'{"s" if segments > 1 else ""}; {call_ms:.3f} ms a single call with '
        f'its host overhead), plain {plain_ms:.3f} ms, library (float32 bmm) '
        f'{library_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}: '
        f'{bound_ms / ms:.1%} of the bound (device ms per call: CUDA graph '
        f'replays between CUDA events)')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / ms,
                library_ms=library_ms, call_ms=call_ms, shape=[B, P, n],
                active=act, segments=segments)


def _active(B, n_active):
    """The active lanes of a phase-3 launch: every fourth lane frozen at the
    table shapes, ``n_active`` evenly spread ones at the few-lane shapes."""
    import torch
    if n_active == B - (B + 3) // 4:
        active = torch.ones(B, dtype=torch.int32)
        active[::4] = 0
    else:
        active = torch.zeros(B, dtype=torch.int32)
        active[::B // n_active] = 1
    if int(active.sum()) != n_active:
        fail(f'phase 3: cannot spread {n_active} active lanes over {B}')
    return active.cuda()


def phase_kernels():
    """Phase 3: every launch of :func:`_cases`; a route's row is its table
    shape's, and its launches at the other shapes are listed under it as
    ``other_shapes``."""
    import torch
    from superdsm_tpu_torch.dsm import gram
    rows = {}
    for shape, launches in _cases():
        Bf, s, yv, w, active, band = _phase3_inputs(*shape)
        for passes, full in launches:
            band_ = None if full else band
            route = gram.route_for(shape[2], band_ is not None, passes, full)
            row = _check_route(route, passes, Bf, s, yv, w, active, band_)
            if shape in KERNEL_SHAPES:
                rows[route] = dict(row, other_shapes=[])
            else:
                rows[route]['other_shapes'].append(row)
        del Bf, s, yv, w, active, band
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def make_image(seed, H=520, W=696, n_nuclei=28, radius=16):
    """Synthetic fluorescence nuclei field with touching pairs (the bench
    field of ``bench.py``)."""
    rng = np.random.RandomState(seed)
    g = np.zeros((H, W), np.float32)
    rr, cc = np.indices((H, W))
    centers = []
    attempts = 0
    while len(centers) < n_nuclei and attempts < 2000:
        attempts += 1
        r0 = rng.randint(radius, H - radius)
        c0 = rng.randint(radius, W - radius)
        # allow some touching pairs (min separation 1.4 r instead of 2.5 r)
        if all((r0 - r) ** 2 + (c0 - c) ** 2 > (1.4 * radius) ** 2 for r, c in centers):
            centers.append((r0, c0))
    for (r0, c0) in centers:
        rad = radius * rng.uniform(0.8, 1.2)
        ecc = rng.uniform(0.8, 1.25)
        g += rng.uniform(0.7, 1.0) * np.exp(
            -(((rr - r0) / ecc) ** 2 + ((cc - c0) * ecc) ** 2) / (2 * (rad * 0.55) ** 2))
    g += rng.randn(H, W).astype(np.float32) * 0.02
    return g.astype(np.float32), len(centers)


def _segment(g, scale):
    """``automation.process_image`` on the default pipeline; ``scale`` None
    leaves ``AF_scale`` unset (the entry point estimates it). Returns the
    data, label map, config, stage timings and wall seconds."""
    import torch
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.output import get_output
    from superdsm_tpu_torch.render import rasterize_labels
    base = T.Config() if scale is None else T.Config({'AF_scale': scale})
    t0 = time.time()
    data, cfg, timings = T.automation.process_image(
        T.create_default_pipeline(), base, g,
        out=get_output(None).derive(muted=True))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    seg = rasterize_labels(data)
    if seg.shape != np.asarray(g).shape:
        fail(f'label map shape {seg.shape} != image shape {np.asarray(g).shape}')
    return data, seg, cfg, timings, seconds


def _validate_module():
    """``tests/regression/validate.py`` loaded by file path (a ``tests``
    package installed elsewhere would shadow the repository's)."""
    import importlib.util
    path = os.path.join(REPO, 'tests', 'regression', 'validate.py')
    spec = importlib.util.spec_from_file_location('_sdsm_validate', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _match(seg, expected_csv, max_unmatched=None):
    """Matches a label map against a golden CSV; fails when more than
    ``max_unmatched`` objects are spurious or missing (None: not gated)."""
    validate = _validate_module()
    rows = validate.summarize_label_map(seg)
    expected = validate.load_csv(expected_csv)
    matched, spurious, missing = validate.match_rows(
        rows, expected, center_tol=3.0, size_tol=0.1)
    say(f'[match] {matched}/{len(expected)} matched, spurious {spurious}, '
        f'missing {missing}')
    if max_unmatched is not None and (len(spurious) > max_unmatched
                                      or len(missing) > max_unmatched):
        fail(f'label map disagrees with {os.path.relpath(expected_csv, REPO)}')
    return matched, len(expected)


BENCH_GOLDEN = os.path.join(REPO, 'tests/data/torch_port/bench-seed0.csv')
NIH3T3_PNG = os.path.join(REPO, 'tests/regression/data/nih3t3-glare.png')
NIH3T3_CSV = os.path.join(REPO, 'tests/regression/expected/nih3t3/nih3t3-glare.csv')


#: Device ms per bench image of the first float32 gram kernel (one block
#: per lane and tile pair, no pixel split) in its profile of the main path
#: on an H100 80GB HBM3 at 700 W (213 launches; ``PERF.md`` section 5).
FIRST_GRAM_MS = 208.0
#: Substrings of the float32 gram's kernel names.
GRAM_KERNELS = ('gram_grad_hess_kernel', 'gram_reduce_kernel')


def _merged_ms(intervals):
    """Length of the union of ``(start, end)`` intervals in microseconds, in
    ms."""
    busy, end = 0.0, float('-inf')
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_profile(g):
    """Phase 4's profile: one ``torch.profiler`` pass over the bench image.
    A wrapper installed here only records each gram launch's shape and
    active lanes (a device copy of ``active``, read after the run, so the
    pass adds no host sync); prints the gram's device ms against the first
    kernel's,
    the device's idle share of the wall and the launch histogram."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    from superdsm_tpu_torch.dsm import gram
    kernel = gram.grad_hess_kernel
    records = []

    def recording(Bf, s, yv, w, active, band=None, passes=6, full=False):
        records.append((tuple(Bf.shape), active.clone(), band is not None,
                        passes, full))
        return kernel(Bf, s, yv, w, active, band, passes=passes, full=full)

    gram.grad_hess_kernel = recording
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, _, _, seconds = _segment(g, 12)
    finally:
        gram.grad_hess_kernel = kernel
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == cuda]
    if not spans:
        fail('profile: torch.profiler recorded no device time')
    busy_ms = _merged_ms([(a, b) for _, a, b in spans])
    gram_ms = sum(b - a for name, a, b in spans
                  if any(k in name for k in GRAM_KERNELS)) / 1e3
    span_ms = (max(b for _, _, b in spans) - min(a for _, a, _ in spans)) / 1e3
    say(f'[profile] bench image under torch.profiler: wall {seconds:.2f} s, '
        f'device busy {busy_ms:.1f} ms ({len(spans)} device activities): idle '
        f'{1 - busy_ms / (seconds * 1e3):.1%} of the wall, '
        f'{1 - busy_ms / span_ms:.1%} of the span from the first to the last '
        f'device activity')
    say(f'[profile] float32 gram kernels: {gram_ms:.1f} ms device time per '
        f'image ({len(records)} launches; first kernel: '
        f'{FIRST_GRAM_MS:.0f} ms, 213 '
        f'launches), {gram_ms / busy_ms:.1%} of the device busy time')
    hist = collections.Counter()
    for (B, P, n), active, banded, passes, full in records:
        route = gram.route_for(n, banded, passes, full)
        segments = gram.split_plan(B, P, n, passes, full)[1]
        hist[(B, int((active != 0).sum()), P, n, route, segments)] += 1
    say('[profile] gram launches by (B, active lanes, P, n, route, pixel '
        'segments), most frequent first:')
    for key, count in hist.most_common():
        say(f'[profile]   {key}: {count}')
    by_segments = collections.Counter()
    for key, count in hist.items():
        by_segments[key[-1]] += count
    say(f'[profile] launches by pixel segments: {dict(sorted(by_segments.items()))}')
    if not records or gram_ms <= 0:
        fail('profile: no gram kernel in the profiled run')


def phase_main_path():
    from superdsm_tpu_torch.dsm import gram
    g, n = make_image(0)
    _, _, _, timings, seconds = _segment(g, 12)
    say(f'[main] cold run: {seconds:.2f} s '
        f'({ {k: round(v, 3) for k, v in timings.items()} })')
    gram.reset_launch_counts()
    data, seg, _, timings, seconds = _segment(g, 12)
    launches = dict(gram.LAUNCHES)
    n_obj = len(data['postprocessed_objects'])
    say(f'[main] timed run: {seconds:.2f} s, {n_obj} objects '
        f'(field has {n} nuclei); stage seconds '
        f'{ {k: round(v, 3) for k, v in timings.items()} }')
    say(f'[main] gram launches per route: {launches}')
    if any(launches[r] == 0 for r in ('dense', 'triangle', 'banded')):
        fail('the main path left a float32 gram route unlaunched')
    if any(v for r, v in launches.items() if r.endswith('pass')):
        fail('the default knobs launched a reduced-precision gram')
    if n_obj == 0:
        fail('no objects segmented')
    _match(seg, BENCH_GOLDEN, 1)
    phase_profile(g)
    return launches


def _leaves(entries, prefix=''):
    """``(key/path, value)`` of every leaf of a nested config dict."""
    for key, value in entries.items():
        if isinstance(value, dict):
            yield from _leaves(value, f'{prefix}{key}/')
        else:
            yield f'{prefix}{key}', value


def phase_real_crop():
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.io import imread
    g = imread(NIH3T3_PNG).astype(np.float64)
    t0 = time.time()
    cfg_ref, scale = T.automation.create_config(T.create_default_pipeline(),
                                                T.Config(), g)
    say(f'[nih3t3] estimated scale {scale!r} ({time.time() - t0:.2f} s, '
        f'expected {NIH3T3_SCALE!r})')
    if not abs(scale / NIH3T3_SCALE - 1.0) <= 1e-9:
        fail(f'nih3t3: estimated scale {scale!r} != {NIH3T3_SCALE!r}')
    data, seg, cfg, _, seconds = _segment(g, None)
    # the stages add their defaults to the config they return; every entry
    # the estimated scale set must be there unchanged
    if any(cfg[key] != value for key, value in _leaves(cfg_ref.entries)):
        fail('nih3t3: the entry point configured another scale')
    say(f'[nih3t3] {seconds:.2f} s through the default entry point (no '
        f'AF_scale), {len(data["postprocessed_objects"])} objects')
    matched, total = _match(seg, NIH3T3_CSV, 0)
    if matched != total:
        fail(f'nih3t3: {matched}/{total} objects matched')


def knob_run():
    """Child of phase 6: the bench field at ``AF_scale=12`` under the
    precision knobs of this process's environment, cold and then timed;
    prints one JSON line with the timed run's launches, objects, matches
    and seconds."""
    sys.path.insert(0, REPO)
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.dsm import gram
    T.set_device('cuda')
    g, _ = make_image(0)
    _segment(g, 12)
    gram.reset_launch_counts()
    data, seg, _, _, seconds = _segment(g, 12)
    launches = dict(gram.LAUNCHES)
    matched, total = _match(seg, BENCH_GOLDEN)
    print(json.dumps(dict(passes=gram.GRAM_PASSES, hybrid=gram.HYBRID_ITERS,
                          launches=launches, seconds=seconds, matched=matched,
                          total=total,
                          objects=len(data['postprocessed_objects']))), flush=True)


def phase_knobs():
    """Phase 6; returns each route's launch count from its knob run."""
    launches = {}
    for env, routes in KNOB_RUNS:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--knob-run'], env={**os.environ, **env},
                              capture_output=True, text=True, timeout=400)
        tag = ' '.join(f'{k}={v}' for k, v in env.items())
        if proc.returncode != 0:
            fail(f'knob run {tag} exited {proc.returncode}:\n'
                 f'{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}')
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        say(f'[knobs] {tag}: {out["objects"]} objects, {out["matched"]}/'
            f'{out["total"]} matched against the golden (not gated), timed run '
            f'{out["seconds"]:.2f} s; launches '
            f'{ {k: v for k, v in out["launches"].items() if v} }')
        for route in routes:
            if out['launches'][route] == 0:
                fail(f'knob run {tag} did not launch route {route}')
            launches[route] = out['launches'][route]
    return launches


# ---------------------------------------------------------------------------
# phases 7 and 8
# ---------------------------------------------------------------------------

BENCH_SEEDS = (0, 1, 2, 3)
#: Changed by ``bench/post`` against ``bench`` (a postprocess-only change).
POST_CHANGE = {'postprocess': {'max_eccentricity': 0.98}}


def _write_json(path, value):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as fout:
        json.dump(value, fout)


def make_task_tree(root):
    """The batch tree of phase 7: ``bench/``, ``bench/post/``, ``nih3t3/``."""
    from superdsm_tpu_torch.io import imsave
    os.makedirs(os.path.join(root, 'images'))
    for seed in BENCH_SEEDS:
        g, _ = make_image(seed)
        g16 = np.round((g - g.min()) / (g.max() - g.min()) * 65535).astype(np.uint16)
        imsave(os.path.join(root, 'images', f'bench-{seed}.png'), g16)
    outputs = dict(seg_pathpattern='seg/%d.png', overlay_pathpattern='overlay/%d.png',
                   adj_pathpattern='adj/%d.png')
    _write_json(os.path.join(root, 'bench', 'task.json'), dict(
        runnable=True, file_ids=list(BENCH_SEEDS),
        img_pathpattern=os.path.join(root, 'images', 'bench-%d.png'),
        config={'AF_scale': 12}, **outputs))
    _write_json(os.path.join(root, 'bench', 'post', 'task.json'), dict(
        runnable=True, config=POST_CHANGE))
    _write_json(os.path.join(root, 'nih3t3', 'task.json'), dict(
        runnable=True, file_ids=['glare'],
        img_pathpattern=NIH3T3_PNG.replace('glare', '%s'),
        seg_pathpattern='seg/%s.png'))


def _read_seg(path):
    from superdsm_tpu_torch.io import imread
    return imread(path)


def _holds_tensor(value, seen=None):
    import torch
    seen = set() if seen is None else seen
    if id(value) in seen:
        return False
    seen.add(id(value))
    if isinstance(value, torch.Tensor):
        return True
    children = value.values() if isinstance(value, dict) else \
        value if isinstance(value, (list, tuple, set, frozenset)) else \
        vars(value).values() if hasattr(value, '__dict__') else ()
    return any(_holds_tensor(child, seen) for child in children)


def _run_batch_in_process(root, threads):
    """``run_cli`` on ``bench`` in this process; returns the seconds."""
    import torch
    from superdsm_tpu_torch.batch import run_cli
    os.environ['SUPERDSM_TPU_TASK_THREADS'] = str(threads)
    t0 = time.time()
    run_cli([root, '--run', '--no-fork', '--force', '--fresh', '--task', 'bench',
             '--verbosity', '-1', '--report', os.path.join(root, 'status')])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    os.environ.pop('SUPERDSM_TPU_TASK_THREADS')
    return seconds


def phase_deadline_fetch():
    """The solve seam's deadline copy on a busy non-default stream."""
    import torch
    from superdsm_tpu_torch.dsm import batching
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x = torch.full((1 << 16,), 1.0, device='cuda')
    stream.synchronize()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(2_000_000_000)  # about a second
        x.fill_(7.0)
        t0 = time.time()
        try:
            batching._fetch_with_deadline([x], 0.1)
            fail('deadline fetch: no SolveTimeout while the producer was busy')
        except batching.SolveTimeout:
            say(f'[batch] deadline fetch: SolveTimeout after '
                f'{time.time() - t0:.3f} s while the stream was busy')
    stream.synchronize()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1_000_000_000)
        x.fill_(9.0)
        t0 = time.time()
        (host,) = batching._fetch_with_deadline([x], 60)
    if not (host == 9.0).all():
        fail(f'deadline fetch returned {np.unique(host)}, not the values the '
             "caller's stream wrote (9.0)")
    say(f'[batch] deadline fetch: the caller stream\'s values after '
        f'{time.time() - t0:.3f} s')


def phase_batch(root):
    """Phase 7 (its launch counts are printed, not put in the kernel
    table)."""
    from superdsm_tpu_torch.dsm import gram
    make_task_tree(root)
    n = len(BENCH_SEEDS)
    serial_s = _run_batch_in_process(root, 1)
    serial = {seed: _read_seg(os.path.join(root, 'bench', 'seg', f'{seed}.png'))
              for seed in BENCH_SEEDS}
    gram.reset_launch_counts()
    threaded_s = _run_batch_in_process(root, 3)
    launches = dict(gram.LAUNCHES)
    say(f'[batch] bench/ ({n} images of 520x696): serial {serial_s:.2f} s = '
        f'{n / serial_s:.3f} images/s; 3 threads {threaded_s:.2f} s = '
        f'{n / threaded_s:.3f} images/s')
    with open(os.path.join(root, 'bench', '.timings.json')) as fin:
        timings = json.load(fin)
    say(f'[batch] stage seconds of image 0 in the threaded run: '
        f'{ {k: round(v, 3) for k, v in timings["0"].items()} }')
    say(f'[batch] gram launches of the threaded run: {launches}')
    if any(launches[r] == 0 for r in ('dense', 'triangle', 'banded')):
        fail('the threaded batch run left a float32 gram route unlaunched')
    validate = _validate_module()
    for seed in BENCH_SEEDS:
        seg = _read_seg(os.path.join(root, 'bench', 'seg', f'{seed}.png'))
        if seg.shape != (520, 696):
            fail(f'bench seg {seed}: shape {seg.shape}')
        matched, spurious, missing = validate.match_rows(
            validate.summarize_label_map(seg),
            validate.summarize_label_map(serial[seed]), center_tol=3.0, size_tol=0.1)
        say(f'[batch] seed {seed}: threaded vs serial seg map bitwise equal: '
            f'{bool(np.array_equal(seg, serial[seed]))}; {matched} matched, '
            f'spurious {spurious}, missing {missing}')
        if len(spurious) > 1 or len(missing) > 1:
            fail(f'bench seed {seed}: threaded seg map disagrees with the serial one')
    phase_deadline_fetch()

    # (b) the CLI as a user runs it: a fresh process, one fork per task
    t0 = time.time()
    proc = subprocess.run([sys.executable, '-m', 'superdsm_tpu_torch.batch', root,
                           '--run', '--task', 'nih3t3', '--task', 'bench/post',
                           '--report', os.path.join(root, 'status')],
                          cwd=REPO, capture_output=True, text=True, timeout=400,
                          # serial, so the log shows every stage each file runs
                          env={**os.environ, 'SUPERDSM_TPU_TASK_THREADS': '1'})
    say(f'[batch] forked CLI run (nih3t3, bench/post): exit {proc.returncode}, '
        f'{time.time() - t0:.2f} s')
    if proc.returncode != 0:
        fail(f'forked batch run exited {proc.returncode}:\n{proc.stdout[-4000:]}\n'
             f'{proc.stderr[-4000:]}')
    post_log = proc.stdout.split('Entering task: bench/post')[1].split(
        'Entering task:')[0]
    pickups = [line.strip() for line in post_log.splitlines()
               if 'Picking up from' in line]
    stages = [name for name in ('preprocess', 'c2f-region-analysis',
                                'global-energy-minimization', 'postprocess')
              if f'Starting stage "{name}"' in post_log]
    say(f'[batch] bench/post: {pickups}; stages run: {stages}')
    if pickups != ['Picking up from: bench/data.dill.gz (postprocess)'] or \
            stages != ['postprocess']:
        fail('bench/post did not pick up at postprocess')
    for seed in BENCH_SEEDS:
        if _read_seg(os.path.join(root, 'bench', 'post', 'seg',
                                  f'{seed}.png')).shape != (520, 696):
            fail(f'bench/post seg {seed}: wrong shape')
    matched, total = _match(_read_seg(os.path.join(root, 'nih3t3', 'seg', 'glare.png')),
                            NIH3T3_CSV, 0)
    if matched != total:
        fail(f'nih3t3 through the batch CLI: {matched}/{total} objects matched')
    # a pickup at postprocess writes no results (the on-disk contract), so
    # bench/post's data is the result it picked up: bench/data.dill.gz
    for task in ('nih3t3', 'bench'):
        with gzip.open(os.path.join(root, task, 'data.dill.gz'), 'rb') as fin:
            data = pickle.load(fin)
        if _holds_tensor(data):
            fail(f'{task}/data.dill.gz holds a torch.Tensor')
        say(f'[batch] {task}/data.dill.gz: {len(data)} entries, no torch.Tensor')


def phase_export(root):
    """Phase 8."""
    from superdsm_tpu_torch.io import imread
    shape = imread(NIH3T3_PNG).shape
    for mode in ('seg', 'adj'):
        t0 = time.time()
        proc = subprocess.run([sys.executable, '-m', 'superdsm_tpu_torch.export',
                               root, 'nih3t3', '--mode', mode],
                              cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f'export --mode {mode} exited {proc.returncode}:\n'
                 f'{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}')
        outdir = os.path.join(root, 'nih3t3', f'export-{mode}')
        files = sorted(os.listdir(outdir))
        expected = ['glare.png'] + (['ymap_legend.png'] if mode == 'adj' else [])
        if files != expected:
            fail(f'export --mode {mode} wrote {files}, expected {expected}')
        img = imread(os.path.join(outdir, 'glare.png'), as_gray=False)
        if img.shape[:2] != shape:
            fail(f'export --mode {mode}: image {img.shape}, expected {shape}')
        say(f'[export] --mode {mode}: exit 0, {files}, {img.shape} '
            f'({time.time() - t0:.2f} s)')


# ---------------------------------------------------------------------------
# --ab: two checkouts compared on one card
# ---------------------------------------------------------------------------

#: Timed runs of each bench seed in each ``--ab`` turn (after one cold
#: run of seed 0).
AB_REPS = 2


def _ab_kernel_ms(root, shape, launches):
    """Device ms of each ``(passes, full)`` launch at a phase-3 shape, each
    held against the plain version first; keyed by route, shape and active
    lanes."""
    from superdsm_tpu_torch.dsm import gram
    Bf, s, yv, w, active, band = _phase3_inputs(*shape)
    B, P, n, _, n_active = shape
    kernel_ms = {}
    for passes, full in launches:
        band_ = None if full else band
        route = gram.route_for(n, band_ is not None, passes, full)
        tag = f'{route} ({B}, {P}, {n}), {n_active} active'

        def kernel():
            return gram.grad_hess_kernel(Bf, s, yv, w, active, band_,
                                         passes=passes, full=full)

        g, H = kernel()
        _, _, ok = _agreement(passes, passes != 6 and not full, Bf, s, yv, w,
                              active, g, H)
        if not ok:
            fail(f'{root}: {tag}: kernel disagrees with the plain version')
        del g, H
        kernel_ms[tag] = _event_ms(kernel)
    return kernel_ms


def ab_run(root):
    """One ``--ab`` turn: the port of the checkout at ``root``; prints one
    JSON line last."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.dsm import batching, gram
    if not T.__file__.startswith(os.path.join(root, 'superdsm_tpu_torch')):
        fail(f'--ab-run imported {T.__file__}, not the package under {root}')
    T.set_device('cuda')
    gram.build()
    # the float32 launches first, so that no bf16 launch (whose scratch
    # differs between checkouts) has touched the allocator before them
    kernel_ms = {}
    for f32 in (True, False):
        for shape, launches in _cases():
            launches = [(p, f) for p, f in launches if (p == 6) == f32]
            if launches:
                kernel_ms.update(_ab_kernel_ms(root, shape, launches))
                torch.cuda.empty_cache()
    images = {seed: make_image(seed)[0] for seed in BENCH_SEEDS}
    _segment(images[0], 12)
    runs = []
    for rep in range(AB_REPS):
        for seed, image in images.items():
            # marks the run in SDSM_SOLVE_TELEMETRY's per-round lines
            print(f'[ab-run] seed {seed} rep {rep}', file=sys.stderr, flush=True)
            gram.reset_launch_counts()
            acct = batching.device_accounting()
            data, seg, _, timings, seconds = _segment(image, 12)
            after = batching.device_accounting()
            runs.append(dict(
                seed=seed, seconds=seconds,
                gem=timings['global-energy-minimization'],
                **{k: after[k] - acct[k] for k in ('lane_iters', 'calls',
                                                   'canonical_lanes')},
                launches={k: v for k, v in gram.LAUNCHES.items() if v},
                objects=len(data['postprocessed_objects'])))
            if seed == 0:
                matched, total = _match(seg, BENCH_GOLDEN)
    print(json.dumps(dict(root=root, kernel_ms=kernel_ms, runs=runs,
                          matched=matched, total=total)), flush=True)


def ab(roots):
    """``--ab ROOT_A ROOT_B``: the turns A, B, B, A, one process each."""
    card = phase_environment()
    turns = {root: [] for root in roots}
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--ab-run', root], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            fail(f'--ab-run {root} exited {proc.returncode}:\n'
                 f'{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}')
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        turns[root].append(out)
        say(f'[ab] {root}: kernel ms '
            f'{ {k: round(v, 4) for k, v in out["kernel_ms"].items()} }')
        for run in out['runs']:
            say(f'[ab] {root}: seed {run["seed"]}: {run["seconds"]:.3f} s '
                f'(gem {run["gem"]:.3f}), {run["lane_iters"]} lane iterations, '
                f'{run["calls"]} solve calls, {run["canonical_lanes"]} lanes '
                f're-solved canonically, gram launches {run["launches"]}, '
                f'{run["objects"]} objects')
        say(f'[ab] {root}: seed 0 {out["matched"]}/{out["total"]} matched the '
            f'golden')
    for root, outs in turns.items():
        for seed in BENCH_SEEDS:
            runs = [run for out in outs for run in out['runs'] if run['seed'] == seed]
            seconds = [run['seconds'] for run in runs]
            iters = sorted({run['lane_iters'] for run in runs})
            say(f'[ab] {root}: seed {seed}: s/image median '
                f'{np.median(seconds):.3f}, min {min(seconds):.3f}, max '
                f'{max(seconds):.3f} over {len(seconds)} runs; lane iterations '
                f'{iters}')
        for tag in outs[0]['kernel_ms']:
            turns_ms = [out['kernel_ms'][tag] for out in outs]
            say(f'[ab] {root}: {tag}: kernel ms mean of the turns '
                f'{np.mean(turns_ms):.4f} (turns {[round(t, 4) for t in turns_ms]})')
    a, b = roots
    for tag in turns[a][0]['kernel_ms']:
        ms_a = np.mean([out['kernel_ms'][tag] for out in turns[a]])
        ms_b = np.mean([out['kernel_ms'][tag] for out in turns[b]])
        say(f'[ab] {tag}: {ms_a:.4f} -> {ms_b:.4f} ms ({ms_a / ms_b:.2f}x)')
    say(card)


def main():
    card = phase_environment()
    import torch
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.dsm import gram
    T.set_device('cuda')
    build_s = gram.build()
    for src in gram.BUILD_LOG:
        gram._load(src)
    say(f'[build] nvcc sm_90a build of {", ".join(gram.BUILD_LOG)} '
        f'(one nvcc each, together): {build_s:.2f} s')
    for src, log in gram.BUILD_LOG.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                say(f'[build] {src}: {line.strip()}')
    kernels = phase_kernels()
    launches = phase_main_path()
    phase_real_crop()
    launches.update(phase_knobs())
    t0 = time.time()
    root = tempfile.mkdtemp(prefix='sdsm-batch-')
    try:
        phase_batch(root)
        phase_export(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(f'[batch] phases 7-8: {time.time() - t0:.2f} s wall')
    table = [dict(name=f'{os.path.basename(_source(route))[:-3]}/{route}',
                  route='cuda', source=_source(route), replaces=REPLACES[route],
                  launches=launches[route], **kernels[route])
             for route in REPLACES]
    say(card)  # the card's name and power limit, as nvidia-smi gives them
    say(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    if sys.argv[1:] == ['--knob-run']:
        knob_run()
    elif sys.argv[1:2] == ['--ab-run'] and len(sys.argv) == 3:
        ab_run(sys.argv[2])
    elif sys.argv[1:2] == ['--ab'] and len(sys.argv) == 4:
        ab(sys.argv[2:])
    else:
        main()
