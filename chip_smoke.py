#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``superdsm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
result lines):

1. environment: torch/CUDA versions, whether triton imports, the card's name
   and power limit; exits non-zero without CUDA or without the package;
2. build: compiles ``superdsm_tpu_torch/csrc/gram_grad_hess.cu`` with nvcc
   for sm_90a and prints the build seconds;
3. the gram kernel against its plain PyTorch version on the card at the
   main path's shapes, with feature matrices built from real row-major disk
   regions and a quarter of the lanes frozen: rtol = atol = 1e-4, banded
   mode bitwise equal to dense mode, frozen lanes exactly zero, two runs
   bitwise equal; times are CUDA-event medians of 10 launches;
4. the main path: ``automation.process_image`` on seed 0 of the bench's
   520x696 synthetic nuclei field at ``AF_scale=12`` (cold, then timed with
   the kernel launch counts), the label map held against the JAX-CPU golden
   ``tests/data/torch_port/bench-seed0.csv`` (center 3 px, size 10%, at
   most one unmatched object);
5. the real NIH3T3 crop ``tests/regression/data/nih3t3-glare.png`` at the
   JAX estimator's scale (30 sqrt 2 = 42.4264...), all 5 objects matched
   against ``tests/regression/expected/nih3t3/nih3t3-glare.csv``.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: AF_scale of the NIH3T3 crop: the JAX package's blob-detector estimate
#: (``superdsm_tpu.automation._estimate_scale`` on the CPU), 30 * sqrt(2).
NIH3T3_SCALE = 42.426406871192846

#: Main-path shapes of phase 3: (B, P, n, route) — the n = 128, 256 and
#: 512 bucket chunks of the bench field.
KERNEL_SHAPES = [(64, 8192, 128, 'dense'), (32, 12288, 256, 'triangle'),
                 (16, 32768, 512, 'banded')]
#: The Pallas kernel each route replaces.
REPLACES = {'dense': 'superdsm_tpu/dsm/pallas_kernels.py:436',
            'triangle': 'superdsm_tpu/dsm/pallas_kernels.py:292',
            'banded': 'superdsm_tpu/dsm/pallas_kernels.py:346'}
RTOL = ATOL = 1e-4


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


def _event_ms(fn, reps=10):
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


def phase_kernels():
    import torch
    from superdsm_tpu_torch.dsm import gram
    dev = torch.device('cuda')
    rows = {}
    for B, P, n, route in KERNEL_SHAPES:
        rng = np.random.RandomState(n)
        lanes = [_lane_features(rng, P, n - 6) for _ in range(B)]
        Bf, s, yv, w = (torch.stack(t).contiguous() for t in zip(*lanes))
        del lanes
        active = torch.ones(B, dtype=torch.int32, device=dev)
        active[::4] = 0  # a quarter of the lanes frozen
        band = gram.band_ranges(Bf, w) if route == 'banded' else None
        torch.cuda.synchronize()

        g, H = gram.grad_hess_kernel(Bf, s, yv, w, active, band)
        torch.cuda.synchronize()
        g2, H2 = gram.grad_hess_kernel(Bf, s, yv, w, active, band)
        torch.cuda.synchronize()
        if not (torch.equal(g, g2) and torch.equal(H, H2)):
            fail(f'{route}: two runs differ (not reproducible)')
        g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active)
        torch.cuda.synchronize()
        frozen = active == 0
        if g[frozen].any() or H[frozen].any():
            fail(f'{route}: frozen lanes are not exactly zero')
        err = max(float((g - g_ref).abs().max()), float((H - H_ref).abs().max()))
        excess = max(float(((g - g_ref).abs() - RTOL * g_ref.abs()).max()),
                     float(((H - H_ref).abs() - RTOL * H_ref.abs()).max()))
        say(f'[kernel] {route} ({B}, {P}, {n}): max_abs_err {err:.3e}, '
            f'max(|d| - rtol|ref|) {excess:.3e} (atol {ATOL})')
        if not (torch.isfinite(g).all() and torch.isfinite(H).all()):
            fail(f'{route}: non-finite output')
        if excess > ATOL:
            fail(f'{route}: kernel disagrees with the plain version')
        if band is not None:
            g_d, H_d = gram.grad_hess_kernel(Bf, s, yv, w, active, None)
            torch.cuda.synchronize()
            if not (torch.equal(g, g_d) and torch.equal(H, H_d)):
                fail('banded mode is not bitwise equal to dense mode')
            say('[kernel] banded mode bitwise equals dense-triangle mode')
            dense_ms = _event_ms(lambda: gram.grad_hess_kernel(Bf, s, yv, w, active, None))
            say(f'[kernel] dense-triangle mode at the same shape: {dense_ms:.3f} ms')
        ms = _event_ms(lambda: gram.grad_hess_kernel(Bf, s, yv, w, active, band))
        plain_ms = _event_ms(lambda: gram.grad_hess_plain(Bf, s, yv, w, active))
        say(f'[kernel] {route}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms '
            f'(CUDA events, median of 10)')
        rows[route] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del Bf, s, yv, w, g, H, g2, H2, g_ref, H_ref
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


def read_gray_png(path):
    """Decodes an 8-bit grayscale, non-interlaced PNG (no imaging library
    needed)."""
    with open(path, 'rb') as fp:
        data = fp.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f'{path}: not a PNG')
    pos, idat, hdr = 8, b'', None
    while pos < len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', chunk)
        elif kind == b'IDAT':
            idat += chunk
        elif kind == b'IEND':
            break
    width, height, depth, color, _, _, interlace = hdr
    if (depth, color, interlace) != (8, 0, 0):
        raise ValueError(f'{path}: only 8-bit grayscale non-interlaced PNGs')
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, width + 1)
    out = np.zeros((height, width), np.int32)
    prev = np.zeros(width, np.int32)
    for r in range(height):
        ftype, line = raw[r, 0], raw[r, 1:].astype(np.int32)
        cur = np.zeros(width, np.int32)
        for c in range(width):
            a = cur[c - 1] if c else 0
            b = prev[c]
            d = prev[c - 1] if c else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - d
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - d)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else d)
            cur[c] = (line[c] + pred) & 0xFF
        out[r] = prev = cur
    return out.astype(np.uint8)


def _segment(g, scale):
    import torch
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.output import get_output
    from superdsm_tpu_torch.render import rasterize_labels
    t0 = time.time()
    data, _, timings = T.automation.process_image(
        T.create_default_pipeline(), T.Config({'AF_scale': scale}), g,
        out=get_output(None).derive(muted=True))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    seg = rasterize_labels(data)
    if seg.shape != np.asarray(g).shape:
        fail(f'label map shape {seg.shape} != image shape {np.asarray(g).shape}')
    return data, seg, timings, seconds


def _validate_module():
    """``tests/regression/validate.py`` loaded by file path (a ``tests``
    package installed elsewhere would shadow the repository's)."""
    import importlib.util
    path = os.path.join(REPO, 'tests', 'regression', 'validate.py')
    spec = importlib.util.spec_from_file_location('_sdsm_validate', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _match(seg, expected_csv, max_unmatched):
    validate = _validate_module()
    rows = validate.summarize_label_map(seg)
    expected = validate.load_csv(expected_csv)
    matched, spurious, missing = validate.match_rows(
        rows, expected, center_tol=3.0, size_tol=0.1)
    say(f'[match] {matched}/{len(expected)} matched, spurious {spurious}, '
        f'missing {missing}')
    if len(spurious) > max_unmatched or len(missing) > max_unmatched:
        fail(f'label map disagrees with {os.path.relpath(expected_csv, REPO)}')
    return matched, len(expected)


def phase_main_path():
    from superdsm_tpu_torch.dsm import gram
    g, n = make_image(0)
    _, _, timings, seconds = _segment(g, 12)
    say(f'[main] cold run: {seconds:.2f} s '
        f'({ {k: round(v, 3) for k, v in timings.items()} })')
    gram.reset_launch_counts()
    data, seg, timings, seconds = _segment(g, 12)
    launches = dict(gram.LAUNCHES)
    n_obj = len(data['postprocessed_objects'])
    say(f'[main] timed run: {seconds:.2f} s, {n_obj} objects '
        f'(field has {n} nuclei); stage seconds '
        f'{ {k: round(v, 3) for k, v in timings.items()} }')
    say(f'[main] gram launches per route: {launches}')
    if sum(launches.values()) == 0:
        fail('the main path launched no gram kernel')
    if n_obj == 0:
        fail('no objects segmented')
    _match(seg, os.path.join(REPO, 'tests/data/torch_port/bench-seed0.csv'), 1)
    return launches


def phase_real_crop():
    g = read_gray_png(os.path.join(REPO, 'tests/regression/data/nih3t3-glare.png'))
    data, seg, timings, seconds = _segment(g.astype(np.float64), NIH3T3_SCALE)
    say(f'[nih3t3] {seconds:.2f} s, {len(data["postprocessed_objects"])} objects')
    matched, total = _match(seg, os.path.join(
        REPO, 'tests/regression/expected/nih3t3/nih3t3-glare.csv'), 0)
    if matched != total:
        fail(f'nih3t3: {matched}/{total} objects matched')


def main():
    card = phase_environment()
    import torch
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.dsm import gram
    T.set_device('cuda')
    build_s = gram.build()
    gram._load()
    say(f'[build] nvcc sm_90a build of gram_grad_hess.cu: {build_s:.2f} s')
    for line in gram.BUILD_LOG.splitlines():
        if 'registers' in line or 'spill' in line or 'smem' in line:
            say(f'[build] {line.strip()}')
    kernels = phase_kernels()
    launches = phase_main_path()
    phase_real_crop()
    table = [dict(name=f'gram_grad_hess/{route}', route='cuda',
                  source='superdsm_tpu_torch/csrc/gram_grad_hess.cu',
                  replaces=REPLACES[route], launches=launches[route],
                  **kernels[route]) for route in REPLACES]
    say(card)  # the card's name and power limit, as nvidia-smi gives them
    say(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
