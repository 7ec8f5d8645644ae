"""The bit-packed mask transfer of the port against the JAX package's and
against the port's own coordinate transfer, on the CPU.

- ``solver._mask_to_pix`` gives the JAX package's coordinates exactly, on
  the edge cases of ``tests/test_solver.py`` (diagonal, single pixel, full
  rectangle, random sets) and on random masks at several buckets and batch
  sizes.
- ``Problem.fits_mask`` decides the cases of ``tests/test_mask_guard.py``
  as the JAX package's ``Problem`` does, and ``packed_mask`` is its bytes.
- ``_solve_{poly,dsm}_packed_mask`` give bitwise the outputs of the port's
  coordinate programs, and the JAX package's mask programs' energies to
  the tolerances of ``tests/test_torch_solver.py`` (rtol 1e-4 on
  converged lanes, foregrounds on >= 99% of the pixels).
- ``solve_problems`` on a small field: ``SDSM_MASK_TRANSFERS=1`` bitwise
  ``=0``; a problem that does not fit goes by coordinates beside the
  others' masks; the mask kinds split over a (2, 1) pipeline mesh of CPU
  devices bitwise the coordinate kinds under the same mesh (the
  counterpart of ``tests/test_parallel.py``'s mesh-sharded mask program).
"""

import jax
import numpy as np
import pytest
import torch

from superdsm_tpu.dsm import batching as jbatching
from superdsm_tpu.dsm import solver as jsolver
from superdsm_tpu.image import Image as JImage

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import batching, solver
from superdsm_tpu_torch.dsm import mask as mask_mod
from superdsm_tpu_torch.image import Image
from superdsm_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with T.use_device('cpu'):
        yield


def _edge_masks():
    rng = np.random.RandomState(7)
    single = np.zeros((5, 9), bool)
    single[3, 7] = True
    cases = [('diagonal', np.eye(30, 40, dtype=bool)), ('single', single),
             ('full', np.ones((12, 20), bool))]
    cases += [(f'random{i}', rng.rand(25, 31) < rng.uniform(0.05, 0.9)) for i in range(4)]
    return cases


def _packed_rows(masks, pb):
    B = len(masks)
    MB = np.zeros((B, (pb * solver.MASK_BITS_PER_PIXEL) // 8), np.uint8)
    WD = np.ones(B, np.int32)
    CNT = np.zeros(B, np.int32)
    for j, m in enumerate(masks):
        if m is None:  # a padding row
            continue
        pm_ = np.packbits(m)
        MB[j, :len(pm_)] = pm_
        WD[j] = m.shape[1]
        CNT[j] = int(m.sum())
    return MB, WD, CNT


def _decode_both(MB, WD, CNT, pb):
    mine = solver._mask_to_pix(torch.from_numpy(MB), torch.from_numpy(WD),
                               torch.from_numpy(CNT), pb).numpy()
    theirs = np.asarray(jsolver._mask_to_pix(MB, WD, CNT, pb))
    return mine, theirs


@pytest.mark.parametrize('label,mask', _edge_masks(), ids=[c[0] for c in _edge_masks()])
def test_mask_to_pix_edge_cases_match_jax(label, mask):
    pts = np.argwhere(mask)
    n = len(pts)
    pb = 128
    while pb < n:
        pb *= 2
    if mask.size > pb * solver.MASK_BITS_PER_PIXEL:
        pb *= 2 ** int(np.ceil(np.log2(mask.size / (pb * solver.MASK_BITS_PER_PIXEL))))
    mine, theirs = _decode_both(*_packed_rows([mask], pb), pb)
    assert mine.dtype == np.int32
    assert np.array_equal(mine, theirs)
    assert np.array_equal(mine[0, :n], pts)
    assert np.all(mine[0, n:] == 0)


@pytest.mark.parametrize('pb,B', [(256, 1), (512, 3), (2048, 5)])
def test_mask_to_pix_random_batches_match_jax(pb, B):
    rng = np.random.RandomState(pb + B)
    masks = []
    for _ in range(B):
        h = rng.randint(1, 40)
        w = rng.randint(1, max(2, (pb * solver.MASK_BITS_PER_PIXEL) // h))
        m = rng.rand(h, w) < rng.uniform(0.05, 0.6)
        while m.sum() > pb:
            m &= rng.rand(h, w) < 0.5
        masks.append(m if m.any() else None)
    MB, WD, CNT = _packed_rows(masks, pb)
    mine, theirs = _decode_both(MB, WD, CNT, pb)
    assert np.array_equal(mine, theirs)
    for j, m in enumerate(masks):
        if m is not None:
            assert np.array_equal(mine[j, :CNT[j]], np.argwhere(m))


def _brev32(x):
    """``__brev`` of uint32 values."""
    out = np.zeros_like(x)
    for i in range(32):
        out |= ((x >> np.uint32(i)) & np.uint32(1)) << np.uint32(31 - i)
    return out


def _kernel_decode(MB, WD, CNT, pb, cluster=8, threads=256):
    """``mask_to_pix_kernel``'s schedule in numpy (``csrc/mask_ops.cu``):
    a cluster of ``cluster`` blocks a row, block q an equal share of the
    row's 16-byte chunks; a chunk's four little-endian words with their
    bits reversed and their bytes swapped (``__brev``, ``__byte_perm``),
    so that bit i of word j is position 128 c + 32 j + i; pass 1 the
    block's ``__popc`` sum, the blocks' totals giving each its offset and
    the row's total; pass 2 in tiles of ``threads`` chunks, each chunk's
    exclusive offset in its tile, each set bit written at its rank while
    the rank is below ``pb``, its (r, c) carried from the chunk's first
    position (``RowCol``: one division, then c += the step, and while c
    >= wd, c -= wd and r += 1); the slots from the total to ``pb`` in
    strided shares. Returns the output and how often each slot was
    written."""
    B, nbytes = MB.shape
    chunks = -(-nbytes // 16)
    padded = np.zeros((B, chunks * 16), np.uint8)
    padded[:, :nbytes] = MB
    words = padded.view('<u4').reshape(B, chunks, 4)
    words = _brev32(words.astype(np.uint32)).byteswap()
    counts = np.array([[sum(bin(int(v)).count('1') for v in c) for c in row] for row in words])
    out = np.full((B, pb, 2), -7, np.int32)
    writes = np.zeros((B, pb), np.int32)
    per = -(-chunks // cluster)

    def put(o, slot, rc):
        out[o, slot] = (0, 0) if slot >= CNT[o] else rc
        writes[o, slot] += 1

    def move(rc, p, q, wd):  # RowCol.move_to
        r, col = rc
        col += q - p
        while col >= wd:
            col -= wd
            r += 1
        return (r, col)
    for o in range(B):
        ranges = [(min(chunks, q * per), min(chunks, min(chunks, q * per) + per))
                  for q in range(cluster)]
        block_bits = [int(counts[o, b:e].sum()) for b, e in ranges]
        total = sum(block_bits)
        for q, (begin, end) in enumerate(ranges):
            offset = sum(block_bits[:q])
            for base in range(begin, end, threads):
                tile = counts[o, base:min(end, base + threads)]
                first = offset + np.concatenate([[0], np.cumsum(tile)[:-1]])
                for c, slot in zip(range(base, min(end, base + threads)), first):
                    p = c * 128
                    rc = (p // WD[o], p - (p // WD[o]) * WD[o])
                    for j in range(4):
                        v = int(words[o, c, j])
                        while v and slot < pb:
                            pos = c * 128 + 32 * j + (v & -v).bit_length() - 1
                            rc, p = move(rc, p, pos, WD[o]), pos
                            v &= v - 1
                            put(o, slot, rc)
                            slot += 1
                offset += int(tile.sum())
            nbits = nbytes * 8
            for t in range(threads):  # thread t's share
                for s in range(total + q * threads + t, pb, cluster * threads):
                    put(o, s, (nbits // WD[o], nbits - (nbits // WD[o]) * WD[o]))
    return out, writes


def _decode_cases():
    """(label, MB, WD, CNT, pb): random rows and the edge cases of the
    decode (an empty row, ``cnt`` below and above the set bits, more set
    bits than ``pb``, a row whose bits end in its last byte, a row length
    that is no multiple of 16 bytes)."""
    rng = np.random.RandomState(11)
    cases = []
    for pb, B in ((256, 3), (1024, 4), (24, 2)):
        nbytes = pb * solver.MASK_BITS_PER_PIXEL // 8
        MB = np.zeros((B, nbytes), np.uint8)
        WD, CNT = np.ones(B, np.int32), np.zeros(B, np.int32)
        for j in range(B):
            bits = rng.rand(nbytes * 8) < rng.uniform(0.02, 0.25)
            MB[j] = np.packbits(bits)
            WD[j] = rng.randint(1, 60)
            CNT[j] = min(int(bits.sum()), pb)
        cases.append((f'random pb={pb}', MB, WD, CNT, pb))
    pb = 128
    nbytes = pb * solver.MASK_BITS_PER_PIXEL // 8
    bits = np.zeros((6, nbytes * 8), bool)
    bits[1, rng.rand(nbytes * 8) < 0.1] = True  # cnt below its set bits
    bits[2, rng.rand(nbytes * 8) < 0.1] = True  # cnt above them
    bits[3, rng.rand(nbytes * 8) < 0.6] = True  # more set bits than pb
    bits[4, -3:] = True                         # ends in the last byte
    bits[5, ::5] = True                         # every fifth bit, cnt = pb
    n_set = bits.sum(1)
    CNT = np.array([0, n_set[1] - 5, n_set[2] + 9, pb, n_set[4], pb], np.int32)
    WD = np.array([1, 7, 13, 40, 64, 1], np.int32)
    cases.append(('edges', np.packbits(bits, axis=1), WD, CNT, pb))
    cases.append(('empty row, cnt > 0', np.zeros((1, nbytes), np.uint8), np.array([5], np.int32),
                  np.array([4], np.int32), pb))
    return cases


@pytest.mark.parametrize('cluster,threads', [(8, 256), (3, 2)])
@pytest.mark.parametrize('case', range(len(_decode_cases())),
                         ids=[c[0] for c in _decode_cases()])
def test_kernel_decode_schedule_is_mask_to_pix(case, cluster, threads):
    """The decode kernel's chunked schedule (its own geometry, and 3 blocks
    of 2 threads: many tiles a block) writes every slot once and gives
    ``_mask_to_pix``'s coordinates bit for bit."""
    _, MB, WD, CNT, pb = _decode_cases()[case]
    want = solver._mask_to_pix(torch.from_numpy(MB), torch.from_numpy(WD),
                               torch.from_numpy(CNT), pb).numpy()
    got, writes = _kernel_decode(MB, WD, CNT, pb, cluster, threads)
    assert np.all(writes == 1)
    assert np.array_equal(got, want)


def test_decode_takes_the_plain_version_on_the_cpu(monkeypatch):
    """``solver._decode_mask`` on CPU tensors is ``_mask_to_pix``; the
    kernel is never asked."""
    def refuse(*args):
        raise AssertionError('the kernel was launched for CPU tensors')
    monkeypatch.setattr(mask_mod, 'mask_to_pix_kernel', refuse)
    _, MB, WD, CNT, pb = _decode_cases()[0]
    args = (torch.from_numpy(MB), torch.from_numpy(WD), torch.from_numpy(CNT), pb)
    assert torch.equal(solver._decode_mask(*args), solver._mask_to_pix(*args))


@pytest.mark.parametrize('bad', ['cpu', '1-D mb', 'int8 mb', 'wd int64', 'cnt short',
                                 'pb < 0'])
def test_decode_kernel_raises_instead_of_falling_back(bad):
    """The kernel's wrapper raises on CPU tensors and on dtypes or shapes it
    does not take: there is no other route."""
    mb = torch.zeros((3, 64), dtype=torch.uint8)
    wd, cnt = torch.ones(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    pb = 128
    if bad == '1-D mb':
        mb = mb[0]
    elif bad == 'int8 mb':
        mb = mb.to(torch.int8)
    elif bad == 'wd int64':
        wd = wd.long()
    elif bad == 'cnt short':
        cnt = cnt[:2]
    elif bad == 'pb < 0':
        pb = -1
    with pytest.raises(ValueError):
        mask_mod.mask_to_pix_kernel(mb, wd, cnt, pb)
    assert mask_mod.LAUNCHES['mask_to_pix'] == 0


def _grid_pts(h, w):
    rr, cc = np.indices((h, w))
    return np.stack([rr.ravel(), cc.ravel()], axis=1)


def _guard_cases():
    reversed_ = _grid_pts(8, 8)[::-1]
    duplicate = _grid_pts(8, 8)
    duplicate[1] = duplicate[0]
    return [('rowmajor', _grid_pts(8, 8), None, True),
            ('capacity', _grid_pts(4, 4), (1024, 1024), False),
            ('unsorted', reversed_, None, False),
            ('duplicates', duplicate, None, False),
            ('out_of_crop', _grid_pts(8, 8), (8, 4), False)]


@pytest.mark.parametrize('label,pts,crop,fits', _guard_cases(),
                         ids=[c[0] for c in _guard_cases()])
def test_fits_mask_guard_cases(label, pts, crop, fits):
    def make(module):
        pts_ = np.asarray(pts, np.int32)
        p = module.Problem(pts=pts_, offset=np.zeros(2, np.int32), img_shape=(64, 64),
                           yv=np.linspace(-1, 1, len(pts_), dtype=np.float32),
                           sub=np.zeros((0, 2), np.int32))
        if crop is not None:
            p.crop_shape = crop
        return p
    mine, theirs = make(batching), make(jbatching)
    assert mine.fits_mask(2048) == theirs.fits_mask(2048) == fits
    assert mine.crop_area == theirs.crop_area
    if fits:
        assert np.array_equal(mine.packed_mask, theirs.packed_mask)


def test_make_problem_sets_the_crop_shape():
    rng = np.random.RandomState(2)
    H, W = 48, 60
    rr, cc = np.indices((H, W))
    mask = ((rr - 22) ** 2 + (cc - 31) ** 2) < 180
    img = rng.rand(H, W).astype(np.float32)
    mine = batching.make_problem(Image(model=img, mask=mask), smooth_amount=np.inf)
    theirs = jbatching.make_problem(JImage(model=img, mask=mask), smooth_amount=np.inf)
    assert mine.crop_shape == theirs.crop_shape
    assert np.array_equal(mine.packed_mask, theirs.packed_mask)
    bits = np.unpackbits(mine.packed_mask, count=mine.crop_area)
    w = mine.crop_shape[1]
    flat = np.flatnonzero(bits)
    assert np.array_equal(np.stack([flat // w, flat % w], 1), mine.pts.astype(np.int64))


@pytest.fixture(scope='module')
def packed_case():
    """One disk problem and a padding row at (pb, kb) = (1024, 26), packed
    in both formats (``tests/test_solver.py``'s program parity case)."""
    rng = np.random.RandomState(3)
    H, W = 48, 60
    rr, cc = np.indices((H, W))
    mask = ((rr - 22) ** 2 + (cc - 31) ** 2) < 180
    img = rng.rand(H, W).astype(np.float32) - 0.45
    p = batching.make_problem(Image(model=img, mask=mask), img_shape=(H, W),
                              smooth_amount=4.0, smooth_subsample=10)
    pb, kb = 1024, 26
    assert p.fits_mask(pb)
    MB = np.zeros((2, (pb * solver.MASK_BITS_PER_PIXEL) // 8), np.uint8)
    MB[0, :len(p.packed_mask)] = p.packed_mask
    WD = np.array([p.crop_shape[1], 1], np.int32)
    CNT = np.array([p.n_pixels, 0], np.int32)
    PIX = np.zeros((2, pb, 2), np.int16)
    PIX[0, :p.n_pixels] = p.pts
    OFF = np.zeros((2, 2), np.int32)
    OFF[0] = p.offset
    YQ = np.zeros((2, pb), np.int16)
    YQ[0, :p.n_pixels] = p.yq
    YS = np.array([p.yscale, 1.0], np.float32)
    denom = np.array([H - 1.0, W - 1.0], np.float32)
    k = p.n_deform
    SUB = np.full((2, kb, 2), -170, np.int16)
    SUB[0, :k] = p.sub
    KM = np.zeros((2, kb), np.float32)
    KM[0, :k] = 1.0
    dsm_tail = (SUB, KM, np.zeros((2, 6 + kb), np.float32), np.zeros(2, bool),
                np.full(2, 0.5, np.float32), 1.0, 40, 1e-5, 4.0, 16)
    common = (OFF, CNT, YQ, YS, denom)
    return dict(coords=(PIX,) + common, mask=(MB, WD) + common,
                poly_tail=(np.zeros((2, 6), np.float32), 40, 1e-5), dsm_tail=dsm_tail)


@pytest.mark.parametrize('kind', ['poly', 'dsm'])
def test_packed_mask_programs(packed_case, kind):
    tail = packed_case[f'{kind}_tail']
    coords_fn = getattr(solver, f'_solve_{kind}_packed')
    mask_fn = getattr(solver, f'_solve_{kind}_packed_mask')
    a = coords_fn(*packed_case['coords'], *tail)
    b = mask_fn(*packed_case['mask'], *tail)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    j = jax.device_get(getattr(jsolver, f'_solve_{kind}_packed_mask')(
        *packed_case['mask'], *tail))
    ix = batching._IDX[kind]
    conv = b[ix['conv']].numpy() & np.asarray(j[ix['conv']])
    assert conv[0]
    np.testing.assert_allclose(b[ix['f']].numpy()[conv], np.asarray(j[ix['f']])[conv],
                               rtol=1e-4)
    n = int(packed_case['mask'][3][0])
    fg_mine = solver.unpack_fg(b[ix['fg']].numpy()[0], n)
    fg_jax = solver.unpack_fg(np.asarray(j[ix['fg']])[0], n)
    assert (fg_mine == fg_jax).mean() >= 0.99


def _field():
    """Six blob problems that fit the mask and one sparse pixel subsample
    over a large box (the oversized-region pattern) that does not."""
    rng = np.random.RandomState(11)
    H, W = 96, 128
    rr, cc = np.indices((H, W))
    problems = []
    for k in range(6):
        m = ((rr - rng.randint(20, 70)) ** 2 + (cc - rng.randint(25, 100)) ** 2) \
            < rng.randint(60, 200)
        img = rng.rand(H, W).astype(np.float32) - 0.45
        problems.append(batching.make_problem(Image(model=img, mask=m), img_shape=(H, W),
                                              smooth_amount=4, smooth_subsample=8, tag=k))
    m_big = ((rr - 48) ** 2 + (cc - 64) ** 2) < 3600
    img = rng.rand(H, W).astype(np.float32) - 0.45
    big = batching.make_problem(Image(model=img, mask=m_big), img_shape=(H, W),
                                smooth_amount=4, smooth_subsample=8)
    sparse = batching.Problem(
        pts=np.ascontiguousarray(big.pts[::8]), offset=big.offset,
        img_shape=big.img_shape, yv=np.ascontiguousarray(big.yv[::8]),
        sub=big.sub, tag='sparse')
    return problems, sparse


def _solve(problems, monkeypatch, env, mesh=None, **kw):
    monkeypatch.setenv('SDSM_MASK_TRANSFERS', env)
    solver.reset_transfers()
    batching.set_pipeline_mesh(mesh)
    try:
        res = batching.solve_problems(problems, alpha=0.05, smooth_amount=4, maxiter=15, **kw)
    finally:
        batching.set_pipeline_mesh(None)
    return res, {k: dict(v) for k, v in solver.TRANSFERS.items()}


def _same(a, b):
    return all(x.status == y.status and x.energy == y.energy
               and np.array_equal(x.params, y.params) and np.array_equal(x.fg, y.fg)
               for x, y in zip(a, b))


@pytest.mark.parametrize('fetch', ['full', 'energy'])
def test_solve_problems_mask_transfers_bitwise(monkeypatch, fetch):
    problems, _ = _field()
    assert all(p.fits_mask(2048) for p in problems)
    coords, sent_c = _solve(problems, monkeypatch, '0', fetch=fetch)
    masks, sent_m = _solve(problems, monkeypatch, '1', fetch=fetch)
    assert set(sent_c) <= {'dsm', 'poly'} and set(sent_m) <= {'dsm-m', 'poly-m'}
    assert sum(v['problems'] for v in sent_m.values()) == \
        sum(v['problems'] for v in sent_c.values()) >= len(problems)
    # the mask leaf is pb / 2 bytes a lane where the coordinates are 4 pb
    assert sent_m['dsm-m']['bytes'] < sent_c['dsm']['bytes']
    assert _same(coords, masks)


def test_a_problem_that_does_not_fit_goes_by_coordinates(monkeypatch):
    problems, sparse = _field()
    assert not sparse.fits_mask(2048)
    both = problems + [sparse]
    masks, sent = _solve(both, monkeypatch, '1')
    assert sent['dsm']['problems'] == 1 and sent['dsm-m']['problems'] >= len(problems)
    alone, _ = _solve([sparse], monkeypatch, '1')
    assert _same(masks[-1:], alone)
    coords, _ = _solve(problems, monkeypatch, '0')
    assert _same(masks[:-1], coords)


def test_mask_kinds_split_over_a_pipeline_mesh(monkeypatch):
    problems, _ = _field()
    mesh = pm.make_mesh(2, 1, ['cpu'] * 2)
    masks, sent_m = _solve(problems, monkeypatch, '1', mesh=mesh)
    coords, sent_c = _solve(problems, monkeypatch, '0', mesh=mesh)
    # each chunk's lanes in two shares, one call each
    assert sent_m['dsm-m']['calls'] == sent_c['dsm']['calls']
    assert sent_m['dsm-m']['calls'] % 2 == 0
    assert _same(masks, coords)
    single, _ = _solve(problems, monkeypatch, '1')
    for a, b in zip(masks, single):
        assert a.status == b.status
        np.testing.assert_allclose(a.energy, b.energy, rtol=1e-4)
