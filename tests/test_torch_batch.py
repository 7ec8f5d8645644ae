"""The port's batch and export CLIs against the JAX package's, on the CPU.

The same task tree of small fields goes through ``superdsm_tpu.batch.run_cli``
and ``superdsm_tpu_torch.batch.run_cli`` (in-process, ``--no-fork``, the port
on the CPU). Stated tolerances: equal ``.digest`` files, ``timings.csv``
columns, ``errors.csv`` rows and pickup stages; the seg maps match with the
repository's regression matcher (center 3 px, size 10%) with at most one
unmatched object per image — the cross-backend allowance of one boundary
flip.
"""

import gzip
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.regression.validate import match_rows, summarize_label_map

import superdsm_tpu_torch as T
from superdsm_tpu_torch import batch as B
from superdsm_tpu_torch import export as E
from superdsm_tpu_torch.io import imread, imsave

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with T.use_device('cpu'):
        yield


def _blobs(centers, seed, shape=(120, 120), width=0.6):
    rr, cc = np.indices(shape)
    g = np.zeros(shape, np.float32)
    for r0, c0, rad in centers:
        g += np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * (rad * width) ** 2)))
    return g + np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.01


def _make_tree(root):
    """taskA: two blob fields at ``AF_scale`` 10; taskB: a blob-free image
    whose scale estimation fails (an ``errors.csv`` row)."""
    root.mkdir(parents=True)
    imsave(str(root / 'img0.png'), _blobs([(40, 40, 14), (90, 90, 14)], 0))
    imsave(str(root / 'img1.png'), _blobs([(35, 80, 13), (85, 40, 14)], 1))
    imsave(str(root / 'img2.png'), np.full((120, 120), 0.5, np.float32),
           normalize=False)
    (root / 'task.json').write_text(json.dumps({'img_pathpattern': '{ROOTDIR}/img%d.png'}))
    for name, spec in [('taskA', {'file_ids': [0, 1], 'config': {
                           'AF_scale': 10, 'global-energy-minimization': {'beta': 0.5}}}),
                       ('taskB', {'file_ids': [2], 'config': {
                           'global-energy-minimization': {'beta': 0.5}}})]:
        (root / name).mkdir()
        (root / name / 'task.json').write_text(json.dumps(dict(
            runnable=True, seg_pathpattern='seg/%d.png', **spec)))


def _change_postprocess(root):
    spec_path = root / 'taskA' / 'task.json'
    spec = json.loads(spec_path.read_text())
    spec['config']['postprocess'] = {'max_eccentricity': 0.98}
    spec_path.write_text(json.dumps(spec))


def _pickup_lines(text):
    return [line.strip().split('(')[-1] for line in text.splitlines()
            if 'Picking up from' in line]


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    from superdsm_tpu.batch import run_cli as jax_run_cli
    base = tmp_path_factory.mktemp('batch')
    jax_root, port_root = base / 'jax', base / 'port'
    _make_tree(jax_root)
    shutil.copytree(jax_root, port_root)
    logs = {}
    import contextlib
    import io
    for name, root, run in (('jax', jax_root, jax_run_cli),
                            ('port', port_root, B.run_cli)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), T.use_device('cpu'):
            run([str(root), '--run', '--no-fork'])
        first = buf.getvalue()
        seg = {i: imread(str(root / 'taskA' / 'seg' / f'{i}.png')) for i in (0, 1)}
        _change_postprocess(root)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), T.use_device('cpu'):
            run([str(root), '--run', '--no-fork'])
        logs[name] = dict(first=first, pickup=buf.getvalue(), seg=seg)
    return dict(jax=jax_root, port=port_root, logs=logs)


@pytest.mark.parametrize('task', ['taskA', 'taskB'])
def test_digests_equal(trees, task):
    for name in ('.digest', '.digest.cfg.json'):
        assert (trees['port'] / task / name).read_text() == \
            (trees['jax'] / task / name).read_text()


def test_timings_columns_equal(trees):
    rows = {k: (trees[k] / 'taskA' / 'timings.csv').read_text().splitlines()
            for k in ('jax', 'port')}
    assert rows['port'][1] == rows['jax'][1]
    assert len(rows['port']) == len(rows['jax'])


def test_errors_rows_equal(trees):
    jax_rows = (trees['jax'] / 'taskB' / 'errors.csv').read_text()
    port_rows = (trees['port'] / 'taskB' / 'errors.csv').read_text()
    assert 'scale estimation failed' in port_rows
    assert port_rows == jax_rows
    assert not (trees['port'] / 'taskB' / 'seg' / '2.png').exists()


@pytest.mark.parametrize('image', [0, 1])
def test_seg_maps_match(trees, image):
    port = trees['logs']['port']['seg'][image]
    ref = trees['logs']['jax']['seg'][image]
    assert port.shape == ref.shape == (120, 120) and port.dtype == np.uint16
    _, spurious, missing = match_rows(summarize_label_map(port),
                                      summarize_label_map(ref),
                                      center_tol=3.0, size_tol=0.1)
    assert len(spurious) <= 1 and len(missing) <= 1, (spurious, missing)
    assert len(np.unique(port)) == 3  # background + 2 objects


def test_pickup_stage_equal(trees):
    port = _pickup_lines(trees['logs']['port']['pickup'])
    assert port == _pickup_lines(trees['logs']['jax']['pickup'])
    assert port == ['postprocess)']
    assert 'Skipping task' in trees['logs']['port']['pickup']  # taskB unchanged


def _walk(value, seen=None):
    seen = set() if seen is None else seen
    if id(value) in seen:
        return
    seen.add(id(value))
    yield value
    children = value.values() if isinstance(value, dict) else \
        value if isinstance(value, (list, tuple, set, frozenset)) else \
        vars(value).values() if hasattr(value, '__dict__') else ()
    for child in children:
        yield from _walk(child, seen)


def test_result_pickle_is_host_data_read_by_dill(trees):
    import dill
    path = trees['port'] / 'taskA' / 'data.dill.gz'
    with gzip.open(path, 'rb') as fin:
        data = dill.load(fin)
    with gzip.open(path, 'rb') as fin:
        assert pickle.load(fin).keys() == data.keys() == {0, 1}
    assert len(data[0]['postprocessed_objects']) == 2
    assert not any(isinstance(v, torch.Tensor) for v in _walk(data))


def test_dump_refuses_tensors(tmp_path):
    with pytest.raises(TypeError, match='torch.Tensor'):
        B._dump({'x': torch.zeros(2)}, tmp_path / 'data.dill.gz')


def test_shard_run_and_merge(trees, tmp_path, capsys):
    root = tmp_path / 'root'
    shutil.copytree(trees['port'], root)
    for task in ('taskA', 'taskB'):
        for name in ('.digest', 'data.dill.gz', 'timings.csv', '.timings.json'):
            (root / task / name).unlink()
    for shard in ('0/2', '1/2'):
        B.run_cli([str(root), '--run', '--no-fork', '--fresh', '--task', 'taskA',
                   '--shard', shard])
    for i in range(2):
        assert (root / 'taskA' / f'.digest.shard-{i}-of-2').exists()
    B.run_cli([str(root), '--run', '--no-fork', '--task', 'taskA',
               '--merge-shards', '2'])
    assert (root / 'taskA' / '.digest').read_text() == \
        (trees['port'] / 'taskA' / '.digest').read_text()
    assert not (root / 'taskA' / 'data.shard-0-of-2.dill.gz').exists()
    data = B._load(root / 'taskA' / 'data.dill.gz')
    assert [len(data[i]['postprocessed_objects']) for i in (0, 1)] == [2, 2]
    assert 'Merged 2 shard(s)' in capsys.readouterr().out


def test_debug_restores_telemetry_after_early_failure(trees, monkeypatch):
    """The failure inside ``find_first_stage_name`` surfaces as itself (the
    JAX package's ``finally`` raised NameError there), and the telemetry is
    restored."""
    from superdsm_tpu_torch.dsm import batching

    def boom(*args, **kwargs):
        raise ValueError('pickup failed')

    monkeypatch.delenv('SDSM_SOLVE_TELEMETRY', raising=False)
    monkeypatch.setattr(batching, '_TELEMETRY', False)
    monkeypatch.setattr(B.Task, 'find_first_stage_name', boom)
    with pytest.raises(ValueError, match='pickup failed'):
        B.run_cli([str(trees['port']), '--run', '--no-fork', '--force',
                   '--debug', '--task', 'taskA'])
    assert batching._TELEMETRY is False
    assert 'SDSM_SOLVE_TELEMETRY' not in os.environ


def test_debug_prints_telemetry(trees, tmp_path, monkeypatch, capsys):
    """The lines come from the span recorder, which the task turns off
    again and which holds none of the task's spans."""
    from superdsm_tpu_torch import trace
    from superdsm_tpu_torch.dsm import batching
    root = tmp_path / 'root'
    shutil.copytree(trees['port'], root)
    monkeypatch.delenv('SDSM_SOLVE_TELEMETRY', raising=False)
    monkeypatch.setattr(batching, '_TELEMETRY', False)
    trace.enable(False)
    trace.drain()
    B.run_cli([str(root), '--run', '--no-fork', '--force', '--fresh', '--debug',
               '--task', 'taskA', '--last-stage', 'c2f-region-analysis',
               '--oneshot'])
    assert '[solve_problems]' in capsys.readouterr().err
    assert batching._TELEMETRY is False
    assert 'SDSM_SOLVE_TELEMETRY' not in os.environ
    assert not trace.enabled() and trace.drain()['spans'] == []


def test_mesh_is_refused(trees, capsys):
    """A mesh needing more devices than the machine has is a parser error
    (the CPU is one device)."""
    with pytest.raises(SystemExit):
        B.run_cli([str(trees['port']), '--run', '--mesh', 'batch:4'])
    assert 'mesh 4x1 needs more than 1 devices' in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason='checks the CPU-only case')
def test_clis_raise_without_cuda(trees):
    with T.use_device('cuda'):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            B.run_cli([str(trees['port']), '--run'])
        with pytest.raises(RuntimeError, match='no CUDA device'):
            E.run_cli([str(trees['port']), 'taskA', '--mode', 'img'])


def test_fork_refused_after_cuda_init(trees, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    with pytest.raises(RuntimeError, match='--no-fork'):
        B.run_cli([str(trees['port']), '--run', '--force', '--task', 'taskA'])


@pytest.mark.parametrize('mode', ['seg', 'adj'])
def test_export_modes(trees, tmp_path, mode):
    outdir = tmp_path / f'export-{mode}'
    E.run_cli([str(trees['port']), 'taskA', '--mode', mode, '--imageid', '0',
               '--outdir', str(outdir)])
    files = sorted(p.name for p in outdir.iterdir())
    assert files == (['0.png'] if mode == 'seg' else ['0.png', 'ymap_legend.png'])
    img = imread(str(outdir / '0.png'), as_gray=False)
    assert img.shape == (120, 120, 3) and img.dtype == np.uint8


_NO_LIBS = r'''
import sys
sys.modules['PIL'] = sys.modules['matplotlib'] = sys.modules['dill'] = None
sys.path.insert(0, REPO)
import numpy as np, torch
import superdsm_tpu_torch as T
from superdsm_tpu_torch import batch, io, render
T.set_device('cpu')
torch.set_num_threads(1)
batch.run_cli([ROOT, '--run', '--force', '--task', 'taskA'])
seg = io.imread(ROOT + '/taskA/seg/0.png')
rgb = render.colorize_labels(seg)
io.imsave(ROOT + '/colorized.png', rgb)
io.imsave(ROOT + '/stack.tif', np.stack([seg, seg]))
assert io.imread(ROOT + '/stack.tif').shape == (2,) + seg.shape
try:
    io.imread(ROOT + '/missing.jpg')
except ImportError as error:
    assert 'JPEG' in str(error)
try:
    render.get_cmap('viridis')
except ImportError as error:
    assert 'matplotlib' in str(error)
assert not torch.cuda.is_initialized()
print('ok', len(np.unique(seg)) - 1, rgb.shape)
'''


def test_clis_need_no_pillow_matplotlib_or_dill(trees, tmp_path):
    """The batch CLI (forked per task, as on the card), io and render in a
    process where Pillow, matplotlib and dill cannot be imported."""
    root = tmp_path / 'root'
    shutil.copytree(trees['port'], root)
    script = _NO_LIBS.replace('REPO', repr(REPO)).replace('ROOT', repr(str(root)))
    proc = subprocess.run([sys.executable, '-c', script], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == 'ok 2 (120, 120, 3)'
    assert (root / 'colorized.png').exists()
