"""The harness end to end on the CPU at tiny sizes, with the port's plain
paths: a sound run is correct; the control and each fault a cell can have
make ``correct`` false. The look for a card (``run.py``) is skipped here;
``test_run_on_the_card`` runs the command itself where a card is present."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness

ROOT = harness.ROOT
SEED = 2 ** 31 + 4242
# the serial traffic mix, one thread: the quickest run on the CPU
TINY = {'assumed': {'height': 140, 'width': 180, 'nuclei': 4},
        'traffic': harness.load_json('traffic', 'serial'),
        'config': {'plate': {'seed': 11, 'fields': 3}},
        'limits': {'solve_sample': 12, 'y_images': 1}}


def _judged_wrong(result, *names):
    """Not correct, every image answered, and one of the named numbers
    beyond its limit (or nothing left to judge)."""
    beyond = [n for n in names if result['check'][n]['value'] is None
              or result['check'][n]['value'] > result['check'][n]['limit']]
    return not result['correct'] and result['failed'] == 0 and bool(beyond)


def _run(cell='bbbc039-batch', seconds=3.0, trace=False, **extra):
    ov = {k: dict(v) for k, v in TINY.items()}
    for k, v in extra.items():
        ov.setdefault(k, {}).update(v)
    torch.set_num_threads(2)
    return harness.run_cell(cell, SEED, seconds, trace, 'cpu', overrides=ov)


def test_sound_run_is_correct():
    result, run, notes = _run()
    assert result['correct'], (result['check'], notes)
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert result['metrics']['setup_s']['value'] > 0
    # no card, no device trace: the reader finds nothing and the metric is left out
    assert 'device_ms_per_image' not in result['metrics'] and run.trace is None
    assert list(result['check']) == ['label_error_share', 'y_lsb', 'solve_far_share']


def test_pipelined_traced_run_reads_its_host_metrics():
    result, run, notes = _run(trace=True, traffic={'mode': 'pipelined', 'threads': 2})
    assert result['correct'], (result['check'], notes)
    for name in ('window_images_per_s', 'image_s_p95', 'stage_s.c2f', 'stage_s.gem'):
        assert result['metrics'][name]['value'] > 0
    assert 'setup_s' not in result['metrics']


def test_control_one_pass_bf16_gram_is_not_correct(monkeypatch):
    from superdsm_tpu_torch.dsm import gram
    monkeypatch.setattr(gram, 'GRAM_PASSES', 1)
    result, _, _ = _run(seconds=6.0, assumed={'height': 160, 'width': 200, 'nuclei': 5},
                        limits={'solve_sample': 48})
    assert _judged_wrong(result, 'solve_far_share')


def test_control_bf16_offsets_exceed_the_limit():
    from portbench import check
    result, run, _ = _run()
    pick = sorted(i for i in run.records if run.records[i].get('error') is None)[:1]
    ys = check.y_numbers(run, pick, 'cpu', dtype=torch.bfloat16)
    assert max(ys.values()) > result['check']['y_lsb']['limit']


def test_fault_step_returns_its_state_unchanged(monkeypatch):
    from superdsm_tpu_torch.dsm import solver
    monkeypatch.setattr(solver, '_newton_step', lambda *a, **k: None)
    result, _, _ = _run()
    assert _judged_wrong(result, 'solve_far_share')


def test_fault_half_the_pixels_left_out(monkeypatch):
    # each region's sums (energies, gradient, Hessian) over the first half
    # of its pixels, the mean taken over the rest (twice the half's sum)
    from superdsm_tpu_torch.dsm import gram, lane
    plain, energies = gram.grad_hess_plain, lane.softplus_energies

    def halve(w):
        keep = torch.zeros_like(w)
        keep[..., : w.shape[-1] // 2] = 2.0
        return w * keep

    monkeypatch.setattr(gram, 'grad_hess_plain',
                        lambda Bf, s, yv, w, *a, **k: plain(Bf, s, yv, halve(w), *a, **k))
    monkeypatch.setattr(lane, 'softplus_energies',
                        lambda s, yv, w, *a, **k: energies(s, yv, halve(w), *a, **k))
    result, _, _ = _run()
    assert _judged_wrong(result, 'solve_far_share')


def test_fault_answer_altered_where_it_is_produced(monkeypatch):
    from superdsm_tpu_torch.dsm import batching
    store = batching._store_results

    def altered(results, problems, kind, chunk, row, fetch):
        store(results, problems, kind, chunk, row, fetch)
        for i in chunk:
            results[i].energy = results[i].energy * 3.0

    monkeypatch.setattr(batching, '_store_results', altered)
    result, _, _ = _run()
    assert _judged_wrong(result, 'solve_far_share')


def test_fault_half_the_lanes_altered(monkeypatch):
    # every other lane, counted over the solved chunks, reports an energy 3
    # times its own (a fault that spares half of the batch)
    import itertools
    from superdsm_tpu_torch.dsm import batching
    store = batching._store_results
    lane = itertools.count()

    def altered(results, problems, kind, chunk, row, fetch):
        store(results, problems, kind, chunk, row, fetch)
        for i in chunk:
            if next(lane) % 2:
                results[i].energy = results[i].energy * 3.0

    monkeypatch.setattr(batching, '_store_results', altered)
    result, _, _ = _run(seconds=6.0, assumed={'height': 200, 'width': 260, 'nuclei': 8},
                        limits={'solve_sample': 48})
    assert _judged_wrong(result, 'solve_far_share')


def test_fault_postprocessing_drops_every_other_object(monkeypatch):
    from superdsm_tpu_torch import postprocess
    process = postprocess.Postprocessing.process

    def dropping(self, input_data, *args, **kwargs):
        data = process(self, input_data, *args, **kwargs)
        data['postprocessed_objects'] = data['postprocessed_objects'][::2]
        return data

    monkeypatch.setattr(postprocess.Postprocessing, 'process', dropping)
    result, _, _ = _run()
    assert _judged_wrong(result, 'label_error_share')


def test_no_jax_loaded_and_the_reference_loads_nothing_of_the_port():
    code = ('import sys, torch; sys.path.insert(0, %r); torch.set_num_threads(2)\n'
            'from portbench import harness\n'
            'harness.run_cell("bbbc039-batch", 5, 2.0, False, "cpu", overrides=%r)\n'
            'print(sorted({m.split(".")[0] for m in sys.modules}))') % (ROOT, TINY)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, 'JAX_PLATFORMS': 'cpu'}, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert 'superdsm_tpu_torch' in top
    assert not top & {'jax', 'jaxlib', 'flax', 'superdsm_tpu'}
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import portbench.reference.dsm, portbench.reference.offsets\n'
            'print(sorted({m.split(".")[0] for m in sys.modules}))') % ROOT
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {'superdsm_tpu_torch', 'superdsm_tpu', 'jax'}


def test_without_a_card_run_exits_nonzero_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload', 'bbbc039-batch',
                          '--seed', '1', '--seconds', '1', '--trace', '0'],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
def test_run_on_the_card(card):
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload', 'bbbc039-batch',
                          '--seed', str(SEED), '--seconds', '5', '--trace', '0'],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'
