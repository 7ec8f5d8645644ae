"""The readers of the port's spans (``portbench/spans.py``) on hand-made
spans and idle intervals; a traced run on the CPU through ``spans.run_cell``;
and the harness's untraced run, which leaves the port's span recorder off."""

import types

import pytest

from portbench import spans


def _span(sid, name, thread, start, end, parent=None, image=1, cpu=0.0, counts=None):
    return dict(id=sid, name=name, parent=parent, image=image, thread=thread,
                start=start, end=end, cpu=cpu, counts=counts or {}, attrs={})


def _run(span_list, gaps=(), t0=0.0, t1=10.0, images=1.0):
    trace = types.SimpleNamespace(gaps=lambda a, b: list(gaps))
    return types.SimpleNamespace(program_spans=dict(spans=span_list, dropped=0, counts={}),
                                 trace=trace, t0=t0, t1=t1, done=[object()],
                                 images_in_window=lambda: images)


def test_idle_goes_to_the_innermost_span():
    s = [_span(1, 'sdsm.image', 7, 0.0, 10.0),
         _span(2, 'sdsm.stage.c2f-region-analysis', 7, 1.0, 9.0, parent=1),
         _span(3, 'sdsm.c2f.advance', 7, 2.0, 4.0, parent=2),
         _span(4, 'sdsm.solve', 7, 4.0, 6.0, parent=2),
         _span(5, 'sdsm.solve.fetch', 7, 5.0, 6.0, parent=4)]
    idle = spans.idle_by_span(s, [(0.5, 2.5), (3.0, 5.5), (8.0, 9.5)])
    assert idle == pytest.approx({'sdsm.image': 0.5 + 0.5,
                                  'sdsm.stage.c2f-region-analysis': 1.0 + 1.0,
                                  'sdsm.c2f.advance': 0.5 + 1.0,
                                  'sdsm.solve': 1.0, 'sdsm.solve.fetch': 0.5})


def test_idle_is_shared_equally_among_threads_in_an_image():
    s = [_span(1, 'sdsm.image', 1, 0.0, 4.0, image=1),
         _span(2, 'sdsm.gem.generation', 1, 0.0, 4.0, parent=1, image=1),
         _span(3, 'sdsm.image', 2, 2.0, 8.0, image=2),
         _span(4, 'sdsm.loop.capture', 2, 2.0, 8.0, parent=3, image=2),
         # a pool thread's carried span takes no share
         _span(5, 'sdsm.c2f.cluster', 3, 0.0, 8.0, parent=2, image=1)]
    # idle 1-3: one second alone in thread 1, one shared; idle 9-10: no image open
    idle = spans.idle_by_span(s, [(1.0, 3.0), (9.0, 10.0)])
    assert idle == pytest.approx({'sdsm.gem.generation': 1.5, 'sdsm.loop.capture': 0.5,
                                  None: 1.0})
    run = _run(s, [(1.0, 3.0), (9.0, 10.0)], images=2.0)
    assert spans.idle_ms_per_image(run, 'gem') == pytest.approx(750.0)
    assert spans.idle_ms_per_image(run, 'capture') == pytest.approx(250.0)
    assert spans.idle_ms_per_image(run, 'c2f') == 0.0
    assert spans.unattributed_share(run) == 0.0


def test_unattributed_share():
    s = [_span(1, 'sdsm.image', 1, 0.0, 10.0),
         _span(2, 'sdsm.stage.global-energy-minimization', 1, 5.0, 10.0, parent=1),
         _span(3, 'sdsm.objects.unpack', 1, 6.0, 10.0, parent=2)]
    run = _run(s, [(0.0, 1.0), (5.0, 7.0)])
    # 1 s in the image alone, 1 s in the stage alone, 1 s below the stage
    assert spans.unattributed_share(run) == pytest.approx(2.0 / 3.0)


def test_stage_cpu_adds_the_carried_pool_spans():
    stage = 'sdsm.stage.c2f-region-analysis'
    s = [_span(1, 'sdsm.image', 1, 0.0, 10.0, cpu=9.0),
         _span(2, stage, 1, 1.0, 9.0, parent=1, cpu=2.0),
         _span(3, 'sdsm.c2f.advance', 1, 2.0, 4.0, parent=2, cpu=0.1),
         # carried onto two pool threads; a span nested in a carried one is
         # already in its parent's CPU seconds
         _span(4, 'sdsm.c2f.cluster', 2, 2.0, 3.5, parent=3, cpu=1.5),
         _span(5, 'sdsm.c2f.cluster', 3, 2.0, 3.0, parent=3, cpu=1.0),
         _span(6, 'sdsm.solve', 3, 2.1, 2.2, parent=5, cpu=0.1),
         # another image's stage, in the window too
         _span(7, 'sdsm.image', 1, 11.0, 12.0, image=2),
         _span(8, stage, 1, 11.0, 12.0, parent=7, image=2, cpu=0.5),
         # an image that started before the window is not read
         _span(9, 'sdsm.image', 4, -5.0, 1.0, image=3),
         _span(10, stage, 4, -4.0, 0.5, parent=9, image=3, cpu=100.0)]
    run = _run(s, t1=11.5)
    assert spans.window_images(run) == {1, 2}
    assert spans.stage_cpu_s(run, 'c2f') == pytest.approx(((2.0 + 1.5 + 1.0) + 0.5) / 2)
    assert spans.stage_cpu_s(run, 'gem') is None


def test_solve_wait_and_lane_counts():
    s = [_span(1, 'sdsm.image', 1, 0.0, 10.0),
         _span(2, 'sdsm.solve.fetch', 1, 1.0, 1.25, parent=1),
         _span(3, 'sdsm.solve.store', 1, 1.25, 1.5, parent=1,
               counts={'dsm.converged': 6, 'dsm.capped': 2, 'poly.converged': 5}),
         _span(4, 'sdsm.image', 2, 1.0, 9.0, image=2),
         _span(5, 'sdsm.solve.fetch', 2, 2.0, 2.75, parent=4, image=2),
         _span(6, 'sdsm.solve.store', 2, 2.75, 3.0, parent=4, image=2,
               counts={'dsm.converged': 1, 'dsm.capped': 1, 'dsm.fallback': 0}),
         # the two capped lanes solved again: counted apart, not a second time
         _span(7, 'sdsm.solve.canonical', 2, 3.0, 4.0, parent=4, image=2,
               counts={'dsm.canonical': 2}),
         _span(8, 'sdsm.solve.store', 2, 3.5, 4.0, parent=7, image=2,
               counts={'dsm.converged': 1, 'dsm.capped': 1})]
    run = _run(s)
    assert spans.solve_wait_ms_per_image(run) == pytest.approx(500.0)
    assert spans.lane_counts(run, 'dsm') == {'converged': 7, 'capped': 3, 'fallback': 0,
                                             'canonical': 2}
    assert spans.lane_counts(run, 'dsm', resolves=True) == {'converged': 1, 'capped': 1}
    assert spans.lane_counts(run, 'poly', resolves=True) is None
    assert spans.lanes_capped_pct(run) == pytest.approx(30.0)


@pytest.mark.parametrize('drained', [None, dict(spans=[], dropped=0, counts={})],
                         ids=['no recorder', 'no spans'])
def test_a_program_without_spans_reads_nothing(drained):
    run = types.SimpleNamespace(t0=0.0, t1=1.0, done=[], trace=None, program_spans=drained)
    assert spans.readings(run) == {
        name: None for name in ('stage_cpu_s.c2f', 'stage_cpu_s.gem', 'solve_wait_ms_per_image',
                                'idle_ms_per_image.c2f', 'idle_ms_per_image.gem',
                                'idle_ms_per_image.solve', 'idle_ms_per_image.capture',
                                'lanes_capped_pct')}


def test_traced_run_keeps_the_spans_of_its_images():
    """``spans.run_cell`` with ``trace`` on the CPU: the recorder is on for
    the run and off after it, every window image's spans share its id, the
    stages' CPU and the lane counts read something, and the device's idle
    time (no card, no trace) reads nothing."""
    from superdsm_tpu_torch import trace
    from portbench.tests.test_portbench_run import TINY, SEED
    ov = {k: dict(v) for k, v in TINY.items()}
    ov['traffic'].update(mode='pipelined', threads=2)
    result, run, notes = spans.run_cell('bbbc039-batch', SEED, 3.0, True, 'cpu', overrides=ov)
    assert result['correct'], (result['check'], notes)
    assert not trace.enabled() and run.program_spans['dropped'] == 0
    images = spans.window_images(run)
    assert images and None not in images
    names = {s['name'] for s in spans.spans_of(run) if s['image'] in images}
    assert {'sdsm.image', 'sdsm.stage.c2f-region-analysis', 'sdsm.c2f.advance',
            'sdsm.solve', 'sdsm.solve.fetch', 'sdsm.objects.pack'} <= names
    got = spans.readings(run)
    assert got['stage_cpu_s.c2f'] > 0 and got['stage_cpu_s.gem'] > 0
    assert got['solve_wait_ms_per_image'] >= 0 and 0 <= got['lanes_capped_pct'] <= 100
    assert got['idle_ms_per_image.c2f'] is None


def test_untraced_run_leaves_the_recorder_off(monkeypatch):
    """A ``--trace 0`` run of the harness on the CPU: the recorder stays off
    through the window, and the result has the keys it always had, the
    end-to-end metrics alone, and no program spans."""
    from superdsm_tpu_torch import automation, trace
    from portbench.tests.test_portbench_run import _run as run_cell
    seen = []
    process = automation.process_image

    def watched(*args, **kwargs):
        seen.append(trace.enabled())
        return process(*args, **kwargs)

    monkeypatch.setattr(automation, 'process_image', watched)
    result, run, _ = run_cell()
    assert seen and not any(seen)
    assert not trace.enabled() and trace.drain()['spans'] == []
    assert not hasattr(run, 'program_spans')
    assert set(result) == {'correct', 'attempted', 'failed', 'metrics', 'device', 'check'}
    assert set(result['metrics']) == {'setup_s'}  # no card: no device trace
    assert result['correct'] and result['failed'] == 0


def test_capture_leads_follow_the_profilers_clock():
    """A profiler clock that runs 1 ms per 100 s late: each capture span's
    own first capture call lags its start by 10 us plus the drift."""
    starts = [0.0, 100.0, 200.0]
    s = [_span(i + 1, 'sdsm.loop.capture', 1, t, t + 0.01) for i, t in enumerate(starts)]
    run = _run(s)
    run.mark_perf = -5.0
    run.trace.host = [('cudaStreamBeginCapture', t + 1e-5 + 1e-5 * t) for t in starts] \
        + [('cudaStreamEndCapture', t + 0.009) for t in starts] \
        + [('cudaStreamBeginCapture', 50.0)]  # no span near it
    leads = spans.capture_leads(run)
    assert [x for x, _ in leads] == pytest.approx([5.0, 105.0, 205.0])
    assert [y for _, y in leads] == pytest.approx([1e-5, 1e-3 + 1e-5, 2e-3 + 1e-5])
