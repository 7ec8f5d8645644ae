"""BENCHMARK.json against the benchmark's contract, and every file a cell
is found by."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['portbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    cost = 2 + 14 * 24 * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200
    assert cost <= 43200


def test_names_units_and_keys():
    names = [c['name'] for c in BENCH['configs']] + [w['name'] for w in BENCH['workloads']] \
        + [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    for name in names:
        assert NAME.match(name), name
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    assert {m['name']: m['source'] for m in BENCH['end_to_end']} == {
        'device_ms_per_image': 'device_trace', 'setup_s': 'host_clock'}
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    layers = {m['layer'] for m in BENCH['per_layer']}
    for m in BENCH['per_layer']:
        assert m['moves'] == 'device_ms_per_image' and '\n' not in m['layer']
    assert len(layers) >= 5


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_cell_files_found_by_name(cell):
    w = next(w for w in BENCH['workloads'] if w['name'] == cell)
    config = harness.load_json('configs', w['config'])
    traffic = harness.load_json('traffic', w['traffic'])
    harness.load_json('limits', w['config'])
    harness.load_module('gen', config['assumed']['generator'])
    assert config['reduced'] == [] and len(config['source']) <= 200
    assert callable(harness.load_module('modes', traffic['mode']).drive)


@pytest.mark.parametrize('kind,metric', [('end_to_end', m['name']) for m in BENCH['end_to_end']]
                         + [('metrics', m['name']) for m in BENCH['per_layer']])
def test_metric_reader_found_by_name(kind, metric):
    assert callable(harness.load_module(kind, metric).read)


def test_config_files_are_listed():
    for c in BENCH['configs']:
        assert os.path.exists(os.path.join(ROOT, c['file']))
        assert c['file'] == f'portbench/configs/{c["name"]}.json'
