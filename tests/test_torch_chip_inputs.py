"""``chip_smoke.py``'s copies of the repository's input generators, held
bitwise equal to their originals on the seeds it uses.

``chip_smoke.py`` cannot import ``examples/synthetic/generate.py`` or
``tools/mosaic_bench.py`` (both reach the JAX package), so it carries its
own copies; the JAX-CPU goldens it gates on hold only if the images are the
same. The synthetic images are also written as ``generate.py`` writes them
(``imsave(..., normalize=True)``): the port's PNG pixels must equal the JAX
package's.
"""

import importlib.util
import os

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _generate():
    path = os.path.join(REPO, 'examples', 'synthetic', 'generate.py')
    spec = importlib.util.spec_from_file_location('_sdsm_generate', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GENERATE = _generate()
PAIRS = {'synthetic': (chip_smoke.make_synthetic, GENERATE.make_image),
         'synthetic-glare': (chip_smoke.make_synthetic_glare, GENERATE.make_image_glare),
         'synthetic-dim': (chip_smoke.make_synthetic_dim, GENERATE.make_image_dim)}


def test_synthetic_datasets_are_generate_py_s():
    assert {name: count for name, (_, count) in chip_smoke.SYNTHETIC_DATASETS.items()} \
        == {name: count for name, (_, count) in GENERATE.DATASETS.items()}
    for name, (maker, _) in chip_smoke.SYNTHETIC_DATASETS.items():
        assert maker is PAIRS[name][0]


@pytest.mark.parametrize('name,seed', [(name, seed)
                                       for name, (_, count) in GENERATE.DATASETS.items()
                                       for seed in range(count)])
def test_synthetic_images_and_pngs_equal_the_originals(name, seed, tmp_path):
    from superdsm_tpu.io import imsave as jimsave
    from superdsm_tpu_torch.io import imread, imsave
    copy, original = PAIRS[name]
    img, labels = copy(seed)
    ref_img, ref_labels = original(seed)
    assert img.dtype == ref_img.dtype and np.array_equal(img, ref_img)
    assert labels.dtype == ref_labels.dtype and np.array_equal(labels, ref_labels)
    imsave(str(tmp_path / 'port.png'), img, normalize=True)
    jimsave(str(tmp_path / 'jax.png'), ref_img, normalize=True)
    port, ref = imread(str(tmp_path / 'port.png')), imread(str(tmp_path / 'jax.png'))
    assert port.dtype == ref.dtype and np.array_equal(port, ref)


def test_mosaic_equals_mosaic_bench():
    from tools.mosaic_bench import make_mosaic
    centers = []
    g, n = chip_smoke.make_mosaic(chip_smoke.MOSAIC_SIZE, centers=centers)
    ref, ref_n = make_mosaic(chip_smoke.MOSAIC_SIZE, seed=0)
    assert n == ref_n == len(centers) == 441
    assert g.dtype == ref.dtype and np.array_equal(g, ref)
    # each planted center is a local maximum of its own blob
    for x, y in centers[::40]:
        patch = g[y - 3:y + 4, x - 3:x + 4]
        assert patch.max() > 0.5 and g[y, x] >= patch.mean()


def test_unmatched_rows_excused_only_with_an_energy_witness():
    """A recorded row is excused when the JAX energy at the port's solution
    is at most half the reference's; a recorded row without that witness
    stays unmatched, and a row not recorded (another size, or a center more
    than half a pixel away) is new."""
    recorded = [('spurious', (100, 10.0, 10.0), 100.0, 50.0),
                ('spurious', (100, 20.0, 20.0), 100.0, 50.1),
                ('missing', (100, 30.0, 30.0), 100.0, 10.0)]
    spurious = [(100, 10.3, 9.8), (100, 20.0, 20.0), (101, 10.0, 10.0),
                (100, 30.0, 30.0)]
    missing = [(100, 30.0, 30.4), (100, 10.0, 10.0), (100, 30.0, 30.6)]
    witnessed, left, new = chip_smoke._excuse(spurious, missing, recorded)
    assert witnessed == {'spurious': [(100, 10.3, 9.8)], 'missing': [(100, 30.0, 30.4)]}
    assert left == {'spurious': [(100, 20.0, 20.0)], 'missing': []}
    assert new == {'spurious': [(101, 10.0, 10.0), (100, 30.0, 30.0)],
                   'missing': [(100, 10.0, 10.0), (100, 30.0, 30.6)]}


def _golden(name):
    from tests.regression.validate import load_csv
    return load_csv(os.path.join(REPO, 'tests', 'data', 'torch_port', name))


@pytest.mark.parametrize('name,rows', [
    ('bench-seed3.csv', chip_smoke.SEED3_ROWS),
    ('mosaic-2048-seed0.csv', chip_smoke._witness_rows(chip_smoke.MOSAIC_WITNESS))])
def test_recorded_rows_are_rows_of_the_golden(name, rows):
    """Each recorded 'missing' row is a row of its golden and no 'spurious'
    one is; each row is recorded once, with finite positive energies."""
    golden = _golden(name)
    assert len({(kind, row) for kind, row, _, _ in rows}) == len(rows)
    for kind, row, e_ref, e_port in rows:
        assert (tuple(row) in golden) == (kind == 'missing'), (kind, row)
        assert np.isfinite([e_ref, e_port]).all() and min(e_ref, e_port) > 0


def test_bench_seed3_rows_are_witnessed():
    """Every recorded row of bench seed 3 has its energy witness."""
    witnessed, left, new = chip_smoke._excuse(
        [r for k, r, _, _ in chip_smoke.SEED3_ROWS if k == 'spurious'],
        [r for k, r, _, _ in chip_smoke.SEED3_ROWS if k == 'missing'],
        chip_smoke.SEED3_ROWS)
    assert sum(map(len, witnessed.values())) == 5
    assert not any(left.values()) and not any(new.values())


@pytest.mark.parametrize('golden,max_unmatched', [
    *((chip_smoke._bench_golden(seed, chip_smoke.F64), 1)
      for seed in chip_smoke.GOLDEN_SEEDS),
    (chip_smoke.MOSAIC_F64_GOLDEN, 4)])
def test_float64_sum_gate_fails_on_a_miss(golden, max_unmatched, monkeypatch, capsys):
    """The float64-sum gate excuses no row: a label map with one row more
    missing than the gate allows fails the run, except on a golden of
    ``F64_NOT_MET``, where the gate is printed NOT met, and ``--strict``
    fails it there too. The golden's own rows pass, and so do rows with as
    many missing as allowed."""
    import types
    validate = chip_smoke._validate_module()
    monkeypatch.setattr(chip_smoke, '_validate_module', lambda: types.SimpleNamespace(
        load_csv=validate.load_csv, match_rows=validate.match_rows,
        summarize_label_map=lambda rows: rows))
    rows = validate.load_csv(golden)
    chip_smoke._f64_gate(rows, golden, max_unmatched)
    chip_smoke._f64_gate(rows[max_unmatched:], golden, max_unmatched)
    short = rows[max_unmatched + 1:]
    if os.path.basename(golden) in chip_smoke.F64_NOT_MET:
        capsys.readouterr()
        chip_smoke._f64_gate(short, golden, max_unmatched)
        assert 'is NOT met; not enforced' in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit):
            chip_smoke._f64_gate(short, golden, max_unmatched)
    monkeypatch.setattr(chip_smoke, 'STRICT', True)
    with pytest.raises(SystemExit):
        chip_smoke._f64_gate(short, golden, max_unmatched)


def test_bench_field_equals_bench_py():
    from bench import make_image
    for seed in chip_smoke.GOLDEN_SEEDS:
        g, n = chip_smoke.make_image(seed)
        ref, ref_n = make_image(seed)
        assert n == ref_n and np.array_equal(g, ref)
