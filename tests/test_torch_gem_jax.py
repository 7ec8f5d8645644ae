"""The port against the JAX package at GOWT1's published settings, on the CPU.

``examples/GOWT1-1/default/adapted/task.json`` (``portbench/configs/
gowt1.json``: no c2f improvement floor, exact pruning) with ``AF_scale``
8.5, on 120x120 crops of one colony of 4 textured nuclei of radius 12
(``portbench/gen/colony_fields.py``), whose clusters of 4 and 5 atoms
take the global energy minimization through its generations. Both
packages' ``automation.process_image`` segment the crop. Stated
tolerances: the label maps as ``tests/test_torch_pipeline.py`` holds them
(equal object counts, the regression matcher with at most one unmatched
object, foreground Dice >= 0.99); the set cover's cost to rtol 5e-4 (the
packages' float32 Newton solves sum in different orders; measured 7e-5).
"""

import copy
import json
import os

import pytest

from portbench.gen import colony_fields
from tests.test_torch_pipeline import _assert_parity, _run_jax, _run_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOWT1 = json.load(open(os.path.join(REPO, 'portbench', 'configs', 'gowt1.json')))


@pytest.mark.parametrize('seed', [1, 2])
def test_gowt1_crop_matches_jax(seed):
    p = dict(GOWT1['assumed'], radius=12.0, height=120, width=120, nuclei=4, colonies=1)
    img = colony_fields.make(seed, 0, p)[0]
    cfg = copy.deepcopy(GOWT1['config'])
    cfg['AF_scale'] = 8.5
    jax_data, jax_seg = _run_jax(img, cfg)
    port_data, port_seg, _ = _run_port(img, cfg)
    sizes = [len(port_data['adjacencies'].get_atoms_in_cluster(label))
             for label in port_data['adjacencies'].cluster_labels]
    assert max(sizes) >= 4, sizes
    assert len(port_data['postprocessed_objects']) == len(jax_data['postprocessed_objects'])
    _assert_parity(port_seg, jax_seg)
    assert port_data['cover'].costs == pytest.approx(jax_data['cover'].costs, rel=5e-4)
