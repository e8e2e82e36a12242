"""The control comes out not correct: the plain reference put in the
program's place at float32 with TF32 on (the nearest precision below the
configurations' float32, whose products the port runs in IEEE fp32), on
the card, at a batch a test run holds. Run on the card:

    python -m pytest -m gpu benchmark/tests/test_bench_control.py -q
"""

import pytest
import torch

from benchmark import readings, run
from benchmark.harness import manifest

CASES = [("serving_b1", 1, 20.0), ("srbd_gait_4096", 512, 5.0), ("sweep_4096", 256, 1.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch,seconds", CASES, ids=[c[0] for c in CASES])
def test_control_is_not_correct(name, batch, seconds):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = manifest.resolve(name)
    cell = cell._replace(config=dict(cell.config, batch=batch))
    readings.control_precision(True)
    try:
        result = run.run_cell(cell, 2**31 + 4242, seconds, False, torch.device("cuda", 0),
                              "control")
    finally:
        readings.control_precision(False)
    assert result["attempted"] > 0
    assert not result["correct"], result["checks"]
