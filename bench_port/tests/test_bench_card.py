"""The tiny cells through the card's kernels: correct as the program
stands, not correct with the control in its place.  Skips without a card;
on the H100: python -m pytest -m gpu bench_port/tests/test_bench_card.py"""

import time

import pytest
import torch

from bench_port import control, harness, spec
from bench_port.tests.conftest import tiny_copy

CELLS = ["passage.batch-encode", "doc-maxp.batch-preencoded", "passage.batch-preencoded"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_on_the_card(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_copy(tmp_path, dim=128)
    c = spec.find_cell(root, cell)
    out = harness.run_cell(c, 2**33 + 7, 1.0, True, time.perf_counter(), "cuda")
    line = harness.line_of(c, out, True, "cuda")
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    values = control.control_values(c, 2**33 + 7, out, torch.device("cuda"))
    assert not harness.check.judge(values, c.limits)[0], values
