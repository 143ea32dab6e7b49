"""The control: each configuration's control, put in the program's place,
reads a compared number several times what sound runs of the program read,
and a limit set between the two refuses it.  On the card the same readings
are taken at each cell's own size (``python3 -m benchmark_torch.readings``,
``limits/<cell>.json``); here at a tiny size."""

import pytest

from benchmark_torch import readings, run
from benchmark_torch.tests.conftest import CELLS, tiny

SEEDS = [11, 2 ** 32 + 7, 3_000_000_101]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    cell = tiny(name, {"nbe": 1.0, "info": 0, "perm_diff": 0})
    prog = readings.read(cell, SEEDS, 0.2, False, device="cpu", out=lambda _: None)
    ctl = readings.read(cell, SEEDS, 0.2, True, device="cpu", out=lambda _: None)
    assert min(ctl["nbe"]) >= 3 * max(prog["nbe"])
    limit = (max(prog["nbe"]) * min(ctl["nbe"])) ** 0.5
    judged = tiny(name, {"nbe": limit, "info": 0, "perm_diff": 0})
    result, _ = run.run_cell(judged, SEEDS[0], 0.2, False, device="cpu",
                             factorizer=run.control_factorizer(judged.config),
                             warmup=False, out=lambda _: None)
    assert result["correct"] is False
    result, _ = run.run_cell(judged, SEEDS[0], 0.2, False, device="cpu",
                             out=lambda _: None)
    assert result["correct"] is True
