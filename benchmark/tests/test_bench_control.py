"""On the card: the control (the plain reference in the program's place,
its float32 matrix products in TF32) comes out not correct on three seeds,
at the cell's own size, under each cell's limits. Run it on the card with
python -m pytest benchmark/tests/test_bench_control.py."""

import pytest

from benchmark import harness, readings


@pytest.mark.card
@pytest.mark.parametrize("cell", ["aloam_hdl64.replay4", "lego_vlp16.replay4",
                                  "aloam_hdl64.live1"])
def test_control_is_not_correct(card, cell):
    rows = readings.readings(harness.load_cell(cell), [], [4000000001, 4000000002, 4000000003],
                             3.0, card)
    assert len(rows) == 3 and not any(r["correct"] for r in rows)
