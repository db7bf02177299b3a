"""The control on the card, at a size a test run holds: the serving cell
with its control (the Predictor's own int8 path, one precision below the
configuration's bf16) in the program's place reads above the limit that
the program itself meets."""

import sys

import pytest

from portbench import control, core


@pytest.mark.card
def test_the_control_fails_where_the_program_passes(card):
    cell = core.find_cell(core.load_bench(), "zs_ncaltech.batch32")
    cell.traffic = dict(cell.traffic, check={"streams": 32})
    limits = cell.config["limits"]

    def log(msg):
        print(msg, file=sys.stderr)

    prog = control.readings(cell, [2 ** 32 + 71], 2.0, card, None, log)
    ctrl = control.readings(cell, [2 ** 32 + 72], 2.0, card,
                            cell.config["control"], log)
    assert all(prog[0][k] <= v for k, v in limits.items()), prog
    assert any(ctrl[0][k] > v for k, v in limits.items()), ctrl
    # recordings' answers lie far apart beside what bfloat16 moves
    assert prog[0]["spread_median"] > 10 * prog[0]["bf16_median"]
