"""The training cell's control on the card, at the cell's own size: the
program's checked steps meet every limit, and the reference in float8
e4m3 storage (one precision below the configuration's bfloat16) in the
program's place reads above one of them."""

import sys

import pytest

from portbench import control_train, core


@pytest.mark.card
def test_the_control_fails_where_the_program_passes(card):
    cell = core.find_cell(core.load_bench(), "ft_nin.train_b128")
    limits = cell.config["limits"]

    def log(msg):
        print(msg, file=sys.stderr)

    prog = control_train.readings(cell, [2 ** 32 + 91], card, log)
    ctrl = control_train.readings(cell, [2 ** 32 + 92], card, log, options={
        "storage": cell.config["control"]["storage"]})
    assert all(prog[0][k] <= v for k, v in limits.items()), prog
    assert any(ctrl[0][k] > v for k, v in limits.items()), ctrl
