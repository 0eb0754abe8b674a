"""The control comes out not correct: the reference put in the program's
place, one precision below the configuration's (TF32 below float32, float8
e4m3 below bfloat16), judged by each cell's limits, at a CPU size. On the
card, benchmark/control.py reads the same numbers at the cells' own sizes."""

import pytest
import torch

from benchmark import control, core, reference


@pytest.mark.parametrize("cell", ["sift1m-f32.batch16k", "sift1m-bf16.batch16k", "sift1m-f32.churn"])
def test_control_fails_the_limits_the_program_meets(cell, tiny):
    spec, cfg, tr, lims = tiny(cell)
    got = list(control.readings(cell, [21, 22], {21, 22}, 0.3, torch.device("cpu"), spec=spec,
                                cfg=cfg, traffic=tr))
    program = [r["numbers"] for r in got if r["side"] == "program"]
    below = reference.CONTROL[cfg["build"]["precision"]]
    lower = [r["numbers"] for r in got if r["side"] == below]
    assert len(program) == 2 and len(lower) == 2
    for numbers in program:
        ok, checks = core.judge(numbers, lims)
        assert ok, checks
    for numbers in lower:
        ok, checks = core.judge(numbers, lims)
        assert not ok, checks
