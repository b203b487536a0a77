"""Whole runs of each cell at a tiny size on the CPU: the result line's
keys, `correct` on sound runs, and `correct` false with the timed path
broken underneath (each fault the cell can have) and with the control in
the program's place."""

import json

import pytest

from tiny import bench, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device",
        "setup_built", "compared"]
TRAIN = ["das_aec_train", "ris_aec_train", "das_dec_train", "ris_dec_train"]


@pytest.mark.parametrize("cell", TRAIN + ["das_serve"])
def test_sound_run_is_correct_with_the_contract_keys(cell):
    line = run_tiny(cell)
    assert list(line) == KEYS  # `compared` comes last
    json.dumps(line, allow_nan=False)
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 3
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["das_aec_train", "das_serve"])
def test_traced_run_reports_per_layer_metrics(cell):
    line = run_tiny(cell, traced=True)
    assert line["correct"] is True
    names = set(line["metrics"])
    assert names and not names & {"setup_s", "peak_device_mib"}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in TRAIN for f in ("frozen_state", "half_batch")
] + [("das_serve", "altered_answer")])
def test_a_fault_makes_the_run_incorrect(cell, fault):
    line = run_tiny(cell, mode=f"fault:{fault}")
    assert line["correct"] is False


def _control_fails(line):
    assert line["correct"] is False
    assert [n for n, c in line["compared"].items()
            if c["value"] > c["limit"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN + ["das_serve"])
def test_the_control_is_not_correct(cell, card):
    """The reference one precision below the configuration's (a float32
    STFT, TF32 on) in the program's place fails one of the cell's numbers;
    on the card, since the CPU has no TF32."""
    if cell == "das_serve":  # its own mix: the largest answers hold the gap
        from portbench import run

        line, _ = run.run_cell(cell, 4000000002, 1.0, False, card, "control",
                               overrides={"clients": 2}, bench=bench())
        _control_fails(line)
        return
    _control_fails(run_tiny(cell, mode="control", device=card))
