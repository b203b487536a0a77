"""Each cell's limits are the rule of `portbench/sweep.py` applied to the
readings committed in `portbench/limits/<cell>.json`, so that none is set
by hand: each lies above every sound reading, and every run of a planted
fault, and of the control, fails the cell on some number."""

import json

import pytest

from portbench import harness, sweep
from tiny import OVERRIDES

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
DATA = {c: sweep.load(c) for c in CELLS}
RUNS = {c: sweep.tree_runs(DATA[c]) for c in CELLS}
NUMBERS = [(c, n) for c in CELLS for n in harness.workload(c)["limits"]]
SOUND_SEEDS, CHECK_SEEDS = 48, 8


def _sources(cell):
    return sorted({r["source"] for r in RUNS[cell]})


@pytest.mark.parametrize("cell", CELLS)
def test_readings_cover_the_seeds(cell):
    runs = RUNS[cell]
    assert set(_sources(cell)) == {"sound", "control", "fault:frozen_state",
                                   "fault:half_batch"}
    for source in _sources(cell):
        seeds = {r["seed"] for r in runs if r["source"] == source}
        assert len(seeds) >= (SOUND_SEEDS if source == "sound"
                              else CHECK_SEEDS)
    compared = set(harness.workload(cell)["limits"])
    assert all(compared <= set(r["numbers"]) for r in runs)


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_compares_each_number_that_has_an_upper_at_its_limit(cell):
    assert harness.workload(cell)["limits"] == sweep.limits(
        RUNS[cell], DATA[cell]["before"])


@pytest.mark.parametrize("cell,number", NUMBERS)
def test_limit_is_the_rule_of_the_readings(cell, number):
    got = sweep.rule(RUNS[cell])[number]
    limit = harness.workload(cell)["limits"][number]
    # the rule's, or the limit that stood before where that is higher
    assert limit in (sweep.two_figures(got["limit"]),
                     DATA[cell]["before"].get(number))
    assert sweep.two_figures(got["limit"]) <= limit
    assert got["lower"] < limit < got["upper"]


@pytest.mark.parametrize("cell,number", NUMBERS)
def test_limit_lies_above_every_sound_reading(cell, number):
    limit = harness.workload(cell)["limits"][number]
    assert all(r["numbers"][number] < limit for r in RUNS[cell]
               if r["source"] == "sound")


@pytest.mark.parametrize("cell,source", [
    (c, s) for c in CELLS for s in ("fault:frozen_state", "fault:half_batch",
                                    "control")])
def test_every_fault_and_control_seed_fails_the_cell(cell, source):
    limits = harness.workload(cell)["limits"]
    runs = [r for r in RUNS[cell] if r["source"] == source]
    assert runs and all(sweep.fails(r, limits) for r in runs)


def test_the_rule():
    runs = ([{"source": "sound", "numbers": {"a": v, "b": v}}
             for v in (1e-6, 4e-6, 2e-6)]
            + [{"source": "control", "numbers": {"a": 2e-5, "b": 1e-5}},
               {"source": "control", "numbers": {"a": 3e-5, "b": 2e-5}},
               {"source": "fault:x", "numbers": {"a": 1e-3, "b": 3e-5}},
               {"source": "fault:x", "numbers": {"a": None, "b": 1.0}}])
    got = sweep.rule(runs)
    # a: the control's least (2e-5) is five times the lower
    assert got["a"]["upper"] == 2e-5 and got["a"]["from"] == "control"
    assert got["a"]["limit"] == pytest.approx(4e-6 ** 0.35 * 2e-5 ** 0.65)
    # b: the control's 1e-5 is under three times, the fault's under ten
    assert got["b"]["upper"] is None and got["b"]["limit"] is None
    assert sweep.limits(runs) == {"a": 1.1e-5}
    # a limit that stood before stays where it is higher, under the upper
    assert sweep.limits(runs, {"a": 1.5e-5}) == {"a": 1.5e-5}
    assert sweep.limits(runs, {"a": 1e-5}) == {"a": 1.1e-5}
    assert sweep.limits(runs, {"a": 3e-5}) == {"a": 1.1e-5}
    assert sweep.fails(runs[-1], {"a": 1.0}) == ["a"]


def test_read_one_keeps_every_number_and_the_worst_leaves():
    import torch

    torch.set_num_threads(2)
    cell = "ris_dec_train"
    rec = sweep.read_one(cell, 4000000021, "sound", torch.device("cpu"),
                         OVERRIDES[cell])
    assert set(harness.workload(cell)["limits"]) < set(rec["numbers"])
    assert not sweep.fails(rec, harness.workload(cell)["limits"])
    assert set(rec["worst"]) == {"gradient", "change"}
    assert rec["traffic"] == harness.workload(cell)["traffic"]


def test_derive_keeps_the_runs_and_the_limits_before(tmp_path, monkeypatch,
                                                     capsys):
    cell = "ris_aec_train"
    traffic = harness.workload(cell)["traffic"]
    runs = [{"cell": cell, "tree": t, "traffic": f, "source": src,
             "seed": seed, "numbers": {"loss_gap": v}, "worst": None}
            for t, f, src, seed, v in [("new", traffic, "sound", 2, 1e-7),
                                       ("new", traffic, "sound", 1, 2e-7),
                                       ("new", traffic, "fault:x", 3, 1e-2),
                                       ("new", "other", "sound", 4, 9e-7),
                                       ("old", traffic, "sound", 1, 5e-7)]]
    path = tmp_path / "runs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in runs))
    monkeypatch.setattr(sweep, "LIMITS", tmp_path / "limits")
    assert sweep.main(["derive", "--workload", cell, "--tree", "new",
                       str(path)]) == 0
    data = sweep.load(cell)
    assert data["before"] == harness.workload(cell)["limits"]
    assert data["traffic"] == traffic
    assert [(r["tree"], r["seed"]) for r in data["runs"]] == [
        ("new", 3), ("new", 1), ("new", 2), ("new", 4), ("old", 1)]
    want = sweep.limits(sweep.tree_runs(data), data["before"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == want
    assert want == {"loss_gap": sweep.two_figures(2e-7 ** 0.35
                                                  * 1e-2 ** 0.65)}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [46304957, 469903368])
def test_seeds_that_read_over_the_old_limit_are_correct(seed, card):
    """Two seeds on which sound runs of `ris_aec_train` read
    `change_gap_median` over the limit it had before the sweep (9.1e-5
    and 1.24e-4 against 7.6e-5) read `correct`, at the cell's size."""
    from portbench import run

    line, _ = run.run_cell("ris_aec_train", seed, 1.0, False, card)
    assert line["correct"] is True, line["compared"]
