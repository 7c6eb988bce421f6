"""Each cell at a tiny size on the CPU, through the port's plain paths:
the run agrees with the frozen reference; each of the configuration's
controls and every planted fault come out not correct under the cell's
limits."""

import pytest
import torch

from portbench import check, faults, reference, run

from ._tiny import tiny_cell

CELLS = ["mistral7b-train-b4-t4096", "mixtral8x7b-train-b2-t4096",
         "mistral7b-train-b1-t32768"]
SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_agrees_with_the_reference(name):
    res, side = run.run_cell(tiny_cell(name), SEED, 0.2, False, "cpu")
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in
                                   run.load_cell(name).end_to_end}
    assert list(res)[-1] == "check"
    assert side["program_losses"][2] < side["program_losses"][0]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    n = cell.mix["checked_steps"]
    batches = list(run.token_batches(cell.conf, cell.mix, SEED, CPU)[:n])
    ref = reference.train(cell.conf, SEED, batches, CPU)
    for precision in cell.conf["control"]:
        ctl = reference.train(cell.conf, SEED, batches, CPU,
                              precision=precision)
        assert not check.verdict(check.readings(ctl, ref), cell.limits), \
            precision


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    with faults.planted(fault):
        res, _ = run.run_cell(tiny_cell(name), SEED, 0.1, False, "cpu")
    assert not res["correct"], res["check"]
