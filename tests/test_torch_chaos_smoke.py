"""The chaos smoke run and the obs CLI on the CPU: ``run_smoke`` (2 worker
processes, one fault of each sweep kind) merges bit for bit equal to the
fault-free sweep with the reference's attempt counts, and every command of
``python -m repro_torch.obs`` prints, over that run's journals, exactly the
text of the reference's CLI (``tests/test_chaos.py``'s smoke test and
``tests/test_obs.py``'s CLI tests)."""
import os

import pytest

from repro.obs import cli as j_cli
from repro_torch.obs import cli as t_cli
from repro_torch.streaming import chaos


@pytest.fixture(scope="module")
def smoke_dir(tmp_path_factory):
    """``run_smoke`` on the CPU with 2 workers (its own bitwise and
    attempt-count checks raise on a mismatch)."""
    wd = tmp_path_factory.mktemp("smoke")
    summary = chaos.run_smoke(str(wd), verbose=False, n_workers=2,
                              device="cpu")
    return str(wd), summary


def test_chaos_smoke_bitwise_with_the_reference_attempts(smoke_dir):
    _, summary = smoke_dir
    assert summary["bitwise_equal"]
    assert summary["faults"] == ["kill", "corrupt", "slow", "drop"]
    assert summary["attempts"] == {0: 2, 1: 2, 2: 1, 3: 2}
    assert summary["worker_resumed_steps"][1] == 2


@pytest.mark.parametrize("cmd", [["timeline"], ["timeline", "--last", "5"],
                                 ["summary"], ["prom"], ["gantt"],
                                 ["gantt", "--width", "32"], ["forensics"],
                                 ["forensics", "--plan"]])
def test_obs_cli_text_equals_the_reference(smoke_dir, cmd, capsys):
    """Every command of ``python -m repro_torch.obs`` prints the reference
    CLI's text, with its exit code, over the smoke run's journals (the
    plan's four faults are each attributed to a journal record)."""
    wd, _ = smoke_dir
    args = [cmd[0], wd] + cmd[1:]
    if cmd[-1] == "--plan":
        args.append(os.path.join(wd, "chaos_plan.json"))
    rc = t_cli.main(args)
    got = capsys.readouterr().out
    assert rc == j_cli.main(args) == 0
    assert got == capsys.readouterr().out
    if cmd[-1] == "--plan":
        assert "4/4 plan faults attributed" in got
