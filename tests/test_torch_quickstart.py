"""The port's quickstart (``python -m repro_torch.quickstart``) on the CPU,
against the reference's examples/quickstart.py run on the same data."""
import re
import sys
from pathlib import Path

import numpy as np

from repro_torch import quickstart


def test_quickstart_main_runs_and_matches_reference(capsys):
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    for line in ("S-DOT :", "SA-DOT:", "OI    :", "worst cross-node"):
        assert line in out
    assert got["sdot"] < 1e-5 and got["sadot"] < 1e-5 and got["oi"] < 1e-5
    assert got["disagreement"] < 1e-5

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    try:
        import quickstart as ref_quickstart
        ref_quickstart.main()
    finally:
        sys.path.pop(0)
    ref_out = capsys.readouterr().out
    ref_errs = {line.split(":")[0].strip(): float(re.search(
        r"final subspace error (\S+)", line).group(1))
        for line in ref_out.splitlines() if "final subspace error" in line}
    # the same data and graph; both runs sit at the f32 floor
    np.testing.assert_allclose(got["sdot"], ref_errs["S-DOT"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["sadot"], ref_errs["SA-DOT"], rtol=0,
                               atol=1e-5)
