"""The port's example twins (``python -m repro_torch.feature_partitioned_fdot``
and ``python -m repro_torch.block_partitioned_bdot``) on the CPU, against
the reference's examples run on the same data: both end in ``OK``, and
their final subspace errors, each at the f32 floor from its own init, lie
within 1e-5 of each other."""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import block_partitioned_bdot, feature_partitioned_fdot


@pytest.mark.parametrize("twin,script", [
    (feature_partitioned_fdot, "feature_partitioned_fdot"),
    (block_partitioned_bdot, "block_partitioned_bdot")])
def test_example_twin_ends_ok_and_matches_reference(twin, script, capsys):
    got = twin.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert got["final_err"] < 1e-4 and got["ortho"] < 1e-5

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    try:
        ref = __import__(script)
        ref.main()
    finally:
        sys.path.pop(0)
    ref_out = capsys.readouterr().out
    assert ref_out.rstrip().endswith("OK")
    ref_err = float(re.search(r"final subspace error: (\S+)",
                              ref_out).group(1))
    np.testing.assert_allclose(got["final_err"], ref_err, rtol=0, atol=1e-5)
