"""On the card, at each cell's own size: the program's readings lie
within the cell's limits, and the control (the reference in the precision
below the configuration's) and every planted fault break at least one of
them.  `python3 -m pytest portbench/tests -m card` on a machine with a
card; they skip elsewhere."""

import pytest

from portbench import control, run as pr
from portbench.tests import helpers

SEED = 2**31 + 101


@pytest.mark.card
@pytest.mark.parametrize("name", helpers.BENCHMARK_CELLS)
def test_control_and_faults_fail_the_limits(name, card):
    limits = pr.load_json(helpers.ROOT / "portbench" / "limits"
                          / f"{name}.json")["limits"]
    got = control.readings(helpers.ROOT, name, SEED, card, seconds=10.0)
    for k, limit in limits.items():
        assert got["program"][k] <= limit, (k, got["program"])
    broken = [k for k in got if k not in ("workload", "seed", "program")
              and isinstance(got[k], dict)]
    assert "control" in broken and len(broken) >= 2
    for k in broken:
        assert any(got[k][n] > limit for n, limit in limits.items()), (
            k, got[k])
