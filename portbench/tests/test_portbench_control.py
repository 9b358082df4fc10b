"""The control of each cell on the card: the plain reference computed in
the nearest precision below the configurations' float32 with TF32 off
(float32, every matrix product's operands rounded to TF32) stands in for
the program and must fail the cell's check, while the program passes it.
At reduced sizes that a test run holds; the readings that set the limits
were taken at the cells' own sizes (``python3 -m portbench.calibrate``,
PERF.md)."""

import pytest

from portbench import calibrate, run

SIZES = {
    "ba-venice1778.cg": (dict(cameras=200, points=50_000, observations=251_630), {}, 4),
    "fachada.fleet64": ({}, dict(lanes=16, pool=2, checked=8), 2),
    "fachada.request": ({}, dict(pool=8, round=8, checked=8), 8),
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("seed", [3_100_000_001, 3_100_000_002, 3_100_000_003])
def test_the_control_fails_where_the_program_passes(card, name, seed):
    config, traffic, units = SIZES[name]
    c = run.cell(name)
    c.config.update(config)
    c.traffic.update(traffic)
    r = calibrate.readings(c, seed, units, control=True, device=card)
    limits = c.config["limits"]
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
