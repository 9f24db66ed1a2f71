"""The control comes out not correct: the reference in the port's place,
computed in TF32 throughout, judged as the port is, fails one of each
cell's numbers against the configured limits. Only the numbers the
control itself reads are held: the harness's own (the launch counts, the
rows a window gave) have no control reading. It needs the card (TF32
exists there only) and runs each cell's control at its own size, on one
seed; `benchmark.calibrate --control` reads it on a dozen."""

import pytest

CELLS = ["dkm-match", "lightglue-zeb", "lightglue-match", "dkm-zeb"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    from benchmark.calibrate import control_readings
    from benchmark.harness import registry
    from benchmark.harness.cell import verdict

    cell = registry.cell(name)
    limits = dict(cell.config["limits"]["all"])
    limits.update(cell.config["limits"].get(cell.traffic["kind"], {}))
    readings = control_readings(name, 2**31 + 901, card)
    held = {k: lim for k, lim in limits.items() if k in readings}
    assert set(held) >= {"match_miss"}, readings
    checked = verdict(readings, held)
    assert any(v > lim for v, lim in checked.values()), checked
