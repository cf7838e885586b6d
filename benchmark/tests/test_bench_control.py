"""The control: the program with TF32 switched on for its matrix products
(the next precision below the float32 that each configuration states)
has to come out not correct against the cell's limits, on the card, at a
size that a test run holds (the monitors at 8 channels).  Skips without
a card; run on the card with ``python -m pytest benchmark/tests``."""

import pytest

CELLS = ["m0_monitor_c512", "m0_listener_c1", "m2_monitor_c512",
         "m2_listener_c1"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload, small_cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is the card's TF32")
    import calibrate
    from harness import check
    if "monitor" in workload:
        small_cell(workload, channels=8)
    limit = check.limits(workload)
    for control in (False, True):
        (r,) = calibrate.readings(workload, [2 ** 32 + 77], control)
        assert r["correct"] is not control, r
        if control:
            bf16 = {n: r["bf16_" + v["statistic"]][v["arm"]]
                    for n, v in limit.items()}
            assert not check.judge(bf16, limit)[0], r
