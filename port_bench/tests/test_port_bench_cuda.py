"""On the card, at each cell's own size: the window reads every
end-to-end metric of the cell, a sound run of the program passes the
cell's limits and the control (the f32 reference computed in
fp8, put in the program's place) fails them. Run on the card with
`python -m pytest port_bench/tests/test_port_bench_cuda.py -q`; without
one these tests skip."""

import pytest
import torch

from port_bench import compare, harness

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEED = 2**31 + 4242


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels are CUDA C++ with no CPU mode")
    import os

    from port_bench import program

    os.environ.update(harness.cache_env())
    program.build_kernels()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(card, name):
    cell = harness.Cell(name)
    drv = cell.driver().Driver(cell, SEED, card)
    drv.setup()
    res = drv.window(1.0)
    for m in cell.end_to_end:                  # every reading the window owes, above 0
        if m["name"] != "setup_s":
            assert res["metrics"][m["name"]] > 0, m["name"]
    drv.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = drv.reference_answers()
    ok, checks = compare.judge(drv.numbers(ref), cell.mix["limits"])
    assert ok, checks
    ok, checks = compare.judge(drv.gaps(drv.reference_answers(fp8=True), ref), cell.mix["limits"])
    assert not ok, checks
