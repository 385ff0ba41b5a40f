"""On a card: the program passes its cell's limits and the precision
control (the reference with fp8 products in the program's place) and
each planted fault fail them, at the cell's own size, on three seeds.
Skips without a card. The half batch of the training cells is not
caught on every seed by any number with an upper reading (PERF.md, Open
questions), and is left out here."""

from __future__ import annotations

import pytest

from benchmark import calibrate, harness

SEEDS = (6100000007, 6200000003, 6300000001)
FAULTS = ("control", "half_batch", "altered_answer")
OPEN = {"paper_train": ("half_batch",), "turbo_train": ("half_batch",)}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.run import cache_dirs

    cache_dirs(harness.ROOT)
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paper_train", "turbo_train",
                                  "paper_serve", "turbo_serve"])
def test_control_and_faults_fail_the_limits(card, cell):
    c = harness.load_cell(cell)
    one = (calibrate.train_seed if c.traffic["kind"] == "train"
           else calibrate.frames_seed)
    recs = [one(c, seed, card, True) for seed in SEEDS]
    for rec in recs:
        assert harness.compare(rec["program"], c.limits)[0], rec["program"]
        for kind in FAULTS:
            if kind in rec and kind not in OPEN.get(cell, ()):
                assert not harness.compare(rec[kind], c.limits)[0], (kind,
                                                                     rec)
