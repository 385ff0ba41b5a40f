"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, at a tiny size on
the CPU (the run skips only the look for a card). A sound run at the
same size comes out correct. The half batch is caught at this size by
``paper_train``'s limits only, and at the cells' own size by neither
training cell's (PERF.md, Open questions)."""

from __future__ import annotations

import pytest

from benchmark.tests._tiny import tiny_run

TRAIN = ["paper_train", "turbo_train"]
SERVE = ["paper_serve", "turbo_serve"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    line = tiny_run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    from nerfmlp_torch.parallel import train_step

    monkeypatch.setattr(train_step.Adam, "step",
                        lambda self, grads, lr: None)
    assert not tiny_run(cell)["correct"]


@pytest.mark.parametrize("cell", ["paper_train"])
def test_half_batch_is_caught(cell, monkeypatch):
    from nerfmlp_torch.parallel import train_step

    whole = train_step.loss_and_metrics

    def half(params, batch, *args, **kw):
        return whole(params, batch[: batch.shape[0] // 2], *args, **kw)

    monkeypatch.setattr(train_step, "loss_and_metrics", half)
    assert not tiny_run(cell)["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answer_is_caught(cell, monkeypatch):
    from nerfmlp_torch.ops import render

    whole = render.render_image_maps

    def altered(*args, **kw):
        out = whole(*args, **kw)
        rgb = out["rgb_map"]
        rgb[: rgb.shape[0] // 4] = 1.0 - rgb[: rgb.shape[0] // 4]
        return out

    monkeypatch.setattr(render, "render_image_maps", altered)
    assert not tiny_run(cell)["correct"]
