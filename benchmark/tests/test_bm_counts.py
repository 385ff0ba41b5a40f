"""The yardstick's counts, pinned: the 8x256 net's multiply-adds, the
evaluations a ray costs, the backward at twice the forward, which bound
each call meets, and the arithmetic of the rooflines and of MFU."""

from __future__ import annotations

import pytest

from benchmark import counts, harness

NET = {"depth": 8, "width": 256, "skips": [5], "pos_enc_L": 10,
       "dir_enc_L": 4, "use_viewdirs": True}


def test_forward_macs_of_the_8x256_net():
    assert counts.macs_per_point(NET) == 593_408


def test_macs_are_the_program_nets_weights():
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.models.mlp import NeRFMLP

    net = NeRFMLP(RenderConfig().model_config())
    weights = sum(p.numel() for n, p in net.named_parameters()
                  if n.endswith("weight"))
    biases = sum(p.numel() for n, p in net.named_parameters()
                 if n.endswith("bias"))
    assert weights == counts.macs_per_point(NET)
    assert biases == counts.n_biases(NET)


@pytest.mark.parametrize("cell, evals", [("paper_train", 192),
                                         ("turbo_train", 64)])
def test_evaluations_per_ray(cell, evals):
    render = harness.load_cell(cell).config["render"]
    assert counts.evals_per_ray(render) == evals


def test_separate_fine_requeries_only_without_a_grid():
    r = {"N_samples": 64, "N_importance": 128, "separate_fine": True}
    assert counts.evals_per_ray(r) == 256
    r.update(use_occupancy=True, N_samples=16, N_importance=48)
    assert counts.evals_per_ray(r) == 64


@pytest.mark.parametrize("points", [16_384, 65_536, 131_072, 786_432])
def test_backward_is_twice_the_forward(points):
    assert counts.bwd_work(NET, points)[0] == 2 * counts.fwd_work(
        NET, points)[0]


@pytest.mark.parametrize("points", [16_384, 49_152, 65_536, 131_072,
                                    262_144, 524_288, 786_432])
def test_every_call_of_the_cells_is_bound_by_operations(points):
    for work in (counts.fwd_work, counts.bwd_work):
        assert counts.least_time(*work(NET, points))[1] == "operations"


def test_a_thin_net_is_bound_by_bytes():
    thin = dict(NET, depth=1, width=16, skips=[])
    assert counts.least_time(*counts.fwd_work(thin, 65_536))[1] == "bytes"


def test_fine_call_bound_and_step_flops():
    t, _ = counts.least_time(*counts.fwd_work(NET, 131_072))
    assert t == pytest.approx(0.1573e-3, rel=1e-3)
    render = harness.load_cell("paper_train").config["render"]
    assert counts.train_useful_flops(NET, render, 1024) == pytest.approx(
        0.700e12, rel=1e-3)


def test_step_and_frame_calls():
    paper = harness.load_cell("paper_train").config["render"]
    turbo = harness.load_cell("turbo_train").config["render"]
    assert counts.step_calls(paper, 1024) == [65_536, 131_072]
    assert counts.step_calls(turbo, 1024) == [16_384, 49_152]
    assert len(counts.frame_calls(paper, 400 * 400, 4096)) == 80
    assert counts.frame_calls(turbo, 400 * 400, 16_384)[:2] == [
        262_144, 786_432]
    assert counts.refresh_points(turbo) == 262_144


def test_roofline_and_mfu_arithmetic():
    kernels = [("void fused_mlp_fwd_kernel<128>(float*)", 0.0, 500.0),
               ("bwd_phase1_kernel<64>", 600.0, 1000.0),
               ("at::native::elementwise_kernel", 1700.0, 100.0)]
    least = counts.least_time(*counts.fwd_work(NET, 131_072))[0]
    assert counts.roofline_pct(kernels, "fwd", [131_072], NET) == \
        pytest.approx(100 * least / 500e-6)
    assert counts.other_seconds(kernels) == pytest.approx(100e-6)
    assert counts.roofline_pct([], "fwd", [131_072], NET) is None
    assert counts.mfu_pct(989e12, 1.0) == pytest.approx(100.0)
