"""The two chip_smoke.py bars that replaced bars the backward's fp32
summation order moved, held on the CPU as pure functions.

* Phase 10's ``vertex_bar`` (the kernel's mesh against its plain
  version's), on an analytic density volume at 64^3: it passes a volume
  with a few isolated near-threshold flips, which the bar it replaced (every
  kernel vertex within a cell diagonal of the plain mesh) fails; it fails a
  patch of surface moved by two diagonals, and a field scaled by 3% over a
  region where it is steep, which moves the surface by a tenth of a cell
  (the old bar passes it).
* Phase 11's ``stack_gap`` (every scene and net of a stack against a solo
  step seeded as that scene), on the port's CPU stack and
  tests/test_torch_multi_scene.py's fixtures: it passes the stack as it is
  and fails one whose scenes' batches or weights were swapped.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.ops.mesh import mesh_from_volume
from nerfmlp_torch.parallel import multi_scene as ms
from nerfmlp_torch.parallel import train_step as ts
from test_torch_multi_scene import B, BOUNDS, KW, S, _batches

G = 64
THR = 25.0
RADIUS = 0.8


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid():
    """(G, G, G, 3) node positions over chip_smoke's box, axis 0 = x."""
    lo, hi = np.asarray(cs.OCC_AABB[:3]), np.asarray(cs.OCC_AABB[3:])
    axes = [np.linspace(lo[a], hi[a], G) for a in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1)


def _ball(radius, slope):
    """THR * exp(slope (radius - r)): the threshold's level set is the
    sphere of ``radius``, crossed at ``slope`` THR a unit length."""
    r = np.linalg.norm(_grid(), axis=-1)
    return (THR * np.exp(slope * (radius - r))).astype(np.float32)


def _diag():
    return float(np.linalg.norm((np.asarray(cs.OCC_AABB[3:])
                                 - np.asarray(cs.OCC_AABB[:3])) / (G - 1)))


def _nearest(a, b, rows=1024):
    """Distance from each point of ``a`` to the nearest point of ``b``."""
    bt = torch.from_numpy(b).double()
    return torch.cat([torch.cdist(torch.from_numpy(a[s:s + rows]).double(),
                                  bt).min(1).values
                      for s in range(0, len(a), rows)]).numpy()


def _volumes(case):
    """(the kernel's volume, the plain version's) for ``case``."""
    rng = np.random.default_rng(0)
    if case == "isolated_flips":
        plain = _ball(RADIUS, 6.0)
        # The two volumes' rounding, and three isolated nodes far outside
        # the surface that lie just below the threshold in the plain
        # volume and just above it in the kernel's: blobs 0.4 away.
        kernel = plain + rng.normal(0.0, 1e-4, plain.shape).astype(
            np.float32)
        for ijk in ((10, 32, 32), (54, 32, 32), (32, 32, 57)):
            plain[ijk] = THR * (1 - 1e-4)
            kernel[ijk] = THR * (1 + 1e-4)
        return kernel, plain
    if case == "patch_moved":
        # The cap x > 0.4 of the sphere (a quarter of its area) moved out
        # by two cell diagonals, where the field is well conditioned.
        plain = _ball(RADIUS, 6.0)
        moved = _ball(RADIUS + 2 * _diag(), 6.0)
        return np.where(_grid()[..., 0] > 0.4, moved, plain), plain
    # "steep_scaled": the field 3% high over z > 0, where it falls by
    # ~40% of the threshold a cell: the surface moves by 0.08 of a cell.
    plain = _ball(RADIUS, 6.0)
    kernel = np.where(_grid()[..., 2] > 0.0, plain * np.float32(1.03),
                      plain)
    return kernel.astype(np.float32), plain


@pytest.mark.parametrize("case, new_ok, old_ok", [
    ("isolated_flips", True, False),
    ("patch_moved", False, False),
    ("steep_scaled", False, True),
])
def test_vertex_bar(case, new_ok, old_ok):
    """vertex_bar against the bar it replaced, on three volume pairs; a
    failing pair fails by the share of vertices in flipped cells, the
    vertices outside them held within a diagonal both ways."""
    kernel, plain = _volumes(case)
    vk, _ = mesh_from_volume(kernel, cs.OCC_AABB, THR)
    vp, _ = mesh_from_volume(plain, cs.OCC_AABB, THR)
    k_to_p, p_to_k = _nearest(vk, vp), _nearest(vp, vk)
    bar = cs.vertex_bar(kernel, plain, THR, cs.OCC_AABB, vk, vp, k_to_p,
                        p_to_k)
    diag = _diag()
    assert bar["diag"] == pytest.approx(diag)
    assert (k_to_p.max() <= diag) == old_ok
    assert bar["ok"] == new_ok, cs.vertex_bar_line(bar)
    for tag in ("kernel", "plain"):
        assert bar[tag]["max_outside"] <= diag
        assert (bar[tag]["share"] <= cs.MESH_FLIP_SHARE) == new_ok
    assert bar["flipped"] > 0


def test_cell_share_reads_every_cell_around_a_vertex():
    """A vertex inside a cell reads that cell; one on a face, an edge or a
    node reads every cell whose closed cube holds it."""
    cells = np.zeros((4, 4, 4), bool)
    cells[1, 2, 3] = True
    box_min, cell = np.zeros(3), np.ones(3)
    verts = np.array([[1.5, 2.5, 3.5],    # inside
                      [2.0, 2.5, 3.5],    # on the face x = 2
                      [1.0, 2.0, 4.0],    # on the node (1, 2, 4)
                      [0.5, 2.5, 3.5],    # in the next cell in x
                      [2.5, 2.5, 3.5]])   # in the cell after it
    np.testing.assert_array_equal(
        cs.cell_share(verts, cells, box_min, cell),
        [True, True, True, False, False])


def _stack_and_solos(rc, tc, batch, swap):
    """The port's CPU stack stepped twice on ``batch`` (scenes 0 and 1
    swapped as ``swap`` says), and a solo state a scene stepped twice on
    its own rows."""
    state = ms.create_multi_scene_state(S, rc, tc, device="cpu")
    step = ms.make_multi_scene_step(rc, tc, with_bounds=True)
    bounds = torch.from_numpy(BOUNDS)
    fed = batch[[1, 0, 2]] if swap == "batches" else batch
    for k in range(2):
        step(state, fed, bounds)
        if swap == "weights" and k == 0:
            with torch.no_grad():
                for key, stack in state.params.items():
                    for p, q in zip(stack.nets[0].parameters(),
                                    stack.nets[1].parameters()):
                        tmp = p.clone()
                        p.copy_(q)
                        q.copy_(tmp)
    solos = []
    for s in range(S):
        solo = ts.create_train_state(
            rc, dataclasses.replace(
                tc, seed=tc.seed + ms.SCENE_SEED_STRIDE * s), device="cpu")
        fn = ts.make_step_fn(rc, tc)
        for _ in range(2):
            fn(solo, batch[s], None, bounds[s])
        solos.append(solo.params)
    return state.params, solos


@pytest.mark.parametrize("swap", [None, "batches", "weights"])
@pytest.mark.parametrize("separate_fine", [False, True])
def test_stack_gap(swap, separate_fine):
    """stack_gap holds every scene of the stack as it is (exactly 0 on the
    CPU) and fails the two scenes whose batches or weights were swapped,
    in every net; the third scene still holds."""
    rc = RenderConfig(**dict(KW, perturb=True, separate_fine=separate_fine))
    tc = TrainConfig(batch_size=B, seed=4,
                     coarse_loss=separate_fine)
    stack, solos = _stack_and_solos(rc, tc, torch.from_numpy(_batches(7)),
                                    swap)
    assert sorted(stack) == (["coarse", "fine"] if separate_fine
                             else ["coarse"])
    gap = cs.stack_gap(stack, solos)
    if swap is None:
        assert gap == [0.0] * S
        return
    assert min(gap[:2]) > 100 * cs.PARAM_ATOL, gap
    assert gap[2] <= cs.PARAM_ATOL
    if separate_fine:
        # The fine net alone departs too.
        assert max(cs.stack_gap({"fine": stack["fine"]},
                                [{"fine": s["fine"]} for s in solos])[:2]) \
            > 100 * cs.PARAM_ATOL


def test_stack_gap_needs_the_same_nets():
    rc = RenderConfig(**dict(KW, perturb=False))
    tc = TrainConfig(batch_size=B, seed=4)
    stack = ms.create_multi_scene_state(S, rc, tc, device="cpu").params
    solo = ts.create_train_state(rc, tc, device="cpu").params
    with pytest.raises(ValueError, match="nets"):
        cs.stack_gap(stack, [dict(solo, fine=solo["coarse"])] * S)
