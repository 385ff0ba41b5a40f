"""The PyTorch port stands alone: it imports no jax, flax, optax, msgpack
or nerfmlp_tpu, and no imaging or plotting package (PIL, imageio,
matplotlib: the card's machine has none) — checked in a fresh
interpreter (this test process already holds jax, from conftest) and by
scanning the port's sources and chip_smoke.py."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "nerfmlp_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "nerfmlp_tpu",
             "PIL", "imageio", "matplotlib")


def _port_modules():
    import nerfmlp_torch

    return ["nerfmlp_torch"] + [
        m.name for m in pkgutil.walk_packages(nerfmlp_torch.__path__,
                                              "nerfmlp_torch.")
    ]


def test_port_imports_no_jax_in_a_fresh_interpreter():
    mods = _port_modules()
    assert "nerfmlp_torch.serve" in mods and "nerfmlp_torch.ops.fused_mlp" in mods
    assert {"nerfmlp_torch.parallel.train_step", "nerfmlp_torch.train.loop",
            "nerfmlp_torch.scripts.train", "nerfmlp_torch.data.synthetic",
            "nerfmlp_torch.data.device_pool", "nerfmlp_torch.data.pipeline",
            "nerfmlp_torch.train.metrics", "nerfmlp_torch.render_path",
            "nerfmlp_torch.utils.image", "nerfmlp_torch.utils.cli",
            "nerfmlp_torch.scripts.render_video",
            "nerfmlp_torch.scripts.render_example",
            "nerfmlp_torch.scripts.eval",
            "nerfmlp_torch.scripts.compare_single_view",
            "nerfmlp_torch.scripts.train_only",
            "nerfmlp_torch.scripts.zoom_example",
            "nerfmlp_torch.scripts.serve", "nerfmlp_torch.data.llff",
            "nerfmlp_torch.data.deepvoxels",
            "nerfmlp_torch.train.graph", "nerfmlp_torch.ops.mesh",
            "nerfmlp_torch.scripts.extract_mesh",
            "nerfmlp_torch.parallel.multi_scene",
            "nerfmlp_torch.scripts.train_multi_scene",
            "nerfmlp_torch.train.flax_msgpack",
            "nerfmlp_torch.scripts.make_synthetic_scene",
            "nerfmlp_torch.scripts.convert_checkpoint"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"print(json.dumps(sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f) for d, _, files in os.walk(PORT) for f in files
    if f.endswith(".py")
) + [os.path.join(ROOT, "chip_smoke.py")])
def test_port_sources_import_nothing_forbidden(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
