"""The PyTorch port and chip_smoke.py import nothing of JAX or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "equivarianttransformermpnn4quantumcomputations_tpu_torch"
TPU_PKG = "equivarianttransformermpnn4quantumcomputations_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [pytest.param(f, id=str(f.relative_to(ROOT))) for f in files]


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources())
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"
        assert not (mod == TPU_PKG or mod.startswith(TPU_PKG + ".")), (
            f"{path.name} imports the JAX package ({mod})"
        )


def test_port_has_every_module_of_the_slice():
    for rel in ("ops/irreps.py", "ops/wigner_np.py", "ops/sph.py",
                "ops/rotation.py", "ops/segment.py", "ops/s2grid.py",
                "ops/cuda/rotate_dense.py", "ops/cuda/s2act.py",
                "nn/activations.py", "nn/layers.py", "nn/norms.py",
                "nn/so3_layers.py", "nn/embedding.py", "nn/gata.py",
                "nn/attention.py", "nn/ffn.py", "nn/block.py",
                "models/backbone.py", "models/matpes.py", "data/graph.py",
                "utils/convert.py", "inference.py",
                "data/synthetic.py", "data/loader.py", "configs/matpes.py",
                "train/schedules.py", "train/trainer.py", "train/checkpoint.py",
                "train/train_matpes.py", "utils/logging.py", "utils/profiling.py",
                "csrc/rotate_dense.cu", "csrc/s2act.cu",
                "ops/cuda/so2conv.py", "csrc/so2conv.cu", "models/qm9.py",
                "data/qm9.py", "configs/qm9.py", "train/train_qm9.py",
                "train/test_qm9.py", "ops/cuda/rotate.py", "csrc/rotate.cu",
                "models/oc20.py", "configs/oc20.py", "data/periodic.py", "data/extxyz.py",
                "data/oc20.py", "train/train_oc20.py", "train/test_oc20.py",
                "data/matpes.py", "train/test_matpes.py", "parallel/multihost.py",
                "parallel/data_parallel.py", "data/native.py", "csrc/neighborlist.cpp",
                "nn/partition.py", "parallel/sharding.py", "parallel/pipeline.py",
                "utils/port.py", "nn/remat.py", "data/prep.py", "utils/plots.py"):
        assert (PORT / rel).is_file(), rel


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without CUDA (as here) the script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, cwd=tmp_path, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
