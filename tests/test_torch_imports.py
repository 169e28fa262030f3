"""The PyTorch port stands alone: no JAX, no reference package.

``repro_torch`` must import with ``jax`` blocked, and no module under
``src/repro_torch/`` (nor ``chip_smoke.py``) may import the reference
package ``repro``.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

MODULES = (
    "repro_torch",
    "repro_torch.configs",
    "repro_torch.core",
    "repro_torch.kernels",
    "repro_torch.kernels.direct_conv3d",
    "repro_torch.core.direct_conv",
    "repro_torch.volume",
    "repro_torch.serving",
    "repro_torch.layers",
    "repro_torch.models",
    "repro_torch.kernels.decode_attn",
    "repro_torch.serving.engine",
    "repro_torch.launch.serve",
    "repro_torch.distributed",
    "repro_torch.serving.sharded_engine",
    "repro_torch.tuning",
    "repro_torch.tuning.autotune",
    "repro_torch.core.distributed_inference",
    "repro_torch.distributed.host_group",
    "repro_torch.optim",
    "repro_torch.data",
    "repro_torch.checkpoint",
    "repro_torch.roofline",
    "repro_torch.examples.train_segmentation",
    "repro_torch.examples.quickstart",
    "repro_torch.examples.serve_volume",
    "repro_torch.examples.pipeline_inference",
    "repro_torch.layers.moe",
    "repro_torch.layers.ssm",
    "repro_torch.configs.mixtral_8x7b",
    "repro_torch.configs.grok1_314b",
    "repro_torch.configs.phi3_medium_14b",
    "repro_torch.configs.gemma3_27b",
    "repro_torch.configs.mamba2_2_7b",
    "repro_torch.configs.jamba_v0_1_52b",
    "repro_torch.configs.qwen2_vl_7b",
    "repro_torch.configs.whisper_tiny",
    "repro_torch.layers.stubs",
    "repro_torch.layers.rope",
    "repro_torch.layers.embedding",
    "repro_torch.models.encdec",
    "repro_torch.models.api",
    "repro_torch.launch.train",
    "repro_torch.examples.serve_lm",
)


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules"
        " if sys.modules[k] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr


def _port_files():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(_port_files()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_reference_or_jax_import(path):
    roots = set(_imported_roots(path))
    assert "repro" not in roots, f"{path} imports the reference package"
    assert "jax" not in roots and "jaxlib" not in roots, f"{path} imports JAX"
