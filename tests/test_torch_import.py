"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, and no source file of the port (or chip_smoke.py and the
port's tools) imports them. tests/conftest.py imports JAX into every test process, so the
import check runs in a fresh subprocess."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "nano_pearl_tpu_torch"


def _modules_loaded_by(imports: str, roots=("jax", "jaxlib", "nano_pearl_tpu")) -> list[str]:
    """Modules under ``roots`` (by default JAX and the JAX package) loaded by
    ``imports`` in a fresh process."""
    code = (
        "import json, sys\n"
        f"{imports}\n"
        f"mods = [m for m in sys.modules if m.split('.')[0] in {tuple(roots)!r}]\n"
        "print(json.dumps(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_import_loads_no_jax_in_fresh_process():
    assert _modules_loaded_by(
        "import nano_pearl_tpu_torch\n"
        "from nano_pearl_tpu_torch.engine import engine, fused, pearl, runner\n"
        "from nano_pearl_tpu_torch.ops.cuda import build, paged_attention, prefill_attention\n"
        "from nano_pearl_tpu_torch.ops.cuda import kv_writeback, mono_attention, paged_attention_fallback\n"
        "from nano_pearl_tpu_torch.ops.cuda import paged_attention_partials\n"
        "from nano_pearl_tpu_torch.parallel import mesh, sp\n"
        "from nano_pearl_tpu_torch.ops import kv_cache, quant\n"
        "from nano_pearl_tpu_torch.utils import layer_share"
    ) == []


def test_parallel_and_native_modules_load_no_jax_in_fresh_process():
    """Tensor parallelism, data parallelism and the native block manager's
    binding import no JAX either."""
    assert _modules_loaded_by(
        "from nano_pearl_tpu_torch.parallel import sharding, tp_attn\n"
        "from nano_pearl_tpu_torch.engine import dp, native"
    ) == []


def test_server_import_loads_no_jax_in_fresh_process():
    assert _modules_loaded_by("import nano_pearl_tpu_torch.serve") == []


def test_loader_loads_no_jax_safetensors_or_transformers():
    """The checkpoint loader reads safetensors files itself: the card's
    host has neither package."""
    roots = ("jax", "jaxlib", "nano_pearl_tpu", "safetensors", "transformers")
    assert _modules_loaded_by("from nano_pearl_tpu_torch.utils import loader", roots) == []


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py"))
    + [REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_port.py", REPO / "tools" / "probe_decode_padding.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_imports_no_jax(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "nano_pearl_tpu"), f"{path.name} imports {mod}"
