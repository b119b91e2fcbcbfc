"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package (``repro``), and its entry
points run on the card unless the caller asks for the CPU — with no card
they raise instead of quietly running on the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _violations(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "jax":
            yield f"{path.name}:{node.lineno}: jax.{node.attr}"
            continue
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                yield f"{path.name}:{node.lineno}: import {name}"


def test_scan_covers_the_package():
    assert len(_FILES) > 30
    assert any(p.name == "codegen.py" for p in _FILES)


@pytest.mark.parametrize("path", _FILES,
                         ids=[str(p.relative_to(ROOT)) for p in _FILES])
def test_no_jax_and_no_reference_package(path):
    assert list(_violations(path)) == []


def test_scan_catches_a_jax_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import ir\n"
                   "x = jax.jit\nfrom . import fine\n")
    assert len(list(_violations(bad))) == 3


def test_model_store_runs_on_the_card_or_raises():
    from repro_torch.core import ModelStore
    if torch.cuda.is_available():
        assert ModelStore().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelStore()
    assert ModelStore(device="cpu").device.type == "cpu"


def test_cpu_store_moves_tables_to_its_device():
    import numpy as np
    from repro_torch.core import ModelStore
    from repro_torch.relational import Table
    store = ModelStore(device="cpu")
    store.register_table("t", Table.from_pydict(
        {"a": np.arange(4, dtype=np.int32)}))
    assert store.get_table("t").device.type == "cpu"
    assert store.get_table("t").column("a").dtype == torch.int32
