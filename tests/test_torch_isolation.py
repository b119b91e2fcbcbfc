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
    assert ROOT / "src" / "repro_torch" / "core" / "clustering.py" in _FILES
    for name in ("models/moe.py", "serve/kv_cache.py", "serve/speculative.py",
                 "train/loop.py", "train/checkpoint.py",
                 "distributed/fault_tolerance.py", "launch/train.py",
                 "distributed/sharding.py", "distributed/elastic.py",
                 "launch/mesh.py", "launch/serve.py", "launch/dryrun.py",
                 "launch/cost_analysis.py", "launch/raven_dryrun.py",
                 "kernels/cost.py"):
        assert ROOT / "src" / "repro_torch" / name in _FILES


_BLOCK_JAX = """
import sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Refuse())
"""


def test_launch_and_distributed_import_without_jax():
    """The dry-run, the serve launcher and elastic rescaling import with
    ``jax``, ``jaxlib`` and ``repro`` made unimportable."""
    import subprocess
    import sys
    code = _BLOCK_JAX + (
        "import repro_torch.launch.dryrun, repro_torch.launch.serve, "
        "repro_torch.distributed.elastic, repro_torch.launch.raven_dryrun\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') "
        "for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]


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


def test_prediction_service_runs_on_the_card_or_raises():
    """The service runs on its catalog's device: ``ModelStore()`` means the
    card, so without one there is no service to build; a CPU service needs
    ``ModelStore(device="cpu")``."""
    from repro_torch.core import ModelStore
    from repro_torch.serve import PredictionService
    if torch.cuda.is_available():
        svc = PredictionService(ModelStore())
        assert svc.catalog.device.type == "cuda"
        svc.close()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PredictionService(ModelStore())
    svc = PredictionService(ModelStore(device="cpu"))
    assert svc.catalog.device.type == "cpu"
    svc.close()


def test_cpu_store_moves_tables_to_its_device():
    import numpy as np
    from repro_torch.core import ModelStore
    from repro_torch.relational import Table
    store = ModelStore(device="cpu")
    store.register_table("t", Table.from_pydict(
        {"a": np.arange(4, dtype=np.int32)}))
    assert store.get_table("t").device.type == "cpu"
    assert store.get_table("t").column("a").dtype == torch.int32


def test_language_model_runs_on_the_card_or_raises():
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import LanguageModel, build_model
    cfg = dataclasses.replace(reduced_config(get_config("minicpm-2b")),
                              d_head=64)
    for make in (build_model, LanguageModel):
        if torch.cuda.is_available():
            assert make(cfg).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(cfg)
        assert make(cfg, device="cpu").device.type == "cpu"


def test_paged_kv_cache_runs_on_the_card_or_raises():
    from repro_torch.serve import PagedKVCache
    if torch.cuda.is_available():
        assert PagedKVCache(2, 4, 1, 64, 2).pool.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedKVCache(2, 4, 1, 64, 2)
    assert PagedKVCache(2, 4, 1, 64, 2, device="cpu").pool.device.type \
        == "cpu"


def test_param_conversion_goes_to_the_card_or_raises():
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import (lm_params_from_numpy,
                                            lm_params_to_numpy)
    cfg = dataclasses.replace(reduced_config(get_config("minicpm-2b")),
                              d_head=64)
    tree = lm_params_to_numpy(build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)))
    if torch.cuda.is_available():
        assert lm_params_from_numpy(cfg, tree)["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm_params_from_numpy(cfg, tree)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    assert params["layers"][0]["ln1"].device.type == "cpu"


def test_inference_engine_runs_on_its_models_device():
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.serve import InferenceEngine, Request, ServeConfig
    cfg = dataclasses.replace(reduced_config(get_config("minicpm-2b")),
                              d_head=64)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, ServeConfig(n_slots=1, max_len=16,
                                             eos_token=-1))
    assert eng.device.type == "cpu"
    eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=2))
    eng.run_until_drained(params)
    assert eng.cache["layers"][0]["k"].device.type == "cpu"
    assert len(eng.completed[0].output) == 2
