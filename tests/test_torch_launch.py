"""The port's launch layer on the CPU: the serve launcher, the mesh, the
dry-run (one reduced cell on ``meta`` with the JAX JSON's keys, the
documented skip) and the cost counter's FLOPs against the JAX package's
HLO analysis of the same forward compiled on one CPU device."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import cost as kcost
from repro_torch.launch import dryrun, raven_dryrun, serve
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.mesh import make_data_mesh, make_local_mesh
from repro_torch.models import build_model

# the keys of the JAX dry-run's cell JSON (src/repro/launch/dryrun.py)
_JAX_KEYS = {"arch", "shape", "mesh", "variant", "status", "n_chips",
             "lower_s", "compile_s", "param_count", "active_param_count",
             "memory", "flat_cost_analysis", "hlo_cost_per_device",
             "roofline"}
_JAX_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                 "model_flops", "hlo_flops_global", "useful_flop_ratio"}
_JAX_MEMORY = {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "alias_bytes_per_device"}


@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-1.6b",
                                  "hymba-1.5b"])
def test_serve_launcher_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                      "--prompt-len", "8", "--new-tokens", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("served 3 requests, 12 tokens in ")
    assert lines[1].startswith("TTFT p50=")
    assert out["device"] == "cpu" and out["tokens"] == 12
    assert out["prefills"] >= 1 and out["decode_steps"] >= 3


def test_serve_launcher_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py's launch phase "
                    "drives the launcher there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "minicpm-2b", "--requests", "1"])


def test_serve_launcher_always_serves_the_reduced_config():
    """``--reduced`` is store_true with default True, as in the JAX
    launcher: the reduced config (at the kernels' head size) either way."""
    cfg = serve.launch_config("minicpm-2b", True)
    assert cfg.d_model == reduced_config(get_config("minicpm-2b")).d_model
    assert cfg.d_head == 64
    rwkv = serve.launch_config("rwkv6-1.6b", True)
    assert rwkv.n_heads * 64 == rwkv.d_model


def test_local_and_data_meshes_on_the_cpu():
    mesh = make_local_mesh(1, 1, device="cpu")
    assert mesh.sizes == (1, 1) and list(mesh.devices.reshape(-1)) == [
        torch.device("cpu")]
    data = make_data_mesh([torch.device("cpu")] * 3)
    assert data.shape == {"data": 3}
    assert list(data.devices) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_local_mesh(1, 1)


def test_reduced_dryrun_cell(tmp_path):
    res = dryrun.run_cell("granite-moe-1b-a400m", "prefill_32k", False,
                          tmp_path, reduced=True)
    path = tmp_path / "granite-moe-1b-a400m__prefill_32k__single.json"
    out = json.loads(path.read_text())
    assert out == json.loads(json.dumps(res))
    assert _JAX_KEYS <= set(out) and out["status"] == "ok"
    assert _JAX_ROOFLINE <= set(out["roofline"])
    assert _JAX_MEMORY <= set(out["memory"])
    assert {"flops", "bytes", "collective_bytes"} <= set(
        out["hlo_cost_per_device"])
    assert out["n_chips"] == 256 and out["mesh"] == "single(32x8)"
    r = out["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert out["hlo_cost_per_device"]["collective_bytes"]
    assert "dispatch" in out["cost_source"]
    assert out["cost_detail"]["kernels_global"]["flash_attention"][
        "calls"] == reduced_config(get_config("granite-moe-1b-a400m")) \
        .n_layers


@pytest.mark.parametrize("arch,shape", [("minicpm-2b", "train_4k"),
                                        ("hymba-1.5b", "decode_32k"),
                                        ("rwkv6-1.6b", "long_500k")])
def test_reduced_dryrun_cells_of_each_kind(tmp_path, arch, shape):
    out = dryrun.run_cell(arch, shape, True, tmp_path, reduced=True)
    assert out["status"] == "ok" and out["n_chips"] == 512
    assert out["roofline"]["compute_s"] > 0
    if shape == "train_4k":     # FSDP gathers and scatters over the data
        coll = out["hlo_cost_per_device"]["collective_bytes"]
        assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
        assert out["cost_detail"]["collective_bytes_by_link"][
            "infiniband"] > 0


def test_long_500k_is_a_documented_skip(tmp_path):
    out = dryrun.run_cell("gemma2-2b", "long_500k", False, tmp_path)
    saved = json.loads(
        (tmp_path / "gemma2-2b__long_500k__single.json").read_text())
    assert out["status"] == saved["status"] == "skipped"
    assert "sub-quadratic" in saved["reason"]


def test_dryrun_main_writes_a_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen2.5-14b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    assert "[SKIP]" in capsys.readouterr().out


def test_raven_dryrun_on_meta(tmp_path):
    out = raven_dryrun.main(["--rows-per-chip", "1000",
                             "--out", str(tmp_path)])
    assert out["status"] == "ok" and out["n_chips"] == 256
    assert out["n_rows"] == 256_000
    assert out["cost_detail"]["kernels"]["tree_gemm"]["calls"] == 1
    assert out["roofline"]["memory_s"] > 0
    assert out["hlo_cost_per_device"]["collective_bytes"]["all-reduce"] > 0
    assert (tmp_path / "raven_query__single.json").exists()


# JAX's blockwise attention (one block here: S <= its 512) computes every
# (query, key) pair of a block and masks the invisible ones afterwards, and
# the HLO analysis counts those dots; the flash kernel's work is the visible
# pairs only.  Adding the masked pairs' 4 d flops back, the rest agrees:
# measured within 0.07% (the router's and a few small products' shapes
# differ).  RWKV-6 has no attention: 0.06%.
_FLOP_RTOL = 0.01


def _masked_pair_flops(cfg, b, s):
    if cfg.rwkv:
        return 0.0
    pairs = s * (s + 1) // 2
    return 4.0 * cfg.d_head * (s * s - pairs) * b * cfg.n_heads \
        * cfg.n_layers


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-14b",
                                  "granite-moe-1b-a400m", "rwkv6-1.6b"])
@pytest.mark.parametrize("s", [64, 256])
def test_counter_flops_match_the_hlo_analysis(arch, s):
    over = dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=64) \
        if arch.startswith("rwkv6") else dict(d_head=64)
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                               **over)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **over)
    jm = jax_build_model(jcfg, remat=False)
    params = jm.init_params(jax.random.PRNGKey(0))
    tokens = jnp.zeros((2, s), jnp.int32)
    compiled = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                               max_len=s)) \
        .lower(params, tokens).compile()
    want = analyze_hlo(compiled.as_text()).flops
    model = build_model(cfg, device="meta")
    with CostCounter() as counter:
        model.prefill(model.abstract_params(),
                      torch.empty((2, s), dtype=torch.int32, device="meta"),
                      max_len=s)
    got = counter.cost.flops + _masked_pair_flops(cfg, 2, s)
    assert abs(got / want - 1) <= _FLOP_RTOL, (got, want)


def test_counter_on_cpu_tensors_counts_what_runs():
    """On CPU tensors the counter sees the plain versions' ops (no kernel
    report) and the same products' FLOPs."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with CostCounter() as counter:
        (a @ b).relu()
    assert counter.cost.flops == 2 * 8 * 16 * 4
    assert counter.cost.flops_by_class == {"fp32": 2 * 8 * 16 * 4}
    assert counter.cost.kernels == {}
    assert counter.cost.bytes >= 4 * (8 * 16 + 16 * 4 + 8 * 4)


def test_peaks_are_the_h100s():
    assert kcost.PEAK_BF16_FLOPS == 989e12
    assert kcost.PEAK_BYTES_PER_S == 3.35e12
    assert kcost.NVLINK_BYTES_PER_S == 450e9
    assert kcost.INFINIBAND_BYTES_PER_S == 50e9


def test_kernel_wrappers_evaluate_meta_tensors_abstractly():
    """On ``meta`` tensors each wrapper returns empty outputs of the right
    shapes and dtypes, reports the kernel's analytic work to the counter
    (``kernels.cost``'s formulas) and launches nothing."""
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.rwkv6_scan import ops as w_ops
    from repro_torch.kernels.ssd_scan import ops as s_ops

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    before = (f_ops.launches, d_ops.launches, w_ops.launches,
              s_ops.launches)
    q, kv = meta(2, 64, 4, 64, dtype=torch.bfloat16), \
        meta(2, 64, 2, 64, dtype=torch.bfloat16)
    with CostCounter() as counter:
        out, lse = f_ops.flash_attention_with_lse(q, kv, kv)
        q1 = meta(2, 1, 4, 64, dtype=torch.bfloat16)
        dec = d_ops.decode_attention(q1, kv, kv,
                                     meta(2, dtype=torch.int32))
        y, st = w_ops.rwkv6_scan(*(meta(1, 32, 2, 64) for _ in range(4)),
                                 meta(2, 64))
        ys, hs = s_ops.ssd_scan(meta(1, 32, 2, 64), meta(1, 32, 2),
                                meta(2), meta(1, 32, 16), meta(1, 32, 16))
    assert (out.shape, out.dtype, lse.shape) == (q.shape, q.dtype,
                                                 (2, 4, 64))
    assert dec.shape == q1.shape and st.shape == (1, 2, 64, 64)
    assert hs.shape == (1, 2, 64, 16) and ys.dtype == torch.float32
    k = counter.cost.kernels
    assert k["flash_attention"]["flops"] == kcost.flash_cost(
        q, kv, kv, True, 0, True)["ops"]["bf16"]
    assert k["rwkv6_scan"]["flops"] == 5.0 * 32 * 2 * 64 * 64
    assert {n: e["calls"] for n, e in k.items()} == {
        "flash_attention": 1, "decode_attention": 1, "rwkv6_scan": 1,
        "ssd_scan": 1}
    assert (f_ops.launches, d_ops.launches, w_ops.launches,
            s_ops.launches) == before
