"""Production dry-run: every (arch x shape) cell on the H100 production
mesh, costed without a card (the JAX package's ``launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k [--multi-pod] [--all] [--out results/dryrun]

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json`` with the JAX
file's keys.  The JAX dry-run lowers and compiles the cell for 512
placeholder devices and reads XLA's per-device program; torch has neither.
Here the model, the train state, the batch and the decode caches are built
at full size as ``meta`` tensors (no storage) and the train step, the
prefill or the decode step runs once, eagerly, under
``launch.cost_analysis.CostCounter``; the five kernel wrappers report
their analytic work on ``meta``.  ``cost_source`` says so.  From the
whole program's counts:

- **per device**: the work splits over the batch shards (the data axes,
  where the batch divides them) times ``model``; the weights are read
  whole on every device of a model shard (serve rules replicate them over
  the data axes, train rules gather them there), so each device's bytes
  are the program's over that split plus its model shard's weight reads
  (once a pass: forward, and under remat recompute and backward).
- **collectives**: reckoned from the sharding rules and the mesh, per
  layer and pass, as each device's operand bytes by type: the FSDP
  all-gathers of the weights and reduce-scatters of their gradients (and
  the all-reduce of the replicated leaves' gradients) over the data axes;
  tensor parallelism's syncs over ``model`` (an all-gather and a
  reduce-scatter of the sequence slices under train's sequence
  parallelism, an all-reduce in serve); the MoE's psum of its float32
  output over ``model``; the logits' all-gather.  Model-axis traffic
  rides NVLink, data-axis traffic InfiniBand.
- **roofline** terms against the H100's published peaks
  (``kernels.cost``): compute at the peak of each operation class,
  memory at the HBM rate, collectives at the links' rates.

The memory entry gives what each device must hold as arguments (state or
parameters, the batch and the caches, over their shards); the eager run
does not give temporaries, so those are null.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

from ..configs import (SHAPES, cell_skips, get_config,
                       kernel_reduced_config, list_archs)
from ..distributed.sharding import (axes_leaves, data_axes_of,
                                    entry_axes, logical_to_pspec,
                                    serve_rules, shard_count, train_rules)
from ..kernels import cost as kcost
from ..models import build_model
from ..train.optimizer import AdamWConfig
from ..train.tree import leaves
from .cost_analysis import CostCounter
from .mesh import Mesh, make_production_mesh

__all__ = ["run_cell", "collective_bytes", "main"]


def _mesh_tag(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def _mesh_name(mesh: Mesh) -> str:
    kind = "multi" if "pod" in mesh.axis_names else "single"
    return f"{kind}({'x'.join(str(n) for n in mesh.sizes)})"


def _leaf_info(model, mesh: Mesh, rules) -> list:
    """(bytes, spec) of every parameter leaf."""
    params = leaves(model.abstract_params())
    axes = axes_leaves(model.param_logical_axes())
    return [(math.prod(p.shape) * p.element_size(),
             logical_to_pspec(a, rules)) for p, a in zip(params, axes)]


def _n_sync(cfg) -> int:
    """Tensor-parallel sync points (partial sums over ``model``) of a
    forward pass: the mixer's and the MLP's output projections a layer,
    the cross-attention's in an encoder-decoder's decoder layers."""
    n = 2 * cfg.n_layers + 2 * cfg.n_encoder_layers
    return n + (cfg.n_layers if cfg.is_encdec else 0)


def collective_bytes(cfg, shape, mesh: Mesh, leaf_info) -> Dict[str, Any]:
    """Per device, by collective type and by link: the operand bytes each
    device contributes in one step of the cell (see the module's
    docstring for the model)."""
    fsdp = data_axes_of(mesh)
    n_data = math.prod(mesh.shape[a] for a in fsdp)
    n_model = mesh.shape["model"]
    train = shape.kind == "train"
    batch_shards = n_data if shape.global_batch % n_data == 0 else 1
    tokens = shape.global_batch // batch_shards \
        * (1 if shape.kind == "decode" else shape.seq_len)
    act = 2.0 * tokens * cfg.d_model                  # bf16 [B, S, D]
    passes = 3 if train else 1                        # fwd, remat, bwd
    by = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0,
          "all-to-all": 0.0}
    link = {"nvlink": 0.0, "infiniband": 0.0}

    def add(kind, n, over_model):
        by[kind] += n
        link["nvlink" if over_model else "infiniband"] += n

    if n_model > 1:
        for _ in range(passes):
            if train:      # sequence parallel: gather, then scatter
                add("all-gather", _n_sync(cfg) * act / n_model, True)
                add("reduce-scatter", _n_sync(cfg) * act, True)
            else:
                add("all-reduce", _n_sync(cfg) * act, True)
        if cfg.n_experts:                             # the MoE psum, f32
            add("all-reduce", passes * cfg.n_layers * 2.0 * act, True)
        add("all-gather", 4.0 * (tokens if train else shape.global_batch
                                 // batch_shards)
            * cfg.vocab_padded / n_model, True)
    if train and n_data > 1:
        for nbytes, spec in leaf_info:
            shards = shard_count(mesh, spec)
            if any(set(entry_axes(e)) & set(fsdp) for e in spec):
                add("all-gather", 2.0 * nbytes / shards, False)
                add("reduce-scatter", nbytes * n_data / shards, False)
            else:
                add("all-reduce", nbytes / shards, False)
    return {"by_type": by, "by_link": link, "batch_shards": batch_shards}


def _spec_bytes(tree, batch_shards) -> float:
    return sum(math.prod(t.shape) * t.element_size() for t in leaves(tree)) \
        / batch_shards


def _run(model, shape, cfg, arch):
    """Build the cell's inputs on meta and run its step under the cost
    counter -> (CostCounter, argument tensors by kind)."""
    from ..train.optimizer import adamw_update, global_norm
    from ..train.train_state import abstract_train_state, loss_and_grads
    batch = model.input_specs(shape)
    with CostCounter() as counter:
        if shape.kind == "train":
            state = abstract_train_state(model)
            opt = AdamWConfig(
                schedule="wsd" if arch == "minicpm-2b" else "cosine")
            # make_train_step's work without its one host read (the
            # non-finite skip), which meta tensors cannot answer
            loss, grads = loss_and_grads(model, state["params"], batch)
            global_norm(grads)
            adamw_update(opt, state["params"], grads, state["opt"])
            args = {"state": state, "batch": batch}
        elif shape.kind == "prefill":
            params = model.abstract_params()
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            model.prefill(params, batch["tokens"], max_len=shape.seq_len,
                          **extra)
            args = {"params": params, "batch": batch}
        else:
            params = model.abstract_params()
            model.decode_step(params, batch["cache"], batch["tokens"])
            args = {"params": params, "batch": batch}
    return counter, args


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = Path("results/dryrun"),
             reduced: bool = False) -> dict:
    """Cost one cell (``reduced``: the arch's ``kernel_reduced_config``
    at the cell's full shape) and write its JSON."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = _mesh_tag(multi_pod)
    path = out_dir / f"{arch}__{shape_name}__{tag}.json"
    skips = cell_skips()
    if (arch, shape_name) in skips:
        res = {"arch": arch, "shape": shape_name, "mesh": tag,
               "status": "skipped", "reason": skips[(arch, shape_name)]}
        path.write_text(json.dumps(res, indent=2))
        return res

    cfg = kernel_reduced_config(get_config(arch)) if reduced \
        else get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    rules = train_rules(mesh) if shape.kind == "train" else serve_rules(mesh)
    t0 = time.time()
    model = build_model(cfg, device="meta", remat=shape.kind == "train")
    info = _leaf_info(model, mesh, rules)
    t_lower = time.time() - t0
    t0 = time.time()
    counter, args = _run(model, shape, cfg, arch)
    t_run = time.time() - t0
    c = counter.cost

    coll = collective_bytes(cfg, shape, mesh, info)
    n_model = mesh.shape["model"]
    split = coll["batch_shards"] * n_model
    passes = 3 if shape.kind == "train" else 1
    weights = sum(nbytes for nbytes, _ in info)
    flops_dev = c.flops / split
    bytes_dev = c.bytes / split + passes * weights * (1 / n_model
                                                      - 1 / split)
    compute_s = c.compute_s() / split
    memory_s = bytes_dev / kcost.PEAK_BYTES_PER_S
    collective_s = (coll["by_link"]["nvlink"] / kcost.NVLINK_BYTES_PER_S
                    + coll["by_link"]["infiniband"]
                    / kcost.INFINIBAND_BYTES_PER_S)
    dominant = max([("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)], key=lambda kv: kv[1])[0]

    # parameters over their shards; train also holds AdamW's m and v,
    # float32 like the float32 parameters
    state_dev = (3 if shape.kind == "train" else 1) * sum(
        nbytes / shard_count(mesh, spec) for nbytes, spec in info)
    arg_dev = state_dev + _spec_bytes(args["batch"], coll["batch_shards"])

    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    n_active = cfg.active_param_count()
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active \
        * n_tokens
    flops_global = flops_dev * n_chips
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": _mesh_name(mesh),
        "variant": "reduced" if reduced else "baseline",
        "status": "ok",
        "n_chips": int(n_chips),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_run, 2),
        "param_count": int(cfg.param_count()),
        "active_param_count": int(n_active),
        "memory": {
            "argument_bytes_per_device": arg_dev,
            "output_bytes_per_device": None,
            "temp_bytes_per_device": None,
            "alias_bytes_per_device": None,
        },
        "flat_cost_analysis": {"flops": c.flops, "bytes accessed": c.bytes},
        "hlo_cost_per_device": {
            "flops": flops_dev,
            "bytes": bytes_dev,
            "collective_bytes": {k: v for k, v in coll["by_type"].items()
                                 if v},
        },
        "cost_source": ("torch dispatch counter over one eager run on meta "
                        "tensors (launch.cost_analysis), the kernels' "
                        "analytic work (kernels.cost), collectives reckoned "
                        "from the sharding rules; no HLO"),
        "cost_detail": {
            "flops_by_class_global": c.flops_by_class,
            "kernels_global": c.kernels,
            "collective_bytes_by_link": coll["by_link"],
            "work_split": split,
            "hardware": "NVIDIA H100 SXM5 80GB, 700 W data-sheet peaks",
        },
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": dominant,
            "model_flops": model_flops,
            "hlo_flops_global": flops_global,
            "useful_flop_ratio": model_flops / flops_global
            if flops_global else 0.0,
        },
    }
    path.write_text(json.dumps(result, indent=2))
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs at the cells' shapes")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    archs = [args.arch] if args.arch and not args.all else list_archs()
    shapes = [args.shape] if args.shape and not args.all else list(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch} x {shape} x {_mesh_tag(multi)}"
                path = out_dir / f"{arch}__{shape}__{_mesh_tag(multi)}.json"
                if args.skip_existing and path.exists() and json.loads(
                        path.read_text()).get("status") in ("ok",
                                                            "skipped"):
                    print(f"[skip-existing] {tag}")
                    continue
                t0 = time.time()
                try:
                    res = run_cell(arch, shape, multi, out_dir,
                                   reduced=args.reduced)
                    if res["status"] == "skipped":
                        print(f"[SKIP] {tag}: {res['reason'][:60]}")
                    else:
                        r = res["roofline"]
                        print(f"[OK]   {tag}: run={res['compile_s']}s "
                              f"dominant={r['dominant']} "
                              f"compute={r['compute_s']*1e3:.2f}ms "
                              f"mem={r['memory_s']*1e3:.2f}ms "
                              f"coll={r['collective_s']*1e3:.2f}ms")
                except Exception as e:   # one cell's failure is recorded
                    failures += 1
                    print(f"[FAIL] {tag}: {e}")
                    traceback.print_exc()
                    out_dir.mkdir(parents=True, exist_ok=True)
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape,
                        "mesh": _mesh_tag(multi), "status": "failed",
                        "error": str(e)[-2000:]}, indent=2))
                finally:
                    print(f"       ({time.time()-t0:.1f}s)", flush=True)
    print(f"done; {failures} failures")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
