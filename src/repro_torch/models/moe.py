"""Top-k routed mixture of experts (Granite 32 experts / top-8, Qwen3 128 /
top-8): the JAX package's ``models/moe.py``, on one device or over a mesh.

Token-choice routing with capacity (GShard): each token's router logits
pick its top-k experts, whose gates are the softmax over those k logits;
each expert then keeps its top-C tokens by gate (C from the capacity
factor), runs its gated MLP on them, and the weighted outputs are summed
per token.  A (token, expert) pair routed but not kept is dropped.

Two places where the port pins down what torch leaves open:

- **Ties.** ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` defines no order on ties (on CUDA it varies), and
  an expert's capacity pick meets many ties at gate 0.  Every top-k here is
  a stable descending sort, cut to its first k.
- **Determinism.** JAX's ``out.at[tok].add(...)`` would be ``index_add_``,
  which adds with atomics on CUDA: the bits of a sum would change from run
  to run.  Instead each token's kept expert outputs are summed in
  ascending expert order into float32 zeros, the order of the JAX scatter,
  so two runs on the card are bitwise equal.

The expert products are plain batched matrix products, as in JAX, which
computes them outside any Pallas kernel; they multiply bfloat16 values
exactly in float32 and accumulate in float32 (JAX's
``preferred_element_type=float32``).

The expert-parallel entry points (``moe_apply_sharded``, the psum design,
and ``moe_apply_sharded_a2a``, the all-to-all dispatch) run over a real
``launch.mesh.Mesh`` from one process: each model shard holds
``n_experts / n_model`` experts on its device, and the JAX package's
collectives become explicit copies between the devices (a float32 sum of
the shards' outputs in ascending shard order for the psum, two block
exchanges for the all-to-all), so their results do not depend on timing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init

__all__ = ["moe_params", "moe_apply", "moe_apply_sharded",
           "moe_apply_sharded_a2a", "moe_reference"]


def moe_params(cfg) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init((d, "embed"), (e, None)),
         "wi": dense_init((e, "expert"), (d, "embed"), (f, None)),
         "wg": dense_init((e, "expert"), (d, "embed"), (f, None)),
         "wo": dense_init((e, "expert"), (f, None), (d, "embed"))}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = dense_init((d, "embed"), (fs, "mlp"))
        p["shared_wg"] = dense_init((d, "embed"), (fs, "mlp"))
        p["shared_wo"] = dense_init((fs, "mlp"), (d, "embed"))
    return p


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, the lower
    index first among equal ones."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg, x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """x [T,d] -> dense gate matrix [T,E] float32: softmax over each token's
    top-k logits, zero elsewhere (token-choice routing)."""
    logits = (x @ router_w).float()                      # [T, E]
    vals, idx = _top_k(logits, cfg.experts_per_token)    # [T, k]
    gates = torch.softmax(vals, dim=-1)
    return torch.zeros_like(logits).scatter_(1, idx, gates)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product in float32 of (possibly bfloat16) operands."""
    return torch.bmm(a.float(), b.float())


def _ffn(xg: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
         wo: torch.Tensor) -> torch.Tensor:
    """Gated expert MLPs on gathered tokens: xg [E,C,d] -> [E,C,d]
    float32 (products in float32, the hidden rounded to xg's dtype)."""
    h = _bmm_f32(xg, wi)
    h = h * F.silu(_bmm_f32(xg, wg))
    return _bmm_f32(h.to(xg.dtype), wo)


def _combine(cfg, y: torch.Tensor, tok: torch.Tensor,
             gate_slice: torch.Tensor) -> torch.Tensor:
    """Each token's kept expert outputs summed in ascending expert order
    into float32 zeros (the order of the JAX scatter, without atomics).
    y [E,C,d] (already weighted by gate); tok [E,C] the picked tokens;
    gate_slice [T,E] -> [T,d] float32."""
    t = gate_slice.shape[0]
    n_exp, c = tok.shape
    # Where token t sits in expert e's pick (-1: not picked); a pick holds
    # distinct tokens, so every entry is written once.
    slot = torch.full((n_exp, t), -1, dtype=torch.long, device=y.device)
    slot.scatter_(1, tok, torch.arange(c, device=y.device)
                  .expand(n_exp, c).contiguous())
    # Only a token's routed experts carry a gate > 0, and a pair picked at
    # gate 0 holds a zero in y.  Sum each token's routed experts in
    # ascending order, as the JAX scatter does.
    routed = torch.sort(_top_k(gate_slice, cfg.experts_per_token)[1],
                        dim=-1).values                   # [T, k] ascending
    rows = torch.arange(t, device=y.device)
    out = torch.zeros((t, y.shape[-1]), dtype=torch.float32,
                      device=y.device)
    for j in range(routed.shape[1]):
        s = slot[routed[:, j], rows]
        out = out + torch.where((s >= 0)[:, None],
                                y[routed[:, j], s.clamp(min=0)], 0.0)
    return out


def _expert_compute(cfg, x: torch.Tensor, gate_slice: torch.Tensor,
                    wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
                    capacity: int, counts: Optional[Dict] = None
                    ) -> torch.Tensor:
    """Capacity-C gather / GEMM / combine for a slice of experts.

    x [T,d]; gate_slice [T,E]; wi/wg [E,d,f]; wo [E,f,d] -> [T,d] float32.
    """
    t, d = x.shape
    c = min(capacity, t)
    vals, tok = _top_k(gate_slice.T, c)                  # [E, C]
    live = vals > 0.0
    xg = x[tok.reshape(-1)].reshape(tok.shape[0], c, d)  # [E, C, d]
    y = _ffn(xg, wi, wg, wo) * (vals * live)[..., None]  # [E, C, d]
    out = _combine(cfg, y, tok, gate_slice)
    if counts is not None:
        n_routed = (gate_slice > 0).sum()
        counts["routed"] = counts.get("routed", 0) + n_routed
        counts["dropped"] = counts.get("dropped", 0) + n_routed - live.sum()
    return out


def _capacity(cfg, tokens: int, capacity_factor: float) -> int:
    per = tokens * cfg.experts_per_token / max(cfg.n_experts, 1)
    return max(1, int(per * capacity_factor + 0.999))


def _shared(cfg, p, x):
    h = x @ p["shared_wi"]
    h = F.silu(x @ p["shared_wg"]) * h
    return h @ p["shared_wo"]


def moe_apply(cfg, p: Dict, x: torch.Tensor, capacity_factor: float = 2.0,
              counts: Optional[Dict] = None) -> torch.Tensor:
    """x [B,S,d] -> [B,S,d] in x's dtype.  ``counts``, where given, gains
    device tensors ``routed`` and ``dropped``: the (token, expert) pairs
    routed and those dropped by capacity."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates = _route(cfg, xf, p["router"])
    cap = _capacity(cfg, xf.shape[0], capacity_factor)
    out = _expert_compute(cfg, xf, gates, p["wi"], p["wg"], p["wo"], cap,
                          counts)
    out = out.reshape(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out


def _device_grid(mesh, data_axes: Tuple[str, ...], model_axis: str):
    """The mesh's devices as rows of data shards, each the devices along
    ``model_axis`` in order: [n_data][n_model]."""
    order = tuple(data_axes) + (model_axis,)
    if set(order) != set(mesh.axis_names):
        raise ValueError(f"moe: mesh axes {mesh.axis_names}, expected the "
                         f"data axes {tuple(data_axes)} and {model_axis!r}")
    n_model = mesh.shape[model_axis]
    grid = mesh.devices.transpose([mesh.axis_names.index(a) for a in order])
    return [list(row) for row in grid.reshape(-1, n_model)]


def _local_experts(p: Dict, m: int, e_loc: int, dev) -> Tuple:
    """Expert shard m's (wi, wg, wo) on ``dev``."""
    sl = slice(m * e_loc, (m + 1) * e_loc)
    return tuple(p[k][sl].to(dev) for k in ("wi", "wg", "wo"))


def _shards_of(cfg, mesh, data_axes, model_axis, x):
    """(device grid, n_model, experts a shard, batch rows a data shard)."""
    grid = _device_grid(mesh, data_axes, model_axis)
    n_model = len(grid[0])
    if cfg.n_experts % n_model:
        raise ValueError(f"{cfg.n_experts} experts not divisible by "
                         f"{model_axis}={n_model}")
    if x.shape[0] % len(grid):
        raise ValueError(f"batch {x.shape[0]} not divisible by the "
                         f"{len(grid)} data shards")
    return grid, n_model, cfg.n_experts // n_model, x.shape[0] // len(grid)


def moe_apply_sharded(cfg, p: Dict, x: torch.Tensor, mesh,
                      data_axes: Tuple[str, ...],
                      model_axis: str = "model",
                      capacity_factor: float = 1.25) -> torch.Tensor:
    """Expert parallelism over a real mesh (the JAX package's psum design):
    the batch splits over the data shards; every device of a data shard
    routes all its tokens, keeps its ``n_experts / n_model`` experts'
    gates and runs them (capacity from the shard's tokens); the shards'
    float32 outputs are summed on x's device in ascending shard order (the
    psum, deterministic) -> [B,S,d] in x's dtype."""
    grid, n_model, e_loc, bl = _shards_of(cfg, mesh, data_axes,
                                          model_axis, x)
    d = x.shape[-1]
    rows = []
    for i, row in enumerate(grid):
        xb = x[i * bl:(i + 1) * bl]
        cap = _capacity(cfg, xb.shape[0] * xb.shape[1], capacity_factor)
        acc = None
        for m, dev in enumerate(row):
            xf = xb.reshape(-1, d).to(dev)
            gates = _route(cfg, xf, p["router"].to(dev))
            part = _expert_compute(
                cfg, xf, gates[:, m * e_loc:(m + 1) * e_loc],
                *_local_experts(p, m, e_loc, dev), cap).to(x.device)
            acc = part if acc is None else acc + part
        rows.append(acc.reshape(xb.shape).to(x.dtype))
    out = torch.cat(rows)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out


def moe_apply_sharded_a2a(cfg, p: Dict, x: torch.Tensor, mesh,
                          data_axes: Tuple[str, ...],
                          model_axis: str = "model",
                          capacity_factor: float = 1.25) -> torch.Tensor:
    """All-to-all expert parallelism over a real mesh (GShard/Switch
    dispatch, the JAX package's ``moe_apply_sharded_a2a``): tokens split
    over the data shards (batch) and the model shards (sequence); each
    device routes its own tokens, picks each expert's top-C of them
    (stable sort: the lower token first among ties) and sends expert shard
    j its block of picks; each shard runs its experts on what it received
    and sends the outputs back; each device sums its tokens' outputs in
    ascending expert order.  The two exchanges are block copies between
    the devices.  When S does not split over the model shards (a decode
    step) this is the psum path, as in the JAX package."""
    grid, n_model, e_loc, bl = _shards_of(cfg, mesh, data_axes,
                                          model_axis, x)
    s, d = x.shape[1], x.shape[2]
    if s % n_model:
        return moe_apply_sharded(cfg, p, x, mesh, data_axes, model_axis,
                                 capacity_factor)
    sl = s // n_model
    rows = []
    for i, row in enumerate(grid):
        local = []                         # per device: its routing
        for m, dev in enumerate(row):
            xf = x[i * bl:(i + 1) * bl, m * sl:(m + 1) * sl] \
                .reshape(-1, d).to(dev)
            gates = _route(cfg, xf, p["router"].to(dev))       # [T_dev, E]
            cap = min(_capacity(cfg, xf.shape[0], capacity_factor),
                      xf.shape[0])
            vals, tok = _top_k(gates.T, cap)                   # [E, C]
            send = xf[tok.reshape(-1)].reshape(n_model, e_loc, cap, d)
            local.append((gates, vals, tok, send))
        # exchange 1: shard m receives block m of every device's picks
        outs = []
        for m, dev in enumerate(row):
            recv = torch.stack([local[src][3][m].to(dev)
                                for src in range(n_model)])
            toks = recv.transpose(0, 1).reshape(e_loc, n_model * cap, d)
            y = _ffn(toks, *_local_experts(p, m, e_loc, dev))
            outs.append(y.reshape(e_loc, n_model, cap, d).transpose(0, 1))
        # exchange 2: each device gets its tokens' outputs back
        parts = []
        for m, dev in enumerate(row):
            gates, vals, tok, _ = local[m]
            back = torch.stack([outs[j][m].to(dev) for j in range(n_model)])
            y = back.reshape(cfg.n_experts, cap, d) \
                * (vals * (vals > 0.0))[..., None]
            parts.append(_combine(cfg, y, tok, gates)
                         .reshape(bl, sl, d).to(x.device))
        rows.append(torch.cat(parts, dim=1))
    out = torch.cat(rows).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out


def moe_reference(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Exact (no-capacity) oracle: y_t = sum_e g_te FFN_e(x_t)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates = _route(cfg, xf, p["router"])                 # [T, E]
    h = torch.einsum("td,edf->tef", xf, p["wi"])
    h = h * F.silu(torch.einsum("td,edf->tef", xf, p["wg"]))
    y = torch.einsum("tef,efd->ted", h, p["wo"])
    out = torch.einsum("te,ted->td", gates, y.float())
    out = out.reshape(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out
