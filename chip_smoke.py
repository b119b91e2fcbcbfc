"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure exits non-zero):

1. device   — the card (``nvidia-smi`` name and power limit), torch and
               CUDA versions; TF32 is switched off for matmuls and cuDNN.
2. build    — compiles every kernel of every path from
               ``src/repro_torch/csrc`` with ``nvcc`` (one process per
               source, all started together) and prints ``ptxas``'s
               registers, shared memory and spills for each kernel.
3. kernels  — each kernel against its plain torch version on the card:
               tree_gemm bitwise at the query path's shapes and on edge
               cases (ragged rows, NaN/±inf, one tree); featurized_linear
               bitwise at edge sizes, on misaligned slices and at the
               benchmark's 5,819,079 flights, where it also equals the
               unfused featurize and row-wise fold; flash_attention and
               decode_attention within 2e-5 (float32) and 2e-2 (bfloat16)
               over GQA groups 1, 2, 4, 5 and (decode) 12, head dims 64,
               128 and 256, causal / window 64 / softcap 30 /
               bidirectional, ragged S, T and cache lengths, and for
               decode Hymba's ring and global caches, lengths on and
               either side of its split boundaries and a row of length 0;
               decode_attention captured in a CUDA graph, replayed after
               its lengths, k and v change in place, must equal an eager
               call bitwise; rwkv6_scan and ssd_scan within 3e-4 on y
               and on the final state, on float32 inputs and on the LM
               paths' dtypes and layout, at the JAX kernel tests' shapes,
               under strong decay (finite), with S off the chunk and B > 1,
               one step alone, under strong decay across many chunks with
               B > 1 (the state pass between chunks), and at their LM
               paths' shapes.  Times each kernel, its plain version and
               (where one exists) the one PyTorch call that computes the
               same function at the main paths' shapes, two ways: ``ms``
               (one wrapper call between CUDA events, host time included)
               and ``device_ms`` (the profiler's device time of 50
               back-to-back launches of the bound C entry point, / 50).
               decode_attention is timed at each LM path's decode shape
               (MiniCPM-2B's cache, Hymba's ring and global caches) with a
               cold L2: its 50 wrapper calls, and masked SDPA's, rotate
               over copies of the caches that add up to 100 MB read.
4. main     — the query path, as a user drives it: a ``ModelStore`` on the
               card holding the hospital tables at 1,000,000 patients each,
               a 64-tree depth-8 random forest over quickstart's seven
               features, and three SQL ``PREDICT`` queries, each optimized
               with the tree strategy forced to traversal, dense GEMM, the
               CUDA kernel, and left to the measured crossover ("auto").
               The forced strategies must agree bitwise; the kernel's launch
               count must rise.  "auto" (calibrated on the forest itself,
               in the first "auto" query's plan time) must choose the
               strategy whose forced run had the lowest model-operator time
               (a runner-up within 10% counts), and predict that time
               within a factor of 2; every strategy's predicted/measured
               ratio is printed.
5. check    — query (a) run on the card equals the same query run by the
               port on the CPU with traversal, bitwise.
6. service  — the main path through its front door, ``PredictionService``
               on phase 4's store under the default optimizer config, with
               one more table, ``scoring`` (pid and the seven features,
               patient_info joined with blood_tests once, 1,000,000 rows):
               queries (a)-(c) through ``svc.sql`` cold, then warm twice
               (the second warm round compiles no plan and traces no new
               signature; every answer bitwise equal to phase 4's "auto"
               output; tree_gemm launches equal the service's executions);
               16 coalesced requests over ``scoring`` slices of 1,000 to
               65,536 rows (each bitwise equal to the request served alone,
               launches equal executions); a service with 262,144-row
               chunks over all of ``scoring`` (4 chunks, 4 launches, equal
               to the unchunked answer); background admission (5 ms
               budget) fed by 4 host threads with 64 requests, each
               resolved within 60 s and equal to its request served alone,
               then ``close()``; and ``explain(analyze=True)`` of query (a),
               its per-operator times printed.
6b. sharded — the partition-parallel tier: a second ``ModelStore`` on the
               card with phase 4's tables and forest, ``patient_info`` and
               ``blood_tests`` range-partitioned on pid at the same 16
               bounds (16 morsels of 65,536 rows at the default
               ``shard_morsel_rows``) and ``blood_x``, a copy of
               ``blood_tests`` on bounds half a partition off, served by
               ``PredictionService(store, execution_config=
               ExecutionConfig(sharded=True))`` under the default optimizer
               config: query (a) as a partition-wise join, (c) as a
               two-phase aggregation, (a) over ``blood_x`` through the hash
               exchange (with ``shard_exchange_cost_gate=False``, which one
               card needs to shuffle at all), and (a) with ``pid <
               250000``, which the zone maps prune to 4 of 16 partitions.
               Each cold, then warm twice, beside the whole-table service
               on the same store: every answer equal to the whole-table
               answer on the valid rows (and on the validity mask where no
               partition was pruned); (c)'s AVG within 1e-4 relative, its
               keys and validity exact (the partial sums fold in partition
               order, so the float32 sum is associated differently);
               tree_gemm launches equal to the morsels or exchange buckets
               run (their ``shard_wave`` / ``exchange_bucket`` spans: 16,
               16, 16 and 4); the shard and exchange counters rising by
               the reference's semantics; the second warm round compiling
               no plan, building no shard executable and tracing no
               signature; the gated service sending the exchange query
               whole-table.  Prints cold and warm ms, morsels, waves,
               bucket rows, exchange bytes, the exchange's planning ms and
               the span times.
6c. fits   — the port fits its own models and clusters them, at the
               paper's sizes (the fits use no kernel of their own:
               autograd, reductions and GEMVs).  Fig 2a: ``flight_features(700_000)``, for each
               l1 in (0.002, 0.01, 0.05) benchmarks/common.py's
               ``flights_lr_pipeline`` (one-hot origin/dest/carrier/dow,
               the scaler, 300 ISTA steps) fitted on the card twice
               (bitwise equal) and once on the CPU (weights and bias
               within 1e-5; zero sets equal, or every index zero in one
               fit only under 1e-5 in the other), then ``SELECT dep_hour,
               PREDICT_PROBA(MODEL='delay') AS p FROM flights`` with and
               without projection pushdown, bitwise equal, each execution
               launching featurized_linear exactly once (the ``kernels``
               line's ``launches_by_path``).  Fig 2b: the
               l1 = 0.003 pipeline fitted on the card, k-means clustered
               models (k = 2, 4, 8, 16) built on the card from the first
               20,000 rows over origin/dest/carrier, each routed over all
               700,000 rows: labels agree with the full model on >= 0.999
               of the rows, the CPU's routed labels are bitwise the
               card's, ``register_clustered`` / ``get_clustered`` round
               trip.  Fig 3: quickstart's seven features scaled into an
               MLP (64, 32), 60 SGD steps on the first 100,000 patients,
               fitted on the card twice (bitwise) and on the CPU (rtol
               1e-5 / atol 1e-6), served as ``los_mlp`` through
               ``PredictionService`` at 1,000,000 patients cold and warm
               twice (equal answers, 0 plans compiled in the second warm
               round), bitwise equal to the CPU's run of the same state on
               the first 65,536 pids.  Prints fit, build and query ms.
7. lm, lm_rwkv, lm_hymba — the LM paths, each a model at full width and
               depth (random bfloat16 weights from a seeded generator on
               the card) served by ``InferenceEngine`` with 4 slots, greedy,
               32 new tokens a request: MiniCPM-2B (40 layers) and RWKV-6
               1.6B (24 layers) at max_len 1024 on prompts of 113-699
               tokens, Hymba-1.5B (32 layers, window 1024, global layers 0,
               15, 31) at max_len 2048 on prompts of 113-1300 tokens (1300
               exceeds the window in the prefill; 1010 wraps the decode
               ring); RWKV-6 and Hymba also get a one-token prompt, whose
               prefill goes through the scan kernel too; the first prompt
               is repeated to hit the prefix cache.
               Every kernel's launch count is zeroed before each path and
               must then equal layers x prefills (flash_attention and the
               family's scan) and layers x decode steps (decode_attention),
               and zero for kernels the family does not run.  Reports
               prefill ms, decode-step ms, tokens/s, peak memory, the
               decode step's device-idle share and decode_attention's
               device time a step.
8. <path>_check — one request's output alone equals its output in the full
               batch; the card's prefill logits for that prompt, through
               the first 2 layers at full width, agree with the port's CPU
               run of the same weights within 5% of the largest CPU logit,
               and their greedy tokens agree where the CPU margin is clear.
9. lm_gemma2 (+ _check), lm_gemma2_int8 — Gemma-2 2B at full width and
               depth (26 layers alternating a 4,096-token window and global
               attention, soft caps 50 and 30) through the engine at
               max_len 8192 on prompts of 113-5000 tokens (5000 passes the
               window in the prefill; 4080 + 32 wraps the local ring), then
               the same weights with an int8 KV cache: its launches, its
               own checks, and for every request the greedy token after the
               prefill and one decode step equal to the bfloat16 cache's
               wherever the bfloat16 margin is clear; KV bytes of both.
10. speculative, paged — ``speculative_decode`` with Gemma-2 2B as the
               target and two drafts (the target, a 4-layer Gemma-2 from
               another seed), k = 4, 32 tokens from a 113-token prompt,
               against ``greedy_decode``: they may part only where the
               target's margin is not clear; acceptance, target calls, ms a
               token.  ``PagedKVCache`` at Gemma-2's KV shape: decode
               attention over ``batch_gather`` bitwise equal to contiguous
               caches, an exhausted pool raising MemoryError, pool bytes
               against per-slot caches.
11. lm_moe, lm_qwen3_moe — Granite-3.0-1B-A400M (24 layers, 32 experts,
               top-8) and Qwen3-30B-A3B (128 experts, QK-norm; 12 of its 48
               layers) through the engine on the ``lm`` prompts: launches,
               the (token, expert) pairs dropped by capacity in a decode
               step and a prefill, the card against the CPU through 2
               layers (a request alone need not equal it in a batch: an
               expert's capacity couples the batch), and for Granite two
               card runs bitwise equal.
12. lm_encdec, lm_vlm — seamless-m4t-large-v2 (24 + 24 layers; 256 source
               frames, target prompts of 1-64 tokens) and Pixtral-12B (40
               layers; 1,024 patch embeddings before 113 or 333 tokens),
               each request prefilled alone, then 32 greedy decode steps
               for the batch: launches (72 flash a prefill and 48 decode a
               step for the encoder-decoder), prefill and decode-step ms,
               peak memory, the card against the CPU through 2 (+ 2
               encoder) layers.
13. train_kernels — the flash kernel's log-sum-exp (written for the
               backward) against ``ref.py``'s within 1e-4, float32 and
               bfloat16, at MiniCPM-2B's train shape (B 8, S = T = 256, 36
               heads of 64, causal), Gemma-2's local and global layers (D
               256, cap 50, S = T = 4,200), a bidirectional and a cross case
               (S != T), one token, and rows that see no key (lse -1e30);
               ``out`` within 2e-5 / 2e-2 on every row that sees a key; the
               flash VJP's dq, dk, dv on the card against autograd through
               the float32 plain version (3e-4 / 1e-3); the scan wrappers
               refusing a gradient when called directly; at the train
               shape, the launch with and
               without the lse, the plain backward's device time and SDPA's
               forward + backward.
14. train   — MiniCPM-2B at full width and depth (40 layers, float32 master
               weights, AdamW, WSD, remat) for 5 steps of ``make_train_step``
               on ``TokenStream`` batches of 8 x 256: exactly 80 flash
               launches a step (each layer's forward and remat's
               recompute), finite losses; step ms, tokens/s, the profiled
               step's device busy ms, idle share and split (flash forward,
               flash backward, matmuls, optimizer), peak memory.
15. train_check — one step at full width and 2 layers, B 1 x 64, on the
               card and on the CPU from the same parameters: loss within
               1e-3, every leaf's gradient within 8% relative L2.
16. train_restart — full width, 2 layers, B 2 x 128, 6 steps of
               ``train()`` checkpointing every 3: a failure injected at step
               4 restarts from step 3 and ends within 1e-4 of the clean
               run's loss; a NaN-poisoned step is skipped, the state
               bitwise kept.
17. launch_train — ``python -m repro_torch.launch.train --arch minicpm-2b
               --reduced --steps 14`` on the card: exit 0, loss dropping.
18. train_scans — RWKV-6 1.6B and Hymba 1.5B at full width and depth
               (float32 master weights, AdamW, cosine, remat), 3 steps of
               ``make_train_step`` each on ``TokenStream`` batches of 8 x
               256, through the scans' autograd Functions (forward the
               kernel, backward the plain chunked form): exactly 48
               rwkv6_scan launches a step, and 64 ssd_scan plus 64 flash
               launches a Hymba step; finite losses; step ms, tokens/s,
               the profiled step's busy ms, idle share and split (scan
               forward and backward, flash, matmuls, optimizer), peak
               memory.  Then the Functions at those kernel shapes in
               float32: one launch a call, the forward within 3e-4 of
               ``ref.py``'s recurrence, every input's gradient within 1e-4
               relative L2 of autograd through it; and one step of each
               family at ``reduced_config``, the card against the CPU:
               loss within 1e-3, every leaf within 8% relative L2 (Hymba's
               dt_bias and d_skip 25%).
19. moe_sharded — Qwen3-MoE's MoE layer at full width, float32, 4 x 256
               tokens, on a mesh whose model axis is every local card
               (one card: model = 1): ``moe_apply_sharded`` (psum) and
               ``moe_apply_sharded_a2a`` against the local ``moe_apply``
               within 1e-4 at capacity factor 8 (nothing dropped).
20. launch  — ``python -m repro_torch.launch.serve --arch minicpm-2b``
               (through its ``main``) on the card, launches exactly flash
               2 a prefill and decode 2 a step; the dry-run cell
               granite-moe-1b-a400m x prefill_32k on the single-pod H100
               mesh and ``raven_dryrun``, each writing its JSON under
               ``chiprun_out/dryrun``; ``rescale_state`` of train_restart's
               newest checkpoint onto a mesh over every local card, every
               leaf gathered back bitwise.
               Every phase's seconds follow it on a line of its own.

Then one ``{"kernels": [...]}`` line (tree_gemm's launches split by phase
under ``launches_by_phase``: main, service, sharded; the attention
kernels' under ``launches_by_path``, ``train``, ``train_scans`` and
``launch`` among them), and last
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or of
the JAX package.

``python3 chip_smoke.py --decode-cold`` runs phase 1 and only
decode_attention's cold-L2 timings; a copy of this file in an unpacked
earlier checkout times that checkout's kernel with the same timer.
``python3 chip_smoke.py --train`` runs phases 1, 2 and 13-18 only.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 on CUDA cores, dense
# bfloat16 and int8 on tensor cores, HBM3; kept in the package, whose
# dry-run's roofline uses them too.
from repro_torch.kernels.cost import (PEAK_BF16_FLOPS,  # noqa: E402
                                      PEAK_BYTES_PER_S, PEAK_FP32_FLOPS,
                                      PEAK_INT8_OPS)
N_ROWS = 1_000_000          # patients per table
N_TREES, DEPTH = 64, 8
FIT_ROWS = 50_000
FEATURES = ["age", "gender", "pregnant", "rcount", "hematocrit",
            "neutrophils", "bp"]
# Query (a) joins blood_tests: three of the seven features live there.
# The grammar takes only a column inside an aggregate, so (c) names the
# PREDICT_PROBA column by its placeholder, registered through WHERE.
QUERIES = {
    "a": "SELECT pid, PREDICT(MODEL='rf') AS s FROM patient_info "
         "JOIN blood_tests ON pid",
    "b": "SELECT pid, age, PREDICT(MODEL='rf') AS s FROM patient_info "
         "JOIN blood_tests ON pid JOIN prenatal_tests ON pid "
         "WHERE pregnant = 1 AND PREDICT(MODEL='rf') > 0",
    "c": "SELECT gender, AVG(__pred_0_rf) AS p FROM patient_info "
         "JOIN blood_tests ON pid WHERE PREDICT_PROBA(MODEL='rf') >= 0 "
         "GROUP BY gender",
}
STRATEGIES = ("traversal", "gemm", "cuda", "auto")
DEVICE_RUNS = 50            # back-to-back launches a device_ms spans

# The LM paths, each a model at full width served by InferenceEngine with
# LM_SLOTS slots, greedy, LM_NEW_TOKENS tokens a request.
LM_SEED = 0
LM_SLOTS, LM_NEW_TOKENS = 4, 32
# Prompt lengths between 100 and 700, none a multiple of 128; the last
# request repeats the first prompt, so it hits the prefix cache.
LM_PROMPT_LENS = (113, 245, 333, 402, 517, 590, 699)
# Hymba's: past its 1,024-token window once in the prefill (1300) and once
# while decoding (1010 + 32 new tokens wraps the ring).
HYMBA_PROMPT_LENS = (113, 333, 517, 699, 1010, 1300)
# Gemma-2's: past its 4,096-token window in the prefill (5000) and while
# decoding (4080 + 32 new tokens wraps the local layers' ring).
GEMMA2_PROMPT_LENS = (113, 699, 2048, 4080, 5000)
# Qwen3-30B-A3B keeps 12 of its 48 layers: ~16 GB of bfloat16 weights.
QWEN3_LAYERS = 12
LM_REPEAT = 0


@dataclasses.dataclass(frozen=True)
class LmPath:
    """An LM path: the config, the engine's max_len, the prompt lengths,
    the prompt of the card-vs-CPU check (and, where ``alone``, of the
    alone-vs-batch check), the layers kept (None: all) and the KV cache's
    dtype.  The recurrent families also prefill a one-token prompt."""
    arch: str
    max_len: int
    lens: tuple
    check: int
    alone: bool = True
    layers: int | None = None
    kv: str = "bfloat16"


# A mixture of experts drops (token, expert) pairs past an expert's
# capacity, which depends on the whole batch (GShard; in the JAX package
# too): one request alone need not equal it in a batch.
LM_PATHS = {
    "lm": LmPath("minicpm-2b", 1024, LM_PROMPT_LENS, 2),
    "lm_rwkv": LmPath("rwkv6-1.6b", 1024, LM_PROMPT_LENS + (1,), 2),
    "lm_hymba": LmPath("hymba-1.5b", 2048, HYMBA_PROMPT_LENS + (1,), 5),
    "lm_gemma2": LmPath("gemma2-2b", 8192, GEMMA2_PROMPT_LENS, 1),
    "lm_gemma2_int8": LmPath("gemma2-2b", 8192, GEMMA2_PROMPT_LENS, 1,
                             kv="int8"),
    "lm_moe": LmPath("granite-moe-1b-a400m", 1024, LM_PROMPT_LENS, 2,
                     alone=False),
    "lm_qwen3_moe": LmPath("qwen3-moe-30b-a3b", 1024, LM_PROMPT_LENS[:4], 2,
                           alone=False, layers=QWEN3_LAYERS),
}
LM_CHECK_LAYERS = 2   # depth of the card-vs-CPU logits check
LM_CHECK_REL = 0.05   # its tolerance, relative to the largest CPU logit
ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, warmup: int = 2, runs: int = 5) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int = DEVICE_RUNS, warmup: int = 3,
              by_kernel: dict | None = None) -> float:
    """Device milliseconds of one call of ``fn``: ``runs`` back-to-back
    calls, after ``warmup``, run under torch.profiler, and the summed
    duration of the device activities they caused (kernels, copies), over
    ``runs``, is the call's device time.  The host's time and any gap
    between launches are not in it, so for the bound C entry point of a
    kernel it is the kernel's own time.  Inputs that fit in the 50 MB L2
    stay warm there from one call to the next (each caller says which
    do).  ``by_kernel``, where given, receives the same per kernel (by its
    function's name), for entry points that launch several."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in device)
    if us <= 0:
        fail("torch.profiler recorded no device time")
    if by_kernel is not None:
        for e in device:
            found = re.search(r"(\w+_kernel)\b", e.name)
            name = found.group(1) if found else e.name
            by_kernel[name] = by_kernel.get(name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / runs
    return us / 1e3 / runs


# -- phase 1 -------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})
    return smi


# -- phase 2 -------------------------------------------------------------------

def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.decode_attention import \
        decode_attention as da_build
    from repro_torch.kernels.featurized_linear import \
        featurized_linear as fl_build
    from repro_torch.kernels.flash_attention import \
        flash_attention as fa_build
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wkv_build
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_build
    from repro_torch.kernels.tree_gemm import tree_gemm as tg_build
    builders = {"tree_gemm": tg_build.build,
                "featurized_linear": fl_build.build,
                "flash_attention": fa_build.build,
                "decode_attention": da_build.build,
                "rwkv6_scan": wkv_build.build, "ssd_scan": ssd_build.build}
    from repro_torch.kernels.build import ptxas_report
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {k: pool.submit(fn) for k, fn in builders.items()}
        libs = {k: str(f.result().relative_to(ROOT))
                for k, f in futures.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs})
    sources = {"tree_gemm": tg_build.SOURCE,
               "featurized_linear": fl_build.SOURCE,
               "flash_attention": fa_build.SOURCE,
               "decode_attention": da_build.SOURCE,
               "rwkv6_scan": wkv_build.SOURCE, "ssd_scan": ssd_build.SOURCE}
    import torch
    dynamic = {"tree_gemm": {"F7_I256_O2": tg_build.smem_bytes(7, 256, 2)},
               "flash_attention": {
                   f"{dt}_D{d}": fa_build.smem_bytes(d, getattr(torch, dt))
                   for dt in ("bfloat16", "float32") for d in (64, 128, 256)}}
    for name, src in sources.items():
        emit({"phase": "build", "kernel": name, "ptxas": ptxas_report(src),
              "dynamic_smem_bytes": dynamic.get(name)})


# -- phase 3 -------------------------------------------------------------------

def tree_gemm_bound_ms(x, ens) -> tuple:
    """Least time for this call -> (ms, bound_by, fp32 ms).

    The work is the function's: per row and tree, the I gates, S = gates . c
    over I x L, the L matches and the payout.  The kernel takes the gates by
    a gather (the one-hot product x . a of the TPU kernel gives the same
    booleans, so its F x I multiply-adds are not work the function needs)
    and S in int8 with an int32 accumulator (exact: {0,1} x {-1,0,+1}), so
    the operations are 2 N T I L int8 tensor-core operations at 1,979 TOP/s
    plus N T (I + L) gathers and compares at the CUDA cores' 67 T/s; the
    bytes are x read once, the kernel's operands (int8 c, int32 d and
    feat, float32 b and e) once and the output written once; the larger
    of the two is the bound.  The third value is the bound of the earlier
    float32 CUDA-core formulation, every product in float32 with the
    one-hot gating kept, 2 N T (F I + I L + L O) at 67 TFLOP/s."""
    n, f = x.shape
    t, _, i = ens.a.shape
    l, o = ens.c.shape[2], ens.e.shape[2]
    by_ops = (2.0 * n * t * i * l / PEAK_INT8_OPS
              + 1.0 * n * t * (i + l) / PEAK_FP32_FLOPS)
    nbytes = 4.0 * x.numel() + t * i * l + 4.0 * t * (l + 2 * i + l * o) \
        + 4.0 * n * o
    by_bytes = nbytes / PEAK_BYTES_PER_S
    fp32 = 2.0 * n * t * (f * i + i * l + l * o) / PEAK_FP32_FLOPS
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes", fp32 * 1e3)


def compare_tree_gemm(ens_dev, x) -> float:
    """Kernel vs plain version on the same card inputs -> max |diff|.  The
    plain side repeats the wrapper's input mapping and averaging."""
    import numpy as np
    import torch

    from repro_torch.kernels.tree_gemm import ops as tg_ops
    from repro_torch.kernels.tree_gemm.ref import tree_gemm_ref
    got = tg_ops.tree_gemm(ens_dev, x)
    xm = torch.nan_to_num(x, nan=tg_ops._FMAX, posinf=tg_ops._FMAX,
                          neginf=-tg_ops._FMAX)
    want = tree_gemm_ref(xm, ens_dev.a, ens_dev.b, ens_dev.c, ens_dev.d,
                         ens_dev.e)
    if ens_dev.average:
        want = want * float(np.float32(1.0) / np.float32(ens_dev.n_trees))
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"tree_gemm output {tuple(got.shape)} not finite/shaped "
             f"like {tuple(want.shape)}")
    return float((got - want).abs().max())


def phase_kernels(ens, ens_pad8, x_main):
    """tree_gemm against its plain version: edge cases (ragged rows,
    NaN/±inf, one tree, I and L not multiples of the kernel's tiles), then
    the main path's shape (the plan's ensemble on query (a)'s features),
    timed."""
    import numpy as np
    import torch

    from repro_torch.kernels.tree_gemm.ref import tree_gemm_ref
    from repro_torch.ml.hummingbird import EnsembleGemm
    dev = x_main.device
    rng = np.random.default_rng(1)
    one_tree = EnsembleGemm(ens.a[:1], ens.b[:1], ens.c[:1], ens.d[:1],
                            ens.e[:1], n_trees=1, average=True,
                            feat=ens.feat[:1])
    cases = []
    for n in (1, 63, 65, 1001, 100_003):
        x = x_main[:n].clone()
        poison = torch.from_numpy(rng.random(tuple(x.shape))).to(dev)
        x[poison < 0.02] = float("nan")
        x[poison > 0.99] = float("inf")
        x[(poison > 0.5) & (poison < 0.51)] = float("-inf")
        cases.append((f"ragged_nan_inf_n{n}", ens, x))
    cases.append(("one_tree_n4097", one_tree, x_main[:4097]))
    cases.append(("pad8_n70001", ens_pad8, x_main[:70_001]))
    cases.append(("main_path", ens, x_main))
    worst = 0.0
    for name, e, x in cases:
        err = compare_tree_gemm(e.to_device(dev), x)
        emit({"phase": "kernels", "kernel": "tree_gemm", "case": name,
              "shape": {"x": list(x.shape), "a": list(e.a.shape),
                        "c": list(e.c.shape), "e": list(e.e.shape)},
              "max_abs_err": err})
        worst = max(worst, err)
    if worst != 0.0:
        fail(f"tree_gemm disagrees with its plain version: {worst}")

    from repro_torch.kernels.tree_gemm import ops as tg_ops
    from repro_torch.kernels.tree_gemm.tree_gemm import tree_gemm_cuda
    dens = ens.to_device(dev)
    xm = torch.nan_to_num(x_main, nan=tg_ops._FMAX, posinf=tg_ops._FMAX,
                          neginf=-tg_ops._FMAX)
    ms = cuda_ms(lambda: tg_ops.tree_gemm(dens, x_main))
    # device time of the C entry point: x (28 MB), the int8 c (4 MB) and
    # the output (8 MB) fit in L2 together, so repeated launches find part
    # of x warm; reading all of x from HBM takes ~8 us of a kernel of
    # milliseconds either way
    xm = xm.contiguous()
    operands = tg_ops.kernel_operands(dens)
    out = torch.empty((x_main.shape[0], dens.e.shape[2]),
                      dtype=torch.float32, device=dev)
    dev_ms = device_ms(
        lambda: tree_gemm_cuda(xm, operands, dens.e, out))
    plain_ms = cuda_ms(lambda: tree_gemm_ref(xm, dens.a, dens.b, dens.c,
                                             dens.d, dens.e))
    bound_ms, bound_by, fp32_ms = tree_gemm_bound_ms(x_main, dens)
    row = {"name": "tree_gemm", "route": "cuda",
           "source": "src/repro_torch/csrc/tree_gemm.cu",
           "replaces": "src/repro/kernels/tree_gemm/tree_gemm.py:75",
           "max_abs_err": worst, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_fp32_ms": fp32_ms,
           # no single PyTorch call computes this function
           "library_ms": None, "library_device_ms": None}
    emit({"phase": "kernels", "kernel": "tree_gemm", "timing": row,
          "x": list(x_main.shape)})
    return row


# -- phase 3, the featurized linear scorer ------------------------------------

BENCH_FLIGHTS = 5_819_079        # the benchmark's flights table


def flights_operands(n, code_dtype="int32", seed=0):
    """The benchmark's flights model as the kernel sees it: 40 of 322
    origins, 40 of 322 destinations and 2 of 14 carriers kept (scattered
    codes), taxi_out and dep_hour scaled, 84 weights; ``n`` rows of raw
    columns on the card, codes drawn past the kept ones."""
    import numpy as np
    import torch

    from repro_torch.ml import OneHotEncoder, StandardScaler
    rng = np.random.default_rng(seed)
    enc = OneHotEncoder(["origin", "dest", "carrier"])
    enc.categories = {c: np.sort(rng.choice(d, k, replace=False))
                      .astype(np.int32)
                      for c, d, k in (("origin", 322, 40), ("dest", 322, 40),
                                      ("carrier", 14, 2))}
    sc = StandardScaler(["taxi_out", "dep_hour"])
    sc.mean, sc.std = np.float32([16.1, 13.2]), np.float32([8.9, 4.8])
    w = rng.normal(1.0, 0.5, (84, 1)).astype(np.float32)
    w[-2:] = rng.normal(0.0, 0.5, (2, 1))
    cols = {"origin": rng.integers(-2, 330, n),
            "dest": rng.integers(0, 322, n),
            "carrier": rng.integers(0, 16, n),
            "taxi_out": rng.gamma(4.0, 4.0, n).astype(np.float32),
            "dep_hour": rng.integers(0, 24, n).astype(np.int32)}
    for c in ("origin", "dest", "carrier"):
        cols[c] = cols[c] % 2 == 0 if code_dtype == "bool" \
            else cols[c].astype(np.int32)
    return ([enc, sc], w, np.float32([-2.1]),
            {k: torch.as_tensor(v).cuda() for k, v in cols.items()})


def phase_featurized_linear():
    """featurized_linear against its plain version (bitwise) at edge sizes,
    on misaligned slices and at the benchmark's 5,819,079 flights, and
    against the unfused plan (the featurizers' matrix and the row-wise
    fold) there; then timed: the wrapper, the C entry point's device time,
    the plain version and the unfused nodes, beside the bound by bytes.
    The columns and the logits (139.7 MB) exceed the 50 MB L2, so each
    launch reads from HBM."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.kernels.featurized_linear import ops as fl_ops
    from repro_torch.kernels.featurized_linear.featurized_linear import \
        featurized_linear_cuda
    from repro_torch.kernels.featurized_linear.ref import \
        featurized_linear_ref
    from repro_torch.ml.linear import rowwise_matmul

    def bitwise(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    dev = torch.device("cuda")
    for n, dtype, offset in ((1, "int32", 0), (31, "int32", 1),
                             (4097, "bool", 2), (4097, "int32", 3),
                             (BENCH_FLIGHTS, "int32", 1)):
        feats, w, b, cols = flights_operands(n + offset, dtype, seed=n)
        cols = {k: v[offset:] for k, v in cols.items()}
        op = fl_ops.prepare(feats, w, b, dev)
        got = fl_ops.featurized_linear(op, cols)
        want = featurized_linear_ref([cols[c] for c in op.columns],
                                     op.blocks, op.table, op.bias)
        ok = bitwise(got, want)
        emit({"phase": "kernels", "kernel": "featurized_linear",
              "case": f"n{n}_{dtype}_offset{offset}", "bitwise": ok})
        if not ok:
            fail(f"featurized_linear differs from its plain version at "
                 f"n={n}, {dtype}, offset {offset}")

    feats, w, b, cols = flights_operands(BENCH_FLIGHTS)
    op = fl_ops.prepare(feats, w, b, dev)
    wt, bt = torch.as_tensor(w, device=dev), torch.as_tensor(b, device=dev)

    def unfused():
        x = torch.cat([f.transform(cols) for f in feats], dim=1)
        return rowwise_matmul(x, wt) + bt

    got = fl_ops.featurized_linear(op, cols)
    if not bitwise(got, unfused()):
        fail("featurized_linear differs from the unfused plan at "
             f"{BENCH_FLIGHTS} rows")
    ordered = [cols[c] for c in op.columns]
    blocks, aligned, _ = fl_ops.kernel_blocks(op, ordered)
    out = torch.empty((BENCH_FLIGHTS, 1), dtype=torch.float32, device=dev)
    launches0 = fl_ops.launches
    ms = cuda_ms(lambda: fl_ops.featurized_linear(op, cols))
    dev_ms = device_ms(lambda: featurized_linear_cuda(blocks, aligned,
                                                      op.table, op.bias,
                                                      out))
    plain_ms = cuda_ms(lambda: featurized_linear_ref(ordered, op.blocks,
                                                     op.table, op.bias))
    plain_dev_ms = device_ms(lambda: featurized_linear_ref(
        ordered, op.blocks, op.table, op.bias), runs=10)
    unfused_ms = cuda_ms(unfused)
    unfused_dev_ms = device_ms(unfused, runs=10)
    work = cost.featurized_linear_cost(BENCH_FLIGHTS, 5 * 4, 3, 2)
    bound_ms = work["bytes"] / cost.PEAK_BYTES_PER_S * 1e3
    row = {"name": "featurized_linear", "route": "cuda",
           "source": "src/repro_torch/csrc/featurized_linear.cu",
           "replaces": None, "rows": BENCH_FLIGHTS, "bitwise": True,
           "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "plain_device_ms": plain_dev_ms,
           "unfused_ms": unfused_ms, "unfused_device_ms": unfused_dev_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_bytes": work["bytes"],
           "roofline_pct": 100.0 * bound_ms / dev_ms,
           "wrapper_launches_timed": fl_ops.launches - launches0,
           "library_ms": None, "library_device_ms": None}
    emit({"phase": "kernels", "kernel": "featurized_linear", "timing": row})
    return row


# -- phases 4 and 5 ------------------------------------------------------------

def setup_model(tables):
    """The 64-tree forest, fitted with the port's numpy CART on the first
    50,000 patients (label: stay longer than 7 days)."""
    import numpy as np

    from repro_torch.ml import (Pipeline, PipelineMetadata, RandomForest,
                                StandardScaler)
    from repro_torch.relational.table import to_numpy
    data = {c: to_numpy(t.column(c))[:FIT_ROWS]
            for t in tables.values() for c in t.names}
    pipe = Pipeline([StandardScaler(FEATURES).fit(data)],
                    RandomForest(n_trees=N_TREES, max_depth=DEPTH),
                    PipelineMetadata(name="rf", task="classification"))
    t0 = time.perf_counter()
    pipe.fit({k: data[k] for k in FEATURES},
             (data["length_of_stay"] > 7.0).astype(np.int32))
    return pipe, time.perf_counter() - t0


def strategy_of(plan) -> str:
    return next((n.attrs.get("strategy", "gemm") for n in plan.nodes.values()
                 if n.op == "tree_gemm"), "traversal")


def run_query(store, sql, strategy, timed_runs=3):
    """Optimize with the strategy forced (or "auto"), compile, run once to
    warm and count kernel launches, time ``timed_runs`` runs, and run once
    more op by op (codegen's ``node_hook``, which synchronizes the card
    around every node) for the per-operator breakdown."""
    import torch

    from repro_torch.core import (CrossOptimizer, OptimizerConfig,
                                  compile_plan, parse_query)
    from repro_torch.kernels.tree_gemm import ops as tg_ops
    t0 = time.perf_counter()
    plan, _report = CrossOptimizer(store, OptimizerConfig(
        tree_strategy=strategy)).optimize(parse_query(sql, store))
    fn = compile_plan(plan, store)
    plan_ms = (time.perf_counter() - t0) * 1e3
    tabs = {n: store.get_table(n) for n in store.table_names()}
    before = tg_ops.launches
    out = fn(tabs)
    torch.cuda.synchronize()
    launches = tg_ops.launches - before
    times = []
    for _ in range(timed_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(tabs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ops_ms = {}

    def hook(nid, node, value, elapsed_s):
        ops_ms[node.op] = ops_ms.get(node.op, 0.0) + elapsed_s * 1e3

    compile_plan(plan, store, node_hook=hook)(tabs)
    return out, {"chosen": strategy_of(plan), "plan_ms": plan_ms,
                 # the cost model's predictions, when it chose ("auto")
                 "predicted": [d for r, d in _report.entries
                               if r == "tree_strategy"],
                 "ms": statistics.median(times), "ms_runs": times,
                 "launches_per_run": launches,
                 "ops_ms": dict(sorted(ops_ms.items(),
                                       key=lambda kv: -kv[1]))}


def host(table):
    from repro_torch.relational.table import to_numpy
    return {"valid": to_numpy(table.valid),
            **{k: to_numpy(v) for k, v in table.columns.items()}}


def same(a, b) -> bool:
    import numpy as np
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k],
                                                    equal_nan=True)
        for k in a)


MODEL_OPS = ("predict_model", "tree_gemm")   # the model's operator, by form
AUTO_SLACK = 1.10       # "auto" may pick a strategy this close to the best
PREDICT_FACTOR = 2.0    # its prediction within this factor of the measured


def model_op_ms(info) -> float:
    """The model operator's time in a run's per-operator breakdown."""
    return sum(info["ops_ms"].get(op, 0.0) for op in MODEL_OPS)


def predicted_ms(info) -> dict:
    """The cost model's per-strategy predictions (ms) from the optimizer's
    ``tree_strategy`` report line: "rf: cuda (est rows 1e+06; cuda
    17000us, traversal 70000us, gemm 300000us)"."""
    if not info["predicted"]:
        fail(f"\"auto\" logged no tree_strategy prediction: {info}")
    costs = info["predicted"][0].split(";", 1)[1]
    return {k: float(v) / 1e3
            for k, v in re.findall(r"(\w+) ([\d.]+)us", costs)}


def check_auto(q, infos) -> None:
    """The "auto" strategy must be the one whose forced run had the
    lowest model-operator time (a runner-up within AUTO_SLACK counts), and
    its prediction for that strategy must lie within PREDICT_FACTOR of
    that time."""
    measured = {s: model_op_ms(infos[q, s]) for s in STRATEGIES[:-1]}
    auto = infos[q, "auto"]
    chosen = auto["chosen"]
    pred = predicted_ms(auto)
    ratios = {s: pred[s] / measured[s] for s in measured if s in pred}
    best = min(measured, key=measured.get)
    emit({"phase": "main", "query": q, "step": "auto_gate",
          "chosen": chosen, "fastest": best, "measured_model_ms": measured,
          "predicted_ms": pred, "predicted_over_measured": ratios,
          "plan_ms": auto["plan_ms"]})
    if measured[chosen] > AUTO_SLACK * measured[best]:
        fail(f"query ({q}): \"auto\" chose {chosen} "
             f"({measured[chosen]:.2f} ms), but {best} ran "
             f"{measured[best]:.2f} ms")
    if not 1 / PREDICT_FACTOR <= ratios.get(chosen, 0.0) <= PREDICT_FACTOR:
        fail(f"query ({q}): \"auto\" predicted {chosen} at "
             f"{pred.get(chosen)} ms, measured {measured[chosen]:.2f} ms")


def phase_main(tables, pipe):
    import numpy as np

    from repro_torch.core import ModelStore
    from repro_torch.kernels.tree_gemm import ops as tg_ops
    tg_ops.launches = 0                 # counts from here on are the path's
    t0 = time.perf_counter()
    store = ModelStore(device="cuda")
    for name, t in tables.items():
        store.register_table(name, t)
    store.register_model("rf", pipe)
    emit({"phase": "main", "step": "register", "rows": N_ROWS,
          "tables": sorted(tables), "seconds": time.perf_counter() - t0})
    outs, infos = {}, {}
    for q, sql in QUERIES.items():
        for strategy in STRATEGIES:
            out, info = run_query(store, sql, strategy)
            infos[q, strategy] = info
            h = host(out)
            live = int(h["valid"].sum())
            for k, v in h.items():
                if v.dtype.kind == "f" and not np.isfinite(v[h["valid"]]).all():
                    fail(f"query ({q}) {strategy}: column {k} not finite")
            emit({"phase": "main", "query": q, "strategy": strategy,
                  "live_rows": live, "capacity": int(h["valid"].shape[0]),
                  **info})
            if strategy == "cuda" and info["launches_per_run"] != 1:
                fail(f"query ({q}) with strategy cuda launched tree_gemm "
                     f"{info['launches_per_run']} times, expected 1")
            outs[q, strategy] = h
        base = outs[q, "traversal"]
        for strategy in STRATEGIES[1:]:
            if not same(base, outs[q, strategy]):
                fail(f"query ({q}): {strategy} differs from traversal")
        check_auto(q, infos)
    launches = tg_ops.launches
    if launches == 0:
        fail("the main path never launched the tree_gemm kernel")
    emit({"phase": "main", "step": "agree", "queries": sorted(QUERIES),
          "strategies": list(STRATEGIES), "bitwise_equal": True,
          "tree_gemm_launches": launches})
    return outs, launches, store, infos


def phase_check(tables, pipe, outs):
    """Query (a) by the port on the CPU with traversal vs the card."""
    from repro_torch.core import ModelStore
    cpu = ModelStore(device="cpu")
    for name in ("patient_info", "blood_tests"):
        cpu.register_table(name, tables[name])
    cpu.register_model("rf", pipe)
    t0 = time.perf_counter()
    from repro_torch.core import (CrossOptimizer, OptimizerConfig, execute,
                                  parse_query)
    plan, _ = CrossOptimizer(cpu, OptimizerConfig(
        tree_strategy="traversal")).optimize(parse_query(QUERIES["a"], cpu))
    want = host(execute(plan, cpu))
    equal = {s: same(want, outs["a", s]) for s in STRATEGIES}
    emit({"phase": "check", "query": "a", "cpu_traversal_vs_card": equal,
          "rows": int(want["valid"].shape[0]),
          "cpu_seconds": time.perf_counter() - t0})
    if not all(equal.values()):
        fail(f"query (a) on the card differs from the CPU: {equal}")


# -- phase 6: the main path's front door -------------------------------------

SERVICE_SQL = "SELECT pid, PREDICT(MODEL='rf') AS s FROM scoring"
SERVICE_SEED = 21
SERVICE_REQUESTS = 16              # coalesced requests, rows drawn from:
SERVICE_ROWS = (1_000, 65_536)
SERVICE_CHUNK = 262_144            # chunked service: 1M rows -> 4 chunks
BACKGROUND_THREADS = 4             # host threads submitting, each all
                                   # SERVICE_REQUESTS requests (64 in all)
BACKGROUND_BUDGET_S = 0.005


def scoring_table(tables):
    """One flat table: pid and the seven features, ``patient_info`` joined
    with ``blood_tests`` on pid once, by the port's join on the host."""
    from repro_torch.relational import ops as rel_ops
    joined = rel_ops.join_unique(tables["patient_info"],
                                 tables["blood_tests"], on="pid")
    return joined.select(["pid"] + FEATURES)


def rows_of(table, start, n):
    return type(table)({k: v[start:start + n]
                        for k, v in table.columns.items()},
                       table.valid[start:start + n], table.schema)


def phase_service(store, tables, main_outs, main_infos):
    """The main path through its front door: the port's
    ``PredictionService`` on ``phase_main``'s store, under the default
    optimizer config (``"auto"``).  Cold then warm SQL, coalesced
    override-table requests, a chunked service, background admission
    from several host threads, and ``explain(analyze=True)``.  Returns
    the tree_gemm launches it made."""
    import threading

    import numpy as np
    import torch

    from repro_torch.core import codegen
    from repro_torch.kernels.tree_gemm import ops as tg_ops
    from repro_torch.serve import AdmissionConfig, PredictionService
    launches0 = tg_ops.launches
    t0 = time.perf_counter()
    store.register_table("scoring", scoring_table(tables))
    scoring = store.get_table("scoring")
    emit({"phase": "service", "step": "register", "table": "scoring",
          "rows": scoring.capacity, "columns": list(scoring.names),
          "seconds": time.perf_counter() - t0})

    def stats(svc):
        return dict(vars(svc.stats))

    svc = PredictionService(store)
    try:
        # 1. queries (a)-(c) cold, then twice warm, through svc.sql
        l0, s0 = tg_ops.launches, stats(svc)
        rounds = []
        for r in range(3):
            if r == 2:
                c2 = codegen.compile_stats["plans_compiled"]
                j2 = svc.stats.jit_traces
            ms = {}
            for q, sql in QUERIES.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = svc.sql(sql)
                ms[q] = (time.perf_counter() - t) * 1e3
                if not same(host(out), main_outs[q, "auto"]):
                    fail(f"service: query ({q}), round {r}, differs from "
                         "phase_main's \"auto\" output")
            rounds.append(ms)
        compiles2 = codegen.compile_stats["plans_compiled"] - c2
        traces2 = svc.stats.jit_traces - j2
        launched = tg_ops.launches - l0
        d = {k: v - s0[k] for k, v in stats(svc).items()}
        emit({"phase": "service", "step": "sql",
              "cold_ms": rounds[0], "warm_ms": rounds[1],
              "warm2_ms": rounds[2],
              "direct_ms": {q: main_infos[q, "auto"]["ms"]
                            for q in QUERIES},
              "warm_overhead_ms": {q: rounds[2][q]
                                   - main_infos[q, "auto"]["ms"]
                                   for q in QUERIES},
              "second_warm_round": {"plans_compiled": compiles2,
                                    "jit_traces": traces2},
              "tree_gemm_launches": launched,
              "batch_executions": d["batch_executions"],
              "stats": {k: v for k, v in d.items() if v}})
        if compiles2 or traces2:
            fail(f"service: the second warm round compiled {compiles2} "
                 f"plans and traced {traces2} signatures")
        if launched != d["batch_executions"]:
            fail(f"service: {launched} tree_gemm launches for "
                 f"{d['batch_executions']} executions")

        # 2. coalesced override-table requests, each vs served alone
        rng = np.random.default_rng(SERVICE_SEED)
        sizes = rng.integers(SERVICE_ROWS[0], SERVICE_ROWS[1] + 1,
                             SERVICE_REQUESTS)
        starts = rng.integers(0, scoring.capacity - sizes)
        slices = [rows_of(scoring, int(a), int(n))
                  for a, n in zip(starts, sizes)]
        alone = [host(svc.run(SERVICE_SQL, {"scoring": t})) for t in slices]
        l0, s0 = tg_ops.launches, stats(svc)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tickets = [svc.submit(SERVICE_SQL, {"scoring": t}) for t in slices]
        served = svc.flush()
        flush_ms = (time.perf_counter() - t) * 1e3
        for i, (tk, want) in enumerate(zip(tickets, alone)):
            if not same(host(tk.result(timeout=60)), want):
                fail(f"service: coalesced request {i} differs from the "
                     f"same request served alone")
        launched = tg_ops.launches - l0
        d = {k: v - s0[k] for k, v in stats(svc).items()}
        emit({"phase": "service", "step": "coalesced",
              "requests": SERVICE_REQUESTS, "served": served,
              "rows": [int(n) for n in sizes], "stacked_rows": int(sum(sizes)),
              "flush_ms": flush_ms,
              "coalesced_requests": d["coalesced_requests"],
              "bucket_compiles": svc.stats.bucket_compiles,
              "jit_traces": svc.stats.jit_traces,
              "batch_executions": d["batch_executions"],
              "tree_gemm_launches": launched})
        if served != SERVICE_REQUESTS \
                or d["coalesced_requests"] != SERVICE_REQUESTS - 1 \
                or launched != d["batch_executions"]:
            fail(f"service: coalescing served {served} requests in "
                 f"{d['batch_executions']} executions with {launched} "
                 f"tree_gemm launches")

        # 3. the same query over the whole table, chunked
        whole = host(svc.sql(SERVICE_SQL))
        csvc = PredictionService(store, chunk_rows=SERVICE_CHUNK)
        try:
            l0 = tg_ops.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = host(csvc.sql(SERVICE_SQL))
            chunk_ms = (time.perf_counter() - t) * 1e3
            launched = tg_ops.launches - l0
            chunks = csvc.stats.chunks_executed
        finally:
            csvc.close()
        want_chunks = -(-scoring.capacity // SERVICE_CHUNK)
        emit({"phase": "service", "step": "chunked",
              "chunk_rows": SERVICE_CHUNK, "chunks": chunks,
              "tree_gemm_launches": launched, "cold_ms": chunk_ms,
              "bitwise_equal_unchunked": same(got, whole)})
        if chunks != want_chunks or launched != want_chunks:
            fail(f"service: chunked run made {chunks} chunks and "
                 f"{launched} tree_gemm launches, expected {want_chunks}")
        if not same(got, whole):
            fail("service: the chunked answer differs from the unchunked")

        # 4. background admission from several host threads
        bsvc = PredictionService(store, admission=AdmissionConfig(
            background=True, latency_budget_s=BACKGROUND_BUDGET_S))
        results = [[None] * len(slices) for _ in range(BACKGROUND_THREADS)]
        errors = []

        def worker(w):
            try:
                tks = [bsvc.submit(SERVICE_SQL, {"scoring": t})
                       for t in slices]
                for i, tk in enumerate(tks):
                    results[w][i] = host(tk.result(timeout=60))
            except Exception as err:     # reported, then fails the phase
                errors.append(repr(err))

        l0 = tg_ops.launches
        t = time.perf_counter()
        try:
            threads = [threading.Thread(target=worker, args=(w,))
                       for w in range(BACKGROUND_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            hung = sum(th.is_alive() for th in threads)
        finally:
            tc = time.perf_counter()
            bsvc.close()
            close_s = time.perf_counter() - tc
        wall_ms = (time.perf_counter() - t) * 1e3
        info = bsvc.admission_info()
        emit({"phase": "service", "step": "background",
              "threads": BACKGROUND_THREADS,
              "requests": BACKGROUND_THREADS * len(slices),
              "latency_budget_s": BACKGROUND_BUDGET_S, "wall_ms": wall_ms,
              "close_s": close_s,
              "queue_p50_ms": info["queue_p50_ms"],
              "queue_p95_ms": info["queue_p95_ms"],
              "batch_executions": bsvc.stats.batch_executions,
              "tree_gemm_launches": tg_ops.launches - l0,
              "admission_info": info})
        if hung or errors:
            fail(f"service: background admission: {hung} threads hung, "
                 f"errors {errors[:3]}")
        for w in range(BACKGROUND_THREADS):
            for i, want in enumerate(alone):
                if not same(results[w][i], want):
                    fail(f"service: background request {w}/{i} differs "
                         f"from the same request served alone")

        # 5. EXPLAIN ANALYZE of query (a): per-operator times
        ex = svc.explain(QUERIES["a"], analyze=True)
        emit({"phase": "service", "step": "explain_analyze", "query": "a",
              "total_ms": ex.total_s * 1e3,
              "operators_ms": ex.measured_s * 1e3,
              "operators": [{"op": n.op, "ms": ex.samples[nid][0] * 1e3,
                             "rows": ex.samples[nid][1]}
                            for nid, n in ex.operators()
                            if nid in ex.samples]})
    finally:
        svc.close()
    launched = tg_ops.launches - launches0
    emit({"phase": "service", "step": "done", "tree_gemm_launches": launched,
          "seconds": time.perf_counter() - t0})
    return launched


# -- phase 6b: the partition-parallel tier -----------------------------------

SHARD_PARTITIONS = 16              # 1M rows -> 16 partitions of 62,500
SHARD_MISALIGN = 31_250            # blood_x's bounds: half a partition off
SHARD_PRUNE_PID = 250_000          # query (p) keeps partitions 0-3
SHARD_AVG_RTOL = 1e-4              # (c)'s AVG: partial sums reassociate
# query -> (SQL, sharded mode, expected morsels or buckets a run)
SHARD_QUERIES = {
    "a": (QUERIES["a"], "partition_wise", SHARD_PARTITIONS),
    "c": (QUERIES["c"], "two_phase", SHARD_PARTITIONS),
    "x": (QUERIES["a"].replace("blood_tests", "blood_x"), "exchange",
          SHARD_PARTITIONS),
    "p": (QUERIES["a"] + f" WHERE pid < {SHARD_PRUNE_PID}",
          "partition_wise", SHARD_PARTITIONS // 4),
}


def shard_units(trace) -> list:
    """The morsels and exchange buckets one served query ran: its
    ``shard_wave`` / ``exchange_bucket`` spans (one a unit, timed on the
    device's worker)."""
    return [s for s in trace.spans()
            if s.name in ("shard_wave", "exchange_bucket")]


def same_rows(a, b, mask: bool = True) -> bool:
    """Equal values on the valid rows, in order (a masked row's other
    columns are not part of the answer), and — with ``mask`` — equal
    validity masks.  A pruned sharded serve places only the surviving
    partitions' rows, so its mask is shorter: compare it without."""
    import numpy as np
    ma, mb = a["valid"], b["valid"]
    if mask and not np.array_equal(ma, mb):
        return False
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype
        and np.array_equal(a[k][ma], b[k][mb], equal_nan=True) for k in a)


def same_two_phase(a, b) -> tuple:
    """(c): group keys, validity and dtypes equal; the AVG column within
    ``SHARD_AVG_RTOL`` (the per-morsel partial sums fold in partition
    order, so the float32 sum is associated differently from one
    whole-table pass).  Returns (ok, bitwise, max relative difference)."""
    import numpy as np
    m = a["valid"]
    ok = (a.keys() == b.keys() and np.array_equal(m, b["valid"])
          and all(a[k].dtype == b[k].dtype for k in a)
          and np.array_equal(a["gender"][m], b["gender"][m]))
    rel = float(np.max(np.abs(a["p"][m] - b["p"][m])
                       / np.maximum(np.abs(b["p"][m]), 1e-30),
                       initial=0.0))
    return ok and rel <= SHARD_AVG_RTOL, same_rows(a, b), rel


def phase_sharded(tables, pipe):
    """The partition-parallel tier: a second store on the card with
    ``patient_info`` and ``blood_tests`` range-partitioned on pid at the
    same 16 bounds (and ``blood_x``, a copy of ``blood_tests`` on bounds
    half a partition off), served by ``PredictionService(store,
    execution_config=ExecutionConfig(sharded=True))`` under the default
    optimizer config: (a) partition-wise, (c) two-phase, (a) over
    ``blood_x`` through the hash exchange (cost gate off, the tests'
    idiom), and (a) pruned by zone maps to a quarter of the partitions.
    Each cold, then warm twice, beside the whole-table service on the same
    store.  Returns the tree_gemm launches it made."""
    import statistics as stats_

    import torch

    from repro_torch.core import ExecutionConfig, ModelStore, codegen
    from repro_torch.kernels.tree_gemm import ops as tg_ops
    from repro_torch.serve import PredictionService, plan_morsels
    launches0 = tg_ops.launches
    t0 = time.perf_counter()
    store = ModelStore(device="cuda")
    n_rows = tables["patient_info"].capacity
    bounds = [n_rows * i // SHARD_PARTITIONS
              for i in range(1, SHARD_PARTITIONS)]
    for name in ("patient_info", "blood_tests"):
        store.register_table(name, tables[name], partition_by="pid",
                             partition_bounds=bounds)
    store.register_table("blood_x", tables["blood_tests"],
                         partition_by="pid",
                         partition_bounds=[b + SHARD_MISALIGN
                                           for b in bounds])
    store.register_model("rf", pipe)
    parts = store.get_partitioned("patient_info").partitions
    cfg = ExecutionConfig(sharded=True)
    placement = plan_morsels([(p.index, p.n_rows) for p in parts], 1,
                             cfg.shard_min_bucket_rows,
                             cfg.shard_morsel_rows)
    emit({"phase": "sharded", "step": "register", "rows": n_rows,
          "partitions": len(parts),
          "partition_rows": sorted({p.n_rows for p in parts}),
          "morsels": placement.n_morsels, "waves": placement.n_waves,
          "bucket_rows": placement.bucket_rows,
          "devices": torch.cuda.device_count(),
          "seconds": time.perf_counter() - t0})

    def stats(svc):
        return dict(vars(svc.stats))

    whole = PredictionService(store)
    svc = PredictionService(store, execution_config=cfg)
    xsvc = PredictionService(store, execution_config=ExecutionConfig(
        sharded=True, shard_exchange_cost_gate=False))
    try:
        ms = {q: {"whole": [], "sharded": []} for q in SHARD_QUERIES}
        units = {}
        want = {}
        for r in range(3):
            if r == 2:
                c2 = codegen.compile_stats["plans_compiled"]
                before2 = {id(s): (s.stats.shard_compiles,
                                   s.stats.jit_traces) for s in (svc, xsvc)}
            for q, (sql, mode, n_units) in SHARD_QUERIES.items():
                ssvc = xsvc if mode == "exchange" else svc
                # the whole-table answer first: it also pays the "auto"
                # calibration of the model on this store, once
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = whole.sql(sql)            # served results are ready
                ms[q]["whole"].append((time.perf_counter() - t) * 1e3)
                want.setdefault(q, host(out))
                s0, l0 = stats(ssvc), tg_ops.launches
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = ssvc.sql(sql)
                ms[q]["sharded"].append((time.perf_counter() - t) * 1e3)
                got = host(out)
                launched = tg_ops.launches - l0
                d = {k: v - s0[k] for k, v in stats(ssvc).items()}
                trace = ssvc.traces(1)[0]
                ran = shard_units(trace)
                units[q] = (trace, ran)
                if mode == "two_phase":
                    ok, bitwise, rel = same_two_phase(got, want[q])
                else:
                    ok = same_rows(got, want[q], mask=q != "p")
                    bitwise, rel = None, 0.0
                if not ok:
                    fail(f"sharded: query ({q}), round {r}, differs from "
                         f"the whole-table service's answer (max relative "
                         f"difference {rel})")
                if launched != len(ran) or len(ran) != n_units:
                    fail(f"sharded: query ({q}), round {r}: {launched} "
                         f"tree_gemm launches, {len(ran)} morsels or "
                         f"buckets run, expected {n_units}")
                rise = {"sharded_executions": 1, "shard_join_executions": 1,
                        "exchange_executions": int(mode == "exchange"),
                        "shard_agg_combines": int(mode == "two_phase"),
                        "shard_partial_aggs":
                            n_units if mode == "two_phase" else 0,
                        "partitions_pruned":
                            SHARD_PARTITIONS - n_units
                            if mode != "exchange" else 0}
                wrong = {k: d[k] for k, v in rise.items() if d[k] != v}
                if wrong:
                    fail(f"sharded: query ({q}), round {r}: counters "
                         f"{wrong}, expected {rise}")
                if mode == "exchange" and d["exchange_bytes_moved"] <= 0:
                    fail("sharded: the exchange moved no bytes")
                if r == 0:
                    emit({"phase": "sharded", "step": "first_serve",
                          "query": q, "mode": mode, "bitwise": bitwise,
                          "max_rel_diff": rel,
                          "stats": {k: v for k, v in d.items() if v}})
        compiles2 = codegen.compile_stats["plans_compiled"] - c2
        built2 = sum(s.stats.shard_compiles - before2[id(s)][0]
                     for s in (svc, xsvc))
        traces2 = sum(s.stats.jit_traces - before2[id(s)][1]
                      for s in (svc, xsvc))
        for q, (sql, mode, n_units) in SHARD_QUERIES.items():
            trace, ran = units[q]
            build = trace.find("exchange_build")
            span_ms = [s.duration * 1e3 for s in ran]
            emit({"phase": "sharded", "step": "query", "query": q,
                  "mode": mode, "sql": sql,
                  "whole_cold_ms": ms[q]["whole"][0],
                  "whole_warm_ms": ms[q]["whole"][1:],
                  "sharded_cold_ms": ms[q]["sharded"][0],
                  "sharded_warm_ms": ms[q]["sharded"][1:],
                  "units": len(ran),
                  "unit_rows": sorted({s.attrs["rows"] for s in ran}),
                  "unit_ms": {"min": min(span_ms),
                              "median": stats_.median(span_ms),
                              "max": max(span_ms), "sum": sum(span_ms)},
                  "exchange_build_ms": build.duration * 1e3
                  if build is not None else None,
                  "exchange_placement": {k: v for k, v in build.attrs.items()
                                         if k != "on"}
                  if build is not None else None})
        emit({"phase": "sharded", "step": "second_warm_round",
              "plans_compiled": compiles2, "shard_compiles": built2,
              "jit_traces": traces2,
              "exchange_bytes_moved": xsvc.stats.exchange_bytes_moved,
              "shard_info": svc.shard_info(),
              "exchange_shard_info": xsvc.shard_info()})
        if compiles2 or built2 or traces2:
            fail(f"sharded: the second warm round compiled {compiles2} "
                 f"plans, built {built2} shard executables and traced "
                 f"{traces2} signatures")
        # with the cost gate on, one device never pays for the shuffle
        f0 = svc.stats.exchange_fallbacks
        if not same_rows(host(svc.sql(SHARD_QUERIES["x"][0])), want["x"]) \
                or svc.stats.exchange_fallbacks != f0 + 1:
            fail("sharded: the gated exchange did not fall back to the "
                 "whole-table answer")
    finally:
        for s in (whole, svc, xsvc):
            s.close()
    del store
    torch.cuda.empty_cache()
    launched = tg_ops.launches - launches0
    emit({"phase": "sharded", "step": "done", "tree_gemm_launches": launched,
          "seconds": time.perf_counter() - t0})
    return launched

# -- phase 6c ------------------------------------------------------------------

FLIGHT_ROWS = 700_000              # Fig 2a/2b: the paper's 700K flight tuples
FIG2A_L1 = (0.002, 0.01, 0.05)     # benchmarks/fig2a's sweep
FIG2B_L1 = 0.003
FIG2B_SAMPLE = 20_000              # k-means sample: the first 20,000 rows
FIG2B_KS = (2, 4, 8, 16)
FIG2B_COLUMNS = ["origin", "dest", "carrier"]
FIG2B_AGREE = 0.999                # routed vs full labels (the JAX tests')
FIG3_FIT_ROWS = 100_000            # benchmarks/fig3's largest size
FIG3_CPU_PIDS = 65_536             # the CPU's run of the served query
FIT_ATOL = 1e-5                    # card vs CPU: linear weights and bias
MLP_RTOL, MLP_ATOL = 1e-5, 1e-6    # card vs CPU: MLP parameters
FIG2A_SQL = "SELECT dep_hour, PREDICT_PROBA(MODEL='delay') AS p FROM flights"
CARD = "cuda"                      # where phase fits' card work runs
FIG3_SQL = ("SELECT pid, PREDICT(MODEL='los_mlp') AS cls "
            "FROM patient_info JOIN blood_tests ON pid")


def flights_pipeline(l1):
    """benchmarks/common.py's ``flights_lr_pipeline``, in the port: one-hot
    origin/dest/carrier/dow, the scaler, L1 logistic regression."""
    from repro_torch.ml import (LogisticRegression, OneHotEncoder, Pipeline,
                                PipelineMetadata, StandardScaler)
    return Pipeline([OneHotEncoder(["origin", "dest", "carrier", "dow"]),
                     StandardScaler(["distance", "taxi_out", "dep_hour"])],
                    LogisticRegression(l1=l1, steps=300),
                    PipelineMetadata(name="delay", task="classification"))


def timed_fit(make, data, y, device):
    """Fit a fresh pipeline; (pipeline, ms).  The fit ends by copying the
    weights to the host, so the host clock spans the device's work."""
    t = time.perf_counter()
    pipe = make().fit(data, y, device=device)
    return pipe, (time.perf_counter() - t) * 1e3


def host_ms(fn, runs=3):
    """Median host-clock ms of ``fn``, the card synchronized around each."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def phase_fits(tables):
    """The port fits its own models and clusters them, at the paper's
    sizes: Fig 2a (L1 logistic fits on 700K flights, served with and
    without projection pushdown), Fig 2b (k-means clustered models routed
    over all 700K rows) and Fig 3 (an MLP fitted on 100,000 patients and
    served through ``PredictionService`` at 1,000,000).  -> the
    featurized_linear launches of the Fig 2a queries, by plan: exactly one
    an execution, with the timing loops left out."""
    import numpy as np
    import torch

    from repro_torch.core import (CrossOptimizer, ModelStore,
                                  OptimizerConfig, codegen, compile_plan,
                                  parse_query)
    from repro_torch.core.clustering import build_clustered_model
    from repro_torch.data import flight_features
    from repro_torch.kernels.featurized_linear import ops as fl_ops
    from repro_torch.ml import MLP, Pipeline, PipelineMetadata, StandardScaler
    from repro_torch.ml.convert import pipeline_from_state, pipeline_state
    from repro_torch.relational import Table
    from repro_torch.relational.table import to_numpy
    from repro_torch.serve import PredictionService
    t0 = time.perf_counter()
    fl_launches = {"fig2a_base": 0, "fig2a_pushdown": 0}
    fcols, fy = flight_features(FLIGHT_ROWS)
    flights = Table.from_pydict({**fcols, "delayed": fy})

    # (i) Fig 2a: fits, then the query with and without pushdown
    for l1 in FIG2A_L1:
        make = functools.partial(flights_pipeline, l1)
        (pipe, card_ms), (again, _) = (timed_fit(make, fcols, fy, CARD)
                                       for _ in range(2))
        m, m2 = pipe.model, again.model
        if not (np.array_equal(m.weights, m2.weights) and m.bias == m2.bias):
            fail(f"fits: Fig 2a l1={l1}: two fits on the card differ")
        cpu, cpu_ms = timed_fit(make, fcols, fy, "cpu")
        w_err = float(np.max(np.abs(m.weights - cpu.model.weights)))
        b_err = abs(m.bias - cpu.model.bias)
        only_one = sorted(set(m.zero_weight_features().tolist())
                          ^ set(cpu.model.zero_weight_features().tolist()))
        if w_err > FIT_ATOL or b_err > FIT_ATOL or any(
                abs(m.weights[i]) >= FIT_ATOL
                or abs(cpu.model.weights[i]) >= FIT_ATOL for i in only_one):
            fail(f"fits: Fig 2a l1={l1}: card vs CPU fit: weights {w_err}, "
                 f"bias {b_err}, zero in one only {only_one}")
        store = ModelStore(device=CARD)
        store.register_table("flights", flights)
        store.register_model("delay", pipe)
        plan = parse_query(FIG2A_SQL, store)
        base, _ = CrossOptimizer(store, OptimizerConfig(
            enable_projection_pushdown=False)).optimize(plan)
        opt, rep = CrossOptimizer(store, OptimizerConfig()).optimize(plan)
        tabs = {"flights": store.get_table("flights")}
        f0, f1 = compile_plan(base, store), compile_plan(opt, store)
        outs = []
        for path, fn in (("fig2a_base", f0), ("fig2a_pushdown", f1)):
            fl_ops.launches = 0         # counts from here on are the path's
            outs.append(host(fn(tabs)))
            if fl_ops.launches != 1:
                fail(f"fits: Fig 2a l1={l1}: {path} launched "
                     f"featurized_linear {fl_ops.launches} times, not once")
            fl_launches[path] += fl_ops.launches
        out0, out1 = outs
        if not same(out0, out1):
            fail(f"fits: Fig 2a l1={l1}: pushdown changed the answer")
        if not np.isfinite(out0["p"]).all():
            fail(f"fits: Fig 2a l1={l1}: probabilities not finite")
        emit({"phase": "fits", "figure": "2a", "l1": l1, "rows": FLIGHT_ROWS,
              "features": int(m.weights.shape[0]),
              "sparsity": m.sparsity(),
              "fit_ms": card_ms, "cpu_fit_ms": cpu_ms,
              "card_fits_bitwise": True, "max_abs_err_weights": w_err,
              "abs_err_bias": b_err, "zero_in_one_only": len(only_one),
              "pushdown": next((d for r, d in rep.entries
                                if r == "projection_pushdown"), "no-op"),
              "base_query_ms": host_ms(lambda: f0(tabs)),
              "pushdown_query_ms": host_ms(lambda: f1(tabs)),
              "bitwise_equal": True})
        del store, base, opt, f0, f1

    # (ii) Fig 2b: clustered models over all 700K rows
    pipe, fit_ms = timed_fit(functools.partial(flights_pipeline, FIG2B_L1),
                             fcols, fy, CARD)
    cols = {k: torch.as_tensor(v, device=CARD) for k, v in fcols.items()}
    cpu_cols = {k: torch.from_numpy(v) for k, v in fcols.items()}
    full = pipe.predict(cols).to(torch.float32)
    full_ms = host_ms(lambda: pipe.predict(cols))
    sample = {k: v[:FIG2B_SAMPLE] for k, v in fcols.items()}
    store = ModelStore(device=CARD)
    for k in FIG2B_KS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        cm = build_clustered_model(pipe, sample, k=k,
                                   cluster_columns=FIG2B_COLUMNS,
                                   device=CARD)
        build_s = time.perf_counter() - t
        assign = cm.assign(cols)
        routed = cm.predict_routed(cols, assign)
        agree = float((routed == full).to(torch.float32).mean())
        if agree < FIG2B_AGREE:
            fail(f"fits: Fig 2b k={k}: routed labels agree with the full "
                 f"model on {agree} of the rows, under {FIG2B_AGREE}")
        cpu_assign = cm.assign(cpu_cols)
        if not (torch.equal(cpu_assign, assign.cpu()) and torch.equal(
                cm.predict_routed(cpu_cols, cpu_assign), routed.cpu())):
            fail(f"fits: Fig 2b k={k}: the CPU's routed labels differ")
        store.register_clustered(f"delay_k{k}", cm)
        if store.get_clustered(f"delay_k{k}") is not cm:
            fail(f"fits: Fig 2b k={k}: register_clustered round trip")
        cost = cm.model_cost()
        emit({"phase": "fits", "figure": "2b", "k": k, "rows": FLIGHT_ROWS,
              "sample_rows": FIG2B_SAMPLE, "fit_ms": fit_ms,
              "build_s": build_s,
              "cluster_rows": torch.bincount(assign, minlength=k).tolist(),
              "original_features": cost["original_features"],
              "mean_cluster_features": cost["mean_cluster_features"],
              "cluster_features": [e.n_features for e in cm.entries],
              "agree": agree, "cpu_bitwise": True,
              "routed_ms": host_ms(lambda: cm.predict_routed(cols, assign)),
              "full_ms": full_ms})
    del cols, cpu_cols, store

    # (iii) Fig 3: the MLP pipeline, fitted on 100,000 patients, served
    data = {c: to_numpy(t.column(c)) for t in tables.values()
            for c in t.names}
    fit_data = {c: data[c][:FIG3_FIT_ROWS] for c in FEATURES}
    label = (data["length_of_stay"][:FIG3_FIT_ROWS] > 7.0).astype(np.int32)

    def make():
        return Pipeline([StandardScaler(FEATURES)],
                        MLP(hidden=(64, 32), n_outputs=2, steps=60),
                        PipelineMetadata(name="los_mlp",
                                         task="classification"))
    (pipe, card_ms), (again, _) = (timed_fit(make, fit_data, label, CARD)
                                   for _ in range(2))
    cpu, cpu_ms = timed_fit(make, fit_data, label, "cpu")
    err = 0.0
    for p, p2, pc in zip(pipe.model.params, again.model.params,
                         cpu.model.params):
        for k in ("w", "b"):
            if not np.array_equal(p[k], p2[k]):
                fail("fits: Fig 3: two MLP fits on the card differ")
            if not np.allclose(p[k], pc[k], rtol=MLP_RTOL, atol=MLP_ATOL):
                fail(f"fits: Fig 3: card vs CPU MLP {k} beyond rtol "
                     f"{MLP_RTOL} / atol {MLP_ATOL}")
            err = max(err, float(np.max(np.abs(p[k] - pc[k]))))
    store = ModelStore(device=CARD)
    for name in ("patient_info", "blood_tests"):
        store.register_table(name, tables[name])
    store.register_model("los_mlp", pipe)
    svc = PredictionService(store)
    try:
        ms, outs = [], []
        for r in range(3):
            if r == 2:
                c2 = codegen.compile_stats["plans_compiled"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(host(svc.sql(FIG3_SQL)))
            ms.append((time.perf_counter() - t) * 1e3)
        compiles2 = codegen.compile_stats["plans_compiled"] - c2
    finally:
        svc.close()
    if not (same(outs[0], outs[1]) and same(outs[0], outs[2])):
        fail("fits: Fig 3: cold and warm answers differ")
    if compiles2:
        fail(f"fits: Fig 3: the second warm round compiled {compiles2} plans")
    cpu_store = ModelStore(device="cpu")
    for name in ("patient_info", "blood_tests"):
        cpu_store.register_table(name, rows_of(tables[name], 0,
                                               FIG3_CPU_PIDS))
    cpu_store.register_model("los_mlp",
                             pipeline_from_state(pipeline_state(pipe)))
    cpu_svc = PredictionService(cpu_store)
    try:
        want = host(cpu_svc.sql(FIG3_SQL))
    finally:
        cpu_svc.close()

    def first_pids(h):
        keep = h["valid"] & (h["pid"] < FIG3_CPU_PIDS)
        order = np.argsort(h["pid"][keep], kind="stable")
        return {k: h[k][keep][order] for k in ("pid", "cls")}
    got, want = first_pids(outs[0]), first_pids(want)
    if len(want["pid"]) != FIG3_CPU_PIDS or not same(got, want):
        fail("fits: Fig 3: the card's answer differs from the CPU's on "
             f"the first {FIG3_CPU_PIDS} pids")
    emit({"phase": "fits", "figure": "3", "rows": N_ROWS,
          "fit_rows": FIG3_FIT_ROWS, "fit_ms": card_ms, "cpu_fit_ms": cpu_ms,
          "card_fits_bitwise": True, "max_abs_err_params": err,
          "class_1_share": float(outs[0]["cls"][outs[0]["valid"]].mean()),
          "cold_ms": ms[0], "warm_ms": ms[1:],
          "second_warm_round_plans_compiled": compiles2,
          "cpu_pids_bitwise": FIG3_CPU_PIDS})
    del store
    torch.cuda.empty_cache()
    emit({"phase": "fits", "step": "done",
          "seconds": time.perf_counter() - t0})
    return fl_launches

# -- phase 3, attention ------------------------------------------------------

FLASH_SHAPES = [  # (b, s, t, h, kv, d): groups 1, 2, 4, 5; S, T off the tile
    (2, 193, 193, 4, 4, 64),
    (1, 130, 130, 8, 4, 128),
    (2, 77, 77, 8, 2, 256),
    (1, 100, 300, 4, 1, 128),
    (1, 150, 150, 25, 5, 64),    # Hymba's 25 query heads over 5 KV heads
    (3, 70, 129, 10, 2, 64),     # B > 1 with S != T, both off the tile
]
FLASH_MASKS = [("causal", True, 0, 0.0), ("window64", True, 64, 0.0),
               ("softcap30", True, 0, 30.0), ("bidir", False, 0, 0.0)]
DECODE_SHAPES = [  # (b, t, h, kv, d): groups 1, 4, 2, 2, 5
    (4, 1024, 36, 36, 64), (3, 777, 8, 2, 128), (2, 300, 8, 4, 256),
    (3, 129, 8, 4, 64), (2, 50, 40, 8, 128),
]
# (name, (b, t, h, kv, d), lengths from (t, split_len), or None for random
# ones from 1 with the first row at 1): Hymba's ring and global caches,
# lengths on and either side of split boundaries with later splits empty,
# a row of cache_len 0, and G = 12 (two tiles of query heads).
DECODE_CASES = [
    ("hymba_ring", (4, 1024, 25, 5, 64), None),
    ("hymba_global", (4, 2048, 25, 5, 64), None),
    ("split_edges", (4, 1024, 25, 5, 64),
     lambda t, sl: [sl, sl + 1, sl - 1, 3 * sl]),
    ("split_edges_mha", (4, 1024, 36, 36, 64),
     lambda t, sl: [sl - 1, sl, sl + 1, t]),
    ("len0", (3, 300, 8, 2, 128), lambda t, sl: [0, 1, t]),
    ("g12", (2, 400, 24, 2, 64), None),
]
# The decode shapes of the LM paths, bfloat16, at the cache lengths halfway
# through the decode of four prompts (n + LM_NEW_TOKENS // 2), and the
# attention soft cap: MiniCPM-2B (36 heads of 64 over a cache of max_len
# 1024) on its first four prompts; Hymba-1.5B (25 query and 5 KV heads of
# 64) on 517, 699, 1010 and 1300, over its local layers' ring of 1024 slots
# (lengths clamped to it) and its global layers' cache of max_len 2048;
# Gemma-2 2B (8 query and 4 KV heads of 256, soft cap 50) on 699, 2048,
# 4080 and 5000, over its local layers' ring of 4096 slots and its global
# layers' cache of max_len 8192.
_HALF = LM_NEW_TOKENS // 2
GEMMA2_SOFTCAP = 50.0
DECODE_PATH_SHAPES = {
    "lm": (LM_SLOTS, 1024, 36, 36, 64,
           [n + _HALF for n in LM_PROMPT_LENS[:4]], 0.0),
    "lm_hymba_local": (LM_SLOTS, 1024, 25, 5, 64,
                       [min(n + _HALF, 1024) for n in HYMBA_PROMPT_LENS[2:]],
                       0.0),
    "lm_hymba_global": (LM_SLOTS, 2048, 25, 5, 64,
                        [n + _HALF for n in HYMBA_PROMPT_LENS[2:]], 0.0),
    "lm_gemma2_local": (LM_SLOTS, 4096, 8, 4, 256,
                        [min(n + _HALF, 4096) for n in GEMMA2_PROMPT_LENS[1:]],
                        GEMMA2_SOFTCAP),
    "lm_gemma2_global": (LM_SLOTS, 8192, 8, 4, 256,
                         [n + _HALF for n in GEMMA2_PROMPT_LENS[1:]],
                         GEMMA2_SOFTCAP),
}
# The prefill shapes the flash kernel is timed at: MiniCPM-2B's longest
# prompt (B 1, S = T = 699, 36 heads of 64, causal) and Gemma-2 2B's (S = T
# = 5000, 8 query and 4 KV heads of 256, soft cap 50) on a local layer
# (window 4096) and a global one: (b, s, h, kv, d, window, softcap).
FLASH_PATH_SHAPES = {
    "lm": (1, max(LM_PROMPT_LENS), 36, 36, 64, 0, 0.0),
    "lm_gemma2_local": (1, max(GEMMA2_PROMPT_LENS), 8, 4, 256, 4096,
                        GEMMA2_SOFTCAP),
    "lm_gemma2_global": (1, max(GEMMA2_PROMPT_LENS), 8, 4, 256, 0,
                         GEMMA2_SOFTCAP),
}
# A cold L2: the timed launches rotate over copies of the caches whose
# touched bytes add up to at least twice the card's 50 MB L2, as in a
# decode step, where no layer's cache is still in L2.
COLD_BYTES = 100e6


def flash_bound_ms(b, s, t, h, kv, d, causal, itemsize, peak_flops,
                   window=0):
    """Least time: q, k, v read once and out written once over HBM
    bandwidth, or 4*d flops per visible (query, key) pair (the last
    ``window`` keys, where > 0) over the peak for the inputs' type,
    whichever is larger."""
    span = window if window > 0 else t
    pairs = sum(min(i + 1, span, t) for i in range(s)) if causal else s * t
    flops = 4.0 * d * pairs * b * h
    nbytes = itemsize * (2 * b * s * h * d + 2 * b * t * kv * d)
    by_ops, by_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def decode_bound_ms(lens, h, kv, d, itemsize, peak_flops):
    """Least time: the valid cache rows of k and v, q, cache_len and out
    moved once, or 4*d flops per (valid slot, query head)."""
    b, valid = len(lens), sum(lens)
    flops = 4.0 * d * valid * h
    nbytes = itemsize * (2 * valid * kv * d + 2 * b * h * d) + 4 * b
    by_ops, by_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def phase_attention_kernels():
    """flash_attention and decode_attention against their plain versions on
    the card over every option, then timed at the LM paths' shapes: a
    prefill at each of ``FLASH_PATH_SHAPES`` (MiniCPM-2B's longest prompt,
    Gemma-2 2B's on a local and a global layer) and a decode step at each
    of ``DECODE_PATH_SHAPES`` with a cold L2; decode_attention captured in
    a CUDA graph must replay bitwise equal to an eager call."""
    import torch

    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for (b, s, t, h, kv, d) in FLASH_SHAPES:
            q, k, v = (randn((b, s, h, d), dtype), randn((b, t, kv, d), dtype),
                       randn((b, t, kv, d), dtype))
            for mname, causal, window, cap in FLASH_MASKS:
                got = f_ops.flash_attention(q, k, v, causal, window, cap)
                want = attention_ref(q, k, v, causal, window, cap)
                torch.cuda.synchronize()
                if got.dtype != dtype or not torch.isfinite(got).all():
                    fail(f"flash_attention {dname} {mname}: output "
                         f"{got.dtype} not finite")
                err = float((got.float() - want.float()).abs().max())
                emit({"phase": "kernels", "kernel": "flash_attention",
                      "dtype": dname, "mask": mname, "groups": h // kv,
                      "shape": {"q": [b, s, h, d], "kv": [b, t, kv, d]},
                      "max_abs_err": err, "tol": ATT_TOL[dname]})
                if err > ATT_TOL[dname]:
                    fail(f"flash_attention {dname} {mname} {(b, s, t, h, kv, d)}"
                         f" differs from its plain version by {err}")
                worst["flash_attention"] = max(worst["flash_attention"], err)
        from repro_torch.kernels.decode_attention.decode_attention import \
            split_layout
        cases = [("random", shape, None) for shape in DECODE_SHAPES] \
            + DECODE_CASES
        for name, (b, t, h, kv, d), lens_of in cases:
            q, k, v = (randn((b, 1, h, d), dtype), randn((b, t, kv, d), dtype),
                       randn((b, t, kv, d), dtype))
            if lens_of is None:
                lens = torch.randint(1, t + 1, (b,), generator=gen,
                                     device=dev, dtype=torch.int32)
                lens[0] = 1
            else:
                split_len = split_layout(t)[1]
                lens = torch.tensor(lens_of(t, split_len), dtype=torch.int32,
                                    device=dev)
            for cap in (0.0, 30.0):
                got = d_ops.decode_attention(q, k, v, lens, cap)
                want = decode_attention_ref(q, k, v, lens, cap)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"decode_attention {dname} {name}: output not "
                         f"finite")
                err = float((got.float() - want.float()).abs().max())
                emit({"phase": "kernels", "kernel": "decode_attention",
                      "case": name, "dtype": dname, "softcap": cap,
                      "groups": h // kv,
                      "shape": {"q": [b, 1, h, d], "cache": [b, t, kv, d]},
                      "cache_len": lens.tolist(), "max_abs_err": err,
                      "tol": ATT_TOL[dname]})
                if err > ATT_TOL[dname]:
                    fail(f"decode_attention {dname} {name} "
                         f"{(b, t, h, kv, d)} softcap {cap} differs from "
                         f"its plain version by {err}")
                worst["decode_attention"] = max(worst["decode_attention"],
                                                err)

    frows = {name: flash_timing_row(f_ops, name, gen)
             for name in FLASH_PATH_SHAPES}
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:113",
        "max_abs_err": max([worst["flash_attention"]]
                           + [r["max_abs_err"] for r in frows.values()]),
        # the headline numbers are MiniCPM-2B's; every path shape's row
        # is in by_shape
        **{k: frows["lm"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")},
        "by_shape": frows}

    check_decode_graph(gen)
    rows = {name: decode_cold_row(d_ops, name, gen)
            for name in DECODE_PATH_SHAPES}
    decode_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces":
            "src/repro/kernels/decode_attention/decode_attention.py:91",
        "max_abs_err": max([worst["decode_attention"]]
                           + [r["max_abs_err"] for r in rows.values()]),
        # the headline numbers are MiniCPM-2B's; every path shape's row
        # is in by_shape
        **{k: rows["lm"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")},
        "by_shape": rows}
    return flash_row, decode_row


def flash_timing_row(f_ops, name, gen) -> dict:
    """``f_ops.flash_attention`` at the prefill shape ``name`` of
    ``FLASH_PATH_SHAPES`` (bfloat16, causal) against its plain version,
    then timed: ``device_ms`` is the profiler's device time of the bound C
    entry point over 50 launches (q, k, v and out stay warm in L2: 12.9 MB
    for MiniCPM-2B, 30.7 MB for Gemma-2 2B), ``library_device_ms`` SDPA's
    on [B,H,S,D] copies, causal or with the window as a boolean mask.  SDPA
    has no soft cap: on Gemma-2's shapes it computes the function without
    it, a yardstick and not the same function."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    b, s, h, kv, d, window, cap = FLASH_PATH_SHAPES[name]
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).to(bf16)
            for _ in range(2))
    err = float((f_ops.flash_attention(q, k, v, True, window, cap).float()
                 - attention_ref(q, k, v, True, window, cap).float())
                .abs().max())
    if err > ATT_TOL["bfloat16"]:
        fail(f"flash_attention at the {name} shape differs by {err}")
    bound, by = flash_bound_ms(b, s, s, h, kv, d, True, 2, PEAK_BF16_FLOPS,
                               window)
    out = torch.empty_like(q)
    dev_ms = device_ms(
        lambda: flash_attention_cuda(q, k, v, out, True, window, cap))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window > 0:
        diff = torch.arange(s, device=dev)[:, None] \
            - torch.arange(s, device=dev)[None, :]
        mask = (diff >= 0) & (diff < window)

        def sdpa():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True)
    else:
        def sdpa():
            return F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)
    row = {"shape": name, "q": [b, s, h, d], "kv": [b, s, kv, d],
           "window": window, "softcap": cap, "dtype": "bfloat16",
           "max_abs_err": err, "device_ms": dev_ms,
           "ms": cuda_ms(lambda: f_ops.flash_attention(q, k, v, True, window,
                                                       cap), runs=20),
           "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, True, window,
                                                     cap)),
           "bound_ms": bound, "bound_by": by,
           "library_ms": cuda_ms(sdpa, runs=20),
           "library_device_ms": device_ms(sdpa),
           "library_softcap": cap == 0}
    emit({"phase": "kernels", "kernel": "flash_attention", "timing": row})
    return row


def _rotate(calls):
    """One callable that runs ``calls`` in turn, one a call."""
    turn = itertools.cycle(calls)
    return lambda: next(turn)()


def decode_cold_row(d_ops, name, gen) -> dict:
    """``d_ops.decode_attention`` at the LM path shape ``name`` of
    ``DECODE_PATH_SHAPES`` against its plain version, then timed with a
    cold L2: ``device_ms`` (and ``device_ms_by_pass``) is the profiler's
    device time of DEVICE_RUNS wrapper calls, / DEVICE_RUNS, rotating over
    enough copies of the caches that the slots they read add up to
    COLD_BYTES; ``library_device_ms`` is masked SDPA over [B,H,T,D] copies
    of the same caches, rotated alike (SDPA has no soft cap: at Gemma-2's
    shapes it computes the function without it).  ``ms`` (one wrapper
    call, host time included), ``plain_ms`` and ``library_ms`` are warm."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    b, t, h, kv, d, lens, cap = DECODE_PATH_SHAPES[name]

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    touched = 2.0 * 2 * sum(lens) * kv * d         # k and v rows, bf16
    copies = max(2, math.ceil(COLD_BYTES / touched))
    q = randn((b, 1, h, d))
    caches = [(randn((b, t, kv, d)), randn((b, t, kv, d)))
              for _ in range(copies)]
    cache_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    kc, vc = caches[0]
    err = float((d_ops.decode_attention(q, kc, vc, cache_len, cap).float()
                 - decode_attention_ref(q, kc, vc, cache_len, cap).float())
                .abs().max())
    if err > ATT_TOL["bfloat16"]:
        fail(f"decode_attention at the {name} shape differs by {err}")
    passes = {}
    dev_ms = device_ms(_rotate([
        lambda kc=kc, vc=vc: d_ops.decode_attention(q, kc, vc, cache_len,
                                                    cap)
        for kc, vc in caches]), by_kernel=passes)
    ms = cuda_ms(lambda: d_ops.decode_attention(q, kc, vc, cache_len, cap),
                 runs=20)
    plain_ms = cuda_ms(lambda: decode_attention_ref(q, kc, vc, cache_len,
                                                    cap))

    qh = q.transpose(1, 2).contiguous()
    mask = (torch.arange(t, device=dev)[None, :]
            < cache_len[:, None])[:, None, None, :]
    heads = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
             for k, v in caches]
    del caches, kc, vc

    def sdpa(kh, vh):
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              enable_gqa=True)
    lib_dev = device_ms(_rotate([lambda kh=kh, vh=vh: sdpa(kh, vh)
                                 for kh, vh in heads]))
    bound, by = decode_bound_ms(lens, h, kv, d, 2, PEAK_BF16_FLOPS)
    row = {"shape": name, "q": [b, 1, h, d], "cache": [b, t, kv, d],
           "cache_len": list(lens), "softcap": cap, "dtype": "bfloat16",
           "max_abs_err": err,
           "device_ms": dev_ms, "device_ms_by_pass": passes, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_device_ms": lib_dev,
           "library_ms": cuda_ms(lambda: sdpa(*heads[0]), runs=20),
           "cold_copies": copies, "touched_bytes": touched}
    emit({"phase": "kernels", "kernel": "decode_attention", "timing": row})
    return row


def check_decode_graph(gen) -> None:
    """One decode_attention call at Hymba's ring shape captured in a CUDA
    graph; the lengths (one of them 0), k and v then change in place, and
    the replay must equal an eager call on the same inputs bitwise."""
    import torch

    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    b, t, h, kv, d, lens, _ = DECODE_PATH_SHAPES["lm_hymba_local"]

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v = randn((b, 1, h, d)), randn((b, t, kv, d)), randn((b, t, kv, d))
    cache_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up outside the capture
        d_ops.decode_attention(q, k, v, cache_len)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = d_ops.decode_attention(q, k, v, cache_len)
    new_lens = [17, t - 24, 0, t]
    cache_len.copy_(torch.tensor(new_lens, dtype=torch.int32, device=dev))
    k.copy_(randn(k.shape))
    v.copy_(randn(v.shape))
    graph.replay()
    eager = d_ops.decode_attention(q, k, v, cache_len)
    torch.cuda.synchronize()
    equal = bool(torch.equal(out, eager))
    err = float((out.float() - decode_attention_ref(q, k, v, cache_len)
                 .float()).abs().max())
    emit({"phase": "kernels", "kernel": "decode_attention",
          "case": "cuda_graph", "cache": [b, t, kv, d],
          "cache_len_captured": list(lens), "cache_len_replayed": new_lens,
          "replay_equals_eager": equal, "max_abs_err": err,
          "tol": ATT_TOL["bfloat16"]})
    if not equal or err > ATT_TOL["bfloat16"]:
        fail(f"decode_attention replayed from a CUDA graph: bitwise equal "
             f"to eager {equal}, {err} from its plain version")
    del graph


def phase_decode_cold() -> None:
    """``--decode-cold``: only decode_attention's cold-L2 rows at the LM
    paths' shapes, through the wrapper of the tree this file sits in (a
    copy of this file in an unpacked earlier checkout times that tree's
    kernel with the same timer)."""
    import torch

    from repro_torch.kernels.decode_attention import ops as d_ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for name in DECODE_PATH_SHAPES:
        decode_cold_row(d_ops, name, gen)


# -- phase 3, scans ------------------------------------------------------------

SCAN_TOL = 3e-4       # y and the final state (tests/test_kernels.py's)
# (b, s, h, decay): tests/test_kernels.py's shapes, strong decay, S off the
# 16-step chunk with B > 1, one step, strong decay over 13 chunks with
# B 2 (the state pass), B 3 over 4 chunks with S off the chunk, and last
# the RWKV-6 path's longest prefill (the timed case).
WKV_CASES = [(1, 32, 2, "mild"), (2, 48, 4, "mild"), (1, 40, 1, "mild"),
             (1, 32, 2, "strong"), (3, 37, 2, "mild"), (2, 1, 3, "mild"),
             (2, 200, 3, "strong"), (3, 53, 2, "mild"),
             (1, 699, 32, "mild")]
# (b, s, h, p, n, decay): tests/test_kernels.py's shapes, strong decay
# (dt * |a| up to ~300), S off the 64-step chunk with B > 1, one step,
# strong decay over 18 chunks with B 2 (the state pass), B 3 over 4 chunks
# with S off the chunk and P, N off the kernel's tiles, and last the Hymba
# path's longest prefill (50 SSM heads of 64, state 16; the timed case).
SSD_CASES = [(1, 32, 2, 8, 4, "mild"), (2, 64, 3, 16, 8, "mild"),
             (1, 48, 2, 8, 4, "mild"), (1, 200, 2, 64, 16, "strong"),
             (2, 300, 3, 64, 16, "mild"), (2, 1, 3, 64, 16, "mild"),
             (2, 1100, 3, 64, 16, "strong"), (3, 200, 2, 18, 12, "mild"),
             (1, 1300, 50, 64, 16, "mild")]


def _nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def wkv_bound_ms(r, k, v, w, u):
    """Least time: r, k, v, w, u read once at their own dtypes, y and the
    final state written once (float32), or the recurrence's 5 K^2 float32
    flops a step and head (S <- w S + k^T v: 3 K^2; r S: 2 K^2), whichever
    is larger."""
    b, s, h, kk = r.shape
    nbytes = _nbytes(r, k, v, w, u) + 4.0 * (b * s * h * kk + b * h * kk * kk)
    flops = 5.0 * b * s * h * kk * kk
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes", nbytes)


def ssd_bound_ms(x, dt, a, bm, cm):
    """Least time: x, dt, a, B, C read once at their own dtypes (a view
    reads only its own elements), y and the final state written once
    (float32), or the recurrence's 5 P N float32 flops a step and head
    (h <- e h + dt x B^T: 3 P N; C h: 2 P N), whichever is larger."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    nbytes = _nbytes(x, dt, a, bm, cm) + 4.0 * (b * s * h * p + b * h * p * n)
    flops = 5.0 * b * s * h * p * n
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes", nbytes)


def phase_scan_kernels():
    """rwkv6_scan and ssd_scan against their plain versions on the card
    (y and final state), on float32 inputs and on the LM paths' dtypes and
    layout (RWKV-6: bfloat16 r, k, v, u, float32 w; Hymba: bfloat16 x, dt,
    B, C as views of one projection row, float32 a), then timed at their
    LM paths' longest prefills in the paths' dtypes and layout."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rwkv6_scan import ops as w_ops
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref
    from repro_torch.kernels.ssd_scan import ops as s_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def compare(kernel, name, got, want, **info):
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"{kernel} {info}: output not finite")
        err = [float((g - w).abs().max()) for g, w in zip(got, want)]
        emit({"phase": "kernels", "kernel": kernel, "case": name, **info,
              "max_abs_err_y": err[0], "max_abs_err_state": err[1],
              "tol": SCAN_TOL})
        if max(err) > SCAN_TOL:
            fail(f"{kernel} {info} differs from its plain version by {err}")
        return max(err)

    def wkv_inputs(b, s, h, decay, inputs):
        r, k, v = (randn(b, s, h, 64) * 0.5 for _ in range(3))
        w = torch.full_like(r, 1e-6) if decay == "strong" else \
            torch.sigmoid(randn(b, s, h, 64)) * 0.5 + 0.45
        u = randn(h, 64) * 0.1
        if inputs == "path":
            r, k, v, u = (t.to(bf16) for t in (r, k, v, u))
        return r, k, v, w, u

    def ssd_inputs(b, s, h, p, n, decay, inputs):
        row = randn(b, s, h * p + 2 * n) * 0.5
        dt, a = F.softplus(randn(b, s, h)), -torch.exp(randn(h) * 0.3)
        if decay == "strong":
            dt, a = dt * 30, a * 10
        if inputs == "path":            # views of one row, as ssm_apply
            row, dt = row.to(bf16), dt.to(bf16)
            x, bm, cm = torch.split(row, [h * p, n, n], dim=-1)
        else:
            x, bm, cm = (t.contiguous() for t in
                         torch.split(row, [h * p, n, n], dim=-1))
        return x.reshape(b, s, h, p), dt, a, bm, cm

    worst = {"rwkv6_scan": 0.0, "ssd_scan": 0.0}
    for (b, s, h, decay) in WKV_CASES:
        for inputs in ("float32", "path"):
            args = wkv_inputs(b, s, h, decay, inputs)
            err = compare("rwkv6_scan", decay, w_ops.rwkv6_scan(*args),
                          wkv6_scan_ref(*args), shape=[b, s, h, 64],
                          inputs=inputs)
            worst["rwkv6_scan"] = max(worst["rwkv6_scan"], err)
    for (b, s, h, p, n, decay) in SSD_CASES:
        for inputs in ("float32", "path"):
            args = ssd_inputs(b, s, h, p, n, decay, inputs)
            err = compare("ssd_scan", decay, s_ops.ssd_scan(*args),
                          ssd_scan_ref(*args),
                          shape={"x": [b, s, h, p], "bc": [b, s, n]},
                          inputs=inputs)
            worst["ssd_scan"] = max(worst["ssd_scan"], err)

    # Timings at the LM paths' longest prefills, in the paths' dtypes and
    # layout, as the models hand them to the wrappers.  Device times span
    # the three passes of each C entry point; the inputs (20.6 and 25.4
    # MB) stay in L2 between launches, beside the scratch (23.4 and 4.3
    # MB).
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as w_bind
    from repro_torch.kernels.ssd_scan import ssd_scan as s_bind
    b, s, h, _ = WKV_CASES[-1]
    args = wkv_inputs(b, s, h, "mild", "path")
    bound, by, nbytes = wkv_bound_ms(*args)
    y = torch.empty(args[0].shape, dtype=torch.float32, device=dev)
    st = torch.empty((b, h, 64, 64), dtype=torch.float32, device=dev)
    scratch = torch.empty(w_bind.scratch_floats(b, s, h), device=dev)
    passes = {}
    dev_ms = device_ms(
        lambda: w_bind.rwkv6_scan_cuda(*args, y, st, scratch),
        by_kernel=passes)
    wkv_row = {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:105",
        "max_abs_err": worst["rwkv6_scan"],
        "ms": cuda_ms(lambda: w_ops.rwkv6_scan(*args), runs=20),
        "device_ms": dev_ms,
        "plain_ms": cuda_ms(lambda: wkv6_scan_ref(*args), warmup=1, runs=3),
        "bound_ms": bound, "bound_by": by,
        # no single PyTorch call computes the WKV6 recurrence
        "library_ms": None, "library_device_ms": None}
    emit({"phase": "kernels", "kernel": "rwkv6_scan", "timing": wkv_row,
          "device_ms_by_pass": passes, "shape": [b, s, h, 64],
          "dtypes": [str(t.dtype) for t in args], "bound_bytes": nbytes})

    b, s, h, p, n, _ = SSD_CASES[-1]
    args = ssd_inputs(b, s, h, p, n, "mild", "path")
    bound, by, nbytes = ssd_bound_ms(*args)
    y = torch.empty(args[0].shape, dtype=torch.float32, device=dev)
    st = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    scratch = torch.empty(s_bind.scratch_floats(b, s, h, p, n), device=dev)
    passes = {}
    dev_ms = device_ms(lambda: s_bind.ssd_scan_cuda(*args, y, st, scratch),
                       by_kernel=passes)
    ssd_row = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:88",
        "max_abs_err": worst["ssd_scan"],
        "ms": cuda_ms(lambda: s_ops.ssd_scan(*args), runs=20),
        "device_ms": dev_ms,
        "plain_ms": cuda_ms(lambda: ssd_scan_ref(*args), warmup=1, runs=3),
        "bound_ms": bound, "bound_by": by,
        # no single PyTorch call computes the SSD recurrence
        "library_ms": None, "library_device_ms": None}
    emit({"phase": "kernels", "kernel": "ssd_scan", "timing": ssd_row,
          "device_ms_by_pass": passes,
          "shape": {"x": [b, s, h, p], "bc": [b, s, n]},
          "dtypes": [str(t.dtype) for t in args], "bound_bytes": nbytes})
    return wkv_row, ssd_row


# -- phases 7-12: the LM paths ------------------------------------------------

def lm_prompts(vocab, lens):
    """Prompts of the given lengths from the seed, plus a repeat of the
    first (a prefix-cache hit)."""
    import numpy as np
    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    return prompts + [prompts[LM_REPEAT].copy()]


def serve(model, params, prompts, max_len):
    """Serve ``prompts`` through a fresh engine, one step at a time with the
    card synchronized around each step -> (engine, per-step records)."""
    import torch

    from repro_torch.serve import InferenceEngine, Request, ServeConfig
    eng = InferenceEngine(model, ServeConfig(
        n_slots=LM_SLOTS, max_len=max_len, eos_token=-1, prefix_cache=True))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS))
    steps = []
    while eng.queue or any(r is not None for r in eng.slots):
        queued, prefills = len(eng.queue), eng.prefills
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(params)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "admitted": queued - len(eng.queue),
                      "prefills": eng.prefills - prefills})
    return eng, steps


def lm_kernel_ops():
    """The wrapper module of every kernel an LM path can launch."""
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.rwkv6_scan import ops as w_ops
    from repro_torch.kernels.ssd_scan import ops as s_ops
    return {"flash_attention": f_ops, "decode_attention": d_ops,
            "rwkv6_scan": w_ops, "ssd_scan": s_ops}


def zero_launches() -> None:
    """Every kernel's launch count to 0: a path's counts start here."""
    for mod in lm_kernel_ops().values():
        mod.launches = 0


def read_launches() -> dict:
    return {k: mod.launches for k, mod in lm_kernel_ops().items()}


def check_launches(name, launches, want, what) -> None:
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want} ({what})")


def expected_launches(cfg, eng):
    """One launch a layer per prefill (flash attention, and the scan of the
    family) and per decode step (decode attention); RWKV-6 has no
    attention and decodes its recurrence in plain torch."""
    n = cfg.n_layers
    want = dict.fromkeys(lm_kernel_ops(), 0)
    if cfg.rwkv:
        want["rwkv6_scan"] = n * eng.prefills
    else:
        want["flash_attention"] = n * eng.prefills
        want["decode_attention"] = n * eng.decode_steps
    if cfg.hybrid:
        want["ssd_scan"] = n * eng.prefills
    return want


def build_lm(arch, layers=None, kv="bfloat16", seed=LM_SEED, params=None):
    """``arch`` at full width (``layers`` of its depth where given) on the
    card with random bfloat16 weights from ``seed`` (or ``params``) ->
    (config, model, params, the depth cut or None)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    reduced = None
    if layers is not None:
        reduced = f"{layers} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, device="cuda", param_dtype=torch.bfloat16,
                        kv_cache_dtype=getattr(torch, kv))
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        params = model.init_params(gen)
        torch.cuda.synchronize()
    return cfg, model, params, reduced


def emit_init(name, cfg, params, reduced, kv, seconds) -> None:
    emit({"phase": name, "step": "init", "arch": cfg.name,
          "layers": cfg.n_layers, "reduced": reduced,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "d_head": cfg.d_head,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "attention": cfg.attention, "window": cfg.window_size,
          "global_layers": list(cfg.global_layers),
          "global_every": cfg.global_every,
          "softcaps": [cfg.attn_softcap, cfg.final_softcap],
          "experts": [cfg.n_experts, cfg.experts_per_token],
          "encoder_layers": cfg.n_encoder_layers,
          "frontend": cfg.frontend, "ssm_state": cfg.ssm_state,
          "params": sum(x.numel() for x in _leaves(params)),
          "param_dtype": "bfloat16", "kv_cache_dtype": kv,
          "seconds": seconds})


def cache_bytes(cache) -> int:
    return sum(x.nbytes for x in _leaves(cache))


def phase_lm(name, params=None):
    """One LM path at full width through InferenceEngine; every kernel's
    launch count is zeroed just before the engine runs and read just
    after.  ``params`` reuses another path's weights.  -> (launches, the
    path's model, weights, prompts, engine and completed requests)."""
    import torch
    path = LM_PATHS[name]
    t0 = time.perf_counter()
    cfg, model, params, reduced = build_lm(path.arch, path.layers, path.kv,
                                           params=params)
    emit_init(name, cfg, params, reduced, path.kv, time.perf_counter() - t0)
    prompts = lm_prompts(cfg.vocab_size, path.lens)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                            # the path's counts from here
    t0 = time.perf_counter()
    eng, steps = serve(model, params, prompts, path.max_len)
    wall = time.perf_counter() - t0
    launches = read_launches()
    done = sorted(eng.completed, key=lambda r: r.rid)
    if len(done) != len(prompts) or any(
            len(r.output) != LM_NEW_TOKENS for r in done):
        fail(f"{name}: {len(done)} of {len(prompts)} requests completed, "
             f"outputs {[len(r.output) for r in done]}")
    if any(not 0 <= tok < cfg.vocab_size for r in done for tok in r.output):
        fail(f"{name}: a generated token lies outside the vocabulary")
    if eng.prefills != len(prompts) - 1:
        fail(f"{name}: {eng.prefills} prefills for {len(prompts)} requests, "
             f"one of which repeats a prompt")
    check_launches(name, launches, expected_launches(cfg, eng),
                   f"{eng.prefills} prefills, {eng.decode_steps} decode "
                   f"steps, {cfg.n_layers} layers")
    decode_only = [st["ms"] for st in steps if st["admitted"] == 0]
    tokens = sum(len(r.output) for r in done)
    emit({"phase": name, "step": "serve", "requests": len(done),
          "prompt_lens": [len(p) for p in prompts],
          "new_tokens": LM_NEW_TOKENS, "slots": LM_SLOTS,
          "max_len": path.max_len, "prefills": eng.prefills,
          "decode_steps": eng.decode_steps, "engine_steps": len(steps),
          "launches": launches, "wall_s": wall,
          "tokens_per_s": tokens / wall,
          "decode_step_ms_median": statistics.median(decode_only),
          "decode_step_ms": decode_only,
          "ttft_ms": [(r.first_token_at - r.submitted_at) * 1e3
                      for r in done],
          "kv_cache_bytes": cache_bytes(eng.cache["layers"]),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    profile_decode(name, model, params, eng.cache,
                   statistics.median(decode_only))
    if cfg.n_experts:
        moe_routing(name, cfg, model, params, eng.cache,
                    prompts[path.check], path.max_len)

    # Per-request prefill time, measured alone after the counted run.
    prefill_ms = []
    for p in prompts[:-1]:
        tok = torch.as_tensor(p, device="cuda")[None]
        prefill_ms.append(cuda_ms(lambda: model.prefill(
            params, tok, max_len=path.max_len), warmup=1, runs=3))
    emit({"phase": name, "step": "prefill", "prompt_lens": list(path.lens),
          "prefill_ms": prefill_ms})
    phase_lm_check(name, cfg, model, params, prompts, done)
    ctx = {"cfg": cfg, "model": model, "params": params, "prompts": prompts,
           "done": done, "decode_step_ms_median":
               statistics.median(decode_only),
           "kv_cache_bytes": cache_bytes(eng.cache["layers"])}
    return launches, ctx


def profile_decode(name, model, params, cache, step_ms, steps=3):
    """Device time of a few decode steps (torch.profiler's CUDA events) ->
    the device's busy share of an unprofiled step and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tokens = torch.zeros((cache["len"].shape[0], 1), dtype=torch.int32,
                         device="cuda")
    _, cache = model.decode_step(params, cache, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _, cache = model.decode_step(params, cache, tokens)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # decode_attention's two kernels (split, combine), per step
    attn = sum(ms for n, ms in by_name.items()
               if re.search(r"\bdecode_(split|combine)_kernel\b", n))
    emit({"phase": name, "step": "profile_decode", "steps": steps,
          "device_busy_ms_per_step": busy if by_name else None,
          "step_ms": step_ms,
          "device_idle_share": 1.0 - busy / step_ms if by_name else None,
          "kernels_per_step": sum(1 for e in prof.events()
                                  if e.device_type == DeviceType.CUDA)
          / steps,
          "decode_attention_ms_per_step": attn,
          "top_kernels_ms": [[n[:80], ms] for n, ms in top]})


def moe_routing(name, cfg, model, params, cache, prompt, max_len) -> None:
    """The (token, expert) pairs routed and dropped by capacity over every
    MoE layer: in one decode step of the engine's batch, and in the prefill
    of one prompt."""
    import torch

    from repro_torch.models.moe import _capacity
    b = cache["len"].shape[0]
    model.moe_counts = {}
    model.decode_step(params, cache, torch.zeros((b, 1), dtype=torch.int32,
                                                 device="cuda"))
    step = {k: int(v) for k, v in model.moe_counts.items()}
    model.moe_counts = {}
    model.prefill(params, torch.as_tensor(prompt, device="cuda")[None],
                  max_len=max_len)
    pre = {k: int(v) for k, v in model.moe_counts.items()}
    model.moe_counts = None
    emit({"phase": name, "step": "moe_routing", "moe_layers": cfg.n_layers,
          "experts": cfg.n_experts, "top_k": cfg.experts_per_token,
          "decode_tokens": b, "decode_capacity": _capacity(cfg, b, 2.0),
          "decode_step_pairs_routed": step["routed"],
          "decode_step_pairs_dropped": step["dropped"],
          "prefill_tokens": len(prompt),
          "prefill_capacity": _capacity(cfg, len(prompt), 2.0),
          "prefill_pairs_routed": pre["routed"],
          "prefill_pairs_dropped": pre["dropped"]})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def top1_clear(logits, scale):
    """The LM_CHECK_REL rule: each row's top-1 margin over twice
    LM_CHECK_REL of ``scale`` -> bool [rows]."""
    import torch
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[:, 0] - top2[:, 1] > 2 * LM_CHECK_REL * scale


def card_vs_cpu(name, small, sub, tok, **inputs) -> None:
    """``small`` (the path's config cut to a few layers at full width) with
    the path's first layers ``sub``: its prefill logits on the card against
    the port's CPU run of the same weights and inputs, within LM_CHECK_REL
    of the largest CPU logit, the greedy token equal where the CPU margin
    is clear."""
    import torch

    from repro_torch.models import build_model
    cuda = {k: v.cuda() for k, v in inputs.items()}
    card, _ = build_model(small, device="cuda",
                          param_dtype=torch.bfloat16).prefill(
        sub, tok.cuda(), **cuda)
    t0 = time.perf_counter()
    cpu, _ = build_model(small, device="cpu",
                         param_dtype=torch.bfloat16).prefill(
        _to(sub, "cpu"), tok, **inputs)
    cpu_s = time.perf_counter() - t0
    v = small.vocab_size
    card, cpu = card.cpu()[:, :v], cpu[:, :v]
    if not torch.isfinite(card).all():
        fail(f"{name}: card prefill logits are not finite")
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    tol = LM_CHECK_REL * scale
    clear = bool(top1_clear(cpu, scale).all())
    same_top1 = bool((card.argmax(-1) == cpu.argmax(-1)).all())
    emit({"phase": f"{name}_check", "layers": small.n_layers,
          "encoder_layers": small.n_encoder_layers,
          "prompt_len": int(tok.shape[1]), "max_abs_err": err,
          "cpu_logit_scale": scale, "tol": tol, "top1_clear": clear,
          "same_top1": same_top1, "cpu_seconds": cpu_s})
    if err > tol:
        fail(f"{name}: card prefill logits differ from the CPU's by {err} "
             f"(tolerance {tol})")
    if clear and not same_top1:
        fail(f"{name}: the card's greedy token differs from the CPU's where "
             f"the CPU margin is clear")


def phase_lm_check(name, cfg, model, params, prompts, done):
    """Slot isolation on the card (where the family has it), and the card
    against the CPU through the first LM_CHECK_LAYERS layers."""
    import torch
    path = LM_PATHS[name]
    i = path.check
    if path.alone:
        eng, _ = serve(model, params, [prompts[i]], path.max_len)
        alone = eng.completed[0].output
        batched = done[i].output
        emit({"phase": f"{name}_check", "request": i,
              "prompt_len": len(prompts[i]),
              "alone_equals_batched": alone == batched})
        if alone != batched:
            fail(f"{name}: request {i} alone gave {alone}, in the batch "
                 f"{batched}")
    else:
        emit({"phase": f"{name}_check", "request": i,
              "alone_equals_batched": None,
              "why": "not applicable: an expert keeps at most its capacity "
                     "of the batch's tokens (GShard, as in the JAX "
                     "package), so a request's output depends on its "
                     "batch"})
    small = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    sub = dict(params, layers=params["layers"][:LM_CHECK_LAYERS])
    card_vs_cpu(name, small, sub, torch.as_tensor(prompts[i])[None])


def moe_repeat(name, model, params, prompts, done) -> None:
    """Two card runs bitwise equal: the prefill logits and one decode step
    of a prompt, each twice, and the whole engine run again (every
    request's tokens equal)."""
    import torch
    path = LM_PATHS[name]
    tok = torch.as_tensor(prompts[path.check], device="cuda")[None]
    runs = []
    for _ in range(2):
        logits, cache = model.prefill(params, tok, max_len=path.max_len)
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        step, _ = model.decode_step(params, cache, nxt)
        runs.append((logits, step))
    prefill_equal = torch.equal(runs[0][0], runs[1][0])
    decode_equal = torch.equal(runs[0][1], runs[1][1])
    eng, _ = serve(model, params, prompts, path.max_len)
    again = sorted(eng.completed, key=lambda r: r.rid)
    tokens_equal = [a.output == b.output for a, b in zip(again, done)]
    emit({"phase": f"{name}_check", "step": "repeat",
          "prefill_logits_bitwise": prefill_equal,
          "decode_logits_bitwise": decode_equal,
          "engine_tokens_equal": tokens_equal})
    if not (prefill_equal and decode_equal and all(tokens_equal)):
        fail(f"{name}: two card runs differ (prefill {prefill_equal}, "
             f"decode {decode_equal}, engine {tokens_equal})")


def gemma2_int8_vs_bf16(g16, g8) -> None:
    """For every request, the greedy token after the prefill and after one
    decode step of the int8-cache model against the bfloat16 one's: the
    prefill logits bitwise equal (the cache's dtype enters after them),
    the decode step's token equal wherever the bfloat16 top-1 margin is
    clear by the LM_CHECK_REL rule; the KV bytes of the engine's caches
    and the decode-step ms of both runs."""
    import torch
    name = "lm_gemma2_int8"
    path = LM_PATHS[name]
    v = g16["cfg"].vocab_size
    params = g16["params"]
    rows = []
    for i, p in enumerate(g16["prompts"][:-1]):
        tok = torch.as_tensor(p, device="cuda")[None]
        l16, c16 = g16["model"].prefill(params, tok, max_len=path.max_len)
        l8, c8 = g8["model"].prefill(params, tok, max_len=path.max_len)
        if not torch.equal(l16, l8):
            fail(f"{name}: request {i}'s prefill logits differ from the "
                 f"bfloat16 model's")
        nxt = l16.argmax(-1, keepdim=True).to(torch.int32)
        d16, _ = g16["model"].decode_step(params, c16, nxt)
        d8, _ = g8["model"].decode_step(params, c8, nxt)
        a, b = d16.cpu()[:, :v], d8.cpu()[:, :v]
        scale = float(a.abs().max())
        clear = bool(top1_clear(a, scale).all())
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
        rows.append({"request": i, "prompt_len": len(p),
                     "max_abs_err": float((a - b).abs().max()),
                     "logit_scale": scale, "top1_clear": clear,
                     "same_top1": same})
        if clear and not same:
            fail(f"{name}: request {i}'s greedy token after one decode "
                 f"step differs from the bfloat16 cache's where its margin "
                 f"is clear")
    emit({"phase": f"{name}_check", "step": "vs_bf16", "requests": rows,
          "kv_cache_bytes_int8": g8["kv_cache_bytes"],
          "kv_cache_bytes_bf16": g16["kv_cache_bytes"],
          "kv_bytes_ratio": g8["kv_cache_bytes"] / g16["kv_cache_bytes"],
          "decode_step_ms_median_int8": g8["decode_step_ms_median"],
          "decode_step_ms_median_bf16": g16["decode_step_ms_median"],
          "engine_outputs_equal_bf16": [
              a.output == b.output for a, b in zip(g8["done"],
                                                    g16["done"])]})


SPEC_PROMPT, SPEC_K, SPEC_DRAFT_LAYERS = 113, 4, 4


def phase_speculative(g16):
    """Speculative decoding with Gemma-2 2B (full depth) as the target and
    two drafts, the target itself and a 4-layer Gemma-2 at full width from
    another seed: k = 4, LM_NEW_TOKENS tokens from a 113-token prompt.
    Each output equals ``greedy_decode`` of the target up to a position
    where they part, and they may part only where the target's top-1
    margin (along the greedy continuation) is not clear by the
    LM_CHECK_REL rule: cuBLAS picks its kernels by the row count, so a
    forward over n tokens and one over n + k can round the last bits
    apart.  Launches: the target's full forwards and the drafts' prefills
    (flash), the drafts' decode steps (decode)."""
    import numpy as np
    import torch

    from repro_torch.serve import greedy_decode, speculative_decode
    from repro_torch.serve.speculative import _full_forward_logits
    name = "speculative"
    cfg, target, params = g16["cfg"], g16["model"], g16["params"]
    dcfg, draft, dparams, reduced = build_lm(cfg.name, SPEC_DRAFT_LAYERS,
                                             seed=LM_SEED + 1)
    prompt = lm_prompts(cfg.vocab_size, (SPEC_PROMPT,))[0]
    n = LM_NEW_TOKENS
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = greedy_decode(target, params, prompt, n)
    greedy_s = time.perf_counter() - t0
    total = read_launches()
    check_launches(name, total, {**dict.fromkeys(total, 0),
                                 "flash_attention": cfg.n_layers * n},
                   f"greedy: {n} full forwards")
    seq = np.concatenate([prompt, np.asarray(ref, np.int32)])
    rows = _full_forward_logits(target, params, seq)[
        len(prompt) - 1:len(prompt) - 1 + n, :cfg.vocab_size].float().cpu()
    clear = top1_clear(rows, rows.abs().amax(-1)).tolist()
    emit({"phase": name, "step": "greedy", "prompt_len": len(prompt),
          "tokens": n, "ms_per_token": greedy_s * 1e3 / n,
          "clear_positions": sum(clear), "distinct_tokens": len(set(ref)),
          "repeats_previous_token": sum(
              int(t == p) for t, p in zip(ref, [int(prompt[-1])] + ref)),
          "draft_reduced": reduced})
    for dname, (dm, dp, layers) in {
            "self": (target, params, cfg.n_layers),
            f"gemma2_{SPEC_DRAFT_LAYERS}_layers": (draft, dparams,
                                                   dcfg.n_layers)}.items():
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = speculative_decode(target, params, dm, dp, prompt, n,
                                        k=SPEC_K)
        secs = time.perf_counter() - t0
        got = read_launches()
        rounds = stats.target_calls
        check_launches(name, got, {
            **dict.fromkeys(got, 0),
            "flash_attention": (cfg.n_layers + layers) * rounds,
            "decode_attention": layers * (stats.draft_calls - rounds)},
            f"{rounds} rounds, {stats.draft_calls} draft calls")
        total = {k: total[k] + got[k] for k in total}
        parted = next((i for i in range(n) if out[i] != ref[i]), None)
        emit({"phase": name, "step": "speculative", "draft": dname,
              "draft_layers": layers, "k": SPEC_K,
              "acceptance_rate": stats.acceptance_rate,
              "proposed": stats.proposed, "accepted": stats.accepted,
              "target_calls": stats.target_calls,
              "draft_calls": stats.draft_calls, "launches": got,
              "ms_per_token": secs * 1e3 / n,
              "greedy_ms_per_token": greedy_s * 1e3 / n,
              "equal_to_greedy": out == ref, "parted_at": parted,
              "margin_clear_there": None if parted is None
              else clear[parted]})
        if len(out) != n or (parted is not None and clear[parted]):
            fail(f"{name}: draft {dname}'s output parts from greedy at "
                 f"{parted}, where the target's margin is clear")
    return total


PAGED_LENS, PAGED_BLOCK, PAGED_STEPS = (1, 517, 1300, 2000), 16, 8


def phase_paged():
    """``PagedKVCache`` at Gemma-2 2B's KV shape (4 heads of 256, bfloat16):
    four sequences of 1-2,000 tokens appended interleaved into one pool of
    16-slot blocks, then PAGED_STEPS decode steps, each appending one token
    to every sequence and running decode_attention (soft cap 50) over
    ``batch_gather``, bitwise equal to it over contiguous caches holding
    the same tokens; an exhausted pool raises MemoryError; the pool's bytes
    against per-slot caches of Gemma-2's max_len."""
    import torch

    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.serve import PagedKVCache
    name = "paged"
    h, kv, d = 8, 4, 256
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    need = [-(-(n + PAGED_STEPS) // PAGED_BLOCK) for n in PAGED_LENS]
    pools = [PagedKVCache(sum(need), PAGED_BLOCK, kv, d, max(need),
                          device=dev) for _ in range(2)]
    t = max(need) * PAGED_BLOCK
    flat = [torch.zeros((len(PAGED_LENS), t, kv, d), dtype=bf16, device=dev)
            for _ in range(2)]
    tokens = [torch.randn((n + PAGED_STEPS, 2, kv, d), generator=gen,
                          device=dev).to(bf16) for n in PAGED_LENS]
    pos = [0] * len(PAGED_LENS)

    def append(i):
        for pool, cache, which in zip(pools, flat, (0, 1)):
            if i not in pool.tables:
                pool.allocate(i)
            pool.append(i, tokens[i][pos[i], which])
            cache[i, pos[i]] = tokens[i][pos[i], which]
        pos[i] += 1

    order = [i for i, n in enumerate(PAGED_LENS) for _ in range(n)]
    perm = torch.randperm(len(order), generator=torch.Generator()
                          .manual_seed(LM_SEED))
    t0 = time.perf_counter()
    for j in perm.tolist():
        append(order[j])
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    zero_launches()
    equal, sids = [], list(range(len(PAGED_LENS)))
    for _ in range(PAGED_STEPS):
        for i in sids:
            append(i)
        (pk, lens), (pv, _) = (pool.batch_gather(sids) for pool in pools)
        q = torch.randn((len(sids), 1, h, d), generator=gen,
                        device=dev).to(bf16)
        paged = d_ops.decode_attention(q, pk, pv, lens, GEMMA2_SOFTCAP)
        contiguous = d_ops.decode_attention(q, *flat, lens, GEMMA2_SOFTCAP)
        equal.append(bool(torch.equal(paged, contiguous)))
    launches = read_launches()
    check_launches(name, launches, {**dict.fromkeys(launches, 0),
                                    "decode_attention": 2 * PAGED_STEPS},
                   f"{PAGED_STEPS} steps, paged and contiguous")
    small = PagedKVCache(2, PAGED_BLOCK, kv, d, 4, device=dev)
    small.allocate(0)
    try:
        for _ in range(2 * PAGED_BLOCK + 1):
            small.append(0, tokens[0][0, 0])
        exhausted = False
    except MemoryError:
        exhausted = True
    pool_bytes = sum(p.pool.nbytes for p in pools)
    per_slot = 2 * LM_SLOTS * LM_PATHS["lm_gemma2"].max_len * kv * d * 2
    emit({"phase": name, "kv": [kv, d], "block": PAGED_BLOCK,
          "lengths": [n + PAGED_STEPS for n in PAGED_LENS],
          "blocks": sum(need), "append_s": append_s,
          "steps_bitwise_equal": equal, "exhausted_raises": exhausted,
          "pool_bytes_per_layer": pool_bytes,
          "per_slot_bytes_per_layer": per_slot,
          "pool_over_per_slot": pool_bytes / per_slot,
          "launches": launches})
    if not all(equal):
        fail(f"{name}: decode attention over the paged gather differs from "
             f"contiguous caches at steps {equal}")
    if not exhausted:
        fail(f"{name}: an exhausted pool did not raise MemoryError")
    return launches


def batch_caches(caches):
    """Decode caches of single requests -> one batched cache (rows in
    order; each keeps its own length)."""
    import torch
    out = {"len": torch.cat([c["len"] for c in caches]),
           "layers": [{k: torch.cat([c["layers"][i][k] for c in caches])
                       for k in layer}
                      for i, layer in enumerate(caches[0]["layers"])]}
    if "enc_out" in caches[0]:
        out["enc_out"] = torch.cat([c["enc_out"] for c in caches])
    return out


def prefill_then_decode(name, cfg, model, params, prompts, max_len,
                        inputs):
    """Each request's prefill alone (its own length and inputs), the
    caches batched, then LM_NEW_TOKENS greedy decode steps for the batch
    -> (tokens [B, LM_NEW_TOKENS + 1], prefill ms, decode step ms, the
    batch's cache)."""
    import torch
    caches, first, prefill_ms = [], [], []
    for i, p in enumerate(prompts):
        kw = {k: v[i:i + 1] for k, v in inputs.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(
            params, torch.as_tensor(p, device="cuda")[None],
            max_len=max_len, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(logits[:, :cfg.vocab_size]).all():
            fail(f"{name}: request {i}'s prefill logits are not finite")
        caches.append(cache)
        first.append(logits.argmax(-1))
    cache = batch_caches(caches)
    del caches
    out = [torch.stack(first, 0).to(torch.int32)]          # [B, 1]
    step_ms = []
    for _ in range(LM_NEW_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, out[-1])
        out.append(logits.argmax(-1, keepdim=True).to(torch.int32))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(logits[:, :cfg.vocab_size]).all():
            fail(f"{name}: decode logits are not finite")
    tokens = torch.cat(out, 1).cpu()
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"{name}: a generated token lies outside the vocabulary")
    return tokens, prefill_ms, step_ms, cache


ENCDEC_MAX_LEN, ENCDEC_TARGET_LENS = 1024, (1, 17, 40, 64)


def phase_encdec():
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers): 4 requests, each 256 seeded source frames
    (encoder_len_ratio 0.25 of max_len 1024) and a target prompt of 1-64
    tokens, each prefilled alone, then LM_NEW_TOKENS greedy decode
    steps for the batch.  Launches: flash 72 a prefill (the encoder's
    bidirectional self-attention, the decoder's causal one, its
    cross-attention), decode 48 a step (self and cross); then the card
    against the CPU through 2 + 2 layers."""
    import torch
    name = "lm_encdec"
    t0 = time.perf_counter()
    cfg, model, params, reduced = build_lm("seamless-m4t-large-v2")
    emit_init(name, cfg, params, reduced, "bfloat16",
              time.perf_counter() - t0)
    src_len = int(ENCDEC_MAX_LEN * cfg.encoder_len_ratio)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM_SEED + 2)
    src = (0.1 * torch.randn((len(ENCDEC_TARGET_LENS), src_len, cfg.d_model),
                             generator=gen, device="cuda")).to(torch.bfloat16)
    prompts = lm_prompts(cfg.vocab_size, ENCDEC_TARGET_LENS)[:-1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    tokens, prefill_ms, step_ms, cache = prefill_then_decode(
        name, cfg, model, params, prompts, ENCDEC_MAX_LEN,
        {"src_embeds": src})
    wall = time.perf_counter() - t0
    launches = read_launches()
    b, steps = len(prompts), LM_NEW_TOKENS
    check_launches(name, launches, {
        **dict.fromkeys(launches, 0),
        "flash_attention": (cfg.n_encoder_layers + 2 * cfg.n_layers) * b,
        "decode_attention": 2 * cfg.n_layers * steps},
        f"{b} prefills, {steps} decode steps")
    emit({"phase": name, "step": "serve", "requests": b,
          "source_frames": src_len, "prompt_lens": list(ENCDEC_TARGET_LENS),
          "new_tokens": tokens.shape[1], "decode_steps": steps,
          "max_len": ENCDEC_MAX_LEN,
          "launches": launches, "wall_s": wall,
          "tokens_per_s": tokens.numel() / wall, "prefill_ms": prefill_ms,
          "decode_step_ms_median": statistics.median(step_ms),
          "decode_step_ms": step_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    profile_decode(name, model, params, cache, statistics.median(step_ms))
    del cache
    small = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS,
                                n_encoder_layers=LM_CHECK_LAYERS)
    sub = dict(params, layers=params["layers"][:LM_CHECK_LAYERS],
               cross_layers=params["cross_layers"][:LM_CHECK_LAYERS],
               enc_layers=params["enc_layers"][:LM_CHECK_LAYERS])
    card_vs_cpu(name, small, sub, torch.as_tensor(prompts[-1])[None],
                src_embeds=src[-1:].cpu())
    return launches


VLM_TEXT_LENS, VLM_MAX_LEN = (113, 333), 1536


def phase_vlm():
    """Pixtral-12B at full width and depth in bfloat16: 2 requests of 1,024
    seeded patch embeddings before 113 or 333 text tokens, each prefilled
    alone, then LM_NEW_TOKENS greedy decode steps for the pair; peak
    memory; then the card against the CPU through 2 layers."""
    import torch
    name = "lm_vlm"
    t0 = time.perf_counter()
    cfg, model, params, reduced = build_lm("pixtral-12b")
    emit_init(name, cfg, params, reduced, "bfloat16",
              time.perf_counter() - t0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM_SEED + 3)
    patches = (0.1 * torch.randn(
        (len(VLM_TEXT_LENS), cfg.n_frontend_tokens, cfg.d_model),
        generator=gen, device="cuda")).to(torch.bfloat16)
    prompts = lm_prompts(cfg.vocab_size, VLM_TEXT_LENS)[:-1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    tokens, prefill_ms, step_ms, cache = prefill_then_decode(
        name, cfg, model, params, prompts, VLM_MAX_LEN,
        {"patch_embeds": patches})
    wall = time.perf_counter() - t0
    launches = read_launches()
    b, steps = len(prompts), LM_NEW_TOKENS
    check_launches(name, launches, {
        **dict.fromkeys(launches, 0),
        "flash_attention": cfg.n_layers * b,
        "decode_attention": cfg.n_layers * steps},
        f"{b} prefills, {steps} decode steps")
    lens = [cfg.n_frontend_tokens + n for n in VLM_TEXT_LENS]
    if cache["len"].tolist() != [n + steps for n in lens]:
        fail(f"{name}: cache lengths {cache['len'].tolist()}")
    emit({"phase": name, "step": "serve", "requests": b,
          "patches": cfg.n_frontend_tokens, "text_lens": list(VLM_TEXT_LENS),
          "new_tokens": tokens.shape[1], "decode_steps": steps,
          "max_len": VLM_MAX_LEN,
          "launches": launches, "wall_s": wall,
          "tokens_per_s": tokens.numel() / wall, "prefill_ms": prefill_ms,
          "decode_step_ms_median": statistics.median(step_ms),
          "decode_step_ms": step_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    profile_decode(name, model, params, cache, statistics.median(step_ms))
    del cache
    small = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    sub = dict(params, layers=params["layers"][:LM_CHECK_LAYERS])
    card_vs_cpu(name, small, sub, torch.as_tensor(prompts[0])[None],
                patch_embeds=patches[:1].cpu())
    return launches


# -- phases 13-17, training -------------------------------------------------

TRAIN_ARCH = "minicpm-2b"
TRAIN_BATCH, TRAIN_SEQ = 8, 256        # the launcher's defaults
TRAIN_STEPS = 5                        # 1 warm-up, 3 timed, 1 profiled
TRAIN_LR = 3e-3
TRAIN_GRAD_REL_L2 = 0.08               # tests/test_torch_train_loss.py's
TRAIN_LOSS_RTOL = 1e-3
RESTART_LOSS_TOL = 1e-4                # tests/test_train_loop.py's
LSE_TOL = 1e-4
VJP_ATOL, VJP_RTOL = 3e-4, 1e-3        # tests/test_flash_vjp.py's
# (name, (b, s, t, h, kv, d), causal, window, softcap): MiniCPM-2B's train
# shape; Gemma-2 2B's local and global layers past the 4,096 window (D
# 256, cap 50); bidirectional; cross with S != T; one token; S > T with a
# window of 16, whose rows from 55 on see no key.
LSE_CASES = [
    ("minicpm_train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 36, 36, 64), True,
     0, 0.0),
    ("gemma2_local", (1, 4200, 4200, 8, 4, 256), True, 4096,
     GEMMA2_SOFTCAP),
    ("gemma2_global", (1, 4200, 4200, 8, 4, 256), True, 0, GEMMA2_SOFTCAP),
    ("bidir", (2, 130, 130, 8, 2, 128), False, 0, 0.0),
    ("cross", (2, 77, 150, 10, 2, 64), False, 0, 30.0),
    ("one_token", (2, 1, 1, 8, 8, 128), True, 0, 0.0),
    ("rows_see_no_key", (1, 200, 40, 4, 2, 64), True, 16, 0.0),
]
# the CPU flash-VJP tests' cases, float32 on the card: (b, s, t, h, kv, d,
# mask kind, window, cap, block size)
VJP_CASES = [
    (2, 96, 96, 4, 2, 64, "window", 0, 0.0, 32),
    (1, 64, 64, 4, 4, 64, "window", 16, 0.0, 32),
    (1, 80, 80, 2, 1, 64, "window", 0, 20.0, 32),
    (2, 64, 64, 4, 2, 64, "window", 24, 20.0, 32),
    (1, 40, 40, 10, 2, 64, "causal", 0, 0.0, 512),
    (2, 48, 48, 4, 2, 128, "bidir", 0, 0.0, 512),
    (2, 24, 56, 4, 2, 64, "cross", 0, 30.0, 512),
    (1, 70, 70, 4, 1, 64, "causal", 0, 0.0, 32),
]


def visible_rows(s, t, causal, window):
    """[S] bool: the query rows that see at least one key."""
    import torch
    rows = torch.arange(s)
    if not causal:
        return torch.ones(s, dtype=torch.bool)
    first = rows - (window - 1 if window > 0 else rows)
    return first.clamp(min=0) < t


def phase_train_kernels(flash_row):
    """The flash kernel's lse against ``ref.py``'s (1e-4) over
    ``LSE_CASES`` in float32 and bfloat16, with ``out`` within today's
    bounds on every row that sees a key; the flash VJP's dq, dk, dv on the
    card against autograd through the float32 plain version (3e-4 / 1e-3);
    the scan wrappers refusing a gradient; then, at MiniCPM-2B's train
    shape, lse's added device time and the plain backward's device time
    against SDPA's forward and backward.  Adds the train shape's numbers
    to ``flash_row["by_shape"]["train"]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref, attention_with_lse_ref)
    from repro_torch.kernels.rwkv6_scan import ops as w_ops
    from repro_torch.kernels.ssd_scan import ops as s_ops
    from repro_torch.models.attention import (flash_attention_bwd,
                                              full_attention)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    worst_lse = 0.0
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for name, (b, s, t, h, kv, d), causal, window, cap in LSE_CASES:
            q = randn((b, s, h, d), dtype)
            k, v = randn((b, t, kv, d), dtype), randn((b, t, kv, d), dtype)
            out, lse = f_ops.flash_attention_with_lse(q, k, v, causal, window,
                                                      cap)
            want_out, want_lse = attention_with_lse_ref(q, k, v, causal,
                                                        window, cap)
            torch.cuda.synchronize()
            seen = visible_rows(s, t, causal, window).to(dev)
            lse_err = float((lse - want_lse).abs().max())
            out_err = float((out.float() - want_out.float())[:, seen]
                            .abs().max())
            blind_ok = bool((lse[:, :, ~seen] == -1e30).all())
            emit({"phase": "train_kernels", "kernel": "flash_attention",
                  "check": "lse", "case": name, "dtype": dname,
                  "shape": {"q": [b, s, h, d], "kv": [b, t, kv, d]},
                  "causal": causal, "window": window, "softcap": cap,
                  "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
                  "out_max_abs_err": out_err, "out_tol": ATT_TOL[dname],
                  "rows_seeing_no_key": int((~seen).sum()),
                  "their_lse_is_-1e30": blind_ok})
            if lse_err > LSE_TOL or not blind_ok:
                fail(f"flash_attention lse {dname} {name}: off by {lse_err} "
                     f"(rows that see no key at -1e30: {blind_ok})")
            if out_err > ATT_TOL[dname]:
                fail(f"flash_attention {dname} {name}: out with the lse off "
                     f"by {out_err}")
            worst_lse = max(worst_lse, lse_err)
            del q, k, v, out, lse, want_out, want_lse

    qwen = reduced_config(get_config("qwen2.5-14b"))
    worst_grad = 0.0
    for b, s, t, h, kv, d, kind, window, cap, block in VJP_CASES:
        cfg = dataclasses.replace(qwen, attn_softcap=cap)
        q, k, v = randn((b, s, h, d)), randn((b, t, kv, d)), \
            randn((b, t, kv, d))
        cot = randn((b, s, h, d))
        mine = [x.clone().requires_grad_() for x in (q, k, v)]
        out = full_attention(cfg, *mine, mask_kind=kind, window=window,
                             block_size=block)
        (out * cot).sum().backward()
        ref = [x.clone().requires_grad_() for x in (q, k, v)]
        want = attention_ref(*ref, causal=kind in ("causal", "window"),
                             window=window, softcap=cap)
        (want * cot).sum().backward()
        torch.cuda.synchronize()
        errs = [float(((a.grad - r.grad).abs()
                       - VJP_RTOL * r.grad.abs()).max())
                for a, r in zip(mine, ref)]
        emit({"phase": "train_kernels", "check": "flash_vjp",
              "shape": {"q": [b, s, h, d], "kv": [b, t, kv, d]},
              "mask": kind, "window": window, "softcap": cap,
              "block_size": block,
              "dq_dk_dv_excess_over_rtol": errs, "atol": VJP_ATOL,
              "rtol": VJP_RTOL})
        if max(errs) > VJP_ATOL:
            fail(f"flash VJP {kind} {(b, s, t, h, kv, d)}: dq/dk/dv off "
                 f"the float32 plain autograd by {errs}")
        worst_grad = max(worst_grad, max(errs))

    # the scans' kernels have no backward: under a gradient they refuse
    refused = []
    x = randn((1, 32, 2, 64)).requires_grad_()
    for name, call in (
            ("rwkv6_scan", lambda: w_ops.rwkv6_scan(
                x, x, x, torch.full_like(x, 0.9), randn((2, 64)))),
            ("ssd_scan", lambda: s_ops.ssd_scan(
                x, randn((1, 32, 2)), torch.full((2,), -0.5, device=dev),
                randn((1, 32, 16)), randn((1, 32, 16))))):
        before = (w_ops.launches, s_ops.launches)
        try:
            call()
        except RuntimeError as err:
            refused.append(name)
            emit({"phase": "train_kernels", "check": "refuses_gradient",
                  "kernel": name, "message": str(err)})
        if (w_ops.launches, s_ops.launches) != before:
            fail(f"{name} launched under a gradient")
    if refused != ["rwkv6_scan", "ssd_scan"]:
        fail(f"scan wrappers under a gradient on the card: only {refused} "
             f"refused")

    # MiniCPM-2B's train shape: the launch with and without the lse, the
    # plain backward, and SDPA's forward and backward on the same inputs
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 36, 64
    q, k, v = (randn((b, s, h, d), torch.bfloat16) for _ in range(3))
    dout = randn((b, s, h, d), torch.bfloat16)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    # the launch without and with the lse, in turns (without, with, with,
    # without), each the mean of its two device_ms
    turns = {"without": [], "with": []}
    for name in ("without", "with", "with", "without"):
        turns[name].append(device_ms(lambda: flash_attention_cuda(
            q, k, v, out, True, 0, 0.0, lse if name == "with" else None)))
    no_lse, with_lse = (statistics.mean(turns[n]) for n in ("without",
                                                            "with"))
    out, lse = f_ops.flash_attention_with_lse(q, k, v, True, 0, 0.0)
    bwd = device_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout, True,
                                                0, 0.0, 512), runs=10)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dh = dout.transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        torch.autograd.grad(o, (qh, kh, vh), dh)
    lib = device_ms(sdpa_fwd_bwd, runs=10)
    bound, by = flash_bound_ms(b, s, s, h, h, d, True, 2, PEAK_BF16_FLOPS)
    row = {"shape": "train", "q": [b, s, h, d], "kv": [b, s, h, d],
           "dtype": "bfloat16", "causal": True,
           "device_ms": no_lse, "device_ms_with_lse": with_lse,
           "lse_added_device_ms": with_lse - no_lse,
           "lse_turns_device_ms": turns,
           "bound_ms": bound, "bound_by": by,
           "plain_ms": cuda_ms(lambda: attention_ref(q, k, v)),
           "ms": cuda_ms(lambda: f_ops.flash_attention_with_lse(
               q, k, v, True, 0, 0.0), runs=20),
           "backward_device_ms": bwd,
           "library_fwd_bwd_device_ms": lib,
           "library": "SDPA forward + backward (causal)"}
    emit({"phase": "train_kernels", "kernel": "flash_attention",
          "timing": row})
    flash_row["by_shape"]["train"] = row
    flash_row["lse_max_abs_err"] = worst_lse
    flash_row["vjp_worst_excess"] = worst_grad


def train_shape_and_opt(steps):
    """The launcher's optimizer for MiniCPM-2B over ``steps`` steps."""
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(peak_lr=TRAIN_LR, schedule="wsd",
                       warmup_steps=max(steps // 20, 5), total_steps=steps)


def kernels_by_range(prof, names):
    """{range name: [(kernel name, ms)]} over the profiler's CPU events of
    ``names`` (record_function ranges) and everything under them."""
    out = {n: [] for n in names}

    def collect(e, acc):
        for kern in getattr(e, "kernels", []):
            acc.append((kern.name, kern.duration / 1e3))
        for child in e.cpu_children:
            collect(child, acc)
    for e in prof.events():
        if e.name in out:
            collect(e, out[e.name])
    return out


def phase_train():
    """MiniCPM-2B at full width and depth trains: float32 master weights,
    remat on (as the launcher has it), WSD, B 8 x 256 tokens from
    ``TokenStream``, ``TRAIN_STEPS`` steps of ``make_train_step``.  Each
    step launches flash exactly 2 x 40 times (forward, remat's recompute);
    every loss is finite.  Prints the step ms, tokens/s, the profiled
    step's device busy ms, idle share and split (flash forward and
    backward, matmuls, optimizer) and peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.models import build_model
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", remat=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM_SEED)
    state = init_train_state(model, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(state["params"]))
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    step_fn = make_train_step(model, train_shape_and_opt(TRAIN_STEPS))
    losses, step_ms, launches = [], [], []
    prof = None
    for i in range(TRAIN_STEPS):
        batch = stream.batch(i)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == TRAIN_STEPS - 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
        else:
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_launches())
        losses.append(float(metrics["loss"]))
        emit({"phase": "train", "step": i, "ms": step_ms[-1],
              "loss": losses[-1], "grad_norm": float(metrics["grad_norm"]),
              "skipped": int(metrics["skipped"]),
              "launches": launches[-1]})
    want = {**dict.fromkeys(lm_kernel_ops(), 0),
            "flash_attention": 2 * cfg.n_layers}
    for i, got in enumerate(launches):
        check_launches("train", got, want,
                       f"step {i}: remat runs each layer's forward twice")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: a loss is not finite: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # device activities, without the record_function ranges' own device
    # spans (user annotations), which would count their kernels twice
    ranges = ("flash_attention_bwd", "adamw_update")
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in ranges]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    if busy <= 0:
        fail("train: the profiler recorded no device time")
    flash_fwd = sum(e.time_range.elapsed_us() for e in device
                    if re.search(r"\bflash_(wgmma|fwd)_kernel\b", e.name)) \
        / 1e3
    gemm = re.compile(r"gemm|sm90_xmma|cutlass|nvjet", re.I)
    matmul_all = sum(e.time_range.elapsed_us() for e in device
                     if gemm.search(e.name)) / 1e3
    in_range = kernels_by_range(prof, ranges)
    flash_bwd = sum(ms for _, ms in in_range["flash_attention_bwd"])
    optimizer = sum(ms for _, ms in in_range["adamw_update"])
    bwd_gemm = sum(ms for n, ms in in_range["flash_attention_bwd"]
                   if gemm.search(n))
    timed = sorted(step_ms[1:TRAIN_STEPS - 1])
    median = statistics.median(timed)
    split = {"flash_forward": flash_fwd, "flash_backward": flash_bwd,
             "matmuls_outside_flash_backward": matmul_all - bwd_gemm,
             "optimizer": optimizer}
    split["other"] = busy - sum(split.values())
    emit({"phase": "train", "step": "summary", "arch": TRAIN_ARCH,
          "layers": cfg.n_layers, "params": n_params, "remat": True,
          "schedule": "wsd", "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
          "init_seconds": init_s, "steps": TRAIN_STEPS, "step_ms": step_ms,
          "median_step_ms": median,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
          "profiled_step_ms": step_ms[-1],
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy / median,
          "device_ms_split": split, "kernels_per_step": len(device),
          "top_kernels_ms": [[n[:80], ms] for n, ms in sorted(
              by_name.items(), key=lambda kv: -kv[1])[:15]],
          "flash_launches_per_step": launches[0]["flash_attention"],
          "peak_mem_gb": peak, "losses": losses})
    del state, model
    torch.cuda.empty_cache()
    return {"flash_attention": sum(x["flash_attention"] for x in launches),
            **{k: 0 for k in lm_kernel_ops() if k != "flash_attention"}}


def phase_train_check():
    """One train step of MiniCPM-2B at full width and LM_CHECK_LAYERS
    layers (remat on), B 1 x 64 tokens, on the card and on the CPU from
    the same float32 parameters: the loss within 1e-3 relative and every
    leaf's gradient within 8% relative L2 (the CPU tests' tolerance), then
    the step's updated parameters finite on both."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_state import (loss_and_grads,
                                               make_train_step)
    from repro_torch.train.tree import leaves_with_paths
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=LM_CHECK_LAYERS)
    card = build_model(cfg, device="cuda", remat=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM_SEED + 1)
    params = card.init_params(gen)
    cpu = build_model(cfg, device="cpu", remat=True)
    cpu_params = _to(params, "cpu")
    batch = TokenStream(cfg.vocab_size, 64, 1, seed=5).batch(0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_c, grads_c = loss_and_grads(card, params, tb)
    t0 = time.perf_counter()
    loss_h, grads_h = loss_and_grads(cpu, cpu_params, tb)
    cpu_s = time.perf_counter() - t0
    worst, worst_key = -1.0, None
    for (key, gc), (_, gh) in zip(leaves_with_paths(grads_c),
                                  leaves_with_paths(grads_h)):
        rel = float(torch.linalg.vector_norm(gc.cpu() - gh)
                    / torch.linalg.vector_norm(gh).clamp_min(1e-30))
        if rel > worst:
            worst, worst_key = rel, key
    loss_rel = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    steps = {}
    for name, model, p in (("card", card, params), ("cpu", cpu, cpu_params)):
        state = {"params": p, "opt": adamw_init(p)}
        _, metrics = make_train_step(model, train_shape_and_opt(1))(state,
                                                                   batch)
        steps[name] = {"loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "finite": all(bool(torch.isfinite(x).all())
                                     for x in _leaves(state["params"]))}
    emit({"phase": "train_check", "layers": cfg.n_layers,
          "tokens": [1, 64], "loss_card": float(loss_c),
          "loss_cpu": float(loss_h), "loss_rel_err": loss_rel,
          "loss_rtol": TRAIN_LOSS_RTOL, "worst_grad_rel_l2": worst,
          "worst_leaf": worst_key, "grad_tol": TRAIN_GRAD_REL_L2,
          "step": steps, "cpu_seconds": cpu_s})
    if loss_rel > TRAIN_LOSS_RTOL:
        fail(f"train_check: card loss {float(loss_c)} against the CPU's "
             f"{float(loss_h)}")
    if worst > TRAIN_GRAD_REL_L2:
        fail(f"train_check: gradient {worst_key} off the CPU's by {worst} "
             f"relative L2")
    if not (steps["card"]["finite"] and steps["cpu"]["finite"]):
        fail("train_check: a train step left non-finite parameters")
    del card, params, cpu_params, grads_c, grads_h
    torch.cuda.empty_cache()


def phase_train_restart(keep_dir):
    """Checkpoint restart on the card: MiniCPM-2B at full width, 2 layers,
    B 2 x 128, 6 steps of ``train()`` with a checkpoint every 3 steps, a
    clean run and one with a failure injected at step 4: the restarted
    run resumes from step 3 and ends within 1e-4 of the clean run's final
    loss.  Then a step with a poisoned (NaN) embedding is skipped and
    leaves every parameter, moment and the step count bitwise as they
    were.  The clean run's checkpoints go to ``keep_dir`` (the launch
    phase rescales them), the other's to a temporary directory, deleted
    after."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.fault_tolerance import FailureInjector
    from repro_torch.models import build_model
    from repro_torch.train.loop import TrainLoopConfig, train
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    model = build_model(cfg, device="cuda", remat=True)
    shape = ShapeConfig("restart", "train", 128, 2)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        for name, injector in (("clean", None),
                               ("crashy", FailureInjector(fail_at=4))):
            root = keep_dir if name == "clean" else f"{tmp}/{name}"
            loop = TrainLoopConfig(n_steps=6, ckpt_root=root,
                                   ckpt_every=3, log_every=1,
                                   opt=train_shape_and_opt(6))
            t0 = time.perf_counter()
            stats = train(model, shape, loop, injector=injector)
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "restarts": stats["restarts"],
                          "resumed_from": stats["resumed_from"],
                          "losses": [x for _, x in stats["losses"]]}
            if name != "clean":
                shutil.rmtree(root, ignore_errors=True)
    diff = abs(runs["clean"]["losses"][-1] - runs["crashy"]["losses"][-1])
    emit({"phase": "train_restart", "layers": cfg.n_layers,
          "tokens": [2, 128], "runs": runs, "final_loss_abs_diff": diff,
          "tol": RESTART_LOSS_TOL})
    if runs["crashy"]["restarts"] != 1 \
            or runs["crashy"]["resumed_from"] != [3]:
        fail(f"train_restart: expected one restart from step 3, got "
             f"{runs['crashy']}")
    if not diff <= RESTART_LOSS_TOL:
        fail(f"train_restart: final losses differ by {diff}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM_SEED + 2)
    state = init_train_state(model, gen)
    state["params"]["embed"] = state["params"]["embed"] * float("nan")
    before = [x.clone() for x in _leaves(state)]
    _, metrics = make_train_step(model, train_shape_and_opt(6))(
        state, {"tokens": np.zeros((2, 128), np.int32)})
    kept = all(torch.equal(a, b) or (torch.isnan(a).all()
                                     and torch.isnan(b).all())
               for a, b in zip(before, _leaves(state)))
    emit({"phase": "train_restart", "check": "nonfinite_skip",
          "skipped": int(metrics["skipped"]),
          "loss": float(metrics["loss"]), "state_bitwise_kept": kept,
          "opt_step": int(state["opt"]["step"])})
    if int(metrics["skipped"]) != 1 or not kept \
            or int(state["opt"]["step"]) != 0:
        fail("train_restart: the poisoned step was not skipped cleanly")
    del state, before, model
    torch.cuda.empty_cache()


def phase_launch_train():
    """``python -m repro_torch.launch.train --arch minicpm-2b --reduced
    --steps 14 --ckpt <tmp>`` as a subprocess on the card: exits 0, and its
    last logged loss is below its first."""
    import os
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               TRAIN_ARCH, "--reduced", "--steps", "14", "--ckpt", tmp]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=300)
        seconds = time.perf_counter() - t0
    losses = [float(m.group(1)) for m in
              re.finditer(r"step\s+\d+ loss (\S+)", proc.stdout)]
    emit({"phase": "launch_train", "cmd": " ".join(cmd[1:]),
          "returncode": proc.returncode, "losses": losses,
          "last_line": proc.stdout.strip().splitlines()[-1:],
          "seconds": seconds})
    if proc.returncode != 0:
        fail(f"launch_train exited {proc.returncode}: {proc.stderr[-2000:]}")
    if len(losses) < 2 or not losses[-1] < losses[0]:
        fail(f"launch_train: the loss did not drop: {losses}")
    if "on cuda" not in proc.stdout:
        fail("launch_train: the launcher did not run on the card")


SCAN_TRAIN_ARCHS = ("rwkv6-1.6b", "hymba-1.5b")
SCAN_TRAIN_STEPS = 3                   # 1 warm-up, 1 timed, 1 profiled
# the scans' Functions on the card against autograd through ref.py's
# float32 recurrences (reductions in other orders on the card)
SCAN_GRAD_REL = 1e-4
SSM_HEAD_LEAVES = ("['dt_bias']", "['d_skip']")
TRAIN_GRAD_REL_L2_SSM_HEAD = 0.25      # tests/test_torch_train_loss.py's
MOE_SHARDED_ATOL = 1e-4                # tests/test_moe_variants.py's
MOE_SHARDED_CF = 8.0                   # ... at which nothing is dropped
DRYRUN_CELL = ("granite-moe-1b-a400m", "prefill_32k")


def scan_launches_per_step(cfg) -> dict:
    """Each layer's scan (and Hymba's attention) launches twice a step
    under remat: the forward and its recompute in the backward; the
    scans' backward is plain torch."""
    want = dict.fromkeys(lm_kernel_ops(), 0)
    if cfg.rwkv:
        want["rwkv6_scan"] = 2 * cfg.n_layers
    else:
        want["ssd_scan"] = want["flash_attention"] = 2 * cfg.n_layers
    return want


def train_scan_family(arch) -> dict:
    """One scan family at full width and depth, remat, B 8 x 256, cosine
    (the launcher's schedule for it), SCAN_TRAIN_STEPS steps: exact
    launches a step, finite losses; step ms, tokens/s, the profiled
    step's busy ms, idle share and split, peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", remat=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM_SEED)
    state = init_train_state(model, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(state["params"]))
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    step_fn = make_train_step(model, AdamWConfig(
        peak_lr=TRAIN_LR, schedule="cosine", warmup_steps=5,
        total_steps=SCAN_TRAIN_STEPS))
    losses, step_ms, launches = [], [], []
    for i in range(SCAN_TRAIN_STEPS):
        batch = stream.batch(i)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == SCAN_TRAIN_STEPS - 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
        else:
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_launches())
        losses.append(float(metrics["loss"]))
        emit({"phase": "train_scans", "arch": arch, "step": i,
              "ms": step_ms[-1], "loss": losses[-1],
              "grad_norm": float(metrics["grad_norm"]),
              "launches": launches[-1]})
    want = scan_launches_per_step(cfg)
    for i, got in enumerate(launches):
        check_launches(f"train_scans {arch}", got, want,
                       f"step {i}: remat runs each layer's forward twice")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_scans {arch}: a loss is not finite: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ranges = ("rwkv6_scan_bwd", "ssd_scan_bwd", "flash_attention_bwd",
              "adamw_update")
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in ranges]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    if busy <= 0:
        fail(f"train_scans {arch}: the profiler recorded no device time")

    def named(pattern):
        return sum(e.time_range.elapsed_us() for e in device
                   if re.search(pattern, e.name)) / 1e3
    in_range = kernels_by_range(prof, ranges)
    gemm = re.compile(r"gemm|sm90_xmma|cutlass|nvjet", re.I)
    bwd_ms = {n: sum(ms for _, ms in in_range[n]) for n in ranges}
    bwd_gemm = sum(ms for n in ranges[:3] for k, ms in in_range[n]
                   if gemm.search(k))
    split = {"scan_forward": named(r"\b(wkv6|ssd)_(local|state|output)"
                                   r"_kernel\b"),
             "scan_backward": bwd_ms["rwkv6_scan_bwd"]
             + bwd_ms["ssd_scan_bwd"],
             "flash_forward": named(r"\bflash_(wgmma|fwd)_kernel\b"),
             "flash_backward": bwd_ms["flash_attention_bwd"],
             "matmuls_outside_backward_ranges":
                 named(gemm.pattern) - bwd_gemm,
             "optimizer": bwd_ms["adamw_update"]}
    split["other"] = busy - sum(split.values())
    timed_ms = step_ms[1]
    emit({"phase": "train_scans", "arch": arch, "step": "summary",
          "layers": cfg.n_layers, "params": n_params, "remat": True,
          "schedule": "cosine", "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
          "init_seconds": init_s, "steps": SCAN_TRAIN_STEPS,
          "step_ms": step_ms, "timed_step_ms": timed_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (timed_ms / 1e3),
          "profiled_step_ms": step_ms[-1],
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy / timed_ms,
          "device_ms_split": split,
          "scan_backward_share_of_busy": split["scan_backward"] / busy,
          "kernels_per_step": len(device),
          "launches_per_step": launches[0], "peak_mem_gb": peak,
          "losses": losses})
    del state, model
    torch.cuda.empty_cache()
    return {k: sum(x[k] for x in launches) for k in want}


def scan_function_grads() -> None:
    """``WKV6Scan`` and ``SSDScan`` on the card at the train path's kernel
    shapes (RWKV-6: B 8, S 256, 32 heads of 64; Hymba: 50 SSM heads of 64,
    state 16), float32: one launch a call, the forward within SCAN_TOL of
    ``ref.py``'s recurrence and every input's gradient within
    SCAN_GRAD_REL relative L2 of autograd through it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rwkv6_scan import ops as w_ops
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref
    from repro_torch.kernels.ssd_scan import ops as s_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.rwkv6 import WKV6Scan
    from repro_torch.models.ssm import SSDScan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    cases = {
        "rwkv6_scan": (WKV6Scan, wkv6_scan_ref, w_ops, [
            0.5 * randn(b, s, 32, 64), 0.5 * randn(b, s, 32, 64),
            0.5 * randn(b, s, 32, 64),
            torch.exp(-torch.exp(0.5 * randn(b, s, 32, 64) - 1.0)),
            0.3 * randn(32, 64)], [randn(b, s, 32, 64),
                                   randn(b, 32, 64, 64)]),
        "ssd_scan": (SSDScan, ssd_scan_ref, s_ops, [
            randn(b, s, 50, 64), F.softplus(0.5 * randn(b, s, 50) - 1.0),
            -torch.exp(0.5 * randn(50)), randn(b, s, 16), randn(b, s, 16)],
            [randn(b, s, 50, 64), randn(b, 50, 64, 16)]),
    }
    for name, (fn, ref, ops, inputs, cots) in cases.items():
        def grads(f):
            xs = [x.clone().requires_grad_() for x in inputs]
            y, st = f(*xs)
            ((y * cots[0]).sum() + (st * cots[1]).sum()).backward()
            return y.detach(), st.detach(), [x.grad for x in xs]
        before = ops.launches
        y, st, got = grads(fn.apply)
        launched = ops.launches - before
        y_ref, st_ref, want = grads(ref)
        torch.cuda.synchronize()
        fwd_err = max(float((y - y_ref).abs().max()),
                      float((st - st_ref).abs().max()))
        rel = [float((g - w).norm() / w.norm().clamp_min(1e-30))
               for g, w in zip(got, want)]
        emit({"phase": "train_scans", "check": "function_grads",
              "kernel": name, "shapes": [list(x.shape) for x in inputs],
              "launches": launched, "forward_max_abs_err": fwd_err,
              "forward_tol": SCAN_TOL, "grad_rel_l2": rel,
              "grad_tol": SCAN_GRAD_REL})
        if launched != 1:
            fail(f"{name}: the Function launched the kernel {launched} "
                 f"times")
        if fwd_err > SCAN_TOL or max(rel) > SCAN_GRAD_REL:
            fail(f"{name}: the Function's forward off by {fwd_err} or its "
                 f"gradients by {rel}")
        del inputs, cots, got, want


def scan_families_card_vs_cpu() -> None:
    """One remat train step's loss and gradients of RWKV-6 and Hymba at
    ``reduced_config`` (d_head 64; RWKV-6 at width 128, 2 heads), the card
    against the CPU from the same float32 parameters, per leaf within
    tests/test_torch_train_loss.py's tolerances (8%; Hymba's dt_bias and
    d_skip 25%); the loss within TRAIN_LOSS_RTOL."""
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.train.train_state import loss_and_grads
    from repro_torch.train.tree import leaves_with_paths
    for arch in SCAN_TRAIN_ARCHS:
        over = dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=64) \
            if arch.startswith("rwkv6") else dict(d_head=64)
        cfg = dataclasses.replace(reduced_config(get_config(arch)), **over)
        card = build_model(cfg, device="cuda", remat=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(LM_SEED + 3)
        params = card.init_params(gen)
        cpu = build_model(cfg, device="cpu", remat=True)
        batch = {k: torch.from_numpy(v) for k, v in TokenStream(
            cfg.vocab_size, 64, 2, seed=6).batch(0).items()}
        loss_c, grads_c = loss_and_grads(card, params, batch)
        loss_h, grads_h = loss_and_grads(cpu, _to(params, "cpu"), batch)
        worst, worst_key = -1.0, None
        for (key, gc), (_, gh) in zip(leaves_with_paths(grads_c),
                                      leaves_with_paths(grads_h)):
            tol = TRAIN_GRAD_REL_L2_SSM_HEAD \
                if key.endswith(SSM_HEAD_LEAVES) else TRAIN_GRAD_REL_L2
            rel = float(torch.linalg.vector_norm(gc.cpu() - gh)
                        / torch.linalg.vector_norm(gh).clamp_min(1e-30))
            if rel / tol > worst:
                worst, worst_key = rel / tol, (key, rel, tol)
        loss_rel = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
        emit({"phase": "train_scans", "check": "card_vs_cpu", "arch": arch,
              "reduced": True, "loss_card": float(loss_c),
              "loss_cpu": float(loss_h), "loss_rel_err": loss_rel,
              "worst_leaf_rel_l2_over_tol": worst,
              "worst_leaf": worst_key})
        if loss_rel > TRAIN_LOSS_RTOL or worst > 1.0:
            fail(f"train_scans card vs CPU {arch}: loss off by {loss_rel}, "
                 f"worst leaf {worst_key}")


def phase_train_scans() -> dict:
    """RWKV-6 1.6B and Hymba 1.5B train on the card through their scans'
    Functions, then the Functions' gradients and the card against the
    CPU -> the phase's kernel launches."""
    out = dict.fromkeys(lm_kernel_ops(), 0)
    for arch in SCAN_TRAIN_ARCHS:
        for k, n in train_scan_family(arch).items():
            out[k] += n
    scan_function_grads()
    scan_families_card_vs_cpu()
    return out


def phase_moe_sharded() -> None:
    """Qwen3-MoE's MoE layer at full width (128 experts, top-8, d 2048,
    d_ff 768), float32, 4 x 256 tokens, on a (data=1, model=every local
    card) mesh: the psum and all-to-all paths against the local
    ``moe_apply`` at the capacity factor where nothing is dropped, within
    MOE_SHARDED_ATOL; each path's ms."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import init_params
    from repro_torch.models.moe import (moe_apply, moe_apply_sharded,
                                        moe_apply_sharded_a2a, moe_params)
    cfg = get_config("qwen3-moe-30b-a3b")
    mesh = make_local_mesh(1, torch.cuda.device_count())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM_SEED + 4)
    p = init_params(moe_params(cfg), gen, torch.float32, "cuda")
    x = 0.5 * torch.randn((4, 256, cfg.d_model), generator=gen,
                          device="cuda")
    local = moe_apply(cfg, p, x, capacity_factor=MOE_SHARDED_CF)
    rows = {"local_ms": cuda_ms(lambda: moe_apply(
        cfg, p, x, capacity_factor=MOE_SHARDED_CF))}
    for name, fn in (("psum", moe_apply_sharded),
                     ("a2a", moe_apply_sharded_a2a)):
        def call():
            return fn(cfg, p, x, mesh, ("data",),
                      capacity_factor=MOE_SHARDED_CF)
        out = call()
        torch.cuda.synchronize()
        err = float((out - local).abs().max())
        rows[name] = {"max_abs_err": err, "ms": cuda_ms(call),
                      "bitwise": bool(torch.equal(out, local))}
        if not err <= MOE_SHARDED_ATOL:
            fail(f"moe_sharded {name}: off the local moe_apply by {err}")
    emit({"phase": "moe_sharded", "arch": cfg.name,
          "mesh": dict(mesh.shape), "tokens": [4, 256],
          "experts_per_shard": cfg.n_experts // mesh.shape["model"],
          "capacity_factor": MOE_SHARDED_CF, "atol": MOE_SHARDED_ATOL,
          **rows})
    del p, x, local
    torch.cuda.empty_cache()


def phase_launch(ckpt_root) -> dict:
    """``python -m repro_torch.launch.serve --arch minicpm-2b`` driven
    through its ``main`` on the card with every launch counted (flash once
    a layer a prefill, decode once a layer a step); the dry-run cell
    DRYRUN_CELL on the single-pod mesh and ``raven_dryrun``, each writing
    its JSON under ``chiprun_out/dryrun``; ``rescale_state`` of the
    train_restart phase's newest checkpoint onto a mesh over every local
    card, every leaf gathered back bitwise equal to its host restore ->
    the serve launcher's kernel launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.elastic import rescale_state
    from repro_torch.launch import dryrun, raven_dryrun
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.train_state import abstract_train_state
    from repro_torch.train.tree import leaves_with_paths
    zero_launches()
    t0 = time.perf_counter()
    served = serve_launcher.main(["--arch", TRAIN_ARCH])
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    cfg = serve_launcher.launch_config(TRAIN_ARCH, True)
    want = {**dict.fromkeys(lm_kernel_ops(), 0),
            "flash_attention": served["prefills"] * cfg.n_layers,
            "decode_attention": served["decode_steps"] * cfg.n_layers}
    emit({"phase": "launch", "entry": "serve", "arch": TRAIN_ARCH,
          "served": served, "launches": launches, "seconds": serve_s})
    check_launches("launch serve", launches, want,
                   "flash a layer a prefill, decode a layer a step")
    if not served["device"].startswith("cuda"):
        fail(f"launch serve ran on {served['device']}")

    out_dir = ROOT / "chiprun_out" / "dryrun"
    t0 = time.perf_counter()
    cell = dryrun.run_cell(*DRYRUN_CELL, False, out_dir)
    cell_s = time.perf_counter() - t0
    emit({"phase": "launch", "entry": "dryrun", "cell": list(DRYRUN_CELL),
          "status": cell["status"], "mesh": cell.get("mesh"),
          "n_chips": cell.get("n_chips"),
          "hlo_cost_per_device": cell.get("hlo_cost_per_device"),
          "roofline": cell.get("roofline"),
          "kernels_global": cell.get("cost_detail", {})
          .get("kernels_global"), "seconds": cell_s})
    if cell["status"] != "ok" or not cell["roofline"]["compute_s"] > 0:
        fail(f"launch dryrun: {cell}")
    t0 = time.perf_counter()
    raven = raven_dryrun.main(["--out", str(out_dir)])
    emit({"phase": "launch", "entry": "raven_dryrun",
          "n_rows": raven["n_rows"], "roofline": raven["roofline"],
          "hlo_cost_per_device": raven["hlo_cost_per_device"],
          "seconds": time.perf_counter() - t0})
    if raven["status"] != "ok" \
            or raven["cost_detail"]["kernels"]["tree_gemm"]["calls"] != 1:
        fail(f"launch raven_dryrun: {raven['status']}")

    rcfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    model = build_model(rcfg, device="meta", remat=True)
    like = abstract_train_state(model)
    axes = model.param_logical_axes()
    logical = {"params": axes, "opt": {"m": axes, "v": axes, "step": ()}}
    mesh = make_local_mesh(1, torch.cuda.device_count())
    t0 = time.perf_counter()
    placed, step, _ = rescale_state(ckpt_root, like, mesh,
                                    logical_axes=logical)
    torch.cuda.synchronize()
    rescale_s = time.perf_counter() - t0
    host, _, _ = restore_checkpoint(ckpt_root, like, step, device="cpu")
    rules = sharding.train_rules(mesh)
    same, n_leaves, nbytes = True, 0, 0
    for (key, want_leaf), (_, grid), axes in zip(
            leaves_with_paths(host), leaves_with_paths(placed),
            sharding.axes_leaves(logical)):
        spec = sharding.logical_to_pspec(axes, rules)
        if any(s.device.type != "cuda" for s in grid.reshape(-1)):
            fail(f"rescale_state: a shard of {key} is not on the card")
        same &= torch.equal(sharding.gather(grid, mesh, spec, "cpu"),
                            want_leaf)
        n_leaves += 1
        nbytes += want_leaf.numel() * want_leaf.element_size()
    emit({"phase": "launch", "entry": "rescale_state", "step": step,
          "mesh": dict(mesh.shape), "leaves": n_leaves, "bytes": nbytes,
          "bitwise": same, "seconds": rescale_s})
    if not same:
        fail("rescale_state: a leaf did not come back bitwise")
    del placed, host
    torch.cuda.empty_cache()
    return launches


def decode_gap_s(decode_row, lm_launches) -> float:
    """Launches x (device_ms - bound) of decode_attention over the LM
    paths timed at their shapes, in seconds: MiniCPM-2B's launches at its
    shape's row, Hymba's and Gemma-2's (both caches) split between their
    local (ring) and global layers at theirs."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    rows = decode_row["by_shape"]

    def gap(name):
        return rows[name]["device_ms"] - rows[name]["bound_ms"]

    def per_launch(arch, prefix):
        flags = build_model(get_config(arch), device="cpu")._layer_flags()
        return (sum(flags) * gap(f"{prefix}_global")
                + (len(flags) - sum(flags)) * gap(f"{prefix}_local")) \
            / len(flags)
    gemma2 = per_launch("gemma2-2b", "lm_gemma2")
    return (lm_launches["lm"]["decode_attention"] * gap("lm")
            + lm_launches["lm_hymba"]["decode_attention"]
            * per_launch("hymba-1.5b", "lm_hymba")
            + (lm_launches["lm_gemma2"]["decode_attention"]
               + lm_launches["lm_gemma2_int8"]["decode_attention"]) * gemma2
            ) / 1e3


def train_phases(flash_row, ckpt_dir) -> dict:
    """Phases 13-18 -> {phase: its kernel launches}; train_restart's clean
    checkpoints stay in ``ckpt_dir``."""
    import torch
    timed("train_kernels", phase_train_kernels, flash_row)
    torch.cuda.empty_cache()
    launches = {"train": timed("train", phase_train)}
    timed("train_check", phase_train_check)
    timed("train_restart", phase_train_restart, ckpt_dir)
    timed("launch_train", phase_launch_train)
    torch.cuda.empty_cache()
    launches["train_scans"] = timed("train_scans", phase_train_scans)
    return launches


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, then the phase's seconds on a line of its
    own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase": name, "step": "seconds",
          "seconds": time.perf_counter() - t0})
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")

    smi = phase_device()
    if sys.argv[1:] == ["--decode-cold"]:
        phase_decode_cold()
        return
    timed("build", phase_build)
    ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_rescale_")
    if sys.argv[1:] == ["--train"]:
        train_phases({"by_shape": {}}, ckpt.name)
        ckpt.cleanup()
        return

    from repro_torch.core.rules.nn_translation import CUDA_PAD
    from repro_torch.data import hospital_tables
    from repro_torch.ml import ensemble_to_gemm
    t0 = time.perf_counter()
    tables = hospital_tables(N_ROWS)
    pipe, fit_s = setup_model(tables)
    emit({"phase": "setup", "rows": N_ROWS, "fit_rows": FIT_ROWS,
          "trees": N_TREES, "depth": DEPTH, "features": FEATURES,
          "fit_seconds": fit_s, "seconds": time.perf_counter() - t0})

    ens = ensemble_to_gemm(pipe.model.trees, pad_to=CUDA_PAD)
    ens_pad8 = ensemble_to_gemm(pipe.model.trees, pad_to=8)
    cols = {c: t.column(c).cuda() for name, t in tables.items()
            if name != "prenatal_tests" for c in t.names}
    x_main = pipe.transform(cols)          # query (a)'s features, on card
    row = timed("kernels", phase_kernels, ens, ens_pad8, x_main)
    fl_row = timed("kernels_featurized_linear", phase_featurized_linear)
    torch.cuda.empty_cache()

    flash_row, decode_row = timed("kernels_attention",
                                  phase_attention_kernels)
    wkv_row, ssd_row = timed("kernels_scans", phase_scan_kernels)

    outs, launches, store, infos = timed("main", phase_main, tables, pipe)
    timed("check", phase_check, tables, pipe, outs)
    service_launches = timed("service", phase_service, store, tables, outs,
                             infos)
    del outs, store
    torch.cuda.empty_cache()
    sharded_launches = timed("sharded", phase_sharded, tables, pipe)
    torch.cuda.empty_cache()
    fl_launches = timed("fits", phase_fits, tables)
    del tables
    torch.cuda.empty_cache()

    lm_launches = {}
    for name in ("lm", "lm_rwkv", "lm_hymba"):
        lm_launches[name] = timed(name, phase_lm, name)[0]
        torch.cuda.empty_cache()
    lm_launches["lm_gemma2"], g16 = timed("lm_gemma2", phase_lm, "lm_gemma2")
    lm_launches["lm_gemma2_int8"], g8 = timed(
        "lm_gemma2_int8", phase_lm, "lm_gemma2_int8", params=g16["params"])
    timed("lm_gemma2_int8_vs_bf16", gemma2_int8_vs_bf16, g16, g8)
    del g8
    lm_launches["speculative"] = timed("speculative", phase_speculative, g16)
    del g16
    torch.cuda.empty_cache()
    lm_launches["paged"] = timed("paged", phase_paged)
    for name in ("lm_moe", "lm_qwen3_moe"):
        lm_launches[name], ctx = timed(name, phase_lm, name)
        if name == "lm_moe":
            timed("lm_moe_repeat", moe_repeat, name, ctx["model"],
                  ctx["params"], ctx["prompts"], ctx["done"])
        del ctx
        torch.cuda.empty_cache()
    lm_launches["lm_encdec"] = timed("lm_encdec", phase_encdec)
    torch.cuda.empty_cache()
    lm_launches["lm_vlm"] = timed("lm_vlm", phase_vlm)
    torch.cuda.empty_cache()

    lm_launches.update(train_phases(flash_row, ckpt.name))
    timed("moe_sharded", phase_moe_sharded)
    lm_launches["launch"] = timed("launch", phase_launch, ckpt.name)
    ckpt.cleanup()

    def on_paths(kernel, rows):
        by_path = {name: counts[kernel]
                   for name, counts in lm_launches.items() if counts[kernel]}
        return {**rows, "launches": sum(by_path.values()),
                "launches_by_path": by_path}

    decode_row["launch_weighted_gap_s"] = decode_gap_s(decode_row,
                                                       lm_launches)
    print(smi, flush=True)      # the card beside the numbers, again
    emit({"kernels": [
        {**row, "launches": launches + service_launches + sharded_launches,
         "launches_by_phase": {"main": launches,
                               "service": service_launches,
                               "sharded": sharded_launches}},
        {**fl_row, "launches": sum(fl_launches.values()),
         "launches_by_path": fl_launches},
        on_paths("flash_attention", flash_row),
        on_paths("decode_attention", decode_row),
        on_paths("rwkv6_scan", wkv_row),
        on_paths("ssd_scan", ssd_row)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
