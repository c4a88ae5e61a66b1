#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (the design-space search, campaigns, scenario
grids with SLO selection, the scalar engine and its baselines, LM serving,
fleets, design recommendation and cross-campaign transfer, LM training and
the whole LM zoo) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` from source
     (``-Xptxas -v`` shows registers, shared memory and spills);
  3. parity on the card: each kernel against its plain PyTorch version at
     the main path's shapes and a ragged batch (rtol 1e-4, atol 1e-5; the
     actor also at B = 1, the scalar engine's act path), the
     actor also with heads, biases and gate set so that both log_std clips,
     the saturated tanh and a peaked gate are reached; ``fused_mlp`` at
     [448]->3, [4096]->52, [28672]->52 and ragged B, also with bf16 input
     (3e-2); ``sumtree`` bitwise (float64 sums of final
     children) at caps 1, 8, 100, 257 and 100,000, N 1 to 1,500, with
     duplicates and a scalar broadcast; ``sumtree_sample`` (the device PER's descent)
     bitwise against its plain version and the host ``SumTree`` walk at
     caps 1 to 200,000 (the kernel's rounds of 6 levels: a partial last
     round at 8,193 and 100,000, whole ones at 200,000); the
     device PER's sampled indices and tree against the host ``SumTree`` on
     the same uniforms; the batched env step and
     the MPC rollouts on the card against the same on the CPU;
     ``flash_attention`` over the reference's sweep, ragged lengths, the
     tensor-core kernel's edges (hd 40 and 80, 1,000 keys, causal with
     Sq != Sk, a window with Sq > Sk, unaligned views) and the LM prefill
     shape, each in fp32, fp16 and bf16 (fp32 2e-5, fp16/bf16 2e-2),
     sequence 2,048 in fp32, and Mixtral's prefill of 4,608 tokens under its
     4,096-token window (q [1,32,4608,128], causal) in all three;
     ``ssm_scan`` at Jamba's
     prefill shape, ragged ones and S = 2,048 (rtol/atol 1e-4 on y and the
     final state);
  4. timing: device time of each kernel and of its plain version (200
     calls replayed from a CUDA graph, between CUDA events; the plain
     ``sumtree`` synchronises, so its eager time; the plain ``ssm_scan``,
     a loop of S steps, is 2 calls in a graph replayed 100 times and 10
     eager calls), the eager call time with the host's work, the least
     time the card could take (bytes at the memory rate, operations at
     the fp32 or fp16 rate, three times the flops at the TF32 rate for the
     kernels that compute fp32 products in 3xTF32 on the tensor cores, and
     for ``ssm_scan`` the exponentials at the
     special-function rate of the card's SMs at their maximum clock), and
     for ``flash_attention`` (the LM prefill
     shape in fp16, bf16 and fp32, sequence 2048 in fp16 and fp32, and the
     Mixtral window shape in bf16 and fp32 with the window as a boolean
     mask) PyTorch's ``scaled_dot_product_attention`` on the same inputs;
     ``actor_moe`` at B = 64, 192 and 448, ``sumtree`` at random N = 64,
     256, 448 and at the inserts' contiguous 64 and 448 leaves with a
     scalar, ``sumtree_sample`` at N = 256 and 448; and
     ``launch_floor_us``, an empty kernel in the same harness;
  5. the single-search path: ``repro_torch.launch.dse.run`` on ``cuda``
     (Llama 3.1 8B decode, seq 2048, batch 3, high-performance mode, node
     3, 4,613 episodes, 64 envs, seed 0, gate threshold ``GATE_THRESHOLD``)
     with the kernels' launch counts read around it; the chosen design is
     re-evaluated on the CPU by the plain evaluator; two short same-seed
     runs must be identical, and a gate that never opens must equal the
     ungated engine; a profile of 12 dispatches;
  6. the campaign path: the paper's grid (Llama 3.1 8B and SmolVLM, both
     modes, all 7 nodes: 28 cells in 4 mixed-node batches of 7 x 64 lanes,
     2,048 episodes per cell, default gate, checkpoint every 8 dispatches)
     through ``python -m repro_torch.launch.dse --campaign`` on ``cuda``,
     with the launch counts read around it (``sumtree`` and ``fused_mlp``
     must launch); each cell's best design re-evaluated on the CPU; a
     profile of 12 dispatches of one such batch;
  7. kill/resume on the card: a smaller campaign (SmolVLM, both modes,
     nodes 3 and 28) run once, run again and killed after its second
     checkpoint (in the high-performance batch, whose cells must have
     non-empty frontiers), then resumed with ``--resume``; its summaries
     (but their clock) and frontiers must equal the first run's, bitwise;
  8. LM serving: ``repro_torch.launch.serve``'s ``inputs`` + ``generate``
     (prefill, then greedy decode with a tail flush every 64 steps) on
     ``cuda`` for ``LM_RUNS``: Llama 3.1 8B whole (fp16), Jamba v0.1 at full
     width and one period of depth (8 layers, bf16), and both at full width
     in float32 (Llama 2 layers, Jamba 8 layers); Mixtral 8x7B at full
     width, batch 1, a 4,608-token prompt (longer than its window, so the
     prefill masks keys and the decode ring wraps), 8 layers in bf16 and 4
     in float32; the launch counts read around each run; the same weights
     again with the two kernels' plain versions put in their place: prefill
     logits within ``tol`` of max |logit| (the bf16 Jamba's and Mixtral's
     gaps printed only), and the same greedy tokens for the float32 runs;
  9. the scenario path: ``SCEN_GRID`` (Mixtral 8x7B at full width, nodes 3,
     7 and 28, both modes, dtypes native and fp8, phases decode and
     prefill, the default SLOs: 24 cells in 8 batches of 3 x 64 lanes,
     1,024 episodes) through ``python -m repro_torch.launch.dse
     --campaign`` with the launch counts read around it; where a cell found
     designs, its pick, ``ttft_ms`` and ``slo_ok`` recomputed on the CPU
     from its stored frontier by the plain evaluator; the same grid at 512
     episodes with and without the SLO gives bitwise-equal frontiers; and
     ``SLO_GRID`` (Llama 3.1 8B, high-performance, 2,048 episodes: 12
     cells in 4 batches, which find designs) held the same way, with and
     without the SLO;
 10. the scalar engine and the baselines on ``cuda`` through
     ``repro_torch.launch.dse.run`` (Llama 3.1 8B decode, node 3,
     high-performance): ``--engine scalar`` SAC for ``SCALAR_EPISODES``
     episodes (run twice: identical), ``--method random`` and ``grid`` for
     4,613; the chosen designs re-evaluated on the CPU, and the random and
     grid baselines' designs equal to a CPU run's;
 11. devices, telemetry and fleets (:func:`devices_telemetry_fleets`): (a)
     phase 5's cell with ``devices=1`` (the chunked env path, one chunk),
     its row and frontier bitwise phase 5's, and ``--devices`` one past the
     visible cards a one-line ``ap.error``; (b) the same cell traced, with
     a checkpoint every ``TRACE_CKPT_EVERY`` dispatches: row and frontier
     bitwise, ``trace.jsonl`` holding ``run_search_cells``,
     ``first_dispatch``, the ``search`` counters and one ``checkpoint``
     span a checkpoint, its Chrome export parsed; the cell untraced with
     ``devices=None`` before (a) and after (b) (held the same way), so the
     four runs' median dispatch times are read side by side; (c) phase
     6's paper grid as a W = 2 fleet on the one card (``--campaign
     --workers 2``), fingerprinting as phase 6's W = 1 campaign, with
     ``report/workers.json``, ``--status`` from the leases, and each
     worker's kernel launches read from its final lease (``actor_moe``,
     ``sumtree`` and ``sumtree_sample`` must launch in every worker);
     ``nvidia-smi``'s ``utilization.gpu`` sampled over phase 6 and over
     the fleet; (d) phase 7's grid as a supervised W = 2 fleet with worker
     1 SIGKILLed after its first checkpoint: re-dealt to a fresh slot,
     fingerprinting as phase 7's uninterrupted run, the eviction and the
     re-deal in the manifest's events;
 12. recommend serving and cross-campaign transfer
     (:func:`recommend_transfer`), over phase 6's run directory as the
     index and the donor: (a) a ``Recommender`` built on ``cuda`` (the
     index surrogate's 400 Adam steps and its calibration through
     ``fused_mlp`` at 82 -> 32 -> 16 -> 3, held against the plain version
     at the index's training-set size and ragged sizes, and timed there);
     one mixed batch of ``SERVE_QUERIES`` queries from the seed (the zoo x
     nodes x modes, raw feature vectors, budgets no archived point meets,
     TTFT caps): archive answers bitwise a CPU recommender's and the cell
     archive's select, surrogate answers those of a CPU recommender given
     the card's fitted parameters (the same design wherever the two best
     scores are more than 1e-4 apart, predictions within rtol 1e-4), one
     dispatch for the batch and none for an all-exact one; the batch's
     time beside ``SERVE_SEQUENTIAL`` sequential calls; ``score_query_batch``
     timed on the card and the CPU; ``recommend_server`` on 127.0.0.1 in a
     thread (a POST of 128 queries, ``/healthz``, ``/metrics``, a
     malformed body's structured 400); (b) ``TRANSFER_GRID`` (SmolLM 135M
     at full width, seq 2048, batch 3, both modes, all 7 nodes: 14 cells
     in 2 batches of 7 x 64 lanes, 1,024 episodes) through ``python -m
     repro_torch.launch.dse --campaign --transfer-from`` with the launch
     counts read around it (``actor_moe``, ``sumtree``, ``sumtree_sample``
     and ``fused_mlp`` must launch); its priorities, donors and ``cost_w``
     bitwise a CPU ``with_transfer`` and ``prepare_store``; the seeded
     frontiers re-evaluated on the CPU (feasible, rtol 1e-5); the same grid
     cold, each cell's best ``ppa_score`` and first frontier episode warm
     and cold printed; the warm grid as a W = 2 fleet, fingerprinting as
     the W = 1 warm run, each worker's manifest carrying the transfer
     record;
 13. LM training and the rest of the zoo (:func:`lm_training_zoo`): (a)
     ``flash_attention_backward`` against autograd over the plain version
     at SmolLM-135M's training shape (q [8,9,1,024,64], k/v 3 heads),
     Jamba's attention layer, the Whisper encoder (non-causal, 1,500),
     MiniCPM3's MLA width (hd 96), a ragged GQA case (Sq 77, Sk 131) and a
     window, each in fp32 (rtol 1e-4, atol 1e-5) and bf16 (2e-2 of the
     largest gradient), two calls bitwise equal; a reading of the loss
     sum(o^2) through both kernels' autograd Function against the plain
     version's over 8 seeds (dP and D ~100, nearly cancelling);
     ``ssm_scan_backward`` at
     Jamba's [2,512,8192] x 16, a ragged shape and Jamba's width at S =
     257 (past the second 128-step chunk's edge), with and without the
     final state's gradient (rtol 1e-4, atol 1e-5 of the largest gradient,
     and within 1e-5 of it from a float64 plain run, beside which the
     float32 plain run's own gap is printed), bitwise repeatable; both
     timed beside their bounds and the plain versions' autograd, each
     launch's device time beside the call (the scan's two, the
     attention's three), and (attention, in bf16, fp16 and fp32 at
     SmolLM's shape and bf16 at Jamba's) SDPA's backward; (b) SmolLM-135M
     at full width through ``repro_torch.launch.train`` (bf16, B = 8, S =
     1,024, ``TRAIN_STEPS`` steps): the loss falls, steps/s, tokens/s,
     peak memory and the attention launches (each period rematerialised,
     so the forward kernel twice a step a layer and the backward once,
     ``train_launches``); one more step under ``torch.profiler``: the
     top device ops, the attention backward's share of device time and the
     device idle share; kill/resume over 6 steps (3, a stop, 3
     resumed) within rtol 1e-6 of a straight run, bitwise or not printed;
     2 steps against 2 with the checkpoints patched out, losses and
     weights bitwise, both peaks printed;
     (c) Jamba at full width with 2 layers (attention + dense FFN, Mamba +
     16-expert MoE; 3.7 B parameters), 5 steps of 2 x 512, both forward
     kernels twice a step and both backward kernels once; (d) one step of
     every reduced config in float32 on the card against the same step on
     the CPU (loss within 1e-4); (e)
     ``ZOO_RUNS`` through ``serve.inputs`` + ``generate``: MiniCPM3-4B and
     Whisper medium and xLSTM 1.3B whole, Llama 3.2 Vision at full width
     with one period (5 layers, 4,096 context tokens), prefill ms, decode
     tok/s, attention launches; each again as a float32 copy of one period
     through the kernels and through the plain versions (prefill logits
     within 1e-4 of max |logit|, identical greedy tokens);
 14. the dry-run cells start (:func:`start_dryruns`) before phase 8, so
     that they run on the host's idle cores beside phases 8-13, each a
     process of
     ``python -m repro_torch.launch.dryrun --extrapolate`` on a fake
     256-rank group (fake CUDA tensors: the kernels' operators traced
     through their fake implementations, no card), ``DRYRUN_CELLS``:
     Mixtral 8x7B at train_4k and decode_32k on pod16x16, each with its
     own time limit; beside them a NCCL start whose second rank never
     comes, which must raise within its 10 s timeout;
 15. sharded training on a 1x1 NCCL mesh (:func:`sharded_training`): (a)
     SmolLM-135M whole, bf16, B = 8 x S = 1,024, ``MESH_STEPS`` steps
     through ``train(mesh=...)`` against as many on the one-device path
     with the same arguments (losses within rtol 1e-5, bitwise or not
     printed; the same ``flash_attention`` and backward launches); (b)
     Jamba at full width with 2 of 32 layers, 2 steps of 2 x 512 on the
     mesh against phase 13 (c)'s first two losses (rtol 1e-5), the
     launches of ``train_launches``, peak memory printed; (d)
     ``compressed_psum`` on the 1-rank NCCL group against the same on a
     gloo group of the CPU
     (bitwise); then each dry-run record (:func:`finish_dryruns`): peak
     bytes, flops and wire bytes a device, flops beside
     ``model_flops_analytic`` over the 256 devices;
 16. one JSON line per kernel (``fused_mlp``'s with its serving shape
     under ``serve``), then the result line.
"""
from __future__ import annotations

import ctypes
import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT = os.path.join(ROOT, "experiments", "dse", "chip_smoke")  # git-ignored
RTOL, ATOL = 1e-4, 1e-5          # kernel vs plain: fp32, other sum order
# H100 SXM published peaks (NVIDIA data sheet): fp32 without tensor cores,
# fp16/bf16 and TF32 dense on the tensor cores, and HBM3 bandwidth.  A
# kernel that computes fp32 products as 3xTF32 (hi.hi + hi.lo + lo.hi, the
# accuracy of fp32) runs three TF32 products for each: its operations term
# is 3 x flops at the TF32 rate ("tf32x3").
PEAK_FP32_FLOPS = 67e12
PEAK_HALF_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES_S = 3.35e12
# special-function unit results (ex2, rcp, ...) a clock on each SM of a
# compute-capability 9.0 card (CUDA C++ Programming Guide, arithmetic
# instruction throughput); times the SM count and the maximum SM clock
# read on the card, the least time of the exponentials
SFU_PER_SM_CLOCK = 16
EPISODES, N_ENVS, NODE, SEED = 4613, 64, 3, 0
# The default Eq.-67 threshold (0.05) never opens the screening gate in this
# cell, in the JAX reference as in the port (scripts/gate_check.py, both on
# the CPU).  The main path is driven with this threshold instead, large
# enough that the first calibration opens it, so that screen_score runs.
GATE_THRESHOLD = 1e3
# the campaign path: the paper's grid at full widths (campaign runs go to
# the git-ignored experiments/campaigns/), 2,048 episodes a cell, cut from
# the paper's 4,613 to keep the script inside its limit on a slow host
# (phase 11's W = 2 fleet runs the grid again, phase 12 reads its archives)
CAMPAIGN_ROOT = os.path.join(ROOT, "experiments", "campaigns", "chip_smoke")
GRID = dict(name="paper-grid", workloads=["llama3.1-8b", "smolvlm"],
            nodes=[3, 5, 7, 10, 14, 22, 28], modes=["high_perf", "low_power"],
            episodes=2048, lanes=64, max_envs=448, seed=0, seq_len=2048,
            batch=3, checkpoint_every=8)
# high_perf first: batch 0, where the kill lands, finds feasible designs at
# this budget (no low-power cell does), so the resumed frontiers compared
# are not empty
KILL_GRID = dict(name="kill-resume", workloads=["smolvlm"], nodes=[3, 28],
                 modes=["high_perf", "low_power"], episodes=1280, lanes=64,
                 max_envs=448, seed=0, seq_len=2048, batch=3,
                 checkpoint_every=4)
SUMTREE_CAP = 100_000
# phase 12: the mixed query batch answered over phase 6's run directory,
# the sequential calls timed beside it, and the transfer target: SmolLM
# 135M at full width, a workload the donor grid lacks, in phase 6's batch
# shape (2 batches of 7 x 64 lanes), 1,024 episodes a cell (cut from 4,613
# when rematerialised training lengthened phase 13 and the dry-run beside
# phases 8-13: its three runs of the grid took 166 s of the script)
SERVE_QUERIES = 4096
SERVE_SEQUENTIAL = 256
TRANSFER_GRID = dict(name="transfer-grid", workloads=["smollm-135m"],
                     nodes=[3, 5, 7, 10, 14, 22, 28],
                     modes=["high_perf", "low_power"], episodes=1024,
                     lanes=64, max_envs=448, seed=0, seq_len=2048, batch=3,
                     checkpoint_every=8)
# phase 11: the traced single cell's checkpoint period (3 checkpoints in
# its 72 dispatches) and the deadlines of the fleet phases
TRACE_CKPT_EVERY = 24
FLEET_TIMEOUT_S = 600
SEARCH_KERNELS = ("actor_moe", "screen_score", "sumtree", "sumtree_sample",
                  "fused_mlp")
# the scenario grid: the paper's prefill/decode x dtype axes for Mixtral 8x7B
# at full width with SLO-aware selection (the default SLOs, set in main());
# 3 cells a batch, so 8 batches of 3 x 64 lanes; 1,024 episodes, cut from
# 4,613 so that the whole script with phases 12 and 13 stays near its
# earlier length (no cell found a design at 4,613 or 2,048 either)
SCEN_GRID = dict(name="scenario-grid", workloads=["mixtral-8x7b"],
                 nodes=[3, 7, 28], modes=["high_perf", "low_power"],
                 dtypes=["native", "fp8"], phases=["decode", "prefill"],
                 episodes=1024, lanes=64, max_envs=192, seed=0, seq_len=2048,
                 batch=3, checkpoint_every=8)
# Mixtral's 93.4 GB of weights (46.7 GB in fp8) fit almost no design of the
# space (2 of 20,000 random designs feasible, all fp8 decode at 3 nm), so
# its cells' frontiers stay empty and the SLO pick is held on this grid too,
# whose cells find designs
SLO_GRID = dict(SCEN_GRID, name="slo-grid", workloads=["llama3.1-8b"],
                modes=["high_perf"], episodes=2048)
# the scalar loop synchronises with the host every env-step, so its SAC run
# is cut from the paper's 4,613 episodes (to 512, from 1,024 before phase
# 12 was added); the baselines run the full budget
SCALAR_EPISODES = 512
# LM serving: (label, arch, config changes, batch, prompt, generated tokens,
# logits tolerance as a share of max |logit|, or None for a printed
# reading).  Llama 3.1 8B fits whole (16 GB in fp16); Jamba's 32 layers
# (104 GB in bf16) do not, so it runs one period: 8 layers, 1 attention +
# 7 Mamba, 4 of them MoE (26.5 GB in bf16, 53 GB in float32).  72 tokens
# (71 decode steps) take one tail flush, at step 64.  The bf16 Jamba's
# gap between the two paths is printed, not held: bf16 keeps 3 bits fewer
# than fp16, and no bound was set for it between a sound reading and a
# faulty one.  Jamba's kernels are held by the float32 run d at 1e-4 with
# identical tokens, as Llama's are by run c.  Mixtral's 32 layers (93 GB in
# bf16) do not fit either: run e keeps 8 (23.7 GB), run f 4 in float32
# (24 GB); their 4,608-token prompt outruns the 4,096-token window.
LM_RUNS = (
    ("a", "llama3.1-8b", {}, 4, 512, 72, 2e-2),
    ("b", "jamba-v0.1-52b", dict(n_layers=8), 4, 512, 72, None),
    ("c", "llama3.1-8b", dict(n_layers=2, param_dtype="float32"), 4, 512,
     32, 1e-4),
    ("d", "jamba-v0.1-52b", dict(n_layers=8, param_dtype="float32"), 4, 512,
     32, 1e-4),
    ("e", "mixtral-8x7b", dict(n_layers=8), 1, 4608, 72, None),
    ("f", "mixtral-8x7b", dict(n_layers=4, param_dtype="float32"), 1, 4608,
     32, 1e-4),
)
# the LM kernels' parity cases: (B, H, Hk, Sq, Sk, hd, causal, window) from
# test_kernels.py's sweep, ragged lengths, the fp16/bf16 kernel's edges (hd
# zero-padded to 64 and 128, several 64-key tiles with a ragged last one,
# causal with Sq != Sk, a window across 64-key tiles with Sq > Sk), and the
# LM prefill's shape
ATTN_CASES = [(1, 4, 2, 256, 256, 64, True, 0),
              (2, 8, 8, 128, 128, 128, True, 0),
              (1, 2, 1, 256, 256, 64, False, 0),
              (1, 4, 4, 256, 256, 64, True, 64),
              (2, 16, 4, 128, 128, 64, True, 0),
              (2, 4, 2, 33, 33, 128, True, 0),
              (1, 8, 2, 200, 200, 128, True, 0),
              (1, 4, 2, 40, 9, 32, False, 4),
              (1, 4, 2, 100, 100, 40, True, 0),
              (1, 4, 2, 150, 150, 80, True, 0),
              (1, 4, 2, 1000, 1000, 128, True, 0),
              (1, 4, 2, 300, 170, 64, True, 0),
              (1, 4, 2, 70, 300, 128, True, 0),
              (1, 4, 2, 200, 100, 64, False, 70),
              (1, 4, 2, 200, 100, 80, True, 70)]
ATTN_LM = (4, 32, 8, 512, 512, 128, True, 0)
ATTN_2048 = (1, 32, 8, 2048, 2048, 128, True, 0)   # the paper's seq_len
ATTN_WINDOW = (1, 32, 8, 4608, 4608, 128, True, 4096)   # Mixtral, runs e/f
ATTN_TOL = {torch.float32: 2e-5, torch.float16: 2e-2, torch.bfloat16: 2e-2}
SSM_CASES = [(4, 512, 8192, 16), (2, 33, 200, 16), (3, 1, 8, 5),
             (1, 200, 40, 8), (2, 17, 130, 13), (1, 2048, 1024, 16)]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def _events_ms(run, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def call_ms(fn, n: int = 200, warm: int = 20) -> float:
    """Time of one eager call, host work included: CUDA events around
    ``n`` back-to-back calls (the rate a Python caller sees)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, n)


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's launch
    and Python work drop out (200 calls in all)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / calls


FLOOR_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def start_floor_build(nvcc: str, flags, out_dir: str):
    """Start ``nvcc`` on an empty kernel, the yardstick of what any launch
    costs in phase 4's harness; returns the process and the library."""
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "launch_floor.cu")
    lib = os.path.join(out_dir, "liblaunch_floor.so")
    with open(src, "w") as f:
        f.write(FLOOR_CU)
    proc = subprocess.Popen([nvcc, *flags, "-shared", "-o", lib, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def load_floor(proc, lib: str):
    """Wait for :func:`start_floor_build`; returns a function that launches
    the empty kernel on the current stream."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed for the empty kernel:\n{out}")
    cdll = ctypes.CDLL(lib)
    cdll.empty_launch.argtypes = [ctypes.c_void_p]
    cdll.empty_launch.restype = ctypes.c_int

    def launch():
        rc = cdll.empty_launch(torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty_launch: CUDA error {rc} at launch")
    return launch


SFU_RATE = None   # results a second, set from the card in main()


OPS_TERMS = {"fp32": lambda f: f / PEAK_FP32_FLOPS,
             "half": lambda f: f / PEAK_HALF_FLOPS,
             "tf32x3": lambda f: 3 * f / PEAK_TF32_FLOPS}


def bound_ms(flops: float, nbytes: float, unit: str = "fp32",
             sfu_ops: float = 0.0):
    """The least time of a call (ms), what bounds it ("operations" or
    "bytes") and which term: the flops as ``unit`` ("fp32", "half" or
    "tf32x3", see ``OPS_TERMS``), "sfu" (``sfu_ops`` special-function
    results at ``SFU_RATE``) or "bytes"."""
    terms = {unit: OPS_TERMS[unit](flops), "bytes": nbytes / PEAK_BYTES_S}
    if sfu_ops:
        terms["sfu"] = sfu_ops / SFU_RATE
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations",
            term)


def actor_work(b: int, w_bytes: int) -> tuple:
    """FLOPs (2 per multiply-add) and bytes (each input read once, each
    output written once) of one ``actor_moe`` call on B rows."""
    s, h, e, no = 52, 256, 4, 80
    flops = b * (2 * s * e + e * 2 * (s * h + h * h + h * no) + 2 * e * no)
    return flops, w_bytes + b * s * 4 + b * (20 + 30 + 30 + 4) * 4


def screen_work(b: int, k: int, w_bytes: int) -> tuple:
    """The same for one ``screen_score`` call on B envs x K candidates."""
    flops = b * k * 2 * (82 * 128 + 128 * 64 + 64 * 3)
    return flops, w_bytes + (b * 52 + b * k * 30 + b * 3 + b * k) * 4


def mlp_work(b: int, d_out: int, x_bytes: int, h1: int = 128,
             h2: int = 64) -> tuple:
    """The same for one ``fused_mlp`` call, 82 -> h1 -> h2 -> d_out."""
    w = 82 * h1 + h1 + h1 * h2 + h2 + h2 * d_out + d_out
    flops = b * 2 * (82 * h1 + h1 * h2 + h2 * d_out)
    return flops, 4 * w + b * 82 * x_bytes + b * d_out * x_bytes


def query_work(q: int, c: int, f: int, d: int, h1: int, h2: int) -> tuple:
    """The same for one ``score_query_batch`` call: layer 1 split as
    q @ W1[:F] and cand @ W1[F:], layers 2 and 3 on Q x C rows, the score,
    the budget mask and the argmin (about 10 operations a (query,
    candidate) pair); q, cand, the weights and the budgets read once, the
    picks, predictions and flags written once."""
    flops = 2.0 * (q * f * h1 + c * d * h1) + q * c * (
        2.0 * (h1 * h2 + h2 * 3) + 2 * h1 + 10)
    w = (f + d) * h1 + h1 + h1 * h2 + h2 + 3 * h2 + 3
    return flops, 4 * (q * f + c * d + w + 5 * q) + q * (8 + 12 + 1)


def sumtree_work(idx: np.ndarray, cap: int, scalar: bool) -> tuple:
    """The same for one ``sumtree`` call on these indices: every touched
    node (the distinct leaves and their distinct ancestors) read and
    written once as a float64, plus the int64 indices and the values."""
    nodes = set()
    for i in np.unique(idx) + cap:
        i = int(i)
        while i >= 1 and i not in nodes:
            nodes.add(i)
            i //= 2
    return 0.0, 16 * len(nodes) + 8 * len(idx) + (8 if scalar else
                                                     8 * len(idx))


def sample_work(n: int, cap: int) -> tuple:
    """The same for one ``sumtree_sample`` call of N samples: one float64
    node read per level per sample (the root once), the uniforms read and
    the int64 indices written; one compare and at most one subtraction per
    level."""
    levels = max(2 * cap - 1, 1).bit_length() - 1
    return 2.0 * n * levels, 8 * n * levels + 8 + 8 * n + 8 * n


def attention_work(B, H, Hk, Sq, Sk, hd, causal, window, elt) -> tuple:
    """FLOPs and bytes of one ``flash_attention`` call: 2 x hd for q.k and
    2 x hd for p.v per visible (query, key) pair (the pairs these lengths
    and masks leave), q, k and v read once and o written once."""
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    visible = np.ones((Sq, Sk), bool)
    if causal:
        visible &= kp <= qp
    if window > 0:
        visible &= kp > qp - window
    flops = 4.0 * hd * B * H * int(visible.sum())
    return flops, elt * hd * (2 * B * H * Sq + 2 * B * Hk * Sk)


def ssm_work(B, S, D, N) -> tuple:
    """The same for one ``ssm_scan`` call: per (b, t, d, n) one product for
    dt * a, two products and a sum for h, a product and a sum for y, and
    one exponential (a special-function result, the third element); per
    (b, t, d) dt * x; dt, x and y, B and C, A and the final state each
    once, in float32."""
    flops = B * S * D * (6.0 * N + 1)
    return (flops, 4 * (3 * B * S * D + 2 * B * S * N + D * N + B * D * N),
            float(B * S * D * N))


class UtilSampler:
    """``nvidia-smi``'s ``utilization.gpu`` (the share of each sample
    period in which a kernel ran) every 500 ms while the block runs, from
    one ``nvidia-smi -lms`` process stopped on exit.  ``mean`` is None when
    no sample came (no ``nvidia-smi``)."""

    def __enter__(self) -> "UtilSampler":
        self.samples, self.mean = [], None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.samples = [float(v) for v in out.split()
                        if v.replace(".", "", 1).isdigit()]
        if self.samples:
            self.mean = sum(self.samples) / len(self.samples)

    def describe(self) -> str:
        if self.mean is None:
            return "utilization.gpu not measured"
        return (f"utilization.gpu mean {self.mean:.1f}% over "
                f"{len(self.samples)} samples of 500 ms")


def devices_telemetry_fleets(device, wl, single, grid_path, grid_name,
                             w1_root, kill_path, kill_name, kill_w1_root,
                             root, w1_wall, w1_util,
                             episodes=EPISODES) -> dict:
    """Phase 11 (see the module docstring) on ``device``: ``single`` is
    phase 5's (row, SearchResult) of ``wl``'s cell, ``grid_path`` and
    ``w1_root`` phase 6's grid file and run directory (its wall ``w1_wall``
    and ``UtilSampler`` ``w1_util``), ``kill_path`` and ``kill_w1_root``
    phase 7's; fleets and traces go under ``root``.  Returns each path's
    launch counts (the fleets' summed from their workers' final leases).
    ``device="cpu"`` with cut budgets rehearses it without a card (no
    launch is then required)."""
    import shutil

    from repro_torch.campaign import CampaignSpec, CampaignStore
    from repro_torch.campaign import fingerprint as campaign_fingerprint
    from repro_torch.campaign.distrib import worker_root, worker_roots
    from repro_torch.campaign.store import read_lease
    from repro_torch.core.search import SearchConfig, run_search_cells
    from repro_torch.kernels import ops
    from repro_torch.launch import dse
    from repro_torch.launch import fleet as fleet_mod
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.metrics import snapshot_value

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    row0, res0 = single
    # rows as JSON, so that a NaN (no feasible design) equals itself
    strip = lambda row: json.dumps({k: v for k, v in row.items()
                                    if k != "wall_s"}, sort_keys=True)
    entries = lambda r: json.dumps([e.to_dict() for e in r.archive.entries])
    median_ms = lambda r: 1e3 * float(np.median(r.dispatch_s))
    paths = {}

    def held(label, row, res):
        if strip(row) != strip(row0) or entries(res) != entries(res0) \
                or [t.__dict__ for t in res.trace] != [
                    t.__dict__ for t in res0.trace]:
            fail(f"{label}: the row or frontier differs from phase 5's")

    def single_run(label, devices=None):
        """Phase 5's cell through ``dse.run``, held against phase 5's."""
        res_l = []
        ops.reset_launch_counts()
        sync()
        t = time.time()
        row, = dse.run("llama3.1-8b", nodes=[NODE],
                       mode="high-performance", episodes=episodes,
                       method="sac", out_dir=os.path.join(root, label),
                       seed=SEED, seq_len=2048, batch=3, engine="vec",
                       n_envs=N_ENVS, gate_threshold=GATE_THRESHOLD,
                       devices=devices, device=device, results=res_l)
        sync()
        wall, counts = time.time() - t, ops.launch_counts()
        held(label, row, res_l[0])
        return res_l[0], wall, counts

    # untraced devices=None runs before (a) and after (b), so that the
    # dispatch times of (a) and (b) are read beside runs of the same
    # process and moment, not only phase 5's
    plain_a, _, _ = single_run("plain-before")
    # (a) devices=1: the chunked env path with one chunk
    res_d, wall_a, paths["devices"] = single_run("devices=1", devices=1)
    log(f"devices=1: row and frontier ({len(res0.archive)} entries) "
        f"bitwise phase 5's; wall {wall_a:.3f} s, median dispatch "
        f"{median_ms(res_d):.3f} ms (plain before it "
        f"{median_ms(plain_a):.3f}, phase 5 {median_ms(res0):.3f}); "
        f"launches {json.dumps(paths['devices'])}")
    n_bad = torch.cuda.device_count() + 1
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dse", "--devices",
         str(n_bad), "--device", "cuda"], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
    err = out.stderr.strip().splitlines()
    if out.returncode != 2 or "Traceback" in out.stderr or not err \
            or f"--devices {n_bad}:" not in err[-1]:
        fail(f"--devices {n_bad} on {n_bad - 1} card(s): exit "
             f"{out.returncode}, stderr {out.stderr[-400:]!r}")
    log(f"--devices {n_bad} on {n_bad - 1} card(s): exit 2, {err[-1]!r}")

    # (b) the same cell traced, with checkpoints
    tdir = os.path.join(root, "traced")
    tracer = obs_trace.Tracer(os.path.join(tdir, obs_trace.TRACE_NAME),
                              proc="chip_smoke")
    obs_trace.install_tracer(tracer)
    ops.reset_launch_counts()
    sync()
    t = time.time()
    try:
        res_t = run_search_cells(
            wl, [NODE], high_perf=True, search=SearchConfig(
                episodes=episodes, seed=SEED, gate_threshold=GATE_THRESHOLD),
            lanes_per_cell=N_ENVS, checkpoint_dir=os.path.join(tdir, "ckpt"),
            checkpoint_every=TRACE_CKPT_EVERY, device=device)[0]
        sync()
    finally:
        obs_trace.install_tracer(None)
        tracer.close()
    wall_b, paths["traced"] = time.time() - t, ops.launch_counts()
    held("traced", dse.result_row(res_t), res_t)
    recs = obs_trace.read_trace(os.path.join(tdir, obs_trace.TRACE_NAME))
    names = [r.get("name") for r in recs]
    steps = [r["args"]["step"] for r in recs if r.get("name") == "checkpoint"]
    want_steps = list(range(TRACE_CKPT_EVERY, len(res_t.dispatch_s),
                            TRACE_CKPT_EVERY))
    n_counters = sum(r.get("name") == "search" and r.get("ph") == "C"
                     for r in recs)
    if names.count("run_search_cells") != 1 \
            or names.count("first_dispatch") != 1 or not n_counters \
            or steps != want_steps:
        fail(f"traced: trace holds run_search_cells x"
             f"{names.count('run_search_cells')}, first_dispatch x"
             f"{names.count('first_dispatch')}, {n_counters} search "
             f"counters, checkpoint steps {steps} (want {want_steps})")
    doc = json.load(open(obs_export.export_run(tdir)))
    plain_b, _, _ = single_run("plain-after")
    log(f"traced: row and frontier bitwise phase 5's; trace.jsonl "
        f"{len(recs)} records (run_search_cells 1, first_dispatch 1, "
        f"{n_counters} search counters, checkpoints at {steps}); Chrome "
        f"export {len(doc['traceEvents'])} events; wall {wall_b:.3f} s")
    log(f"median dispatch (ms): untraced before {median_ms(plain_a):.3f}, "
        f"devices=1 {median_ms(res_d):.3f}, traced {median_ms(res_t):.3f}, "
        f"untraced after {median_ms(plain_b):.3f}; phase 5 "
        f"{median_ms(res0):.3f}")

    def lease_counts(froot):
        """{worker dir: {kernel: launches}} from the final leases."""
        return {os.path.basename(w): {
            k: int(snapshot_value((read_lease(w) or {}).get("metrics"),
                                  "counters", "kernel_launches_total",
                                  {"kernel": k}, default=0))
            for k in ops.KERNELS} for w in worker_roots(froot)}

    def summed(per_worker):
        return {k: sum(c[k] for c in per_worker.values())
                for k in ops.KERNELS}

    # (c) the paper grid as a W=2 fleet on the one card
    froot = os.path.join(root, "fleet")
    with UtilSampler() as util:
        t = time.time()
        dse.main(["--campaign", grid_path, "--workers", "2",
                  "--campaign-root", froot, "--device", device])
        fleet_wall = time.time() - t
    froot = os.path.join(froot, grid_name)
    fstore = CampaignStore.open(froot)
    if not fstore.all_done() or campaign_fingerprint(fstore) != \
            campaign_fingerprint(CampaignStore.open(w1_root)):
        fail("fleet: the W=2 fleet's fingerprint differs from phase 6's "
             "W=1 campaign")
    rep = json.load(open(os.path.join(froot, "report", "workers.json")))
    per_worker = lease_counts(froot)
    paths["fleet"] = summed(per_worker)
    log(f"fleet: W=2 fingerprint == phase 6's W=1 over "
        f"{len(fstore.manifest['cells'])} cells; wall W=2 "
        f"{fleet_wall:.3f} s, W=1 (phase 6) {w1_wall:.3f} s; "
        f"{util.describe()} (W=1: {w1_util.describe()})")
    for r in rep["workers"]:
        log(f"fleet workers.json: {json.dumps(r)}")
    for line in fleet_mod.render_status(
            fleet_mod.fleet_status(froot)).splitlines():
        log(f"fleet --status: {line}")
    for w, c in sorted(per_worker.items()):
        log(f"fleet {w} launches: {json.dumps(c)}")
        missing = [k for k in ("actor_moe", "sumtree", "sumtree_sample")
                   if c[k] <= 0]
        if on_card and missing:
            fail(f"fleet {w}: {missing} never launched")
    if len(per_worker) != 2 or rep["events"]:
        fail(f"fleet: {len(per_worker)} workers, events {rep['events']}")

    # (d) chaos: SIGKILL worker 1 after its first checkpoint
    croot = os.path.join(root, "chaos", kill_name)
    h = fleet_mod.launch_fleet(croot, CampaignSpec.from_file(kill_path),
                               workers=2, progress=log, device=device)
    ckpts = os.path.join(worker_root(croot, 1), "ckpt", "*", "step_*")
    deadline = time.time() + FLEET_TIMEOUT_S
    while time.time() < deadline and not glob.glob(ckpts) \
            and h.procs[1].poll() is None:
        time.sleep(0.02)
    if h.procs[1].poll() is not None or not glob.glob(ckpts):
        fail("chaos: worker 1 wrote no checkpoint before it ended")
    killed_at = sorted(os.path.basename(p) for p in glob.glob(ckpts))
    h.kill(1, signal.SIGKILL)
    cstore = h.wait(timeout=FLEET_TIMEOUT_S)
    events = cstore.manifest["fleet"]["events"]
    evict = [e for e in events if e["kind"] == "evict"
             and e["worker"] == 1]
    redeal = [e for e in events if e["kind"] == "redeal"
              and e["from_worker"] == 1]
    if not (evict and redeal) or redeal[0]["to_worker"] in (0, 1):
        fail(f"chaos: events {events}")
    if campaign_fingerprint(cstore) != campaign_fingerprint(
            CampaignStore.open(kill_w1_root)):
        fail("chaos: the healed fleet's fingerprint differs from phase "
             "7's uninterrupted run")
    paths["chaos"] = summed(lease_counts(croot))
    log(f"chaos: worker 1 SIGKILLed at {killed_at}; evicted "
        f"({evict[0]['reason']}), batch(es) {redeal[0]['batches']} "
        f"re-dealt to slot {redeal[0]['to_worker']}; fingerprint == phase "
        f"7's uninterrupted run; launches {json.dumps(paths['chaos'])}")
    return paths


def mixed_queries(index, n: int, seed: int) -> list:
    """``n`` recommendation queries made from ``seed``: every zoo arch x
    node x mode, then in turn raw feature vectors, budgets below every
    archived point of a cell, and TTFT caps (decode or prefill) with drawn
    weights."""
    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.launch.recommend import Query, split_cell_id
    from repro_torch.ppa.nodes import NODES
    rng = np.random.default_rng(seed)
    modes = ("high_perf", "low_power")
    grid = [dict(arch=a, node_nm=nd, mode=m) for a in sorted(ARCH_IDS)
            for nd in NODES for m in modes]
    floors = {cid: min(e.power_mw for e in ar.entries)
              for cid, ar in sorted(index.cells.items())}
    cids = sorted(floors)
    out = list(grid)
    while len(out) < n:
        kind = len(out) % 3
        if kind == 0:
            out.append(dict(
                node_nm=int(rng.choice(NODES)), mode=str(rng.choice(modes)),
                features={"flops_per_token": float(10 ** rng.uniform(8, 12)),
                          "weight_mb": float(10 ** rng.uniform(1, 5)),
                          "seq_len": int(rng.choice([512, 2048, 8192])),
                          "batch": int(rng.integers(1, 9)),
                          "d_model": int(rng.choice([576, 2048, 8192]))}))
        elif kind == 1:
            cid = cids[int(rng.integers(len(cids)))]
            arch, node, mode = split_cell_id(cid)
            out.append(dict(arch=arch, node_nm=node, mode=mode,
                            power_budget_mw=floors[cid]
                            * float(rng.uniform(0.1, 0.9))))
        else:
            w = rng.dirichlet(np.ones(3))
            out.append(dict(grid[int(rng.integers(len(grid)))],
                            phase=str(rng.choice(["decode", "prefill"])),
                            max_ttft_ms=float(10 ** rng.uniform(0, 4)),
                            w_perf=float(w[0]), w_power=float(w[1]),
                            w_area=float(w[2])))
    return [Query(**d) for d in out[:n]]


def query_json(q) -> dict:
    """A query as the server's POST body holds it (no None, no inf)."""
    out = {}
    for f in dataclasses.fields(q):
        v = getattr(q, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v.tolist()
        elif v is not None and v != np.inf:
            out[f.name] = v
    return out


def plain_score_gaps(params, q, cand, w, budget, perf) -> np.ndarray:
    """The gap between the two best (budget-masked, where a candidate is
    within budget) scores of each query, from ``score_query_batch``'s
    arithmetic in plain PyTorch on the CPU."""
    gelu = lambda t: torch.nn.functional.gelu(t, approximate="tanh")
    p = {k: {kk: v.cpu() for kk, v in d.items()} for k, d in params.items()}
    q, cand, w, budget, perf = (t.cpu() for t in (q, cand, w, budget, perf))
    f = q.shape[1]
    w1 = p["l1"]["w"]
    h = gelu((q @ w1[:f])[:, None] + (cand @ w1[f:])[None] + p["l1"]["b"])
    h = gelu(h @ p["l2"]["w"] + p["l2"]["b"])
    pred = torch.clamp_min(h @ p["head"]["w"] + p["head"]["b"], 0.0)
    score = (w[:, None, 1] * pred[..., 0] + w[:, None, 2] * pred[..., 2]
             - w[:, None, 0] * pred[..., 1])
    ok = ((torch.expm1(pred[..., 0]) <= budget[:, None])
          & (torch.expm1(pred[..., 1]) >= perf[:, None]))
    masked = torch.where(ok.any(1, keepdim=True) & ~ok,
                         torch.full_like(score, float("inf")), score)
    if masked.shape[1] < 2:
        return np.full(masked.shape[0], np.inf)
    top = torch.topk(masked, 2, dim=1, largest=False).values
    return (top[:, 1] - top[:, 0]).numpy()


def recommend_transfer(device, index_root, root, timed=None,
                       n_queries=SERVE_QUERIES, n_seq=SERVE_SEQUENTIAL,
                       grid=TRANSFER_GRID) -> dict:
    """Phase 12 (see the module docstring) on ``device`` over phase 6's run
    directory ``index_root``; campaigns go under ``root``.  ``timed`` is
    phase 4's timing harness (None: nothing timed).  Returns the launch
    counts of the recommend path (the index build and the batch), the warm
    transfer campaign and its W = 2 fleet (summed from the workers' final
    leases), and the index's training-set size with ``fused_mlp``'s
    largest error and its launches at the serving widths.  ``device="cpu"`` with cut budgets rehearses it without a
    card (no launch is then required)."""
    import shutil
    import threading
    import urllib.error
    import urllib.request

    from repro_torch.campaign import CampaignSpec, CampaignStore
    from repro_torch.campaign import fingerprint as campaign_fingerprint
    from repro_torch.campaign import transfer as transfer_mod
    from repro_torch.campaign.distrib import worker_roots
    from repro_torch.campaign.planner import plan_cached
    from repro_torch.campaign.store import read_lease
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, policy_mlp
    from repro_torch.launch import dse
    from repro_torch.launch.recommend import ArchiveIndex, Recommender
    from repro_torch.launch.serve import recommend_server
    from repro_torch.models import cost_model as cm
    from repro_torch.obs.metrics import snapshot_value
    from repro_torch.ppa import analytic as an
    from repro_torch.ppa import config_space as cs
    from repro_torch.ppa import surrogate as sur
    from repro_torch.ppa.nodes import node_params
    from repro_torch.workload.extract import extract

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    paths = {}
    # fused_mlp launches at the serving widths (the index surrogate and the
    # cost model), counted apart from the online surrogate's
    serve_launches = [0]
    real_cuda = policy_mlp.fused_mlp_cuda

    def counting_cuda(x, w1, *rest):
        serve_launches[0] += w1.shape[-1] == sur.SERVE_HIDDEN[0]
        return real_cuda(x, w1, *rest)

    # (a) the index, its surrogate on the card, one mixed batch
    index = ArchiveIndex.build([index_root])
    x_idx, _ = index.training_set()
    n_rows = x_idx.shape[0]
    log(f"recommend: index over {len(index.cells)} cells, {n_rows} "
        f"training rows, {len(index.candidates)} candidates")
    ops.reset_launch_counts()
    sync()
    t = time.time()
    policy_mlp.fused_mlp_cuda = counting_cuda
    try:
        rec = Recommender(index, device=device)
    finally:
        policy_mlp.fused_mlp_cuda = real_cuda
    sync()
    build_s, build_counts = time.time() - t, ops.launch_counts()
    log(f"recommend: Recommender build (400 Adam steps + the calibration) "
        f"{build_s:.3f} s on {device}, resid_var "
        f"{rec.surrogate.resid_var:.6f}; launches {json.dumps(build_counts)}")
    if on_card and build_counts["fused_mlp"] <= 0:
        fail("recommend: the index fit launched no fused_mlp")
    ws = [rec.surrogate.params[k][kk] for k in ("l1", "l2", "head")
          for kk in ("w", "b")]
    # the serving widths at the index's N (its own rows) and ragged N
    serve_err = 0.0
    for b in (n_rows, max(1, n_rows - 7), 333):
        x = np.random.default_rng(b).normal(size=(b, 82)).astype(np.float32)
        x[:min(b, n_rows)] = x_idx[:b]
        x = torch.as_tensor(x, device=device)
        with torch.no_grad():
            got = policy_mlp.fused_mlp(x, *ws)
            want = policy_mlp.fused_mlp_plain(x, *ws)
        err = float((got - want).abs().max())
        serve_err = max(serve_err, err)
        log(f"parity fused_mlp [{b},82]->32->16->3 (the index "
            f"surrogate's fitted weights): max abs err {err:.3e}")
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"fused_mlp at the serving widths, B={b}, disagrees with "
                 f"the plain version (max abs err {err:.3e})")
    cpu_params = {k: {kk: v.cpu() for kk, v in d.items()}
                  for k, d in rec.surrogate.params.items()}
    cpu_rec = Recommender(index, fit_steps=0, params=cpu_params,
                          device="cpu")
    queries = mixed_queries(index, n_queries, SEED)
    captured = []
    real_score = sur.score_query_batch

    def capturing(*args):
        captured.append(args)
        return real_score(*args)

    ops.reset_launch_counts()
    d0 = rec.n_dispatches
    sync()
    t = time.time()
    answers = rec.recommend_batch(queries)
    batch_s = time.time() - t
    paths["recommend"] = {k: build_counts[k] + v
                          for k, v in ops.launch_counts().items()}
    sur.score_query_batch = capturing
    try:
        cpu_answers = cpu_rec.recommend_batch(queries)
    finally:
        sur.score_query_batch = real_score
    if rec.n_dispatches - d0 != 1 or cpu_rec.n_dispatches != 1:
        fail(f"recommend: the mixed batch made {rec.n_dispatches - d0} "
             "dispatches, not 1")
    gaps = plain_score_gaps(*captured[0])
    store6 = CampaignStore.open(index_root)
    n_exact = n_tie = row = 0
    for q, a, c in zip(queries, answers, cpu_answers):
        if a.source != c.source or a.cell_id is None:
            fail(f"recommend: {q} answered from {a.source} on the card, "
                 f"{c.source} on the CPU")
        if a.source == "archive":
            n_exact += 1
            if a.to_dict() != c.to_dict():
                fail(f"recommend: archive answer to {q} differs from the "
                     "CPU's")
            if q.power_budget_mw == np.inf and not q.min_perf_gops \
                    and not q.min_tok_s:
                e = store6.load_archive(a.cell_id).select(*q.weights)
                if not (np.array_equal(a.cfg, e.cfg)
                        and a.ppa_score == e.ppa_score):
                    fail(f"recommend: archive answer to {q} is not the "
                         "cell archive's select")
            continue
        gap = gaps[row]
        row += 1
        if gap <= 1e-4:
            n_tie += 1
            continue
        if not np.array_equal(a.cfg, c.cfg) or not np.allclose(
                [a.power_mw, a.perf_gops, a.area_mm2],
                [c.power_mw, c.perf_gops, c.area_mm2], rtol=1e-4):
            fail(f"recommend: surrogate answer to {q} differs from the "
                 f"CPU's (score gap {gap:.3e})")
    d1 = rec.n_dispatches
    exact_qs = [q for q, a in zip(queries, answers)
                if a.source == "archive"]
    rec.recommend_batch(exact_qs)
    if rec.n_dispatches != d1:
        fail("recommend: an all-exact batch made a dispatch")
    log(f"recommend: {len(queries)} queries, {n_exact} exact (== the CPU "
        f"recommender's, bitwise), {len(queries) - n_exact} by the "
        f"surrogate in 1 dispatch ({n_tie} with the two best scores within"
        f" 1e-4; the rest the CPU's picks, predictions rtol 1e-4); an "
        f"all-exact batch of {len(exact_qs)}: 0 dispatches")
    reps = []
    for _ in range(5):
        sync()
        t = time.time()
        rec.recommend_batch(queries)
        reps.append(time.time() - t)
    t = time.time()
    for q in queries[:n_seq]:
        rec.recommend(q)
    seq_s = (time.time() - t) / n_seq
    per_q = float(np.median(reps)) / len(queries)
    log(f"recommend: fused batch of {len(queries)}: first {batch_s:.4f} s, "
        f"median of 5 {float(np.median(reps)):.4f} s ({1e6 * per_q:.2f} "
        f"us a query); {n_seq} sequential recommend calls "
        f"{1e3 * seq_s:.4f} ms a query; ratio {seq_s / per_q:.1f}x "
        "(recorded, not gated)")
    if timed is not None:
        x_dev = torch.as_tensor(x_idx, device=device)
        timed(("fused_mlp", "serve"), f"[{n_rows},82]->32->16->3",
              lambda: policy_mlp.fused_mlp_cuda(x_dev, *ws),
              lambda: policy_mlp.fused_mlp_plain(x_dev, *ws),
              mlp_work(n_rows, 3, 4, 32, 16), unit="tf32x3")
        args = captured[0]
        card_args = [rec.surrogate.params] + [a.to(device)
                                              for a in args[1:]]
        qn, cn = args[1].shape[0], args[2].shape[0]
        card_ms = device_ms(lambda: sur.score_query_batch(*card_args),
                            calls=5, replays=4)
        t = time.perf_counter()
        for _ in range(5):
            sur.score_query_batch(*args)
        cpu_ms = 1e3 * (time.perf_counter() - t) / 5
        bnd, by, term = bound_ms(*query_work(qn, cn, 52, 30, 32, 16))
        log(f"time score_query_batch Q={qn} C={cn}: card {card_ms:.5f} ms "
            f"(device, CUDA graph) bound {bnd:.5f} ms ({by}, {term}); "
            f"CPU {cpu_ms:.3f} ms; plain PyTorch products, no kernel")

    # the HTTP server, in a thread on a free local port
    box, ready = {}, threading.Event()
    th = threading.Thread(target=recommend_server, args=([index_root],),
                          kwargs=dict(host="127.0.0.1", port=0,
                                      recommender=rec,
                                      on_ready=lambda srv: (box.update(
                                          srv=srv), ready.set())),
                          daemon=True)
    th.start()
    if not ready.wait(60):
        fail("serve: the recommendation server did not come up")
    url = f"http://127.0.0.1:{box['srv'].server_port}"
    sample = queries[:128]

    def post(body: bytes):
        req = urllib.request.Request(
            url + "/recommend", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    try:
        body = json.dumps({"queries": [query_json(q)
                                       for q in sample]}).encode()
        t = time.time()
        code, reply = post(body)
        rtt = time.time() - t
        want = rec.recommend_batch(sample)
        if code != 200 or reply["dispatches"] != 1 or [
                a["source"] for a in reply["answers"]] != [
                a.source for a in want] or any(
                a["source"] == "archive" and a != w.to_dict()
                for a, w in zip(reply["answers"], want)):
            fail(f"serve: POST /recommend answered {code}, "
                 f"{reply.get('dispatches')} dispatches, or answers that "
                 "differ from the recommender's")
        health = json.load(urllib.request.urlopen(url + "/healthz",
                                                  timeout=60))
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        bad, err = post(b"{not json")
        if health["status"] != "ok" or health["cells"] != len(index.cells) \
                or 'repro_serve_answers_total{source="archive"}' not in \
                metrics or bad != 400 or not err["error"]["message"]:
            fail(f"serve: /healthz {health}, a malformed body gave {bad}")
    finally:
        box["srv"].shutdown()
        th.join(60)
    log(f"serve: POST /recommend of {len(sample)} queries round trip "
        f"{1e3 * rtt:.3f} ms, 1 dispatch, answers == the recommender's; "
        f"/healthz ok ({health['cells']} cells, {health['candidates']} "
        "candidates); /metrics carries serve_answers_total; a malformed "
        f"body: 400 {err['error']['type']}")

    # (b) transfer: the grid warm from phase 6's run directory, cold, and
    # warm as a W = 2 fleet
    grid_path = os.path.join(root, "transfer_grid.json")
    with open(grid_path, "w") as f:
        json.dump(grid, f)

    def drive(label, extra):
        croot = os.path.join(root, label)
        ops.reset_launch_counts()
        sync()
        t = time.time()
        dse.main(["--campaign", grid_path, "--campaign-root", croot,
                  "--device", device] + extra)
        sync()
        wall, counts = time.time() - t, ops.launch_counts()
        store = CampaignStore.open(os.path.join(croot, grid["name"]))
        if not store.all_done():
            fail(f"transfer {label}: the campaign did not finish")
        log(f"transfer {label}: {len(store.manifest['cells'])} cells, wall "
            f"{wall:.3f} s; launches in this process {json.dumps(counts)}")
        return store, wall, counts

    policy_mlp.fused_mlp_cuda = counting_cuda
    try:
        warm, warm_wall, paths["transfer"] = drive(
            "warm", ["--transfer-from", index_root])
    finally:
        policy_mlp.fused_mlp_cuda = real_cuda
    missing = [k for k in ("actor_moe", "sumtree", "sumtree_sample",
                           "fused_mlp") if paths["transfer"][k] <= 0]
    if on_card and missing:
        fail(f"transfer: {missing} never launched")
    spec = CampaignSpec.from_dict(grid)
    cpu_spec = transfer_mod.with_transfer(spec, [index_root], device="cpu")
    if cpu_spec.to_dict() != warm.manifest["spec"]:
        fail("transfer: the priorities differ from a CPU with_transfer")
    cpu_store = CampaignStore.create(os.path.join(root, "cpu-prepare"),
                                     cpu_spec)
    cpu_tr = transfer_mod.prepare_store(cpu_store, device="cpu")
    tr = warm.manifest["transfer"]
    cost_w = cm.load_cost_model(warm.root, device="cpu").cost_w
    if cpu_tr["donors"] != tr["donors"] or cpu_tr["roots"] != tr["roots"] \
            or not np.array_equal(cost_w, cm.load_cost_model(
                cpu_store.root, device="cpu").cost_w):
        fail("transfer: the donors or cost_w differ from a CPU "
             "prepare_store")
    log(f"transfer: priorities {json.dumps(cpu_spec.priorities)}, donors "
        f"and cost_w ({cost_w.shape[0]} weights) == a CPU with_transfer + "
        f"prepare_store, bitwise; cost model {json.dumps(tr['cost_model'])}"
        f" on {device}")
    n_seed = 0
    for batch in plan_cached(warm.spec):
        wl = extract(get_config(batch.arch), seq_len=grid["seq_len"],
                     batch=grid["batch"], phase=batch.phase,
                     dtype=batch.dtype)
        ws_b = transfer_mod.load_warm_start(warm, batch, wl, device=device)
        for cell, seed_cell in zip(batch.cells, ws_b["cells"]):
            if not seed_cell:
                continue
            ents = seed_cell["entries"]
            hp = cell.mode == "high_perf"
            node = torch.as_tensor(an.node_vector(
                node_params(cell.node_nm, low_power=not hp), high_perf=hp))
            with torch.no_grad():
                m = an.evaluate(cs.project(torch.as_tensor(np.stack(
                    [e.cfg for e in ents]))), torch.as_tensor(
                    np.asarray(wl.features, np.float32)),
                    node.expand(len(ents), node.shape[0])).numpy()
            got = np.array([[e.power_mw, e.perf_gops, e.area_mm2, e.tok_s,
                             e.ppa_score] for e in ents])
            cols = [an.M_IDX[n] for n in ("power_mw", "perf_gops",
                                          "area_mm2", "tok_s", "ppa_score")]
            if (m[:, an.M_IDX["feasible"]] != 1.0).any() or not \
                    np.allclose(got, m[:, cols], rtol=1e-5):
                fail(f"transfer: {cell.cell_id}'s seeded frontier "
                     "disagrees with the plain CPU evaluator")
            n_seed += len(ents)
    log(f"transfer: {n_seed} seeded frontier entries re-evaluated on the "
        "CPU: feasible, rtol 1e-5")
    cold, cold_wall, cold_counts = drive("cold", [])
    for cid in sorted(warm.manifest["cells"]):
        row = []
        for st in (warm, cold):
            ents = st.load_archive(cid).entries
            row.append((st.load_summary(cid)["ppa_score"],
                        min((e.episode for e in ents), default=None)))
        log(f"transfer {cid}: best ppa_score warm {row[0][0]} cold "
            f"{row[1][0]}; first frontier episode warm {row[0][1]} cold "
            f"{row[1][1]}")
    fleet, fleet_wall, _ = drive(
        "fleet", ["--transfer-from", index_root, "--workers", "2"])
    if campaign_fingerprint(fleet) != campaign_fingerprint(warm):
        fail("transfer: the warm W=2 fleet's fingerprint differs from the "
             "W=1 warm run's")
    workers = worker_roots(fleet.root)
    if len(workers) != 2 or any(
            CampaignStore.open(w).manifest.get("transfer") !=
            fleet.manifest["transfer"] for w in workers):
        fail("transfer: a worker's manifest lacks the top-level transfer "
             "record")
    paths["transfer_fleet"] = {
        k: sum(int(snapshot_value((read_lease(w) or {}).get("metrics"),
                                  "counters", "kernel_launches_total",
                                  {"kernel": k}, default=0))
               for w in workers) for k in ops.KERNELS}
    log(f"transfer: warm W=2 fleet fingerprint == the W=1 warm run's, both "
        f"workers mirror the transfer record; walls warm {warm_wall:.3f} s,"
        f" cold {cold_wall:.3f} s, warm W=2 {fleet_wall:.3f} s; fleet "
        f"launches {json.dumps(paths['transfer_fleet'])}")
    log(f"fused_mlp at the serving widths: {serve_launches[0]} launches "
        "(the index build and the warm run's cost-model fits)")
    return paths, dict(rows=n_rows, max_abs_err=serve_err,
                       launches=serve_launches[0])


# phase 13: the backward kernels' parity cases (B, H, Hk, Sq, Sk, hd,
# causal, window): SmolLM-135M's training shape, Jamba's attention layer,
# the Whisper encoder (non-causal), MiniCPM3's MLA width (96), a ragged
# GQA one with Sq != Sk and a window
BWD_ATTN_CASES = [(8, 9, 3, 1024, 1024, 64, True, 0),
                  (2, 32, 8, 512, 512, 128, True, 0),
                  (2, 16, 16, 1500, 1500, 64, False, 0),
                  (2, 40, 40, 512, 512, 96, True, 0),
                  (1, 4, 2, 77, 131, 64, True, 0),
                  (1, 4, 2, 300, 300, 64, True, 128)]
BWD_SSM_CASES = [(2, 512, 8192, 16), (2, 300, 200, 13), (2, 257, 8192, 16)]
# (b) SmolLM-135M at full width: 100 steps of B = 8 x S = 1,024 (the loss
# runs in 2 chunks of 512), then kill/resume over 6 steps; (c) Jamba at
# full width with 2 layers, 5 steps of 2 x 512; (e) serving the four
# architectures the earlier slices lacked: (label, arch, config changes,
# batch, prompt, generated tokens)
TRAIN_STEPS, TRAIN_B, TRAIN_S = 100, 8, 1024
JAMBA_STEPS = 5
ZOO_RUNS = (("minicpm3", "minicpm3-4b", {}, 4, 512, 32),
            ("whisper", "whisper-medium", {}, 4, 448, 32),
            ("xlstm", "xlstm-1.3b", {}, 4, 512, 32),
            ("vision", "llama-3.2-vision-90b", dict(n_layers=5), 2, 512, 32))


def train_launches(cfg, steps: int) -> dict:
    """The kernel launches of ``steps`` one-device training steps of
    ``cfg``, from its period layout (``lm._layout``): each attention and
    Mamba layer launches its forward kernel twice a step, in the forward
    and again where the backward recomputes its period (``layers.remat``,
    the reference's ``jax.checkpoint``), and its backward kernel once."""
    from repro_torch.models import lm
    _, n_periods, slots = lm._layout(cfg)
    n = {k: n_periods * sum(kind == k for kind, _ in slots)
         for k in ("attn", "mamba")}
    return {"flash_attention": 2 * steps * n["attn"],
            "flash_attention_backward": steps * n["attn"],
            "ssm_scan": 2 * steps * n["mamba"],
            "ssm_scan_backward": steps * n["mamba"]}


def attention_bwd_work(B, H, Hk, Sq, Sk, hd, causal, window, elt) -> tuple:
    """FLOPs and bytes of one ``flash_attention_backward`` call: per
    visible pair the recomputed q.k and the products for dV, dP, dQ and dK
    (5 x 2 x hd); q, k, v, o, dO and lse read once, dq, dk, dv written
    once."""
    flops, _ = attention_work(B, H, Hk, Sq, Sk, hd, causal, window, elt)
    return (2.5 * flops, elt * hd * (4 * B * H * Sq + 4 * B * Hk * Sk)
            + 4 * B * H * Sq)


def ssm_bwd_work(B, S, D, N) -> tuple:
    """The same for one ``ssm_scan_backward`` call, the least work of any
    design: the forward's states recomputed (6 operations a state a step)
    and about 14 more for g and the five gradients' terms; one exponential
    a state a step (the kernel takes each once, for both of its scans);
    dt, x, dy, B, C, A and the saved states read once, d(dt), dx, dB, dC,
    dA written once.  The kernel's scans (a lane's pair and 5 shuffle
    rounds a direction), its dB/dC partials and its sums over n in shared
    memory come on top and are not counted."""
    n_chunks = -(-S // 128)
    return (20.0 * B * S * D * N,
            4 * (5 * B * S * D + 4 * B * S * N + 2 * D * N
                 + n_chunks * B * D * N),
            float(B * S * D * N))


# the backward kernels' launches' names in a profile
# (csrc/flash_attention_backward.cu, csrc/ssm_scan_backward.cu)
ATTN_BWD_KERNELS = ("dsum_kernel", "dkdv_kernel", "dq_kernel")
SSM_BWD_KERNELS = ("ssm_scan_backward_kernel", "ssm_scan_backward_reduce")


def dev_time(e) -> float:
    """A profiler event's self device time (µs), under either name torch
    gives it."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_split(fn, names, calls: int = 10) -> str:
    """The device time a call of each launch named in ``names`` (kernel
    names as the profile shows them, by substring), over ``calls`` calls
    of ``fn`` (``torch.profiler``; "not measured" if the profile holds no
    device time for them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    us = {n: sum(dev_time(e) for e in events if n in e.key) / calls
          for n in names}
    if not sum(us.values()):
        return "per-launch split not measured (no device time profiled)"
    return "per call " + ", ".join(f"{n} {v / 1e3:.5f} ms"
                                   for n, v in us.items())


def cancelling_cotangent(dev, seeds: int = 8) -> None:
    """Print how close the backward comes to the plain version's autograd
    under the loss sum(o^2) (dO = 2 o: dP and D ~100 and nearly cancelling
    in dS; at a row with one visible key the plain softmax backward cancels
    exactly, D = rowsum(dO o) to an ulp of dP): through ``flash_attention``'s
    autograd Function against the plain version's, q [2,8,96,64], k/v 2
    heads, causal, window 40, over ``seeds`` seeds; fp32 as the worst
    |err| / (1e-5 + 1e-4 |want|), bf16 as err / max |grad|.  A reading:
    the card tests hold one such seed."""
    from repro_torch.kernels import flash_attention as fa
    for dt in (torch.float32, torch.bfloat16):
        worst = []
        for seed in range(seeds):
            g = torch.Generator(device=dev).manual_seed(seed)
            base = [torch.randn((2, 96, n, 64), generator=g,
                                device=dev).to(dt) for n in (8, 2, 2)]
            grads = []
            for fn in (fa.flash_attention, fa.flash_attention_plain):
                leaves = [t.clone().requires_grad_(True) for t in base]
                o = fn(*(t.transpose(1, 2) for t in leaves), window=40)
                o.float().square().sum().backward()
                grads.append([t.grad.float() for t in leaves])
            worst.append(max(
                float(((a_ - w_).abs() / (ATOL + RTOL * w_.abs())).max())
                if dt == torch.float32 else
                float((a_ - w_).abs().max() / w_.abs().max())
                for a_, w_ in zip(*grads)))
        log(f"reading flash_attention_backward, loss sum(o^2) (dP and D "
            f"cancel), {str(dt)[6:]}: per seed worst "
            + ("|err| / (1e-5 + 1e-4 |want|) " if dt == torch.float32
               else "err / max |grad| ")
            + " ".join(f"{w_:.4f}" for w_ in worst))


def profile_train_step(state, steps: int) -> None:
    """Profile SmolLM-135M's next step (``steps``, its batch from the data
    pipeline) after the timed run, from ``state``: the device ops by time,
    the attention backward's share of device time, the device idle share
    (1 - device busy / the step's wall)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.optim import trainer
    cfg = get_config("smollm-135m")
    step_fn = trainer.make_train_step(cfg, trainer.TrainConfig(
        lr=3e-4, warmup_steps=max(10, steps // 10), total_steps=steps))
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B,
                    seed=0)
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in batch_at(dc, steps).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        _, met = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.time() - t
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_time(e) > 0]
    busy = sum(dev_time(e) for e in events) / 1e3
    attn = sum(dev_time(e) for e in events
               if any(n in e.key for n in ATTN_BWD_KERNELS)) / 1e3
    if not (np.isfinite(float(met["loss"])) and busy > 0):
        fail("profile of a train step: no device time or a bad loss")
    log(f"profile train step smollm-135m (step {steps}): wall "
        f"{1e3 * wall:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / (1e3 * wall):.4f}; attention backward {attn:.3f} ms "
        f"({attn / busy:.4f} of device time); "
        f"{sum(e.count for e in events)} device ops")
    for e in sorted(events, key=dev_time, reverse=True)[:15]:
        log(f"profile train step:   {dev_time(e) / 1e3:10.3f} ms  "
            f"x{e.count:<6d} {e.key[:90]}")


def lm_training_zoo(dev, timings, errs, steps=TRAIN_STEPS,
                    zoo_runs=ZOO_RUNS) -> tuple:
    """Phase 13 (see the module docstring) on the card.  Returns the
    launch counts of the training path and of the zoo's serving runs."""
    import dataclasses as dc_
    from unittest import mock as mock_
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.kernels import flash_attention as fa, ops, ssm_scan as ss
    from repro_torch.launch import serve, train as train_mod
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import lm
    from repro_torch.optim import trainer
    from repro_torch.optim.adam import tree_leaves, tree_map

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    errs.setdefault("flash_attention_backward", 0.0)
    errs.setdefault("ssm_scan_backward", 0.0)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    # (a) the backward kernels against their plain versions' autograd
    for case in BWD_ATTN_CASES:
        B, H, Hk, Sq, Sk, hd, causal, window = case
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(shape, generator=gen,
                                       device=dev).to(dt)
                           for shape in ((B, H, Sq, hd), (B, Hk, Sk, hd),
                                         (B, Hk, Sk, hd), (B, H, Sq, hd)))
            with torch.no_grad():
                o, lse = fa._forward_cuda(q, k, v, causal, window, True)
                got = fa.flash_attention_backward_cuda(
                    q, k, v, o, lse, do, causal=causal, window=window)
                again = fa.flash_attention_backward_cuda(
                    q, k, v, o, lse, do, causal=causal, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_backward_plain(
                q, k, v, do, causal=causal, window=window)
            worst = 0.0
            for name, g_, a_, w_ in zip("qkv", got, again, want):
                if not torch.equal(g_, a_):
                    fail(f"flash_attention_backward {case} {dt}: d{name} "
                         "differs between two identical calls")
                err = float((g_.float() - w_.float()).abs().max())
                scale = float(w_.float().abs().max())
                ok = (torch.allclose(g_, w_, rtol=1e-4, atol=1e-5)
                      if dt == torch.float32 else err <= 2e-2 * scale)
                worst = max(worst, err if dt == torch.float32
                            else err / scale)
                if dt == torch.float32:
                    errs["flash_attention_backward"] = max(
                        errs["flash_attention_backward"], err)
                if not ok:
                    fail(f"flash_attention_backward {case} {dt}: d{name} "
                         f"disagrees with the plain version (max abs err "
                         f"{err:.3e}, max |grad| {scale:.3e})")
            log(f"parity flash_attention_backward B={B} H={H} Hk={Hk} "
                f"Sq={Sq} Sk={Sk} hd={hd} causal={causal} window={window} "
                f"{str(dt)[6:]}: max {'abs' if dt == torch.float32 else 'rel'}"
                f" err {worst:.3e}, two calls bitwise equal")
            del q, k, v, do, o, lse, got, again, want
    cancelling_cotangent(dev)
    for B, S, D, N in BWD_SSM_CASES:
        ins = (torch.rand((B, S, D), generator=gen, device=dev) * 0.1 + 1e-3,
               torch.randn((B, S, N), generator=gen, device=dev),
               torch.randn((B, S, N), generator=gen, device=dev),
               torch.randn((B, S, D), generator=gen, device=dev),
               -torch.exp(0.5 * torch.randn((D, N), generator=gen,
                                            device=dev)))
        dy = torch.randn((B, S, D), generator=gen, device=dev)
        for dh in (None, torch.randn((B, D, N), generator=gen, device=dev)):
            with torch.no_grad():
                _, _, h_chunks = ss._forward_cuda(*ins, None, True)
                got = ss.ssm_scan_backward_cuda(*ins, h_chunks, dy, dh)
                again = ss.ssm_scan_backward_cuda(*ins, h_chunks, dy, dh)
            torch.cuda.synchronize()
            want = ss.ssm_scan_backward_plain(*ins, None, dy, dh)
            exact = ss.ssm_scan_backward_plain(
                *(t.double() for t in ins), None, dy.double(),
                None if dh is None else dh.double())
            for name, g_, a_, w_, x_ in zip(("dt", "B", "C", "x", "A"), got,
                                            again, want, exact):
                if not torch.equal(g_, a_):
                    fail(f"ssm_scan_backward {(B, S, D, N)}: d{name} "
                         "differs between two identical calls")
                err = float((g_ - w_).abs().max())
                scale = float(w_.abs().max())
                err_k = float((g_.double() - x_).abs().max())
                err_p = float((w_.double() - x_).abs().max())
                errs["ssm_scan_backward"] = max(errs["ssm_scan_backward"],
                                                err)
                log(f"parity ssm_scan_backward B={B} S={S} D={D} N={N} dh="
                    f"{dh is not None} d{name}: max abs err {err:.3e} of max"
                    f" |grad| {scale:.3e}; against float64 kernel "
                    f"{err_k:.3e}, plain float32 {err_p:.3e}")
                if not (torch.allclose(g_, w_, rtol=1e-4, atol=1e-5 * scale)
                        and err_k <= 1e-5 * scale):
                    fail(f"ssm_scan_backward {(B, S, D, N)}: d{name} "
                         "disagrees with the plain version")
    # timing at the training shapes: the kernel (CUDA graph), the plain
    # version's autograd and SDPA's backward (eager, CUDA events)
    for label, case, dt in (("smollm", BWD_ATTN_CASES[0], torch.bfloat16),
                            ("smollm_fp16", BWD_ATTN_CASES[0],
                             torch.float16),
                            ("jamba", BWD_ATTN_CASES[1], torch.bfloat16),
                            ("smollm_fp32", BWD_ATTN_CASES[0],
                             torch.float32)):
        B, H, Hk, Sq, Sk, hd, causal, window = case
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((B, H, Sq, hd), (B, Hk, Sk, hd),
                                     (B, Hk, Sk, hd), (B, H, Sq, hd)))
        with torch.no_grad():
            o, lse = fa._forward_cuda(q, k, v, causal, window, True)
        kern = lambda: fa.flash_attention_backward_cuda(
            q, k, v, o, lse, do, causal=causal, window=window)
        plain = lambda: fa.flash_attention_backward_plain(
            q, k, v, do, causal=causal, window=window)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
        lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
        ms = device_ms(kern)
        call = call_ms(kern, n=20, warm=3)
        plain_ms = call_ms(plain, n=5, warm=1)
        library_ms = call_ms(lib, n=20, warm=3)
        work = attention_bwd_work(*case, q.element_size())
        # fp32 runs 3xTF32 on the tensor cores: its bound beside the
        # fp32-FMA one
        bnd, by, term = bound_ms(*work, unit="tf32x3" if dt == torch.float32
                                 else "half")
        fma = "" if dt != torch.float32 else \
            f" (fp32 FMA: {1e6 * work[0] / PEAK_FP32_FLOPS:.4f})"
        timings[("flash_attention_backward", label)] = (
            ms, plain_ms, bnd, by, term, call, library_ms)
        log(f"time flash_attention_backward {label} q [{B},{H},{Sq},{hd}] "
            f"k/v [{B},{Hk},{Sk},{hd}] {str(dt)[6:]} causal: ms {ms:.5f} "
            f"plain_ms {plain_ms:.5f} bound_us {1e3 * bnd:.4f}{fma} bound_by"
            f" {by} ({term}) library_ms (SDPA backward) {library_ms:.5f} | "
            f"eager call_ms {call:.5f} | "
            f"{kernel_split(kern, ATTN_BWD_KERNELS)}")
        del q, k, v, do, o, lse, leaves, out
    B, S, D, N = BWD_SSM_CASES[0]
    ins = (torch.rand((B, S, D), generator=gen, device=dev) * 0.1 + 1e-3,
           torch.randn((B, S, N), generator=gen, device=dev),
           torch.randn((B, S, N), generator=gen, device=dev),
           torch.randn((B, S, D), generator=gen, device=dev),
           -torch.exp(0.5 * torch.randn((D, N), generator=gen, device=dev)))
    dy = torch.randn((B, S, D), generator=gen, device=dev)
    with torch.no_grad():
        _, _, h_chunks = ss._forward_cuda(*ins, None, True)
    kern = lambda: ss.ssm_scan_backward_cuda(*ins, h_chunks, dy)
    ms, call = device_ms(kern), call_ms(kern, n=20, warm=3)
    plain_ms = call_ms(lambda: ss.ssm_scan_backward_plain(*ins, None, dy),
                       n=2, warm=1)
    bnd, by, term = bound_ms(*ssm_bwd_work(B, S, D, N)[:2],
                             sfu_ops=ssm_bwd_work(B, S, D, N)[2])
    timings[("ssm_scan_backward", "c")] = (ms, plain_ms, bnd, by, term, call,
                                           None)
    log(f"time ssm_scan_backward [{B},{S},{D}] N={N} fp32: ms {ms:.5f} "
        f"plain_ms {plain_ms:.5f} bound_us {1e3 * bnd:.4f} bound_by {by} "
        f"({term}) library_ms None | eager call_ms {call:.5f} | "
        f"{kernel_split(kern, SSM_BWD_KERNELS)}")
    del ins, dy, h_chunks

    # (b) SmolLM-135M at full width through repro_torch.launch.train
    ckpt_root = os.path.join(OUT, "train")
    subprocess.run(["rm", "-rf", ckpt_root], check=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.time()
    state, losses = train_mod.train("smollm-135m", reduced=False,
                                    steps=steps, global_batch=TRAIN_B,
                                    seq_len=TRAIN_S, log_every=10,
                                    device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    train_counts = dict(ops.launch_counts())
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    log(f"train smollm-135m: {steps} steps of {TRAIN_B} x {TRAIN_S} in "
        f"{wall:.3f} s: {steps / wall:.4f} steps/s, "
        f"{steps * TRAIN_B * TRAIN_S / wall:.1f} tokens/s; loss first 10 "
        f"mean {first:.4f}, last 10 mean {last:.4f}; launches "
        f"flash_attention {train_counts['flash_attention']} "
        f"flash_attention_backward "
        f"{train_counts['flash_attention_backward']}; peak_mem_gb "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} (before remat: "
        f"4.70-6.39 steps/s, peak 14.092 GB)")
    if not (np.isfinite(losses).all() and first > last):
        fail("train smollm-135m: the loss did not fall")
    want = train_launches(get_config("smollm-135m"), steps)
    for name in ("flash_attention", "flash_attention_backward"):
        if train_counts[name] != want[name]:
            fail(f"train smollm-135m: {name} launched {train_counts[name]} "
                 f"times, not {want[name]}")
    profile_train_step(state, steps)
    del state
    # kill/resume: 6 steps straight against 3, a stop, and 3 resumed
    ops.reset_launch_counts()
    kw = dict(reduced=False, steps=6, global_batch=TRAIN_B,
              seq_len=TRAIN_S, ckpt_every=1000, log_every=1, device="cuda")
    full, l_full = train_mod.train("smollm-135m",
                                   ckpt_dir=os.path.join(ckpt_root, "a"),
                                   **kw)
    _, l_a = train_mod.train("smollm-135m", stop_after=3,
                             ckpt_dir=os.path.join(ckpt_root, "b"), **kw)
    resumed, l_b = train_mod.train("smollm-135m", resume="auto",
                                   ckpt_dir=os.path.join(ckpt_root, "b"),
                                   **kw)
    pairs = list(zip(ckpt._leaves_with_names(resumed),
                     ckpt._leaves_with_names(full)))
    bitwise = l_a + l_b == l_full and all(torch.equal(a_, b_)
                                          for (_, a_), (_, b_) in pairs)
    close = np.allclose(l_a + l_b, l_full, rtol=1e-6) and all(
        torch.allclose(a_.double(), b_.double(), rtol=1e-6, atol=0)
        for (_, a_), (_, b_) in pairs)
    log(f"train kill/resume smollm-135m: losses straight {l_full}, "
        f"stopped {l_a} + resumed {l_b}; within rtol 1e-6 {close}; bitwise "
        f"{bitwise}")
    if not close:
        fail("train kill/resume: the resumed run differs from the straight "
             "one")
    del full, resumed, pairs
    subprocess.run(["rm", "-rf", ckpt_root], check=False)
    # the recomputation through the kernels: 2 steps with the periods and
    # the loss chunks rematerialised against 2 with the checkpoints patched
    # out (layers.checkpoint a plain call), losses and weights bitwise
    kw = dict(reduced=False, steps=2, global_batch=TRAIN_B, seq_len=TRAIN_S,
              log_every=1, device="cuda")
    runs = {}
    for label, how in (("remat", layers_mod.checkpoint),
                       ("no remat", lambda f, *a, **k: f(*a))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with mock_.patch.object(layers_mod, "checkpoint", how):
            runs[label] = train_mod.train("smollm-135m", **kw)
        runs[label] += (torch.cuda.max_memory_allocated() / 1e9,)
    (a_, l_r, peak_r), (b_, l_n, peak_n) = runs["remat"], runs["no remat"]
    bitwise = l_r == l_n and all(
        torch.equal(x_, y_) for (_, x_), (_, y_) in zip(
            ckpt._leaves_with_names(a_), ckpt._leaves_with_names(b_)))
    log(f"train remat smollm-135m: 2 steps, losses {l_r} against {l_n} "
        f"with the checkpoints patched out; losses and weights bitwise "
        f"{bitwise}; peak_mem_gb {peak_r:.3f} against {peak_n:.3f}")
    if not bitwise:
        fail("train remat: the rematerialised steps differ from the steps "
             "without it")
    del a_, b_, runs
    train_counts = {k: train_counts[k] + v
                    for k, v in ops.launch_counts().items()}

    # (c) Jamba at full width with 2 layers (attention + dense FFN, Mamba +
    # the 16-expert MoE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dc_.replace(get_config("jamba-v0.1-52b"), n_layers=2)
    ops.reset_launch_counts()
    t = time.time()
    state, losses = train_mod.train("jamba-v0.1-52b", cfg=cfg, seed=SEED,
                                    steps=JAMBA_STEPS, global_batch=2,
                                    seq_len=512, log_every=1, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = ops.launch_counts()
    n_params = sum(t_.numel() for t_ in tree_leaves(state.params))
    # a slice of a matrix of each part against the same seed's initial
    # weights (a norm's scale of 1 is bf16-rounding-stationary under steps
    # of lr <= 1.5e-4)
    samples = {"embed": lambda p: p["embed"]["w"][:64],
               "attention wq": lambda p: p["blocks"]["p0"]["wq"]["w"]
               [..., :64, :64],
               "mamba in_proj": lambda p: p["blocks"]["p1"]["in_proj"]["w"]
               [..., :64, :64],
               "expert e_up": lambda p: p["blocks"]["p1"]["e_up"]
               [..., 0, :64, :64]}
    after = {k: f(state.params).clone() for k, f in samples.items()}
    del state
    init = lm.init_params(cfg, seed=SEED, device=dev)
    moved = {k: float((after[k] - f(init)).abs().max().float())
             for k, f in samples.items()}
    del init
    log(f"train jamba-v0.1-52b 2 layers ({n_params / 1e9:.3f} B parameters)"
        f": {JAMBA_STEPS} steps of 2 x 512 in {wall:.3f} s, losses {losses}"
        f"; launches ssm_scan {counts['ssm_scan']} ssm_scan_backward "
        f"{counts['ssm_scan_backward']} flash_attention "
        f"{counts['flash_attention']}; parameters moved {moved}; peak_mem_gb "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} (before remat: "
        f"60.550 GB)")
    if not (np.isfinite(losses).all() and all(m > 0 for m in moved.values())):
        fail("train jamba: a loss is not finite or the parameters stayed")
    JAMBA_LOSSES[:] = losses           # phase 15 (b) is held against them
    for name, n in train_launches(cfg, JAMBA_STEPS).items():
        if counts[name] != n:
            fail(f"train jamba: {name} launched {counts[name]} times, not "
                 f"{n}")
    train_counts = {k: train_counts[k] + v for k, v in counts.items()}

    # (d) one step on every reduced config (float32) on the card, and the
    # same step on the CPU from the card's initial weights
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    tc = trainer.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in ARCH_IDS:
        cfg = dc_.replace(get_reduced(arch), param_dtype="float32")
        p_gpu = lm.init_params(cfg, seed=SEED, device=dev)
        p_cpu = tree_map(lambda t_: t_.cpu(), p_gpu)
        p_start = tree_map(lambda t_: t_.clone(), p_cpu)
        rng = np.random.default_rng(SEED)
        batch = dict(tokens=rng.integers(0, cfg.vocab, (2, 64)),
                     labels=rng.integers(0, cfg.vocab, (2, 64)))
        ctx = train_mod.context_at(cfg, SEED, 0, 2)
        mets = {}
        for where, p_ in (("cuda", p_gpu), ("cpu", p_cpu)):
            b_ = {k: torch.as_tensor(v, device=where).long()
                  for k, v in batch.items()}
            if ctx is not None:
                b_["ctx"] = torch.as_tensor(ctx, device=where)
            st, met = trainer.make_train_step(cfg, tc)(
                trainer.create_state(p_), b_)
            mets[where] = {k: float(v) for k, v in met.items()}
            if where == "cuda":
                moved = max(float((a_.cpu() - b0).abs().max()) for a_, b0 in
                            zip(tree_leaves(st.params),
                                tree_leaves(p_start)))
        gap = abs(mets["cuda"]["loss"] - mets["cpu"]["loss"]) \
            / abs(mets["cpu"]["loss"])
        gn = abs(mets["cuda"]["grad_norm"] - mets["cpu"]["grad_norm"]) \
            / abs(mets["cpu"]["grad_norm"])
        log(f"train step {arch} reduced float32: card loss "
            f"{mets['cuda']['loss']:.6f} grad_norm "
            f"{mets['cuda']['grad_norm']:.6f}, CPU loss "
            f"{mets['cpu']['loss']:.6f} grad_norm "
            f"{mets['cpu']['grad_norm']:.6f} (relative gaps {gap:.2e}, "
            f"{gn:.2e}); parameters moved {moved:.3e}")
        if not (np.isfinite(list(mets["cuda"].values())).all()
                and gap <= 1e-4 and moved > 0):
            fail(f"train step {arch}: the card's step disagrees with the "
                 "CPU's, is not finite or moved nothing")
    counts = ops.launch_counts()
    train_counts = {k: train_counts[k] + v for k, v in counts.items()}
    for name in ("flash_attention", "flash_attention_backward", "ssm_scan",
                 "ssm_scan_backward"):
        if train_counts[name] <= 0:
            fail(f"kernel {name} was never launched on the train path")

    # (e) serving the four new architectures, then an fp32 copy of one
    # period through the kernels and through the plain versions
    zoo_counts = {k: 0 for k in ops.KERNELS}
    for label, arch, changes, batch, prompt_len, gen_tokens in zoo_runs:
        full = dc_.replace(get_config(arch), **changes)
        period = lm.period_of(full)
        for tag, cfg in (("whole", full), ("fp32", dc_.replace(
                full, n_layers=period, param_dtype="float32",
                **({"enc_layers": 1} if full.is_encdec else {})))):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params, prompts, ctx = serve.inputs(cfg, batch, prompt_len, SEED,
                                                dev)
            n_params = sum(t_.numel() for t_ in tree_leaves(params))
            kinds = lm.decoder_kinds(cfg)
            serve.generate(params, cfg, prompts, 2, ctx)          # warm-up
            ops.reset_launch_counts()
            g = serve.generate(params, cfg, prompts, gen_tokens, ctx)
            counts = ops.launch_counts()
            for k, v in counts.items():
                zoo_counts[k] += v
            want_fa = sum(1 + (k == "xattn") for k in kinds
                          if k in ("attn", "xattn")) + cfg.enc_layers
            log(f"zoo {label} {tag}: {arch} {json.dumps(changes)} "
                f"{cfg.param_dtype} ({cfg.n_layers} layers"
                f"{f' + {cfg.enc_layers} encoder' if cfg.is_encdec else ''},"
                f" {n_params / 1e9:.3f} B parameters); batch {batch}, prompt "
                f"{prompt_len}, {gen_tokens} tokens: prefill_ms "
                f"{1e3 * g.t_prefill:.3f} decode_tok_s {g.tok_s:.3f}; "
                f"launches flash_attention {counts['flash_attention']}; "
                f"peak_mem_gb {torch.cuda.max_memory_allocated() / 1e9:.3f}")
            if not torch.isfinite(g.prefill_logits).all():
                fail(f"zoo {label} {tag}: prefill logits are not finite")
            if counts["flash_attention"] != want_fa:
                fail(f"zoo {label} {tag}: flash_attention launched "
                     f"{counts['flash_attention']} times, not {want_fa}")
            if tag == "fp32":
                with mock_.patch.object(attention_mod, "flash_attention",
                                        fa.flash_attention_plain), \
                        mock_.patch.object(blocks_mod, "ssm_scan",
                                           ss.ssm_scan_plain):
                    ops.reset_launch_counts()
                    p = serve.generate(params, cfg, prompts, gen_tokens, ctx)
                    if any(ops.launch_counts().values()):
                        fail(f"zoo {label}: the plain path launched a kernel")
                a_, b_ = g.prefill_logits.float(), p.prefill_logits.float()
                err = float((a_ - b_).abs().max())
                scale = float(b_.abs().max())
                same = bool((g.tokens == p.tokens).all())
                log(f"zoo {label} check: prefill logits max abs err "
                    f"{err:.4e} of max |logit| {scale:.4f} (share "
                    f"{err / scale:.3e}, tolerance 1e-4); greedy tokens "
                    f"equal {same}")
                if not (err <= 1e-4 * scale and same):
                    fail(f"zoo {label}: the kernels' fp32 generation differs"
                         " from the plain versions'")
            del params, prompts, ctx, g
    if zoo_counts["flash_attention"] <= 0:
        fail("kernel flash_attention was never launched on the zoo path")
    return train_counts, zoo_counts


# phase 15: sharded training on a 1x1 NCCL mesh and the production dry-run
MESH_STEPS = 10
MESH_JAMBA_STEPS = 2
JAMBA_LOSSES: list = []      # phase 13 (c)'s one-device losses
# (arch, shape, time limit in s) of the dry-run cells, each a process on the
# fake 256-rank group, traced at 2 and 3 periods and carried to the depth
DRYRUN_CELLS = (("mixtral-8x7b", "train_4k", 600),
                ("mixtral-8x7b", "decode_32k", 300))


def start_dryruns(out_dir: str) -> list:
    """Start each dry-run cell (``python -m repro_torch.launch.dryrun``,
    fake CUDA tensors, no card) and a NCCL start that must fail (a world
    of 2 whose second rank never comes, 10 s timeout), all at once;
    returns (label, process, time limit, start, log path)."""
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    runs = []
    for arch, shape, limit in DRYRUN_CELLS:
        path = os.path.join(out_dir, f"{arch}__{shape}.log")
        runs.append((f"{arch} {shape}", subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "pod", "--extrapolate",
             "--out", out_dir], env=env, stdout=open(path, "w"),
            stderr=subprocess.STDOUT), limit, time.time(), path))
    path = os.path.join(out_dir, "nccl_fail.log")
    probe = ("import sys; sys.path.insert(0, %r)\n"
             "from repro_torch.launch import mesh\n"
             "try:\n"
             "    mesh.init_distributed('cuda', init_method='tcp://127.0.0.1:"
             "%d', rank=0, world_size=2, timeout=10)\n"
             "except Exception as e:\n"
             "    print('raised', type(e).__name__); sys.exit(3)\n"
             "print('no error')\n") % (SRC, free_port())
    runs.append(("nccl start that must fail", subprocess.Popen(
        [sys.executable, "-c", probe], env=env, stdout=open(path, "w"),
        stderr=subprocess.STDOUT), 120, time.time(), path))
    return runs


def free_port() -> int:
    import socket
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def sharded_training(dev, card: str) -> dict:
    """Phase 15 (a), (b), (d) on a 1x1 NCCL mesh (see the module
    docstring); returns the mesh path's launch counts."""
    import dataclasses as dc_
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as comp
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod, train as train_mod

    mesh_mod.init_distributed("cuda", init_method="tcp://127.0.0.1:%d"
                              % free_port(), rank=0, world_size=1)
    mesh = mesh_mod.make_test_mesh(1, 1, device="cuda")
    log(f"mesh: {mesh} over NCCL (backend {dist.get_backend()}) on {card}")
    mesh_counts = {}

    def run(label, **kw):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.time()
        _, losses = train_mod.train(device="cuda", log_every=100, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t
        counts = ops.launch_counts()
        log(f"{label}: {kw.get('steps')} steps in {wall:.3f} s, losses "
            f"{losses}; launches {counts}; peak_mem_gb "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        return losses, counts

    # (a) SmolLM-135M whole, bf16, B = 8 x S = 1,024: the mesh against the
    # one-device path with the same arguments
    kw = dict(arch="smollm-135m", reduced=False, steps=MESH_STEPS,
              global_batch=TRAIN_B, seq_len=TRAIN_S, seed=SEED)
    mesh_losses, counts = run("mesh 1x1 smollm-135m", mesh=mesh, **kw)
    one_losses, one_counts = run("one device smollm-135m", **kw)
    rel = np.abs(np.subtract(mesh_losses, one_losses)) / np.abs(one_losses)
    log(f"smollm-135m mesh 1x1 against one device: losses max rel "
        f"{rel.max():.3e}, bitwise {mesh_losses == one_losses} (before "
        f"remat: peak 14.364 GB on the mesh, 14.085 on one device)")
    if not (np.isfinite(mesh_losses).all() and rel.max() <= 1e-5):
        fail("mesh 1x1: SmolLM's losses differ from the one-device run's")
    for name in ("flash_attention", "flash_attention_backward"):
        if counts[name] != one_counts[name] or not counts[name]:
            fail(f"mesh 1x1: {name} launched {counts[name]} times, the "
                 f"one-device run {one_counts[name]}")
    mesh_counts = dict(counts)

    # (b) Jamba at full width, 2 of 32 layers, against phase 13 (c)
    cfg = dc_.replace(get_config("jamba-v0.1-52b"), n_layers=2)
    losses, counts = run("mesh 1x1 jamba-v0.1-52b 2 layers",
                         arch="jamba-v0.1-52b", cfg=cfg, mesh=mesh, seed=SEED,
                         steps=MESH_JAMBA_STEPS, global_batch=2, seq_len=512)
    want = JAMBA_LOSSES[:MESH_JAMBA_STEPS]
    rel = np.abs(np.subtract(losses, want)) / np.abs(want)
    log(f"jamba mesh 1x1 against phase 13 (c): losses {losses} against "
        f"{want}, max rel {rel.max():.3e}")
    if not rel.max() <= 1e-5:
        fail("mesh 1x1: Jamba's losses differ from phase 13 (c)'s")
    for name, n in train_launches(cfg, MESH_JAMBA_STEPS).items():
        if counts[name] != n:
            fail(f"mesh 1x1 jamba: {name} launched {counts[name]} times, "
                 f"not {n}")
    mesh_counts = {k: mesh_counts[k] + v for k, v in counts.items()}

    # (d) compressed_psum on the 1-rank NCCL group, against the same on a
    # gloo group of the CPU
    gloo = dist.new_group(backend="gloo")
    gen = torch.Generator().manual_seed(SEED)
    grads = {"a": torch.randn(4096, generator=gen),
             "b": torch.randn(64, 129, generator=gen) * 100}
    res = comp.init_residuals(grads)
    on_card = comp.compressed_psum({k: v.to(dev) for k, v in grads.items()},
                                   {k: v.to(dev) for k, v in res.items()})
    on_cpu = comp.compressed_psum(grads, res, gloo)
    err = max(float((on_card[i][k].cpu() - on_cpu[i][k]).abs().max())
              for i in (0, 1) for k in grads)
    log(f"compressed_psum on the card's 1-rank NCCL group against the CPU's "
        f"gloo group: max abs err {err:.3e} (grads and residuals)")
    if err != 0.0:
        fail("compressed_psum: the card's result differs from the CPU's")
    dist.destroy_process_group()
    return mesh_counts


def finish_dryruns(runs: list, card: str, out_dir: str) -> None:
    """Wait for each process of :func:`start_dryruns` within its limit,
    then print each cell's record beside the analytic flops."""
    for label, proc, limit, t0, path in runs:
        try:
            proc.wait(timeout=max(1.0, limit - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"dry-run {label}: over its {limit} s limit; tail "
                 f"{open(path).read()[-2000:]}")
        wall = time.time() - t0
        if label.startswith("nccl"):
            out = open(path).read()
            if proc.returncode != 3 or "raised" not in out:
                fail(f"a NCCL start whose second rank never comes did not "
                     f"raise: {out[-1000:]}")
            log(f"nccl start that must fail: {out.strip().splitlines()[-1]}"
                f" (read {wall:.1f} s after its start)")
            continue
        arch, shape = label.split()
        if proc.returncode != 0:
            fail(f"dry-run {label}: exit {proc.returncode}; tail "
                 f"{open(path).read()[-2000:]}")
        with open(os.path.join(out_dir,
                               f"{arch}__{shape}__pod16x16.json")) as f:
            rec = json.load(f)
        mem, colls = rec["memory"], rec["collectives"]
        flops, model = rec["cost"]["flops_per_device"], \
            rec["analytic"]["model_flops"] / rec["n_devices"]
        log(f"dry-run {arch} {shape} pod16x16 ({rec['n_devices']} fake "
            f"ranks, traced on the host of {card} in {rec['trace_s']} s; "
            f"read {wall:.1f} s after its start): status "
            f"{rec['status']}; peak_bytes/dev {mem['peak_bytes']:.6e} "
            f"(argument {mem['argument_bytes']:.6e}, output "
            f"{mem['output_bytes']:.6e}, temp {mem['temp_bytes']:.6e}); "
            f"flops/dev {flops:.6e} against model_flops_analytic/dev "
            f"{model:.6e} (ratio {flops / model:.4f}); wire_bytes/dev "
            f"{colls['total_wire_bytes']:.6e} by kind "
            f"{colls['per_kind_bytes']} counts {colls['per_kind_count']}; "
            f"extrapolated from periods {rec.get('extrapolated_from_periods')}")
        if rec["status"] != "OK":
            fail(f"dry-run {label}: status {rec['status']}")
        if not (mem["peak_bytes"] >= mem["argument_bytes"] > 0
                and flops > 0):
            fail(f"dry-run {label}: a peak below the arguments' bytes or no "
                 "flops")


def phase_mark(n: int, name: str, _t0=time.time()) -> None:
    """Log when phase ``n`` starts, in seconds since the script started."""
    log(f"phase {n} ({name}) starts at {time.time() - _t0:.1f} s")


def main() -> None:
    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from the repo")
    sys.path.insert(0, SRC)
    from repro_torch import device as device_mod
    from repro_torch.campaign import CampaignStore, runner
    from repro_torch.configs import get_config
    from repro_torch.core import mpc, replay, reward, sac
    from repro_torch.core import world_model as wm
    from repro_torch.core.networks import to_device
    from repro_torch.core.env import VecDSEEnv
    from repro_torch.core import search as search_mod
    from repro_torch.core.search import (SearchConfig, run_grid, run_random,
                                         run_sac, run_search,
                                         run_search_cells)
    from repro_torch.kernels import (actor_moe, build, flash_attention, ops,
                                     policy_mlp, screen_score, ssm_scan,
                                     sumtree, sumtree_sample)
    from repro_torch.launch import dse, serve
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import lm
    from repro_torch.optim.adam import tree_leaves
    from repro_torch.ppa import analytic as an
    from repro_torch.ppa import config_space as cs
    from repro_torch.ppa import surrogate as sur
    from repro_torch.ppa.nodes import node_params
    from repro_torch.workload.extract import extract

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = device_mod.resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    clock = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if not clock.isdigit():
        fail(f"nvidia-smi gave no maximum SM clock: {clock!r}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    global SFU_RATE
    SFU_RATE = SFU_PER_SM_CLOCK * sms * int(clock) * 1e6
    log(f"{sms} SMs, maximum SM clock {clock} MHz: {SFU_RATE:.4e} "
        "special-function results a second")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s); TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ---------------------------------------------------------
    phase_mark(2, "build")
    t0 = time.time()
    floor_build = start_floor_build(build.nvcc(), build.NVCC_FLAGS, OUT)
    lib_path = build.build(verbose=True, force=True)
    empty_launch = load_floor(*floor_build)
    log(f"built {os.path.relpath(lib_path, ROOT)} in {time.time() - t0:.1f} s")
    print(build.last_build_log, flush=True)
    build.library()

    # ---- 3. parity on the card -------------------------------------------
    phase_mark(3, "parity on the card")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    actor = sac.create(SEED, dev).params.actor
    sur_params = sur.Surrogate.create(82, seed=SEED + 2, device=dev).params
    errs = {name: 0.0 for name in ops.KERNELS}
    names = ("disc", "mu", "log_std", "gate")
    # a fresh actor's heads (x1e-2) and gate (x0.01) keep every output near
    # 0.  "hot" scales the heads x5 and the gate x100 (one expert takes most
    # of the weight) and sets the head biases so that a third of the
    # log_std columns straddle each clip and a third of the mu columns sit
    # in the tanh's saturated tails.  Larger head weights would put the
    # outputs there too, but fp32 rounding grows with the summed terms and
    # would exceed the tolerance for any order of summation.
    hot = {k: ({"w": v["w"] * 5.0, "b": v["b"].clone()} if k in (
        "disc", "mu", "log_std") else v) for k, v in actor.items()}
    hot["gate"] = actor["gate"] * 100.0
    col = torch.arange(30, device=dev) % 3
    hot["log_std"]["b"][:, col == 0] = -20.0
    hot["log_std"]["b"][:, col == 2] = 2.0
    hot["mu"]["b"][:, col == 0] = -4.0
    hot["mu"]["b"][:, col == 2] = 4.0
    for label, params in (("init", actor), ("hot", hot)):
        for b in (1, 33, 64, 192, 448):
            s = torch.randn((b, 52), generator=gen, device=dev)
            got = actor_moe.actor_forward_cuda(params, s)
            torch.cuda.synchronize()
            with torch.no_grad():
                want = actor_moe.actor_forward_plain(params, s)
                # the plain version in fp64: how far fp32 rounding alone
                # moves the result
                exact = actor_moe.actor_forward_plain(
                    to_device(params, torch.float64), s.double())
            for name, g, w, x in zip(names, got, want, exact):
                err = float((g - w).abs().max())
                errs["actor_moe"] = max(errs["actor_moe"], err)
                log(f"parity actor_moe {label} B={b} {name}: max abs err "
                    f"{err:.3e} (plain fp32 vs fp64 "
                    f"{float((w.double() - x).abs().max()):.3e})")
                if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
                    fail(f"actor_moe {label} B={b} {name} disagrees with "
                         f"the plain version (max abs err {err:.3e})")
            _, mu, log_std, gate = want
            shares = dict(
                log_std_at_min=float((log_std == -20.0).float().mean()),
                log_std_at_max=float((log_std == 2.0).float().mean()),
                tanh_saturated=float((mu.abs() > 0.999).float().mean()),
                gate_top=float(gate.max(-1).values.mean()))
            log(f"parity actor_moe {label} B={b} inputs: "
                + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
            # (one row at B = 1 cannot reach every region; the batches
            # around it do)
            if label == "hot" and b > 1 and min(shares["log_std_at_min"],
                                                shares["log_std_at_max"],
                                                shares["tanh_saturated"]) \
                    == 0.0:
                fail(f"actor_moe hot B={b}: the inputs miss a clip or "
                     "the tanh's saturated region")
    for b, k in ((33, 4), (64, 4), (448, 4)):
        s = torch.randn((b, 52), generator=gen, device=dev)
        cand = torch.rand((b, k, 30), generator=gen, device=dev) * 2 - 1
        w = torch.softmax(torch.randn((b, 3), generator=gen, device=dev), -1)
        got = screen_score.screen_scores_cuda(sur_params, s, cand, w)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = screen_score.screen_scores_plain(sur_params, s, cand, w)
        err = float((got - want).abs().max())
        errs["screen_score"] = max(errs["screen_score"], err)
        log(f"parity screen_score B={b} K={k}: max abs err {err:.3e}")
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"screen_score B={b} K={k} disagrees with the plain version "
                 f"(max abs err {err:.3e})")
        # the picks (screen_batch, half the gates open) against the plain
        # scores' argmin on the envs whose two best differ by more than the
        # tolerance
        open_ = torch.arange(b, device=dev) % 2 == 0
        pick = sur.screen_batch(sur_params, s, cand, w, open_)
        two = want.topk(2, dim=1, largest=False).values
        apart = two[:, 1] - two[:, 0] > ATOL + RTOL * two[:, 0].abs()
        plain_pick = torch.where(open_, want.argmin(1), 0)
        log(f"parity screen_score B={b} K={k} picks: {int(apart.sum())} of "
            f"{b} envs well apart, picks equal there: "
            f"{bool(torch.equal(pick[apart], plain_pick[apart]))}")
        if not torch.equal(pick[apart], plain_pick[apart]):
            fail(f"screen_score B={b} K={k}: the kernel's picks differ from "
                 "the plain picks on well-separated envs")
    # sumtree: bitwise against the plain version (float64 sums of final
    # children), duplicates last-write-wins, a scalar broadcast, N > 1024
    # split into ordered launches; the root against the sum of the leaves
    nrng = np.random.default_rng(SEED)
    for cap in (1, 8, 100, 257, SUMTREE_CAP):
        base = replay.SumTree(cap)
        base.set_many(np.arange(cap), nrng.random(cap))
        for n in (1, 31, 32, 33, 64, 256, 448, 1024, 1500):
            idx = nrng.integers(0, cap, n)
            idx[-1] = idx[0]
            for vals in (nrng.random(n), 0.25):
                scalar = np.ndim(vals) == 0
                want = torch.as_tensor(base.tree.copy())
                sumtree.sumtree_set_many_plain(
                    want, torch.as_tensor(idx),
                    vals if scalar else torch.as_tensor(vals))
                got = torch.as_tensor(base.tree.copy(), device=dev)
                sumtree.sumtree_set_many_cuda(
                    got, torch.as_tensor(idx, device=dev),
                    vals if scalar else torch.as_tensor(vals, device=dev))
                torch.cuda.synchronize()
                got = got.cpu()
                err = float((got - want).abs().max())
                errs["sumtree"] = max(errs["sumtree"], err)
                if not torch.equal(got, want):
                    fail(f"sumtree cap {cap} N={n} scalar={scalar}: not "
                         f"bitwise the plain version (max abs err {err:.3e})")
                if not np.isclose(float(got[1]), float(got[cap:].sum()),
                                  rtol=1e-12, atol=0):
                    fail(f"sumtree cap {cap} N={n}: root != sum of leaves")
    log("parity sumtree: bitwise == plain at caps 1/8/100/257/100000, "
        "N 1/31/32/33/64/256/448/1024/1500, per-leaf values and scalar "
        "broadcast; root == sum of leaves (rtol 1e-12)")
    # sumtree_sample: bitwise against the plain descent and the host walk,
    # on trees with zero leaves (prefix sums landing on boundaries), leaves
    # on two levels, and the kernel's rounds of 6 levels ending partial (14
    # levels at 8,193, 17 at 100,000) or whole (18 at 200,000)
    for cap in (1, 8, 100, 257, 8193, SUMTREE_CAP, 2 * SUMTREE_CAP):
        host = replay.SumTree(cap)
        host.set_many(np.arange(cap),
                      nrng.integers(0, 4, cap).astype(np.float64))
        tree_d = torch.as_tensor(host.tree, device=dev)
        for n, size in ((1, cap), (33, cap), (256, max(1, cap // 2)),
                        (448, cap)):
            u = nrng.random(n)
            got = sumtree_sample.sumtree_sample_cuda(
                tree_d, torch.as_tensor(u, device=dev), size).cpu()
            want = sumtree_sample.sumtree_sample_plain(
                torch.as_tensor(host.tree), torch.as_tensor(u), size)
            walk = np.minimum([host.sample(float(v)) for v in
                               (np.arange(n) + u) * (host.total() / n)],
                              size - 1)
            errs["sumtree_sample"] = max(errs["sumtree_sample"], float(
                (got - want).abs().max()))
            if not (torch.equal(got, want)
                    and np.array_equal(got.numpy(), walk)):
                fail(f"sumtree_sample cap {cap} N={n}: indices differ from "
                     "the plain descent or the host SumTree walk")
    log("parity sumtree_sample: bitwise == plain and host SumTree walk at "
        "caps 1/8/100/257/8193/100000/200000, N 1/33/256/448")
    # the device PER against the host SumTree: the same inserts and
    # priority refreshes, then the host descent on the buffer's own uniforms
    buf = replay.PERBuffer(52, 30, 4, seed=SEED, device=dev)
    host = replay.SumTree(buf.capacity)
    for rnd in range(6):
        n = 448
        host.set_many((buf.pos + np.arange(n)) % buf.capacity,
                      buf.max_priority ** replay.ALPHA_PER)
        buf.add_batch(*(np.zeros(shape, dt) for shape, dt in (
            ((n, 52), np.float32), ((n, 30), np.float32),
            ((n, 4), np.int32), (n, np.float32), ((n, 52), np.float32),
            (n, np.float32))))
        for _ in range(4):
            state = buf.rng.bit_generator.state
            _, idx = buf.sample(256)
            u_rng = np.random.default_rng()
            u_rng.bit_generator.state = state
            us = (np.arange(256) + u_rng.random(256)) * (host.total() / 256)
            want_idx = np.minimum([host.sample(float(u)) for u in us],
                                  buf.size - 1)
            if not np.array_equal(idx.cpu().numpy(), want_idx):
                fail(f"device PER round {rnd}: sampled indices differ from "
                     "the host SumTree descent")
            td = np.abs(nrng.normal(size=256)).astype(np.float32) * 3
            buf.update_priorities(idx, torch.as_tensor(td, device=dev))
            host.set_many(idx.cpu().numpy(), (np.abs(td) + replay.EPS_P)
                          ** replay.ALPHA_PER)
        if not np.array_equal(buf.tree.cpu().numpy(), host.tree):
            fail(f"device PER round {rnd}: tree differs from the host's")
    log("parity device PER: 6 rounds of 448 inserts + 4 x 256 refreshes, "
        "sampled indices and float64 tree == host SumTree")
    # fused_mlp: fp32 at rtol 1e-4 / atol 1e-5, bf16 input at 3e-2
    mlp_ws = {}
    for d_out in (3, 52):
        mlp_ws[d_out] = [torch.randn(shape, generator=gen, device=dev) * 0.1
                         for shape in ((82, 128), (128,), (128, 64), (64,),
                                       (64, d_out), (d_out,))]
    for b, d_out in ((448, 3), (4096, 52), (28672, 52), (33, 3), (33, 52),
                     (17, 3), (4225, 52)):
        for dtype, rtol, atol in ((torch.float32, RTOL, ATOL),
                                  (torch.bfloat16, 3e-2, 3e-2)):
            x = torch.randn((b, 82), generator=gen, device=dev).to(dtype)
            with torch.no_grad():
                got = policy_mlp.fused_mlp_cuda(x, *mlp_ws[d_out])
                torch.cuda.synchronize()
                want = policy_mlp.fused_mlp_plain(x, *mlp_ws[d_out])
            err = float((got.float() - want.float()).abs().max())
            if dtype == torch.float32:
                errs["fused_mlp"] = max(errs["fused_mlp"], err)
            log(f"parity fused_mlp [{b},82]->{d_out} {str(dtype)[6:]}: max "
                f"abs err {err:.3e}")
            if got.dtype != dtype or not torch.allclose(
                    got.float(), want.float(), rtol=rtol, atol=atol):
                fail(f"fused_mlp [{b},82]->{d_out} {dtype} disagrees with "
                     f"the plain version (max abs err {err:.3e})")
    # fused_mlp at the index surrogate's serving widths, 82 -> 32 -> 16 ->
    # 3, before anything uses them (phase 12 holds them again at the
    # index's training-set size)
    serve_ws = [torch.randn(shape, generator=gen, device=dev) * 0.3
                for shape in ((82, 32), (32,), (32, 16), (16,), (16, 3),
                              (3,))]
    for b in (1, 17, 333, 4225):
        x = torch.randn((b, 82), generator=gen, device=dev)
        with torch.no_grad():
            got = policy_mlp.fused_mlp_cuda(x, *serve_ws)
            torch.cuda.synchronize()
            want = policy_mlp.fused_mlp_plain(x, *serve_ws)
        err = float((got - want).abs().max())
        log(f"parity fused_mlp [{b},82]->32->16->3: max abs err {err:.3e}")
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"fused_mlp [{b},82]->32->16->3 disagrees with the plain "
                 f"version (max abs err {err:.3e})")
    # the batched env step on the card against the same step on the CPU
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3)
    env_gpu = VecDSEEnv(wl, NODE, batch=N_ENVS, seed=SEED, device=dev)
    env_cpu = VecDSEEnv(wl, NODE, batch=N_ENVS, seed=SEED, device="cpu")
    o_g, o_c = env_gpu.reset(), env_cpu.reset()
    if not (torch.equal(env_gpu.cfg.cpu(), env_cpu.cfg)
            and np.allclose(o_g, o_c, rtol=1e-5, atol=1e-6)):
        fail("env reset on the card disagrees with the CPU")
    rng = np.random.default_rng(SEED)
    for step in range(5):
        a_c = rng.uniform(-1, 1, (N_ENVS, 30)).astype(np.float32)
        a_d = rng.integers(0, 5, (N_ENVS, 4)).astype(np.int32)
        s_g, r_g, i_g = env_gpu.step(a_c, a_d)
        s_c, r_c, i_c = env_cpu.step(a_c, a_d)
        keep = np.arange(an.M_DIM) != an.M_IDX["mem_overuse_mb"]
        ok = (np.array_equal(i_g.feasible, i_c.feasible)
              and np.allclose(s_g, s_c, rtol=1e-5, atol=1e-6)
              and np.allclose(r_g, r_c, rtol=1e-5, atol=1e-6)
              and np.allclose(i_g.metrics[:, keep], i_c.metrics[:, keep],
                              rtol=1e-5, atol=1e-6))
        if not ok:
            fail(f"env step {step} on the card disagrees with the CPU")
    log("parity env step: card == CPU over 5 steps (rtol 1e-5, atol 1e-6)")
    # MPC rollouts (actor_moe + fused_mlp) on the card against the CPU
    nets_cpu = [sac.create(SEED, "cpu").params.actor,
                wm.create(SEED + 1, "cpu").params,
                sur.Surrogate.create(82, seed=SEED + 2).params]
    g_cpu = torch.Generator().manual_seed(SEED)
    s_cpu = torch.randn((N_ENVS, 52), generator=g_cpu)
    noise = torch.randn((N_ENVS, mpc.K_CANDIDATES, 30), generator=g_cpu)
    a_cpu = mpc.plan(*nets_cpu, s_cpu, noise=noise)
    a_gpu = mpc.plan(*[to_device(t, dev) for t in nets_cpu], s_cpu.to(dev),
                     noise=noise.to(dev)).cpu()
    if not torch.allclose(a_gpu, a_cpu, rtol=RTOL, atol=ATOL):
        fail("mpc.plan on the card picks other candidates than on the CPU")
    log(f"parity mpc.plan: card == CPU for {N_ENVS} states x "
        f"{mpc.K_CANDIDATES} candidates")
    # flash_attention against its plain version: the reference's sweep,
    # ragged lengths, the edges and the LM prefill's shape in fp32, fp16
    # and bf16 (fp16 and bf16 run one tensor-core kernel, fp32 the 3xTF32
    # one), and sequence 2048 in fp32; "unaligned": q, k and v are
    # x[..., 1:65] of [..., 66] tensors, not 16-byte aligned, so loaded
    # element by element
    cases = [(c, dt, False) for c in ATTN_CASES + [ATTN_LM]
             for dt in (torch.float32, torch.float16, torch.bfloat16)]
    cases += [((2, 8, 2, 150, 150, 64, True, 0), dt, True)
              for dt in (torch.float32, torch.float16, torch.bfloat16)]
    cases += [(ATTN_2048, torch.float32, False)]
    cases += [(ATTN_WINDOW, dt, False)
              for dt in (torch.float32, torch.float16, torch.bfloat16)]
    for (B, H, Hk, Sq, Sk, hd, causal, window), dt, unaligned in cases:
        pad = int(unaligned)
        q, k, v = (torch.randn((B, n, S, hd + 2 * pad), generator=gen,
                               device=dev).to(dt)[..., pad:pad + hd]
                   for n, S in ((H, Sq), (Hk, Sk), (Hk, Sk)))
        with torch.no_grad():
            got = flash_attention.flash_attention_cuda(
                q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = flash_attention.flash_attention_plain(
                q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"parity flash_attention B={B} H={H} Hk={Hk} Sq={Sq} Sk={Sk} "
            f"hd={hd} causal={causal} window={window} {str(dt)[6:]}"
            f"{' unaligned' if unaligned else ''}: max abs err {err:.3e}")
        if got.dtype != dt or not err < ATTN_TOL[dt]:
            fail(f"flash_attention {(B, H, Hk, Sq, Sk, hd, causal, window)} "
                 f"{dt} disagrees with the plain version (max abs err "
                 f"{err:.3e})")
    for B, S, D, N in SSM_CASES:
        ins = (torch.rand((B, S, D), generator=gen, device=dev) * 0.1 + 1e-3,
               torch.randn((B, S, N), generator=gen, device=dev),
               torch.randn((B, S, N), generator=gen, device=dev),
               torch.randn((B, S, D), generator=gen, device=dev),
               -torch.exp(0.5 * torch.randn((D, N), generator=gen,
                                            device=dev)))
        for h0 in (None, torch.randn((B, D, N), generator=gen, device=dev)):
            with torch.no_grad():
                got = ssm_scan.ssm_scan_cuda(*ins, h0)
                torch.cuda.synchronize()
                want = ssm_scan.ssm_scan_plain(*ins, h0)
            for name, g_, w_ in zip(("y", "h_final"), got, want):
                err = float((g_ - w_).abs().max())
                errs["ssm_scan"] = max(errs["ssm_scan"], err)
                log(f"parity ssm_scan B={B} S={S} D={D} N={N} h0="
                    f"{h0 is not None} {name}: max abs err {err:.3e}")
                if not torch.allclose(g_, w_, rtol=1e-4, atol=1e-4):
                    fail(f"ssm_scan {(B, S, D, N)} {name} disagrees with "
                         f"the plain version (max abs err {err:.3e})")

    # ---- 4. timing --------------------------------------------------------
    phase_mark(4, "timing")
    timings = {}
    nbytes = lambda tree: sum(t.numel() * 4 for t in tree_leaves(tree))

    def timed(key, shape, kernel, plain, work, plain_in_graph=True,
              plain_calls=20, unit="fp32", library=None):
        with torch.no_grad():
            ms, call = device_ms(kernel), call_ms(kernel)
            plain_call = call_ms(plain, n=200 if plain_calls == 20 else 10,
                                 warm=20 if plain_calls == 20 else 2)
            plain_ms = device_ms(plain, calls=plain_calls,
                                 replays=200 // plain_calls) \
                if plain_in_graph else plain_call
            library_ms = None if library is None else device_ms(library)
        bnd, by, term = bound_ms(*work[:2], unit=unit,
                                 sfu_ops=work[2] if len(work) > 2 else 0.0)
        timings[key] = (ms, plain_ms, bnd, by, term, call, library_ms)
        # a 3xTF32 kernel's bound beside the fp32-FMA one it replaced
        fma = "" if unit != "tf32x3" else \
            f" (fp32 FMA: {1e6 * work[0] / PEAK_FP32_FLOPS:.4f})"
        log(f"time {key[0]} {shape}: ms {ms:.5f} plain_ms {plain_ms:.5f} "
            f"bound_us {1e3 * bnd:.4f}{fma} bound_by {by} ({term}) "
            f"library_ms {library_ms} | eager call_ms {call:.5f} "
            f"plain_call_ms {plain_call:.5f}")

    for b in (64, 192, 448):
        s = torch.randn((b, 52), generator=gen, device=dev)
        timed(("actor_moe", b), f"B={b}",
              lambda: actor_moe.actor_forward_cuda(actor, s),
              lambda: actor_moe.actor_forward_plain(actor, s),
              actor_work(b, nbytes(actor)))
    # the single search's shape, a campaign batch's and K_MAX
    for b, k in ((64, 4), (448, 4), (64, 8)):
        s = torch.randn((b, 52), generator=gen, device=dev)
        cand = torch.rand((b, k, 30), generator=gen, device=dev) * 2 - 1
        w = torch.softmax(torch.randn((b, 3), generator=gen, device=dev), -1)
        timed(("screen_score", f"{b}x{k}"), f"B={b} K={k}",
              lambda: screen_score.screen_scores_cuda(sur_params, s, cand, w),
              lambda: screen_score.screen_scores_plain(sur_params, s, cand,
                                                       w),
              screen_work(b, k, nbytes(sur_params)), unit="tf32x3")

    tree = torch.as_tensor(np.random.default_rng(1).random(2 * SUMTREE_CAP),
                           device=dev)
    for n in (64, 256, 448):
        idx_np = np.random.default_rng(n).integers(0, SUMTREE_CAP, n)
        idx = torch.as_tensor(idx_np, device=dev)
        vals = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        # the plain version synchronises (torch.unique, a host loop over the
        # bands), so it cannot be captured: its time is the eager one
        timed(("sumtree", n), f"N={n} cap={SUMTREE_CAP}",
              lambda: sumtree.sumtree_set_many_cuda(tree, idx, vals),
              lambda: sumtree.sumtree_set_many_plain(tree, idx, vals),
              sumtree_work(idx_np, SUMTREE_CAP, False), plain_in_graph=False)
    # the inserts' shape: a contiguous run of leaves and a scalar
    # (PERBuffer.add_batch), 64 a dispatch in the single cell, 448 in a
    # campaign batch
    for n in (64, 448):
        idx_np = (SUMTREE_CAP - 17 + np.arange(n)) % SUMTREE_CAP
        idx = torch.as_tensor(idx_np, device=dev)
        timed(("sumtree", f"insert{n}"), f"N={n} contiguous scalar "
              f"cap={SUMTREE_CAP}",
              lambda: sumtree.sumtree_set_many_cuda(tree, idx, 0.5),
              lambda: sumtree.sumtree_set_many_plain(tree, idx, 0.5),
              sumtree_work(idx_np, SUMTREE_CAP, True), plain_in_graph=False)
    # what any launch costs in this harness: an empty kernel
    floor = device_ms(empty_launch)
    log(f"launch_floor_us {1e3 * floor:.4f} (an empty kernel, <<<1, 32>>>, "
        "200 launches replayed from a CUDA graph between CUDA events)")
    for n in (256, 448):
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        timed(("sumtree_sample", n), f"N={n} cap={SUMTREE_CAP}",
              lambda: sumtree_sample.sumtree_sample_cuda(tree, u,
                                                         SUMTREE_CAP),
              lambda: sumtree_sample.sumtree_sample_plain(tree, u,
                                                          SUMTREE_CAP),
              sample_work(n, SUMTREE_CAP))
    for b, d_out in ((448, 3), (4096, 52), (28672, 52)):
        x = torch.randn((b, 82), generator=gen, device=dev)
        timed(("fused_mlp", b), f"[{b},82]->{d_out}",
              lambda: policy_mlp.fused_mlp_cuda(x, *mlp_ws[d_out]),
              lambda: policy_mlp.fused_mlp_plain(x, *mlp_ws[d_out]),
              mlp_work(b, d_out, 4), unit="tf32x3")
    # flash_attention at the Llama prefill's shape (fp16; bf16 for Jamba,
    # fp32 for runs c and d) and at the paper's sequence length in fp16 and
    # fp32; the library yardstick is PyTorch's fused attention on the same
    # inputs (never called by the port)
    for shape, dt, label in ((ATTN_LM, torch.float16, "a"),
                             (ATTN_LM, torch.bfloat16, "b"),
                             (ATTN_LM, torch.float32, "c"),
                             (ATTN_2048, torch.float16, "2048"),
                             (ATTN_2048, torch.float32, "2048_fp32")):
        B, H, Hk, Sq, Sk, hd, causal, window = shape
        q = torch.randn((B, H, Sq, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Hk, Sk, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Hk, Sk, hd), generator=gen, device=dev).to(dt)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        timed(("flash_attention", label),
              f"q [{B},{H},{Sq},{hd}] k/v [{B},{Hk},{Sk},{hd}] {str(dt)[6:]} "
              "causal",
              lambda: flash_attention.flash_attention_cuda(q, k, v),
              lambda: flash_attention.flash_attention_plain(q, k, v),
              attention_work(*shape, q.element_size()),
              unit="tf32x3" if dt == torch.float32 else "half",
              library=lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    # the Mixtral window (runs e and f): the library call takes the causal
    # window as a boolean mask (True = attend)
    B, H, Hk, Sq, Sk, hd, causal, window = ATTN_WINDOW
    pos = torch.arange(Sq, device=dev)
    win_mask = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - window)
    for dt, label in ((torch.bfloat16, "e"), (torch.float32, "f")):
        q = torch.randn((B, H, Sq, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Hk, Sk, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Hk, Sk, hd), generator=gen, device=dev).to(dt)
        timed(("flash_attention", label),
              f"q [{B},{H},{Sq},{hd}] k/v [{B},{Hk},{Sk},{hd}] {str(dt)[6:]} "
              f"causal window {window}",
              lambda: flash_attention.flash_attention_cuda(
                  q, k, v, window=window),
              lambda: flash_attention.flash_attention_plain(
                  q, k, v, window=window),
              attention_work(*ATTN_WINDOW, q.element_size()),
              unit="tf32x3" if dt == torch.float32 else "half",
              plain_calls=2,
              library=lambda: sdpa(q, k, v, attn_mask=win_mask,
                                   enable_gqa=True))
    # ssm_scan at Jamba's prefill shape; the plain version is a loop of S
    # steps (7 ops each), so its graph holds 2 calls and 10 are timed eager
    B, S, D, N = SSM_CASES[0]
    ins = (torch.rand((B, S, D), generator=gen, device=dev) * 0.1 + 1e-3,
           torch.randn((B, S, N), generator=gen, device=dev),
           torch.randn((B, S, N), generator=gen, device=dev),
           torch.randn((B, S, D), generator=gen, device=dev),
           -torch.exp(0.5 * torch.randn((D, N), generator=gen, device=dev)))
    timed(("ssm_scan", "b"), f"[{B},{S},{D}] N={N} fp32",
          lambda: ssm_scan.ssm_scan_cuda(*ins),
          lambda: ssm_scan.ssm_scan_plain(*ins), ssm_work(B, S, D, N),
          plain_calls=2)

    # ---- 5. the main path -------------------------------------------------
    phase_mark(5, "the main path")
    results = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.time()
    row, = dse.run("llama3.1-8b", nodes=[NODE], mode="high-performance",
                   episodes=EPISODES, method="sac", out_dir=OUT, seed=SEED,
                   seq_len=2048, batch=3, engine="vec", n_envs=N_ENVS,
                   gate_threshold=GATE_THRESHOLD, device="cuda",
                   results=results)
    torch.cuda.synchronize()
    wall, counts, res = time.time() - t, ops.launch_counts(), results[0]
    single = (row, res)           # held by phase 11
    disp = np.asarray(res.dispatch_s)
    log(f"main path: llama3.1-8b decode, node {NODE} nm, {res.episodes_run} "
        f"env-steps in {len(disp)} dispatches of {N_ENVS} envs, "
        f"gate_threshold {GATE_THRESHOLD} (default "
        f"{sur.TAU_SUR_DEFAULT}), gate opened at env-step "
        f"{res.gate_open_episode}, screened {res.screened}, evaluated "
        f"{res.evaluated}, MPC dispatches {res.mpc_dispatches}")
    log(f"main path: wall {wall:.3f} s, loop {disp.sum():.3f} s, "
        f"env-steps/s {res.episodes_run / disp.sum():.1f} (loop) "
        f"{res.episodes_run / wall:.1f} (wall), median dispatch "
        f"{1e3 * float(np.median(disp)):.3f} ms, first dispatch "
        f"{1e3 * float(disp[0]):.3f} ms")
    log(f"main path result: mesh {row['mesh']} tok/s {row['tok_s']:.3f} "
        f"power {row['power_mw']:.3f} mW area {row['area_mm2']:.3f} mm2 "
        f"ppa_score {row['ppa_score']:.6f}")
    log(f"main path launches: {json.dumps(counts)}")
    log(f"main path: {counts['screen_score']} of {len(disp)} dispatches "
        "screened their candidates (one screen_score launch each)")
    for name in SEARCH_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")
    if res.best_metrics is None or not np.isfinite(res.best_metrics).all():
        fail("the search returned no finite best design")
    with torch.no_grad():
        cpu_m = an.evaluate(
            cs.project(torch.as_tensor(np.asarray(res.best_cfg, np.float32))),
            torch.as_tensor(np.asarray(wl.features, np.float32)),
            torch.as_tensor(an.node_vector(node_params(NODE)))).numpy()
    keep = np.arange(an.M_DIM) != an.M_IDX["mem_overuse_mb"]
    if not np.allclose(res.best_metrics[keep], cpu_m[keep], rtol=1e-5,
                       atol=1e-6) or cpu_m[an.M_IDX["feasible"]] != 1.0:
        fail("the best design's card metrics disagree with the plain CPU "
             "evaluator")
    log("main path check: best design re-evaluated on the CPU agrees "
        "(rtol 1e-5) and is feasible")

    def short(**kw):
        sc = SearchConfig(episodes=10 * N_ENVS, seed=SEED, batch_size=64,
                          warmup=64, **kw)
        r = run_search(wl, NODE, search=sc, n_envs=N_ENVS, device="cuda")
        return json.dumps(dict(
            archive=[e.to_dict() for e in r.archive.entries],
            trace=[t.__dict__ for t in r.trace],
            best=None if r.best_cfg is None else r.best_cfg.tolist()))
    if short(gate_threshold=1e9) != short(gate_threshold=1e9):
        fail("two same-seed runs on the card differ")
    if short(gate_threshold=0.0) != short(surrogate_gate=False):
        fail("a never-open gate differs from the ungated engine on the card")
    log("determinism: same-seed runs identical; closed gate == ungated")

    # where a dispatch's time goes: torch.profiler over a short search with
    # learning on from the 5th dispatch and the gate open from the 6th
    from torch.profiler import ProfilerActivity, profile
    n_disp = 12

    def profiled(label, search):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            r = search()
            torch.cuda.synchronize()
            wall_p = time.time() - t
        # device-side events only (kernels, copies): the host ops that
        # launched them carry the same time again
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and dev_time(e) > 0]
        busy_ms = sum(dev_time(e) for e in events) / 1e3
        log(f"profile {label}: {n_disp} dispatches, wall "
            f"{1e3 * wall_p:.3f} ms, loop {1e3 * sum(r.dispatch_s):.3f} ms, "
            f"median dispatch {1e3 * float(np.median(r.dispatch_s)):.3f} ms, "
            f"device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / (1e3 * wall_p):.4f}, "
            f"{sum(e.count for e in events)} device ops")
        for e in sorted(events, key=dev_time, reverse=True)[:12]:
            log(f"profile {label}:   {dev_time(e) / 1e3:10.3f} ms  "
                f"x{e.count:<6d} {e.key[:90]}")
        host = [e for e in prof.key_averages()
                if not str(e.device_type).endswith("CUDA")]
        log(f"profile {label}: host ops by self CPU time (of "
            f"{sum(e.self_cpu_time_total for e in host) / 1e3:.3f} ms):")
        for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:10]:
            log(f"profile {label}:   {e.self_cpu_time_total / 1e3:10.3f} ms"
                f"  x{e.count:<6d} {e.key[:90]}")

    profiled("B=64", lambda: run_search(wl, NODE, search=SearchConfig(
        episodes=n_disp * N_ENVS, seed=SEED, gate_threshold=1e9),
        n_envs=N_ENVS, device="cuda"))

    # ---- 6. the campaign path ---------------------------------------------
    phase_mark(6, "the campaign path")
    # the paper's grid through the port's CLI
    import shutil
    shutil.rmtree(CAMPAIGN_ROOT, ignore_errors=True)
    os.makedirs(CAMPAIGN_ROOT)

    def drive_campaign(grid, json_name):
        """Run ``grid`` through the port's CLI under CAMPAIGN_ROOT, with
        run_batch wrapped to keep each batch's SearchResults (dispatch
        times, MPC count, best designs) and the launch counts set to 0 just
        before and read just after; returns (store, {batch_id: (batch,
        wall, results)}, wall, counts)."""
        batch_results = {}
        real_run_batch = runner.run_batch

        def recording_run_batch(store, batch, workload, spec, device="cuda"):
            t = time.time()
            res = real_run_batch(store, batch, workload, spec, device=device)
            torch.cuda.synchronize()
            batch_results[batch.batch_id] = (batch, time.time() - t, res)
            return res

        grid_path = os.path.join(CAMPAIGN_ROOT, json_name)
        with open(grid_path, "w") as f:
            json.dump(grid, f)
        runner.run_batch = recording_run_batch
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.time()
        try:
            dse.main(["--campaign", grid_path, "--campaign-root",
                      CAMPAIGN_ROOT, "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            runner.run_batch = real_run_batch
        wall, counts = time.time() - t, ops.launch_counts()
        store = CampaignStore.open(os.path.join(CAMPAIGN_ROOT, grid["name"]))
        return store, batch_results, wall, counts

    def check_cells(label, store, batch_results, grid):
        """Log each batch and cell; each cell's best design must be its
        stored summary's and agree, re-evaluated on the CPU by the plain
        evaluator on the cell's own workload, and be feasible.  Returns
        the dispatch times of the grid."""
        grid_disp = []
        for batch_id, (batch, wall_b, res) in sorted(batch_results.items()):
            disp = np.asarray(res[0].dispatch_s)
            grid_disp.extend(disp.tolist())
            log(f"{label} {batch_id}: wall {wall_b:.3f} s, {len(disp)} "
                f"dispatches of {len(batch.node_nms) * grid['lanes']} envs, "
                f"median dispatch {1e3 * float(np.median(disp)):.3f} ms, "
                f"first {1e3 * float(disp[0]):.3f} ms, MPC dispatches "
                f"{res[0].mpc_dispatches}")
            hp = batch.mode == "high_perf"
            wl_b = extract(get_config(batch.arch), seq_len=grid["seq_len"],
                           batch=grid["batch"], phase=batch.phase,
                           dtype=batch.dtype)
            for cell, r in zip(batch.cells, res):
                summ = store.load_summary(cell.cell_id)
                log(f"{label}   {cell.cell_id}: ppa_score "
                    f"{summ['ppa_score']} frontier {summ['frontier']} gate "
                    f"open at {summ['gate_open_episode']} screened "
                    f"{summ['screened']} evaluated {summ['evaluated']}"
                    + (f" ttft_ms {summ['ttft_ms']} slo_ok {summ['slo_ok']}"
                       if "ttft_ms" in summ else ""))
                if r.best_cfg is None:
                    continue
                if summ["ppa_score"] != float(r.best_metrics[
                        an.M_IDX["ppa_score"]]):
                    fail(f"{cell.cell_id}: stored summary disagrees with "
                         "the search result")
                with torch.no_grad():
                    cpu_m = an.evaluate(
                        cs.project(torch.as_tensor(
                            np.asarray(r.best_cfg, np.float32))),
                        torch.as_tensor(np.asarray(wl_b.features,
                                                   np.float32)),
                        torch.as_tensor(an.node_vector(
                            node_params(cell.node_nm, low_power=not hp),
                            high_perf=hp))).numpy()
                if not np.allclose(r.best_metrics[keep], cpu_m[keep],
                                   rtol=1e-5, atol=1e-6) \
                        or cpu_m[an.M_IDX["feasible"]] != 1:
                    fail(f"{cell.cell_id}: the best design's card metrics "
                         "disagree with the plain CPU evaluator")
        return grid_disp

    with UtilSampler() as camp_util:
        store, batch_results, camp_wall, camp_counts = drive_campaign(
            GRID, "paper_grid.json")
    if not store.all_done() or len(store.summaries()) != 28 \
            or len(batch_results) != 4:
        fail(f"campaign: {len(store.summaries())} of 28 cells done in "
             f"{len(batch_results)} batches")
    log(f"campaign: 28 cells in 4 batches, wall {camp_wall:.3f} s; "
        f"{camp_util.describe()}; launches {json.dumps(camp_counts)}")
    for name in ("sumtree", "sumtree_sample", "fused_mlp"):
        if camp_counts[name] <= 0:
            fail(f"kernel {name} was never launched on the campaign path")
    camp_disp = check_cells("campaign", store, batch_results, GRID)
    n_best = sum(r.best_cfg is not None for _, _, res in
                 batch_results.values() for r in res)
    log(f"campaign check: {n_best} of 28 cells found a feasible design; "
        "each re-evaluated on the CPU agrees (rtol 1e-5) and is feasible; "
        f"median dispatch over the grid {1e3 * float(np.median(camp_disp)):.3f}"
        f" ms, MPC dispatches "
        f"{sum(res[0].mpc_dispatches for _, _, res in batch_results.values())}"
        f" of {len(camp_disp)}")
    first = min(batch_results.values(), key=lambda v: v[0].index)[0]
    profiled("B=448", lambda: run_search_cells(
        extract(get_config(first.arch), seq_len=GRID["seq_len"],
                batch=GRID["batch"]), list(first.node_nms),
        high_perf=first.mode == "high_perf", search=SearchConfig(
            episodes=n_disp * GRID["lanes"], seed=SEED),
        lanes_per_cell=GRID["lanes"], device="cuda")[0])

    # ---- 7. kill/resume on the card --------------------------------------
    phase_mark(7, "kill/resume on the card")
    kill_path = os.path.join(CAMPAIGN_ROOT, "kill_grid.json")
    with open(kill_path, "w") as f:
        json.dump(KILL_GRID, f)
    kill_roots = [os.path.join(CAMPAIGN_ROOT, part) for part in ("a", "b")]
    dse.main(["--campaign", kill_path, "--campaign-root", kill_roots[0],
              "--device", "cuda"])
    real_save = search_mod._save_search_ckpt
    saves = []

    def killing_save(*args, **kw):
        out = real_save(*args, **kw)
        saves.append((os.path.basename(args[0]), args[1]))
        if len(saves) == 2:
            raise KeyboardInterrupt("simulated kill after checkpoint 2")
        return out

    search_mod._save_search_ckpt = killing_save
    try:
        dse.main(["--campaign", kill_path, "--campaign-root", kill_roots[1],
                  "--device", "cuda"])
        fail("the killed campaign ran to its end")
    except KeyboardInterrupt:
        log(f"kill/resume: killed after checkpoints (batch, dispatch) "
            f"{saves}")
    finally:
        search_mod._save_search_ckpt = real_save
    dse.main(["--resume", os.path.join(kill_roots[1], KILL_GRID["name"]),
              "--device", "cuda"])
    a, b = (CampaignStore.open(os.path.join(r, KILL_GRID["name"]))
            for r in kill_roots)
    if not (a.all_done() and b.all_done()):
        fail("kill/resume: a run did not finish")
    if "high_perf" not in saves[-1][0]:
        fail(f"kill/resume: the kill landed in {saves[-1][0]}, not in the "
             "high-performance batch")
    sizes = {}
    for cid in a.manifest["cells"]:
        sizes[cid] = len(a.load_archive(cid))
        if "high_perf" in cid and not sizes[cid]:
            fail(f"kill/resume: {cid} found no design, so its resume would "
                 "compare empty frontiers")
        sa, sb = ({k: v for k, v in st.load_summary(cid).items()
                   if k != "wall_s"} for st in (a, b))
        fa, fb = (st.load_archive(cid).frontier() for st in (a, b))
        if sa != sb or fa.keys() != fb.keys() or not all(
                np.array_equal(np.sort(fa[k]), np.sort(fb[k])) for k in fa):
            fail(f"kill/resume: {cid} differs from the uninterrupted run")
    log(f"kill/resume: resumed summaries (but wall_s) and frontiers == the "
        f"uninterrupted run's; frontier sizes {json.dumps(sizes)}")

    # ---- 14. the dry-run cells start, each a process on the host's idle
    # cores beside phases 8-13 (fake tensors: no card, no device memory) --
    phase_mark(14, "the dry-run cells start, beside phases 8-13")
    dry_out = os.path.join(OUT, "dryrun")
    dry_runs = start_dryruns(dry_out)

    # ---- 8. LM serving -----------------------------------------------------
    phase_mark(8, "LM serving")
    # each run through serve's own inputs + generate, the kernels' launches
    # counted around it; then the same weights and prompts with the two
    # kernels' plain versions put in their place (the package has no switch
    # for that: the names the model calls are patched here).  Each path is
    # warmed up first by a 2-token generation (cuBLAS and the allocator).
    # A MoE router's top-k is discontinuous: a 1-ulp change in its input can
    # flip a near-tie, and the flipped token's output (and, through the
    # Mamba state and attention, every later position's) moves by far more
    # than the kernels' rounding.  So the plain path's prefill routes each
    # token to the experts the kernel path picked (gates recomputed from its
    # own router), and the log counts the picks that would have differed.
    lm_counts = {"flash_attention": 0, "ssm_scan": 0}
    real_route = blocks_mod._route
    for label, arch, changes, batch, prompt_len, gen_tokens, tol in LM_RUNS:
        cfg = dataclasses.replace(get_config(arch), **changes)
        kinds = lm.decoder_kinds(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        params, prompts, ctx = serve.inputs(cfg, batch, prompt_len, SEED, dev)
        torch.cuda.synchronize()
        n_params = sum(t_.numel() for t_ in tree_leaves(params))
        log(f"lm {label}: {arch} {json.dumps(changes)} ({cfg.n_layers} "
            f"layers: {kinds.count('attn')} attention, {kinds.count('mamba')}"
            f" Mamba; {cfg.param_dtype}; {n_params / 1e9:.3f} B parameters, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB) made in "
            f"{time.time() - t:.3f} s; batch {batch}, prompt {prompt_len}, "
            f"{gen_tokens} tokens")
        runs, routes, flips = {}, [], []

        def recording_route(p, ht, top_k):
            gv, idx = real_route(p, ht, top_k)
            if ht.shape[0] != batch:          # the prefill's routes
                routes.append(idx)
            return gv, idx

        def pinned_route(p, ht, top_k):
            if ht.shape[0] == batch:          # decode: free
                return real_route(p, ht, top_k)
            idx = routes[len(flips)]
            probs = blocks_mod._router_probs(p, ht)
            free = torch.topk(probs, top_k, dim=-1).indices
            flips.append(int((free.sort(-1).values != idx.sort(-1).values)
                             .any(-1).sum()))
            return probs.gather(-1, idx), idx

        for path in ("kernels", "plain"):
            patches = [mock.patch.object(blocks_mod, "_route",
                                         recording_route)]
            if path == "plain":
                patches = [
                    mock.patch.object(attention_mod, "flash_attention",
                                      flash_attention.flash_attention_plain),
                    mock.patch.object(blocks_mod, "ssm_scan",
                                      ssm_scan.ssm_scan_plain),
                    mock.patch.object(blocks_mod, "_route", pinned_route)]
            for p_ in patches:
                p_.start()
            try:
                serve.generate(params, cfg, prompts, 2, ctx)    # warm-up
                routes_warm, flips[:] = list(routes), []
                routes[:] = [] if path == "kernels" else routes_warm
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                g = serve.generate(params, cfg, prompts, gen_tokens, ctx)
                torch.cuda.synchronize()
                counts_lm = ops.launch_counts()
            finally:
                for p_ in patches:
                    p_.stop()
            runs[path] = g
            finite = bool(torch.isfinite(g.prefill_logits).all())
            log(f"lm {label} {path}: prefill_ms {1e3 * g.t_prefill:.3f} "
                f"decode_tok_s {g.tok_s:.3f} ({gen_tokens - 1} steps, "
                f"{1e3 * g.t_decode / (gen_tokens - 1):.3f} ms each) "
                f"peak_mem_gb {torch.cuda.max_memory_allocated() / 1e9:.3f} "
                f"logits finite {finite}; launches "
                f"flash_attention {counts_lm['flash_attention']} ssm_scan "
                f"{counts_lm['ssm_scan']}")
            if not finite:
                fail(f"lm {label} {path}: prefill logits are not finite")
            want = dict(flash_attention=kinds.count("attn"),
                        ssm_scan=kinds.count("mamba"))
            if path == "plain":
                want = dict(flash_attention=0, ssm_scan=0)
            else:
                for name in lm_counts:
                    lm_counts[name] += counts_lm[name]
            for name, n in want.items():
                if counts_lm[name] != n:
                    fail(f"lm {label} {path}: {name} launched "
                         f"{counts_lm[name]} times, not {n}")
        a_, b_ = (runs[p_].prefill_logits.float() for p_ in ("kernels",
                                                              "plain"))
        scale = float(b_.abs().max())
        err = float((a_ - b_).abs().max())
        same = float((runs["kernels"].tokens == runs["plain"].tokens).mean())
        log(f"lm {label} check: prefill logits max abs err {err:.4e} of max "
            f"|logit| {scale:.4f} (share {err / scale:.3e}, tolerance "
            f"{tol if tol is not None else 'none: a reading'});"
            f" greedy tokens agree {same:.4f}; tokens "
            f"{runs['kernels'].tokens.shape}; prefill router calls pinned "
            f"{len(flips)}, tokens whose free pick would differ {flips}")
        if tol is not None and not err <= tol * scale:
            fail(f"lm {label}: prefill logits through the kernels differ "
                 "from the plain versions'")
        if cfg.param_dtype == "float32" and same != 1.0:
            fail(f"lm {label}: greedy tokens through the kernels differ "
                 "from the plain versions'")
        # where a short generation's time goes: the prefill and 8 decode
        # steps through the kernels under torch.profiler
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            serve.generate(params, cfg, prompts, 9, ctx)
            torch.cuda.synchronize()
            wall_p = time.time() - t
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and dev_time(e) > 0]
        busy_ms = sum(dev_time(e) for e in events) / 1e3
        log(f"lm {label} profile: prefill + 8 decode steps, wall "
            f"{1e3 * wall_p:.3f} ms, device busy {busy_ms:.3f} ms, idle "
            f"share {1 - busy_ms / (1e3 * wall_p):.4f}, "
            f"{sum(e.count for e in events)} device ops")
        for e in sorted(events, key=dev_time, reverse=True)[:8]:
            log(f"lm {label} profile:   {dev_time(e) / 1e3:10.3f} ms  "
                f"x{e.count:<6d} {e.key[:90]}")
        for e in events:     # the port's own LM kernels, wherever they rank
            if "flash_attention_kernel" in e.key or "ssm_scan_kernel" in e.key:
                log(f"lm {label} profile: port kernel {dev_time(e) / 1e3:.3f}"
                    f" ms x{e.count} {e.key[:90]}")
        del params, prompts, ctx, runs, g, a_, b_
    for name in lm_counts:
        if lm_counts[name] <= 0:
            fail(f"kernel {name} was never launched on the LM path")

    # ---- 9. the scenario path ----------------------------------------------
    phase_mark(9, "the scenario path")
    def hold_slo_picks(label, store, batch_results, grid):
        """Where a cell found designs, its SLO pick, ``ttft_ms`` and
        ``slo_ok`` recomputed on the CPU from its stored frontier: each
        entry re-evaluated under the prefill workload by the plain
        evaluator, the pick the argmin of ``slo_objective`` (rtol 1e-5 for
        ties), TTFT at rtol 1e-5 and the verdict equal.  Returns how many
        cells had a pick."""
        picked = 0
        for batch, _, res in batch_results.values():
            hp = batch.mode == "high_perf"
            slo = reward.resolve_slo(grid["slo"], batch.mode)
            aux = extract(get_config(batch.arch), seq_len=grid["seq_len"],
                          batch=grid["batch"], phase="prefill",
                          dtype=batch.dtype)
            wl_b = extract(get_config(batch.arch), seq_len=grid["seq_len"],
                           batch=grid["batch"], phase=batch.phase,
                           dtype=batch.dtype)
            for cell, r in zip(batch.cells, res):
                summ = store.load_summary(cell.cell_id)
                ents = store.load_archive(cell.cell_id).entries
                if not ents:
                    if "ttft_ms" in summ or r.best_cfg is not None:
                        fail(f"{cell.cell_id}: an SLO pick without designs")
                    continue
                node = torch.as_tensor(an.node_vector(
                    node_params(cell.node_nm, low_power=not hp),
                    high_perf=hp))
                with torch.no_grad():
                    cfgs = cs.project(torch.as_tensor(
                        np.stack([e.cfg for e in ents]).astype(np.float32)))
                    pre = an.evaluate(cfgs, torch.as_tensor(aux.features),
                                      node).numpy()
                    own = an.evaluate(cfgs, torch.as_tensor(wl_b.features),
                                      node).numpy()
                ttfts = [reward.ttft_ms(p_[an.M_IDX["tok_s"]],
                                        grid["seq_len"], grid["batch"])
                         for p_ in pre]
                objs = np.asarray([reward.slo_objective(
                    e.ppa_score, e.tok_s, t_, slo)
                    for e, t_ in zip(ents, ttfts)])
                at = [i for i, e in enumerate(ents)
                      if np.array_equal(e.cfg, r.best_cfg)]
                if not at or objs[at[0]] > objs.min() * (1 + 1e-5) + 1e-9:
                    fail(f"{cell.cell_id}: the pick is not the argmin of "
                         "slo_objective over the stored frontier")
                i = at[0]
                ok = bool(own[i, an.M_IDX["tok_s"]] >= slo["tok_s"]
                          and ttfts[i] <= slo["ttft_ms"])
                if not np.isclose(summ["ttft_ms"], ttfts[i], rtol=1e-5,
                                  atol=0) or summ["slo_ok"] != ok:
                    fail(f"{cell.cell_id}: ttft_ms {summ['ttft_ms']} / "
                         f"slo_ok {summ['slo_ok']} differ from the CPU's "
                         f"{ttfts[i]} / {ok}")
                picked += 1
        log(f"{label} check: {picked} cells with an SLO pick; each pick "
            "the argmin of slo_objective over its stored frontier, its "
            "ttft_ms (rtol 1e-5) and slo_ok recomputed on the CPU")
        return picked

    def same_frontiers(label, a, b):
        """Every cell's frontier of store ``a`` bitwise that of ``b``."""
        sizes = []
        for cid in a.manifest["cells"]:
            fa, fb = (st_.load_archive(cid).frontier() for st_ in (a, b))
            if fa.keys() != fb.keys() or not all(
                    np.array_equal(fa[k], fb[k]) for k in fa):
                fail(f"{label}: {cid}'s frontier moved with the SLO")
            sizes.append(len(a.load_archive(cid)))
        log(f"{label}: frontiers with and without the SLO bitwise equal "
            f"over {len(sizes)} cells (sizes {sizes})")

    scen = dict(SCEN_GRID, slo=reward.DEFAULT_SLOS)
    scen_store, scen_batches, scen_wall, scen_counts = drive_campaign(
        scen, "scenario_grid.json")
    if not scen_store.all_done() or len(scen_store.summaries()) != 24 \
            or len(scen_batches) != 8:
        fail(f"scenario grid: {len(scen_store.summaries())} of 24 cells "
             f"done in {len(scen_batches)} batches")
    log(f"scenario grid: 24 cells in 8 batches, wall {scen_wall:.3f} s; "
        f"launches {json.dumps(scen_counts)}")
    for name in ("actor_moe", "sumtree", "sumtree_sample", "fused_mlp"):
        if scen_counts[name] <= 0:
            fail(f"kernel {name} was never launched on the scenario path")
    scen_disp = check_cells("scenario", scen_store, scen_batches, scen)
    log(f"scenario grid: median dispatch "
        f"{1e3 * float(np.median(scen_disp)):.3f} ms over "
        f"{len(scen_disp)} dispatches")
    hold_slo_picks("scenario grid", scen_store, scen_batches, scen)
    short = [drive_campaign(dict(scen, name=f"scenario-512-{tag}",
                                 episodes=512, slo=slo_), f"s512{tag}.json")[0]
             for tag, slo_ in (("slo", scen["slo"]), ("none", None))]
    same_frontiers("scenario grid at 512 episodes", *short)
    # the SLO pick where cells find designs: Llama 3.1 8B's axes, with and
    # without the SLO
    held = dict(SLO_GRID, slo=reward.DEFAULT_SLOS)
    held_store, held_batches, held_wall, held_counts = drive_campaign(
        held, "slo_grid.json")
    log(f"slo grid: {len(held_store.summaries())} cells in "
        f"{len(held_batches)} batches, wall {held_wall:.3f} s; launches "
        f"{json.dumps(held_counts)}")
    check_cells("slo grid", held_store, held_batches, held)
    if hold_slo_picks("slo grid", held_store, held_batches, held) == 0:
        fail("slo grid: no cell found a design, so no SLO pick was held")
    plain_store = drive_campaign(dict(held, name="slo-grid-none", slo=None),
                                 "slo_grid_none.json")[0]
    same_frontiers("slo grid", held_store, plain_store)

    # ---- 10. the scalar engine and the baselines ---------------------------
    phase_mark(10, "the scalar engine and the baselines")
    # through dse.run, as the CLI's --engine scalar and --method random|grid
    # drive them; the launch counts set to 0 before and read after each
    scalar = {}
    for method, episodes in (("sac", SCALAR_EPISODES), ("random", EPISODES),
                             ("grid", EPISODES)):
        res_l = []
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.time()
        row, = dse.run("llama3.1-8b", nodes=[NODE], mode="high-performance",
                       episodes=episodes, method=method,
                       out_dir=os.path.join(OUT, "scalar"), seed=SEED,
                       seq_len=2048, batch=3, engine="scalar",
                       device="cuda", results=res_l)
        torch.cuda.synchronize()
        wall_s, counts_s, r = time.time() - t, ops.launch_counts(), res_l[0]
        scalar[method] = (wall_s, counts_s, r)
        loop = sum(r.dispatch_s) if r.dispatch_s else wall_s
        log(f"scalar {method}: {r.episodes_run} env-steps in {wall_s:.3f} s "
            f"({r.episodes_run / loop:.1f} env-steps/s over the loop, "
            f"{r.episodes_run / wall_s:.1f} over the wall), feasible "
            f"{r.feasible_count}, frontier {len(r.archive)}, MPC steps "
            f"{r.mpc_dispatches}; mesh {row['mesh']} ppa_score "
            f"{row['ppa_score']:.6f}; launches {json.dumps(counts_s)}")
        if r.best_cfg is None:
            fail(f"scalar {method}: no feasible design found")
        with torch.no_grad():
            cpu_m = an.evaluate(
                cs.project(torch.as_tensor(np.asarray(r.best_cfg,
                                                      np.float32))),
                torch.as_tensor(np.asarray(wl.features, np.float32)),
                torch.as_tensor(an.node_vector(node_params(NODE)))).numpy()
        if not np.allclose(r.best_metrics[keep], cpu_m[keep], rtol=1e-5,
                           atol=1e-6) or cpu_m[an.M_IDX["feasible"]] != 1:
            fail(f"scalar {method}: the chosen design's card metrics "
                 "disagree with the plain CPU evaluator")
    for name in ("actor_moe", "sumtree", "sumtree_sample"):
        if scalar["sac"][1][name] <= 0:
            fail(f"kernel {name} was never launched on the scalar path")

    def fingerprint(r):
        return json.dumps(dict(
            archive=[e.to_dict() for e in r.archive.entries],
            trace=[t_.__dict__ for t_ in r.trace],
            best=None if r.best_cfg is None else r.best_cfg.tolist()))
    again = run_sac(wl, NODE, search=SearchConfig(episodes=SCALAR_EPISODES,
                                                  seed=SEED), device="cuda")
    if fingerprint(again) != fingerprint(scalar["sac"][2]):
        fail("scalar sac: two same-seed runs on the card differ")
    for method, fn in (("random", run_random), ("grid", run_grid)):
        cpu_r = fn(wl, NODE, episodes=EPISODES, seed=SEED, device="cpu")
        card_r = scalar[method][2]
        if (len(cpu_r.archive) != len(card_r.archive)
                or cpu_r.feasible_count != card_r.feasible_count
                or not np.array_equal(cpu_r.best_cfg, card_r.best_cfg)
                or not all(np.array_equal(a_.cfg, b_.cfg) for a_, b_ in zip(
                    cpu_r.archive.entries, card_r.archive.entries))):
            fail(f"scalar {method}: the card's designs differ from a CPU "
                 "run's")
    log("scalar check: same-seed SAC runs identical; each chosen design "
        "re-evaluated on the CPU agrees (rtol 1e-5); random and grid "
        "baselines' frontiers and picks equal a CPU run's")

    # ---- 11. devices, telemetry and fleets ----------------------------------
    phase_mark(11, "devices, telemetry and fleets")
    fleet_counts = devices_telemetry_fleets(
        "cuda", wl, single, os.path.join(CAMPAIGN_ROOT, "paper_grid.json"),
        GRID["name"], os.path.join(CAMPAIGN_ROOT, GRID["name"]), kill_path,
        KILL_GRID["name"], os.path.join(kill_roots[0], KILL_GRID["name"]),
        os.path.join(CAMPAIGN_ROOT, "phase11"), camp_wall, camp_util)

    # ---- 12. recommend serving and cross-campaign transfer ------------------
    phase_mark(12, "recommend serving and cross-campaign transfer")
    phase12, serve = recommend_transfer(
        "cuda", os.path.join(CAMPAIGN_ROOT, GRID["name"]),
        os.path.join(CAMPAIGN_ROOT, "phase12"), timed=timed)

    # ---- 13. LM training and the rest of the zoo -----------------------------
    phase_mark(13, "LM training and the rest of the zoo")
    train_counts, zoo_counts = lm_training_zoo(dev, timings, errs)

    # ---- 15. sharded training on a 1x1 NCCL mesh, the dry-run results ------
    phase_mark(15, "sharded training and the production dry-run")
    mesh_counts = sharded_training(dev, card)
    finish_dryruns(dry_runs, card, dry_out)

    # ---- 16. results ------------------------------------------------------
    phase_mark(16, "results")
    # actor_moe and screen_score at the single search's shapes with its
    # launch counts; sumtree, sumtree_sample and fused_mlp at the campaign
    # batch's (B = 448; 256 samples per SAC update) with the campaign's;
    # flash_attention at LM run a's shape and ssm_scan at run b's, with the
    # LM phase's launches (runs a-f); each path's own counts beside them
    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, replaces, key, shape, path_counts in (
            ("actor_moe", "src/repro/kernels/actor_moe.py:75", 64, "B=64",
             counts),
            ("screen_score", "src/repro/kernels/screen_score.py:66", "64x4",
             "B=64,K=4", counts),
            ("sumtree", "src/repro/kernels/sumtree.py:63", 448,
             f"N=448,cap={SUMTREE_CAP}", camp_counts),
            # no TPU kernel: the reference's host loop of SumTree.sample
            ("sumtree_sample", "src/repro/core/replay.py:120", 256,
             f"N=256,cap={SUMTREE_CAP}", camp_counts),
            ("fused_mlp", "src/repro/kernels/policy_mlp.py:60", 448,
             "[448,82]->3", camp_counts),
            ("flash_attention", "src/repro/kernels/flash_attention.py:91",
             "a", "q[4,32,512,128],kv[4,8,512,128],fp16,causal", lm_counts),
            ("ssm_scan", "src/repro/kernels/ssm_scan.py:66", "b",
             "[4,512,8192],N=16,fp32", lm_counts),
            # no TPU kernel: XLA's gradient of the reference's jnp
            # attention and remat-chunked scan (phase 13's train path)
            ("flash_attention_backward", "src/repro/models/attention.py:29",
             "smollm", "q[8,9,1024,64],kv[8,3,1024,64],bf16,causal",
             train_counts),
            ("ssm_scan_backward", "src/repro/models/blocks.py:349", "c",
             "[2,512,8192],N=16,fp32", train_counts)):
        ms, plain, bnd, by, term, call, library_ms = timings[(name, key)]
        source = src + ("policy_mlp.cu" if name == "fused_mlp"
                        else name + ".cu")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            shape=shape, launches=path_counts[name], max_abs_err=errs[name],
            ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
            bound_term=term, library_ms=library_ms, call_ms=call,
            launches_by_path={path: c.get(name, 0) for path, c in (
                ("single", counts), ("campaign", camp_counts),
                ("scenario", scen_counts), ("scalar", scalar["sac"][1]),
                ("lm", lm_counts), ("train", train_counts),
                ("lm_zoo", zoo_counts), ("mesh", mesh_counts),
                *fleet_counts.items(),
                *phase12.items())}))
    # fused_mlp also at the index surrogate's serving shape (phase 12)
    ms, plain, bnd, by, term, call, library_ms = timings[("fused_mlp",
                                                          "serve")]
    next(k for k in kernels if k["name"] == "fused_mlp")["serve"] = dict(
        shape=f"[{serve['rows']},82]->32->16->3",
        max_abs_err=serve["max_abs_err"], launches=serve["launches"],
        ms=ms, plain_ms=plain,
        bound_ms=bnd, bound_by=by, bound_term=term, library_ms=library_ms,
        call_ms=call)
    print(card, flush=True)     # again here, so that a short tail holds it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
