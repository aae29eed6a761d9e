#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's prefill and serving paths at the full width of seven
models, its train step at the full width of four, and the expert-parallel
MoE, the compressed all-reduce, the GPipe runtime and the dry-run
(phases 20-23), with random weights from a seeded ``torch.Generator``:
smollm-135m (30 layers, d 576, 9/3 heads, head_dim 64, d_ff 1536, vocab
49152), xlstm-125m (12 layers: 10 mLSTM, 2 sLSTM; d 768, 4 heads,
mLSTM head dim 384, chunk 256, vocab 50304, untied head) and
jamba-v0.1-52b at 16 of its 32 layers (two periods of its 8-layer
pattern: 14 Mamba and 2 GQA attention layers, 8 MoE and 8 dense FFNs;
d 4096, 32/8 heads, head_dim 128, Mamba d_inner 8192, d_state 16, 16
experts of d_ff 14336, top-2, vocab 65536; 26.05 B params, 52.1 GB in
bf16); and the prefill of two more at full width and 2 layers, for
their head dims: stablelm-3b (d 2560, 32/32 heads, head_dim 80,
LayerNorm, rotary on 25%) and h2o-danube-3-4b (d 3840, 32/8 heads,
head_dim 120, window 4096); and the two non-token frontends at full
width and depth: musicgen-large (48 layers, d 2048, 32/32 heads,
head_dim 64, d_ff 8192, vocab 2048, LayerNorm, audio frames in place of
tokens; 3.22 B params) and llama-3.2-vision-11b (40 layers, every 5th
cross-attending to a 1600-row image; d 4096, 32/8 heads, head_dim 128,
d_ff 14336, vocab 128256; 9.78 B params); and the two MLA models at full
width, cut in depth: deepseek-v2-236b at 7 of its 60 layers (the dense
layer and 6 MoE layers; d 5120, 128 heads, MLA kv_lora 512, q_lora
1536, rope 64, nope 128, v 128; 160 routed experts of d 1536, top-6, 2
shared, capacity factor 1.25; dense d_ff 12288; vocab 102400; 25.22 B
params, 50.4 GB in bf16) and deepseek-v3-671b at 5 of its 61 (its 3
dense layers and 2 MoE layers, with the MTP head; d 7168, 128 heads, the
same MLA ranks; 256 routed experts of d 2048, top-8, 1 shared; dense
d_ff 18432; vocab 129280; 27.82 B params, 55.6 GB).  On the card:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: compiles every kernel under ``src/repro_torch/csrc`` with nvcc
   for sm_90a (one process per source, all at once);
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main paths give it, bf16 and f32, with kernel, plain and library
   times from CUDA events: RMSNorm and flash attention at 2e-2 (bf16) and
   2e-4 (f32), RMSNorm at smollm's, xlstm's and jamba's widths with 8
   and 4,096 rows (and in bf16 at deepseek-v2's and -v3's, 5120 and
   7168), each also timed as device time per launch from a CUDA
   graph's replays (``device_ms``); flash attention at smollm's shapes,
   at jamba's prefill shape (B=4, S=1024, 32/8 heads, Dh 128, causal),
   and in bf16 at stablelm-3b's (32/32 heads, Dh 80) and
   h2o-danube-3-4b's (32/8 heads, Dh 120, with window 96 and without),
   musicgen-large's (32/32 heads, Dh 64, causal) and llama-vision's
   cross-attention (Sq 1024 over Skv 1600, 32/8 heads, Dh 128,
   non-causal); flash attention and RMSNorm in bf16 at the groups of
   smollm's one-pass prefill (``PASS_SHAPES``: k prompts of S tokens,
   RMSNorm over k·S rows); the grouped matmul and RMSNorm at the shapes
   of deepseek-v2's expert-parallel decode step (``EPS_*``: 40 experts of
   32 rows, most of them zero, every group size 32, one counted launch a
   call; RMSNorm on 32 rows of 1536 and of 512);
   the mLSTM chunkwise
   kernel at B=4, S=1024, H=4, Dh=384, chunk 256 at 2e-3, the
   reference's tolerance for it (no single PyTorch call computes it, so
   it has no library time); the selective
   scan at jamba's prefill shape (B=4, S=1024, Din=8192, N=16; x bf16,
   dt f32, and all f32) at 1e-4, the reference's tolerance (no library
   call either), against ``ssd_scan_ref``, and at 1e-6 against
   ``ssd_scan_kernel_order`` (the kernel's own order and software
   exponential in plain PyTorch, which the card's ``torch.exp2`` matches
   bit for bit there); the grouped expert matmul comes after phase 10
   (11);
4. smollm prefill: ``LM.prefill`` with ``use_kernels=True`` at B=4,
   S=1024 against the plain path on the card (atol 0.25, rtol 0.1); the
   flash attention kernel must launch 30 times and the RMSNorm kernel 61;
5. smollm serve: the ``ContinuousBatcher`` with 8 slots over 16 requests
   (prompts 16-256, 32-128 new tokens, greedy, seed 0), twice: eager
   (``graphs=False``), then on CUDA graphs (``launch/graphs.py``: the
   slot batch's, built by an untimed warm-up pass over the same trace;
   both runs admit each group in one eager pass, ``LM.prefill_into``).
   First the graph of the slot batch and the eager ``decode_step`` take
   one step from zero caches on the same inputs, and their largest
   logits difference is printed.  In each run every request completes and the RMSNorm kernel
   launches at least 61 times per decode step; the graph run's launch
   counts must equal the eager run's, and its tokens the eager run's
   (a first divergence is accepted only where the eager run's top-2
   logit margin at that token is under 0.05); two requests of the graph
   run are re-decoded with ``decode_offline`` and must match token for
   token under the same rule (with the offline margin).  Then the plain
   path (``use_kernels=False``, the reference's serving path,
   ``launch/serve.py --plain``) serves the same trace from the same
   weights on graphs, launching no kernel; the kernel path's greedy
   tokens on graphs must equal its tokens, a first divergence accepted
   only where the plain run's top-2 logit margin is under 0.05.  Every
   run prints tok/s,
   p50/p99, ms per decode step, prefill s and peak memory, the graph run
   also the graphs captured and their capture seconds.  Then one decode
   step of the slot batch, eager and replayed, under ``torch.profiler``:
   the window and the device's busy and idle share of it, and the
   device time over the step's unprofiled host-clock time
   (``[decode-profile]``);
6. xlstm prefill: as 4, at B=4, S=1024; the mLSTM kernel must launch 10
   times and the RMSNorm kernel 13 (12 ``norm1`` and ``final_norm``);
   the prefill with the sLSTM recurrence replayed from its CUDA graphs
   (the default) is also timed against the host loop (``LM(...,
   graphs=False)``), with their logits difference;
7. xlstm serve: as 5, over 8 requests (prompts 16-128, 16-64 new
   tokens); the RMSNorm kernel launches at least 13 times per step;
8. stablelm-3b and h2o-danube-3-4b prefill: as 4, at 2 layers each;
   exactly 2 flash-attention launches each, and 5 RMSNorm for
   h2o-danube (stablelm's norms are LayerNorms: none);
9. jamba prefill: as 4, at B=4, S=1024; exactly 33 RMSNorm (16 ``norm1``,
   16 ``norm2``, ``final_norm``), 2 flash-attention, 14 selective-scan
   and 16 grouped-matmul launches; prints the MoE dropped fraction and
   the share of the tolerance used beside the earlier scan kernel's;
   then one more prefill under ``torch.profiler`` (CPU and CUDA
   activity), broken down on ``[prefill-breakdown]`` lines: the window,
   the device time in it and the device's busy and idle share, device
   time by category (each hand-written kernel by its symbols, cuBLAS
   GEMMs, copies and casts, other elementwise and reduction kernels, the
   rest) and the ten device operations that took the most time; the
   trace is written to ``build/traces/`` (``scripts/trace_by_operator.py``
   reads it by launching PyTorch operator);
10. jamba serve: ``run_static`` (MoE configs serve on the static path)
   with 8 slots over 8 requests (prompts 16-128, 16-64 new tokens,
   greedy), eager and then on the CUDA graph of its wave width, as 5;
   every request completes, the grouped matmul launches at least 16
   times and RMSNorm 33 per decode step, and each request whose prompt
   is its wave's longest (``run_static`` pads the others with token 0)
   is re-decoded with ``decode_offline`` under the margin rule of 5,
   with the eager run's expert choices replayed (a graph would replay
   the routing of its capture, so the pinned checks use the eager run,
   and the graph run is held to the eager run's tokens);
11. grouped matmul: once jamba is freed, as 3 at the group sizes that
   jamba's first MoE layer had in phase 9 and its last decode step in
   phase 10: the two prefill products (C=640) and the two decode products
   (C=8) in bf16 at 2e-2, and the first prefill product with F cut from
   28672 to 3584 in f32 at 2e-4 (so its f32 weights take 0.94 GB, not
   7.5), against ``torch.bmm`` as the library time; each is also checked
   with one expert's group set to 0 rows and one to C;
12. train: ``build_train_step`` on smollm-135m at full width (remat
   full, AdamW lr 1e-3 with the reference driver's cosine warm-up of 1
   step), 20 steps at B=8, S=1024 from ``ShardedLoader(SyntheticCorpus)``,
   eagerly (``graphs=False``) and then on the step's CUDA graph (its
   default on the card: the whole step captured at the first call and
   replayed), each from the seeded params (``train_pair``): the loss of
   every step, the median step ms (CUDA events, after 2 warm-up steps),
   tokens/s, model TFLOP/s (6·N_params + 6·L·S·d per token, x4/3 for
   the remat), peak memory, and the graph's capture seconds and the
   memory its run reserved, on ``[train]`` lines; the graph run must
   equal the eager run bit for bit (every metric of every step, the
   final params, moments and step counter); the mean of the last 5
   losses must be below the first, and no kernel may launch (training
   runs the plain paths, as the reference's does).  Then one more step
   of each under ``torch.profiler`` (``[train-profile]``: busy and idle
   share, operations), and the checks: remat none, full and dots
   give the same loss and gradients (1e-5 of each leaf's largest
   magnitude); ``accum_steps=2`` gives the full batch's update (rtol
   2e-2, atol 2e-3); a loss through ``use_kernels=True`` with params that
   require grad raises; one step on the card equals one on the CPU at
   B=1, S=128 (loss 1e-3 and gradient norm 1e-2 relative, each updated
   param within ``2·lr·(1 + wd·|p|)`` plus one bf16 step).  Last,
   xlstm-125m at full width, 3 steps at B=4, S=512: first eagerly with
   the sLSTM's gate weights cast to f32 at every step (the peak memory
   before the cast was hoisted out of the loop), then eager and on its
   graph as smollm's (its sLSTM loop captured in the train step's
   graph), the first loss bit-equal to the per-step cast's, and the
   largest change of the gate weights' gradients the hoisted cast makes;
13. train driver: ``repro_torch.launch.train.main`` in this process on
   smollm-135m at full width, B=8, S=1024, remat full, 10 steps, in a
   fresh temporary directory (removed at the end), on the train step's
   graph (the driver's default on the card): (a) uninterrupted, without
   checkpoints, once eagerly (``graphs=False``) and once on the graph,
   the losses bit-equal; (b) a checkpoint every 3 steps, preempted at
   step 7; (c) the same run again, which must resume from step 6 by
   copying the checkpoint into the tensors the graph holds, its four
   losses (steps 6-9) bit-equal to (a)'s.  Each run's wall seconds, the
   loop's ms per step (the gaps between the driver's calls of its
   straggler monitor, saves included) and the graphs it captured on
   ``[driver]`` lines, and the disk space free before (b).  (d) The checkpoint (``[ckpt]`` lines): (c)'s newest step restored
   into a card tree (seconds), saved again (the ms ``save()`` takes to
   return, its synchronous host copy, then the seconds of ``wait()``, the
   background write with its CRC), its bytes and leaves; restored into a
   CPU tree, which must equal the card's tree bit for bit; then one byte
   of its shard flipped: ``restore`` must raise
   ``CheckpointCorruptionError`` and ``restore_latest`` return the step
   before.  (e) No kernel may launch in (a)-(c): the driver trains on the
   plain paths, as the reference's does;
14. musicgen-large: prefill as 4 on seeded bf16 frames (B=4, S=1024):
   exactly 48 flash-attention launches and no RMSNorm (its norms are
   LayerNorms); serving as 5 over 8 requests of frames only (16-128
   positions of input, 16-64 new tokens), whose frames come from the
   scheduler's ``Draws``; then 3 train steps at B=4, S=1024, remat full,
   AdamW lr 1e-3, eager and on the graph as 12: finite losses, ms a step,
   peak memory, capture seconds, the graph bit-equal, no launch;
15. llama-3.2-vision-11b: prefill as 4 with a seeded (4, 1600, 4096) bf16
   image: exactly 40 flash-attention launches (32 causal, 8 non-causal
   over the image) and 81 RMSNorm; serving as 5 over 8 requests (prompts
   16-128, 16-64 new tokens) with a cache of 2048 positions, since the
   offline oracle writes all 1600 image rows into each cross layer's
   cache.  No training: 9.78 B params take 117 GB with AdamW's state.
   Each phase's seconds on ``[frontends]`` lines;
16. deepseek-v2-236b at 7 layers: prefill as 4 at B=4, S=1024 with
   routing pinned: exactly 15 RMSNorm, 12 grouped-matmul and no
   flash-attention launches (MLA takes no kernel, as the reference's
   takes none); the absorbed decode (``decode_step`` token by token over
   the latent cache) against the materialised ``LM.prefill`` on one
   prompt of 8 tokens, last-position logits at atol 0.25, rtol 0.1,
   the decode's expert choices replayed in the prefill; static serving
   as 10 (8 requests, prompts 16-128, 16-64 new tokens), with also the
   first request shorter than its wave's longest re-decoded, its prompt
   padded as the wave fed it; then, the model freed, the grouped
   matmul as 11 at the group sizes of its first MoE layer's prefill
   and its last decode step (both products each, bf16);
17. deepseek-v3-671b at 5 layers: as 16, with 11 RMSNorm and 4
   grouped-matmul launches a prefill; then 3 train steps at 3 layers
   (its dense layers and the MTP head, 4.81 B params) at B=2, S=1024,
   remat full, AdamW lr 1e-3 with bf16 moments, eager and on the graph
   as 12: the losses and the ``mtp`` metric finite, the moments bf16, ms
   a step, peak memory, capture seconds, the graph bit-equal, no
   launch.  Each phase's seconds on ``[deepseek]`` lines;
18. compiler: the port's HIDA compiler (``repro_torch.core``) on the
   host, in front of the paths the card runs: for each of the ten archs
   at ``train_4k`` on ``SINGLE_POD`` (``training=True``), the pre-DSE
   schedule (construct, fuse, lower, multi-producer elimination,
   balance) and ``optimize``'s plan must equal the goldens of
   ``tests/goldens/pre_dse`` (read as plain JSON files), with no
   degradation; each arch's compile seconds, with the host's CPU model
   and the card's name and power limit, on ``[compiler]`` lines; then
   the serve driver's ``fetch_plan`` for smollm-135m at phase 5's
   serving shape into a fresh temporary plan cache: cold, then a hit of
   the same plan, both times printed.  Phase 13's driver compiles its
   plan the same way (``[train] plan:``) on a mesh of one data and one
   model slot, where every constraint is the identity.  Then the lint
   CLI's ``lint_one`` (``repro_torch.lint``) on the ten smoke archs and
   ``synth_1k``, every verdict ``ok``, each target's compile seconds
   printed; ``optimize`` of ``synth_5k`` on ``SINGLE_POD`` (verifier
   clean, no degradation) and the build of ``synth_10k``, timed, on
   ``[compiler]`` lines that name the host's CPU beside the card;
19. mesh: a single-rank NCCL process group and a ``(1, 1)``
   ``("data", "model")`` ``DeviceMesh`` (``launch.mesh.make_host_mesh``),
   its set-up seconds; smollm-135m's params at full width distributed by
   ``launch.steps.sharding_tree`` under its train plan, every local shard
   bit-equal to its full tensor; then phase 13's uninterrupted driver
   run again, now through the mesh (the driver finds the process group
   and builds its ``(1, 1)`` mesh: one rank, so the step stays on its
   CUDA graph), its losses bit-equal to phase 13's, no kernel launched;
   the group is destroyed after.  On ``[mesh]`` lines;
20. ep: a new single-rank NCCL group and a ``(1, 1)`` mesh; deepseek-v2's
   first MoE layer at full width (160 experts of d 1536, top-6, 2 shared,
   capacity factor 1.25) from a seeded generator, x (4, 1024, 5120) bf16,
   through ``moe_ffn_ep`` with experts over ``("model",)`` (G = 1: the
   capacity, 192, and the slots are ``moe_ffn``'s), then again with each
   expert's d_ff split over ``"data"`` (the psum): each time the plain
   path bit-equal to ``moe_ffn`` (outputs and aux), its f32 gradients
   (x, router, ``w_in``, ``w_out``) within 2e-4 of ``moe_ffn``'s, and the
   kernel path with routing pinned (``Routing``) launching the grouped
   matmul exactly twice, within 2e-2 of the plain path; each call's
   device time (three means of ten calls, between CUDA events) and peak
   memory; then both products at the EP shapes (every
   row live) as 11, against their bounds and ``torch.bmm``; on ``[ep]``
   lines;
21. compress: a params-shaped f32 tree of smollm-135m from a seed,
   compressed on the card (``optim.compression``): int8 payloads and
   scales bit-equal to the CPU's; ``dp_allreduce_compressed`` over the
   one-rank group equal to ``decompress(q, s)`` exactly; its time against
   a plain all-reduce of the tree (``[compress]``);
22. gpipe: ``core.pipeline.gpipe`` over a one-rank ``("pod",)`` stage
   axis, S = 1, M = 8 microbatches of (16, 4096) f32, ``tanh(x @ w)``:
   bit-equal to the sequential oracle (``[gpipe]``); the group is
   destroyed after;
23. dryrun: ``repro_torch.launch.dryrun.run_cell`` in a child process
   started right after phase 1 (fake tensors over a fake process group
   cannot share a process with NCCL, and need no card, so it runs on the
   host beside phases 2-22): the reduced smollm train cell of the tests
   (``ShapeSpec("t", 512, 16, "train")`` on a (4, 2) mesh) and
   smollm-135m ``train_4k`` on the 16x16 mesh, both ``ok``; per rank
   argument and temp bytes, FLOPs and collectives by kind (counts of the
   port's program on fake tensors, not the card's) and each cell's
   seconds on the host (``[dryrun]``); the child is killed if the script
   ends first.

Each path's launch counts are set to 0 just before it and read just
after; the kernels' ``launches`` are their sums over phases 4-10,
14-17 and 20 (the serving runs on graphs, which replays count, the eager
ones only checked against them); the train runs of phases 12, 13, 14 and
17 must count none.
Each model's graphs are released before the next model is built.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero without printing that line; so does a machine without a
card, or a directory that holds this file and nothing else of the repo.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import (SHAPES, get_config, get_synth,  # noqa: E402
                                 list_archs)
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import (SINGLE_POD, MeshSpec,  # noqa: E402
                              balance_paths, build_lm_graph,
                              construct_functional,
                              eliminate_multi_producers, fuse_tasks,
                              lower_to_structural, optimize)
from repro_torch.core.ir import reset_fresh_names  # noqa: E402
from repro_torch.data import ShardedLoader, SyntheticCorpus  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as ml_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_kernel_order, ssd_scan_ref)
from repro_torch.distributed import (CheckpointManager,  # noqa: E402
                                     StragglerMonitor)
from repro_torch.distributed.checkpoint import (  # noqa: E402
    CheckpointCorruptionError, _flatten, _unflatten)
from repro_torch.launch import graphs  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.launch import scheduler as sched  # noqa: E402
from repro_torch.launch.scheduler import (ContinuousBatcher,  # noqa: E402
                                          Request, decode_offline,
                                          prefill_bucket, run_static)
from repro_torch.launch.serve import fetch_plan, make_trace  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import (build_train_step,  # noqa: E402
                                      distribute_tree, sharding_tree)
from repro_torch.lint import lint_one  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.moe import capacity_of  # noqa: E402
from repro_torch.models.layers import ParamBuilder  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig, gpipe  # noqa: E402
from repro_torch.optim import (AdamW, cosine_schedule,  # noqa: E402
                               dp_allreduce_compressed, ef_compress_tree,
                               ef_decompress_tree, init_ef_state)
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
ELT = {torch.bfloat16: 2, torch.float32: 4}
DTYPES = (torch.bfloat16, torch.float32)

ARCH = "smollm-135m"
XARCH = "xlstm-125m"
JARCH = "jamba-v0.1-52b"
#: jamba's depth here: two periods of its 8-layer pattern (of 32)
J_LAYERS = 16
#: the dense models whose head dims (80, 120) have kernel widths of
#: their own or are zero-filled to one; prefilled at 2 layers
HEAD_DIM_ARCHS = ("stablelm-3b", "h2o-danube-3-4b")
HD_LAYERS = 2
#: the sliding window of the h2o-danube kernel case (its own is 4096,
#: which S=1024 never reaches)
HD_WINDOW = 96
#: where phases 3-8 run; only a rehearsal of the script changes it
DEVICE = "cuda"
PREFILL_B, PREFILL_S = 4, 1024
SLOTS, REQUESTS, SEED = 8, 16, 0
PROMPT_RANGE, GEN_RANGE = (16, 256), (32, 128)
#: the (k, S) groups of smollm's one-pass prefill (``LM.prefill_into``):
#: phase 5's (up to 8 prompts of 16-256 tokens) and the chat benchmark
#: cell's (up to 32 of 4-473); RMSNorm runs over k·S rows there
PASS_SHAPES = ((8, 16), (8, 256), (32, 4), (32, 16), (32, 473))
#: expert-parallel serving of deepseek-v2 (``moe.moe_ffn_serve_ep``, the
#: benchmark's 4-rank cell): a rank's 32 rows a decode step, its 40 of
#: 160 experts, each taking the G·cap = 4 x 8 = 32 rows its sources' slots
#: hold, every row counted live and most of them zero
EPS_RANKS, EPS_ROWS, EPS_EXPERTS = 4, 32, 40
#: xlstm serving traffic (phase 7)
X_REQUESTS, X_PROMPT_RANGE, X_GEN_RANGE = 8, (16, 128), (16, 64)
MARGIN = 0.05
#: the reference's tolerance for the mLSTM kernel (tests/test_kernels.py)
MLSTM_TOL = 2e-3
#: ... and for the selective scan
SSD_TOL = 1e-4
#: ... and for the selective scan against its kernel-order mirror at
#: jamba's shape, where they agree bit for bit; the earlier kernel (four
#: states per lane, a shuffle reduction) differs by 2.86e-6 there
SSD_ORDER_TOL = 1e-6
#: share of the jamba prefill check's tolerance that the earlier scan
#: kernel (four states per lane) used in the same check
J_TOL_USED_EARLIER = 0.69
#: jamba serving traffic (phase 10)
J_REQUESTS, J_PROMPT_RANGE, J_GEN_RANGE = 8, (16, 128), (16, 64)
#: the f32 grouped-matmul case cuts F by this factor (weights 0.94 GB)
GMM_F32_F_CUT = 8
#: training (phase 12): smollm-135m at B=8, S=1024 with full remat, as
#: the reference's driver trains (AdamW lr 1e-3, cosine warm-up 1)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 8, 1024, 20, 2, 1e-3
#: xlstm-125m's few steps at B=4, S=512 (its sLSTM loops over 512 steps)
X_TRAIN_B, X_TRAIN_S, X_TRAIN_STEPS = 4, 512, 3
#: the card's train step against the CPU's, at B=1, S=128: loss and the
#: global gradient norm relative tolerances
PARITY_B, PARITY_S, PARITY_LOSS_RTOL, PARITY_GN_RTOL = 1, 128, 1e-3, 1e-2
#: remat modes against each other: share of each leaf's largest magnitude
#: (the embedding's backward scatter-adds with atomics)
REMAT_TOL = 1e-5
#: gradient accumulation against the full batch (tests/test_substrate.py)
ACCUM_RTOL, ACCUM_ATOL = 2e-2, 2e-3
#: the train driver (phase 13): steps, checkpoint cadence, the preempted
#: step and the step the resumed run must start from
DRIVER_STEPS, DRIVER_EVERY, DRIVER_PREEMPT, DRIVER_RESUME = 10, 3, 7, 6
#: the frontends' models (phases 14 and 15), at full width and depth
MARCH = "musicgen-large"
VARCH = "llama-3.2-vision-11b"
#: their serving traffic: 8 requests (musicgen's of frames only)
F_REQUESTS, F_PROMPT_RANGE, F_GEN_RANGE = 8, (16, 128), (16, 64)
#: llama-vision's cache: the offline oracle's scalar write puts all 1600
#: image rows into each cross layer's cache, so it must hold them
V_S_MAX = 2048
#: musicgen's train steps (its state is ~38.7 GB: 3.22 B params x 12 B)
M_TRAIN_B, M_TRAIN_S, M_TRAIN_STEPS = 4, 1024, 3
#: the deepseek models (phases 16 and 17) at full width, cut in depth:
#: deepseek-v2 to its dense layer and 6 MoE layers (of 60; 25.22 B
#: params), deepseek-v3 to its 3 dense layers and 2 MoE layers (of 61),
#: with the MTP head (27.82 B params)
DS2, DS3 = "deepseek-v2-236b", "deepseek-v3-671b"
DS2_LAYERS, DS3_LAYERS = 7, 5
#: the absorbed decode against the materialised prefill: one prompt of
#: this many tokens, which the prefill's expert capacity (at least 8)
#: holds whole, so neither path drops a token
DS_ORACLE_S = 8
#: deepseek-v3's train steps: its 3 dense layers and the MTP head (4.81 B
#: params; with gradients and bf16 moments ~38.5 GB), B=2, S=1024
DS_TRAIN_LAYERS, DS_TRAIN_B, DS_TRAIN_S, DS_TRAIN_STEPS = 3, 2, 1024, 3
#: the compiler's goldens (phase 18): per arch the pre-DSE schedule and
#: the plan at this shape on ``SINGLE_POD``
GOLDEN_DIR = ROOT / "tests" / "goldens" / "pre_dse"
GOLDEN_SHAPE = "train_4k"
#: phase 18's lint targets beside the ten smoke archs, and the synthetic
#: graphs compiled (on ``SINGLE_POD``) and built only
LINT_SYNTH, COMPILE_SYNTH, BUILD_SYNTH = "synth_1k", "synth_5k", "synth_10k"
#: phase 20: deepseek-v2's MoE layer at prefill width, and the tolerance
#: of the f32 gradients against moe_ffn's
EP_B, EP_S, EP_GRAD_TOL = 4, 1024, 2e-4
EP_GRAD_KEYS = ("w_router", "w_in", "w_out")
#: phase 20 times each call EP_REPEATS times, each a mean of EP_ITERS
EP_REPEATS, EP_ITERS = 3, 10
#: phase 22's pipeline: M microbatches of (B, D) f32
GP_M, GP_B, GP_D = 8, 16, 4096
#: seconds phase 23 waits for its child after phase 22
DRYRUN_WAIT = 300
#: the dry-run child's standard output (.out) and error (.err)
DRYRUN_LOG = ROOT / "build" / "chip_smoke" / "dryrun"


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events, after ``warmup`` calls (warm L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 100, replays: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, its replays timed with CUDA events (the host's launch path is
    out of the timing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                dtype, tol: float | None = None) -> float:
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    tol = TOL[dtype] if tol is None else tol
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {err} (tol {tol})")
    return err


COUNTED = {"rmsnorm": rms_ops.rmsnorm,
           "flash_attention": fa_ops.flash_attention,
           "mlstm_chunk": ml_ops.mlstm_chunk,
           "ssd_scan": ssd_ops.ssd_scan,
           "moe_gmm": gmm_ops.moe_gmm}


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


# -- phases --------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} built with nvcc {' '.join(_build.NVCC_FLAGS)}"
          f" in {time.perf_counter() - t0:.1f} s")


def rmsnorm_case(R: int, D: int, dtype) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(R * 7 + D)
    x = torch.randn((R, D), generator=gen, device=DEVICE).to(dtype)
    s = torch.randn((D,), generator=gen, device=DEVICE) + 1.0
    err = check_close(f"rmsnorm R={R} D={D} {dtype}",
                      rms_ops.rmsnorm(x, s), rmsnorm_ref(x, s), dtype)
    s_lib = s.to(dtype)
    b, by = bound_ms(2 * R * D * ELT[dtype] + 4 * D, 4 * R * D,
                     torch.float32)
    before = rms_ops.rmsnorm.launches
    rms_ops.rmsnorm(x, s)
    if rms_ops.rmsnorm.launches != before + 1:
        raise AssertionError("rmsnorm: not one launch per call")

    def library():
        return F.rms_norm(x, (D,), s_lib, eps=1e-6)
    # ms: back-to-back calls, which at few rows is the host's launch path;
    # device_ms: the same calls replayed from a CUDA graph
    rec = {"max_abs_err": err,
           "ms": time_ms(lambda: rms_ops.rmsnorm(x, s), iters=1000,
                         warmup=100),
           "device_ms": graph_ms(lambda: rms_ops.rmsnorm(x, s)),
           "plain_ms": time_ms(lambda: rmsnorm_ref(x, s)),
           "library_ms": time_ms(library, iters=1000, warmup=100),
           "library_device_ms": graph_ms(library),
           "bound_ms": b, "bound_by": by}
    print(f"[kernels] rmsnorm R={R} D={D} {str(dtype)[6:]}: err {err:.3g}, "
          f"kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.5f}), "
          f"plain {rec['plain_ms']:.4f} ms, F.rms_norm "
          f"{rec['library_ms']:.4f} ms (device "
          f"{rec['library_device_ms']:.5f}), bound {b:.3g} ms ({by})")
    return rec


def mha_case(B: int, S: int, H: int, KVH: int, Dh: int, window, dtype,
             Skv: int | None = None, causal: bool = True) -> dict:
    """Flash attention at S queries over ``Skv`` keys (S by default),
    causal or not (cross-attention: not, over the image's rows)."""
    Skv = Skv or S
    gen = torch.Generator(device=DEVICE).manual_seed(B * S + H + Dh)
    q = torch.randn((B, S, H, Dh), generator=gen, device=DEVICE).to(dtype)
    k = torch.randn((B, Skv, KVH, Dh), generator=gen,
                    device=DEVICE).to(dtype)
    v = torch.randn((B, Skv, KVH, Dh), generator=gen,
                    device=DEVICE).to(dtype)
    qk, kk, vk = (t.contiguous() for t in fa_ops.to_kernel_layout(q, k, v))
    tag = (f"mha B={B} S={S}" + ("" if Skv == S else f" Skv={Skv}")
           + f" H={H}/{KVH} Dh={Dh} window={window}"
           + ("" if causal else " non-causal"))
    kw = dict(causal=causal, window=window)
    err = check_close(f"{tag} {dtype}",
                      fa_ops.flash_attention(qk, kk, vk, **kw),
                      attention_ref(qk, kk, vk, **kw), dtype)
    # the same mha through the model-layout wrapper
    check_close(f"{tag} {dtype} (mha)", fa_ops.mha(q, k, v, **kw),
                fa_ops.from_kernel_layout(attention_ref(qk, kk, vk, **kw),
                                          B), dtype)
    qpos = torch.arange(S, device=DEVICE)[:, None]
    kpos = torch.arange(Skv, device=DEVICE)[None, :]
    mask = (kpos <= qpos) if causal else torch.ones(
        (S, Skv), dtype=torch.bool, device=DEVICE)
    if window is not None:
        mask &= kpos > qpos - window
    pairs = int(mask.sum())
    ops = 2 * (Dh + Dh) * pairs * B * H
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * ELT[dtype]
    b, by = bound_ms(nbytes, ops, dtype)
    kl, vl = kk[:, None], vk[:, None]          # (B·KVH, 1, Skv, Dh)

    def library():
        if window is None:
            return F.scaled_dot_product_attention(qk, kl, vl,
                                                  is_causal=causal,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qk, kl, vl, attn_mask=mask,
                                              enable_gqa=True)
    rec = {"max_abs_err": err,
           "ms": time_ms(lambda: fa_ops.flash_attention(qk, kk, vk, **kw),
                         iters=20),
           "plain_ms": time_ms(lambda: attention_ref(qk, kk, vk, **kw),
                               iters=10),
           "library_ms": time_ms(library, iters=20),
           "bound_ms": b, "bound_by": by}
    print(f"[kernels] {tag} {str(dtype)[6:]}: err {err:.3g}, kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, sdpa "
          f"{rec['library_ms']:.4f} ms, bound {b:.3g} ms ({by}; "
          f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP)")
    return rec


def mlstm_flops(B: int, S: int, H: int, Dh: int, L: int) -> float:
    """FLOPs of the chunkwise algorithm at chunk ``L``, counted once per
    head: causal ``q kᵀ`` and ``w v`` inside each chunk, the read of C
    and n by every query, and the rank-L update of C and n."""
    pairs = (S // L) * L * (L + 1) // 2 + (S % L) * (S % L + 1) // 2
    per_head = 2 * (2 * pairs * Dh + 2 * S * Dh * Dh + 2 * S * Dh)
    return float(B * H * per_head)


def mlstm_case(B: int, S: int, H: int, Dh: int, chunk: int, dtype) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(B * S + H + Dh)

    def rnd(*shape, shift=0.0):
        return (torch.randn(shape, generator=gen, device=DEVICE)
                + shift).to(dtype)
    q, k, v = (rnd(B, S, H, Dh) for _ in range(3))
    i_pre, f_pre = rnd(B, S, H), rnd(B, S, H, shift=2.0)
    tag = f"mlstm_chunk B={B} S={S} H={H} Dh={Dh} chunk={chunk}"

    def kernel():
        return ml_ops.mlstm_chunk(q, k, v, i_pre, f_pre, chunk=chunk)

    def plain():
        return ml_ops.mlstm_chunk_plain(q, k, v, i_pre, f_pre, chunk=chunk)
    err = check_close(f"{tag} {dtype}", kernel(), plain(), dtype,
                      tol=MLSTM_TOL)
    nbytes = (3 * q.numel() + 2 * i_pre.numel()) * ELT[dtype] \
        + 4 * q.numel()
    ops = mlstm_flops(B, S, H, Dh, ml_ops.KERNEL_CHUNK)
    b, by = bound_ms(nbytes, ops, dtype)
    peak = PEAK_OPS_PER_S[dtype]
    rec = {"max_abs_err": err, "ms": time_ms(kernel, iters=20),
           "plain_ms": time_ms(plain, iters=10), "library_ms": None,
           "library": "none: no single PyTorch call computes the mLSTM "
                      "chunkwise recurrence",
           "bound_ms": b, "bound_by": by,
           "bound_peak": f"{peak / 1e12:g} TFLOP/s ({str(dtype)[6:]}), "
                         f"{HBM_BYTES_PER_S / 1e12:g} TB/s"}
    print(f"[kernels] {tag} {str(dtype)[6:]}: err {err:.3g}, kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, no library "
          f"call, bound {b:.3g} ms ({by}; {ops / 1e9:.2f} GFLOP at the "
          f"{rec['bound_peak']} peaks)")
    return rec


#: H100 SXM: 132 SMs, 16 MUFU results per SM per clock, 1.98 GHz boost
MUFU_PER_S = 132 * 16 * 1.98e9


def ssd_case(B: int, S: int, Din: int, N: int, chunk: int, x_dtype) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(B * S + Din + N)
    x = torch.randn((B, S, Din), generator=gen, device=DEVICE).to(x_dtype)
    dt = torch.rand((B, S, Din), generator=gen, device=DEVICE) * 0.19 + 0.01
    A = -(torch.rand((Din, N), generator=gen, device=DEVICE) * 1.5 + 0.5)
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device=DEVICE)
              .to(x_dtype) for _ in range(2))
    tag = f"ssd_scan B={B} S={S} Din={Din} N={N} x {str(x_dtype)[6:]}"

    def kernel():
        return ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)

    def plain():
        return ssd_scan_ref(x, dt, A, Bm, Cm)
    got = kernel()
    err = check_close(tag, got, plain(), torch.float32, tol=SSD_TOL)
    err_order = check_close(f"{tag} (kernel order)", got,
                            ssd_scan_kernel_order(x, dt, A, Bm, Cm),
                            torch.float32, tol=SSD_ORDER_TOL)
    del got
    elt = ELT[x_dtype]
    nbytes = (x.numel() * elt + dt.numel() * 4 + A.numel() * 4
              + 2 * Bm.numel() * elt + 4 * x.numel())
    ops = float(B * S * Din * (7 * N + 1))
    b, by = bound_ms(nbytes, ops, torch.float32)
    rec = {"max_abs_err": err, "max_abs_err_kernel_order": err_order,
           "ms": time_ms(kernel, iters=20),
           "plain_ms": time_ms(plain, iters=3, warmup=1), "library_ms": None,
           "library": "none: no single PyTorch call computes the selective "
                      "scan",
           "bound_ms": b, "bound_by": by}
    # printed only: exp can also run on the FMA units, so this is no bound
    mufu_ms = B * S * Din * N / MUFU_PER_S * 1e3
    print(f"[kernels] {tag}: err {err:.3g} ({err_order:.3g} against the "
          f"kernel order), kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, no library call, bound {b:.3g} ms "
          f"({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP f32), "
          f"{B * S * Din * N / 1e6:.0f} M exp need {mufu_ms:.3g} ms "
          "of the MUFU")
    return rec


def group_sizes(ids: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """An MoE layer's grouped-matmul ``group_sizes`` from its router's
    expert ids (T, K): each expert's copies, capped at its capacity."""
    return torch.bincount(ids.reshape(-1), minlength=E).clamp(max=C) \
        .to(torch.int32)


def gmm_case(gs: torch.Tensor, C: int, D: int, F: int, dtype) -> dict:
    """The grouped matmul at the group sizes ``gs`` that the main path
    gave it; checked there and with one expert empty and one full."""
    E = gs.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(E * C + D + F)
    x = torch.randn((E, C, D), generator=gen, device=DEVICE, dtype=dtype)
    w = torch.randn((E, D, F), generator=gen, device=DEVICE, dtype=dtype) \
        * D ** -0.5
    tag = f"moe_gmm E={E} C={C} D={D} F={F} {str(dtype)[6:]}"

    def kernel(gs=gs):
        return gmm_ops.moe_gmm(x, w, gs, c_block=C, f_block=F, d_block=D)
    edge = gs.clone()
    edge[0], edge[-1] = 0, C
    check_close(f"{tag} group sizes {edge.tolist()}", kernel(edge),
                moe_gmm_ref(x, w, edge), dtype)
    err = check_close(tag, kernel(), moe_gmm_ref(x, w, gs), dtype)
    rows = int(gs.sum())
    used = int((gs > 0).sum())
    nbytes = (rows * D + used * D * F + E * C * F) * ELT[dtype] + 4 * E
    ops = 2.0 * rows * D * F
    b, by = bound_ms(nbytes, ops, dtype)
    rec = {"max_abs_err": err, "ms": time_ms(kernel, iters=10),
           "plain_ms": time_ms(lambda: moe_gmm_ref(x, w, gs), iters=3,
                               warmup=1),
           "library_ms": time_ms(lambda: torch.bmm(x, w), iters=10),
           "library": "torch.bmm (all C rows)",
           "bound_ms": b, "bound_by": by}
    print(f"[kernels] {tag} at group sizes {gs.tolist()} ({rows} of "
          f"{E * C} rows live): err {err:.3g}, "
          f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
          f"torch.bmm {rec['library_ms']:.4f} ms, bound {b:.3g} ms ({by}; "
          f"{nbytes / 1e9:.3f} GB, {ops / 1e12:.3f} TFLOP)")
    return rec


def ep_serve_gmm_case(D: int, F: int, cap: int) -> dict:
    """The grouped matmul as a rank of expert-parallel serving runs it: its
    ``EPS_EXPERTS`` experts over ``C = EPS_RANKS·cap`` rows each, the
    slots a source filled (0-3 of its ``cap``) first in its chunk, zero
    rows after them, and every group size ``C``."""
    E, G = EPS_EXPERTS, EPS_RANKS
    C = G * cap
    gen = torch.Generator(device=DEVICE).manual_seed(E * C + D + F)
    x = torch.randn((E, G, cap, D), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    filled = torch.randint(0, 4, (E, G, 1, 1), generator=gen, device=DEVICE)
    x = (x * (torch.arange(cap, device=DEVICE)[None, None, :, None]
              < filled)).reshape(E, C, D)
    w = torch.randn((E, D, F), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16) * D ** -0.5
    gs = torch.full((E,), C, dtype=torch.int64, device=DEVICE)
    tag = (f"moe_gmm E={E} C={C} D={D} F={F} bf16 (expert-parallel decode, "
           f"{int((filled > 0).sum())} of {E * G} source chunks live)")
    before = gmm_ops.moe_gmm.launches
    got = gmm_ops.moe_gmm(x, w, gs, c_block=math.gcd(C, 128),
                          f_block=math.gcd(F, 512), d_block=math.gcd(D, 512))
    if gmm_ops.moe_gmm.launches != before + 1:
        raise AssertionError(f"{tag}: not one counted launch per call")
    err = check_close(tag, got, moe_gmm_ref(x, w, gs), torch.bfloat16)
    zero = (x.float().abs().amax(-1) == 0)
    if bool((got.float().abs().amax(-1)[zero] != 0).any()):
        raise AssertionError(f"{tag}: a zero row gave a nonzero output")
    nbytes = (E * C * D + E * D * F + E * C * F) * 2 + 8 * E
    b, by = bound_ms(nbytes, 2.0 * E * C * D * F, torch.bfloat16)
    rec = {"max_abs_err": err, "ms": time_ms(lambda: gmm_ops.moe_gmm(
               x, w, gs, c_block=math.gcd(C, 128), f_block=math.gcd(F, 512),
               d_block=math.gcd(D, 512)), iters=20),
           "plain_ms": time_ms(lambda: moe_gmm_ref(x, w, gs), iters=3,
                               warmup=1),
           "library_ms": time_ms(lambda: torch.bmm(x, w), iters=20),
           "library": "torch.bmm (all C rows)",
           "bound_ms": b, "bound_by": by}
    print(f"[kernels] {tag}: err {err:.3g}, kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, torch.bmm "
          f"{rec['library_ms']:.4f} ms, bound {b:.3g} ms ({by})")
    return rec


def phase_ep_serve_kernels() -> dict:
    """The kernels at the shapes of deepseek-v2's expert-parallel decode
    step (``EPS_*``): both grouped-matmul products, and RMSNorm on the
    rank's rows' compressed query (q_lora) and kv latent (kv_lora)."""
    cfg = get_config(DS2)
    D, Fe, m = cfg.d_model, cfg.moe.d_expert, cfg.mla
    cap = capacity_of(EPS_ROWS, cfg.moe)
    out = {("gmm", "ep_serve", 1): ep_serve_gmm_case(D, 2 * Fe, cap),
           ("gmm", "ep_serve", 2): ep_serve_gmm_case(Fe, D, cap)}
    for width in (m.q_lora, m.kv_lora):
        out[("rmsnorm", EPS_ROWS, width, torch.bfloat16)] = rmsnorm_case(
            EPS_ROWS, width, torch.bfloat16)
    torch.cuda.empty_cache()
    return out


def phase_kernels() -> dict:
    cfg = get_config(ARCH)
    D, H, KVH, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    out = {}
    for dtype in DTYPES:
        for R in (SLOTS, PREFILL_B * PREFILL_S):
            out[("rmsnorm", R, dtype)] = rmsnorm_case(R, D, dtype)
        for (S, h, kvh, window) in ((PREFILL_S, H, KVH, None),
                                    (PREFILL_S, H, KVH, 96),
                                    (PREFILL_S, KVH, KVH, None),
                                    (1000, H, KVH, None)):
            out[("mha", S, h, kvh, window, dtype)] = mha_case(
                PREFILL_B, S, h, kvh, Dh, window, dtype)
    for k, S in PASS_SHAPES:
        out[("mha", "pass", k, S)] = mha_case(k, S, H, KVH, Dh, None,
                                              torch.bfloat16)
        out[("rmsnorm", "pass", k * S)] = rmsnorm_case(k * S, D,
                                                       torch.bfloat16)
    for arch in HEAD_DIM_ARCHS:
        hcfg = get_config(arch)
        for window in ((None, HD_WINDOW) if hcfg.attn_window else (None,)):
            out[("mha", arch, window)] = mha_case(
                PREFILL_B, PREFILL_S, hcfg.n_heads, hcfg.n_kv_heads,
                hcfg.resolved_head_dim, window, torch.bfloat16)
    xcfg = get_config(XARCH)
    xH = xcfg.n_heads
    xDh = xcfg.xlstm.proj_factor_mlstm * xcfg.d_model // xH
    for dtype in DTYPES:
        for R in (SLOTS, PREFILL_B * PREFILL_S):
            out[("rmsnorm", R, xcfg.d_model, dtype)] = rmsnorm_case(
                R, xcfg.d_model, dtype)
        out[("mlstm", dtype)] = mlstm_case(PREFILL_B, PREFILL_S, xH, xDh,
                                           xcfg.xlstm.chunk, dtype)
    jcfg = get_config(JARCH)
    for dtype in DTYPES:
        out[("mha", PREFILL_S, jcfg.n_heads, jcfg.n_kv_heads, None,
             dtype)] = mha_case(PREFILL_B, PREFILL_S, jcfg.n_heads,
                                jcfg.n_kv_heads, jcfg.resolved_head_dim,
                                None, dtype)
        for R in (SLOTS, PREFILL_B * PREFILL_S):
            out[("rmsnorm", R, jcfg.d_model, dtype)] = rmsnorm_case(
                R, jcfg.d_model, dtype)
    mcfg, vcfg = get_config(MARCH), get_config(VARCH)
    out[("mha", MARCH)] = mha_case(PREFILL_B, PREFILL_S, mcfg.n_heads,
                                   mcfg.n_kv_heads, mcfg.resolved_head_dim,
                                   None, torch.bfloat16)
    out[("mha", "cross")] = mha_case(PREFILL_B, PREFILL_S, vcfg.n_heads,
                                     vcfg.n_kv_heads,
                                     vcfg.resolved_head_dim, None,
                                     torch.bfloat16, Skv=vcfg.n_img_tokens,
                                     causal=False)
    for arch in (DS2, DS3):
        d = get_config(arch).d_model
        for R in (SLOTS, PREFILL_B * PREFILL_S):
            out[("rmsnorm", R, d, torch.bfloat16)] = rmsnorm_case(
                R, d, torch.bfloat16)
    out.update(phase_ep_serve_kernels())
    mb = jcfg.mamba
    for x_dtype in DTYPES:
        out[("ssd", x_dtype)] = ssd_case(PREFILL_B, PREFILL_S,
                                         mb.expand * jcfg.d_model,
                                         mb.d_state, mb.chunk, x_dtype)
    torch.cuda.empty_cache()
    return out


def phase_gmm_kernels(arch: str, prefill_ids: list, decode_ids: list,
                      f32_case: bool = False) -> dict:
    """The grouped matmul at the group sizes of ``arch``'s first MoE layer
    in its prefill (phase 9, 16 or 17) and of its last decode step in
    serving (phase 10, 16 or 17: all ``SLOTS`` rows active, ``top_k``
    copies each); ``f32_case`` adds the first prefill product in f32 with
    F cut.  Run after the model is freed, since the plain version widens
    the weights to f32."""
    cfg = get_config(arch)
    moe = cfg.moe
    D, E, Fe = cfg.d_model, moe.n_experts, moe.d_expert
    cap = capacity_of(PREFILL_B * PREFILL_S, moe)
    dcap = capacity_of(SLOTS, moe)
    live = [int(group_sizes(ids, E, cap).sum()) for ids in prefill_ids]
    print(f"[kernels] {arch} prefill: live grouped-matmul rows by MoE layer "
          f"{live} of {E * cap}")
    out = {}
    for ids, C, tag in ((prefill_ids[0], cap, "prefill"),
                        (decode_ids[-1], dcap, "decode")):
        gs = group_sizes(ids, E, C)
        out[("gmm", arch, tag, 1)] = gmm_case(gs, C, D, 2 * Fe,
                                              torch.bfloat16)
        torch.cuda.empty_cache()
        out[("gmm", arch, tag, 2)] = gmm_case(gs, C, Fe, D, torch.bfloat16)
        torch.cuda.empty_cache()
    if f32_case:
        out[("gmm", arch, "f32")] = gmm_case(
            group_sizes(prefill_ids[0], E, cap), cap, D,
            2 * Fe // GMM_F32_F_CUT, torch.float32)
    torch.cuda.empty_cache()
    return out


def expected_prefill_counts(cfg) -> dict:
    """Kernel launches of one prefill: a norm before every mixer, one
    before every FFN, the final norm; one flash-attention launch per
    attention layer (GQA: MLA has none), one mLSTM launch per mLSTM layer,
    one selective scan per Mamba layer and two grouped matmuls per MoE
    FFN."""
    kinds = cfg.layer_kinds()
    norms = cfg.n_layers + 1 + sum(f != "none" for _, f in kinds)
    return {"rmsnorm": norms if cfg.norm == "rms" else 0,
            # MLA takes no kernel, as the reference's takes none
            "flash_attention": 0 if cfg.mla else sum(
                m in ("attn", "xattn") for m, _ in kinds),
            "mlstm_chunk": sum(m == "mlstm" for m, _ in kinds),
            "ssd_scan": sum(m == "mamba" for m, _ in kinds),
            "moe_gmm": 2 * sum(f == "moe" for _, f in kinds)}


class Routing:
    """Records the experts ``moe.router_topk`` chooses in one run, and
    replays that choice in a later one: each call then returns the
    recorded expert ids, with gates from its own router probabilities at
    those experts.  A top-k choice is discontinuous: one bf16 step in a
    router input can swap a near-tied expert, and with random weights an
    expert's output dominates its token's residual, so two paths that
    round differently part far beyond any tolerance after a few MoE
    layers.  Pinning the choice compares what the kernels compute."""

    def __init__(self):
        self.ids: list[torch.Tensor] = []
        self._orig = moe_mod.router_topk

    def _record(self, x, w_router, moe):
        gate, idx, aux = self._orig(x, w_router, moe)
        self.ids.append(idx)
        return gate, idx, aux

    def _replay(self, x, w_router, moe):
        _, _, aux = self._orig(x, w_router, moe)
        idx = self.ids[self._next]
        if self._row is not None:
            idx = idx[self._row:self._row + 1]
        self._next += 1
        probs = torch.softmax((x.to(torch.float32) @ w_router), dim=-1)
        gate = probs.gather(-1, idx)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return gate, idx, aux

    def run(self, fn, replay: bool, start: int = 0, row: int | None = None):
        """``fn()`` recording, or replaying from call ``start`` on (only
        batch row ``row`` of each recorded choice, if given)."""
        self._next, self._row = start, row
        moe_mod.router_topk = self._replay if replay else self._record
        try:
            return fn()
        finally:
            moe_mod.router_topk = self._orig


def step_inputs(cfg, B: int, S: int, gen) -> dict:
    """Seeded inputs of ``B`` rows of ``S`` positions on the card: tokens,
    or bf16 frames for the audio frontend, and the vision frontend's
    bf16 image."""
    if cfg.frontend == "audio_frames":
        batch = {"frames": torch.randn((B, S, cfg.d_model), generator=gen,
                                       device=DEVICE).to(torch.bfloat16)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                         device=DEVICE)}
    if cfg.frontend == "vision":
        batch["img_embeds"] = torch.randn(
            (B, cfg.n_img_tokens, cfg.d_model), generator=gen,
            device=DEVICE).to(torch.bfloat16)
    return batch


def prefill_batch(cfg) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    return step_inputs(cfg, PREFILL_B, PREFILL_S, gen)


def phase_prefill(lm_k: LM, lm_p: LM, params, iters: int = 5,
                  used_earlier: float | None = None) -> tuple[dict, list]:
    """Launch counts of one prefill, and the expert ids each MoE layer's
    router chose in it.  ``used_earlier``: the share of the tolerance an
    earlier kernel used in this check, printed beside this run's."""
    cfg = lm_k.cfg
    batch = prefill_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    routing = Routing()
    reset_counts()
    got, aux = routing.run(lambda: lm_k.prefill(params, batch,
                                                 with_aux=True), False)
    torch.cuda.synchronize()
    counts = read_counts()
    moe_note = ""
    if routing.ids:
        # the kernel path against the plain path with its own routing,
        # reported; the check below pins the routing
        own = Routing()
        free = own.run(lambda: lm_p.prefill(params, batch), False)
        moved = sum(int((a != b).any(-1).sum())
                    for a, b in zip(routing.ids, own.ids))
        fe = (got.float() - free.float()).abs().max().item()
        fa = (got.float().argmax(-1) == free.float().argmax(-1)) \
            .float().mean().item()
        moe_note = (f"; MoE dropped fraction {aux.dropped_fraction.item():.4f}"
                    f" (mean over MoE layers); with its own routing the "
                    f"plain path moves {moved} of "
                    f"{len(own.ids) * PREFILL_B * PREFILL_S} token choices "
                    f"and parts by {fe:.4f} (argmax agreement {fa:.2f}); "
                    "the check pins the kernel path's routing")
    want = routing.run(lambda: lm_p.prefill(params, batch), bool(routing.ids))
    ms_k = time_ms(lambda: lm_k.prefill(params, batch), iters=iters,
                   warmup=1)
    ms_p = time_ms(lambda: lm_p.prefill(params, batch), iters=iters,
                   warmup=1)
    if any(m == "slstm" for m, _ in cfg.layer_kinds()):
        # the default replays the sLSTM recurrence from CUDA graphs
        # (captured in the first prefill above); against the host loop
        loop = dataclasses.replace(lm_k, graphs=False)
        by_loop = loop.prefill(params, batch)
        d = (got.float() - by_loop.float()).abs().max().item()
        ms_loop = time_ms(lambda: loop.prefill(params, batch), iters=iters,
                          warmup=1)
        moe_note += (f"; the sLSTM recurrence replayed from CUDA graphs "
                     f"{ms_k:.2f} ms against looped from the host "
                     f"{ms_loop:.2f} ms, logits max abs diff {d:.4g}")
    if counts != expected_prefill_counts(cfg):
        raise AssertionError(f"{cfg.name} prefill launches {counts}, "
                             f"expected {expected_prefill_counts(cfg)}")
    if got.shape != (PREFILL_B, 1, cfg.vocab) or \
            not torch.isfinite(got.float()).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite")
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, atol=0.25, rtol=0.1):
        raise AssertionError(f"prefill kernel path vs plain: max abs err "
                             f"{err} (atol 0.25, rtol 0.1)")
    agree = (g.argmax(-1) == w.argmax(-1)).float().mean().item()
    # the largest share of the allowed difference that any logit uses
    used = ((g - w).abs() / (0.25 + 0.1 * w.abs())).max().item()
    earlier = ("" if used_earlier is None else
               f"; {used_earlier:.2f} with the earlier scan kernel")
    print(f"[prefill] {cfg.name} B={PREFILL_B} S={PREFILL_S}: logits vs "
          f"plain max abs err {err:.4f} (max |logit| "
          f"{w.abs().max().item():.3f}, {used:.2f} of the tolerance used"
          f"{earlier}), "
          f"argmax agreement {agree:.2f}; launches {counts}; "
          f"{ms_k:.2f} ms with kernels, {ms_p:.2f} ms plain; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB{moe_note}")
    return counts, routing.ids


#: symbols of the hand-written kernels (``csrc/*.cu``), by wrapper
KERNEL_SYMBOLS = {
    "rmsnorm": ("rmsnorm_kernel",),
    "flash_attention": ("flash_bf16_kernel", "flash_f32_kernel"),
    "mlstm_chunk": ("mlstm_state_kernel", "mlstm_out_kernel"),
    "ssd_scan": ("ssd_scan_kernel",),
    "moe_gmm": ("gmm_bf16_wgmma_kernel", "gmm_bf16_decode_kernel",
                "gmm_zero_rows_kernel", "gmm_f32_kernel")}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_category(name: str, cat: str) -> str:
    """A device operation's category.  Copies come before the elementwise
    kernels, since PyTorch's copy and cast kernels are elementwise
    templates (``direct_copy_kernel_cuda`` inside
    ``vectorized_elementwise_kernel``)."""
    for kernel, symbols in KERNEL_SYMBOLS.items():
        if any(sym in name for sym in symbols):
            return kernel
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cublas")):
        return "cublas_gemm"
    if cat != "kernel" or "copy" in low or "cast" in low:
        return "copy_cast"
    if any(k in low for k in ("elementwise", "vectorized", "reduce")):
        return "elementwise_reduce"
    return "other"


def _union_us(spans: list, lo: float, hi: float) -> float:
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def profile_window(fn, name: str, label: str) -> tuple[dict, list]:
    """``fn()`` and a synchronise under ``torch.profiler`` (CPU and CUDA
    activity) inside a ``label`` annotation, the trace written to
    ``build/traces/<name>.json``.  The window is the host's span of the
    call and its synchronise, so the profiler's own host cost counts as
    idle time.  Returns the window's ms, the device time and operations
    in it and the device's busy and idle share, and those operations."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    path = ROOT / "build" / "traces" / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == label
           and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if len(win) != 1 or not dev:
        raise AssertionError(f"profiler trace {path}: {len(win)} windows, "
                             f"{len(dev)} device operations")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in dev if lo <= e["ts"] < hi]
    busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    return {"window_ms": (hi - lo) / 1e3,
            "device_ms": sum(e["dur"] for e in dev) / 1e3,
            "device_ops": len(dev), "busy": busy / (hi - lo),
            "idle": 1 - busy / (hi - lo)}, dev


def phase_prefill_breakdown(lm_k: LM, params) -> dict:
    """One more prefill with kernels under ``torch.profiler``: where the
    device time goes, and how much of the window the device is idle."""
    cfg = lm_k.cfg
    batch = prefill_batch(cfg)
    rec, dev = profile_window(lambda: lm_k.prefill(params, batch),
                              f"{cfg.name}_prefill", "prefill_window")
    tag = f"[prefill-breakdown] {cfg.name} B={PREFILL_B} S={PREFILL_S}"
    print(f"{tag}: window {rec['window_ms']:.2f} ms (host span of the "
          f"profiled call), device time {rec['device_ms']:.2f} ms in "
          f"{len(dev)} operations, busy {rec['busy']:.3f}, idle "
          f"{rec['idle']:.3f}")
    print_breakdown(tag, rec, dev)
    print(f"{tag}: {json.dumps(rec)}")
    return rec


def print_breakdown(tag: str, rec: dict, dev: list) -> None:
    """Adds to ``rec`` the device time and count by category and of the
    ten costliest device operations in ``dev``, and prints them."""
    cats: dict = {}
    ops: dict = {}

    def add(table, key, ms):
        ms0, n0 = table.get(key, (0.0, 0))
        table[key] = [ms0 + ms, n0 + 1]
    for e in dev:
        add(cats, device_category(e["name"], e["cat"]), e["dur"] / 1e3)
        add(ops, e["name"], e["dur"] / 1e3)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    rec.update(by_category_ms_count=dict(sorted(cats.items(),
                                                key=lambda kv: -kv[1][0])),
               top10_ms_count=[[name[:160], ms, n]
                               for name, (ms, n) in top])
    print(f"{tag}: by category (ms, count): " + ", ".join(
        f"{c} {ms:.3f} ({n})" for c, (ms, n) in
        rec["by_category_ms_count"].items()))
    for i, (name, ms, n) in enumerate(rec["top10_ms_count"]):
        print(f"{tag}: top {i + 1}: {ms:.3f} ms ({n}) {name[:120]}")


def _first_divergence(streamed: list[int], offline: list[int]) -> int | None:
    for i, (a, b) in enumerate(zip(streamed, offline)):
        if a != b:
            return i
    if len(streamed) != len(offline):
        return min(len(streamed), len(offline))
    return None


class Margins:
    """Records the top-2 logit margin of every token the scheduler chooses,
    per request in draw order, by wrapping ``scheduler._Tokens`` (host
    code, outside any graph), where every token is chosen: greedy rows
    on the card by the device's argmax, which never calls ``_sample``.
    Each step's margins come from one ``topk`` on the device."""

    def __init__(self):
        self.by_rid: dict[int, list[float]] = {}
        self._orig = sched._Tokens

    def _tokens(self):
        by_rid, base = self.by_rid, self._orig

        class Recorded(base):
            def __init__(self, rows, temperatures, seed):
                super().__init__(rows, temperatures, seed)
                top2 = torch.topk(rows.float(), 2, dim=-1).values
                self.margins = (top2[:, 0] - top2[:, 1]).tolist()

            def take(self, i, rid, pos, rep=None):
                by_rid.setdefault(rid, []).append(self.margins[i])
                return super().take(i, rid, pos, rep)
        return Recorded

    def run(self, fn):
        sched._Tokens = self._tokens()
        try:
            return fn()
        finally:
            sched._Tokens = self._orig


@dataclasses.dataclass
class Served:
    """One serving run: its report, launch counts and peak memory."""
    rep: object
    counts: dict
    peak_gb: float


def serve_run(fn) -> Served:
    """``fn()``, a serving run, with the launch counts set to 0 just
    before it and read just after, and the peak memory in it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rep = fn()
    torch.cuda.synchronize()
    return Served(rep, read_counts(), torch.cuda.max_memory_allocated() / 1e9)


def first_step_diff(lm_k: LM, params, s_max: int, vector_pos: bool,
                    use: str) -> float:
    """The largest logits difference between one step of the (memoised)
    graph of ``SLOTS`` rows and the eager ``decode_step``, both from zero
    caches on the same tokens at position 0."""
    g = graphs.step_graph(lm_k, params, SLOTS, s_max, vector_pos, use=use)
    g.reset()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    inputs = step_inputs(lm_k.cfg, SLOTS, 1, gen)
    if vector_pos:
        pos = torch.zeros(SLOTS, dtype=torch.int32, device=DEVICE)
        active = torch.ones(SLOTS, dtype=torch.bool, device=DEVICE)
        got = g.run(pos=pos, active=active, **inputs)
        batch = {**inputs, "pos": pos, "active": active}
    else:
        got = g.run(pos=0, **inputs)
        batch = {**inputs,
                 "pos": torch.tensor(0, dtype=torch.int32, device=DEVICE)}
    want, _ = lm_k.decode_step(params, batch, lm_k.init_caches(
        SLOTS, s_max, vector_pos=vector_pos))
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"graph step logits {tuple(got.shape)} not "
                             "finite")
    diff = (got.float() - want.float()).abs().max().item()
    g.reset()
    return diff


def check_served(cfg, run: Served, n_requests: int, steps: int,
                 per_step: tuple = ("rmsnorm",)) -> None:
    """Every request served in full, and each counted kernel launched at
    least its per-step count on every one of ``steps`` decode steps."""
    rep = run.rep
    if len(rep.requests) != n_requests:
        raise AssertionError(f"{len(rep.requests)} of {n_requests} served")
    for r in rep.requests:
        if r.finish != "length" or len(r.out) != r.max_new:
            raise AssertionError(f"rid {r.rid}: finish {r.finish!r}, "
                                 f"{len(r.out)} of {r.max_new} tokens")
    want = expected_prefill_counts(cfg)
    for name in per_step:
        if run.counts[name] < want[name] * steps:
            raise AssertionError(f"{name} launched {run.counts[name]} times "
                                 f"over {steps} decode steps")


def parted_requests(tag: str, want: Served, got: Served, margins: Margins,
                    what: str) -> int:
    """``got`` streamed ``want``'s tokens, or parted first at a token whose
    top-2 logit margin in ``want`` (recorded in ``margins``) was under
    ``MARGIN``.  Returns how many requests parted."""
    by_rid = {r.rid: r.out for r in want.rep.requests}
    parted = 0
    for r in got.rep.requests:
        i = _first_divergence(r.out, by_rid[r.rid])
        if i is None:
            continue
        m = margins.by_rid[r.rid][i]
        print(f"[serve] {tag} rid {r.rid}: {what} at token {i} of "
              f"{r.max_new}, top-2 logit margin there {m:.4f}")
        if m >= MARGIN:
            raise AssertionError(f"{tag} rid {r.rid}: {what} at token {i} "
                                 f"with margin {m} >= {MARGIN}")
        parted += 1
    return parted


def check_graph_run(tag: str, eager: Served, graph: Served,
                    margins: Margins) -> int:
    """The graph run launched what the eager run did, and streamed its
    tokens, or parted first at a token whose top-2 logit margin in the
    eager run was under ``MARGIN``.  Returns how many requests parted."""
    if graph.counts != eager.counts:
        raise AssertionError(f"{tag}: graph run launches {graph.counts}, "
                             f"eager run {eager.counts}")
    return parted_requests(tag, eager, graph, margins,
                           "the graph run parts from the eager run")


def print_served(tag: str, mode: str, run: Served, ms_step: float,
                 extra: str = "") -> None:
    rep = run.rep
    d = rep.to_dict()
    print(f"[serve] {tag} {mode:>6}: {rep.generated} tokens / "
          f"{len(rep.requests)} requests in {rep.wall_s:.2f} s, "
          f"{d['tok_per_s']:.1f} tok/s, p50 {d['latency_p50_s']:.3f} s, "
          f"p99 {d['latency_p99_s']:.3f} s, occupancy {rep.occupancy:.3f}, "
          f"{ms_step:.2f} ms a decode "
          f"step, prefill {rep.prefill_s:.2f} s, peak memory "
          f"{run.peak_gb:.2f} GB{extra}; launches {run.counts}")


def phase_serve(lm_k: LM, params, device: dict, n_requests: int = REQUESTS,
                prompt_range=PROMPT_RANGE, gen_range=GEN_RANGE,
                s_max: int | None = None, lm_plain: LM | None = None) -> dict:
    """Serving eager and on graphs; with ``lm_plain`` (phase 5) also on
    the plain path on graphs, the reference's serving path
    (``launch/serve.py --plain``), whose greedy tokens the kernel path's
    must stream up to near-ties."""
    cfg = lm_k.cfg
    s_max = s_max or prefill_bucket(prompt_range[1], 16) + gen_range[1]
    trace = make_trace(cfg, n_requests, seed=SEED,
                       prompt_len_range=prompt_range, gen_range=gen_range)

    def serve(graphs_on: bool, lm: LM = lm_k):
        b = ContinuousBatcher(lm, params, slots=SLOTS, s_max=s_max,
                              seed=SEED, graphs=graphs_on)
        for t in trace:
            b.submit(t["prompt"], t["max_new"], prompt_len=t["prompt_len"],
                     temperature=t["temperature"])
        return b.run()
    margins = Margins()
    eager = serve_run(lambda: margins.run(lambda: serve(False)))
    check_served(cfg, eager, n_requests, eager.rep.steps)
    # the graphs: the slot batch's (checked against one eager step), then,
    # where the batcher admits by side steps, one per prefill group width,
    # in an untimed pass over the trace
    built0, t0 = graphs.stats(), time.perf_counter()
    diff = first_step_diff(lm_k, params, s_max, True, "slots")
    serve(True)
    built = graphs.stats()
    n_graphs = built["graphs"] - built0["graphs"]
    capture_s = built["capture_s"] - built0["capture_s"]
    warm_s = time.perf_counter() - t0
    graph = serve_run(lambda: serve(True))
    check_served(cfg, graph, n_requests, graph.rep.steps)
    tag = f"{cfg.name} on {device['kind']} ({device['smi']})"
    parted = check_graph_run(cfg.name, eager, graph, margins)
    for r in graph.rep.requests[:2]:
        _check_offline(lm_k, params, r, s_max)
    for mode, run in (("eager", eager), ("graphs", graph)):
        extra = "" if mode == "eager" else (
            f", {n_graphs} graphs captured in {capture_s:.2f} s (the "
            f"untimed warm-up pass took {warm_s:.2f} s), first decode "
            f"step's logits max abs diff to eager {diff:.4g}, {parted} of "
            f"{n_requests} requests part from the eager run's tokens")
        print_served(tag, mode, run, run.rep.decode_s
                     / max(run.rep.steps, 1) * 1e3, extra)
    if lm_plain is not None:
        # the reference's serving path: no kernel, on graphs (captured in
        # this run), its margins recorded
        plain_margins = Margins()
        plain = serve_run(lambda: plain_margins.run(
            lambda: serve(True, lm_plain)))
        check_served(cfg, plain, n_requests, plain.rep.steps, per_step=())
        if any(plain.counts.values()):
            raise AssertionError(f"the plain path launched {plain.counts}")
        off = parted_requests(f"{cfg.name} kernels vs plain", plain, graph,
                              plain_margins, "the kernel path parts from "
                              "the plain path")
        print_served(tag, "plain", plain, plain.rep.decode_s
                     / max(plain.rep.steps, 1) * 1e3,
                     f" (on graphs, captured in this run); the kernel path "
                     f"on graphs streams its greedy tokens in "
                     f"{n_requests - off} of {n_requests} requests, the "
                     f"other {off} parting at a top-2 margin under "
                     f"{MARGIN}")
    print(f"[serve] {cfg.name}: graphs / eager tok/s "
          f"{graph.rep.tok_per_s / eager.rep.tok_per_s:.2f}x, ms a decode "
          f"step {graph.rep.decode_s / max(graph.rep.steps, 1) * 1e3:.2f} "
          f"against {eager.rep.decode_s / max(eager.rep.steps, 1) * 1e3:.2f}"
          f", prefill {graph.rep.prefill_s:.2f} s against "
          f"{eager.rep.prefill_s:.2f} s")
    return graph.counts


def phase_decode_profile(lm_k: LM, params, s_max: int) -> dict:
    """One decode step of the slot batch under ``torch.profiler``, eager
    and replayed from its graph: the window and the device's busy and
    idle share of it."""
    g = graphs.step_graph(lm_k, params, SLOTS, s_max, True, use="slots")
    g.reset()
    toks = torch.zeros((SLOTS, 1), dtype=torch.int64, device=DEVICE)
    pos = torch.full((SLOTS,), 64, dtype=torch.int32, device=DEVICE)
    active = torch.ones(SLOTS, dtype=torch.bool, device=DEVICE)
    caches = lm_k.init_caches(SLOTS, s_max, vector_pos=True)
    batch = {"tokens": toks, "pos": pos, "active": active}
    fns = {"eager": lambda: lm_k.decode_step(params, batch, caches),
           "graph": lambda: g.run(toks, pos, active)}
    out = {}
    for mode, fn in fns.items():
        fn()
        rec, _ = profile_window(fn, f"{lm_k.cfg.name}_decode_{mode}",
                                "decode_window")
        # the same step unprofiled (host clock over a step and its
        # synchronise), since the profiler's own host cost counts as idle
        n = 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        rec["step_ms"] = (time.perf_counter() - t0) / n * 1e3
        out[mode] = rec
        print(f"[decode-profile] {lm_k.cfg.name} B={SLOTS} {mode}: window "
              f"{rec['window_ms']:.3f} ms (host span of the profiled step),"
              f" device time {rec['device_ms']:.3f} ms in "
              f"{rec['device_ops']} operations, busy {rec['busy']:.3f}, "
              f"idle {rec['idle']:.3f}; unprofiled {rec['step_ms']:.3f} ms "
              f"a step, device time / that "
              f"{rec['device_ms'] / rec['step_ms']:.3f}")
    g.reset()
    return out


def _check_offline(lm_k: LM, params, r: Request, s_max: int,
                   pinned: tuple[Routing, int, int] | None = None,
                   check: bool = True) -> None:
    """Re-decode ``r`` with ``decode_offline``: its tokens must equal the
    streamed ones, or part first where the offline top-2 logit margin is
    under ``MARGIN``.  ``pinned`` = (routing, first call, batch row)
    replays the streamed run's expert choices; ``check=False`` reports
    without asserting."""
    rows: list[np.ndarray] = []

    def offline():
        return decode_offline(lm_k, params, r, seed=SEED, s_max=s_max,
                              on_logits=rows.append)
    ref = offline() if pinned is None else pinned[0].run(
        offline, True, start=pinned[1], row=pinned[2])
    tag = f"rid {r.rid}" + (" (routing pinned)" if pinned else "")
    i = _first_divergence(r.out, ref)
    if i is None:
        print(f"[serve] {tag}: {len(ref)} streamed tokens equal "
              "decode_offline")
        return
    top2 = np.sort(rows[i])[-2:]
    margin = float(top2[1] - top2[0])
    print(f"[serve] {tag}: first divergence at token {i} of "
          f"{len(ref)}, offline top-2 logit margin {margin:.4f}")
    if check and margin >= MARGIN:
        raise AssertionError(f"rid {r.rid} diverges at token {i} with "
                             f"margin {margin} >= {MARGIN}")


def phase_serve_static(lm_k: LM, params, device: dict
                       ) -> tuple[dict, list]:
    """MoE configs serve on the static path (the batcher refuses them):
    waves of ``SLOTS`` requests, each prompt padded to its wave's
    longest with token 0; eager, then on the graph of the wave width.
    Returns the graph run's launch counts and the expert ids of every
    router call of the eager run."""
    cfg = lm_k.cfg
    s_max = prefill_bucket(J_PROMPT_RANGE[1], 16) + J_GEN_RANGE[1]
    trace = make_trace(cfg, J_REQUESTS, seed=SEED,
                       prompt_len_range=J_PROMPT_RANGE,
                       gen_range=J_GEN_RANGE)

    def requests():
        return [Request(rid=i, prompt_len=t["prompt_len"],
                        max_new=t["max_new"], prompt=t["prompt"],
                        temperature=t["temperature"],
                        t_submit=time.perf_counter())
                for i, t in enumerate(trace)]

    def serve(graphs_on: bool):
        return run_static(lm_k, params, requests(), seed=SEED, s_max=s_max,
                          slots=SLOTS, graphs=graphs_on)
    waves = [requests()[i:i + SLOTS] for i in range(0, J_REQUESTS, SLOTS)]
    # decode_step calls: each wave steps through its longest prompt, then
    # its largest max_new less the token the prompt's last step gives
    calls = sum(max(r.prompt_len for r in w) + max(r.max_new for r in w) - 1
                for w in waves)
    routing, margins = Routing(), Margins()
    eager = serve_run(lambda: margins.run(
        lambda: routing.run(lambda: serve(False), False)))
    check_served(cfg, eager, J_REQUESTS, calls, ("rmsnorm", "moe_gmm"))
    # the longest prompts decode offline twice: with their own routing
    # (reported: batch 1 and batch 8 round differently, which can swap a
    # near-tied expert, see Routing) and with the eager run's (checked);
    # and the first shorter one, with its prompt padded with token 0 as
    # the wave fed it, with the eager run's routing (checked)
    n_moe = sum(f == "moe" for _, f in cfg.layer_kinds())
    served = {r.rid: r for r in eager.rep.requests}
    start = 0
    for w in waves:
        l_max = max(r.prompt_len for r in w)
        for row, r in enumerate(w):
            if r.prompt_len == l_max:
                _check_offline(lm_k, params, served[r.rid], s_max,
                               check=False)
                _check_offline(lm_k, params, served[r.rid], s_max,
                               pinned=(routing, start, row))
        short = [(row, r) for row, r in enumerate(w) if r.prompt_len < l_max]
        if short:
            row, r = short[0]
            padded = np.zeros(l_max, np.int64)
            padded[:r.prompt_len] = r.prompt
            _check_offline(lm_k, params, dataclasses.replace(
                served[r.rid], prompt=padded, prompt_len=l_max), s_max,
                pinned=(routing, start, row))
        start += n_moe * (l_max + max(q.max_new for q in w) - 1)
    # the graph of the wave width, checked against one eager step, then
    # an untimed pass over the trace
    built0, t0 = graphs.stats(), time.perf_counter()
    diff = first_step_diff(lm_k, params, s_max, False, "step")
    serve(True)
    built = graphs.stats()
    n_graphs = built["graphs"] - built0["graphs"]
    capture_s = built["capture_s"] - built0["capture_s"]
    warm_s = time.perf_counter() - t0
    graph = serve_run(lambda: serve(True))
    check_served(cfg, graph, J_REQUESTS, calls, ("rmsnorm", "moe_gmm"))
    parted = check_graph_run(cfg.name, eager, graph, margins)
    tag = f"{cfg.name} static on {device['kind']} ({device['smi']})"
    for mode, run in (("eager", eager), ("graphs", graph)):
        rep = run.rep
        extra = f", {calls} decode steps ({rep.steps} after the prompts)"
        if mode == "graphs":
            extra += (f", {n_graphs} graphs captured in {capture_s:.2f} s "
                      f"(the untimed warm-up pass took {warm_s:.2f} s), "
                      f"first decode step's logits max abs diff to eager "
                      f"{diff:.4g}, {parted} of {J_REQUESTS} requests part "
                      "from the eager run's tokens")
        print_served(tag, mode, run,
                     (rep.prefill_s + rep.decode_s) / calls * 1e3, extra)
    print(f"[serve] {cfg.name}: graphs / eager tok/s "
          f"{graph.rep.tok_per_s / eager.rep.tok_per_s:.2f}x, ms a step "
          f"{(graph.rep.prefill_s + graph.rep.decode_s) / calls * 1e3:.2f} "
          f"against "
          f"{(eager.rep.prefill_s + eager.rep.decode_s) / calls * 1e3:.2f}")
    return graph.counts, routing.ids


def main() -> int:
    device = phase_device()
    # phase 23 needs no card: its child runs on the host beside phases
    # 2-22 (on the card's machine it moved no host time beyond the
    # spread between two runs)
    dry = start_dryrun()
    try:
        return run_phases(device, dry)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()


def run_phases(device: dict, dry: subprocess.Popen) -> int:
    phase_build()
    cases = phase_kernels()

    cfg, lm_k, lm_p, params = build_model(ARCH)
    paths = [phase_prefill(lm_k, lm_p, params)[0],
             phase_serve(lm_k, params, device, lm_plain=lm_p)]
    phase_decode_profile(lm_k, params,
                         prefill_bucket(PROMPT_RANGE[1], 16) + GEN_RANGE[1])
    graphs.release()
    del lm_k, lm_p, params
    xcfg, xlm_k, xlm_p, xparams = build_model(XARCH)
    paths += [phase_prefill(xlm_k, xlm_p, xparams, iters=3)[0],
              phase_serve(xlm_k, xparams, device, X_REQUESTS,
                          X_PROMPT_RANGE, X_GEN_RANGE)]
    graphs.release()
    del xlm_k, xlm_p, xparams
    torch.cuda.empty_cache()
    for arch in HEAD_DIM_ARCHS:
        _, hlm_k, hlm_p, hparams = build_model(arch, n_layers=HD_LAYERS)
        paths.append(phase_prefill(hlm_k, hlm_p, hparams, iters=3)[0])
        del hlm_k, hlm_p, hparams
        torch.cuda.empty_cache()
    jcfg, jlm_k, jlm_p, jparams = build_model(JARCH, n_layers=J_LAYERS)
    j_prefill, prefill_ids = phase_prefill(jlm_k, jlm_p, jparams, iters=2,
                                           used_earlier=J_TOL_USED_EARLIER)
    phase_prefill_breakdown(jlm_k, jparams)
    j_serve, decode_ids = phase_serve_static(jlm_k, jparams, device)
    paths += [j_prefill, j_serve]
    graphs.release()
    del jlm_k, jlm_p, jparams
    torch.cuda.empty_cache()
    cases.update(phase_gmm_kernels(JARCH, prefill_ids, decode_ids,
                                   f32_case=True))
    torch.cuda.empty_cache()
    phase_train()
    torch.cuda.empty_cache()
    driver = phase_train_driver()
    torch.cuda.empty_cache()
    paths += phase_frontends(device)
    for arch, n_layers, phase in ((DS2, DS2_LAYERS, 16),
                                  (DS3, DS3_LAYERS, 17)):
        ds_paths, ds_cases = phase_deepseek(arch, n_layers, phase, device)
        paths += ds_paths
        cases.update(ds_cases)
    t0 = time.perf_counter()
    phase_deepseek_train()
    print(f"[deepseek] phase 17 train took {time.perf_counter() - t0:.1f} s")
    phase_compiler(device)
    phase_lint(device)
    phase_mesh(driver["a"]["losses"], device)
    ep_paths, ep_cases = phase_ep(device)
    paths += ep_paths
    cases.update(ep_cases)
    phase_compress(device)
    phase_gpipe(device)
    phase_dryrun(dry, device)

    main_path = {k: sum(p[k] for p in paths) for k in COUNTED}
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")

    def sub(key, shape, extra=()):
        return dict(shape=shape, **{k: cases[key][k] for k in keys + extra})
    hd = {}
    for arch in HEAD_DIM_ARCHS:
        hcfg = get_config(arch)
        for window in ((None, HD_WINDOW) if hcfg.attn_window else (None,)):
            hd[arch + ("" if window is None else f" window {window}")] = sub(
                ("mha", arch, window),
                f"B={PREFILL_B} S={PREFILL_S} H={hcfg.n_heads}/"
                f"{hcfg.n_kv_heads} Dh={hcfg.resolved_head_dim} causal"
                + ("" if window is None else f" window {window}")
                + f" bf16 ({arch} prefill)")
    mcfg, vcfg = get_config(MARCH), get_config(VARCH)
    xH = xcfg.n_heads
    xDh = xcfg.xlstm.proj_factor_mlstm * xcfg.d_model // xH
    kernels = [
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:26",
             launches=main_path["rmsnorm"],
             shape=f"x ({SLOTS}, {cfg.d_model}) bf16 (decode step)",
             jamba_decode=sub(("rmsnorm", SLOTS, jcfg.d_model,
                               torch.bfloat16),
                              f"x ({SLOTS}, {jcfg.d_model}) bf16 (jamba "
                              "decode step)", ("device_ms",)),
             jamba_prefill=sub(("rmsnorm", PREFILL_B * PREFILL_S,
                                jcfg.d_model, torch.bfloat16),
                               f"x ({PREFILL_B * PREFILL_S}, "
                               f"{jcfg.d_model}) bf16 (jamba prefill)",
                               ("device_ms",)),
             **{f"{arch.split('-')[0]}_{arch.split('-')[1]}_{mode}": sub(
                 ("rmsnorm", R, get_config(arch).d_model, torch.bfloat16),
                 f"x ({R}, {get_config(arch).d_model}) bf16 ({arch} "
                 f"{mode})", ("device_ms",))
                for arch in (DS2, DS3)
                for R, mode in ((SLOTS, "decode"),
                                (PREFILL_B * PREFILL_S, "prefill"))},
             **{f"deepseek_v2_ep_decode_{w}": sub(
                 ("rmsnorm", EPS_ROWS, w, torch.bfloat16),
                 f"x ({EPS_ROWS}, {w}) bf16 (deepseek-v2 expert-parallel "
                 "decode, a latent norm)", ("device_ms",))
                for w in (get_config(DS2).mla.q_lora,
                          get_config(DS2).mla.kv_lora)},
             **cases[("rmsnorm", SLOTS, torch.bfloat16)]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:76",
             launches=main_path["flash_attention"],
             shape=(f"B={PREFILL_B} S={PREFILL_S} H={cfg.n_heads}/"
                    f"{cfg.n_kv_heads} Dh={cfg.resolved_head_dim} causal "
                    "bf16 (prefill)"),
             jamba=dict(shape=(f"B={PREFILL_B} S={PREFILL_S} H="
                               f"{jcfg.n_heads}/{jcfg.n_kv_heads} Dh="
                               f"{jcfg.resolved_head_dim} causal bf16 "
                               "(jamba prefill)"),
                        **cases[("mha", PREFILL_S, jcfg.n_heads,
                                 jcfg.n_kv_heads, None, torch.bfloat16)]),
             head_dims=hd,
             musicgen=sub(("mha", MARCH),
                          f"B={PREFILL_B} S={PREFILL_S} H={mcfg.n_heads}/"
                          f"{mcfg.n_kv_heads} Dh={mcfg.resolved_head_dim} "
                          "causal bf16 (musicgen-large prefill)"),
             cross=sub(("mha", "cross"),
                       f"B={PREFILL_B} Sq={PREFILL_S} Skv="
                       f"{vcfg.n_img_tokens} H={vcfg.n_heads}/"
                       f"{vcfg.n_kv_heads} Dh={vcfg.resolved_head_dim} "
                       "non-causal bf16 (llama-3.2-vision-11b prefill, "
                       "cross-attention layers)"),
             **cases[("mha", PREFILL_S, cfg.n_heads, cfg.n_kv_heads, None,
                      torch.bfloat16)]),
        dict(name="mlstm_chunk", route="cuda",
             source="src/repro_torch/csrc/mlstm_chunk.cu",
             replaces="src/repro/kernels/mlstm_chunk/kernel.py:84",
             launches=main_path["mlstm_chunk"],
             shape=(f"B={PREFILL_B} S={PREFILL_S} H={xH} Dh={xDh} chunk "
                    f"{xcfg.xlstm.chunk} bf16 in, f32 out (xlstm prefill)"),
             f32=sub(("mlstm", torch.float32), "the same, f32 in"),
             **cases[("mlstm", torch.bfloat16)]),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:54",
             launches=main_path["ssd_scan"],
             shape=(f"B={PREFILL_B} S={PREFILL_S} Din="
                    f"{jcfg.mamba.expand * jcfg.d_model} N="
                    f"{jcfg.mamba.d_state}, x bf16, dt f32, y f32 (jamba "
                    "prefill)"),
             f32=sub(("ssd", torch.float32), "the same, x f32",
                     ("max_abs_err_kernel_order",)),
             **cases[("ssd", torch.bfloat16)]),
        dict(name="moe_gmm", route="cuda",
             source="src/repro_torch/csrc/moe_gmm.cu",
             replaces="src/repro/kernels/moe_gmm/kernel.py:49",
             launches=main_path["moe_gmm"],
             shape=(f"({jcfg.moe.n_experts}, "
                    f"{capacity_of(PREFILL_B * PREFILL_S, jcfg.moe)}, "
                    f"{jcfg.d_model}) x ({jcfg.moe.n_experts}, "
                    f"{jcfg.d_model}, {2 * jcfg.moe.d_expert}) bf16 (jamba "
                    "prefill, first product, at the first MoE layer's "
                    "group sizes)"),
             second={k: cases[("gmm", JARCH, "prefill", 2)][k]
                     for k in keys},
             decode={k: cases[("gmm", JARCH, "decode", 1)][k]
                     for k in keys},
             deepseek_v2=gmm_subs(DS2, cases, sub),
             ep={f"{('first', 'second')[n - 1]}": sub(
                 ("gmm", "ep", n), shape)
                 for n, shape in ((1, "(160, 192, 5120) x (160, 5120, 3072) "
                                      "bf16 (deepseek-v2 expert-parallel "
                                      "prefill, every row live)"),
                                  (2, "(160, 192, 1536) x (160, 1536, 5120) "
                                      "bf16 (the same, second product)"))},
             ep_serve={f"{('first', 'second')[n - 1]}": sub(
                 ("gmm", "ep_serve", n), shape)
                 for n, shape in ((1, "(40, 32, 5120) x (40, 5120, 3072) "
                                      "bf16 (deepseek-v2 expert-parallel "
                                      "decode, a rank's experts)"),
                                  (2, "(40, 32, 1536) x (40, 1536, 5120) "
                                      "bf16 (the same, second product)"))},
             deepseek_v3=gmm_subs(DS3, cases, sub),
             **cases[("gmm", JARCH, "prefill", 1)]),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 "path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}))
    return 0


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at |x|."""
    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp_min(1e-30))) - 7)


def _global_norm(grads) -> float:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads))).item()


def _copy(tree, device):
    """A copy of a param tree on ``device``."""
    return {k: _copy(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def train_run(step, params, opt_state, loader, steps: int, lr_fn):
    """``steps`` steps; each metric of each step (``{name: [value]}``;
    a copy on the card, since a graph's metrics are static tensors that
    the next step overwrites), and each step's ms between CUDA events
    (the device's timeline, idle gaps included)."""
    metrics, events = [], []
    for i in range(steps):
        batch = loader.batch_at(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step.fn(params, opt_state, batch,
                                       lr_scale=lr_fn(i))
        end.record()
        metrics.append({k: v.clone() for k, v in m.items()})
        events.append((start, end))
    torch.cuda.synchronize()
    return params, opt_state, \
        {k: [float(m[k]) for m in metrics] for k in metrics[0]}, \
        [a.elapsed_time(b) for a, b in events]


def check_train_parity(cfg, params) -> dict:
    """One train step on the card against one on the CPU from the same
    params and batch (B=1, S=128), each as ``fn`` runs it (``grads``, then
    ``opt.update``), so the gradient norm is that of the gradients the
    update applies: loss, global gradient norm, and every updated param
    within the most one AdamW step can move it either way,
    ``2·lr·(1 + wd·|p|)``, plus one bf16 step of |p|."""
    batch = SyntheticCorpus(cfg.vocab, seed=SEED + 1).batch(
        0, 0, PARITY_B, PARITY_S)
    out = {}
    for dev in (DEVICE, "cpu"):
        step = build_train_step(cfg, opt=AdamW(lr=TRAIN_LR), device=dev)
        p = _copy(params, dev)
        grads, metrics = step.grads(p, batch)
        gn = _global_norm(grads)
        p, _ = step.opt.update(grads, step.opt.init(p), p)
        out[dev] = (float(metrics["loss"]), gn, _copy(p, "cpu"))
    (lc, gc, pc), (lh, gh, ph) = out[DEVICE], out["cpu"]
    opt = AdamW(lr=TRAIN_LR)
    p0 = _copy(params, "cpu")
    worst = 0.0
    for a, b, w0 in zip(tree_leaves(pc), tree_leaves(ph), tree_leaves(p0)):
        bound = (2 * opt.lr * (1 + opt.weight_decay * w0.float().abs())
                 + _bf16_ulp(w0))
        worst = max(worst, ((a.float() - b.float()).abs() / bound)
                    .max().item())
    rec = {"loss_rel": abs(lc - lh) / abs(lh), "grad_norm_rel":
           abs(gc - gh) / gh, "step_bound_used": worst, "loss_card": lc,
           "loss_cpu": lh, "grad_norm_card": gc, "grad_norm_cpu": gh}
    print(f"[train] card vs CPU, {cfg.name} B={PARITY_B} S={PARITY_S}: "
          f"loss {lc:.6f} vs {lh:.6f} (rel {rec['loss_rel']:.2e}, tol "
          f"{PARITY_LOSS_RTOL}), grad norm {gc:.6f} vs {gh:.6f} (rel "
          f"{rec['grad_norm_rel']:.2e}, tol {PARITY_GN_RTOL}), updated "
          f"params use {worst:.3f} of the one-step bound")
    if rec["loss_rel"] > PARITY_LOSS_RTOL or \
            rec["grad_norm_rel"] > PARITY_GN_RTOL or worst > 1.0:
        raise AssertionError(f"train step card vs CPU: {rec}")
    return rec


def check_remat(cfg, params, batch) -> float:
    """``remat`` none, full and dots: the same loss and gradients, within
    ``REMAT_TOL`` of each leaf's largest magnitude."""
    ref = None
    worst = 0.0
    for remat in ("none", "full", "dots"):
        torch.cuda.reset_peak_memory_stats()
        step = build_train_step(cfg, remat=remat, device=DEVICE)
        grads, m = step.grads(params, batch)
        peak = torch.cuda.max_memory_allocated() / 1e9
        leaves = tree_leaves(grads)
        if ref is None:
            ref = (float(m["loss"]), leaves)
            print(f"[train] remat none: loss {ref[0]:.6f}, peak memory "
                  f"{peak:.2f} GB")
            continue
        dl = abs(float(m["loss"]) - ref[0])
        d = max(((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30)).item()
                for a, b in zip(leaves, ref[1]))
        worst = max(worst, d, dl / abs(ref[0]))
        print(f"[train] remat {remat}: loss diff {dl:.3e}, gradients "
              f"differ by up to {d:.3e} of a leaf's largest magnitude (tol "
              f"{REMAT_TOL}); peak memory {peak:.2f} GB")
        del grads, leaves
    if worst > REMAT_TOL:
        raise AssertionError(f"remat modes disagree: {worst} > {REMAT_TOL}")
    return worst


def check_accumulation(cfg, params, batch) -> float:
    """``accum_steps=2`` against 1 with the default AdamW, as the
    reference's test takes them: the updated params within rtol 2e-2,
    atol 2e-3 (its tolerance)."""
    out = []
    for accum in (1, 2):
        step = build_train_step(cfg, accum_steps=accum, device=DEVICE)
        p = _copy(params, DEVICE)
        p, _, _ = step.fn(p, step.opt.init(p), batch)
        out.append(tree_leaves(p))
    worst = 0.0
    for a, b in zip(*out):
        a, b = a.float(), b.float()
        worst = max(worst, ((a - b).abs() / (ACCUM_ATOL + ACCUM_RTOL
                                             * b.abs())).max().item())
    print(f"[train] accum_steps=2 vs 1, B={TRAIN_B} S={TRAIN_S}: updated "
          f"params use {worst:.3f} of the tolerance (rtol {ACCUM_RTOL}, "
          f"atol {ACCUM_ATOL})")
    if worst > 1.0:
        raise AssertionError(f"accumulation differs from the full batch: "
                             f"{worst:.3f} of the tolerance")
    return worst


def check_guard(cfg, params, batch) -> None:
    """A loss through the kernels with params that require grad raises:
    the kernels carry no gradient."""
    lm_k = LM(cfg, use_kernels=True, device=DEVICE, graphs=False)
    p = {**params, "final_norm": {
        "scale": params["final_norm"]["scale"].detach().clone()
        .requires_grad_()}}
    tb = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    try:
        lm_k.loss_fn(p, tb)
    except RuntimeError as e:
        if "carry no gradient" not in str(e):
            raise
        print(f"[train] guard: a loss through the kernels with params that "
              f"require grad raises: {e}")
        return
    raise AssertionError("a loss through the kernels took gradients")


def state_leaves(params, opt_state) -> list:
    """The params, the step counter and the moments, in one order."""
    return [*tree_leaves(params), opt_state.step, *tree_leaves(opt_state.mu),
            *tree_leaves(opt_state.nu)]


def train_pair(cfg, opt: AdamW, batches, steps: int, lr_fn,
               warmup: int = 1) -> tuple[dict, tuple]:
    """``steps`` train steps of ``cfg`` (remat full) from the seeded
    params, eagerly (``graphs=False``) and then on the step's CUDA graph
    (``build_train_step``'s default on the card), each run with params and
    moments of its own: its median ms a step (CUDA events, after
    ``warmup`` steps; the graph's first step captures it), peak memory and
    launches (none may launch); the graph run's capture seconds and the
    memory its run left reserved (the graph's pool and static buffers).
    The graph run is held to the eager run bit for bit: every metric of
    every step, and the final params, step counter and moments, the
    eager run's copied to the host first so that both states need not
    fit on the card at once.  The step returns no gradient; its
    moments, bit-equal after each run, are built from each step's
    gradients.  Returns the records and the graph run's (step, params,
    opt_state)."""
    rec, held = {}, None
    for mode in ("eager", "graph"):
        step = build_train_step(cfg, opt=opt, remat="full", device=DEVICE,
                                graphs=mode == "graph")
        params, _ = step.lm.init(SEED)
        opt_state = step.opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reserved = torch.cuda.memory_reserved()
        before = graphs.stats()
        reset_counts()
        params, opt_state, hist, ms = train_run(step, params, opt_state,
                                                batches, steps, lr_fn)
        counts = read_counts()
        after = graphs.stats()
        r = {"metrics": hist, "losses": hist["loss"], "step_ms": ms,
             "median_step_ms": float(np.median(ms[warmup:])),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "reserved_gb": (torch.cuda.memory_reserved() - reserved) / 1e9,
             "graphs": after["graphs"] - before["graphs"],
             "capture_s": after["capture_s"] - before["capture_s"],
             "launches": counts}
        rec[mode] = r
        if any(counts.values()) or not all(
                np.all(np.isfinite(v)) for v in hist.values()):
            raise AssertionError(f"{cfg.name} train ({mode}): launches "
                                 f"{counts}, metrics {hist}")
        if mode == "eager":
            host = [t.to("cpu", copy=True)
                    for t in state_leaves(params, opt_state)]
            del step, params, opt_state
        else:
            held = (step, params, opt_state)
    e, g = rec["eager"], rec["graph"]
    if g["graphs"] != 1:
        raise AssertionError(f"{cfg.name}: the graph run captured "
                             f"{g['graphs']} graphs, not 1")
    differ = [(i, (a.float() - b.cpu().float()).abs().max().item())
              for i, (a, b) in enumerate(zip(host, state_leaves(*held[1:])))
              if not _bits_equal(a, b.cpu())]
    same_metrics = e["metrics"] == g["metrics"]
    rec["bit_equal"] = {"metrics": same_metrics, "leaves": len(host),
                        "leaves_differ": differ}
    print(f"[train] {cfg.name} eager: median {e['median_step_ms']:.2f} ms a "
          f"step (steps " + " ".join(f"{x:.1f}" for x in e["step_ms"])
          + f"), peak memory {e['peak_gb']:.2f} GB, {e['reserved_gb']:.2f} GB "
          f"reserved by its run (the allocator's cache); graph: median "
          f"{g['median_step_ms']:.2f} ms a step (steps "
          + " ".join(f"{x:.1f}" for x in g["step_ms"])
          + f"), {g['graphs']} graph captured in {g['capture_s']:.2f} s, "
          f"{g['reserved_gb']:.2f} GB reserved by its run (pool and static "
          f"buffers), peak memory {g['peak_gb']:.2f} GB; graph vs eager: "
          f"the metrics of all {steps} steps "
          + ("bit-equal" if same_metrics else "DIFFER") + f", "
          f"{len(host) - len(differ)} of {len(host)} state leaves bit-equal"
          + (f" (max abs diff {max(d for _, d in differ):.3e})"
             if differ else "") + f"; kernel launches {e['launches']}, "
          f"{g['launches']}")
    if not same_metrics or differ:
        raise AssertionError(f"{cfg.name}: the graph run differs from the "
                             f"eager run: metrics {e['metrics']} vs "
                             f"{g['metrics']}, leaves {differ[:10]}")
    return rec, held


def phase_train() -> dict:
    """smollm-135m trained at full width (remat full, B=8, S=1024, 20
    steps) eager and on its graph, and xlstm-125m (B=4, S=512, 3 steps);
    one step of each smollm path under ``torch.profiler``, and the five
    checks."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    loader = ShardedLoader(SyntheticCorpus(cfg.vocab, seed=SEED), TRAIN_B,
                           TRAIN_S)
    lr_fn = cosine_schedule(1.0, warmup=1, total=TRAIN_STEPS)
    pair, (step, params, opt_state) = train_pair(
        cfg, AdamW(lr=TRAIN_LR), loader, TRAIN_STEPS, lr_fn,
        warmup=TRAIN_WARMUP)
    n_params = sum(t.numel() for t in tree_leaves(params))
    losses = pair["eager"]["losses"]
    tail = float(np.mean(losses[-5:]))
    if not tail < losses[0]:
        raise AssertionError(f"the loss did not fall: first {losses[0]}, "
                             f"mean of the last 5 {tail}")
    tokens = TRAIN_B * TRAIN_S
    flops = (6 * n_params + 6 * cfg.n_layers * TRAIN_S * cfg.d_model) \
        * tokens * 4 / 3
    rec = {"arch": cfg.name, "B": TRAIN_B, "S": TRAIN_S, "remat": "full",
           "steps": TRAIN_STEPS, "losses": losses, "n_params": n_params,
           "loss_margin": losses[0] - tail, **pair}
    print(f"[train] {cfg.name} ({n_params / 1e6:.1f}M params) B={TRAIN_B} "
          f"S={TRAIN_S} remat full, AdamW lr {TRAIN_LR}, cosine warm-up 1: "
          f"losses " + " ".join(f"{x:.4f}" for x in losses))
    for mode in ("eager", "graph"):
        r = pair[mode]
        r["tokens_per_s"] = tokens / r["median_step_ms"] * 1e3
        r["model_tflops"] = flops / r["median_step_ms"] / 1e9
        print(f"[train] {cfg.name} {mode}: median {r['median_step_ms']:.2f} "
              f"ms a step (CUDA events, after {TRAIN_WARMUP} warm-up steps), "
              f"{r['tokens_per_s']:.0f} tokens/s, model "
              f"{r['model_tflops']:.1f} TFLOP/s ({flops / 1e12:.2f} TFLOP a "
              f"step: 6·N + 6·L·S·d per token, x4/3 for the remat), peak "
              f"memory {r['peak_gb']:.2f} GB")
    print(f"[train] the loss fell from {losses[0]:.4f} to {tail:.4f} (mean "
          f"of the last 5, margin {rec['loss_margin']:.4f}); the train step "
          "runs the plain paths")
    batch = loader.batch_at(TRAIN_STEPS)
    eager = build_train_step(cfg, opt=AdamW(lr=TRAIN_LR), remat="full",
                             device=DEVICE, graphs=False)
    p = _copy(params, DEVICE)
    st = type(opt_state)(opt_state.step.clone(), _copy(opt_state.mu, DEVICE),
                         _copy(opt_state.nu, DEVICE))
    rec["profile"] = {
        "eager": phase_train_profile(
            "eager", lambda: eager.fn(p, st, batch)),
        "graph": phase_train_profile(
            "graph", lambda: step.fn(params, opt_state, batch))}
    del eager, p, st, step, params, opt_state
    torch.cuda.empty_cache()
    p_init, _ = LM(cfg, device=DEVICE).init(SEED)
    rec["remat_worst"] = check_remat(cfg, p_init, batch)
    rec["accum_used"] = check_accumulation(cfg, p_init, batch)
    check_guard(cfg, p_init, batch)
    rec["parity"] = check_train_parity(cfg, p_init)
    del p_init
    torch.cuda.empty_cache()
    rec["xlstm"] = phase_train_xlstm()
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[train] phase 12 took {rec['phase_s']:.1f} s")
    print(f"[train] {json.dumps(rec)}")
    return rec


def phase_train_profile(mode: str, fn) -> dict:
    """One smollm train step (``fn``: eager, or a replay of its graph)
    under ``torch.profiler``: the device's busy and idle share of the
    window, and its operation count; then three unprofiled steps."""
    rec, dev = profile_window(fn, f"{ARCH}_train_step_{mode}",
                              "train_window")
    n = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    rec["step_ms"] = (time.perf_counter() - t0) / n * 1e3
    tag = f"[train-profile] {ARCH} {mode}"
    print(f"{tag} B={TRAIN_B} S={TRAIN_S} remat full: window "
          f"{rec['window_ms']:.2f} ms (host span of the profiled step), "
          f"device time {rec['device_ms']:.2f} ms in {rec['device_ops']} "
          f"operations, busy {rec['busy']:.3f}, idle {rec['idle']:.3f}; "
          f"unprofiled {rec['step_ms']:.2f} ms a step, device time / that "
          f"{rec['device_ms'] / rec['step_ms']:.3f}")
    print_breakdown(tag, rec, dev)
    return rec


def _slstm_scan_cast_per_step(p, x, carry):
    """The sLSTM loop with the gate weights cast to f32 at every step, as
    the reference's ``_slstm_step`` casts them (and the port did before it
    cast them once per sequence): the "before" of phase 12's xlstm peak."""
    hs = []
    for t in range(x.shape[1]):
        carry, h = xlstm_mod._slstm_step(
            p["w_gates"].to(torch.float32), p["r_gates"].to(torch.float32),
            carry, x[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), carry


def phase_train_xlstm() -> dict:
    """xlstm-125m at full width, a few steps: first eagerly with the sLSTM
    gate weights cast at every step (the peak before the cast was
    hoisted), then eager and on its graph (``train_pair``), whose sLSTM
    loop the train step's graph captures (the LM has ``graphs=False``);
    and the largest change of the gate weights' gradients that the
    hoisted cast makes, at the seeded params."""
    cfg = get_config(XARCH)
    loader = ShardedLoader(SyntheticCorpus(cfg.vocab, seed=SEED),
                           X_TRAIN_B, X_TRAIN_S)
    step = build_train_step(cfg, opt=AdamW(lr=TRAIN_LR), remat="full",
                            device=DEVICE, graphs=False)
    params, _ = step.lm.init(SEED)
    batch = loader.batch_at(0)
    grads = {}
    with mock.patch.object(xlstm_mod, "_slstm_scan",
                           _slstm_scan_cast_per_step):
        grads["per step"] = step.grads(params, batch)[0]
    grads["once"] = step.grads(params, batch)[0]
    change = {}
    for name in ("w_gates", "r_gates"):
        for path, a, b in _named_leaves(grads["per step"], grads["once"]):
            if path.endswith(name):
                change[path] = ((a.float() - b.float()).abs().max()
                                / b.float().abs().max().clamp_min(1e-30)
                                ).item()
    del grads, params, step
    with mock.patch.object(xlstm_mod, "_slstm_scan",
                           _slstm_scan_cast_per_step):
        before_pair = build_train_step(cfg, opt=AdamW(lr=TRAIN_LR),
                                       remat="full", device=DEVICE,
                                       graphs=False)
        p, _ = before_pair.lm.init(SEED)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, _, hist, ms = train_run(before_pair, p, before_pair.opt.init(p),
                                   loader, X_TRAIN_STEPS, lambda i: 1.0)
        before = {"step_ms": ms, "losses": hist["loss"],
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del before_pair, p
    torch.cuda.empty_cache()
    pair, held = train_pair(cfg, AdamW(lr=TRAIN_LR), loader, X_TRAIN_STEPS,
                            lambda i: 1.0)
    del held
    torch.cuda.empty_cache()
    same_first = before["losses"][0] == pair["eager"]["losses"][0]
    print(f"[train] {cfg.name} B={X_TRAIN_B} S={X_TRAIN_S} remat full: gate "
          f"weights cast at every step (before): step ms "
          + " ".join(f"{x:.1f}" for x in before["step_ms"])
          + f", peak memory {before['peak_gb']:.2f} GB; cast once a "
          f"sequence: eager "
          f"peak {pair['eager']['peak_gb']:.2f} GB, graph peak "
          f"{pair['graph']['peak_gb']:.2f} GB; first-step loss "
          + ("bit-equal" if same_first else "DIFFERS")
          + " (the forward is unchanged); the gate weights' gradients "
          "change by up to " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in change.items())
          + " of a leaf's largest magnitude")
    if not same_first:
        raise AssertionError(f"xlstm: hoisting the cast changed the loss: "
                             f"{before['losses'][0]} vs "
                             f"{pair['eager']['losses'][0]}")
    return {"before": before, "grad_change": change, **pair}


def _named_leaves(a, b, path=""):
    """(path, leaf of a, leaf of b) over two trees of the same shape."""
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _named_leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


CLOCKS: list = []


@dataclasses.dataclass
class StepClock(StragglerMonitor):
    """The driver's straggler monitor, also keeping the host clock at each
    of its calls (once a step, after the loss reaches the host): the gaps
    between calls are the loop's time per step, saves included."""
    stamps: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        CLOCKS.append(self)

    def step(self, host_times_s):
        self.stamps.append(time.perf_counter())
        return super().step(host_times_s)


def driver_run(tag: str, argv: list, eager: bool = False) -> dict:
    """``launch.train.main(argv)`` with its wall seconds, the loop's ms
    per step (mean gap between monitor calls: the first step's own time,
    which captures the graph, and the final ``wait()``, fall outside the
    gaps) and the graphs it captured; ``eager`` builds its train step
    with ``graphs=False``."""
    CLOCKS.clear()
    build = functools.partial(build_train_step, graphs=not eager)
    before = graphs.stats()
    with mock.patch.object(train_driver, "StragglerMonitor", StepClock), \
            mock.patch.object(train_driver, "build_train_step", build):
        t0 = time.perf_counter()
        out = train_driver.main(argv)
        t1 = time.perf_counter()
    after = graphs.stats()
    plan = out.pop("plan")
    if plan is None or plan.mesh_spec.axes != (("data", 1), ("model", 1)):
        raise AssertionError(f"driver run {tag}: plan {plan}")
    stamps = CLOCKS[0].stamps
    losses = out["losses"]
    if len(stamps) < 2 or not all(np.isfinite(losses)):
        raise AssertionError(f"driver run {tag}: losses {losses}")
    gaps = np.diff(stamps) * 1e3
    out.update(plan_rules={k: list(v) for k, v in plan.rules.items()},
               wall_s=t1 - t0, gap_ms=gaps.tolist(),
               ms_per_step=float(np.mean(gaps)), tail_s=t1 - stamps[-1],
               graphs=after["graphs"] - before["graphs"],
               capture_s=after["capture_s"] - before["capture_s"])
    if out["graphs"] != (0 if eager else 1):
        raise AssertionError(f"driver run {tag} captured {out['graphs']} "
                             "graphs")
    print(f"[driver] ({tag}) {' '.join(argv[-4:])}: {len(losses)} steps in "
          f"{out['wall_s']:.2f} s wall, the loop {out['ms_per_step']:.1f} ms "
          f"a step (gaps " + " ".join(f"{g:.1f}" for g in gaps) + "), "
          f"{out['tail_s']:.3f} s from the last step to the return; "
          f"{out['graphs']} graph captured in {out['capture_s']:.2f} s; "
          "losses " + " ".join(f"{x:.4f}" for x in losses))
    return out


def _like_on(tree, device):
    """Zeros shaped like a checkpoint tree, on ``device``."""
    return _unflatten(tree, [torch.zeros(v.shape, dtype=v.dtype,
                                         device=device)
                             for _, v in _flatten(tree)])


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and torch.equal(a, b)


def phase_checkpoint(directory: Path) -> dict:
    """(d): the newest step of ``directory`` restored into a card tree,
    saved again and timed, restored on the CPU bit for bit, then
    corrupted."""
    cfg = get_config(ARCH)
    params, _ = LM(cfg, device=DEVICE).init(SEED)
    opt = AdamW(lr=TRAIN_LR, moment_dtype=cfg.opt_moment_dtype)
    like = {"params": params, "opt": opt.init(params)}
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    t0 = time.perf_counter()
    state = mgr.restore(step, like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del like, params
    named = _flatten(state)
    nbytes = sum(v.numel() * v.element_size() for _, v in named)
    t0 = time.perf_counter()
    mgr.save(step + 1, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t0
    shard = directory / f"step_{step + 1:06d}" / "shard_h000.npz"
    file_bytes = shard.stat().st_size
    cpu_like = _like_on(state, "cpu")
    t0 = time.perf_counter()
    host = _flatten(mgr.restore(step + 1, cpu_like))
    cpu_restore_s = time.perf_counter() - t0
    bad = [k for (k, a), (_, b) in zip(named, host)
           if b.device.type != "cpu" or not _bits_equal(a.cpu(), b)]
    if bad:
        raise AssertionError(f"the CPU restore differs from the card's "
                             f"tree at {bad[:5]} ({len(bad)} leaves)")
    del host
    with open(shard, "r+b") as f:
        f.seek(file_bytes // 2)
        byte = f.read(1)[0]
        f.seek(file_bytes // 2)
        f.write(bytes([byte ^ 0xFF]))
    try:
        mgr.restore(step + 1, cpu_like)
    except CheckpointCorruptionError as e:
        print(f"[ckpt] flipped one byte of step {step + 1}'s shard: "
              f"restore raised {type(e).__name__}: {e}")
    else:
        raise AssertionError("restore of a corrupt shard did not raise")
    fell_back, _ = mgr.restore_latest(cpu_like)
    if fell_back != step:
        raise AssertionError(f"restore_latest gave step {fell_back}, not "
                             f"{step}")
    rec = {"step": step + 1, "leaves": len(named), "tensor_bytes": nbytes,
           "file_bytes": file_bytes, "restore_card_s": restore_s,
           "save_ms": save_ms, "wait_s": wait_s,
           "restore_cpu_s": cpu_restore_s, "fell_back_to": fell_back}
    print(f"[ckpt] {ARCH}: {len(named)} leaves, {nbytes / 1e9:.3f} GB of "
          f"tensors, shard file {file_bytes / 1e9:.3f} GB; restore of step "
          f"{step} into the card {restore_s:.3f} s; save() returned in "
          f"{save_ms:.1f} ms (the synchronous host copy), wait() "
          f"{wait_s:.3f} s (the background write and its CRC); restore into "
          f"the CPU {cpu_restore_s:.3f} s, bit-equal to the card's tree; "
          f"restore_latest fell back to step {fell_back}")
    return rec


def driver_argv() -> list:
    """Phase 13's driver flags (19 runs them again on a mesh)."""
    return ["--arch", ARCH, "--device", DEVICE, "--seed", str(SEED),
            "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--remat", "full", "--lr", str(TRAIN_LR),
            "--steps", str(DRIVER_STEPS)]


def phase_train_driver() -> dict:
    """13. The train driver at full width on its graph: uninterrupted
    (and once more with ``graphs=False``, the losses bit-equal),
    preempted, resumed (the losses bit-equal to the uninterrupted run's);
    then the checkpoint itself."""
    t0 = time.perf_counter()
    common = driver_argv()
    d = Path(tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
    try:
        reset_counts()
        full_eager = driver_run("a eager", common + [
            "--ckpt-dir", str(d / "a0"), "--ckpt-every", "0"], eager=True)
        full = driver_run("a", common + ["--ckpt-dir", str(d / "a"),
                                         "--ckpt-every", "0"])
        free = shutil.disk_usage(d).free
        print(f"[driver] {free / 1e9:.1f} GB free on {d}'s file system")
        every = ["--ckpt-dir", str(d / "b"), "--ckpt-every",
                 str(DRIVER_EVERY)]
        pre = driver_run("b", common + every + [
            "--simulate-preemption-at", str(DRIVER_PREEMPT)])
        resumed = driver_run("c", common + every)
        counts = read_counts()
        if pre.get("preempted_at") != DRIVER_PREEMPT:
            raise AssertionError(f"(b) returned {pre}, not preempted at "
                                 f"{DRIVER_PREEMPT}")
        if resumed.get("resumed_from") != DRIVER_RESUME:
            raise AssertionError(f"(c) resumed from "
                                 f"{resumed.get('resumed_from')}, not "
                                 f"{DRIVER_RESUME}")
        if any(counts.values()):
            raise AssertionError(f"the train driver launched kernels: "
                                 f"{counts}")
        want = np.asarray(full["losses"][DRIVER_RESUME:])
        got = np.asarray(resumed["losses"])
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        pre_rel = float(np.max(np.abs(np.asarray(pre["losses"])
                                      - full["losses"][:DRIVER_PREEMPT])
                               / np.abs(full["losses"][:DRIVER_PREEMPT])))
        print(f"[driver] resumed losses against the uninterrupted run's: "
              f"max relative difference {rel:.3e} ("
              + ("bit-equal" if got.tolist() == want.tolist() else "DIFFER")
              + f"); the preempted run's first {DRIVER_PREEMPT}: "
              f"{pre_rel:.3e}; (a) on the graph against (a) eager: "
              + ("bit-equal" if full["losses"] == full_eager["losses"]
                 else "DIFFER")
              + f"; the loop a step: (a) eager "
              f"{full_eager['ms_per_step']:.1f} ms, (a) "
              f"{full['ms_per_step']:.1f} ms, (b) "
              f"{pre['ms_per_step']:.1f} ms "
              f"({pre['ms_per_step'] / full['ms_per_step']:.2f}x), (c) "
              f"{resumed['ms_per_step']:.1f} ms; kernel launches {counts}")
        if got.tolist() != want.tolist() or \
                full["losses"] != full_eager["losses"]:
            raise AssertionError(
                f"driver losses: resumed {got.tolist()} vs {want.tolist()}; "
                f"graph {full['losses']} vs eager {full_eager['losses']}")
        ckpt = phase_checkpoint(d / "b")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec = {"a_eager": full_eager, "a": full, "b": pre, "c": resumed,
           "ckpt": ckpt,
           "free_gb": free / 1e9, "resume_rel": rel, "launches": counts,
           "phase_s": time.perf_counter() - t0}
    print(f"[driver] phase 13 took {rec['phase_s']:.1f} s")
    print(f"[driver] {json.dumps(rec)}")
    return rec


class FrameBatches:
    """Seeded train batches of the frontends on the card: ``batch_at(i)``
    holds the inputs of ``step_inputs`` and ``labels``, from seed
    ``SEED + i``."""

    def __init__(self, cfg, B: int, S: int):
        self.cfg, self.B, self.S = cfg, B, S

    def batch_at(self, i: int) -> dict:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + i)
        batch = step_inputs(self.cfg, self.B, self.S, gen)
        batch["labels"] = torch.randint(0, self.cfg.vocab, (self.B, self.S),
                                        generator=gen, device=DEVICE)
        return batch


def phase_frontend_train() -> dict:
    """14 (c). musicgen-large trained at full width and depth on seeded
    frames: ``M_TRAIN_STEPS`` steps at B=4, S=1024, remat full, AdamW lr
    1e-3, eager and on its graph (``train_pair``)."""
    cfg = get_config(MARCH)
    pair, held = train_pair(cfg, AdamW(lr=TRAIN_LR),
                            FrameBatches(cfg, M_TRAIN_B, M_TRAIN_S),
                            M_TRAIN_STEPS, lambda i: 1.0)
    del held
    torch.cuda.empty_cache()
    print(f"[train] {cfg.name} B={M_TRAIN_B} S={M_TRAIN_S} remat full, "
          f"AdamW lr {TRAIN_LR}: losses "
          + " ".join(f"{x:.4f}" for x in pair["eager"]["losses"]))
    return pair


def phase_frontends(device: dict) -> list:
    """14-15. musicgen-large (audio frames) and llama-3.2-vision-11b
    (cross-attention to an image) at full width and depth: prefill,
    serving eager and on graphs, and musicgen's train steps.  Returns
    the launch counts of each path."""
    paths = []
    for arch in (MARCH, VARCH):
        t0 = time.perf_counter()
        cfg, lm_k, lm_p, params = build_model(arch)
        paths.append(phase_prefill(lm_k, lm_p, params, iters=2)[0])
        t1 = time.perf_counter()
        paths.append(phase_serve(
            lm_k, params, device, F_REQUESTS, F_PROMPT_RANGE, F_GEN_RANGE,
            s_max=V_S_MAX if cfg.frontend == "vision" else None))
        graphs.release()
        del lm_k, lm_p, params
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        print(f"[frontends] {arch}: build and prefill {t1 - t0:.1f} s, "
              f"serving {t2 - t1:.1f} s")
        if cfg.frontend == "audio_frames":
            phase_frontend_train()
            print(f"[frontends] {arch}: train "
                  f"{time.perf_counter() - t2:.1f} s")
    return paths


def gmm_subs(arch: str, cases: dict, sub) -> dict:
    """The ``kernels`` line's grouped-matmul entries of ``arch``: both
    prefill products and both decode products, at the group sizes the
    main path gave them."""
    cfg = get_config(arch)
    moe = cfg.moe
    D, E, Fe = cfg.d_model, moe.n_experts, moe.d_expert
    out = {}
    for tag, C in (("prefill", capacity_of(PREFILL_B * PREFILL_S, moe)),
                   ("decode", capacity_of(SLOTS, moe))):
        for n, (d, f) in ((1, (D, 2 * Fe)), (2, (Fe, D))):
            out[f"{tag}_{('first', 'second')[n - 1]}"] = sub(
                ("gmm", arch, tag, n),
                f"({E}, {C}, {d}) x ({E}, {d}, {f}) bf16 ({arch} {tag}, "
                f"{('first', 'second')[n - 1]} product)")
    return out


def check_absorbed(lm_k: LM, params) -> None:
    """16 (c), 17 (c).  One prompt of ``DS_ORACLE_S`` tokens: the
    last-position logits of ``decode_step`` run token by token (MLA's
    absorbed form over the latent cache) against ``LM.prefill``'s (its
    materialised form), at atol 0.25, rtol 0.1, with the decode's expert
    choices replayed in the prefill."""
    cfg = lm_k.cfg
    S = DS_ORACLE_S
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=DEVICE)

    def stepped():
        caches = lm_k.init_caches(1, S)
        for t in range(S):
            logits, caches = lm_k.decode_step(params, {
                "tokens": toks[:, t:t + 1],
                "pos": torch.tensor(t, dtype=torch.int32, device=DEVICE)},
                caches)
        return logits
    routing = Routing()
    got = routing.run(stepped, False)
    n_moe = sum(f == "moe" for _, f in cfg.layer_kinds())
    # the prefill routes each MoE layer once over all S tokens
    routing.ids = [torch.cat([routing.ids[t * n_moe + j] for t in range(S)])
                   for j in range(n_moe)]
    want = routing.run(lambda: lm_k.prefill(params, {"tokens": toks}), True)
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    if not torch.isfinite(g).all() or not torch.allclose(
            g, w, atol=0.25, rtol=0.1):
        raise AssertionError(f"{cfg.name}: absorbed decode vs materialised "
                             f"prefill max abs err {err} (atol 0.25, rtol "
                             "0.1)")
    print(f"[deepseek] {cfg.name}: absorbed decode ({S} steps) vs "
          f"materialised prefill, last-position logits max abs err "
          f"{err:.4f} (max |logit| {w.abs().max().item():.3f}), argmax "
          f"{'equal' if g.argmax() == w.argmax() else 'differs'}, routing "
          "pinned")


def phase_deepseek(arch: str, n_layers: int, phase: int, device: dict
                   ) -> tuple[list, dict]:
    """16, 17.  ``arch`` at full width and ``n_layers``: the prefill with
    kernels against the plain one (routing pinned), the absorbed decode
    against the materialised prefill, static serving eager and on graphs;
    then, the model freed, the grouped matmul at the group sizes they
    gave it.  Returns the launch counts of each path and the kernel
    cases."""
    t0 = time.perf_counter()
    _, lm_k, lm_p, params = build_model(arch, n_layers=n_layers)
    counts, prefill_ids = phase_prefill(lm_k, lm_p, params, iters=2)
    check_absorbed(lm_k, params)
    t1 = time.perf_counter()
    serve_counts, decode_ids = phase_serve_static(lm_k, params, device)
    graphs.release()
    del lm_k, lm_p, params
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    cases = phase_gmm_kernels(arch, prefill_ids, decode_ids)
    print(f"[deepseek] phase {phase} ({arch}, {n_layers} layers): build, "
          f"prefill and oracle {t1 - t0:.1f} s, serving {t2 - t1:.1f} s, "
          f"grouped matmul {time.perf_counter() - t2:.1f} s")
    return [counts, serve_counts], cases


def phase_deepseek_train() -> dict:
    """17 (d).  deepseek-v3 at full width and ``DS_TRAIN_LAYERS`` layers
    (all dense) with its MTP head: ``DS_TRAIN_STEPS`` steps at B=2,
    S=1024, remat full, AdamW lr 1e-3 with the config's bf16 moments,
    eager and on its graph (``train_pair``); the ``mtp`` metric finite
    and the moments bf16."""
    cfg = dataclasses.replace(get_config(DS3), n_layers=DS_TRAIN_LAYERS)
    pair, held = train_pair(
        cfg, AdamW(lr=TRAIN_LR, moment_dtype=cfg.opt_moment_dtype),
        FrameBatches(cfg, DS_TRAIN_B, DS_TRAIN_S), DS_TRAIN_STEPS,
        lambda i: 1.0)
    n_params = sum(t.numel() for t in _leaves(held[1]))
    moments = {t.dtype for t in [*_leaves(held[2].mu),
                                 *_leaves(held[2].nu)]}
    del held
    torch.cuda.empty_cache()
    losses, mtp = pair["eager"]["losses"], pair["eager"]["metrics"]["mtp"]
    if moments != {torch.bfloat16}:
        raise AssertionError(f"{DS3} train: moment dtypes {moments}")
    print(f"[train] {DS3} at {DS_TRAIN_LAYERS} layers with the MTP head "
          f"({n_params / 1e9:.2f} B params) B={DS_TRAIN_B} S={DS_TRAIN_S} "
          f"remat full, AdamW lr {TRAIN_LR} with bf16 moments: losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; mtp "
          + " ".join(f"{x:.4f}" for x in mtp))
    return pair


def build_model(arch: str, n_layers: int | None = None):
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    lm_k = LM(cfg, use_kernels=True, device=DEVICE)
    lm_p = LM(cfg, use_kernels=False, device=DEVICE)
    params, _ = lm_k.init(SEED)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] {arch}: {n_params / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers, d {cfg.d_model}; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")
    return cfg, lm_k, lm_p, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def host_cpu() -> str:
    """The host CPU's model name, as ``lscpu`` or Linux's cpuinfo report
    it, with the machine's architecture."""
    fields = ("Model name:", "model name", "Model\t", "Hardware")
    try:
        text = subprocess.run(["lscpu"], capture_output=True, text=True,
                              timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        text = ""
    try:
        text += Path("/proc/cpuinfo").read_text()
    except OSError:
        pass
    for line in text.splitlines():
        if line.startswith(fields) and ":" in line:
            return f"{line.split(':', 1)[1].strip()}, {platform.machine()}"
    return f"model not reported, {platform.machine()}"


def pre_dse_schedule(arch: str):
    """construct → fuse → lower → multi-producer → balance at the goldens'
    shape, from a reset name counter."""
    reset_fresh_names()
    g = build_lm_graph(get_config(arch), SHAPES[GOLDEN_SHAPE])
    construct_functional(g)
    fuse_tasks(g)
    sched = lower_to_structural(g)
    eliminate_multi_producers(sched)
    balance_paths(sched)
    return sched


def phase_compiler(device: dict) -> dict:
    """18. The port's compiler against the goldens on all ten archs, then
    the serve driver's plan fetch, cold and hit."""
    t0 = time.perf_counter()
    rec = {}
    for arch in list_archs():
        golden = json.loads((GOLDEN_DIR / f"{arch}.json").read_text())
        if (golden["shape"], golden["mesh"]) != (GOLDEN_SHAPE, "SINGLE_POD"):
            raise AssertionError(f"{arch}: golden of {golden['shape']} on "
                                 f"{golden['mesh']}")
        sched = pre_dse_schedule(arch)
        if json.loads(json.dumps(sched.to_dict())) != golden["schedule"]:
            raise AssertionError(f"{arch}: the pre-DSE schedule differs "
                                 "from its golden")
        reset_fresh_names()
        t1 = time.perf_counter()
        g = build_lm_graph(get_config(arch), SHAPES[GOLDEN_SHAPE])
        osched, plan, rep = optimize(g, SINGLE_POD, training=True)
        secs = time.perf_counter() - t1
        if json.loads(plan.to_json()) != golden["plan"]:
            raise AssertionError(f"{arch}: the plan differs from its golden")
        if rep.degradations or not rep.verify.ok:
            raise AssertionError(f"{arch}: degraded {rep.degradations}, "
                                 f"verify {rep.verify.summary()}")
        rec[arch] = {"compile_s": secs, "nodes": len(osched.nodes),
                     "regions": rep.regions,
                     "evaluated": rep.parallelize.evaluated}
        print(f"[compiler] {arch}: pre-DSE schedule and plan equal the "
              f"golden; build_lm_graph + optimize {secs:.3f} s "
              f"({len(osched.nodes)} nodes, {rep.regions} regions, "
              f"{rep.parallelize.evaluated} proposals evaluated)")
    total = sum(r["compile_s"] for r in rec.values())
    print(f"[compiler] {len(rec)} plans equal their goldens; compile "
          f"{total:.3f} s in all on the host ({host_cpu()}, "
          f"{os.cpu_count()} logical CPUs), beside {device['smi']}")
    d = Path(tempfile.mkdtemp(prefix="repro_torch_plans_"))
    try:
        s_max = prefill_bucket(PROMPT_RANGE[1], 16) + GEN_RANGE[1]
        fetched = [fetch_plan(get_config(ARCH), slots=SLOTS, s_max=s_max,
                              cache_root=d) for _ in range(2)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    (cold, ci), (hit, hi) = fetched
    if (ci["source"], hi["source"]) != ("cold", "hit") or \
            cold.to_json() != hit.to_json():
        raise AssertionError(f"fetch_plan: {ci['source']} then "
                             f"{hi['source']}")
    rec["fetch_plan"] = {"bucket": ci["bucket"], "cold_ms": ci["fetch_ms"],
                         "hit_ms": hi["fetch_ms"]}
    print(f"[compiler] fetch_plan {ARCH} (bucket {ci['bucket']}): cold "
          f"{ci['fetch_ms']:.1f} ms, then a hit of the same plan in "
          f"{hi['fetch_ms']:.2f} ms")
    print(f"[compiler] phase 18 took {time.perf_counter() - t0:.1f} s")
    return rec


def phase_lint(device: dict) -> dict:
    """18, continued. The lint CLI's verdict (``repro_torch.lint``) on the
    ten smoke archs and ``synth_1k``, as the reference's lint suite runs
    them, every one ``ok``; then ``optimize`` of ``synth_5k`` on
    ``SINGLE_POD`` and the build of ``synth_10k``, timed on the host."""
    t0 = time.perf_counter()
    rec = {}
    for target in list_archs() + [LINT_SYNTH]:
        reset_fresh_names()
        res = lint_one(target)
        if not res["ok"] or res["errors"] or res["verify_errors"]:
            raise AssertionError(f"lint {target}: {json.dumps(res)}")
        rec[target] = {k: res[k] for k in ("checks", "nodes", "wall_s",
                                           "analyze_s")}
        print(f"[compiler] lint {target}: ok, {res['checks']} checks, "
              f"{len(res['rules_run'])} rules, {len(res['warnings'])} "
              f"warnings, {len(res['degradations'])} degradations, "
              f"{res['nodes']} nodes; compile {res['wall_s']:.3f} s, "
              f"analyze {res['analyze_s'] * 1e3:.2f} ms")
    reset_fresh_names()
    t1 = time.perf_counter()
    g = get_synth(COMPILE_SYNTH)
    build_s = time.perf_counter() - t1
    sched, _plan, rep = optimize(g, SINGLE_POD)
    compile_s = time.perf_counter() - t1
    if rep.verify.issues or rep.degradations:
        raise AssertionError(f"{COMPILE_SYNTH}: verify "
                             f"{rep.verify.summary()}, degraded "
                             f"{rep.degradations}")
    t1 = time.perf_counter()
    big = get_synth(BUILD_SYNTH)
    big_s = time.perf_counter() - t1
    n_big = sum(1 for _ in big.walk())
    rec["compile"] = {"synth": COMPILE_SYNTH, "build_s": build_s,
                      "compile_s": compile_s, "nodes": len(sched.nodes),
                      "regions": rep.regions}
    rec["build"] = {"synth": BUILD_SYNTH, "build_s": big_s, "ops": n_big}
    print(f"[compiler] {COMPILE_SYNTH}: build {build_s:.3f} s, build + "
          f"optimize {compile_s:.3f} s ({len(sched.nodes)} nodes, "
          f"{rep.regions} regions, verifier clean); {BUILD_SYNTH}: build "
          f"{big_s:.3f} s ({n_big} ops); {LINT_SYNTH} optimize "
          f"{rec[LINT_SYNTH]['wall_s']:.3f} s; on the host ({host_cpu()}, "
          f"{os.cpu_count()} logical CPUs), beside {device['smi']}")
    print(f"[compiler] lint and synthetic graphs took "
          f"{time.perf_counter() - t0:.1f} s")
    return rec


def phase_mesh(want_losses: list, device: dict) -> dict:
    """19. The port's plans on a ``DeviceMesh`` of the card: a single-rank
    NCCL group and a ``(1, 1)`` mesh (``launch.mesh.make_host_mesh``);
    smollm-135m's params at full width distributed by ``sharding_tree``
    under its train plan, each local shard equal to its full tensor; then
    phase 13's driver run on that mesh, its losses bit-equal to phase
    13's run without one."""
    t0 = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("a process group exists before phase 19")
    mesh = make_host_mesh((1, 1), device=DEVICE)
    setup_s = time.perf_counter() - t0
    backend = dist.get_backend()
    d = Path(tempfile.mkdtemp(prefix="repro_torch_mesh_"))
    try:
        cfg = get_config(ARCH)
        reset_fresh_names()
        _, plan, _ = optimize(build_lm_graph(cfg, ShapeSpec(
            "cli", TRAIN_S, TRAIN_B, "train")),
            MeshSpec((("data", 1), ("model", 1))))
        lm = LM(cfg, device=DEVICE, plan=plan)
        params, dims = lm.init(SEED)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        placed = distribute_tree(params, sharding_tree(
            dims, mesh, plan, weight=True, shapes_tree=params))
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t1
        full, local = _flatten(params), _flatten(placed)
        bad = [k for (k, a), (_, b) in zip(full, local)
               if not _bits_equal(b.to_local(), a)]
        if bad or len(full) != len(local):
            raise AssertionError(f"local shards differ from the full "
                                 f"tensors at {bad[:5]}")
        nbytes = sum(v.numel() * v.element_size() for _, v in full)
        n_leaves = len(full)
        del placed, params, lm, full, local
        torch.cuda.empty_cache()
        reset_counts()
        run = driver_run("mesh", driver_argv() + [
            "--ckpt-dir", str(d), "--ckpt-every", "0"])
        counts = read_counts()
    finally:
        shutil.rmtree(d, ignore_errors=True)
        dist.destroy_process_group()
    if any(counts.values()):
        raise AssertionError(f"the driver on the mesh launched {counts}")
    if run["world"] != 1 or run["losses"] != want_losses:
        raise AssertionError(f"driver on the (1, 1) mesh: world "
                             f"{run['world']}, losses {run['losses']} vs "
                             f"phase 13's {want_losses}")
    rec = {"setup_s": setup_s, "place_s": place_s, "leaves": n_leaves,
           "bytes": nbytes,
           "ms_per_step": run["ms_per_step"],
           "phase_s": time.perf_counter() - t0}
    print(f"[mesh] {backend} group of 1 rank and a (1, 1) mesh set up in "
          f"{setup_s:.3f} s on {device['kind']} ({device['smi']}); "
          f"{ARCH}'s {rec['leaves']} param leaves ({nbytes / 1e9:.3f} GB) "
          f"distributed by sharding_tree in {place_s:.3f} s, every local "
          f"shard equal to its full tensor; the driver on the mesh: "
          f"{len(run['losses'])} losses bit-equal to phase 13's run "
          f"without it, the loop {run['ms_per_step']:.1f} ms a step, no "
          f"kernel launch")
    print(f"[mesh] phase 19 took {rec['phase_s']:.1f} s")
    return rec


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def _timed(fn):
    """(fn(), seconds between synchronised host clock readings)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ms_list(ts: list) -> str:
    return "/".join(f"{t:.3f}" for t in ts)


def _ep_grads(fn, x, p, ct):
    """Gradients of ``sum(y·ct) + 0.01·lb + 0.001·z`` of ``fn(x, p)`` with
    respect to x and the router and expert weights (f32)."""
    leaves = [x] + [p[k] for k in EP_GRAD_KEYS]
    leaves = [t.detach().requires_grad_() for t in leaves]
    y, aux = fn(leaves[0], {**p, **dict(zip(EP_GRAD_KEYS, leaves[1:]))})
    loss = (y.float() * ct).sum() + 0.01 * aux.load_balance_loss \
        + 0.001 * aux.router_z_loss
    return torch.autograd.grad(loss, leaves)


def phase_ep(device: dict) -> tuple[list, dict]:
    """20. Expert-parallel MoE on a one-rank NCCL group and a ``(1, 1)``
    mesh: deepseek-v2's first MoE layer at full width (160 experts of
    d 1536, top-6, 2 shared, capacity factor 1.25), x (4, 1024, 5120)
    bf16, experts over ``("model",)`` (G = 1, so ``moe_ffn_ep``'s capacity
    and slots are ``moe_ffn``'s), then again with each expert's d_ff split
    over the other axis (``tp_axis="data"``, the psum).  Each: the plain
    path bit-equal to ``moe_ffn``; at f32 inputs its gradients within
    ``EP_GRAD_TOL`` of ``moe_ffn``'s; the kernel path (routing pinned)
    launching the grouped matmul exactly twice, within 2e-2 of the plain
    path.  Then the two products at the EP shapes (every row live) timed
    against their bounds and ``torch.bmm``.  The group stays up for
    phases 21 and 22."""
    t0 = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("a process group exists before phase 20")
    mesh = make_host_mesh((1, 1), device=DEVICE)
    cfg = get_config(DS2)
    moe = cfg.moe
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pb = ParamBuilder(gen, device=torch.device(DEVICE))
    moe_mod.init_moe(pb, "m", cfg)
    p = pb.params["m"]
    x = torch.randn((EP_B, EP_S, cfg.d_model), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    cap = max(1, math.ceil(EP_B * EP_S * moe.top_k * moe.capacity_factor
                           / moe.n_experts))
    if cap != capacity_of(EP_B * EP_S, moe):
        raise AssertionError(f"EP capacity {cap} != moe_ffn's "
                             f"{capacity_of(EP_B * EP_S, moe)}")

    def noop(t, d, s=None):
        return t
    paths, rec = [], {"capacity": cap}
    for tag, batch_axes, tp in (("ep", ("data",), None),
                                ("ep_tp", (), "data")):
        def ep(x, p, use_kernels=False):
            return moe_mod.moe_ffn_ep(x, p, cfg, batch_axes, ("model",),
                                      (), mesh, tp_axis=tp,
                                      use_kernels=use_kernels)
        routing = Routing()
        with torch.no_grad():
            # warm: the first call sets up NCCL's communicator and cuBLAS
            moe_mod.moe_ffn(x, p, cfg, noop)
            ep(x, p)
            ep(x, p, use_kernels=True)
            want, want_aux = moe_mod.moe_ffn(x, p, cfg, noop)
            torch.cuda.reset_peak_memory_stats()
            got, aux = routing.run(lambda: ep(x, p), replay=False)
            peak_plain = _peak_gb()
            if not (_bits_equal(got, want) and all(
                    _bits_equal(a, b) for a, b in zip(aux, want_aux))):
                raise AssertionError(f"{tag}: the plain expert-parallel "
                                     "path differs from moe_ffn")
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            got_k, _ = routing.run(lambda: ep(x, p, use_kernels=True),
                                   replay=True)
            counts = read_counts()
            peak_kernel = _peak_gb()
            # each call's device time: EP_REPEATS means of EP_ITERS calls
            # (its spread bounds what a difference between them can say)
            t_global, t_plain, t_kernel = (
                [time_ms(fn, iters=EP_ITERS, warmup=2)
                 for _ in range(EP_REPEATS)]
                for fn in (lambda: moe_mod.moe_ffn(x, p, cfg, noop),
                           lambda: ep(x, p),
                           lambda: ep(x, p, use_kernels=True)))
        paths.append(counts)
        if counts != {**{k: 0 for k in COUNTED}, "moe_gmm": 2}:
            raise AssertionError(f"{tag}: the kernel path launched {counts}")
        err = check_close(f"{tag} kernel path", got_k, got, torch.bfloat16)
        del got_k, got, want
        # f32 gradients against moe_ffn's
        p32 = {k: v.float() for k, v in p.items()}
        ct = torch.randn(x.shape, generator=gen, device=DEVICE)
        g_ep = _ep_grads(ep, x.float(), p32, ct)
        g_ref = _ep_grads(lambda x, p: moe_mod.moe_ffn(x, p, cfg, noop),
                          x.float(), p32, ct)
        del p32, ct
        gerr = {}
        for name, a, b in zip(("x",) + EP_GRAD_KEYS, g_ep, g_ref):
            # a few experts at a time: the expert gradients take 10 GB
            gerr[name], close = 0.0, True
            for i in range(0, a.shape[0], 16):
                ai, bi = a[i:i + 16], b[i:i + 16]
                gerr[name] = max(gerr[name], (ai - bi).abs().max().item())
                close &= torch.allclose(ai, bi, rtol=EP_GRAD_TOL,
                                        atol=EP_GRAD_TOL)
            if not close:
                raise AssertionError(f"{tag}: gradient of {name} differs "
                                     f"from moe_ffn's by {gerr[name]}")
        del g_ep, g_ref, a, b, ai, bi
        torch.cuda.empty_cache()
        rec[tag] = {"global_ms": t_global, "plain_ms": t_plain,
                    "kernel_ms": t_kernel, "peak_plain_gb": peak_plain,
                    "peak_kernel_gb": peak_kernel, "max_abs_err": err,
                    "grad_err": gerr}
        print(f"[ep] {tag}: {DS2} MoE layer, x ({EP_B}, {EP_S}, "
              f"{cfg.d_model}) bf16, experts over ('model',)"
              + (f", d_ff over {tp!r}" if tp else "")
              + f", capacity {cap}: plain path bit-equal to moe_ffn; "
              f"kernel path {counts['moe_gmm']} grouped-matmul launches, "
              f"err {err:.3g}; f32 gradients vs moe_ffn max "
              + ", ".join(f"{k} {v:.3g}" for k, v in gerr.items())
              + f"; device ms per call, {EP_REPEATS} means of {EP_ITERS} "
              f"calls each: moe_ffn {_ms_list(t_global)}, plain EP "
              f"{_ms_list(t_plain)} (peak {peak_plain:.2f} GB), kernel EP "
              f"{_ms_list(t_kernel)} (peak {peak_kernel:.2f} GB) on "
              f"{device['kind']} ({device['smi']})")
    del p, x
    torch.cuda.empty_cache()
    gs = torch.full((moe.n_experts,), cap, dtype=torch.int32, device=DEVICE)
    cases = {("gmm", "ep", 1): gmm_case(gs, cap, cfg.d_model,
                                        2 * moe.d_expert, torch.bfloat16)}
    torch.cuda.empty_cache()
    cases[("gmm", "ep", 2)] = gmm_case(gs, cap, moe.d_expert, cfg.d_model,
                                       torch.bfloat16)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[ep] phase 20 took {rec['phase_s']:.1f} s")
    return paths, cases


def phase_compress(device: dict) -> dict:
    """21. Int8 error-feedback compression on the card: a params-shaped
    f32 tree of smollm-135m from a seed; the card's int8 payloads and
    scales bit-equal to the CPU's, and ``dp_allreduce_compressed`` over
    the one-rank group equal to ``decompress(q, s)`` exactly; its time
    against a plain all-reduce of the same tree."""
    t0 = time.perf_counter()
    shapes = LM(get_config(ARCH), device=DEVICE).param_shapes()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    grads = _map_leaves(lambda t: torch.randn(t.shape, generator=gen,
                                              device=DEVICE), shapes)
    state = init_ef_state(grads)
    q, s, _ = ef_compress_tree(grads, state)
    cq, cs, _ = ef_compress_tree(_map_leaves(lambda t: t.cpu(), grads),
                                 init_ef_state(_map_leaves(
                                     lambda t: t.cpu(), grads)))
    bad = [i for i, (a, b, c, d) in enumerate(zip(
        tree_leaves(q), tree_leaves(cq), tree_leaves(s), tree_leaves(cs)))
        if not (_bits_equal(a.cpu(), b) and _bits_equal(c.cpu(), d))]
    if bad:
        raise AssertionError(f"compress: the card's payloads or scales "
                             f"differ from the CPU's at leaves {bad}")
    mean, _ = dp_allreduce_compressed(grads, state)
    deq = ef_decompress_tree(q, s)
    if not all(_bits_equal(a, b) for a, b in zip(tree_leaves(mean),
                                                 tree_leaves(deq))):
        raise AssertionError("dp_allreduce_compressed over one rank is "
                             "not decompress(q, s)")
    leaves = tree_leaves(grads)

    def plain():
        for g in leaves:
            dist.all_reduce(g.clone())
    rec = {"leaves": len(leaves),
           "elements": sum(g.numel() for g in leaves),
           "compressed_ms": time_ms(lambda: dp_allreduce_compressed(
               grads, state), iters=5, warmup=1),
           "plain_ms": time_ms(plain, iters=5, warmup=1)}
    del grads, q, s, mean, deq, state, leaves
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[compress] {ARCH}'s {rec['leaves']} param-shaped f32 leaves "
          f"({rec['elements'] / 1e6:.1f}M elements): int8 payloads and "
          f"scales bit-equal to the CPU's; dp_allreduce_compressed over "
          f"one rank equals decompress(q, s); it takes "
          f"{rec['compressed_ms']:.3f} ms against {rec['plain_ms']:.3f} ms "
          f"for a plain all_reduce of the tree on {device['kind']} "
          f"({device['smi']}); phase 21 took {rec['phase_s']:.1f} s")
    return rec


def phase_gpipe(device: dict) -> dict:
    """22. ``gpipe`` over a one-rank ``("pod",)`` stage axis: S = 1, M = 8
    microbatches of (16, 4096) f32, ``tanh(x @ w)``; equal to the
    sequential oracle bit for bit.  The group is destroyed after."""
    t0 = time.perf_counter()
    try:
        mesh = make_host_mesh((1,), axes=("pod",), device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        ws = torch.randn((1, GP_D, GP_D), generator=gen,
                         device=DEVICE) * GP_D ** -0.5
        mb = torch.randn((GP_M, GP_B, GP_D), generator=gen, device=DEVICE)

        def stage(w, x, sid):
            return torch.tanh(x @ w)
        run = gpipe(stage, PipelineConfig(1, GP_M), mesh)
        got, run_s = _timed(lambda: run(ws, mb))
        want = torch.stack([stage(ws[0], mb[i], 0) for i in range(GP_M)])
        if not _bits_equal(got, want):
            raise AssertionError(f"gpipe differs from the oracle by "
                                 f"{(got - want).abs().max().item()}")
    finally:
        dist.destroy_process_group()
    rec = {"run_s": run_s, "phase_s": time.perf_counter() - t0}
    print(f"[gpipe] S=1, M={GP_M}, microbatches ({GP_B}, {GP_D}) f32: "
          f"bit-equal to the sequential oracle, {run_s * 1e3:.2f} ms on "
          f"{device['kind']}; phase 22 took {rec['phase_s']:.1f} s")
    return rec


#: phase 23's child: the dry-run of two cells on fake tensors over a fake
#: process group (which cannot share a process with NCCL)
DRYRUN_CHILD = r"""
import json, sys, time
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.dryrun import run_cell
out = []
for arch, shape, mesh in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    shape = shape if isinstance(shape, str) else ShapeSpec(*shape)
    r = run_cell(arch, shape, mesh_axes=[tuple(a) for a in mesh] or None)
    r["cell_s"] = time.perf_counter() - t0
    out.append(r)
print(json.dumps(out))
"""


def start_dryrun() -> subprocess.Popen:
    """23 (start).  The port's dry-run in a child process: fake tensors
    over a fake process group, which cannot share a process with NCCL and
    needs no card, so it runs on the host while phases 2-22 use the card:
    the reduced smollm train cell of the tests (``ShapeSpec("t", 512, 16,
    "train")`` on a (4, 2) mesh) and smollm-135m ``train_4k`` on the 16x16
    mesh."""
    cells = [[ARCH, ["t", 512, 16, "train"], [["data", 4], ["model", 2]]],
             [ARCH, "train_4k", []]]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    # its output goes to files, which nothing has to drain while it runs
    DRYRUN_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(DRYRUN_LOG.with_suffix(".out"), "w") as out, \
            open(DRYRUN_LOG.with_suffix(".err"), "w") as err:
        return subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD,
                                 json.dumps(cells)], env=env, stdout=out,
                                stderr=err)


def phase_dryrun(proc: subprocess.Popen, device: dict) -> list:
    """23. The dry-run's two cells (``start_dryrun``) must be ``ok``; per
    rank argument and temp bytes, FLOPs, collectives by kind and each
    cell's seconds on the card machine's host."""
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=DRYRUN_WAIT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"the dry-run child ran past phase 22 by "
                             f"{DRYRUN_WAIT} s")
    out = DRYRUN_LOG.with_suffix(".out").read_text()
    if proc.returncode:
        err = DRYRUN_LOG.with_suffix(".err").read_text()
        raise AssertionError(f"the dry-run child exited {proc.returncode}:"
                             f"\n{err[-3000:]}")
    recs = json.loads(out.splitlines()[-1])
    for r in recs:
        if r["status"] != "ok":
            raise AssertionError(f"dry-run {r['arch']} {r['shape']} "
                                 f"{r['mesh']}: {r['status']}: "
                                 f"{r.get('error')}\n{r.get('traceback')}")
        mem = r["memory_analysis"]
        coll = r["collectives"]
        print(f"[dryrun] {r['arch']} {r['shape']} on {r['mesh']} (fake "
              f"tensors, {r['chips']} fake ranks): per rank arguments "
              f"{mem['argument_size_in_bytes']} B, temp "
              f"{mem['temp_size_in_bytes']} B, "
              f"{r['cost_analysis']['flops']:.6g} FLOPs; collectives "
              + ", ".join(f"{k} {coll['count_by_kind'][k]} x "
                          f"{coll['bytes_by_kind'][k]} B"
                          for k in sorted(coll["count_by_kind"]))
              + f"; {r['cell_s']:.1f} s on the host of {device['kind']}")
    print(f"[dryrun] phase 23 waited {time.perf_counter() - t0:.1f} s for "
          f"its child after phase 22")
    return recs


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
