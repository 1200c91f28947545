#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (the run exits non-zero if any of them fails):

  1. GPU identity and the kernels' build: ``nvcc`` compiles every source of
     ``src/repro_torch/csrc`` in parallel; ptxas' register and spill report
     is printed.
  2. Each kernel against its plain PyTorch version on the card, on the case
     grid of the kernel tests and on heavy rows (a window of 2,100 blocks,
     2,000 identity padding blocks on one window, windows whose block ends
     in identity slots with ldst 0, unsorted rows, a dst row of 1,100
     tiles): bit-exact for min/max; for sums, each output within 1e-5 of
     the same sum taken over the inputs' absolute values (the scale of a
     reordered float sum's rounding), and two launches give the same bits.
  3. The windows path at full size: ``GraphSession.from_graph(
     kronecker_graph(20, seed=7), 16, "cdbh")``; SSSP from two sources and
     a warm repeat, CC and PageRank on ``pallas_windows``, each held against
     the same query on ``coo``.
  4. The tiles path: ``grid_graph(1024, weighted=True, seed=9)`` with the
     ``range`` vertex-cut (P=16), SSSP, CC and PageRank on ``pallas_tiles``
     against ``coo``; then the quickstart graph (``kronecker_graph(14)``,
     ``cdbh``, P=16) on ``pallas_tiles``. SSSP and CC must also take the
     supersteps and host syncs of ``coo``; the peak device memory of each
     path is printed.
  5. Kernel confirmation: both kernels' launch counters, reset just before
     phase 3 and read just after phase 4, must be positive. Each kernel is
     then checked and timed against its plain version at the
     shapes phases 3 and 4 gave it (the compact device lists), beside its
     bound on the card and, where one PyTorch call computes the same
     function, that call's time; and timed again on the padded JAX-layout
     input, where every padding block / tile sits on a partition's last
     window / dst row. ``bsp_spmv`` plus_times is also timed at the grid
     PageRank shape beside ``torch.sparse.mm`` of a BSR matrix.
  6. Streaming, on phase 3's kron-20 session (``pallas_windows``, its
     buffer bound above a batch) and phase 4's kron-14 session
     (``pallas_tiles``), with both launch counters reset before it: two
     symmetric insert batches of 0.5% of the edges (weights in [5, 10);
     the second brings 1,024 new vertex ids; together they must move the
     slot capacity to its next bucket), each flushed and followed by
     SSSP warm-auto and cold (bit-identical, warm in fewer supersteps),
     the same query on ``coo`` and scipy's Dijkstra on the mutated edge
     list; a delete batch of 5% of the resident edges (warm results
     dropped), CC and PageRank against ``coo``; ``compact()`` and SSSP
     again. On kron-14: one batch through many small ``update`` calls
     (auto-flushes), one batch that moves the ``e_max`` bucket (the
     fullest partition's resident pairs again, so the tiles keep their
     shape), and a compaction, each followed by SSSP, CC and PageRank on tiles against
     ``coo``; then a trace run with ``checkpoint_every=2`` resumed from its
     second checkpoint. Both counters must be positive after it, and each
     kernel is checked against its plain version on the post-compact
     device lists. Per step it prints the host time of the flush (the
     layout refresh apart), the re-upload of the device graph and of the
     kernels' device list, and the query wall times.
  7. The algorithm suite, with both launch counters reset before it. On
     phase 3's kron-20 session (as phase 6 left it): BFS from two seeded
     roots, MSBFS and triangles with K = 16 seeded roots / pivots on
     ``pallas_windows``, each bit-identical to ``coo`` (results,
     supersteps, messages, per-partition sweeps); levels against scipy's
     unweighted shortest paths (4 lanes), triangles against float64 scipy
     products on the same edge list (every z below 2**24); then an insert
     batch and MSBFS warm-auto vs cold. On phase 4's grid-1024 session:
     MSBFS K = 16 on ``pallas_tiles`` the same way. On a kron-14 session of
     its own (weighted, seeded labels): triangles K = 16 on
     ``pallas_tiles`` vs ``coo`` and scipy; MSSP (K = 8) vs Dijkstra; LP,
     k-core (k = 2, 3), betweenness (8 pivots) and graph simulation against
     the script's numpy/scipy oracles; a delete batch then k-core warm vs
     cold, an insert batch then MSBFS warm vs cold. Then each kernel at
     K = 16 on those device lists (``segment_combine`` min and sum at
     kron-20, ``bsp_spmv`` min_plus at grid-1024 and plus_times at
     kron-14) against its plain version, timed beside its bound and the
     library call; the peak device memory of each part is printed.

  8. ``edge_backend='auto'`` and the balanced vertex-cut, after the
     earlier sessions are dropped. The calibration table is measured on
     the card (``DRONE_AUTOTUNE_DIR=build/autotune``) and must reload to
     the same JSON. ``GraphSession.from_graph(kronecker_graph(20, seed=7),
     16, "ebv", rebalance="auto")``: EBV routing time, replication factor
     and imbalance beside phase 3's cdbh; SSSP from phase 3's two sources,
     CC and PageRank under ``'auto'`` and on ``pallas_windows``, each
     against ``coo`` (SSSP also against Dijkstra). grid-1024 / range /
     P=16 under a forced three-way assignment (``coo``, tiles, windows by
     partition mod 3) through ``make_sim_runner(partition_backends=)``:
     SSSP, CC and PageRank against uniform ``coo``, both kernels launched;
     then the calibrated ``'auto'`` SSSP beside tiles and ``coo``. On the
     ebv session: a 0.5% symmetric insert batch, a delete wave on 6 of the
     16 partitions over two flushes that fires the monitor exactly once,
     SSSP warm and cold, CC and PageRank after the rebalance against
     ``coo`` (SSSP against Dijkstra), and deletes of original edges through
     the router's pair table (the copies they miss must be exactly those
     the rebalance left on its donors while moving their pair, a fault
     kept for parity with the reference); each kernel against its plain
     version on the group-sliced device lists. Per step it prints the
     flush's host time, the rebalance's plan and execution, the layout
     refresh and the re-upload.
  9. Serving and micro-batching. On phase 8's kron-20 ebv session after
     its last step, on ``pallas_windows``: ``query_batch`` of SSSP from 5
     sources (the 8-lane bucket), each lane bit-identical to its
     singleton query (results, supersteps, messages, per-partition
     sweeps) and two lanes to scipy's Dijkstra, with the batch's
     ``segment_combine`` launches equal to its singletons' sum; a batch
     of 8 that builds no runner; SSSP B=4 on ``coo``, CC B=2, a leafless
     PageRank (its lanes fan out from one runner call) and PageRank B=2
     (within PR_RTOL); a ``ResultCache(store=DictStore())`` whose repeated
     batch is an all-hit with no launch, then an insert that makes every
     lane miss (Dijkstra again on the new edges). Then two kron-14 tenants
     (seeds 7 and 8, one shape bucket) in one ``SessionPool`` on
     ``pallas_tiles``: tenant b's first query builds no runner; 8 SSSP
     requests through a ``MicroBatcher(max_batch=4)`` (2 inline batches,
     each lane equal to its singleton, none degraded), a result-cache
     fast-path repeat, and one ``start()`` / ``stop()`` round whose batch
     the pump thread launches. Each kernel is checked against its plain
     version on the device lists the phase ran on. It prints each batch's
     host time beside its singletons' and the all-hit batch's time.

 10. The ``shard_map`` backend (``backend='shard_map'`` over
     ``torch.distributed``). 10a, one process, before the earlier sessions
     are dropped: the S = 2 edge-sharded geometry of phase 3's kron-20
     session (windows) and phase 4's grid session (tiles); each kernel on
     every (partition, shard) device list against its plain version (min
     exact, sums within 1e-5 of |terms|), min_plus and plus_times, and the
     shards' products reduced (min, or summed) against each partition's
     unsharded product. 10b, after phase 9: 4 processes on the one card,
     spawned by ``torch.multiprocessing``, one gloo job over CUDA tensors
     (the collectives stage through the host); each rank loads the
     parent's host arrays (the parent builds kron-20 / cdbh at P = 4 and
     P = 2 from phase 3's graph and grid / range at P = 2, and saves them
     under ``build/shard``), then runs through ``repro_torch.core.run``
     on a ``(4,)`` mesh SSSP from phase 3's two sources, CC and PageRank
     on kron-20 P = 4, on ``pallas_windows`` and on ``coo``, and on a
     ``(2, 2)`` sub x edge mesh SSSP, CC and PageRank on kron-20 P = 2
     (windows) and CC on the grid P = 2 (tiles). Every rank's results must
     equal a one-process ``run_sim`` of the same partitioned graph on the
     card (bit for bit, PageRank within PR_RTOL; supersteps, messages and
     per-partition sweeps equal for every program), and each P = 4
     windows run its ``coo`` twin the same way; each rank's kernel
     counters (set to 0 before each query) must be positive, each kernel
     must equal its plain version on the rank's own list (the query's
     program, min_plus and plus_times), and every exit code must be 0.
     10c: a world of one over NCCL: ``GraphSession(mesh=)`` on kron-14 /
     cdbh / P = 1 on both kernel backends, a query, an insert batch with
     ``flush`` and a warm query, against the simulator session (counters
     set to 0 before each query). It prints per query the
     wall time, supersteps, host syncs and collective calls, the launches
     per kernel (``launches_shard``), the peak device memory per rank and
     the phase's seconds.

 11. The LM serving path (``repro_torch.models``, no kernel of its own):
     olmo-1b at full width and depth (16 layers, d_model 2048, 16 heads,
     d_ff 8192, vocab 50,304; 1,176,764,416 fp32 parameters, bf16
     activations) with the port's seeded weights, TF32 off. 11a:
     ``examples/serve_lm.py``'s defaults through ``make_prefill_step`` /
     ``make_serve_step`` (batch 4, prompt 24, 32 greedy tokens), timed after
     a warm-up; the same inputs replayed through ``prefill`` /
     ``decode_step`` (their first 4 steps once more under
     ``torch.profiler``), every step's logits within LM_BF16_ATOL of
     ``forward`` over the same prefix, and each greedy token equal to the
     forward's argmax, or else its forward logit within twice its row's
     decode-vs-forward error of the forward's largest (a near-tie at bf16
     resolution). 11b: the model cut to its first 4 layers (to pay for
     phase 16), one long request, a 32,768-token prompt at batch 1
     (prefill_32k's length; its batch of 32 would need ~137 GB of cache)
     through the blockwise path, and 16 greedy steps, held against
     ``forward`` over the same 32,783 tokens the same way; blockwise
     attention against dense at that length (float32, within 2e-5), and one
     layer's attention timed and profiled. 11c: the model cut to 2 layers
     with float32 activations, the card's forward logits against the CPU's
     on the same weights (within LM_FP32_ATOL) and 8 greedy tokens equal. It
     prints prefill time, decode time per step and tokens/s, peak device
     memory, each beside its bound from the shapes (``lm_work``: every
     weight read once, the valid KV read once, causal attention pairs; 3.35
     TB/s, 989 bf16 TFLOP/s), and the device's busy time and idle share
     under the profiler.

 12. The MoE family on the LM serving path (``repro_torch.models.moe``,
     MLA, MTP; no kernel of its own), seeded bf16 weights, TF32 off, each
     model freed before the next. 12a: phi3.5-MoE-42B at full width
     (d_model 4096, 32 heads, GQA kv 8, 16 experts top-2, d_ffe 6400,
     vocab 32,064, capacity 1.25), depth cut from 32 to 8 layers
     (10,665,205,888 parameters, 19.87 GiB; 28 fit the card, 8 pay for
     phase 16). 12b: DeepSeek-V3 at full width
     (d_model 7168, 128 heads, MLA q_lora 1536 / kv_lora 512 / rope 64, 3
     dense layers then MoE of 256 experts top-8 plus 1 shared expert,
     d_ffe 2048, aux-free bias, vocab 129,280) cut from 61 to 5 layers plus
     its MTP module (27,587,293,696 parameters, 51.39 GiB). Each serves
     ``examples/serve_lm.py``'s defaults through the step builders (timed
     after a warm-up), then replays the same inputs through ``prefill`` /
     ``decode_step`` with forward hooks on the ``MoE`` modules (``MoeTap``:
     each call's dropped share, expert load and router picks): the replay
     reproduces the served tokens, no decode step drops a pair, every
     logit is finite, and the prefill's last logits equal ``forward`` on
     the same prompt (same token count, so the same drops) within
     LM_BF16_ATOL, the router picks of the two compared (a differing pick
     must be a near-tie, and its batch row leaves the logit check). It
     prints each layer's prefill drop share and expert load, the MLA
     cache's bytes beside per-head keys and values of the same heads, and
     checks ``mtp_logits`` on the forward's ``mtp_hidden`` ([B, S, V],
     finite); 4 decode steps run under ``torch.profiler``. 12c: each model
     cut to 2 layers in float32 (DeepSeek: 1 dense layer, 16 of its 256
     routed experts), the card against the CPU on the same weights:
     forward logits within LM_FP32_ATOL, ``moe_dropped`` equal, the router
     picks equal (or differing at near-ties, counted), 8 greedy tokens
     equal. It prints prefill time, decode time per step and tokens/s,
     peak device memory, each beside its bound (``lm_work``: only the
     routed experts a step sends a kept pair to, the shared expert, the
     router and the attention and dense weights read once, the MLA latent
     cache read once; the top-k kept pairs' and the shared expert's
     operations), and the device's idle share.

 13. Mamba and the Jamba hybrid on the LM serving path
     (``repro_torch.models.ssm``; no kernel of its own), seeded bf16
     weights, TF32 off, after phase 12's models are freed. jamba-v0.1-52b
     at full width (d_model 4096, 32 heads, GQA kv 8, d_ff 14336, Mamba
     d_state 16 / d_conv 4 / expand 2, so di 8192 and dt_rank 256, 16
     experts top-2 on the odd layers, vocab 65,536), depth cut from 32 to 8
     layers, one whole 8-layer Jamba block: 7 Mamba, 1 attention, 4 MoE
     (13,295,235,136 parameters, 24.77 GiB; 24 fit the card, 8 pay for
     phase 16). 13a: serve_lm's defaults through the step
     builders (timed after a warm-up) and phase 12's tapped replay (no
     decode step drops a pair; the prefill's last logits equal
     ``forward`` on the same prompt), 4 decode steps profiled. Then the
     held check (``jamba_held``), with every MoE layer's capacity factor
     raised to 8 (a slot per token in every expert, so no path drops a
     pair whatever its token count): a greedy loop through ``prefill`` /
     ``decode_step`` (every Mamba cache's ``h`` and ``conv`` in bf16)
     against ``forward`` over the same prefix. The two paths multiply
     matrices of other shapes and round apart, and routers at a near-tie
     then pick other experts: every row's first such flip must be a
     near-tie. ``forward`` runs again with its routing pinned to the
     loop's picks, and every step's logits must lie within
     max(LM_BF16_ATOL, 2 x the rounding floor) of it, the floor being how
     far that forward moves when its input moves by one ulp (a bf16
     random-weight Jamba turns that ulp into 1.3-1.5 logits); each greedy
     token is the forward's argmax or a near-tie. 13b: one 4,096-token
     request at batch 1 (8 scan chunks of 512) and 16 greedy steps, timed
     and tapped, the prefill against ``forward`` on the same prompt, one
     Mamba layer's prefill timed and profiled; then the request replayed
     dropless and held the same way on JAMBA_LONG_HELD_LAYERS layers (the
     whole 8-layer model; at 24 layers a dropless MoE at 4,111 tokens
     needed ~7 GiB beside 72.30 GiB of weights, so 16 were held); with
     the model freed, the chunked scan against
     the single-shot one at one Mamba layer's shapes (di 8192, n 16) over
     2,048 tokens in float32 (within 1e-5). 13c: the model cut to its first
     5 layers (4 Mamba, the attention layer, 2 MoE) with 4 of its 16
     routed experts, float32 (2,937,892,872 parameters), the card against
     the CPU on the same weights: forward logits within LM_FP32_ATOL,
     ``moe_dropped`` equal, router picks equal or near-ties, 8 greedy
     tokens equal, the Mamba caches after the prefill within
     LM_FP32_ATOL; and the card's own cached path held against its
     forward as in 13a, within 5e-4 (the reference's decode-vs-forward
     bound). It prints prefill time, decode time per step and tokens/s,
     peak device memory, each beside its bound (``lm_work``: a Mamba
     layer's weights read once and its ``conv`` and ``h`` read and written
     per step; its projections and the scan's ~6 b s di n operations), and
     the device's idle share.

 14. The xLSTM cells on the LM serving path (``repro_torch.models.ssm``'s
     ``MLSTM`` / ``SLSTM``; no kernel of their own), seeded weights, TF32
     off, after phase 13's models are freed. xlstm-350m at full width and
     depth: 24 blocks without an MLP (21 mLSTM, 3 sLSTM), d_model 1024, 4
     heads of 256, vocab 50,304, tied embeddings, fp32 parameters (the
     gate leaves ``wi`` / ``wf`` / ``b`` float32 too), bf16 activations;
     187,013,120 parameters. 14a: serve_lm's defaults through the step
     builders (timed after a warm-up), every cache checked (mLSTM ``C`` /
     ``n`` / ``m`` float32, sLSTM ``h`` bf16 beside float32 ``c`` / ``n`` /
     ``m``, each its own storage), the replay through ``prefill`` /
     ``decode_step`` held against ``forward`` (``lm_held``: within
     max(LM_BF16_ATOL, 2 x the model's one-ulp floor), as phase 13 holds
     Jamba, the floor printed), 4 decode steps profiled. 14b: one
     4,096-token request at batch 1 (8 mLSTM chunks of 512, 4,096
     sequential steps in each sLSTM layer) and 16 greedy steps, timed and
     held the same way over 4,111 tokens; one mLSTM layer's prefill (4,096
     tokens) and one sLSTM layer's (4,096 timed, 256 profiled) timed and
     profiled; with the model freed, the chunkwise mLSTM against the
     parallel form at one layer's shapes over 2,048 tokens in float32
     (within 5e-4, the reference test's bound). 14c: the first 8 layers (7
     mLSTM, 1 sLSTM) in float32, card against CPU: forward logits and the
     prefill's xLSTM caches within LM_FP32_ATOL, 8 greedy tokens equal, the
     card's cached path against its own forward within 5e-4.
 15. The encoder-decoder and the frontend stubs (no kernel), seeded
     weights, TF32 off. 15a: seamless-m4t-large-v2 at full width (d_model
     1024, 16 heads, d_ff 8192 gelu, vocab 256,206, fp32 parameters, bf16
     activations), depth cut from 24 + 24 to 8 encoder + 8 decoder layers
     with cross-attention (894,943,232 parameters, 3.33 GiB), on 1,024
     seeded frame features of width 1,024 (times 0.02, as
     ``tests/test_archs.py:21``), the encoder timed apart (its memory is
     computed once and given to every decode step; ``prefill`` encodes
     again). 15b: internvl2-26b at full width (d_model 6144, GQA 48/8, d_ff
     16384, vocab 92,553), depth cut from 48 to 16 layers (7,398,279,168
     bf16 parameters, 13.78 GiB), with 256 seeded patch features of width
     3,200 before each 24-token prompt (the cache holds 256 more
     positions). Full depth fit the card; the cuts pay for phase 16. Each:
     serve_lm's defaults as 14a, held against ``forward`` the same way, 4
     decode steps profiled. 15c: each cut to 2 layers (seamless: 2 encoder
     layers too) in float32, card against CPU: forward logits within
     LM_FP32_ATOL, 8 greedy tokens equal. Phases 14-15 print prefill,
     decode (and encoder) times, tokens/s and peak memory beside their
     ``lm_work`` bounds (mLSTM: the state read and written a step, the
     parallel and chunkwise forms' operations; sLSTM: ``r`` read once per
     step of its loop; the encoder over its frames; cross-attention: the
     memory read and projected to keys and values in every layer at every
     call; the adapter), and the idle share.
 16. LM training (``repro_torch.training``, ``repro_torch.launch.train``;
     no kernel: the reference's gradients are ``jax.value_and_grad`` over
     ``jnp`` code), TF32 off, after phase 15's models are freed. 16a:
     olmo-1b at full width and depth (1,176,764,416 fp32 parameters, bf16
     activations) from ``make_train_state(cfg, seed=0)``, 6 steps of
     ``make_train_step(cfg, peak_lr=1e-3, warmup=2, total=6)`` on batches
     0-5 of ``SyntheticTokens(50304, 4096, 4)`` (train_4k's length at batch
     4; every block recomputed in the backward): every loss and grad_norm
     finite, lr equal to ``lr_schedule`` at each step, batch 0's loss after
     the steps below step 1's; steps 3-6 timed (each ends in a
     synchronize), step 2 profiled; the step time and tokens/s beside the
     ``train_work`` bound (the forward's operations 3 times: forward and
     backward; AdamW's 28 bytes a parameter) and remat's recompute (the
     blocks' forward once more) printed apart from it, peak memory
     beside parameters, gradients and moments (18.83 GB). 16b:
     ``tests/test_training.py``'s restart on the card through
     ``launch.train.train`` (6 steps straight against 3, a checkpoint under
     ``build/``, 3 resumed): losses and every parameter and moment within
     1e-6, bit-equality printed. 16c: olmo-1b cut to 2 layers in float32
     (237,240,320 parameters), drawn on the CPU and carried to the card,
     one step on each (warm-up 0, so the step moves the parameters): loss
     and grad_norm within 1e-5 relative, the moments within the CPU tests'
     1e-5 of each leaf's largest value (v, a square, 2e-5), each leaf's
     change within 2e-3 relative to the CPU's and every element within
     2 lr. 16d: the 10 LM archs' smoke configs, drawn on the CPU and
     carried, 5 steps on one batch on each: losses within 1e-5 relative
     and falling, ``moe_dropped`` equal, DeepSeek's ``mtp_loss`` within
     1e-5; then ``compressed_psum`` on an NCCL world of one, each mean
     within one quantum of the gradient.
 17. The graph examples, the lint and the ``ops`` rig, after phase 16's
     models are freed. 17a: ``examples/torch_quickstart.py``,
     ``torch_sssp_road.py``, ``torch_pagerank_powerlaw.py`` and
     ``torch_streaming_updates.py`` on the card (each makes its own
     asserts), each against the same example run with ``--device cpu``
     here: every count equal (supersteps, messages, components, slots,
     flushes, runner builds, uploads), SSSP distances and CC labels
     bit-identical, PageRank ranks within 1e-5 of their largest value.
     17b: ``tools/drone_lint_torch.py src/repro_torch`` exits 0 and strict
     DL005 (``--no-baseline --select DL005 src/repro_torch/kernels``)
     reports nothing. 17c: ``benchmarks/kernel_roofline.py``'s large shape,
     the busiest cdbh partition of ``kronecker_graph(16, seed=3,
     weighted=True)`` at P = 16, with both launch counters reset first:
     ``ops.spmv`` through ``build_tiles`` (plus_times, min_plus) and
     ``window_align_edges`` (sum, min) on the card, each kernel launched,
     each result against the same call on the CPU; then each kernel on
     those layouts against its plain version (min exact, sums within 1e-5
     of the sum over |terms|), timed beside its bound, the plain version
     and a library call.

A small-graph check holds the three programs against independent numpy
oracles on all three backends. The kernel JSON line gives each kernel's
launches per phase (``launches`` = phases 3-4, ``launches_streaming`` =
phase 6, ``launches_algos`` = phase 7, ``launches_auto`` = phase 8's
``'auto'`` runs: its ``'auto'`` queries and the forced mix, without the
uniform queries it compares them with; ``launches_serving`` = phase 9's
serving calls; ``launches_shard`` = phase 10b's queries over every rank
and phase 10c's sharded sessions, ``launches_ops`` = phase 17c's
``ops.spmv`` calls), its K = 16 rows (``k16``) and its phase 17c rows
(``ops17``). The line before it gives each phase's seconds
(``phase_seconds``; phase 10 is 10a and 10b-c together). The line
before the last is the card's name and power limit from ``nvidia-smi``;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM float32 rate outside tensor cores
PR_RTOL = 1e-5                # PageRank: max |a - b| <= PR_RTOL * max |b|
DEVICE = "cuda"
GRID_SIDE = 1024              # the tiles path's grid graph (1,048,576 vertices)
SUM_RTOL = 1e-5               # float sums: |got - want| <= SUM_RTOL * sum |terms|
STREAM_BUFFER_EDGES = 1 << 22  # kron-20 session's buffer bound: above a batch


class Smoke:
    def __init__(self):
        self.failures = []
        self.facts = {}               # what a later phase compares with
        self.t0 = time.perf_counter()

    def check(self, ok: bool, what: str) -> bool:
        status = "ok" if ok else "FAIL"
        print(f"[{time.perf_counter() - self.t0:7.1f}s] {status}: {what}",
              flush=True)
        if not ok:
            self.failures.append(what)
        return ok

    def note(self, what: str) -> None:
        print(f"[{time.perf_counter() - self.t0:7.1f}s] {what}", flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def time_ms(fn, target_s: float = 0.25, max_iters: int = 50) -> float:
    """Mean milliseconds of ``fn`` on the card, timed with CUDA events after
    a warm-up, over enough launches to fill about ``target_s``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t, 1e-6)
    iters = int(min(max_iters, max(3, target_s / one)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, magnitude=None):
    """(ok, max_abs_err) of two tensors on the card. With no ``magnitude``
    the two must be equal; otherwise each element may differ by
    ``SUM_RTOL`` times its ``magnitude``, the same sum taken over the
    absolute values of its terms, so that a zeroed or partial row fails
    however small its values are."""
    import torch
    got, want = got.float(), want.float()
    both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
    diff = torch.where(both_inf, torch.zeros_like(got), (got - want).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    if magnitude is None:
        return bool(torch.equal(got, want)), err
    return bool((diff <= SUM_RTOL * magnitude.float()).all()), err


def spmv_magnitude(tiles, td, ts, vals, ndt, semiring):
    """Per-output scale of a plus_times product (None for min_plus)."""
    from repro_torch.kernels.bsp_spmv import bsp_spmv_plain
    if semiring != "plus_times":
        return None
    return bsp_spmv_plain(tiles.abs(), td, ts, vals.abs(), n_dst_tiles=ndt,
                          semiring=semiring)


def segment_magnitude(msgs, ldst, bwin, nw, combiner):
    """Per-output scale of a windowed sum (None for min/max)."""
    from repro_torch.kernels.segment_combine import segment_combine_plain
    if combiner != "sum":
        return None
    return segment_combine_plain(msgs.abs(), ldst, bwin, n_windows=nw,
                                 combiner=combiner)


# --------------------------------------------------------------------------- #
# phase 2: kernel against plain version on the test case grid
# --------------------------------------------------------------------------- #
def kernel_case_grid(sm: Smoke, errs: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.ops import WindowLayout
    from repro_torch.kernels.ref import combine_identity, tile_pad_identity

    dev = torch.device(DEVICE)

    def rand_tiles(rng, T, ndt, nst, semiring, dtype):
        ident = tile_pad_identity(semiring, dtype)
        tiles = np.full((T, 128, 128), ident, dtype)
        mask = rng.random((T, 128, 128)) < 0.3
        if np.dtype(dtype) == np.int32:
            tiles[mask] = rng.integers(0, 50, size=int(mask.sum()))
        else:
            tiles[mask] = rng.uniform(0.1, 5.0, size=int(mask.sum()))
        td = np.sort(rng.integers(0, ndt, size=T).astype(np.int32))
        td[:ndt] = np.arange(ndt)
        td = np.sort(td)
        ts = rng.integers(0, nst, size=T).astype(np.int32)
        return tiles, td, ts

    cases = [(4, 2, 2, 1), (9, 3, 2, 4), (16, 4, 4, 8), (5, 5, 1, 128)]
    for semiring, dtype in (("plus_times", np.float32),
                            ("min_plus", np.float32),
                            ("min_plus", np.int32)):
        for T, ndt, nst, K in cases:
            rng = np.random.default_rng(T * 100 + K)
            tiles, td, ts = rand_tiles(rng, T, ndt, nst, semiring, dtype)
            if np.dtype(dtype) == np.int32:
                vals = rng.integers(0, 1000, size=(nst, 128, K)).astype(dtype)
            else:
                vals = rng.uniform(0, 3, size=(nst, 128, K)).astype(dtype)
            args = [torch.from_numpy(a).to(dev) for a in (tiles, td, ts, vals)]
            check_spmv(sm, errs, args, ndt, semiring,
                       f"T={T} K={K}")

    seg_cases = [(100, 64, 1, 128), (1000, 300, 4, 256), (3000, 500, 8, 512),
                 (50, 400, 1, 128)]
    for combiner, dtype in (("sum", np.float32), ("min", np.float32),
                            ("max", np.float32), ("min", np.int32),
                            ("max", np.int32)):
        for E, n_rows, K, Be in seg_cases:
            rng = np.random.default_rng(E + K)
            dst = np.sort(rng.integers(0, n_rows, size=E).astype(np.int64))
            if np.dtype(dtype) == np.int32:
                msgs = rng.integers(-50, 50, size=(E, K)).astype(dtype)
            else:
                msgs = rng.uniform(-2, 2, size=(E, K)).astype(dtype)
            lay = WindowLayout(dst, n_rows, block_edges=Be)
            buf = np.full((lay.n_blocks * Be, K),
                          combine_identity(combiner, dtype), dtype)
            buf[lay.edge_slot] = msgs[lay.order]
            args = [torch.from_numpy(a).to(dev)
                    for a in (buf, lay.local_dst, lay.block_window)]
            check_segment(sm, errs, args, lay.n_windows, combiner,
                          f"E={E} K={K} Be={Be}")
    heavy_case_grid(sm, errs)


def check_spmv(sm: Smoke, errs: dict, args, ndt: int, semiring: str,
               what: str) -> None:
    """bsp_spmv against its plain version on the card; a plus_times sum
    must also give the same bits on a second launch."""
    import torch
    from repro_torch.kernels import bsp_spmv as bk
    got = bk.bsp_spmv(*args, n_dst_tiles=ndt, semiring=semiring)
    want = bk.bsp_spmv_plain(*args, n_dst_tiles=ndt, semiring=semiring)
    again = bk.bsp_spmv(*args, n_dst_tiles=ndt, semiring=semiring)
    torch.cuda.synchronize()
    ok, err = compare(got, want, spmv_magnitude(*args, ndt, semiring))
    errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
    dt = str(args[0].dtype).replace("torch.", "")
    sm.check(ok, f"bsp_spmv {semiring} {dt} {what} vs plain (max err "
                 f"{err:.3g})")
    if semiring == "plus_times":
        sm.check(torch.equal(got, again), f"bsp_spmv {semiring} {dt} "
                                          f"{what}: two launches, same bits")


def check_segment(sm: Smoke, errs: dict, args, nw: int, combiner: str,
                  what: str) -> None:
    """segment_combine against its plain version on the card; a sum must
    also give the same bits on a second launch."""
    import torch
    from repro_torch.kernels import segment_combine as sk
    got = sk.segment_combine_windowed(*args, n_windows=nw, combiner=combiner)
    want = sk.segment_combine_plain(*args, n_windows=nw, combiner=combiner)
    again = sk.segment_combine_windowed(*args, n_windows=nw,
                                        combiner=combiner)
    torch.cuda.synchronize()
    ok, err = compare(got, want, segment_magnitude(*args, nw, combiner))
    errs["segment_combine"] = max(errs["segment_combine"], err)
    dt = str(args[0].dtype).replace("torch.", "")
    sm.check(ok, f"segment_combine {combiner} {dt} {what} vs plain (max err "
                 f"{err:.3g})")
    if combiner == "sum":
        sm.check(torch.equal(got, again), f"segment_combine {combiner} {dt} "
                                          f"{what}: two launches, same bits")


def heavy_case_grid(sm: Smoke, errs: dict) -> None:
    """Rows far longer than a chunk: a window of 2,100 blocks, the JAX
    layout's 2,000 identity padding blocks on the last window, windows of a
    few edges whose block ends in identity slots with ldst 0, rows in random
    order inside each block; a dst row of 1,100 tiles."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import WindowLayout
    from repro_torch.kernels.ref import combine_identity, tile_pad_identity

    dev = torch.device(DEVICE)
    Be = 128
    for combiner, dtype in (("sum", np.float32), ("min", np.float32),
                            ("max", np.float32), ("min", np.int32),
                            ("max", np.int32)):
        ident = combine_identity(combiner, dtype)
        for kind in ("heavy", "padded", "tail", "unsorted"):
            rng = np.random.default_rng(11)
            if kind == "heavy":
                dst = np.sort(np.concatenate([
                    rng.integers(0, 128, 2100 * Be - 7),
                    rng.integers(128, 600, 900)]))
            elif kind == "tail":
                dst = np.sort(rng.choice([0, 3, 130, 131, 300], size=23))
            else:
                dst = np.sort(rng.integers(0, 700, size=20_000))
            lay = WindowLayout(dst, 700, block_edges=Be)
            K = 3 if kind == "unsorted" else 1
            if np.dtype(dtype) == np.int32:
                msgs = rng.integers(-50, 50, size=(dst.shape[0], K))
            else:
                msgs = rng.uniform(-2, 2, size=(dst.shape[0], K))
            buf = np.full((lay.n_blocks * Be, K), ident, dtype)
            buf[lay.edge_slot] = msgs[lay.order].astype(dtype)
            ldst, bwin = lay.local_dst, lay.block_window
            if kind == "padded":
                buf = np.concatenate([buf, np.full((2000 * Be, K), ident,
                                                   dtype)])
                ldst = np.concatenate([ldst, np.zeros(2000 * Be, np.int32)])
                bwin = np.concatenate([bwin, np.full(
                    2000, lay.n_windows - 1, np.int32)])
            if kind == "unsorted":
                ldst = ldst.reshape(-1, Be).copy()
                for row in ldst:
                    rng.shuffle(row)
                ldst = ldst.reshape(-1)
            args = [torch.from_numpy(a).to(dev) for a in (buf, ldst, bwin)]
            check_segment(sm, errs, args, lay.n_windows, combiner,
                          f"{kind} ({bwin.shape[0]} blocks, longest window "
                          f"{int(np.bincount(bwin).max())}) K={K}")

    for semiring, dtype in (("plus_times", np.float32),
                            ("min_plus", np.float32),
                            ("min_plus", np.int32)):
        for K in (1, 5):
            rng = np.random.default_rng(K)
            T, ndt, nst = 1104, 3, 6
            tiles = np.full((T, 128, 128), tile_pad_identity(semiring, dtype),
                            dtype)
            live = rng.random(tiles.shape) < 0.01
            tiles[live] = rng.integers(0, 50, size=int(live.sum()))
            td = np.array([0, 0, 1] + [2] * (T - 3), np.int32)
            ts = rng.integers(0, nst, size=T).astype(np.int32)
            if np.dtype(dtype) == np.int32:
                vals = rng.integers(0, 1000, size=(nst, 128, K))
            else:
                vals = rng.uniform(0, 3, size=(nst, 128, K))
            args = [torch.from_numpy(a).to(dev)
                    for a in (tiles, td, ts, vals.astype(dtype))]
            check_spmv(sm, errs, args, ndt, semiring,
                       f"heavy row ({T - 3} tiles) K={K}")


# --------------------------------------------------------------------------- #
# small-graph oracles (independent numpy/scipy implementations)
# --------------------------------------------------------------------------- #
def oracle_sssp(g, source):
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    m = csr_matrix((g.weights.astype(np.float64), (g.src, g.dst)),
                   shape=(g.n_vertices, g.n_vertices))
    return dijkstra(m, directed=True, indices=source)


def oracle_cc(g):
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    m = csr_matrix((np.ones(g.n_edges), (g.src, g.dst)),
                   shape=(g.n_vertices, g.n_vertices))
    _, comp = connected_components(m, directed=False)
    low = np.full(comp.max() + 1, g.n_vertices, np.int64)
    np.minimum.at(low, comp, np.arange(g.n_vertices))
    return low[comp]


def oracle_pagerank(g, alpha=0.85, iters=200):
    import numpy as np
    n = g.n_vertices
    out_deg = np.bincount(g.src, minlength=n).astype(np.float64)
    x = np.full(n, (1 - alpha) / n)
    r = x.copy()
    for _ in range(iters):
        push = alpha * x / np.maximum(out_deg, 1)
        y = np.zeros(n)
        np.add.at(y, g.dst, push[g.src])
        x = r + y
    return x


def small_graph_check(sm: Smoke) -> None:
    import numpy as np
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core import EngineConfig
    from repro_torch.graphgen import kronecker_graph
    from repro_torch.session import GraphSession

    g = kronecker_graph(10, seed=3, weighted=True)
    sess = GraphSession.from_graph(g, 8, "cdbh", device=DEVICE)
    src = int(np.argmax(g.out_degrees()))
    want_d = oracle_sssp(g, src)
    want_c = oracle_cc(g)
    want_p = oracle_pagerank(g)
    for eb in ("coo", "pallas_tiles", "pallas_windows"):
        cfg = EngineConfig(edge_backend=eb)
        d, _ = sess.query(SSSP(), {"source": src}, warm=False, cfg=cfg)
        d = sess.pg.collect(d, fill=np.float32(np.inf)).astype(np.float64)
        fin = np.isfinite(want_d)
        sm.check(bool(np.array_equal(np.isfinite(d), fin)
                      and np.allclose(d[fin], want_d[fin], rtol=1e-5)),
                 f"small graph SSSP on {eb} agrees with Dijkstra")
        c, _ = sess.query(ConnectedComponents(), warm=False, cfg=cfg)
        c = sess.pg.collect(c, fill=-1)
        sm.check(bool(np.array_equal(c, want_c)),
                 f"small graph CC on {eb} agrees with scipy components")
        # a tight significance threshold, so that the mass the program
        # leaves unpushed below it stays far under the check's tolerance
        p, _ = sess.query(PageRank(tol=1e-10), {"n_vertices": g.n_vertices},
                          cfg=cfg)
        p = sess.pg.collect(p).astype(np.float64)
        err = float(np.abs(p - want_p).sum() / want_p.sum())
        sm.check(bool(np.isfinite(p).all() and err < 1e-4),
                 f"small graph PageRank on {eb} agrees with power iteration "
                 f"(L1 error {err:.3g} of the total rank)")


# --------------------------------------------------------------------------- #
# phases 3 and 4: the main path
# --------------------------------------------------------------------------- #
def run_queries(sm: Smoke, sess, label: str, kernel_eb: str, queries,
                log: list) -> dict:
    """Run every query on ``kernel_eb`` and on ``coo``; hold each kernel
    result against its COO twin. Returns the kernel-backend results."""
    import numpy as np
    from repro_torch.core import EngineConfig
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    def launches():
        return bk.bsp_spmv.launches + sk.segment_combine_windowed.launches

    results, counts = {}, {}
    for eb in (kernel_eb, "coo"):
        cfg = EngineConfig(edge_backend=eb)
        for name, prog, params, warm in queries:
            before = launches()
            res, st = sess.query(prog, params, warm=warm, cfg=cfg)
            results[(eb, name)] = res
            counts[(eb, name)] = (st.supersteps, st.host_syncs)
            rec = dict(graph=label, query=name, edge_backend=eb,
                       wall_s=round(st.wall_time, 4),
                       build_s=round(st.compile_time, 6),
                       supersteps=st.supersteps,
                       messages=st.total_messages, host_syncs=st.host_syncs,
                       processed_edges=st.processed_edges,
                       kernel_launches=launches() - before)
            log.append(rec)
            print("query " + json.dumps(rec), flush=True)
    for name, prog, _, _ in queries:
        got, want = results[(kernel_eb, name)], results[("coo", name)]
        finite = np.isfinite(got.astype(np.float64)).any()
        if prog.delta_based:
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            ok = err <= PR_RTOL * scale and np.isfinite(got).all()
            sm.check(ok, f"{label} {name}: {kernel_eb} == coo within "
                         f"{PR_RTOL:g} of max |rank| (max err {err:.3g}, "
                         f"max rank {scale:.3g})")
        else:
            sm.check(bool(np.array_equal(got, want) and finite),
                     f"{label} {name}: {kernel_eb} bit-identical to coo "
                     f"{got.shape} {got.dtype}")
            sm.check(counts[(kernel_eb, name)] == counts[("coo", name)],
                     f"{label} {name}: {kernel_eb} supersteps and host "
                     f"syncs {counts[(kernel_eb, name)]} equal coo's")
    return results


def windows_path(sm: Smoke, log: list):
    import numpy as np
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.graphgen import kronecker_graph
    from repro_torch.session import GraphSession

    t = time.perf_counter()
    g = kronecker_graph(20, seed=7)
    sm.note(f"kron-20: {g.n_vertices} vertices, {g.n_edges} edges, "
            f"generated in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    sess = GraphSession.from_graph(g, 16, "cdbh", device=DEVICE,
                                   max_buffer_edges=STREAM_BUFFER_EDGES)
    lay = sess.pg.ensure_edge_layouts(shape_policy=sess.shape_policy)
    sm.note(f"kron-20 cdbh P=16: v_max={sess.pg.v_max} e_max={sess.pg.e_max}"
            f" b_max={lay.b_max}; built in {time.perf_counter() - t:.1f}s")
    from repro_torch.core import partition_metrics
    sm.facts["kron-20 cdbh"] = partition_metrics(sess.pg)
    sm.note(f"kron-20 cdbh P=16 partitioning: {sm.facts['kron-20 cdbh']}")
    deg = g.out_degrees()
    rng = np.random.default_rng(7)
    s0 = int(np.argmax(deg))
    s1 = int(rng.choice(np.nonzero(deg)[0]))
    queries = [("sssp_a", SSSP(), {"source": s0}, False),
               ("sssp_b", SSSP(), {"source": s1}, False),
               ("sssp_a_warm", SSSP(), {"source": s0}, True),
               ("cc", ConnectedComponents(), None, False),
               ("pagerank", PageRank(), {"n_vertices": g.n_vertices}, False)]
    res = run_queries(sm, sess, "kron-20", "pallas_windows", queries, log)
    return sess, res, g, s0


def tiles_path(sm: Smoke, log: list):
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.graphgen import grid_graph, kronecker_graph
    from repro_torch.session import GraphSession

    t = time.perf_counter()
    g = grid_graph(GRID_SIDE, weighted=True, seed=9)
    sess = GraphSession.from_graph(g, 16, "range", device=DEVICE)
    lay = sess.pg.ensure_edge_layouts(shape_policy=sess.shape_policy)
    sm.note(f"grid-{GRID_SIDE} range P=16: {g.n_vertices} vertices, {g.n_edges} "
            f"edges, v_max={sess.pg.v_max} t_max={lay.t_max} real tiles="
            f"{int(lay.n_tiles.sum())}; built in "
            f"{time.perf_counter() - t:.1f}s")
    queries = [("sssp", SSSP(), {"source": 0}, False),
               ("cc", ConnectedComponents(), None, False),
               ("pagerank", PageRank(), {"n_vertices": g.n_vertices}, False)]
    res = run_queries(sm, sess, f"grid-{GRID_SIDE}", "pallas_tiles", queries, log)

    gq = kronecker_graph(14, seed=7)
    sq = GraphSession.from_graph(gq, 16, "cdbh", device=DEVICE)
    qq = [("sssp", SSSP(), {"source": 0}, False),
          ("cc", ConnectedComponents(), None, False),
          ("pagerank", PageRank(), {"n_vertices": gq.n_vertices}, False)]
    run_queries(sm, sq, "kron-14", "pallas_tiles", qq, log)
    return sess, res, sq


# --------------------------------------------------------------------------- #
# phase 5: kernels at the main path's shapes
# --------------------------------------------------------------------------- #
def padded_window_inputs(sess, sgs, prog, vals):
    """The same messages in the JAX package's padded stacked layout: every
    partition padded to b_max blocks, its padding blocks on its last
    window (the input the engine fed the kernel before the layouts became
    compact). Returns ``(msgs, ldst, bwin, n_windows)``."""
    import numpy as np
    import torch
    from repro_torch.core.engine import _edge_messages
    from repro_torch.kernels.ref import combine_identity, numpy_dtype
    lay, spec, dev = sess.pg.edge_layouts, prog.sweep_spec, vals.device
    P, K = lay.n_parts, vals.shape[-1]
    n_buf = lay.ldst.shape[-1]
    offs = np.arange(P)[:, None]
    slot = np.where(lay.eslot >= 0, lay.eslot + offs * n_buf, P * n_buf)
    msgs = _edge_messages(sgs, spec, vals, sgs.esrc, sgs.ew)
    ident = combine_identity(spec.combiner, numpy_dtype(vals.dtype)).item()
    buf = torch.full((P * n_buf + 1, K), ident, dtype=vals.dtype, device=dev)
    buf.index_copy_(0, torch.from_numpy(slot.reshape(-1).astype(np.int64))
                    .to(dev), msgs.reshape(-1, K))
    bwin = (lay.bwin + offs * lay.n_windows).reshape(-1).astype(np.int32)
    return (buf[:-1], torch.from_numpy(lay.ldst.reshape(-1)).to(dev),
            torch.from_numpy(bwin).to(dev), P * lay.n_windows)


def padded_tile_inputs(sess, prog, dev):
    """The tile list in the JAX package's padded stacked layout: every
    partition padded to t_max identity tiles on its last dst row. Returns
    ``(tiles, tile_dst, tile_src)``."""
    import numpy as np
    import torch
    lay, spec = sess.pg.edge_layouts, prog.sweep_spec
    offs = np.arange(lay.n_parts)[:, None]
    tiles = lay.tile_values(sess.pg, spec.semiring, spec.edge_values,
                            prog.dtype)
    td = (lay.tile_dst + offs * lay.n_dst_tiles).reshape(-1)
    ts = (lay.tile_src + offs * lay.n_src_tiles).reshape(-1)
    return (torch.from_numpy(tiles.reshape(-1, 128, 128)).to(dev),
            torch.from_numpy(td.astype(np.int32)).to(dev),
            torch.from_numpy(ts.astype(np.int32)).to(dev))


def bsr_yardstick(tiles, td, ts, v, ndt):
    """One PyTorch call for the plus_times product: ``torch.sparse.mm`` of
    a block-sparse (BSR, 128x128 fp32 blocks) matrix and the values.
    Returns ``(fn, None)`` or ``(None, the error)`` if the card refuses."""
    import torch
    try:
        crow = torch.searchsorted(
            td, torch.arange(ndt + 1, dtype=torch.int32, device=td.device),
            out_int32=True)
        A = torch.sparse_bsr_tensor(crow, ts, tiles,
                                    size=(ndt * 128, v.shape[0] * 128))
        x = v.reshape(-1, v.shape[-1])

        def fn():
            return torch.sparse.mm(A, x)
        fn()
        torch.cuda.synchronize()
        return fn, None
    except Exception as e:      # the yardstick is optional: report why
        return None, f"{type(e).__name__}: {e}"


def main_path_kernels(sm: Smoke, errs: dict, win, tile) -> list:
    """Each kernel at the shapes the main path gave it: held against its
    plain version for all three programs, then timed for SSSP on the
    compact device lists the engine feeds it and on the padded JAX-layout
    input (the same work plus the padding), beside its bound and a library
    call."""
    import torch
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core.engine import (_layout_block_from, _tile_inputs,
                                         _window_inputs)
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    dev = torch.device(DEVICE)
    out = []
    programs = (("sssp", SSSP()), ("cc", ConnectedComponents()),
                ("pagerank", PageRank()))

    # windows kernel on kron-20
    sess, res = win[:2]
    sgs = sess.device_graph()
    lay = sess.pg.edge_layouts
    timing = None
    for name, prog in programs:
        key = ("pallas_windows", "sssp_a" if name == "sssp" else name)
        vals = torch.from_numpy(res[key]).to(dev)[..., None]
        blk = _layout_block_from(lay, sess.pg, prog, "pallas_windows", dev)
        msgs, ldst, bwin, nw, plan = _window_inputs(
            sgs, blk, vals, prog.sweep_spec, sgs.v_max)
        comb = prog.sweep_spec.combiner
        got = sk.segment_combine_windowed(msgs, ldst, bwin, n_windows=nw,
                                          combiner=comb, plan=plan)
        want = sk.segment_combine_plain(msgs, ldst, bwin, n_windows=nw,
                                        combiner=comb)
        torch.cuda.synchronize()
        ok, err = compare(got, want, segment_magnitude(
            msgs, ldst, bwin, nw, comb))
        errs["segment_combine"] = max(errs["segment_combine"], err)
        sm.check(ok, f"segment_combine {comb} {msgs.dtype} at kron-20 "
                     f"shape {tuple(msgs.shape)} vs plain (max err {err:.3g})")
        if name == "sssp":
            timing = (msgs, ldst, bwin, nw, comb, plan, got)
            pad = padded_window_inputs(sess, sgs, prog, vals)
    msgs, ldst, bwin, nw, comb, plan, got = timing
    pm, pl, pb, pnw = pad
    pplan = sk.plan_windows(pb, pnw)
    got_p = sk.segment_combine_windowed(pm, pl, pb, n_windows=pnw,
                                        combiner=comb, plan=pplan)
    want_p = sk.segment_combine_plain(pm, pl, pb, n_windows=pnw,
                                      combiner=comb)
    torch.cuda.synchronize()
    sm.check(torch.equal(got_p, want_p) and torch.equal(got_p, got),
             f"segment_combine on the padded kron-20 input {tuple(pm.shape)}"
             f" (longest window {int(torch.bincount(pb).max())} blocks) "
             f"equals its plain version and the compact result")
    Be = lay.block_edges
    K = msgs.shape[1]
    real_edges = int(lay.n_blocks.sum()) * Be
    nbytes = real_edges * (K + 1) * 4 + int(lay.n_blocks.sum()) * 4 \
        + nw * 128 * K * 4
    ops = real_edges * K
    row = (bwin.long().repeat_interleave(Be) * 128 + ldst.long())[:, None]
    row = row.expand(-1, K).contiguous()
    lib_out = torch.full((nw * 128, K), float("inf"), device=dev)
    rec = dict(
        name="segment_combine_windowed", route="cuda",
        source="src/repro_torch/csrc/segment_combine.cu",
        replaces="src/repro/kernels/segment_combine.py:79",
        ms=time_ms(lambda: sk.segment_combine_windowed(
            msgs, ldst, bwin, n_windows=nw, combiner=comb, plan=plan)),
        padded_ms=time_ms(lambda: sk.segment_combine_windowed(
            pm, pl, pb, n_windows=pnw, combiner=comb, plan=pplan)),
        plain_ms=time_ms(lambda: sk.segment_combine_plain(
            msgs, ldst, bwin, n_windows=nw, combiner=comb)),
        library_ms=time_ms(lambda: lib_out.scatter_reduce_(
            0, row, msgs, "amin", include_self=True)),
        bytes=nbytes, ops=ops, shape=f"msgs {tuple(msgs.shape)} f32 min, "
        f"{nw} windows, {plan.n_chunks} chunks (kron-20 SSSP); padded "
        f"input {tuple(pm.shape)}")
    out.append(rec)
    del pad, pm, pl, pb, got_p, want_p, row, lib_out

    # tile kernel on the grid graph
    sess, res = tile[:2]
    lay = sess.pg.edge_layouts
    timing = pr = None
    for name, prog in programs:
        vals = torch.from_numpy(res[("pallas_tiles", name)]).to(dev)[..., None]
        blk = _layout_block_from(lay, sess.pg, prog, "pallas_tiles", dev)
        tiles, td, ts, v, ndt, plan = _tile_inputs(
            blk, vals, prog.sweep_spec, sess.pg.v_max)
        semi = prog.sweep_spec.semiring
        got = bk.bsp_spmv(tiles, td, ts, v, n_dst_tiles=ndt, semiring=semi,
                          plan=plan)
        want = bk.bsp_spmv_plain(tiles, td, ts, v, n_dst_tiles=ndt,
                                 semiring=semi)
        torch.cuda.synchronize()
        ok, err = compare(got, want, spmv_magnitude(
            tiles, td, ts, v, ndt, semi))
        errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
        sm.check(ok, f"bsp_spmv {semi} {v.dtype} at grid shape "
                     f"T={tiles.shape[0]} vs plain (max err {err:.3g})")
        if name == "sssp":
            timing = (tiles, td, ts, v, ndt, semi, plan, got, prog)
        if name == "pagerank":
            pr = (tiles, td, ts, v, ndt, semi, plan, got)
    tiles, td, ts, v, ndt, semi, plan, got, prog = timing
    ptiles, ptd, pts = padded_tile_inputs(sess, prog, dev)
    pplan = bk.plan_tiles(ptd, ndt)
    got_p = bk.bsp_spmv(ptiles, ptd, pts, v, n_dst_tiles=ndt, semiring=semi,
                        plan=pplan)
    want_p = bk.bsp_spmv_plain(ptiles, ptd, pts, v, n_dst_tiles=ndt,
                               semiring=semi)
    torch.cuda.synchronize()
    sm.check(torch.equal(got_p, want_p) and torch.equal(got_p, got),
             f"bsp_spmv on the padded grid input ({ptiles.shape[0]} tiles, "
             f"longest dst row {int(torch.bincount(ptd).max())} tiles) "
             f"equals its plain version and the compact result")
    padded_ms = time_ms(lambda: bk.bsp_spmv(
        ptiles, ptd, pts, v, n_dst_tiles=ndt, semiring=semi, plan=pplan))
    del ptiles, ptd, pts, got_p, want_p
    T_real = int(lay.n_tiles.sum())
    K = v.shape[-1]
    nbytes = T_real * 128 * 128 * 4 + 2 * T_real * 4 + v.numel() * 4 \
        + ndt * 128 * K * 4
    ops = 2 * T_real * 128 * 128 * K

    # plus_times (grid PageRank) beside one PyTorch call
    t2, td2, ts2, v2, ndt2, semi2, plan2, got2 = pr
    pt_ms = time_ms(lambda: bk.bsp_spmv(t2, td2, ts2, v2, n_dst_tiles=ndt2,
                                        semiring=semi2, plan=plan2))
    pt_plain_ms = time_ms(lambda: bk.bsp_spmv_plain(
        t2, td2, ts2, v2, n_dst_tiles=ndt2, semiring=semi2), max_iters=5)
    lib_fn, lib_err = bsr_yardstick(t2, td2, ts2, v2, ndt2)
    pt_lib_ms = None
    if lib_fn is not None:
        y = lib_fn().reshape(got2.shape)
        torch.cuda.synchronize()
        ok, err = compare(got2, y, spmv_magnitude(t2, td2, ts2, v2, ndt2,
                                                  semi2))
        sm.note(f"torch.sparse.mm (BSR) agrees with bsp_spmv plus_times: "
                f"{ok} (max err {err:.3g})")
        pt_lib_ms = time_ms(lib_fn)
    else:
        sm.note(f"torch.sparse.mm (BSR) refused on the card: {lib_err}")
    rec = dict(
        name="bsp_spmv", route="cuda",
        source="src/repro_torch/csrc/bsp_spmv.cu",
        replaces="src/repro/kernels/bsp_spmv.py:82",
        ms=time_ms(lambda: bk.bsp_spmv(tiles, td, ts, v, n_dst_tiles=ndt,
                                       semiring=semi, plan=plan)),
        padded_ms=padded_ms,
        plain_ms=time_ms(lambda: bk.bsp_spmv_plain(
            tiles, td, ts, v, n_dst_tiles=ndt, semiring=semi), max_iters=5),
        library_ms=None, plus_times_ms=pt_ms,
        plus_times_plain_ms=pt_plain_ms,
        plus_times_library_ms=pt_lib_ms, plus_times_library_error=lib_err,
        bytes=nbytes, ops=ops,
        shape=f"tiles [{tiles.shape[0]}, 128, 128] f32 min_plus, K={K}, "
        f"{plan.n_chunks} chunks (grid SSSP); padded input "
        f"{lay.n_parts * lay.t_max} tiles; plus_times at the grid PageRank "
        f"shape")
    out.append(rec)
    return out



# --------------------------------------------------------------------------- #
# phase 6: the streaming lifecycle
# --------------------------------------------------------------------------- #
class CallTimer:
    """Host seconds spent inside the wrapped entry points (``targets``:
    ``(owner, attribute)`` pairs) while the timer is open."""

    def __init__(self, targets):
        self.seconds = 0.0
        self._orig = [(owner, name, getattr(owner, name))
                      for owner, name in targets]
        for owner, name, fn in self._orig:
            setattr(owner, name, self._timed(fn))

    def _timed(self, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t
        return run

    def take(self) -> float:
        s, self.seconds = self.seconds, 0.0
        return s

    def close(self) -> None:
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def layout_timer() -> CallTimer:
    """Host seconds the edge layouts' refresh takes: the incremental
    rebuild, the column growth and a full rebuild."""
    from repro_torch.core import layouts as L
    return CallTimer(((L.EdgeLayouts, "rebuild_partitions"),
                      (L.EdgeLayouts, "sync_capacity"),
                      (L, "build_edge_layouts")))


def oracle_sssp_edges(n, src, dst, w, source):
    """Dijkstra over an edge list whose parallel copies keep the lightest
    weight (the session relaxes every resident copy)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    key = src.astype(np.int64) * n + dst
    order = np.argsort(key, kind="stable")
    key, w = key[order], w[order].astype(np.float64)
    first = np.concatenate([[True], key[1:] != key[:-1]])
    starts = np.nonzero(first)[0]
    wmin = np.minimum.reduceat(w, starts)
    k = key[starts]
    m = csr_matrix((wmin, (k // n, k % n)), shape=(n, n))
    return dijkstra(m, directed=True, indices=source)


def sym_batch(rng, n_pairs, n, new_ids=()):
    """``n_pairs`` distinct unordered pairs u != v of ids below ``n``, plus
    one pair from each of ``new_ids`` to a random id below ``n``; both
    directions, weights uniform in [5, 10)."""
    import numpy as np
    u = rng.integers(0, n, 2 * n_pairs)
    v = rng.integers(0, n, 2 * n_pairs)
    keep = u != v
    u, v = u[keep], v[keep]
    _, idx = np.unique(np.minimum(u, v) * n + np.maximum(u, v),
                       return_index=True)
    idx = np.sort(idx)[:n_pairs]
    new_ids = np.asarray(new_ids, np.int64)
    u = np.concatenate([u[idx], new_ids])
    v = np.concatenate([v[idx], rng.integers(0, n, new_ids.shape[0])])
    w = rng.uniform(5.0, 10.0, u.shape[0]).astype(np.float32)
    return (np.concatenate([u, v]), np.concatenate([v, u]),
            np.concatenate([w, w]))


def streaming_path(sm: Smoke, log: list, win, tile, ident: str) -> dict:
    """Phase 6 (see the module docstring). Returns the state the kernel
    checks after it need and the per-step records."""
    import numpy as np
    import torch
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core import EngineConfig

    sess, _, g, s0 = win
    sq = tile[2]
    timer = layout_timer()
    steps = []
    rng = np.random.default_rng(13)
    win_cfg = EngineConfig(edge_backend="pallas_windows")
    coo_cfg = EngineConfig(edge_backend="coo")
    # the mutated kron-20 edge list, kept on the host for the oracle
    es, ed, ew = [g.src], [g.dst], [g.weights]

    def refresh(label, s, mutate):
        """Mutate (then flush) ``s``; time the host work and the re-upload
        of the device graph and of the kernels' device list."""
        t = time.perf_counter()
        st = mutate()
        host = time.perf_counter() - t
        layout = timer.take()
        t = time.perf_counter()
        s.device_graph()
        torch.cuda.synchronize()
        upload = time.perf_counter() - t
        eb = "pallas_windows" if s is sess else "pallas_tiles"
        t = time.perf_counter()
        s._layout_arg(SSSP(), eb, s.cfg)
        torch.cuda.synchronize()
        dev_list = time.perf_counter() - t
        rec = dict(graph="kron-20" if s is sess else "kron-14", step=label,
                   host_s=host - layout, layout_refresh_s=layout,
                   graph_upload_s=upload, device_list_s=dev_list,
                   shape_key=list(s.shape_key), n_edges=s.pg.n_edges,
                   n_vertices=s.pg.n_vertices, gpu=ident)
        steps.append(rec)
        sm.note(f"stream {rec['graph']} {label}: host {rec['host_s']:.3f}s "
                f"(mutation + flush), layout refresh {layout:.3f}s, graph "
                f"upload {upload:.3f}s, {eb} device list {dev_list:.3f}s; "
                f"shape key {s.shape_key} [{ident}]")
        return st, rec

    def q(s, prog, params, warm, cfg, rec, name):
        res, st = s.query(prog, params, warm=warm, cfg=cfg)
        rec.setdefault("queries", []).append(dict(
            query=name, edge_backend=st.edge_backend, wall_s=st.wall_time,
            supersteps=st.supersteps, messages=st.total_messages))
        return res, st

    def sssp_three_ways(rec, label, oracle):
        wres, wst = q(sess, SSSP(), {"source": s0}, "auto", win_cfg, rec,
                      "sssp_warm")
        cres, cst = q(sess, SSSP(), {"source": s0}, False, win_cfg, rec,
                      "sssp_cold")
        ores, _ = q(sess, SSSP(), {"source": s0}, False, coo_cfg, rec,
                    "sssp_coo")
        sm.check(bool(np.array_equal(wres, cres)),
                 f"kron-20 {label}: SSSP warm-auto bit-identical to cold")
        sm.check(wst.supersteps < cst.supersteps,
                 f"kron-20 {label}: warm took {wst.supersteps} supersteps, "
                 f"cold {cst.supersteps}")
        sm.check(bool(np.array_equal(cres, ores)),
                 f"kron-20 {label}: SSSP on pallas_windows bit-identical to "
                 f"coo")
        if oracle:
            t = time.perf_counter()
            want = oracle_sssp_edges(sess.pg.n_vertices, np.concatenate(es),
                                     np.concatenate(ed), np.concatenate(ew),
                                     s0)
            d = sess.pg.collect(cres, fill=np.float32(np.inf)).astype(
                np.float64)
            fin = np.isfinite(want)
            sm.check(bool(np.array_equal(np.isfinite(d), fin) and np.allclose(
                d[fin], want[fin], rtol=1e-5)),
                f"kron-20 {label}: SSSP agrees with scipy Dijkstra on the "
                f"mutated edge list (rtol 1e-5; {int(fin.sum())} reachable; "
                f"oracle {time.perf_counter() - t:.1f}s)")
        return cres

    # ---- kron-20 (windows) ---------------------------------------------- #
    n0, E0 = g.n_vertices, g.n_edges
    cap0 = sess.slot_capacity
    for label, new in (("insert 1", ()),
                       ("insert 2 (+1024 ids)", np.arange(n0, n0 + 1024))):
        src, dst, w = sym_batch(rng, E0 // 400, n0, new)
        es.append(src)
        ed.append(dst)
        ew.append(w)

        def mutate(src=src, dst=dst, w=w):
            sess.update(adds=(src, dst, w))
            return sess.flush()
        st, rec = refresh(label, sess, mutate)
        sm.check(st.n_added == src.shape[0] and st.warm_start_safe
                 and sess.pg.n_vertices == n0 + len(new),
                 f"kron-20 {label}: {st.n_added} edges added in one flush, "
                 f"{sess.pg.n_vertices} vertices")
        sssp_three_ways(rec, label, oracle=True)
    sm.check(sess.slot_capacity > cap0,
             f"kron-20 inserts moved the slot capacity {cap0} -> "
             f"{sess.slot_capacity} (the layouts' column growth)")

    src_all, dst_all = np.concatenate(es), np.concatenate(ed)
    pick = rng.random(src_all.shape[0]) < 0.05

    def delete():
        sess.update(deletes=(src_all[pick], dst_all[pick]))
        return sess.flush()
    st, rec = refresh("delete 5%", sess, delete)
    sm.check(st.n_deleted > 0 and not st.warm_start_safe
             and len(sess._warm) == 0,
             f"kron-20 delete: {st.n_deleted} resident edges removed, warm "
             f"results dropped")
    for name, prog, params in (
            ("cc", ConnectedComponents(), None),
            ("pagerank", PageRank(), {"n_vertices": sess.pg.n_vertices})):
        got, _ = q(sess, prog, params, False, win_cfg, rec, name)
        want, _ = q(sess, prog, params, False, coo_cfg, rec, name + "_coo")
        if prog.delta_based:
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            sm.check(err <= PR_RTOL * scale and bool(np.isfinite(got).all()),
                     f"kron-20 delete: PageRank windows == coo within "
                     f"{PR_RTOL:g} of max rank (max err {err:.3g})")
        else:
            sm.check(bool(np.array_equal(got, want)),
                     "kron-20 delete: CC windows bit-identical to coo")
    q(sess, SSSP(), {"source": s0}, False, win_cfg, rec, "sssp_seed")

    cs, rec = refresh("compact", sess, sess.compact)
    sm.check(cs.n_evicted >= 0 and cs.remap is not None,
             f"kron-20 compact: {cs.n_evicted} rows evicted, v_max "
             f"{cs.v_max_before} -> {cs.v_max_after}, e_max "
             f"{cs.e_max_before} -> {cs.e_max_after}")
    win_vals = sssp_three_ways(rec, "compact", oracle=False)

    # ---- kron-14 (tiles) ------------------------------------------------ #
    from repro_torch.stream import EdgeDelta

    def tiles_queries(label, rec):
        qs = [("sssp", SSSP(), {"source": 0}, False),
              ("cc", ConnectedComponents(), None, False),
              ("pagerank", PageRank(), {"n_vertices": sq.pg.n_vertices},
               False)]
        before = len(log)
        res = run_queries(sm, sq, f"kron-14 {label}", "pallas_tiles", qs,
                          log)
        rec["queries"] = log[before:]
        return res

    nq = sq.pg.n_vertices
    src, dst, w = sym_batch(rng, sq.pg.n_edges // 100, nq)

    def small_updates():
        for lo in range(0, src.shape[0], 200):
            sq.update(adds=(src[lo:lo + 200], dst[lo:lo + 200],
                            w[lo:lo + 200]))
        return sq.flush()
    auto0 = sq.buffer.stats.auto_flushes
    _, rec = refresh("small updates", sq, small_updates)
    sm.check(sq.buffer.stats.auto_flushes - auto0 > 0,
             f"kron-14: {src.shape[0]} edges through "
             f"{-(-src.shape[0] // 200)} update calls, "
             f"{sq.buffer.stats.auto_flushes - auto0} auto-flushes")
    tiles_queries("small updates", rec)

    # the fullest partition's own resident pairs once more (parallel
    # copies, weights in [5, 10)): just enough to move the e_max bucket
    # with the members, and so v_max and the tiles, unchanged
    key0, pg = sq.shape_key, sq.pg
    p = int(np.argmax(pg.edges_per_part))
    m = pg.emask[p]
    gs, gd = pg.gvid[p][pg.esrc[p][m]], pg.gvid[p][pg.edst[p][m]]
    _, first = np.unique(gs * nq + gd, return_index=True)
    n_big = pg.e_max - int(m.sum()) + 1
    pick = np.sort(first)[:n_big]
    big = EdgeDelta(add_src=gs[pick], add_dst=gd[pick],
                    add_w=rng.uniform(5, 10, pick.shape[0]).astype(
                        np.float32))

    def push_big():
        sq.push(big)
        return sq.flush()
    _, rec = refresh("e_max batch", sq, push_big)
    sm.note(f"kron-14 shape key {key0} -> {sq.shape_key}")
    sm.check(pick.shape[0] == n_big and sq.shape_key[2] > key0[2],
             f"kron-14: the batch of {n_big} edges into partition {p} moved "
             f"the e_max bucket ({key0[2]} -> {sq.shape_key[2]})")
    tiles_queries("e_max batch", rec)
    _, rec = refresh("compact", sq, sq.compact)
    tile_res = tiles_queries("compact", rec)

    # ---- checkpoint / resume (trace mode, kron-14 on tiles) ------------- #
    import shutil
    import tempfile
    from repro_torch.core import run_sim
    ckdir = tempfile.mkdtemp(prefix="bsp_ckpt_")
    try:
        for name, prog, params in (
                ("sssp", SSSP(), {"source": 0}),
                ("pagerank", PageRank(), {"n_vertices": sq.pg.n_vertices})):
            d = f"{ckdir}/{name}"
            cfg = EngineConfig(edge_backend="pallas_tiles", trace=True,
                               checkpoint_every=2, checkpoint_dir=d)
            full, fst = run_sim(prog, sq.pg, params, cfg, device=DEVICE)
            second = f"{d}/bsp_000004.npz"
            res, rst = run_sim(prog, sq.pg, params,
                               EngineConfig(edge_backend="pallas_tiles",
                                            trace=True),
                               resume_from=second, device=DEVICE)
            same = (np.allclose(res, full, rtol=PR_RTOL, atol=PR_RTOL)
                    if prog.delta_based else np.array_equal(res, full))
            # a checkpoint of the halting superstep resumes into one more,
            # empty, superstep (the JAX engine does the same)
            want = fst.supersteps + (fst.supersteps <= 4)
            sm.check(bool(same) and rst.supersteps == want,
                     f"kron-14 {name}: resumed from the second checkpoint "
                     f"(step 4 of {fst.supersteps}): {rst.supersteps} "
                     f"supersteps, the uninterrupted run's results")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    timer.close()
    return dict(steps=steps, win_vals=win_vals, tile_res=tile_res)


def stream_kernel_checks(sm: Smoke, errs: dict, win, tile, out) -> None:
    """Each kernel against its plain version once on the post-compact
    device lists of phase 6 (min exact; sums within SUM_RTOL)."""
    import torch
    from repro_torch.algos import SSSP, PageRank

    dev = torch.device(DEVICE)
    dist = torch.from_numpy(out["win_vals"]).to(dev)[..., None]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for prog in (SSSP(), PageRank()):
        vals = torch.rand(dist.shape, generator=gen, device=dev) \
            if prog.delta_based else dist
        kernel_vs_plain(sm, errs, "the post-compact kron-20", win[0],
                        "pallas_windows", prog, vals)
    for name, prog in (("sssp", SSSP()), ("pagerank", PageRank())):
        v = torch.from_numpy(out["tile_res"][("pallas_tiles", name)]).to(
            dev)[..., None]
        kernel_vs_plain(sm, errs, "the post-compact kron-14", tile[2],
                        "pallas_tiles", prog, v)


def kernel_vs_plain(sm: Smoke, errs: dict, label: str, sess, eb: str, prog,
                    vals) -> None:
    """One kernel against its plain version on a session's device list at
    ``vals`` ([P, v_max, K] on the card): min exact, sums within
    SUM_RTOL."""
    import torch
    from repro_torch.core.engine import (_layout_block_from, _tile_inputs,
                                         _window_inputs)
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    spec = prog.sweep_spec
    v_max = sess.pg.v_max
    blk = _layout_block_from(sess.pg.ensure_edge_layouts(
        shape_policy=sess.shape_policy), sess.pg, prog, eb, vals.device)
    if eb == "pallas_windows":
        msgs, ldst, bwin, nw, plan = _window_inputs(
            sess.device_graph(), blk, vals, spec, v_max)
        got = sk.segment_combine_windowed(msgs, ldst, bwin, n_windows=nw,
                                          combiner=spec.combiner, plan=plan)
        want = sk.segment_combine_plain(msgs, ldst, bwin, n_windows=nw,
                                        combiner=spec.combiner)
        torch.cuda.synchronize()
        ok, err = compare(got, want, segment_magnitude(
            msgs, ldst, bwin, nw, spec.combiner))
        errs["segment_combine"] = max(errs["segment_combine"], err)
        sm.check(ok, f"segment_combine {spec.combiner} on {label} list "
                     f"({bwin.shape[0]} blocks) vs plain (max err "
                     f"{err:.3g})")
        return
    tiles, td, ts, vv, ndt, plan = _tile_inputs(blk, vals, spec, v_max)
    got = bk.bsp_spmv(tiles, td, ts, vv, n_dst_tiles=ndt,
                      semiring=spec.semiring, plan=plan)
    want = bk.bsp_spmv_plain(tiles, td, ts, vv, n_dst_tiles=ndt,
                             semiring=spec.semiring)
    torch.cuda.synchronize()
    ok, err = compare(got, want, spmv_magnitude(tiles, td, ts, vv, ndt,
                                                spec.semiring))
    errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
    sm.check(ok, f"bsp_spmv {spec.semiring} on {label} list "
                 f"({tiles.shape[0]} tiles) vs plain (max err {err:.3g})")


# --------------------------------------------------------------------------- #
# phase 7: the algorithm suite
# --------------------------------------------------------------------------- #
ALGO_K = 16                   # roots / pivots of MSBFS and triangles
F32_EXACT = 2**24             # float32 holds every integer below this
# phase 7's engine bounds: far above what its queries need (at most 17
# supersteps and ~1,100 sweeps in one), so a query that does not halt fails
# its check instead of running into the script's time limit
ALGO_MAX_STEPS = 100
ALGO_MAX_LOCAL = 4096


def resident_edges(pg):
    """The session graph's resident edge list in global ids (parallel
    copies kept): ``(src, dst, w)``."""
    p, e = pg.emask.nonzero()
    return (pg.gvid[p, pg.esrc[p, e]], pg.gvid[p, pg.edst[p, e]],
            pg.ew[p, e])


def _adjacency(n, src, dst):
    """CSR adjacency with parallel copies summed (float64)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    return csr_matrix((np.ones(src.shape[0]), (src, dst)), shape=(n, n))


def oracle_bfs_levels(n, src, dst, roots):
    """[n, K] hop counts from each root (scipy; inf where unreachable)."""
    from scipy.sparse.csgraph import shortest_path
    return shortest_path(_adjacency(n, src, dst), directed=True,
                         unweighted=True, indices=roots).T


def oracle_triangles(n, src, dst, pivots):
    """float64 ``y = A^T x_p, z = A^T y, sum_u y*z`` per pivot (A^T: the
    engine sums at edge destinations); returns ``(sums [K], max z, max
    y*z)``."""
    import numpy as np
    at = _adjacency(n, src, dst).T.tocsr()
    x = np.zeros((n, len(pivots)))
    x[np.asarray(pivots), np.arange(len(pivots))] = 1.0
    y = at @ x
    z = at @ y
    return (y * z).sum(axis=0), float(z.max()), float((y * z).max())


def oracle_lp(n, src, dst, hops):
    """[n, hops + 1]: lane h is the smallest id within h hops."""
    import numpy as np
    ids = np.arange(n, dtype=np.int64)
    lanes = [ids]
    for _ in range(hops):
        new = ids.copy()
        np.minimum.at(new, dst, lanes[-1][src])
        lanes.append(new)
    return np.stack(lanes, axis=1)


def oracle_kcore_peeled(n, src, dst, k):
    """1 where the vertex is peeled out of the k-core (numpy peel)."""
    import numpy as np
    alive = np.ones(n, bool)
    while True:
        deg = np.bincount(src, weights=alive[dst], minlength=n)
        kill = alive & (deg < k)
        if not kill.any():
            return (~alive).astype(np.int64)
        alive &= ~kill


def oracle_brandes(n, src, dst, pivots):
    """Brandes from each pivot over scipy's BFS levels, float64: ``(levels,
    sigma, delta, bc)`` with bc halved (undirected) and v != s."""
    import numpy as np
    lev = oracle_bfs_levels(n, src, dst, pivots)
    sigma = np.zeros(lev.shape)
    delta = np.zeros(lev.shape)
    for k, s in enumerate(pivots):
        d = lev[:, k]
        on = np.isfinite(d[src]) & (d[src] + 1 == d[dst])
        es, ed = src[on], dst[on]
        sig = np.zeros(n)
        sig[s] = 1.0
        depth = int(d[np.isfinite(d)].max())
        for level in range(1, depth + 1):
            sel = d[ed] == level
            np.add.at(sig, ed[sel], sig[es[sel]])
        dl = np.zeros(n)
        for level in range(depth - 1, -1, -1):
            sel = d[es] == level
            u, w = es[sel], ed[sel]
            np.add.at(dl, u, sig[u] / sig[w] * (1.0 + dl[w]))
        sigma[:, k], delta[:, k] = sig, dl
    not_pivot = np.arange(n)[:, None] != np.asarray(pivots)[None, :]
    return lev, sigma, delta, (delta * not_pivot).sum(axis=1) / 2.0


def oracle_gsim(n, src, dst, labels, qadj, qlabel):
    """Simulation fixpoint: for each pattern edge q -> q2,
    ``sim[:, q] &= (A @ sim[:, q2]) > 0`` until nothing changes."""
    import numpy as np
    a = _adjacency(n, src, dst)
    sim = labels[:, None] == qlabel[None, :]
    while True:
        post = a @ sim.astype(np.float64)
        new = sim.copy()
        for q, q2 in zip(*np.nonzero(qadj)):
            new[:, q] &= post[:, q2] > 0
        if np.array_equal(new, sim):
            return sim.astype(np.int64)
        sim = new


def allclose(got, want, rtol=SUM_RTOL):
    """(ok, max relative error) of a float32 engine result against a
    float64 oracle: each element within ``rtol`` of the oracle's value
    (and ``rtol`` absolute near zero); inf must meet inf."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)) or \
            not np.array_equal(got[~fin], want[~fin]):
        return False, float("inf")
    err = np.abs(got[fin] - want[fin])
    ok = bool((err <= rtol * np.maximum(np.abs(want[fin]), 1.0)).all())
    rel = float((err / np.maximum(np.abs(want[fin]), 1.0)).max()) \
        if err.size else 0.0
    return ok, rel


class AlgoRunner:
    """Runs the phase's queries, logs each one (wall time, supersteps,
    messages, kernel launches) and counts the launches per (kernel, row)."""

    def __init__(self, sm: Smoke, log: list):
        self.sm, self.log = sm, log
        self.row_launches: dict = {}

    def launches(self):
        from repro_torch.kernels import bsp_spmv as bk
        from repro_torch.kernels import segment_combine as sk
        return bk.bsp_spmv.launches + sk.segment_combine_windowed.launches

    def query(self, sess, label, name, prog, params, eb, warm=False,
              row=None):
        from repro_torch.core import EngineConfig
        before = self.launches()
        res, st = sess.query(prog, params, warm=warm, cfg=EngineConfig(
            edge_backend=eb, max_supersteps=ALGO_MAX_STEPS,
            max_local_iters=ALGO_MAX_LOCAL))
        n = self.launches() - before
        if st.supersteps >= ALGO_MAX_STEPS:
            self.sm.check(False, f"{label} {name} on {eb} halted within "
                                 f"{ALGO_MAX_STEPS} supersteps")
        if row is not None:
            self.row_launches[row] = self.row_launches.get(row, 0) + n
        rec = dict(phase=7, graph=label, query=name, edge_backend=eb,
                   wall_s=st.wall_time, supersteps=st.supersteps,
                   messages=st.total_messages, host_syncs=st.host_syncs,
                   processed_edges=st.processed_edges, kernel_launches=n)
        self.log.append(rec)
        print("query " + json.dumps(rec), flush=True)
        return res, st

    def same(self, label, name, kern, coo):
        """A kernel-backend query against its ``coo`` twin: results bit
        for bit, supersteps, messages and per-partition sweeps."""
        import numpy as np
        (got, gst), (want, wst) = kern, coo
        self.sm.check(
            bool(np.array_equal(got, want)) and
            (gst.supersteps, gst.total_messages, gst.partition_sweeps) ==
            (wst.supersteps, wst.total_messages, wst.partition_sweeps),
            f"{label} {name}: {gst.edge_backend} bit-identical to coo "
            f"{got.shape}, supersteps {gst.supersteps}, messages "
            f"{gst.total_messages}, per-partition sweeps equal")


def check_levels(sm, label, name, sess, res, roots, src, dst):
    """The first four lanes of a levels result against scipy's BFS."""
    import numpy as np
    t = time.perf_counter()
    want = oracle_bfs_levels(sess.pg.n_vertices, src, dst, roots[:4])
    got = sess.pg.collect(res, fill=np.float32(np.inf))
    got = got[:, :4] if got.ndim == 2 else got[:, None]
    sm.check(bool(np.array_equal(got.astype(np.float64), want)),
             f"{label} {name}: {want.shape[1]} lanes of levels equal scipy's "
             f"unweighted shortest paths ({int(np.isfinite(want).sum())} "
             f"reachable; oracle {time.perf_counter() - t:.1f}s)")


def check_triangles(sm, label, sess, res, pivots, src, dst):
    import numpy as np
    from repro_torch.algos import triangles_from_result
    want, zmax, yzmax = oracle_triangles(sess.pg.n_vertices, src, dst,
                                         pivots)
    sm.note(f"{label} triangles: largest z {zmax:.0f}, largest y*z "
            f"{yzmax:.0f} (float32 exact below {F32_EXACT})")
    sm.check(zmax < F32_EXACT and yzmax < F32_EXACT,
             f"{label} triangles: every z and y*z below 2**24")
    got = 2.0 * triangles_from_result(sess.pg.collect(res, fill=0.0))
    sm.check(bool(np.array_equal(got, want)),
             f"{label} triangles: sum y*z per pivot equals scipy's float64 "
             f"A^T products on the same edge list (closed 3-walks "
             f"{int(want.sum())}, per pivot max {int(want.max())})")


def windows_algos(sm: Smoke, ar: AlgoRunner, win) -> dict:
    """kron-20 / cdbh / P=16 (phase 3's session after phase 6): BFS from
    two roots, MSBFS and triangles at K = 16 on ``pallas_windows`` against
    ``coo`` and scipy, then an insert batch and MSBFS warm vs cold."""
    import numpy as np
    from repro_torch.algos import BFS, make_msbfs, make_triangles

    sess = win[0]
    label = "kron-20"
    src, dst, _ = resident_edges(sess.pg)
    n = sess.pg.n_vertices
    rng = np.random.default_rng(17)
    live = np.nonzero(np.bincount(src, minlength=n))[0]
    roots = np.sort(rng.choice(live, ALGO_K, replace=False)).astype(np.int32)
    out = {}
    for i, r in enumerate(roots[:2]):
        q = [ar.query(sess, label, f"bfs_{i}", BFS(), {"source": int(r)}, eb)
             for eb in ("pallas_windows", "coo")]
        ar.same(label, f"BFS from {r}", *q)
        check_levels(sm, label, f"BFS from {r}", sess, q[0][0], [r], src,
                     dst)
    prog, params = make_msbfs(roots)
    q = [ar.query(sess, label, "msbfs", prog, params, eb,
                  row=("segment_combine_windowed", "min") if
                  eb == "pallas_windows" else None)
         for eb in ("pallas_windows", "coo")]
    ar.same(label, f"MSBFS K={ALGO_K}", *q)
    check_levels(sm, label, f"MSBFS K={ALGO_K}", sess, q[0][0], roots, src,
                 dst)
    out["msbfs"] = q[0][0]
    tprog, tparams = make_triangles(roots)
    q = [ar.query(sess, label, "triangles", tprog, tparams, eb,
                  row=("segment_combine_windowed", "sum") if
                  eb == "pallas_windows" else None)
         for eb in ("pallas_windows", "coo")]
    ar.same(label, f"triangles K={ALGO_K}", *q)
    check_triangles(sm, label, sess, q[0][0], roots, src, dst)

    # an insert batch of phase 6's kind, then MSBFS warm-auto vs cold
    bs, bd, bw = sym_batch(rng, sess.pg.n_edges // 400, n)
    warm_q0 = sess.stats.warm_queries
    t = time.perf_counter()
    sess.update(adds=(bs, bd, bw))
    st = sess.flush()
    sm.note(f"{label}: insert batch of {st.n_added} edges flushed in "
            f"{time.perf_counter() - t:.1f}s")
    warm = ar.query(sess, label, "msbfs_warm", prog, params,
                    "pallas_windows", warm="auto",
                    row=("segment_combine_windowed", "min"))
    cold = ar.query(sess, label, "msbfs_cold", prog, params,
                    "pallas_windows", row=("segment_combine_windowed", "min"))
    coo = ar.query(sess, label, "msbfs_cold", prog, params, "coo")
    sm.check(sess.stats.warm_queries == warm_q0 + 1 and
             bool(np.array_equal(warm[0], cold[0])) and
             warm[1].supersteps <= cold[1].supersteps,
             f"{label} after the insert batch: MSBFS warm-auto bit-identical"
             f" to cold, {warm[1].supersteps} supersteps vs "
             f"{cold[1].supersteps}")
    ar.same(label, "MSBFS after the insert batch", cold, coo)
    src, dst, _ = resident_edges(sess.pg)
    check_levels(sm, label, "MSBFS after the insert batch", sess, cold[0],
                 roots, src, dst)
    out["msbfs"] = cold[0]
    return out


def grid_algos(sm: Smoke, ar: AlgoRunner, tile) -> dict:
    """grid-1024 / range / P=16 (phase 4's session): MSBFS at K = 16 on
    ``pallas_tiles`` against ``coo`` and scipy."""
    import numpy as np
    from repro_torch.algos import make_msbfs

    sess = tile[0]
    label = f"grid-{GRID_SIDE}"
    src, dst, _ = resident_edges(sess.pg)
    rng = np.random.default_rng(19)
    roots = np.sort(rng.choice(sess.pg.n_vertices, ALGO_K,
                               replace=False)).astype(np.int32)
    prog, params = make_msbfs(roots)
    q = [ar.query(sess, label, "msbfs", prog, params, eb,
                  row=("bsp_spmv", "min_plus") if eb == "pallas_tiles"
                  else None)
         for eb in ("pallas_tiles", "coo")]
    ar.same(label, f"MSBFS K={ALGO_K}", *q)
    check_levels(sm, label, f"MSBFS K={ALGO_K}", sess, q[0][0], roots, src,
                 dst)
    return {"msbfs": q[0][0]}


def kron14_algos(sm: Smoke, ar: AlgoRunner) -> dict:
    """kron-14 / cdbh / P=16, a session of its own (weighted, seeded vertex
    labels): triangles at K = 16 on ``pallas_tiles`` against ``coo``;
    MSSP, LP, k-core, betweenness and graph simulation against the
    script's oracles; k-core warm vs cold after a delete batch and MSBFS
    warm vs cold after an insert batch."""
    import numpy as np
    from repro_torch.algos import (brandes_betweenness, make_kcore, make_lp,
                                   make_msbfs, make_triangles)
    from repro_torch.algos.gsim import make_gsim
    from repro_torch.algos.mssp import make_mssp
    from repro_torch.graphgen import kronecker_graph
    from repro_torch.session import GraphSession

    label = "kron-14"
    g = kronecker_graph(14, seed=7, weighted=True)
    sess = GraphSession.from_graph(g, 16, "cdbh", device=DEVICE)
    n = g.n_vertices
    rng = np.random.default_rng(23)
    labels = rng.integers(0, 3, n)
    sess.pg.set_vertex_labels(labels)
    src, dst, w = resident_edges(sess.pg)
    live = np.nonzero(np.bincount(src, minlength=n))[0]
    pivots = np.sort(rng.choice(live, ALGO_K, replace=False)).astype(
        np.int32)
    out = {}

    tprog, tparams = make_triangles(pivots)
    q = [ar.query(sess, label, "triangles", tprog, tparams, eb,
                  row=("bsp_spmv", "plus_times") if eb == "pallas_tiles"
                  else None)
         for eb in ("pallas_tiles", "coo")]
    ar.same(label, f"triangles K={ALGO_K}", *q)
    check_triangles(sm, label, sess, q[0][0], pivots, src, dst)

    sources = pivots[:8]
    res, _ = ar.query(sess, label, "mssp", *make_mssp(sources), "coo")
    want = oracle_sssp_edges(n, src, dst, w, sources).T
    ok, rel = allclose(sess.pg.collect(res, fill=np.float32(np.inf)), want)
    sm.check(ok, f"{label} MSSP K=8 agrees with scipy Dijkstra (max rel err"
                 f" {rel:.3g})")

    res, _ = ar.query(sess, label, "lp", *make_lp(3), "coo")
    got = sess.pg.collect(res, fill=np.int32(2**31 - 1))
    sm.check(bool(np.array_equal(got, oracle_lp(n, src, dst, 3))),
             f"{label} LP hops=3 equals the numpy hop-lane oracle")

    for k in (2, 3):
        res, _ = ar.query(sess, label, f"kcore{k}", *make_kcore(k), "coo")
        want = oracle_kcore_peeled(n, src, dst, k)
        got = sess.pg.collect(res, fill=0)
        sm.check(bool(np.array_equal(got, want)),
                 f"{label} k-core k={k} equals the numpy peel "
                 f"({int(n - want.sum())} vertices in the core)")

    bq = []

    def query(prog, params):
        res, _ = ar.query(sess, label, type(prog).__name__, prog, params,
                          "coo")
        bq.append(type(prog).__name__)
        return sess.pg.collect(res, fill=prog.identity)
    bpiv = pivots[:8]
    got = brandes_betweenness(query, bpiv)
    lev, sigma, delta, bc = oracle_brandes(n, src, dst, bpiv)
    ok_l = bool(np.array_equal(got["levels"].astype(np.float64), lev))
    checks = [allclose(got[k], v)
              for k, v in (("sigma", sigma), ("delta", delta), ("bc", bc))]
    sm.check(ok_l and all(c[0] for c in checks),
             f"{label} betweenness, 8 pivots ({' -> '.join(bq)}): levels "
             f"exact; sigma, delta, bc within {SUM_RTOL:g} of the float64 "
             f"Brandes (max rel err {max(c[1] for c in checks):.3g}; max bc "
             f"{bc.max():.4g})")

    qadj = np.array([[0, 1, 1], [0, 0, 1], [0, 0, 0]], np.int32)
    qlabel = np.array([0, 1, 2], np.int32)
    res, _ = ar.query(sess, label, "gsim", *make_gsim(qadj, qlabel), "coo")
    want = oracle_gsim(n, src, dst, labels, qadj, qlabel)
    got = sess.pg.collect(res, fill=0)
    sm.check(bool(np.array_equal(got, want)),
             f"{label} graph simulation equals the numpy fixpoint "
             f"({int(want.sum())} (vertex, pattern node) pairs kept)")

    # a delete batch, then k-core warm-auto vs cold
    kprog, kparams = make_kcore(3)
    ar.query(sess, label, "kcore3_seed", kprog, kparams, "coo", warm="auto")
    pick = rng.random(src.shape[0]) < 0.05
    sess.update(deletes=(np.concatenate([src[pick], dst[pick]]),
                         np.concatenate([dst[pick], src[pick]])))
    st = sess.flush()
    warm = ar.query(sess, label, "kcore3_warm", kprog, kparams, "coo",
                    warm="auto")
    cold = ar.query(sess, label, "kcore3_cold", kprog, kparams, "coo")
    src, dst, w = resident_edges(sess.pg)
    want = oracle_kcore_peeled(n, src, dst, 3)
    sm.check(st.n_deleted > 0 and bool(np.array_equal(warm[0], cold[0]))
             and bool(np.array_equal(sess.pg.collect(cold[0], fill=0), want))
             and warm[1].supersteps <= cold[1].supersteps,
             f"{label} after deleting {st.n_deleted} edges: k-core warm "
             f"bit-identical to cold and to the numpy peel, "
             f"{warm[1].supersteps} supersteps vs {cold[1].supersteps}")

    # an insert batch, then MSBFS warm-auto vs cold on tiles and coo
    mprog, mparams = make_msbfs(pivots)
    ar.query(sess, label, "msbfs_seed", mprog, mparams, "pallas_tiles",
             warm="auto")
    bs, bd, bw = sym_batch(rng, sess.pg.n_edges // 100, n)
    sess.update(adds=(bs, bd, bw))
    st = sess.flush()
    warm_q0 = sess.stats.warm_queries
    warm = ar.query(sess, label, "msbfs_warm", mprog, mparams,
                    "pallas_tiles", warm="auto")
    cold = ar.query(sess, label, "msbfs_cold", mprog, mparams,
                    "pallas_tiles")
    coo = ar.query(sess, label, "msbfs_cold", mprog, mparams, "coo")
    sm.check(sess.stats.warm_queries == warm_q0 + 1 and st.n_added > 0 and
             bool(np.array_equal(warm[0], cold[0])) and
             warm[1].supersteps <= cold[1].supersteps,
             f"{label} after inserting {st.n_added} edges: MSBFS warm-auto "
             f"bit-identical to cold, {warm[1].supersteps} supersteps vs "
             f"{cold[1].supersteps}")
    ar.same(label, "MSBFS after the insert batch", cold, coo)
    src, dst, _ = resident_edges(sess.pg)
    check_levels(sm, label, "MSBFS after the insert batch", sess, cold[0],
                 pivots, src, dst)
    out["sess"] = sess
    return out


def k16_kernel_rows(sm: Smoke, errs: dict, ar: AlgoRunner, win, tile,
                    parts: dict) -> dict:
    """The four K = 16 rows: each kernel on the device lists phase 7's
    queries used (``parts``: what each part of the phase returned), against
    its plain version, timed beside its bound and (where one PyTorch call
    computes the same function) that call. Returns ``{kernel name: [row,
    ...]}``."""
    import torch
    from repro_torch.algos import make_msbfs, make_triangles
    from repro_torch.core.engine import (_layout_block_from, _tile_inputs,
                                         _window_inputs)
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    rows = {"segment_combine_windowed": [], "bsp_spmv": []}
    roots = list(range(ALGO_K))

    def bound(nbytes, ops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    # segment_combine on kron-20: min (MSBFS levels) and sum (random)
    sess = win[0]
    sgs = sess.device_graph()
    lay = sess.pg.edge_layouts
    levels = torch.from_numpy(parts["kron-20 windows"]["msbfs"]).to(dev)
    for comb, prog in (("min", make_msbfs(roots)[0]),
                       ("sum", make_triangles(roots)[0])):
        vals = levels if comb == "min" else torch.rand(
            levels.shape, generator=gen, device=dev)
        blk = _layout_block_from(lay, sess.pg, prog, "pallas_windows", dev)
        msgs, ldst, bwin, nw, plan = _window_inputs(
            sgs, blk, vals, prog.sweep_spec, sgs.v_max)
        got = sk.segment_combine_windowed(msgs, ldst, bwin, n_windows=nw,
                                          combiner=comb, plan=plan)
        want = sk.segment_combine_plain(msgs, ldst, bwin, n_windows=nw,
                                        combiner=comb)
        torch.cuda.synchronize()
        ok, err = compare(got, want, segment_magnitude(msgs, ldst, bwin, nw,
                                                       comb))
        errs["segment_combine"] = max(errs["segment_combine"], err)
        sm.check(ok, f"segment_combine {comb} K={ALGO_K} at the kron-20 "
                     f"shape {tuple(msgs.shape)} vs plain (max err "
                     f"{err:.3g})")
        Be = lay.block_edges
        n_blocks = int(lay.n_blocks.sum())
        nbytes = n_blocks * Be * (ALGO_K + 1) * 4 + n_blocks * 4 \
            + nw * 128 * ALGO_K * 4
        b_ms, b_by = bound(nbytes, n_blocks * Be * ALGO_K)
        row = (bwin.long().repeat_interleave(Be) * 128 + ldst.long())[:, None]
        row = row.expand(-1, ALGO_K).contiguous()
        lib_out = torch.full((nw * 128, ALGO_K),
                             float("inf") if comb == "min" else 0.0,
                             device=dev)
        red = "amin" if comb == "min" else "sum"
        rows["segment_combine_windowed"].append(dict(
            shape=f"kron-20 {'MSBFS' if comb == 'min' else 'triangles'} "
                  f"msgs {tuple(msgs.shape)} f32 {comb}, {nw} windows, "
                  f"{plan.n_chunks} chunks",
            launches=ar.row_launches.get(("segment_combine_windowed", comb),
                                         0),
            max_abs_err=err,
            ms=time_ms(lambda: sk.segment_combine_windowed(
                msgs, ldst, bwin, n_windows=nw, combiner=comb, plan=plan)),
            plain_ms=time_ms(lambda: sk.segment_combine_plain(
                msgs, ldst, bwin, n_windows=nw, combiner=comb)),
            library_ms=time_ms(lambda: lib_out.scatter_reduce_(
                0, row, msgs, red, include_self=True)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
        del msgs, ldst, bwin, got, want, row, lib_out

    # bsp_spmv: min_plus on grid-1024 (MSBFS levels), plus_times on kron-14
    for label, sess, vals, prog, key in (
            (f"grid-{GRID_SIDE} MSBFS", tile[0],
             torch.from_numpy(parts[f"grid-{GRID_SIDE} tiles"]["msbfs"]).to(
                 dev),
             make_msbfs(roots)[0], "min_plus"),
            ("kron-14 triangles", parts["kron-14"]["sess"], None,
             make_triangles(roots)[0], "plus_times")):
        pg = sess.pg
        if vals is None:
            vals = torch.rand((pg.n_parts, pg.v_max, ALGO_K), generator=gen,
                              device=dev)
        blk = _layout_block_from(pg.edge_layouts, pg, prog, "pallas_tiles",
                                 dev)
        tiles, td, ts, v, ndt, plan = _tile_inputs(blk, vals,
                                                   prog.sweep_spec, pg.v_max)
        semi = prog.sweep_spec.semiring
        got = bk.bsp_spmv(tiles, td, ts, v, n_dst_tiles=ndt, semiring=semi,
                          plan=plan)
        want = bk.bsp_spmv_plain(tiles, td, ts, v, n_dst_tiles=ndt,
                                 semiring=semi)
        torch.cuda.synchronize()
        ok, err = compare(got, want, spmv_magnitude(tiles, td, ts, v, ndt,
                                                    semi))
        errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
        sm.check(ok, f"bsp_spmv {semi} K={ALGO_K} at the {label} shape "
                     f"T={tiles.shape[0]} vs plain (max err {err:.3g})")
        T = tiles.shape[0]
        nbytes = T * 128 * 128 * 4 + 2 * T * 4 + v.numel() * 4 \
            + ndt * 128 * ALGO_K * 4
        b_ms, b_by = bound(nbytes, 2 * T * 128 * 128 * ALGO_K)
        lib_ms = None
        if semi == "plus_times":
            lib_fn, lib_err = bsr_yardstick(tiles, td, ts, v, ndt)
            if lib_fn is not None:
                ok_l, err_l = compare(got, lib_fn().reshape(got.shape),
                                      spmv_magnitude(tiles, td, ts, v, ndt,
                                                     semi))
                sm.note(f"torch.sparse.mm (BSR) agrees with bsp_spmv "
                        f"plus_times K={ALGO_K}: {ok_l} (max err "
                        f"{err_l:.3g})")
                lib_ms = time_ms(lib_fn)
            else:
                sm.note(f"torch.sparse.mm (BSR) refused: {lib_err}")
        launches = ar.row_launches.get(("bsp_spmv", key), 0)
        rows["bsp_spmv"].append(dict(
            shape=f"{label} tiles [{T}, 128, 128] f32 {semi}, K={ALGO_K}, "
                  f"{plan.n_chunks} chunks, {-(-ALGO_K // 8)} lane groups",
            launches=launches, max_abs_err=err,
            ms=time_ms(lambda: bk.bsp_spmv(tiles, td, ts, v, n_dst_tiles=ndt,
                                           semiring=semi, plan=plan)),
            plain_ms=time_ms(lambda: bk.bsp_spmv_plain(
                tiles, td, ts, v, n_dst_tiles=ndt, semiring=semi),
                max_iters=5),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
        del tiles, td, ts, v, got, want
    return rows


def algos_path(sm: Smoke, log: list, errs: dict, win, tile) -> dict:
    """Phase 7 (see the module docstring): returns the K = 16 kernel rows,
    the launches per kernel and the peak device memory of each part."""
    import torch
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    ar = AlgoRunner(sm, log)
    bk.bsp_spmv.launches = 0
    sk.segment_combine_windowed.launches = 0
    peak = {}
    t0 = time.perf_counter()
    parts = {}
    for name, fn in (("kron-20 windows", lambda: windows_algos(sm, ar, win)),
                     (f"grid-{GRID_SIDE} tiles",
                      lambda: grid_algos(sm, ar, tile)),
                     ("kron-14", lambda: kron14_algos(sm, ar))):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        parts[name] = fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated()
        sm.note(f"phase 7 {name}: {time.perf_counter() - t:.1f}s, peak "
                f"device memory {peak[name]} bytes "
                f"({peak[name] / 2**30:.2f} GiB)")
    launches = {"bsp_spmv": bk.bsp_spmv.launches,
                "segment_combine_windowed":
                    sk.segment_combine_windowed.launches}
    sm.note(f"launches in the algorithm phase: {launches}; per row "
            f"{ {'/'.join(k): v for k, v in ar.row_launches.items()} }; "
            f"queries {time.perf_counter() - t0:.1f}s")
    sm.check(all(v > 0 for v in launches.values()),
             "the algorithm phase launched both kernels")
    sm.check(all(ar.row_launches.get(k, 0) > 0 for k in (
        ("segment_combine_windowed", "min"),
        ("segment_combine_windowed", "sum"), ("bsp_spmv", "min_plus"),
        ("bsp_spmv", "plus_times"))),
        "MSBFS and triangles at K=16 launched segment_combine at kron-20 "
        "and bsp_spmv at grid-1024 / kron-14")
    rows = k16_kernel_rows(sm, errs, ar, win, tile, parts)
    return dict(rows=rows, launches=launches, peak=peak,
                row_launches={"/".join(k): v
                              for k, v in ar.row_launches.items()})


# --------------------------------------------------------------------------- #
# phase 8: edge_backend='auto' and the balanced vertex-cut
# --------------------------------------------------------------------------- #
# The phase's monitor reads the edge counts alone (no sweep-time or
# frontier weight), so the wave below trips it at a flush known in advance:
# deleting WAVE_FRACTIONS of the resident edges of WAVE_PARTS of the 16
# partitions leaves an edge imbalance of at least 16 / (10 + 6 f), f the
# share they keep: >= 1.127 after the first flush, >= 1.176 after the
# second, so the gauge sits above ``high`` at two graph events in a row.
AUTO_MONITOR = dict(high=1.1, low=1.05, patience=2, w_time=0.0,
                    w_frontier=0.0)
WAVE_PARTS = 6
WAVE_FRACTIONS = (0.3, 1.0 / 7.0)    # of what each wave partition holds
WAVE_BUFFER_EDGES = 1 << 24          # the ebv session's buffer: above a wave
STEP5_DELETES = 10_000               # original edges deleted at the end
TILE_GROUP_LIMIT = 16 * 2**30        # tile value bytes 'auto' may realize


class AutoRunner:
    """Runs phase 8's session queries and logs each one (wall time,
    supersteps, messages, kernel launches, per-partition picks). Each run
    goes through ``counted``: the launch counters are set to 0 just before
    it and read just after, and the counts of the 'auto' path's runs (the
    'auto' queries and the forced mix) add up in ``auto_launches``; those
    of the uniform comparison queries in ``uniform_launches``."""

    def __init__(self, sm: Smoke, log: list):
        self.sm, self.log = sm, log
        self.auto_launches = {"bsp_spmv": 0, "segment_combine_windowed": 0}
        self.uniform_launches = dict(self.auto_launches)

    def counted(self, auto: bool, fn):
        """``(fn(), {kernel: launches in fn})``, added to the path's sum."""
        from repro_torch.kernels import bsp_spmv as bk
        from repro_torch.kernels import segment_combine as sk
        bk.bsp_spmv.launches = 0
        sk.segment_combine_windowed.launches = 0
        out = fn()
        n = {"bsp_spmv": bk.bsp_spmv.launches,
             "segment_combine_windowed": sk.segment_combine_windowed.launches}
        total = self.auto_launches if auto else self.uniform_launches
        for k, v in n.items():
            total[k] += v
        return out, n

    def query(self, sess, label, name, prog, params, eb, warm=False):
        from repro_torch.core import EngineConfig
        t = time.perf_counter()
        (res, st), n = self.counted(eb == "auto", lambda: sess.query(
            prog, params, warm=warm, cfg=EngineConfig(edge_backend=eb)))
        rec = dict(phase=8, graph=label, query=name, edge_backend=eb,
                   wall_s=st.wall_time, host_s=time.perf_counter() - t,
                   supersteps=st.supersteps,
                   messages=st.total_messages, host_syncs=st.host_syncs,
                   kernel_launches=n,
                   picks=pick_counts(st.partition_edge_backends))
        self.log.append(rec)
        print("query " + json.dumps(rec), flush=True)
        return res, st

    def same(self, label, name, got, want, delta_based):
        """A query against its ``coo`` twin: bit for bit with the same
        supersteps, messages and per-partition sweeps, or PageRank within
        PR_RTOL of the largest rank."""
        import numpy as np
        (a, ast), (b, bst) = got, want
        if delta_based:
            err = float(np.abs(a - b).max())
            scale = float(np.abs(b).max())
            return self.sm.check(
                err <= PR_RTOL * scale and bool(np.isfinite(a).all()),
                f"{label} {name}: {ast.edge_backend} == coo within "
                f"{PR_RTOL:g} of max rank (max err {err:.3g})")
        return self.sm.check(
            bool(np.array_equal(a, b)) and
            (ast.supersteps, ast.total_messages, ast.partition_sweeps) ==
            (bst.supersteps, bst.total_messages, bst.partition_sweeps),
            f"{label} {name}: {ast.edge_backend} bit-identical to coo, "
            f"supersteps {ast.supersteps}, messages {ast.total_messages}, "
            f"per-partition sweeps equal")


def pick_counts(picks) -> dict:
    """Partitions per backend of an assignment."""
    out = {}
    for b in picks or ():
        out[b] = out.get(b, 0) + 1
    return out


def check_dijkstra(sm, label, sess, res, source, src, dst, w):
    check_dijkstra_lanes(sm, label, sess, [res], [source], src, dst, w)


def check_dijkstra_lanes(sm, label, sess, results, sources, src, dst, w):
    """Each SSSP result against scipy's Dijkstra from its source, the
    oracle run once for all of them."""
    import numpy as np
    t = time.perf_counter()
    want = oracle_sssp_edges(sess.pg.n_vertices, src, dst, w, sources)
    took = time.perf_counter() - t
    for res, source, ws in zip(results, sources, want):
        d = sess.pg.collect(res, fill=np.float32(np.inf)).astype(np.float64)
        fin = np.isfinite(ws)
        sm.check(bool(np.array_equal(np.isfinite(d), fin)
                      and np.allclose(d[fin], ws[fin], rtol=1e-5)),
                 f"{label}: SSSP from {source} agrees with scipy Dijkstra "
                 f"(rtol 1e-5; {int(fin.sum())} reachable; oracle "
                 f"{took:.1f}s)")


def calibration_part(sm: Smoke):
    """The measured calibration table, cached under build/autotune."""
    import os
    import torch
    from repro_torch.core import autotune
    os.environ["DRONE_AUTOTUNE_DIR"] = str(ROOT / "build" / "autotune")
    t = time.perf_counter()
    table = autotune.get_table(force=True)
    took = time.perf_counter() - t
    name = torch.cuda.get_device_name(0).split()
    sm.check(table.source == "measured"
             and table.platform.startswith("torch-cuda-sm")
             and all(part in table.platform for part in name),
             f"calibration measured on {table.platform} in {took:.1f}s "
             f"({len(table.points)} points)")
    again = autotune.load_table(table.platform)
    sm.check(again is not None and again.to_json() == table.to_json(),
             f"calibration table reloads to the same JSON from "
             f"{autotune.table_path(table.platform)}")
    sm.note("calibrated unit costs (s per unit): " + ", ".join(
        f"{k} {v:.4g}" for k, v in sorted(table.unit_costs.items())))
    return table


def kron20_ebv_part(sm: Smoke, ar: AutoRunner, g) -> dict:
    """kron-20 / ebv / P=16 under 'auto' beside windows and coo."""
    import numpy as np
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core import EngineConfig, partition_metrics
    from repro_torch.kernels.bsp_spmv import TM, TN
    from repro_torch.partition import LoadMonitor, MonitorConfig
    from repro_torch.partition import ebv as E
    from repro_torch.session import GraphSession

    routing = CallTimer(((E.EBVRouterState, "route_adds"),))
    t = time.perf_counter()
    try:
        sess = GraphSession.from_graph(
            g, 16, "ebv", device=DEVICE, rebalance="auto",
            monitor=LoadMonitor(MonitorConfig(**AUTO_MONITOR)),
            cfg=EngineConfig(edge_backend="auto"),
            max_buffer_edges=WAVE_BUFFER_EDGES)
    finally:
        ebv_s = routing.take()
        routing.close()
    build = time.perf_counter() - t
    m, cdbh = partition_metrics(sess.pg), sm.facts.get("kron-20 cdbh")
    sm.note(f"kron-20 ebv P=16: EBV routing {ebv_s:.1f}s host, session "
            f"built in {build:.1f}s; ebv {m}; cdbh {cdbh}")
    sm.check(m.imbalance <= 1.1,
             f"kron-20 ebv edge imbalance {m.imbalance:.4f} <= 1.1 (cdbh "
             f"{cdbh.imbalance if cdbh else float('nan'):.4f}); replication "
             f"factor {m.replication_factor:.4f} (cdbh "
             f"{cdbh.replication_factor if cdbh else float('nan'):.4f})")
    t = time.perf_counter()
    picks = sess._resolve_assignment(SSSP(), sess.cfg)
    lay = sess.pg.edge_layouts
    tile_bytes = int(sum(int(lay.n_tiles[p]) for p, b in enumerate(picks)
                         if b == "pallas_tiles")) * TM * TN * 4
    sm.note(f"kron-20 ebv 'auto' picks {list(picks)} "
            f"({pick_counts(picks)}; layouts and picks "
            f"{time.perf_counter() - t:.1f}s; tile group values "
            f"{tile_bytes} bytes)")
    out = dict(sess=sess, picks=picks, ebv_s=ebv_s, metrics=m)
    if not sm.check(tile_bytes <= TILE_GROUP_LIMIT,
                    f"kron-20 'auto' tile group fits the card "
                    f"({tile_bytes} <= {TILE_GROUP_LIMIT} bytes)"):
        return out
    deg = g.out_degrees()
    rng = np.random.default_rng(7)                 # phase 3's two sources
    s0 = int(np.argmax(deg))
    s1 = int(rng.choice(np.nonzero(deg)[0]))
    out["source"] = s0
    for name, prog, params in (
            ("sssp_a", SSSP(), {"source": s0}),
            ("sssp_b", SSSP(), {"source": s1}),
            ("cc", ConnectedComponents(), None),
            ("pagerank", PageRank(), {"n_vertices": g.n_vertices})):
        res = {eb: ar.query(sess, "kron-20 ebv", name, prog, params, eb)
               for eb in ("auto", "pallas_windows", "coo")}
        for eb in ("auto", "pallas_windows"):
            ar.same("kron-20 ebv", name, res[eb], res["coo"],
                    prog.delta_based)
        sm.note(f"kron-20 ebv {name}: auto {res['auto'][1].wall_time:.4f}s, "
                f"pallas_windows {res['pallas_windows'][1].wall_time:.4f}s, "
                f"coo {res['coo'][1].wall_time:.4f}s")
        if name.startswith("sssp"):
            check_dijkstra(sm, f"kron-20 ebv {name}", sess, res["auto"][0],
                           params["source"], g.src, g.dst, g.weights)
    return out


def grid_mix_part(sm: Smoke, ar: AutoRunner) -> dict:
    """grid-1024 / range / P=16 under a forced three-way assignment through
    the engine's runner, each program against uniform ``coo``; then the
    calibrated 'auto' SSSP beside tiles and coo."""
    import numpy as np
    import torch
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core import EngineConfig
    from repro_torch.core.engine import _auto_layout_blocks, make_sim_runner
    from repro_torch.graphgen import grid_graph
    from repro_torch.session import GraphSession

    t = time.perf_counter()
    g = grid_graph(GRID_SIDE, weighted=True, seed=9)
    sess = GraphSession.from_graph(g, 16, "range", device=DEVICE)
    pg = sess.pg
    lay = pg.ensure_edge_layouts(shape_policy=sess.shape_policy)
    sgs = sess.device_graph()
    sm.note(f"grid-{GRID_SIDE} range P=16 session for phase 8 built in "
            f"{time.perf_counter() - t:.1f}s")
    asg = tuple(("coo", "pallas_tiles", "pallas_windows")[p % 3]
                for p in range(pg.n_parts))
    auto_cfg = EngineConfig(edge_backend="auto")
    blocks, values = {}, {}
    mix_launches = {"bsp_spmv": 0, "segment_combine_windowed": 0}
    for name, prog, params in (
            ("sssp", SSSP(), {"source": 0}),
            ("cc", ConnectedComponents(), None),
            ("pagerank", PageRank(), {"n_vertices": g.n_vertices})):
        t = time.perf_counter()
        blk = _auto_layout_blocks(lay, pg, prog, asg, sgs.device)
        torch.cuda.synchronize()
        lists = time.perf_counter() - t
        blocks[name] = (prog, blk)
        runs = {}
        for label, cfg, kw, lay_arg in (
                ("mix", auto_cfg, dict(partition_backends=asg), blk),
                ("coo", EngineConfig(), {}, None)):
            runner = make_sim_runner(prog, cfg, sess.slot_capacity, **kw)
            t = time.perf_counter()

            def run():
                out = runner(sgs, lay_arg, params)
                torch.cuda.synchronize()
                return out
            (res, steps, msgs, sweeps, syncs), n = ar.counted(
                label == "mix", run)
            wall = time.perf_counter() - t
            if label == "mix":
                for k, v in n.items():
                    mix_launches[k] += v
            res = res.cpu().numpy()
            runs[label] = (res, steps, msgs, list(sweeps))
            rec = dict(phase=8, graph=f"grid-{GRID_SIDE}", query=name,
                       edge_backend="forced three-way" if label == "mix"
                       else "coo", wall_s=wall,
                       supersteps=steps, messages=msgs, host_syncs=syncs,
                       kernel_launches=n,
                       group_lists_s=lists if label == "mix" else None)
            ar.log.append(rec)
            print("query " + json.dumps(rec), flush=True)
        (a, *ca), (b, *cb) = runs["mix"], runs["coo"]
        values[name] = a
        if prog.delta_based:
            err = float(np.abs(a - b).max())
            sm.check(err <= PR_RTOL * float(np.abs(b).max()),
                     f"grid-{GRID_SIDE} {name}: forced three-way mix == coo "
                     f"within {PR_RTOL:g} of max rank (max err {err:.3g})")
        else:
            sm.check(bool(np.array_equal(a, b)) and ca == cb,
                     f"grid-{GRID_SIDE} {name}: forced three-way mix "
                     f"bit-identical to coo, supersteps {ca[0]}, messages "
                     f"{ca[1]}, per-partition sweeps equal")
    sm.check(all(n > 0 for n in mix_launches.values()),
             f"the forced three-way mix launched both kernels, counted over "
             f"its own runs alone: {mix_launches}")
    res = {eb: ar.query(sess, f"grid-{GRID_SIDE}", "sssp", SSSP(),
                        {"source": 0}, eb)
           for eb in ("auto", "pallas_tiles", "coo")}
    for eb in ("auto", "pallas_tiles"):
        ar.same(f"grid-{GRID_SIDE}", "sssp", res[eb], res["coo"], False)
    sm.note(f"grid-{GRID_SIDE} SSSP: calibrated 'auto' picks "
            f"{pick_counts(res['auto'][1].partition_edge_backends)} "
            f"{res['auto'][1].wall_time:.4f}s, pallas_tiles "
            f"{res['pallas_tiles'][1].wall_time:.4f}s, coo "
            f"{res['coo'][1].wall_time:.4f}s")
    return dict(sess=sess, asg=asg, blocks=blocks, values=values)


def stranded_copies(pg, plan):
    """``(src, dst)`` of the resident copies a rebalance plan leaves on
    their donor partition while it moves another copy of the same
    unordered pair (the other direction, or a parallel edge). Counted from
    the plan's moves and the graph before it runs, not from the router."""
    import numpy as np
    V = np.int64(pg.n_vertices)
    ss, dd = [np.empty(0, np.int64)], [np.empty(0, np.int64)]
    for p, (idx, _) in plan.moves.items():
        m = pg.emask[p]
        gs = pg.gvid[p][pg.esrc[p][m]].astype(np.int64)
        gd = pg.gvid[p][pg.edst[p][m]].astype(np.int64)
        pair = np.minimum(gs, gd) * V + np.maximum(gs, gd)
        moved = np.zeros(gs.shape[0], bool)
        moved[idx] = True
        left = ~moved & np.isin(pair, pair[moved])
        ss.append(gs[left])
        dd.append(gd[left])
    return np.concatenate(ss), np.concatenate(dd)


def rebalance_part(sm: Smoke, ar: AutoRunner, k20: dict, g,
                   ident: str) -> list:
    """On the kron-20 ebv session: an insert batch, a delete wave on six
    partitions that trips the monitor once, queries after the migration,
    and deletes of original edges through the router's pair table."""
    import numpy as np
    import torch
    import repro_torch.session as S
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core import partition_metrics

    sess, s0 = k20["sess"], k20["source"]
    mon = sess.monitor
    lt = layout_timer()
    plan_t = CallTimer(((S, "plan_rebalance"),))
    spent = dict(execute=0.0, execute_layout=0.0)
    moved, stranded = [], []
    orig_exec = S.execute_rebalance

    def timed_exec(pg, ctx, plan, **k):
        stranded.append(stranded_copies(pg, plan))
        lay0, t = lt.seconds, time.perf_counter()
        before = partition_metrics(pg).imbalance
        try:
            rs = orig_exec(pg, ctx, plan, **k)
        finally:
            inner = lt.seconds - lay0
            spent["execute"] += time.perf_counter() - t - inner
            spent["execute_layout"] += inner
        moved.append((rs, before, partition_metrics(pg).imbalance))
        return rs

    S.execute_rebalance = timed_exec
    steps = []
    rng = np.random.default_rng(17)

    def step(label, mutate):
        spent.update(execute=0.0, execute_layout=0.0)
        t = time.perf_counter()
        st = mutate()
        host = time.perf_counter() - t
        layout, plan = lt.take(), plan_t.take()
        flush_layout = layout - spent["execute_layout"]
        t = time.perf_counter()
        sess.device_graph()
        torch.cuda.synchronize()
        upload = time.perf_counter() - t
        t = time.perf_counter()
        sess._layout_arg(SSSP(), "auto", sess.cfg)
        torch.cuda.synchronize()
        dev_list = time.perf_counter() - t
        rec = dict(graph="kron-20 ebv", step=label,
                   flush_host_s=host - layout - plan - spent["execute"],
                   layout_refresh_s=flush_layout,
                   rebalance_plan_s=plan,
                   rebalance_execute_s=spent["execute"],
                   rebalance_layout_s=spent["execute_layout"],
                   graph_upload_s=upload, auto_device_lists_s=dev_list,
                   n_edges=sess.pg.n_edges,
                   imbalance=partition_metrics(sess.pg).imbalance,
                   gauge=mon.gauge, rebalances=sess.stats.rebalances,
                   triggers=mon.triggers, gpu=ident)
        steps.append(rec)
        sm.note(f"rebalance step {label}: flush host "
                f"{rec['flush_host_s']:.3f}s, layout refresh "
                f"{flush_layout:.3f}s, rebalance plan {plan:.3f}s, "
                f"execution {spent['execute']:.3f}s, its layout rebuild "
                f"{spent['execute_layout']:.3f}s, graph upload "
                f"{upload:.3f}s, 'auto' device lists {dev_list:.3f}s; "
                f"imbalance {rec['imbalance']:.4f}, gauge {mon.gauge:.4f}, "
                f"rebalances {sess.stats.rebalances}, monitor "
                f"{mon.signals()} [{ident}]")
        return st

    try:
        # 1. a 0.5% symmetric insert batch, routed by EBV, sticky by pair
        n0, E0 = g.n_vertices, g.n_edges
        src, dst, w = sym_batch(rng, E0 // 400, n0)
        epp0 = sess.pg.edges_per_part.astype(np.int64)

        def insert():
            sess.update(adds=(src, dst, w))
            return sess.flush()
        st = step("insert 0.5%", insert)
        sm.check(st.n_added == src.shape[0] and sess.stats.rebalances == 0,
                 f"kron-20 ebv insert: {st.n_added} edges added, no "
                 f"rebalance")
        where = sess.ctx.route_deletes(src, dst)
        sm.check(bool(np.array_equal(
                     sess.pg.edges_per_part - epp0,
                     np.bincount(where, minlength=sess.pg.n_parts)))
                 and bool(np.array_equal(where,
                                         sess.ctx.route_deletes(dst, src))),
                 "kron-20 ebv insert: each partition grew by the new edges "
                 "the pair table routes to it, both directions of a pair "
                 "on one partition")

        # 2. the delete wave, over two flushes
        wave = np.sort(rng.choice(sess.pg.n_parts, WAVE_PARTS,
                                  replace=False))
        before_wave = partition_metrics(sess.pg).imbalance
        for i, frac in enumerate(WAVE_FRACTIONS):
            ds, dd = [], []
            for p in wave:
                m = sess.pg.emask[p]
                gs = sess.pg.gvid[p][sess.pg.esrc[p][m]]
                gd = sess.pg.gvid[p][sess.pg.edst[p][m]]
                pick = rng.random(gs.shape[0]) < frac
                ds.append(gs[pick])
                dd.append(gd[pick])
            ds, dd = np.concatenate(ds), np.concatenate(dd)

            def delete(ds=ds, dd=dd):
                sess.update(deletes=(ds, dd))
                return sess.flush()
            st = step(f"delete wave {i + 1} ({ds.shape[0]} edges on "
                      f"partitions {wave.tolist()})", delete)
        sm.check(sess.stats.rebalances == 1 and mon.triggers == 1
                 and len(moved) == 1,
                 f"the delete wave fired the monitor exactly once "
                 f"(rebalances {sess.stats.rebalances}, triggers "
                 f"{mon.triggers}; imbalance before the wave "
                 f"{before_wave:.4f})")
        if moved:
            rs, imb_before, imb_after = moved[0]
            sm.check(imb_after < imb_before,
                     f"the rebalance lowered the edge imbalance "
                     f"{imb_before:.4f} -> {imb_after:.4f} ({rs.n_moved} "
                     f"edges moved from {rs.parts_from} to {rs.parts_to} "
                     f"partitions, {rs.replicas_created} replicas created)")

        # 3. queries after the migration; the 'auto' pin re-resolves
        cold = ar.query(sess, "kron-20 ebv rebalanced", "sssp_cold", SSSP(),
                        {"source": s0}, "auto")
        warm = ar.query(sess, "kron-20 ebv rebalanced", "sssp_warm", SSSP(),
                        {"source": s0}, "auto", warm=True)
        coo = ar.query(sess, "kron-20 ebv rebalanced", "sssp_coo", SSSP(),
                       {"source": s0}, "coo")
        sm.check(bool(np.array_equal(cold[0], warm[0]))
                 and warm[1].supersteps <= cold[1].supersteps,
                 f"kron-20 ebv rebalanced: SSSP warm bit-identical to cold "
                 f"({warm[1].supersteps} vs {cold[1].supersteps} "
                 f"supersteps)")
        ar.same("kron-20 ebv rebalanced", "sssp", cold, coo, False)
        check_dijkstra(sm, "kron-20 ebv rebalanced", sess, cold[0], s0,
                       *resident_edges(sess.pg))
        after = cold[1].partition_edge_backends
        sm.note(f"'auto' picks before the rebalance {list(k20['picks'])}, "
                f"after {after}")
        sm.check(len(after) == sess.pg.n_parts and len(sess._auto_pin) == 1,
                 "the 'auto' assignment was resolved again after the "
                 "rebalance")
        for name, prog, params in (
                ("cc", ConnectedComponents(), None),
                ("pagerank", PageRank(), {"n_vertices": sess.pg.n_vertices})):
            ar.same("kron-20 ebv rebalanced", name,
                    ar.query(sess, "kron-20 ebv rebalanced", name, prog,
                             params, "auto"),
                    ar.query(sess, "kron-20 ebv rebalanced", name, prog,
                             params, "coo"), prog.delta_based)

        # 4. original edges deleted through the router's pair table: those
        # of a slice that route to the two partitions most of it routes to
        # (so the flush refreshes two partitions' layouts)
        pg = sess.pg
        V = pg.n_vertices
        cand = np.arange(min(g.n_edges, 20 * STEP5_DELETES))
        to = sess.ctx.route_deletes(g.src[cand], g.dst[cand])
        two = np.argsort(-np.bincount(to, minlength=pg.n_parts),
                         kind="stable")[:2]
        live = cand[np.isin(to, two)][:STEP5_DELETES]
        dsrc, ddst = g.src[live], g.dst[live]
        dk = np.unique(dsrc.astype(np.int64) * V + ddst)
        part = sess.ctx.route_deletes(dk // V, dk % V)
        routed = other = 0
        for p in range(pg.n_parts):
            m = pg.emask[p]
            pk = (pg.gvid[p][pg.esrc[p][m]].astype(np.int64) * V
                  + pg.gvid[p][pg.edst[p][m]])
            hit = np.isin(pk, dk[part == p])
            routed += int(hit.sum())
            other += int(np.isin(pk, dk).sum()) - int(hit.sum())
        n_before = int(pg.emask.sum())
        # the copies the rebalance stranded on their donors (ROADMAP Queue
        # 3): the pair table names the receiver, so these deletes are lost
        left = sum(int(np.isin(a * V + b, dk).sum()) for a, b in stranded)

        def delete_original():
            sess.update(deletes=(dsrc, ddst))
            return sess.flush()
        st = step(f"delete {live.shape[0]} original edges", delete_original)
        drop = n_before - int(sess.pg.emask.sum())
        sm.check(drop == routed == st.n_deleted and routed > 0,
                 f"deleting {live.shape[0]} original edges through the pair "
                 f"table (routed to partitions {sorted(two.tolist())}) "
                 f"removed {drop} resident copies, the {routed} on the "
                 f"partitions it routes to")
        sm.check(other == left,
                 f"the {other} resident copies of those edges the deletes "
                 f"missed are exactly the {left} the rebalance left on their "
                 f"donor partitions while moving their pair (known fault, "
                 f"as in the reference: {other} of {routed + other} copies, "
                 f"{other / max(routed + other, 1):.4f}, not deleted)")
        sm.check(sess.stats.rebalances == 1 and mon.triggers == 1,
                 "no second rebalance after the wave")
    finally:
        S.execute_rebalance = orig_exec
        plan_t.close()
        lt.close()
    return steps


def group_list_checks(sm: Smoke, errs: dict, grid: dict) -> None:
    """Each kernel against its plain version on the forced mix's
    group-sliced device lists of grid-1024, at the values the mix computed
    (SSSP distances: min_plus / min; ranks: plus_times / sum)."""
    import torch
    from repro_torch.core.api import DeviceSubgraph
    from repro_torch.core.engine import _tile_inputs, _window_inputs
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    sess, asg = grid["sess"], grid["asg"]
    sgs = sess.device_graph()
    v_max = sess.pg.v_max
    for name in ("sssp", "pagerank"):
        prog, (t_blk, w_blk) = grid["blocks"][name]
        spec = prog.sweep_spec
        v = torch.from_numpy(grid["values"][name]).to(sgs.device).reshape(
            sess.pg.n_parts, v_max, -1)
        ti = torch.tensor([p for p, b in enumerate(asg)
                           if b == "pallas_tiles"], device=sgs.device)
        wi = torch.tensor([p for p, b in enumerate(asg)
                           if b == "pallas_windows"], device=sgs.device)
        tl, td, ts, vv, ndt, plan = _tile_inputs(t_blk, v[ti], spec, v_max)
        got = bk.bsp_spmv(tl, td, ts, vv, n_dst_tiles=ndt,
                          semiring=spec.semiring, plan=plan)
        want = bk.bsp_spmv_plain(tl, td, ts, vv, n_dst_tiles=ndt,
                                 semiring=spec.semiring)
        ok, err = compare(got, want, spmv_magnitude(tl, td, ts, vv, ndt,
                                                    spec.semiring))
        errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
        sm.check(ok, f"bsp_spmv {spec.semiring} equals its plain version on "
                     f"the tile group's list ({tl.shape[0]} tiles of "
                     f"{ti.numel()} partitions; max err {err:.3g})")
        sub = DeviceSubgraph(*[None if x is None else x.index_select(0, wi)
                               for x in sgs])
        msgs, ldst, bwin, nw, plan = _window_inputs(sub, w_blk, v[wi], spec,
                                                    v_max)
        got = sk.segment_combine_windowed(msgs, ldst, bwin, n_windows=nw,
                                          combiner=spec.combiner, plan=plan)
        want = sk.segment_combine_plain(msgs, ldst, bwin, n_windows=nw,
                                        combiner=spec.combiner)
        ok, err = compare(got, want, segment_magnitude(msgs, ldst, bwin, nw,
                                                       spec.combiner))
        errs["segment_combine"] = max(errs["segment_combine"], err)
        sm.check(ok, f"segment_combine {spec.combiner} equals its plain "
                     f"version on the window group's list "
                     f"({bwin.shape[0]} blocks of {wi.numel()} partitions; "
                     f"max err {err:.3g})")


def auto_path(sm: Smoke, log: list, errs: dict, g20, ident: str) -> dict:
    """Phase 8 (see the module docstring): returns the launches per
    kernel, the rebalance steps and the peak device memory."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    table = calibration_part(sm)
    ar = AutoRunner(sm, log)
    t = time.perf_counter()
    k20 = kron20_ebv_part(sm, ar, g20)
    sm.note(f"phase 8 kron-20 ebv part: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    grid = grid_mix_part(sm, ar)
    sm.note(f"phase 8 grid part: {time.perf_counter() - t:.1f}s")
    steps = []
    if "source" in k20:
        t = time.perf_counter()
        steps = rebalance_part(sm, ar, k20, g20, ident)
        sm.note(f"phase 8 rebalance part: {time.perf_counter() - t:.1f}s")
    launches = ar.auto_launches
    sm.note(f"launches in phase 8's 'auto' runs: {launches}; in its "
            f"uniform comparison queries: {ar.uniform_launches}")
    sm.check(all(v > 0 for v in launches.values()),
             "phase 8's 'auto' runs launched both kernels")
    group_list_checks(sm, errs, grid)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    sm.note(f"phase 8: {time.perf_counter() - t0:.1f}s, peak device memory "
            f"{peak} bytes ({peak / 2**30:.2f} GiB)")
    return dict(launches=launches, steps=steps, peak=peak,
                unit_costs=table.unit_costs, platform=table.platform,
                ebv_s=k20["ebv_s"], picks=list(k20["picks"]),
                sess=k20["sess"] if "source" in k20 else None)


# --------------------------------------------------------------------------- #
# phase 9: serving and micro-batching
# --------------------------------------------------------------------------- #
SERVE_SOURCES = 5             # the kron-20 batch: pads to the 8-lane bucket
SERVE_REQUESTS = 8            # batcher requests to tenant a
SERVE_MAX_BATCH = 4           # two inline batched launches of 4
SERVE_INSERT_PAIRS = 64       # the insert that bumps the graph version


class ServeRunner:
    """Runs phase 9's calls with the launch counters set to 0 just before
    each and read just after; the counts add up in ``launches`` (the
    phase's ``launches_serving``)."""

    def __init__(self, sm: Smoke, log: list):
        self.sm, self.log = sm, log
        self.launches = {"bsp_spmv": 0, "segment_combine_windowed": 0}

    def counted(self, fn):
        """``(fn(), {kernel: launches in fn}, host seconds)``, synchronized
        before the clock stops."""
        import torch
        from repro_torch.kernels import bsp_spmv as bk
        from repro_torch.kernels import segment_combine as sk
        bk.bsp_spmv.launches = 0
        sk.segment_combine_windowed.launches = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        n = {"bsp_spmv": bk.bsp_spmv.launches,
             "segment_combine_windowed": sk.segment_combine_windowed.launches}
        for k, v in n.items():
            self.launches[k] += v
        return out, n, took

    def record(self, label, name, eb, lanes, host_s, n, st):
        rec = dict(phase=9, graph=label, query=name, edge_backend=eb,
                   lanes=lanes, host_s=host_s, wall_s=st.wall_time,
                   supersteps=st.supersteps, batch_size=st.batch_size,
                   result_cache_tier=st.result_cache_tier,
                   kernel_launches=n)
        self.log.append(rec)
        print("query " + json.dumps(rec), flush=True)

    def singles(self, sess, label, name, prog, plist, eb, **kw):
        """Each request alone; returns ``(outs, launches, host seconds)``
        summed over them."""
        from repro_torch.core import EngineConfig
        outs, total, secs = [], {}, 0.0
        for p in plist:
            out, n, took = self.counted(lambda: sess.query(
                prog, p, warm=False, cfg=EngineConfig(edge_backend=eb),
                **kw))
            self.record(label, name, eb, 1, took, n, out[1])
            outs.append(out)
            secs += took
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
        return outs, total, secs

    def batch(self, sess, label, name, prog, plist, eb, **kw):
        """One ``query_batch``; returns ``(outs, launches, host seconds)``."""
        from repro_torch.core import EngineConfig
        outs, n, took = self.counted(lambda: sess.query_batch(
            prog, plist, warm=False, cfg=EngineConfig(edge_backend=eb),
            **kw))
        self.record(label, name, eb, len(plist), took, n, outs[0][1])
        return outs, n, took

    def lanes_equal(self, label, name, got, want, delta_based=False):
        """Each batch lane against its singleton: bit for bit with the same
        supersteps, messages and per-partition sweeps, or PageRank within
        PR_RTOL of the largest rank."""
        import numpy as np
        ok, errs = True, []
        for (a, ast), (b, bst) in zip(got, want):
            if delta_based:
                err = float(np.abs(a - b).max())
                errs.append(err)
                ok &= err <= PR_RTOL * float(np.abs(b).max()) \
                    and bool(np.isfinite(a).all())
            else:
                ok &= bool(np.array_equal(a, b)) and \
                    (ast.supersteps, ast.total_messages,
                     ast.partition_sweeps) == \
                    (bst.supersteps, bst.total_messages,
                     bst.partition_sweeps)
        what = (f"within {PR_RTOL:g} of max rank (max err "
                f"{max(errs):.3g})" if delta_based else
                "bit for bit (results, supersteps, messages, "
                "per-partition sweeps)")
        return self.sm.check(
            ok and len(got) == len(want) and len(got) > 0,
            f"{label} {name}: each of the {len(got)} batch lanes equals its "
            f"singleton query {what}")


def _leafless_pagerank(n: int):
    """PageRank with the vertex count as a field: a leafless, non-monotone
    program, whose batch lanes are all one computation (they fan out from
    one query)."""
    from repro_torch.algos import PageRank

    @dataclasses.dataclass
    class LeaflessPageRank(PageRank):
        n_vertices: int = 1

        def init(self, sg, params, ec):
            return super().init(sg, {"n_vertices": self.n_vertices}, ec)

    return LeaflessPageRank(n_vertices=n)


def serving_kron20_part(sm: Smoke, sr: ServeRunner, errs: dict, sess,
                        g) -> dict:
    """Batches on phase 8's kron-20 / ebv session after its last step:
    SSSP on ``pallas_windows`` (B = 5, the 8-lane bucket) and on ``coo``
    (B = 4), CC, a leafless fan-out, PageRank; the result cache's all-hit
    batch and the version bump of an insert."""
    import numpy as np
    import torch
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core import EngineConfig
    from repro_torch.serving import DictStore, ResultCache

    label, win = "kron-20 ebv", "pallas_windows"
    deg = g.out_degrees()
    rng = np.random.default_rng(9)
    sources = [int(np.argmax(deg))] + [int(s) for s in rng.choice(
        np.nonzero(deg)[0], SERVE_SOURCES - 1, replace=False)]
    plist = [{"source": s} for s in sources]
    out = dict(sources=sources)

    # the session's windows device list (phase 8 ran 'auto'), built before
    # the timed calls; it launches nothing
    sess._layout_arg(SSSP(), win, EngineConfig(edge_backend=win))
    singles, alone, alone_s = sr.singles(sess, label, "sssp", SSSP(), plist,
                                         win)
    builds = sess.stats.runner_builds
    batch, n, batch_s = sr.batch(sess, label, "sssp", SSSP(), plist, win)
    sr.lanes_equal(label, f"SSSP B={SERVE_SOURCES} on {win}", batch, singles)
    sm.check(all(st.batch_size == SERVE_SOURCES for _, st in batch),
             f"{label}: every lane reports batch_size {SERVE_SOURCES}")
    seg = "segment_combine_windowed"
    sm.check(n[seg] == alone[seg] > 0 and n["bsp_spmv"] == 0,
             f"{label}: the batch launched segment_combine {n[seg]} times, "
             f"its {SERVE_SOURCES} singletons {alone[seg]} together")
    sm.check(sess.stats.runner_builds == builds + 1,
             f"{label}: the batch built one runner (the 8-lane bucket)")
    walls = (batch[0][1].wall_time, sum(st.wall_time for _, st in singles))
    sm.note(f"{label} SSSP B={SERVE_SOURCES} on {win}: batch {batch_s:.4f}s "
            f"host ({walls[0]:.4f}s runner wall), its lanes alone "
            f"{alone_s:.4f}s host ({walls[1]:.4f}s wall) together")
    out.update(batch_s=batch_s, singles_s=alone_s, batch_wall_s=walls[0],
               singles_wall_s=walls[1])
    check_dijkstra_lanes(sm, f"{label} batch lanes 0, 1", sess,
                         [r for r, _ in batch[:2]], sources[:2],
                         *resident_edges(sess.pg))
    eight = [{"source": s} for s in sources] + [
        {"source": int(s)} for s in rng.choice(np.nonzero(deg)[0], 8 -
                                               SERVE_SOURCES)]
    builds = sess.stats.runner_builds
    b8, _, _ = sr.batch(sess, label, "sssp", SSSP(), eight, win)
    sm.check(sess.stats.runner_builds == builds and
             all(bool(np.array_equal(a[0], b[0]))
                 for a, b in zip(b8, singles)),
             f"{label}: a batch of 8 builds no runner (same bucket), its "
             f"first {SERVE_SOURCES} lanes equal the singletons")

    coo = plist[:4]
    c_single, _, _ = sr.singles(sess, label, "sssp", SSSP(), coo, "coo")
    c_batch, n, _ = sr.batch(sess, label, "sssp", SSSP(), coo, "coo")
    sr.lanes_equal(label, "SSSP B=4 on coo", c_batch, c_single)
    sm.check(sum(n.values()) == 0, f"{label}: the coo batch launched no "
                                   f"kernel")

    cc_single, _, _ = sr.singles(sess, label, "cc", ConnectedComponents(),
                                 [None], win)
    cc_batch, _, _ = sr.batch(sess, label, "cc", ConnectedComponents(),
                              [None, None], win)
    sr.lanes_equal(label, "CC B=2 (leafless, monotone: a batch)", cc_batch,
                   cc_single * 2)
    fan = _leafless_pagerank(sess.pg.n_vertices)
    launches, batches = sess.stats.device_launches, sess.stats.batches
    f_single, f_alone, _ = sr.singles(sess, label, "pagerank_leafless", fan,
                                      [None], win)
    f_batch, n, _ = sr.batch(sess, label, "pagerank_leafless", fan,
                             [None, None], win)
    sm.check(sess.stats.device_launches == launches + 2 and
             sess.stats.batches == batches and n == f_alone and
             all(st.batch_size == 2 for _, st in f_batch) and
             f_batch[0][0] is f_batch[1][0],
             f"{label}: a leafless non-monotone batch of 2 fans out from one "
             f"runner call ({n[seg]} segment_combine launches, as alone)")
    # PageRank's float sums (scatter_add_ in apply_frontier) may round
    # differently from one run to the next on the card
    sr.lanes_equal(label, "leafless PageRank B=2 (fanned out)", f_batch,
                   f_single * 2, delta_based=True)
    pr = {"n_vertices": sess.pg.n_vertices}
    p_single, _, _ = sr.singles(sess, label, "pagerank", PageRank(), [pr],
                                win)
    p_batch, _, _ = sr.batch(sess, label, "pagerank", PageRank(), [pr, pr],
                             win)
    sr.lanes_equal(label, "PageRank B=2", p_batch, p_single * 2,
                   delta_based=True)

    # the result cache: an all-hit batch launches nothing
    sess.result_cache = ResultCache(store=DictStore())
    filled, _, _ = sr.batch(sess, label, "sssp", SSSP(), plist, win)
    launches = sess.stats.device_launches
    hit, n, hit_s = sr.batch(sess, label, "sssp", SSSP(), plist, win)
    sm.check(sum(n.values()) == 0 and
             sess.stats.device_launches == launches and
             all(st.result_cache_tier == "l1" for _, st in hit) and
             all(bool(np.array_equal(a[0], b[0]))
                 for a, b in zip(hit, filled)),
             f"{label}: the repeated batch is an all-hit on the result "
             f"cache: no kernel launch, device_launches unchanged")
    sm.note(f"{label}: result-cache all-hit batch of {SERVE_SOURCES} in "
            f"{hit_s:.6f}s host")
    out["hit_s"] = hit_s
    # an insert bumps the graph version: every lane misses and runs again
    a, b, w = sym_batch(rng, SERVE_INSERT_PAIRS, sess.pg.n_vertices)
    t = time.perf_counter()
    sess.update(adds=(a, b, w))
    sess.flush()
    out["flush_s"] = time.perf_counter() - t
    miss, n, _ = sr.batch(sess, label, "sssp", SSSP(), plist, win)
    sm.check(all(st.result_cache_tier == "miss" for _, st in miss) and
             n[seg] > 0,
             f"{label}: after an insert of {2 * SERVE_INSERT_PAIRS} edges "
             f"(flush {out['flush_s']:.1f}s) every lane misses and the "
             f"batch launches again ({n[seg]} segment_combine launches)")
    check_dijkstra_lanes(sm, f"{label} batch lanes 0, 1 after the insert",
                         sess, [r for r, _ in miss[:2]], sources[:2],
                         *resident_edges(sess.pg))
    dist = torch.from_numpy(miss[0][0]).to(DEVICE)[..., None]
    kernel_vs_plain(sm, errs, f"the {label}", sess, win, SSSP(), dist)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    kernel_vs_plain(sm, errs, f"the {label}", sess, win, PageRank(),
                    torch.rand(dist.shape, generator=gen, device=DEVICE))
    return out


def serving_pool_part(sm: Smoke, sr: ServeRunner, errs: dict) -> dict:
    """Two kron-14 tenants in one ``SessionPool`` on ``pallas_tiles``
    (one shape bucket: tenant b builds no runner), a ``MicroBatcher`` over
    the pool, and one round of its pump thread."""
    import threading
    import numpy as np
    import torch
    from repro_torch.algos import SSSP, PageRank
    from repro_torch.core import EngineConfig
    from repro_torch.graphgen import kronecker_graph
    from repro_torch.serving import (BatchPolicy, MicroBatcher, ResultCache,
                                     SessionPool)

    tiles = "pallas_tiles"
    t = time.perf_counter()
    pool = SessionPool(cfg=EngineConfig(edge_backend=tiles),
                       result_cache=ResultCache(), device=DEVICE)
    graphs = {"a": kronecker_graph(14, seed=7),
              "b": kronecker_graph(14, seed=8)}
    a = pool.open("a", graphs["a"], n_parts=16)
    b = pool.open("b", graphs["b"], n_parts=16)
    la = a.pg.ensure_edge_layouts(shape_policy=a.shape_policy)
    lb = b.pg.ensure_edge_layouts(shape_policy=b.shape_policy)
    sm.note(f"kron-14 tenants a, b opened in {time.perf_counter() - t:.1f}s:"
            f" shapes {a.shape_key} / {b.shape_key}, tile layouts "
            f"{la.shape_key(tiles)} / {lb.shape_key(tiles)}")
    sm.check(a.shape_key == b.shape_key and
             la.shape_key(tiles) == lb.shape_key(tiles),
             "kron-14 seeds 7 and 8 land in one shape bucket")
    deg = graphs["a"].out_degrees()
    rng = np.random.default_rng(14)
    sources = [int(s) for s in rng.choice(np.nonzero(deg)[0],
                                          SERVE_REQUESTS + 3, replace=False)]
    (qa, _, _) = sr.singles(a, "kron-14 a", "sssp", SSSP(),
                            [{"source": sources[0]}], tiles,
                            use_result_cache=False)
    (qb, _, _) = sr.singles(b, "kron-14 b", "sssp", SSSP(),
                            [{"source": sources[0]}], tiles,
                            use_result_cache=False)
    rc = pool.runner_cache
    sm.check(rc.misses == 1 and rc.hits == 1 and
             qb[0][1].compile_time == 0.0,
             f"tenant b's first query built no runner (runner cache misses "
             f"{rc.misses}, hits {rc.hits})")
    for tenant, res in (("a", qa[0][0]), ("b", qb[0][0])):
        gt = graphs[tenant]
        check_dijkstra(sm, f"kron-14 tenant {tenant}", pool.session(tenant),
                       res, sources[0], gt.src, gt.dst,
                       np.ones(gt.n_edges, np.float32))

    reqs = [{"source": s} for s in sources[:SERVE_REQUESTS]]
    bat = MicroBatcher(pool, BatchPolicy(max_batch=SERVE_MAX_BATCH))
    (futs, n, took) = sr.counted(lambda: [
        bat.submit(SSSP(), p, tenant="a", warm=False) for p in reqs])
    got = [f.result(timeout=600) for f in futs]
    want, alone, _ = sr.singles(a, "kron-14 a", "sssp", SSSP(), reqs, tiles,
                                use_result_cache=False)
    sr.lanes_equal("kron-14 a", f"SSSP through the batcher (max_batch "
                   f"{SERVE_MAX_BATCH})", got, want)
    st = bat.stats
    sm.check(st.launched_batches == SERVE_REQUESTS // SERVE_MAX_BATCH and
             st.batched_requests == SERVE_REQUESTS and st.degraded == 0 and
             all(f.done() for f in futs) and
             n["bsp_spmv"] == alone["bsp_spmv"] > 0,
             f"the batcher launched {st.launched_batches} batches of "
             f"{SERVE_MAX_BATCH} inline, degraded {st.degraded}; "
             f"bsp_spmv {n['bsp_spmv']} launches, the singletons "
             f"{alone['bsp_spmv']}")
    sm.note(f"kron-14 a: {SERVE_REQUESTS} requests through the batcher in "
            f"{took:.4f}s host")
    (fast, n, fast_s) = sr.counted(lambda: bat.submit(
        SSSP(), reqs[0], tenant="a", warm=False))
    sm.check(fast.done() and st.fast_path_hits == 1 and
             fast.result()[1].result_cache_tier == "l1" and
             sum(n.values()) == 0 and
             bool(np.array_equal(fast.result()[0], want[0][0])),
             f"a repeated request is answered on the result-cache fast path "
             f"in {fast_s:.6f}s, with no launch")

    # the pump thread launches from a thread other than the main one
    threads = set()

    def recording(fn):
        def call(*args, **kw):
            threads.add(threading.current_thread().name)
            return fn(*args, **kw)
        return call

    a.query_batch, a.query = recording(a.query_batch), recording(a.query)
    later = [{"source": s} for s in sources[SERVE_REQUESTS:]]
    pump = MicroBatcher(pool, BatchPolicy(max_batch=64, max_delay=0.05))
    try:
        def pumped():
            pump.start()
            fs = [pump.submit(SSSP(), p, tenant="a", warm=False)
                  for p in later]
            return [f.result(timeout=600) for f in fs]
        got, n, _ = sr.counted(pumped)
    finally:
        pump.stop()
        del a.query_batch, a.query
    want, _, _ = sr.singles(a, "kron-14 a", "sssp", SSSP(), later, tiles,
                            use_result_cache=False)
    sr.lanes_equal("kron-14 a", "SSSP through the pump thread", got, want)
    sm.check(threads == {"micro-batcher"} and pump.stats.degraded == 0 and
             n["bsp_spmv"] > 0,
             f"the pump thread launched the batch ({sorted(threads)}; "
             f"{pump.stats.launched_batches} batches, "
             f"{pump.stats.launched_singletons} singletons, bsp_spmv "
             f"{n['bsp_spmv']} launches)")

    dist = torch.from_numpy(want[0][0]).to(DEVICE)[..., None]
    kernel_vs_plain(sm, errs, "kron-14 tenant a's", a, tiles, SSSP(), dist)
    pr, _ = a.query(PageRank(), {"n_vertices": a.pg.n_vertices},
                    use_result_cache=False)
    kernel_vs_plain(sm, errs, "kron-14 tenant a's", a, tiles, PageRank(),
                    torch.from_numpy(pr).to(DEVICE)[..., None])
    stats = pool.stats()
    pool.close_all()
    return dict(runner_cache={k: v for k, v in stats["runner_cache"].items()
                              if k != "by_owner"},
                batcher=dataclasses.asdict(st))


def serving_path(sm: Smoke, log: list, errs: dict, sess, g20) -> dict:
    """Phase 9 (see the module docstring): returns the launches per
    kernel, the timings and the peak device memory."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sr = ServeRunner(sm, log)
    k20 = {}
    if sm.check(sess is not None, "phase 8 left its kron-20 ebv session"):
        t = time.perf_counter()
        k20 = serving_kron20_part(sm, sr, errs, sess, g20)
        sm.note(f"phase 9 kron-20 part: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    pool = serving_pool_part(sm, sr, errs)
    sm.note(f"phase 9 pool part: {time.perf_counter() - t:.1f}s")
    sm.note(f"launches in phase 9's serving runs: {sr.launches}")
    sm.check(all(v > 0 for v in sr.launches.values()),
             "phase 9's serving runs launched both kernels")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    sm.note(f"phase 9: {time.perf_counter() - t0:.1f}s, peak device memory "
            f"{peak} bytes ({peak / 2**30:.2f} GiB)")
    return dict(launches=sr.launches, peak=peak, kron20=k20, pool=pool)


# --------------------------------------------------------------------------- #
# phase 10: the shard_map backend
# --------------------------------------------------------------------------- #
SHARD_S = 2                   # edge shards of phase 10a's lists
SHARD_WORLD = 4               # phase 10b's processes, all on the one card
SHARD_TIMEOUT_S = 600         # phase 10b's ranks are killed past this


def list_vs_plain(pg, lay, backend: str, prog, pl, vals):
    """The kernel of ``backend`` on the device list that
    ``_shard_layout_block`` hands a rank at ``pl`` (its partition, edge
    shard and shard count) for ``prog``, against its plain version on the
    same inputs (min exact; sums within SUM_RTOL of |terms|). ``vals``:
    the rank's [1, v_max, K] values. Returns ``(the kernel's product
    [1, v_max, K], ok, max err)``."""
    from repro_torch.core.engine import (_device_subgraph, _shard_layout_block,
                                         _tile_inputs, _window_inputs)
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    spec, v_max, K = prog.sweep_spec, pg.v_max, vals.shape[-1]
    blk = _shard_layout_block(lay, pg, prog, backend, vals.device, pl)
    if backend == "pallas_tiles":
        tl, td, ts, vv, ndt, plan = _tile_inputs(blk, vals, spec, v_max)
        kw = dict(n_dst_tiles=ndt, semiring=spec.semiring)
        got = bk.bsp_spmv(tl, td, ts, vv, plan=plan, **kw)
        want = bk.bsp_spmv_plain(tl, td, ts, vv, **kw)
        mag = spmv_magnitude(tl, td, ts, vv, ndt, spec.semiring)
    else:
        sg = _device_subgraph(pg, vals.device,
                              block=(pl.part, pl.shard, pl.n_edge))
        msgs, ldst, bwin, nw, plan = _window_inputs(sg, blk, vals, spec,
                                                    v_max)
        kw = dict(n_windows=nw, combiner=spec.combiner)
        got = sk.segment_combine_windowed(msgs, ldst, bwin, plan=plan, **kw)
        want = sk.segment_combine_plain(msgs, ldst, bwin, **kw)
        mag = segment_magnitude(msgs, ldst, bwin, nw, spec.combiner)
    ok, err = compare(got, want, mag)
    return got.reshape(1, -1, K)[:, :v_max], ok, err


def list_values(prog, v_max: int, K: int, dev, seed: int):
    """Seeded [1, v_max, K] values of ``prog``'s dtype for a list check
    (integers below 2**20, floats in [0, 9))."""
    import numpy as np
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    if np.dtype(prog.dtype).kind == "i":
        return torch.randint(0, 1 << 20, (1, v_max, K), generator=gen,
                             device=dev, dtype=torch.int32)
    return torch.rand((1, v_max, K), generator=gen, device=dev) * 9


def shard_lists_path(sm: Smoke, errs: dict, win, tile) -> dict:
    """Phase 10a: each kernel on every (partition, shard) device list of
    the S = 2 edge-sharded geometry of phase 3's kron-20 session (windows)
    and phase 4's grid session (tiles), against its plain version (min
    exact; sums within SUM_RTOL of |terms|), and the shards' products
    reduced (min, or summed) against the partition's unsharded product.
    Returns per graph the geometry's counts and seconds."""
    import types
    import numpy as np
    import torch
    from repro_torch.algos import SSSP, PageRank
    from repro_torch.core.engine import _tile_product, _window_product

    dev = torch.device(DEVICE)
    S = SHARD_S
    out = {}
    for label, sess, backend in (("kron-20", win[0], "pallas_windows"),
                                 (f"grid-{GRID_SIDE}", tile[0],
                                  "pallas_tiles")):
        pg = sess.pg
        P, v_max, Se = pg.n_parts, pg.v_max, pg.e_max // S
        lay = pg.ensure_edge_layouts(shape_policy=sess.shape_policy)
        t = time.perf_counter()
        geom = lay.shard_counts(pg, S)
        geo_s = time.perf_counter() - t
        empty = sum(1 for p in range(P) for s in range(S)
                    if not pg.emask[p, s * Se:(s + 1) * Se].any())
        unit = "n_tiles" if backend == "pallas_tiles" else "n_blocks"
        rec = dict(geometry_s=geo_s, lists=P * S, empty_shards=empty,
                   units_sharded=int(geom[unit].sum()),
                   units_unsharded=int(getattr(lay, unit).sum()),
                   t_loc=geom["t_loc"], b_loc=geom["b_loc"])
        sm.note(f"10a {label}: S={S} geometry in {geo_s:.1f}s, "
                f"{P * S} lists, {empty} without an edge, {unit} "
                f"{rec['units_sharded']} sharded vs "
                f"{rec['units_unsharded']} unsharded")
        full_sgs = sess.device_graph()
        for prog in (SSSP(), PageRank()):
            spec = prog.sweep_spec
            gen = torch.Generator(device=dev).manual_seed(10)
            V = torch.rand((P, v_max, 1), generator=gen, device=dev) * 9
            if backend == "pallas_tiles":
                full = _tile_product(lay.device_tiles(
                    pg, spec.semiring, spec.edge_values, np.float32, dev),
                    V, spec, v_max)
            else:
                full = _window_product(full_sgs, lay.device_windows(dev), V,
                                       spec, v_max)
            ok_k = ok_r = True
            err_k = err_r = 0.0
            t = time.perf_counter()
            for p in range(P):
                parts = []
                for s in range(S):
                    pl = types.SimpleNamespace(part=p, shard=s, n_edge=S)
                    got, ok, err = list_vs_plain(pg, lay, backend, prog, pl,
                                                 V[p:p + 1])
                    ok_k, err_k = ok_k and ok, max(err_k, err)
                    parts.append(got)
                stack = torch.stack(parts)
                red = stack.amin(0) if spec.semiring == "min_plus" \
                    else stack.sum(0)
                # every term is non-negative: |sum| is the sum of |terms|
                ok, err = compare(red, full[p:p + 1],
                                  None if spec.semiring == "min_plus"
                                  else full[p:p + 1].abs())
                ok_r, err_r = ok_r and ok, max(err_r, err)
            torch.cuda.synchronize()
            key = "bsp_spmv" if backend == "pallas_tiles" \
                else "segment_combine"
            errs[key] = max(errs[key], err_k)
            sm.check(ok_k, f"10a {label} {spec.semiring}: {key} equals its "
                           f"plain version on all {P * S} (partition, "
                           f"shard) lists (max err {err_k:.3g})")
            sm.check(ok_r, f"10a {label} {spec.semiring}: the shards' "
                           f"products reduced equal each partition's "
                           f"unsharded product (max err {err_r:.3g}; "
                           f"{time.perf_counter() - t:.1f}s)")
        lay.drop_sharded()
        out[label] = rec
    return out


def shard_queries(g20):
    """Phase 10b's queries: ``(id, graph, mesh, program, source, edge
    backend)``; the SSSP sources are phase 3's."""
    import numpy as np
    deg = g20.out_degrees()
    s0 = int(np.argmax(deg))
    s1 = int(np.random.default_rng(7).choice(np.nonzero(deg)[0]))
    qs = []
    for eb in ("pallas_windows", "coo"):
        qs += [(f"k20p4-sssp_a-{eb}", "kron20_p4", "4", "sssp", s0, eb),
               (f"k20p4-sssp_b-{eb}", "kron20_p4", "4", "sssp", s1, eb),
               (f"k20p4-cc-{eb}", "kron20_p4", "4", "cc", None, eb),
               (f"k20p4-pagerank-{eb}", "kron20_p4", "4", "pagerank", None,
                eb)]
    qs += [("k20p2-sssp_a-pallas_windows", "kron20_p2", "22", "sssp", s0,
            "pallas_windows"),
           ("k20p2-cc-pallas_windows", "kron20_p2", "22", "cc", None,
            "pallas_windows"),
           ("k20p2-pagerank-pallas_windows", "kron20_p2", "22", "pagerank",
            None, "pallas_windows"),
           ("gridp2-cc-pallas_tiles", "grid_p2", "22", "cc", None,
            "pallas_tiles")]
    return qs


def _shard_program(name, source, n_vertices):
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    if name == "sssp":
        return SSSP(), {"source": source}
    if name == "cc":
        return ConnectedComponents(), None
    return PageRank(), {"n_vertices": n_vertices}


def _shard_rank(rank: int, world: int, store: str, work: str, queries,
                device: str) -> None:
    """One phase 10b process: a gloo job over CUDA tensors on the one card.
    Loads the parent's host arrays, runs every query through
    ``repro_torch.core.run`` on its block of the (4,) or (2, 2) mesh, and
    writes its results and a report (launches per query, counted from 0
    just before it; seconds; peak device memory). After each kernel query
    it holds the kernel against its plain version on its own list, the one
    the query ran on: for the query's program and for min_plus (SSSP) and
    plus_times (PageRank), on seeded values."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    t0 = time.perf_counter()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from repro_torch.algos import SSSP, PageRank
    from repro_torch.core import EngineConfig, run
    from repro_torch.core.mesh import placement
    from repro_torch.interop import partitioned_graph_from_arrays
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk
    # the mesh names the rank layout only; the tensors live on the card
    meshes = {"4": (init_device_mesh("cpu", (4,), mesh_dim_names=("sub",)),
                    ("sub",), ()),
              "22": (init_device_mesh("cpu", (2, 2),
                                      mesh_dim_names=("sub", "edge")),
                     ("sub",), ("edge",))}
    t = time.perf_counter()
    pgs = {}
    for key in sorted({q[1] for q in queries}):
        with np.load(os.path.join(work, key + ".npz")) as z:
            pgs[key] = partitioned_graph_from_arrays(dict(z))
    report = dict(rank=rank, start_s=t - t0,
                  load_s=time.perf_counter() - t, queries=[])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec = {}
    for qid, gk, mk, pname, source, eb in queries:
        mesh, sub, edge = meshes[mk]
        pg = pgs[gk]
        prog, params = _shard_program(pname, source, pg.n_vertices)
        cfg = EngineConfig(backend="shard_map", subgraph_axes=sub,
                           edge_axes=edge, edge_backend=eb)
        bk.bsp_spmv.launches = 0
        sk.segment_combine_windowed.launches = 0
        t = time.perf_counter()
        res, st = run(prog, pg, params, cfg, mesh=mesh, device=device)
        if cuda:
            torch.cuda.synchronize()
        host_s = time.perf_counter() - t
        rec[qid + "/res"] = res
        rec[qid + "/counts"] = np.array([st.supersteps, st.total_messages])
        rec[qid + "/sweeps"] = np.array(st.partition_sweeps, np.int64)
        q = dict(query=qid, host_s=host_s, wall_s=st.wall_time,
                 supersteps=st.supersteps, messages=st.total_messages,
                 host_syncs=st.host_syncs, collectives=st.collectives,
                 bsp_spmv=bk.bsp_spmv.launches,
                 segment_combine_windowed=sk.segment_combine_windowed.launches)
        if eb != "coo":
            pl = placement(mesh, sub, edge)
            lay = pg.ensure_edge_layouts()
            specs, checks = set(), []
            for i, cp in enumerate((prog, SSSP(), PageRank())):
                sw = cp.sweep_spec
                key = (sw.semiring, sw.edge_values, str(cp.dtype))
                if key in specs:
                    continue
                specs.add(key)
                vals = list_values(cp, pg.v_max, 1, torch.device(device),
                                   100 * rank + i)
                _, ok, err = list_vs_plain(pg, lay, eb, cp, pl, vals)
                checks.append(dict(semiring=cp.sweep_spec.semiring,
                                   program=type(cp).__name__, ok=ok,
                                   max_err=err))
            q["list_checks"] = checks
        report["queries"].append(q)
    report["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    report["total_s"] = time.perf_counter() - t0
    np.savez(os.path.join(work, f"rank{rank}.npz"), **rec)
    dist.destroy_process_group()
    if rank == 0:
        # the one-process simulator on the card, on the same host graphs
        # (whose layouts the sharded runs built), after the job ended
        from repro_torch.core import run_sim
        t = time.perf_counter()
        ref = {}
        for i, (qid, gk, _, pname, source, eb) in enumerate(queries):
            pg = pgs[gk]
            prog, params = _shard_program(pname, source, pg.n_vertices)
            res, st = run_sim(prog, pg, params,
                              EngineConfig(edge_backend=eb), device=device)
            ref[qid + "/res"] = res
            ref[qid + "/counts"] = np.array([st.supersteps,
                                             st.total_messages])
            ref[qid + "/sweeps"] = np.array(st.partition_sweeps, np.int64)
            report["queries"][i].update(
                run_sim_wall_s=st.wall_time, run_sim_host_syncs=st.host_syncs)
        report["run_sim_s"] = time.perf_counter() - t
        np.savez(os.path.join(work, "run_sim.npz"), **ref)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def shard_ranks_path(sm: Smoke, g20) -> dict:
    """Phase 10b (see the module docstring). Returns the launches per
    kernel over every rank and the per-rank reports."""
    import shutil
    import numpy as np
    import torch
    import torch.multiprocessing as tmp
    from repro_torch.core import partition_and_build
    from repro_torch.graphgen import grid_graph

    t0 = time.perf_counter()
    work = ROOT / "build" / "shard"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t = time.perf_counter()
    pgs = {"kron20_p4": partition_and_build(g20, 4, "cdbh"),
           "kron20_p2": partition_and_build(g20, 2, "cdbh"),
           "grid_p2": partition_and_build(
               grid_graph(GRID_SIDE, weighted=True, seed=9), 2, "range")}
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    for key, pg in pgs.items():
        np.savez(work / f"{key}.npz", **{
            f.name: getattr(pg, f.name) for f in dataclasses.fields(pg)
            if f.name != "edge_layouts" and getattr(pg, f.name) is not None})
    save_s = time.perf_counter() - t
    sm.note(f"10b: kron-20 cdbh P=4 and P=2, grid-{GRID_SIDE} range P=2 "
            f"built in {build_s:.1f}s, host arrays saved for the ranks in "
            f"{save_s:.1f}s (v_max/e_max: " + ", ".join(
                f"{k} {pg.v_max}/{pg.e_max}" for k, pg in pgs.items()) + ")")
    queries = shard_queries(g20)
    pgs = None
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    ctx = tmp.get_context("spawn")
    store = str(work / "store")
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, SHARD_WORLD, store, str(work), queries,
                               DEVICE))
             for r in range(SHARD_WORLD)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + SHARD_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.perf_counter(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    ranks_s = time.perf_counter() - t
    codes = [p.exitcode for p in procs]
    ok = sm.check(codes == [0] * SHARD_WORLD,
                  f"10b: all {SHARD_WORLD} ranks exited 0 (exit codes "
                  f"{codes}; {ranks_s:.1f}s)")
    launches = {"bsp_spmv": 0, "segment_combine_windowed": 0}
    list_err = dict.fromkeys(launches, 0.0)
    reports = []
    if not ok:
        return dict(launches=launches, reports=reports, seconds=ranks_s,
                    list_err=list_err)
    ref = dict(np.load(work / "run_sim.npz"))
    got = []
    for r in range(SHARD_WORLD):
        reports.append(json.loads((work / f"rank{r}.json").read_text()))
        got.append(dict(np.load(work / f"rank{r}.npz")))
        rep = reports[-1]
        if r == 0:
            sm.note(f"10b: rank 0 ran the one-process run_sim references "
                    f"on the card in {rep['run_sim_s']:.1f}s after the job")
        sm.note(f"10b rank {r}: started in {rep['start_s']:.1f}s, loaded the "
                f"parent's host arrays in {rep['load_s']:.1f}s, peak device "
                f"memory {rep['peak_bytes']} bytes "
                f"({rep['peak_bytes'] / 2**30:.2f} GiB), "
                f"{rep['total_s']:.1f}s in all")
    def same(a, b, qa, qb, pagerank):
        """Results bit for bit (PageRank: within PR_RTOL of max |rank|,
        and finite), supersteps, messages and per-partition sweeps equal."""
        x, y = a[qa + "/res"], b[qb + "/res"]
        if pagerank:
            close = (np.isfinite(x).all() and float(np.abs(x - y).max())
                     <= PR_RTOL * float(np.abs(y).max()))
        else:
            close = np.array_equal(x, y)
        return bool(close
                    and np.array_equal(a[qa + "/counts"], b[qb + "/counts"])
                    and np.array_equal(a[qa + "/sweeps"], b[qb + "/sweeps"]))

    for i, (qid, _, _, pname, _, eb) in enumerate(queries):
        steps, msgs = (int(x) for x in ref[qid + "/counts"])
        pr = pname == "pagerank"
        res_what = f"within {PR_RTOL:g} of max |rank|" if pr \
            else "bit for bit"
        bad = [r for r in range(SHARD_WORLD)
               if not same(got[r], ref, qid, qid, pr)]
        sm.check(not bad, f"10b {qid}: all {SHARD_WORLD} ranks equal the "
                          f"one-process run_sim (results {res_what}; "
                          f"supersteps {steps}, messages {msgs} and "
                          f"per-partition sweeps equal; ranks that differ: "
                          f"{bad})")
        twin = qid.replace(eb, "coo")
        if eb != "coo" and twin + "/res" in got[0]:
            bad = [r for r in range(SHARD_WORLD)
                   if not same(got[r], got[r], qid, twin, pr)]
            sm.check(not bad, f"10b {qid}: every rank's run equals its coo "
                              f"twin {twin} (results {res_what}; counts and "
                              f"sweeps equal; ranks that differ: {bad})")
        qs = [rep["queries"][i] for rep in reports]
        used = {"pallas_windows": "segment_combine_windowed",
                "pallas_tiles": "bsp_spmv"}.get(eb)
        if used:
            n = [q[used] for q in qs]
            sm.check(min(n) > 0, f"10b {qid}: {used} launches per rank {n}")
            for c in range(len(qs[0]["list_checks"])):
                cs = [q["list_checks"][c] for q in qs]
                errs_r = [x["max_err"] for x in cs]
                list_err[used] = max(list_err[used], max(errs_r))
                sm.check(all(x["ok"] for x in cs),
                         f"10b {qid}: {used} {cs[0]['semiring']} "
                         f"({cs[0]['program']}) equals its plain version on "
                         f"each rank's own list (max err per rank {errs_r})")
        for k in launches:
            launches[k] += sum(q[k] for q in qs)
        print("shard query " + json.dumps(dict(
            qs[0], wall_s_max=max(x["wall_s"] for x in qs))), flush=True)
    sm.note(f"10b: {time.perf_counter() - t0:.1f}s; launches over every "
            f"rank {launches}")
    return dict(launches=launches, reports=reports, seconds=ranks_s,
                list_err=list_err)


def nccl_path(sm: Smoke) -> dict:
    """Phase 10c: a world of one over NCCL. ``GraphSession(mesh=)`` on
    kron-14 / cdbh / P = 1 against the simulator session, on both kernel
    backends: a query, an insert batch with ``flush``, a warm query.
    Returns the launches of the sharded sessions' queries."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.algos import SSSP
    from repro_torch.core import EngineConfig
    from repro_torch.graphgen import kronecker_graph
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk
    from repro_torch.session import GraphSession

    t0 = time.perf_counter()
    store = ROOT / "build" / "shard" / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    nccl = DEVICE == "cuda"
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    launches = {"bsp_spmv": 0, "segment_combine_windowed": 0}
    try:
        mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("sub",))
        g = kronecker_graph(14, seed=7)
        for eb in ("pallas_windows", "pallas_tiles"):
            cfg = EngineConfig(edge_backend=eb)
            shard = GraphSession.from_graph(g, 1, "cdbh", mesh=mesh, cfg=cfg,
                                            device=DEVICE)
            sim = GraphSession.from_graph(g, 1, "cdbh", cfg=cfg,
                                          device=DEVICE)
            sm.check(shard.cfg.backend == "shard_map"
                     and sim.cfg.backend == "sim",
                     f"10c {eb}: the mesh picks shard_map")
            batch = sym_batch(np.random.default_rng(5), 256, g.n_vertices)
            out = {}
            for name, sess in (("shard", shard), ("sim", sim)):
                rows = []
                for step in ("query", "insert", "warm"):
                    if step == "insert":
                        sess.update(adds=batch)
                        sess.flush()
                    bk.bsp_spmv.launches = 0
                    sk.segment_combine_windowed.launches = 0
                    res, st = sess.query(SSSP(), {"source": 0})
                    if name == "shard":
                        launches["bsp_spmv"] += bk.bsp_spmv.launches
                        launches["segment_combine_windowed"] += \
                            sk.segment_combine_windowed.launches
                    rows.append((res, st))
                out[name] = rows
            for i, step in enumerate(("query", "after the insert", "warm")):
                (a, sa), (b, sb) = out["shard"][i], out["sim"][i]
                sm.check(bool(np.array_equal(a, b))
                         and (sa.supersteps, sa.total_messages) ==
                         (sb.supersteps, sb.total_messages),
                         f"10c {eb} {step}: the NCCL session equals the "
                         f"simulator session ({sa.supersteps} supersteps, "
                         f"{sa.collectives} collectives, wall "
                         f"{sa.wall_time:.4f}s vs {sb.wall_time:.4f}s)")
            sm.check(shard.stats.warm_queries == sim.stats.warm_queries == 2,
                     f"10c {eb}: the queries after the insert ran warm, as "
                     f"the simulator session's did")
    finally:
        dist.destroy_process_group()
    sm.check(all(v > 0 for v in launches.values()),
             f"10c: the NCCL sessions launched both kernels {launches}")
    sm.note(f"10c: {time.perf_counter() - t0:.1f}s")
    return dict(launches=launches)


# --------------------------------------------------------------------------- #
# phase 11: the LM serving path
# --------------------------------------------------------------------------- #
LM_ARCH = "olmo_1b"
LM_PARAMS = 1_176_764_416            # olmo-1b at full width, tied embeddings
LM_BATCH, LM_PROMPT, LM_GEN = 4, 24, 32   # examples/serve_lm.py's defaults
LM_LONG_PROMPT, LM_LONG_GEN = 32768, 16   # prefill_32k's length, batch 1
# 11b's depth: the 32k request's first 4 layers of 16 (371,458,048
# parameters; every 11b check is per layer or against this model's own
# forward, so the cut keeps them all and frees phase 16's time)
LM_LONG_LAYERS = 4
LM_CPU_LAYERS = 2                    # 11c: full width, depth cut to 2
# bf16 logits (|logit| < ~6), cached decode against forward: an H100 at 700 W
# shows at most 0.078 (11a) and 0.105 (11b), a few bf16 ulps of the logit
LM_BF16_ATOL = 0.25
LM_FP32_ATOL = 1e-4    # float32 logits, the card against the CPU: 7.3e-6
BF16_OPS_PER_S = 989e12             # H100 SXM dense bf16 tensor-core rate


def lm_config():
    from repro_torch.configs import get_config
    return get_config(LM_ARCH)


def mlstm_work(cfg, batch: int, new: int, past: int) -> tuple:
    """(bytes, ops) of one mLSTM layer's call beyond its weights, in the
    form ``mlstm_apply`` picks: its projections (wq, wk, wv, og, wo; wi, wf);
    a decode step (``past`` > 0, one token) reads and writes the float32
    ``C`` / ``n`` / ``m`` state and does ~6 B H dh^2 operations; up to 512
    tokens the parallel form multiplies over the causal pairs (qk and the
    scores times v, 4 H dh a pair) and a prefill folds the prompt into the
    state (2 B S H dh^2) and writes it; past 512 the chunkwise form does
    the pairs inside each chunk and ~4 B S H dh^2 for the state carried
    between chunks."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    T = batch * new
    ops = 2 * T * (5 * d * d + 2 * d * H)
    state = batch * H * (dh * dh + dh + 1) * 4
    if past and new == 1:
        return 2 * state, ops + 6 * batch * H * dh * dh
    if new > 512:
        full, rest = divmod(new, 512)
        pairs = batch * (full * 512 * 513 // 2 + rest * (rest + 1) // 2)
        return state, ops + 4 * pairs * H * dh + 4 * T * H * dh * dh
    pairs = batch * new * (new + 1) // 2
    return state, ops + 4 * pairs * H * dh + 2 * T * H * dh * dh


def slstm_work(cfg, mixer, batch: int, new: int, past: int,
               act: int) -> tuple:
    """(bytes, ops) of one sLSTM layer's call beyond reading ``w`` and
    ``r`` once: the loop reads ``r`` once per further step (``new`` steps
    in all); the state (``h`` in the activation dtype, ``c`` / ``n`` /
    ``m`` float32) is written, and read too by a decode step; the
    operations of ``x @ w`` and of every step's ``h @ r``."""
    d = cfg.d_model
    nbytes = (new - 1) * mixer.r.numel() * mixer.r.element_size()
    nbytes += (2 if past else 1) * batch * d * (act + 12)
    return nbytes, 2 * 2 * batch * new * d * 4 * d


def encoder_work(cfg, model, batch: int, act: int) -> tuple:
    """(bytes, ops) of ``_encode`` over ``frontend_len`` frames: the
    frame features read (float32) and the adapter, the encoder's weights
    read once, the memory written; the adapter's, the attention
    projections', the non-causal attention's (every pair) and the MLPs'
    operations."""
    d, L = cfg.d_model, cfg.frontend_len
    F_ = cfg.frontend_dim or d
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_mats = 3 if cfg.act == "swiglu" else 2
    T = batch * L
    nbytes = T * F_ * 4 + T * d * act + sum(
        p.numel() * p.element_size()
        for m in (model.encoder, model.enc_norm) for p in m.parameters())
    nbytes += model.frontend_adapter.numel() * \
        model.frontend_adapter.element_size()
    ops = 2 * T * F_ * d + cfg.n_enc_layers * (
        2 * T * (d * (Hq + 2 * Hkv) * Dh + Hq * Dh * d)
        + 4 * Hq * Dh * batch * L * L + 2 * T * n_mats * d * cfg.d_ff)
    return nbytes, ops


def lm_work(cfg, model, batch: int, new: int, past: int, used=(),
            kept_pairs=(), frontend: bool = False) -> tuple:
    """(bytes, ops) the least a forward of ``new`` tokens per lane over a
    cache holding ``past`` must move and compute: the weights it uses read
    once (each routed expert only where a kept pair goes to it, given as
    ``used`` per MoE layer; the shared expert, the router, attention and
    dense MLPs whole; the embedding rows gathered unless tied; no MTP
    weight), the valid cache read once and the new positions written (MLA:
    its latent ``ckv`` + ``kr``), the last logits written; operations of
    the matmuls (the top-k kept pairs, ``kept_pairs`` per MoE layer, and
    the shared expert) and of attention over the causal pairs, each query
    against the keys at or before it (MLA in the cheaper of its two
    forms: keys and values expanded from the latent for every position,
    or the up-projections absorbed into the query and output). A Mamba
    layer reads its ``conv`` and ``h`` state and writes it (a prefill only
    writes it), in the activation dtype; its operations are the
    projections, the depthwise conv and the scan's ~6 per (token, channel,
    state) element. An mLSTM or sLSTM layer adds ``mlstm_work`` /
    ``slstm_work``. A cross-attention layer reads the encoder's memory and
    projects it to keys and values at every call (2·2·B·L·d·Hkv·Dh), then
    attends over all L positions. With ``frontend`` (a prefill or forward
    that carries the features) the adapter's work is added, and an
    encoder-decoder's ``encoder_work``; a frontend-prefixed model's
    ``new`` counts the prefix."""
    from repro_torch.models.layers import MLA
    from repro_torch.models.moe import MoE
    from repro_torch.models.ssm import MLSTM, SLSTM, Mamba
    d, H, V = cfg.d_model, cfg.n_heads, cfg.vocab
    act = 2 if cfg.activation_dtype == "bfloat16" else 4
    n_mats = 3 if cfg.act == "swiglu" else 2
    T = batch * new
    pairs = batch * (new * past + new * (new + 1) // 2)
    positions = batch * (past + new)
    nbytes = batch * V * act                               # last logits
    ops = 2 * batch * d * V
    emb = model.embed
    nbytes += (emb.numel() if cfg.tie_embeddings
               else T * d) * emb.element_size()
    if not cfg.tie_embeddings:
        nbytes += model.lm_head.numel() * model.lm_head.element_size()
    nbytes += sum(p.numel() * p.element_size()
                  for p in model.final_norm.parameters())
    if frontend and cfg.n_enc_layers:
        eb, eo = encoder_work(cfg, model, batch, act)
        nbytes, ops = nbytes + eb, ops + eo
    elif frontend and cfg.frontend:
        F_, L = cfg.frontend_dim or d, cfg.frontend_len
        nbytes += (batch * L * F_ * 4 + model.frontend_adapter.numel()
                   * model.frontend_adapter.element_size())
        ops += 2 * batch * L * F_ * d
    moe_i = 0
    for blk in model.blocks:
        for name, p in blk.named_parameters():
            if not (isinstance(blk.mlp, MoE) and name in (
                    "mlp.w_gate", "mlp.w_up", "mlp.w_down")):
                nbytes += p.numel() * p.element_size()
        if isinstance(blk.mixer, Mamba):
            mc = cfg.mamba
            di, n, K = int(mc.expand * d), mc.d_state, mc.d_conv
            r = max(d // 16, 1)
            ops += 2 * T * (d * 2 * di + di * (r + 2 * n) + r * di + di * d
                            + K * di) + 6 * T * di * n
            nbytes += (2 if past else 1) * batch * ((K - 1) * di
                                                    + di * n) * act
        elif isinstance(blk.mixer, MLSTM):
            mb, mo = mlstm_work(cfg, batch, new, past)
            nbytes, ops = nbytes + mb, ops + mo
        elif isinstance(blk.mixer, SLSTM):
            sb, so = slstm_work(cfg, blk.mixer, batch, new, past, act)
            nbytes, ops = nbytes + sb, ops + so
        elif isinstance(blk.mixer, MLA):
            m = cfg.mla
            qk, r = m.nope_head_dim + m.rope_head_dim, m.kv_lora_rank
            ops += 2 * T * (d * m.q_lora_rank + m.q_lora_rank * H * qk
                            + d * (r + m.rope_head_dim)
                            + H * m.v_head_dim * d)
            expand = (2 * positions * r * H * (m.nope_head_dim
                                                + m.v_head_dim)
                      + pairs * 2 * H * (qk + m.v_head_dim))
            absorb = (2 * T * H * r * (m.nope_head_dim + m.v_head_dim)
                      + pairs * 2 * H * (r + m.rope_head_dim + r))
            ops += min(expand, absorb)
            nbytes += positions * (r + m.rope_head_dim) * act
        else:
            Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
            ops += 2 * T * (d * (H + 2 * Hkv) * Dh + H * Dh * d)
            ops += 4 * H * Dh * pairs
            nbytes += positions * 2 * Hkv * Dh * act
        if blk.cross is not None:
            Hkv, Dh, L = cfg.n_kv_heads, cfg.head_dim, cfg.frontend_len
            ops += (2 * 2 * T * d * H * Dh + 2 * 2 * batch * L * d * Hkv
                    * Dh + 4 * H * Dh * T * L)
            nbytes += batch * L * d * act
        if isinstance(blk.mlp, MoE):
            mc = cfg.moe
            d_ffe = mc.d_ff_expert or cfg.d_ff
            per_expert = 3 * d * d_ffe
            nbytes += used[moe_i] * per_expert * blk.mlp.w_gate.element_size()
            ops += (2 * T * d * mc.n_experts + 2 * kept_pairs[moe_i]
                    * per_expert + 2 * T * mc.n_shared * per_expert)
            moe_i += 1
        elif blk.mlp is not None:
            ops += 2 * T * n_mats * d * cfg.d_ff
    return nbytes, ops


def lm_bound_ms(nbytes: int, ops: int, ops_rate: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lm_sync():
    import torch
    if str(DEVICE).startswith("cuda"):
        torch.cuda.synchronize()


def lm_offset(cfg) -> int:
    """Positions a frontend-prefixed (decoder-only) model puts before the
    prompt: its ``frontend_len``; 0 otherwise."""
    return cfg.frontend_len if cfg.frontend and not cfg.n_enc_layers else 0


def lm_replay(M, model, cfg, prompts, toks, max_len, extra=None,
              memory=None):
    """Logits [B, n, V] of ``prefill`` on ``prompts`` (and the ``extra``
    batch entries: frontend features) and of each ``decode_step`` fed
    ``toks[:, :n-1]`` (the serve loop's own inputs; ``memory`` for an
    encoder-decoder)."""
    import torch
    lg, caches = M.prefill(model, {"tokens": prompts, **(extra or {})}, cfg,
                           max_len)
    out = [lg]
    for i in range(toks.shape[1] - 1):
        db = {"tokens": toks[:, i:i + 1]}
        if memory is not None:
            db["memory"] = memory
        lg, caches = M.decode_step(model, caches, db, cfg)
        out.append(lg)
    return torch.cat(out, dim=1)


def lm_serve_timed(S, model, cfg, prompts, gen: int, extra=None,
                   memory=None):
    """serve_lm's loop through the step builders: (tokens [B, gen],
    prefill seconds, decode seconds, the cache after the last step).
    ``extra`` joins the prompt batch (frontend features; the cache then
    holds ``lm_offset`` more positions); ``memory`` joins every decode
    step's."""
    import torch
    prefill = S.make_prefill_step(cfg, prompts.shape[1] + gen
                                  + lm_offset(cfg))
    step = S.make_serve_step(cfg)
    lm_sync()
    t0 = time.perf_counter()
    nxt, caches = prefill(model, {"tokens": prompts, **(extra or {})})
    lm_sync()
    t1 = time.perf_counter()
    out = [nxt]
    for _ in range(gen - 1):
        db = {"tokens": nxt[:, None]}
        if memory is not None:
            db["memory"] = memory
        nxt, caches = step(model, caches, db)
        out.append(nxt)
    lm_sync()
    return (torch.stack(out, dim=1), t1 - t0, time.perf_counter() - t1,
            caches)


def lm_check_greedy(sm: Smoke, label: str, toks, steps, full, atol: float):
    """The cached steps' logits ``steps`` against ``full`` (the forward's
    logits at the same positions) within ``atol``, and the greedy tokens
    against the forward's argmax. A token may differ from that argmax only
    where its forward logit lies within twice its row's decode-vs-forward
    error of the largest: a tie at the logits' bf16 resolution, which the
    decode may break either way."""
    import torch
    s, f = steps.float(), full.float()
    row_err = (s - f).abs().amax(-1)
    err = float(row_err.max())
    sm.check(bool(torch.isfinite(s).all() and torch.isfinite(f).all()),
             f"{label}: logits finite")
    sm.check(err <= atol, f"{label}: every cached step's logits within "
             f"{atol} of forward over the same prefix (max abs err {err:.6g}"
             f", |logits| <= {float(f.abs().max()):.4g})")
    sm.check(torch.equal(s.argmax(-1), toks.long()),
             f"{label}: the serve loop's tokens are the argmax of its own "
             f"steps' logits")
    top = f.topk(2, dim=-1).values
    picked = f.gather(-1, toks.long()[..., None])[..., 0]
    same = f.argmax(-1) == toks.long()
    near = (top[..., 0] - top[..., 1]) <= 2 * row_err
    n_diff = int((~same).sum())
    sm.check(bool((same | (top[..., 0] - picked <= 2 * row_err)).all()),
             f"{label}: greedy tokens equal the forward's argmax at "
             f"{int(same.sum())} of {same.numel()} positions; the "
             f"{n_diff} others are near-ties (their forward logit within "
             f"twice the row's error of the largest; {int(near.sum())} "
             f"positions have a forward top-2 gap that small)")
    return dict(max_abs_err=err, tokens=same.numel(), argmax_equal=int(
        same.sum()), near_ties=int(near.sum()))


def lm_floor(M, model, cfg, batch: dict, full, start: int) -> float:
    """How far ``forward`` on ``batch`` moves when the input of the first
    decoder block moves by one ulp of its dtype (``x * (1 + eps)``): the
    max abs change of its logits from ``start`` on, against ``full``
    (the unmoved forward's logits from ``start``)."""
    import torch

    def kick(mod, args):
        return (args[0] * (1 + torch.finfo(args[0].dtype).eps),) + args[1:]

    hook = model.blocks[0].register_forward_pre_hook(kick)
    try:
        with torch.no_grad():
            moved, _ = M.forward(model, batch, cfg)
    finally:
        hook.remove()
    return float((moved[:, start:].float() - full.float()).abs().max())


LM_PROFILE_STEPS = 4                # 11a profiles prefill + 3 decode steps


def lm_profile(fn) -> dict:
    """``fn`` once under ``torch.profiler``: the device's busy time (the
    union of its kernel and copy spans), its idle share of the host's wall
    time around the call (the profiler slows the host, so the share is an
    upper bound) and the ops whose kernels took most of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm_sync()
        t0 = time.perf_counter()
        fn()
        lm_sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return dict(wall_ms=wall_us / 1e3, device_busy_ms=None,
                    idle_share=None, kernels=0, top=[])
    busy, end = 0.0, -float("inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                idle_share=max(0.0, 1 - busy / wall_us), kernels=len(spans),
                top=[dict(op=e.key, ms=e.self_device_time_total / 1e3,
                          count=e.count) for e in ops])


def lm_note_profile(sm: Smoke, label: str, prof: dict) -> None:
    if prof["device_busy_ms"] is None:
        sm.note(f"{label}: the profiler recorded no device time (idle share"
                f" not measured)")
        return
    sm.note(f"{label}: {prof['kernels']} device spans, busy "
            f"{prof['device_busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
            f"wall (idle share <= {prof['idle_share']:.4f}); device time by "
            f"op: " + "; ".join(f"{t['op']} {t['ms']:.3f} ms x{t['count']}"
                                for t in prof["top"]))


def lm_serve_part(sm: Smoke, M, S, model, cfg, ident) -> dict:
    """11a: serve_lm's defaults through the step builders, timed; then the
    same inputs replayed through ``prefill`` / ``decode_step`` for their
    logits, held against ``forward`` over the prompt and the tokens."""
    import torch
    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    max_len = P + G
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                            device=DEVICE)
    lm_serve_timed(S, model, cfg, prompts, G)     # warm-up: cuBLAS plans
    torch.cuda.reset_peak_memory_stats()
    toks, prefill_s, decode_s, _ = lm_serve_timed(S, model, cfg, prompts, G)
    peak = torch.cuda.max_memory_allocated()
    sm.check(toks.shape == (B, G) and bool(((toks >= 0)
                                             & (toks < cfg.vocab)).all()),
             f"11a: {B}x{G} greedy tokens in range")
    steps = lm_replay(M, model, cfg, prompts, toks, max_len)
    n = LM_PROFILE_STEPS
    prof = lm_profile(lambda: lm_replay(M, model, cfg, prompts, toks[:, :n],
                                        max_len))
    lm_note_profile(sm, f"11a profile (prefill and {n - 1} decode steps of "
                    f"the serve loop)", prof)
    with torch.no_grad():
        full, _ = M.forward(model, {"tokens": torch.cat(
            [prompts, toks[:, :-1].long()], dim=1)}, cfg)
    sm.check(full.dtype == steps.dtype == torch.bfloat16,
             f"11a: logits in {full.dtype} (bf16 activations)")
    chk = lm_check_greedy(sm, "11a", toks, steps, full[:, P - 1:],
                          LM_BF16_ATOL)
    pb, po = lm_work(cfg, model, B, P, 0)
    p_bound, p_by = lm_bound_ms(pb, po, BF16_OPS_PER_S)
    d_bound = 0.0
    for i in range(G - 1):
        db, do = lm_work(cfg, model, B, 1, P + i)
        d_bound += lm_bound_ms(db, do, BF16_OPS_PER_S)[0]
    d_ms = decode_s * 1e3 / (G - 1)
    rec = dict(batch=B, prompt=P, gen=G, prefill_ms=prefill_s * 1e3,
               prefill_bound_ms=p_bound, prefill_bound_by=p_by,
               decode_step_ms=d_ms, decode_step_bound_ms=d_bound / (G - 1),
               decode_tokens_per_s=B * (G - 1) / decode_s,
               decode_bound_tokens_per_s=B * (G - 1) / (d_bound / 1e3),
               peak_bytes=peak, profile=prof, **chk)
    sm.note(f"11a ({ident}): prefill {B}x{P} {rec['prefill_ms']:.3f} ms "
            f"(bound {p_bound:.4f} ms, {p_by}); decode {d_ms:.4f} ms/step "
            f"(bound {rec['decode_step_bound_ms']:.4f} ms), "
            f"{rec['decode_tokens_per_s']:.1f} tok/s (bound "
            f"{rec['decode_bound_tokens_per_s']:.1f}); peak {peak} bytes "
            f"({peak / 2**30:.2f} GiB)")
    return rec


def lm_blockwise_check(sm: Smoke, cfg) -> dict:
    """11b, first: ``_sdpa_blockwise`` against ``_sdpa_dense`` on the card
    at the long prompt's geometry (the prompt's last 512 queries over a
    cache of prompt + gen positions, valid up to the prompt), float32 with
    TF32 off, within the reference tests' 2e-5."""
    import torch
    from repro_torch.models.layers import _sdpa_blockwise, _sdpa_dense
    S_ = LM_LONG_PROMPT + LM_LONG_GEN
    Tq = 512
    g = torch.Generator(device=DEVICE).manual_seed(3)
    q = torch.randn((1, Tq, cfg.n_heads, cfg.head_dim), generator=g,
                    device=DEVICE)
    k, v = (torch.randn((1, S_, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=DEVICE) for _ in range(2))
    kw = dict(causal=True, q_offset=LM_LONG_PROMPT - Tq,
              kv_len_valid=LM_LONG_PROMPT)
    err = float((_sdpa_blockwise(q, k, v, **kw)
                 - _sdpa_dense(q, k, v, **kw)).abs().max())
    sm.check(err <= 2e-5, f"11b: blockwise attention equals dense at "
             f"S = {S_} (last {Tq} queries, float32; max abs err {err:.3g})")
    return dict(blockwise_vs_dense_err=err)


def lm_attention_profile(sm: Smoke, cfg) -> dict:
    """One layer's prefill attention at the long prompt's shape (bf16 q
    [1, 32768, H, Dh] over a 32,784-position cache valid up to the prompt,
    the blockwise path): its wall time, then once under the profiler."""
    import torch
    from repro_torch.models.layers import _sdpa
    S_ = LM_LONG_PROMPT + LM_LONG_GEN
    g = torch.Generator(device=DEVICE).manual_seed(5)
    q = torch.randn((1, LM_LONG_PROMPT, cfg.n_heads, cfg.head_dim),
                    generator=g, device=DEVICE).to(torch.bfloat16)
    k, v = (torch.randn((1, S_, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=DEVICE).to(torch.bfloat16) for _ in range(2))

    def attend():
        return _sdpa(q, k, v, causal=True, q_offset=0,
                     kv_len_valid=LM_LONG_PROMPT)

    attend()
    lm_sync()
    t0 = time.perf_counter()
    attend()
    lm_sync()
    ms = (time.perf_counter() - t0) * 1e3
    prof = lm_profile(attend)
    lm_note_profile(sm, "11b profile (one layer's attention over the "
                    "32,768-token prompt)", prof)
    sm.note(f"11b: one layer's attention {ms:.1f} ms unprofiled; x "
            f"{cfg.n_layers} layers = {ms * cfg.n_layers:.1f} ms")
    return dict(attention_layer_ms=ms, attention_profile=prof)


def lm_long_part(sm: Smoke, M, model, cfg, ident) -> dict:
    """11b: one long request, a 32,768-token prompt at batch 1 and 16
    greedy steps through ``prefill`` / ``decode_step`` (timed), held
    against ``forward`` over the same 32,783 tokens."""
    import torch
    P, G = LM_LONG_PROMPT, LM_LONG_GEN
    rec = lm_blockwise_check(sm, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (1, P), generator=gen,
                           device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    lm_sync()
    t0 = time.perf_counter()
    lg, caches = M.prefill(model, {"tokens": prompt}, cfg, P + G)
    nxt = lg[:, -1].argmax(-1)
    lm_sync()
    t1 = time.perf_counter()
    out, logits = [nxt], [lg]
    for _ in range(G - 1):
        lg, caches = M.decode_step(model, caches, {"tokens": nxt[:, None]},
                                   cfg)
        nxt = lg[:, -1].argmax(-1)
        out.append(nxt)
        logits.append(lg)
    lm_sync()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    sm.check(caches[0]["idx"] == P + G - 1,
             f"11b: the cache holds {P + G - 1} positions")
    toks = torch.stack(out, dim=1)
    steps = torch.cat(logits, dim=1)
    del caches
    with torch.no_grad():
        full, _ = M.forward(model, {"tokens": torch.cat(
            [prompt, toks[:, :-1]], dim=1)}, cfg)
        full = full[:, P - 1:].clone()
    lm_sync()
    t3 = time.perf_counter()
    rec.update(lm_attention_profile(sm, cfg))
    rec.update(lm_check_greedy(sm, "11b", toks, steps, full, LM_BF16_ATOL))
    pb, po = lm_work(cfg, model, 1, P, 0)
    p_bound, p_by = lm_bound_ms(pb, po, BF16_OPS_PER_S)
    d_bound = sum(lm_bound_ms(*lm_work(cfg, model, 1, 1, P + i),
                              BF16_OPS_PER_S)[0] for i in range(G - 1))
    rec.update(prompt=P, gen=G, prefill_ms=(t1 - t0) * 1e3,
               prefill_bound_ms=p_bound, prefill_bound_by=p_by,
               decode_step_ms=(t2 - t1) * 1e3 / (G - 1),
               decode_step_bound_ms=d_bound / (G - 1),
               decode_tokens_per_s=(G - 1) / (t2 - t1),
               forward_ms=(t3 - t2) * 1e3, peak_bytes=peak)
    sm.note(f"11b ({ident}): prefill 1x{P} {rec['prefill_ms']:.1f} ms "
            f"(bound {p_bound:.3f} ms, {p_by}); decode "
            f"{rec['decode_step_ms']:.4f} ms/step at {P}+ positions (bound "
            f"{rec['decode_step_bound_ms']:.4f} ms), "
            f"{rec['decode_tokens_per_s']:.1f} tok/s; forward over "
            f"{P + G - 1} tokens {rec['forward_ms']:.1f} ms; "
            f"peak {peak} "
            f"bytes ({peak / 2**30:.2f} GiB)")
    return rec


def lm_cpu_part(sm: Smoke, M, S, cfg) -> dict:
    """11c: the full-width model cut to 2 layers with float32 activations,
    the card against the same weights on the CPU (``lm_cpu_compare``):
    forward logits within LM_FP32_ATOL, and a greedy serve loop's tokens
    equal."""
    return lm_cpu_compare(sm, M, S, "11c", dataclasses.replace(
        cfg, n_layers=LM_CPU_LAYERS, activation_dtype="float32"))


def lm_path(sm: Smoke, ident: str) -> dict:
    """Phase 11: olmo-1b at full width and depth with the port's seeded
    weights (fp32 parameters, bf16 activations); 11b on its first
    LM_LONG_LAYERS layers."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import steps as S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = lm_config()
    model = M.init_model(cfg, seed=0, device=DEVICE)
    lm_sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    sm.check(cfg.name != "olmo-1b" or n_params == LM_PARAMS,
             f"11: {cfg.name}, {cfg.n_layers} layers, {n_params} parameters "
             f"({param_bytes} bytes, {cfg.param_dtype}), drawn in "
             f"{init_s:.2f}s")
    serve = lm_serve_part(sm, M, S, model, cfg, ident)
    del model.blocks[LM_LONG_LAYERS:]
    gc.collect()
    torch.cuda.empty_cache()
    long = lm_long_part(sm, M, model, dataclasses.replace(
        cfg, n_layers=LM_LONG_LAYERS), ident)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cpu = lm_cpu_part(sm, M, S, cfg)
    sm.note(f"phase 11: {time.perf_counter() - t0:.1f}s")
    return dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
                param_bytes=param_bytes, init_s=init_s, serve=serve,
                long=long, cpu=cpu, seconds=time.perf_counter() - t0)


# --------------------------------------------------------------------------- #
# phase 12: the MoE family on the LM serving path
# --------------------------------------------------------------------------- #
# (label, arch, the depth cut); full width, seeded bf16 weights
# depths: phi3.5-MoE 8 of 32 layers (10,665,205,888 parameters, 19.87 GiB;
# 28 fit the card, 8 free phase 16's time and keep every check), DeepSeek-V3
# 5 of 61 (3 dense, 2 MoE) plus MTP
MOE_CELLS = (("12a", "phi35_moe_42b", 8), ("12b", "deepseek_v3_671b", 5))
MOE_CPU_LAYERS = 2                   # 12c: full width, depth cut to 2
MOE_CPU_EXPERTS = 16                 # 12c DeepSeek: routed experts 256 -> 16
MOE_PROFILE_STEPS = 4                # decode steps under torch.profiler


class MoeTap:
    """Forward hooks on a model's MoE modules. While ``on``, each call
    records the layer's stats (``dropped``, ``load``) and its router's
    picks, selection scores and top-k margin (the k-th score less the
    (k+1)-th), recomputed from the layer's input by ``moe._route``."""

    def __init__(self, model):
        from repro_torch.models.moe import MoE
        self.on, self.calls = False, []
        self.handles = [blk.mlp.register_forward_hook(self._hook(i))
                        for i, blk in enumerate(model.blocks)
                        if isinstance(blk.mlp, MoE)]
        self.n_layers = len(self.handles)

    def _hook(self, layer):
        def hook(mod, args, out):
            if not self.on:
                return
            from repro_torch.models.layers import _cast_params
            from repro_torch.models.moe import _route
            x, dtype = args[0], args[1] if len(args) > 1 else None
            k = mod.cfg.moe.top_k
            sel, idx, _ = _route(_cast_params(mod, dtype),
                                    x.reshape(-1, x.shape[-1]), mod.cfg.moe)
            top = sel.topk(k + 1, dim=-1).values
            self.calls.append(dict(
                layer=layer, pairs=idx.numel(), dropped=out[1]["dropped"],
                load=out[1]["load"], idx=idx, sel=sel,
                margin=top[:, k - 1] - top[:, k]))
        return hook

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls

    def close(self) -> None:
        for h in self.handles:
            h.remove()


def moe_dropped_pairs(call) -> int:
    return round(float(call["dropped"]) * call["pairs"])


def moe_flips(a: list, b: list, rows: int) -> dict:
    """Compare two runs' router calls layer by layer (same tokens): the
    tokens whose picked sets of experts differ (an order swap within the
    top k changes no output), whether each is a near-tie (the margin of
    either run within twice the largest difference of that token's
    selection scores between the runs), the batch rows they lie in, and
    whether every layer dropped the same number of pairs."""
    import torch
    flips, ties, bad_rows = 0, 0, set()
    for ca, cb in zip(a, b):
        diff = (ca["idx"].sort(-1).values
                != cb["idx"].sort(-1).values).any(-1)
        if not bool(diff.any()):
            continue
        eps = (ca["sel"] - cb["sel"]).abs().amax(-1)
        near = torch.minimum(ca["margin"], cb["margin"]) <= 2 * eps
        flips += int(diff.sum())
        ties += int((diff & near).sum())
        per_row = ca["idx"].shape[0] // rows
        bad_rows.update(int(t) // per_row
                        for t in torch.nonzero(diff).flatten())
    same_drops = all(moe_dropped_pairs(ca) == moe_dropped_pairs(cb)
                     for ca, cb in zip(a, b))
    return dict(flips=flips, near_ties=ties, rows=sorted(bad_rows),
                same_drops=same_drops)


def moe_bound(cfg, model, calls: list, batch: int, new: int,
              past: int) -> tuple:
    """``lm_bound_ms`` of ``lm_work`` with this call's routing (``calls``:
    one tap record per MoE layer)."""
    used = [int((c["load"] > 0).sum()) for c in calls]
    kept = [c["pairs"] - moe_dropped_pairs(c) for c in calls]
    return lm_bound_ms(*lm_work(cfg, model, batch, new, past, used, kept),
                       BF16_OPS_PER_S)


def moe_build(sm: Smoke, M, label: str, cfg):
    """``cfg``'s model on the card with seeded weights: (model, seconds
    to draw them). Its size is printed and its routers must be float32."""
    import torch
    t0 = time.perf_counter()
    model = M.init_model(cfg, seed=0, device=DEVICE)
    lm_sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    sm.check(all(blk.mlp.router.dtype == torch.float32
                 for blk in model.blocks if hasattr(blk.mlp, "router")),
             f"{label}: {cfg.name} cut to {cfg.n_layers} layers, {n_params} "
             f"parameters ({param_bytes} bytes, {param_bytes / 2**30:.2f} "
             f"GiB, {cfg.param_dtype}; routers float32), drawn in "
             f"{init_s:.2f}s; {torch.cuda.memory_allocated() / 2**30:.2f} "
             f"GiB allocated")
    return model, init_s


def moe_serve_part(sm: Smoke, M, S, label: str, cfg, model, init_s: float,
                   ident: str) -> dict:
    """12a / 12b / 13a: ``model`` (``cfg`` at full width with its depth
    cut, seeded bf16 weights): serve_lm's defaults through the step
    builders (timed after a warm-up), a replay through ``prefill`` /
    ``decode_step`` with the MoE layers tapped, the prefill's last logits
    against ``forward`` over the same prompt, 4 decode steps under the
    profiler."""
    import torch
    layers = cfg.n_layers
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    tap = MoeTap(model)
    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    max_len = P + G
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                            device=DEVICE)
    lm_serve_timed(S, model, cfg, prompts, G)     # warm-up: cuBLAS plans
    torch.cuda.reset_peak_memory_stats()
    toks, prefill_s, decode_s, caches = lm_serve_timed(S, model, cfg,
                                                       prompts, G)
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c.values() if isinstance(t, torch.Tensor))
    del caches
    sm.check(toks.shape == (B, G) and bool(((toks >= 0)
                                             & (toks < cfg.vocab)).all()),
             f"{label}: {B}x{G} greedy tokens in range")

    tap.on = True
    steps = lm_replay(M, model, cfg, prompts, toks, max_len)
    calls = tap.take()
    L = tap.n_layers
    pre, dec = calls[:L], [calls[L + i * L:L + (i + 1) * L]
                           for i in range(G - 1)]
    with torch.no_grad():
        full, aux = M.forward(model, {"tokens": prompts}, cfg)
    fwd = tap.take()
    tap.on = False
    sm.check(bool(torch.isfinite(steps.float()).all()
                  and torch.isfinite(full.float()).all()),
             f"{label}: logits finite")
    sm.check(torch.equal(steps.float().argmax(-1), toks.long()),
             f"{label}: the replay through prefill / decode_step reproduces "
             f"the served tokens (argmax of its logits)")
    dec_drops = [moe_dropped_pairs(c) for s_ in dec for c in s_]
    sm.check(len(dec) == G - 1 and all(len(s_) == L for s_ in dec)
             and max(dec_drops) == 0,
             f"{label}: no decode step drops a pair ({G - 1} steps x {L} MoE "
             f"layers, {dec[0][0]['pairs']} pairs a layer)")
    pre_drop = [moe_dropped_pairs(c) / c["pairs"] for c in pre]
    sm.note(f"{label}: prefill drop share by MoE layer "
            + ", ".join(f"{x:.4f}" for x in pre_drop)
            + f"; forward moe_dropped {float(aux['moe_dropped']):.6g}")
    for c in pre:
        ld = c["load"].float()
        sm.note(f"{label}: prefill layer {c['layer']} expert load: "
                + (", ".join(f"{x:.4f}" for x in ld.tolist())
                   if ld.numel() <= 16 else
                   f"{int((ld > 0).sum())} of {ld.numel()} experts hit, "
                   f"max {float(ld.max()):.4f}, min nonzero "
                   f"{float(ld[ld > 0].min()):.4f} (uniform "
                   f"{1 / ld.numel():.4f})"))
    fl = moe_flips(pre, fwd, B)
    err_rows = (steps[:, 0].float() - full[:, -1].float()).abs().amax(-1)
    exempt = set(fl["rows"]) if fl["same_drops"] else set(range(B))
    held = [b for b in range(B) if b not in exempt]
    err = float(err_rows[held].max()) if held else float("nan")
    sm.check(fl["flips"] == fl["near_ties"] and bool(held)
             and err <= LM_BF16_ATOL,
             f"{label}: prefill's last logits against forward on the same "
             f"prompt, max abs err {err:.6g} <= {LM_BF16_ATOL} over rows "
             f"{held} (|logits| <= {float(full.float().abs().max()):.4g}); "
             f"router picks differ at {fl['flips']} token-layers, "
             f"{fl['near_ties']} of them near-ties (rows {fl['rows']}, "
             f"same drops per layer: {fl['same_drops']})")
    rec = dict(arch=cfg.name, layers=layers, params=n_params,
               param_bytes=param_bytes, init_s=init_s, batch=B, prompt=P,
               gen=G, prefill_drop_share=pre_drop,
               prefill_vs_forward_err=err, router_flips=fl)
    if cfg.mtp_depth:
        seq = torch.cat([prompts, toks[:, :1].long()], dim=1)
        with torch.no_grad():
            _, aux2 = M.forward(model, {"tokens": seq[:, :-1]}, cfg)
            mtp = M.mtp_logits(model, aux2["mtp_hidden"],
                               model.embed[seq[:, 1:]], cfg)
        sm.check(mtp.shape == (B, P, cfg.vocab)
                 and bool(torch.isfinite(mtp.float()).all()),
                 f"{label}: mtp_logits on forward's mtp_hidden, shape "
                 f"{tuple(mtp.shape)}, finite")
        m = cfg.mla
        gqa = (B * max_len * cfg.n_layers * cfg.n_heads
               * (m.nope_head_dim + m.rope_head_dim + m.v_head_dim) * 2)
        sm.note(f"{label}: MLA cache {cache_bytes} bytes for {B}x{max_len} "
                f"positions x {cfg.n_layers} layers (kv_lora {m.kv_lora_rank}"
                f" + rope {m.rope_head_dim} a position); keys and values of "
                f"the same {cfg.n_heads} heads would take {gqa} bytes "
                f"({gqa / cache_bytes:.1f}x)")
        rec.update(mla_cache_bytes=cache_bytes, gqa_cache_bytes=gqa)
        del mtp, aux2
    del full, aux, steps

    # 4 decode steps after a prefill, profiled
    step = S.make_serve_step(cfg)
    nxt, caches = S.make_prefill_step(cfg, max_len)(model,
                                                    {"tokens": prompts})

    def decode_some():
        nonlocal nxt, caches
        for _ in range(MOE_PROFILE_STEPS):
            nxt, caches = step(model, caches, {"tokens": nxt[:, None]})

    prof = lm_profile(decode_some)
    lm_note_profile(sm, f"{label} profile ({MOE_PROFILE_STEPS} decode steps)",
                    prof)
    del caches
    p_bound, p_by = moe_bound(cfg, model, pre, B, P, 0)
    d_bounds = [moe_bound(cfg, model, s_, B, 1, P + i)[0]
                for i, s_ in enumerate(dec)]
    d_bound = sum(d_bounds) / len(d_bounds)
    d_ms = decode_s * 1e3 / (G - 1)
    rec.update(prefill_ms=prefill_s * 1e3, prefill_bound_ms=p_bound,
               prefill_bound_by=p_by, decode_step_ms=d_ms,
               decode_step_bound_ms=d_bound,
               decode_tokens_per_s=B * (G - 1) / decode_s,
               decode_bound_tokens_per_s=B / (d_bound / 1e3),
               peak_bytes=peak, cache_bytes=cache_bytes, profile=prof,
               experts_used_decode=[[int((c["load"] > 0).sum())
                                     for c in s_] for s_ in dec[:4]])
    sm.note(f"{label} ({ident}): prefill {B}x{P} {rec['prefill_ms']:.3f} ms "
            f"(bound {p_bound:.4f} ms, {p_by}); decode {d_ms:.4f} ms/step "
            f"(bound {d_bound:.4f} ms), {rec['decode_tokens_per_s']:.1f} "
            f"tok/s (bound {rec['decode_bound_tokens_per_s']:.1f}); peak "
            f"{peak} bytes ({peak / 2**30:.2f} GiB; weights {param_bytes}, "
            f"cache {cache_bytes})")
    tap.close()
    return rec


def moe_cpu_config(arch: str):
    """12c's cut: 2 layers, float32 parameters and activations; DeepSeek
    keeps 1 dense layer and 16 of its 256 routed experts."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cut = dict(n_layers=MOE_CPU_LAYERS, param_dtype="float32",
               activation_dtype="float32")
    if cfg.first_k_dense:
        cut.update(first_k_dense=1, moe=dataclasses.replace(
            cfg.moe, n_experts=MOE_CPU_EXPERTS))
    return dataclasses.replace(cfg, **cut)


def moe_cpu_part(sm: Smoke, M, S, label: str, cfg):
    """12c / 13c: ``cfg`` (float32) on the card against the CPU on the same
    weights: forward logits within LM_FP32_ATOL, ``moe_dropped`` equal,
    the router picks equal (or differing at near-ties, counted), 8 greedy
    tokens of a prefill and a decode loop equal, and every Mamba cache
    after the prefill within LM_FP32_ATOL. Returns (record, the card's
    model, the tokens)."""
    import torch
    card = M.init_model(cfg, seed=4, device=DEVICE)
    cpu = M.Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    taps = [MoeTap(card), MoeTap(cpu)]
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    out = []
    for model, dev, tap in ((card, DEVICE, taps[0]), (cpu, "cpu", taps[1])):
        tap.on = True
        with torch.no_grad():
            lg, aux = M.forward(model, {"tokens": toks.to(dev)}, cfg)
        tap.on = False
        out.append((lg.cpu(), float(aux["moe_dropped"]),
                    [{k: v.cpu() if isinstance(v, torch.Tensor) else v
                      for k, v in c.items()} for c in tap.take()]))
    err = float((out[0][0] - out[1][0]).abs().max())
    fl = moe_flips(out[0][2], out[1][2], 2)
    sm.check(err <= LM_FP32_ATOL, f"{label}: {cfg.n_layers}-layer "
             f"full-width float32 forward ({cfg.moe.n_experts} experts), "
             f"card vs CPU, max abs err {err:.3g} <= {LM_FP32_ATOL} "
             f"(|logits| <= {float(out[1][0].abs().max()):.4g})")
    sm.check(fl["flips"] == fl["near_ties"]
             and (out[0][1] == out[1][1] or fl["flips"] > 0),
             f"{label}: moe_dropped {out[0][1]:.6g} on the card, "
             f"{out[1][1]:.6g} on the CPU; router picks differ at "
             f"{fl['flips']} token-layers, {fl['near_ties']} of them "
             f"near-ties")
    outs, states = [], []
    for model, dev in ((card, DEVICE), (cpu, "cpu")):
        nxt, caches = S.make_prefill_step(cfg, 24)(
            model, {"tokens": toks[:, :16].to(dev)})
        states.append([{k: c[k].cpu() for k in ("conv", "h")}
                       for c in mamba_caches(cfg, caches)])
        got = [nxt.cpu()]
        for _ in range(7):
            nxt, caches = S.make_serve_step(cfg)(model, caches,
                                                 {"tokens": nxt[:, None]})
            got.append(nxt.cpu())
        outs.append(torch.stack(got, dim=1))
    sm.check(torch.equal(outs[0], outs[1]),
             f"{label}: 8 greedy tokens of 2 prompts, card equal to CPU")
    rec = dict(arch=cfg.name, layers=cfg.n_layers,
               experts=cfg.moe.n_experts, forward_max_abs_err=err,
               moe_dropped=[out[0][1], out[1][1]], router_flips=fl)
    if states[0]:
        cache_err = max(float((a[k] - b[k]).abs().max())
                        for a, b in zip(*states) for k in a)
        sm.check(cache_err <= LM_FP32_ATOL,
                 f"{label}: the {len(states[0])} Mamba caches after the "
                 f"prefill, card vs CPU, max abs err {cache_err:.3g} <= "
                 f"{LM_FP32_ATOL}")
        rec.update(mamba_cache_err=cache_err)
    for tap in taps:
        tap.close()
    return rec, card, toks


def moe_path(sm: Smoke, ident: str) -> dict:
    """Phase 12: phi3.5-MoE (8 layers) and DeepSeek-V3 (5 layers and its
    MTP module) at full width with seeded bf16 weights, each freed before
    the next; then the 2-layer float32 cuts, card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import steps as S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rec = {}
    for label, arch, layers in MOE_CELLS:
        t = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        model, init_s = moe_build(sm, M, label, cfg)
        rec[label] = moe_serve_part(sm, M, S, label, cfg, model, init_s,
                                    ident)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        sm.note(f"{label}: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    rec["12c"] = []
    for _, arch, _ in MOE_CELLS:
        cfg = moe_cpu_config(arch)
        rec["12c"].append(moe_cpu_part(sm, M, S, f"12c {cfg.name}", cfg)[0])
    gc.collect()
    torch.cuda.empty_cache()
    sm.note(f"12c: {time.perf_counter() - t:.1f}s; phase 12: "
            f"{time.perf_counter() - t0:.1f}s")
    rec["seconds"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------------------- #
# phase 13: Mamba and the Jamba hybrid on the LM serving path
# --------------------------------------------------------------------------- #
JAMBA_ARCH = "jamba_v01_52b"
JAMBA_LAYERS = 8                     # one whole 8-layer Jamba block of 4:
                                     # 7 Mamba, 1 attention, 4 MoE; 24
                                     # fit, 8 free phase 16's time
JAMBA_PARAMS = 13_295_235_136        # the reference's eval_shape at 8 layers
JAMBA_LONG_PROMPT, JAMBA_LONG_GEN = 4096, 16   # 8 scan chunks of 512
JAMBA_LONG_HELD_LAYERS = 8           # 13b's dropless replay: the block
JAMBA_DROPLESS = 8.0                 # capacity factor >= n_experts / top_k
JAMBA_SCAN_LEN = 2048                # 13b: chunked vs single-shot scan
JAMBA_SCAN_ATOL = 1e-5
JAMBA_CPU_LAYERS = 5                 # 13c: 4 Mamba, the attention layer
JAMBA_CPU_EXPERTS = 4                # 13c: routed experts 16 -> 4, top-2
JAMBA_CPU_PARAMS = 2_937_892_872
JAMBA_FP32_SELF_ATOL = 5e-4          # decode vs forward, float32: the
                                     # reference's bound (test_archs.py)
JAMBA_FLOOR_FACTOR = 2               # cached vs forward: rounding floors


def jamba_config(layers: int, **kw):
    """jamba-v0.1-52b cut to its first ``layers`` layers of the pattern."""
    from repro_torch.configs import get_config
    from repro_torch.configs.jamba_v01_52b import _pattern
    return dataclasses.replace(get_config(JAMBA_ARCH), n_layers=layers,
                               pattern=_pattern(layers), **kw)


@contextlib.contextmanager
def moe_capacity(model, cfg, factor: float):
    """``cfg`` with every MoE layer's capacity factor ``factor``, given to
    ``model``'s MoE modules while inside. At ``factor >= n_experts /
    top_k`` each expert has a slot for every token, so no call drops a
    pair whatever its token count T: the cached path and ``forward`` keep
    the same pairs wherever their routers pick alike."""
    from repro_torch.models.moe import MoE
    dcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    mods = [m for m in model.modules() if isinstance(m, MoE)]
    for m in mods:
        m.cfg = dcfg
    try:
        yield dcfg
    finally:
        for m in mods:
            m.cfg = cfg


def moe_routes(calls: list, L: int, B: int) -> list:
    """One run's router records per MoE layer as ``(idx, sel, margin)``
    of shapes [B, positions, ...]: ``calls`` is a tap's record of one
    forward (L calls over B x S tokens) or of a prefill then its decode
    steps (L calls over B x P tokens, then L calls over B tokens a step),
    each in layer order."""
    import torch
    out = []
    for layer in range(L):
        mine = calls[layer::L]
        idx, sel, margin = (torch.cat([c[k].reshape(B, -1, *c[k].shape[1:])
                                       for c in mine], dim=1)
                            for k in ("idx", "sel", "margin"))
        out.append((idx.sort(-1).values, sel, margin))
    return out


def moe_first_flips(rep: list, fwd: list, L: int, B: int) -> list:
    """Where the cached path's routing first leaves the forward's: per
    batch row, (the first position at which any MoE layer picks another
    set of experts, whether every such pick there is a near-tie), or None
    (the same set in another order is the same output). A
    near-tie: the smaller top-k margin of the two runs within twice the
    largest difference of that token's selection scores between them,
    i.e. the two runs' rounding decides it. A flip routes the token
    through other experts, so it moves the logits at its position and,
    through attention and the Mamba state, at every later one."""
    import torch
    a, b = moe_routes(rep, L, B), moe_routes(fwd, L, B)
    firsts = []
    for row in range(B):
        q, near = None, True
        for (ia, sa, ma), (ib, sb, mb) in zip(a, b):
            diff = (ia[row] != ib[row]).any(-1)
            if bool(diff.any()):
                pos = int(torch.nonzero(diff)[0])
                if q is None or pos < q:
                    q, near = pos, True
                if pos == q:
                    eps = float((sa[row, pos] - sb[row, pos]).abs().max())
                    near &= min(float(ma[row, pos]),
                                float(mb[row, pos])) <= 2 * eps
        firsts.append(None if q is None else (q, near))
    return firsts


@contextlib.contextmanager
def moe_pinned(picks: list):
    """While inside, each call of ``repro_torch.models.moe._route`` routes
    its tokens to the experts ``picks`` gives, one entry per call in call
    order (a forward calls each MoE layer once, in layer order); the gates
    are those experts' router probabilities, renormalized, as ``_route``
    computes them. A forward then routes as the run that ``picks`` was
    recorded from, and what is left to compare is the rest of the model."""
    import torch
    from repro_torch.models import moe
    route, calls = moe._route, iter(picks)

    def pinned(params, xt, m):
        sel, _, _ = route(params, xt, m)
        probs = torch.softmax(xt.float() @ params["router"].float(), dim=-1)
        idx = next(calls).reshape(*xt.shape[:-1], m.top_k).to(xt.device)
        gate = probs.gather(-1, idx)
        return sel, idx, gate / torch.clamp_min(gate.sum(-1, keepdim=True),
                                                1e-9)

    moe._route = pinned
    try:
        yield
    finally:
        moe._route = route


def mamba_caches(cfg, caches) -> list:
    return [c for spec, c in zip(cfg.layer_pattern(), caches)
            if spec.mixer == "mamba"]


def jamba_check_caches(sm: Smoke, label: str, cfg, caches, pos: int,
                       batch: int) -> None:
    """Every Mamba layer's decode state in the activation dtype (the
    scan returns its state in ``u``'s dtype), of the reference's shapes,
    at position ``pos``."""
    import torch
    mc = cfg.mamba
    di = int(mc.expand * cfg.d_model)
    act = getattr(torch, cfg.activation_dtype)
    ms = mamba_caches(cfg, caches)
    sm.check(len(ms) > 0 and all(
        c["h"].dtype == c["conv"].dtype == act
        and tuple(c["h"].shape) == (batch, di, mc.d_state)
        and tuple(c["conv"].shape) == (batch, mc.d_conv - 1, di)
        and c["idx"] == pos and bool(torch.isfinite(c["h"].float()).all())
        for c in ms) and all(c["idx"] == pos for c in caches),
        f"{label}: {len(ms)} Mamba caches hold h [{batch}, {di}, "
        f"{mc.d_state}] and conv [{batch}, {mc.d_conv - 1}, {di}] in "
        f"{act}, finite, every layer at position {pos}")


def jamba_held(sm: Smoke, label: str, M, model, cfg, prompts, G: int,
               atol: float) -> dict:
    """With every MoE layer dropless: a greedy loop of ``G`` tokens through
    ``prefill`` / ``decode_step`` (its Mamba caches checked) against
    ``forward`` over the same prefix. The two paths multiply matrices of
    other shapes, so they round apart, and a router whose top-k margin is
    below that rounding picks other experts in each: every row's first
    such flip must be a near-tie. Then ``forward`` runs again with its
    routing pinned to the loop's picks (``moe_pinned``), and every step's
    logits must lie within the tolerance of it, each greedy token its
    argmax or a near-tie. The tolerance is ``atol``, or, where larger,
    JAMBA_FLOOR_FACTOR times the model's rounding floor: how far the same
    pinned forward's logits move when its input is moved by one ulp of the
    activation dtype (``x * (1 + eps)`` into the first block). In bf16 a
    random-weight Jamba amplifies that one ulp to 1.3-1.5 logits on an
    H100 (13a, 13b), far above the 0.25 that holds for olmo-1b; the cached
    path rounds apart from the forward at every layer, not once at the
    input, so it may sit somewhat above one floor."""
    import torch
    B, P = prompts.shape
    tap = MoeTap(model)
    L = tap.n_layers
    tap.on = True
    with moe_capacity(model, cfg, JAMBA_DROPLESS) as dcfg:
        lg, caches = M.prefill(model, {"tokens": prompts}, dcfg, P + G)
        out, logits = [lg[:, -1].argmax(-1)], [lg]
        for _ in range(G - 1):
            lg, caches = M.decode_step(model, caches,
                                       {"tokens": out[-1][:, None]}, dcfg)
            out.append(lg[:, -1].argmax(-1))
            logits.append(lg)
        rep = tap.take()
        jamba_check_caches(sm, label, dcfg, caches, P + G - 1, B)
        del caches
        toks, steps = torch.stack(out, dim=1), torch.cat(logits, dim=1)
        seq = {"tokens": torch.cat([prompts, toks[:, :-1]], dim=1)}
        with torch.no_grad():
            free, aux = M.forward(model, seq, dcfg)
            free = free[:, P - 1:].clone()
        fwd = tap.take()
        tap.on = False
        tap.close()
        picks = [r[0] for r in moe_routes(rep, L, B)]
        with moe_pinned(picks), torch.no_grad():
            full, _ = M.forward(model, seq, dcfg)
            full = full[:, P - 1:].clone()
        with moe_pinned(picks):
            floor = lm_floor(M, model, dcfg, seq, full, P - 1)
    pairs = B * (P + G - 1) * cfg.moe.top_k
    sm.check(round(float(aux["moe_dropped"]) * pairs) == 0,
             f"{label}: capacity factor {JAMBA_DROPLESS}: forward over "
             f"{B}x{P + G - 1} tokens drops no pair (moe_dropped "
             f"{float(aux['moe_dropped']):.3g})")
    sm.check(full.dtype == steps.dtype == getattr(torch,
                                                  cfg.activation_dtype),
             f"{label}: logits in {full.dtype}")
    firsts = moe_first_flips(rep, fwd, L, B)
    flips = [f for f in firsts if f is not None]
    free_err = float((steps.float() - free.float()).abs().max())
    sm.check(all(near for _, near in flips),
             f"{label}: the cached path's routing leaves the free "
             f"forward's in {len(flips)} of {B} rows, first at positions "
             f"{[f[0] for f in flips]}, each a near-tie (free forward vs "
             f"cached steps: max abs err {free_err:.4g})")
    tol = max(atol, JAMBA_FLOOR_FACTOR * floor)
    sm.note(f"{label}: rounding floor (the pinned forward with its input "
            f"moved by one ulp) {floor:.4g}; tolerance max({atol}, "
            f"{JAMBA_FLOOR_FACTOR} x floor) = {tol:.4g}")
    rec = lm_check_greedy(sm, f"{label}, routing pinned", toks, steps, full,
                          tol)
    rec.update(first_flips=[None if f is None else f[0] for f in firsts],
               free_forward_err=free_err, floor=floor, tolerance=tol)
    return rec


def jamba_mamba_profile(sm: Smoke, model, cfg) -> dict:
    """One Mamba layer's prefill at the long prompt's shape (layer 0's
    mixer on a bf16 [1, 4096, 4096] input and a fresh cache: the chunked
    scan), timed unprofiled, then once under the profiler; beside its
    bound from ``lm_work``'s Mamba terms."""
    import torch
    from repro_torch.models.ssm import Mamba, mamba_cache_shape
    mixer = model.blocks[0].mixer
    assert isinstance(mixer, Mamba)
    act = getattr(torch, cfg.activation_dtype)
    g = torch.Generator(device=DEVICE).manual_seed(6)
    x = torch.randn((1, JAMBA_LONG_PROMPT, cfg.d_model), generator=g,
                    device=DEVICE).to(act)

    def mix():
        with torch.no_grad():
            return mixer(x, cache=mamba_cache_shape(cfg, 1, act,
                                                    device=DEVICE),
                         dtype=act)

    mix()
    lm_sync()
    t0 = time.perf_counter()
    mix()
    lm_sync()
    ms = (time.perf_counter() - t0) * 1e3
    prof = lm_profile(mix)
    lm_note_profile(sm, "13b profile (one Mamba layer's prefill of the "
                    f"{JAMBA_LONG_PROMPT}-token prompt)", prof)
    mc = cfg.mamba
    di, n, K = int(mc.expand * cfg.d_model), mc.d_state, mc.d_conv
    r = max(cfg.d_model // 16, 1)
    T, d = JAMBA_LONG_PROMPT, cfg.d_model
    ops = 2 * T * (d * 2 * di + di * (r + 2 * n) + r * di + di * d
                   + K * di) + 6 * T * di * n
    nbytes = (sum(p.numel() * p.element_size() for p in mixer.parameters())
              + 2 * T * d * x.element_size()
              + ((K - 1) * di + di * n) * x.element_size())
    bound, by = lm_bound_ms(nbytes, ops, BF16_OPS_PER_S)
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_pattern())
    sm.note(f"13b: one Mamba layer's prefill {ms:.3f} ms unprofiled (bound "
            f"{bound:.4f} ms, {by}); x {n_mamba} Mamba layers = "
            f"{ms * n_mamba:.1f} ms")
    return dict(mamba_layer_ms=ms, mamba_layer_bound_ms=bound,
                mamba_layer_bound_by=by, mamba_profile=prof)


def jamba_long_part(sm: Smoke, M, model, cfg, ident) -> dict:
    """13b: one 4,096-token request at batch 1 and 16 greedy steps through
    ``prefill`` / ``decode_step`` (timed, the MoE layers tapped), the
    prefill against ``forward`` on the same prompt, one Mamba layer's
    prefill profiled; then the model cut to its first
    JAMBA_LONG_HELD_LAYERS layers and the request replayed dropless, held
    against ``forward`` over the same 4,111 tokens. Leaves ``model`` at
    that depth."""
    import torch
    P, G = JAMBA_LONG_PROMPT, JAMBA_LONG_GEN
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (1, P), generator=gen,
                           device=DEVICE)
    tap = MoeTap(model)
    L = tap.n_layers
    tap.on = True
    torch.cuda.reset_peak_memory_stats()
    lm_sync()
    t0 = time.perf_counter()
    lg, caches = M.prefill(model, {"tokens": prompt}, cfg, P + G)
    nxt = lg[:, -1].argmax(-1)
    lm_sync()
    t1 = time.perf_counter()
    first = lg
    for _ in range(G - 1):
        lg, caches = M.decode_step(model, caches, {"tokens": nxt[:, None]},
                                   cfg)
        nxt = lg[:, -1].argmax(-1)
    lm_sync()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    calls = tap.take()
    pre, dec = calls[:L], [calls[L + i * L:L + (i + 1) * L]
                           for i in range(G - 1)]
    jamba_check_caches(sm, "13b", cfg, caches, P + G - 1, 1)
    del caches
    dec_drops = [moe_dropped_pairs(c) for s_ in dec for c in s_]
    sm.check(len(dec) == G - 1 and max(dec_drops) == 0,
             f"13b: no decode step drops a pair ({G - 1} steps x {L} MoE "
             f"layers)")
    pre_drop = [moe_dropped_pairs(c) / c["pairs"] for c in pre]
    sm.note("13b: prefill drop share by MoE layer "
            + ", ".join(f"{x:.4f}" for x in pre_drop))
    with torch.no_grad():
        full, _ = M.forward(model, {"tokens": prompt}, cfg)
        full = full[:, -1:].clone()
    fwd = tap.take()
    tap.on = False
    tap.close()
    fl = moe_flips(pre, fwd, 1)
    err = float((first.float() - full.float()).abs().max())
    sm.check(fl["flips"] == fl["near_ties"] and (fl["flips"] > 0
                                                 or err <= LM_BF16_ATOL),
             f"13b: prefill's last logits against forward on the same "
             f"{P}-token prompt, max abs err {err:.6g} (held to "
             f"{LM_BF16_ATOL} only without a router flip); router picks "
             f"differ at {fl['flips']} token-layers, {fl['near_ties']} of "
             f"them near-ties (the prefill attends over {P + G} cache "
             f"positions blockwise, the forward over {P} densely)")
    del full
    p_bound, p_by = moe_bound(cfg, model, pre, 1, P, 0)
    d_bound = sum(moe_bound(cfg, model, s_, 1, 1, P + i)[0]
                  for i, s_ in enumerate(dec)) / len(dec)
    rec = dict(prompt=P, gen=G, prefill_ms=(t1 - t0) * 1e3,
               prefill_bound_ms=p_bound, prefill_bound_by=p_by,
               decode_step_ms=(t2 - t1) * 1e3 / (G - 1),
               decode_step_bound_ms=d_bound,
               decode_tokens_per_s=(G - 1) / (t2 - t1), peak_bytes=peak,
               prefill_drop_share=pre_drop, prefill_vs_forward_err=err,
               router_flips=fl)
    rec.update(jamba_mamba_profile(sm, model, cfg))
    sm.note(f"13b ({ident}): prefill 1x{P} {rec['prefill_ms']:.1f} ms "
            f"(bound {p_bound:.3f} ms, {p_by}); decode "
            f"{rec['decode_step_ms']:.4f} ms/step at {P}+ positions (bound "
            f"{d_bound:.4f} ms), {rec['decode_tokens_per_s']:.1f} tok/s; "
            f"peak {peak} bytes ({peak / 2**30:.2f} GiB)")

    # held: the first JAMBA_LONG_HELD_LAYERS layers, dropless
    H = JAMBA_LONG_HELD_LAYERS
    del model.blocks[H:]
    hcfg = dataclasses.replace(cfg, n_layers=H,
                               pattern=cfg.layer_pattern()[:H])
    gc.collect()
    torch.cuda.empty_cache()
    rec["held"] = dict(layers=H, **jamba_held(
        sm, f"13b ({H} layers, dropless)", M, model, hcfg, prompt, G,
        LM_BF16_ATOL))
    return rec


def jamba_scan_check(sm: Smoke, cfg) -> dict:
    """13b, with the model freed: ``_mamba_scan`` chunked (512) against
    single-shot at one Mamba layer's shapes (di 8192, n 16) over 2,048
    tokens, float32 (TF32 off), within JAMBA_SCAN_ATOL; the inputs take
    the distributions of the reference's own chunked-scan test."""
    import torch
    from repro_torch.models.ssm import _MAMBA_CHUNK, _mamba_scan
    mc = cfg.mamba
    di, n, s = int(mc.expand * cfg.d_model), mc.d_state, JAMBA_SCAN_LEN
    g = torch.Generator(device=DEVICE).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)

    u = randn(1, s, di) * 0.1
    dt = torch.nn.functional.softplus(randn(1, s, di)) * 0.1
    B, C = randn(1, s, n) * 0.3, randn(1, s, n) * 0.3
    A = -torch.exp(randn(di, n) * 0.2)
    D = torch.ones(di, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    y1, h1 = _mamba_scan(u, dt, B, C, A, D, chunk=s)
    y2, h2 = _mamba_scan(u, dt, B, C, A, D, chunk=_MAMBA_CHUNK)
    lm_sync()
    peak = torch.cuda.max_memory_allocated()
    err = max(float((y1 - y2).abs().max()), float((h1 - h2).abs().max()))
    sm.check(err <= JAMBA_SCAN_ATOL,
             f"13b: chunked scan ({_MAMBA_CHUNK}) against single-shot over "
             f"{s} tokens at di {di}, n {n}, float32: max abs err "
             f"{err:.3g} <= {JAMBA_SCAN_ATOL} (|y| <= "
             f"{float(y1.abs().max()):.4g}); peak {peak / 2**30:.2f} GiB")
    return dict(scan_len=s, scan_chunked_vs_single_err=err,
                scan_peak_bytes=peak)


def jamba_cpu_part(sm: Smoke, M, S) -> dict:
    """13c: the first 5 layers at full width with 4 routed experts,
    float32, the card against the CPU on the same weights (phase 12c's
    checks and the Mamba caches), then the card's own cached path held
    against its forward."""
    base = jamba_config(JAMBA_CPU_LAYERS)
    cfg = jamba_config(JAMBA_CPU_LAYERS, param_dtype="float32",
                       activation_dtype="float32",
                       moe=dataclasses.replace(base.moe,
                                               n_experts=JAMBA_CPU_EXPERTS))
    rec, card, toks = moe_cpu_part(sm, M, S, "13c", cfg)
    n_params = sum(p.numel() for p in card.parameters())
    sm.check((cfg.name != "jamba-v0.1-52b" or n_params == JAMBA_CPU_PARAMS)
             and "mamba_cache_err" in rec,
             f"13c: {cfg.name} cut to {cfg.n_layers} layers "
             f"({[s_.mixer + '/' + s_.mlp for s_ in cfg.layer_pattern()]}), "
             f"{cfg.moe.n_experts} experts, {n_params} float32 parameters")
    rec.update(params=n_params, held=jamba_held(
        sm, "13c (card, dropless)", M, card, cfg, toks[:, :16].to(DEVICE),
        8, JAMBA_FP32_SELF_ATOL))
    return rec


def jamba_path(sm: Smoke, ident: str) -> dict:
    """Phase 13: jamba-v0.1-52b at full width cut to 8 layers with
    seeded bf16 weights (13a, 13b), freed; the scan at full width; then
    the 5-layer float32 cut, card against CPU (13c)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.ssm import Mamba
    from repro_torch.training import steps as S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = jamba_config(JAMBA_LAYERS)
    model, init_s = moe_build(sm, M, "13a", cfg)
    n_params = sum(p.numel() for p in model.parameters())
    mixers = [blk.mixer for blk in model.blocks
              if isinstance(blk.mixer, Mamba)]
    sm.check((cfg.name != "jamba-v0.1-52b" or n_params == JAMBA_PARAMS)
             and len(mixers) == sum(s_.mixer == "mamba"
                                    for s_ in cfg.layer_pattern())
             and all(m.A_log.dtype == m.D.dtype == torch.float32
                     and m.in_proj.dtype == torch.bfloat16 for m in mixers),
             f"13a: {len(mixers)} Mamba layers of {cfg.n_layers}, A_log and "
             f"D float32 beside bf16 weights, {n_params} parameters")
    rec = {"13a": moe_serve_part(sm, M, S, "13a", cfg, model, init_s,
                                 ident)}
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=DEVICE)
    rec["13a"].update(dropless=jamba_held(sm, "13a (dropless)", M, model,
                                          cfg, prompts, LM_GEN,
                                          LM_BF16_ATOL))
    sm.note(f"13a: {time.perf_counter() - t0:.1f}s")
    t = time.perf_counter()
    rec["13b"] = jamba_long_part(sm, M, model, cfg, ident)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rec["13b"].update(jamba_scan_check(sm, cfg))
    gc.collect()
    torch.cuda.empty_cache()
    sm.note(f"13b: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    rec["13c"] = jamba_cpu_part(sm, M, S)
    gc.collect()
    torch.cuda.empty_cache()
    sm.note(f"13c: {time.perf_counter() - t:.1f}s; phase 13: "
            f"{time.perf_counter() - t0:.1f}s")
    rec["seconds"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------------------- #
# phases 14-15: the xLSTM cells and the encoder-decoder / frontend stubs
# --------------------------------------------------------------------------- #
XLSTM_ARCH = "xlstm_350m"
XLSTM_PARAMS = 187_013_120           # the reference's eval_shape, 24 layers
XLSTM_LONG_PROMPT, XLSTM_LONG_GEN = 4096, 16   # 8 mLSTM chunks of 512
XLSTM_CHUNK_LEN = 2048               # 14b: chunkwise vs parallel mLSTM
XLSTM_CHUNK_ATOL = 5e-4              # tests/test_longcontext_paths.py:64
XLSTM_SLSTM_PROFILED = 256           # 14b: sLSTM steps under the profiler
XLSTM_CPU_LAYERS = 8                 # 14c: 7 mLSTM + 1 sLSTM
# (label, arch, layers, the reference's eval_shape parameters at them):
# seamless 8 encoder + 8 decoder layers of 24 + 24 (894,943,232 float32
# parameters), internvl2 16 layers of 48 (7,398,279,168 bf16); full depth
# fit the card, the cuts free phase 16's time and keep every check
ENCDEC_CELLS = (("15a", "seamless_m4t_large_v2", 8, 894_943_232),
                ("15b", "internvl2_26b", 16, 7_398_279_168))
ENCDEC_CPU_LAYERS = 2                # 15c: decoder (and encoder) layers
LM_FLOOR_FACTOR = JAMBA_FLOOR_FACTOR  # cached vs forward: rounding floors
FRONTEND_SCALE = 0.02                # frontend features, as test_archs.py


def lm_inputs(cfg, B: int, P: int, seed: int, dev=None) -> tuple:
    """(prompts [B, P], extra): seeded tokens, and for a config with a
    frontend its features [B, frontend_len, frontend_dim], normal times
    FRONTEND_SCALE (``tests/test_archs.py:21``), float32."""
    import torch
    dev = DEVICE if dev is None else dev
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    extra = {}
    if cfg.frontend:
        extra["frontend"] = FRONTEND_SCALE * torch.randn(
            (B, cfg.frontend_len, cfg.frontend_dim), generator=gen,
            device=dev)
    return prompts, extra


def lm_encode(M, model, cfg, extra):
    """An encoder-decoder's memory (``_encode`` without autograd), else
    None."""
    import torch
    if not cfg.n_enc_layers:
        return None
    with torch.no_grad():
        return M._encode(model, extra, cfg)


def lm_held(sm: Smoke, label: str, M, model, cfg, prompts, extra, toks,
            steps, atol: float) -> dict:
    """The cached steps' logits ``steps`` (a prefill on ``prompts`` and
    decode steps fed ``toks``) against ``forward`` over the same prefix
    (frontend features included), within max(``atol``, LM_FLOOR_FACTOR x
    the model's one-ulp floor, ``lm_floor``), each greedy token the
    forward's argmax or a near-tie (``lm_check_greedy``)."""
    import torch
    P, off = prompts.shape[1], lm_offset(cfg)
    seq = {"tokens": torch.cat([prompts, toks[:, :-1].long()], dim=1),
           **extra}
    with torch.no_grad():
        full, _ = M.forward(model, seq, cfg)
        full = full[:, off + P - 1:].clone()
    floor = lm_floor(M, model, cfg, seq, full, off + P - 1)
    tol = max(atol, LM_FLOOR_FACTOR * floor)
    sm.note(f"{label}: rounding floor (forward with its first block's input "
            f"moved by one ulp) {floor:.4g}; tolerance max({atol}, "
            f"{LM_FLOOR_FACTOR} x floor) = {tol:.4g}")
    sm.check(full.dtype == steps.dtype == getattr(torch,
                                                  cfg.activation_dtype),
             f"{label}: logits in {full.dtype}")
    rec = lm_check_greedy(sm, label, toks, steps, full, tol)
    rec.update(floor=floor, tolerance=tol)
    return rec


def owns_storage(t) -> bool:
    """A cache tensor that holds no view of a larger buffer."""
    return t.untyped_storage().nbytes() == t.numel() * t.element_size()


def xlstm_check_caches(sm: Smoke, label: str, cfg, caches, pos: int,
                       batch: int) -> None:
    """Every mLSTM layer's ``C`` [B, H, dh, dh], ``n`` [B, H, dh], ``m``
    [B, H] float32 and every sLSTM layer's ``h`` [B, d] in the activation
    dtype beside float32 ``c`` / ``n`` / ``m``, finite, each its own
    storage, every layer at position ``pos``."""
    import torch
    act = getattr(torch, cfg.activation_dtype)
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    want = {"mlstm": {"C": ((batch, H, dh, dh), torch.float32),
                      "n": ((batch, H, dh), torch.float32),
                      "m": ((batch, H), torch.float32)},
            "slstm": {"h": ((batch, d), act), "c": ((batch, d), torch.float32),
                      "n": ((batch, d), torch.float32),
                      "m": ((batch, d), torch.float32)}}
    kinds = [spec.mixer for spec in cfg.layer_pattern()]
    ok = len(caches) == len(kinds)
    for kind, c in zip(kinds, caches):
        ok &= c["idx"] == pos and set(c) == set(want[kind]) | {"idx"}
        for key, (shape, dt) in want[kind].items():
            t = c[key]
            ok &= (tuple(t.shape) == shape and t.dtype == dt
                   and owns_storage(t)
                   and bool(torch.isfinite(t.float()).all()))
    sm.check(ok, f"{label}: {kinds.count('mlstm')} mLSTM caches (C [{batch}, "
             f"{H}, {dh}, {dh}], n, m float32) and {kinds.count('slstm')} "
             f"sLSTM caches (h [{batch}, {d}] in {act}; c, n, m float32), "
             f"finite, each its own storage, every layer at position {pos}")


def lm_cell(sm: Smoke, M, S, label: str, cfg, model, ident: str) -> dict:
    """14a / 15a / 15b: serve_lm's defaults (batch 4, prompt 24, 32 tokens;
    the config's frontend features seeded; an encoder-decoder's memory
    encoded once, timed apart) through the step builders, timed after a
    warm-up; the same inputs replayed through ``prefill`` /
    ``decode_step`` and held against ``forward`` (``lm_held``); 4 decode
    steps under the profiler; each time beside its ``lm_work`` bound."""
    import torch
    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    off = lm_offset(cfg)
    max_len = P + G + off
    prompts, extra = lm_inputs(cfg, B, P, seed=1)
    memory = lm_encode(M, model, cfg, extra)              # warm-up
    lm_serve_timed(S, model, cfg, prompts, G, extra, memory)
    torch.cuda.reset_peak_memory_stats()
    lm_sync()
    t0 = time.perf_counter()
    memory = lm_encode(M, model, cfg, extra)
    lm_sync()
    encode_s = time.perf_counter() - t0
    toks, prefill_s, decode_s, caches = lm_serve_timed(
        S, model, cfg, prompts, G, extra, memory)
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c.values() if isinstance(t, torch.Tensor))
    sm.check(toks.shape == (B, G) and bool(((toks >= 0)
                                             & (toks < cfg.vocab)).all()),
             f"{label}: {B}x{G} greedy tokens in range")
    if cfg.xlstm:
        xlstm_check_caches(sm, label, cfg, caches, P + G - 1, B)
    else:
        sm.check(all(c["idx"] == off + P + G - 1 for c in caches),
                 f"{label}: every layer's cache at position "
                 f"{off + P + G - 1} ({off} frontend positions first)")
    del caches
    steps = lm_replay(M, model, cfg, prompts, toks, max_len, extra, memory)
    sm.check(torch.equal(steps.float().argmax(-1), toks.long()),
             f"{label}: the replay through prefill / decode_step reproduces "
             f"the served tokens")
    rec = lm_held(sm, label, M, model, cfg, prompts, extra, toks, steps,
                  LM_BF16_ATOL)
    del steps
    step = S.make_serve_step(cfg)
    nxt, caches = S.make_prefill_step(cfg, max_len)(
        model, {"tokens": prompts, **extra})

    def decode_some():
        nonlocal nxt, caches
        for _ in range(LM_PROFILE_STEPS):
            db = {"tokens": nxt[:, None]}
            if memory is not None:
                db["memory"] = memory
            nxt, caches = step(model, caches, db)

    prof = lm_profile(decode_some)
    lm_note_profile(sm, f"{label} profile ({LM_PROFILE_STEPS} decode "
                    f"steps)", prof)
    del caches
    act = 2 if cfg.activation_dtype == "bfloat16" else 4
    p_bound, p_by = lm_bound_ms(*lm_work(cfg, model, B, off + P, 0,
                                         frontend=True), BF16_OPS_PER_S)
    d_bound = sum(lm_bound_ms(*lm_work(cfg, model, B, 1, off + P + i),
                              BF16_OPS_PER_S)[0]
                  for i in range(G - 1)) / (G - 1)
    d_ms = decode_s * 1e3 / (G - 1)
    rec.update(batch=B, prompt=P, gen=G, frontend_len=cfg.frontend_len,
               prefill_ms=prefill_s * 1e3, prefill_bound_ms=p_bound,
               prefill_bound_by=p_by, decode_step_ms=d_ms,
               decode_step_bound_ms=d_bound,
               decode_tokens_per_s=B * (G - 1) / decode_s,
               decode_bound_tokens_per_s=B / (d_bound / 1e3),
               peak_bytes=peak, cache_bytes=cache_bytes, profile=prof)
    enc = ""
    if memory is not None:
        e_bound, e_by = lm_bound_ms(*encoder_work(cfg, model, B, act),
                                    BF16_OPS_PER_S)
        rec.update(encode_ms=encode_s * 1e3, encode_bound_ms=e_bound,
                   encode_bound_by=e_by)
        enc = (f"encoder {B}x{cfg.frontend_len} frames "
               f"{rec['encode_ms']:.3f} ms (bound {e_bound:.4f} ms, {e_by}); "
               f"encoding again, ")
    sm.note(f"{label} ({ident}): {enc}prefill {B}x{off + P} "
            f"{rec['prefill_ms']:.3f} ms (bound {p_bound:.4f} ms, {p_by}); "
            f"decode {d_ms:.4f} ms/step (bound {d_bound:.4f} ms), "
            f"{rec['decode_tokens_per_s']:.1f} tok/s (bound "
            f"{rec['decode_bound_tokens_per_s']:.1f}); peak {peak} bytes "
            f"({peak / 2**30:.2f} GiB; cache {cache_bytes})")
    return rec


def lm_build(sm: Smoke, M, label: str, cfg, want_params: int):
    """``cfg``'s model on the card with seeded weights: (model, seconds to
    draw them); its parameter count must be the reference's."""
    import torch
    t0 = time.perf_counter()
    model = M.init_model(cfg, seed=0, device=DEVICE)
    lm_sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    sm.check(n_params == want_params,
             f"{label}: {cfg.name}, {cfg.n_layers} layers"
             + (f" + {cfg.n_enc_layers} encoder layers"
                if cfg.n_enc_layers else "")
             + f", {n_params} parameters (the reference's {want_params}; "
             f"{param_bytes} bytes, {param_bytes / 2**30:.2f} GiB, "
             f"{cfg.param_dtype}), drawn in {init_s:.2f}s; "
             f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return model, init_s


def lm_mixer_profile(sm: Smoke, label: str, mixer, cfg, T: int,
                     profiled: int, bound: tuple) -> dict:
    """One mixer's prefill of ``T`` tokens (a bf16 [1, T, d] input and a
    fresh cache), timed unprofiled, then its first ``profiled`` tokens once
    under the profiler; beside ``bound`` (ms, by)."""
    import torch
    from repro_torch.models.model import init_cache
    act = getattr(torch, cfg.activation_dtype)
    g = torch.Generator(device=DEVICE).manual_seed(6)
    x = torch.randn((1, T, cfg.d_model), generator=g, device=DEVICE).to(act)
    kind = type(mixer).__name__.lower()
    spec = next(s_ for s_ in cfg.layer_pattern() if s_.mixer == kind)
    one = dataclasses.replace(cfg, n_layers=1, pattern=(spec,))

    def mix(n):
        with torch.no_grad():
            return mixer(x[:, :n], cache=init_cache(one, 1, n,
                                                    device=DEVICE)[0],
                         dtype=act)

    mix(min(T, 64))
    lm_sync()
    t0 = time.perf_counter()
    mix(T)
    lm_sync()
    ms = (time.perf_counter() - t0) * 1e3
    prof = lm_profile(lambda: mix(profiled))
    lm_note_profile(sm, f"{label} profile (one {type(mixer).__name__} "
                    f"layer's prefill of {profiled} tokens)", prof)
    sm.note(f"{label}: one {type(mixer).__name__} layer's prefill of {T} "
            f"tokens {ms:.3f} ms unprofiled (bound {bound[0]:.4f} ms, "
            f"{bound[1]})")
    return dict(ms=ms, bound_ms=bound[0], bound_by=bound[1],
                profiled_tokens=profiled, profile=prof)


def xlstm_chunk_check(sm: Smoke, cfg) -> dict:
    """14b, with the model freed: ``_mlstm_chunked`` (512) against
    ``_mlstm_parallel`` at one full-width layer's shapes (H 4, dh 256)
    over XLSTM_CHUNK_LEN tokens, float32 (TF32 off), within
    XLSTM_CHUNK_ATOL; the inputs take the distributions of the reference's
    own test."""
    import math

    import torch
    from repro_torch.models.ssm import (_MLSTM_CHUNK, _mlstm_chunked,
                                        _mlstm_parallel)
    H, dh, S_ = cfg.n_heads, cfg.d_model // cfg.n_heads, XLSTM_CHUNK_LEN
    g = torch.Generator(device=DEVICE).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)

    q, k = (randn(1, S_, H, dh) / math.sqrt(dh) for _ in range(2))
    v, ip, fp = randn(1, S_, H, dh), randn(1, S_, H), randn(1, S_, H) + 2
    torch.cuda.reset_peak_memory_stats()
    h1, _ = _mlstm_parallel(q, k, v, ip, fp)
    h2, _ = _mlstm_chunked(q, k, v, ip, fp)
    lm_sync()
    peak = torch.cuda.max_memory_allocated()
    err = float((h1 - h2).abs().max())
    sm.check(err <= XLSTM_CHUNK_ATOL,
             f"14b: chunkwise mLSTM ({_MLSTM_CHUNK}) against the parallel "
             f"form over {S_} tokens at H {H}, dh {dh}, float32: max abs err "
             f"{err:.3g} <= {XLSTM_CHUNK_ATOL} (|h| <= "
             f"{float(h1.abs().max()):.4g}); peak {peak / 2**30:.2f} GiB")
    return dict(chunk_len=S_, chunked_vs_parallel_err=err,
                chunk_peak_bytes=peak)


def xlstm_long_part(sm: Smoke, M, model, cfg, ident: str) -> dict:
    """14b: one 4,096-token request at batch 1 (8 mLSTM chunks of 512 and
    4,096 sequential sLSTM steps in each of 3 layers) and 16 greedy steps
    through ``prefill`` / ``decode_step``, timed, its caches checked, held
    against ``forward`` over the same 4,111 tokens (``lm_held``); one
    mLSTM and one sLSTM layer's prefill timed and profiled."""
    import torch
    from repro_torch.models.ssm import MLSTM, SLSTM
    P, G = XLSTM_LONG_PROMPT, XLSTM_LONG_GEN
    prompt, _ = lm_inputs(cfg, 1, P, seed=2)
    torch.cuda.reset_peak_memory_stats()
    lm_sync()
    t0 = time.perf_counter()
    lg, caches = M.prefill(model, {"tokens": prompt}, cfg, P + G)
    nxt = lg[:, -1].argmax(-1)
    lm_sync()
    t1 = time.perf_counter()
    out, logits = [nxt], [lg]
    for _ in range(G - 1):
        lg, caches = M.decode_step(model, caches, {"tokens": nxt[:, None]},
                                   cfg)
        nxt = lg[:, -1].argmax(-1)
        out.append(nxt)
        logits.append(lg)
    lm_sync()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    xlstm_check_caches(sm, "14b", cfg, caches, P + G - 1, 1)
    del caches
    toks, steps = torch.stack(out, dim=1), torch.cat(logits, dim=1)
    rec = lm_held(sm, "14b", M, model, cfg, prompt, {}, toks, steps,
                  LM_BF16_ATOL)
    p_bound, p_by = lm_bound_ms(*lm_work(cfg, model, 1, P, 0),
                                BF16_OPS_PER_S)
    d_bound = sum(lm_bound_ms(*lm_work(cfg, model, 1, 1, P + i),
                              BF16_OPS_PER_S)[0]
                  for i in range(G - 1)) / (G - 1)
    rec.update(prompt=P, gen=G, prefill_ms=(t1 - t0) * 1e3,
               prefill_bound_ms=p_bound, prefill_bound_by=p_by,
               decode_step_ms=(t2 - t1) * 1e3 / (G - 1),
               decode_step_bound_ms=d_bound,
               decode_tokens_per_s=(G - 1) / (t2 - t1), peak_bytes=peak)
    sm.note(f"14b ({ident}): prefill 1x{P} {rec['prefill_ms']:.1f} ms "
            f"(bound {p_bound:.3f} ms, {p_by}); decode "
            f"{rec['decode_step_ms']:.4f} ms/step (bound {d_bound:.4f} ms), "
            f"{rec['decode_tokens_per_s']:.1f} tok/s; peak {peak} bytes "
            f"({peak / 2**30:.2f} GiB)")
    act = 2 if cfg.activation_dtype == "bfloat16" else 4
    for kind, profiled in ((MLSTM, P), (SLSTM, XLSTM_SLSTM_PROFILED)):
        mixer = next(b.mixer for b in model.blocks
                     if isinstance(b.mixer, kind))
        wbytes = sum(p_.numel() * p_.element_size()
                     for p_ in mixer.parameters())
        if kind is MLSTM:
            xb, xo = mlstm_work(cfg, 1, P, 0)
        else:
            xb, xo = slstm_work(cfg, mixer, 1, P, 0, act)
        bound = lm_bound_ms(wbytes + xb + 2 * P * cfg.d_model * act, xo,
                            BF16_OPS_PER_S)
        rec[kind.__name__.lower()] = lm_mixer_profile(
            sm, "14b", mixer, cfg, P, profiled, bound)
    return rec


def lm_cpu_compare(sm: Smoke, M, S, label: str, cfg, self_atol=None):
    """14c / 15c: ``cfg`` (float32) on the card against the CPU on the same
    weights: forward logits within LM_FP32_ATOL (2 prompts of 32 tokens,
    with the config's frontend features), the prefill's state caches
    (xLSTM) within LM_FP32_ATOL, 8 greedy tokens of a prefill (16 tokens)
    and a decode loop equal; with ``self_atol``, the card's own cached
    path against its forward within it."""
    import torch
    card = M.init_model(cfg, seed=4, device=DEVICE)
    cpu = M.Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    n_params = sum(p.numel() for p in card.parameters())
    toks, extra = lm_inputs(cfg, 2, 32, seed=4, dev="cpu")
    outs = []
    for model, dev in ((card, DEVICE), (cpu, "cpu")):
        batch = {"tokens": toks.to(dev),
                 **{k: v.to(dev) for k, v in extra.items()}}
        with torch.no_grad():
            lg, _ = M.forward(model, batch, cfg)
        outs.append(lg.cpu())
    err = float((outs[0] - outs[1]).abs().max())
    sm.check(err <= LM_FP32_ATOL,
             f"{label}: {cfg.n_layers}-layer"
             + (f" (+{cfg.n_enc_layers} encoder)" if cfg.n_enc_layers
                else "")
             + f" full-width float32 forward ({n_params} parameters), card "
             f"vs CPU, max abs err {err:.3g} <= {LM_FP32_ATOL} (|logits| <= "
             f"{float(outs[1].abs().max()):.4g})")
    rec = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
               forward_max_abs_err=err)
    served, states = [], []
    off = lm_offset(cfg)
    for model, dev in ((card, DEVICE), (cpu, "cpu")):
        ex = {k: v.to(dev) for k, v in extra.items()}
        memory = lm_encode(M, model, cfg, ex)
        nxt, caches = S.make_prefill_step(cfg, 24 + off)(
            model, {"tokens": toks[:, :16].to(dev), **ex})
        states.append([{k: t.cpu() for k, t in c.items()
                        if isinstance(t, torch.Tensor)}
                       for spec, c in zip(cfg.layer_pattern(), caches)
                       if spec.mixer in ("mlstm", "slstm")])
        got = [nxt.cpu()]
        for _ in range(7):
            db = {"tokens": nxt[:, None]}
            if memory is not None:
                db["memory"] = memory
            nxt, caches = S.make_serve_step(cfg)(model, caches, db)
            got.append(nxt.cpu())
        served.append(torch.stack(got, dim=1))
    sm.check(torch.equal(served[0], served[1]),
             f"{label}: 8 greedy tokens of 2 prompts, card equal to CPU")
    if states[0]:
        cache_err = max(float((a[k] - b[k]).abs().max())
                        for a, b in zip(*states) for k in a)
        scale = max(float(b[k].abs().max()) for b in states[1] for k in b)
        sm.check(cache_err <= LM_FP32_ATOL,
                 f"{label}: the {len(states[0])} xLSTM caches after the "
                 f"prefill, card vs CPU, max abs err {cache_err:.3g} <= "
                 f"{LM_FP32_ATOL} (|state| <= {scale:.4g})")
        rec.update(cache_err=cache_err)
    if self_atol is not None:
        prompts, toks_card = toks[:, :16].to(DEVICE), served[0].to(DEVICE)
        memory = lm_encode(M, card, cfg, {k: v.to(DEVICE)
                                         for k, v in extra.items()})
        steps = lm_replay(M, card, cfg, prompts, toks_card, 24 + off,
                          {k: v.to(DEVICE) for k, v in extra.items()},
                          memory)
        with torch.no_grad():
            full, _ = M.forward(card, {"tokens": torch.cat(
                [prompts, toks_card[:, :-1].long()], dim=1), **{
                    k: v.to(DEVICE) for k, v in extra.items()}}, cfg)
        rec.update(held=lm_check_greedy(
            sm, f"{label} (card, cached vs forward)", toks_card, steps,
            full[:, off + 15:], self_atol))
    return rec


def xlstm_path(sm: Smoke, ident: str) -> dict:
    """Phase 14: xlstm-350m at full width and depth (24 layers: 21 mLSTM,
    3 sLSTM; fp32 parameters, bf16 activations) with seeded weights: 14a,
    14b; freed; the chunkwise form at full width; 14c the first 8 layers in
    float32, card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.ssm import MLSTM, SLSTM
    from repro_torch.training import steps as S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = get_config(XLSTM_ARCH)
    model, init_s = lm_build(sm, M, "14a", cfg, XLSTM_PARAMS)
    gates = [(n, p.dtype) for b in model.blocks
             for n, p in b.mixer.named_parameters() if n in ("wi", "wf", "b")]
    kinds = [type(b.mixer) for b in model.blocks]
    sm.check(kinds.count(MLSTM) == 21 and kinds.count(SLSTM) == 3
             and all(b.mlp is None and b.norm2 is None for b in model.blocks)
             and all(dt == torch.float32 for _, dt in gates),
             f"14a: {kinds.count(MLSTM)} mLSTM and {kinds.count(SLSTM)} "
             f"sLSTM blocks without an MLP; {len(gates)} gate leaves "
             f"(wi, wf, b) float32")
    rec = {"14a": lm_cell(sm, M, S, "14a", cfg, model, ident)}
    rec["14a"].update(init_s=init_s)
    sm.note(f"14a: {time.perf_counter() - t0:.1f}s")
    t = time.perf_counter()
    rec["14b"] = xlstm_long_part(sm, M, model, cfg, ident)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rec["14b"].update(xlstm_chunk_check(sm, cfg))
    sm.note(f"14b: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    from repro_torch.configs.xlstm_350m import _pattern
    cut = dataclasses.replace(cfg, n_layers=XLSTM_CPU_LAYERS,
                              pattern=_pattern(XLSTM_CPU_LAYERS),
                              activation_dtype="float32")
    rec["14c"] = lm_cpu_compare(sm, M, S, "14c", cut,
                                self_atol=JAMBA_FP32_SELF_ATOL)
    gc.collect()
    torch.cuda.empty_cache()
    sm.note(f"14c: {time.perf_counter() - t:.1f}s; phase 14: "
            f"{time.perf_counter() - t0:.1f}s")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def encdec_config(cfg, layers: int):
    """``cfg`` cut to its first ``layers`` decoder layers (its pattern
    too), and an encoder-decoder to as many encoder layers."""
    cut = dict(n_layers=layers)
    if cfg.pattern is not None:
        cut["pattern"] = cfg.pattern[:layers]
    if cfg.n_enc_layers:
        cut["n_enc_layers"] = layers
    return dataclasses.replace(cfg, **cut)


def encdec_path(sm: Smoke, ident: str) -> dict:
    """Phase 15: seamless-m4t-large-v2 (15a: 8 encoder + 8 decoder layers
    of 24 + 24, 1,024 frame features) and internvl2-26b (15b: 16 layers of
    48, 256 patch features before the prompt) at full width with seeded
    weights, each freed before the next; then 15c, each cut to 2 layers
    (seamless: 2 encoder layers too) in float32, card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import steps as S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rec = {}
    for label, arch, layers, want in ENCDEC_CELLS:
        t = time.perf_counter()
        cfg = encdec_config(get_config(arch), layers)
        model, init_s = lm_build(sm, M, label, cfg, want)
        rec[label] = lm_cell(sm, M, S, label, cfg, model, ident)
        rec[label].update(arch=cfg.name, init_s=init_s)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        sm.note(f"{label}: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    rec["15c"] = []
    for _, arch, _, _ in ENCDEC_CELLS:
        cut = dataclasses.replace(
            encdec_config(get_config(arch), ENCDEC_CPU_LAYERS),
            param_dtype="float32", activation_dtype="float32")
        rec["15c"].append(lm_cpu_compare(sm, M, S, f"15c {cut.name}", cut))
        gc.collect()
        torch.cuda.empty_cache()
    sm.note(f"15c: {time.perf_counter() - t:.1f}s; phase 15: "
            f"{time.perf_counter() - t0:.1f}s")
    rec["seconds"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------------------- #
# phase 16: LM training
# --------------------------------------------------------------------------- #
TRAIN_BATCH, TRAIN_SEQ = 4, 4096     # train_4k's length at batch 4
TRAIN_STEPS = 6                      # steps 1-2 warm up, 3-6 are timed
TRAIN_WARM = 2
TRAIN_PROFILED = 1                   # step 2 (index 1) runs under the profiler
TRAIN_SCHEDULE = dict(peak_lr=1e-3, warmup=2, total=6)
TRAIN_RESTART = dict(steps=6, batch=2, seq=32)   # tests/test_training.py:71
TRAIN_RESTART_ATOL = 1e-6            # the reference's bar for the restart
TRAIN_CPU_LAYERS = 2                 # 16c: full width, depth cut to 2
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 128
# 16c: warm-up 0, so the one step moves the parameters (lr(0) = peak)
TRAIN_CPU_SCHEDULE = dict(peak_lr=1e-3, warmup=0, total=6)
TRAIN_RTOL = 1e-5                    # loss, grad_norm, mtp_loss: card vs CPU
TRAIN_GRAD_TOL = 1e-5                # a moment leaf: of its largest |value|
TRAIN_PARAM_RTOL = 2e-3              # a leaf's change, card vs CPU, relative
TRAIN_ARCH_STEPS = 5                 # 16d: steps on one batch per arch
TRAIN_ARCH_SCHEDULE = dict(peak_lr=1e-3, warmup=2, total=50)
ADAMW_BYTES = 28                     # p, m, v read and written; g read (fp32)


def train_work(cfg, model, batch: int, seq: int) -> tuple:
    """(bytes, ops, recompute ops) of a train step of ``batch`` x ``seq``
    tokens. Bytes and ops are the least the step must move and compute:
    the forward's operations (``lm_work`` over the whole sequence, the
    head's product at every position) counted 3 times (the forward, and 2
    for the backward: the products with the activations' and the weights'
    gradients); bytes: the forward's, and AdamW's 28 per float32 parameter
    (p, m and v read and written, the gradient read). The recompute ops
    are the blocks' forward once more, which remat adds to save memory:
    work of this implementation, not of the step, so not in the bound."""
    fb, fo = lm_work(cfg, model, batch, seq, 0)
    head = 2 * batch * cfg.d_model * cfg.vocab
    blocks = fo - head
    n = sum(p.numel() for p in model.parameters())
    return fb + ADAMW_BYTES * n, 3 * (blocks + head * seq), blocks


def train_batch(b: dict, dev, cfg=None) -> dict:
    """A ``SyntheticTokens`` batch on ``dev``; with a frontend ``cfg``, its
    zero features (as ``launch.train`` gives them)."""
    import torch
    out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    if cfg is not None and cfg.frontend:
        B = out["tokens"].shape[0]
        out["frontend"] = torch.zeros((B, cfg.frontend_len,
                                       cfg.frontend_dim), device=dev)
    return out


def train_carry(S, state, cfg, dev):
    """A CPU ``TrainState`` carried to ``dev``: the same weights, zero
    moments (a fresh state, as the CPU's is)."""
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import adamw_init
    model = M.Model(cfg, device=dev)
    model.load_state_dict(state.params.state_dict())
    return S.TrainState(params=model, opt=adamw_init(model))


def train_full_part(sm: Smoke, ident: str) -> dict:
    """16a: olmo-1b at full width and depth, 6 train steps at 4 x 4,096
    tokens (steps 3-6 timed, step 2 profiled), its loss on batch 0 after
    training, peak memory beside the state's bytes."""
    import math
    import torch
    from repro_torch.training import steps as S
    from repro_torch.training.data import SyntheticTokens
    from repro_torch.training.optimizer import lr_schedule
    cfg = lm_config()
    t0 = time.perf_counter()
    state = S.make_train_state(cfg, seed=0, device=DEVICE)
    lm_sync()
    init_s = time.perf_counter() - t0
    model = state.params
    n = sum(p.numel() for p in model.parameters())
    sm.check(cfg.name != "olmo-1b" or n == LM_PARAMS,
             f"16a: {cfg.name}, {cfg.n_layers} layers, {n} parameters "
             f"({cfg.param_dtype}, {cfg.activation_dtype} activations) and "
             f"zero float32 moments drawn in {init_s:.2f}s")
    step = S.make_train_step(cfg, **TRAIN_SCHEDULE)
    ds = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [train_batch(ds.batch(i), DEVICE) for i in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    rows, prof = [], None
    for i, b in enumerate(batches):
        out = []
        lm_sync()
        t = time.perf_counter()
        if i == TRAIN_PROFILED:
            prof = lm_profile(lambda: out.append(step(state, b)))
        else:
            out.append(step(state, b))
        lm_sync()
        dt = time.perf_counter() - t
        state, m = out[0]
        rows.append(dict(step=i + 1, s=dt, loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                         want_lr=float(lr_schedule(
                             torch.tensor(i, dtype=torch.int32),
                             **TRAIN_SCHEDULE))))
        sm.note(f"16a step {i + 1}: {dt:.3f}s, loss {rows[-1]['loss']:.5f},"
                f" grad_norm {rows[-1]['grad_norm']:.4f}, lr "
                f"{rows[-1]['lr']:.4g}"
                + (" (profiled)" if i == TRAIN_PROFILED else ""))
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        after, _ = S.loss_fn(model, batches[0], cfg)
    after = float(after)
    sm.check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                 for r in rows),
             f"16a: every loss and grad_norm finite")
    sm.check(all(r["lr"] == r["want_lr"] for r in rows),
             f"16a: lr equals lr_schedule at every step "
             f"{[r['lr'] for r in rows]}")
    sm.check(after < rows[0]["loss"],
             f"16a: batch 0's loss after {TRAIN_STEPS} steps {after:.5f} < "
             f"its loss at step 1 {rows[0]['loss']:.5f}")
    state_bytes = 4 * 4 * n
    timed = [r["s"] for r in rows[TRAIN_WARM:]]
    step_s = sum(timed) / len(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    nb, no, nr = train_work(cfg, model, TRAIN_BATCH, TRAIN_SEQ)
    bound_ms, by = lm_bound_ms(nb, no, BF16_OPS_PER_S)
    recompute_ms = nr / BF16_OPS_PER_S * 1e3
    sm.note(f"16a ({ident}): step {step_s * 1e3:.1f} ms (mean of steps "
            f"{TRAIN_WARM + 1}-{TRAIN_STEPS}: "
            + ", ".join(f"{x * 1e3:.1f}" for x in timed)
            + f"), {tokens / step_s:.0f} tokens/s; bound {bound_ms:.2f} ms "
            f"({by}: {no / 1e12:.2f} TFLOP at 989 TFLOP/s bf16, {nb / 1e9:.2f}"
            f" GB at 3.35 TB/s), {tokens / (bound_ms / 1e3):.0f} tokens/s; "
            f"remat's recompute, not in the bound: {nr / 1e12:.2f} TFLOP, "
            f"{recompute_ms:.2f} ms at 989 TFLOP/s; "
            f"peak {peak} bytes ({peak / 2**30:.2f} GiB) beside parameters, "
            f"gradients and moments {state_bytes} bytes "
            f"({state_bytes / 1e9:.2f} GB)")
    lm_note_profile(sm, "16a profile (train step 2)", prof)
    del state, model, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.n_layers, params=n,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=init_s, steps=rows,
                step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                bound_ms=bound_ms, bound_by=by, bound_ops=no,
                bound_bytes=nb, recompute_ops=nr, recompute_ms=recompute_ms,
                peak_bytes=peak, state_bytes=state_bytes,
                loss_after=after, profile=prof)


def train_restart_part(sm: Smoke) -> dict:
    """16b: ``tests/test_training.py``'s restart on the card through
    ``launch.train.train``: 6 steps straight against 3 steps, a checkpoint
    under ``build/``, and 3 resumed."""
    import shutil
    import torch
    from repro_torch.launch.train import train
    from repro_torch.training.checkpoint import _leaves
    root = ROOT / "build" / "train_restart"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(TRAIN_RESTART, log_every=100, device=DEVICE)
    full, h_full = train("olmo_1b", **kw, ckpt_dir=str(root / "a"),
                         ckpt_every=100)
    train("olmo_1b", **dict(kw, steps=3), ckpt_dir=str(root / "b"),
          ckpt_every=3)
    res, h_res = train("olmo_1b", **kw, ckpt_dir=str(root / "b"),
                       ckpt_every=100, resume=True)
    pairs = list(zip(_leaves(full), _leaves(res)))
    err = max(float((a.float() - b.float()).abs().max())
              for (_, a), (_, b) in pairs)
    bits = h_full[3:] == h_res and all(torch.equal(a, b)
                                       for (_, a), (_, b) in pairs)
    loss_err = abs(h_full[-1] - h_res[-1])
    sm.check(len(h_res) == 3 and loss_err <= TRAIN_RESTART_ATOL
             and err <= TRAIN_RESTART_ATOL,
             f"16b: 6 steps straight vs 3 + checkpoint + 3 resumed on the "
             f"card: final loss {h_full[-1]:.7f} vs {h_res[-1]:.7f}, every "
             f"parameter and moment within {err:.3g} <= "
             f"{TRAIN_RESTART_ATOL}; bits equal: {bits}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(losses=h_full, resumed=h_res, max_abs_err=err,
                bit_equal=bits)


def train_cpu_part(sm: Smoke) -> dict:
    """16c: olmo-1b cut to 2 layers with float32 activations, its state
    drawn on the CPU and carried to the card; one train step on each, on
    batch 0 of ``SyntheticTokens(50304, 128, 2)``."""
    import torch
    from repro_torch.training import steps as S
    from repro_torch.training.data import SyntheticTokens
    cfg = dataclasses.replace(lm_config(), n_layers=TRAIN_CPU_LAYERS,
                              activation_dtype="float32")
    cpu = S.make_train_state(cfg, seed=0, device="cpu")
    card = train_carry(S, cpu, cfg, DEVICE)
    p0 = {name: p.detach().clone()
          for name, p in cpu.params.named_parameters()}
    n = sum(p.numel() for p in cpu.params.parameters())
    b = SyntheticTokens(cfg.vocab, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH).batch(0)
    step = S.make_train_step(cfg, **TRAIN_CPU_SCHEDULE)
    card, mc = step(card, train_batch(b, DEVICE))
    cpu, mh = step(cpu, train_batch(b, "cpu"))
    rel = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
           for k in ("loss", "grad_norm")}
    sm.check(all(v <= TRAIN_RTOL for v in rel.values()),
             f"16c: {cfg.n_layers}-layer full-width float32 train step "
             f"({n} parameters), card vs CPU: loss {float(mc['loss']):.6f} "
             f"vs {float(mh['loss']):.6f}, relative errors {rel} <= "
             f"{TRAIN_RTOL}")
    # the CPU tests' bars: a moment leaf within TRAIN_GRAD_TOL of its
    # largest value (v, a square, twice that); each leaf's change within
    # TRAIN_PARAM_RTOL of the CPU's (norm of the difference over the norm),
    # and every element within 2 lr R_1 = 2 lr (an element whose gradient
    # sits at rounding noise can step either way)
    lr = float(mh["lr"])
    worst = {"m": 0.0, "v": 0.0, "params": 0.0, "change_rel": 0.0}
    ok = True
    for name, p in cpu.params.named_parameters():
        q = card.params.get_parameter(name).detach().cpu()
        d = float((q - p.detach()).abs().max())
        worst["params"] = max(worst["params"], d)
        ok &= d <= 2 * lr
        want = p.detach() - p0[name]
        got = q - p0[name]
        r = float((got - want).norm() / want.norm()) if want.any() \
            else float(got.abs().max())
        worst["change_rel"] = max(worst["change_rel"], r)
        ok &= r <= TRAIN_PARAM_RTOL
        for which, tol in (("m", TRAIN_GRAD_TOL), ("v", 2 * TRAIN_GRAD_TOL)):
            a = getattr(card.opt, which)[name].cpu()
            w = getattr(cpu.opt, which)[name]
            scale = float(w.abs().max())
            d = float((a - w).abs().max()) / max(scale, 1e-30)
            worst[which] = max(worst[which], d)
            ok &= d <= tol
    sm.check(ok, f"16c: after the step, card vs CPU: moments m within "
             f"{worst['m']:.3g} (<= {TRAIN_GRAD_TOL}) and v within "
             f"{worst['v']:.3g} (<= {2 * TRAIN_GRAD_TOL}) of each leaf's "
             f"largest value, each leaf's change within "
             f"{worst['change_rel']:.3g} (<= {TRAIN_PARAM_RTOL}) relative "
             f"to the CPU's, parameters within {worst['params']:.3g} "
             f"(<= 2 lr = {2 * lr:.3g})")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params=n, rel=rel, worst=worst)


def train_archs_part(sm: Smoke) -> dict:
    """16d: every LM arch's smoke config (``tests/test_archs.py``'s
    ``LM_ARCHS``), weights drawn on the CPU and carried to the card, 5 train
    steps on one batch on each; then ``compressed_psum`` on an NCCL world of
    one."""
    import torch
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.training import steps as S
    out = {}
    for arch in [a for a in ARCHS if a != "drone_graph"]:
        cfg = get_smoke_config(arch)
        cpu = S.make_train_state(cfg, seed=1, device="cpu")
        card = train_carry(S, cpu, cfg, DEVICE)
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (4, 32), generator=gen)
        b = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        if cfg.frontend:
            b["frontend"] = FRONTEND_SCALE * torch.randn(
                (4, cfg.frontend_len, cfg.frontend_dim), generator=gen)
        bc = {k: v.to(DEVICE) for k, v in b.items()}
        step = S.make_train_step(cfg, **TRAIN_ARCH_SCHEDULE)
        rows = []
        for _ in range(TRAIN_ARCH_STEPS):
            card, mc = step(card, bc)
            cpu, mh = step(cpu, b)
            rows.append({k: (float(mc[k]), float(mh[k])) for k in mc})
        loss_rel = max(abs(a - b_) / abs(b_) for a, b_ in
                       (r["loss"] for r in rows))
        mtp_rel = max((abs(a - b_) / abs(b_) for a, b_ in
                       (r["mtp_loss"] for r in rows if "mtp_loss" in r)),
                      default=0.0)
        dropped = all(r["moe_dropped"][0] == r["moe_dropped"][1]
                      for r in rows)
        falls = rows[-1]["loss"][0] < rows[0]["loss"][0]
        sm.check(loss_rel <= TRAIN_RTOL and mtp_rel <= TRAIN_RTOL and dropped
                 and falls,
                 f"16d {arch}: {TRAIN_ARCH_STEPS} steps, card vs CPU: loss "
                 f"{rows[0]['loss'][0]:.5f} -> {rows[-1]['loss'][0]:.5f} "
                 f"(falls: {falls}), relative error {loss_rel:.3g}"
                 + (f", mtp_loss {mtp_rel:.3g}" if "mtp_loss" in rows[0]
                    else "")
                 + f" <= {TRAIN_RTOL}; moe_dropped equal: {dropped}")
        out[arch] = dict(rows=rows, loss_rel=loss_rel, mtp_rel=mtp_rel)
        del card, cpu
    out["compressed_psum"] = train_psum_check(sm)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_psum_check(sm: Smoke) -> dict:
    """``compressed_psum`` on an NCCL world of one (phase 10c's store): the
    mean of one rank is its own gradient within one quantum (the shared
    scale: the noise and the rounding each move it by at most half)."""
    import torch
    import torch.distributed as dist
    from repro_torch.training.optimizer import compressed_psum
    store = ROOT / "build" / "shard" / "train_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        g = {"w": torch.randn((1024, 256), generator=gen, device=DEVICE)
             * 0.01, "b": torch.randn((256,), generator=gen, device=DEVICE)}
        mean, err = compressed_psum(g, None, gen)
        rows = {}
        for k, x in g.items():
            quantum = float(x.abs().max()) / 127.0 + 1e-12
            rows[k] = dict(err=float((mean[k] - x).abs().max()),
                           quantum=quantum,
                           feedback=float((err[k] - (x - mean[k])).abs()
                                          .max()))
    finally:
        dist.destroy_process_group()
    sm.check(all(r["err"] <= r["quantum"] and r["feedback"] <= 1e-6
                 for r in rows.values()),
             f"16d: compressed_psum on an NCCL world of one: each mean within"
             f" one quantum of the gradient, the fed-back error the "
             f"difference: {rows}")
    return rows


def train_path(sm: Smoke, ident: str) -> dict:
    """Phase 16: LM training on the card (TF32 off): 16a olmo-1b at full
    width and depth, 16b the restart, 16c card vs CPU at full width, 16d
    every LM arch's smoke config and compressed_psum."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rec = {"16a": train_full_part(sm, ident)}
    for label, part in (("16b", train_restart_part), ("16c", train_cpu_part),
                        ("16d", train_archs_part)):
        t = time.perf_counter()
        rec[label] = part(sm)
        sm.note(f"{label}: {time.perf_counter() - t:.1f}s")
    sm.note(f"phase 16: {time.perf_counter() - t0:.1f}s")
    rec["seconds"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------------------- #
# phase 17: the graph examples, the lint and the ops rig
# --------------------------------------------------------------------------- #
EXAMPLES = ("quickstart", "sssp_road", "pagerank_powerlaw",
            "streaming_updates")
OPS_SCALE = 16                # benchmarks/kernel_roofline.py's large shape
OPS_PARTS = 16


def load_example(name: str):
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_diffs(got, want, key: str = "") -> list:
    """Where an example's record on the card differs from the CPU's: every
    count equal, arrays bit-identical, except PageRank's ranks (within
    ``PR_RTOL`` of their largest value) and its mass (relative)."""
    import numpy as np
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{key}: keys {sorted(got)} vs {sorted(want)}"]
        return [d for k in want for d in example_diffs(got[k], want[k],
                                                      f"{key}.{k}")]
    if isinstance(want, (list, tuple)) and not isinstance(want, str):
        if len(got) != len(want):
            return [f"{key}: {len(got)} vs {len(want)} entries"]
        return [d for i, (a, b) in enumerate(zip(got, want))
                for d in example_diffs(a, b, f"{key}[{i}]")]
    if isinstance(want, np.ndarray):
        if key.endswith("ranks"):
            err = float(np.abs(got - want).max())
            ok = err <= PR_RTOL * float(np.abs(want).max())
            return [] if ok else [f"{key}: max err {err:.3g}"]
        ok = got.dtype == want.dtype and np.array_equal(got, want)
        return [] if ok else [f"{key}: arrays differ"]
    if key.endswith("mass"):
        ok = abs(got - want) <= PR_RTOL * abs(want)
        return [] if ok else [f"{key}: {got!r} vs {want!r}"]
    return [] if got == want else [f"{key}: {got!r} vs {want!r}"]


def examples_part(sm: Smoke) -> dict:
    """17a: each graph example on the card and on the CPU."""
    out = {}
    for name in EXAMPLES:
        mod = load_example(name)
        t = time.perf_counter()
        card = mod.main([])
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = mod.main(["--device", "cpu"])
        cpu_s = time.perf_counter() - t
        diffs = example_diffs(card, cpu)
        sm.check(not diffs, f"17a: examples/torch_{name}.py on the card "
                            f"counts as on the CPU ({card_s:.1f}s card, "
                            f"{cpu_s:.1f}s CPU){': ' if diffs else ''}"
                            f"{'; '.join(diffs[:5])}")
        out[name] = dict(card_s=card_s, cpu_s=cpu_s, diffs=diffs)
    return out


def lint_part(sm: Smoke) -> dict:
    """17b: the port's lint gate and strict DL005 on its kernels."""
    cli = str(ROOT / "tools" / "drone_lint_torch.py")
    out = {}
    for label, args in (("gate", ["src/repro_torch"]),
                        ("strict DL005", ["--no-baseline", "--select",
                                          "DL005",
                                          "src/repro_torch/kernels"])):
        run = subprocess.run([sys.executable, cli, *args], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        last = (run.stdout.strip().splitlines() or [""])[-1]
        sm.check(run.returncode == 0 and " 0 finding(s)" in last
                 if label == "strict DL005" else run.returncode == 0,
                 f"17b: drone_lint_torch {' '.join(args)}: exit "
                 f"{run.returncode}, {last}{run.stderr.strip()[-300:]}")
        out[label] = dict(rc=run.returncode, last=last)
    return out


def ops_inputs(src, dst, w, nv: int, vals):
    """The busiest partition's layouts and the kernels' device inputs, as
    ``ops.spmv`` makes them: the tile list and value blocks of both
    semirings, and the windowed message buffers of both combiners."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import combine_identity, tile_pad_identity
    dev = vals.device
    K = vals.shape[1]
    out = {}
    for semi in ("plus_times", "min_plus"):
        tl = ops.build_tiles(src, dst, w, nv, nv, semi)
        ident = float(tile_pad_identity(semi, np.float32))
        v = torch.full((tl.n_src_tiles * 128, K), ident, device=dev)
        v[:nv] = vals
        out[("tiles", semi)] = dict(
            layout=tl, args=(torch.from_numpy(tl.tiles).to(dev),
                             torch.from_numpy(tl.tile_dst).to(dev),
                             torch.from_numpy(tl.tile_src).to(dev),
                             v.reshape(tl.n_src_tiles, 128, K)),
            n=tl.n_dst_tiles)
    wl = ops.window_align_edges(dst, nv)
    sv = vals[torch.from_numpy(src).to(dev)]
    wt = torch.from_numpy(np.asarray(w, np.float32)).to(dev)[:, None]
    order = torch.from_numpy(wl.order).to(dev)
    slot = torch.from_numpy(wl.edge_slot).to(dev)
    for semi, comb in (("plus_times", "sum"), ("min_plus", "min")):
        msgs = sv * wt if semi == "plus_times" else sv + wt
        buf = torch.full((wl.n_blocks * wl.block_edges, K),
                         float(combine_identity(comb, np.float32)),
                         device=dev)
        buf[slot] = msgs[order]
        out[("windowed", semi)] = dict(
            layout=wl, args=(buf, torch.from_numpy(wl.local_dst).to(dev),
                             torch.from_numpy(wl.block_window).to(dev)),
            n=wl.n_windows, combiner=comb)
    return out


def ops_row(sm: Smoke, kernel: str, semi: str, inp: dict, ident: str):
    """One kernel on one 17c layout: against its plain version, timed
    beside its bound, the plain version and a library call."""
    import torch
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk
    args, n = inp["args"], inp["n"]
    if kernel == "tiles":
        name, plan = "bsp_spmv", bk.plan_tiles(args[1], n)
        tiles, td, ts, v = args
        K = v.shape[-1]

        def run():
            return bk.bsp_spmv(*args, n_dst_tiles=n, semiring=semi,
                               plan=plan)

        def plain():
            return bk.bsp_spmv_plain(*args, n_dst_tiles=n, semiring=semi)
        mag = spmv_magnitude(*args, n, semi)
        T = tiles.shape[0]
        nbytes = T * 128 * 128 * 4 + 2 * T * 4 + v.numel() * 4 \
            + n * 128 * K * 4
        ops = 2 * T * 128 * 128 * K
        lib = bsr_yardstick(*args, n)[0] if semi == "plus_times" else None
        what = f"{T} tiles"
    else:
        name, comb = "segment_combine_windowed", inp["combiner"]
        msgs, ldst, bwin = args
        plan = sk.plan_windows(bwin, n)
        K = msgs.shape[1]

        def run():
            return sk.segment_combine_windowed(*args, n_windows=n,
                                               combiner=comb, plan=plan)

        def plain():
            return sk.segment_combine_plain(*args, n_windows=n,
                                            combiner=comb)
        mag = segment_magnitude(*args, n, comb)
        Be = msgs.shape[0] // bwin.shape[0]
        nbytes = msgs.numel() * 4 + ldst.numel() * 4 + bwin.numel() * 4 \
            + n * 128 * K * 4
        ops = msgs.numel()
        row = (bwin.long().repeat_interleave(Be) * 128 + ldst.long())
        lib_out = plain()
        if comb == "sum":
            def lib():
                return lib_out.view(-1, K).index_add_(0, row, msgs)
        else:
            idx = row[:, None].expand(-1, K).contiguous()

            def lib():
                return lib_out.view(-1, K).scatter_reduce_(
                    0, idx, msgs, "amin", include_self=True)
        what = f"msgs {tuple(msgs.shape)}, {bwin.shape[0]} blocks"
    got = run()
    want = plain()
    torch.cuda.synchronize()
    ok, err = compare(got, want, mag)
    sm.check(ok, f"17c: {name} {semi} at the kron-{OPS_SCALE} partition "
                 f"({what}) vs plain (max err {err:.3g})")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    rec = dict(name=name, semiring=semi, shape=what, max_abs_err=err,
               ms=time_ms(run), plain_ms=time_ms(plain, max_iters=5),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=time_ms(lib) if lib is not None else None,
               chunks=plan.n_chunks)
    sm.note(f"17c: {name} {semi} ({what}, {plan.n_chunks} chunks): "
            f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']:.4f} ms, library "
            + (f"{rec['library_ms']:.4f} ms" if lib is not None else "none")
            + f" [{ident}]")
    return rec


def ops_part(sm: Smoke, ident: str) -> dict:
    """17c: the ops rig on the busiest partition of kron-16."""
    import numpy as np
    import torch
    from repro_torch.core import partition_and_build
    from repro_torch.graphgen import kronecker_graph
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_combine as sk
    dev = torch.device(DEVICE)
    g = kronecker_graph(OPS_SCALE, seed=3, weighted=True)
    pg = partition_and_build(g, OPS_PARTS, "cdbh")
    p = int(np.argmax(pg.edges_per_part))
    m = pg.emask[p]
    src = pg.esrc[p][m].astype(np.int64)
    dst = pg.edst[p][m].astype(np.int64)
    w = pg.ew[p][m]
    nv = int(pg.vertices_per_part[p])
    vals = np.random.default_rng(0).uniform(0, 2, (nv, 1)).astype(
        np.float32)
    cells = [(k, s) for k in ("tiles", "windowed")
             for s in ("plus_times", "min_plus")]
    bk.bsp_spmv.launches = 0
    sk.segment_combine_windowed.launches = 0
    card = {}
    for kernel, semi in cells:
        card[(kernel, semi)] = ops.spmv(src, dst, w, vals, nv,
                                        semiring=semi, kernel=kernel,
                                        device=dev)
    torch.cuda.synchronize()
    launches = {"bsp_spmv": bk.bsp_spmv.launches,
                "segment_combine_windowed":
                    sk.segment_combine_windowed.launches}
    sm.check(launches["bsp_spmv"] == 2
             and launches["segment_combine_windowed"] == 2,
             f"17c: ops.spmv launched each kernel once per semiring "
             f"{launches}")
    for kernel, semi in cells:
        want = ops.spmv(src, dst, w, vals, nv, semiring=semi, kernel=kernel,
                        device="cpu")
        mag = None
        if semi == "plus_times":
            mag = ops.spmv(src, dst, np.abs(w), np.abs(vals), nv,
                           semiring=semi, kernel=kernel, device="cpu")
        ok, err = compare(card[(kernel, semi)].cpu(), want, mag)
        sm.check(ok, f"17c: ops.spmv {kernel} {semi} on the card vs the "
                     f"CPU (max err {err:.3g})")
    vdev = torch.from_numpy(vals).to(dev)
    rows = [ops_row(sm, kernel, semi, inp, ident) for (kernel, semi), inp
            in ops_inputs(src, dst, w, nv, vdev).items()]
    return dict(launches=launches, rows=rows, edges=int(src.shape[0]),
                vertices=nv, partition=p)


def graph_tools_path(sm: Smoke, ident: str) -> dict:
    """Phase 17: 17a the graph examples, 17b the lint, 17c the ops rig."""
    t0 = time.perf_counter()
    rec = {}
    for label, part in (("17a", examples_part), ("17b", lint_part),
                        ("17c", lambda s: ops_part(s, ident))):
        t = time.perf_counter()
        rec[label] = part(sm)
        sm.note(f"{label}: {time.perf_counter() - t:.1f}s")
    rec["seconds"] = time.perf_counter() - t0
    sm.note(f"phase 17: {rec['seconds']:.1f}s [{ident}]")
    return rec


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    sm = Smoke()
    phase_s = {}                  # seconds per phase, 1-17
    t_phase = time.perf_counter()
    ident = gpu_identity()
    sm.note(f"gpu: {ident}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    took = _build.build()
    sm.note(f"kernels built in {time.perf_counter() - t:.1f}s (parallel "
            f"nvcc): " + ", ".join(f"{k} {v:.1f}s" for k, v in took.items()))
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                sm.note(f"ptxas {name}: {line.strip()}")

    phase_s["1"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    errs = {"bsp_spmv": 0.0, "segment_combine": 0.0}
    kernel_case_grid(sm, errs)
    small_graph_check(sm)
    phase_s["2"] = time.perf_counter() - t_phase

    log: list = []
    bk.bsp_spmv.launches = 0
    sk.segment_combine_windowed.launches = 0
    peak = {}
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    win = windows_path(sm, log)
    peak["windows path"] = torch.cuda.max_memory_allocated()
    w_launch = (bk.bsp_spmv.launches, sk.segment_combine_windowed.launches)
    phase_s["3"] = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    tile = tiles_path(sm, log)
    peak["tiles path"] = torch.cuda.max_memory_allocated()
    phase_s["4"] = time.perf_counter() - t_phase
    for path, nbytes in peak.items():
        sm.note(f"peak device memory, {path}: {nbytes} bytes "
                f"({nbytes / 2**30:.2f} GiB; torch.cuda.max_memory_allocated)")
    launches = {"bsp_spmv": bk.bsp_spmv.launches,
                "segment_combine_windowed":
                    sk.segment_combine_windowed.launches}
    sm.note(f"launches: windows path {w_launch[1]} segment_combine, "
            f"{w_launch[0]} bsp_spmv; after tiles path {launches}")
    sm.check(w_launch[1] > 0, "windows path launched segment_combine")
    sm.check(launches["bsp_spmv"] - w_launch[0] > 0,
             "tiles path launched bsp_spmv")
    syncs = sum(r["host_syncs"] for r in log)
    sm.note(f"host syncs over {len(log)} main-path queries: {syncs}")

    t_phase = time.perf_counter()
    recs = main_path_kernels(sm, errs, win, tile)
    phase_s["5"] = time.perf_counter() - t_phase

    bk.bsp_spmv.launches = 0
    sk.segment_combine_windowed.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    stream = streaming_path(sm, log, win, tile, ident)
    peak["streaming"] = torch.cuda.max_memory_allocated()
    stream_launches = {"bsp_spmv": bk.bsp_spmv.launches,
                       "segment_combine_windowed":
                           sk.segment_combine_windowed.launches}
    sm.note(f"launches in the streaming phase: {stream_launches}")
    sm.check(all(v > 0 for v in stream_launches.values()),
             "the streaming phase launched both kernels")
    stream_kernel_checks(sm, errs, win, tile, stream)
    phase_s["6"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    algos = algos_path(sm, log, errs, win, tile)
    peak.update({f"algorithms, {k}": v for k, v in algos["peak"].items()})
    phase_s["7"] = time.perf_counter() - t_phase
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    shard_lists = shard_lists_path(sm, errs, win, tile)
    peak["shard lists (10a)"] = torch.cuda.max_memory_allocated()
    phase_s["10"] = time.perf_counter() - t
    sm.note(f"10a: {time.perf_counter() - t:.1f}s")
    # close the earlier sessions, so that phase 8's peak is its own
    g20 = win[2]
    win = tile = None
    stream = dict(steps=stream["steps"])
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    auto = auto_path(sm, log, errs, g20, ident)
    peak["auto and rebalance"] = auto["peak"]
    phase_s["8"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    serve = serving_path(sm, log, errs, auto.pop("sess"), g20)
    peak["serving"] = serve["peak"]
    phase_s["9"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = shard_ranks_path(sm, g20)
    errs["bsp_spmv"] = max(errs["bsp_spmv"], ranks["list_err"]["bsp_spmv"])
    errs["segment_combine"] = max(
        errs["segment_combine"],
        ranks["list_err"]["segment_combine_windowed"])
    nccl = nccl_path(sm)
    shard_launches = {k: ranks["launches"][k] + nccl["launches"][k]
                      for k in ranks["launches"]}
    sm.check(all(v > 0 for v in shard_launches.values()),
             f"phase 10's sharded runs launched both kernels "
             f"{shard_launches}")
    sm.note(f"phase 10b-c: {time.perf_counter() - t:.1f}s")
    phase_s["10"] += time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_path(sm, ident)
    peak["lm serve (11a)"] = lm["serve"]["peak_bytes"]
    peak["lm 32k request (11b)"] = lm["long"]["peak_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_path(sm, ident)
    for label, _, _ in MOE_CELLS:
        peak[f"moe serve ({label})"] = moe[label]["peak_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    jamba = jamba_path(sm, ident)
    peak["jamba serve (13a)"] = jamba["13a"]["peak_bytes"]
    peak["jamba 4k request (13b)"] = jamba["13b"]["peak_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    xlstm = xlstm_path(sm, ident)
    peak["xlstm serve (14a)"] = xlstm["14a"]["peak_bytes"]
    peak["xlstm 4k request (14b)"] = xlstm["14b"]["peak_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    encdec = encdec_path(sm, ident)
    for label, _, _, _ in ENCDEC_CELLS:
        peak[f"{encdec[label]['arch']} serve ({label})"] = \
            encdec[label]["peak_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    train = train_path(sm, ident)
    peak["train step (16a)"] = train["16a"]["peak_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    graph_tools = graph_tools_path(sm, ident)
    for k, rec in (("11", lm), ("12", moe), ("13", jamba), ("14", xlstm),
                   ("15", encdec), ("16", train), ("17", graph_tools)):
        phase_s[k] = rec["seconds"]
    phase_s = {k: round(phase_s[k], 1) for k in sorted(phase_s, key=int)}
    lm_s = sum(phase_s[k] for k in ("11", "12", "13", "14", "15", "16"))
    sm.note(f"phases 11-16: {lm_s:.1f}s")
    kernels = []
    for r in recs:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_OPS_PER_S * 1e3
        err_key = "bsp_spmv" if r["name"] == "bsp_spmv" else "segment_combine"
        ops17 = [o for o in graph_tools["17c"]["rows"]
                 if o["name"] == r["name"]]
        errs[err_key] = max([errs[err_key]]
                            + [o["max_abs_err"] for o in ops17])
        sm.note(f"{r['name']}: {r['shape']}; {r['bytes']} bytes, {r['ops']} "
                f"ops")
        extra = {k: r[k] for k in ("padded_ms", "plus_times_ms",
                                   "plus_times_plain_ms",
                                   "plus_times_library_ms") if k in r}
        kernels.append(dict(
            name=r["name"], route=r["route"], source=r["source"],
            replaces=r["replaces"], launches=launches[r["name"]],
            max_abs_err=errs[err_key], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"],
            launches_streaming=stream_launches[r["name"]],
            launches_algos=algos["launches"][r["name"]],
            launches_auto=auto["launches"][r["name"]],
            launches_serving=serve["launches"][r["name"]],
            launches_shard=shard_launches[r["name"]],
            launches_ops=graph_tools["17c"]["launches"][r["name"]],
            k16=algos["rows"][r["name"]], ops17=ops17, **extra))
    Path(ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke_queries.json").write_text(
        json.dumps(dict(gpu=ident, queries=log, kernels=kernels,
                        stream_steps=stream["steps"],
                        rebalance_steps=auto["steps"],
                        autotune=dict(platform=auto["platform"],
                                      unit_costs=auto["unit_costs"]),
                        kron20_ebv=dict(routing_s=auto["ebv_s"],
                                        picks=auto["picks"]),
                        serving=dict(kron20=serve["kron20"],
                                     pool=serve["pool"]),
                        shard=dict(lists=shard_lists,
                                   ranks=ranks["reports"],
                                   ranks_s=ranks["seconds"],
                                   launches=shard_launches),
                        lm=lm, moe=moe, jamba=jamba, xlstm=xlstm,
                        encdec=encdec, train=train,
                        graph_tools=graph_tools, phase_seconds=phase_s,
                        peak_memory_bytes=peak,
                        algo_row_launches=algos["row_launches"],
                        kernel_shapes={r["name"]: r["shape"] for r in recs},
                        plus_times_library_error=recs[-1].get(
                            "plus_times_library_error")), indent=1))
    sm.note(f"total {time.perf_counter() - sm.t0:.1f}s")
    if sm.failures:
        print(f"chip_smoke: {len(sm.failures)} check(s) failed:",
              file=sys.stderr)
        for f in sm.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"phase_seconds": phase_s}))
    print(json.dumps({"kernels": kernels}))
    print(ident)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
