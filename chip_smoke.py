#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. build   - compiles the thirteen CUDA kernels from
             ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a into
             ``build/repro_torch_kernels/``, one nvcc per source, all at
             once; prints each entry's registers, shared memory and
             spills (none allowed in the entries of ``NO_SPILL``, the WKV
             scan, both ticks, Mamba's conv and scan and the five
             backward kernels, or in the bf16
             wgmma flash kernel at any head dim) and, where ``cuobjdump`` is
             installed, the tensor-core (HGMMA) instructions of the
             machine code of flash and of its backward (at least one
             each; the backward's ``dq_wgmma`` and ``dkdv_wgmma`` built
             at every head-dim pair, MLA's (192, 128) among them).
2. kernels - holds each kernel against its plain PyTorch version on the
             card at a mid-size shape and at every shape the main paths
             give it: the coherence ticks exactly (int32); RMSNorm in
             both cast orders, the TPU kernel's within one bf16 ulp and
             the cast-first order the models run within |w| one ulp of
             x_hat plus one ulp, differing from its plain twin in at most
             1e-4 of the elements (the TPU order, as a control, must fail
             that) (also
             on a view offset by one element, the kernel's
             element-by-element path, and at a qk-norm width);
             flash attention and flash decode within 1e-2 max-abs in bf16
             and 1e-5 in fp32 on unit-scale inputs, and in bf16 also
             element by element within one bf16 ulp of the plain value
             plus 2**-10 of its row's rms (flash decode at the batched
             request's shape on every kv_len its 32 steps give it, P + 1
             .. P + 32; the context cells' cross caches read whole,
             kv_len = L); flash attention also non-causal at the
             context cells' encoder and cross shapes (Lq != Lk), ragged
             and with Lq > Lk, with its row statistics held to
             ``LSE_REL``; flash and decode at MLA's (192, 128) head-dim
             pair at deepseek-v2-lite's shapes, flash in bf16 and fp32
             (SDPA's time where a fused backend takes Ev != E, else
             none); flash at per-row offsets (``FLASH_OFFSET_CASES``:
             the continued prefills of gemma-2b, deepseek-v2-lite and
             jamba, 4096 rows at 0, 1024, 1793, 2048 over a cache of
             6176, and a ragged one) in bf16 and fp32 within flash's
             gates, its offset-0 row bit for bit today's causal call
             over the first s keys, 50 repeats bit-equal, beside its
             bound (no library call takes a per-row offset); bf16 flash
             attention, flash decode, the WKV
             scan (fp32 and bf16), the MESI tick (every shape and
             strategy) and the chunk tick (both shapes) launched
             ``REPEATS`` more times at each shape after every timing,
             each output equal to the first bit for bit.  The tick rows
             give ``staged_sims``, the simulations a block of the
             kernel's staged path runs (0: its direct path).
             The MESI rows add ``sector_bound_ms`` (the 32-byte sectors
             the tick must touch) beside the word bound, the WKV rows
             ``issue_floor_ms`` (four fp32 instructions per state element
             per step over the card's fp32 lanes at its highest SM
             clock), and four ``host_split_us`` lines split the host
             time of a ``mesi_tick_``, an ``rwkv6_scan`` and a
             ``chunk_tick_`` call and of a kernel-route ``decide`` of the
             service's content broker (prefix batch, MESI tick launch,
             chunk tick launch, read-back, bookkeeping).  The ticks are
             also held at the service's shapes: (33, 32, 6) and
             (49, 48, 6) for the MESI tick, (1, 32, 6, 64) for the chunk
             tick, and at a shard's share of its 6 artifacts on the
             sharded plane, m = 1, 2, 4: (33, 32, m) and (1, 32, m, 64).
             Times the
             wrapper call (CUDA events), the kernel alone, the wrapper's
             host time, the plain version and, for the model kernels, the
             one PyTorch call that computes the same function (a
             yardstick the port never calls), beside the bound.  The
             RWKV6 WKV scan at the rwkv serving path's shapes (the batched
             and the agents' 6144-step prefills, a decode step from a
             random state) and a ragged bf16 mid shape: the final state
             bit for bit, y in fp32 within 1e-5 of the rms of its head's
             output and in bf16 within one bf16 ulp plus 2**-10 of its
             row's rms; no PyTorch call computes the recurrence, so it has
             no library time.  Mamba's causal conv and selective scan at
             jamba-1.5-large-398b's serving shapes (the batched and the
             agents' 6144-step prefills at d_inner 16384, the conv reading
             the x half of the input projection through its row stride;
             a decode step from a state), a ragged (2, 333, 384) one in
             both types and the smoke config's: the conv bit for bit or
             within one ulp of its type (its new state bit for bit), the
             scan's fp32 mode's y and state within 1e-5 of their rms, its
             gated mode (dt's softplus and the SiLU gate fused, in the
             model type, on the conv's output) within one ulp of the
             unfused chain it replaces and its state bit for bit, within
             1e-5 of the plain state's rms; and a long-memory case (dt =
             1e-3, a = -1 and -16 over 6144 steps) for both modes.  Each
             beside its bound, the scan also beside its MUFU floor (the
             gated mode's with its four MUFU operations a channel a step)
             and the gated mode beside the unfused chain's time, the conv
             beside ``F.conv1d`` + ``F.silu``.
3. scenarios - first the committed goldens on the threefry stream in
             legacy mode: ``tests/golden/scenarios.json`` exactly, then the
             zoo and content goldens with a count of the runs that differ
             (by family).  Then the paper's scenarios A-D (n=4, m=3,
             |d|=4096, S=40) with 4096 runs each: savings must clear the
             Token Coherence Theorem's bound and sit within 2.5 pp of the
             published table; the kernel and scan routes must agree on
             every statistic of the whole grid.
4. fleet   - the six-family workload zoo at n=16 agents, m=16 artifacts,
             4096 runs per family with 64-token chunks (24,576 episodes
             per variant): delta bytes never exceed whole-artifact bytes,
             and each kernel launches once per step; then eager and
             access_count at 1024 runs per family without content.
5. service - the live coherence service on the card: the JAX package's
             service bench grid (32 clients, 6 artifacts of 4096 tokens,
             lazy; its 40 lockstep rounds cut to 20) for each of the seven
             families
             (``uniform`` = zipf with skew 0 at V = 0.10) through brokers
             on both decision routes, with and without 64-token chunks,
             plus eager and access_count (k = 3) on ``bursty`` (kernel
             route) and K = 3 staleness on ``uniform`` (scan route).
             Every broker's trace passes the port's oracle
             (``verify_broker``, its kernel legs on the card; the K = 3
             broker, outside the oracle's scope, its live invariant
             checks) and the metrics conformance replay; the two routes
             decide alike step for step (with content, the chunks each
             fill shipped too); the kernel route launches exactly one
             MESI tick (with content one chunk tick) per micro-batch;
             the uniform kernel-route broker run on the CPU decides
             exactly as on the card.  Prints each broker's throughput,
             capacity, request and decide latency, micro-batches,
             savings against broadcast and warm-up seconds, then a
             profile of the uniform kernel-route brokers (the device's
             busy share, the host's time by function).  Then the sharded
             authority plane (the JAX package's sharded service bench:
             4 hosts' L1 directories), every plane built by
             ``service.connect`` on the kernel route, each of its K
             shards on its own CUDA stream: ``uniform`` at K = 1, 2, 4
             (throughput, capacity over the slowest shard's ``decide``
             time, each shard's ``decide`` p50 / p99 and micro-batches,
             request p50 / p99, L1 fill rate, warm-up), every family at
             K = 4 without and with 64-token chunks (ledgers equal to the
             plain broker's above; ``verify_broker``, here the sharded
             verifier, and the metrics conformance; one tick launch, and
             with content one chunk tick, per shard micro-batch); the
             scan route once at K = 4 deciding exactly as the kernel
             route; a profiled K = 4 run whose exported trace shows the
             tick kernels on 4 distinct streams, none the default one;
             the K = 4 plane on the CPU deciding exactly as on the card;
             the JSON-lines TCP frontend over a K = 4 plane answering a
             scripted session as the same script does in process (its
             round trips' p50 / p99, ``stats`` and ``metrics`` checked);
             and ``launch.service.main`` at K = 4 with ``--verify
             --verify-metrics``, its summary printed on one line.
   fleet_sharded - phase 4's content fleet sharded by the engine
             over 4 streams of the card (its placements standing in for
             4 cards, ``devices=4``): every per-run ledger equal to the
             unsharded run's, 4 launches of each tick a step, the
             padded-runs plan (4095 runs over 4) and the workloads-axis
             plan (4097 over 3) equal to their unsharded runs, and, from
             a profiler trace of the fleet cut to 4 steps, the shards'
             ticks on 4 distinct streams, none the default; with two or
             more cards also the public path asked for every card
             (``devices=cards``) and a K = 4 authority plane's shards on
             distinct cards.  Prints both runs' seconds and episodes/s
             and the phase's seconds beside its 15 s budget.
6. serve   - coherent serving on gemma-2b at its registered width (18
             layers, d 2048, MQA, head dim 256, vocab 256000, bf16) with
             random weights from ``SEED``: 4 agents, 3 artifacts of 2048
             tokens, 40 steps at V = 0.10, lazy; every agent's context
             prefilled (cache 8192), then one batched request (the
             contexts cut to their common length P, prefilled at B = 4
             into a cache of P + 32, then 32 greedy decode steps).  Checks
             finite logits, the launch counts (37 rmsnorm per forward, 18
             flash_attention per prefill, 18 decode_attention per step)
             and the same request on the plain versions: relative L2 error
             of the prefill's last-position logits <= 2e-2 and of every
             decode step's <= 2.5e-2; then the prompt through the layers
             one at a time on both routes, each layer's own share of
             their distance <= 1e-2.  Profiles one batched prefill
             (top device operations, flash attention's share) and eight
             decode steps.  Then a continued prefill (``CONTINUE_OFFSETS``,
             also in ``serve_deepseek`` and ``serve_jamba``): row b's
             cache filled by a one-row prefill of its request's first o_b
             tokens, then one batched cached prefill of the next 4096 at
             ``cache_len = o`` through ``_run_layers``: exactly one
             flash_attention launch per attention layer (counted apart
             from the phase's launch gate), each row's last-position
             logits within the cell's prefill limit of a one-row
             one-shot prefill of its o_b + 4096 tokens and of the same
             continued prefill on the plain route, every attention cache
             row in [0, o_b + 4096) within 1e-2 of the one-shot
             prefill's, layer by layer; its tokens/s.  Every serve and
             train phase prints an ``analytic`` line (not gated): the
             port's ``analytic_cost`` at one card for its cell, the
             roofline bound on this card, the measured time's share of
             it and ``model_flops_for``'s share of the bf16 peak.
7. serve_rwkv - the same serving workload on rwkv6-1.6b at its
             registered width (24 layers, d 2048, 32 heads of 64,
             channel-mix 7168, vocab 65536, bf16) with random weights from
             ``SEED``: finite logits, exactly 73 rmsnorm and 24 rwkv6_scan
             launches per forward and no attention launch; the plain route
             within relative L2 4.5e-2 (prefill) and 5e-2 (every decode
             step), set from the per-layer readings in PERF.md, and each
             layer's own share <= 1e-2.  Then ``serve_moe``, the same
             workload on olmoe-1b-7b (16 layers, d 2048, 16 heads of 128,
             64 experts top 8 of width 1024, vocab 50304, bf16, 6.9 B):
             33 rmsnorm per forward, 16 flash_attention per
             prefill, 16 decode_attention per step; the plain route run
             on the kernel route's expert choices, as on its greedy
             tokens, within gemma-2b's gates (2e-2 / 2.5e-2, each layer
             1e-2), and the tokens whose top-k set of experts the plain
             route would choose otherwise counted per layer and over the
             request.  Then the context families, each cross-attention
             gate set to 1.0 (tanh 0.76; the reference's init 0 would
             multiply the context away) and, in whisper's layernorm, each
             norm scale drawn as 1 + 0.3 N(0, 1) and each bias as
             0.1 N(0, 1) from ``SEED``: ``serve_whisper``, the same
             workload on whisper-medium at its registered width (24
             encoder and 24 decoder layers, d 1024, 16 heads of 64,
             vocab 51968, 0.81 B), every prefill with stub frames of 4096
             (``_ctx_len``), 72 flash_attention per prefill (the encoder's
             24 and the cross sublayers' 24 non-causal), 48
             decode_attention per step (24 over the cross caches) and no
             rmsnorm; ``serve_vlm``, llama-3.2-vision-90b at its published
             width cut to its first superblock of 5 layers (cross layer
             3, 6.38 B) with 1024 vision embeddings, 11 rmsnorm per
             forward, 5 flash_attention per prefill, 5 decode_attention
             per step;
             both within gemma-2b's gates, each layer's share (whisper's
             encoder walked layer by layer first) within 1e-2, and, as
             controls, no context and another seed's each moving every
             row's prefill logits by more than ``CONTEXT_NOISE`` times
             the row's kernel-vs-plain distance.  Then
             ``serve_deepseek``, the same workload on
             deepseek-v2-lite-16b at its registered width (27 MLA layers,
             d 2048, 16 heads with a q / k head of 192 and a v head of
             128 over a latent cache of rank 512, 64 experts top 6 with 2
             shared, the first layer dense, vocab 102400, bf16, 15.71 B):
             82 rmsnorm per forward (the latent's kv_norm a third a
             layer), 27 flash_attention per prefill, 27 decode_attention
             per step, gemma-2b's gates scaled by the depth (2.5e-2 /
             3e-2) with the plain route on the kernel route's experts
             and the flips counted, each layer's
             share (its dense first layer an unstacked prefix) within
             1e-2, and what expanding the latent cache costs a decode
             step (``mla_expansion``).  Then ``serve_jamba``,
             jamba-1.5-large-398b at its published width cut to its first
             5 layers (Mamba at 0-3 with d_inner 16384 and d_state 16,
             attention at 4 with 64 heads and 8 KV heads of 128, the MoE's
             16 experts top 2 of width 24576 at 1 and 3, dense GLUs of
             24576, vocab 65536; 24.05 B), every ``conv_b`` drawn as
             0.1 N(0, 1) and ``d_skip`` as 1 + 0.3 N(0, 1): 11 rmsnorm, 4
             causal_conv1d and 4 selective_scan per forward, 1
             flash_attention per prefill, 1 decode_attention per step,
             gemma-2b's gates with the plain route on the kernel route's
             experts and the flips counted, each layer's share within
             1e-2.
8. train   - training of gemma-2b and of rwkv6-1.6b at their registered
             widths (random weights from ``SEED``, bf16, 2.51 B / 1.60 B
             parameters) on 4 x 2048-token batches of the port's
             synthetic stream: the first step's loss and every gradient
             leaf on the kernel route within ``TRAIN_LOSS_REL`` /
             ``TRAIN_GRAD_REL_L2`` of the plain route (the worst leaf
             named; rwkv6-1.6b also in fp32 at 1 x 1024 tokens, within
             ``TRAIN_FP32_GRAD_REL_L2``); then 4 steps of ``make_train_step`` with
             ``AdamWConfig()``, exactly 73 rmsnorm, 37 rmsnorm_bwd (a
             wrapper call each: the rows pass and its dweight sum), 36
             flash_attention (18 recomputed) and 18 flash_attention_bwd
             launches a step on gemma-2b, 145 rmsnorm, 73 rmsnorm_bwd,
             48 rwkv6_scan (24 recomputed, each writing its state every
             64 steps) and 24 rwkv6_scan_bwd on rwkv6-1.6b; prints the
             step time, tokens/s, model TFLOP/s and its share of the bf16
             peak, peak memory and the idle share of a profiled step.
             Then whisper-medium (``TRAIN_WHISPER``: 4 x 4096 frames and
             1024 decoder tokens) the same way, its gates and layernorm
             moved as in phase 7: 144 flash_attention (72 recomputed, 96
             non-causal) and 72 flash_attention_bwd (48 non-causal) a
             step, no rmsnorm, every encoder and cross leaf's gradient
             non-zero.  Then deepseek-v2-lite-16b cut to its dense first
             layer (``TRAIN_DEEPSEEK``: MLA at the (192, 128) pair and
             the dense feed-forward at 10944, 0.50 B): 7 rmsnorm, 4
             rmsnorm_bwd, 2 flash_attention and 1 flash_attention_bwd a
             step, every MLA leaf's gradient non-zero.  Then
             jamba-1.5-large-398b cut to its first layer (``TRAIN_JAMBA``:
             Mamba and the dense feed-forward at 24576, 2.10 B): 5
             rmsnorm, 3 rmsnorm_bwd, 2 causal_conv1d, 1
             causal_conv1d_bwd, 2 selective_scan (one recomputed, each
             writing its state every 8 steps) and 1 selective_scan_bwd a
             step, every Mamba leaf's gradient non-zero (9 of 9).  Then
             ``run_training`` on the card at
             qwen3-1.7b's smoke config, crashed at step 25 and resumed
             from 20 with the uninterrupted run's losses, and the training
             CLI for 3 steps.  The backward kernels are held in phase 2
             too: ``flash_attention_bwd`` (gemma-2b's and qwen3-1.7b's
             training shapes, mid fp32 / bf16, a ragged length, with
             the dK/dV pass's head split, and without it where it
             splits; whisper's training shapes, its encoder's and cross
             attention's non-causal, and two ragged non-causal ones;
             deepseek-v2-lite's (4, 16, 16, 2048) at the (192, 128) pair
             and a ragged fp32 one;
             each pass's device time from
             one profiled call, after phase 8) and ``rmsnorm_bwd`` in
             both cast orders (``RMS_BWD_CASES``: (8192, 2048), the
             qk-norm width, mid fp32, a ragged width; its plan, the grid
             and the ring's stages, printed beside each, and the device
             time of its two launches from one profiled call, after
             phase 8)
             against autograd of their plain versions
             (fp32 within 1e-4 of the reference's largest magnitude; bf16
             relative L2 within 1e-2 and each element within 2 bf16 ulps
             plus 2**-8 of its tensor's rms), timed beside their bounds
             (and their share of it) and the backward of
             ``scaled_dot_product_attention`` / ``F.rms_norm``, and
             ``REPEATS`` more launches bit-equal;
             the forward flash kernel is timed with and without its row
             statistics; and ``rwkv6_scan_bwd`` at rwkv6-1.6b's training
             shape (4, 2048, 32, 64) and a ragged (2, 333, 2, 64) from the
             forward's checkpoints, against the plain reverse recurrence
             at the fp32 gate, its device memory beyond its inputs and
             outputs at most du's B * H * dh float partials plus 1 MiB,
             beside its bound, its issue floor and the plain version (no
             library call computes it), with the checkpointing forward
             timed against the serving launch; and Mamba's two backward
             kernels at jamba-1.5-large-398b's training shape (4, 2048,
             16384, 16; the conv in bf16) and a ragged fp32 one, the
             scan's from the checkpoints of the forward as training
             launches it (which equals the serving launch bit for bit)
             and its device memory beyond its inputs and outputs at most
             its stated scratch plus 1 MiB, each beside its bound and the
             plain version, the conv's beside autograd of ``F.conv1d`` +
             ``F.silu``, 50 more launches bit-equal.
   serve_tp - tensor-parallel serving, after every timed phase: the
             one-rank port's batched request on ``serve_vlm``'s model
             (the reference, whose card memory is freed first), then two
             ranks over a (data 1, model 2) mesh, each its own process
             (``--serve-tp-rank``; two gloo processes on the one card,
             or one card a rank over NCCL where there are two or more),
             each holding half the heads, FFN channels and vocab rows
             (``shard_params``) and serving the same request through
             ``make_prefill_step`` / ``make_decode_step`` over the mesh,
             the decode steps fed the reference's greedy tokens: each
             rank's first attention output before ``wo`` within
             ``TP_ATTENTION_REL_L2`` of its heads' slice of the
             reference's, the logits within ``TP_LOGITS_REL_L2``, the
             greedy tokens that differ counted, exactly 5 flash_attention
             (4 causal, 1 non-causal), 5 decode_attention a step and 11
             rmsnorm a forward a rank.  On a host with 4 cards also all
             100 layers over (data 1, model 4), one card a rank, each
             drawing only its shard (``draw_shard``): finite logits,
             exact launches, prefill and decode tokens/s, each card's
             peak memory, a profiled decode step and one all_reduce's
             time at the prefill's and a decode step's shapes.  Every
             rank is joined (killed at a deadline or at the first
             failure); a failed rank fails the run.
9. the ``kernels`` line (``selective_scan``'s row is its gated mode,
   which the serving paths launch, with its fp32 mode's under
   ``fp32_mode``), the card's name and power limit, and the final
   ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --wkv-bwd-turns SRC...`` builds each given
source of the WKV backward (this tree's, an earlier tree's unpacked
under ``build/``, or a probe variant) into a library of its own and
times them alone at rwkv6-1.6b's training shape in turns
(:func:`wkv_bwd_turns`); ``--rmsnorm-bwd-turns SRC...`` does the same
for the RMSNorm backward at its two training shapes in both cast
orders, with each launch's device time (:func:`rmsnorm_bwd_turns`).
``--mamba-turns ROOT...`` runs each tree's own Mamba kernel checks and
its two jamba cells from its root, in turns (:func:`mamba_turns`).
``--sass KERNEL SRC...`` builds each given source of ``causal_conv1d`` or
``selective_scan`` the same way and counts its machine code's
instructions by opcode in the loop that writes the output, per output
element (the conv) or per exponential, i.e. per state element a step
(the scan's fp32 mode) (:func:`sass_counts`).

Phases 3-4 (the sweep engine), 5 (the service), 6 and 7 (serving, seven
cells), 8 (training, five cells) and serve_tp are the main paths
(serve_tp's launches are its ranks', summed); each path's kernels' launch counts are
set to 0 just before it and read just after.  Any failed check raises,
and the script then exits non-zero.  Without a CUDA device, or without the
repository's ``src/`` beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SEED = 20260305

#: paper Table 1 savings (lazy vs broadcast, SS8.2)
PUBLISHED = {"A": 0.950, "B": 0.923, "C": 0.883, "D": 0.842}
PUBLISHED_TOLERANCE = 0.025

#: mid-size, then every shape the main paths give the kernel: the four
#: scenarios' batch, the eager/access_count fleets, the service's
#: decisions (B = n + 1 prefix simulations: n = 32 clients, the staged
#: path's top, and n = 48, the direct path; for the chunk tick one
#: simulation), a shard's share of the 6 artifacts on the sharded plane
#: (K = 2: 2 / 4, K = 4: 1 / 2 / 1 / 2), the content fleet (last: the
#: ``kernels`` line reports this one)
MESI_SHAPES = ((8192, 16, 16), (16384, 4, 3), (6144, 16, 16),
               (33, 32, 6), (49, 48, 6),
               (33, 32, 1), (33, 32, 2), (33, 32, 4), (24576, 16, 16))
CHUNK_SHAPES = ((4096, 16, 16, 64), (1, 32, 6, 64),
                (1, 32, 1, 64), (1, 32, 2, 64), (1, 32, 4, 64),
                (24576, 16, 16, 64))
FLEET_RUNS = 4096
#: runs per family of the eager / access_count fleets, per scenario of
#: the A-D grid
STRATEGY_FLEET_RUNS = 1024
#: phase ``fleet_sharded``: the streams of the card its shards run on,
#: and the fallback plans it checks, (runs, shards, the plan's axis)
FLEET_SHARDS = 4
#: steps of the fleet whose trace phase ``fleet_sharded`` reads (a
#: profiled step of the grid is ~10 ms of host time a shard)
FLEET_TRACE_STEPS = 4
#: the seconds phase ``fleet_sharded`` is meant to take, reported beside
#: its own
FLEET_SHARDED_BUDGET_S = 15.0
FLEET_FALLBACKS = ((FLEET_RUNS - 1, FLEET_SHARDS, "runs"),
                   (FLEET_RUNS + 1, 3, "workloads"))
SCENARIO_RUNS = 4096
#: GPU clock cycles a spin kernel holds the stream for (about 5 ms at
#: 1980 MHz): it must outlast the wrapper's host work, and on a busy host
#: ``mesi_tick``'s wrapper can take more than 1 ms
SPIN_CYCLES = 10_000_000
#: how many times a spin is doubled and its work run again when the host's
#: work outlasted it (a host busy with other work) before a timing fails
SPIN_DOUBLINGS = 5
#: launches of bf16 flash attention, flash decode, the WKV scan and the
#: MESI tick at each checked shape that must equal the first bit for bit
#: (flash's K/V ring is shared by two warpgroups, so a stage overwritten
#: too early shows in some launches and not others; decode merges its
#: splits behind tickets that must return to 0 after every launch, in
#: split order whichever block finishes last; the scan's stage ring and
#: the tick's staged slabs are reused the same way)
REPEATS = 50
#: kernels none of whose entries may spill registers (the build phase)
NO_SPILL = ("rwkv6_scan", "mesi_tick", "chunk_tick", "flash_attention_bwd",
            "rmsnorm_bwd", "rwkv6_scan_bwd", "causal_conv1d",
            "causal_conv1d_bwd", "selective_scan", "selective_scan_bwd")
#: fp32 lanes of an SM on Hopper (the issue floor of the WKV scan)
FP32_LANES_PER_SM = 128
#: host-time samples of each piece of a wrapper call (``host_split``)
HOST_SPLIT_CALLS = 50
#: a qk-norm width (the per-head norm of q and k at head dim 128)
QK_NORM_WIDTH = 128
REPLACES = {
    "mesi_tick": ("src/repro_torch/kernels/csrc/mesi_tick.cu",
                  "src/repro/kernels/mesi_transition.py:151"),
    "chunk_tick": ("src/repro_torch/kernels/csrc/chunk_tick.cu",
                   "src/repro/kernels/chunk_diff.py:131"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:29"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:71"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:63"),
    # no Pallas kernel of the JAX package has a backward: these replace
    # jax.grad of the functions it trains through
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:76 _sdpa_block (jax.grad)"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                    "src/repro/models/common.py:46 norm_apply (jax.grad)"),
    "rwkv6_scan_bwd": ("src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
                       "src/repro/models/rwkv6.py:142 rwkv_time_mix_apply's "
                       "chunked scan of _wkv_step (jax.grad)"),
    # Mamba has no Pallas kernel in the JAX package: these replace its
    # plain JAX conv and chunked scan, and jax.grad of each
    "causal_conv1d": ("src/repro_torch/kernels/csrc/causal_conv1d.cu",
                      "src/repro/models/mamba.py:65 _conv1d_causal"),
    "causal_conv1d_bwd": ("src/repro_torch/kernels/csrc/causal_conv1d_bwd.cu",
                          "src/repro/models/mamba.py:65 _conv1d_causal "
                          "(jax.grad)"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/models/mamba.py:116 mamba_apply's chunked "
                       "scan of _ssm_step and its skip (:144); serving "
                       "also dt's softplus (:82) and the SiLU gate (:145)"),
    "selective_scan_bwd": ("src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
                           "src/repro/models/mamba.py:116 mamba_apply's "
                           "chunked scan of _ssm_step (jax.grad)"),
}
#: the service cell of phase 5: the JAX package's service bench grid
#: (``benchmarks/service_bench.py``): 32 clients, 6 artifacts of 4096
#: tokens, lazy, its 40 lockstep rounds halved to 20 (the run's depth cut
#: so that the hybrid family's phases fit the time limit; every gate is
#: kept); the content plane's brokers cut the artifacts into 64-token
#: chunks
SERVICE = dict(clients=32, artifacts=6, artifact_tokens=4096, rounds=20,
               strategy="lazy", chunk_tokens=64)
#: the service's workload families and their seeds (the bench's)
SERVICE_FAMILIES = ("uniform", "bursty", "zipf", "hierarchical", "rag",
                    "pipeline", "ping_pong")
SERVICE_SEEDS = {f: 20260701 + i for i, f in enumerate(SERVICE_FAMILIES)}
#: the sharded authority plane of phase 5 (the JAX package's sharded
#: service bench, ``benchmarks/service_bench.py:64-67, 90-96``): the
#: uniform capacity sweep's shard counts (every family at the last), and
#: the L1 placement domains; each shard on its own CUDA stream of the card
SERVICE_SHARDS = (1, 2, 4)
SERVICE_HOSTS = 4
#: requests of the scripted JSON-lines session over the TCP frontend
TCP_REQUESTS = 200
#: the serving workload of phase 6
SERVE = dict(arch="gemma-2b", agents=4, artifacts=3, artifact_tokens=2048,
             steps=40, volatility=0.10, strategy="lazy", max_len=8192,
             decode_steps=32)
#: the serving workload of phase 7: the same on rwkv6-1.6b, and on
#: olmoe-1b-7b (16 layers, d 2048, 16 heads of 128, 64 experts top 8 of
#: width 1024, vocab 50304, bf16)
SERVE_RWKV = dict(SERVE, arch="rwkv6-1.6b")
SERVE_MOE = dict(SERVE, arch="olmoe-1b-7b")
#: the context families' serving cells: whisper-medium at its registered
#: width (24 encoder and 24 decoder layers, d 1024, 16 heads of 64, d_ff
#: 4096, vocab 51968, layernorm with biases, bf16), its stub frames
#: ``_ctx_len``'s 4096; llama-3.2-vision-90b at its published width (d
#: 8192, 64 heads, 8 KV heads of 128, d_ff 28672, vocab 128256) cut to
#: its first ``n_layers`` 5 (its first superblock of the published period
#: 5, cross layer 3: 6.38 B of its 87.7 B, which do not fit 80 GB; cut
#: from 10 layers to buy phase ``serve_tp`` its room), 1024 image tokens
#: of vision embeddings
SERVE_WHISPER = dict(SERVE, arch="whisper-medium")
SERVE_VLM = dict(SERVE, arch="llama-3.2-vision-90b", n_layers=5)
#: phase ``serve_tp``: tensor-parallel serving of ``SERVE_VLM``'s model
#: and request (4 x 6144 prompt tokens, 1024 image tokens, 32 decode
#: steps) over a mesh (data 1, model ``tp``), held to the one-rank port;
#: on a host with 4 cards also llama-3.2-vision-90b's 100 layers over
#: (data 1, model 4), one rank a card, each drawing only its shard
SERVE_TP = dict(SERVE_VLM, tp=2)
SERVE_TP_FULL = dict(SERVE_VLM, n_layers=100, tp=4)
#: where serve_tp's ranks find the reference and leave their results
TP_DIR = REPO / "build" / "serve_tp"
#: seconds serve_tp's ranks may take together, by mode
TP_DEADLINE_S = {"check": 600, "full": 1500}
#: decode steps of the full-depth run profiled after the timed ones
TP_PROFILED_STEPS = 2
#: MLA's serving cell: deepseek-v2-lite-16b at its registered width (27
#: layers, d 2048, 16 heads with a q / k head of 128 + 64 rope and a v
#: head of 128 over a latent cache of rank 512, 64 routed experts top 6
#: of width 1408 with 2 shared, the first layer dense at 10944, vocab
#: 102400, bf16, 15.71 B), the MoE at its capacity factor 1.25
SERVE_DEEPSEEK = dict(SERVE, arch="deepseek-v2-lite-16b")
#: the hybrid family's serving cell: jamba-1.5-large-398b at its registered
#: width (d 8192, 64 heads with 8 KV heads of 128, Mamba with d_inner 16384,
#: d_state 16, d_conv 4, dt_rank 512; the MoE's 16 experts top 2 of width
#: 24576 on the odd layers, the rest dense at 24576; vocab 65536, bf16)
#: cut to its first ``n_layers`` 5 (Mamba at 0-3, attention at 4, MoE at
#: 1 and 3: 24.05 B of its 398.6 B, which do not fit 80 GB)
SERVE_JAMBA = dict(SERVE, arch="jamba-1.5-large-398b", n_layers=5)
#: the continued prefill of phases ``serve``, ``serve_deepseek`` and
#: ``serve_jamba``: row b's cache filled by a one-row prefill of its
#: request's first o_b tokens, then one batched cached prefill of the next
#: ``CONTINUE_TOKENS`` at ``cache_len = o`` (the batch's cache is the
#: batched request's, P + 32 = 6176 long); 1793 lies off every key tile,
#: and jamba's Mamba layers take prompts only in multiples of their scan
#: chunk (128), as the reference asserts, so its third row starts at 1792
CONTINUE_TOKENS = 4096
CONTINUE_OFFSETS = {"gemma-2b": (1024, 1536, 1793, 2048),
                    "deepseek-v2-lite-16b": (1024, 1536, 1793, 2048),
                    "jamba-1.5-large-398b": (1024, 1536, 1792, 2048)}
#: every attention cache row in [0, o_b + CONTINUE_TOKENS) of the continued
#: prefill against the one-shot prefill's, layer by layer (relative L2)
CONTINUE_CACHE_REL_L2 = 1e-2
#: the MoE capacity factor at which an MoE cell's continued prefill is
#: held to its one-shot prefill.  At the cell's own 1.25 an expert drops
#: the pairs past its capacity, and which pairs it drops depends on every
#: token of the call, so the two are different functions (deepseek's
#: caches parted from the one-shot prefill's by 0.13 after its first MoE
#: layer); at this factor no pair drops in either (checked on the routes
#: dispatched), and the two are the same function.  With random routers
#: one of deepseek's 64 experts takes ~8x its capacity at 1.25, nearly
#: every token (so 11: a capacity over every token); jamba's busiest of 16
#: takes 1.02x at 1.25 and 0.42x at 3, which fits the card beside its
#: weights (its experts are 24576 wide)
CONTINUE_DROP_FREE = {"deepseek-v2-lite-16b": 11.0,
                      "jamba-1.5-large-398b": 3.0}
#: the batched request's cache: its prompt (3 artifacts of 2048 tokens)
#: and its 32 decode steps
SERVE_CACHE = SERVE["artifacts"] * SERVE["artifact_tokens"] \
    + SERVE["decode_steps"]
#: flash at per-row offsets in phase ``kernels`` (label, b, Hq, Hkv, s,
#: Lk, D or a (D, Dv) pair, offsets): the three continued prefills'
#: attention (gemma-2b's MQA at 256, deepseek-v2-lite's MLA pair,
#: jamba's GQA at 128) over the batched request's cache, rows at 0, 1024,
#: 1793 and 2048, and a ragged one over a cache of 1000
FLASH_OFFSET_CASES = (
    ("gemma-2b continued prefill", 4, 8, 1, CONTINUE_TOKENS, SERVE_CACHE,
     256, (0, 1024, 1793, 2048)),
    ("deepseek continued prefill", 4, 16, 16, CONTINUE_TOKENS, SERVE_CACHE,
     (192, 128), (0, 1024, 1793, 2048)),
    ("jamba continued prefill", 4, 64, 8, CONTINUE_TOKENS, SERVE_CACHE,
     128, (0, 1024, 1793, 2048)),
    ("ragged", 2, 4, 2, 333, 1000, 64, (0, 667)))
#: each serving workload's phase name, by arch
SERVE_PHASES = {"gemma-2b": "serve", "rwkv6-1.6b": "serve_rwkv",
                "olmoe-1b-7b": "serve_moe", "whisper-medium": "serve_whisper",
                "llama-3.2-vision-90b": "serve_vlm",
                "deepseek-v2-lite-16b": "serve_deepseek",
                "jamba-1.5-large-398b": "serve_jamba"}
#: every cross-attention gate is set to this after the init (tanh 0.76):
#: the reference draws it 0, and tanh(0) = 0 multiplies the context away;
#: the layernorm scales are drawn as 1 + 0.3 N(0, 1) and every bias as
#: 0.1 N(0, 1) (from ``SEED``) for the same reason
CROSS_GATE = 1.0
#: the controls of a context cell: the prefill's last-position logits
#: without a context (empty cross caches, no encoder) and with another
#: seed's must each move, every row, by more than this many times the
#: row's own kernel-vs-plain distance (relative L2).  Ten times the route
#: gate is out of reach with random weights: a cross attention over 4096
#: frames (1024 image tokens) of iid N(0, 1) draws has nearly flat
#: softmax rows, so its output is mostly the keys' mean, which another
#: seed hardly moves, and the vlm's mean of iid embeddings is near 0, so
#: its cross layers move its logits by ~4-6 % in all (readings, as
#: multiples of the route distance: whisper no context 100x, another
#: seed 4.5x; the vlm's 10 layers 4.2x and 5.8x, its 5 layers 3.8x and
#: 5.3x; PERF.md)
CONTEXT_NOISE = 3.0
#: the training cell of phase 8: gemma-2b at its registered width, a
#: batch of 4 sequences of 2048 tokens from the port's synthetic stream,
#: ``steps`` steps of AdamW (``AdamWConfig()``); and the trainer's smoke
#: run (qwen3-1.7b's smoke config, a crash at 25 of 40 steps, resumed)
TRAIN = dict(arch="gemma-2b", batch=4, seq_len=2048, steps=4)
#: the same training cell on rwkv6-1.6b at its registered width (24
#: layers, d 2048, 32 heads of 64, bf16, 1.60 B): its WKV runs the
#: checkpointing forward and the backward kernel
TRAIN_RWKV = dict(TRAIN, arch="rwkv6-1.6b")
#: whisper-medium at its registered width: 4 sequences of 4096 frames and
#: 1024 decoder tokens (``_dec_len`` of 4096), the JAX package's
#: ``train_4k`` cut to one card; tokens from the port's synthetic
#: stream, frames N(0, 1) from ``SEED`` (plus the step)
TRAIN_WHISPER = dict(TRAIN, arch="whisper-medium", seq_len=1024, frames=4096)
#: deepseek-v2-lite-16b at its registered width cut to its first layer:
#: MLA and the dense feed-forward at ``dense_d_ff`` 10944 (0.50 B), so the
#: route check meets no routing near-tie; 4 x 2048 tokens
TRAIN_DEEPSEEK = dict(TRAIN, arch="deepseek-v2-lite-16b", n_layers=1)
#: jamba-1.5-large-398b at its registered width cut to its first layer:
#: Mamba and the dense feed-forward at ``dense_d_ff`` 24576 (2.10 B, half
#: of it the untied embedding and head); 4 x 2048 tokens
TRAIN_JAMBA = dict(TRAIN, arch="jamba-1.5-large-398b", n_layers=1)
TRAIN_LOOP = dict(arch="qwen3-1.7b", steps=40, every=10, crash_at=25)
#: MLA's (q and k, v) head-dim pair: deepseek-v2-lite's 128 + 64 rope, 128
MLA_DIMS = (192, 128)
#: the attention backward's shapes in phase ``kernels`` (label, b, Hq,
#: Hkv, Lq, Lk, D or a (D, Dv) pair, dtype name, causal): the non-causal
#: ones are whisper training's encoder and cross-attention and two ragged
#: ones; the pairs deepseek-v2-lite's training shape and a ragged fp32 one
BWD_CASES = (("mid fp32", 2, 8, 2, 700, 700, 64, "float32", True),
             ("mid bf16", 2, 8, 2, 700, 700, 64, "bfloat16", True),
             ("gemma-2b train", TRAIN["batch"], 8, 1, TRAIN["seq_len"],
              TRAIN["seq_len"], 256, "bfloat16", True),
             ("qwen3-1.7b train", TRAIN["batch"], 16, 8, TRAIN["seq_len"],
              TRAIN["seq_len"], 128, "bfloat16", True),
             ("ragged bf16", 1, 8, 1, 333, 1001, 256, "bfloat16", True),
             ("whisper train self", TRAIN_WHISPER["batch"], 16, 16,
              TRAIN_WHISPER["seq_len"], TRAIN_WHISPER["seq_len"], 64,
              "bfloat16", True),
             ("whisper train encoder", TRAIN_WHISPER["batch"], 16, 16,
              TRAIN_WHISPER["frames"], TRAIN_WHISPER["frames"], 64,
              "bfloat16", False),
             ("whisper train cross", TRAIN_WHISPER["batch"], 16, 16,
              TRAIN_WHISPER["seq_len"], TRAIN_WHISPER["frames"], 64,
              "bfloat16", False),
             ("ragged non-causal fp32", 2, 8, 2, 700, 333, 64, "float32",
              False),
             ("ragged non-causal bf16", 1, 8, 1, 333, 1001, 256, "bfloat16",
              False),
             ("deepseek train", TRAIN_DEEPSEEK["batch"], 16, 16,
              TRAIN_DEEPSEEK["seq_len"], TRAIN_DEEPSEEK["seq_len"], MLA_DIMS,
              "bfloat16", True),
             ("ragged mla fp32", 2, 4, 4, 333, 333, MLA_DIMS, "float32",
              True))
#: the WKV backward's shapes in phase ``kernels`` (label, b, t, h, dh):
#: rwkv6-1.6b's training shape and a ragged one (T not a multiple of the
#: checkpoint spacing, B*H below the SMs)
WKV_BWD_CASES = (("rwkv6-1.6b train", TRAIN_RWKV["batch"],
                  TRAIN_RWKV["seq_len"], 32, 64),
                 ("ragged", 2, 333, 2, 64))
#: the RMSNorm backward's cases in phase ``kernels`` (label, rows, d,
#: dtype name): a mid fp32 shape, gemma-2b's training rows, the qk-norm
#: width at qwen3-1.7b's heads, a ragged width
RMS_BWD_CASES = (("mid fp32", 4096, 2048, "float32"),
                 ("gemma-2b train", TRAIN["batch"] * TRAIN["seq_len"], 2048,
                  "bfloat16"),
                 ("qk-norm", TRAIN["batch"] * TRAIN["seq_len"] * 16, 128,
                  "bfloat16"),
                 ("ragged bf16", 333, 1000, "bfloat16"))
#: fp32 instructions per state element a step of the WKV backward's
#: design (its issue floor): the state recomputed in pass A (3 a step for
#: all but a chunk's last 8-step sub-chunk: 3 x 56 / 64) and in pass B (3
#: for 10 of 8 steps: steps 1-6 forward to the even states kept in
#: registers, then the 4 odd ones again in the reverse loop), four FMAs
#: of the sums and two for G, and the shuffle trees that replace the
#: shared-memory partials: over a sub-chunk a thread's 8 elements x 8
#: steps take 61 adds and 61 shuffles at dh 64 (dr, dk, dw
#: reduce-scattered over 16 lanes, 24 + 12 + 6 + 3; dv over the warp's two
#: row pairs, 2 a step), counted by hand from ``csrc/rwkv6_scan_bwd.cu``;
#: the trees' 122 selects and the loads from shared memory are not counted
WKV_BWD_INSTRUCTIONS = 3 * 56 / 64 + 3 * 10 / 8 + 4 + 2 + 2 * 61 / 64
#: flops per state element a step of the WKV backward (its operations
#: bound): the forward's state once (multiply, multiply, add), the four
#: sums (an FMA each) and G (a multiply and an FMA)
WKV_BWD_FLOPS = 3 + 8 + 3
#: the backward kernels against autograd of the plain versions: fp32
#: max-abs within this share of the reference tensor's largest magnitude;
#: bf16 relative L2 within GRAD_REL_L2 per tensor and each element within
#: GRAD_ULPS bf16 ulps of the reference plus GRAD_RMS_FLOOR of its
#: tensor's rms (both round fp32 sums of different order; a key tile or a
#: row's statistics lost moves a tensor by far more)
GRAD_FP32_TOL = 1e-4
GRAD_REL_L2 = 1e-2
GRAD_ULPS = 2.0
GRAD_RMS_FLOOR = 2.0 ** -8
#: kernel route vs plain route of the first train step (phase 8): the
#: loss's relative difference and each gradient leaf's relative L2, by
#: arch, set from the H100 readings recorded in PERF.md: gemma-2b 8.9e-6
#: and at most 0.0116 (the tied embedding's, median 0.0054); rwkv6-1.6b
#: 5.0e-7 and at most 0.0739 (the stacked bonus, median 0.048), parting
#: evenly over its 24 layers (each layer's worst leaf 0.058-0.092) and
#: as far with either kind of kernel alone on the kernel route (the norms
#: 0.043, the WKV 0.073), while in fp32 the routes agree to 2.3e-5: bf16
#: activations of random weights round differently on the two routes
#: layer by layer, through rwkv's 24 recurrent states more than through
#: gemma's attention, and a leaf that sums every token's gradient (the
#: embedding, the bonus) gathers it all
TRAIN_LOSS_REL = 1e-4
#: gradient leaves that are 0 in exact arithmetic: the key bias of an
#: attention without rope (whisper's encoder) adds q.b to every logit of a
#: row, which the softmax cancels, so each route's gradient is rounding
#: noise (relative L2 1.39 between the routes, PERF.md).  Such a leaf is
#: held by its size instead, on both routes: its norm at most
#: ``ZERO_LEAF_SHARE`` of the query bias's (readings 1.5e-4 on both
#: routes; a backward that broke the
#: softmax's shift invariance, a wrong D = rowsum(P dP), would move it to
#: the query bias's order)
ZERO_GRAD_LEAVES = {"/encoder/blocks/mixer/bk": "/encoder/blocks/mixer/bq"}
ZERO_LEAF_SHARE = 1e-2
TRAIN_GRAD_REL_L2 = {"gemma-2b": 2e-2, "rwkv6-1.6b": 9e-2,
                     "whisper-medium": 2e-2, "deepseek-v2-lite-16b": 2e-2,
                     "jamba-1.5-large-398b": 2e-2}
#: the same first step of rwkv6-1.6b at its registered width in fp32 (a
#: batch of 1 x 1024 tokens) on both routes: every gradient leaf within
#: this relative L2 (reading 2.3e-5: the fp32 kernels sum in other
#: orders), the gate that a faulty layer could not pass
TRAIN_FP32 = dict(batch=1, seq_len=1024)
TRAIN_FP32_GRAD_REL_L2 = 1e-4
#: the cast-first bf16 ``rmsnorm`` (the models' order) against its plain
#: twin: at most this share of the elements may differ at all (at least
#: one is allowed).  The two sum the squares in other orders, so the
#: first rounding of x_hat falls the other way in a few elements a
#: million (2.8e-6 on an H100, PERF.md), while the TPU kernel's order,
#: which rounds once, differs in about a quarter of them: the gate tells
#: the two orders apart, which the per-element allowance cannot
CAST_FIRST_DIFF_SHARE = 1e-4
#: tolerances of the model kernels against their plain versions (max-abs)
ATTN_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
#: the forward's row statistics (fp32 natural log-sum-exp, which the
#: backward reads) against the plain version's: max-abs within this share
#: of max(1, the largest |lse|), in both types: both sum the same fp32
#: exponentials of logits that are exact in fp32, in other orders, while
#: one key tile of 64 lost at L = 2048 moves a row's lse by ~3e-2
LSE_REL = 1e-4
#: bf16 attention is also held element by element to one bf16 ulp of the
#: plain value plus this share of the rms of its row: both round nearly the
#: same fp32 result, so they differ in the last bit at most, while a key
#: block lost or masked wrongly moves a row by about a tenth of its rms
#: (unit-normal inputs at L = 6144 give rows of rms ~0.02, so the max-abs
#: limit alone would not see it)
ROW_RMS_FLOOR = 2.0 ** -10
#: fp32 WKV outputs are held to this share of the rms of their head's
#: output over the sequence (not of their row's: early rows are sums that
#: cancel, and there even the plain version lies ~1e-4 of the row's rms
#: from the same sum in fp64)
WKV_FP32_TOL = 1e-5
#: relative L2 error allowed between the kernel and plain routes' logits,
#: by arch: (the prefill's last position, every decode step's), set from
#: the H100 readings recorded in PERF.md: gemma-2b 0.0167 and at most
#: 0.0191; rwkv6-1.6b 0.0378 and at most 0.0399, where the per-layer
#: readings show no layer parting the routes (each adds at most 0.0037);
#: olmoe-1b-7b and the context families start at gemma-2b's;
#: deepseek-v2-lite-16b's 27 layers take gemma-2b's 18-layer gates times
#: sqrt(27 / 18) ~ 1.22 (independent per-layer roundings add in
#: quadrature), rounded up: its readings 0.0207 and at most 0.0235, with
#: every layer's own share at most 0.0041 and no layer parting the routes
#: (PERF.md; gemma-2b's 2e-2 failed by 4 % at the prefill)
LOGITS_REL_L2 = {"gemma-2b": (2e-2, 2.5e-2), "rwkv6-1.6b": (4.5e-2, 5e-2),
                 "olmoe-1b-7b": (2e-2, 2.5e-2),
                 "whisper-medium": (2e-2, 2.5e-2),
                 "llama-3.2-vision-90b": (2e-2, 2.5e-2),
                 "deepseek-v2-lite-16b": (2.5e-2, 3e-2),
                 "jamba-1.5-large-398b": (2e-2, 2.5e-2)}
#: relative L2 error allowed between phase ``serve_tp``'s two ranks and
#: the one-rank port, both on the kernel route: each rank's first
#: attention output before ``wo`` (its 32 q heads; only its q / k / v
#: products differ, narrower: bit-equal on the H100, reading 0), and the
#: logits (the prefill's last position, every decode step's), where the
#: bf16 sums over 'model' of the row-parallel products round otherwise
#: than one product does (readings 0.0143 and at most 0.0149; the vlm's
#: kernel-vs-plain gates, whose 5-layer readings are 0.0114 / 0.0123)
TP_ATTENTION_REL_L2 = 1e-3
TP_LOGITS_REL_L2 = (2e-2, 2.5e-2)
#: relative L2 error allowed for one layer's own share of the routes'
#: distance (``layer_divergence``'s ``local``; readings at most 0.0015 on
#: gemma-2b and 0.0037 on rwkv6-1.6b)
LAYER_REL_L2 = 1e-2


def head_dims(dim) -> tuple:
    """A case's (q and k, v) head dims from one D or a (D, Dv) pair."""
    return tuple(dim) if isinstance(dim, tuple) else (dim, dim)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def memory_rate(name: str) -> float:
    """The card's device-memory bytes/s (``launch/roofline.py``'s table,
    by H100 variant)."""
    from repro_torch.launch import roofline
    return roofline.memory_rate(name)


def bf16_rate(name: str) -> float:
    """The card's dense bf16 tensor-core flop/s (``launch/roofline.py``)."""
    from repro_torch.launch import roofline
    return roofline.bf16_rate(name)


def fp32_rate(name: str) -> float:
    """The card's fp32 CUDA-core flop/s (``launch/roofline.py``)."""
    from repro_torch.launch import roofline
    return roofline.fp32_rate(name)


def median_ms(fn, make_args, reps: int) -> float:
    """Median device time of ``fn(*make_args())`` over ``reps`` calls,
    each on freshly made arguments (made outside the timed window), by
    CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        args = make_args()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def behind_spin(queue, cycles: int) -> tuple:
    """``queue()`` run on the host while a spin kernel of ``cycles`` GPU
    cycles holds the stream, so that nothing it queues starts before the
    host has queued all of it.  Returns ``queue()``'s result and its host
    time in ms.  Where the host's work outlasted the spin, the timing is
    not kept: the queued work finishes, and ``queue()`` runs again behind
    a spin twice as long, at most ``SPIN_DOUBLINGS`` times before it
    fails."""
    import torch
    for doubling in range(SPIN_DOUBLINGS + 1):
        torch.cuda.synchronize()
        held, released = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
        held.record()
        torch.cuda._sleep(cycles << doubling)
        released.record()
        t0 = time.perf_counter()
        out = queue()
        host_ms = (time.perf_counter() - t0) * 1e3
        released.synchronize()
        if held.elapsed_time(released) > host_ms:
            return out, host_ms
    raise AssertionError(f"the host's work ({host_ms} ms) outlasted a spin "
                         f"kernel of {cycles << SPIN_DOUBLINGS} cycles")


def device_ms(fn, make_args, reps: int) -> tuple:
    """Median device time of ``fn(*make_args())`` alone over ``reps``
    calls, and the host time of one call (the wrapper's work until its
    launches are queued): each call is queued behind a spin kernel
    (:func:`behind_spin`), so the CUDA events bracket the kernel's device
    work and none of the host's.  The host time is the mean over ``reps``
    calls queued back to back behind one spin, as a decode step queues
    them."""
    import torch

    def bracketed(args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(*args)
        end.record()
        return start, end

    times = []
    for _ in range(reps):
        args = make_args()
        (start, end), _ = behind_spin(lambda: bracketed(args), SPIN_CYCLES)
        end.synchronize()
        times.append(start.elapsed_time(end))
    calls = [make_args() for _ in range(reps)]
    _, host_ms = behind_spin(lambda: [fn(*args) for args in calls],
                             SPIN_CYCLES * reps)
    torch.cuda.synchronize()
    return statistics.median(times), host_ms / reps


def check_repeats(card: str, cases) -> None:
    """Each ``(kernel, label, call, first)`` case launched ``REPEATS``
    times more; every output (a tensor or a sequence of them) must equal
    the first bit for bit."""
    import torch

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for kernel, label, call, first in cases:
        equal = sum(same(call(), first) for _ in range(REPEATS))
        check(equal == REPEATS, f"{kernel} ({label}): {equal} of {REPEATS} "
              f"repeated launches equal the first")
        emit({"phase": "kernels", "kernel": kernel, "case": label,
              "repeats": REPEATS, "repeats_equal": equal, "card": card})


def changed_words(before, after) -> int:
    return sum(int((b != a).sum()) for b, a in zip(before, after))


def mesi_bound_bytes(inputs, outputs) -> tuple:
    """Least bytes one MESI tick moves on these inputs, as words and as
    the 32-byte sectors the card moves: the action vectors read in full;
    the state words the decisions read (the addressed cell of every
    acting agent, the whole column of every written artifact, the
    version of every addressed artifact, the read counters of acting
    agents where the tick reads them); miss and counters written in
    full; every state word whose value changed written once.  Returns
    (4 bytes a word, 32 bytes a sector holding any such word, read and
    written sectors counted apart)."""
    import torch
    state, version, sync, reads, acts, arts, writes = inputs
    B, n, m = state.shape
    idx = arts.long()
    act = acts != 0
    cell = torch.zeros((B, n, m), dtype=torch.bool, device=state.device)
    cell.scatter_(2, idx[..., None], act[..., None])
    written = torch.zeros((B, m), dtype=torch.int32, device=state.device)
    written.scatter_add_(1, idx, (act & (writes != 0)).to(torch.int32))
    addressed = torch.zeros((B, m), dtype=torch.int32, device=state.device)
    addressed.scatter_add_(1, idx, act.to(torch.int32))
    state_read = cell | (written > 0)[:, None, :]
    changed = [b != a for b, a in zip(inputs[:4], outputs[:4])]
    words = (3 * B * n + int(state_read.sum()) + int((addressed > 0).sum())
             + int(cell.sum()) + B * n + B * 8 + sum(int(c.sum())
                                                    for c in changed))

    def sectors(mask):    # 8 words a sector; every buffer starts on one
        flat = mask.reshape(-1)
        pad = (-flat.numel()) % 8
        flat = torch.cat([flat, flat.new_zeros(pad)])
        return int(flat.view(-1, 8).any(dim=1).sum())

    full = 3 * -(-B * n // 8) + -(-B * n // 8) + -(-B * 8 // 8)
    touched = (full + sectors(state_read) + sectors(addressed > 0)
               + sectors(cell) + sum(sectors(c) for c in changed))
    return 4 * words, 32 * touched


def chunk_bound_bytes(inputs, outputs) -> int:
    """Least bytes one chunk tick moves on these inputs: miss, write
    flags and artifact choices read in full; the authority chunk row of
    every artifact an agent fills or writes, the reader row of every
    fill and the span of every write read once; fetched and counters
    written in full; every chunk word whose value changed written
    once."""
    import torch
    cv, cs, dirty, miss, wact, arts, wmask = inputs
    B, n, m, C = cs.shape
    idx = arts.long()
    busy = ((miss != 0) | (wact != 0)).to(torch.int32)
    rows = torch.zeros((B, m), dtype=torch.int32, device=cs.device)
    rows.scatter_add_(1, idx, busy)
    words = (3 * B * n + C * (int((rows > 0).sum())
                              + int((miss != 0).sum())
                              + int((wact != 0).sum()))
             + B * n * C + B * 4
             + changed_words(inputs[:3], outputs[:3]))
    return 4 * words


def ptxas_entries(log: str) -> dict:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log (``name<D>`` for a
    template on equal head dims, ``name<D,Dv>`` on a pair): registers,
    static shared memory, stack frame and spill bytes."""
    entries, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"\d((?:flash|dq|dkdv)_[a-z0-9]+)I(?:f)?Li(\d+)E"
                          r"(?:Li(\d+)E)?", m.group(1))
            plain = re.search(r"\d(dkdv_reduce)E", m.group(1))
            dims = None
            if t:
                dims = (t.group(2) if t.group(3) in (None, t.group(2))
                        else f"{t.group(2)},{t.group(3)}")
            name = (f"{t.group(1)}<{dims}>" if t
                    else plain.group(1) if plain else m.group(1))
            entries[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            entries[name].update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            entries[name].update(registers=int(m.group(1)),
                                 static_smem=int(smem.group(1)) if smem
                                 else 0)
    return entries


def phase_build(card: str) -> None:
    """Builds every kernel (each one anew, so its compiler output is at
    hand); prints each entry's registers, shared memory and spills, which
    must be none in the entries of the kernels of ``NO_SPILL`` and in the
    bf16 flash kernel at every head dim, and, where ``cuobjdump`` is
    installed, the count of tensor-core (``HGMMA``) instructions in the
    machine code of flash and of its backward (whose ``dq_wgmma`` and
    ``dkdv_wgmma`` entries must exist at every head dim), neither of
    which may be 0."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    for name in build.KERNELS:
        build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    logs = build.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    check(all(build.library_path(name).exists() for name in build.KERNELS),
          "every kernel library is built")
    usage = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()
             if name not in ("flash_attention",) + NO_SPILL}
    emit({"phase": "build", "seconds": seconds, "arch": "sm_90a",
          "kernels": len(build.KERNELS), "compiled": sorted(logs),
          "ptxas": usage, "card": card})

    for name in NO_SPILL:
        rows = ptxas_entries(logs[name])
        check(bool(rows) and all(
            row.get("spill_stores") == 0 == row.get("spill_loads")
            and row.get("stack") == 0 for row in rows.values()),
            f"{name} compiled without register spills ({rows})")
        emit({"phase": "build", "kernel": name, "entries": rows,
              "card": card})

    def entry_dims(dk, dv):
        return f"{dk}" if dk == dv else f"{dk},{dv}"

    entries = ptxas_entries(logs["flash_attention"])
    for dk, dv in HEAD_DIMS:
        name = f"flash_wgmma<{entry_dims(dk, dv)}>"
        row = entries.get(name, {})
        check(row.get("spill_stores") == 0 == row.get("spill_loads")
              and row.get("stack") == 0,
              f"{name} compiled without register spills ({row})")
    bwd = ptxas_entries(logs["flash_attention_bwd"])
    for dk, dv in HEAD_DIMS:
        for entry in ("dq_wgmma", "dkdv_wgmma"):
            check(f"{entry}<{entry_dims(dk, dv)}>" in bwd,
                  f"flash_attention_bwd builds {entry}<{entry_dims(dk, dv)}>")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, rows in (("flash_attention", entries),
                       ("flash_attention_bwd", None)):
        hgmma = None
        if pathlib.Path(tool).exists():
            sass = subprocess.run(
                [tool, "-sass", str(build.library_path(name))], check=True,
                capture_output=True, text=True).stdout
            hgmma = dict(collections.Counter(
                re.findall(r"HGMMA\.\w+\.\w+\.\w+", sass)))
            check(sum(hgmma.values()) > 0,
                  f"{name}'s machine code holds HGMMA instructions")
        row = {"phase": "build", "kernel": name, "hgmma": hgmma,
               "card": card}
        if rows is not None:
            row["entries"] = rows
        emit(row)


def random_mesi_inputs(gen, B: int, n: int, m: int):
    """Random valid directories (every entry I or S, synced to the
    current version where valid) and random actions."""
    import torch
    dev, i32 = gen.device, torch.int32

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=i32)

    state = ints(0, 2, B, n, m)
    version = ints(1, 6, B, m)
    sync = torch.where(state > 0, version[:, None, :], 0).to(i32)
    reads = ints(0, 12, B, n, m)
    return (state, version, sync, reads, ints(0, 2, B, n), ints(0, m, B, n),
            ints(0, 2, B, n))


def random_chunk_inputs(gen, B: int, n: int, m: int, C: int):
    """One chunk tick's inputs in 64-token chunks: ``miss`` from a MESI
    tick on random directories, chunk vectors lagging the authority by 0
    or 1, write spans drawn as the engine draws them (locality 0.25);
    returns ``(inputs, opts)``."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.acs import draw_write_chunks
    from repro_torch.kernels import mesi_transition as mt
    tokens, chunk = C * 64, 64
    acts, arts, writes = random_mesi_inputs(gen, B, n, m)[4:]
    mesi_in = random_mesi_inputs(gen, B, n, m)[:4] + (acts, arts, writes)
    miss = mt.mesi_tick(*mesi_in, artifact_tokens=tokens)[5]
    cv = torch.randint(1, 5, (B, m, C), generator=gen, device="cuda",
                       dtype=torch.int32)
    lag = torch.randint(0, 2, (B, n, m, C), generator=gen, device="cuda",
                        dtype=torch.int32)
    cs = torch.clamp(cv[:, None] - lag, min=0)
    dirty = (cv > 1).to(torch.int32)
    keys = prng.split(prng.prng_key(SEED, "cuda"), B)
    wmask = draw_write_chunks(keys, n, C, 0.25).to(torch.int32)
    inputs = (cv, cs, dirty, miss, (acts * writes).contiguous(), arts, wmask)
    return inputs, dict(artifact_tokens=tokens, chunk_tokens=chunk,
                        signal_tokens=12)


def phase_kernels(card: str, rate: float) -> dict:
    """Kernel against plain version on the card; returns, per kernel,
    the measurements at the fleet shape (the last shape listed)."""
    import torch
    from repro_torch.core import invariants
    from repro_torch.kernels import chunk_diff, mesi_transition as mt

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    repeat_cases = []
    for B, n, m in MESI_SHAPES:
        for label, eager, access_k in (("lazy", False, 0),
                                       ("eager", True, 0),
                                       ("access_count", False, 8)):
            inputs = random_mesi_inputs(gen, B, n, m)
            opts = dict(artifact_tokens=4096, eager=eager,
                        access_k=access_k, signal_tokens=12)
            out = mt.mesi_tick(*inputs, **opts)
            torch.cuda.synchronize()
            plain = [t.clone() for t in inputs[:4]]
            plain += list(mt.mesi_tick_plain_(*plain, *inputs[4:], **opts))
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(out, plain))
            check(all(torch.equal(a, b) for a, b in zip(out, plain)),
                  f"mesi_tick kernel == plain ({label}, B={B})")
            st = out[0].cpu().numpy()
            check(invariants.single_writer(
                st.transpose(1, 0, 2).reshape(n, B * m)),
                "SWMR after the kernel tick")
            check(invariants.monotonic_version(inputs[1].cpu().numpy(),
                                               out[1].cpu().numpy()),
                  "monotonic versions after the kernel tick")

            def fresh():
                return [t.clone() for t in inputs[:4]] + list(inputs[4:])

            ms = median_ms(lambda *a: mt.mesi_tick_(*a, **opts), fresh, 10)
            dev_ms, host_ms = device_ms(
                lambda *a: mt.mesi_tick_(*a, **opts), fresh, 10)
            plain_ms = median_ms(lambda *a: mt.mesi_tick_plain_(*a, **opts),
                                 fresh, 3)
            word_bytes, sector_bytes = mesi_bound_bytes(inputs, out)
            row = {"phase": "kernels", "kernel": "mesi_tick",
                   "strategy": label, "shape": [B, n, m],
                   "equal": True, "max_abs_err": err, "ms": ms,
                   "device_ms": dev_ms, "host_ms": host_ms,
                   "plain_ms": plain_ms,
                   "bound_ms": word_bytes / rate * 1e3,
                   "sector_bound_ms": sector_bytes / rate * 1e3,
                   "staged_sims": mt.plan(n, m), "card": card}
            emit(row)
            if label == "lazy":
                results["mesi_tick"] = row

            def again(inputs=inputs, opts=opts):
                state = [t.clone() for t in inputs[:4]]
                return state + list(mt.mesi_tick_(*state, *inputs[4:],
                                                  **opts))
            repeat_cases.append(("mesi_tick", f"{label}, B={B}", again, out))
    # each shape and strategy launched again after every timing
    check_repeats(card, repeat_cases)

    repeat_cases = []
    for B, n, m, C in CHUNK_SHAPES:
        inputs, opts = random_chunk_inputs(gen, B, n, m, C)
        miss = inputs[3]
        out = chunk_diff.chunk_tick(*inputs, **opts)
        torch.cuda.synchronize()
        plain = [t.clone() for t in inputs[:3]]
        plain += list(chunk_diff.chunk_tick_plain_(*plain, *inputs[3:],
                                                   **opts))
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(out, plain))
        check(all(torch.equal(a, b) for a, b in zip(out, plain)),
              f"chunk_tick kernel == plain (B={B})")
        check(int(miss.sum()) > 0 and int(out[3].sum()) > 0,
              "the chunk tick fetched chunks")

        def fresh():
            return [t.clone() for t in inputs[:3]] + list(inputs[3:])

        ms = median_ms(lambda *a: chunk_diff.chunk_tick_(*a, **opts),
                       fresh, 10)
        dev_ms, host_ms = device_ms(
            lambda *a: chunk_diff.chunk_tick_(*a, **opts), fresh, 10)
        plain_ms = median_ms(lambda *a: chunk_diff.chunk_tick_plain_(
            *a, **opts), fresh, 3)
        bound_ms = chunk_bound_bytes(inputs, out) / rate * 1e3
        row = {"phase": "kernels", "kernel": "chunk_tick",
               "shape": [B, n, m, C], "equal": True, "max_abs_err": err,
               "ms": ms, "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "staged_sims": chunk_diff.plan(n, m, C), "card": card}
        emit(row)
        results["chunk_tick"] = row

        def again(inputs=inputs, opts=opts):
            state = [t.clone() for t in inputs[:3]]
            return state + list(chunk_diff.chunk_tick_(*state, *inputs[3:],
                                                       **opts))
        repeat_cases.append(("chunk_tick", f"B={B}, C={C}", again, out))
    # each shape launched again after every timing
    check_repeats(card, repeat_cases)
    return results


def serve_config(serve):
    """The model config of a serving or training cell: the registered
    one, cut to the cell's ``n_layers`` where it names one."""
    from repro_torch.configs import get
    cfg = get(serve["arch"])
    if "n_layers" in serve:
        cfg = dataclasses.replace(cfg, n_layers=serve["n_layers"])
    return cfg


def serving_system(serve=SERVE):
    """A serving workload (phase 5's by default), driven through its
    coherence decisions (no model yet): the system and its stats."""
    from repro_torch.configs import n_active_params
    from repro_torch.launch.serve import build_artifacts
    from repro_torch.runtime.coherent_serving import (CoherentServingSystem,
                                                      run_workload)
    cfg = serve_config(serve)
    system = CoherentServingSystem(
        cfg, serve["agents"],
        build_artifacts(serve["artifacts"], serve["artifact_tokens"]),
        strategy=serve["strategy"], n_active_params=n_active_params(cfg))
    stats = run_workload(system, serve["steps"], serve["volatility"])
    return system, stats


#: the bias leaves of the models' trees (norms, attention, whisper's MLP)
BIAS_LEAVES = ("bias", "bq", "bk", "bv", "bo", "b_in", "b_out")


def needs_awake(cfg) -> bool:
    """Whether a model's init hides a fault that ``awake_params`` shows:
    the context families' gates and layernorms, Mamba's conv bias and
    skip."""
    return cfg.family in ("vlm", "audio") or cfg.mamba is not None


def awake_params(params, cfg) -> dict:
    """Moves the leaves whose init hides a fault of the context path or
    of Mamba's kernels, in place: every cross-attention ``gate`` to
    ``CROSS_GATE``; in a layernorm model every norm scale to 1 + 0.3 N(0,
    1) and every bias to 0.1 N(0, 1); every Mamba ``conv_b`` (init 0: a
    conv that dropped its bias would pass) to 0.1 N(0, 1) and ``d_skip``
    (init 1) to 1 + 0.3 N(0, 1), drawn from ``SEED`` on the params'
    device.  Returns what it set, for the phase's line."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    moved = collections.Counter()

    def walk(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif key == "gate":
                leaf.fill_(CROSS_GATE)
                moved["gates"] += leaf.numel()
            elif cfg.norm == "layernorm" and key == "scale":
                leaf.copy_(1.0 + 0.3 * torch.randn(
                    leaf.shape, generator=gen, device=leaf.device))
                moved["scales"] += 1
            elif cfg.norm == "layernorm" and key in BIAS_LEAVES:
                leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen,
                                             device=leaf.device))
                moved["biases"] += 1
            elif key == "conv_b":
                leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen,
                                             device=leaf.device))
                moved["conv_b"] += 1
            elif key == "d_skip":
                leaf.copy_(1.0 + 0.3 * torch.randn(
                    leaf.shape, generator=gen, device=leaf.device))
                moved["d_skip"] += 1

    walk(params)
    return {"cross_gate": CROSS_GATE, "tanh_gate": math.tanh(CROSS_GATE),
            "gates_set": moved["gates"], "scale_leaves_drawn":
            moved["scales"], "bias_leaves_drawn": moved["biases"],
            "conv_b_leaves_drawn": moved["conv_b"],
            "d_skip_leaves_drawn": moved["d_skip"]}


def cell_context(cfg, batch: int, length: int, seed: int):
    """A cell's stub context on the card (the port's own draw,
    ``launch.serve.stub_context``): None for a model without cross
    layers."""
    from repro_torch.launch.serve import stub_context
    if cfg.family not in ("vlm", "audio"):
        return None
    return stub_context(cfg, batch, length, seed, "cuda")


def bf16_ulps(got, exp) -> float:
    """Largest difference of ``got`` from ``exp`` in units of the bf16
    ulp of ``exp`` (x = m * 2**e, m in [0.5, 1), has ulp 2**(e - 8))."""
    import torch
    exp32 = exp.float()
    ulp = torch.ldexp(torch.ones_like(exp32), torch.frexp(exp32).exponent
                      - 8)
    return float(((got.float() - exp32).abs() / ulp).max())


def cast_first_err(got, x, w, eps: float = 1e-6) -> float:
    """Largest ``|got - exp|`` of a cast-first ``rmsnorm`` (bf16) over its
    allowance against the plain twin ``exp = bf16(bf16(x_hat) * w)``:
    ``|w|`` times one bf16 ulp of ``bf16(x_hat)`` plus half an ulp each of
    ``got`` and ``exp``.  The kernel sums the squares in another order
    than the plain version, so where the two fp32 x_hat lie either side
    of a bf16 rounding boundary the first rounding falls the other way:
    the two exact products then differ by at most ``|w|`` one ulp of
    x_hat, and each is rounded by at most half an ulp of its result (up
    to 2 ulps of y, in a few elements a million on an H100); a lost row
    or a wrong scale moves it far more."""
    import torch

    def ulp(t):
        t = t.float()
        return torch.where(t == 0, 0.0, torch.ldexp(
            torch.ones_like(t), torch.frexp(t).exponent - 8))

    x32 = x.float()
    xhat = (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
            ).to(x.dtype)
    exp = xhat * w
    allow = w.float().abs() * ulp(xhat) + 0.5 * (ulp(got) + ulp(exp))
    diff = (got.float() - exp.float()).abs()
    # x = 0 (randn draws it) gives exp = 0 and no allowance: equal is 0
    return float(torch.where(diff == 0, 0.0, diff / allow).max())


def differing_share(got, exp) -> tuple:
    """(elements of ``got`` that differ from ``exp`` at all, their share,
    the share ``CAST_FIRST_DIFF_SHARE`` allows: at least one element)."""
    n = int((got != exp).sum())
    return n, n / got.numel(), max(CAST_FIRST_DIFF_SHARE, 1 / got.numel())


def check_rmsnorm(x, w, label: str) -> dict:
    """``rmsnorm`` in both cast orders against its plain versions: the
    TPU kernel's order (``ops.rmsnorm``) within one bf16 ulp of
    ``rmsnorm_plain``, the cast-first order (the model's
    ``norm_apply``) within :func:`cast_first_err`'s allowance of
    ``rmsnorm_cast_first_plain`` and differing from it in at most
    ``CAST_FIRST_DIFF_SHARE`` of the elements; fp32 within 1e-5 of the
    largest magnitude in both.  As a control, the TPU kernel's order must
    fail the share gate against the cast-first twin (bf16 inputs of 4096
    elements or more, where a quarter of them differ).  Returns the
    readings."""
    import torch
    from repro_torch.kernels.ref import (rmsnorm_cast_first_plain,
                                         rmsnorm_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm
    out, outputs = {}, {}
    for cast_first, plain in ((False, rmsnorm_plain),
                              (True, rmsnorm_cast_first_plain)):
        got = outputs[cast_first] = rmsnorm(x, w, cast_first=cast_first)
        torch.cuda.synchronize()
        exp = plain(x, w)
        err = float((got.float() - exp.float()).abs().max())
        order = "cast-first" if cast_first else "TPU-kernel"
        if x.dtype != torch.bfloat16:
            check(err <= 1e-5 * max(1.0, float(exp.abs().max())),
                  f"rmsnorm ({order} order) fp32 within 1e-5 ({label})")
            out[order] = {"max_abs_err": err}
        elif cast_first:
            ratio = cast_first_err(got, x, w)
            check(ratio <= 1.0, f"rmsnorm (cast-first order) within |w| "
                  f"one ulp of x_hat plus one bf16 ulp ({label}: {ratio})")
            n, share, limit = differing_share(got, exp)
            check(share <= limit, f"rmsnorm (cast-first order) differs "
                  f"from its plain twin in {share} <= {limit} of the "
                  f"elements ({label})")
            out[order] = {"max_abs_err": err, "max_allowance_share": ratio,
                          "max_bf16_ulps": bf16_ulps(got, exp),
                          "elements_differing": n, "share_differing": share}
            if x.numel() >= 4096:
                n, share, limit = differing_share(outputs[False], exp)
                check(share > limit, f"control: the TPU kernel's order "
                      f"fails the cast-first share gate ({label}: {share} "
                      f"of the elements differ)")
                out["control: TPU order vs cast-first twin"] = {
                    "elements_differing": n, "share_differing": share}
        else:
            ulps = bf16_ulps(got, exp)
            check(ulps <= 1.0, f"rmsnorm within one bf16 ulp ({label})")
            out[order] = {"max_abs_err": err, "max_bf16_ulps": ulps}
    return out


def bf16_row_err(got, exp) -> float:
    """Largest ``|got - exp|`` over its allowance: one bf16 ulp of ``exp``
    plus ``ROW_RMS_FLOOR`` times the rms of ``exp``'s row (last axis).
    At most 1 when the two round nearly equal fp32 results."""
    import torch
    exp32 = exp.float()
    ulp = torch.where(exp32 == 0, 0.0, torch.ldexp(
        torch.ones_like(exp32), torch.frexp(exp32).exponent - 8))
    rms = exp32.square().mean(dim=-1, keepdim=True).sqrt()
    return float(((got.float() - exp32).abs()
                  / (ulp + ROW_RMS_FLOOR * rms)).max())


def check_attention(got, exp, dtype, what: str) -> tuple:
    """Holds an attention kernel's output to its plain version: max-abs
    within ``ATTN_TOL`` and, in bf16, :func:`bf16_row_err` <= 1.
    Returns (max-abs error, row error or None)."""
    err = float((got.float() - exp.float()).abs().max())
    tol = ATTN_TOL[str(dtype).split(".")[-1]]
    check(err <= tol, f"{what} within {tol} max-abs ({err})")
    row_err = None
    if str(dtype).endswith("bfloat16"):
        row_err = bf16_row_err(got, exp)
        check(row_err <= 1.0, f"{what} within one bf16 ulp plus "
              f"{ROW_RMS_FLOOR} of the row rms ({row_err})")
    return err, row_err


def library_ms(timed, pair: bool):
    """``timed()``, the time of a ``scaled_dot_product_attention`` call
    (the yardstick).  At a head-dim pair (Ev != E) only the fused backends
    are allowed, and None is returned where none of them takes the call:
    the math backend would materialize the whole score matrix, which is
    no library kernel to compare with."""
    if not pair:
        return timed()
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    with sdpa_kernel(fused):
        try:
            return timed()
        except RuntimeError:
            return None


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """Query-key pairs a causal (rows aligned to the last lq keys) or
    full attention computes for one (batch, head)."""
    if not causal:
        return lq * lk
    off = lk - lq
    return sum(min(lk, r + off + 1) for r in range(lq))


def offset_pairs(s: int, offsets, kv_len, lk: int) -> int:
    """Query-key pairs of a causal attention of s rows at per-row offsets
    over keys below min(kv_len, Lk), summed over the batch rows: what the
    kernel computes for this call's data (one head)."""
    return sum(min(o + r + 1, min(n, lk)) for o, n in zip(offsets, kv_len)
               for r in range(s))


def check_flash_offsets(card: str, rate: float, flops: float,
                        fp32_flops: float, gen) -> list:
    """Flash at per-row offsets (``FLASH_OFFSET_CASES``, the continued
    prefills' over the batched request's cache), bf16 and fp32: against
    its plain version at flash's gates, over a cache whose rows past
    kv_len are random too (masked, never seen); the row at offset 0 bit
    for bit today's causal call over its first s keys (the same tiles in
    the same order); timed alone, by events and on the host beside its
    bound (2 (D + Dv) flops a kept pair; q, the output, and K / V rows
    below kv_len read once) and the plain version (no library call takes
    a per-row causal offset).  Returns the repeat cases."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention

    def fn(q, k, v, q_offset, kv_len):
        return flash_attention(q, k, v, causal=True, q_offset=q_offset,
                               kv_len=kv_len)

    def plain(q, k, v, q_offset, kv_len):
        return plain_attention(q, k, v, True, None, q_offset, kv_len)

    repeats = []
    for label, b, h, g, s, lk, dim, offsets in FLASH_OFFSET_CASES:
        dk, dv = head_dims(dim)
        for dtype in (torch.bfloat16, torch.float32):
            q, k = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                    for shape in ((b, h, s, dk), (b, g, lk, dk)))
            v = torch.randn((b, g, lk, dv), generator=gen,
                            device="cuda").to(dtype)
            off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
            lens = off + s
            out = fn(q, k, v, off, lens)
            torch.cuda.synchronize()
            what = f"flash_attention at offsets ({label}, {dtype})"
            err, row_err = check_attention(out, plain(q, k, v, off, lens),
                                           dtype, what)
            zero = offsets.index(0)
            today = flash_attention(*(t[zero:zero + 1, :, :s].contiguous()
                                      for t in (q, k, v)), causal=True)
            check(torch.equal(out[zero:zero + 1], today),
                  f"{what}: the row at offset 0 is today's causal call over "
                  f"its first {s} keys, bit for bit")
            lens_host = [o + s for o in offsets]
            work = 2 * (dk + dv) * h * offset_pairs(s, offsets, lens_host, lk)
            moved = ((q.numel() + out.numel()
                      + sum(min(n, lk) for n in lens_host) * g * (dk + dv))
                     * q.element_size() + 2 * 4 * b)
            ops_s = work / (flops if dtype == torch.bfloat16 else fp32_flops)
            args = lambda: (q, k, v, off, lens)   # noqa: E731
            dev_ms, host_ms = device_ms(fn, args, 5)
            row = {"phase": "kernels", "kernel": "flash_attention",
                   "case": f"offsets {label}", "shape": [b, h, g, s, lk, dk]
                   + ([dv] if dv != dk else []), "q_offset": list(offsets),
                   "kv_len": lens_host, "causal": True,
                   "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                   "max_row_err": row_err, "offset_zero_bit_equal": True,
                   "ms": median_ms(fn, args, 5), "device_ms": dev_ms,
                   "host_ms": host_ms, "plain_ms": median_ms(plain, args, 3),
                   "library_ms": None,
                   "bound_ms": max(moved / rate, ops_s) * 1e3,
                   "bound_by": ("operations" if ops_s > moved / rate
                                else "bytes"),
                   "tflops": work / (dev_ms * 1e-3) / 1e12, "card": card}
            emit(row)
            repeats.append(("flash_attention", f"offsets {label} {dtype}",
                            functools.partial(fn, q, k, v, off, lens), out))
    return repeats


def phase_model_kernels(card: str, rate: float, flops: float,
                        fp32_flops: float, contexts: list) -> dict:
    """The four model kernels against their plain versions at the
    serving paths' shapes (every serving cell's agents' prefills, batched
    prefill and decode; the context cells' encoder and cross-attention
    non-causal, their cross caches read whole) and at mid, ragged and
    Lq > Lk shapes; returns, per kernel, the row of gemma-2b's batched
    request's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get
    from repro_torch.configs.registry import _ctx_len
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import _forward, flash_attention
    from repro_torch.kernels.ref import (attention_lse_plain,
                                         decode_attention_plain,
                                         rmsnorm_cast_first_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm

    cfg = get(SERVE["arch"])
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.kv_head_dim())
    moe = get(SERVE_MOE["arch"])    # olmoe-1b-7b: 16 heads of 128, MHA
    mq, mkv, md = moe.n_heads, moe.n_kv_heads, moe.kv_head_dim()
    wsp = get(SERVE_WHISPER["arch"])   # whisper-medium: 16 heads of 64
    wq, wd = wsp.n_heads, wsp.kv_head_dim()
    vlm = serve_config(SERVE_VLM)      # 64 heads, 8 KV heads of 128
    vq, vkv, vd = vlm.n_heads, vlm.n_kv_heads, vlm.kv_head_dim()
    dsq = get(SERVE_DEEPSEEK["arch"]).n_heads   # 16 MLA heads, group 1
    artifact_len = SERVE["artifacts"] * SERVE["artifact_tokens"]
    wT, vT = _ctx_len(wsp, artifact_len), _ctx_len(vlm, artifact_len)
    P = min(contexts)
    L1 = min(max(contexts), SERVE["max_len"])
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def size(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    results = {}
    # --- rmsnorm: the batched prefill's rows, one agent's, decode's, a
    # view offset by one element (the kernel's element-by-element path),
    # a qk-norm width (a row per token and head), mid fp32
    for label, rows, width, dtype, offset in (
            ("batched prefill", SERVE["agents"] * P, d, bf16, 0),
            ("agent prefill", L1, d, bf16, 0),
            ("decode", SERVE["agents"], d, bf16, 0),
            ("scalar path", 4096, d, bf16, 1),
            ("qk-norm", SERVE["agents"] * P * hq, QK_NORM_WIDTH, bf16, 0),
            ("mid fp32", 4096, d, torch.float32, 0)):
        x = normal(rows * width + offset, dtype=dtype)[offset:].view(rows,
                                                                    width)
        w = normal(width, dtype=dtype)
        errs = check_rmsnorm(x, w, label)
        # timed in the order the models run (norm_apply: cast first)
        model_norm = functools.partial(rmsnorm, cast_first=True)
        args = lambda: (x, w)   # noqa: E731
        dev_ms, host_ms = device_ms(model_norm, args, 10)
        row = {"phase": "kernels", "kernel": "rmsnorm", "case": label,
               "shape": [rows, width], "offset": offset,
               "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max(errs[o]["max_abs_err"]
                                  for o in ("TPU-kernel", "cast-first")),
               "orders": errs,
               "ms": median_ms(model_norm, args, 10),
               "device_ms": dev_ms, "host_ms": host_ms,
               "device_ms_tpu_order": device_ms(rmsnorm, args, 10)[0],
               "plain_ms": median_ms(rmsnorm_cast_first_plain, args, 3),
               "library_ms": median_ms(
                   lambda a, b: F.rms_norm(a, (width,), b, 1e-6), args, 10),
               "bound_ms": (2 * size(x) + size(w)) / rate * 1e3,
               "bound_by": "bytes", "card": card}
        emit(row)
        if label == "batched prefill":
            results["rmsnorm"] = row

    # --- flash attention: the batched prefill, one agent's, a mid shape;
    # the context cells' self-attention (causal), encoder (Lq = Lk) and
    # cross-attention (Lq != Lk) at the batched request's shapes, non-causal
    # ragged ones and Lq > Lk (the agents' prefills of the context cells,
    # the batched shapes at b = 1, checked but not timed)
    repeat_cases = []
    B = SERVE["agents"]
    for label, b, h, g, lq, lk, dim, dtype, causal, timed in (
            ("batched prefill", B, hq, hkv, P, P, hd, bf16, True, True),
            ("agent prefill", 1, hq, hkv, L1, L1, hd, bf16, True, True),
            ("olmoe batched prefill", B, mq, mkv, P, P, md, bf16, True,
             True),
            ("olmoe agent prefill", 1, mq, mkv, L1, L1, md, bf16, True,
             True),
            ("whisper batched self", B, wq, wq, P, P, wd, bf16, True, True),
            ("whisper encoder", B, wq, wq, wT, wT, wd, bf16, False, True),
            ("whisper cross", B, wq, wq, P, wT, wd, bf16, False, True),
            ("whisper agent cross", 1, wq, wq, L1, wT, wd, bf16, False,
             False),
            ("vlm batched self", B, vq, vkv, P, P, vd, bf16, True, True),
            ("vlm cross", B, vq, vkv, P, vT, vd, bf16, False, True),
            ("vlm agent cross", 1, vq, vkv, L1, vT, vd, bf16, False, False),
            ("ragged non-causal bf16", 1, 8, 1, 333, 1001, 256, bf16, False,
             True),
            ("Lq > Lk fp32", 2, 8, 2, 700, 300, 64, torch.float32, False,
             True),
            ("Lq > Lk bf16", 2, 8, 2, 700, 300, 64, bf16, False, True),
            ("mid bf16", 2, 16, 8, 2048, 2048, 128, bf16, True, True),
            ("mid fp32", 1, 8, 2, 1000, 1000, 64, torch.float32, True,
             True),
            ("deepseek batched prefill", B, dsq, dsq, P, P, MLA_DIMS, bf16,
             True, True),
            ("deepseek agent prefill", 1, dsq, dsq, L1, L1, MLA_DIMS, bf16,
             True, True),
            ("deepseek batched prefill fp32", B, dsq, dsq, P, P, MLA_DIMS,
             torch.float32, True, True),
            ("deepseek agent prefill fp32", 1, dsq, dsq, L1, L1, MLA_DIMS,
             torch.float32, True, False)):
        dk, dv = head_dims(dim)
        q = normal(b, h, lq, dk, dtype=dtype)
        k = normal(b, g, lk, dk, dtype=dtype)
        v = normal(b, g, lk, dv, dtype=dtype)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, row_err = check_attention(
            out, plain_attention(q, k, v, causal), dtype,
            f"flash_attention ({label})")
        row = {"phase": "kernels", "kernel": "flash_attention",
               "case": label, "shape": [b, h, g, lq, lk, dk]
               + ([dv] if dv != dk else []),
               "causal": causal, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err, "max_row_err": row_err, "card": card}
        if not causal:
            # the row statistics the backward reads, in the new mode
            lse = _forward(q, k, v, False, None, with_lse=True)[1]
            exp_lse = attention_lse_plain(q, k, False)
            row["lse_max_abs_err"] = float((lse - exp_lse).abs().max())
            lse_limit = LSE_REL * max(1.0, float(exp_lse.abs().max()))
            check(row["lse_max_abs_err"] <= lse_limit,
                  f"flash_attention lse ({label}) within {lse_limit} "
                  f"max-abs ({row['lse_max_abs_err']})")
            del lse, exp_lse
        if not timed:
            emit(row)
            continue
        args = lambda: (q, k, v, causal)   # noqa: E731
        work = 2 * (dk + dv) * b * h * attention_pairs(lq, lk, causal)
        rate_ops = flops if dtype == bf16 else fp32_flops
        bound = max(size(q, k, v, out) / rate, work / rate_ops) * 1e3
        dev_ms, host_ms = device_ms(flash_attention, args, 5)
        row.update({
            "ms": median_ms(flash_attention, args, 5),
            "device_ms": dev_ms, "host_ms": host_ms,
            "plain_ms": median_ms(plain_attention, args, 3),
            "library_ms": library_ms(lambda: median_ms(
                lambda a, b_, c, m: F.scaled_dot_product_attention(
                    a, b_, c, is_causal=m, enable_gqa=True), args, 5),
                dk != dv),
            "bound_ms": bound, "bound_by": "operations"})
        row["tflops"] = work / (row["device_ms"] * 1e-3) / 1e12
        emit(row)
        if dtype == bf16:
            repeat_cases.append(("flash_attention", label,
                                 functools.partial(flash_attention, q, k, v,
                                                   causal=causal), out))
        if label == "batched prefill":
            results["flash_attention"] = row
    repeat_cases += check_flash_offsets(card, rate, flops, fp32_flops, gen)

    # --- decode: the batched request's steps (kv_len P + 1 .. P + 32 over
    # a cache of P + 32, as the path gives them), a ragged mid shape
    # the context cells' self caches (as gemma-2b's) and their write-once
    # cross caches, read whole (kv_len = L for every row)
    steps = SERVE["decode_steps"]
    for label, b, h, g, L, dim, dtype, lens_kind in (
            ("batched decode", B, hq, hkv, P + steps, hd, bf16, "steps"),
            ("olmoe batched decode", B, mq, mkv, P + steps, md, bf16,
             "steps"),
            ("whisper batched decode", B, wq, wq, P + steps, wd, bf16,
             "steps"),
            ("whisper cross decode", B, wq, wq, wT, wd, bf16, "full"),
            ("vlm batched decode", B, vq, vkv, P + steps, vd, bf16, "steps"),
            ("vlm cross decode", B, vq, vkv, vT, vd, bf16, "full"),
            ("mid bf16", 8, 16, 8, 2048, 128, bf16, "ragged"),
            ("mid fp32", 4, 8, 2, 777, 64, torch.float32, "ragged"),
            ("deepseek batched decode", B, dsq, dsq, P + steps, MLA_DIMS,
             bf16, "steps"),
            ("mla mid fp32", 4, dsq, dsq, 777, MLA_DIMS, torch.float32,
             "ragged")):
        dk, dv = head_dims(dim)
        q = normal(b, h, dk, dtype=dtype)
        kc = normal(b, g, L, dk, dtype=dtype)
        vc = normal(b, g, L, dv, dtype=dtype)
        if lens_kind == "ragged":
            cases = [torch.randint(1, L + 1, (b,), generator=gen,
                                   device="cuda", dtype=torch.int32)]
        else:
            cases = [torch.full((b,), n, dtype=torch.int32, device="cuda")
                     for n in ([L] if lens_kind == "full" else
                               range(P + 1, P + steps + 1))]
        err, row_err = 0.0, None
        for lens in cases:
            out = decode_attention(q, kc, vc, lens)
            torch.cuda.synchronize()
            e, r = check_attention(
                out, decode_attention_plain(q, kc, vc, lens), dtype,
                f"decode_attention ({label}, kv_len {lens.tolist()})")
            err = max(err, e)
            row_err = r if row_err is None else max(row_err, r)
        args = lambda: (q, kc, vc, lens)   # noqa: E731
        mask = (torch.arange(L, device="cuda")[None, None, None, :]
                < lens[:, None, None, None])
        valid = int(lens.sum())
        moved = ((dk + dv) * valid * g * kc.element_size() + size(q, out)
                 + lens.numel() * 4)
        dev_ms, host_ms = device_ms(decode_attention, args, 10)
        row = {"phase": "kernels", "kernel": "decode_attention",
               "case": label, "shape": [b, h, g, L, dk]
               + ([dv] if dv != dk else []),
               "dtype": str(dtype).split(".")[-1], "kv_lens_checked":
               len(cases), "max_abs_err": err, "max_row_err": row_err,
               "ms": median_ms(decode_attention, args, 10),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(decode_attention_plain, args, 3),
               "library_ms": library_ms(lambda: median_ms(
                   lambda a, b_, c, n: F.scaled_dot_product_attention(
                       a[:, :, None], b_, c, attn_mask=mask,
                       enable_gqa=True), args, 10), dk != dv),
               "bound_ms": max(moved / rate, 2 * h * (dk + dv) * valid
                               / (flops if dtype == bf16 else fp32_flops))
               * 1e3, "bound_by": "bytes", "card": card}
        emit(row)
        if dtype == bf16:
            repeat_cases.append(("decode_attention", label, functools.partial(
                decode_attention, q, kc, vc, lens), out))
        if label == "batched decode":
            results["decode_attention"] = row
    results["rwkv6_scan"], wkv_repeats = check_rwkv6_scan(
        card, rate, fp32_flops, gen, P, L1)
    mamba_rows, mamba_repeats = check_mamba_kernels(card, rate, fp32_flops,
                                                    gen, P, L1)
    results.update(mamba_rows)
    host_split(card)

    # bf16 flash attention, flash decode, the WKV scan and Mamba's conv and
    # scan launched again at each shape, after every timing (a burst of
    # launches slows the kernel timed right after it), each output equal
    # to the first of the same inputs
    check_repeats(card, repeat_cases + wkv_repeats + mamba_repeats)
    return results


def host_us(fn) -> float:
    """Mean host time of ``fn()`` over ``HOST_SPLIT_CALLS`` calls back to
    back behind one spin kernel (:func:`behind_spin`), in microseconds."""
    import torch
    _, ms = behind_spin(lambda: [fn() for _ in range(HOST_SPLIT_CALLS)],
                        SPIN_CYCLES * 4)
    torch.cuda.synchronize()
    return ms / HOST_SPLIT_CALLS * 1e3


def chunk_host_split(card: str) -> None:
    """How the host time of a ``chunk_tick_`` call at the content fleet's
    shape splits: the whole call, then the routing rule, the checks, the
    two output allocations and ``backend.launch`` with the pointers
    ready, each on its own (``host_us``).  It reads only names the
    package has had since the kernel was first ported, so it times an
    earlier tree's wrapper as well when that tree's ``src`` comes first
    on ``sys.path``."""
    import torch
    from repro_torch.kernels import backend, chunk_diff
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, n, m, C = CHUNK_SHAPES[-1]
    args, opts = random_chunk_inputs(gen, B, n, m, C)

    def outputs():
        return (torch.empty((B, n, C), dtype=torch.int32, device="cuda"),
                torch.empty((B, chunk_diff.N_CHUNK_COUNTERS),
                            dtype=torch.int32, device="cuda"))

    ptrs = [t.data_ptr() for t in args + outputs()]
    chunk_diff.chunk_tick_(*args, **opts)   # the library built and loaded
    emit({"phase": "kernels", "kernel": "chunk_tick", "host_split_us": {
        "call": host_us(lambda: chunk_diff.chunk_tick_(*args, **opts)),
        "route": host_us(lambda: backend.use_kernel(*args)),
        "checks": host_us(lambda: chunk_diff._check(*args)),
        "outputs": host_us(outputs),
        "launch": host_us(lambda: backend.launch(
            "chunk_tick", 0, *ptrs, B, n, m, C, opts["chunk_tokens"],
            opts["artifact_tokens"], opts["signal_tokens"], 4))},
        "shape": [B, n, m, C], "card": card})


def decide_host_split(card: str) -> None:
    """How a kernel-route ``decide`` call of the service's content broker
    (``SERVICE``: 32 clients, 6 artifacts, 64-token chunks) splits, in
    microseconds: the whole call, then each piece on its own: building
    the prefix batch with the content plane's inputs and moving it to
    the card in one copy (``decision_inputs``),
    the MESI tick's launch with its gathers (``decision_tick``), the
    chunk tick's launch, the one read-back (the batch's buffers copied
    to the host) and the host bookkeeping (the call less the four).  The
    two launches are timed behind a spin kernel (``host_us``); the call,
    the prefix batch and the read-back (which waits for the card) as the
    mean wall time of ``HOST_SPLIT_CALLS`` calls on an idle stream."""
    import numpy as np
    import torch
    from repro_torch.core import acs
    from repro_torch.kernels import chunk_diff, mesi_transition as mt
    from repro_torch.service import BatchDecider

    def wall_us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_SPLIT_CALLS):
            fn()
        return (time.perf_counter() - t0) / HOST_SPLIT_CALLS * 1e6

    n, m = SERVICE["clients"], SERVICE["artifacts"]
    cfg = acs.ACSConfig(n_agents=n, n_artifacts=m,
                        artifact_tokens=SERVICE["artifact_tokens"],
                        n_steps=1, chunk_tokens=SERVICE["chunk_tokens"])
    C = acs.content_chunks(cfg)
    rng = np.random.default_rng(SEED)
    acts = rng.random(n) < 0.75
    arts = rng.integers(0, m, n).astype(np.int32)
    writes = rng.random(n) < 0.10
    wchunks = rng.random((n, C)) < 0.25
    decider = BatchDecider(cfg, "kernel", device="cuda")
    decider.decide(acts, arts, writes, write_chunks=wchunks)
    a = decider.arrays
    opts = dict(artifact_tokens=cfg.artifact_tokens, eager=False,
                access_k=0, signal_tokens=12)
    # the pieces as the decider runs them (``BatchDecider._decide_kernel``)
    tail = np.concatenate([(acts & writes).astype(np.int32),
                           wchunks.astype(np.int32).reshape(-1)])
    prefix = mt.decision_inputs(acts, arts, writes, m, "cuda", tail=tail)
    st, ver, sy, rd, cnt, miss, served = mt.decision_tick(
        a.state, a.version, a.last_sync, a.reads_since_fetch, prefix,
        **opts)
    B, head = n + 1, 3 * (n + 1) * n + 2 * n
    chunk_args = (a.chunk_version.clone(), a.chunk_sync.clone(),
                  a.chunk_dirty.clone(), miss[None],
                  prefix[head:head + n][None], prefix[B * n:B * n + n][None],
                  prefix[head + n:].view(1, n, C))
    copts = dict(artifact_tokens=cfg.artifact_tokens,
                 chunk_tokens=cfg.chunk_tokens, signal_tokens=12)
    fetched, ccnt = chunk_diff.chunk_tick_(*chunk_args, **copts)
    parts = [st, ver, miss, served, cnt[:6], ccnt[0, :3], fetched]
    split = {
        "call": wall_us(lambda: decider.decide(acts, arts, writes,
                                               write_chunks=wchunks)),
        "prefix_batch": wall_us(lambda: mt.decision_inputs(
            acts, arts, writes, m, "cuda", tail=tail)),
        "mesi_tick_launch": host_us(lambda: mt.decision_tick(
            a.state, a.version, a.last_sync, a.reads_since_fetch, prefix,
            **opts)),
        "chunk_tick_launch": host_us(lambda: chunk_diff.chunk_tick_(
            *chunk_args, **copts)),
        "read_back": wall_us(lambda: decider._read_back(parts))}
    split["bookkeeping"] = split["call"] - sum(
        split[k] for k in ("prefix_batch", "mesi_tick_launch",
                           "chunk_tick_launch", "read_back"))
    emit({"phase": "kernels", "kernel": "service_decide",
          "host_split_us": split, "route": "kernel",
          "shape": {"clients": n, "artifacts": m, "chunks": C,
                    "requests": int(acts.sum())}, "card": card})


def host_split(card: str) -> None:
    """How the host time of a call splits, for ``mesi_tick_`` at the
    content fleet's shape (lazy), ``rwkv6_scan`` at rwkv6-1.6b's decode
    step (24 calls a step) and ``chunk_tick_`` (``chunk_host_split``):
    the whole call, then each piece of it on its own: the routing rule,
    the checks, the output allocations, the bonus conversion the wrapper
    skips for an fp32 bonus, and ``backend.launch`` with the pointers
    ready.  Each is the mean of ``HOST_SPLIT_CALLS`` calls back to back
    behind one spin kernel (``host_us``), in microseconds."""
    import torch
    import importlib
    from repro_torch.configs import get
    from repro_torch.kernels import backend, mesi_transition as mt
    wkv = importlib.import_module("repro_torch.kernels.rwkv6_scan")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, n, m = MESI_SHAPES[-1]
    args = random_mesi_inputs(gen, B, n, m)
    opts = dict(artifact_tokens=4096, eager=False, access_k=0,
                signal_tokens=12)
    ptrs = [t.data_ptr() for t in args + mt._outputs(B, n, "cuda")]
    emit({"phase": "kernels", "kernel": "mesi_tick", "host_split_us": {
        "call": host_us(lambda: mt.mesi_tick_(*args, **opts)),
        "route": host_us(lambda: backend.use_kernel(*args)),
        "checks": host_us(lambda: mt._check(*args)),
        "outputs": host_us(lambda: mt._outputs(B, n, "cuda")),
        "launch": host_us(lambda: backend.launch(
            "mesi_tick", 0, *ptrs, B, n, m, 4096, 0, 0, 12))},
        "shape": [B, n, m], "card": card})

    cfg = get(SERVE_RWKV["arch"])
    h, dh = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    b = SERVE_RWKV["agents"]
    r, k, v, w = (torch.rand((b, 1, h, dh), generator=gen, device="cuda")
                  for _ in range(4))
    bonus = torch.randn((h, dh), generator=gen, device="cuda")
    s0 = torch.randn((b, h, dh, dh), generator=gen, device="cuda")
    y, state = wkv._outputs(r)
    wptrs = [x.data_ptr() for x in (r, k, v, w, bonus, s0, y, state)]
    emit({"phase": "kernels", "kernel": "rwkv6_scan", "host_split_us": {
        "call": host_us(lambda: wkv.rwkv6_scan(r, k, v, w, bonus, s0)),
        "route": host_us(lambda: backend.use_kernel(r, k, v, w, bonus,
                                                     s0)),
        "checks": host_us(lambda: wkv._check(r, k, v, w, bonus, s0)),
        "bonus_conversion": host_us(
            lambda: bonus.to(torch.float32).contiguous()),
        "outputs": host_us(lambda: wkv._outputs(r)),
        "launch": host_us(lambda: backend.launch(
            "rwkv6_scan", 0, *wptrs, None, b, 1, h, dh, 0, 0))},
        "shape": [b, 1, h, dh], "card": card})
    chunk_host_split(card)
    decide_host_split(card)


def check_rwkv6_scan(card: str, rate: float, fp32_flops: float, gen,
                     P: int, L1: int) -> tuple:
    """The WKV kernel against its plain version at the rwkv serving
    path's shapes (rwkv6-1.6b: the batched prefill of P steps, one
    agent's prefill of L1, a decode step from a random state) and a
    ragged bf16 mid shape; returns the batched prefill's row and the
    shapes' cases for ``check_repeats``.  Each row's ``issue_floor_ms``
    is the time of four fp32 instructions per state element per step
    (the state update's rounded multiply, multiply and add, and y's FMA)
    over the card's fp32 lanes at its highest SM clock."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.ref import rwkv6_scan_plain
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    cfg = get(SERVE_RWKV["arch"])
    h, dh = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    n = SERVE_RWKV["agents"]
    f32 = torch.float32
    lanes = (torch.cuda.get_device_properties(0).multi_processor_count
             * FP32_LANES_PER_SM)
    clock_hz = max_sm_clock_hz()
    result, repeats = None, []
    for label, b, t, heads, dtype, state in (
            ("batched prefill", n, P, h, f32, False),
            ("agent prefill", 1, L1, h, f32, False),
            ("decode", n, 1, h, f32, True),
            ("mid bf16", 2, 1000, 8, torch.bfloat16, False)):
        r, k, v = (torch.randn((b, t, heads, dh), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        # the model's decay range: exp(-exp(U(-8, -5)))
        w = torch.exp(-torch.exp(torch.rand(
            (b, t, heads, dh), generator=gen, device="cuda") * 3 - 8)
        ).to(dtype)
        bonus = torch.randn((heads, dh), generator=gen, device="cuda") * 0.1
        s0 = (torch.randn((b, heads, dh, dh), generator=gen, device="cuda")
              if state else None)
        args = (r, k, v, w, bonus, s0)
        y, s = rwkv6_scan(*args)
        torch.cuda.synchronize()
        ey, es = rwkv6_scan_plain(*args)
        check(torch.equal(s, es),
              f"rwkv6_scan final state == plain bit for bit ({label})")
        err = float((y.float() - ey.float()).abs().max())
        row_rms = ey.float().square().mean(dim=-1, keepdim=True).sqrt()
        row_rel = float(((y.float() - ey.float()).abs() / row_rms).max())
        if dtype == f32:
            head_rms = ey.square().mean(dim=(1, 3), keepdim=True).sqrt()
            wkv_err = float(((y - ey).abs() / (WKV_FP32_TOL * head_rms))
                            .max())
            check(wkv_err <= 1.0, f"rwkv6_scan y within {WKV_FP32_TOL} of "
                  f"its head's rms ({label}: {wkv_err})")
        else:
            wkv_err = bf16_row_err(y, ey)
            check(wkv_err <= 1.0, f"rwkv6_scan y within one bf16 ulp plus "
                  f"{ROW_RMS_FLOOR} of the row rms ({label}: {wkv_err})")
        moved = (sum(x.numel() * x.element_size()
                     for x in args + (y, s) if x is not None))
        work = 5 * b * t * heads * dh * dh
        bytes_ms, ops_ms = moved / rate * 1e3, work / fp32_flops * 1e3
        make = lambda: args   # noqa: E731
        dev_ms, host_ms = device_ms(rwkv6_scan, make, 5)
        row = {"phase": "kernels", "kernel": "rwkv6_scan", "case": label,
               "shape": [b, t, heads, dh], "dtype": str(dtype).split(".")[-1],
               "initial_state": state, "state_equal": True,
               "max_abs_err": err, "max_wkv_err": wkv_err,
               "max_err_over_row_rms": row_rel,
               "ms": median_ms(rwkv6_scan, make, 5),
               "device_ms": dev_ms, "host_ms": host_ms,
               # one call of the plain loop is itself thousands of steps
               "plain_ms": median_ms(rwkv6_scan_plain, make, 1),
               "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
               "issue_floor_ms": 4 * b * t * heads * dh * dh
               / (lanes * clock_hz) * 1e3,
               "card": card}
        emit(row)
        repeats.append(("rwkv6_scan", label,
                        functools.partial(rwkv6_scan, *args), (y, s)))
        if label == "batched prefill":
            result = row
    return result, repeats


#: MUFU (``ex2``) results an SM issues a clock on Hopper: the selective
#: scan's issue floor is its exponentials at this rate
MUFU_PER_SM = 16
#: fp32 operations per element of the causal conv (four products, four
#: sums with the bias, SiLU's exp, add and divide) and of its backward
#: (the pre-activation again, SiLU's derivative, dx's four products and
#: sums, dw's and db's five multiply-adds); per state element a step of
#: the selective scan (dt a, dt b, times x, E h, the sum, y's FMA: 7, and
#: the exp counted as one) and of its backward (the forward's state again
#: and the reverse step's sixteen)
CONV_FLOPS, CONV_BWD_FLOPS = 11, 32
SCAN_FLOPS, SCAN_BWD_FLOPS = 8, 8 + 16
#: what the gated scan adds a channel a step: MUFU operations (softplus's
#: exp and log, SiLU's exp and reciprocal) and fp32 operations (the bias,
#: softplus's exp, add and log, SiLU's exp, add and divide, the product)
GATED_MUFU, GATED_FLOPS = 4, 8
#: MUFU operations an output of the causal conv (SiLU's exp and
#: reciprocal)
CONV_MUFU = 2


#: (B, T, d_inner, d_state) of ``check_long_memory``
LONG_MEMORY = (1, 6144, 512, 16)


def mamba_shapes(P: int, L1: int) -> tuple:
    """The Mamba kernels' cases of phase ``kernels`` (label, b, t, d_inner,
    d_state, dtype name, with a state): jamba-1.5-large-398b's serving path
    (the batched prefill of P steps, one agent's of L1, a decode step from
    a state) and a ragged shape (d_inner 384, no power of two) in both
    types, and the smoke config's."""
    from repro_torch.configs import get
    m = get(SERVE_JAMBA["arch"])
    d, n = m.mamba.expand * m.d_model, m.mamba.d_state
    B = SERVE_JAMBA["agents"]
    return (("batched prefill", B, P, d, n, "bfloat16", False),
            ("agent prefill", 1, L1, d, n, "bfloat16", False),
            ("decode", B, 1, d, n, "bfloat16", True),
            ("ragged fp32", 2, 333, 384, 16, "float32", True),
            ("ragged bf16", 2, 333, 384, 16, "bfloat16", True),
            ("smoke fp32", 2, 64, 256, 8, "float32", False))


def mamba_inputs(gen, b: int, t: int, d: int, n: int, dtype, state: bool):
    """The conv's (x the x half of an input projection, row stride 2d;
    weights; a bias off its init, 0.1 N(0, 1); a state or None) and the
    scan's inputs (dt as the model makes it, softplus around its bias's
    init; a = -(1..n) scaled by exp(0.3 N(0, 1)); b, c, x N(0, 1); d_skip
    1 + 0.3 N(0, 1); an fp32 state or None)."""
    import torch
    import torch.nn.functional as F

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xz = normal(b, t, 2 * d).to(dtype)
    conv = (xz[..., :d], (0.3 * normal(4, d)).to(dtype),
            (0.1 * normal(d)).to(dtype),
            normal(b, 3, d).to(dtype) if state else None)
    scan = (F.softplus(normal(b, t, d) - 3.0),
            -torch.exp(0.3 * normal(d, n)) * torch.arange(1, n + 1,
                                                           device="cuda"),
            normal(b, t, n), normal(b, t, n), normal(b, t, d),
            1 + 0.3 * normal(d), 0.5 * normal(b, d, n) if state else None)
    return conv, scan


def gated_inputs(gen, scan, x):
    """The gated scan's inputs beside ``scan``'s a, b, c, d_skip and
    state: dt's raw projection 0.5 N(0, 1) in x's type, its bias at its
    init (the inverse softplus of U(1e-3, 1e-1)), x (the conv's output)
    and z, the z half of an input projection (row stride 2d)."""
    import torch
    b, t, d = x.shape
    raw = (0.5 * torch.randn((b, t, d), generator=gen, device="cuda")).to(
        x.dtype)
    dt0 = 1e-3 + (1e-1 - 1e-3) * torch.rand(d, generator=gen, device="cuda")
    z = torch.randn((b, t, 2 * d), generator=gen, device="cuda").to(
        x.dtype)[..., d:]
    return (raw, torch.log(torch.expm1(dt0)), scan[1], scan[2], scan[3], x,
            z, scan[5], scan[6])


def unfused_gated(dt_raw, dt_bias, a, b, c, x, z, d_skip, state=None):
    """What the gated scan replaces: the scan kernel's fp32 mode between
    the torch ops of ``models/mamba.py``'s autograd chain (dt's softplus,
    the casts, the SiLU gate)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.selective_scan import selective_scan
    y, h = selective_scan(F.softplus(dt_raw.to(torch.float32) + dt_bias), a,
                          b, c, x.to(torch.float32), d_skip, state)
    return y.to(x.dtype) * F.silu(z), h


def ulp_err(got, exp) -> float:
    """Largest |got - exp| in ulps of exp's type at exp."""
    import torch
    e = exp.float()
    bits = 8 if exp.dtype == torch.bfloat16 else 24
    ulp = torch.ldexp(torch.ones_like(e), torch.frexp(e).exponent - bits)
    return float(((got.float() - e).abs() / ulp).max())


def rms_err(got, exp) -> float:
    return float((got.float() - exp.float()).abs().max()
                 / exp.float().square().mean().sqrt())


def check_long_memory(card: str, gen) -> None:
    """The case that catches a biased exponential: dt = 1e-3 (its init's
    floor) with a = -1 and -16 (states that remember ~1000 and ~60
    steps) over 6144 steps, one batch row of 512 channels (four lanes a
    channel): both modes' y or output and state against their plain
    versions, within 1e-5 of the rms (the gated output in fp32, where a
    bf16 rounding would hide a drift)."""
    import torch
    from repro_torch.kernels.ref import (selective_scan_gated_plain,
                                         selective_scan_plain)
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_gated)
    b, t, d, n = LONG_MEMORY
    a = torch.where(torch.arange(n, device="cuda") % 2 == 0, -1.0,
                    -16.0).expand(d, n).contiguous()

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    bm, cm, x = normal(b, t, n), normal(b, t, n), normal(b, t, d)
    dskip = 1 + 0.3 * normal(d)
    dt = torch.full((b, t, d), 1e-3, device="cuda")
    y, s = selective_scan(dt, a, bm, cm, x, dskip)
    ey, es = selective_scan_plain(dt, a, bm, cm, x, dskip)
    # softplus(0 + bias) = 1e-3 up to the bias's rounding
    bias = torch.full((d,), math.log(math.expm1(1e-3)), device="cuda")
    z = normal(b, t, 2 * d)[..., d:]
    g = (torch.zeros_like(x), bias, a, bm, cm, x, z, dskip)
    go, gs = selective_scan_gated(*g)
    po, ps = selective_scan_gated_plain(*g)
    errs = {"y": rms_err(y, ey), "state": rms_err(s, es),
            "gated_out": rms_err(go, po), "gated_state": rms_err(gs, ps)}
    emit({"phase": "kernels", "kernel": "selective_scan",
          "case": "long memory", "shape": [b, t, d, n], "dt": 1e-3,
          "a": [-1.0, -16.0], "err_over_rms": errs, "card": card})
    check(max(errs.values()) <= WKV_FP32_TOL,
          f"selective_scan's long-memory case within {WKV_FP32_TOL} of "
          f"its rms in both modes ({errs})")


def conv_library(x, weight, bias):
    """The yardstick of the causal conv: ``F.conv1d`` (depthwise, padded
    by 3 on the left's behalf) and ``F.silu``, one PyTorch call each, on
    the (B, D, T) view of x, the result viewed back as (B, T, D)."""
    import torch.nn.functional as F
    t, d = x.shape[1], x.shape[2]
    return F.silu(F.conv1d(x.transpose(1, 2), weight.t()[:, None, :], bias,
                           padding=weight.shape[0] - 1,
                           groups=d)[..., :t]).transpose(1, 2)


def check_mamba_kernels(card: str, rate: float, fp32_flops: float, gen,
                        P: int, L1: int) -> tuple:
    """Mamba's two forward kernels against their plain versions at
    ``mamba_shapes``: the causal conv's output bit for bit or within one
    ulp of its type (the share of differing elements printed) and its new
    state bit for bit; the selective scan's y and final state within 1e-5
    of their rms (whether the state is bit-equal printed).  Each timed
    alone and through its wrapper beside its bound, the plain version and
    the library yardstick (the conv's ``conv_library`` without a state;
    none computes the scan), the scan also beside its issue floor (its
    exponentials at ``MUFU_PER_SM`` an SM a clock at the card's highest
    SM clock).  Returns the batched prefill's rows and the cases for
    ``check_repeats``."""
    import torch
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_plain)
    from repro_torch.kernels.ref import selective_scan_gated_plain
    from repro_torch.kernels.selective_scan import (plan, selective_scan,
                                                    selective_scan_gated,
                                                    selective_scan_plain)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = max_sm_clock_hz()
    results, repeats = {}, []
    check_long_memory(card, gen)

    def size(*ts):
        return sum(v.numel() * v.element_size() for v in ts if v is not None)

    for label, b, t, d, n, name, state in mamba_shapes(P, L1):
        dtype = getattr(torch, name)
        conv, scan = mamba_inputs(gen, b, t, d, n, dtype, state)
        out, new = causal_conv1d(*conv)
        torch.cuda.synchronize()
        eo, en = causal_conv1d_plain(*conv)
        check(torch.equal(new, en), f"causal_conv1d new state == plain bit "
              f"for bit ({label})")
        ulps = ulp_err(out, eo)
        check(ulps <= 1.0, f"causal_conv1d ({label}) within one ulp of its "
              f"plain version ({ulps})")
        make = lambda: conv   # noqa: E731
        dev_ms, host_ms = device_ms(causal_conv1d, make, 10)
        x = conv[0]
        bytes_ms = (2 * x.numel() * x.element_size() + size(*conv[1:])
                    + size(new)) / rate * 1e3
        ops_ms = CONV_FLOPS * x.numel() / fp32_flops * 1e3
        vec = 16 // x.element_size()
        sass_per, sass_ms = sass_issue(
            "causal_conv1d", r"conv_kernelI13__nv_bfloat16E" if vec == 8
            else r"conv_kernelIfE", "STG.E.128", x.numel() // vec, sms,
            clock_hz)
        row = {"phase": "kernels", "kernel": "causal_conv1d", "case": label,
               "shape": [b, t, d], "dtype": name, "initial_state": state,
               "issue_floor_ms": CONV_MUFU * x.numel()
               / (MUFU_PER_SM * sms * clock_hz) * 1e3,
               "sass_per_value": sass_per / vec, "sass_issue_ms": sass_ms,
               "x_row_stride": x.stride(1), "state_equal": True,
               "bit_equal": bool(torch.equal(out, eo)),
               "differing_share": float((out != eo).float().mean()),
               "max_abs_err": float((out.float() - eo.float()).abs().max()),
               "max_ulps": ulps,
               "ms": median_ms(causal_conv1d, make, 10),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(causal_conv1d_plain, make, 3),
               "library_ms": None if state else median_ms(
                   lambda x_, w, b_, s: conv_library(x_, w, b_), make, 10),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "card": card}
        emit(row)
        repeats.append(("causal_conv1d", label,
                        functools.partial(causal_conv1d, *conv), (out, new)))
        del eo, en, new
        elems = b * t * d * n
        y, s = selective_scan(*scan)
        torch.cuda.synchronize()
        ey, es = selective_scan_plain(*scan)
        errs = [rms_err(y, ey), rms_err(s, es)]
        check(max(errs) <= WKV_FP32_TOL, f"selective_scan ({label}) y and "
              f"state within {WKV_FP32_TOL} of their rms ({errs})")
        make = lambda: scan   # noqa: E731
        dev_ms, host_ms = device_ms(selective_scan, make, 5)
        bytes_ms = (size(*scan) + size(y, s)) / rate * 1e3
        ops_ms = (SCAN_FLOPS * elems + 2 * b * t * d) / fp32_flops * 1e3
        lanes = plan(b, d, sms)
        sass_per, sass_ms = sass_issue(
            "selective_scan", rf"scan_kernelIfLb0ELi{n}ELi{lanes}EE",
            "MUFU.EX2", elems, sms, clock_hz)
        srow = {"phase": "kernels", "kernel": "selective_scan",
                "mode": "fp32", "case": label, "shape": [b, t, d, n],
                "dtype": "float32", "initial_state": state,
                "lanes": lanes, "sass_per_exp": sass_per,
                "sass_issue_ms": sass_ms,
                "state_equal": bool(torch.equal(s, es)),
                "max_abs_err": float((y - ey).abs().max()),
                "y_err_over_rms": errs[0], "state_err_over_rms": errs[1],
                "ms": median_ms(selective_scan, make, 5),
                "device_ms": dev_ms, "host_ms": host_ms,
                # one call of the plain loop is itself thousands of steps
                "plain_ms": median_ms(selective_scan_plain, make, 1),
                "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
                "issue_floor_ms": elems / (MUFU_PER_SM * sms * clock_hz)
                * 1e3, "card": card}
        emit(srow)
        repeats.append(("selective_scan", label,
                        functools.partial(selective_scan, *scan), (y, s)))
        del ey, es
        # the gated mode, on the conv's output
        g = gated_inputs(gen, scan, out)
        go, gs = selective_scan_gated(*g)
        torch.cuda.synchronize()
        co, cs = unfused_gated(*g)
        ulps = ulp_err(go, co)
        check(ulps <= 1.0 and torch.equal(gs, cs),
              f"selective_scan_gated ({label}) within one ulp of the "
              f"unfused chain ({ulps}) and its state bit for bit")
        po, ps = selective_scan_gated_plain(*g)
        state_err = rms_err(gs, ps)
        check(state_err <= WKV_FP32_TOL, f"selective_scan_gated ({label}) "
              f"state within {WKV_FP32_TOL} of its rms ({state_err})")
        make = lambda: g   # noqa: E731
        dev_ms, host_ms = device_ms(selective_scan_gated, make, 5)
        bytes_ms = (size(*g) + size(go, gs)) / rate * 1e3
        ops_ms = (SCAN_FLOPS * elems + (2 + GATED_FLOPS) * b * t * d) \
            / fp32_flops * 1e3
        # softplus's and SiLU's expf are MUFU.EX2s of the loop too
        io = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
        sass_per, sass_ms = sass_issue(
            "selective_scan", rf"scan_kernelI{io}Lb1ELi{n}ELi{lanes}EE",
            "MUFU.EX2", elems + 2 * b * t * d, sms, clock_hz)
        grow = {"phase": "kernels", "kernel": "selective_scan",
                "mode": "gated", "case": label, "shape": [b, t, d, n],
                "dtype": name, "initial_state": state, "lanes": lanes,
                "sass_per_exp": sass_per, "sass_issue_ms": sass_ms,
                "z_row_stride": g[6].stride(1),
                "bit_equal_to_unfused": bool(torch.equal(go, co)),
                "differing_share_unfused": float((go != co).float().mean()),
                "max_ulps_unfused": ulps,
                "max_abs_err": float((go.float() - po.float()).abs().max()),
                "max_ulps_plain": ulp_err(go, po),
                "differing_share_plain": float((go != po).float().mean()),
                "state_err_over_rms": state_err,
                "ms": median_ms(selective_scan_gated, make, 5),
                "device_ms": dev_ms, "host_ms": host_ms,
                "unfused_ms": device_ms(unfused_gated, make, 5)[0],
                "plain_ms": median_ms(selective_scan_gated_plain, make, 1),
                "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
                "issue_floor_ms": (elems + GATED_MUFU * b * t * d)
                / (MUFU_PER_SM * sms * clock_hz) * 1e3, "card": card}
        emit(grow)
        repeats.append(("selective_scan_gated", label,
                        functools.partial(selective_scan_gated, *g),
                        (go, gs)))
        del co, cs, po, ps, out
        if label == "batched prefill":
            # the serving paths launch the gated mode (training the fp32)
            grow["fp32_mode"] = {k: srow[k] for k in (
                "ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
                "bound_by", "issue_floor_ms", "sass_issue_ms",
                "max_abs_err")}
            results["causal_conv1d"], results["selective_scan"] = row, grow
    return results, repeats


def phase_goldens(card: str) -> None:
    """The committed golden ledgers on the card, on the port's own
    threefry draws in legacy mode: the scenarios exactly; the zoo and
    content cells with the runs that differ counted by family (the
    Gumbel sampler's ``log`` may round apart from XLA's on the card)."""
    import torch
    from repro_torch.core import acs, prng
    from repro_torch.sim import (SCENARIOS, compare_grid, make, run_workload,
                                 zoo)

    golden_dir = REPO / "tests" / "golden"

    def golden(name):
        return json.loads((golden_dir / f"{name}.json").read_text())

    def roundtrip(payload):
        return json.loads(json.dumps(payload, sort_keys=True, default=float))

    t0 = time.perf_counter()
    cmps = compare_grid(list(SCENARIOS.values()), partitionable=False)
    payload = {key: {
        "scenario": c.scenario, "volatility": c.volatility,
        "broadcast_total_mean": c.broadcast.total_tokens_mean,
        "coherent_total_mean": c.coherent.total_tokens_mean,
        "savings_mean": c.savings_mean, "savings_std": c.savings_std,
        "crr": c.crr, "cache_hit_rate_mean": c.chr_mean}
        for key, c in zip(SCENARIOS, cmps)}
    check(roundtrip(payload) == golden("scenarios"),
          "tests/golden/scenarios.json reproduced exactly (legacy mode)")

    zoo_golden = golden("workloads")
    grid = zoo_golden["_grid"]
    differ = {}
    for w in zoo(**grid):
        bc = run_workload(w.with_strategy(acs.BROADCAST),
                          partitionable=False)
        co = run_workload(w, partitionable=False)
        want = zoo_golden[w.family]
        differ[w.family] = sum(
            int(a != b) for a, b in zip(
                [int(x) for x in co.per_run_total_tokens]
                + [int(x) for x in bc.per_run_total_tokens],
                want["coherent_per_run"] + want["broadcast_per_run"]))
    content_golden = golden("content")
    small = dict(n_agents=4, n_artifacts=3, n_runs=2, artifact_tokens=96,
                 n_steps=8)
    for family in ("bursty", "ping_pong"):
        for ct in (16, 40):
            w = make(family, **small, chunk_tokens=ct)
            keys = acs.run_keys(prng.prng_key(w.seed, "cuda"), [0])
            met = acs.run_episode(w.acs, keys, rates=w.rates(),
                                  locality=w.write_locality,
                                  partitionable=False)
            got = {"delta_bytes": int(met.delta_bytes[0]),
                   "full_bytes": int(met.full_bytes[0]),
                   "n_chunks_fetched": int(met.n_chunks_fetched[0]),
                   "n_fills": int(met.n_fetches[0])}
            cell = f"{family}/ct{ct}"
            differ[f"content {cell}"] = int(got != content_golden[cell])
    torch.cuda.synchronize()
    emit({"phase": "scenarios", "goldens": "legacy threefry",
          "scenarios_exact": True, "runs_differing": differ,
          "runs_differing_total": sum(differ.values()),
          "seconds": time.perf_counter() - t0, "card": card})


def phase_scenarios(card: str) -> None:
    import torch
    from repro_torch.core import acs, theorem
    from repro_torch.kernels import mesi_transition as mt
    from repro_torch.sim import SCENARIOS, compare_grid

    phase_goldens(card)

    scns = [dataclasses.replace(SCENARIOS[k], n_runs=SCENARIO_RUNS)
            for k in "ABCD"]
    launches = mt.mesi_tick_.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = compare_grid(scns)
    seconds = time.perf_counter() - t0
    check(mt.mesi_tick_.launches - launches == scns[0].acs.n_steps,
          "one MESI kernel launch per step for the four scenarios")
    for key, scn, c in zip("ABCD", scns, results):
        bound = theorem.savings_lower_bound_uniform(
            scn.acs.n_agents, scn.acs.n_steps, scn.acs.volatility)
        check(c.savings_mean >= bound, f"{key}: savings >= theorem bound")
        check(abs(c.savings_mean - PUBLISHED[key]) <= PUBLISHED_TOLERANCE,
              f"{key}: savings within 2.5 pp of the paper")
        emit({"phase": "scenarios", "scenario": c.scenario,
              "n_runs": scn.n_runs, "savings_mean": c.savings_mean,
              "savings_std": c.savings_std, "theorem_bound": bound,
              "published": PUBLISHED[key], "chr_mean": c.chr_mean})
    emit({"phase": "scenarios", "episodes": 2 * 4 * SCENARIO_RUNS,
          "seconds": seconds,
          "episodes_per_s": 2 * 4 * SCENARIO_RUNS / seconds,
          "card": card})

    # The kernel and scan routes draw the same stream, so on the whole
    # grid every statistic agrees exactly but the staleness diagnostics,
    # which the kernel route does not track.
    untracked = dict(max_staleness_max=-1, max_version_lag_max=-1,
                     max_consumed_staleness_max=-1)
    for key, kern, scan in zip("ABCD", results,
                               compare_grid(scns, tick_backend="scan")):
        check(dataclasses.replace(kern.coherent, **untracked)
              == dataclasses.replace(scan.coherent, **untracked)
              and (kern.savings_mean, kern.savings_std, kern.chr_std)
              == (scan.savings_mean, scan.savings_std, scan.chr_std),
              f"{key}: kernel route == scan route on the card")
    emit({"phase": "scenarios", "routes_equal": True,
          "episodes": 4 * SCENARIO_RUNS,
          "strategy": acs.STRATEGY_NAMES[scns[0].acs.strategy]})


def phase_fleet(card: str) -> float:
    """The zoo fleet runs; returns the content-plane run's seconds."""
    import torch
    from repro_torch.core import acs
    from repro_torch.kernels import chunk_diff, mesi_transition as mt
    from repro_torch.sim import compare_workloads, zoo

    workloads = zoo(n_agents=16, n_artifacts=16, n_runs=FLEET_RUNS,
                    chunk_tokens=64)
    episodes = len(workloads) * FLEET_RUNS
    steps = workloads[0].acs.n_steps
    before = (mt.mesi_tick_.launches, chunk_diff.chunk_tick_.launches)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = compare_workloads(workloads)
    seconds = time.perf_counter() - t0
    check((mt.mesi_tick_.launches - before[0],
           chunk_diff.chunk_tick_.launches - before[1]) == (steps, steps),
          "one launch of each kernel per step for the whole zoo")
    for c in results:
        check(c.coherent.delta_bytes_mean <= c.coherent.full_bytes_mean,
              f"{c.scenario}: delta bytes <= whole-artifact bytes")
        emit({"phase": "fleet", "family": c.scenario,
              "savings_mean": c.savings_mean,
              "delta_bytes_mean": c.coherent.delta_bytes_mean,
              "full_bytes_mean": c.coherent.full_bytes_mean,
              "chr_mean": c.chr_mean})
    fleet_seconds = seconds
    emit({"phase": "fleet", "strategy": "lazy", "chunk_tokens": 64,
          "episodes_per_variant": episodes, "seconds": seconds,
          "episodes_per_s": 2 * episodes / seconds,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": card})

    for code in (acs.EAGER, acs.ACCESS_COUNT):
        ws = [w.with_strategy(code)
              for w in zoo(n_agents=16, n_artifacts=16,
                           n_runs=STRATEGY_FLEET_RUNS)]
        before = (mt.mesi_tick_.launches, chunk_diff.chunk_tick_.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = compare_workloads(ws)
        seconds = time.perf_counter() - t0
        check((mt.mesi_tick_.launches - before[0],
               chunk_diff.chunk_tick_.launches - before[1]) == (steps, 0),
              f"{acs.STRATEGY_NAMES[code]}: one MESI launch per step")
        check(all(0.0 < c.chr_mean <= 1.0 and c.crr > 0.0 for c in res),
              f"{acs.STRATEGY_NAMES[code]}: finite ledgers")
        emit({"phase": "fleet", "strategy": acs.STRATEGY_NAMES[code],
              "episodes_per_variant": len(ws) * STRATEGY_FLEET_RUNS,
              "seconds": seconds,
              "episodes_per_s": 2 * len(ws) * STRATEGY_FLEET_RUNS / seconds,
              "savings_mean": {c.scenario: c.savings_mean for c in res},
              "card": card})
    return fleet_seconds


def fleet_zoo(n_runs: int) -> list:
    """The content fleet of phase ``fleet``: six families, n = m = 16,
    64-token chunks, ``n_runs`` runs each."""
    from repro_torch.sim import zoo
    return zoo(n_agents=16, n_artifacts=16, n_runs=n_runs, chunk_tokens=64)


def fleet_grid(workloads, shards=None, devices=1) -> dict:
    """``compare_workloads(workloads, devices=devices)`` on the card, or
    over ``shards`` new streams of ``cuda:0`` standing in for the host's
    cards when given (``engine._placed``, ``devices=shards``); returns
    its comparisons, every per-run array of its grid (recorded from the
    engine's ``_run_grid``), its seconds and the tick launches it
    made."""
    import contextlib
    import torch
    from repro_torch.kernels import chunk_diff, mesi_transition as mt
    from repro_torch.sim import compare_workloads, engine
    placed = contextlib.nullcontext()
    if shards is not None:
        placed = engine._placed([("cuda:0", torch.cuda.Stream())
                                 for _ in range(shards)])
        devices = shards
    grids = []
    run_grid = engine._run_grid

    def recorded(*args):
        grids.append(run_grid(*args))
        return grids[-1]

    before = (mt.mesi_tick_.launches, chunk_diff.chunk_tick_.launches)
    engine._run_grid = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with placed:
            results = compare_workloads(workloads, devices=devices)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        engine._run_grid = run_grid
    return dict(results=results, grids=grids, seconds=seconds,
                launches=(mt.mesi_tick_.launches - before[0],
                          chunk_diff.chunk_tick_.launches - before[1]))


def same_grid(a: dict, b: dict, what: str) -> None:
    """Two ``fleet_grid`` runs alike: every per-run array of every
    variant equal, and so every statistic."""
    import numpy as np
    check(len(a["grids"]) == len(b["grids"]) == 1
          and all(va.keys() == vb.keys()
                  and all(np.array_equal(va[k], vb[k]) for k in va)
                  for va, vb in zip(a["grids"][0], b["grids"][0]))
          and a["results"] == b["results"],
          f"{what}: every per-run ledger equal")


def fleet_streams(card: str) -> dict:
    """The content fleet cut to ``FLEET_TRACE_STEPS`` steps, unsharded,
    then over ``FLEET_SHARDS`` streams, under the torch profiler (device
    activity only); in the exported trace the unsharded run's tick
    kernels (the first 2 S by start time) must share one stream and the
    sharded run's lie on ``FLEET_SHARDS`` others, S launches of each
    tick on each.  Returns the launches by stream and the seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim import zoo
    t0 = time.perf_counter()
    workloads = zoo(n_agents=16, n_artifacts=16, n_runs=FLEET_RUNS,
                    chunk_tokens=64, n_steps=FLEET_TRACE_STEPS)
    steps = FLEET_TRACE_STEPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fleet_grid(workloads)
        fleet_grid(workloads, FLEET_SHARDS)
    path = REPO / "build" / "fleet_sharded_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    tick = re.compile(r"(mesi|chunk)_(staged|direct)_kernel")
    ticks = sorted((e["ts"], e["args"]["stream"],
                    tick.search(e["name"]).group(1))
                   for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "kernel" and tick.search(e["name"]))
    default = {stream for _, stream, _ in ticks[:2 * steps]}
    shards = collections.Counter((stream, kind)
                                 for _, stream, kind in ticks[2 * steps:])
    streams = {stream for stream, _ in shards}
    check(len(ticks) == 2 * steps * (1 + FLEET_SHARDS) and len(default) == 1,
          f"the unsharded run's {2 * steps} ticks on one stream: "
          f"{len(ticks)} ticks, default {default}")
    check(len(streams) == FLEET_SHARDS and not streams & default
          and set(shards.values()) == {steps},
          f"{steps} ticks of each kind on each of {FLEET_SHARDS} streams, "
          f"none the default: {dict(shards)}")
    return {"default_stream": sorted(default),
            "tick_launches_by_stream": {
                f"{stream}:{kind}": n for (stream, kind), n
                in sorted(shards.items())},
            "seconds": time.perf_counter() - t0}


def phase_fleet_sharded(card: str) -> None:
    """The content fleet of phase ``fleet`` sharded by the engine over
    ``FLEET_SHARDS`` streams of the card: every per-run ledger equal to
    the unsharded run's, ``FLEET_SHARDS`` launches of each tick a step,
    the fallback plans of ``FLEET_FALLBACKS`` equal to their unsharded
    runs, and the shards' streams in a profiler trace
    (:func:`fleet_streams`).  With two or more cards, also the public
    path asked for every card (``devices=cards``) and a K = 4 plane's
    shards on distinct cards.  Runs after phase ``service``: no card
    work of another process overlaps a timing, and no profiler session
    opens before that phase's."""
    import torch
    from repro_torch.sim import engine
    t0 = time.perf_counter()
    workloads = fleet_zoo(FLEET_RUNS)
    steps = workloads[0].acs.n_steps
    plain = fleet_grid(workloads)
    sharded = fleet_grid(workloads, FLEET_SHARDS)
    check(sharded["launches"] == (FLEET_SHARDS * steps,) * 2,
          f"{sharded['launches']} tick launches: {FLEET_SHARDS} of each a "
          f"step")
    same_grid(plain, sharded, f"the fleet over {FLEET_SHARDS} streams")
    fallbacks = []
    for runs, shards, axis in FLEET_FALLBACKS:
        zoo = fleet_zoo(runs)
        with engine._placed([("cuda:0", None)] * shards):
            plan = engine.shard_plan(len(zoo), runs, shards)
        check(plan.axis == axis and plan.devices == shards,
              f"{runs} runs over {shards}: {plan}")
        same_grid(fleet_grid(zoo), fleet_grid(zoo, shards),
                  f"{runs} runs over {shards} streams ({axis})")
        fallbacks.append({"runs": runs, "shards": shards,
                          "plan": plan._asdict()})
    checked_s = time.perf_counter() - t0
    streams = fleet_streams(card)
    cards = torch.cuda.device_count()
    multi = "not run: one card"
    if cards >= 2:
        plan = engine.shard_plan(len(workloads), FLEET_RUNS, cards)
        over = fleet_grid(workloads, devices=cards)
        check(plan.devices == cards
              and over["launches"] == (cards * steps,) * 2,
              f"{over['launches']} tick launches over {cards} cards")
        same_grid(plain, over, f"the fleet over {cards} cards")
        plane = run_plane("uniform", SERVICE_SHARDS[-1])["plane"]
        placed = {dev for dev, _ in plane.placements}
        check(len(placed) == min(cards, SERVICE_SHARDS[-1]),
              f"K = {SERVICE_SHARDS[-1]} plane's shards on {placed}")
        multi = {"fleet_over_cards_s": over["seconds"],
                 "plan": plan._asdict(),
                 "plane_cards": sorted(str(d) for d in placed)}
    episodes = 2 * len(workloads) * FLEET_RUNS
    emit({"phase": "fleet_sharded", "shards": FLEET_SHARDS,
          "placement": f"{FLEET_SHARDS} streams of cuda:0",
          "episodes": episodes, "unsharded_s": plain["seconds"],
          "sharded_s": sharded["seconds"],
          "unsharded_episodes_per_s": episodes / plain["seconds"],
          "sharded_episodes_per_s": episodes / sharded["seconds"],
          "launches": sharded["launches"], "fallbacks": fallbacks,
          "streams": streams, "cards": cards, "multi_card": multi,
          "checks_s": checked_s, "phase_s": time.perf_counter() - t0,
          "budget_s": FLEET_SHARDED_BUDGET_S, "card": card})


def service_workload(family: str):
    """One family of the service cell, built by the port's service
    launcher (``uniform`` is ``zipf`` with skew 0 at V = 0.10, the
    paper's homogeneous scenario)."""
    from repro_torch.launch.service import build_workload
    return build_workload(family, SERVICE["clients"], SERVICE["artifacts"],
                          SERVICE["artifact_tokens"], SERVICE["rounds"],
                          seed=SERVICE_SEEDS[family])


def run_service(family: str, backend: str, chunk_tokens: int = 0,
                device: str = "cuda", **core) -> dict:
    """One broker of the service cell (telemetry and trace capture on)
    driven through its family's lockstep load on ``device``; returns the
    broker, the ``LoadReport``, the tick launches during the load, every
    batch's ``BatchDecision`` and the seconds of the decider's warm-up
    event."""
    import asyncio
    from repro_torch.kernels import chunk_diff, mesi_transition as mt
    from repro_torch.obs import runtime
    from repro_torch.service import (CoherenceBroker, CoherenceConfig,
                                     drive_workload)
    names = tuple(f"artifact-{d}" for d in range(SERVICE["artifacts"]))
    core.setdefault("strategy", SERVICE["strategy"])
    cfg = CoherenceConfig.make(
        SERVICE["clients"], names, artifact_tokens=SERVICE["artifact_tokens"],
        chunk_tokens=chunk_tokens, backend=backend, telemetry=True,
        capture_trace=True, **core).broker_view()

    async def main() -> dict:
        async with CoherenceBroker(cfg, device=device) as broker:
            decisions = []
            decide = broker.decider.decide

            def recorded(*args, **kw):
                decisions.append(decide(*args, **kw))
                return decisions[-1]
            broker.decider.decide = recorded
            events = len(runtime.compile_events())
            before = (mt.mesi_tick_.launches, chunk_diff.chunk_tick_.launches)
            load = await drive_workload(broker, service_workload(family),
                                        SERVICE["rounds"],
                                        seed=SERVICE_SEEDS[family],
                                        lockstep=True)
            launches = (mt.mesi_tick_.launches - before[0],
                        chunk_diff.chunk_tick_.launches - before[1])
        warm = [e["dur_s"] for e in runtime.compile_events()[events:]
                if e["kind"] == "warmup"]
        return dict(broker=broker, load=load, launches=launches,
                    decisions=decisions, warmup_s=warm[0])
    return asyncio.run(main())


def same_service(a: dict, b: dict, what: str) -> None:
    """Two brokers' runs decided alike: traces step for step (agents,
    artifacts, writes, miss, served versions, measured write chunks),
    every batch's decision (with content the chunks each fill shipped),
    ledgers, wire ledgers, directory, versions and last_sync, and with
    content the chunk arrays."""
    import numpy as np
    ba, bb = a["broker"], b["broker"]
    check(ba.trace.n_steps == bb.trace.n_steps > 0
          and all((s.agents, s.arts, s.writes, s.miss, s.version, s.chunks)
                  == (r.agents, r.arts, r.writes, r.miss, r.version,
                      r.chunks)
                  for s, r in zip(ba.trace.steps, bb.trace.steps)),
          f"{what}: traces equal step for step")
    check(len(a["decisions"]) == len(b["decisions"]) and all(
        np.array_equal(x.miss, y.miss) and np.array_equal(x.version,
                                                          y.version)
        and x.ledger_delta == y.ledger_delta
        and x.wire_delta == y.wire_delta
        and (x.fetched_chunks is None) == (y.fetched_chunks is None)
        and (x.fetched_chunks is None
             or np.array_equal(x.fetched_chunks, y.fetched_chunks))
        for x, y in zip(a["decisions"], b["decisions"])),
        f"{what}: decisions equal batch by batch")
    leaves = ["last_sync"] + (["chunk_version", "chunk_sync", "chunk_dirty"]
                              if ba.chunks is not None else [])
    check(dataclasses.astuple(ba.ledger) == dataclasses.astuple(bb.ledger)
          and ba.wire == bb.wire
          and np.array_equal(ba.directory_state, bb.directory_state)
          and np.array_equal(ba.versions, bb.versions)
          and all(np.array_equal(getattr(ba.decider.arrays, x).cpu().numpy(),
                                 getattr(bb.decider.arrays, x).cpu().numpy())
                  for x in leaves),
          f"{what}: ledgers, wire, directory, versions, arrays equal")


#: host functions whose cumulative time ``service_profile`` reports
SERVICE_HOST_SPANS = ("_decide_and_resolve", "decide", "_decide_kernel",
                      "_measure_write_masks", "record_batch", "append_step",
                      "_patch_mirror", "sample_round")


def service_profile(card: str) -> None:
    """Where the time of the uniform family's kernel-route brokers goes,
    without and with 64-token chunks: the device's busy share of one run
    under the torch profiler, then, in another run under ``cProfile``,
    the host's time by function (own time, largest first, and the
    cumulative time of ``SERVICE_HOST_SPANS``)."""
    import cProfile
    import pstats
    for chunk in (0, SERVICE["chunk_tokens"]):
        wall, busy, top = device_profile(
            lambda: run_service("uniform", "kernel", chunk))
        prof = cProfile.Profile()
        prof.enable()
        t0 = time.perf_counter()
        run_service("uniform", "kernel", chunk)
        host_wall = time.perf_counter() - t0
        prof.disable()
        stats = pstats.Stats(prof).stats
        own = sorted(((tt, f"{pathlib.Path(f).name}:{line}({name})", nc)
                      for (f, line, name), (_, nc, tt, _, _)
                      in stats.items()), reverse=True)
        spans = {}
        for (f, line, name), (_, _, _, ct, _) in stats.items():
            if name in SERVICE_HOST_SPANS and "repro_torch" in f:
                spans[name] = spans.get(name, 0.0) + ct
        emit({"phase": "service", "what": "profile", "family": "uniform",
              "route": "kernel", "chunk_tokens": chunk, "wall_s": wall,
              "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
              "top_device": top[:6], "host_wall_s": host_wall,
              "host_own_s": [{"function": k, "seconds": s, "calls": c}
                             for s, k, c in own[:10]],
              "host_cumulative_s": spans, "card": card})


def phase_service(card: str) -> None:
    """The live coherence service on the card: each family of
    ``SERVICE_FAMILIES`` through brokers on both decision routes, with
    and without 64-token chunks, then eager and access_count (k = 3) on
    ``bursty`` (kernel route) and K = 3 staleness on ``uniform`` (scan
    route).  Every broker's trace is verified by the port's oracle (its
    kernel legs on the card; K-staleness is outside the oracle's scope,
    so that broker is held to its live invariant checks) and its metrics
    by the conformance replay; the routes must agree step for step; the
    kernel route must launch one MESI tick (and with content one chunk
    tick) per micro-batch and the scan route none; the uniform family's
    kernel-route broker on the CPU must decide exactly as on the card."""
    import numpy as np
    import torch
    from repro_torch.obs import check_metrics_conformance
    from repro_torch.service import verify_broker

    def verified(run: dict, label: str, family: str) -> None:
        broker = run["broker"]
        kernel = broker.decider.backend == "kernel"
        content = broker.chunks is not None
        batches = broker.n_batches
        check(run["launches"] == ((batches, batches if content else 0)
                                  if kernel else (0, 0)),
              f"{label}: {run['launches']} tick launches for {batches} "
              f"micro-batches")
        if broker.config.max_stale_steps:
            consumed = int(broker.decider.metrics.max_consumed_staleness)
            check(consumed <= broker.config.max_stale_steps,
                  f"{label}: served staleness {consumed} within K")
            legs = ("live_invariants",)
        else:
            legs = verify_broker(broker, name=label).implementations
        conformance = check_metrics_conformance(broker, name=label)
        load = run["load"]
        decide = np.array([s.decide_s for s in broker.trace.steps]) * 1e3
        emit({"phase": "service", "broker": label, "family": family,
              "route": broker.decider.backend,
              "strategy": broker.config.strategy,
              "chunk_tokens": broker.config.chunk_tokens,
              "max_stale_steps": broker.config.max_stale_steps,
              "actions": load.n_actions, "micro_batches": batches,
              "mean_batch": load.n_actions / batches,
              "throughput_dps": load.throughput_dps,
              "capacity_dps": load.capacity_dps,
              "request_p50_ms": load.latency_ms(50),
              "request_p99_ms": load.latency_ms(99),
              "decide_p50_ms": float(np.percentile(decide, 50)),
              "decide_p99_ms": float(np.percentile(decide, 99)),
              "savings_vs_broadcast": load.savings_vs_broadcast,
              "wire": dict(broker.wire) if content else None,
              "warmup_s": run["warmup_s"], "launches": run["launches"],
              "oracle": list(legs),
              "conformance_cells": conformance["label_cells_compared"],
              "card": card})

    t0 = time.perf_counter()
    brokers = 0
    cards = {}
    for family in SERVICE_FAMILIES:
        for chunk in (0, SERVICE["chunk_tokens"]):
            runs = {backend: run_service(family, backend, chunk)
                    for backend in ("kernel", "scan")}
            for backend, run in runs.items():
                check(run["broker"].decider.backend == backend,
                      f"{family}: route {backend}")
                verified(run, f"{family}:{backend}:chunks={chunk}", family)
            same_service(runs["kernel"], runs["scan"],
                         f"{family} (chunks={chunk}): kernel == scan")
            brokers += 2
            cards[(family, chunk)] = runs["kernel"]
    for label, family, backend, core in (
            ("bursty:kernel:eager", "bursty", "kernel",
             dict(strategy="eager")),
            ("bursty:kernel:access_count", "bursty", "kernel",
             dict(strategy="access_count", access_k=3)),
            ("uniform:scan:K=3", "uniform", "scan",
             dict(max_stale_steps=3))):
        verified(run_service(family, backend, **core), label, family)
        brokers += 1
    seconds = time.perf_counter() - t0
    card_run = cards[("uniform", 0)]
    cpu_run = run_service("uniform", "kernel", device="cpu")
    same_service(card_run, cpu_run, "uniform kernel route: card == CPU")
    check(card_run["load"].savings_vs_broadcast
          == cpu_run["load"].savings_vs_broadcast,
          "uniform: savings_vs_broadcast on the card == on the CPU")
    service_profile(card)
    t0 = time.perf_counter()
    planes = service_sharded(card, cards)
    sharded_seconds = time.perf_counter() - t0
    emit({"phase": "service", "brokers": brokers, "seconds": seconds,
          "routes_equal": True, "card_equals_cpu": True,
          "uniform_savings_vs_broadcast":
              card_run["load"].savings_vs_broadcast,
          "sharded_planes": planes, "sharded_seconds": sharded_seconds,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": card})


def run_plane(family: str, shards: int, chunk_tokens: int = 0,
              backend: str = "kernel", device: str = "cuda") -> dict:
    """One sharded authority plane of the service cell (``shards``
    shards behind ``SERVICE_HOSTS`` hosts' L1 directories, telemetry and
    trace capture on), built by ``service.connect`` and driven through
    its family's lockstep load on ``device``; returns the plane, the
    ``LoadReport``, the tick launches during the load and the seconds of
    each shard decider's warm-up event."""
    import asyncio
    from repro_torch.kernels import chunk_diff, mesi_transition as mt
    from repro_torch.obs import runtime
    from repro_torch.service import connect, drive_workload
    names = tuple(f"artifact-{d}" for d in range(SERVICE["artifacts"]))

    async def main() -> dict:
        plane = connect(
            n_agents=SERVICE["clients"], artifacts=names,
            artifact_tokens=SERVICE["artifact_tokens"],
            strategy=SERVICE["strategy"], chunk_tokens=chunk_tokens,
            backend=backend, shards=shards, hosts=SERVICE_HOSTS,
            device=device)
        events = len(runtime.compile_events())
        async with plane:
            before = (mt.mesi_tick_.launches, chunk_diff.chunk_tick_.launches)
            load = await drive_workload(plane, service_workload(family),
                                        SERVICE["rounds"],
                                        seed=SERVICE_SEEDS[family],
                                        lockstep=True)
            launches = (mt.mesi_tick_.launches - before[0],
                        chunk_diff.chunk_tick_.launches - before[1])
        warm = [e["dur_s"] for e in runtime.compile_events()[events:]
                if e["kind"] == "warmup"]
        return dict(plane=plane, load=load, launches=launches,
                    warmup_s=warm)
    return asyncio.run(main())


def same_plane(a: dict, b: dict, what: str) -> None:
    """Two planes decided alike: traces step for step (the committing
    shard and the measured write chunks included), ledgers, wire and L1
    ledgers, the assembled directory, versions and last_sync."""
    import numpy as np
    pa, pb = a["plane"], b["plane"]
    check(pa.trace.n_steps == pb.trace.n_steps > 0
          and all((s.agents, s.arts, s.writes, s.miss, s.version, s.chunks,
                   s.shard)
                  == (r.agents, r.arts, r.writes, r.miss, r.version,
                      r.chunks, r.shard)
                  for s, r in zip(pa.trace.steps, pb.trace.steps)),
          f"{what}: traces equal step for step")
    check(dataclasses.astuple(pa.ledger) == dataclasses.astuple(pb.ledger)
          and pa.wire == pb.wire and pa.l1_wire == pb.l1_wire
          and all(np.array_equal(getattr(pa, v), getattr(pb, v))
                  for v in ("directory_state", "versions", "last_sync")),
          f"{what}: ledgers, wire, L1, directory, versions, last_sync "
          f"equal")


def plane_row(card: str, run: dict, label: str, family: str) -> dict:
    """The JSON row of one plane: decisions per second, capacity (over
    the slowest shard's time in ``decide``), request latency, each
    shard's ``decide`` p50 / p99 and micro-batches, the L1 fill split
    and the deciders' warm-up."""
    import numpy as np
    plane, load = run["plane"], run["load"]
    shards = []
    for k, sub in enumerate(plane.brokers):
        decide = np.array([s.decide_s for s in plane.trace.steps
                           if s.shard == k]) * 1e3
        shards.append({
            "artifacts": len(sub.names), "micro_batches": sub.n_batches,
            "decide_p50_ms": (float(np.percentile(decide, 50))
                              if decide.size else None),
            "decide_p99_ms": (float(np.percentile(decide, 99))
                              if decide.size else None)})
    l1 = plane.stats()["l1"]
    return {"phase": "service", "plane": label, "family": family,
            "shards": plane.n_shards, "hosts": SERVICE_HOSTS,
            "route": plane.brokers[0].decider.backend,
            "chunk_tokens": plane.config.core.chunk_tokens,
            "actions": load.n_actions, "micro_batches": plane.n_batches,
            "throughput_dps": load.throughput_dps,
            "capacity_dps": load.capacity_dps,
            "request_p50_ms": load.latency_ms(50),
            "request_p99_ms": load.latency_ms(99),
            "per_shard": shards, "l1_fill_rate": l1["l1_fill_rate"],
            "l1_fills": l1["l1_fills"], "l2_fills": l1["l2_fills"],
            "wire": dict(plane.wire) if plane.chunked else None,
            "warmup_s": run["warmup_s"], "launches": run["launches"],
            "card": card}


def plane_streams(card: str) -> dict:
    """One K = 4 ``uniform`` plane (no content: no chunk tick) on the
    card under the torch profiler, between two chunk tick launches queued
    on the default stream as markers: the streams its MESI tick kernels
    ran on, read from the exported trace, must be 4, none the markers'.
    Returns the tick launches by stream."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import chunk_diff
    marker = [torch.zeros(shape, dtype=torch.int32, device="cuda")
              for shape in ((1, 1, 4), (1, 1, 1, 4), (1, 1, 4), (1, 1),
                            (1, 1), (1, 1), (1, 1, 4))]

    def mark():
        chunk_diff.chunk_tick_(*marker, artifact_tokens=256,
                               chunk_tokens=64)
        chunk_diff.chunk_tick_.launches -= 1   # not a main-path launch

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mark()
        run = run_plane("uniform", SERVICE_SHARDS[-1])
        mark()
        torch.cuda.synchronize()
    path = REPO / "build" / "service_plane_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    kernels = [e for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]

    def streams(pattern):     # (device, stream): the shards take cards
        return collections.Counter(
            (e["args"].get("device"), e["args"]["stream"]) for e in kernels
            if re.search(pattern, e["name"]))
    default = streams(r"chunk_(staged|direct)_kernel")
    ticks = streams(r"mesi_(staged|direct)_kernel")
    check(len(default) == 1 and run["launches"][1] == 0,
          f"the marker chunk ticks on one default stream: {dict(default)}")
    check(len(ticks) == SERVICE_SHARDS[-1] and not set(ticks) & set(default),
          f"tick kernels on {len(ticks)} streams {dict(ticks)}, default "
          f"{dict(default)}: one non-default stream a shard")
    check(sum(ticks.values()) == run["launches"][0]
          == run["plane"].n_batches,
          f"the trace holds every tick launch: {dict(ticks)} vs "
          f"{run['launches']}")
    by_stream = {f"{d}:{k}": v for (d, k), v in sorted(ticks.items())}
    emit({"phase": "service", "what": "streams",
          "default_stream": [f"{d}:{k}" for d, k in sorted(default)],
          "tick_launches_by_stream":
          by_stream, "card": card})
    return by_stream


def service_tcp(card: str) -> None:
    """The JSON-lines TCP frontend (``launch.service.serve_tcp`` on
    127.0.0.1, port 0) over a K = 4, hosts 4 plane on the card: a
    scripted session of ``TCP_REQUESTS`` reads and writes (some with new
    content) over one socket, then ``stats`` and ``metrics``.  The
    replies must equal the same script awaited in process on another
    plane; the ``stats`` sections equal that plane's; the ``metrics``
    counters the registry's.  Prints the round trips' p50 / p99."""
    import asyncio
    import numpy as np
    from repro_torch.launch.service import artifact_names, serve_tcp
    from repro_torch.service import connect
    rng = np.random.default_rng(SEED)
    names = artifact_names(SERVICE["artifacts"])
    script = []
    for _ in range(TCP_REQUESTS):
        req = {"op": "write" if rng.random() < 0.3 else "read",
               "agent": int(rng.integers(SERVICE["clients"])),
               "artifact": names[int(rng.integers(len(names)))]}
        if req["op"] == "write" and rng.random() < 0.5:
            req["content"] = rng.integers(
                0, 50_000, SERVICE["artifact_tokens"]).tolist()
        script.append(req)

    def plane():
        return connect(n_agents=SERVICE["clients"], artifacts=names,
                       artifact_tokens=SERVICE["artifact_tokens"],
                       strategy=SERVICE["strategy"], backend="kernel",
                       shards=SERVICE_SHARDS[-1], hosts=SERVICE_HOSTS)

    async def rpc(reader, writer, req):
        writer.write(json.dumps(req).encode() + b"\n")
        await writer.drain()
        return json.loads(await reader.readline())

    async def over_tcp():
        async with plane() as broker:
            server = await serve_tcp(broker, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", port, limit=1 << 20)
            replies, rtt = [], []
            for req in script:
                t0 = time.perf_counter()
                replies.append(await rpc(reader, writer, req))
                rtt.append(time.perf_counter() - t0)
            stats = await rpc(reader, writer, {"op": "stats"})
            metrics = await rpc(reader, writer, {"op": "metrics"})
            writer.close()
            server.close()
            await server.wait_closed()
            return replies, rtt, stats, metrics, broker

    async def in_process():
        async with plane() as broker:
            replies, lat = [], []
            for req in script:
                t0 = time.perf_counter()
                if req["op"] == "read":
                    r = await broker.read(req["agent"], req["artifact"])
                    replies.append({"ok": True, "version": r.version,
                                    "hit": r.hit,
                                    "content": list(r.content)})
                else:
                    w = await broker.write(req["agent"], req["artifact"],
                                           req.get("content"))
                    replies.append({"ok": True, "version": w.version})
                lat.append(time.perf_counter() - t0)
            return replies, lat, broker

    replies, rtt, stats, metrics, tcp_plane = asyncio.run(over_tcp())
    want, lat, local_plane = asyncio.run(in_process())
    check(replies == json.loads(json.dumps(want)),
          "TCP replies equal the in-process replies")
    local = json.loads(json.dumps(local_plane.stats(), default=float))
    check(stats["ok"] and all(stats["stats"][k] == local[k]
                              for k in ("ledger", "topology", "l1")),
          "TCP stats equal the in-process plane's")
    reg = tcp_plane.telemetry.registry
    counters = metrics["snapshot"]["counters"]
    check(metrics["ok"] and "coh_fetch_tokens_total" in metrics["prometheus"]
          and counters and all(
              {tuple(sorted(v["labels"].items())): v["value"]
               for v in c["values"]}
              == {tuple(sorted(k)): v
                  for k, v in reg.counter_cells(name).items()}
              for name, c in counters.items()),
          "TCP metrics counters equal the registry's, cell by cell")
    ms = np.array(rtt) * 1e3
    local_ms = np.array(lat) * 1e3
    emit({"phase": "service", "what": "tcp", "requests": len(script),
          "writes": sum(r["op"] == "write" for r in script),
          "round_trip_p50_ms": float(np.percentile(ms, 50)),
          "round_trip_p99_ms": float(np.percentile(ms, 99)),
          "in_process_p50_ms": float(np.percentile(local_ms, 50)),
          "in_process_p99_ms": float(np.percentile(local_ms, 99)),
          "counters_compared": len(counters), "card": card})


def service_cli(card: str) -> None:
    """``python -m repro_torch.launch.service`` on the card, in process:
    the service grid at K = 4, hosts 4, with ``--verify`` and
    ``--verify-metrics``; its printed summary is checked and emitted on
    one line."""
    import contextlib
    import io
    from repro_torch.launch import service as launch
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = launch.main([
            "--clients", str(SERVICE["clients"]),
            "--artifacts", str(SERVICE["artifacts"]),
            "--artifact-tokens", str(SERVICE["artifact_tokens"]),
            "--rounds", str(SERVICE["rounds"]), "--backend", "kernel",
            "--shards", str(SERVICE_SHARDS[-1]),
            "--hosts", str(SERVICE_HOSTS), "--verify", "--verify-metrics"])
    check(json.loads(out.getvalue()) == json.loads(json.dumps(
        summary, default=float)) and summary["oracle"]["bit_exact"]
        and summary["metrics_conformance"]["bit_exact"]
        and summary["backend"] == "kernel"
        and summary["shards"] == SERVICE_SHARDS[-1],
        "the service CLI verified its K = 4 run")
    emit({"phase": "service", "what": "cli", "summary": summary,
          "card": card})


def service_sharded(card: str, plain: dict) -> int:
    """The sharded authority plane on the card, every plane built by
    ``service.connect`` on the kernel route, each shard on its own CUDA
    stream: the uniform capacity sweep over ``SERVICE_SHARDS``, then
    every family at K = 4 without and with 64-token chunks, its token
    ledger (with content its wire ledger) equal to the plain broker's of
    ``plain`` (the kernel-route runs of ``phase_service``), verified by
    the port's oracle (``verify_broker`` dispatches to
    ``verify_sharded_broker``, its kernel legs on the card) and by the
    metrics conformance replay, one tick launch (with content one chunk
    tick) per shard micro-batch; the scan route once; the tick kernels'
    streams; card == CPU; the TCP frontend and the CLI.  Returns the
    planes driven."""
    from repro_torch.obs import check_metrics_conformance
    from repro_torch.service import verify_broker

    def checked(run: dict, label: str, family: str, verify: bool) -> None:
        plane = run["plane"]
        content = plane.chunked
        base = plain[(family, plane.config.core.chunk_tokens)]["broker"]
        batches = plane.n_batches
        check(batches == sum(b.n_batches for b in plane.brokers)
              and run["launches"] == (batches, batches if content else 0),
              f"{label}: {run['launches']} tick launches for {batches} "
              f"shard micro-batches")
        check(dataclasses.astuple(plane.ledger)
              == dataclasses.astuple(base.ledger)
              and (not content or plane.wire == base.wire),
              f"{label}: ledgers equal the plain broker's")
        row = plane_row(card, run, label, family)
        if verify:
            t0 = time.perf_counter()
            row["oracle"] = list(verify_broker(
                plane, name=label).implementations)
            t1 = time.perf_counter()
            row["conformance_cells"] = check_metrics_conformance(
                plane, name=label)["label_cells_compared"]
            row["verify_s"] = t1 - t0
            row["conformance_s"] = time.perf_counter() - t1
        emit(row)

    planes = 0
    runs = {}
    seconds = {}
    t0 = time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t0
        seconds[part] = time.perf_counter() - t0
        t0 = time.perf_counter()

    for shards in SERVICE_SHARDS:
        runs[shards] = run_plane("uniform", shards)
        checked(runs[shards], f"uniform:K={shards}", "uniform",
                verify=shards == SERVICE_SHARDS[-1])
        planes += 1
    lap("capacity_sweep")
    k = SERVICE_SHARDS[-1]
    for family in SERVICE_FAMILIES:
        for chunk in (0, SERVICE["chunk_tokens"]):
            if (family, chunk) == ("uniform", 0):
                continue                  # the sweep's last plane
            checked(run_plane(family, k, chunk),
                    f"{family}:K={k}:chunks={chunk}", family, verify=True)
            planes += 1
    lap("families")
    scan = run_plane("uniform", k, backend="scan")
    check(scan["plane"].brokers[0].decider.backend == "scan"
          and scan["launches"] == (0, 0), "the scan plane launched nothing")
    same_plane(runs[k], scan, f"uniform K={k}: kernel route == scan route")
    lap("scan")
    cpu = run_plane("uniform", k, device="cpu")
    same_plane(runs[k], cpu, f"uniform K={k}: card == CPU")
    lap("cpu")
    plane_streams(card)
    lap("streams")
    service_tcp(card)
    lap("tcp")
    service_cli(card)
    lap("cli")
    emit({"phase": "service", "what": "sharded_seconds", "seconds": seconds,
          "card": card})
    return planes + 5


def device_profile(fn):
    """Run ``fn()`` under the torch profiler; returns the wall seconds,
    the device's busy seconds (the union of the kernels' spans) and
    every ``{name, device_ms, calls}`` row by device time, largest
    first (names cut to 60 characters)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # Device kernels and copies only: the profiler mirrors each CPU
    # operator onto the device timeline as a user annotation spanning
    # its kernels, and counting those too would count that time twice.
    def on_device(ev):
        return (ev.device_type == DeviceType.CUDA
                and not ev.is_user_annotation)

    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if on_device(ev))
    check(bool(spans), "the profiler saw device kernels")
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:          # the union of the kernels' spans
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if on_device(ev) and ev.self_device_time_total > 0),
                  reverse=True)
    return wall, busy_us / 1e6, [
        {"name": k[:60], "device_ms": us / 1e3, "calls": c}
        for us, k, c in rows]


def phase_profile(card: str, fleet_seconds: float) -> None:
    """Where the time goes in the content-plane fleet run: device time
    by kernel name over one repeat of it, and the device's busy share
    of the wall time, both of the profiled repeat and of the unprofiled
    run that took ``fleet_seconds``."""
    from repro_torch.sim import compare_workloads, zoo

    workloads = zoo(n_agents=16, n_artifacts=16, n_runs=FLEET_RUNS,
                    chunk_tokens=64)
    wall, busy, top = device_profile(lambda: compare_workloads(workloads))
    emit({"phase": "profile", "what": "fleet", "wall_s": wall,
          "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
          "unprofiled_wall_s": fleet_seconds,
          "unprofiled_device_idle_share": 1.0 - busy / fleet_seconds,
          "top": top[:10], "card": card})


def serve_profile(card: str, system, params, steps: int = 8,
                  context=None) -> None:
    """Where the time goes in the batched request: its prefill (with the
    cell's ``context``), then ``steps`` greedy decode steps, each under
    the profiler.  The prefill's line carries flash attention's share of
    the device's busy time."""
    import torch
    from repro_torch import models

    cfg, n = system.cfg, len(system.agents)
    contexts = [system.context_tokens(i) for i in range(n)]
    p = min(len(c) for c in contexts)
    tokens = torch.tensor([c[:p] for c in contexts], dtype=torch.int64,
                          device="cuda")
    cache = models.init_cache(cfg, n, p + steps, ctx_len=0 if context is None
                              else context.shape[1])

    def prefill():
        nonlocal logits, cache
        logits, cache = models.prefill(params, cfg, tokens, cache,
                                       context=context)

    logits = None
    wall, busy, top = device_profile(prefill)
    flash_ms = sum(row["device_ms"] for row in top
                   if re.search(r"\bflash_(wgmma|fp32)\b", row["name"]))
    emit({"phase": "profile", "what": "prefill", "arch": cfg.name,
          "batch": n, "prompt_len": p, "wall_s": wall,
          "tokens_per_s": n * p / wall, "device_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall,
          "flash_attention_ms": flash_ms,
          "flash_attention_share": flash_ms / (busy * 1e3),
          "top": top[:10], "card": card})

    def decode():
        nonlocal logits, cache
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = models.decode_step(params, cfg, tok, cache)

    wall, busy, top = device_profile(decode)
    emit({"phase": "profile", "what": "decode", "arch": cfg.name,
          "steps": steps,
          "batch": n, "wall_s": wall, "ms_per_step": wall / steps * 1e3,
          "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
          "top": top[:10], "card": card})


class head_split_off:
    """Inside ``with head_split_off():`` the bf16 attention backward is
    planned as on a card of one SM, so its dK/dV pass runs unsplit (S_h =
    1): the yardstick of what the head split buys."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        self.saved = fa._sm_count
        fa._sm_count = lambda index: 1
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        fa._sm_count = self.saved


@functools.lru_cache(maxsize=None)
def plain_wkv():
    """The WKV scan's plain version as an autograd function whose backward
    is the plain reverse recurrence (``ref.rwkv6_scan_bwd_plain``, held to
    autograd of the plain scan by the CPU tests): ``plain_route``'s, since
    autograd of the step-by-step loop would walk tens of thousands of
    graph nodes a layer on the host."""
    import torch
    from repro_torch.kernels import ref

    class PlainWKV(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, w, bonus, initial_state):
            ctx.save_for_backward(r, k, v, w, bonus, initial_state)
            ctx.set_materialize_grads(False)
            return ref.rwkv6_scan_plain(r, k, v, w, bonus, initial_state)

        @staticmethod
        def backward(ctx, dy, dstate):
            r, k, v, w, bonus, s0 = ctx.saved_tensors
            dy = torch.zeros_like(r) if dy is None else dy
            dr, dk, dv, dw, du, ds0 = ref.rwkv6_scan_bwd_plain(
                r, k, v, w, bonus, s0, dy, dstate)
            return (dr, dk, dv, dw, du.to(bonus.dtype),
                    None if s0 is None else ds0)

    return PlainWKV


@functools.lru_cache(maxsize=None)
def plain_ssm():
    """The selective scan's plain version as an autograd function whose
    backward is the plain reverse recurrence
    (``ref.selective_scan_bwd_plain``, held to autograd of the plain scan
    by the CPU tests): ``plain_route``'s, as ``plain_wkv``."""
    import torch
    from repro_torch.kernels import ref

    class PlainSSM(torch.autograd.Function):
        @staticmethod
        def forward(ctx, dt, a, b, c, x, d_skip, initial_state):
            ctx.save_for_backward(dt, a, b, c, x, d_skip, initial_state)
            ctx.set_materialize_grads(False)
            return ref.selective_scan_plain(dt, a, b, c, x, d_skip,
                                            initial_state)

        @staticmethod
        def backward(ctx, dy, dstate):
            dt, a, b, c, x, d_skip, s0 = ctx.saved_tensors
            dy = torch.zeros_like(dt) if dy is None else dy
            ddt, da, db, dc, dx, dds, ds0 = ref.selective_scan_bwd_plain(
                dt, a, b, c, x, d_skip, s0, dy, dstate)
            return ddt, da, db, dc, dx, dds, None if s0 is None else ds0

    return PlainSSM


#: logits of one piece of ``plain_attention`` at most (4 GB in fp32)
PLAIN_ATTENTION_PIECE = 2 ** 30


def plain_attention(q, k, v, causal=True, scale=None, q_offset=None,
                    kv_len=None):
    """``ref.attention_plain`` in pieces of batch rows and KV heads (each
    with its query heads, and its row's ``q_offset`` and ``kv_len``), each
    piece at most ``PLAIN_ATTENTION_PIECE`` logits: every row is computed
    as the whole call computes it, without the whole call's
    (B, Hq, Lq, Lk) fp32 logits (38.7 GB at the vlm's self-attention)."""
    import torch
    from repro_torch.kernels import ref
    b, hq, lq, _ = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    if b * hq * lq * lk <= PLAIN_ATTENTION_PIECE:
        return ref.attention_plain(q, k, v, causal, scale, q_offset, kv_len)
    heads = max(1, min(hkv, PLAIN_ATTENTION_PIECE // (group * lq * lk)))
    rows = []
    for i in range(b):
        off, lens = (None if t is None else t[i:i + 1]
                     for t in (q_offset, kv_len))
        rows.append(torch.cat([ref.attention_plain(
            q[i:i + 1, h * group:(h + heads) * group], k[i:i + 1, h:h + heads],
            v[i:i + 1, h:h + heads], causal, scale, off, lens)
            for h in range(0, hkv, heads)], dim=1))
    return torch.cat(rows, dim=0)


class plain_route:
    """Inside ``with plain_route():`` the model kernels' public entry
    points (``repro_torch.kernels.ops``, and the RMSNorm wrapper that the
    models' ``norm_apply`` calls in its cast-first order) run their plain
    versions, on CUDA tensors too - the reference the serve and train
    phases hold the kernel route to (the WKV scan's and the selective
    scan's backward their plain reverse recurrences, ``plain_wkv`` and
    ``plain_ssm``; the causal conv's autograd of its plain version).  The
    port itself has no such switch."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels import rmsnorm as norm
        self.saved = (ops.rmsnorm, ops.flash_attention, ops.decode_attention,
                      ops.rwkv6_scan, ops.causal_conv1d, ops.selective_scan,
                      ops.selective_scan_gated, norm.rmsnorm)
        ops.rmsnorm = lambda x, w, eps=1e-6, block_rows=128: \
            ref.rmsnorm_plain(x, w, eps)
        norm.rmsnorm = lambda x, w, eps=1e-6, cast_first=False: (
            ref.rmsnorm_cast_first_plain if cast_first
            else ref.rmsnorm_plain)(x, w, eps)
        ops.flash_attention = lambda q, k, v, causal=True, scale=None, \
            block_q=128, block_k=128, q_offset=None, kv_len=None: \
            plain_attention(q, k, v, causal, scale, q_offset, kv_len)
        ops.decode_attention = lambda q, kc, vc, kv_len=None, scale=None, \
            block_k=256: ref.decode_attention_plain(q, kc, vc, kv_len, scale)
        ops.rwkv6_scan = lambda r, k, v, w, bonus, initial_state=None, \
            chunk=64: plain_wkv().apply(r, k, v, w, bonus, initial_state)
        ops.causal_conv1d = ref.causal_conv1d_plain
        ops.selective_scan = lambda dt, a, b, c, x, d_skip, \
            initial_state=None: plain_ssm().apply(dt, a, b, c, x, d_skip,
                                                  initial_state)
        ops.selective_scan_gated = ref.selective_scan_gated_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.kernels import rmsnorm as norm
        (ops.rmsnorm, ops.flash_attention, ops.decode_attention,
         ops.rwkv6_scan, ops.causal_conv1d, ops.selective_scan,
         ops.selective_scan_gated, norm.rmsnorm) = self.saved
        return False


def model_kernels():
    """The wrappers of the serving paths' kernels, by kernel name."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.causal_conv1d import causal_conv1d
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.selective_scan import selective_scan
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention, "rwkv6_scan": rwkv6_scan,
            "causal_conv1d": causal_conv1d,
            "selective_scan": selective_scan}


def expected_launches(cfg, prefills: int, steps: int) -> dict:
    """Launches of each model kernel over ``prefills`` prefills (each with
    a context where the model has cross layers) and ``steps`` decode
    steps: per forward one rmsnorm per norm of an rmsnorm model (norm1
    and norm2 of each layer, a cross sublayer's norm, rwkv's ln_x, MLA's
    kv_norm of the latent, the final norm; a prefill's encoder adds two a
    layer and its final norm; a layernorm model launches none) and one
    attention kernel per attention (self, MLA, cross mixer, cross
    sublayer) - flash attention per prefill, the encoder's layers too,
    and decode attention per step - or the WKV scan, or Mamba's causal
    conv and selective scan, in both."""
    from repro_torch.models.transformer import layer_specs
    specs = layer_specs(cfg)
    mixers = [spec.mixer for spec in specs]
    forwards = prefills + steps
    n_rwkv, n_mla = mixers.count("rwkv"), mixers.count("mla")
    n_attn = mixers.count("attn") + n_mla + mixers.count("cross") + sum(
        spec.cross for spec in specs)
    enc = cfg.encoder_layers
    norms = (2 * cfg.n_layers + sum(spec.cross for spec in specs) + n_rwkv
             + n_mla + 1) * forwards + (2 * enc + 1) * prefills * bool(enc)
    return {"rmsnorm": norms if cfg.norm == "rmsnorm" else 0,
            "flash_attention": (n_attn + enc) * prefills,
            "decode_attention": n_attn * steps,
            "rwkv6_scan": n_rwkv * forwards,
            "causal_conv1d": mixers.count("mamba") * forwards,
            "selective_scan": mixers.count("mamba") * forwards}


def analytic_line(card: str, phase: str, cfg, what: str, kind: str,
                  batch: int, seq_len: int, measured_s: float) -> None:
    """Prints (does not gate) the port's cost model for a cell at one
    card: ``analytic_cost(cfg, shape, n_chips=1, tp=1)`` (GFLOPs, HBM
    bytes, the dominant term), the roofline bound of ``build_report`` on
    this card, the measured time's share of it, and ``model_flops_for``'s
    share of the card's bf16 peak.  ``seq_len`` is the reference's
    nominal length (whisper's decoder takes a quarter of it)."""
    from repro_torch.configs import ShapeConfig, n_active_params
    from repro_torch.launch.analytic import analytic_cost
    from repro_torch.launch.roofline import build_report, model_flops_for
    shape = ShapeConfig(f"{phase} {what}", seq_len, batch, kind)
    cost = analytic_cost(cfg, shape, n_chips=1, tp=1)
    model = model_flops_for(cfg, shape, n_active_params(cfg))
    rep = build_report(arch=cfg.name, shape=shape.name, mesh_name="1xH100",
                       n_chips=1, analytic=cost, model_flops=model,
                       card=card)
    emit({"phase": phase, "what": f"analytic {what}", "arch": cfg.name,
          "n_layers": cfg.n_layers, "kind": kind, "batch": batch,
          "seq_len": seq_len, "analytic_gflops": rep.analytic_gflops,
          "hbm_gbytes": rep.analytic_hbm_gbytes_dev,
          "flops_by_part": cost.flops_by_part,
          "bytes_by_part": cost.bytes_by_part, "dominant": rep.dominant,
          "compute_ms": rep.compute_s * 1e3, "memory_ms": rep.memory_s * 1e3,
          "bound_ms": rep.bound_time_s * 1e3, "measured_ms": measured_s * 1e3,
          "bound_share": rep.bound_time_s / measured_s,
          "model_gflops": rep.model_gflops,
          "model_flops_share": model / measured_s / bf16_rate(card),
          "card": card})


def copy_row(dst: dict, src: dict, b: int, stacked: bool = False) -> None:
    """Row 0 of a one-row cache ``src`` into row ``b`` of ``dst`` (the
    stacked superblocks' leaves carry the layer axis first)."""
    for key, leaf in src.items():
        if isinstance(leaf, dict):
            copy_row(dst[key], leaf, b, stacked or key == "blocks")
        elif stacked:
            dst[key][:, b] = leaf[:, 0]
        else:
            dst[key][b] = leaf[0]


def continued_prefill(params, cfg, tokens, cache, offsets):
    """One batched cached prefill of ``tokens`` (B, s) at per-row
    ``offsets`` (B,) int32 through ``_run_layers``, positions ``offsets +
    arange(s)``: the last position's logits (B, V), the cache updated in
    place."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import norm_apply
    x = tf._embed_tokens(params, cfg, tokens)
    positions = offsets[:, None] + torch.arange(tokens.shape[1],
                                                device=tokens.device)
    x, cache, _ = tf._run_layers(params, cfg, x, positions=positions,
                                 cache=cache, cache_len=offsets)
    x = norm_apply(params["final_norm"], x[:, -1:].contiguous(), cfg.norm)
    return tf._logits(params, cfg, x)[:, 0], cache


#: the cache leaves of attention layers (GQA head-major K / V, MLA's
#: latent and rope key), time on the second axis from the end
ATTENTION_LEAVES = ("k", "v", "ckv", "kpe")


def attention_cache_rel(got: dict, want: dict, b: int, rows: int,
                        stacked: bool = False, path: str = "") -> dict:
    """Per attention layer and leaf, the relative L2 distance of row
    ``b``'s cache positions [0, rows) in ``got`` from row 0's in the
    one-row cache ``want``."""
    import torch
    out = {}
    for key, leaf in got.items():
        name = f"{path}/{key}"
        if isinstance(leaf, dict):
            out.update(attention_cache_rel(leaf, want[key], b, rows,
                                           stacked or key == "blocks", name))
        elif key in ATTENTION_LEAVES:
            pairs = ([(leaf[i, b], want[key][i, 0])
                      for i in range(leaf.shape[0])] if stacked
                     else [(leaf[b], want[key][0])])
            for i, (g, w) in enumerate(pairs):
                g, w = (t[..., :rows, :].float() for t in (g, w))
                out[f"{name}[{i}]" if stacked else name] = float(
                    torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w))
    return out


def offset_cache(params, cfg, tokens, offsets, lmax: int) -> dict:
    """A batch cache of ``lmax`` whose row b holds a one-row prefill of
    ``tokens[b, :offsets[b]]`` (each row's Mamba and RWKV states are the
    states after exactly its own tokens)."""
    from repro_torch import models
    cache = models.init_cache(cfg, len(offsets), lmax)
    for b, o in enumerate(offsets):
        one = models.init_cache(cfg, 1, lmax)
        models.prefill(params, cfg, tokens[b:b + 1, :o], one)
        copy_row(cache, one, b)
    return cache


def load_over_capacity(routes, m) -> float:
    """The largest share of its capacity that any expert's load takes in
    the recorded MoE routings (each (tokens, k), one dispatch slice):
    above 1, pairs past the capacity were dropped."""
    import torch
    worst = 0.0
    for idx in routes:
        cap = max(int(m.capacity_factor * m.top_k * idx.shape[0]
                      / m.n_experts), m.top_k)
        counts = torch.bincount(idx.reshape(-1), minlength=m.n_experts)
        worst = max(worst, int(counts.max()) / cap)
    return worst


def continue_prefill_check(card: str, system, params, serve,
                           phase: str) -> None:
    """The serve phase's continued prefill (``CONTINUE_OFFSETS``): each
    row's cache filled by a one-row prefill of its request's first o_b
    tokens and copied into row b of a batch cache of P + 32, then one
    batched cached prefill of the next ``CONTINUE_TOKENS`` at
    ``cache_len = o``.  Gates: exactly one flash_attention launch per
    attention layer; each row's last-position logits within the cell's
    prefill limit (``LOGITS_REL_L2``) of the same continued prefill on
    the plain route (from the same cache, on the kernel route's expert
    choices, as the phase's other checks run it) and of a one-row
    one-shot prefill of its o_b + s tokens on the kernel route; every
    attention cache row in [0, o_b + s) within ``CONTINUE_CACHE_REL_L2``
    of the one-shot prefill's, layer by layer.  An MoE cell is compared
    with its one-shot prefill at ``CONTINUE_DROP_FREE`` (no pair dropped
    in any routing of either, checked on the routes dispatched), as the
    two are different functions at its capacity factor, and the one-shot
    prefill takes the continued run's expert choices (``moe_routes``:
    the tokens whose top-k set it would choose otherwise, near-ties
    between two batch shapes, are counted apart).  Prints the readings
    and the continued prefill's tokens/s."""
    import torch
    from repro_torch import models
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.common import tree_map

    cfg = system.cfg
    offsets = CONTINUE_OFFSETS[serve["arch"]]
    s, n = CONTINUE_TOKENS, len(offsets)
    contexts = [system.context_tokens(i) for i in range(n)]
    P = min(len(c) for c in contexts)
    lmax = P + serve["decode_steps"]
    check(max(offsets) + s <= P, f"{cfg.name}: the continued prefill's "
          f"tokens lie inside the request ({max(offsets)} + {s} <= {P})")
    tokens = torch.tensor([c[:P] for c in contexts], dtype=torch.int64,
                          device="cuda")
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    nxt = torch.stack([tokens[b, o:o + s] for b, o in enumerate(offsets)])
    n_attn = sum(spec.mixer in ("attn", "mla")
                 for spec in models.layer_specs(cfg))
    cache = offset_cache(params, cfg, tokens, offsets, lmax)
    start = tree_map(torch.clone, cache)
    before = flash_attention.launches
    with moe_routes() as kernel_routes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = continued_prefill(params, cfg, nxt, cache, off)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launched = flash_attention.launches - before
    with plain_route(), moe_routes(kernel_routes.routes):
        plain, _ = continued_prefill(params, cfg, nxt, start, off)
    del start

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).float())
                     / torch.linalg.vector_norm(b.float()))

    route_rel = [rel(logits[b], plain[b]) for b in range(n)]
    del plain
    # the one-shot comparison, an MoE cell at its drop-free factor
    free, loads = cfg, {}
    if cfg.moe is not None:
        loads["cell"] = load_over_capacity(kernel_routes.routes, cfg.moe)
        free = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CONTINUE_DROP_FREE[serve["arch"]]))
        del cache
        torch.cuda.empty_cache()
    with moe_routes() as free_routes:
        if free is not cfg:
            cache = offset_cache(params, free, tokens, offsets, lmax)
            logits, cache = continued_prefill(params, free, nxt, cache, off)
    # the routings recorded: each row's prefill, layer by layer, then the
    # continued prefill's (n * s tokens, row-major); row b's one-shot
    # prefill takes the concatenation of its rows' choices
    n_moe = sum(spec.moe for spec in models.layer_specs(cfg))
    routes = free_routes.routes
    dispatched, shot_rel, cache_rel, flips = list(routes), [], {}, []
    for b, o in enumerate(offsets):
        forced = [torch.cat([routes[b * n_moe + i],
                             routes[n * n_moe + i][b * s:(b + 1) * s]])
                  for i in range(n_moe)]
        dispatched += forced
        one = models.init_cache(cfg, 1, lmax)
        with moe_routes(forced) as own:
            shot, one = models.prefill(params, free,
                                       tokens[b:b + 1, :o + s], one)
        flips.append(sum(flipped_tokens(a, c)
                         for a, c in zip(own.routes, forced)))
        shot_rel.append(rel(logits[b], shot[0, -1]))
        for name, r in attention_cache_rel(cache, one, b, o + s).items():
            cache_rel[name] = max(cache_rel.get(name, 0.0), r)
        del one
    if free is not cfg:
        loads["drop_free"] = load_over_capacity(dispatched, free.moe)
    limit = LOGITS_REL_L2[serve["arch"]][0]
    emit({"phase": phase, "what": "continued prefill", "arch": cfg.name,
          "offsets": list(offsets), "tokens": s, "cache_len": lmax,
          "seconds": secs, "tokens_per_s": n * s / secs,
          "flash_attention_launches": launched, "attention_layers": n_attn,
          "plain_route_rel_l2": route_rel, "one_shot_rel_l2": shot_rel,
          "one_shot_capacity_factor": (free.moe.capacity_factor
                                       if free.moe else None),
          "moe_load_over_capacity": loads or None,
          "one_shot_flipped_tokens": flips if n_moe else None,
          "limit": limit,
          "cache_rel_l2_by_layer": cache_rel,
          "cache_rel_l2_max": max(cache_rel.values()), "card": card})
    check(launched == n_attn,
          f"{cfg.name} continued prefill: {launched} flash_attention "
          f"launches == {n_attn}, one per attention layer")
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: finite continued-prefill logits")
    check(max(route_rel) <= limit,
          f"{cfg.name} continued prefill, kernel vs plain route: relative "
          f"L2 {route_rel} <= {limit}")
    check(loads.get("drop_free", 0.0) <= 1.0,
          f"{cfg.name}: no MoE pair dropped at the one-shot comparison's "
          f"capacity factor ({loads})")
    check(max(shot_rel) <= limit,
          f"{cfg.name} continued prefill vs one-shot prefill: relative L2 "
          f"{shot_rel} <= {limit}")
    check(max(cache_rel.values()) <= CONTINUE_CACHE_REL_L2,
          f"{cfg.name} continued prefill's attention caches vs the one-shot "
          f"prefill's: {max(cache_rel.values())} <= {CONTINUE_CACHE_REL_L2}")


def phase_serve(card: str, serve=SERVE) -> dict:
    """Coherent serving of ``serve``'s workload at its model's registered
    width, with the model kernels' launch counts set to 0 before it;
    returns the counts of the kernels it launched."""
    import torch
    from repro_torch import models
    from repro_torch.configs.registry import _ctx_len
    from repro_torch.launch.serve import batched_request

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    (system, stats), _ = sync_time(lambda: serving_system(serve))
    cfg = system.cfg
    phase = SERVE_PHASES[serve["arch"]]
    params, init_s = sync_time(lambda: models.init_params(cfg, seed=SEED))
    awake = awake_params(params, cfg) if needs_awake(cfg) else None
    n_params = models.params_count(params)
    n = len(system.agents)
    contexts = [len(system.context_tokens(i)) for i in range(n)]
    ctx_len = _ctx_len(cfg, serve["artifacts"] * serve["artifact_tokens"])
    context = cell_context(cfg, n, ctx_len, SEED)
    for i in range(n):
        logits, secs = sync_time(lambda: system.materialize_prefill(
            params, i, max_len=serve["max_len"],
            context=None if context is None else context[i:i + 1]))
        tokens = min(contexts[i], serve["max_len"])
        check(bool(torch.isfinite(logits).all()),
              f"agent {i}: finite prefill logits")
        emit({"phase": phase, "agent": i, "prefill_tokens": tokens,
              "seconds": secs, "prefill_tokens_per_s": tokens / secs,
              "card": card})
    steps = serve["decode_steps"]
    pre, pre_s = sync_time(lambda: batched_request(system, params, 0,
                                                   context=context))
    out, full_s = sync_time(lambda: batched_request(system, params, steps,
                                                    context=context))
    P = out["prompt_len"]
    check(bool(torch.isfinite(out["logits"]).all()),
          "finite logits of the batched request")
    launches = {name: fn.launches for name, fn in model_kernels().items()}
    expected = expected_launches(cfg, n + 2, steps)
    check(launches == expected,
          f"{cfg.name}: launch counts {launches} == {expected}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # an MoE model's plain route takes the kernel route's experts, as it
    # takes its greedy tokens (moe_routes); the two routes' own choices
    # are compared apart (``request_flipped_tokens``, per layer in
    # ``layer_divergence``)
    with moe_routes() as kernel_routes:
        if cfg.moe is not None:
            batched_request(system, params, steps)
    with plain_route(), moe_routes(kernel_routes.routes) as plain_routes:
        plain, plain_s = sync_time(lambda: batched_request(
            system, params, steps, forced=out["tokens"], context=context))
    flips = [flipped_tokens(a, b) for a, b in zip(kernel_routes.routes,
                                                  plain_routes.routes)]
    rel_steps = (torch.linalg.vector_norm(
        (out["logits"] - plain["logits"]).float(), dim=-1)
        / torch.linalg.vector_norm(plain["logits"].float(), dim=-1))
    rel = float(rel_steps[:, 0].max())
    worst = float(rel_steps[:, 1:].max()) if steps else None
    agree = float((torch.argmax(plain["logits"][:, :-1], dim=-1)
                   == out["tokens"]).float().mean()) if steps else 1.0
    decode_s = full_s - pre_s
    controls = None
    if context is not None:
        # the controls: no context, and another seed's, must move the
        # logits (a cross path or encoder that is skipped or ignores the
        # context would not)
        def moved(other_context):
            other = batched_request(system, params, 0,
                                    context=other_context)["logits"][:, 0]
            return (torch.linalg.vector_norm((other - out["logits"][:, 0])
                                             .float(), dim=-1)
                    / torch.linalg.vector_norm(out["logits"][:, 0].float(),
                                               dim=-1))
        none_rel = moved(None)
        other_rel = moved(cell_context(cfg, n, ctx_len, SEED + 1))
        controls = {"no_context_rel_l2": none_rel.tolist(),
                    "no_context_over_route": (
                        none_rel / rel_steps[:, 0]).tolist(),
                    "other_context_rel_l2": other_rel.tolist(),
                    "other_context_over_route": (
                        other_rel / rel_steps[:, 0]).tolist()}
    emit({"phase": phase, "arch": cfg.name, "params": n_params,
          "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
          "context_len": None if context is None else ctx_len,
          "awake": awake, "controls": controls,
          "dtype": cfg.dtype, "init_seconds": init_s, "agents": n,
          "context_tokens": contexts, "prompt_len": P,
          "batched_prefill_tokens_per_s": n * P / pre_s,
          "batched_prefill_seconds": pre_s,
          "decode_tokens_per_s": n * steps / decode_s if steps else None,
          "decode_seconds": decode_s, "plain_route_seconds": plain_s,
          "logits_rel_l2": rel,
          "logits_rel_l2_max_step": float(rel_steps.max()),
          "logits_rel_l2_max_decode_step": worst,
          "logits_rel_l2_by_step": rel_steps.max(dim=0).values.tolist(),
          "greedy_agreement": agree, "launches": launches,
          "routes_forced": bool(flips),
          "request_flipped_tokens": sum(flips) if flips else None,
          "request_routed_tokens": (sum(r.shape[0] for r in plain_routes.routes)
                                    if flips else None),
          "peak_gib": peak, "token_savings": stats.token_savings,
          "flops_savings": stats.flops_savings,
          "prefill_tokens": stats.prefill_tokens,
          "broadcast_tokens": stats.broadcast_tokens,
          "fetches": stats.fetches, "cache_hits": stats.cache_hits,
          "card": card})
    layers = layer_divergence(card, system, params, phase, context)
    worst_layer = max(row["local"] for row in layers)
    if cfg.moe is not None:
        emit({"phase": phase, "what": "routing flips", "arch": cfg.name,
              "tokens": max(row.get("tokens", 0) for row in layers),
              "flipped_local": [row.get("flipped_local") for row in layers],
              "flipped_chained": [row.get("flipped_chained")
                                  for row in layers],
              "card": card})
    check(worst_layer <= LAYER_REL_L2,
          f"{cfg.name}: every layer's own share of the routes' distance "
          f"{worst_layer} <= {LAYER_REL_L2}")
    last_limit, step_limit = LOGITS_REL_L2[serve["arch"]]
    check(rel <= last_limit,
          f"{cfg.name} prefill logits: kernel vs plain relative L2 {rel} "
          f"<= {last_limit}")
    if steps:
        check(worst <= step_limit,
              f"{cfg.name} decode-step logits: kernel vs plain relative L2 "
              f"{worst} <= {step_limit}")
    if controls is not None:
        for what in ("no_context", "other_context"):
            ratios = controls[f"{what}_over_route"]
            check(min(ratios) > CONTEXT_NOISE,
                  f"{cfg.name}: {what.replace('_', ' ')} moves every row's "
                  f"logits by more than {CONTEXT_NOISE} times its route "
                  f"distance ({ratios})")
    serve_profile(card, system, params, context=context)
    if cfg.mla is not None:
        mla_expansion(card, cfg, params, n, P + steps,
                      decode_s / steps * 1e3 if steps else None, phase)
    # the reference's nominal length: whisper's decoder takes a quarter
    nominal = 4 * P if cfg.family == "audio" else P
    analytic_line(card, phase, cfg, "batched prefill", "prefill", n,
                  nominal, pre_s)
    if steps:
        analytic_line(card, phase, cfg, "decode step", "decode", n,
                      P + steps, decode_s / steps)
    if serve["arch"] in CONTINUE_OFFSETS:
        continue_prefill_check(card, system, params, serve, phase)
    return {name: count for name, count in launches.items() if count}


def mla_expansion(card: str, cfg, params, batch: int, length: int,
                  step_ms, phase: str) -> None:
    """What expanding MLA's latent cache costs a decode step (the
    reference's order, which the port follows): one layer's up-projection
    of a (batch, length) latent cache into head-major k and v
    (``attention._mla_expand``), alone by CUDA events, times the MLA
    layers, beside the decode step's time and the decode kernel's own over
    the expanded cache.  Reading the latent cache directly would drop the
    expansion and run decode as one group of all heads over a key of
    rank + rope and a value of rank (ROADMAP.md section 2)."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import attention as attn
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import layer_specs
    m, h = cfg.mla, cfg.n_heads
    layer = (params["prefix_0"] if "prefix_0" in params else
             tree_map(lambda a: a[0], params["blocks"]["sub0"]))["mixer"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(layer["wo"].dtype)

    ckv, kpe = normal(batch, length, m.kv_lora_rank), normal(
        batch, length, m.qk_rope_head_dim)
    expand_ms, expand_host = device_ms(
        lambda c, r: attn._mla_expand(layer, cfg, c, r), lambda: (ckv, kpe),
        10)
    k, v = attn._mla_expand(layer, cfg, ckv, kpe)
    dk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = normal(batch, h, dk)
    lens = torch.full((batch,), length, dtype=torch.int32, device="cuda")
    attend_ms = device_ms(lambda *a: decode_attention(*a, scale=dk ** -0.5),
                          lambda: (q, k, v, lens), 10)[0]
    layers = [spec.mixer for spec in layer_specs(cfg)].count("mla")
    emit({"phase": phase, "what": "mla expansion", "arch": cfg.name,
          "batch": batch, "cached_tokens": length, "mla_layers": layers,
          "expand_ms_per_layer": expand_ms,
          "expand_host_ms_per_layer": expand_host,
          "expand_ms_per_step": expand_ms * layers,
          "decode_kernel_ms_per_layer": attend_ms,
          "decode_step_ms": step_ms,
          "expand_flops_per_step": 2 * batch * length * m.kv_lora_rank * h
          * (m.qk_nope_head_dim + m.v_head_dim) * layers,
          "expanded_bytes_per_step": (k.numel() + v.numel())
          * k.element_size() * layers,
          "latent_bytes_per_step": (ckv.numel() + kpe.numel())
          * ckv.element_size() * layers, "card": card})



class moe_routes:
    """Inside ``with moe_routes(forced) as rec:`` every MoE routing
    (``models.moe._route``) appends the experts it chose itself, (tokens,
    k), to ``rec.routes``.  While ``forced`` (a list of such routings)
    holds any, each call takes the next of them instead, its gate values
    its own router probabilities at those experts, renormalized as
    ``_route`` does: the plain route then runs the kernel route's expert
    choices, as it runs its greedy tokens, so that the comparison of the
    two measures the kernels and not a near-tie in the top k (those are
    counted apart).  The model is unchanged."""

    def __init__(self, forced=()):
        self.forced = list(forced)

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.saved, self.routes = moe._route, []

        def route(p, m, xs):
            probs, gate, idx = self.saved(p, m, xs)
            self.routes.append(idx.reshape(-1, m.top_k))
            if self.forced:
                idx = self.forced.pop(0).reshape(idx.shape)
                top = torch.gather(probs, -1, idx)
                gate = (top / torch.clamp(top.sum(-1, keepdim=True),
                                          min=1e-9)).to(xs.dtype)
            return probs, gate, idx

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.saved
        return False


def flipped_tokens(a, b) -> int:
    """Tokens whose set of k experts differs between two routings."""
    import torch
    return int((torch.sort(a, dim=-1).values
                != torch.sort(b, dim=-1).values).any(dim=-1).sum())


def layer_divergence(card: str, system, params, phase: str,
                     context=None) -> list:
    """Where the kernel and plain routes part: the batched request's
    prompt through the layers one at a time, on both routes.  Per layer,
    the relative L2 distance of the residual stream after it (whole, and
    at the last position, the one the logits read): ``chained``, each
    route fed its own previous output; ``local``, the kernel route fed
    the plain route's input, so the layer's own share.  An MoE layer's
    row adds the tokens whose top-k set of experts differs from the plain
    route's (``flipped_local``, ``flipped_chained``).  With a ``context``
    the cross layers read it, and an encoder is walked first, layer by
    layer (rows ``encoder i``; its final norm gives each route its own
    context, the local call the plain route's).  Returns the rows."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import dtype_of, norm_apply, tree_map

    cfg, n = system.cfg, len(system.agents)
    contexts = [system.context_tokens(i) for i in range(n)]
    p = min(len(c) for c in contexts)
    tokens = torch.tensor([c[:p] for c in contexts], dtype=torch.int64,
                          device="cuda")
    positions = torch.arange(p, device="cuda")[None, :]
    specs = tf.layer_specs(cfg)
    prefix, period = tf.split_pattern(specs)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    def layer(i, x, ctx):
        if i < prefix:
            layer_p = params[f"prefix_{i}"]
        else:
            blk = tree_map(lambda a: a[(i - prefix) // period],
                           params["blocks"])
            layer_p = blk[f"sub{(i - prefix) % period}"]
        return tf.layer_apply(layer_p, cfg, specs[i], x, positions=positions,
                              context=ctx)[0]

    def row(label, xk, xp, local):
        return {"layer": label, "chained": rel(xk, xp),
                "chained_last": rel(xk[:, -1], xp[:, -1]),
                "local": rel(local, xp),
                "local_last": rel(local[:, -1], xp[:, -1])}

    rows = []
    ctx_k = ctx_p = None if context is None else context.to(
        dtype_of(cfg.dtype))
    if cfg.encoder_layers and context is not None:
        enc = params["encoder"]
        t = context.shape[1]
        xk = xp = ctx_k + tf._sinusoid(torch.arange(t, device="cuda"),
                                       cfg.d_model).to(ctx_k.dtype)
        for i in range(cfg.encoder_layers):
            blk = tree_map(lambda a: a[i], enc["blocks"])
            local = tf.encoder_layer_apply(blk, cfg, xp)
            xk = tf.encoder_layer_apply(blk, cfg, xk)
            with plain_route():
                xp = tf.encoder_layer_apply(blk, cfg, xp)
            rows.append(row(f"encoder {i}", xk, xp, local))
        ctx_k = norm_apply(enc["final_norm"], xk, cfg.norm)
        ctx_p = norm_apply(enc["final_norm"], xp, cfg.norm)
        del xk, xp, local
    xk = xp = tf._embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        with moe_routes() as kernel:
            local = layer(i, xp, ctx_p)
            xk = layer(i, xk, ctx_k)
        # an MoE layer's plain route takes the local kernel call's experts
        with plain_route(), moe_routes(kernel.routes[:1]) as plain:
            xp = layer(i, xp, ctx_p)
        rows.append(row(i, xk, xp, local))
        if plain.routes:    # the plain route's own choice against the two
            here, chained = kernel.routes
            rows[-1].update(
                tokens=int(here.shape[0]),
                flipped_local=flipped_tokens(here, plain.routes[0]),
                flipped_chained=flipped_tokens(chained, plain.routes[0]))
    torch.cuda.synchronize()
    emit({"phase": phase, "what": "layer_divergence", "arch": cfg.name,
          "prompt": [n, p], "layers": rows, "card": card})
    return rows


def check_grad(got, exp, what: str) -> tuple:
    """Holds a backward kernel's output to autograd of the plain version
    on the same inputs: fp32 max-abs within ``GRAD_FP32_TOL`` of the
    reference's largest magnitude; bf16 relative L2 within
    ``GRAD_REL_L2`` and each element within ``GRAD_ULPS`` bf16 ulps of
    the reference plus ``GRAD_RMS_FLOOR`` of its tensor's rms.  Returns
    (max-abs error, relative L2, largest element error over its
    allowance or None)."""
    import torch
    check(got.dtype == exp.dtype and got.shape == exp.shape,
          f"{what}: type and shape of the reference")
    g, e = got.float(), exp.float()
    err = float((g - e).abs().max())
    rel = float(torch.linalg.vector_norm(g - e)
                / torch.linalg.vector_norm(e).clamp_min(1e-30))
    if exp.dtype == torch.float32:
        limit = GRAD_FP32_TOL * float(e.abs().max())
        check(err <= limit, f"{what} within {limit} max-abs ({err})")
        return err, rel, None
    check(rel <= GRAD_REL_L2, f"{what} relative L2 {rel} <= {GRAD_REL_L2}")
    ulp = torch.where(e == 0, 0.0, torch.ldexp(
        torch.ones_like(e), torch.frexp(e).exponent - 8))
    ratio = float(((g - e).abs() / (GRAD_ULPS * ulp + GRAD_RMS_FLOOR
                                    * e.square().mean().sqrt())).max())
    check(ratio <= 1.0, f"{what}: every element within {GRAD_ULPS} bf16 "
          f"ulps plus {GRAD_RMS_FLOOR} of the tensor's rms ({ratio})")
    return err, rel, ratio


def phase_train_kernels(card: str, rate: float, flops: float,
                        fp32_flops: float) -> dict:
    """The two backward kernels against autograd of their plain versions
    on the card, and the forward kernels as training launches them
    against theirs (flash with its row statistics, output and lse each
    held; rmsnorm at the same rows as its backward, both in both cast
    orders), at a mid shape in fp32 and bf16, at the
    training path's shapes (gemma-2b's attention at (4, 8, 1, 2048, 256)
    and its rows (8192, 2048), its qk-norm width at qwen3-1.7b's heads,
    qwen3-1.7b's attention (4, 16, 8, 2048, 128)) and a ragged length;
    each timed alone (rmsnorm's in the cast-first order the models run;
    the attention backward with its head split and, where it splits,
    also without, in turns), with its bound and the
    backward of the one PyTorch call that
    computes the same forward (a yardstick the port never calls), then
    launched ``REPEATS`` more times, every output equal to the first bit
    for bit.  Also times the forward flash kernel with and without its
    row statistics at the batched prefill's shape.  Returns, per kernel,
    the row of gemma-2b's training shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_forward, bwd_plan,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import (attention_bwd_plain,
                                         attention_lse_plain, attention_plain,
                                         rmsnorm_bwd_plain)
    from repro_torch.kernels.rmsnorm import bwd_plan as norm_bwd_plan
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def normal(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def size(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def library_grad_ms(fn, inputs, dout, pair=False, reps=3):
        """The backward alone of ``fn`` (a PyTorch call) timed by
        ``median_ms``: its forward once, then autograd's backward with the
        graph kept; at an attention head-dim pair only on a fused backend,
        else None (``library_ms``)."""
        def timed():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            out = fn(*leaves)
            return median_ms(lambda: torch.autograd.grad(
                out, leaves, dout, retain_graph=True), tuple, reps)
        return library_ms(timed, pair)

    results, repeat_cases = {}, []
    for label, b, h, g, lq, lk, dim, name, causal in BWD_CASES:
        dtype = getattr(torch, name)
        dk, dv = head_dims(dim)
        q = normal(b, h, lq, dk, dtype=dtype)
        k = normal(b, g, lk, dk, dtype=dtype)
        v = normal(b, g, lk, dv, dtype=dtype)
        dout = normal(b, h, lq, dv, dtype=dtype)
        # the forward as training launches it: with its row statistics
        fwd, lse = _forward(q, k, v, causal, None, with_lse=True)
        got = flash_attention_bwd(q, k, v, dout, lse, causal)
        torch.cuda.synchronize()
        fwd_err, fwd_row_err = check_attention(
            fwd, attention_plain(q, k, v, causal), dtype,
            f"flash_attention with lse ({label})")
        check(torch.equal(fwd, _forward(q, k, v, causal, None, False)[0]),
              f"flash_attention's output unchanged by its lse ({label})")
        exp_lse = attention_lse_plain(q, k, causal)
        lse_err = float((lse - exp_lse).abs().max())
        lse_limit = LSE_REL * max(1.0, float(exp_lse.abs().max()))
        check(lse_err <= lse_limit, f"flash_attention lse ({label}) "
              f"within {lse_limit} max-abs ({lse_err})")
        del fwd, exp_lse
        exp = attention_bwd_plain(q, k, v, dout, causal)
        errs = [check_grad(a, e, f"flash_attention_bwd d{n} ({label})")
                for n, a, e in zip("qkv", got, exp)]
        del exp
        args = lambda: (q, k, v, dout, lse, causal)   # noqa: E731
        work = 2.5 * 2 * (dk + dv) * b * h * attention_pairs(lq, lk, causal)
        dev_ms, host_ms = device_ms(flash_attention_bwd, args, 3)
        row = {"phase": "kernels", "kernel": "flash_attention_bwd",
               "case": label, "shape": [b, h, g, lq, lk, dk]
               + ([dv] if dv != dk else []),
               "causal": causal, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max(e[0] for e in errs),
               "rel_l2": [e[1] for e in errs],
               "max_elem_err": (None if dtype == torch.float32
                                else max(e[2] for e in errs)),
               "fwd_max_abs_err": fwd_err, "fwd_row_err": fwd_row_err,
               "lse_max_abs_err": lse_err,
               "ms": median_ms(flash_attention_bwd, args, 3),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(lambda *a: attention_bwd_plain(
                   *a[:4], causal), args, 1),
               "library_ms": library_grad_ms(
                   lambda a, b_, c: F.scaled_dot_product_attention(
                       a, b_, c, is_causal=causal, enable_gqa=True),
                   (q, k, v), dout, dk != dv),
               "bound_ms": max(size(q, k, v, dout, lse, *got) / rate,
                               work / (flops if dtype == bf16
                                       else fp32_flops)) * 1e3,
               "bound_by": "operations", "card": card}
        row["tflops"] = work / (row["device_ms"] * 1e-3) / 1e12
        if dtype == bf16:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            row["head_splits"] = bwd_plan(b, h, g, lq, lk, dk,
                                          sms).head_splits
            if row["head_splits"] > 1:
                # what the split buys: alone in turns, unsplit and split
                turns = {}
                for off in (True, False, False, True):
                    if off:
                        with head_split_off():
                            ms = device_ms(flash_attention_bwd, args, 3)[0]
                    else:
                        ms = device_ms(flash_attention_bwd, args, 3)[0]
                    turns.setdefault(off, []).append(ms)
                row["device_ms_split_off"] = turns[True]
                row["device_ms_split_on"] = turns[False]
        emit(row)
        repeat_cases.append(("flash_attention_bwd", label, functools.partial(
            flash_attention_bwd, q, k, v, dout, lse, causal), got))
        if label == "gemma-2b train":
            results["flash_attention_bwd"] = row
    del q, k, v, dout, lse, got

    # the forward with and without its row statistics, at the batched
    # prefill's shape (1.420 ms without them on an H100, PERF.md)
    q = normal(SERVE["agents"], 8, 6144, 256)
    k, v = (normal(SERVE["agents"], 1, 6144, 256) for _ in range(2))
    timed = {}
    for with_lse in (False, True, True, False):
        ms, _ = device_ms(lambda a, b_, c: _forward(a, b_, c, True, None,
                                                    with_lse), lambda: (
                                                        q, k, v), 5)
        timed.setdefault(with_lse, []).append(ms)
    emit({"phase": "kernels", "kernel": "flash_attention",
          "case": "batched prefill, with and without lse",
          "shape": [SERVE["agents"], 8, 1, 6144, 256],
          "ms_without_lse": timed[False], "ms_with_lse": timed[True],
          "card": card})
    del q, k, v

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, rows, width, name in RMS_BWD_CASES:
        dtype = getattr(torch, name)
        x, dy = (normal(rows, width, dtype=dtype) for _ in range(2))
        w = normal(width, dtype=dtype)
        # the forward at training's rows in both cast orders, then the
        # backward in both, each against autograd of its plain version
        fwd_errs = check_rmsnorm(x, w, f"{label}, training")
        orders = {}
        for cast_first in (False, True):
            got = rmsnorm_bwd(x, w, dy, cast_first=cast_first)
            torch.cuda.synchronize()
            exp = rmsnorm_bwd_plain(x, w, dy, cast_first=cast_first)
            order = "cast-first" if cast_first else "TPU-kernel"
            orders[order] = [check_grad(a, e, f"rmsnorm_bwd {n} ({label}, "
                                        f"{order} order)")
                             for n, a, e in zip(("dx", "dw"), got, exp)]
            repeat_cases.append((f"rmsnorm_bwd ({order} order)", label,
                                 functools.partial(rmsnorm_bwd, x, w, dy,
                                                   cast_first=cast_first),
                                 got))
            if label == "gemma-2b train":
                repeat_cases.append((
                    f"rmsnorm ({order} order)", label, functools.partial(
                        rmsnorm, x, w, cast_first=cast_first),
                    rmsnorm(x, w, cast_first=cast_first)))
        del exp
        errs = orders["cast-first"]
        # timed in the order the models run (norm_apply: cast first)
        model_bwd = functools.partial(rmsnorm_bwd, cast_first=True)
        args = lambda: (x, w, dy)   # noqa: E731
        dev_ms, host_ms = device_ms(model_bwd, args, 10)
        row = {"phase": "kernels", "kernel": "rmsnorm_bwd", "case": label,
               "shape": [rows, width], "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max(e[0] for e in errs),
               "rel_l2": [e[1] for e in errs],
               "max_elem_err": (None if dtype == torch.float32
                                else max(e[2] for e in errs)),
               "tpu_order": {"rel_l2": [e[1] for e in orders["TPU-kernel"]],
                             "max_elem_err": (
                                 None if dtype == torch.float32 else
                                 max(e[2] for e in orders["TPU-kernel"])),
                             "device_ms": device_ms(rmsnorm_bwd, args,
                                                    10)[0]},
               "fwd": fwd_errs,
               "ms": median_ms(model_bwd, args, 10),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(functools.partial(
                   rmsnorm_bwd_plain, cast_first=True), args, 3),
               "library_ms": library_grad_ms(
                   lambda a, b_: F.rms_norm(a, (width,), b_, 1e-6),
                   (x, w), dy, reps=10),
               "bound_ms": (3 * size(x) + 2 * size(w)) / rate * 1e3,
               "bound_by": "bytes",
               "plan": norm_bwd_plan(width, x.element_size(),
                                     sms)._asdict(),
               "card": card}
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        emit(row)
        if label == "gemma-2b train":
            results["rmsnorm_bwd"] = row
    row, wkv_repeats = check_rwkv6_scan_bwd(card, rate, fp32_flops, gen)
    results["rwkv6_scan_bwd"] = row
    mamba_rows, mamba_repeats = check_mamba_bwd(card, rate, fp32_flops, gen)
    results.update(mamba_rows)
    check_repeats(card, repeat_cases + wkv_repeats + mamba_repeats)
    return results


def check_rwkv6_scan_bwd(card: str, rate: float, fp32_flops: float,
                         gen) -> tuple:
    """The WKV backward kernel (a cluster of a head's row groups per
    (batch, head), dv summed in distributed shared memory, then du's
    batch sum) against the plain reverse recurrence
    (``rwkv6_scan_bwd_plain``) at ``WKV_BWD_CASES``, each from the
    checkpoints of the forward as training launches it, with an initial
    state and a final state's gradient: every gradient within the fp32
    gate of ``check_grad``, and the call's device memory beyond its
    inputs and outputs (``extra_bytes``, the peak) at most du's B * H *
    dh float partials plus 1 MiB.  Timed alone and through its wrapper
    beside its bound (bytes: r, k, v, w, dy, the bonus, the checkpoints
    and the final state's gradient read once, the six gradients written
    once; operations: ``WKV_BWD_FLOPS`` a state element a step at the
    card's fp32 rate), its issue floor (``WKV_BWD_INSTRUCTIONS`` at the
    card's fp32 lanes and highest SM clock) and the plain version; no
    PyTorch call computes it (``library_ms`` None).  The checkpointing
    forward is timed against the serving launch, in turns.  Returns the
    training shape's row and the cases for ``check_repeats``."""
    import torch
    from repro_torch.kernels.ref import rwkv6_scan_bwd_plain
    from repro_torch.kernels.rwkv6_scan import (CKPT, bwd_resident_blocks,
                                                rwkv6_scan, rwkv6_scan_bwd,
                                                rwkv6_scan_checkpoints)
    lanes = (torch.cuda.get_device_properties(0).multi_processor_count
             * FP32_LANES_PER_SM)
    clock_hz = max_sm_clock_hz()
    result, repeats = None, []
    for label, b, t, h, dh in WKV_BWD_CASES:
        r, k, v, dy = (torch.randn((b, t, h, dh), generator=gen,
                                   device="cuda") for _ in range(4))
        w = torch.exp(-torch.exp(torch.rand(
            (b, t, h, dh), generator=gen, device="cuda") * 3 - 8))
        bonus = torch.randn((h, dh), generator=gen, device="cuda") * 0.1
        s0, ds = (torch.randn((b, h, dh, dh), generator=gen, device="cuda")
                  for _ in range(2))
        fwd = (r, k, v, w, bonus, s0)
        ckpt = rwkv6_scan_checkpoints(*fwd)[2]
        args = (r, k, v, w, bonus, ckpt, dy, ds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = rwkv6_scan_bwd(*args)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - before
                 - sum(g.numel() * g.element_size() for g in got))
        check(extra <= 4 * b * h * dh + (1 << 20),
              f"rwkv6_scan_bwd ({label}) takes {extra} bytes beyond its "
              f"inputs and outputs")
        exp = rwkv6_scan_bwd_plain(*fwd, dy, ds)
        errs = [check_grad(a, e, f"rwkv6_scan_bwd {n} ({label})")
                for n, a, e in zip(("dr", "dk", "dv", "dw", "du", "dstate0"),
                                   got, exp)]
        del exp
        make = lambda: args   # noqa: E731
        dev_ms, host_ms = device_ms(rwkv6_scan_bwd, make, 5)
        moved = sum(x.numel() * x.element_size() for x in args + got)
        elems = b * t * h * dh * dh
        bytes_ms = moved / rate * 1e3
        ops_ms = WKV_BWD_FLOPS * elems / fp32_flops * 1e3
        # the forward as training launches it (checkpoints every CKPT
        # steps) against the serving launch, alone, in turns
        turns = {}
        for ckpts in (False, True, True, False):
            fn = rwkv6_scan_checkpoints if ckpts else rwkv6_scan
            turns.setdefault(ckpts, []).append(
                device_ms(fn, lambda: fwd, 5)[0])
        row = {"phase": "kernels", "kernel": "rwkv6_scan_bwd",
               "case": label, "shape": [b, t, h, dh], "dtype": "float32",
               "checkpoint_every": CKPT, "extra_bytes": extra,
               "resident_blocks": bwd_resident_blocks(dh),
               "max_abs_err": max(e[0] for e in errs),
               "rel_l2": [e[1] for e in errs],
               "ms": median_ms(rwkv6_scan_bwd, make, 5),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(lambda *a: rwkv6_scan_bwd_plain(
                   *fwd, dy, ds), make, 1),
               "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
               "issue_floor_ms": WKV_BWD_INSTRUCTIONS * elems
               / (lanes * clock_hz) * 1e3,
               "forward_device_ms": turns[False],
               "forward_checkpointed_device_ms": turns[True],
               "card": card}
        emit(row)
        repeats.append(("rwkv6_scan_bwd", label,
                        functools.partial(rwkv6_scan_bwd, *args), got))
        if label == "rwkv6-1.6b train":
            result = row
    return result, repeats



def mamba_bwd_occupancy(kernel: str, *key) -> dict:
    """A Mamba backward kernel's registers a thread, blocks an SM, threads
    a block and shared bytes a block on the card, from its occupancy
    entry (``selective_scan_bwd_occupancy(N, out)``,
    ``causal_conv1d_bwd_occupancy(dtype, out)``)."""
    import ctypes
    from repro_torch.kernels import build
    out = (ctypes.c_int * 4)()
    err = build.entry(kernel, f"{kernel}_occupancy",
                      [ctypes.c_int] * len(key) + [ctypes.c_void_p])(
        *key, ctypes.addressof(out))
    check(err == 0, f"{kernel}'s occupancy query (CUDA error {err})")
    return dict(zip(("registers", "blocks_per_sm", "threads", "smem_bytes"),
                    out))


def check_mamba_bwd(card: str, rate: float, fp32_flops: float, gen) -> tuple:
    """Mamba's two backward kernels against their plain versions at
    jamba-1.5-large-398b's training shape (4, 2048, 16384, 16; the conv in
    bf16) and a ragged one (2, 333, 384, 16 in fp32, with a state and the
    new or final state's gradient), every output within the gates of
    ``check_grad``.  The selective scan's from the checkpoints of the
    forward as training launches it, whose y and final state must equal
    the serving launch's bit for bit, and its device memory beyond its
    inputs and outputs at most its stated scratch
    (``selective_scan.bwd_scratch_floats``) plus 1 MiB.  Each timed alone
    and through its wrapper beside its bound, the plain version and, for
    the conv, autograd of ``conv_library`` (none computes the scan's);
    beside them each kernel's registers a thread, blocks an SM and waves
    (``mamba_bwd_occupancy``), its MUFU floor (the scan's one exponential
    a state element a step, the conv's exponential and reciprocal a
    value) and its machine code's issue time (``sass_issue``); the
    checkpointing forward is timed against the serving launch, in turns.
    Returns the training shape's rows and the cases for
    ``check_repeats``."""
    import torch
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_bwd,
                                                   causal_conv1d_bwd_plain)
    from repro_torch.kernels.selective_scan import (
        CKPT, bwd_scratch_floats, selective_scan, selective_scan_bwd,
        selective_scan_bwd_plain, selective_scan_checkpoints)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = max_sm_clock_hz()
    cfg = serve_config(TRAIN_JAMBA)
    d, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    results, repeats = {}, []

    def size(*ts):
        return sum(v.numel() * v.element_size() for v in ts if v is not None)

    def mufu_ms(units):
        return units / (MUFU_PER_SM * sms * clock_hz) * 1e3

    for label, b, t, d_, n_, name, state in (
            ("jamba train", TRAIN_JAMBA["batch"], TRAIN_JAMBA["seq_len"], d,
             n, "bfloat16", False),
            ("ragged", 2, 333, 384, 16, "float32", True)):
        dtype = getattr(torch, name)
        conv, scan = mamba_inputs(gen, b, t, d_, n_, dtype, state)
        dout = torch.randn((b, t, d_), generator=gen, device="cuda").to(dtype)
        dnew = (torch.randn((b, 3, d_), generator=gen, device="cuda")
                .to(dtype) if state else None)
        got = causal_conv1d_bwd(*conv, dout, dnew)
        torch.cuda.synchronize()
        exp = causal_conv1d_bwd_plain(*conv, dout, dnew)
        errs = [check_grad(g, e, f"causal_conv1d_bwd {k} ({label})")
                for k, g, e in zip(("dx", "dw", "db", "dstate"), got, exp)]
        del exp
        make = lambda: conv + (dout, dnew)   # noqa: E731
        dev_ms, host_ms = device_ms(causal_conv1d_bwd, make, 5)
        x = conv[0]
        bytes_ms = (3 * x.numel() * x.element_size() + size(*conv[1:], dnew)
                    + size(*got[1:])) / rate * 1e3
        ops_ms = CONV_BWD_FLOPS * x.numel() / fp32_flops * 1e3
        io = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
        sass_per, sass_ms = sass_issue(
            "causal_conv1d_bwd", rf"conv_bwd_kernelI{io}E", "MUFU.EX2",
            x.numel(), sms, clock_hz)
        occ = mamba_bwd_occupancy("causal_conv1d_bwd", int(
            dtype == torch.bfloat16))
        vec = 4 // x.element_size()
        blocks = -(-d_ // (vec * occ["threads"])) * -(-t // 128) * b
        row = {"phase": "kernels", "kernel": "causal_conv1d_bwd",
               "case": label, "shape": [b, t, d_], "dtype": name,
               "initial_state": state, **occ,
               "waves": blocks / (occ["blocks_per_sm"] * sms),
               "mufu_floor_ms": mufu_ms(CONV_MUFU * x.numel()),
               "sass_per_value": sass_per, "sass_issue_ms": sass_ms,
               # the forward as training launches it
               "forward_device_ms": device_ms(causal_conv1d,
                                              lambda: conv, 5)[0],
               "forward_bound_ms": (2 * x.numel() * x.element_size()
                                    + size(*conv[1:])) / rate * 1e3,
               "forward_issue_floor_ms": CONV_MUFU * x.numel()
               / (MUFU_PER_SM * sms * clock_hz) * 1e3,
               "max_abs_err": max(e[0] for e in errs),
               "rel_l2": [e[1] for e in errs],
               "ms": median_ms(causal_conv1d_bwd, make, 5),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(causal_conv1d_bwd_plain, make, 1),
               "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "card": card}
        if not state:
            leaves = [v.detach().requires_grad_(True) for v in conv[:3]]
            out = conv_library(*leaves)
            row["library_ms"] = median_ms(lambda: torch.autograd.grad(
                out, leaves, dout, retain_graph=True), tuple, 5)
            del leaves, out
        emit(row)
        repeats.append(("causal_conv1d_bwd", label, functools.partial(
            causal_conv1d_bwd, *conv, dout, dnew), got))
        del got

        y, s = selective_scan(*scan)
        y2, s2, ckpt = selective_scan_checkpoints(*scan)
        check(torch.equal(y, y2) and torch.equal(s, s2),
              f"selective_scan's checkpointing launch == its serving launch "
              f"bit for bit ({label})")
        del y, s, y2, s2
        dy = torch.randn((b, t, d_), generator=gen, device="cuda")
        ds = (0.5 * torch.randn((b, d_, n_), generator=gen, device="cuda")
              if state else None)
        args = scan[:6] + (ckpt, dy, ds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = selective_scan_bwd(*args)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - before
                 - sum(g.numel() * g.element_size() for g in got))
        scratch = 4 * bwd_scratch_floats(b, t, d_, n_)
        check(extra <= scratch + (1 << 20),
              f"selective_scan_bwd ({label}) takes {extra} bytes beyond its "
              f"inputs and outputs, its scratch {scratch}")
        exp = selective_scan_bwd_plain(*scan, dy, ds)
        errs = [check_grad(g, e, f"selective_scan_bwd {k} ({label})")
                for k, g, e in zip(("ddt", "da", "db", "dc", "dx", "dd_skip",
                                    "dstate0"), got, exp)]
        del exp
        make = lambda: args   # noqa: E731
        dev_ms, host_ms = device_ms(selective_scan_bwd, make, 5)
        elems = b * t * d_ * n_
        bytes_ms = (size(*args) + size(*got)) / rate * 1e3
        ops_ms = SCAN_BWD_FLOPS * elems / fp32_flops * 1e3
        occ = mamba_bwd_occupancy("selective_scan_bwd", n_)
        sass_per, sass_ms = sass_issue(
            "selective_scan_bwd", rf"scan_bwd_kernelILi{n_}EE", "MUFU.EX2",
            elems, sms, clock_hz)
        turns = {}
        for ckpts in (False, True, True, False):
            fn = selective_scan_checkpoints if ckpts else selective_scan
            turns.setdefault(ckpts, []).append(
                device_ms(fn, lambda: scan, 5)[0])
        srow = {"phase": "kernels", "kernel": "selective_scan_bwd",
                "case": label, "shape": [b, t, d_, n_], "dtype": "float32",
                "checkpoint_every": CKPT, "extra_bytes": extra,
                "scratch_bytes": scratch, **occ,
                "waves": (d_ // 128) * b / (occ["blocks_per_sm"] * sms),
                "sass_per_state_step": sass_per, "sass_issue_ms": sass_ms,
                "max_abs_err": max(e[0] for e in errs),
                "rel_l2": [e[1] for e in errs],
                "ms": median_ms(selective_scan_bwd, make, 5),
                "device_ms": dev_ms, "host_ms": host_ms,
                "plain_ms": median_ms(lambda *a: selective_scan_bwd_plain(
                    *scan, dy, ds), make, 1),
                "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
                "mufu_floor_ms": mufu_ms(elems),
                "forward_device_ms": turns[False],
                "forward_checkpointed_device_ms": turns[True],
                "forward_issue_floor_ms": mufu_ms(elems),
                "card": card}
        emit(srow)
        repeats.append(("selective_scan_bwd", label, functools.partial(
            selective_scan_bwd, *args), got))
        if label == "jamba train":
            results["causal_conv1d_bwd"] = row
            results["selective_scan_bwd"] = srow
    return results, repeats


#: rounds of a turns run (each the sources in order, then reversed) and
#: launches timed a source a turn: ``wkv_bwd_turns`` and
#: ``rmsnorm_bwd_turns``
WKV_TURNS = (3, 5)
RMS_BWD_TURNS = (3, 20)
#: ``rmsnorm_bwd``'s shapes timed in turns (bf16): gemma-2b's training
#: rows and the qk-norm width's, phase ``kernels``' two training cases
RMS_BWD_TURN_SHAPES = ((TRAIN["batch"] * TRAIN["seq_len"], 2048),
                       (TRAIN["batch"] * TRAIN["seq_len"] * 16,
                        QK_NORM_WIDTH))


def build_variants(kernel: str, sources) -> list:
    """Each given source of ``kernel`` (this tree's, an earlier tree's
    unpacked under ``build/``, or a probe variant of either) built into a
    library of its own with the port's nvcc flags (its own directory,
    then this tree's ``csrc``, for headers), one ``nvcc`` each, all
    started together.  Returns ``(source, library, ptxas entries)`` a
    source."""
    import ctypes
    from repro_torch.kernels import build
    out_dir = REPO / "build" / f"{kernel}_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    procs = []
    for i, src in enumerate(sources):
        src = pathlib.Path(src).resolve()
        lib = out_dir / f"v{i}.so"
        procs.append((src, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
             f"-I{src.parent}", f"-I{csrc}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    variants = []
    for src, lib, proc in procs:
        log, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"{src} builds:\n{log}")
        variants.append((src, ctypes.CDLL(str(lib)), ptxas_entries(log)))
    return variants


def sass_loop(instructions, unit: str) -> tuple:
    """Per opcode, the instructions of the loop body (the span of a
    backward branch) that holds the most ``unit`` instructions (its
    tightest such span), and that count.  ``instructions`` are
    ``(address, text)`` pairs of one function of ``cuobjdump -sass``."""
    def opcode(text):
        words = text.split()
        return words[1] if words[0].startswith("@") else words[0]

    best = None
    for addr, text in instructions:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [opcode(t) for a, t in instructions
                if int(m.group(1), 16) <= a <= addr]
        units = sum(op.startswith(unit) for op in body)
        if units and (best is None or (units, -len(body)) > best[0]):
            best = ((units, -len(body)), body)
    if best is None:
        return {}, 0
    return dict(collections.Counter(best[1])), best[0][0]


@functools.lru_cache(maxsize=None)
def sass_functions(library: str) -> dict:
    """A library's machine code (``cuobjdump -sass``): per function's
    mangled name, its ``(address, text)`` instructions."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


def sass_issue(kernel: str, pattern: str, unit: str, units_run: int,
               sms: int, clock_hz: float) -> tuple:
    """The built ``kernel``'s instance matching ``pattern``: the
    instructions of its output loop (:func:`sass_loop`) per ``unit``
    instruction, and the ms that ``units_run`` such units take to issue
    at ``FP32_LANES_PER_SM`` thread-instructions an SM a clock.  A static
    count: branches not taken (a division's slow path) count too."""
    from repro_torch.kernels import build
    funcs = sass_functions(str(build.library_path(kernel)))
    match = [f for f in funcs if re.search(pattern, f)]
    check(len(match) == 1, f"one {kernel} instance matches {pattern}")
    ops, units = sass_loop(funcs[match[0]], unit)
    per = sum(ops.values()) / units
    return per, per * units_run / (FP32_LANES_PER_SM * sms * clock_hz) * 1e3


#: ``--sass``'s instances of each kernel: (name, the function's mangled
#: name pattern, the loop's unit instruction, model values a unit)
SASS_INSTANCES = {
    "causal_conv1d": (("bf16", r"conv_kernelI13__nv_bfloat16E", "STG.E.128",
                       8),
                      ("fp32", r"conv_kernelIfE", "STG.E.128", 4)),
    "selective_scan": (("fp32 mode, d_state 16, 1 lane",
                        r"scan_kernelI(?:fLb0E)?Li16E(?:Li1E)?E",
                        "MUFU.EX2", 1),),
    # a unit is an exponential: one a value of the conv, one a state
    # element a step of the scan (two in its earlier design, which kept a
    # chunk's states in shared memory)
    "causal_conv1d_bwd": (("bf16", r"conv_bwd_kernelI13__nv_bfloat16E",
                           "MUFU.EX2", 1),
                          ("fp32", r"conv_bwd_kernelIfE", "MUFU.EX2", 1)),
    "selective_scan_bwd": (("d_state 16", r"scan_bwd_kernelILi16EE",
                            "MUFU.EX2", 1),),
}


def sass_counts(card: str, kernel: str, sources) -> None:
    """``chip_smoke.py --sass KERNEL SRC...``: each source built by
    :func:`build_variants`, then, per instance of ``SASS_INSTANCES``, the
    instructions of its output loop (:func:`sass_loop`) per output element
    (the conv: a 16-byte store is 8 bf16 or 4 fp32 values) or per
    exponential (the scan): every opcode, and conversions (``F2F``,
    ``F2FP``), fp32 FMA-pipe operations (``FFMA``, ``FMUL``, ``FADD``),
    packed half operations (``HFMA2``, ``HMUL2``, ``HADD2``) and ``MUFU``
    summed apart.  Static counts of the machine code, not a profile."""
    for src, lib, entries in build_variants(kernel, sources):
        funcs = sass_functions(lib._name)
        for label, pattern, unit, values in SASS_INSTANCES[kernel]:
            match = [f for f in funcs if re.search(pattern, f)]
            check(len(match) == 1, f"{source_name(src)}: one {kernel} "
                  f"instance matches {pattern} ({match})")
            ops, units = sass_loop(funcs[match[0]], unit)
            check(units > 0, f"{source_name(src)}: {label}'s output loop")
            per = {op: n / (units * values) for op, n in sorted(ops.items())}

            def total(*prefixes):
                return sum(v for op, v in per.items()
                           if op.split(".")[0] in prefixes)

            emit({"phase": "sass", "kernel": kernel,
                  "source": source_name(src), "instance": label,
                  "loop_units": units, "unit": unit, "per_value": per,
                  "conversions": total("F2F", "F2FP"),
                  "fp32_fma_pipe": total("FFMA", "FMUL", "FADD"),
                  "packed_half": total("HFMA2", "HMUL2", "HADD2"),
                  "mufu": total("MUFU"), "all": sum(per.values()),
                  "ptxas": entries, "card": card})


def mamba_bwd_variants(card: str, kernel: str, sources) -> None:
    """``chip_smoke.py --mamba-bwd-variants KERNEL SRC...``: each source
    of ``causal_conv1d_bwd`` or ``selective_scan_bwd`` with this tree's
    C interface (a probe variant) in turns by :func:`variants_in_turns`
    at jamba-1.5-large-398b's training shape, the conv in bf16."""
    import torch
    from repro_torch.kernels.causal_conv1d import bwd_scratch_floats as cbs
    from repro_torch.kernels.ref import (causal_conv1d_bwd_plain,
                                         selective_scan_bwd_plain)
    from repro_torch.kernels.selective_scan import (
        bwd_scratch_floats, selective_scan_checkpoints)
    cfg = serve_config(TRAIN_JAMBA)
    b, t = TRAIN_JAMBA["batch"], TRAIN_JAMBA["seq_len"]
    d, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    conv, scan = mamba_inputs(gen, b, t, d, n, torch.bfloat16, False)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "causal_conv1d_bwd":
        x, w, bias, _ = conv
        dout = torch.randn((b, t, d), generator=gen,
                           device="cuda").to(x.dtype)
        outs = [torch.empty_like(dout), torch.empty((4, d), device="cuda"),
                torch.empty(d, device="cuda"),
                torch.empty((b, 3, d), dtype=x.dtype, device="cuda")]
        scratch = torch.empty(cbs(b, t, d), device="cuda")
        args = (x.data_ptr(), w.data_ptr(), bias.data_ptr(), None,
                dout.data_ptr(), None, *(o.data_ptr() for o in outs),
                scratch.data_ptr(), b, t, d, x.stride(0), x.stride(1), 1,
                stream)
        variants_in_turns(card, "mamba_bwd_variants", kernel, sources, args,
                          outs, causal_conv1d_bwd_plain(x, w, bias, None,
                                                        dout),
                          shape=[b, t, d])
        return
    _, _, ckpt = selective_scan_checkpoints(*scan)
    dy = torch.randn((b, t, d), generator=gen, device="cuda")
    dt, a, bm, cm, x, dskip, _ = scan
    outs = [torch.empty_like(dt), torch.empty_like(a), torch.empty_like(bm),
            torch.empty_like(cm), torch.empty_like(dt),
            torch.empty_like(dskip), torch.empty((b, d, n), device="cuda")]
    scratch = torch.empty(bwd_scratch_floats(b, t, d, n), device="cuda")
    args = (*(v.data_ptr() for v in (dt, a, bm, cm, x, dskip, ckpt, dy)),
            None, *(o.data_ptr() for o in outs), scratch.data_ptr(), b, t, d,
            n, stream)
    variants_in_turns(card, "mamba_bwd_variants", kernel, sources, args,
                      outs, selective_scan_bwd_plain(*scan, dy),
                      shape=[b, t, d, n])


#: one turn of ``--mamba-turns``, run in a child process from a tree's
#: root with that tree's own ``chip_smoke``
MAMBA_TURN = """
import sys
import torch
sys.path.insert(0, "src")
import chip_smoke as cs
card = cs.card_line()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
cs.check_mamba_kernels(card, cs.memory_rate(card), cs.fp32_rate(card), gen,
                       6144, 6144)
cs.check_mamba_bwd(card, cs.memory_rate(card), cs.fp32_rate(card), gen)
for fn in cs.model_kernels().values():
    fn.launches = 0
cs.phase_serve(card, cs.SERVE_JAMBA)
cs.phase_train(card, cs.bf16_rate(card), cs.TRAIN_JAMBA)
"""


def mamba_turns(card: str, roots) -> None:
    """``chip_smoke.py --mamba-turns ROOT...``: each tree's own Mamba
    kernel checks (``check_mamba_kernels`` at jamba's serving shapes,
    ``check_mamba_bwd`` at its training shape) and its two jamba cells (``serve_jamba`` and jamba's first-layer
    training) in a child process from the tree's root, in turns (the
    roots in order, then reversed), every line the child prints that is
    a JSON object re-emitted with its turn and root.  The kernels build
    at first use in each tree."""
    order = list(roots) + list(roots)[::-1]
    for turn, root in enumerate(order):
        proc = subprocess.run([sys.executable, "-c", MAMBA_TURN],
                              cwd=root, capture_output=True, text=True,
                              timeout=1200)
        check(proc.returncode == 0, f"{root} turn {turn}: "
              f"{proc.stdout[-1500:]}{proc.stderr[-1500:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                emit(dict(json.loads(line), turn=turn, root=root))


def in_turns(calls, turns) -> list:
    """Device ms of each zero-argument call in turns: ``turns[0]`` rounds
    of the calls in order and then reversed, a turn one warm-up call and
    then ``turns[1]`` calls queued behind a spin kernel (so that the CUDA
    events between them bracket the device's work and not the host's
    launches), their median.  Returns each call's turn medians."""
    import torch
    times = [[] for _ in calls]
    rounds, reps = turns
    for _ in range(rounds):
        order = list(range(len(calls)))
        for i in order + order[::-1]:
            calls[i]()
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(reps + 1)]
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            events[0].record()
            for end in events[1:]:
                calls[i]()
                end.record()
            events[-1].synchronize()
            times[i].append(statistics.median(
                a.elapsed_time(b) for a, b in zip(events, events[1:])))
    return times


def source_name(src: pathlib.Path) -> str:
    return str(src.relative_to(REPO)) if src.is_relative_to(REPO) else str(
        src)


def variants_in_turns(card: str, phase: str, kernel: str, sources, args,
                      outs, expected, extra=None, **shown) -> None:
    """Each source of ``kernel`` (this tree's, an earlier tree's, or a
    probe variant of either, with this tree's C interface) built by
    :func:`build_variants`, then launched through its C entry on ``args``
    (writing ``outs``) in turns (:func:`in_turns`, ``WKV_TURNS``).  Each
    source's first launch is held to ``expected`` and its max-abs error
    over each output's largest magnitude printed (a probe with parts
    switched off computes wrong sums, so nothing here is gated).  Prints
    a row a source: the kernel, ``shown``, its ptxas lines,
    ``extra(library)``'s keys, turn times and median."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    _, symbol, argtypes = build.KERNELS[kernel]
    entries = []
    for src, so, ptxas in build_variants(kernel, sources):
        fn = getattr(so, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries.append((src, so, fn, ptxas))

    def run(fn) -> None:
        err = fn(*args)
        check(err == 0, f"launch failed: CUDA error {err}")

    errs = []
    for _, _, fn, _ in entries:
        for o in outs:
            o.fill_(float("nan"))
        run(fn)
        torch.cuda.synchronize()
        errs.append([float((g.float() - e.float()).abs().max()
                           / e.float().abs().max())
                     for g, e in zip(outs, expected)])
    del expected
    times = in_turns([functools.partial(run, fn) for _, _, fn, _ in entries],
                     WKV_TURNS)
    for (src, so, _, ptxas), err, ms in zip(entries, errs, times):
        emit({"phase": phase, "kernel": kernel, "source": source_name(src),
              **shown, "ptxas": ptxas, **(extra(so) if extra else {}),
              "max_abs_err_over_max": err, "turn_ms": ms,
              "median_ms": statistics.median(ms), "card": card})


def wkv_bwd_turns(card: str, sources, shape=None) -> None:
    """``chip_smoke.py --wkv-bwd-turns [--shape B,T,H,DH] SRC...``: each
    WKV backward source in turns by :func:`variants_in_turns` at
    rwkv6-1.6b's training shape, ``WKV_BWD_CASES[0]`` (or ``shape``),
    fp32, checkpoints ``CKPT`` steps apart, against the plain reverse
    recurrence; a row a source with its resident blocks an SM where its
    library reports them."""
    import torch
    from repro_torch.kernels.ref import rwkv6_scan_bwd_plain
    from repro_torch.kernels.rwkv6_scan import CKPT, rwkv6_scan_checkpoints
    b, t, h, dh = shape or WKV_BWD_CASES[0][1:]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    r, k, v, dy = (torch.randn((b, t, h, dh), generator=gen, device="cuda")
                   for _ in range(4))
    w = torch.exp(-torch.exp(torch.rand(
        (b, t, h, dh), generator=gen, device="cuda") * 3 - 8))
    bonus = torch.randn((h, dh), generator=gen, device="cuda") * 0.1
    s0, ds = (torch.randn((b, h, dh, dh), generator=gen, device="cuda")
              for _ in range(2))
    ckpt = rwkv6_scan_checkpoints(r, k, v, w, bonus, s0)[2]
    outs = [torch.empty_like(r) for _ in range(4)] + [
        torch.empty_like(bonus), torch.empty_like(s0)]
    # the largest scratch any design of the kernel took: dv's row-group
    # partials and du's batch partials
    scratch = torch.empty((dh // 16) * b * t * h * dh + b * h * dh,
                          device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (*(x.data_ptr() for x in (r, k, v, w, bonus, ckpt, dy, ds)),
            *(o.data_ptr() for o in outs), scratch.data_ptr(), b, t, h, dh,
            CKPT, stream)

    def resident(so) -> dict:
        return {"resident_blocks": so.rwkv6_scan_bwd_resident(dh, CKPT)
                if hasattr(so, "rwkv6_scan_bwd_resident") else None}

    variants_in_turns(card, "wkv_bwd_turns", "rwkv6_scan_bwd", sources, args,
                      outs, rwkv6_scan_bwd_plain(r, k, v, w, bonus, s0, dy,
                                                 ds),
                      resident, shape=[b, t, h, dh], checkpoint_every=CKPT)


#: the most blocks the earlier design of ``rmsnorm_bwd`` (per-block
#: dweight partials summed by ``dw_kernel``) ran: its wrapper's grid, one
#: fp32 partial row a block
PARTIALS_BWD_BLOCKS = 1024


def rmsnorm_bwd_call(so, x, w, dy, cast_first: bool):
    """A zero-argument call of one library's ``rmsnorm_bwd_launch`` on
    (x, w, dy) in the given cast order, and its (dx, dw) outputs and
    plan.  A library that exports ``rmsnorm_bwd_smem`` is the ring design
    and takes :func:`repro_torch.kernels.rmsnorm.bwd_plan`'s grid, stage
    rows and stages; any other is the earlier per-block-partials design
    (x, w, dy, dx, dw, partial, rows, d, eps, max_blocks, order, dtype,
    stream), with its wrapper's grid of ``min(1024, rows)`` blocks."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import float_code
    rows, d = x.shape
    code = float_code(x, w, dy)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    fn = so.rmsnorm_bwd_launch
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(so, "rmsnorm_bwd_smem"):
        from repro_torch.kernels.rmsnorm import bwd_plan
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = bwd_plan(d, x.element_size(), sms)
        fn.argtypes = build.KERNELS["rmsnorm_bwd"][2]
        tail = (plan.blocks, plan.rows_per_stage, plan.stages)
        partial = torch.empty(plan.scratch_floats, device=x.device)
        shown = plan._asdict()
    else:
        _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [_P] * 6 + [_I, _I, _F, _I, _I, _I, _P]
        blocks = min(PARTIALS_BWD_BLOCKS, rows)
        tail = (blocks,)
        partial = torch.empty(PARTIALS_BWD_BLOCKS * d, device=x.device)
        shown = {"max_blocks": blocks}
    ptrs = [t.data_ptr() for t in (x, w, dy, dx, dw, partial)]

    def call():
        err = fn(*ptrs, rows, d, 1e-6, *tail, int(cast_first), code, stream)
        check(err == 0, f"launch failed: CUDA error {err}")

    return call, (dx, dw), shown


def rmsnorm_bwd_turns(card: str, sources) -> None:
    """``chip_smoke.py --rmsnorm-bwd-turns SRC...``: each RMSNorm backward
    source built by :func:`build_variants`, then launched through its C
    entry (:func:`rmsnorm_bwd_call`) alone at ``RMS_BWD_TURN_SHAPES`` in
    bf16, cast first (the models' order) and in the TPU kernel's order.
    At each shape and order every source's output is held to autograd of
    the plain version (the errors printed, a failed gate named, nothing
    raised: a probe may compute wrong sums), each launch's device time
    taken from one profiled call, and the sources timed in turns
    (:func:`in_turns`, ``RMS_BWD_TURNS``) beside a yardstick of the same
    bytes, ``torch.add`` of x and dy into a third tensor.  Prints a row a
    source, shape and order (after a row of each source's ptxas lines):
    its plan, errors, launches and turn times, and their median's share
    of the bytes bound."""
    import torch
    from repro_torch.kernels.ref import rmsnorm_bwd_plain
    variants = build_variants("rmsnorm_bwd", sources)
    for src, _, ptxas in variants:
        emit({"phase": "rmsnorm_bwd_turns", "source": source_name(src),
              "ptxas": ptxas, "card": card})
    rate = memory_rate(card)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for rows, d in RMS_BWD_TURN_SHAPES:
        x, dy = (torch.randn((rows, d), generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        w = (1 + 0.3 * torch.randn(d, generator=gen, device="cuda")
             ).bfloat16()
        bound_ms = (3 * x.numel() + 2 * d) * x.element_size() / rate * 1e3
        for cast_first in (True, False):
            exp = rmsnorm_bwd_plain(x, w, dy, cast_first=cast_first)
            calls, rows_out = [], []
            for src, so, _ in variants:
                call, outs, plan = rmsnorm_bwd_call(so, x, w, dy, cast_first)
                for o in outs:
                    o.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                try:
                    errs = [check_grad(g, e, n) for n, g, e in
                            zip(("dx", "dw"), outs, exp)]
                    gate = "passed"
                except AssertionError as fault:
                    errs, gate = None, f"failed: {fault}"
                launches = {row["name"]: row["device_ms"]
                            for row in device_profile(call)[2]}
                calls.append(call)
                rows_out.append({
                    "phase": "rmsnorm_bwd_turns", "source": source_name(src),
                    "shape": [rows, d], "dtype": "bfloat16",
                    "order": "cast-first" if cast_first else "TPU-kernel",
                    "plan": plan, "gate": gate,
                    "errors": errs, "launches_ms": launches})
            del exp
            # a yardstick of the same bytes (x and dy read, one (rows, d)
            # tensor written) that the port never calls: PyTorch's add
            out = torch.empty_like(x)
            calls.append(functools.partial(torch.add, x, dy, out=out))
            rows_out.append({"phase": "rmsnorm_bwd_turns",
                             "source": "yardstick: torch.add(x, dy, out=)",
                             "shape": [rows, d], "dtype": "bfloat16",
                             "order": rows_out[0]["order"]})
            for row, ms in zip(rows_out, in_turns(calls, RMS_BWD_TURNS)):
                med = statistics.median(ms)
                row.update(turn_ms=ms, median_ms=med, bound_ms=bound_ms,
                           bound_share=bound_ms / med, card=card)
                emit(row)


def train_kernels():
    """The wrappers of the training paths' kernels, by kernel name."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_bwd)
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_bwd)
    return {"rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "rwkv6_scan": rwkv6_scan, "rwkv6_scan_bwd": rwkv6_scan_bwd,
            "causal_conv1d": causal_conv1d,
            "causal_conv1d_bwd": causal_conv1d_bwd,
            "selective_scan": selective_scan,
            "selective_scan_bwd": selective_scan_bwd}


def expected_train_launches(cfg, steps: int) -> dict:
    """Launches of each kernel over ``steps`` train steps of a model whose
    superblocks and encoder layers are checkpointed: the forward's norms
    of an rmsnorm model (two a layer, two more with qk-norm in an
    attention layer, rwkv's ln_x a third in an rwkv layer, the final
    norm; a layernorm model launches none) and mixer kernels (flash
    attention for each self, cross and encoder attention, or the WKV
    scan), the layers' again in the recompute, and one backward launch
    of each norm and mixer kernel.  An MLA layer has three norms (norm1,
    the latent's kv_norm, norm2) and one flash attention; a Mamba layer two
    norms, its causal conv and its selective scan."""
    from repro_torch.models.transformer import layer_specs
    specs = layer_specs(cfg)
    mixers = [spec.mixer for spec in specs]
    n_rwkv, n_sub = mixers.count("rwkv"), sum(spec.cross for spec in specs)
    n_mla, n_mamba = mixers.count("mla"), mixers.count("mamba")
    layers = mixers.count("attn") + mixers.count("cross") + cfg.encoder_layers
    n_attn = layers + n_sub + n_mla
    qk = 2 * cfg.use_qk_norm
    # the layers' norms run twice (forward and recompute), the final norms
    # (the model's, the encoder's) once
    norms = ((2 + qk) * layers + (1 + qk) * n_sub + 3 * n_rwkv + 3 * n_mla
             + 2 * n_mamba)
    finals = 1 + bool(cfg.encoder_layers)
    rms = cfg.norm == "rmsnorm"
    return {"rmsnorm": (2 * norms + finals) * steps * rms,
            "rmsnorm_bwd": (norms + finals) * steps * rms,
            "flash_attention": 2 * n_attn * steps,
            "flash_attention_bwd": n_attn * steps,
            "rwkv6_scan": 2 * n_rwkv * steps,
            "rwkv6_scan_bwd": n_rwkv * steps,
            "causal_conv1d": 2 * n_mamba * steps,
            "causal_conv1d_bwd": n_mamba * steps,
            "selective_scan": 2 * n_mamba * steps,
            "selective_scan_bwd": n_mamba * steps}


def phase_bwd_passes() -> None:
    """Each pass of ``flash_attention_bwd`` and each launch of
    ``rmsnorm_bwd`` at the shapes of phase ``kernels``, printed by a
    process of its own (``chip_smoke.py --bwd-passes``,
    :func:`bwd_passes`).  Not in this process: on an H100,
    profiler sessions opened after phase ``train`` saw no device kernel,
    and with five opened before phase ``service`` that phase's trace held
    157 of its 158 tick launches."""
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           "--bwd-passes"], cwd=REPO, timeout=600)
    check(proc.returncode == 0, "the attention backward's passes profiled")


def bwd_passes(card: str) -> None:
    """Each pass of ``flash_attention_bwd`` (``dq_wgmma``,
    ``dkdv_wgmma``, ``dkdv_reduce``; fp32: ``dq_kernel``,
    ``dkdv_kernel``) at the shapes of phase ``kernels``, from one
    profiled call each, with the dK/dV pass's head split and, where it
    splits, one more call without; then ``rmsnorm_bwd``'s two launches
    (the rows pass and the dweight sum) at ``RMS_BWD_CASES`` in the
    cast-first order the models run."""
    import torch
    from repro_torch.kernels.flash_attention import (_forward, bwd_plan,
                                                     flash_attention_bwd)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def short(kernel):   # "void (anonymous namespace)::dq_wgmma<256>(..."
        # (the profiler's names are cut at 60 characters: a template's
        # arguments may be cut off, and then the bare name is kept)
        m = (re.search(r"::(\w+(?:<[^>(]*>)?)\(", kernel)
             or re.search(r"::(\w+)", kernel))
        return m.group(1) if m else kernel

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for label, b, h, g, lq, lk, dim, name, causal in BWD_CASES:
        dtype = getattr(torch, name)
        dk, dv = head_dims(dim)
        q, dout = normal(b, h, lq, dk), normal(b, h, lq, dv)
        k, v = normal(b, g, lk, dk), normal(b, g, lk, dv)
        lse = _forward(q, k, v, causal, None, with_lse=True)[1]
        flash_attention_bwd(q, k, v, dout, lse, causal)  # built and warm

        def passes():
            return {short(row["name"]): row["device_ms"]
                    for row in device_profile(lambda: flash_attention_bwd(
                        q, k, v, dout, lse, causal))[2]}

        splits = (bwd_plan(b, h, g, lq, lk, dk, sms).head_splits
                  if dtype == torch.bfloat16 else 1)
        row = {"phase": "kernels", "kernel": "flash_attention_bwd",
               "case": label, "shape": [b, h, g, lq, lk, dk]
               + ([dv] if dv != dk else []),
               "causal": causal, "dtype": name, "head_splits": splits,
               "passes_ms": passes(),
               "card": card}
        if splits > 1:      # the same call with the group unsplit
            with head_split_off():
                row["passes_ms_split_off"] = passes()
        emit(row)
        del q, k, v, dout, lse

    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    for label, rows, d, name in RMS_BWD_CASES:
        dtype = getattr(torch, name)
        x, dy = (torch.randn((rows, d), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        w = torch.randn(d, generator=gen, device="cuda").to(dtype)
        rmsnorm_bwd(x, w, dy, cast_first=True)      # built and warm
        emit({"phase": "kernels", "kernel": "rmsnorm_bwd", "case": label,
              "shape": [rows, d], "dtype": name, "launches_ms": {
                  short(row["name"]): row["device_ms"]
                  for row in device_profile(lambda: rmsnorm_bwd(
                      x, w, dy, cast_first=True))[2]}, "card": card})
        del x, dy, w


def phase_train(card: str, flops: float, train=TRAIN) -> dict:
    """Training of ``train``'s model at its registered width (gemma-2b:
    18 layers, d 2048, MQA, head dim 256, vocab 256000; rwkv6-1.6b: 24
    layers, d 2048, 32 heads of 64, vocab 65536; whisper-medium: 24 + 24
    layers, d 1024, 16 heads of 64, vocab 51968, its gates and layernorm
    moved by ``awake_params``; bf16, random weights from ``SEED``) on
    batches of 4 x 2048 tokens (whisper: 4 x 1024 tokens and 4 x 4096
    frames) from the port's synthetic stream: the first step's loss and
    gradients on the kernel route against the same step on the plain
    route (``TRAIN_LOSS_REL``, ``TRAIN_GRAD_REL_L2``; the worst leaf
    named; ``ZERO_GRAD_LEAVES`` by their size; every encoder and cross
    leaf non-zero), then ``steps`` steps of
    ``make_train_step`` with ``AdamWConfig()``, the kernels' launch counts
    set to 0 just before them and checked exactly after; prints the step
    time (median of steps 2 on), tokens/s, model TFLOP/s and its share of
    the card's bf16 peak, peak memory, and the idle share of one profiled
    step.  Returns the steps' launch counts."""
    import torch
    from repro_torch import models
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime import steps as step_factories

    cfg = serve_config(train)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=SEED)
    awake = awake_params(params, cfg) if needs_awake(cfg) else None
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = models.params_count(params)
    n_enc = (models.params_count(params["encoder"]) if "encoder" in params
             else 0)
    b, s, frames = train["batch"], train["seq_len"], train.get("frames", 0)
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=s, global_batch=b,
                                          seed=SEED))

    def batch(step):
        out = {k: torch.from_numpy(v).cuda()
               for k, v in stream.batch_at(step).items()}
        if frames:
            out["frames"] = cell_context(cfg, b, frames, SEED + step)
        return out

    # the first step on both routes, no update
    first = batch(0)
    loss_k, grads_k = step_factories.value_and_grad(params, cfg, first)
    with plain_route():
        loss_p, grads_p = step_factories.value_and_grad(params, cfg, first)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    paths = leaf_paths(grads_k)
    split = grad_split(grads_k, grads_p, paths)
    leaf_rel = [rel for path, rel in split["leaves"].items()
                if path not in ZERO_GRAD_LEAVES]
    by_path = {"kernel": dict(zip(paths, tree_leaves(grads_k))),
               "plain": dict(zip(paths, tree_leaves(grads_p)))}
    zero_leaves = {
        path: {route: float(torch.linalg.vector_norm(g[path].float())
                            / torch.linalg.vector_norm(g[yardstick].float()))
               for route, g in by_path.items()}
        for path, yardstick in ZERO_GRAD_LEAVES.items()
        if path in by_path["kernel"]}
    del by_path
    finite = all(bool(torch.isfinite(g).all())
                 for g in tree_leaves(grads_k))
    # every encoder and cross-attention leaf must get a gradient (at the
    # reference's init, gate 0, each would be exactly 0), and every MLA
    # leaf (a latent or rope path the kernels skipped would leave its
    # leaves at 0)
    held = r"/encoder/|/cross/|/gate$" + (
        r"|/mixer/" if cfg.mla or cfg.mamba else "")
    silent = [path for path, g in zip(paths, tree_leaves(grads_k))
              if re.search(held, path) and not bool(g.any())]
    context_leaves = sum(bool(re.search(held, path)) for path in paths)
    del grads_k, grads_p
    emit({"phase": "train", "what": "route equality", "arch": cfg.name,
          "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
          "loss_rel": loss_rel, "awake": awake,
          "context_leaves": context_leaves,
          "context_leaves_zero": silent, "zero_leaves_over_bq": zero_leaves,
          **split, "card": card})
    check(finite and bool(torch.isfinite(loss_k)),
          "finite loss and gradients on the kernel route")
    check(not silent, f"{cfg.name}: every encoder, cross, MLA and Mamba "
          f"leaf has a non-zero gradient ({silent})")
    check(loss_rel <= TRAIN_LOSS_REL,
          f"{cfg.name} train loss: kernel vs plain {loss_rel} <= "
          f"{TRAIN_LOSS_REL}")
    grad_limit = TRAIN_GRAD_REL_L2[train["arch"]]
    check(max(leaf_rel) <= grad_limit,
          f"{cfg.name} gradients: kernel vs plain relative L2 "
          f"{max(leaf_rel)} <= {grad_limit}")
    check(all(v <= ZERO_LEAF_SHARE for r in zero_leaves.values()
              for v in r.values()),
          f"{cfg.name}: the gradients that are 0 in exact arithmetic stay "
          f"within {ZERO_LEAF_SHARE} of the query bias's ({zero_leaves})")
    if cfg.rwkv is not None:
        route_equality_fp32(card, train)

    opt_cfg = AdamWConfig()
    opt_state = init_state(opt_cfg, params)
    step_fn = step_factories.make_train_step(cfg, opt_cfg)
    batches = [batch(i) for i in range(train["steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in train_kernels().values():
        fn.launches = 0
    losses, times = [], []
    for i in range(train["steps"]):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batches[i])
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in train_kernels().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = expected_train_launches(cfg, train["steps"])
    check(launches == expected,
          f"{cfg.name} train: launch counts {launches} == {expected}")
    check(all(map(math.isfinite, losses)), "finite train losses")
    step_s = statistics.median(times[1:])
    tokens = b * s
    specs = models.layer_specs(cfg)
    mixers = [spec.mixer for spec in specs]
    n_attn = mixers.count("attn") + mixers.count("mla")
    n_cross = sum(spec.cross for spec in specs)
    pairs = (n_attn * attention_pairs(s, s, True)
             + n_cross * attention_pairs(s, frames, False)
             + cfg.encoder_layers * attention_pairs(frames, frames, False))
    # the (q and k, v) head dims: MLA's pair or the GQA head's twice
    dk, dv = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
               cfg.mla.v_head_dim) if cfg.mla else (cfg.kv_head_dim(),) * 2)
    attn = 6 * (dk + dv) * b * cfg.n_heads * pairs
    model_flops = (6 * (n_params - n_enc) * tokens + 6 * n_enc * b * frames
                   + attn)
    wall, busy, top = device_profile(lambda: step_fn(
        params, opt_state, batches[0]))
    # the reference's nominal length: whisper's frames (its decoder takes a
    # quarter of them)
    analytic_line(card, "train", cfg, "step", "train", b, frames or s,
                  step_s)
    emit({"phase": "train", "arch": cfg.name, "params": n_params,
          "dtype": cfg.dtype, "init_seconds": init_s, "batch": b,
          "seq_len": s, "steps": train["steps"], "losses": losses,
          "step_seconds": times, "step_ms": step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "model_flops_per_step": model_flops,
          "frames": frames or None,
          "model_flops_formula": "6*N_dec*T + 6*N_enc*B*F + 6*(Dqk+Dv)*B*"
                                 "Hq*(L_attn*causal_pairs(S) + L_cross*S*F"
                                 " + L_enc*F*F); recompute not counted; the "
                                 "WKV recurrence's flops (about 0.5 % of "
                                 "6*N*T at rwkv6-1.6b) not counted",
          "model_tflops": model_flops / step_s / 1e12,
          "model_flops_share": model_flops / step_s / flops,
          "peak_gib": peak, "launches": launches,
          "launches_per_step": {k: v // train["steps"]
                                for k, v in launches.items()},
          "profiled_step_s": wall, "profiled_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall, "top": top[:10],
          # the attention backward's passes in the profiled step
          "attention_bwd_passes": [
              r for r in top if re.search(
                  r"dq_wgmma|dkdv_wgmma|dkdv_reduce|dq_kernel|dkdv_kernel",
                  r["name"])],
          # the WKV's: the forward, the backward's cluster launch and its
          # batch sum of du
          "wkv_passes": [r for r in top if re.search(
              r"wkv_kernel|wkv_bwd_kernel|wkv_bwd_du", r["name"])],
          # Mamba's: the conv and the scan, their backward kernels and
          # the backward's fixed-order sums
          "mamba_passes": [r for r in top if re.search(
              r"conv_kernel|conv_bwd|scan_kernel|scan_bwd", r["name"])],
          "card": card})
    del params, opt_state, batches, step_fn
    torch.cuda.empty_cache()
    return launches


def grad_split(got, exp, paths) -> dict:
    """Each gradient leaf's relative L2 distance from the reference's, the
    largest (and its leaf) and the median; and per stacked layer (the
    leaves under ``/blocks``, split on their leading axis) the largest
    distance of its leaves, its leaf, and their median."""
    import torch
    from repro_torch.models.common import tree_leaves

    def rel(a, e):
        return float(torch.linalg.vector_norm((a - e).float())
                     / torch.linalg.vector_norm(e.float()).clamp_min(1e-30))

    leaves, layers = {}, {}
    for path, a, e in zip(paths, tree_leaves(got), tree_leaves(exp)):
        leaves[path] = rel(a, e)
        if path.startswith("/blocks"):
            for i in range(a.shape[0]):
                layers.setdefault(i, []).append((rel(a[i], e[i]), path))
    worst = max(leaves, key=leaves.get)
    return {"grad_rel_l2_max": leaves[worst],
            "grad_rel_l2_worst_leaf": worst,
            "grad_rel_l2_median": statistics.median(leaves.values()),
            "grad_rel_l2_by_layer_max": [max(v)[0] for v in layers.values()],
            "grad_rel_l2_by_layer_worst_leaf": [max(v)[1]
                                                for v in layers.values()],
            "grad_rel_l2_by_layer_median": [
                statistics.median(x for x, _ in v) for v in layers.values()],
            "leaves": leaves}


def train_route_split(card: str) -> None:
    """Where rwkv6-1.6b's first-step gradients part between the routes
    (``chip_smoke.py --train-route-split``, a process of its own): the
    kernel route, then the WKV kernel alone (the norms plain) and the
    norm kernels alone (the WKV plain), each against the plain route, in
    bf16 at ``TRAIN_RWKV``'s batch, per leaf and per stacked layer
    (``grad_split``)."""
    import torch
    from repro_torch import models
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as norm
    from repro_torch.runtime import steps as step_factories
    cfg = get(TRAIN_RWKV["arch"])
    params = models.init_params(cfg, seed=SEED)
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_RWKV["seq_len"],
        global_batch=TRAIN_RWKV["batch"], seed=SEED))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch_at(0).items()}
    paths = leaf_paths(params)
    with plain_route():
        loss_p, grads_p = step_factories.value_and_grad(params, cfg, batch)
        plain_wkv, plain_norm = ops.rwkv6_scan, norm.rmsnorm
    for label, wkv_plain, norm_plain in (("kernel route", False, False),
                                         ("WKV kernel alone", False, True),
                                         ("norm kernels alone", True, False)):
        saved = ops.rwkv6_scan, norm.rmsnorm
        if wkv_plain:
            ops.rwkv6_scan = plain_wkv
        if norm_plain:
            norm.rmsnorm = plain_norm
        try:
            loss, grads = step_factories.value_and_grad(params, cfg, batch)
        finally:
            ops.rwkv6_scan, norm.rmsnorm = saved
        emit({"phase": "train", "what": "route split", "arch": cfg.name,
              "route": label, "loss_rel": abs(float(loss) - float(loss_p))
              / abs(float(loss_p)), **grad_split(grads, grads_p, paths),
              "card": card})
        del grads


#: kernel names of the step profile by kind: matrix products, the port's
#: hand-written kernels, and the rest (PyTorch's elementwise passes,
#: reductions and copies)
STEP_KINDS = (("matmul", r"gemm|cutlass|xmma|nvjet|sm90_"),
              ("port kernel", r"conv_kernel|conv_bwd|scan_kernel|scan_bwd|"
                              r"rms|flash|dq_|dkdv|decode_kernel"),
              ("elementwise and other", r""))


def step_kind(name: str) -> str:
    return next(kind for kind, pattern in STEP_KINDS
                if re.search(pattern, name))


def split_profile(fn, ranges=()) -> dict:
    """``fn()`` under the torch profiler: the wall and busy ms, the device
    ms of each kernel kind (``STEP_KINDS``), the top 12 kernels by device
    time, and for each ``record_function`` range named in ``ranges`` the
    device ms of the kernels inside the span the profiler mirrors it to
    on the device's timeline (in a step, a range around a forward
    function holds its forward only: autograd runs the backward
    later)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation]
    spans = {name: [(ev.time_range.start, ev.time_range.end)
                    for ev in events if ev.device_type == DeviceType.CUDA
                    and ev.is_user_annotation and ev.name == name]
             for name in ranges}
    kinds, by_range = collections.Counter(), collections.Counter()
    for ev in kernels:
        us = ev.time_range.end - ev.time_range.start
        kinds[step_kind(ev.name)] += us / 1e3
        for name, s in spans.items():
            if any(a <= ev.time_range.start < b for a, b in s):
                by_range[name] += us / 1e3
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and not ev.is_user_annotation
                   and ev.self_device_time_total > 0), reverse=True)
    return {"wall_ms": wall * 1e3,
            "busy_ms": sum(kinds.values()), "by_kind_ms": dict(kinds),
            "ranges_ms": {n: by_range[n] for n in ranges},
            "range_spans": {n: len(s) for n, s in spans.items()},
            "top": [{"name": k[:70], "device_ms": us / 1e3, "calls": c,
                     "kind": step_kind(k)} for us, k, c in rows[:12]]}


def jamba_step_split(card: str) -> None:
    """``chip_smoke.py --jamba-step-split``: where jamba-1.5-large-398b's
    first-layer training step (``TRAIN_JAMBA``) spends its device time.
    One profiled step with ``record_function`` ranges around AdamW's
    update (``adamw.apply_updates``: all of it), the loss head
    (``transformer._chunked_ce``) and the Mamba chain
    (``mamba.mamba_apply``: their forward, and the forward recomputed by
    the checkpoints), then each part's forward and backward profiled
    alone: AdamW's update, the loss head on the final hidden states
    (norm's output), the Mamba layer from its input (its forward twice,
    as the checkpointed step runs it).  Each profile gives its kernels'
    ms by kind and its top kernels, so each row of the step's profile
    can be traced to its source."""
    import torch
    from torch.profiler import record_function
    from repro_torch import models
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw, init_state
    from repro_torch.runtime import steps as step_factories

    train = TRAIN_JAMBA
    cfg = serve_config(train)
    params = models.init_params(cfg, seed=SEED)
    awake_params(params, cfg)
    b, s = train["batch"], train["seq_len"]
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=s, global_batch=b,
                                          seed=SEED))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch_at(0).items()}
    opt_cfg = AdamWConfig()
    opt_state = init_state(opt_cfg, params)
    step_fn = step_factories.make_train_step(cfg, opt_cfg)
    for _ in range(2):
        params, opt_state, _ = step_fn(params, opt_state, batch)
    torch.cuda.synchronize()

    originals = {"adamw": (adamw, "apply_updates"),
                 "loss": (transformer, "_chunked_ce"),
                 "mamba": (mamba_mod, "mamba_apply")}

    def ranged(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    saved = {name: getattr(mod, attr)
             for name, (mod, attr) in originals.items()}
    try:
        for name, (mod, attr) in originals.items():
            setattr(mod, attr, ranged(name, saved[name]))
        step = split_profile(lambda: step_fn(params, opt_state, batch),
                             tuple(originals))
    finally:
        for name, (mod, attr) in originals.items():
            setattr(mod, attr, saved[name])

    _, grads = step_factories.value_and_grad(params, cfg, batch)
    parts = {"adamw update": split_profile(lambda: adamw.apply_updates(
        opt_cfg, params, grads, opt_state))}
    del grads
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
        params["final_norm"]["scale"].dtype)
    head = [params["embed"] if cfg.tie_embeddings else params["lm_head"]]

    def loss_part():
        x = h.detach().requires_grad_(True)
        for p in head:
            p.requires_grad_(True)
        loss = transformer._chunked_ce(params, cfg, x, batch["labels"])
        torch.autograd.grad(loss, [x] + head)
        for p in head:
            p.requires_grad_(False)

    parts["loss head, forward and backward"] = split_profile(loss_part)

    def find_mixer(tree):
        if isinstance(tree, dict):
            if "a_log" in tree:
                return tree
            for v in tree.values():
                got = find_mixer(v)
                if got is not None:
                    return got
        return None

    mixer = find_mixer(params)
    if mixer["a_log"].ndim == 3:   # stacked layers: the first
        mixer = {k: v[0] for k, v in mixer.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in mixer.items()}
    dy = torch.randn_like(h)

    def mamba_part():
        x = h.detach().requires_grad_(True)
        mamba_mod.mamba_apply(leaves, cfg, x)   # the checkpoint's pass
        y, _ = mamba_mod.mamba_apply(leaves, cfg, x)
        torch.autograd.grad(y, [x] + list(leaves.values()), dy)

    parts["mamba layer, forward twice and backward"] = split_profile(
        mamba_part)
    emit({"phase": "jamba step split", "arch": cfg.name,
          "batch": b, "seq_len": s,
          "params": models.params_count(params), "step": step,
          "parts": parts, "card": card})


def route_equality_fp32(card: str, train) -> None:
    """``train``'s model at its registered width in fp32 (``TRAIN_FP32``'s
    batch, random weights from ``SEED``): the first step's gradients on
    the kernel route within ``TRAIN_FP32_GRAD_REL_L2`` of the plain
    route's, leaf by leaf, and the worst leaf named."""
    import torch
    from repro_torch import models
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.runtime import steps as step_factories
    cfg = dataclasses.replace(get(train["arch"]), dtype="float32")
    params = models.init_params(cfg, seed=SEED)
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_FP32["seq_len"],
        global_batch=TRAIN_FP32["batch"], seed=SEED))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch_at(0).items()}
    loss_k, grads_k = step_factories.value_and_grad(params, cfg, batch)
    with plain_route():
        loss_p, grads_p = step_factories.value_and_grad(params, cfg, batch)
    split = grad_split(grads_k, grads_p, leaf_paths(grads_k))
    del params, grads_k, grads_p
    torch.cuda.empty_cache()
    emit({"phase": "train", "what": "route equality fp32", "arch": cfg.name,
          "batch": TRAIN_FP32["batch"], "seq_len": TRAIN_FP32["seq_len"],
          "loss_rel": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
          **split, "card": card})
    check(split["grad_rel_l2_max"] <= TRAIN_FP32_GRAD_REL_L2,
          f"{cfg.name} fp32 gradients: kernel vs plain relative L2 "
          f"{split['grad_rel_l2_max']} <= {TRAIN_FP32_GRAD_REL_L2}")


def leaf_paths(tree, prefix="") -> list:
    """The ``/``-joined key path of each leaf of a nested dict, in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}/{k}")]
    return [prefix]


def train_loop_on_card(card: str) -> None:
    """The trainer on the card at ``TRAIN_LOOP``'s smoke config: a run
    that crashes at ``crash_at`` and resumes from its last checkpoint
    gives the losses of an uninterrupted run (rtol 1e-4); then the
    training CLI for 3 steps.  Checkpoints go under ``build/``."""
    import contextlib
    import io
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    cfg = smoke_config(TRAIN_LOOP["arch"])
    loop = TrainLoopConfig(total_steps=TRAIN_LOOP["steps"],
                           checkpoint_every=TRAIN_LOOP["every"])
    root = REPO / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    straight = run_training(cfg, loop, root / "straight")
    try:
        run_training(cfg, loop, root / "resumed",
                     crash_at_step=TRAIN_LOOP["crash_at"])
        check(False, "the injected crash was raised")
    except RuntimeError as exc:
        check("injected crash" in str(exc), f"injected crash ({exc})")
    resumed = run_training(cfg, loop, root / "resumed")
    seconds = time.perf_counter() - t0
    resume_at = (TRAIN_LOOP["crash_at"] // TRAIN_LOOP["every"]
                 * TRAIN_LOOP["every"])
    worst = max(abs(a - b) / abs(b) for a, b in zip(
        resumed.losses, straight.losses[resume_at:]))
    check(resumed.resumed_from == resume_at
          and len(resumed.losses) == TRAIN_LOOP["steps"] - resume_at,
          f"resumed from {resumed.resumed_from}")
    check(worst <= 1e-4, f"resumed losses reproduce the straight run "
          f"({worst})")
    check(straight.losses[-1] < straight.losses[0] - 0.5,
          "the smoke loss drops")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", TRAIN_LOOP["arch"], "--smoke",
                           "--steps", "3", "--ckpt-dir",
                           str(root / "cli")])
    summary = out.getvalue().strip()
    check("steps_run=3" in summary, f"the training CLI ran ({summary})")
    emit({"phase": "train", "what": "train loop", "arch": cfg.name,
          "steps": TRAIN_LOOP["steps"], "crash_at": TRAIN_LOOP["crash_at"],
          "resumed_from": resumed.resumed_from,
          "first_loss": straight.losses[0],
          "last_loss": straight.losses[-1],
          "resumed_rel_diff_max": worst, "seconds": seconds,
          "stragglers": straight.straggler_events, "cli": summary,
          "card": card})
    shutil.rmtree(root, ignore_errors=True)


class flash_recorder:
    """Inside ``with flash_recorder() as rec:`` every call of the models'
    ``ops.flash_attention`` is counted by its causal flag
    (``rec.causal``) and the first call's output is kept
    (``rec.first``)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved, self.first = ops.flash_attention, None
        self.causal = collections.Counter()

        def call(q, k, v, causal=True, *args, **kwargs):
            out = self.saved(q, k, v, causal, *args, **kwargs)
            if self.first is None:
                self.first = out
            self.causal["causal" if causal else "non_causal"] += 1
            return out

        ops.flash_attention = call
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self.saved
        return False


def rel_l2(got, exp, dim=None):
    """Relative L2 distance of ``got`` from ``exp`` in fp32 (over ``dim``,
    or over the whole tensor)."""
    import torch
    got, exp = got.float(), exp.float()
    return (torch.linalg.vector_norm(got - exp, dim=dim)
            / torch.linalg.vector_norm(exp, dim=dim))


def tp_reference(card: str) -> dict:
    """The one-rank port's batched request on ``SERVE_TP``'s model (the
    phase's reference): the prompt tokens, the vision embeddings, the
    logits and greedy tokens (``batched_request``), and each rank's heads
    of the first layer's attention output, written to ``TP_DIR`` for the
    ranks; the card's memory is freed before they start."""
    import torch
    from repro_torch import models
    from repro_torch.configs.registry import _ctx_len
    from repro_torch.launch.serve import batched_request

    torch.cuda.empty_cache()
    system, _ = serving_system(SERVE_TP)
    cfg, n = system.cfg, len(system.agents)
    params = models.init_params(cfg, seed=SEED)
    awake_params(params, cfg)
    contexts = [system.context_tokens(i) for i in range(n)]
    p = min(len(c) for c in contexts)
    context = cell_context(cfg, n, _ctx_len(cfg, SERVE_TP["artifacts"]
                                            * SERVE_TP["artifact_tokens"]),
                           SEED)
    with flash_recorder() as rec:
        out = batched_request(system, params, SERVE_TP["decode_steps"],
                              context=context)
    check(out["prompt_len"] == p, "the reference's prompt length")
    torch.save({"tokens": torch.tensor([c[:p] for c in contexts]),
                "context": context.cpu(), "logits": out["logits"].cpu(),
                "greedy": out["tokens"].cpu()}, TP_DIR / "reference.pt")
    heads = cfg.n_heads // SERVE_TP["tp"]
    for r in range(SERVE_TP["tp"]):
        torch.save(rec.first[:, r * heads:(r + 1) * heads].cpu(),
                   TP_DIR / f"attention{r}.pt")
    del params, out, rec, context
    torch.cuda.empty_cache()
    return {"agents": n, "prompt_len": p}


def draw_shard(cfg, mesh) -> dict:
    """This rank's shard of ``cfg``'s params over the mesh's 'model' axis,
    drawn leaf by leaf on its card from ``SEED``, so that no process
    holds the whole model (llama-3.2-vision-90b's 87.7 B do not fit one
    card): each leaf's block shape from ``shard_params`` of a meta tree,
    each block from a generator seeded by the seed, the leaf's index and
    the rank's index on 'model' (0 for a leaf every rank holds whole, so
    those are equal on every rank; a K / V head is never held by two
    ranks here, 8 heads over 4): norm scales 1, cross gates
    ``CROSS_GATE`` (as ``awake_params`` sets them), the embedding and the
    head N(0, 0.02^2) and every other weight N(0, 1 / d_in), d_in its
    whole input width, as ``init_params`` draws them."""
    import torch
    from repro_torch import models
    from repro_torch.launch.mesh import axis_group
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import tensor_parallel as tp

    whole = dict(shd.flatten_with_paths(models.init_params(cfg,
                                                           device="meta")))
    local = tp.shard_params(cfg, models.init_params(cfg, device="meta"),
                            mesh)
    index = axis_group(mesh).index
    dev = torch.device("cuda", torch.cuda.current_device())
    drawn = {}
    for i, (path, x) in enumerate(shd.flatten_with_paths(local)):
        leaf = path.rsplit("/", 1)[-1]
        block = index if x.shape != whole[path].shape else 0
        if leaf == "scale":
            drawn[path] = torch.ones(x.shape, dtype=x.dtype, device=dev)
        elif leaf == "gate":
            drawn[path] = torch.full(x.shape, CROSS_GATE, dtype=x.dtype,
                                     device=dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(
                SEED + 7919 * i + 104729 * block)
            std = (0.02 if leaf in ("embed", "lm_head")
                   else whole[path].shape[-2] ** -0.5)
            drawn[path] = torch.randn(x.shape, generator=gen, device=dev
                                      ).mul_(std).to(x.dtype)
    return shd.unflatten_like(local, drawn)


def serve_tp_rank(card: str, mode: str, rank: int, world: int, port: int,
                  backend: str) -> None:
    """One rank of phase ``serve_tp`` (its own process, ``chip_smoke.py
    --serve-tp-rank MODE RANK WORLD PORT BACKEND``): a (data 1, model
    ``world``) mesh over ``backend`` (gloo: every rank on card 0; nccl:
    rank r on card r), the params of ``mode`` "check" (``SERVE_TP``'s
    model drawn whole from ``SEED``, awake, then ``shard_params``) or
    "full" (``SERVE_TP_FULL``'s, :func:`draw_shard`), the reference's
    request through ``make_prefill_step`` and ``make_decode_step`` over
    the mesh (check: the decode steps fed the reference's greedy tokens;
    full: then ``TP_PROFILED_STEPS`` more under the profiler, and the time
    of one ``all_reduce`` over 'model' of a prefill's and of a decode
    step's residual stream); writes its result to ``TP_DIR``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import models
    from repro_torch.launch.mesh import axis_group
    from repro_torch.runtime import steps as step_factories
    from repro_torch.runtime import tensor_parallel as tp

    serve = SERVE_TP if mode == "check" else SERVE_TP_FULL
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, **({"device_id": dev} if backend == "nccl" else {}))
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        cfg = serve_config(serve)
        ref = torch.load(TP_DIR / "reference.pt")
        tokens, context = ref["tokens"].to(dev), ref["context"].to(dev)
        b, p = tokens.shape
        steps = serve["decode_steps"]
        t0 = time.perf_counter()
        if mode == "check":
            params = models.init_params(cfg, seed=SEED)
            awake_params(params, cfg)
            local = tp.shard_params(cfg, params, mesh)
            del params
        else:
            local = draw_shard(cfg, mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        extra = TP_PROFILED_STEPS if mode == "full" else 0
        cache = tp.init_cache(cfg, b, p + steps + extra,
                              ctx_len=context.shape[1], mesh=mesh)
        prefill = step_factories.make_prefill_step(cfg, mesh)
        decode = step_factories.make_decode_step(cfg, mesh)
        for fn in model_kernels().values():
            fn.launches = 0
        with flash_recorder() as rec:
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            logits, cache = prefill(local, {"tokens": tokens,
                                            "vision_embeds": context}, cache)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, greedy = [logits], []
            for t in range(steps):
                nxt = torch.argmax(logits[:, -1], dim=-1)
                greedy.append(nxt)
                feed = ref["greedy"][:, t].to(dev) if mode == "check" else nxt
                logits, cache = decode(local, feed[:, None], cache)
                out.append(logits)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        logits, greedy = torch.cat(out, dim=1), torch.stack(greedy, dim=1)
        result = {"rank": rank, "backend": backend, "card": card,
                  "device": str(dev), "n_layers": cfg.n_layers,
                  "batch": b, "prompt_len": p, "steps": steps,
                  "params": models.params_count(local),
                  "init_seconds": init_s, "prefill_seconds": t1 - t0,
                  "decode_seconds": t2 - t1,
                  "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                  "finite": bool(torch.isfinite(logits).all()),
                  "launches": {name: fn.launches for name, fn in
                               model_kernels().items() if fn.launches},
                  "flash_calls": dict(rec.causal),
                  "greedy_first": greedy[:, :8].tolist()}
        if mode == "full":
            def more_steps():
                nonlocal logits, cache
                for _ in range(extra):
                    logits, cache = decode(
                        local, torch.argmax(logits[:, -1], dim=-1)[:, None],
                        cache)

            logits = out[-1]
            wall, busy, top = device_profile(more_steps)
            result["decode_profile"] = {
                "steps": extra, "wall_s": wall, "device_busy_s": busy,
                "device_idle_share": 1.0 - busy / wall, "top": top[:8]}
            group = axis_group(mesh).group
            result["all_reduce_ms"] = {
                what: all_reduce_ms(torch.zeros(
                    shape, dtype=context.dtype, device=dev), group)
                for what, shape in (("prefill", (b, p, cfg.d_model)),
                                    ("decode", (b, 1, cfg.d_model)))}
        if mode == "check":
            want = torch.load(TP_DIR / f"attention{rank}.pt").to(dev)
            by_step = rel_l2(logits, ref["logits"].to(dev), dim=-1
                             ).max(dim=0).values
            result.update(
                attention_rel_l2=float(rel_l2(rec.first, want)),
                logits_rel_l2=float(by_step[0]),
                logits_rel_l2_max_decode_step=float(by_step[1:].max()),
                logits_rel_l2_by_step=by_step.tolist(),
                greedy_differing=int((greedy.cpu() != ref["greedy"]).sum()),
                greedy_tokens=greedy.numel())
        (TP_DIR / f"{mode}{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def all_reduce_ms(x, group, reps: int = 10) -> float:
    """Host-clock ms of one ``all_reduce`` of ``x`` over ``group`` (every
    rank calls it), the mean of ``reps`` after one warm call."""
    import torch
    import torch.distributed as dist
    dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def run_tp_ranks(mode: str, world: int, backend: str) -> list:
    """Starts ``world`` ranks of phase ``serve_tp`` (:func:`serve_tp_rank`),
    each its own process logging to ``TP_DIR``, and joins them all: every
    rank is killed at ``TP_DEADLINE_S[mode]`` or once one rank has failed.
    A rank that fails fails the run (the end of its log on stderr).
    Returns each rank's result."""
    import os
    import socket
    with socket.socket() as sock:          # a free port for the store
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    sys.stdout.flush()
    procs = []
    try:
        for r in range(world):
            with open(TP_DIR / f"{mode}{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(REPO / "chip_smoke.py"),
                     "--serve-tp-rank", mode, str(r), str(world), str(port),
                     backend], cwd=REPO, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + TP_DEADLINE_S[mode]
        while (time.monotonic() < deadline
               and any(proc.poll() is None for proc in procs)
               and all(proc.poll() in (None, 0) for proc in procs)):
            time.sleep(1.0)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    failed = [r for r, proc in enumerate(procs) if proc.returncode != 0]
    for r in failed:
        tail = (TP_DIR / f"{mode}{r}.log").read_text()[-4000:]
        print(f"serve_tp {mode} rank {r} exited {procs[r].returncode}:\n"
              f"{tail}", file=sys.stderr)
    check(not failed, f"serve_tp {mode}: every rank ran to its end")
    return [json.loads((TP_DIR / f"{mode}{r}.json").read_text())
            for r in range(world)]


def phase_serve_tp(card: str) -> dict:
    """Tensor-parallel serving (module docstring, phase ``serve_tp``):
    the one-rank reference, then ``SERVE_TP``'s ranks (two gloo ranks on
    card 0 on one card, else one rank a card over NCCL) held to it; on a
    host with 4 cards also ``SERVE_TP_FULL`` over NCCL.  Returns the
    model kernels' launches summed over the ranks."""
    import torch
    from repro_torch.models import layer_specs
    cards = torch.cuda.device_count()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    ref = tp_reference(card)
    cfg = serve_config(SERVE_TP)
    steps = SERVE_TP["decode_steps"]
    ranks = run_tp_ranks("check", SERVE_TP["tp"],
                         "nccl" if cards >= 2 else "gloo")
    expected = expected_launches(cfg, 1, steps)
    expected = {k: v for k, v in expected.items() if v}
    cross = sum(spec.mixer == "cross" for spec in layer_specs(cfg))
    calls = {"causal": cfg.n_layers - cross, "non_causal": cross}
    emit({"phase": "serve_tp", "arch": cfg.name, "n_layers": cfg.n_layers,
          "tp": SERVE_TP["tp"], "backend": ranks[0]["backend"],
          "agents": ref["agents"], "prompt_len": ref["prompt_len"],
          "ranks": ranks, "expected_launches": expected,
          "expected_flash_calls": calls,
          "attention_gate": TP_ATTENTION_REL_L2,
          "logits_gates": TP_LOGITS_REL_L2,
          "note": "ranks sharing one card time-slice it: their seconds "
                  "say nothing of tensor-parallel speed", "card": card})
    for r in ranks:
        check(r["finite"], f"serve_tp rank {r['rank']}: finite logits")
        check(r["launches"] == expected,
              f"serve_tp rank {r['rank']}: launches {r['launches']} == "
              f"{expected}")
        check(r["flash_calls"] == calls,
              f"serve_tp rank {r['rank']}: flash calls {r['flash_calls']} "
              f"== {calls}")
        check(r["attention_rel_l2"] <= TP_ATTENTION_REL_L2,
              f"serve_tp rank {r['rank']}: first attention output vs the "
              f"one-rank slice {r['attention_rel_l2']} <= "
              f"{TP_ATTENTION_REL_L2}")
        check(r["logits_rel_l2"] <= TP_LOGITS_REL_L2[0],
              f"serve_tp rank {r['rank']}: prefill logits vs one rank "
              f"{r['logits_rel_l2']} <= {TP_LOGITS_REL_L2[0]}")
        check(r["logits_rel_l2_max_decode_step"] <= TP_LOGITS_REL_L2[1],
              f"serve_tp rank {r['rank']}: decode logits vs one rank "
              f"{r['logits_rel_l2_max_decode_step']} <= "
              f"{TP_LOGITS_REL_L2[1]}")
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    if cards >= 4:
        topo, nvlink = (subprocess.run(["nvidia-smi", *args],
                                       capture_output=True, text=True,
                                       timeout=60)
                        for args in (("topo", "-m"), ("nvlink", "-s")))
        full_cfg = serve_config(SERVE_TP_FULL)
        full = run_tp_ranks("full", SERVE_TP_FULL["tp"], "nccl")
        expected = {k: v for k, v in
                    expected_launches(full_cfg, 1, steps).items() if v}
        for r in full:
            check(r["finite"], f"serve_tp full rank {r['rank']}: finite "
                  f"logits")
            check(r["launches"] == expected,
                  f"serve_tp full rank {r['rank']}: launches "
                  f"{r['launches']} == {expected}")
        slowest = {k: max(r[k] for r in full)
                   for k in ("prefill_seconds", "decode_seconds")}
        b, p = full[0]["batch"], full[0]["prompt_len"]
        emit({"phase": "serve_tp", "what": "full depth",
              "arch": full_cfg.name, "n_layers": full_cfg.n_layers,
              "tp": SERVE_TP_FULL["tp"], "backend": "nccl",
              "params_per_rank": [r["params"] for r in full],
              "prefill_tokens_per_s": b * p / slowest["prefill_seconds"],
              "decode_tokens_per_s": b * steps / slowest["decode_seconds"],
              "decode_ms_per_step": slowest["decode_seconds"] / steps * 1e3,
              **slowest, "peak_gib": [r["peak_gib"] for r in full],
              "init_seconds": [r["init_seconds"] for r in full],
              "launches_per_rank": full[0]["launches"],
              "flash_calls": full[0]["flash_calls"],
              "greedy_first": full[0]["greedy_first"],
              "decode_profile": full[0]["decode_profile"],
              "all_reduce_ms": full[0]["all_reduce_ms"],
              "topology": topo.stdout or topo.stderr,
              "nvlink": nvlink.stdout or nvlink.stderr, "card": card})
        for r in full:
            launches.update(r["launches"])
    return dict(launches)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import build, chunk_diff, mesi_transition as mt

    card = card_line()
    if sys.argv[1:] == ["--bwd-passes"]:   # phase_bwd_passes' own process
        bwd_passes(card)
        return 0
    if sys.argv[1:2] == ["--serve-tp-rank"]:  # a rank of phase serve_tp
        mode, rank, world, port, backend = sys.argv[2:7]
        serve_tp_rank(card, mode, int(rank), int(world), int(port), backend)
        return 0
    if sys.argv[1:] == ["--train-route-split"]:
        train_route_split(card)
        return 0
    if sys.argv[1:] == ["--jamba-step-split"]:
        jamba_step_split(card)
        return 0
    if sys.argv[1:2] == ["--rmsnorm-bwd-turns"]:
        rmsnorm_bwd_turns(card, sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--mamba-turns"]:
        mamba_turns(card, sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--mamba-bwd-variants"]:
        mamba_bwd_variants(card, sys.argv[2], sys.argv[3:])
        return 0
    if sys.argv[1:2] == ["--sass"]:
        sass_counts(card, sys.argv[2], sys.argv[3:])
        return 0
    if sys.argv[1:2] == ["--wkv-bwd-turns"]:
        args = sys.argv[2:]
        shape = None
        if args[:1] == ["--shape"]:
            shape = tuple(int(x) for x in args[1].split(","))
            args = args[2:]
        wkv_bwd_turns(card, args, shape)
        return 0
    seconds, since = {}, [time.perf_counter()]

    def lap(name: str) -> None:     # each phase's wall seconds
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - since[0]
        since[0] = now

    rate, flops = memory_rate(card), bf16_rate(card)
    fp32_flops = fp32_rate(card)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "memory_bytes_per_s": rate, "bf16_flops_per_s": flops,
          "fp32_flops_per_s": fp32_flops})
    phase_build(card)
    lap("build")
    kernels = phase_kernels(card, rate)
    system, _ = serving_system()
    contexts = [len(system.context_tokens(i))
                for i in range(len(system.agents))]
    kernels.update(phase_model_kernels(card, rate, flops, fp32_flops,
                                       contexts))
    kernels.update(phase_train_kernels(card, rate, flops, fp32_flops))
    lap("kernels")

    mt.mesi_tick_.launches = 0
    chunk_diff.chunk_tick_.launches = 0
    phase_scenarios(card)
    fleet_seconds = phase_fleet(card)
    launches = {"mesi_tick": mt.mesi_tick_.launches,
                "chunk_tick": chunk_diff.chunk_tick_.launches}
    lap("scenarios and fleet")

    mt.mesi_tick_.launches = 0
    chunk_diff.chunk_tick_.launches = 0
    phase_service(card)
    launches["mesi_tick"] += mt.mesi_tick_.launches
    launches["chunk_tick"] += chunk_diff.chunk_tick_.launches
    lap("service")

    mt.mesi_tick_.launches = 0
    chunk_diff.chunk_tick_.launches = 0
    phase_fleet_sharded(card)
    launches["mesi_tick"] += mt.mesi_tick_.launches
    launches["chunk_tick"] += chunk_diff.chunk_tick_.launches
    lap("fleet_sharded")

    for serve in (SERVE, SERVE_RWKV, SERVE_MOE, SERVE_WHISPER, SERVE_VLM,
                  SERVE_DEEPSEEK, SERVE_JAMBA):
        for fn in model_kernels().values():
            fn.launches = 0
        for name, count in phase_serve(card, serve).items():
            launches[name] = launches.get(name, 0) + count
        torch.cuda.empty_cache()
        lap(SERVE_PHASES[serve["arch"]])
    for train in (TRAIN, TRAIN_RWKV, TRAIN_WHISPER, TRAIN_DEEPSEEK,
                  TRAIN_JAMBA):
        for name, count in phase_train(card, flops, train).items():
            launches[name] = launches.get(name, 0) + count
        lap(f"train {train['arch']}")
    train_loop_on_card(card)
    phase_bwd_passes()
    check(set(kernels) == set(launches) == set(REPLACES)
          == set(build.KERNELS) and all(v > 0 for v in launches.values()),
          "the main paths launched every kernel")

    phase_profile(card, fleet_seconds)
    lap("train loop, passes, profile")
    torch.cuda.empty_cache()
    for name, count in phase_serve_tp(card).items():
        launches[name] += count
    lap("serve_tp")
    emit({"phase": "timing", "seconds": seconds,
          "total_s": sum(seconds.values()), "card": card})
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": REPLACES[name][0],
        "replaces": REPLACES[name][1], "launches": launches[name],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row.get("bound_by", "bytes"),
        "library_ms": row.get("library_ms"), "shape": row["shape"],
        "staged_sims": row.get("staged_sims"),
        "device_ms": row["device_ms"], "host_ms": row["host_ms"],
        "max_abs_diff": row["max_abs_err"], "kernel_ms": row["ms"]}
        for name, row in kernels.items()], "card": card})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
