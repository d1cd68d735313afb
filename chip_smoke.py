#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts, serves and trains on the GPU.

    python3 chip_smoke.py [--requests 500] [--epochs 150] [--seed 0]
                          [--train-steps 10] [--out FILE]

Run from the root of a checkout on a machine with one NVIDIA H100. It
builds the CUDA kernels of ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all at once) and drives the port's paths: PROFET serving, LM
serving, LM training of every family, and LM training and serving on a
device mesh.

The PROFET path: it fits the paper-grid predictor (4 devices, 346 cases,
linear + 60-tree forest + DNN members, 150 DNN epochs, random DNN init from
seed 0) on the card, then

  1. serves the ``synthetic_requests`` stream twice through
     ``LatencyService`` (waves of 64; banked: one fused grouped launch,
     traversal and tree mean, per wave; no separate tree-mean launch) and
     one wave through the per-group path (one fused single-forest launch
     per pair);
  2. holds each forest kernel, both traversals by both of their routes
     (shared memory, the one the serving run takes, and global) and both
     fused predictions (the shared route with the tree mean as its
     epilogue), against its plain PyTorch version on the card (max abs
     difference must be 0, NaN where the plain version has NaN): at the
     shapes the serving run gave it, on random ragged forests with a
     depth-0 group, with out-of-range group ids, with groups left out, at
     1 row and at 4,096 rows drawn from the served waves; times every
     kernel at the serving shapes, each fused prediction in turns with the
     two launches it replaces, and both traversal routes in turns at 512
     to 4,096 rows (and says which one the wrapper takes there: the shared
     route only while its grid fits the card in one round), the plain
     versions, and the one PyTorch call that computes the same function
     where there is one (``mean(0)`` for the tree mean; none traverses a
     forest);
  3. holds the card's answers for one wave against the same model run with
     ``device="cpu"`` (rtol 1e-5, the float32 DNN member's bar);
  4. replays the stream once more through a fresh service under
     ``torch.profiler`` and prints the card's idle share and top kernels
     (profiler overhead included; the untraced replays give the latency);
  5. saves the fitted oracle with ``repro_torch.api.save`` and loads it on
     the card and on the CPU (linear and forest members bit for bit, the
     answers within rtol 1e-5); serves the stream through a 2-worker
     thread-mode shard plane in process (one fused grouped launch per
     shard slice, no plain version); launches 2 TCP shard workers on the
     card and serves the stream over HTTP (``BackgroundServer``,
     ``replay`` with 8 clients) through ``LatencyService(shard_plane=...,
     supervise=...)``: every request answers within rtol 1e-5 of the
     unsharded service, each worker runs one fused launch per slice and
     holds a CUDA context (its pid in ``nvidia-smi``); kills worker 1
     mid-replay (requests riding it retry once), waits for the supervisor
     to respawn it and serves again; then float64-only oracles through
     thread, spawn and TCP planes, bit for bit as the unsharded bank;
 11. (run after phase 5, on the phase-1 oracle) live calibration:
     ``serve_calibrated``'s drift-injection replay over HTTP (4 clients,
     rounds of 120 ``synthetic_requests``, the first pair's truth x1.6
     from round 1, noise 0.01; ``Calibrator`` at the CLI's configuration,
     stepping every 0.05 s in its thread, with a ``CalibrationStore``):
     the reference's 6 rounds, then on until the promotion and 2 rounds
     after it (at most 20). Every request answers; drift, a refit, a
     passed canary and a promotion happen mid-traffic; the service ends
     on the ``+cal`` epoch with the drifted pair's rolling MAPE below the
     trigger; the promoted candidate's bank runs fused grouped launches
     and no forest wrapper takes its plain version. Prints each round's
     p50 / p99 / req/s beside what the calibrator had in flight (refit,
     canary, swap), and the refit and canary seconds and the swap and
     warm-up ms. ``CalibrationStore.recover`` gives the promoted epoch on
     the card and on the CPU, linear and forest members bit for bit; then
     ``build_candidate`` on the frozen buffer, on the card and on a CPU
     copy of the oracle: linear and forest members bit for bit, each
     candidate's held-out MAPE on the drifted pair below the trigger (the
     DNN member trains on each device, so it is not compared bitwise);
 12. the paper's baselines on the paper grid's split (20% held out, seed
     0): ``MLPredictModel(epochs=300, seed=0)`` fitted on the card and on
     the CPU, held-out MAPE per target device within 3 points of each
     other; Paleo and Habitat on the host, their MAPE printed;
 19. (after phase 12) the frozen reference fit path
     (``repro_torch.core.reference``) on ``benchmarks/bench_fit.py``'s
     split (25% held out, seed 0) and full-mode config (60 trees, 300
     epochs), cut to anchor T4 (3 of 12 pairs): (a) ``Profet.fit`` on the
     card, warm, against ``fit_profet_reference`` on the card, both times
     and their ratio printed, the vectorized fit's held-out cross MAPE at
     most 3.0 points above its reference's; (b) for pair (T4, V100) the
     grower's 60 trees walked beside ``ReferenceForest``'s (same bootstrap
     weights) from the root: every split equal or an exact SSE tie
     (rational arithmetic), node values within 1e-12; the fused
     single-forest kernel on the oracle's own trees (packed from its node
     lists) within 1e-12 of the recursive host walk on the 260 training
     and 86 held-out rows, 4 counted launches and no plain call; (c) a
     linear + 5-tree reference fit of all 12 pairs on the card and on the
     CPU: no bank, phase 1's requests served through ``LatencyService``
     per group (no wave banked, no forest launch: the recursive forests
     walk on the host), the card's answers equal to the CPU's bit for bit.
     Its wall time is printed.

The LM serving path, at the full published widths and depths, random
float32 weights from ``--seed`` cast to bfloat16 as the prefill step's:

  6. the llama3.2-1b prefill step on (4, 2048) tokens: exactly 16
     flash-attention launches per call, finite next tokens and logits,
     median step time. The model (params rounded to bf16 values) is held
     end to end against the same model with the plain attention in float32
     (atol 1e-4, rtol 1e-4, the CPU parity tests' bar); in bf16 its
     last-position logits may end at most 2x as far from that float32
     plain run as the bf16 plain run's do;
  7. the mamba2-130m prefill step on (4, 2048) tokens: exactly 24 SSD-scan
     launches per call, the same checks;
  8. ``Engine`` serving 8 requests for each model (4 slots, 16 new tokens,
     max_len 128, continuous), as ``launch/serve.py`` does by default; it
     launches neither kernel (prefill goes through the decode step);
  9. the two kernels against their plain versions at the inputs phases 6
     and 7 gave them and at random shapes (flash: GQA, MQA, KV == H, D 16,
     32, 64 and 128, S 300 and 1000, f32 and bf16; SSD: P 32, 64 and 128,
     N 64 and 128, chunks 64, 128 and 256, 16 chunks at S 4096), bars f32
     atol 2e-5 / rtol 1e-4 and bf16 atol 6e-3 / rtol 3e-2 (SSD after
     dividing by max |ref|); two bf16 launches at the main path's inputs
     must give the same bits; each library's SASS must hold tensor-core
     ``HMMA`` instructions (``cuobjdump``); timed with their plain versions
     and, for attention, PyTorch's ``scaled_dot_product_attention`` (timed
     only; the port never calls it), and the float32 kernels at the same
     shapes (cast), held to the float32 bar and timed the same way;
 10. one prefill of each model under ``torch.profiler``: idle share and
     top device kernels.

The LM training path, at full published width:

 13. a launch of either kernel on grad-requiring inputs outside its
     ``autograd.Function`` raises; one float32 train step of each SMOKE
     model on the card and on the CPU (loss and grad norm within 1e-4
     relative); one step's parameter gradients at full width and 2 layers
     of each model on (4, 2048) tokens through the kernel (its Function:
     kernel forward; the reference's gradient recomputed, but for the bf16
     SSD scan, whose backward is its own kernel, one launch a layer) against the
     plain path (``backend="torch"``): float32 per tensor within 1e-4
     of its largest gradient, bf16 per tensor at most 2x as far from the
     float32 plain gradient as the bf16 plain path's; then ``Trainer.run`` for
     ``--train-steps`` (10) steps of llama3.2-1b (16 layers,
     1,235,814,400 params) and of mamba2-130m on (4, 2048) tokens of the
     synthetic stream, float32 params and Adam state, bf16 activations,
     remat: launches per step as derived from the code (one per block in
     the forward and one in the remat recompute: 32 flash, 48 SSD; one
     backward recompute per flash block and one SSD backward-kernel
     launch per SSD block, none recomputed; one ``adamw_sumsq`` and one
     ``adamw_update`` launch, the optimizer's), every gradient after step
     1 finite and not all zero, every loss finite and the last 3 below the first 3;
     median step time, tokens/s, peak memory, and one traced step. The
     mamba2-130m run checkpoints at the midpoint: that checkpoint restores
     on the card and on the CPU bit for bit, and a fresh ``Trainer``
     resumes from the last one.

The remaining LM families (moe, vlm, audio, hybrid), after phase 13:

 14. a float32 SMOKE forward and 3 decode steps of dbrx-132b, grok-1-314b,
     llama-3.2-vision-90b (gates 0.5 and -0.3), whisper-tiny (``enc_out``
     filled by ``encode``) and recurrentgemma-2b (two windows) on the card
     against the CPU from the same params (1e-5 of max |logit|); then, one
     model at a time at full width, random weights from ``--seed`` rounded
     to bf16 values: dbrx-132b (2 layers; 7.75 G params), llama-3.2-vision-
     90b (4 self + 1 cross layers; 6.38 G), whisper-tiny and
     recurrentgemma-2b (whole). For each, the float32 forward through the
     flash kernel against the plain path (atol / rtol 1e-4, where the
     family launches it), the bf16 prefill step on (4, 2048) tokens ((4,
     448) for Whisper's decoder, with 1,500 frames; the vlm with 1,024
     patches): flash launches per prefill as derived from the config (2,
     4, 4, 0), next tokens, the share of dbrx's token-expert choices
     dropped by capacity, median time of 5, tokens/s, peak memory, one
     traced prefill of the hybrid (its ``rglru/scan`` and
     ``attention/local`` ranges), and ``Engine`` serving 8 requests as in
     phase 8; then the flash kernel at that prefill's inputs against its
     plain version (bf16 bar, and its float32 route on the inputs cast,
     float32 bar), timed beside its plain version and SDPA. Its wall time
     is printed. grok-1-314b runs at SMOKE only.

The distributed layer, after phase 14:

 15. a process group of one rank (``nccl``, a ``FileStore`` in a temporary
     directory) and a (1, 1) ``("data", "model")`` ``DeviceMesh``: 3 steps
     of llama3.2-1b and 2 of mamba2-130m at full width and depth on (4,
     2048) tokens (float32 params, bf16 activations, seed ``--seed``),
     first through ``Trainer(mesh=None)``, then through ``Trainer(mesh=
     ...)`` from the same state (``DTensor`` parameters, moments and batch;
     the kernels run on the local shards): losses and grad norms within
     rtol 1e-5 of mesh=None (printed side by side, and whether the gap is
     exactly 0), 32 flash / 48 SSD launches a step on both with no
     plain-version call, step time and peak memory beside phase 13's,
     and one more step of each traced (wall, device busy, idle share);
     ``compressed_psum`` over the NCCL group on the llama mesh step's
     gradients, two rounds, every leaf's mean and residual bit for bit the
     per-rank plain computation on the card, and the largest compression
     error; the mamba mesh trainer's checkpoint restored into a mesh=None
     ``Trainer`` on the card and on the CPU, bit for bit. Each run's counts
     are zeroed before it and read per step; the kernels' line adds the
     mesh run's launches (``mesh_train_*``). Then, as one card holds one
     NCCL rank, every family at SMOKE size in float32 takes one step on a
     (2, 2) mesh of 4 ``gloo`` ranks on this machine's CPU, held against
     its mesh=None step at the train-step bars: this machine's torch runs
     DTensor's sharding rules with the model axis at 2.

The dry-run, after phase 15, in a subprocess of its own (its fake
process group cannot share a process with phase 15's NCCL group):

 16. (a) ``launch.steps.build_cell`` for llama3.2-1b and mamba2-130m,
     prefill and train on (4, 2048) tokens, traced under ``FakeTensorMode``
     on a fake (1, 1) ``cuda`` mesh (``launch.mesh.make_fake_mesh``) with
     the aten-op counter (``analysis.opcount``); (b) the same cells built
     for real (random weights from ``--seed``) and run on the card on that
     mesh under the same counter: the real FLOPs and HBM bytes equal the
     trace's, the traced kernel nodes equal the wrappers' launch counts
     (16 / 32 flash, 24 / 48 SSD: one per call, though a bf16 SSD call is
     three launches) and the derived counts, and the roofline lower bound
     (``analysis.roofline``, H100 constants) is at most the step's time
     measured in phases 6, 7 and 13 and on this mesh; the predicted memory
     (arguments and the counter's peak of temporaries) beside
     ``torch.cuda.max_memory_allocated``; (c) llama3.2-1b ``train_4k``
     and mamba2-130m ``prefill_32k`` through ``launch.dryrun.run_cell``
     on a fake (16, 16) ``cuda`` mesh: each ``ok`` with FLOPs and HBM
     bytes above 0, and collective bytes above 0 for the train cell; then
     llama3.2-1b ``decode_32k`` there, ``ok`` with its collective bytes,
     HBM bytes and all-gathers per device per token printed, the
     collective bytes at most 300 MB (decode attention gathers neither
     the seq-sharded cache nor its scores). (d) phase 18's configurations,
     each chosen from its trace on a fake (1, 1) ``cuda`` mesh (granite's
     and jamba's with no mesh, as one card runs them): from the
     published depth down, float32 Adam moments before bfloat16, the first
     whose arguments and peak temporaries are predicted at most 72 GB; its
     prediction and roofline bound are printed. The kernels' line adds the
     traced nodes and the real launches per step (``dryrun_*`` keys).

Serving on a mesh, on phase 15's NCCL group and (1, 1) mesh (printed
after phase 15):

 17. ``Engine(mesh=...)`` serves phase 8's 8 requests (4 slots, 16 new
     tokens, max_len 128, continuous) for llama3.2-1b and mamba2-130m at
     full width and depth from phase 8's random weights: stats and
     completion order exactly phase 8's ``mesh=None`` engine's, the tokens
     equal up to each request's first parting and there within the bf16
     margin (the mesh run's own logits may favour its token by at most 2 x
     2e-2 x max |logit|), whether every token was equal printed, decode
     tokens/s beside phase 8's, no LM kernel launched and no plain version
     called (decode runs neither). Then every family at SMOKE in bfloat16
     through ``Engine(mesh=(2, 2))`` on 4 ``gloo`` ranks on this
     machine's CPU, continuous, 5 requests on 2 slots, against
     ``mesh=None`` by the same rules, every rank's tokens the same.

Training the remaining families, after phase 16, one model at a time:

 18. for dbrx-132b, llama-3.2-vision-90b, whisper-tiny,
     recurrentgemma-2b, granite-4.0-h-small and jamba2-3b at every width
     as published, at phase 16 (d)'s configuration (dbrx-132b 1 of 40 layers,
     the vision model 3 self + 1 cross layers, both with bfloat16 Adam
     moments; whisper-tiny whole; recurrentgemma-2b whole with bfloat16
     moments; granite one card's share, searched from one period of its
     pattern down: 10 of 40 layers, 9 of each layer's 72 experts, as its
     benchmark cell; jamba2-3b whole with float32 moments, as its cell),
     on (4, 2048) tokens ((4, 448) for whisper's decoder, with 1,500
     frames; the vlm with 1,024 patches; (4, 4096) for granite; (1,
     16384) for jamba, its cell's): one float32 SMOKE train step on the
     card and on the CPU (loss and grad norm within 1e-4 relative; not
     jamba, whose scan kernel takes bf16 only); where the family launches
     the flash kernel, granite and jamba aside, one step's gradients
     through it
     against the plain path at that configuration (phase 13's float32 and
     bf16 per-tensor bars; launches and recomputes as derived); then
     ``Trainer.run`` for
     ``--train-steps`` steps, the vlm gates set to 0.5 and -0.3 first:
     every gradient after step 1 finite and not all zero, every loss finite
     and the last 3 below the first 3, flash launches and backward
     recomputes per step as derived from the config (2 / 1, 6 / 3, 8 / 4,
     0 / 0, 2 / 1, 4 / 2; granite's SSD scan 18 / 0 and 9 backward-kernel
     launches; jamba's selective scan 52 forward and 26 backward kernel
     launches), the optimizer's two kernels
     launched once each a step, the
     peak allocation over what was allocated before the
     Trainer within 5% of the prediction, the median step at or above the
     roofline bound; step ms, tokens/s, peak GB, and one traced step
     (device ms of ``FlashAttentionBackward``, ``moe/route``,
     ``rglru/scan``, ``attention/local``, and granite's
     ``SSDScanBackward``, ``moe/experts``, ``MoEExpertsBackward`` and
     ``moe/shared``, jamba's ``SelectiveScanBackward``, where they exist;
     idle share).
     Each cut goes into the report's ``reduced`` list with its predicted
     GB; the kernels' line adds the ``train_*`` keys to the
     ``flash_attention/<arch>`` rows. Its wall time is printed.

The optimizer, after phase 13:

 20. the AdamW kernel (``csrc/adamw.cu``: the norm's sum of squares and the
     update, one launch each over every tensor) at dbrx-132b-l1's largest
     tensor, one whole expert weight (``blocks.0.ffn.wi``, 16 x 6,144 x
     10,752 = 1.06 G elements) with bfloat16 moments, and at
     mamba2-130m's whole parameter list (314 tensors, 129 M elements)
     with float32 moments: p, m and v after one update equal to the plain
     version's (``adamw.update_plain``, the eager chain, cut into
     ``UPDATE_PIECE`` pieces) bit for bit, the norm the same bits on two
     calls and within 1e-6 of the plain one; the norm and the update timed
     together as the median of 5 CUDA-graph replays, beside their bound
     (24 or 32 bytes an element at the HBM rate), the plain version's time
     and ``torch._fused_adamw_``'s on the same parameters and gradients
     (with float32 moments, the only ones it takes; the library's time,
     never on the port's path). The kernels' line adds to each row the
     optimizer's launches in the trainer's own run of that model
     (``train_launches``, ``train_launches_per_step``: phase 13's
     mamba2-130m, phase 18's dbrx-132b) and its step time.

The kernels at a train cell's own inputs, after phase 18:

 21. for granite-4.0-h-small, the flash kernel at (4, 4096, 32, 8, 128)
     with scores x 1/128 and the SSD scan at (4, 4096, 128, 64, 128),
     chunk 256, on seeded bf16 inputs: each against its plain version
     within 2**-6 (four units of bf16 roundoff) of the element's terms'
     magnitude plus its own, and the same bits on two launches; their lines
     (graph-replay ms, plain ms, bound, SDPA's ms at the same scale) with
     phase 18's launches of that model. Then the SSD scan's backward
     kernel at mamba2-130m's (16, 2048, 24, 64, 128) and granite's (4,
     4096, 128, 64, 128), chunk 256: dX, dAdt, dBc and dCc each within
     2**-6 of its plain version (``ssd_chunked_backward``) in norm, the
     same bits on two calls; lines with the float32 recompute's ms beside
     (what the backward ran before) and the launches of phases 13 and 18.

The Mamba-1 selective scan (to run it alone, a scratch script builds
``selective_scan`` with ``_build.build_all`` and calls
``selective_scan_rows(torch, args, dev, {})`` with ``args.seed`` set):

 22. the selective-scan kernel at jamba2-3b's cell, (1, 16384, 5120, 16),
     on seeded inputs (bf16 u, delta_raw, B, C, z; delta's bias and A
     drawn as the model draws them): y within 2**-8 of its plain version
     in norm (bf16 keeps 2**-9 of a value), the kept states within 2**-12,
     and every gradient of the backward kernel within 2**-6 in norm of the
     plain backward's, taken on slices of 512 channels (each channel scans
     alone; dB and dC add up over the slices); the same bits on two calls;
     two lines (forward, backward: graph-replay ms beside the bound at the
     float32 peak, the plain version's ms; no PyTorch call computes the
     scan), the report's entries keyed by name; each line with the
     launches of phase 18's ``Trainer.run`` of jamba2-3b.

Launch counts are zeroed just before each path's main run and read just
after it. Any failed check exits non-zero. The last line is the JSON
result; the line before it lists every kernel with its launches, error,
times and bound. Without CUDA, or outside a checkout, it exits 2 and prints
no result.
"""
import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 rate; float64 outside the tensor cores
# (the forest kernels compare and add in float64); dense bf16 on the tensor
# cores (the LM kernels' inputs are bf16 on the main path); float32 outside
# the tensor cores (the LM kernels' float32 route)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
LM_BATCH, LM_SEQ = 4, 2048
LM_KERNELS = ("flash_attention", "ssd_scan")
KERNEL_SOURCES = ("forest_eval", "flash_attention", "ssd_scan", "adamw",
                  "rms_norm", "selective_scan")
RTOL_CARD_VS_CPU = 1e-5
# how much farther from the float32 plain run the bf16 run through a kernel
# may end than the bf16 plain run
BF16_VS_PLAIN = 2.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"ok: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_kernel_ms(torch, fn, iters=200, reps=5):
    """Device time of one ``fn()`` launch: ``iters`` launches captured in a
    CUDA graph, replayed ``reps`` times between CUDA events; the median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[reps // 2]


def time_plain_ms(torch, fn, iters=20):
    """Time of one ``fn()`` call between CUDA events (the plain versions
    synchronise inside, so they cannot be captured in a graph)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def path_bytes(torch, forest_eval, X, gid, feat, thr, left, right, depth):
    """What one traversal of these rows must read, counted per field off the
    plain traversal's levels: at an internal node its feat (4 B) and thr
    (8 B), the one child it follows (4 B) and x[row, feat] (8 B); feat at a
    leaf that stopped a walk (4 B); value at each node a walk ends on
    (8 B). Each distinct address counts once. Returns (bytes, compares)."""
    D = X.shape[1]
    rows = torch.arange(X.shape[0], device=X.device)[None, :]
    internal, edges, xreads, stops = [], [], [], []
    compares = 0

    def on_step(flat, F, within, go_left):
        nonlocal compares
        live = within & (F >= 0)
        compares += int(live.sum())
        internal.append(flat[live])
        edges.append((2 * flat + (~go_left).long())[live])
        xreads.append((rows * D + F)[live])
        stops.append(flat[within & (F < 0)])

    ends = forest_eval.leaf_nodes_grouped_plain(
        X, gid, feat, thr, left, right, depth, on_step=on_step)

    def distinct(parts):
        return int(torch.unique(torch.cat(parts)).numel()) if parts else 0

    return (12 * distinct(internal) + 4 * distinct(edges)
            + 8 * distinct(xreads) + 4 * distinct(stops)
            + 8 * distinct([ends.reshape(-1)])), compares


def replay_once(svc, reqs) -> dict:
    """Submit every request, drain the service, and summarise this replay
    alone: service latency (queue + execute) percentiles over its
    requests, and requests per second of its drain."""
    import numpy as np
    before = dict(vars(svc.stats))
    svc.take_finished()
    for r in reqs:
        svc.submit(r)
    t0 = time.perf_counter()
    svc.run()
    wall = time.perf_counter() - t0
    lat = [sr.latency_ms for sr in svc.take_finished()]
    s = svc.stats
    return {"requests": len(lat), "waves": s.waves - before["waves"],
            "banked_waves": s.fused_calls - before["fused_calls"],
            "cache_hits": s.cache_hits - before["cache_hits"],
            "errors": s.errors - before["errors"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "requests_per_s": len(lat) / wall}


# the device functions of src/repro_torch/csrc, as the profiler names them
# (the shared route's by instantiation: <kGrouped, kMean>)
FOREST_KERNELS = ("leaves_tile_kernel<true, true>",
                  "leaves_tile_kernel<false, true>",
                  "leaves_tile_kernel<true, false>",
                  "leaves_tile_kernel<false, false>",
                  "leaves_grouped_kernel", "leaves_single_kernel",
                  "tree_mean_kernel")
REPO_KERNELS = FOREST_KERNELS + (
    "flash_fwd_kernel", "flash_bf16_kernel", "ssd_scan_kernel",
    "ssd_states_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")


def is_kernel(name, key) -> bool:
    """Whether the profiler's ``key`` names device function ``name``
    (spaces ignored, so a template's arguments match however they are
    spaced)."""
    name, key = name.replace(" ", ""), key.replace(" ", "")
    return f"{name}<" in key or f"{name}(" in key


# the train step's profiler ranges (launch/steps.py), the hybrid's RG-LRU
# scan and local attention ranges (models/rglru.py, models/layers.py), the
# MoE router's (models/moe.py), and the kernels' Function backwards, whose
# device time traces report inclusive of what they launch
RANGES = ("train_step/", "rglru/", "attention/", "moe/")
TRACED_SPANS = ("train_step/forward", "train_step/optimizer",
                "FlashAttentionBackward", "SSDScanBackward", "rglru/scan",
                "attention/local", "moe/route", "moe/experts",
                "MoEExpertsBackward", "moe/shared", "SelectiveScanBackward")


def kernel_kind(key) -> str:
    """A coarse kind of the device function the profiler's ``key`` names:
    one of the repo's kernels, a library GEMM, a reduction, an elementwise
    pass, a copy or fill, or other."""
    low = key.lower()
    if any(is_kernel(name, key) for name in REPO_KERNELS):
        return "repo_kernels"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas",
                              "sm90_", "nvjet")):
        return "gemm"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reduction"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    if "memcpy" in low or "memset" in low or "copy" in low or "fill" in low:
        return "copy"
    return "other"


def traced(torch, run) -> dict:
    """``run()`` under ``torch.profiler``: the share of its wall time the
    card spent running kernels, the kernels that took the most device
    time, the device time of each of the repo's own kernels and of each
    kind of kernel, and of the train step's spans (``TRACED_SPANS``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # record_function ranges also appear as device events (the GPU span of
    # what their thread launched): not kernels, so not busy time
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and not e.key.startswith(RANGES)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    split = {}
    for e in kernels:
        kind = kernel_kind(e.key)
        split[kind] = split.get(kind, 0.0) + e.self_device_time_total / 1e3
    # device time under the train step's ranges and the kernels' Function
    # backwards (inclusive of what they launch)
    spans = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
             if e.device_type.name == "CPU" and e.key in TRACED_SPANS}
    # a trace without device events measured nothing: say so, not "idle"
    return {"wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if kernels else None,
            "device_idle_share": 1.0 - busy_us / wall_us if kernels else None,
            "device_ms_by_kind": split, "spans_device_ms": spans,
            "top_kernels": [{"name": e.key[:60], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top],
            "repo_kernels": {
                name: {"calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                for e in kernels for name in REPO_KERNELS
                if is_kernel(name, e.key)}}


def traced_replay(torch, svc, reqs) -> dict:
    """One replay of a fresh service under ``torch.profiler``."""
    for r in reqs:
        svc.submit(r)
    return traced(torch, svc.run)


ROUTES = ("shared", "global")
LARGE_WAVE = 4096
# waves of rows drawn from the served ones at which both traversal routes
# are timed beside each other
WAVE_SIZES = (512, 1024, 2048, LARGE_WAVE)


def bound_ms(nbytes, ops, ops_per_s=FP64_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_forest_stack(torch, device, d=33, seed=0):
    """Ragged random forests grown on random data (60 trees each, depths up
    to 20), one grown on a constant target (depth 0), stacked like the
    bank."""
    import numpy as np
    from repro_torch.core.regressors import RandomForestRegressor
    rng = np.random.default_rng(seed)
    forests = []
    for g in range(4):
        X = rng.normal(size=(120 + 60 * g, d))
        y = (np.full(len(X), 2.0) if g == 1 else
             X[:, 0] * (g + 1) + np.sin(3 * X[:, 1]) + rng.normal(size=len(X)))
        forests.append(RandomForestRegressor(
            n_estimators=60, max_depth=8 + 4 * g, seed=seed + g,
            device=device).fit(X, y).forest_)
    n_max = max(f.feat.shape[1] for f in forests)
    out = {}
    for k, fill in (("feat", -1), ("thr", 0.0), ("left", 0), ("right", 0),
                    ("value", 0.0)):
        a = np.full((4, 60, n_max), fill, getattr(forests[0], k).dtype)
        for g, f in enumerate(forests):
            a[g, :, :f.feat.shape[1]] = getattr(f, k)
        out[k] = torch.from_numpy(a).to(device)
    out["depth"] = torch.tensor([f.depth for f in forests],
                                dtype=torch.int64, device=device)
    Xq = torch.from_numpy(rng.normal(size=(100, d))).to(device)
    gq = torch.from_numpy(rng.integers(0, 4, size=100)).to(device)
    return out, Xq, gq


# ---------------------------------------------------------------------------
# artifacts, sharded and HTTP serving (phase 5)
# ---------------------------------------------------------------------------


def gpu_apps() -> dict:
    """pid -> device memory (MiB) of every compute process ``nvidia-smi``
    lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, mem = (x.strip() for x in line.split(","))
        apps[int(pid)] = int(mem)
    return apps


def gpu_memory_used_mib() -> int:
    """The card's used memory as ``nvidia-smi`` reads it, all contexts."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])


def check_worker_contexts(tag, procs, stats, mib_before, card) -> dict:
    """Each shard worker process holds a CUDA context on the card. Where
    ``nvidia-smi`` lists the workers' pids, their rows say so; where it
    attributes every context to one process of its own (as behind a
    container's GPU proxy), each worker's report from its own process
    (pid, bytes its torch holds on the card) says so, and the card's used
    memory must have grown since before the workers started."""
    import os
    apps = gpu_apps()
    used = gpu_memory_used_mib()
    out = {"nvidia_smi_apps": apps, "memory_used_mib": used,
           "memory_used_before_mib": mib_before,
           "worker_pids": [p.pid for p in procs],
           "worker_cuda_bytes": [st.get("cuda_memory_allocated")
                                 for st in stats]}
    for i, (p, st) in enumerate(zip(procs, stats)):
        check(st["pid"] == p.pid != os.getpid()
              and (st.get("cuda_memory_allocated") or 0) > 0,
              f"{tag}: worker {i} (pid {p.pid}) holds "
              f"{st.get('cuda_memory_allocated')} bytes on the card, "
              "reported from its own process")
    if all(p.pid in apps for p in procs):
        out["worker_mib"] = [apps[p.pid] for p in procs]
        check(all(m > 0 for m in out["worker_mib"]),
              f"{tag}: nvidia-smi lists each worker's context: "
              f"{out['worker_mib']} MiB; card: {card}")
    else:
        check(used > mib_before,
              f"{tag}: nvidia-smi lists the card's contexts under pids "
              f"{sorted(apps)} (a GPU proxy's), not the workers' "
              f"{out['worker_pids']}; the card's used memory went from "
              f"{mib_before} to {used} MiB with the workers "
              f"({(used - mib_before) / len(procs):.0f} MiB a worker); "
              f"card: {card}")
    return out


def member_preds(torch, bank, X, gids) -> dict:
    """Each member's prediction of a bank for the rows (X, gids), as
    ``ModelBank.execute`` computes them before the median."""
    from repro_torch.core.regressors import LinearRegressor
    from repro_torch.kernels import forest_eval
    out = {}
    if bank.lin_coef is not None:
        out["linear"] = LinearRegressor.apply(LinearRegressor._design(X),
                                              bank.lin_coef[gids])
    if bank.forest is not None:
        f = bank.forest
        out["forest"] = forest_eval.predict_grouped(
            torch.from_numpy(X).to(bank.device),
            torch.from_numpy(gids).to(bank.device), f["feat"], f["thr"],
            f["left"], f["right"], f["value"], f["depth"]).cpu().numpy()
    if bank.dnn is not None:
        out["dnn"] = bank._dnn_member(X, gids)
    return out


def max_rel(np, got, want) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def served(np, svc, reqs) -> list:
    """The service's answers to ``reqs`` in request order."""
    svc.take_finished()
    for r in reqs:
        svc.submit(r)
    svc.run()
    done = sorted(svc.take_finished(), key=lambda sr: sr.uid)
    assert all(sr.error is None for sr in done), [sr.error for sr in done]
    return np.array([sr.result.latency_ms for sr in done])


def shard_phase(torch, np, oracle, reqs, waves, wave_plans, args,
                card) -> dict:
    """Phase 5: the artifact store, HTTP serving through two TCP shard
    workers on the card (and after one is killed), a thread-mode plane in
    process, and float64-only planes of every kind."""
    import threading

    from repro_torch import api
    from repro_torch.core.predictor import ProfetConfig
    from repro_torch.kernels import forest_eval
    from repro_torch.serve import (BackgroundServer, LatencyService,
                                   LifecycleConfig, RetryPolicy,
                                   ShardPlane, launch_tcp_workers, replay)
    rep = {}
    X, gids = max(waves, key=lambda w: len(w[0]))

    # -- artifacts: save on the card, load on the card and on the CPU -----
    path = ROOT / "build" / "smoke" / "oracle.pkl"
    t0 = time.perf_counter()
    manifest = api.save(oracle, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_card = api.load(path, expect_config=oracle.config, device="cuda")
    load_s = time.perf_counter() - t0
    on_cpu = api.load(path, expect_config=oracle.config, device="cpu")
    check(on_card.bank.forest["feat"].is_cuda
          and not on_cpu.bank.forest["feat"].is_cuda,
          f"artifact ({path.stat().st_size} bytes, saved in {save_s:.2f} s, "
          f"loaded on the card in {load_s:.2f} s) reloads on the card and "
          "on the CPU")
    want = member_preds(torch, oracle.bank, X, gids)
    for name, o in (("card", on_card), ("CPU", on_cpu)):
        got = member_preds(torch, o.bank, X, gids)
        for member in ("linear", "forest"):
            check(np.array_equal(got[member], want[member]),
                  f"{name} reload: the {member} member equals the "
                  f"original's bit for bit on a wave of {len(X)} rows")
    lat = oracle.execute(wave_plans).latencies()
    lat_card = on_card.execute(wave_plans).latencies()
    lat_cpu = on_cpu.execute(wave_plans).latencies()
    rel_card, rel_cpu = max_rel(np, lat_card, lat), max_rel(np, lat_cpu,
                                                            lat_card)
    check(rel_card <= RTOL_CARD_VS_CPU,
          f"card reload answers the 64-request wave as the original "
          f"(max rel diff {rel_card:.3e}, bitwise "
          f"{bool(np.array_equal(lat_card, lat))})")
    check(rel_cpu <= RTOL_CARD_VS_CPU,
          f"CPU reload answers within rtol {RTOL_CARD_VS_CPU} of the card "
          f"(max rel diff {rel_cpu:.3e})")
    rep["artifact"] = {"bytes": path.stat().st_size, "save_s": save_s,
                       "load_card_s": load_s, "schema": manifest[
                           "schema_version"],
                       "card_reload_max_rel": rel_card,
                       "card_reload_bitwise": bool(np.array_equal(lat_card,
                                                                  lat)),
                       "cpu_reload_max_rel": rel_cpu}

    # -- the unsharded answers every sharded run is held to ---------------
    want = served(np, LatencyService(oracle, max_wave=64), reqs)

    # -- thread-mode plane in process: one fused launch per slice ---------
    with ShardPlane(workers=2, mode="thread") as tplane:
        tsvc = LatencyService(oracle, max_wave=64, shard_plane=tplane)
        check(tsvc._shard_gen is not None and not tsvc.stats.degraded,
              "thread-mode plane loaded the bank")
        before, s0 = dict(forest_eval.launches), tplane.slices
        plain0 = sum(forest_eval.plain_calls.values())
        got = served(np, tsvc, reqs)
        delta = {k: v - before[k] for k, v in forest_eval.launches.items()}
        plain = sum(forest_eval.plain_calls.values()) - plain0
        slices = tplane.slices - s0
    check(delta["predict_grouped"] == slices > 0
          and delta["leaf_values_grouped"] == 0
          and delta["leaf_values_grouped/global"] == 0
          and plain == 0,
          f"thread mode: {delta['predict_grouped']} fused grouped launches "
          f"for {slices} shard slices, {plain} plain calls")
    rel_thread = max_rel(np, got, want)
    check(rel_thread <= RTOL_CARD_VS_CPU,
          f"thread-mode plane answers {len(reqs)} requests as the "
          f"unsharded service (max rel diff {rel_thread:.3e})")
    rep["thread_plane"] = {"slices": slices, "launches": delta,
                           "max_rel": rel_thread}

    # -- the same replay over HTTP, unsharded: the yardstick --------------
    usvc = LatencyService(oracle, max_wave=64, cache_size=0)
    ubg = BackgroundServer(usvc, host="127.0.0.1", port=0).start()
    try:
        r = replay(ubg.host, ubg.port, reqs, clients=8)
    finally:
        ubg.stop()
    got = np.array([x["latency_ms"] if x else np.nan for x in r["results"]])
    check(r["ok"] == len(reqs) and max_rel(np, got, want)
          <= RTOL_CARD_VS_CPU,
          f"unsharded replay: {r['ok']} of {len(reqs)} requests answered "
          f"over HTTP (max rel diff {max_rel(np, got, want):.3e})")
    rep["http_unsharded"] = {k: r[k] for k in (
        "ok", "wall_s", "client_p50_ms", "client_p99_ms", "requests_per_s")}
    print(f"unsharded replay over HTTP: p50 {r['client_p50_ms']:.3f} ms, "
          f"p99 {r['client_p99_ms']:.3f} ms, {r['requests_per_s']:.1f} "
          f"req/s, {len(reqs)} requests, 8 clients; card: {card}")

    # -- two TCP shard workers on the card behind HTTP ---------------------
    mib_before = gpu_memory_used_mib()
    t0 = time.perf_counter()
    pool = launch_tcp_workers(2, device="cuda")
    plane = bg = None
    try:
        plane = ShardPlane(workers=0, mode="thread", remote=pool.addresses)
        # no prediction cache: every replay executes on the plane
        svc = LatencyService(oracle, max_wave=64, cache_size=0,
                             shard_plane=plane,
                             supervise=LifecycleConfig(endpoints={
                                 i: (lambda i=i: pool.respawn(i))
                                 for i in range(2)}))
        boot_s = time.perf_counter() - t0
        check(svc._shard_gen is not None and not svc.stats.degraded
              and svc.supervisor is not None,
              f"2 TCP shard workers loaded the bank on the card "
              f"({boot_s:.1f} s with their start; "
              f"{svc.stats.degraded_reason})")
        bg = BackgroundServer(svc, host="127.0.0.1", port=0).start()

        def http_run(tag, stats=True, **kw):
            """One replay of ``reqs`` over HTTP; with ``stats``, each
            worker's fused launches during it (from the worker process)."""
            st0 = [w.stats() for w in plane.workers] if stats else []
            s0 = plane.slices
            r = replay(bg.host, bg.port, reqs, clients=8, **kw)
            st1 = [w.stats() for w in plane.workers] if stats else []
            got = np.array([x["latency_ms"] if x else np.nan
                            for x in r["results"]])
            check(r["ok"] == len(reqs) and not r["errors"],
                  f"{tag}: {r['ok']} of {len(reqs)} requests answered over "
                  f"HTTP ({len(r['errors'])} errors)")
            rel = max_rel(np, got, want)
            check(rel <= RTOL_CARD_VS_CPU,
                  f"{tag}: answers as the unsharded service (max rel diff "
                  f"{rel:.3e})")
            out = {"ok": r["ok"], "wall_s": r["wall_s"],
                   "client_p50_ms": r["client_p50_ms"],
                   "client_p99_ms": r["client_p99_ms"],
                   "requests_per_s": r["requests_per_s"], "max_rel": rel,
                   "slices": plane.slices - s0,
                   "worker_launches": [
                       b["launches"]["predict_grouped"]
                       - a["launches"]["predict_grouped"]
                       for a, b in zip(st0, st1)],
                   "worker_pids": [b["pid"] for b in st1],
                   "worker_stats": st1}
            print(f"{tag} over HTTP: p50 {out['client_p50_ms']:.3f} ms, "
                  f"p99 {out['client_p99_ms']:.3f} ms, "
                  f"{out['requests_per_s']:.1f} req/s, "
                  f"{len(reqs)} requests, 8 clients; card: {card}")
            return out

        first = http_run("sharded replay")
        check(sum(first["worker_launches"]) == first["slices"] > 0
              and all(n > 0 for n in first["worker_launches"]),
              f"the workers ran one fused grouped launch per slice on the "
              f"card ({first['worker_launches']} for {first['slices']} "
              "slices)")
        first["contexts"] = check_worker_contexts(
            "sharded replay", pool.procs, first.pop("worker_stats"),
            mib_before, card)

        # kill worker 1 while a replay is in flight; the supervisor
        # respawns it and every request still answers (retried once)
        old_pid = pool.procs[1].pid
        base = svc.stats.requests
        errs0, fb0 = svc.stats.shard_slice_errors, plane.fallback_rows
        result = {}

        def run():
            result["r"] = http_run("replay with a worker killed",
                                   stats=False, retry=RetryPolicy(
                                       max_attempts=4, base_s=0.05,
                                       retry_statuses=frozenset({500})))
        t = threading.Thread(target=run)
        t.start()
        deadline = time.time() + 60
        while svc.stats.requests < base + len(reqs) // 5 \
                and time.time() < deadline:
            time.sleep(0.001)
        in_flight = t.is_alive()
        pool.kill(1)
        t.join(timeout=300)
        check(in_flight and not t.is_alive() and "r" in result,
              f"worker 1 (pid {old_pid}) killed while the replay was in "
              f"flight ({svc.stats.requests - base} requests in)")
        deadline = time.time() + 120
        while plane.adoptions < 1 and time.time() < deadline:
            time.sleep(0.05)
        check(plane.adoptions >= 1 and plane.alive_workers() == 2
              and pool.procs[1].pid != old_pid,
              f"the supervisor respawned worker 1 as pid "
              f"{pool.procs[1].pid} ({plane.adoptions} adoption)")
        killed = result["r"]
        killed.update(slice_errors=svc.stats.shard_slice_errors - errs0,
                      fallback_rows=plane.fallback_rows - fb0)
        check(killed["slices"] > 0 and killed["fallback_rows"] > 0,
              f"waves after the kill rode the live worker and the parent "
              f"answered the dead one's rows ({killed['slices']} slices, "
              f"{killed['fallback_rows']} fallback rows, "
              f"{killed['slice_errors']} slice errors retried)")
        after = http_run("replay after the respawn")
        check(all(n > 0 for n in after["worker_launches"]),
              f"the respawned worker serves its slices on the card "
              f"({after['worker_launches']})")
        after["contexts"] = check_worker_contexts(
            "after the respawn", pool.procs, after.pop("worker_stats"),
            mib_before, card)
        rep["http"] = {"sharded": first, "killed": killed,
                       "after_respawn": after,
                       "lifecycle": plane.summary().get("lifecycle")}
    finally:
        if bg is not None:
            bg.stop()
        if plane is not None:
            plane.close()
        pool.close()

    # -- float64-only members: every plane kind bit for bit ----------------
    from repro_torch.api.oracle import LatencyOracle
    o64 = LatencyOracle.fit(oracle.dataset, ProfetConfig(
        members=("linear", "forest"), n_trees=60, seed=args.seed),
        device="cuda")
    Xb = np.concatenate([w[0] for w in waves])
    gb = np.concatenate([w[1] for w in waves])
    want64 = o64.bank.execute(Xb, gb)
    pool = launch_tcp_workers(2, device="cuda")
    try:
        for kind, kw in (("thread", dict(workers=2, mode="thread")),
                         ("spawn", dict(workers=2, mode="spawn")),
                         ("tcp", dict(workers=0, mode="thread",
                                      remote=pool.addresses))):
            with ShardPlane(**kw) as p64:
                got = p64.load(o64.bank).execute(Xb, gb)
                check(np.array_equal(got, want64) and p64.slices == 2,
                      f"float64 members, {kind} plane on the card: "
                      f"{len(Xb)} rows bit for bit as the unsharded bank")
    finally:
        pool.close()
    rep["float64_planes_rows"] = len(Xb)
    return rep


# ---------------------------------------------------------------------------
# live calibration (phase 11) and the paper's baselines (phase 12)
# ---------------------------------------------------------------------------

# serve_calibrated's defaults: the drift-injection replay and the control
# loop's configuration
CAL_ROUNDS, CAL_REQUESTS, CAL_CLIENTS, CAL_WAVE = 6, 120, 4, 32
CAL_DRIFT, CAL_ONSET, CAL_NOISE, CAL_INTERVAL = 1.6, 1, 0.01, 0.05
CAL_TRIGGER = 10.0
# past the reference's 6 rounds the replay goes on until the promotion and
# CAL_AFTER rounds after it, at most CAL_MAX_ROUNDS in all: on the paper
# grid the drifted pair gets ~6 measured requests a round, and the refit
# waits for 24 of them scored after the drift was detected
CAL_AFTER, CAL_MAX_ROUNDS = 2, 20
# MLPredict on the card against its CPU fit: the percentage-point band of
# tests/test_torch_fit_mape.py, here two-sided, per target device
MLPREDICT_BAND_PTS = 3.0


def round_kind(rec, onset, spans, promoted_at) -> str:
    """What the calibrator had in flight during one replay round: the
    kinds of work whose span overlaps the round's, or its phase."""
    busy = sorted({kind for kind, t0, t1 in spans
                   if t0 < rec["t1"] and t1 > rec["t0"]})
    if busy:
        return "+".join(busy)
    if rec["round"] < onset:
        return "before drift"
    if promoted_at is not None and rec["t0"] >= promoted_at:
        return "after promotion"
    return "drift, nothing in flight"


def calibration_phase(torch, np, oracle, waves, args, card) -> dict:
    """Phase 11: ``serve_calibrated``'s drift-injection replay on the card
    over the phase-1 oracle, then the recovery and a refit on the card
    and on the CPU."""
    import shutil

    from repro_torch.api.artifacts import CalibrationStore
    from repro_torch.api.oracle import LatencyOracle
    from repro_torch.calibrate import (CalibrationConfig, Calibrator,
                                       build_candidate, heldout_scores)
    from repro_torch.calibrate import canary as canary_mod
    from repro_torch.convert import profet_from_numpy, profet_to_numpy
    from repro_torch.kernels import forest_eval
    from repro_torch.launch.serve_calibrated import DriftTruth, replay_round
    from repro_torch.serve import BackgroundServer, LatencyService

    X, gids = max(waves, key=lambda w: len(w[0]))
    store_dir = ROOT / "build" / "smoke" / "calibration"
    shutil.rmtree(store_dir, ignore_errors=True)
    store = CalibrationStore(store_dir)
    cfg = CalibrationConfig(trigger_mape=CAL_TRIGGER, min_obs=8,
                            min_refit_obs=6, canary_min_obs=4,
                            confirm_obs=16, cooldown_scored=16)
    spans, swaps = [], []       # (kind, t0, t1); the promoted oracles

    def timed(kind, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((kind, t0, time.perf_counter()))
        return run

    svc = LatencyService(oracle, max_wave=CAL_WAVE)
    base_epoch = svc.epoch
    refreshed = svc.oracle_refreshed

    def swap(new, label=None):
        warm0 = svc.stats.warmup_ms
        epoch = refreshed(new, label)
        swaps.append({"oracle": new, "epoch": epoch,
                      "warmup_ms": svc.stats.warmup_ms - warm0,
                      "launches_at_swap": new.bank.forest_launches})
        return epoch

    svc.oracle_refreshed = timed("swap", swap)
    verdict = canary_mod.verdict
    canary_mod.verdict = timed("canary", verdict)
    cal = Calibrator(svc, cfg, store=store,
                     refit_fn=timed("refit", build_candidate))
    truth = DriftTruth(oracle.dataset, oracle.pairs()[0], CAL_DRIFT,
                       CAL_NOISE, seed=args.seed)
    pair = truth.pair
    rounds = []
    bg = None
    forest_eval.reset_launches()
    incumbent0 = oracle.bank.forest_launches
    try:
        cal.start(interval=CAL_INTERVAL)
        bg = BackgroundServer(svc, host="127.0.0.1", port=0,
                              calibrator=cal).start()
        print(f"calibration replay: {truth.label} x{CAL_DRIFT} from round "
              f"{CAL_ONSET}, trigger MAPE {CAL_TRIGGER}, epoch {base_epoch}")
        promoted_round = None
        for rnd in range(CAL_MAX_ROUNDS):
            t0 = time.perf_counter()
            rec = replay_round(bg, cal, oracle, truth, rnd, onset=CAL_ONSET,
                               requests=CAL_REQUESTS, clients=CAL_CLIENTS,
                               interval=CAL_INTERVAL, seed=args.seed)
            rec.update(t0=t0, t1=time.perf_counter())
            rounds.append(rec)
            if cal.stats.promotions and promoted_round is None:
                promoted_round = rnd
            if rnd + 1 >= CAL_ROUNDS and promoted_round is not None \
                    and rnd - promoted_round >= CAL_AFTER \
                    and cal.detector.samples(pair) >= cfg.min_obs:
                break
        cal.stop()
    finally:
        cal.stop()
        if bg is not None:
            bg.stop()
        canary_mod.verdict = verdict
    launches = dict(forest_eval.launches)
    plain = dict(forest_eval.plain_calls)
    incumbent = oracle.bank.forest_launches - incumbent0
    s = cal.summary()
    print("calibration timeline:")
    for ev in cal.stats.events:
        print(f"  * {ev}")
    promoted_at = min((t0 for kind, t0, _ in spans if kind == "swap"),
                      default=None)
    for rec in rounds:
        rec["kind"] = round_kind(rec, CAL_ONSET, spans, promoted_at)
        print(f"round {rec['round']} ({rec['kind']}; state {rec['state']}): "
              f"p50 {rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms, "
              f"{rec['requests_per_s']:.1f} req/s, {rec['ok']}/{rec['n']} "
              f"ok; card: {card}")
    by_kind = {}
    for rec in rounds:
        by_kind.setdefault(rec["kind"], []).append(rec)
    kinds = {k: {"rounds": [r["round"] for r in v],
                 "p50_ms": float(np.median([r["p50_ms"] for r in v])),
                 "p99_ms": float(np.median([r["p99_ms"] for r in v])),
                 "requests_per_s": float(np.median(
                     [r["requests_per_s"] for r in v]))}
             for k, v in by_kind.items()}
    for k, v in kinds.items():
        print(f"rounds {v['rounds']} ({k}): median p50 {v['p50_ms']:.3f} "
              f"ms, median p99 {v['p99_ms']:.3f} ms, median "
              f"{v['requests_per_s']:.1f} req/s")
    secs = {kind: [t1 - t0 for k, t0, t1 in spans if k == kind]
            for kind in ("refit", "canary", "swap")}
    print(f"refit s {secs['refit']}, canary s {secs['canary']}, swap ms "
          f"{[1e3 * t for t in secs['swap']]}, warm-up ms "
          f"{[w['warmup_ms'] for w in swaps]}; card: {card}")
    n_ok = sum(r["ok"] for r in rounds)
    n_req = sum(r["n"] for r in rounds)
    check(n_ok == n_req and not any(r["errors"] for r in rounds),
          f"calibration replay: {n_ok} of {n_req} requests answered over "
          f"{len(rounds)} rounds")
    check(s["drift_events"] >= 1 and s["refits"] >= 1
          and s["canary_pass"] >= 1 and s["promotions"] >= 1,
          f"drift detected ({s['drift_events']}), refit ({s['refits']}), "
          f"canary passed ({s['canary_pass']} of "
          f"{s['canary_pass'] + s['canary_fail']}) and promoted "
          f"({s['promotions']}; {s['rollbacks']} rollbacks) mid-traffic")
    mape = cal.detector.mape(pair)
    check("+cal" in svc.epoch and svc.epoch != base_epoch and swaps
          and svc.epoch == swaps[-1]["epoch"],
          f"the service serves the promoted epoch {svc.epoch}")
    check(cal.detector.samples(pair) >= cfg.min_obs and mape < CAL_TRIGGER,
          f"{truth.label} rolling MAPE after the promotion {mape:.3f} < "
          f"{CAL_TRIGGER} over {cal.detector.samples(pair)} observations")
    promoted = swaps[-1]["oracle"]
    cand_launches = (promoted.bank.forest_launches
                     - swaps[-1]["launches_at_swap"])
    # the calibrated path's fused grouped launches by whose bank ran them:
    # the incumbent's (waves before the swap, scoring, the canary), the
    # candidate's before the swap (canary, shadow waves) and after it
    # (served waves, scoring); the rest are the swap's bank warm-up
    split = {"incumbent": incumbent,
             "candidate_before_swap": swaps[-1]["launches_at_swap"],
             "candidate_after_swap": cand_launches}
    split["warmup"] = launches["predict_grouped"] - sum(split.values())
    check(cand_launches > 0 and launches["predict_grouped"] > 0
          and promoted.bank.device.type == "cuda",
          f"the promoted candidate's bank served {cand_launches} fused "
          f"grouped launches on the card ({launches['predict_grouped']} "
          f"on the calibrated path in all: {json.dumps(split)})")
    check(not any(plain.values()),
          f"no plain forest call on the calibrated path "
          f"({json.dumps(plain)})")
    print(f"launches on the calibrated path: {json.dumps(launches)}; plain "
          f"calls {json.dumps(plain)}")

    # -- recovery on the card and on the CPU ------------------------------
    want = member_preds(torch, promoted.bank, X, gids)
    recovered = {}
    for dev in ("cuda", "cpu"):
        got = store.recover(expect_config=oracle.config, device=dev)
        check(got is not None and got[1] == svc.epoch,
              f"CalibrationStore.recover on {dev} gives the promoted epoch "
              f"({got[1] if got else None})")
        preds = member_preds(torch, got[0].bank, X, gids)
        for member in ("linear", "forest"):
            check(np.array_equal(preds[member], want[member]),
                  f"recovered on {dev}: the {member} member equals the "
                  f"promoted one's bit for bit ({len(X)} rows)")
        recovered[dev] = got[1]

    # -- the same refit on the card and on the CPU ------------------------
    cpu_oracle = LatencyOracle(profet_from_numpy(
        profet_to_numpy(oracle.profet), device="cpu"), oracle.dataset)
    refit = {}
    for dev, orc in (("cuda", oracle), ("cpu", cpu_oracle)):
        t0 = time.perf_counter()
        cand, rep = build_candidate(orc, cal.buffer, [pair],
                                    min_refit_obs=cfg.min_refit_obs,
                                    window=cfg.drift_confirm_obs)
        fit_s = time.perf_counter() - t0
        check(cand is not None and rep.pairs == (pair,)
              and cand.ensemble(*pair).device.type == dev,
              f"build_candidate on {dev}: {rep.pairs}, {rep.total_obs} obs, "
              f"fit on {dev} in {fit_s:.2f} s")
        scores = heldout_scores(orc, cand, cal.buffer, pairs=[pair],
                                min_obs=cfg.canary_min_obs,
                                window=cfg.drift_confirm_obs)
        inc, cmape, n = scores.get(pair, (np.nan, np.nan, 0))
        check(cmape < CAL_TRIGGER,
              f"{dev} candidate's held-out MAPE on {truth.label} "
              f"{cmape:.3f} < {CAL_TRIGGER} (incumbent {inc:.3f}, {n} obs)")
        refit[dev] = {"cand": cand, "fit_s": fit_s, "heldout": cmape,
                      "incumbent": inc, "n_obs": n, "scale": rep.scale[pair]}
    card_m = member_preds(torch, refit["cuda"]["cand"].bank, X, gids)
    cpu_m = member_preds(torch, refit["cpu"]["cand"].bank, X, gids)
    for member in ("linear", "forest"):
        check(np.array_equal(card_m[member], cpu_m[member]),
              f"refit candidate's {member} member: card and CPU bit for "
              f"bit ({len(X)} rows)")
    dnn_rel = max_rel(np, card_m["dnn"], cpu_m["dnn"])
    print(f"refit candidate's DNN member, card against CPU: max rel diff "
          f"{dnn_rel:.3e} (float32, trained on each device)")
    for r in refit.values():
        del r["cand"]
    return {"rounds": [{k: v for k, v in r.items() if k not in ("t0", "t1")}
                       for r in rounds],
            "by_kind": kinds, "refit_s": secs["refit"],
            "canary_s": secs["canary"],
            "swap_ms": [1e3 * t for t in secs["swap"]],
            "warmup_ms": [w["warmup_ms"] for w in swaps],
            "launches": launches, "plain_calls": plain,
            "candidate_fused_launches": cand_launches,
            "fused_launches_by_bank": split,
            "summary": {k: s[k] for k in (
                "drift_events", "refits", "canary_pass", "canary_fail",
                "promotions", "rollbacks", "confirms", "scored",
                "shadow_waves", "persisted")},
            "epoch": svc.epoch, "mape_after": mape, "recovered": recovered,
            "refit": refit, "refit_dnn_card_vs_cpu_max_rel": dnn_rel}


def baselines_phase(np, card) -> dict:
    """Phase 12: MLPredict fitted on the card and on the CPU, Paleo and
    Habitat on the host, all on the paper grid's train/test split
    (``benchmarks/common.split``: 20% held out, seed 0)."""
    from repro_torch.core import baselines, workloads
    from repro_torch.core.ensemble import mape

    ds = workloads.generate()
    train, test = workloads.split_cases(ds.cases, test_frac=0.2, seed=0)
    true = {d: np.array([ds.latency(d, c) for c in test])
            for d in ds.devices}
    ml = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m = baselines.MLPredictModel(epochs=300, seed=0, device=dev).fit(
            ds, train)
        fit_s = time.perf_counter() - t0
        check(m.reg.params[0]["w"].device.type == dev,
              f"MLPredict fitted on {dev} in {fit_s:.1f} s")
        per = {d: mape(true[d], [m.predict(d, c) for c in test])
               for d in ds.devices}
        check(all(np.isfinite(v) for v in per.values()),
              f"MLPredict on {dev}: finite held-out MAPE per target")
        ml[dev] = {"fit_s": fit_s, "mape": per}
    for d in ds.devices:
        a, b = ml["cuda"]["mape"][d], ml["cpu"]["mape"][d]
        check(abs(a - b) <= MLPREDICT_BAND_PTS,
              f"MLPredict MAPE on {d}: card {a:.3f}, CPU {b:.3f} (within "
              f"{MLPREDICT_BAND_PTS} points); card: {card}")
    pa = baselines.PaleoModel()
    for d in ds.devices:
        pa.calibrate_many(d, train, [ds.latency(d, c) for c in train])
    paleo = {d: mape(true[d], [pa.predict(d, c) for c in test])
             for d in ds.devices}
    hb = baselines.HabitatScaling()
    habitat = {f"{a}->{t}": mape(true[t], [hb.predict(a, t, c)
                                           for c in test])
               for a in ds.devices for t in ds.devices if a != t}
    print(f"held-out MAPE, {len(test)} cases per device: Paleo "
          f"{json.dumps(paleo)}; Habitat {json.dumps(habitat)}")
    return {"mlpredict": ml, "paleo": paleo, "habitat": habitat,
            "n_test": len(test)}


# ---------------------------------------------------------------------------
# the frozen reference fit path (phase 19)
# ---------------------------------------------------------------------------

# benchmarks/bench_fit.py's one-sided band: the vectorized fit's held-out
# cross MAPE may be at most this many points above its reference's
MAPE_PARITY_PTS = 3.0
# phase 19 (a)'s cut: one anchor (3 of the paper grid's 12 pairs), as the
# recursive forest takes ~10 s of host time a pair
REFERENCE_ANCHORS = ("T4",)
# phase 19 (b): the pair whose forest is grown both ways, and the bar of
# tests/test_fit_path.py for predictions of equal trees
ORACLE_PAIR = ("T4", "V100")
ORACLE_RTOL = ORACLE_ATOL = 1e-12


def cross_mape(np, profet, ds, test) -> float:
    """Mean phase-1 MAPE over every trained pair on the held-out cases
    (``benchmarks/bench_fit.py``'s ``_cross_mape``)."""
    from repro_torch.core.ensemble import mape
    scores = []
    X_by_anchor = {}
    for (ga, gt) in sorted(profet.cross):
        if ga not in X_by_anchor:
            X_by_anchor[ga] = profet.feature_matrix(
                [ds.profile(ga, c) for c in test], test)
        y_true = np.array([ds.latency(gt, c) for c in test])
        scores.append(mape(y_true, profet.predict_cross_matrix(
            ga, gt, X_by_anchor[ga])))
    return float(np.mean(scores))


def timed_s(torch, fn):
    """(result, host seconds of ``fn`` up to a synchronised card)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exact_sse(w, y):
    """The weighted SSE of one node's rows in rational arithmetic: each
    float64 weight and target taken exactly, nothing rounded."""
    from fractions import Fraction
    w = [Fraction(float(v)) for v in w]
    y = [Fraction(float(v)) for v in y]
    sw = sum(w)
    if not sw:
        return Fraction(0)
    swy = sum(a * b for a, b in zip(w, y))
    return sum(a * b * b for a, b in zip(w, y)) - swy * swy / sw


def tie_walk(np, f, oracle_f, W, X, y) -> dict:
    """Walk each tree of the packed forest ``f`` beside the recursive
    oracle's tree of the same bootstrap plan ``W``, from the root, each
    node with the rows its own tree sends there. Where the two nodes hold
    the same in-bag rows (``W > 0``), their values are compared, and their
    splits must be equal or an exact tie: the same in-bag rows to each
    side, or two partitions whose SSEs are equal in rational arithmetic
    (the last-ulp ties of ``core.reference``'s docstring). The walk goes
    on below a split that keeps the in-bag rows together and stops below
    one that sends them apart. Counts are returned; ``mismatched`` counts
    everything else (a leaf beside a split, a split that is not a tie)."""
    out = {"compared": 0, "equal": 0, "ties_same_rows": 0, "ties": 0,
           "mismatched": 0, "value_max_rel": 0.0}
    for t in range(f.n_trees):
        tree, w = oracle_f.trees_[t], W[t]
        stack = [(0, 0, np.arange(len(y)), np.arange(len(y)))]
        while stack:
            a, b, ra, rb = stack.pop()
            nb = tree[b]
            out["compared"] += 1
            out["value_max_rel"] = max(out["value_max_rel"], float(
                abs(f.value[t, a] - nb.value) / abs(nb.value)))
            fa = int(f.feat[t, a])
            if (fa < 0) != (nb.feature < 0):
                out["mismatched"] += 1
                continue
            if fa < 0:
                continue
            sides_a = X[ra, fa] <= f.thr[t, a]
            sides_b = X[rb, nb.feature] <= nb.threshold
            la, ra_ = ra[sides_a], ra[~sides_a]
            lb, rb_ = rb[sides_b], rb[~sides_b]
            if (fa, float(f.thr[t, a])) == (nb.feature, nb.threshold):
                out["equal"] += 1
            elif np.array_equal(la[w[la] > 0], lb[w[lb] > 0]):
                out["ties_same_rows"] += 1
            else:
                if (exact_sse(w[la], y[la]) + exact_sse(w[ra_], y[ra_])
                        == exact_sse(w[lb], y[lb])
                        + exact_sse(w[rb_], y[rb_])):
                    out["ties"] += 1
                else:
                    out["mismatched"] += 1
                continue
            stack += [(f.left[t, a], nb.left, la, lb),
                      (f.right[t, a], nb.right, ra_, rb_)]
    return out


def pack_node_lists(torch, trees, dev) -> tuple:
    """A recursive forest's node lists as the ``(T, N)`` arrays the forest
    kernels walk (node ``i`` of a tree in column ``i``; the columns past a
    tree's last node are leaves) on ``dev``, and the forest's depth."""
    import numpy as np
    T, N = len(trees), max(len(t) for t in trees)
    feat = np.full((T, N), -1, np.int32)
    thr, value = np.zeros((T, N)), np.zeros((T, N))
    left, right = np.zeros((T, N), np.int32), np.zeros((T, N), np.int32)
    depth = 0
    for t, tree in enumerate(trees):
        for i, nd in enumerate(tree):
            feat[t, i], thr[t, i], value[t, i] = nd.feature, nd.threshold, \
                nd.value
            left[t, i], right[t, i] = max(nd.left, 0), max(nd.right, 0)
        stack = [(0, 0)]
        while stack:
            i, d = stack.pop()
            depth = max(depth, d)
            if tree[i].feature >= 0:
                stack += [(tree[i].left, d + 1), (tree[i].right, d + 1)]
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (feat, thr, left, right, value)) + (depth,)


def reference_phase(torch, np, reqs, card, dev) -> dict:
    """Phase 19: the port's fit path, its single-forest kernel and its
    per-group serving path against the frozen reference fit path
    (``repro_torch.core.reference``)."""
    from repro_torch.api.oracle import LatencyOracle
    from repro_torch.core import reference, workloads
    from repro_torch.core.predictor import Profet, ProfetConfig
    from repro_torch.core.regressors import (RandomForestRegressor,
                                             bootstrap_plan)
    from repro_torch.kernels import forest_eval
    from repro_torch.serve import LatencyService

    t_phase = time.perf_counter()
    ds = workloads.generate()
    train, test = workloads.split_cases(ds.cases, test_frac=0.25, seed=0)
    out = {}

    # (a) the vectorized fit against its baseline, bench_fit's full mode
    cfg = ProfetConfig(seed=0)
    def fit_new():
        return Profet(cfg, device=dev).fit(ds, train,
                                           anchors=REFERENCE_ANCHORS)

    fit_new()                                  # untimed: warm
    new, new_s = timed_s(torch, fit_new)
    ref, ref_s = timed_s(torch, lambda: reference.fit_profet_reference(
        ds, cfg, train, anchors=REFERENCE_ANCHORS, device=dev))
    mape_new, mape_ref = (cross_mape(np, p, ds, test) for p in (new, ref))
    out["fit"] = {"anchors": list(REFERENCE_ANCHORS),
                  "pairs": len(new.cross), "n_train": len(train),
                  "n_test": len(test), "n_trees": cfg.n_trees,
                  "dnn_epochs": cfg.dnn_epochs, "vectorized_s": new_s,
                  "reference_s": ref_s, "reference_over_vectorized":
                  ref_s / new_s, "mape_vectorized": mape_new,
                  "mape_reference": mape_ref,
                  "mape_delta_pts": mape_new - mape_ref}
    print(f"phase 19 (a), cut: anchor {REFERENCE_ANCHORS[0]} only, "
          f"{len(new.cross)} of 12 pairs; {len(train)} train / {len(test)} "
          f"held-out cases, {cfg.n_trees} trees, {cfg.dnn_epochs} epochs: "
          f"{json.dumps(out['fit'])}; card: {card}")
    check(sorted(new.cross) == sorted(ref.cross) and len(new.cross) == 3,
          "both fits trained the same 3 pairs")
    check(mape_new - mape_ref <= MAPE_PARITY_PTS,
          f"vectorized fit's held-out cross MAPE {mape_new:.3f}% at most "
          f"{MAPE_PARITY_PTS} points above its reference's {mape_ref:.3f}% "
          f"(fit {new_s:.2f} s against {ref_s:.2f} s, "
          f"{ref_s / new_s:.2f}x; card: {card})")

    # (b) the grower, and the fused single-forest kernel, against the
    # recursive oracle, which never reads packed arrays
    ga, gt = ORACLE_PAIR
    X = new.feature_matrix([ds.profile(ga, c) for c in train], train)
    Xt = new.feature_matrix([ds.profile(ga, c) for c in test], test)
    y = np.array([ds.latency(gt, c) for c in train])
    rf = RandomForestRegressor(n_estimators=cfg.n_trees, seed=cfg.seed,
                               device=dev).fit(X, y)
    t0 = time.perf_counter()
    oracle_f = reference.ReferenceForest(n_estimators=cfg.n_trees,
                                         seed=cfg.seed).fit(X, y)
    grow_s = time.perf_counter() - t0
    f = rf.forest_
    W, _ = bootstrap_plan(cfg.seed, cfg.n_trees, len(y))
    walk = tie_walk(np, f, oracle_f, W, X, y)
    nodes = [int(c) for c in f.n_nodes]
    walk.update(
        trees=f.n_trees, nodes=sum(nodes),
        trees_equal_node_counts=sum(
            a == len(t) for a, t in zip(nodes, oracle_f.trees_)),
        trees_equal_split_multisets=sum(
            sorted((int(f.feat[t, i]), float(f.thr[t, i]))
                   for i in range(nodes[t]) if f.feat[t, i] >= 0) == ms
            for t, ms in enumerate(oracle_f.split_multiset())),
        recursive_grow_s=grow_s)
    print(f"phase 19 (b), pair {ORACLE_PAIR}, {len(y)} rows, "
          f"{f.n_trees} trees: {json.dumps(walk)}")
    check(walk["mismatched"] == 0 and walk["value_max_rel"] <= ORACLE_RTOL,
          f"the grower's {f.n_trees} trees equal the recursive oracle's "
          f"split for split up to exact SSE ties: {walk['equal']} equal "
          f"splits, {walk['ties_same_rows']} ties sending the same "
          f"in-bag rows each way, {walk['ties']} exact ties (rational "
          f"arithmetic) sending them apart (their subtrees not compared), "
          f"none else; node values within {walk['value_max_rel']:.2e} "
          f"relative")
    # the kernel on the oracle's own trees, packed from its node lists,
    # against its recursive walk of them; and on the grower's trees, where
    # the ties route out-of-bag and held-out rows their own way
    packed = pack_node_lists(torch, oracle_f.trees_, dev)
    forest_eval.reset_launches()
    on_oracle = {k: forest_eval.predict(
        torch.from_numpy(Z).to(dev), *packed[:5], depth=packed[5]
    ).cpu().numpy() for k, Z in (("train", X), ("held_out", Xt))}
    on_grower = {"train": rf.predict(X), "held_out": rf.predict(Xt)}
    launches, plain = dict(forest_eval.launches), dict(forest_eval.plain_calls)
    check(launches["predict"] == 4 and sum(launches.values()) == 4
          and not any(plain.values()),
          f"the fused single-forest kernel answered all 4 calls "
          f"({launches['predict']} launches, no other route, "
          f"{sum(plain.values())} plain calls; oracle's trees packed "
          f"{tuple(packed[0].shape)}, depth {packed[5]})")
    errs, grower_errs = {}, {}
    for name, Z in (("train", X), ("held_out", Xt)):
        want = oracle_f.predict(Z)
        errs[name] = float(np.max(np.abs(on_oracle[name] - want)))
        grower_errs[name] = float(np.max(np.abs(on_grower[name] - want)))
        check(np.allclose(on_oracle[name], want, rtol=ORACLE_RTOL,
                          atol=ORACLE_ATOL),
              f"{name}: the kernel's {len(Z)} predictions over the oracle's "
              f"trees within rtol {ORACLE_RTOL}, atol {ORACLE_ATOL} of its "
              f"recursive host walk (max abs err {errs[name]}); over the "
              f"grower's trees {grower_errs[name]} from it (ties)")
    out["oracle"] = dict(walk, pair=list(ORACLE_PAIR), depth=int(f.depth),
                         launches=launches, max_abs_err=errs,
                         grower_kernel_vs_recursive_max_abs=grower_errs)

    # (c) an ensemble the bank cannot stack serves per group, on the card
    # as on the CPU
    cfg_c = ProfetConfig(members=("linear", "forest"), n_trees=5, seed=0)
    oracles = {d: LatencyOracle(reference.fit_profet_reference(
        ds, cfg_c, device=d), ds) for d in (dev, "cpu")}
    card_o = oracles[dev]
    check(card_o.bank is None and card_o.bank_error is None
          and oracles["cpu"].bank is None,
          f"reference fit of {len(card_o.pairs())} pairs: no bank and no "
          "bank error, on the card and on the CPU")
    svc = LatencyService(card_o, max_wave=64)
    check(not svc.stats.degraded, "per-group service warm-up")
    batches = []
    execute = card_o.execute

    def recording_execute(*a, **kw):
        batches.append(execute(*a, **kw))
        return batches[-1]

    card_o.execute = recording_execute
    forest_eval.reset_launches()
    t0 = time.perf_counter()
    lat = served(np, svc, reqs)
    serve_s = time.perf_counter() - t0
    card_o.execute = execute
    s = svc.stats
    launches, plain = dict(forest_eval.launches), dict(forest_eval.plain_calls)
    lat_cpu = served(np, LatencyService(oracles["cpu"], max_wave=64), reqs)
    check(len(lat) == len(reqs) == s.requests and s.errors == 0
          and np.isfinite(lat).all(),
          f"{s.requests} of {len(reqs)} requests answered, {s.errors} "
          f"errors, in {s.waves} waves ({serve_s:.2f} s)")
    check(len(batches) == s.waves and not any(x.banked for x in batches)
          and s.fused_calls == sum(x.fused_calls for x in batches)
          and not s.degraded,
          f"no wave banked: {s.waves} waves answered by {s.fused_calls} "
          f"fused ensemble calls, one per (anchor, target) group")
    check(not any(launches.values()) and not any(plain.values()),
          f"no forest kernel and no plain version ran: the recursive "
          f"forests walk on the host ({launches}, {plain})")
    check(np.array_equal(lat, lat_cpu),
          "the card's answers equal the CPU oracle's bit for bit")
    out["per_group"] = {"pairs": len(card_o.pairs()),
                        "requests": s.requests, "waves": s.waves,
                        "banked_waves": sum(x.banked for x in batches),
                        "group_calls": s.fused_calls, "serve_s": serve_s}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 19 (the reference fit path): {out['wall_s']:.1f} s; "
          f"{json.dumps(out['per_group'])}")
    return out


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------


def median_ms(torch, fn, calls=5):
    """Median time of one ``fn()`` between CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[calls // 2]


def lm_launches() -> dict:
    from repro_torch.kernels import adamw as aw_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import selective_scan as ss_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    return {**fa_mod.launches, **ssd_mod.launches, **aw_mod.launches,
            **ss_mod.launches}


def norm_launches() -> dict:
    """The norm kernel's launches in this process since the last
    :func:`lm_reset_launches` (forward, backward)."""
    from repro_torch.kernels import rms_norm as rn_mod
    return dict(rn_mod.launches)


def lm_reset_launches() -> None:
    from repro_torch.kernels import adamw as aw_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import rms_norm as rn_mod
    from repro_torch.kernels import selective_scan as ss_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    fa_mod.reset_launches()
    ssd_mod.reset_launches()
    aw_mod.reset_launches()
    rn_mod.reset_launches()
    ss_mod.reset_launches()


def lm_prefill(torch, np, arch, kernel, args, dev) -> dict:
    """Phases 6 and 7: one model's prefill step at full width on (4, 2048)
    tokens. Returns the model, its config, the kernel's inputs on the main
    path and the phase's report."""
    from repro_torch.configs import base as CB
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = CB.get_config(arch)
    t0 = time.perf_counter()
    model32 = M.init(cfg, seed=args.seed, device=dev)
    # round the float32 params to bf16 values in place, so that the float32
    # plain run below computes the served bf16 model's function in float32
    with torch.no_grad():
        for t in model32.state_dict().values():
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model32.parameters())
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_SEQ))).to(dev)
    batch = {"tokens": tokens}
    pv = L.padded_vocab(cfg.vocab_size)

    # the model through the kernel against the plain version, in float32
    # end to end, at the CPU parity tests' float32 bar
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    last32 = M.forward(model32, cfg32, batch)[0][:, -1]
    plain32 = M.forward(model32, cfg32, batch, backend="torch")[0][:, -1]
    err32 = float((last32 - plain32).abs().max())
    check(bool(torch.allclose(last32, plain32, atol=1e-4, rtol=1e-4)),
          f"{arch} float32 last-position logits through the {kernel} kernel "
          f"equal the plain version's within atol 1e-4 rtol 1e-4 (max abs "
          f"diff {err32:.3e}, max |logit| {float(plain32.abs().max()):.3f})")
    del last32

    # the main path: bf16 params, as the prefill step is served
    model = M.cast(model32, cfg, torch.bfloat16)
    del model32
    torch.cuda.empty_cache()
    step = make_prefill_step(cfg)

    # record the kernel's inputs of the first block on the main path
    mod = fa_mod if kernel == "flash_attention" else ssd_mod
    launch = getattr(mod, kernel)
    seen = []

    def recording(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return launch(*a, **kw)

    setattr(mod, kernel, recording)
    lm_reset_launches()
    nxt = step(model, batch)
    torch.cuda.synchronize()
    counts = lm_launches()
    setattr(mod, kernel, launch)
    other = "ssd_scan" if kernel == "flash_attention" else "flash_attention"
    check(counts[kernel] == cfg.num_layers and counts[other] == 0,
          f"{arch} prefill: {counts[kernel]} {kernel} launches, one per "
          f"block ({cfg.num_layers}), and {counts[other]} {other}")
    check(tuple(nxt.shape) == (LM_BATCH, 1) and nxt.dtype == torch.int32
          and bool(((nxt >= 0) & (nxt < pv)).all()),
          f"{arch} prefill: ({LM_BATCH}, 1) int32 next tokens in [0, {pv})")

    # in bf16 the kernel's run and the plain run round differently after
    # every block; each is held against the float32 plain run of the same
    # (bf16-valued) params, and the kernel's run may stray from it at most
    # BF16_VS_PLAIN times as far as the plain run does
    last = M.forward(model, cfg, batch)[0][:, -1].float()
    plain = M.forward(model, cfg, batch, backend="torch")[0][:, -1].float()
    check(bool(torch.isfinite(last).all())
          and tuple(last.shape) == (LM_BATCH, pv),
          f"{arch} bf16 last-position logits finite, ({LM_BATCH}, {pv})")
    err = float((last - plain).abs().max())
    err_k = float((last - plain32).abs().max())
    err_p = float((plain - plain32).abs().max())
    same = int((last.argmax(-1) == plain.argmax(-1)).sum())
    print(f"{arch} bf16 logits against the plain {kernel}: max abs diff "
          f"{err:.3e}, max |logit| {float(plain.abs().max()):.3f}, "
          f"{same} of {LM_BATCH} next tokens equal")
    check(err_k <= BF16_VS_PLAIN * err_p,
          f"{arch} bf16 logits through the {kernel} kernel stray from the "
          f"float32 plain run {err_k:.3e}, within {BF16_VS_PLAIN} x the bf16 "
          f"plain run's {err_p:.3e}")
    del plain32

    lm_reset_launches()
    calls = 5
    ms = median_ms(torch, lambda: step(model, batch), calls=calls)
    check(lm_launches()[kernel] == cfg.num_layers * (calls + 1),
          f"{arch}: {cfg.num_layers} {kernel} launches per timed call")
    rep = {"params": n_params, "init_s": init_s, "launches": counts[kernel],
           "step_ms": ms, "tokens_per_s": LM_BATCH * LM_SEQ / ms * 1e3,
           "f32_logits_max_abs_diff_vs_plain": err32,
           "logits_max_abs_diff_vs_plain": err,
           "bf16_kernel_vs_f32_plain": err_k,
           "bf16_plain_vs_f32_plain": err_p,
           "next_token_equal_vs_plain": same,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{arch} prefill: {json.dumps(rep)}")
    return {"cfg": cfg, "model": model, "seen": seen[0], "report": rep,
            "step": step, "batch": batch}


# the LM engine runs of phases 8, 14 and 17: requests, slots, new tokens,
# cache length (continuous mode)
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW, SERVE_MAX_LEN = 8, 4, 16, 128


def serve_prompts(np, cfg, seed) -> list:
    """The engine runs' prompts, drawn as ``launch/serve.py`` does."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(SERVE_REQUESTS):
        plen = int(rng.integers(2, 12))
        out.append(rng.integers(1, min(cfg.vocab_size, 1000),
                                size=plen).tolist())
    return out


def lm_serve(torch, np, arch, cfg, model, args, keep_tokens=False) -> dict:
    """Phase 7: 8 requests through ``Engine`` (4 slots, 16 new tokens,
    max_len 128, continuous), prompts drawn as ``launch/serve.py`` does.
    With ``keep_tokens`` the report adds the tokens and the completion
    order (not printed), which phase 17 holds its mesh engine against."""
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import Engine

    eng = Engine(cfg, model, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    reqs = [eng.submit(p, max_new_tokens=SERVE_NEW)
            for p in serve_prompts(np, cfg, args.seed)]
    lm_reset_launches()
    done = eng.run()
    torch.cuda.synchronize()
    pv = L.padded_vocab(cfg.vocab_size)
    s = eng.stats
    check(all(r.done and len(r.output) == 16
              and all(0 <= t < pv for t in r.output) for r in reqs)
          and sum(lm_launches().values()) == 0,
          f"{arch} engine: 8 requests, 16 tokens each in [0, {pv}), no "
          f"kernel launched")
    rep = {"requests": len(reqs), "decode_steps": s.decode_steps,
           "prefill_tokens": s.prefill_tokens,
           "generated_tokens": s.generated_tokens, "wall_s": s.wall_s,
           "tokens_per_s": s.tokens_per_s,
           "beyond_vocab_tokens": sum(t >= cfg.vocab_size for r in reqs
                                      for t in r.output)}
    print(f"{arch} serve: {json.dumps(rep)}")
    if keep_tokens:
        rep.update(outputs=[r.output for r in reqs],
                   order=[r.uid for r in done])
    return rep


def sass_hmma(name) -> int:
    """Tensor-core (``HMMA``) instructions in the SASS of the library built
    from ``csrc/<name>.cu``, read with the toolkit's ``cuobjdump``."""
    from repro_torch.kernels import _build
    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def lm_kernel_checks(torch, np, flash_in, ssd_in, dev) -> tuple:
    """Phase 8: each kernel against its plain version at the main path's
    inputs and at random shapes, bf16 launches repeatable bit for bit, and
    tensor-core instructions in the SASS. Returns (max abs error at the
    main path's inputs per kernel, the cases checked, HMMA counts)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    rng = np.random.default_rng(1)

    def randn(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=dtype)

    def tol(dtype):
        return dict(atol=6e-3, rtol=3e-2) if dtype == torch.bfloat16 \
            else dict(atol=2e-5, rtol=1e-4)

    cases = []
    (q, k, v), _ = flash_in
    flash_sets = [("main path", q, k, v)]
    for B, S, H, KV, D, dt in [(2, 512, 32, 8, 64, torch.float32),
                               (2, 300, 8, 1, 128, torch.bfloat16),
                               (1, 1024, 16, 16, 128, torch.bfloat16),
                               (1, 300, 4, 2, 64, torch.float32),
                               (1, 1000, 8, 2, 16, torch.bfloat16),
                               (2, 300, 4, 4, 32, torch.bfloat16),
                               (1, 1000, 8, 1, 64, torch.bfloat16)]:
        flash_sets.append((f"{(B, S, H, KV, D)} {dt}".replace("torch.", ""),
                           randn((B, S, H, D), dt), randn((B, S, KV, D), dt),
                           randn((B, S, KV, D), dt)))
    errs = {}
    for name, q, k, v in flash_sets:
        got = fa_mod.flash_attention(q, k, v).float()
        want = fa_mod.flash_attention(q, k, v, backend="torch").float()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        errs.setdefault("flash_attention", e)
        ok = bool(torch.allclose(got, want, **tol(q.dtype)))
        cases.append({"kernel": "flash_attention", "case": name,
                      "max_abs_err": e, "ok": ok})
        check(ok, f"flash_attention kernel equals its plain version, "
              f"{name} (max abs err {e:.3e})")

    (X, Adt, Bc, Cc), kw = ssd_in
    ssd_sets = [("main path", X, Adt, Bc, Cc, kw["chunk"])]
    for B, S, H, P, N, dt, chunk in [
            (2, 512, 8, 64, 128, torch.float32, 64),
            (1, 1024, 4, 64, 128, torch.bfloat16, 256),
            (1, 192, 2, 32, 64, torch.float32, 64),
            (1, 512, 4, 32, 64, torch.bfloat16, 64),
            (2, 512, 2, 128, 128, torch.bfloat16, 128),
            (1, 4096, 2, 64, 128, torch.bfloat16, 256),
            (1, 4096, 1, 128, 64, torch.bfloat16, 256)]:
        ssd_sets.append((
            f"{(B, S, H, P, N)} {dt} chunk {chunk}".replace("torch.", ""),
            randn((B, S, H, P), dt),
            -torch.nn.functional.softplus(randn((B, S, H), torch.float32))
            * 0.5, randn((B, S, N), dt), randn((B, S, N), dt), chunk))
    for name, X, Adt, Bc, Cc, chunk in ssd_sets:
        got = ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=chunk).float()
        want = ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=chunk,
                                backend="torch").float()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        errs.setdefault("ssd_scan", e)
        scale = float(want.abs().max())
        ok = bool(torch.allclose(got / scale, want / scale, **tol(X.dtype)))
        cases.append({"kernel": "ssd_scan", "case": name, "max_abs_err": e,
                      "max_abs_ref": scale, "ok": ok})
        check(ok, f"ssd_scan kernel equals its plain version, {name} (max "
              f"abs err {e:.3e}, max |ref| {scale:.3f})")

    # no atomics and a fixed order of every sum: the same bits twice
    (q, k, v), _ = flash_in
    check(torch.equal(fa_mod.flash_attention(q, k, v),
                      fa_mod.flash_attention(q, k, v)),
          "flash_attention: two bf16 launches at the main path's inputs "
          "give the same bits")
    (X, Adt, Bc, Cc), kw = ssd_in
    check(torch.equal(
        ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=kw["chunk"]),
        ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=kw["chunk"])),
        "ssd_scan: two bf16 launches at the main path's inputs give the "
        "same bits")

    hmma = {n: sass_hmma(n) for n in ("flash_attention", "ssd_scan")}
    for n, count in hmma.items():
        check(count > 0, f"{n}.cu SASS holds {count} HMMA (tensor-core) "
              f"instructions")
    return errs, cases, hmma


def kernel_row(torch, name, source, replaces, kern, plain, lib, work,
               dtype, launches, err, tag="") -> dict:
    """One LM kernel's line: its time at these inputs beside its bound (at
    the peak of the inputs' dtype), its plain version's time and the
    library call's (None where there is none)."""
    b_ms, b_by = bound_ms(*work, ops_per_s=(
        BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S))
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/csrc/{source}.cu",
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": time_kernel_ms(torch, kern, iters=10),
           "plain_ms": time_plain_ms(torch, plain, iters=3),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": (time_kernel_ms(torch, lib, iters=20)
                          if lib is not None else None)}
    print(f"{name}{tag}: {json.dumps(row)} (bytes {work[0]}, operations "
          f"{work[1]})")
    return row


def flash_runs(fa_mod, F, q, k, v) -> tuple:
    """The flash kernel, its plain version and SDPA (causal, GQA) on the
    same q, k, v."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return (lambda: fa_mod.flash_attention(q, k, v),
            lambda: fa_mod.flash_attention(q, k, v, backend="torch"),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True,
                                                   enable_gqa=True))


def lm_kernel_rows(torch, flash_in, ssd_in, counts, errs, tag="") -> list:
    """The LM kernels' lines at the main path's inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    (q, k, v), _ = flash_in
    (X, Adt, Bc, Cc), kw = ssd_in
    chunk = kw["chunk"]
    return [
        kernel_row(torch, "flash_attention", "flash_attention",
                   "src/repro/kernels/flash_attention.py:74",
                   *flash_runs(fa_mod, F, q, k, v), fa_mod.work(q, k),
                   q.dtype, counts["flash_attention"],
                   errs["flash_attention"], tag),
        kernel_row(torch, "ssd_scan", "ssd_scan",
                   "src/repro/kernels/ssd_scan.py:70",
                   lambda: ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=chunk),
                   lambda: ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=chunk,
                                            backend="torch"),
                   None, ssd_mod.work(X, Bc, chunk), X.dtype,
                   counts["ssd_scan"], errs["ssd_scan"], tag)]


def lm_f32_rows(torch, flash_in, ssd_in) -> list:
    """The float32 route (CUDA-core kernels) at the main path's shapes: the
    same inputs cast to float32, held against the plain versions at the
    float32 bar, and lines as ``lm_kernel_rows`` makes them (no launch on
    the main path, which is bf16)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    (q, k, v), _ = flash_in
    (X, Adt, Bc, Cc), kw = ssd_in
    q, k, v, X, Bc, Cc = (t.float() for t in (q, k, v, X, Bc, Cc))
    errs = {}
    for name, run, scale in [
            ("flash_attention",
             lambda b: fa_mod.flash_attention(q, k, v, backend=b), False),
            ("ssd_scan",
             lambda b: ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=kw["chunk"],
                                        backend=b), True)]:
        got, want = run("auto"), run("torch")
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        div = float(want.abs().max()) if scale else 1.0
        check(bool(torch.allclose(got / div, want / div, atol=2e-5,
                                  rtol=1e-4)),
              f"{name} float32 kernel equals its plain version at the main "
              f"path's shapes (max abs err {errs[name]:.3e})")
    return lm_kernel_rows(torch, ((q, k, v), {}), ((X, Adt, Bc, Cc), kw),
                          {"flash_attention": 0, "ssd_scan": 0}, errs,
                          tag=" (float32)")


def lm_phases(torch, np, args, dev, report) -> list:
    """Phases 6 to 10; returns the LM kernels' lines."""
    runs = {}
    for arch, kernel in (("llama3.2-1b", "flash_attention"),
                         ("mamba2-130m", "ssd_scan")):
        runs[kernel] = lm_prefill(torch, np, arch, kernel, args, dev)
    counts = {k: r["report"]["launches"] for k, r in runs.items()}
    report["lm_prefill"] = {k: r["report"] for k, r in runs.items()}
    report["lm_serve"] = {k: lm_serve(torch, np, r["cfg"].name, r["cfg"],
                                      r["model"], args, keep_tokens=True)
                          for k, r in runs.items()}
    errs, cases, hmma = lm_kernel_checks(
        torch, np, runs["flash_attention"]["seen"], runs["ssd_scan"]["seen"],
        dev)
    report["lm_kernel_cases"] = cases
    report["sass_hmma"] = hmma
    rows = lm_kernel_rows(torch, runs["flash_attention"]["seen"],
                          runs["ssd_scan"]["seen"], counts, errs)
    report["lm_f32_kernels"] = lm_f32_rows(
        torch, runs["flash_attention"]["seen"], runs["ssd_scan"]["seen"])
    report["lm_trace"] = {}
    for k, r in runs.items():
        tr = traced(torch, lambda: r["step"](r["model"], r["batch"]))
        report["lm_trace"][k] = tr
        print(f"{r['cfg'].name} traced prefill: {json.dumps(tr)}")
    return rows

# ---------------------------------------------------------------------------
# the LM training path (phase 13)
# ---------------------------------------------------------------------------

# the gradient check's float32 bar, per tensor: max |kernel grad - plain
# grad| <= RTOL_GRAD_F32 x max |plain grad|. The Functions' backward is
# the same on both paths, so the gap comes from the float32 kernels'
# forward alone. On an H100 80GB HBM3 (700 W limit) the worst tensors
# measured 1.55e-6 (llama3.2-1b) and 4.46e-6 (mamba2-130m): the bar
# leaves ~20x above the larger and sits 1e4 below a cut branch's gap (1.0)
RTOL_GRAD_F32 = 1e-4
# the bf16 per-tensor rule's least plain gap, relative to the tensor's max
# float32 gradient: an eighth of bf16's spacing at 1.0 (2**-7), so a tensor
# whose plain path happens to round like float32 is held to 2x 2**-10
BF16_GRAD_FLOOR = 2.0 ** -10
# a SMOKE train step's loss and grad norm, card against CPU
RTOL_TRAIN_CARD_VS_CPU = 1e-4
TRAIN_GRAD_LAYERS = 2


def kernel_layers(cfg, kernel="flash_attention") -> int:
    """Layers whose forward calls ``kernel``'s wrapper once, so its counted
    launches in one prefill, from the config: for flash attention the
    causal self-attention layers (the transformer's blocks, the Whisper
    decoder's, the hybrid_moe's attention layers; none for the hybrid,
    whose layers all have a window and take the plain local attention, or
    for the ssm; jamba's attention layers); for the SSD scan the ssm's
    Mamba-2 blocks and the hybrid_moe's Mamba layers; for the selective
    scan jamba's Mamba-1 layers."""
    if cfg.family in ("hybrid_moe", "jamba"):
        pat = cfg.hybrid_pattern
        kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
        return kinds.count({"ssd_scan": "mamba", "selective_scan": "mamba1",
                            "flash_attention": "attention"}[kernel])
    if kernel == "selective_scan":
        return 0
    if kernel == "ssd_scan":
        return cfg.num_layers if cfg.family == "ssm" else 0
    return 0 if cfg.family in ("hybrid", "ssm") else cfg.num_layers


def per_train_step(cfg, kernel="flash_attention") -> tuple:
    """(launches, backward recomputes) of ``kernel`` in one train step on the
    card, from the config: each layer of :func:`kernel_layers` launches it
    in the forward and, with ``cfg.remat``, again when
    ``torch.utils.checkpoint`` recomputes its block in the backward (each
    forward launches through the kernel's Function); each Function's
    backward runs once and recomputes: flash attention's the scores, a
    block of queries at a time, the SSD scan's ``ssd_chunked``, but with
    bfloat16 activations the SSD scan launches the backward kernel instead
    (:func:`ssd_backward_launches`)."""
    n = kernel_layers(cfg, kernel)
    return n * (2 if cfg.remat else 1), n - ssd_backward_launches(cfg, kernel)


def ssd_backward_launches(cfg, kernel="ssd_scan") -> int:
    """Launches of the SSD scan's backward kernel in one train step on the
    card: one per SSD layer when the activations are bfloat16, none in
    float32 (each backward recomputes ``ssd_chunked``) or for another
    kernel."""
    if kernel != "ssd_scan" or cfg.dtype != "bfloat16":
        return 0
    return kernel_layers(cfg, "ssd_scan")


def scan_launches(cfg) -> dict:
    """Launches of the selective scan's forward and backward kernels (one
    each a call) in one train step on the card, from the config: the
    forward once a Mamba-1 layer and again in its remat recompute, the
    backward once a layer."""
    n = kernel_layers(cfg, "selective_scan")
    return {"selective_scan": n * (2 if cfg.remat else 1),
            "selective_scan_backward": n}


def train_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    return {**lm_launches(),
            "flash_attention/backward": fa_mod.backward_recomputes[
                "flash_attention"],
            "ssd_scan/backward": ssd_mod.backward_recomputes["ssd_scan"]}


def device_batch(torch, np, cfg, dev, seed, index=0, seq=LM_SEQ):
    from repro_torch.data import pipeline as DP
    b = DP.make_pipeline(cfg, seq_len=seq, global_batch=LM_BATCH,
                         seed=seed).batch_at(index)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


# phase 18: the train step's peak allocation, over what was allocated
# before its Trainer, may differ from the dry-run's prediction (arguments
# plus the counter's peak of temporaries) by this share of the prediction
MEM_VS_PREDICTED = 0.05


def lm_train(torch, np, cfg, kernel, args, dev, ckpt_dir=None, seq=LM_SEQ,
             hp=None, pred=None, batch=LM_BATCH) -> dict:
    """``Trainer.run`` of ``cfg`` for ``args.train_steps`` steps on
    (``batch``, ``seq``) tokens, float32 params, bf16 activations, remat; Adam state
    as ``hp`` says (the trainer's own by default: float32). Phase 13: the
    dense and ssm models at full width and depth; with ``ckpt_dir`` it
    checkpoints mid-run and checks the restore on the card and on the CPU.
    Phase 18: the remaining families at the dry-run's cut (``pred``, its
    prediction): the vlm gates set to ``VLM_GATES`` before the first step,
    and the peak allocation and step time held against the prediction."""
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.trainer import Trainer, TrainConfig

    arch = cfg.name
    steps = args.train_steps
    # derived from the config before the run (per_train_step)
    per_step, per_step_backward = per_train_step(cfg, kernel)
    derived = {k: per_train_step(cfg, k) for k in LM_KERNELS}
    mid = steps // 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainConfig(seq_len=seq, global_batch=batch,
                                  num_steps=steps, log_every=0,
                                  ckpt_every=mid if ckpt_dir else 0,
                                  ckpt_dir=ckpt_dir, seed=args.seed),
                 hp, device=dev)
    set_vlm_gates(torch, tr.model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tr.model.parameters())

    lm_reset_launches()
    tr.train_one()
    c1 = train_counts()
    check(all((c1[k], c1[f"{k}/backward"]) == derived[k]
              for k in LM_KERNELS),
          f"{arch} train step 1: launches and backward recomputes "
          f"{ {k: (c1[k], c1[f'{k}/backward']) for k in LM_KERNELS} } "
          f"(derived {derived}: {cfg.num_layers} blocks, forward and remat "
          f"recompute)")
    check(c1["ssd_scan_backward"] == ssd_backward_launches(cfg),
          f"{arch} train step 1: {c1['ssd_scan_backward']} SSD backward "
          f"kernel launches (derived {ssd_backward_launches(cfg)})")
    scans = scan_launches(cfg)
    check(all(c1[k] == n for k, n in scans.items()),
          f"{arch} train step 1: selective-scan launches "
          f"{ {k: c1[k] for k in scans} } (derived {scans})")
    check(c1["adamw_sumsq"] == c1["adamw_update"] == 1,
          f"{arch} train step 1: {c1['adamw_sumsq']} adamw_sumsq and "
          f"{c1['adamw_update']} adamw_update launches (1 each)")
    bad = [k for k, p in tr.params.items()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool((p.grad != 0).any())]
    check(not bad, f"{arch} after step 1 every one of {len(tr.params)} "
          f"parameters' .grad is finite and not all zero (bad: {bad[:5]})")

    snap = {}

    def on_step(step, _):
        if ckpt_dir and step == mid:   # what the trainer saves next
            snap.update(
                params={k: p.detach().cpu().clone()
                        for k, p in tr.params.items()},
                m={k: t.cpu().clone() for k, t in tr.opt_state["m"].items()},
                v={k: t.cpu().clone() for k, t in tr.opt_state["v"].items()},
                step=int(tr.opt_state["step"]))

    tr.run(on_step=on_step)
    torch.cuda.synchronize()
    counts = train_counts()
    check(all((counts[k], counts[f"{k}/backward"])
              == (derived[k][0] * steps, derived[k][1] * steps)
              for k in LM_KERNELS),
          f"{arch} Trainer.run, {steps} steps: launches and backward "
          f"recomputes "
          f"{ {k: (counts[k], counts[f'{k}/backward']) for k in LM_KERNELS} }"
          f" ({derived} a step)")
    check(counts["ssd_scan_backward"] == ssd_backward_launches(cfg) * steps,
          f"{arch} Trainer.run, {steps} steps: "
          f"{counts['ssd_scan_backward']} SSD backward kernel launches "
          f"({ssd_backward_launches(cfg)} a step)")
    check(all(counts[k] == n * steps for k, n in scans.items()),
          f"{arch} Trainer.run, {steps} steps: selective-scan launches "
          f"{ {k: counts[k] for k in scans} } ({scans} a step)")
    check(counts["adamw_sumsq"] == counts["adamw_update"] == steps,
          f"{arch} Trainer.run, {steps} steps: {counts['adamw_sumsq']} "
          f"adamw_sumsq and {counts['adamw_update']} adamw_update launches "
          f"(1 each a step)")
    losses = [h["loss"] for h in tr.history]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(all(np.isfinite(losses)) and last < first,
          f"{arch}: {steps} finite losses, the last 3 mean {last:.4f} below "
          f"the first 3 mean {first:.4f}")
    times = [h["step_time_s"] for h in tr.history[1:]]
    step_ms = 1e3 * float(np.median(times))
    peak = torch.cuda.max_memory_allocated()
    rep = {"params": n_params, "init_s": init_s, "steps": steps,
           "losses": losses, "step_ms": step_ms,
           "step_ms_all": [1e3 * h["step_time_s"] for h in tr.history],
           "tokens_per_s": batch * seq / step_ms * 1e3,
           "peak_mem_gb": peak / 1e9,
           "peak_over_base_gb": (peak - base) / 1e9,
           # cudaMalloc retries after freeing the cache in this run: a
           # step near the card's capacity pays for them in host time
           "alloc_retries": torch.cuda.memory_stats().get(
               "num_alloc_retries", 0) - retries,
           # measured: the counts of this run over its steps
           "launches_per_step": counts[kernel] // steps,
           "backward_recomputes_per_step":
               counts[f"{kernel}/backward"] // steps,
           "launches": counts[kernel],
           "backward_recomputes": counts[f"{kernel}/backward"],
           "kernel_launches": {k: counts[k] for k in LM_KERNELS},
           "ssd_backward_launches": counts["ssd_scan_backward"],
           "scan_launches": {k: counts[k] for k in scans},
           "adamw_launches": {k: counts[k]
                              for k in ("adamw_sumsq", "adamw_update")},
           # the norm kernel's (not among the LM kernels the checks sum)
           "norm_launches": norm_launches(),
           "grad_norms": [h["grad_norm"] for h in tr.history]}
    if pred is not None:
        want = pred["predicted_bytes"]
        rep.update(predicted_gb=want / 1e9, bound_ms=pred["bound_ms"])
        check(abs(peak - base - want) <= MEM_VS_PREDICTED * want,
              f"{arch} Trainer.run: peak allocation {(peak - base) / 1e9:.3f}"
              f" GB over the {base / 1e9:.3f} GB before the Trainer, within "
              f"{MEM_VS_PREDICTED:.0%} of the dry-run's prediction "
              f"{want / 1e9:.3f} GB")
        check(step_ms >= pred["bound_ms"],
              f"{arch} Trainer.run: step {step_ms:.1f} ms (median of steps "
              f"2-{steps}) at or above the dry-run's roofline bound "
              f"{pred['bound_ms']:.1f} ms ({pred['bottleneck']})")

    if ckpt_dir:
        like = {"params": tr.params, "opt": tr.opt_state,
                "data_index": np.int32(0)}
        for where in (dev, torch.device("cpu")):
            got = CKPT.restore(ckpt_dir, mid, like, device=where)
            same = (all(torch.equal(got["params"][k].cpu(), t)
                        for k, t in snap["params"].items())
                    and all(torch.equal(got["opt"][part][k].cpu(), t)
                            for part in ("m", "v")
                            for k, t in snap[part].items())
                    and int(got["opt"]["step"]) == snap["step"] == mid
                    and int(got["data_index"]) == mid
                    and all(t.device.type == where.type
                            for t in got["params"].values()))
            check(same, f"{arch}: the step-{mid} checkpoint saved on the "
                  f"card restores on {where.type} bit for bit (params, "
                  f"Adam moments, step, data index)")
        fresh = Trainer(cfg, TrainConfig(seq_len=seq,
                                         global_batch=LM_BATCH,
                                         num_steps=steps, ckpt_dir=ckpt_dir,
                                         seed=args.seed + 1), device=dev)
        check(fresh.maybe_restore() and fresh.step == steps
              and all(torch.equal(p, tr.params[k])
                      for k, p in fresh.params.items())
              and fresh.data.index == steps,
              f"{arch}: a fresh Trainer on the card resumes from the step-"
              f"{steps} checkpoint, params bit for bit")
        del fresh
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    rep["trace"] = traced(torch, tr.train_one)
    rep["trace"]["alloc_retries"] = torch.cuda.memory_stats().get(
        "num_alloc_retries", 0) - retries
    print(f"{arch} train: {json.dumps(rep)}")
    del tr
    torch.cuda.empty_cache()
    return rep


def lm_grad_check(torch, np, cfg, kernel, args, dev, seq=LM_SEQ) -> dict:
    """One step's parameter gradients of ``cfg`` (phase 13: full width and
    TRAIN_GRAD_LAYERS layers; phase 18: the dry-run's cut), (4, ``seq``)
    tokens, through the kernel (its Function: the kernel's forward, the
    reference's gradient recomputed) against the plain path
    (``backend="torch"``: the kernel's plain version through the same
    Function). float32: per tensor within RTOL_GRAD_F32 of its largest
    plain gradient. bf16, per tensor: the kernel path's gradient at most
    BF16_VS_PLAIN times as far from the float32 plain gradient as the bf16
    plain path's, or as BF16_GRAD_FLOOR if that is larger (each gap
    relative to the tensor's max |float32 plain grad|). The float32 plain
    gradients wait on the host, so that the card holds one set of
    gradients at a time; the vlm gates are ``VLM_GATES``."""
    from repro_torch.models import model as M

    arch = cfg.name
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = M.init(cfg, seed=args.seed, device=dev).requires_grad_(True)
    set_vlm_gates(torch, model)
    batch = device_batch(torch, np, cfg, dev, args.seed, seq=seq)
    # counted over the float32 runs, which recompute in every backward
    launches, recomputes = per_train_step(cfg32, kernel)

    def grads(c, backend):
        for p in model.parameters():
            p.grad = None
        loss, _ = M.loss_fn(model, c, batch, backend=backend)
        loss.backward()
        return {k: p.grad for k, p in model.named_parameters()}

    def rel(g, want):
        out = {}
        for k, w in want.items():
            w = w.to(dev)
            out[k] = float((g[k] - w).abs().max()) / float(w.abs().max())
        return out

    lm_reset_launches()
    g32 = {k: g.cpu() for k, g in grads(cfg32, "torch").items()}
    n = train_counts()
    k32 = grads(cfg32, "auto")
    m = train_counts()
    check(n[kernel] == 0 and m[kernel] == launches
          and n[f"{kernel}/backward"] == recomputes
          and m[f"{kernel}/backward"] == 2 * recomputes
          and all(n[k] == 0 and m[k] == per_train_step(cfg32, k)[0]
                  for k in LM_KERNELS)
          and m["ssd_scan_backward"] == 0,
          f"{arch} gradient check: the kernel path launched {kernel} "
          f"{m[kernel]} times (derived {launches}: forward and remat "
          f"recompute), the plain path {n[kernel]}; "
          f"{m[f'{kernel}/backward'] - n[f'{kernel}/backward']} and "
          f"{n[f'{kernel}/backward']} backward recomputes (derived "
          f"{recomputes})")
    dead = [k for k, g in k32.items() if not bool((g != 0).any())]
    check(not dead, f"{arch} float32 kernel-path gradients: none all zero "
          f"({dead[:5]})")
    r32 = rel(k32, g32)
    worst32 = max(r32, key=r32.get)
    check(r32[worst32] <= RTOL_GRAD_F32,
          f"{arch} float32 gradients through the {kernel} kernel: every "
          f"tensor within {RTOL_GRAD_F32} x its max |plain grad| (worst "
          f"{worst32} {r32[worst32]:.3e})")
    del k32
    k16 = rel(grads(cfg, "auto"), g32)
    bwd = train_counts()["ssd_scan_backward"]
    check(bwd == ssd_backward_launches(cfg, kernel),
          f"{arch} gradient check: the bf16 kernel path launched the SSD "
          f"backward kernel {bwd} times (derived "
          f"{ssd_backward_launches(cfg, kernel)})")
    p16 = rel(grads(cfg, "torch"), g32)
    ratio = {k: k16[k] / max(p16[k], BF16_GRAD_FLOOR) for k in k16}
    worst16 = max(ratio, key=ratio.get)
    check(ratio[worst16] <= BF16_VS_PLAIN,
          f"{arch} bf16 gradients through the {kernel} kernel: every "
          f"tensor's gap from the float32 plain gradient within "
          f"{BF16_VS_PLAIN} x the bf16 plain path's (floor "
          f"{BF16_GRAD_FLOOR}); worst {worst16} {k16[worst16]:.3e} against "
          f"{p16[worst16]:.3e}")
    rep = {"layers": cfg.num_layers, "launches": m[kernel],
           "backward_recomputes": m[f"{kernel}/backward"]
           - n[f"{kernel}/backward"], "bf16_ssd_backward_launches": bwd,
           "f32_worst": r32[worst32], "f32_worst_tensor": worst32,
           "f32_median": float(np.median(list(r32.values()))),
           "bf16_worst_ratio": ratio[worst16],
           "bf16_worst_ratio_tensor": worst16,
           "bf16_median_ratio": float(np.median(list(ratio.values()))),
           "bf16_kernel_vs_f32_plain_max": max(k16.values()),
           "bf16_plain_vs_f32_plain_max": max(p16.values()),
           "bf16_kernel_median": float(np.median(list(k16.values()))),
           "bf16_plain_median": float(np.median(list(p16.values())))}
    print(f"{arch} gradient check: {json.dumps(rep)}")
    for p in model.parameters():
        p.grad = None
    del model, g32
    torch.cuda.empty_cache()
    return rep


def smoke_train_card_vs_cpu(torch, np, arch, dev) -> dict:
    """Phases 13 and 18: one float32 train step of a SMOKE model on the card
    and on the CPU from the same params (the vlm gates ``VLM_GATES``) and
    batch."""
    from repro_torch.configs import base as CB
    from repro_torch.data import pipeline as DP
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as OPT

    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="float32")
    hp = OPT.OptHParams(warmup_steps=2, decay_steps=10)
    b = DP.make_pipeline(cfg, seq_len=64, global_batch=4).batch_at(0)
    out = {}
    for where in ("cpu", dev):
        model = M.init(cfg, seed=0, device="cpu")
        set_vlm_gates(torch, model)
        model = model.to(where).requires_grad_(True)
        state = OPT.init_state(dict(model.named_parameters()), hp)
        _, _, m = ST.make_train_step(cfg, hp)(
            model, state, {k: torch.from_numpy(v).to(where)
                           for k, v in b.items()})
        out[torch.device(where).type] = {k: float(v) for k, v in m.items()}
    rels = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
            for k in ("loss", "grad_norm")}
    check(max(rels.values()) <= RTOL_TRAIN_CARD_VS_CPU,
          f"{arch} SMOKE float32 train step: card and CPU loss and grad "
          f"norm within {RTOL_TRAIN_CARD_VS_CPU} relative ({rels})")
    return {"card": out["cuda"], "cpu": out["cpu"], "rel": rels}


def train_phases(torch, np, args, dev, report) -> dict:
    """Phase 13; returns, per LM kernel, what its row adds."""
    import tempfile
    from repro_torch.configs import base as CB
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    for name, launch in (
            ("flash_attention", lambda: fa_mod.kernel_forward(q, q, q)),
            ("ssd_scan", lambda: ssd_mod.kernel_forward(
                q, torch.zeros((1, 64, 2), device=dev), q[:, :, 0],
                q[:, :, 0], chunk=64))):
        try:
            launch()
            raised = False
        except RuntimeError as e:
            raised = "cut every gradient" in str(e)
        check(raised, f"{name}: a launch on grad-requiring inputs outside "
              f"its autograd.Function raises")
    out = {"card_vs_cpu": {a: smoke_train_card_vs_cpu(torch, np, a, dev)
                           for a in ("llama3.2-1b", "mamba2-130m")}}
    out["grad_check"] = {
        k: lm_grad_check(torch, np, dataclasses.replace(
            CB.get_config(a), num_layers=TRAIN_GRAD_LAYERS), k, args, dev)
        for a, k in (("llama3.2-1b", "flash_attention"),
                     ("mamba2-130m", "ssd_scan"))}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        out["train"] = {
            "flash_attention": lm_train(torch, np,
                                        CB.get_config("llama3.2-1b"),
                                        "flash_attention", args, dev),
            "ssd_scan": lm_train(torch, np, CB.get_config("mamba2-130m"),
                                 "ssd_scan", args, dev, ckpt_dir=d)}
    report["lm_train"] = out
    return {k: {"train_launches": r["launches"],
                "train_launches_per_step": r["launches_per_step"],
                "train_backward_recomputes_per_step":
                    r["backward_recomputes_per_step"],
                "train_step_ms": r["step_ms"]}
            for k, r in out["train"].items()}


# ---------------------------------------------------------------------------
# the optimizer (phase 20)
# ---------------------------------------------------------------------------

ADAMW_HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def adamw_shapes(case) -> list:
    """(name, shape, decays) of phase 20's tensors."""
    from repro_torch.configs import base as CB
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as OPT
    if case == "dbrx-132b-l1 expert weight":
        cfg = dataclasses.replace(CB.get_config("dbrx-132b"), num_layers=1)
        keep = ("blocks.0.ffn.wi",)
    else:
        cfg, keep = CB.get_config("mamba2-130m"), None
    model = M.build(cfg, device="meta")
    return [(k, tuple(p.shape), OPT.decays(k, p))
            for k, p in model.named_parameters() if keep is None or k in keep]


def adamw_case(torch, case, state_dtype, dev, iters) -> dict:
    """One row of phase 20 at ``case``'s tensors."""
    from repro_torch.kernels import adamw as aw_mod
    shapes = adamw_shapes(case)
    gen = torch.Generator(device=dev).manual_seed(20)

    def rand(shape, scale=1.0, square=False, dtype=torch.float32):
        t = torch.randn(shape, generator=gen, device=dev).mul_(scale)
        return (t.mul_(t) if square else t).to(dtype)

    ps = [rand(s) for _, s, _ in shapes]
    gs = [rand(s, 1e-3) for _, s, _ in shapes]
    ms = [rand(s, 1e-4, dtype=state_dtype) for _, s, _ in shapes]
    vs = [rand(s, 1e-3, True, state_dtype) for _, s, _ in shapes]
    flags = [d for _, _, d in shapes]
    reps = [1] * len(shapes)
    scal = [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (0.5, 3e-4, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]
    n = sum(p.numel() for p in ps)

    # the update: kernel against the plain version, from the same state
    copies = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    aw_mod.reset_launches()
    aw_mod.update_op(ps, gs, ms, vs, flags, *scal, *ADAMW_HP.values())
    check(aw_mod.launches["adamw_update"] == 1,
          f"adamw {case}: one update launch for {len(ps)} tensors")
    aw_mod.update_plain(copies[0], gs, copies[1], copies[2], flags, *scal,
                        *ADAMW_HP.values())
    torch.cuda.synchronize()
    err = 0.0
    for got, want in zip((ps, ms, vs), copies):
        for a, b in zip(got, want):
            err = max(err, float((a.float() - b.float()).abs().max()))
    check(err == 0.0, f"adamw {case} ({state_dtype}): p, m, v bit for bit "
          f"the plain version's (max abs err {err})")
    del copies

    # the norm: fixed order, near the plain sum
    first = aw_mod.sumsq_op(gs, reps)
    second = aw_mod.sumsq_op(gs, reps)
    plain = aw_mod.sumsq_plain(gs, reps)
    rel = abs(float(first) - float(plain)) / float(plain)
    check(torch.equal(first, second) and rel <= 1e-6,
          f"adamw {case}: the norm's sum the same bits on two calls, "
          f"{rel:.2e} from the plain one")

    def kernel():
        aw_mod.sumsq_op(gs, reps)
        aw_mod.update_op(ps, gs, ms, vs, flags, *scal, *ADAMW_HP.values())

    def plain_step():
        aw_mod.sumsq_plain(gs, reps)
        aw_mod.update_plain(ps, gs, ms, vs, flags, *scal, *ADAMW_HP.values())

    ms_kernel = time_kernel_ms(torch, kernel, iters=iters, reps=5)
    ms_plain = time_plain_ms(torch, plain_step, iters=3)
    ub, uo = aw_mod.update_work(ps, gs, ms, vs, flags)
    sb, so = aw_mod.sumsq_work(gs)
    b_ms, b_by = bound_ms(ub + sb, uo + so, ops_per_s=FP32_OPS_PER_S)
    del ms, vs
    torch.cuda.empty_cache()
    lib_ms, lib_note = None, "float32 moments (it takes one dtype)"
    m32 = [torch.zeros_like(p) for p in ps]
    v32 = [torch.zeros_like(p) for p in ps]
    steps = [torch.ones((), device=dev) for _ in ps]
    try:
        ms_lib = time_plain_ms(torch, lambda: torch._fused_adamw_(
            ps, gs, m32, v32, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False),
            iters=5)
        lib_ms = ms_lib
    except RuntimeError as e:            # a comparator only
        lib_note = f"not timed: {str(e).splitlines()[0]}"
    row = {"name": "adamw", "case": case, "route": "cuda",
           "source": "src/repro_torch/csrc/adamw.cu",
           "replaces": "- (the reference's jnp update, fused by XLA)",
           "tensors": len(ps), "elements": n,
           "state_dtype": str(state_dtype).replace("torch.", ""),
           "max_abs_err": err,
           "norm_rel_err": rel, "ms": ms_kernel, "plain_ms": ms_plain,
           "bound_ms": b_ms, "bound_by": b_by,
           "roofline": b_ms / ms_kernel, "library_ms": lib_ms,
           "library": "torch._fused_adamw_, " + lib_note}
    print(f"adamw ({case}): {json.dumps(row)} (bytes {ub + sb}, "
          f"operations {uo + so})")
    del ps, gs, m32, v32
    torch.cuda.empty_cache()
    return row


def adamw_train_counts(report) -> dict:
    """Per phase 20 row, the optimizer's launches in the trainer's own run
    of that model (phase 13's mamba2-130m, phase 18's dbrx-132b)."""
    runs = {"dbrx-132b-l1 expert weight":
            report["family_train"]["dbrx-132b"]["train"],
            "mamba2-130m parameters": report["lm_train"]["train"]["ssd_scan"]}
    out = {}
    for case, r in runs.items():
        n = sum(r["adamw_launches"].values())
        out[case] = {"train_launches": n,
                     "train_launches_per_step": n // r["steps"],
                     "train_launches_by_op": r["adamw_launches"],
                     "train_step_ms": r["step_ms"]}
    return out


def adamw_phase(torch, dev, report) -> list:
    """Phase 20; returns the AdamW kernel's rows."""
    t0 = time.perf_counter()
    rows = [adamw_case(torch, "dbrx-132b-l1 expert weight", torch.bfloat16,
                       dev, iters=3),
            adamw_case(torch, "mamba2-130m parameters", torch.float32, dev,
                       iters=20)]
    report["adamw"] = rows
    print(f"phase 20 (the optimizer kernel): "
          f"{time.perf_counter() - t0:.1f} s")
    return rows



# ---------------------------------------------------------------------------
# the remaining families (phase 14)
# ---------------------------------------------------------------------------

# (arch, depth cut or None, prefill length): every width as published; the
# depth is cut only where one card forces it (a whole model at float32 and
# its bf16 copy must fit 80 GB); Whisper's decoder context is 448 tokens
FAMILY_RUNS = (("dbrx-132b", 2, LM_SEQ),
               ("llama-3.2-vision-90b", 4, LM_SEQ),
               ("whisper-tiny", None, 448),
               ("recurrentgemma-2b", None, LM_SEQ))
SMOKE_FAMILIES = ("dbrx-132b", "grok-1-314b", "llama-3.2-vision-90b",
                  "whisper-tiny", "recurrentgemma-2b")
# the vlm cross blocks' tanh gates (attention, MLP): 0 at init, where a
# cross block adds exactly nothing
VLM_GATES = (0.5, -0.3)
# a float32 SMOKE forward or decode step, card against CPU: max |diff| <=
# this x max |CPU logit|
RTOL_SMOKE_CARD_VS_CPU = 1e-5


def set_vlm_gates(torch, model) -> None:
    with torch.no_grad():
        for cb in getattr(model, "cross_blocks", ()):
            cb.gate_attn.fill_(VLM_GATES[0])
            cb.gate_mlp.fill_(VLM_GATES[1])


def smoke_family_card_vs_cpu(torch, np, arch, dev) -> dict:
    """Phase 14: a float32 SMOKE forward and 3 decode steps (float32
    caches, the vlm context filled with the patches and the audio
    ``enc_out`` with ``encode(frames)``) on the card and on the CPU from the
    same params; the hybrid's prefill is two windows long (its two-block
    path)."""
    import copy
    from repro_torch.configs import base as CB
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.models import whisper as W

    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="float32")
    model = M.init(cfg, seed=0, device="cpu")
    set_vlm_gates(torch, model)
    S = 2 * cfg.attn_window if cfg.attn_window else 32
    batch = ST.prefill_batch(cfg, 2, S, seed=0, device="cpu")
    out = {}
    for side, where in (("cpu", "cpu"), ("card", dev)):
        m = copy.deepcopy(model).to(where)
        b = {k: v.to(where) for k, v in batch.items()}
        logits = [M.forward(m, cfg, b)[0]]
        cache = {k: v.float() for k, v in M.init_cache(
            cfg, 2, 16, device=where).items()}
        if "context" in cache:
            cache["context"] = b["patches"]
        if "enc_out" in cache:
            cache["enc_out"] = W.encode(m, cfg, b["frames"])
        for t in range(3):
            lg, cache = M.decode_step(
                m, cfg, cache, b["tokens"][:, t:t + 1],
                torch.tensor(t, dtype=torch.int32, device=where))
            logits.append(lg)
        out[side] = [x.cpu() for x in logits]
    gaps = [float((c - g).abs().max() / g.abs().max())
            for c, g in zip(out["card"], out["cpu"])]
    check(max(gaps) <= RTOL_SMOKE_CARD_VS_CPU,
          f"{arch} SMOKE float32 forward and 3 decode steps, card against "
          f"CPU: max |diff| / max |logit| {max(gaps):.2e} (forward "
          f"{gaps[0]:.2e}) within {RTOL_SMOKE_CARD_VS_CPU}")
    return {"forward": gaps[0], "decode": gaps[1:]}


def family_prefill(torch, np, arch, layers, seq, args, dev) -> dict:
    """Phase 14, one configuration at full width: the float32 forward
    through the flash kernel against the plain path, then the bf16 prefill
    step on the main path (flash launches as derived, next tokens, the MoE
    capacity drops), its median time, peak memory, a traced prefill for
    the hybrid, and ``Engine`` serving 8 requests. Returns the report and
    the flash kernel's first inputs on the main path."""
    import gc
    from repro_torch.configs import base as CB
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    full = CB.get_config(arch)
    cfg = full if layers is None else dataclasses.replace(
        full, num_layers=layers)
    if layers is not None:
        print(f"cut: {arch} depth {full.num_layers} -> {layers} layers "
              f"({cfg.family}; every width as published; "
              f"{cfg.param_count() / 1e9:.2f} G params of "
              f"{full.param_count() / 1e9:.1f} G)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model32 = M.init(cfg, seed=args.seed, device=dev)
    set_vlm_gates(torch, model32)
    # params rounded to bf16 values, so the float32 runs compute the served
    # bf16 model's function
    with torch.no_grad():
        for t in model32.state_dict().values():
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16))
    torch.cuda.synchronize()
    rep = {"layers": cfg.num_layers, "seq": seq,
           "params": sum(p.numel() for p in model32.parameters()),
           "param_count": cfg.param_count(),
           "init_s": time.perf_counter() - t0}
    batch = ST.prefill_batch(cfg, LM_BATCH, seq, seed=args.seed, device=dev)
    want = kernel_layers(cfg)    # flash launches of one prefill
    pv = L.padded_vocab(cfg.vocab_size)
    if want:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        b32 = {k: v.float() if v.is_floating_point() else v
               for k, v in batch.items()}
        last32 = M.forward(model32, cfg32, b32)[0][:, -1]
        plain32 = M.forward(model32, cfg32, b32, backend="torch")[0][:, -1]
        err32 = float((last32 - plain32).abs().max())
        check(bool(torch.allclose(last32, plain32, atol=1e-4, rtol=1e-4)),
              f"{arch} float32 last-position logits through the flash "
              f"kernel equal the plain path's within atol 1e-4 rtol 1e-4 "
              f"(max abs diff {err32:.3e}, max |logit| "
              f"{float(plain32.abs().max()):.3f})")
        rep["f32_logits_max_abs_diff_vs_plain"] = err32
        del last32, plain32, b32
    model = M.cast(model32, cfg, torch.bfloat16)
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    step = ST.make_prefill_step(cfg)

    # the main path, recording the flash kernel's first inputs and every
    # MoE layer's input
    seen, moe_in = [], []
    launch, moe_apply = fa_mod.flash_attention, MOE.moe_apply

    def recording(*a, **kw):
        if not seen:
            seen.append(a)
        return launch(*a, **kw)

    def moe_recording(p, x, c):
        moe_in.append((p, x))
        return moe_apply(p, x, c)

    fa_mod.flash_attention, MOE.moe_apply = recording, moe_recording
    try:
        lm_reset_launches()
        nxt = step(model, batch)
        torch.cuda.synchronize()
        counts = lm_launches()
    finally:
        fa_mod.flash_attention, MOE.moe_apply = launch, moe_apply
    check(counts["flash_attention"] == want and counts["ssd_scan"] == 0,
          f"{arch} prefill: {counts['flash_attention']} flash launches, as "
          f"derived from the config ({want}), and {counts['ssd_scan']} SSD")
    check(tuple(nxt.shape) == (LM_BATCH, 1) and nxt.dtype == torch.int32
          and bool(((nxt >= 0) & (nxt < pv)).all()),
          f"{arch} prefill: ({LM_BATCH}, 1) int32 next tokens in [0, {pv})")
    if moe_in:
        keep = [MOE.route(p, x, cfg)[3] for p, x in moe_in]
        shares = [1.0 - float(k.float().mean()) for k in keep]
        rep["moe_dropped_share"] = sum(
            int((~k).sum()) for k in keep) / sum(k.numel() for k in keep)
        rep["moe_dropped_share_per_layer"] = shares
        rep["moe_capacity"] = MOE.capacity(cfg, seq)
        print(f"{arch}: {rep['moe_dropped_share']:.4%} of the "
              f"{LM_BATCH} x {seq} x {cfg.num_experts_per_tok} token-expert "
              f"choices dropped by capacity ({rep['moe_capacity']} slots "
              f"per expert and sequence; per layer {shares})")
        del keep, moe_in
    last = M.forward(model, cfg, batch)[0][:, -1].float()
    check(bool(torch.isfinite(last).all())
          and tuple(last.shape) == (LM_BATCH, pv),
          f"{arch} bf16 last-position logits finite, ({LM_BATCH}, {pv})")
    del last

    torch.cuda.reset_peak_memory_stats()
    lm_reset_launches()
    calls = 5
    ms = median_ms(torch, lambda: step(model, batch), calls=calls)
    check(lm_launches()["flash_attention"] == want * (calls + 1),
          f"{arch}: {want} flash launches per timed prefill")
    rep.update(launches=counts["flash_attention"], step_ms=ms,
               tokens_per_s=LM_BATCH * seq / ms * 1e3,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if cfg.family == "hybrid":
        tr = traced(torch, lambda: step(model, batch))
        rep["trace"] = tr
        sp = tr["spans_device_ms"]
        check(sp.get("rglru/scan", 0) > 0 and sp.get("attention/local", 0) > 0,
              f"{arch} traced prefill: RG-LRU scan {sp.get('rglru/scan')} "
              f"ms and local attention {sp.get('attention/local')} ms of "
              f"{tr['device_busy_ms']} ms busy (device time of their "
              f"ranges)")
    rep["serve"] = lm_serve(torch, np, arch, cfg, model, args)
    print(f"{arch} prefill: {json.dumps(rep)}")
    del model, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"report": rep, "flash_in": seen[0] if seen else None}


def family_flash_row(torch, arch, q, k, v, launches) -> dict:
    """Phase 14: the flash kernel at the inputs this family's prefill gave
    it, held against its plain version (bf16 bar), its float32 route on the
    same inputs cast (float32 bar), and its line."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod

    shape = (*q.shape[:3], k.shape[2], q.shape[3])
    errs = {}
    for dt, tol in ((torch.bfloat16, dict(atol=6e-3, rtol=3e-2)),
                    (torch.float32, dict(atol=2e-5, rtol=1e-4))):
        a, b, c = (t.to(dt) for t in (q, k, v))
        got = fa_mod.flash_attention(a, b, c).float()
        want = fa_mod.flash_attention(a, b, c, backend="torch").float()
        torch.cuda.synchronize()
        errs[dt] = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, **tol)),
              f"flash_attention kernel equals its plain version at "
              f"{arch}'s {shape} {str(dt).replace('torch.', '')} (max abs "
              f"err {errs[dt]:.3e})")
        del got, want
    row = kernel_row(torch, f"flash_attention/{arch}", "flash_attention",
                     "src/repro/kernels/flash_attention.py:74",
                     *flash_runs(fa_mod, F, q, k, v), fa_mod.work(q, k),
                     q.dtype, launches, errs[torch.bfloat16],
                     f" {shape}")
    row["f32_max_abs_err"] = errs[torch.float32]
    return row


def family_phases(torch, np, args, dev, report) -> list:
    """Phase 14; returns the flash kernel's lines at the new shapes."""
    t0 = time.perf_counter()
    print("cut: grok-1-314b runs at SMOKE only (card against CPU); one "
          "layer at full width would add 6.53 G params and no mechanism "
          "dbrx-132b does not run")
    out = {"smoke_card_vs_cpu": {
        a: smoke_family_card_vs_cpu(torch, np, a, dev)
        for a in SMOKE_FAMILIES}}
    rows = []
    for arch, layers, seq in FAMILY_RUNS:
        r = family_prefill(torch, np, arch, layers, seq, args, dev)
        out[arch] = r["report"]
        if r["flash_in"] is not None:
            rows.append(family_flash_row(torch, arch, *r["flash_in"],
                                         launches=r["report"]["launches"]))
        del r
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 14 (the remaining families): {out['wall_s']:.1f} s")
    report["families"] = out
    return rows


# ---------------------------------------------------------------------------
# the distributed layer on the card (phase 15)
# ---------------------------------------------------------------------------

# the mesh trainer against mesh=None from the same state: losses and grad
# norms within this relative gap (the float32 train-step bar)
RTOL_MESH = 1e-5
# (arch, kernel, steps) of phase 15
MESH_RUNS = (("llama3.2-1b", "flash_attention", 3),
             ("mamba2-130m", "ssd_scan", 2))


class PlainCalls:
    """Counts the calls that ``_build.route`` sends anywhere but to a kernel
    (``"plain"`` or ``"reference"``) while it is entered."""

    def __init__(self):
        self.counts = {"plain": 0, "reference": 0}

    def __enter__(self):
        from repro_torch.kernels import _build
        self._orig = orig = _build.route

        def counting(x, backend):
            way = orig(x, backend)
            if way in self.counts:
                self.counts[way] += 1
            return way
        _build.route = counting
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        _build.route = self._orig


def mesh_train(torch, np, arch, kernel, steps, mesh, args, dev,
               ckpt_dir=None) -> dict:
    """Phase 15, one model: ``steps`` steps of ``Trainer(mesh=None)``, then
    of ``Trainer(mesh=mesh)`` from the same state (the same seed: the same
    parameters and batches), full width and depth, (4, 2048) tokens. The
    mesh trainer is returned for the compression and checkpoint checks."""
    from repro_torch.configs import base as CB
    from repro_torch.train.trainer import Trainer, TrainConfig

    cfg = CB.get_config(arch)
    per_step = per_train_step(cfg, kernel)[0]
    runs = {}
    for name, m in (("none", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, TrainConfig(seq_len=LM_SEQ, global_batch=LM_BATCH,
                                      num_steps=steps, log_every=0,
                                      ckpt_every=0, ckpt_dir=(
                                          ckpt_dir if m is not None
                                          else None), seed=args.seed),
                     mesh=m, device=dev)
        lm_reset_launches()
        with PlainCalls() as plain:
            per = []
            for _ in range(steps):
                before = lm_launches()[kernel]
                tr.train_one()
                per.append(lm_launches()[kernel] - before)
        torch.cuda.synchronize()
        runs[name] = {
            "losses": [h["loss"] for h in tr.history],
            "grad_norms": [h["grad_norm"] for h in tr.history],
            "launches_per_step": per, "plain_calls": dict(plain.counts),
            "step_ms": 1e3 * float(np.median(
                [h["step_time_s"] for h in tr.history[1:]])),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        # one more step, traced: is the mesh's extra time on the card?
        t = traced(torch, tr.train_one)
        runs[name]["trace"] = {k: t[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share")}
        if m is None:
            del tr
    rels = [abs(a - b) / abs(b) for key in ("losses", "grad_norms")
            for a, b in zip(runs["mesh"][key][:steps],
                            runs["none"][key][:steps])]
    rep = {**runs, "max_rel": max(rels), "exact": max(rels) == 0.0,
           "placements": sorted({str(tuple(p.placements))
                                 for p in tr.params.values()})}
    for name in ("none", "mesh"):
        r = runs[name]
        check(all(n == per_step for n in r["launches_per_step"])
              and not any(r["plain_calls"].values()),
              f"{arch} {name} trainer: {r['launches_per_step']} {kernel} "
              f"launches a step (derived {per_step}), "
              f"{r['plain_calls']} calls off the kernels")
    check(all(np.isfinite(runs["mesh"]["losses"]))
          and rep["max_rel"] <= RTOL_MESH,
          f"{arch} on the (1, 1) NCCL mesh: losses and grad norms within "
          f"{RTOL_MESH} of mesh=None (largest relative gap "
          f"{rep['max_rel']:.3e}; exactly 0: {rep['exact']})")
    for i, (a, b, c, d) in enumerate(zip(
            runs["mesh"]["losses"][:steps], runs["none"]["losses"],
            runs["mesh"]["grad_norms"][:steps], runs["none"]["grad_norms"]),
            1):
        print(f"{arch} step {i}: loss mesh {a!r} / none {b!r}; grad norm "
              f"mesh {c!r} / none {d!r}")
    return rep, tr


def mesh_psum(torch, tr) -> dict:
    """Phase 15: ``compressed_psum`` over the NCCL group on a mesh
    trainer's gradients, two rounds (the second with the first's
    residuals), each leaf's mean and residual against the per-rank plain
    computation on the card, bit for bit: ``quantize_int8`` with the
    group's absmax, ``dequantize`` over the group size and the fused
    residual (the pieces the CPU tests hold against the reference's)."""
    import torch.distributed as dist
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.sharding import local

    grads = {k: local(p.grad) for k, p in tr.params.items()}
    res = C.init_residuals(grads)
    n = dist.get_world_size()
    worst = {"mean": 0.0, "residual": 0.0}
    t0 = time.perf_counter()
    for _ in range(2):
        mean, new = C.compressed_psum(grads, res)
        for k, g in grads.items():
            c = g.float() + res[k]
            q, scale = C.quantize_int8(c)     # one rank: its own absmax
            want_mean = (C.dequantize(q, scale) / n).to(g.dtype)
            want_res = C.fused_residual(c, q, scale)
            worst["mean"] = max(worst["mean"], float(
                (mean[k] - want_mean).abs().max()))
            worst["residual"] = max(worst["residual"], float(
                (new[k] - want_res).abs().max()))
        res = new
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 2
    errs = {k: C.compression_error(g) for k, g in grads.items()}
    top = max(errs, key=errs.get)
    rep = {"leaves": len(grads), "elements": sum(g.numel()
                                                 for g in grads.values()),
           "max_abs_diff": worst, "largest_compression_error": errs[top],
           "largest_error_leaf": top, "largest_error_leaf_absmax_over_rms":
           float(grads[top].abs().max() / grads[top].float().pow(2).mean()
                 .sqrt().clamp_min(1e-30)),
           "ms_per_round": ms, "world": n}
    check(worst["mean"] == 0.0 and worst["residual"] == 0.0,
          f"compressed_psum over the NCCL group: means and residuals of "
          f"{len(grads)} gradient leaves bit for bit the plain per-rank "
          f"computation ({worst})")
    print(f"compressed_psum: {json.dumps(rep)}")
    return rep


def mesh_checkpoint(torch, tr, args, dev, ckpt_dir) -> dict:
    """Phase 15: the mesh trainer's checkpoint restores into a mesh=None
    trainer on the card and on the CPU, bit for bit."""
    from repro_torch.distributed.sharding import full
    from repro_torch.train.trainer import Trainer, TrainConfig

    tr.save()
    want = {k: full(p.detach()).cpu() for k, p in tr.params.items()}
    m = {k: full(t).cpu() for k, t in tr.opt_state["m"].items()}
    out = {}
    for where in (dev, torch.device("cpu")):
        fresh = Trainer(tr.cfg, TrainConfig(
            seq_len=LM_SEQ, global_batch=LM_BATCH, num_steps=tr.step,
            ckpt_dir=ckpt_dir, seed=args.seed + 1), device=where)
        ok = fresh.maybe_restore()
        same = (ok and fresh.step == tr.step
                and all(torch.equal(p.detach().cpu(), want[k])
                        for k, p in fresh.params.items())
                and all(torch.equal(t.cpu(), m[k])
                        for k, t in fresh.opt_state["m"].items())
                and all(p.device.type == where.type
                        for p in fresh.params.values()))
        check(same, f"{tr.cfg.name}: the mesh trainer's step-{tr.step} "
              f"checkpoint restores into a mesh=None trainer on "
              f"{where.type} bit for bit (params, Adam m)")
        out[where.type] = same
        del fresh
    return out


# phase 15's model-parallel check: every family at SMOKE in float32 on a
# (2, 2) ("data", "model") mesh of 4 gloo ranks on the CPU, one step from
# the same seed as mesh=None on the CPU. One card holds one NCCL rank, so
# this is where this machine's torch runs DTensor's sharding rules with
# the model axis at 2 (heads, kv head_dim, vocab, SSD heads, experts and
# RG-LRU width split over two ranks)
MESH_MP = ((2, 2), ("data", "model"))
MESH_MP_RUNS = (("llama3.2-1b", 32), ("mamba2-130m", 64), ("dbrx-132b", 32),
                ("recurrentgemma-2b", 64), ("whisper-tiny", 32),
                ("llama-3.2-vision-90b", 32))
MESH_MP_HP = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
# the vision family's cross-attention gates (0 at init: the cross blocks
# would add nothing)
MESH_MP_GATES = {"gate_attn": 0.5, "gate_mlp": -0.3}
# the moe family's mesh backward rounds the dispatch / combine cotangents
# to bfloat16 (the reference's design): its gradients are held at 1e-3
MESH_MP_RTOL_MOE_GRAD = 1e-3


def mesh_mp_train(arch, seq, mesh) -> dict:
    """One float32 SMOKE step of ``arch`` on the CPU, on ``mesh`` or
    without one: the step's metrics and every parameter after it, whole."""
    import torch
    from repro_torch.configs import base as CB
    from repro_torch.distributed.sharding import full, local
    from repro_torch.train.optimizer import OptHParams
    from repro_torch.train.trainer import Trainer, TrainConfig
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="float32")
    tr = Trainer(cfg, TrainConfig(seq_len=seq, global_batch=4, num_steps=1,
                                  log_every=0, ckpt_every=0, seed=0),
                 hp=OptHParams(**MESH_MP_HP), mesh=mesh, device="cpu")
    with torch.no_grad():
        for k, p in tr.params.items():
            gate = MESH_MP_GATES.get(k.rpartition(".")[2])
            if gate is not None:
                local(p).fill_(gate)
    tr.train_one()
    return {"history": tr.history[0], "moe": cfg.family == "moe",
            "params": {k: full(p.detach()).numpy().copy()
                       for k, p in tr.params.items()},
            "sharded": sum(any(q.is_shard() for q in p.placements)
                           for p in tr.params.values()) if mesh else 0}


def mesh_mp_rank(rank, world, out_path):
    """Phase 15, in each of the 4 gloo ranks: every family's mesh step;
    rank 0 writes the results."""
    import pickle
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*MESH_MP, device="cpu")
    out = [mesh_mp_train(arch, seq, mesh) for arch, seq in MESH_MP_RUNS]
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


def mesh_model_parallel(np, tmp) -> dict:
    """Phase 15: :func:`mesh_mp_rank` on 4 gloo ranks, each family held
    against its mesh=None step at the train-step bars: loss, grad norm
    and lr within rtol 1e-5 (the moe family's grad norm 1e-3, its
    parameters only finite), every parameter within atol 5e-5 + rtol
    1e-5."""
    import os
    import pickle
    import torch
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    path = os.path.join(tmp, "mesh_mp.pkl")
    spawn(mesh_mp_rank, 4, device="cpu", args=(path,))
    with open(path, "rb") as f:
        meshed = pickle.load(f)
    out = {"torch": torch.__version__, "mesh": str(MESH_MP), "runs": {}}
    for (arch, seq), m in zip(MESH_MP_RUNS, meshed):
        one = mesh_mp_train(arch, seq, None)
        rel = {k: abs(m["history"][k] - one["history"][k])
               / abs(one["history"][k]) for k in ("loss", "grad_norm", "lr")}
        gap = max(float(np.max(np.abs(v - one["params"][k])
                               - 1e-5 * np.abs(one["params"][k])))
                  for k, v in m["params"].items())
        finite = all(np.isfinite(v).all() for v in m["params"].values())
        grad_bar = MESH_MP_RTOL_MOE_GRAD if m["moe"] else 1e-5
        ok = (rel["loss"] <= 1e-5 and rel["lr"] <= 1e-5
              and rel["grad_norm"] <= grad_bar and finite
              and (m["moe"] or gap <= 5e-5) and m["sharded"] > 0)
        out["runs"][arch] = {"rel": rel, "param_excess": gap,
                             "sharded_params": m["sharded"]}
        check(ok, f"{arch} SMOKE on the {MESH_MP[0]} gloo mesh (torch "
              f"{torch.__version__}): {m['sharded']} sharded parameters; "
              f"loss, grad norm, lr relative gaps {rel} (grad norm bar "
              f"{grad_bar}); parameters: largest |gap| - 1e-5 |want| "
              f"{gap:.3e} (bar 5e-5{', not held: moe' if m['moe'] else ''})")
    out["wall_s"] = time.perf_counter() - t0
    return out


def mesh_phase(torch, np, args, dev, report) -> dict:
    """Phase 15, then phase 17 (its first part on phase 15's NCCL group
    and mesh); returns, per LM kernel, what its row adds."""
    import os
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import mesh as LM

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        LM.init_process_group(0, 1, os.path.join(d, "store"),
                              device=dev.type)
        try:
            mesh = LM.make_mesh((1, 1), ("data", "model"), device=dev.type)
            out["mesh"] = str(mesh)
            for arch, kernel, steps in MESH_RUNS:
                ckpt = os.path.join(d, "ckpt") if kernel == "ssd_scan" \
                    else None
                out[kernel], tr = mesh_train(torch, np, arch, kernel, steps,
                                             mesh, args, dev, ckpt)
                if kernel == "flash_attention":
                    out["compressed_psum"] = mesh_psum(torch, tr)
                else:
                    out["checkpoint"] = mesh_checkpoint(torch, tr, args,
                                                        dev, ckpt)
                del tr
                torch.cuda.empty_cache()
            t17 = time.perf_counter()
            serve = mesh_serve(torch, np, mesh, args, dev, report)
            t17 = time.perf_counter() - t17
        finally:
            dist.destroy_process_group()
        out["model_parallel"] = mesh_model_parallel(np, d)
        t = time.perf_counter()
        serve["model_parallel"] = mesh_serve_model_parallel(d)
        serve["wall_s"] = t17 + time.perf_counter() - t
    p13 = report["lm_train"]["train"]
    for kernel in ("flash_attention", "ssd_scan"):
        r = out[kernel]
        print(f"{kernel} trainer: mesh (1, 1) {r['mesh']['step_ms']:.1f} ms "
              f"a step, peak {r['mesh']['peak_mem_gb']:.2f} GB; mesh=None "
              f"{r['none']['step_ms']:.1f} ms, "
              f"{r['none']['peak_mem_gb']:.2f} GB; phase 13 "
              f"{p13[kernel]['step_ms']:.1f} ms, "
              f"{p13[kernel]['peak_mem_gb']:.2f} GB; traced step, mesh "
              f"{json.dumps(r['mesh']['trace'])}, mesh=None "
              f"{json.dumps(r['none']['trace'])}")
    out["wall_s"] = time.perf_counter() - t0 - serve["wall_s"]
    print(f"phase 15 (the distributed layer): {json.dumps(out)}")
    report["mesh"] = out
    print(f"phase 17 (serving on a mesh): {json.dumps(serve)}")
    report["mesh_serve"] = serve
    return {k: {"mesh_train_launches_per_step":
                out[k]["mesh"]["launches_per_step"][-1],
                "mesh_train_launches": sum(
                    out[k]["mesh"]["launches_per_step"]),
                "mesh_train_step_ms": out[k]["mesh"]["step_ms"]}
            for k in ("flash_attention", "ssd_scan")}


# ---------------------------------------------------------------------------
# serving on a mesh (phase 17)
# ---------------------------------------------------------------------------

# the bf16 decode-step bar of the CPU parity tests: where a mesh run's
# tokens first part from another run's, the mesh run's own logits may
# favour its token over the other by at most 2 x this x max |logit|
BF16_BAR = 2e-2
# the 4-gloo-rank check: every family at SMOKE in bfloat16, continuous
# (per-slot lengths), the CPU tests' 5 requests on 2 slots (slots are
# reused); the CPU tests also run every family in wave mode
SERVE_MP_ARCHS = ("llama3.2-1b", "mamba2-130m", "dbrx-132b",
                  "llama-3.2-vision-90b", "whisper-tiny", "recurrentgemma-2b")
SERVE_MP_PROMPTS = ([1, 2, 3], [7, 8], [4, 5, 6, 9], [2, 2], [11])
SERVE_MP_NEW = (5, 3, 6, 2, 4)
SERVE_MP_SLOTS, SERVE_MP_MAX_LEN = 2, 32


def engine_run(cfg, model, prompts, new, slots, max_len, mode, mesh):
    """Prompts through one ``Engine``: (tokens per request, uids in
    completion order, (waves, decode steps, prefill tokens, generated
    tokens), tokens/s)."""
    from repro_torch.serve.engine import Engine
    eng = Engine(cfg, model, batch_slots=slots, max_len=max_len, mesh=mesh,
                 mode=mode)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run()
    s = eng.stats
    return ([r.output for r in reqs], [r.uid for r in done],
            (s.waves, s.decode_steps, s.prefill_tokens, s.generated_tokens),
            s.tokens_per_s)


def engine_partings(cfg, model, mesh, prompts, slots, max_len, mode, got,
                    want) -> list:
    """Where each request's tokens ``got`` (a mesh engine's) first part from
    ``want``: (request, place, got token, wanted token, the gap between
    their logits in the mesh run, the bar 2 x BF16_BAR x max |logit|), or
    None where they are all equal. The mesh run's logits there come from
    the same fed tokens through the decode step on ``mesh``, every slot
    of a cache of the engine's size fed them, so that each rank computes
    its rows at the engine's local shapes (a collective on a mesh of many
    ranks: every rank calls it)."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    out, placed = [], None
    for i, (g, w) in enumerate(zip(got, want)):
        k = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if k is None:
            out.append(None if len(g) == len(w)
                       else (i, -1, len(g), len(w), 0.0, 0.0))
            continue
        if mode == "continuous":
            seq = list(prompts[i]) + g[:k]
        else:        # left-padded to the wave's longest prompt
            wave = prompts[i - i % slots:i - i % slots + slots]
            seq = [0] * (max(map(len, wave)) - len(prompts[i])) \
                + list(prompts[i]) + g[:k]
        dev = torch.device(mesh.device_type)
        cache = M.init_cache(cfg, slots, max_len, device=dev)
        if placed is None:
            placed, _ = ST.place_model(cfg, mesh, M.cast(model, cfg))
        with SH.use_mesh(mesh), torch.no_grad():
            for t, tok in enumerate(seq):
                cur = torch.full((slots,) if mode == "continuous" else (), t,
                                 dtype=torch.int32, device=dev)
                args_, _ = ST.place_decode_args(
                    cfg, mesh, placed, cache, torch.full(
                        (slots, 1), tok, dtype=torch.int32, device=dev), cur)
                placed, cache, toks, cur = args_
                logits, cache = M.decode_step(placed, cfg, cache, toks, cur)
            lg = SH.full(logits)[0, -1].float()
        out.append((i, k, g[k], w[k], float(lg[g[k]] - lg[w[k]]),
                    2 * BF16_BAR * float(lg.abs().max())))
    return out


def partings_ok(parts) -> bool:
    return all(p is None or (p[1] >= 0 and 0 <= p[4] <= p[5]) for p in parts)


def mesh_serve(torch, np, mesh, args, dev, report) -> dict:
    """Phase 17 on the card, on phase 15's one-rank NCCL group and (1, 1)
    mesh: ``Engine(mesh=...)`` serves phase 8's 8 requests for llama3.2-1b
    and mamba2-130m at full width and depth from phase 8's random weights
    (the same seed), held against phase 8's ``mesh=None`` engine: stats and
    completion order exactly, tokens by the bf16 margin rule; no LM kernel
    launched and no plain version called (decode runs neither)."""
    from repro_torch.configs import base as CB
    from repro_torch.models import model as M

    out = {}
    for arch, kernel in (("llama3.2-1b", "flash_attention"),
                         ("mamba2-130m", "ssd_scan")):
        cfg = CB.get_config(arch)
        model = M.cast(M.init(cfg, seed=args.seed, device=dev), cfg,
                       torch.bfloat16)
        torch.cuda.empty_cache()
        p8 = report["lm_serve"][kernel]
        prompts = serve_prompts(np, cfg, args.seed)
        lm_reset_launches()
        with PlainCalls() as plain:
            outs, order, stats, tps = engine_run(
                cfg, model, prompts, [SERVE_NEW] * len(prompts), SERVE_SLOTS,
                SERVE_MAX_LEN, "continuous", mesh)
        torch.cuda.synchronize()
        launches = sum(lm_launches().values())
        want = (0, p8["decode_steps"], p8["prefill_tokens"],
                p8["generated_tokens"])
        parts = engine_partings(cfg, model, mesh, prompts, SERVE_SLOTS,
                                SERVE_MAX_LEN, "continuous", outs,
                                p8["outputs"])
        rep = {"stats": stats, "order_equal": order == p8["order"],
               "every_token_equal": all(p is None for p in parts),
               "partings": [p for p in parts if p is not None],
               "tokens_per_s": tps, "phase8_tokens_per_s": p8["tokens_per_s"],
               "launches": launches, "plain_calls": dict(plain.counts)}
        check(stats == want and order == p8["order"],
              f"{arch} engine on the (1, 1) mesh: stats {stats} and "
              f"completion order equal phase 8's mesh=None engine ({want})")
        check(partings_ok(parts),
              f"{arch} engine on the (1, 1) mesh: tokens equal phase 8's up "
              f"to each first parting, within the bf16 margin there "
              f"({rep['partings']}; every token equal: "
              f"{rep['every_token_equal']})")
        check(launches == 0 and sum(plain.counts.values()) == 0,
              f"{arch} engine on the mesh: {launches} LM kernel launches, "
              f"{plain.counts} plain-version calls (decode runs neither)")
        print(f"{arch} serve on the (1, 1) mesh: decode {tps:.1f} tok/s "
              f"(phase 8, mesh=None: {p8['tokens_per_s']:.1f} tok/s); "
              f"every token equal to phase 8's: {rep['every_token_equal']}")
        out[arch] = rep
        del model
        torch.cuda.empty_cache()
    return out


def serve_mp_case(arch, mesh) -> dict:
    """One family at SMOKE in bfloat16 from seed 0 (the vlm's gates set),
    continuous, through ``Engine(mesh=mesh)`` and ``Engine(mesh=None)`` on
    the CPU: each run, where the mesh run's tokens part from the other,
    and every rank's tokens (a collective)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import base as CB
    from repro_torch.models import model as M
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="bfloat16")
    model = M.init(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            gate = MESH_MP_GATES.get(k.rpartition(".")[2])
            if gate is not None:
                p.fill_(gate)
    got, one = (engine_run(cfg, model, SERVE_MP_PROMPTS, SERVE_MP_NEW,
                           SERVE_MP_SLOTS, SERVE_MP_MAX_LEN, "continuous", m)
                for m in (mesh, None))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, got[:3])
    return {"mesh": got[:3], "none": one[:3],
            "same_on_every_rank": all(e == got[:3] for e in every),
            "partings": engine_partings(
                cfg, model, mesh, SERVE_MP_PROMPTS, SERVE_MP_SLOTS,
                SERVE_MP_MAX_LEN, "continuous", got[0], one[0])}


def serve_mp_rank(rank, world, out_path):
    """Phase 17, in each of the 4 gloo ranks: every family's engines;
    rank 0 writes the results."""
    import pickle
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*MESH_MP, device="cpu")
    out = {arch: serve_mp_case(arch, mesh) for arch in SERVE_MP_ARCHS}
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


def mesh_serve_model_parallel(tmp) -> dict:
    """Phase 17: :func:`serve_mp_rank` on 4 gloo ranks; each run held
    against its ``mesh=None`` engine: stats and completion order exactly,
    the tokens by the bf16 margin rule, every rank's the same."""
    import os
    import pickle
    import torch
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    path = os.path.join(tmp, "serve_mp.pkl")
    spawn(serve_mp_rank, 4, device="cpu", args=(path,))
    with open(path, "rb") as f:
        res = pickle.load(f)
    out = {"torch": torch.__version__, "mesh": str(MESH_MP), "runs": {}}
    for arch, r in res.items():
        equal = all(p is None for p in r["partings"])
        check(r["mesh"][1:] == r["none"][1:] and r["same_on_every_rank"]
              and partings_ok(r["partings"]),
              f"{arch} SMOKE continuous engine on the {MESH_MP[0]} gloo mesh "
              f"(torch {torch.__version__}): stats {r['mesh'][2]} and "
              f"completion order {r['mesh'][1]} equal mesh=None's "
              f"({r['none'][2]}, {r['none'][1]}); the same on every rank: "
              f"{r['same_on_every_rank']}; partings "
              f"{[p for p in r['partings'] if p]} (every token equal: "
              f"{equal})")
        out["runs"][arch] = {"every_token_equal": equal}
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the dry-run on the card (phase 16)
# ---------------------------------------------------------------------------

# (arch, kernel) of phase 16 (a) and (b), at phases 6, 7 and 13's shapes
DRYRUN_RUNS = (("llama3.2-1b", "flash_attention"),
               ("mamba2-130m", "ssd_scan"))
# phase 16 (c): production cells on the fake (16, 16) cuda mesh
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("mamba2-130m", "prefill_32k"),
                ("llama3.2-1b", "decode_32k"))
# the decode cell's collective bytes per device per token: its weights'
# FSDP gathers (256.8 MB on the CPU trace) and decode attention's
# statistics and partial outputs, no gathered scores (761.1 MB with them)
DECODE_32K_MAX_COLLECTIVE_BYTES = 300e6


def dryrun_step_ms(torch, spec, mesh, calls=3) -> float:
    """Median host time of ``spec.fn(*spec.args)`` on the card (each call
    ends in a sync), after one warm-up call."""
    from repro_torch.distributed import sharding as SH
    times = []
    for _ in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SH.use_mesh(mesh):
            spec.fn(*spec.args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times[1:])[calls // 2]


def dryrun_pair(torch, arch, kernel, kind, mesh, seed, measured_ms) -> dict:
    """Phase 16 (a) and (b), one step: the step of ``build_cell`` on the fake
    (1, 1) ``cuda`` mesh traced under ``FakeTensorMode`` with the op
    counter, then the same cell built for real (seed ``seed``) and run on
    the card under the same counter. The real run's counts, launches and
    time are held against the trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs import base as CB
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as ST

    cfg = CB.get_config(arch)
    shape = CB.ShapeConfig(f"phase16_{kind}", LM_SEQ, LM_BATCH, kind)
    t0 = time.perf_counter()
    with FakeTensorMode():
        spec = ST.build_cell(cfg, shape, mesh)
        traced = DR.count_step(spec, mesh)
        args_bytes = DR.local_bytes(spec.args)
    trace_s = time.perf_counter() - t0
    del spec
    nodes = traced.kernel_nodes(kernel)
    ts = traced.summary
    rl = RL.Roofline(arch=arch, shape=shape.name, mesh="1x1", n_devices=1,
                     hlo_flops_per_dev=ts.flops, hlo_bytes_per_dev=ts.hbm_bytes,
                     collective_bytes_per_dev=ts.collective_bytes,
                     model_flops_global=RL.model_flops(cfg, shape),
                     per_device_memory=float(args_bytes + traced.peak_bytes))

    torch.cuda.empty_cache()
    spec = ST.build_cell(cfg, shape, mesh, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()   # the step's peak, args included
    lm_reset_launches()
    real = DR.count_step(spec, mesh)
    torch.cuda.synchronize()
    launches = lm_launches()
    peak = torch.cuda.max_memory_allocated()
    rs = real.summary
    own_ms = dryrun_step_ms(torch, spec, mesh)
    del spec
    torch.cuda.empty_cache()

    per = (per_train_step(cfg, kernel)[0] if kind == "train"
           else kernel_layers(cfg, kernel))
    bound_ms_ = 1e3 * rl.step_time_lower_bound
    rep = {"trace_s": trace_s, "traced_flops": ts.flops,
           "real_flops": rs.flops, "traced_hbm_bytes": ts.hbm_bytes,
           "real_hbm_bytes": rs.hbm_bytes,
           "collective_bytes": ts.collective_bytes,
           "traced_nodes": nodes, "real_nodes": real.kernel_nodes(kernel),
           "launches": launches[kernel], "derived_nodes": per,
           "roofline": rl.to_json(), "bound_ms": bound_ms_,
           "measured_ms": measured_ms, "step_ms_on_mesh": own_ms,
           "predicted_mem_gb": rl.per_device_memory / 1e9,
           "args_gb": args_bytes / 1e9, "temp_gb": traced.peak_bytes / 1e9,
           "max_memory_allocated_gb": peak / 1e9}
    tag = f"{arch} {kind}"
    check(rs.flops == ts.flops and rs.hbm_bytes == ts.hbm_bytes,
          f"{tag}: the real step's counted FLOPs {rs.flops:.6e} and HBM "
          f"bytes {rs.hbm_bytes:.6e} equal the trace's ({ts.flops:.6e}, "
          f"{ts.hbm_bytes:.6e})")
    check(nodes == per == launches[kernel] == real.kernel_nodes(kernel),
          f"{tag}: {nodes} traced {kernel} nodes, {launches[kernel]} "
          f"launches counted by the wrapper in the real step (derived "
          f"{per})")
    check(bound_ms_ <= min(measured_ms, own_ms),
          f"{tag}: roofline lower bound {bound_ms_:.3f} ms ({rl.bottleneck})"
          f" is at most the measured step, {measured_ms:.3f} ms (phases 6, 7"
          f" and 13) and {own_ms:.3f} ms (this mesh)")
    print(f"{tag} dry-run: {json.dumps(rep)}")
    return rep


def dryrun_child(in_path, out_path) -> int:
    """Phase 16, in a process of its own (its fake process group cannot
    share a process with phase 15's NCCL group): (a) and (b) on a fake
    (1, 1) ``cuda`` mesh, then (c) two production cells on a fake (16, 16)
    ``cuda`` mesh, then (d) phase 18's train configurations chosen from
    their traces on the (1, 1) mesh (:func:`choose_train_cut`)."""
    import tempfile
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_fake_mesh

    t0 = time.perf_counter()
    inp = json.loads(pathlib.Path(in_path).read_text())
    _build.build_all(KERNEL_SOURCES)    # built by the parent: loads only
    out = {"torch": torch.__version__}
    mesh = make_fake_mesh((1, 1), ("data", "model"), device="cuda")
    for arch, kernel in DRYRUN_RUNS:
        for kind in ("prefill", "train"):
            out[f"{kernel} {kind}"] = dryrun_pair(
                torch, arch, kernel, kind, mesh, inp["seed"],
                inp["measured_ms"][kernel][kind])
    out["cells"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        for arch, shape in DRYRUN_CELLS:
            rec = DR.run_cell(arch, shape, False, pathlib.Path(d),
                              device="cuda")
            ok = rec["status"] == "ok"
            hs = rec.get("hlo_summary", {})
            check(ok and hs["flops"] > 0 and hs["hbm_bytes"] > 0
                  and (hs["collective_bytes"] > 0
                       or not shape.startswith("train")),
                  f"{arch} {shape} on the fake (16, 16) cuda mesh: "
                  f"{rec['status']} {rec.get('error', '')[:300]}, FLOPs "
                  f"{hs.get('flops')}, HBM bytes {hs.get('hbm_bytes')}, "
                  f"collective bytes {hs.get('collective_bytes')}")
            out["cells"][f"{arch} {shape}"] = {
                k: rec[k] for k in ("n_devices", "build_s", "trace_s",
                                    "memory_analysis", "roofline")}
            if shape == "decode_32k":
                gathers = [c["out_bytes"] for c in hs["collectives"]
                           if "all_gather" in c["op"]]
                dec = {"collective_bytes": hs["collective_bytes"],
                       "hbm_bytes": hs["hbm_bytes"],
                       "all_gathers": len(gathers),
                       "largest_all_gather_bytes": max(gathers, default=0)}
                out["cells"][f"{arch} {shape}"].update(dec)
                print(f"{arch} {shape} on the fake (16, 16) cuda mesh, per "
                      f"device per token: {json.dumps(dec)}")
                check(hs["collective_bytes"]
                      <= DECODE_32K_MAX_COLLECTIVE_BYTES,
                      f"{arch} {shape}: {hs['collective_bytes']:.6e} "
                      f"collective bytes per device, at most "
                      f"{DECODE_32K_MAX_COLLECTIVE_BYTES:.0e}")
    # (d) phase 18's configurations, chosen from their traces on a (1, 1)
    # mesh (again: (c)'s mesh replaced the group) before the card runs any
    mesh = make_fake_mesh((1, 1), ("data", "model"), device="cuda")
    out["family_train"] = {arch: choose_train_cut(torch, arch, seq, mesh)
                           for arch, seq in FAMILY_TRAIN}
    out["wall_s"] = time.perf_counter() - t0
    pathlib.Path(out_path).write_text(json.dumps(out))
    return 0


def dryrun_phase(torch, args, report) -> dict:
    """Phase 16: :func:`dryrun_child` in a subprocess; returns, per LM
    kernel, what its row adds."""
    import tempfile
    measured = {k: {"prefill": report["lm_prefill"][k]["step_ms"],
                    "train": report["lm_train"]["train"][k]["step_ms"]}
                for k in ("flash_attention", "ssd_scan")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p16_") as d:
        inp, res = pathlib.Path(d, "in.json"), pathlib.Path(d, "out.json")
        inp.write_text(json.dumps({"seed": args.seed,
                                   "measured_ms": measured}))
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--dryrun-child", str(inp), str(res)],
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="")
        check(proc.returncode == 0 and res.exists(),
              f"phase 16 subprocess exits 0 (exit {proc.returncode}; "
              f"{proc.stderr[-3000:]})")
        out = json.loads(res.read_text())
    print(f"phase 16 (the dry-run): {json.dumps(out)}")
    report["dryrun"] = out
    return {k: {"dryrun_nodes_per_prefill": out[f"{k} prefill"]["traced_nodes"],
                "dryrun_nodes_per_train_step":
                    out[f"{k} train"]["traced_nodes"],
                "dryrun_real_launches_per_prefill":
                    out[f"{k} prefill"]["launches"],
                "dryrun_real_launches_per_train_step":
                    out[f"{k} train"]["launches"]}
            for k in ("flash_attention", "ssd_scan")}


# ---------------------------------------------------------------------------
# training the remaining families (phase 18)
# ---------------------------------------------------------------------------

# (arch, tokens per sequence) of phase 18; Whisper's decoder context is
# 448; granite-4.0-h-small at its benchmark cell's (4, 4096); jamba2-3b at
# its cell's 16,384 tokens a sequence
FAMILY_TRAIN = (("dbrx-132b", LM_SEQ), ("llama-3.2-vision-90b", LM_SEQ),
                ("whisper-tiny", 448), ("recurrentgemma-2b", LM_SEQ),
                ("granite-4.0-h-small", 4096), ("jamba2-3b", 16384))
# sequences a phase-18 step takes where not LM_BATCH: jamba2-3b one, as its
# cell (four 16k sequences' float32 logits over 65,536 pass the card alone)
TRAIN_BATCH = {"jamba2-3b": 1}
# a hybrid_moe model trains in phase 18 as one card of its benchmark cell's
# deployment holds it (perfbench/configs/granite-4.0-h-small-p1.json): at
# most one period of its layer pattern, and experts 0 .. E/8 - 1 of each
# layer's E (8-way expert parallelism; the router keeps its E outputs)
EXPERT_SHARE = 8
# the most a phase-18 step may be predicted to hold: its arguments (params,
# Adam moments, batch) and the peak of its temporaries; 90% of the card's
# 80 GB
TRAIN_BUDGET_BYTES = 72e9
# bytes a parameter holds in a train step by the moments' dtype: float32
# param and gradient and two moments; a cut over budget on these alone is
# not traced
STATE_BYTES = {"float32": 16, "bfloat16": 12}


def train_cut(full, depth):
    """``full`` at ``depth`` layers, every width as published. A vlm cut
    keeps one cross block after each group of at most ``depth`` self
    blocks (a ``cross_attn_every`` above the depth would leave none). A
    hybrid_moe cut holds the card's share of the experts
    (``EXPERT_SHARE``)."""
    if full.family == "hybrid_moe":
        return dataclasses.replace(
            full, num_layers=depth,
            num_experts=full.num_router_experts // EXPERT_SHARE,
            router_experts=full.num_router_experts)
    if depth == full.num_layers:
        return full
    if full.family == "vlm":
        return dataclasses.replace(
            full, num_layers=depth,
            cross_attn_every=min(full.cross_attn_every, depth))
    return dataclasses.replace(full, num_layers=depth)


def train_depths(full) -> range:
    """Phase 18's depths to try, deepest first: from the published depth
    down, or for hybrid_moe from one period of its layer pattern down."""
    top = (len(full.hybrid_pattern) if full.family == "hybrid_moe"
           else full.num_layers)
    return range(top, 0, -1)


def train_hparams(steps, state_dtype):
    """The trainer's own default ``OptHParams`` for ``steps`` steps, with
    the Adam moments in ``state_dtype``."""
    from repro_torch.train import optimizer as OPT
    return OPT.OptHParams(warmup_steps=10, decay_steps=max(steps, 2),
                          state_dtype=state_dtype)


def choose_train_cut(torch, arch, seq, mesh) -> dict:
    """Phase 18's configuration of ``arch`` on (batch, ``seq``) tokens
    (``TRAIN_BATCH``, else LM_BATCH sequences), chosen
    from the dry-run's prediction, never by trial on the card: from
    :func:`train_depths`'s first down, float32 Adam moments before
    bfloat16, the first
    cut whose train step (``launch.steps.build_cell`` on ``mesh`` under
    ``FakeTensorMode``, ``dryrun.count_step``, ``dryrun.local_bytes``)
    holds at most TRAIN_BUDGET_BYTES of arguments and peak temporaries.
    Returns that cut, its prediction (bytes, roofline bound, flash nodes)
    and every candidate traced (the deeper ones whose params, gradients
    and moments alone exceed the budget are counted, not traced)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs import base as CB
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as ST

    full = CB.get_config(arch)
    batch = TRAIN_BATCH.get(arch, LM_BATCH)
    shape = CB.ShapeConfig(f"phase18_{arch}", seq, batch, "train")
    tried, untraced = [], 0
    for depth in train_depths(full):
        cfg = train_cut(full, depth)
        for sd, per_param in STATE_BYTES.items():
            if cfg.param_count() * per_param > TRAIN_BUDGET_BYTES:
                untraced += 1
                continue
            cand = {"depth": depth, "state_dtype": sd}
            tried.append(cand)
            t0 = time.perf_counter()
            if cfg.family in ("hybrid_moe", "jamba"):
                # a share of the experts, and the selective scan's op,
                # have no mesh path: the step as one card runs it, with
                # no mesh (jamba's cell: the whole model a card)
                one = DR.one_card_train(cfg, train_hparams(2, sd), batch,
                                        seq, device=mesh.device_type)
                args_bytes, temp = one["argument_bytes"], one["temp_bytes"]
                flops, hbm, coll = one["flops"], one["hbm_bytes"], 0.0
                flash = one["flash_nodes"]
            else:
                with FakeTensorMode():
                    spec = ST.build_cell(cfg, shape, mesh,
                                         hp=train_hparams(2, sd))
                    counter = DR.count_step(spec, mesh)
                    args_bytes = DR.local_bytes(spec.args)
                del spec
                ts = counter.summary
                temp, flops, hbm = counter.peak_bytes, ts.flops, ts.hbm_bytes
                coll = ts.collective_bytes
                flash = counter.kernel_nodes("flash_attention")
            total = args_bytes + temp
            cand.update(predicted_gb=total / 1e9,
                        trace_s=time.perf_counter() - t0)
            if total > TRAIN_BUDGET_BYTES:
                continue
            rl = RL.Roofline(
                arch=arch, shape=shape.name, mesh="1x1", n_devices=1,
                hlo_flops_per_dev=flops, hlo_bytes_per_dev=hbm,
                collective_bytes_per_dev=coll,
                model_flops_global=RL.model_flops(cfg, shape),
                per_device_memory=float(total))
            rec = {"arch": arch, "batch": batch, "seq": seq, "depth": depth,
                   "published_depth": full.num_layers,
                   "cross_attn_every": cfg.cross_attn_every,
                   "state_dtype": sd, "params": cfg.param_count(),
                   "args_bytes": args_bytes, "temp_bytes": temp,
                   "predicted_bytes": total,
                   "bound_ms": 1e3 * rl.step_time_lower_bound,
                   "bottleneck": rl.bottleneck, "flops": flops,
                   "hbm_bytes": hbm, "flash_nodes": flash,
                   "tried": tried, "untraced_over_budget": untraced}
            print(f"{arch} train on ({batch}, {seq}): {json.dumps(rec)}")
            return rec
    raise SmokeFailure(f"{arch}: no cut's train step is predicted within "
                       f"{TRAIN_BUDGET_BYTES / 1e9:.0f} GB ({tried})")


def family_train(torch, np, arch, seq, pred, args, dev) -> dict:
    """Phase 18, one family at the dry-run's configuration ``pred``: (a) a
    float32 SMOKE train step on the card against the CPU; (b) where it
    launches the flash kernel, the gradient check against the plain path
    (not for hybrid_moe: its ten layers' top-10 of 72 routes, each over
    16,384 tokens after a kernel's output, are set apart by float32
    differences of ~1e-6 in some tokens, and each such token moves its
    experts' gradients far past the check's bars; its benchmark cell holds
    its gradients against the plain reference); jamba takes neither (a)
    nor (b): the selective-scan kernel takes bf16 only, so a float32 step
    has no card route, and the plain scan at (4, 16384, 5120, 16) holds
    5.4 GB a float32 tensor a sequence; its benchmark cell holds its
    gradients against the plain reference; (c) ``Trainer.run`` with
    launches, recomputes, peak memory and step time held against what was
    derived and predicted before it, and one traced step."""
    from repro_torch.configs import base as CB

    cfg = train_cut(CB.get_config(arch), pred["depth"])
    launches, recomputes = per_train_step(cfg)
    check(pred["flash_nodes"] == launches,
          f"{arch}: {pred['flash_nodes']} flash nodes in the traced train "
          f"step, as derived from the config ({launches})")
    print(f"{arch} predicted before its run: {cfg.num_layers} of "
          f"{pred['published_depth']} layers, {cfg.param_count() / 1e9:.3f} "
          f"G params, {pred['state_dtype']} Adam moments, "
          f"{pred['predicted_bytes'] / 1e9:.3f} GB (arguments "
          f"{pred['args_bytes'] / 1e9:.3f}, temporaries "
          f"{pred['temp_bytes'] / 1e9:.3f}), roofline bound "
          f"{pred['bound_ms']:.1f} ms ({pred['bottleneck']}), {launches} "
          f"flash launches and {recomputes} backward recomputes a step")
    rep = {"prediction": pred}
    if cfg.family != "jamba":
        rep["card_vs_cpu"] = smoke_train_card_vs_cpu(torch, np, arch, dev)
    if launches and cfg.family not in ("hybrid_moe", "jamba"):
        rep["grad_check"] = lm_grad_check(torch, np, cfg, "flash_attention",
                                          args, dev, seq=seq)
    rep["train"] = tr = lm_train(
        torch, np, cfg, "flash_attention", args, dev, seq=seq,
        hp=train_hparams(args.train_steps, pred["state_dtype"]), pred=pred,
        batch=pred["batch"])
    spans = tr["trace"]["spans_device_ms"]
    want = (["FlashAttentionBackward"] if launches else []) + (
        ["moe/route"] if cfg.family == "moe" else []) + (
        ["rglru/scan", "attention/local"] if cfg.family == "hybrid" else []
    ) + (["SSDScanBackward", "moe/route", "moe/experts", "MoEExpertsBackward",
          "moe/shared"] if cfg.family == "hybrid_moe" else []) + (
        ["SelectiveScanBackward"] if cfg.family == "jamba" else [])
    check(all(spans.get(k, 0) > 0 for k in want),
          f"{arch} traced train step: device ms of "
          f"{ {k: spans.get(k) for k in want} } of "
          f"{tr['trace']['device_busy_ms']} busy, idle share "
          f"{tr['trace']['device_idle_share']}")
    return rep


def family_train_phase(torch, np, args, dev, report) -> dict:
    """Phase 18; returns, per ``flash_attention/<arch>`` row of phase 14,
    what its train step adds."""
    from repro_torch.configs import base as CB
    t0 = time.perf_counter()
    preds = report["dryrun"]["family_train"]
    out, rows, reduced = {}, {}, []
    for arch, seq in FAMILY_TRAIN:
        pred = preds[arch]
        why = (f"predicted {pred['predicted_bytes'] / 1e9:.3f} GB of the "
               f"{TRAIN_BUDGET_BYTES / 1e9:.0f} GB budget; the candidates "
               f"before it predicted {pred['tried'][:-1]}, and "
               f"{pred['untraced_over_budget']} deeper ones over it on "
               f"their params, gradients and moments alone")
        if pred["depth"] < pred["published_depth"]:
            reduced.append({"arch": arch, "cut": f"depth "
                            f"{pred['published_depth']} -> {pred['depth']}"
                            + (f", cross_attn_every {pred['cross_attn_every']}"
                               if pred["cross_attn_every"] else ""),
                            "predicted_gb": pred["predicted_bytes"] / 1e9,
                            "reason": why})
        full = CB.get_config(arch)
        if full.family == "hybrid_moe":
            reduced.append({"arch": arch, "cut": f"experts held "
                            f"{full.num_experts} -> "
                            f"{train_cut(full, 1).num_experts}",
                            "predicted_gb": pred["predicted_bytes"] / 1e9,
                            "reason": f"one card of {EXPERT_SHARE}-way "
                                      f"expert parallelism, as the "
                                      f"benchmark cell's"})
        if pred["state_dtype"] != "float32":
            reduced.append({"arch": arch, "cut": "bfloat16 Adam moments",
                            "predicted_gb": pred["predicted_bytes"] / 1e9,
                            "reason": why})
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out[arch] = r = family_train(torch, np, arch, seq, pred, args, dev)
        r["wall_s"] = time.perf_counter() - t1
        t = r["train"]
        if t["launches"]:
            rows[f"flash_attention/{arch}"] = {
                "train_launches": t["launches"],
                "train_launches_per_step": t["launches_per_step"],
                "train_backward_recomputes_per_step":
                    t["backward_recomputes_per_step"],
                "train_step_ms": t["step_ms"]}
    for r in reduced:
        print(f"reduced: {json.dumps(r)}")
    out["reduced"] = reduced
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 18 (training the remaining families): {out['wall_s']:.1f} "
          f"s")
    report["family_train"] = out
    return rows


# ---------------------------------------------------------------------------
# the LM kernels at a train cell's own inputs (phase 21)
# ---------------------------------------------------------------------------

# the models of phase 18 whose kernels run at inputs no other phase gives
# them: granite's flash at (4, 4096, 32, 8, 128) with scores x 1/128 and
# its SSD scan at 128 heads
CELL_KERNEL_ARCHS = ("granite-4.0-h-small",)
# phase 21's bar, per element: |kernel - plain| <= CELL_BAR x (A + |plain|),
# A the same function of the inputs' absolute values (the plain version on
# |v|, or on |X|, |B|, |C| with the same decays: the sum of the terms'
# magnitudes). Both round their float32 result to bf16 once (u |plain|
# each, u = 2**-8 bf16's unit roundoff), and the kernel rounds its
# products' operands to bf16 (the flash kernel P, the SSD kernel its
# states and chunk products), each term off by u at a stage: 2**-6 is
# four units, for the two outputs' roundings and two stages of operands
CELL_BAR = 2.0 ** -6


def cell_kernel_inputs(torch, cfg, seq, dev, seed) -> tuple:
    """Seeded bf16 inputs of the flash kernel and the SSD scan at the
    shapes ``cfg``'s train step on (LM_BATCH, ``seq``) tokens gives them:
    ``(q, k, v)`` and ``(X, Adt, Bc, Cc)``, Adt float32 in (-0.35, 0)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, S = LM_BATCH, seq
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Hs = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    adt = -F.softplus(randn(B, S, Hs, dtype=torch.float32)) * 0.5
    return ((randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)),
            (randn(B, S, Hs, P), adt, randn(B, S, N), randn(B, S, N)))


def cell_kernel_phase(torch, args, dev, report) -> list:
    """Phase 21, after phase 18: for each model of ``CELL_KERNEL_ARCHS``
    that phase 18 trained, the flash kernel (at the model's softmax scale)
    and the SSD scan on seeded bf16 inputs at the shapes its train step
    gave them, each against its plain version by the ``CELL_BAR`` bar and
    the same bits on two launches; their lines (graph-replay ms, plain
    ms, bound, SDPA's ms at the same scale for the flash kernel) with the
    launches of phase 18's ``Trainer.run`` of that model."""
    import torch.nn.functional as F
    from repro_torch.configs import base as CB
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    rows, found = [], {}
    for arch in CELL_KERNEL_ARCHS:
        fam = report["family_train"].get(arch)
        if fam is None:
            continue
        seq = dict(FAMILY_TRAIN)[arch]
        cfg = train_cut(CB.get_config(arch), fam["prediction"]["depth"])
        scale = cfg.attn_scale or None
        tr = fam["train"]
        torch.cuda.empty_cache()
        (q, k, v), (X, Adt, Bc, Cc) = cell_kernel_inputs(
            torch, cfg, seq, dev, args.seed)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        runs = {
            "flash_attention": (
                lambda b, v=v: fa_mod.flash_attention(q, k, v, backend=b,
                                                      scale=scale),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True,
                    scale=scale),
                fa_mod.work(q, k), f" {tuple(q.shape[:3])} kv "
                f"{k.shape[2]} scale {scale}"),
            "ssd_scan": (
                lambda b, X=X, Bc=Bc, Cc=Cc: ssd_mod.ssd_scan(
                    X, Adt, Bc, Cc, chunk=cfg.ssm_chunk, backend=b),
                None, ssd_mod.work(X, Bc, cfg.ssm_chunk),
                f" {tuple(X.shape)} chunk {cfg.ssm_chunk}")}
        absolute = {"flash_attention": lambda: runs["flash_attention"][0](
                        "torch", v=v.abs()),
                    "ssd_scan": lambda: runs["ssd_scan"][0](
                        "torch", X=X.abs(), Bc=Bc.abs(), Cc=Cc.abs())}
        for name, (run, lib, work, tag) in runs.items():
            got, want = run("auto").float(), run("torch").float()
            mag = absolute[name]().float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            ratio = torch.nan_to_num(err / (CELL_BAR * (mag + want.abs())),
                                     nan=0.0, posinf=float("inf"))
            worst = int(ratio.argmax())
            f = found[f"{name}/{arch}"] = {
                "max_abs_err": float(err.max()),
                "max_abs_ref": float(want.abs().max()),
                "max_magnitude": float(mag.max()),
                "worst_err_over_bar": float(ratio.max()),
                "worst_element": [float(t.reshape(-1)[worst])
                                  for t in (got, want, mag)],
                "same_bits": bool(torch.equal(run("auto"), run("auto")))}
            del got, want, mag, err, ratio
            row = kernel_row(torch, f"{name}/{arch}", name,
                             "src/repro/kernels/" + name + ".py",
                             lambda: run("auto"), lambda: run("torch"), lib,
                             work, torch.bfloat16,
                             tr["kernel_launches"][name],
                             f["max_abs_err"], tag)
            row.update(f, train_launches=tr["kernel_launches"][name],
                       train_launches_per_step=tr["kernel_launches"][name]
                       // tr["steps"], train_step_ms=tr["step_ms"])
            rows.append(row)
        del q, k, v, qt, kt, vt, X, Adt, Bc, Cc
        torch.cuda.empty_cache()
    report["cell_kernels"] = found
    # checked after every line is printed, so a miss still shows the times
    for name, f in found.items():
        check(f["worst_err_over_bar"] <= 1.0,
              f"{name} kernel equals its plain version at its train cell's "
              f"inputs within {CELL_BAR} x (the terms' magnitude + |ref|) "
              f"(max abs err {f['max_abs_err']:.3e}, max |ref| "
              f"{f['max_abs_ref']:.3e}; worst element at "
              f"{f['worst_err_over_bar']:.3f} of its bar: kernel, plain, "
              f"magnitude {f['worst_element']})")
        check(f["same_bits"], f"{name}: two bf16 launches at its train "
              f"cell's inputs give the same bits")
    return rows


# phase 21: the SSD scan's backward kernel at the train cells' shapes, (B,
# S, H, P, N) with chunk 256: mamba2-130m's (16, 2048) tokens and
# granite-4.0-h-small's (4, 4096), with the trainers that launch it there
SSD_BACKWARD_CELLS = (("mamba2-130m", (16, 2048, 24, 64, 128)),
                      ("granite-4.0-h-small", (4, 4096, 128, 64, 128)))
# its bar, per gradient, stated before the run: |kernel - plain| <= bar x
# |plain| in norm, the plain version computing in float32 from the same
# bf16 inputs and rounding only its outputs. The kernel rounds its
# products' operands to bf16 (u = 2**-8) at two stages and its outputs
# once; 2**-6 is four units, as CELL_BAR
SSD_BACKWARD_BAR = 2.0 ** -6


def ssd_backward_rows(torch, args, dev, report) -> list:
    """Phase 21's SSD backward lines: at each shape of
    ``SSD_BACKWARD_CELLS`` on seeded bf16 inputs, the backward kernel
    (``ssd_scan.kernel_backward``) against its plain version
    (``ssd_chunked_backward``) by the ``SSD_BACKWARD_BAR`` bar for each of
    dX, dAdt, dBc and dCc, the same bits on two calls, and its line:
    graph-replay ms beside its bound (``work_backward``), the plain
    version's ms and the float32 recompute's (autograd of ``ssd_chunked``,
    what the backward ran before), with the launches of the trainer that
    ran the model."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd_mod

    # the trainers' runs: phase 13's mamba2-130m, phase 18's families
    trainers = {"mamba2-130m": report.get("lm_train", {}).get(
        "train", {}).get("ssd_scan", {})}
    for arch, _ in SSD_BACKWARD_CELLS:
        fam = report.get("family_train", {}).get(arch)
        if fam is not None:
            trainers[arch] = fam["train"]
    rows, found = [], {}
    for arch, (B, S, H, P, N) in SSD_BACKWARD_CELLS:
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(args.seed)

        def randn(*shape, dtype=torch.bfloat16):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        X, Bc, Cc = randn(B, S, H, P), randn(B, S, N), randn(B, S, N)
        Adt = -F.softplus(randn(B, S, H, dtype=torch.float32)) * 0.5
        dY = randn(B, S, H, P)
        ins = (X, Adt, Bc, Cc, dY)
        kern = lambda: ssd_mod.kernel_backward(*ins, chunk=256)  # noqa: E731
        got, again = kern(), kern()
        want = ssd_mod.ssd_chunked_backward(*ins, 256)
        torch.cuda.synchronize()
        gaps = {n: float((g.float() - w.float()).norm() / w.float().norm())
                for n, g, w in zip(("dX", "dAdt", "dBc", "dCc"), got, want)}
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        f = found[f"ssd_scan_backward/{arch}"] = {
            "norm_gap": gaps, "max_abs_err": err,
            "same_bits": all(torch.equal(a, b) for a, b in zip(got, again))}
        del got, again, want

        def recompute():
            return _build.recompute_grads(
                lambda *a: ssd_mod.ssd_chunked(*a, 256)[0], ins[:4],
                (True,) * 4, dY)

        tr = trainers.get(arch, {})
        row = kernel_row(torch, f"ssd_scan_backward/{arch}", "ssd_scan",
                         "none (the reference differentiates ssd_chunked)",
                         kern, lambda: ssd_mod.ssd_chunked_backward(*ins, 256),
                         None, ssd_mod.work_backward(X, Bc, 256),
                         torch.bfloat16, tr.get("ssd_backward_launches"),
                         err, f" {(B, S, H, P, N)} chunk 256")
        row.update(f, recompute_ms=time_plain_ms(torch, recompute, iters=2),
                   train_step_ms=tr.get("step_ms"))
        print(f"ssd_scan_backward/{arch}: {json.dumps(row)}")
        rows.append(row)
        del X, Bc, Cc, Adt, dY, ins
        torch.cuda.empty_cache()
    report["ssd_backward"] = found
    for name, f in found.items():
        check(all(g <= SSD_BACKWARD_BAR for g in f["norm_gap"].values()),
              f"{name}: every gradient within {SSD_BACKWARD_BAR} of its plain "
              f"version in norm ({f['norm_gap']})")
        check(f["same_bits"], f"{name}: two calls give the same bits")
    return rows


# phase 21: the norm kernel at the train cells' shapes, (name, rows, width,
# gated): mamba2-130m's gated norm at d_inner on (16, 2048) tokens,
# granite-4.0-h-small's at d_inner on (4, 4096), and granite's input norms
# at d_model, plain; held to CELL_BAR against autograd of the eager chain
# the models ran before the kernel
NORM_CELLS = (("mamba2-130m", 32768, 1536, True),
              ("granite-4.0-h-small", 16384, 8192, True),
              ("granite-4.0-h-small", 16384, 4096, False))


def rms_norm_rows(torch, args, dev, report) -> list:
    """Phase 21's norm lines (kernel table rows 6, 6a, 6b): at each shape of
    ``NORM_CELLS`` on seeded bf16 inputs, the kernel's output and its
    gradients dx, dz and dw through the models' norm against autograd of
    the eager chain (``backend="torch"``) by the ``CELL_BAR`` bar, the same
    bits on two calls of each kernel, and two lines: the forward and the
    backward, each graph-replay ms beside its byte bound, its plain
    version's ms (the kernels' arithmetic in eager ops) and
    ``torch.nn.functional.rms_norm``'s on the normed input (its autograd
    backward for the backward line): the library's yardstick, which the port
    never calls. The trainers' launches are phase 13's and 18's."""
    import torch.nn.functional as F
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models import layers as L

    eps = 1e-5
    trainers = {"mamba2-130m": report.get("lm_train", {}).get(
        "train", {}).get("ssd_scan", {})}
    fam = report.get("family_train", {}).get("granite-4.0-h-small")
    if fam is not None:
        trainers["granite-4.0-h-small"] = fam["train"]
    rows, found = [], {}
    for arch, n, D, gated in NORM_CELLS:
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(args.seed)

        def randn(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen, device=dev)
                    ).bfloat16()

        x, dout = randn(n, D, scale=2.0), randn(n, D)
        z = randn(n, D) if gated else None
        w = 1 + 0.3 * torch.randn(D, generator=gen, device=dev)
        name = f"rms_norm/{arch} {'gated ' if gated else ''}{D}"

        def through(backend):
            ins = [t.clone().requires_grad_() for t in (x, w)] + (
                [z.clone().requires_grad_()] if gated else [])
            y = L.rms_norm(ins[0], ins[1], eps, gate=ins[2] if gated
                           else None, backend=backend)
            dx, dw, *dz = torch.autograd.grad(y, ins, dout)
            return [y.detach(), dx] + dz + [dw]

        got, want = through("auto"), through("torch")
        mags = rn.magnitudes(dout, x, z, w, eps)
        worst = {}
        for key, k, p, m in zip(["out", "dx"] + (["dz"] if gated else [])
                                + ["dw"], got, want, mags):
            ratio = ((k.float() - p.float()).abs()
                     / (CELL_BAR * (m + p.float().abs()))).nan_to_num(0.0)
            worst[key] = float(ratio.max())
        out, rstd = rn.kernel_forward(x, w, eps, z)
        again = rn.kernel_forward(x, w, eps, z)
        bwd = rn.kernel_backward(dout, x, z, w, rstd)
        bwd2 = rn.kernel_backward(dout, x, z, w, rstd)
        torch.cuda.synchronize()
        f = found[name] = {
            "worst_err_over_bar": worst,
            "same_bits": bool(torch.equal(out, again[0])
                              and torch.equal(rstd, again[1])
                              and all(torch.equal(a, b)
                                      for a, b in zip(bwd, bwd2)))}
        del got, want, mags, again, bwd, bwd2
        g = (x if z is None else x * F.silu(z)).detach()
        wb = w.bfloat16()
        g_req, wb_req = g.clone().requires_grad_(), wb.clone().requires_grad_()
        lib_y = F.rms_norm(g_req, (D,), wb_req, eps)
        tr = trainers.get(arch, {}).get("norm_launches", {})
        tag = f" ({n}, {D}){' gated' if gated else ''}"
        fwd_row = kernel_row(
            torch, name, "rms_norm",
            "none (the reference's rms_norm, src/repro/models/layers.py, "
            "is jnp code XLA fuses)",
            lambda: rn.kernel_forward(x, w, eps, z),
            lambda: rn.rms_norm_plain(x, w, eps, z),
            lambda: F.rms_norm(g, (D,), wb, eps), rn.work(x, z),
            torch.bfloat16, tr.get("rms_norm"), None, tag)
        bwd_row = kernel_row(
            torch, name.replace("rms_norm/", "rms_norm_backward/"),
            "rms_norm", "none (autograd of the reference's rms_norm)",
            lambda: rn.kernel_backward(dout, x, z, w, rstd),
            lambda: rn.rms_norm_backward_plain(dout, x, z, w, rstd), None,
            rn.work_backward(x, z), torch.bfloat16,
            tr.get("rms_norm_backward"), None, tag)
        bwd_row["library_ms"] = time_plain_ms(
            torch, lambda: torch.autograd.grad(lib_y, (g_req, wb_req), dout,
                                               retain_graph=True), iters=5)
        for row in (fwd_row, bwd_row):
            row.update(f, bound_share=row["bound_ms"] / row["ms"],
                       train_step_ms=trainers.get(arch, {}).get("step_ms"))
            print(f"{row['name']}: {json.dumps(row)}")
            rows.append(row)
        del x, z, w, dout, out, rstd, g, wb, g_req, wb_req, lib_y
        torch.cuda.empty_cache()
    report["rms_norm"] = found
    for name, f in found.items():
        check(all(v <= 1.0 for v in f["worst_err_over_bar"].values()),
              f"{name}: the output and every gradient within {CELL_BAR} x "
              f"(the terms' magnitude + |plain|) of the eager chain's "
              f"(worst element at {f['worst_err_over_bar']} of its bar)")
        check(f["same_bits"], f"{name}: two calls of each kernel give the "
              f"same bits")
    return rows


# phase 22: the selective-scan kernel at jamba2-3b's cell, (arch, (batch,
# seq, d_inner, d_state)); y by SCAN_Y_BAR and each gradient by SCAN_BAR in
# norm against the plain version, as the SSD backward's rows are held
SCAN_CELL = ("jamba2-3b", (1, 16384, 5120, 16))
SCAN_Y_BAR = 2.0 ** -8
SCAN_BAR = 2.0 ** -6
SCAN_SLICE = 512


def selective_scan_rows(torch, args, dev, report) -> list:
    """Phase 22's lines (kernel table rows 7, 7a): the forward and backward
    kernels (``selective_scan.kernel_forward`` / ``kernel_backward``) at
    ``SCAN_CELL`` against the plain versions, the same bits on two calls,
    and their graph-replay ms beside the bound (bytes at the HBM rate, the
    float32 operations at the float32 peak: the recurrence is float32 on
    the CUDA cores) and the plain versions' ms. The plain backward runs on
    slices of ``SCAN_SLICE`` channels, which bounds its memory; its line's
    plain ms is that sliced run. Where phase 18 trained the model, each
    line's launches are that ``Trainer.run``'s (``train_*`` keys)."""
    import math
    from repro_torch.kernels import selective_scan as SS

    arch, (Bt, S, Dc, N) = SCAN_CELL
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt0 = torch.exp(torch.empty(Dc, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen))
    A = -torch.exp(torch.empty(Dc, N, device=dev).uniform_(
        0, math.log(16), generator=gen))
    ins = (rn(Bt, S, Dc).bfloat16(), rn(Bt, S, Dc).bfloat16(),
           dt0 + torch.log(-torch.expm1(-dt0)), A, rn(Bt, S, N).bfloat16(),
           rn(Bt, S, N).bfloat16(), 1 + 0.1 * rn(Dc),
           rn(Bt, S, Dc).bfloat16())
    dy = rn(Bt, S, Dc).bfloat16()

    def gap(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def plain_backward():
        u, dr, bias, A_, B, C, D, z = ins
        parts, dB, dC = [], 0, 0
        for c0 in range(0, Dc, SCAN_SLICE):
            s = slice(c0, c0 + SCAN_SLICE)
            g = SS.selective_scan_backward_plain(
                u[..., s], dr[..., s], bias[s], A_[s], B.float(), C.float(),
                D[s], z[..., s], dy[..., s])
            parts.append(g)
            dB, dC = dB + g[4], dC + g[5]
        out = [torch.cat([p[i] for p in parts], dim=0 if i == 3 else -1)
               for i in range(8)]
        out[4], out[5] = dB, dC
        return out

    y, kept = SS.kernel_forward(*ins)
    again = SS.kernel_forward(*ins)
    grads = SS.kernel_backward(*ins, kept, dy)
    grads2 = SS.kernel_backward(*ins, kept, dy)
    torch.cuda.synchronize()
    py, pkept = SS.selective_scan_plain(*ins)
    fwd = {"y_norm_gap": gap(y, py), "kept_norm_gap": gap(kept, pkept),
           "max_abs_err": float((y.float() - py.float()).abs().max()),
           "same_bits": bool(torch.equal(y, again[0])
                             and torch.equal(kept, again[1]))}
    del py, pkept, again
    torch.cuda.empty_cache()
    want = plain_backward()
    bwd = {"norm_gap": {n: gap(g, w) for n, g, w in zip(SS._NAMES, grads,
                                                        want)},
           "max_abs_err": max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(grads, want)),
           "same_bits": all(torch.equal(a, b) for a, b in zip(grads,
                                                              grads2))}
    del want, grads2
    torch.cuda.empty_cache()
    tag = f" {(Bt, S, Dc, N)}"
    name = f"selective_scan/{arch}"
    # the launches of phase 18's Trainer.run of the model, where it ran
    tr = report.get("family_train", {}).get(arch, {}).get("train")
    runs = tr["scan_launches"] if tr else {}
    fwd_row = kernel_row(
        torch, name, "selective_scan", "none (the JAX package has no "
        "Mamba-1 mixer)", lambda: SS.kernel_forward(*ins),
        lambda: SS.selective_scan_plain(*ins), None, SS.work(ins[0], ins[4]),
        torch.float32, runs.get("selective_scan"), fwd["max_abs_err"], tag)
    bwd_row = kernel_row(
        torch, f"selective_scan_backward/{arch}", "selective_scan",
        "none (the JAX package has no Mamba-1 mixer)",
        lambda: SS.kernel_backward(*ins, kept, dy), plain_backward, None,
        SS.work_backward(ins[0], ins[4]), torch.float32,
        runs.get("selective_scan_backward"), bwd["max_abs_err"], tag)
    for row, f, op in ((fwd_row, fwd, "selective_scan"),
                       (bwd_row, bwd, "selective_scan_backward")):
        row.update(f, bound_share=row["bound_ms"] / row["ms"])
        if tr:
            row.update(train_launches=runs[op],
                       train_launches_per_step=runs[op] // tr["steps"],
                       train_step_ms=tr["step_ms"])
        print(f"{row['name']}: {json.dumps(row)}")
    report["selective_scan"] = {fwd_row["name"]: fwd, bwd_row["name"]: bwd}
    check(fwd["y_norm_gap"] <= SCAN_Y_BAR and fwd["kept_norm_gap"]
          <= 2.0 ** -12, f"{name}: y within {SCAN_Y_BAR} and the kept states "
          f"within {2.0 ** -12} of the plain version in norm ({fwd})")
    check(all(v <= SCAN_BAR for v in bwd["norm_gap"].values()),
          f"{name}: every gradient within {SCAN_BAR} of the plain backward "
          f"in norm ({bwd['norm_gap']})")
    check(fwd["same_bits"] and bwd["same_bits"],
          f"{name}: two calls of each kernel give the same bits")
    del ins, dy, y, kept, grads
    torch.cuda.empty_cache()
    return [fwd_row, bwd_row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=10,
                    help="Trainer.run steps per model in phases 13 and 18")
    ap.add_argument("--out", default=None,
                    help="also write the result lines to this JSON file")
    ap.add_argument("--dryrun-child", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"error: {SRC / 'repro_torch'} not found; run chip_smoke.py "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.dryrun_child:
        return dryrun_child(*args.dryrun_child)
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.api.oracle import LatencyOracle
    from repro_torch.convert import profet_from_numpy, profet_to_numpy
    from repro_torch.core import workloads
    from repro_torch.core.predictor import ProfetConfig
    from repro_torch.kernels import _build, forest_eval
    from repro_torch.serve import LatencyService, synthetic_requests

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # -- build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} in "
          f"{report['build_s']:.1f} s")

    # -- fit the --full configuration on the card -------------------------
    t0 = time.perf_counter()
    cfg = ProfetConfig(members=("linear", "forest", "dnn"), n_trees=60,
                       dnn_epochs=args.epochs, seed=args.seed)
    oracle = LatencyOracle.fit(workloads.generate(), cfg, device="cuda")
    report["fit_s"] = time.perf_counter() - t0
    bank = oracle.bank
    check(bank is not None and oracle.bank_error is None,
          f"bank built on the card ({oracle.bank_error})")
    f = bank.forest
    G, T, N = f["feat"].shape
    print(f"fit: {report['fit_s']:.1f} s; bank (G, T, N) = ({G}, {T}, {N}), "
          f"D = {bank.n_features}, depth {f['depth'].tolist()}")
    check(f["feat"].is_cuda and bank.dnn[0][0]["w"].is_cuda,
          "forest stack and DNN heads live on the card")

    # -- 1. the main path: serving through the kernels ---------------------
    svc = LatencyService(oracle, max_wave=64)
    check(not svc.stats.degraded, f"service warm-up on the card "
          f"({svc.stats.warmup_ms:.1f} ms; {svc.stats.degraded_reason})")
    waves = []
    execute = bank.execute

    def recording_execute(X, gids):
        waves.append((np.array(X), np.array(gids)))
        return execute(X, gids)

    bank.execute = recording_execute
    reqs = synthetic_requests(oracle, n=args.requests, seed=args.seed)
    wave_plans = [oracle.plan(r) for r in reqs[:64]]

    forest_eval.reset_launches()
    replays, replay_counts = [], []
    for replay in (1, 2):
        before = dict(forest_eval.launches)
        replays.append(replay_once(svc, reqs))
        replay_counts.append({k: v - before[k]
                              for k, v in forest_eval.launches.items()})
        print(f"replay {replay}: {json.dumps(replays[-1])}; launches "
              f"{json.dumps(replay_counts[-1])}")
    per_group = oracle.execute(wave_plans, banked=False)
    counts = dict(forest_eval.launches)
    bank.execute = execute
    report["replays"] = replays
    report["replay_launches"] = replay_counts

    s = svc.stats
    check(s.requests == 2 * args.requests and s.errors == 0
          and all(r["requests"] == args.requests for r in replays),
          f"{s.requests} requests served, {s.errors} errors")
    check(not s.degraded and oracle.bank_error is None,
          "no degraded state and no bank error after serving")
    check(bank.forest_launches == s.fused_calls == len(waves) > 0,
          f"one grouped forest launch per banked wave "
          f"({bank.forest_launches} launches, {s.fused_calls} banked waves)")
    for replay, (r, c) in enumerate(zip(replays, replay_counts), 1):
        check(c["predict_grouped"] == r["banked_waves"]
              and c["leaf_values_grouped"] == c["tree_mean"] == 0
              and c["leaf_values_grouped/global"] == 0,
              f"replay {replay}: one fused grouped launch (traversal and "
              f"tree mean) per banked wave, by the shared route "
              f"({c['predict_grouped']} for {r['banked_waves']} waves; "
              f"leaves-only {c['leaf_values_grouped']}, global "
              f"{c['leaf_values_grouped/global']}, tree mean "
              f"{c['tree_mean']})")
    check(counts["predict_grouped"] == len(waves),
          f"{counts['predict_grouped']} fused grouped launches for "
          f"{len(waves)} banked waves")
    check(not per_group.banked and counts["predict"]
          == per_group.fused_calls > 0 and counts["leaf_values"] == 0
          and counts["leaf_values/global"] == 0,
          f"per-group wave: one fused single-forest launch per pair, by "
          f"the shared route ({counts['predict']} launches for "
          f"{per_group.fused_calls} pairs)")
    check(counts["tree_mean"] == 0,
          f"no separate tree-mean launch on the served path "
          f"({counts['tree_mean']})")
    print(f"launches on the main path: {json.dumps(counts)}")

    # -- 2. kernels against their plain versions ---------------------------
    X_np, g_np = max(waves, key=lambda w: len(w[0]))
    X = torch.from_numpy(X_np).to(dev)
    gid = torch.from_numpy(g_np).to(dev)
    fa = (f["feat"], f["thr"], f["left"], f["right"], f["value"])
    m = X.shape[0]
    pair = bank.pairs[int(np.bincount(g_np).argmax())]
    rf = oracle.profet.cross[pair].models["forest"]
    sf = rf.device_forest()
    sa = (sf["feat"], sf["thr"], sf["left"], sf["right"], sf["value"])
    Xs = X[gid == bank.gid[pair]].contiguous()
    depth1 = rf.forest_.depth
    rnd, Xr, gr = random_forest_stack(torch, dev)
    ra = (rnd["feat"], rnd["thr"], rnd["left"], rnd["right"], rnd["value"])
    print(f"kernel shapes: wave of {m} rows over {G} groups; per-group "
          f"{Xs.shape[0]} rows of pair {pair} (depth {depth1}); random "
          f"stack {tuple(rnd['feat'].shape)} depth {rnd['depth'].tolist()}")
    D = X.shape[1]

    def chosen(grouped_, n, mean=False):
        """The plan the wrapper takes for n rows, or None (global route);
        with mean, the fused prediction's."""
        return forest_eval.route_plan(
            G if grouped_ else 1, T, N, n, D,
            lambda smem: forest_eval.resident_blocks(grouped_, smem, dev,
                                                     mean=mean))

    plans = {"grouped": chosen(True, m), "single": chosen(False, Xs.shape[0]),
             "predict_grouped": chosen(True, m, mean=True),
             "predict": chosen(False, Xs.shape[0], mean=True)}
    shown = {k: (tuple(p), forest_eval.resident_blocks(
                 k in ("grouped", "predict_grouped"), p.smem, dev,
                 mean=k.startswith("predict")))
             for k, p in plans.items() if p is not None}
    check(len(shown) == 4,
          f"the serving shapes take the shared route (R rows a tile, B a "
          f"batch, smem bytes; blocks resident on the card): {shown}")

    def max_err(a, b):
        """Max abs difference; NaN must meet NaN (else inf)."""
        if not a.numel():
            return 0.0
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("inf")
        return float((a.nan_to_num() - b.nan_to_num()).abs().max())

    def grouped(backend, x=X, g=gid, args=fa, depth=f["depth"], route=None):
        """By the wrapper (route None), or by one route whatever the
        shape."""
        if route is None:
            return forest_eval.leaf_values_grouped(x, g, *args, depth,
                                                   backend=backend)
        if route == "global":
            return forest_eval._leaf_values_grouped_global(x, g, *args,
                                                           depth)
        plan = forest_eval.tile_plan(args[0].shape[0], *args[0].shape[1:],
                                     *x.shape)
        return forest_eval._leaf_values_grouped_shared(x, g, *args, depth,
                                                       plan)

    def single(backend, x=Xs, args=sa, depth=depth1, route=None):
        if route is None:
            return forest_eval.leaf_values(x, *args, depth=depth,
                                           backend=backend)
        if route == "global":
            return forest_eval._leaf_values_global(x, *args, depth=depth)
        plan = forest_eval.tile_plan(1, *args[0].shape, *x.shape)
        return forest_eval._leaf_values_shared(x, *args, depth=depth,
                                               plan=plan)

    def fused_grouped(backend, x=X, g=gid, args=fa, depth=f["depth"],
                      route=None):
        """The grouped prediction by the wrapper (route None), or forced
        through the fused kernel ("shared") whatever the shape."""
        if route is None:
            return forest_eval.predict_grouped(x, g, *args, depth,
                                               backend=backend)
        plan = forest_eval.tile_plan(args[0].shape[0], *args[0].shape[1:],
                                     *x.shape)
        return forest_eval._predict_grouped_shared(x, g, *args, depth, plan)

    def fused_single(backend, x=Xs, args=sa, depth=depth1, route=None):
        if route is None:
            return forest_eval.predict(x, *args, depth=depth,
                                       backend=backend)
        plan = forest_eval.tile_plan(1, *args[0].shape, *x.shape)
        return forest_eval._predict_shared(x, *args, depth=depth, plan=plan)

    # rows of every served wave, drawn with their group ids into a wave of
    # LARGE_WAVE rows spanning many row tiles
    X_all = torch.from_numpy(np.concatenate([w[0] for w in waves])).to(dev)
    g_all = torch.from_numpy(np.concatenate([w[1] for w in waves])).to(dev)
    pick = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, X_all.shape[0], size=LARGE_WAVE)).to(dev)
    X4k, g4k = X_all[pick].contiguous(), g_all[pick].contiguous()
    bad = gid.clone()
    bad[::5] = -1
    bad[2::7] = G
    bad[3::11] = G + 9
    kept = gid % 3 == 0
    kept_groups = sorted(set(gid[kept].tolist()))
    grouped_cases = [
        ("served wave", X, gid, fa, f["depth"]),
        ("random ragged stack", Xr, gr, ra, rnd["depth"]),
        ("out-of-range gids", X, bad, fa, f["depth"]),
        (f"only groups {kept_groups} of {G}", X[kept].contiguous(),
         gid[kept].contiguous(), fa, f["depth"]),
        ("m = 1", X[:1], gid[:1], fa, f["depth"]),
        (f"m = {LARGE_WAVE}", X4k, g4k, fa, f["depth"]),
    ]
    single_cases = [("served pair's rows", Xs, sa, depth1)] + [
        (f"random forest {g} (depth {int(rnd['depth'][g])})", Xr,
         tuple(a[g] for a in ra), int(rnd["depth"][g])) for g in range(4)] + [
        ("m = 1", Xs[:1], sa, depth1),
        (f"m = {LARGE_WAVE}", X4k, sa, depth1)]
    errs = {}
    runners = {"leaf_values_grouped": grouped, "leaf_values": single,
               "predict_grouped": fused_grouped, "predict": fused_single}
    for name, suffix in (("leaf_values_grouped", ""),
                         ("leaf_values_grouped", "/global"),
                         ("leaf_values", ""), ("leaf_values", "/global"),
                         ("predict_grouped", ""), ("predict", "")):
        route = "global" if suffix else "shared"
        worst = 0.0
        for case in (single_cases if name in ("leaf_values", "predict")
                     else grouped_cases):
            run = runners[name]
            e = max_err(run("auto", *case[1:], route=route),
                        run("torch", *case[1:]))
            torch.cuda.synchronize()
            check(e == 0.0, f"{name}{suffix} equals its plain version, "
                  f"{case[0]} ({case[1].shape[0]} rows; max abs err {e})")
            worst = max(worst, e)
        errs[name + suffix] = worst
    zero = all(not bool(b.any()) for b in forest_eval._COUNTERS.values())
    check(zero, "the fused kernels' tile counters are back at zero")

    leaves = grouped("auto")
    cpu_leaves = forest_eval.leaf_values_grouped(
        X.cpu(), gid.cpu(), *(a.cpu() for a in fa), f["depth"].cpu())
    e = max_err(leaves.cpu(), cpu_leaves)
    check(e == 0.0, f"leaf_values_grouped on the card equals the plain "
          f"version on the CPU, served wave (max abs err {e})")
    errs["leaf_values_grouped"] = max(errs["leaf_values_grouped"], e)
    errs["tree_mean"] = max(
        max_err(forest_eval.tree_mean(leaves),
                forest_eval.tree_mean(leaves, backend="torch")),
        max_err(forest_eval.tree_mean(leaves).cpu(),
                forest_eval.tree_mean(cpu_leaves)))
    check(errs["tree_mean"] == 0.0, f"tree_mean kernel equals its plain "
          f"version (max abs err {errs['tree_mean']})")
    for name, on_card, on_cpu in [
            ("predict_grouped", fused_grouped("auto"),
             forest_eval.predict_grouped(X.cpu(), gid.cpu(),
                                         *(a.cpu() for a in fa),
                                         f["depth"].cpu())),
            ("predict", fused_single("auto"),
             forest_eval.predict(Xs.cpu(), *(a.cpu() for a in sa),
                                 depth=depth1))]:
        e = max_err(on_card.cpu(), on_cpu)
        check(e == 0.0, f"{name} on the card equals the plain version on "
              f"the CPU, served shapes (max abs err {e})")
        errs[name] = max(errs[name], e)

    def grouped_work(x, g):
        """(bytes, compares) of a grouped traversal: the path's reads, gid
        and each used group's depth bound in, the (T, rows) leaves out."""
        path, cmp = path_bytes(torch, forest_eval, x, g, *fa[:4], f["depth"])
        n = x.shape[0]
        return path + n * 8 + int(g.unique().numel()) * 8 + T * n * 8, cmp

    def single_work(x):
        path, cmp = path_bytes(
            torch, forest_eval, x,
            torch.zeros(x.shape[0], dtype=torch.int64, device=dev),
            *(a[None] for a in sa[:4]),
            torch.tensor([depth1], dtype=torch.int64, device=dev))
        return path + T * x.shape[0] * 8, cmp

    def fused_work(work_l, n):
        """The traversal's work with (n,) means out in place of the (T, n)
        leaves (the scratch is not counted), plus the mean's T n adds and n
        divides."""
        return work_l[0] - T * n * 8 + n * 8, work_l[1] + T * n + n

    work_g, work_s = grouped_work(X, gid), single_work(Xs)
    work = {
        "leaf_values_grouped": work_g, "leaf_values_grouped/global": work_g,
        "leaf_values": work_s, "leaf_values/global": work_s,
        "tree_mean": (T * m * 8 + m * 8, T * m + m),
        "predict_grouped": fused_work(work_g, m),
        "predict": fused_work(work_s, Xs.shape[0]),
    }
    timed = {
        "leaf_values_grouped": (lambda: grouped("auto"),
                                lambda: grouped("torch")),
        "leaf_values_grouped/global": (lambda: grouped("auto",
                                                       route="global"),
                                       lambda: grouped("torch")),
        "leaf_values": (lambda: single("auto"), lambda: single("torch")),
        "leaf_values/global": (lambda: single("auto", route="global"),
                               lambda: single("torch")),
        "tree_mean": (lambda: forest_eval.tree_mean(leaves),
                      lambda: forest_eval.tree_mean(leaves,
                                                    backend="torch")),
        "predict_grouped": (lambda: fused_grouped("auto"),
                            lambda: fused_grouped("torch")),
        "predict": (lambda: fused_single("auto"),
                    lambda: fused_single("torch")),
    }
    meta = {
        "leaf_values_grouped": "src/repro/kernels/forest_eval.py:217",
        "leaf_values_grouped/global": "src/repro/kernels/forest_eval.py:217",
        "leaf_values": "src/repro/kernels/forest_eval.py:158",
        "leaf_values/global": "src/repro/kernels/forest_eval.py:158",
        "tree_mean": "src/repro/kernels/forest_eval.py:38",
        "predict_grouped": "src/repro/kernels/forest_eval.py:217",
        "predict": "src/repro/kernels/forest_eval.py:158",
    }
    # one PyTorch call for the same function, timed as a yardstick only;
    # it sums in its own order, so it is not bitwise equal to tree_mean
    library = {"tree_mean": lambda: leaves.mean(0)}
    report["tree_mean_vs_library_max_abs"] = max_err(
        forest_eval.tree_mean(leaves), leaves.mean(0))
    print(f"tree_mean against mean(0): max abs diff "
          f"{report['tree_mean_vs_library_max_abs']} (not bitwise)")
    kernels = []
    for name, (kern, plain) in timed.items():
        b_ms, b_by = bound_ms(*work[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/forest_eval.cu",
            "replaces": meta[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": time_kernel_ms(torch, kern),
            "plain_ms": time_plain_ms(torch, plain), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": (time_kernel_ms(torch, library[name])
                           if name in library else None)})
        note = (" (bound: inputs once and the (rows,) means out; the "
                "(T, rows) scratch of leaves is not counted)"
                if name.startswith("predict") else "")
        print(f"{name}: {json.dumps(kernels[-1])}{note}")
    report["work"] = {k: {"bytes": v[0], "ops": v[1]} for k, v in work.items()}

    # each fused prediction in turns (fused, two, two, fused) with the two
    # launches it replaces: the leaves-only traversal, then the tree mean
    fused_vs_two = {}
    for name, fused_run, leaves_run in [
            ("predict_grouped", lambda: fused_grouped("auto"),
             lambda: grouped("auto")),
            ("predict", lambda: fused_single("auto"),
             lambda: single("auto"))]:
        runs = {"fused": fused_run,
                "two": lambda r=leaves_run: forest_eval.tree_mean(r())}
        t = [time_kernel_ms(torch, runs[k])
             for k in ("fused", "two", "two", "fused")]
        fu, tw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        fused_vs_two[name] = {"fused_ms": fu, "two_launches_ms": tw,
                              "fused_over_two": fu / tw, "turns_ms": t}
        print(f"{name} fused against its two launches: "
              f"{json.dumps(fused_vs_two[name])}")
    report["fused_vs_two_launches"] = fused_vs_two

    # both routes at larger waves, over the bank and through one forest,
    # and the one the wrapper takes there
    large = {"leaf_values_grouped": {}, "leaf_values": {}}
    for n in WAVE_SIZES:
        xn, gn = X4k[:n].contiguous(), g4k[:n].contiguous()
        for name, work_l, runs, grouped_ in [
                ("leaf_values_grouped", grouped_work(xn, gn),
                 {r: (lambda r=r: grouped("auto", xn, gn, route=r))
                  for r in ROUTES}, True),
                ("leaf_values", single_work(xn),
                 {r: (lambda r=r: single("auto", xn, route=r))
                  for r in ROUTES}, False)]:
            b_ms, b_by = bound_ms(*work_l)
            # in turns (shared, global, global, shared); the mean of each
            order = ("shared", "global", "global", "shared")
            t = [time_kernel_ms(torch, runs[r], iters=50) for r in order]
            sh, gl = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            plan = forest_eval.tile_plan(G if grouped_ else 1, T, N, n, D)
            large[name][n] = {
                "shared_ms": sh, "global_ms": gl,
                "shared_over_global": sh / gl, "bound_ms": b_ms,
                "bound_by": b_by, "plan": list(plan),
                "blocks": T * (G if grouped_ else 1) * -(-n // plan.R),
                "resident": forest_eval.resident_blocks(grouped_, plan.smem,
                                                        dev),
                "taken": ("shared" if chosen(grouped_, n) is not None
                          else "global"),
                "turns_ms": t}
            print(f"{name} at {n} rows: {json.dumps(large[name][n])}")
    report["large_waves"] = large

    # -- 3. card against CPU, and the answers themselves ---------------------
    cpu_oracle = LatencyOracle(profet_from_numpy(
        profet_to_numpy(oracle.profet), device="cpu"), oracle.dataset)
    on_card = oracle.execute(wave_plans)
    on_cpu = cpu_oracle.execute(wave_plans)
    lat_card, lat_cpu = on_card.latencies(), on_cpu.latencies()
    check(on_card.banked and on_cpu.banked, "both waves banked")
    check(lat_card.shape == (64,) and np.isfinite(lat_card).all()
          and (lat_card > 0).all(), "64 finite positive latencies")
    rel = float(np.max(np.abs(lat_card - lat_cpu) / np.abs(lat_cpu)))
    check(rel <= RTOL_CARD_VS_CPU,
          f"card agrees with CPU within rtol {RTOL_CARD_VS_CPU} "
          f"(max rel err {rel:.3e})")
    pg = per_group.latencies()
    rel_pg = float(np.max(np.abs(pg - lat_card) / np.abs(lat_card)))
    check(rel_pg <= RTOL_CARD_VS_CPU,
          f"per-group path agrees with the banked path (max rel err "
          f"{rel_pg:.3e})")
    report.update(card_vs_cpu_max_rel=rel, per_group_vs_banked_max_rel=rel_pg,
                  kernels=kernels, launches=counts)

    # -- 4. a traced replay: where the card's time goes ----------------------
    trace = traced_replay(torch, LatencyService(oracle, max_wave=64), reqs)
    forest_ms = sum(v["device_ms"] for k, v in trace["repo_kernels"].items()
                    if k in FOREST_KERNELS)
    trace["forest_kernels_ms"] = forest_ms
    trace["forest_share_of_busy"] = (forest_ms / trace["device_busy_ms"]
                                     if trace["device_busy_ms"] else None)
    print(f"trace: {json.dumps(trace)}")
    check("tree_mean_kernel" not in trace["repo_kernels"],
          f"no tree-mean launch in the traced replay; forest kernels traced: "
          f"{sorted(k for k in trace['repo_kernels'] if k in FOREST_KERNELS)}")
    report["trace"] = trace

    # -- 5. artifacts, sharded and HTTP serving ------------------------------
    report["shard"] = shard_phase(torch, np, oracle, reqs, waves,
                                  wave_plans, args, card)

    # -- 11. live calibration, 12. the baselines ---------------------------
    report["calibration"] = calibration_phase(torch, np, oracle, waves,
                                              args, card)
    report["baselines"] = baselines_phase(np, card)

    # -- 19. the frozen reference fit path -----------------------------------
    report["reference"] = reference_phase(torch, np, reqs, card, dev)
    next(k for k in kernels if k["name"] == "predict")[
        "recursive_walk_max_abs_err"] = max(
            report["reference"]["oracle"]["max_abs_err"].values())

    # -- 6.-10. the LM serving path ------------------------------------------
    lm_rows = lm_phases(torch, np, args, dev, report)

    # -- 13. the LM training path --------------------------------------------
    per_kernel = train_phases(torch, np, args, dev, report)
    for row in lm_rows:
        row.update(per_kernel[row["name"]])
    kernels += lm_rows

    # -- 20. the optimizer kernel ---------------------------------------------
    adamw_rows = adamw_phase(torch, dev, report)
    kernels += adamw_rows

    # -- 14. the remaining families --------------------------------------------
    family_rows = family_phases(torch, np, args, dev, report)
    kernels += family_rows

    # -- 15. the distributed layer ---------------------------------------------
    per_kernel = mesh_phase(torch, np, args, dev, report)
    for row in lm_rows:
        row.update(per_kernel[row["name"]])

    # -- 16. the dry-run ------------------------------------------------------
    per_kernel = dryrun_phase(torch, args, report)
    for row in lm_rows:
        row.update(per_kernel[row["name"]])

    # -- 18. training the remaining families --------------------------------
    per_row = family_train_phase(torch, np, args, dev, report)
    for row in family_rows:
        row.update(per_row.get(row["name"], {}))
    per_case = adamw_train_counts(report)
    for row in adamw_rows:
        row.update(per_case[row["case"]])

    # -- 21. the LM kernels at a train cell's own inputs -----------------------
    kernels += cell_kernel_phase(torch, args, dev, report)
    kernels += ssd_backward_rows(torch, args, dev, report)
    kernels += rms_norm_rows(torch, args, dev, report)

    # -- 22. the selective-scan kernel at jamba2-3b's cell ---------------------
    kernels += selective_scan_rows(torch, args, dev, report)

    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
