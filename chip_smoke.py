#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing falls back to the CPU):
  1. card and build: the card's name and power limit, the build of every
     CUDA kernel from the sources in this checkout (``nvcc``, sm_90a) and of
     two control builds of the GEMM library (one or two of its three weight
     pieces), and the SASS of the SSA and spike GEMM libraries (every
     ``*_tc_kernel`` must hold ``HMMA``);
  2. kernels vs plain: each kernel (K1-K3 of the dense path, K4-K6 of the
     packed path, K8-K9 of the sparse path, and K4's occupancy epilogue) at
     the shapes its path gives it (spike-iand-former-8-384, slot batch 8),
     held against its plain PyTorch version on the same inputs, and timed
     beside it, beside one library call computing the same function (where
     there is one) and its tensor-core form (``library_tc_ms``: for the
     GEMMs ``torch.matmul`` with TF32 allowed, for K3, K6 and K9 the two
     products as f16 ``torch.bmm`` with f32 output), and beside its bound
     (bytes over the memory rate, or operations over the peak of the unit
     the work runs on: the bf16/f16 tensor cores for the GEMMs -- three
     bf16 products per spike x weight -- and the SSA kernels, exact on
     binary operands; float32 for the LIF kernels); K3 and K9 also on
     worst-case operand sets (all ones at Dh=128, ragged Dh=20 with N != M),
     causal and not, K6 also at T=33 and 40; K8 and K9 on three operand sets
     (50%-random words, half the tiles or some planes dead, all zero), held
     equal to K5 and K6; K2, K5 and K8 on one-hot rows within one unit in
     the last place of the weights they select, K2 on integer counts up to
     17 (the residual='add' configs) within GEMM_TOL, and the control
     builds caught by these checks;
  3. model: the main paths on a LIVE spike-iand-former-8-384 (``live_model``:
     seeded weights with BatchNorm perturbed as the reference's engine tests
     perturb it, so every block fires) on all six backends -- ``cuda``,
     ``torch``, ``cuda+packed``, ``torch+packed``, ``cuda+packed+sparse``,
     ``torch+packed+sparse`` -- 3 slot batches of 8 each, timed as
     ``serve_vision`` times them, each kernel route with every launch counter
     set to 0 just before and read just after; the three kernel routes'
     logits equal; the sparse kernel route held end to end against the
     sparse plain route (each plan's spikes on its own activations within
     E2E_SPIKE_SHARE of a layer, which the hi-only control GEMM must exceed,
     and its logits within E2E_LOGITS_ATOL), the other pairs reported; spike
     and word mismatches counted layer by layer, the spike rate of every LIF
     (fails if a block LIF never fires), the sparsity report, K8/K9 timed
     at the live data beside K5/K6, and one profiled forward per kernel
     route (each kernel's ``device_ms``); then one
     ``serve_vision`` per kernel route on the fresh-BN seeded model (dead
     beyond the tokenizer: the upper bound of what skipping saves);
  4. the other vision configs once each at full size (live weights) through
     the dense plans, and the IAND ones through the packed and sparse plans;
  5. training: spike-iand-former-8-384 from a seed, 224x224, batch 16 -- one
     ``train_step``'s loss and gradients on the kernel route (K1 + K7 per
     LIF, K3 per SSA) against the plain route on the same card (loss
     ``torch.equal``, every gradient leaf within ``GRAD_REL`` of the leaf's
     scale and non-zero wherever the plain one is, spikes block by block
     within the mismatch bound, every block LIF firing, the autograd
     Functions of both kernels in the graph); then ``train_spikformer``, the
     training entry point, for a few SGD steps with every launch counter set
     to 0 just before and read just after (60 K1 + 60 K7 + 8 K3 per step,
     60 K1 + 8 K3 per held-out forward); its checkpoint restored into fresh
     trees and served by a ``cuda+packed`` plan, held end to end against
     ``torch+packed+sparse`` as in phase 3 (the control must exceed the
     spike limit again) and against ``apply(train=False)``;
     ms per step and img/s on both routes, and one profiled step;
  6. the spiking LM: ``serve_spiking_lm`` at the full width of
     ``spiking_lm_config("llama3.2-1b")`` (16 layers, d 2048, 4 heads of
     Dh 512, d_ff 8192, vocab 128,256, T=4; weights from a seed, made on
     the card), 8 requests, prompt 32, 16 new tokens, 4 slots, on ``cuda``,
     ``cuda+packed`` and ``cuda+packed+sparse`` with every launch counted
     (113 LIF + 96 GEMM + 16 SSA per prefill, 113 + 96 + 0 per decode
     step), the three routes' streams and logits equal, every LIF firing;
     then on the live LM (``live_lm_params``: the same weights with the
     proj and fc2 norm gains at 0.5, so that the AND-NOT residual keeps
     every block firing) the three routes served again, a linear-ordering
     prefill, prefill plus 4 steps against the full forward and chunked
     prefill (spikes and state ``torch.equal``), the kernel route against
     the plain route (layer by layer; end to end within E2E_SPIKE_SHARE,
     which the control builds must exceed; the first diverging token), and
     one profiled prefill and decode step per route; then one 2048-token
     prompt (``LONG_PREFILL``, slot batch 1) through the live LM's prefill at
     full depth on the three routes: launches counted, logits ``torch.equal``
     across routes, ms per prefill and the GEMM / SSA / LIF device ms of a
     profiled prefill;
  7. continuous serving of the same LM (``launch.scheduler.ContinuousScheduler``
     through ``serve_continuous_plan``) on the live LM: 12 ``token_batch``
     requests, prompt lengths cycled over 8, 32 and 77, ``max_new`` 16...9, 4
     slots, the queue bounded at 12, closed loop, on the three kernel routes,
     and with 16-token chunked admission on ``cuda``, each run's launches
     counted (a batch-1 prefill or chunk as a prefill; the sparse decode step
     gathers the token's train from the plan's table, 112 LIF + 96 GEMM); every
     request completes and the streams ``torch.equal`` across routes and
     admissions, and each equal its single-stream decode teacher-forced, but
     where that decode's top-2 margin is within LM_LOGITS_ATOL (the head's
     cuBLAS order may differ between 1 and 4 rows); paging at prompt 32 (four
     batch-1 prefills scattered equal a 4-row prefill's state, and a step from
     either the same logits; gather then scatter round-trips) and the
     scatter's time; a 77-token admission against the plain route (spikes
     per layer, logits) and in 16-token chunks (state ``torch.equal`` the
     one-shot state); ``serve_spiking_lm_continuous`` on phase 6's uniform
     workload against ``serve_spiking_lm``'s streams and tok/s; the sparse
     plan's train table against the plain encoding LIF on all 128,256 rows;
     ``compile_plan(bundle=0.0)`` and ``bundle`` at ``llama3.2-1b_smoke`` on
     the kernel and plain routes; tok/s, occupancy, TTFT, stall per tick, one
     profiled batch-1 admission at 77 tokens and 4-slot step per route, and
     ``decode_slot_report``'s capacity beside the plan.
  8. a prompt past M * Dh = 2^24: the spiking LM at llama3.2-1b width, depth
     cut to 2 layers, prefills one 33,024-token prompt on the three kernel
     routes (K3, K6, K9 sum two key ranges; launches counted) and with the
     linear ordering on ``cuda``: logits and state ``torch.equal`` across all
     four;
  9. the paper's 8-bit bitplane input: ``core.encoding.bitplane_conv`` with
     the kernel route's 3x3 spike conv on the 8-384's folded encoding conv, a
     slot batch of 224x224 uint8 images (8 planes, one K2 launch, counted),
     held against the same function over the plain GEMM (GEMM_TOL on the
     encoding drive) and reported against the direct cuDNN conv (TF32 off),
     with the encoding LIF's spikes of the two sum orders compared;
 10. the graph checks of ``engine.analysis`` on the three kernel routes at
     full width, each with its negative case: no BN in the 8-384 deploy graph
     (the train-mode graph has 52), no RMSNorm layer in the llama3.2-1b plan
     (the oracle forward has 98), no axis of the prompt length in the decode
     step (after 24 tokens) or a 5-token prefill chunk (after 37; the full
     forward has it), every hand-kernel launch recorded;
 11. learning parity: the JAX package's example run (embed 48, 2 layers,
     16x16 images, 4 classes, 300 SGD steps of batch 16, 20 held-out
     batches) through ``train_spikformer`` on the kernel route (launches
     counted) and on the plain route from the same seed, held-out accuracies
     within LEARN_BAND of each other and above chance;
 12. the mesh (``compile_plan(mesh=)``): a gloo world of MESH_RANKS ranks,
     all on this card (``launch.mesh.spawn_world``; the ranks find the
     kernels phase 1 built), runs the live 8-384 (slot batch 8) on 1x2, 2x1
     and 2x2 and the live llama3.2-1b (a prefill of 4 x 32 tokens, then
     MESH_STEPS greedy steps, the state gathered with
     ``decode_state_full``) on 1x2 and 2x2, on the three kernel routes,
     each ``torch.equal`` the single-device plan this process ran first
     (the LM's logits and 1 GiB state by sha256 of their bytes); every
     rank's launches equal the single-device counts and its kernels' shapes
     those of its shard (GEMM columns 384/m and 1536/m, SSA folds over its
     rows and heads); under the packed routes every spike edge on the wire
     is int32, and on the non-sparse routes its ring bytes, summed over the
     data shards, equal ``spike_traffic`` / ``lm_spike_traffic``'s
     ``mesh=`` pricing; then ``serve_spiking_lm_continuous(mesh="2x1")``
     on phase 7's workload, one-shot and chunked, equal to the
     single-device streams.  Each rank's wall and device time per case is
     printed (ranks time-sliced on one card: not a scaling figure), and a
     2-rank world reports whether gloo takes CUDA tensors and times its
     all-gather of one dense edge on CUDA tensors against host staging;
 13. spiking-LM training at the full width of ``spiking_lm_config("llama3.2-1b")``
     (``live_lm_params``, 4 x 64 tokens of the port's fixture corpus): K1, K7
     and K3 at the training shapes against their plain versions
     (``torch.equal``) and timed; one ``loss_and_grad`` on the kernel route
     (113 K1 + 113 K7 + 16 K3, counted) against the plain route (loss
     ``torch.equal``, each gradient leaf within GRAD_REL of its max); one
     ``make_adamw(OptimizerConfig(state_dtype="bfloat16", master_weights=True))``
     update of that gradient tree, timed, its lm_head leaf held against the
     CPU; the main path, ``train_fixture_params`` for LM_TRAIN_STEPS SGD
     steps on the kernel route with every counter set to 0 just before and
     read just after, ms per step and tokens/s, one profiled step (K1, K7,
     K3, cuBLAS and the rest); then ``trained_lm_fixture`` in a fresh
     directory (60 steps at smoke width on the kernel route): it learns, a
     second call retrains nothing, and restored at T 8 and 32 it serves
     greedy streams ``torch.equal`` across ``cuda``, ``cuda+packed`` and
     ``cuda+packed+sparse`` in both orderings; its ``sparsity_report``
     beside the seeded model's;
 14. the generic LM families (``models/transformer.py``; no Pallas kernel is
     on this path, and no hand kernel may launch in it, counted): ``serve``
     of ``llama3.2-1b`` at full width (16 layers, d 2048, vocab 128,256, f32
     parameters from a seed on the card, bf16 compute; 8 requests, prompt
     32, 16 new tokens, 4 slots), prompt-feed and decode tok/s; its first
     slot batch again by hand in f32 compute (the prompt fed through
     ``make_serve_step`` against ``make_prefill_step``'s last logits, and
     decode from ``cache_init`` against ``forward`` over the 32 tokens,
     within GEN_DECODE_ATOL) and in bf16 (gaps printed, the tokens equal
     ``serve``'s); one AdamW ``make_train_step`` on 4 x 512 tokens (loss
     finite, every leaf moved) and two timed ones; the card against the CPU
     on the same 2-layer full-width f32 weights (logits within
     GEN_CPU_LOGITS_ATOL, every ``loss_fn`` gradient leaf within
     GEN_CPU_GRAD_REL of its max); then ``qwen1.5-4b``, ``qwen3-8b``,
     ``musicgen-large``, ``paligemma-3b``, ``granite-moe-3b-a800m``,
     ``mamba2-130m`` and ``recurrentgemma-9b`` at full width in f32, one at
     a time: parameter count, a prefill of 2 x 256 tokens of the modality
     (paligemma: its 256-token image prefix plus 256 text tokens), 32 decode
     steps from ``cache_init`` against ``forward`` within GEN_DECODE_ATOL
     (granite at capacity factor E / k, where nothing drops), granite's
     first MoE layer against its dense oracle; ``mistral-large-123b`` and
     ``kimi-k2-1t-a32b`` counted on the meta device.
 15. the generic trainer (``launch/train.py::train``; no hand kernel may
     launch, counted): ``train("llama3.2-1b")`` at full width, 12 AdamW
     steps of 4 x 512 tokens with no checkpoint directory (every loss finite,
     the last-3 mean below the first-3 mean; ms a step, tokens/s, peak GiB and
     the idle share of one profiled step), then 12 steps with
     ``compress_grads=True`` under the same gates; at full width cut to 2
     layers (f32 compute), 8 uninterrupted steps against ``stop_after=4`` and
     a resume from a temporary directory (params within the reference's
     rtol 1e-5 / atol 1e-6; the checkpoint's size, a save's and a restore's
     wall time) and the first 3 losses on the card against the CPU from the
     same weights (relative 1e-4, TF32 off); then the dry run
     (``launch/dryrun.py``) of all 10 archs x 4 cells x 2 production meshes on
     the meta device, made in a process of its own from the start of phase
     8 on, beside phases 8-13 (a failure there fails this phase with its
     traceback; OK / SKIP / FAIL counts: no FAIL, SKIP only where
     ``cell_supported`` says so) and its one-device record of llama3.2-1b's
     4 x 512 training step: argument bytes within 0.1% of what that state
     and batch allocate on the card, temporaries beside the measured peak of
     one step (reported); every OK record carries collective bytes.
 16. the generic LM's SPMD steps of the dense kind (``lm.make_*_step(mesh=)``;
     no hand kernel may launch): ``llama3.2-1b`` at full width cut to
     SPMD_DEPTH (2) layers, in f32 (TF32 off), an AdamW step of 4 x 512
     tokens, a 4 x 32 prefill and SPMD_STEPS (2) greedy steps on one device,
     then the same state handed by IPC to a 2x2 gloo world of 4 ranks on
     this card (``launch.mesh.World``, started with this phase and kept for
     phase 17's configs), which runs the steps under the ``base``, ``fsdp`` and
     ``zero2`` presets in turn (SPMD_PRESETS), each rank's loss, grad_norm,
     block of the new state, logits and tokens held against the single
     device's, its collective operand bytes against a record-only 2x2
     mesh's on meta under that preset;
 17. the same for the MoE, SSM and hybrid kinds, one config at a time
     (``SPMD17``) on the same world, each after the ranks released the
     config before: ``granite-moe-3b-a800m`` at full width cut to 2 layers
     (under ``base`` its 40 experts split 20/20 over ``data``: the
     all-to-all runs; under ``fsdp`` and ``zero2`` its MoE is device-local,
     the experts gathered whole), also one train step under kimi's Adafactor
     settings; ``mamba2-130m`` at 4 layers; ``recurrentgemma-9b`` at full
     width cut to one rec, rec, attn_local period (its reference handed to
     the ranks in one shared host segment), its 2 x 2048-token prompt
     as long as its window so that the decode steps wrap the ring; caches
     held too.  Every rank compares the experts it picked with the single
     device's: an MoE step in which none flipped is held in full (else
     SPMD_FLIP_SHARE); Adafactor's elements where the single device's
     row x col underflows are counted, not held;
 18. the three step builders under ``sp`` must raise ``ValueError`` naming
     ``model``, as the reference's ``NamedSharding`` refuses the spec; and,
     in a process of its own beside the worlds of phases 16 and 17, a
     rank's collective operand bytes of ``llama3.2-1b``'s train_4k cell on
     the production 16x16 mesh under ``base``, ``fsdp`` and ``zero2``
     (meta).  Phases 16 and 17 share one runner, ``phase_spmd``.
Phase 2 also holds K7 (the LIF backward) ``torch.equal`` to its plain
version at the six LIF shapes of the training batch, chain_len 1/2/4, both
resets, and the LM path's kernels at its shapes: K3, K6 and K9 at Dh=512
(N = M = 32, 512, 2048, all ones, ragged Dh=200 with N != M, M * Dh just
below 2^24, and one key more: two key ranges), every kernel timed per
prefill, K2 also per decode step, K3, K6 and K9 also on 512- and 2048-token
prompts in every slot (G = 64; the same spikes as T = 4 planes of 16 folds
for K6 and K9), each beside its f16 ``torch.bmm`` pair; every kernel of
phase 7's path at the shapes phase 7 adds (batch-1 admissions and chunk
buckets, N = 8...77 tokens, and the 4-slot step) against its plain
version, each row also
against the same row at another row count; K1, K4 and K7 on bf16 drives at
the 8-384 shapes (``torch.equal``, timed against their byte bounds, then
the bf16 path -- ``core.lif.lif`` on bf16 drives, one forward and one
training step's LIFs -- with its launches counted and each run profiled);
K1 and K4 over the edges of their vector design (``_lif_edges``: f32 and
bf16, T = 1, 4, 32, 33, 40, every chain_len of 1, 2, 3, 4, 8 dividing T,
both resets, IAND off and on, N of every residue mod 8 and an operand at a
one-element offset, and K4's occupancy map of rows of D = 48, 96, 192, 200,
384, 1536, 2048 and 130, each ``torch.equal`` its plain version); and K3, K6 and K9 past
the 2^24 edge (N = M = 33,024, Dh = 512, causal, near-all-ones operands,
every row ``torch.equal`` the plain version in 1024-row slices); and K2, K5
and K8 at a model shard's 192 and 96 columns and a data shard's half rows,
each launch ``torch.equal`` the full launch's block, and K4's occupancy map
at 192 and 384 columns equal to the map recomputed from its words.  The last
lines are ``seconds:`` (each phase's seconds and each library's ``nvcc``
seconds, JSON), the card's ``nvidia-smi`` name and power limit,
a JSON line of per-kernel numbers, and ``{"ok": true, "device": {...}}``.
In the JSON line ``launches`` is the count over the live main-path run of
the kernel's path (warm-up forward included) and ``launches_per_forward``
that count over the forwards -- for K7, whose path is training, the count
over phase 5's ``train_spikformer`` run and that count per training step;
``ms`` (CUDA events over back-to-back launches) and ``device_ms`` (the
kernel's own device time in one profiled forward of its route on the live
model; K4's from the packed route) are per forward, K7's per training
step, as are its ``plain_ms`` and ``bound_ms``.  K8 and K9's ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are per forward at the live
model's own operands.  The entries named ``*@llama3.2-1b`` are the LM
path's: per prefill forward at its shapes (``... decode``: K2 per decode
step), ``launches`` over the prefills (the decode steps) of phase 6's
``serve_spiking_lm`` run on the kernel's route, ``device_ms`` from one
profiled prefill (step).  The entries after those: the bf16 forms of K1,
K4, K7 (per forward, K7 per training step; ``launches`` from the bf16 path,
``device_ms`` from its profiled forward and step), K3/K6/K9 past 2^24 (per
launch; ``launches`` from phase 8's prefills) and K2 at the bitplane input's
shape (``launches`` from phase 9), whose ``device_ms`` is not measured
(null).  The last three entries,
``*@lm-train``, are phase 13's: K1, K7 and K3 per training step of the
full-width LM (``launches`` over its ``train_fixture_params`` run,
``launches_per_forward`` per step, ``device_ms`` from its profiled step).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
ARCH = "spike-iand-former-8-384"
SLOTS, REQUESTS = 8, 24
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores, same source
TC_FLOP_PER_S = 989e12         # f16/bf16 tensor cores, dense, f32 accumulation, same source
GEMM_TOL = dict(rtol=1e-5, atol=1e-4)   # f32 sums of up to 1728 terms, reordered
# The spike GEMMs (K2, K5, K8) run three bf16 tensor-core products per spike x
# weight product (the weight split into hi, mid and lo pieces).
GEMM_PIECES = 3
LOGITS_ATOL = 1e-3
# A kernel route against a plain route on a model that fires (the live
# model, the trained model), where the two differ only in the GEMMs' sum order
# (tensor cores against f32 torch.matmul): a spike flipped at threshold by the
# other order feeds every later layer.  Each plan runs end to end on its own
# activations, and the largest share of a layer's neuron-steps that differ
# must stay within E2E_SPIKE_SHARE.  Sound runs read at most 2.1e-3 (the live
# model's last block), the control build of the GEMM with only the hi piece
# (E2E_CONTROL) 2.2e-2 and more, and it must exceed the limit in every run
# (PERF.md, PR 16).  The logits must stay within E2E_LOGITS_ATOL, 3x the
# largest sound reading (0.0171); no control reaches it -- the rate head
# averages the flips away (hi-only: 0.045 on the live model, 0.016 on the
# trained one) -- so it guards against gross faults only.
E2E_SPIKE_SHARE = 5e-3
E2E_LOGITS_ATOL = 0.05
E2E_CONTROL = "spike_matmul_hi"
# K2, K5 and K8 on one-hot rows: one spike times three pieces sums to the
# selected weight exactly, which f32 holds, so only the tensor cores'
# truncating add may cost the last bit.  Two pieces miss by ~2^-17 of w.
ONE_HOT_ULPS = 1
# The largest count the dense GEMM reads on a main path: the residual stream
# of the residual='add' configs, a sum of at most 2L + 1 spike trains (L = 8).
ADD_STREAM_MAX = 17
# Share of a layer's spikes (neuron-steps, dense or packed) that may differ
# when the kernel layer and the plain layer get the same input: a spike flips
# only where the membrane lies within f32 reassociation error (~1e-6) of theta.
MISMATCH_SHARE = 1e-4
BACKENDS = ("cuda", "torch", "cuda+packed", "torch+packed", "cuda+packed+sparse",
            "torch+packed+sparse")
PATHS = {"cuda": ("K1", "K2", "K3"), "cuda+packed": ("K4", "K5", "K6"),
         "cuda+packed+sparse": ("K4", "K8", "K9")}
TRAIN_BATCH, TRAIN_STEPS, TRAIN_EVAL = 16, 3, 2
# The spiking LM of phase 6: spiking_lm_config("llama3.2-1b") at full width
# (16 layers, d_model 2048, 4 heads of Dh 512, d_ff 8192, vocab 128,256, T = 4),
# weights from a seeded generator on the card, served as the reference's
# --spiking-lm defaults serve it.
LM_ARCH = "llama3.2-1b"
LM_REQUESTS, LM_PROMPT, LM_NEW, LM_SLOTS, LM_CHUNK = 8, 32, 16, 4, 8
LM_LAYERS, LM_D, LM_FF, LM_HEADS, LM_DH, LM_VOCAB = 16, 2048, 8192, 4, 512, 128256
LONG_PREFILL = 2048   # tokens of phase 6's full-depth prompt (one slot)
# The workload of phase 7, continuous serving at the same width: prompt lengths
# cycled over CONT_LENS, max_new LM_NEW - (i % (CONT_SPREAD + 1)) (16...9), the
# admission queue bounded at CONT_PENDING, closed loop; chunked admission in
# CONT_CHUNK-token chunks (buckets 16, 13 and 8) on the cuda route.
CONT_REQUESTS, CONT_LENS, CONT_SPREAD, CONT_PENDING, CONT_CHUNK = 12, (8, 32, 77), 7, 12, 16
# Decode against the full forward on the card: spikes and state are exact
# integer arithmetic, but the head is a cuBLAS f32 GEMM whose order may
# differ between B and B*S rows: logits within LM_LOGITS_ATOL (2048-term f32
# sums of |terms| < 0.1: reordering moves them by ~1e-5 at most).
LM_LOGITS_ATOL = 1e-4
# Per gradient leaf, max |kernel route - plain route| <= GRAD_REL * max |plain
# route|: the forward is bit-equal on both routes (so is every surrogate
# mask), and the backward differs only in the SSA's sum order (three
# torch.bmm against autograd of the einsum), f32 sums of ~10^5 terms.
GRAD_REL = 1e-4


_FAILED: list[str] = []


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    """Record a failed check and go on, so that one run prints every
    reading; ``fail_if_any`` ends the phase."""
    if not ok:
        print(f"[chip_smoke] CHECK FAILED: {msg}", flush=True)
        _FAILED.append(msg)


def _result(future, what: str):
    """The result of a task in another process; fails the run with the
    task's traceback if it raised or its process died."""
    try:
        return future.result()
    except Exception as e:   # the task raised, or its pool broke (BrokenProcessPool)
        fail(f"{what} failed:\n" + "".join(traceback.format_exception(e)))


def fail_if_any(phase: str) -> None:
    if _FAILED:
        fail(f"{phase}: {len(_FAILED)} check(s) failed: " + "; ".join(_FAILED))


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, peak: float = TC_FLOP_PER_S) -> tuple[float, str]:
    """The least time of the work: its bytes over the memory rate or its
    operations over ``peak``, the rate of the unit the work runs on (the
    f16/bf16 tensor cores for the SSA kernels and the GEMMs, exact on binary
    operands, the GEMMs with three bf16 products each; float32 for the LIF
    kernels' elementwise work)."""
    from repro_torch.launch.timing import HBM_BYTES_PER_S

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class KernelReport:
    """Per-kernel sums over the main path's cases, each weighted by how many
    times one forward launches it."""

    def __init__(self, name, source, replaces):
        self.entry = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": None,
                      "launches_per_forward": None, "max_abs_err": 0.0,
                      "ms": 0.0, "device_ms": None, "plain_ms": 0.0, "bound_ms": 0.0,
                      "bound_by": None, "library_ms": None, "library_tc_ms": None}
        self._bound = {"bytes": 0.0, "operations": 0.0}

    def add(self, label, count, err, ms, plain_ms, nbytes, flops, library_ms=None,
            peak=TC_FLOP_PER_S, library_tc_ms=None):
        b, by = bound_ms(nbytes, flops, peak)
        e = self.entry
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ms"] += count * ms
        e["plain_ms"] += count * plain_ms
        e["bound_ms"] += count * b
        self._bound[by] += count * b
        if library_ms is not None:
            e["library_ms"] = (e["library_ms"] or 0.0) + count * library_ms
        if library_tc_ms is not None:
            e["library_tc_ms"] = (e["library_tc_ms"] or 0.0) + count * library_tc_ms
        e["bound_by"] = max(self._bound, key=self._bound.get)
        lib = f" library {library_ms:.4f} ms" if library_ms is not None else ""
        if library_tc_ms is not None:
            lib += f" (tensor cores {library_tc_ms:.4f} ms)"
        log(f"  {self.entry['name']} {label} x{count}/forward: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms,{lib} bound {b:.4f} ms ({by}), "
            f"max_abs_err {err:.3g}")


def matmul_tf32_ms(x, w, reps=20):
    """Device time of ``torch.matmul(x, w)`` with TF32 allowed: the tensor-core
    yardstick of the spike GEMMs (cuBLAS's own TF32 kernels, ~10 bits of
    mantissa; timed only, its result is not held to GEMM_TOL)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return time_ms(lambda: torch.matmul(x, w), reps=reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def library_tc_ms(q, k, v, scale, want, label, causal=False):
    """Device time of the two SSA products on the tensor cores through one
    PyTorch call each: f16 operands, f32 accumulation and output
    (``torch.bmm(..., out_dtype=torch.float32)``), the scores cast to f16
    between them (exact: integers <= 512), masked by ``torch.tril`` where
    ``causal``.  Held ``torch.equal`` to ``want``.  None, logged, where this
    PyTorch lacks that ``out_dtype``."""
    q16, k16, v16 = q.half(), k.half(), v.half()
    mask = torch.tril if causal else (lambda x: x)
    run = lambda: torch.bmm(mask(torch.bmm(q16, k16.transpose(1, 2), out_dtype=torch.float32))
                            .half(), v16, out_dtype=torch.float32) * scale
    try:
        got = run()
    except (TypeError, RuntimeError, NotImplementedError) as e:
        log(f"  {label}: torch.bmm(..., out_dtype=torch.float32) is missing in torch "
            f"{torch.__version__} ({type(e).__name__}: {str(e).splitlines()[0][:120]}); "
            "library_tc_ms null")
        return None
    same = torch.equal(got, want)
    check(same, f"{label}: the tensor-core library pair differs from the plain version")
    log(f"  {label}: tensor-core library pair (f16 bmm, f32 out) torch.equal the plain "
        f"version: {same}")
    return time_ms(run)


def _ssa_operand_sets(gen, g, ntok, binary):
    """(label, q, k, v) of the worst-case SSA operand sets beside the main
    path's random one: all ones at Dh=128 and N = M = ntok (the largest
    scores, 128, and sums, 128 * ntok, the path can give), and ragged Dh=20
    with N != M both ways.  ``binary(shape)`` draws a random operand."""
    ones = torch.ones((g, ntok, 128))
    yield "all-ones Dh=128", ones, ones, ones
    for n, m in ((ntok, 131), (131, ntok)):
        yield (f"ragged Dh=20 N={n} M={m}", binary((g, n, 20)), binary((g, m, 20)),
               binary((g, m, 20)))


def phase_card_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build([*_build.SOURCES, *_build.CONTROLS])
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)}; the control builds with "
        + ", ".join(f"{n}: -D{' -D'.join(d)}" for n, (_, d) in _build.CONTROLS.items())
        + "; in parts, each part -c for -shared and linked: "
        + ", ".join(f"{n}: -D{m}=0...{k - 1}" for n, (m, k) in _build.PARTS.items()) + ")")
    log("  nvcc seconds a library, all started together: " + ", ".join(
        f"{n} {b.seconds:.1f}" + (f" (parts {', '.join(f'{x:.1f}' for x in b.parts)}, then "
                                  "the link)" if b.parts else "")
        for n, b in sorted(built.items(), key=lambda nb: -nb[1].seconds)))
    for name, b in built.items():
        if name in _build.CONTROLS:
            continue
        for line in b.log.splitlines():
            if "Compiling entry" in line:
                log(f"  ptxas {name}: {line.split(chr(39))[1] if chr(39) in line else line}")
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")
    _tensor_core_sass(_build)
    return smi, {n: b.seconds for n, b in built.items()}


def _tensor_core_sass(_build):
    """HMMA instructions per kernel of the SSA and spike GEMM libraries
    (``cuobjdump -sass``): fails if a tensor-core kernel (``*_tc_kernel``)
    holds none, or a library has none."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        cuobjdump = shutil.which("cuobjdump")
    if not cuobjdump:
        fail("cuobjdump is neither beside nvcc nor on PATH: the SASS cannot be checked")
    for lib in ("ssa", "spike_matmul"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        counts, name = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = 0
            elif name and "HMMA" in line:
                counts[name] += 1
        log(f"  SASS HMMA per {lib} kernel: "
            + ", ".join(f"{k} {v}" for k, v in counts.items()))
        missing = [k for k, v in counts.items() if "_tc_kernel" in k and v == 0]
        if missing or not any("_tc_kernel" in k for k in counts):
            fail(f"{lib}: tensor-core kernels without HMMA in their SASS: "
                 f"{missing or 'none found'}")


def phase_kernels(dev, gen):
    """Kernels vs plain at the 8-384 main path's shapes, slot batch 8."""
    from repro_torch.core import lif as tlif
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import ssa_ref

    t, b, ntok, d, hid, heads = 4, SLOTS, 196, 384, 1536, 12
    reports = {}

    # -- K1: LIF (+IAND) ---------------------------------------------------
    rep = KernelReport("lif_parallel", "src/repro_torch/kernels/lif_parallel/csrc/lif_parallel.cu",
                       "src/repro/kernels/lif_parallel/kernel.py:144")
    big = b * 112 * 112 * 48
    drive = torch.randn((t, big), generator=gen).to(dev)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8      # membranes exactly on theta too
    skip = (torch.rand((t, big), generator=gen) > 0.5).float().to(dev)
    for iand in (False, True):
        for reset in ("hard", "soft"):
            for chain in (1, 2, 4):
                sk = skip if iand else None
                got = lif_ops.lif_parallel_fwd(drive, chain_len=chain, lam=0.25,
                                               theta=0.5, reset=reset, skip=sk)
                want = tlif.lif_parallel(drive, chain_len=chain, reset=reset, iand_skip=sk)
                if not torch.equal(got, want):
                    fail(f"lif_parallel iand={iand} reset={reset} chain_len={chain}: "
                         f"{(got != want).sum().item()} mismatches")
    log(f"K1 lif_parallel: torch.equal at N={big} for iand x reset x chain_len 1/2/4")
    cases = [(b * 112 * 112 * 48, False, 1), (b * 56 * 56 * 96, False, 1 + 8),
             (b * 28 * 28 * 192, False, 1), (b * ntok * d, False, 1 + 4 * 8),
             (b * ntok * d, True, 2 * 8)]
    for n, iand, count in cases:
        x, sk = drive[:, :n].contiguous(), (skip[:, :n].contiguous() if iand else None)
        run = lambda: lif_ops.lif_parallel_fwd(x, chain_len=t, lam=0.25, theta=0.5,
                                               reset="hard", skip=sk)
        plain = lambda: tlif.lif_parallel(x, iand_skip=sk)
        got, want = run(), plain()
        if not torch.equal(got, want):
            fail(f"lif_parallel N={n} iand={iand}: not equal to the plain version")
        nbytes = 4 * t * n * (3 if iand else 2)
        rep.add(f"N={n} iand={iand}", count, 0.0, time_ms(run), time_ms(plain), nbytes,
                5 * t * n, peak=F32_FLOP_PER_S)
    reports["K1"] = rep
    del drive, skip

    # -- K2: spike GEMM ----------------------------------------------------
    rep = KernelReport("spike_matmul", "src/repro_torch/kernels/spike_matmul/csrc/spike_matmul.cu",
                       "src/repro/kernels/spike_matmul/kernel.py:164")
    m_blk = t * b * ntok
    cases = [(t * b * 112 * 112, 9 * 48, 96, 1), (t * b * 56 * 56, 9 * 96, 192, 1),
             (t * b * 28 * 28, 9 * 192, 384, 1), (m_blk, d, d, 4 * 8),
             (m_blk, d, hid, 8), (m_blk, hid, d, 8)]
    for m, k, c, count in cases:
        x = (torch.rand((m, k), generator=gen) > 0.5).float().to(dev)
        w = ((torch.rand((k, c), generator=gen) * 2 - 1) / k ** 0.5).to(dev)
        run = lambda: mm_ops.spike_matmul_fwd(x, w)
        plain = lambda: mm_ops.spike_matmul_ref(x, w)
        got, want = run(), plain()
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        if not torch.allclose(got, want, **GEMM_TOL):
            fail(f"spike_matmul {m}x{k}x{c}: max abs err {err:.3g}, max rel {rel:.3g} "
                 f"outside {GEMM_TOL}")
        log(f"  spike_matmul {m}x{k}x{c}: max abs err {err:.3g}, max rel err {rel:.3g} "
            f"(tolerance {GEMM_TOL})")
        rep.add(f"{m}x{k}x{c}", count, err, time_ms(run), time_ms(plain),
                4 * (m * k + k * c + m * c), GEMM_PIECES * 2 * m * k * c,
                library_ms=time_ms(lambda: torch.matmul(x, w)),
                library_tc_ms=matmul_tf32_ms(x, w))
        del x, w, got, want
    reports["K2"] = rep

    # -- K3: SSA -----------------------------------------------------------
    rep = KernelReport("ssa", "src/repro_torch/kernels/spiking_attention/csrc/ssa.cu",
                       "src/repro/kernels/spiking_attention/kernel.py:62")
    g, dh = t * b * heads, d // heads
    binary = lambda shape: (torch.rand(shape, generator=gen) > 0.5).float().to(dev)
    q, k, v = (binary((g, ntok, dh)) for _ in range(3))
    sets = [("random", q, k, v)] + [(label, *(x.to(dev) for x in xs)) for label, *xs in
                                    _ssa_operand_sets(gen, g, ntok, binary)]
    for label, qs, ks, vs in sets:
        for causal in (False, True):
            if not torch.equal(ssa_ops.ssa_fwd(qs, ks, vs, scale=0.125, causal=causal),
                               ssa_ref(qs, ks, vs, scale=0.125, causal=causal)):
                fail(f"ssa {label} {tuple(qs.shape)} causal={causal}: not equal to the "
                     "plain version")
    log(f"K3 ssa: torch.equal at G={g} on {', '.join(x[0] for x in sets)} (N={ntok}, "
        f"Dh={dh} unless named), causal and not")
    del sets
    run = lambda: ssa_ops.ssa_fwd(q, k, v, scale=0.125)
    plain = lambda: ssa_ref(q, k, v, scale=0.125)
    library = lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v) * 0.125
    rep.add(f"G={g} N={ntok} Dh={dh}", 8, 0.0, time_ms(run), time_ms(plain),
            4 * 4 * g * ntok * dh, 4 * g * ntok * ntok * dh, library_ms=time_ms(library),
            peak=TC_FLOP_PER_S,
            library_tc_ms=library_tc_ms(q, k, v, 0.125, plain(), "K3"))
    reports["K3"] = rep
    reports.update(_packed_kernels(dev, gen))
    reports["K7"] = _lif_backward(dev, gen)
    return reports


def _admission_lens():
    """Token counts of one sequence on phase 7's path: the prompt lengths of
    one-shot admission and the chunk buckets of chunked admission."""
    from repro_torch.launch.scheduler import _chunk_buckets

    return sorted(set(CONT_LENS).union(*(_chunk_buckets(n, CONT_CHUNK) for n in CONT_LENS)))


def _lm_ssa_sets(gen, dev):
    """(label, q, k, v, causal) of the LM's attention beside the main path's
    (G = T*B*H = 64, N = M = 32, Dh = 512, causal): one sequence (G = T*H =
    16) at phase 7's admission and chunk lengths with some folds all zero
    (dead planes for K9), longer prompts (512, 2048), phase 6's LONG_PREFILL
    prompt at slot batch 1 (G = T*H = 16), all ones at Dh = 512 (the largest
    scores, 512), ragged Dh = 200 with N != M both ways, and all ones with
    M * Dh just below 2^24 (one query tile, not causal: every output is the
    largest exact sum)."""
    binary = lambda shape: (torch.rand(shape, generator=gen) > 0.5).float().to(dev)
    g, d = 4 * LM_SLOTS * LM_HEADS, LM_DH
    for n in _admission_lens():
        q, k = binary((4 * LM_HEADS, n, d)), binary((4 * LM_HEADS, n, d))
        q[1::5], k[2::7] = 0.0, 0.0
        yield f"G={4 * LM_HEADS} N=M={n} dead folds", q, k, binary((4 * LM_HEADS, n, d)), True
    for n in (512, 2048):
        yield f"N=M={n}", binary((g, n, d)), binary((g, n, d)), binary((g, n, d)), True
    one = (4 * LM_HEADS, LONG_PREFILL, d)
    yield (f"G={one[0]} N=M={LONG_PREFILL} (slot batch 1)", binary(one), binary(one), binary(one),
           True)
    ones = torch.ones((g, 512, d), device=dev)
    for causal in (False, True):
        yield "all-ones N=M=512", ones, ones, ones, causal
    for n, m in ((57, 40), (40, 57)):
        for causal in (False, True):
            yield (f"ragged Dh=200 N={n} M={m}", binary((g, n, 200)), binary((g, m, 200)),
                   binary((g, m, 200)), causal)
    edge = 2 ** 24 // d - 1
    yield (f"all-ones M*Dh = 2^24 - {d}", torch.ones((1, 64, d), device=dev),
           torch.ones((1, edge, d), device=dev), torch.ones((1, edge, d), device=dev), False)


def _lm_kernels(dev, gen):
    """The kernels of the spiking LM's path at its shapes (llama3.2-1b width,
    slot batch 4, prompt 32, T = 4): K3, K6 and K9 at Dh = 512 on the main
    path's operands and on the sets of :func:`_lm_ssa_sets`, each
    ``torch.equal`` its plain version, and one key past M * Dh = 2^24 (two
    key ranges) too; then every kernel timed per prefill forward beside its plain
    version, its bound and the library calls, and K2 per decode step (16
    rows).  Returns the reports of the LM entries of the JSON line."""
    from repro_torch.core import lif as tlif
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.lif_parallel.ref import lif_pack_ref
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spike_matmul.ref import (
        packed_spike_matmul_ref, sparse_packed_spike_matmul_ref)
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import (
        packed_ssa_ref, sparse_packed_ssa_ref, ssa_ref)

    t, b, s, d, f, layers = 4, LM_SLOTS, LM_PROMPT, LM_D, LM_FF, LM_LAYERS
    suffix = f"@{LM_ARCH}"
    src = "src/repro_torch/kernels/{}/csrc/{}.cu"
    tpu = "src/repro/kernels/{}/kernel.py:{}"
    reports = {}
    pack = lambda x: packing.pack(x).words
    fold_words = lambda x: x.reshape(1, x.shape[0], x.shape[1], x.shape[2])

    # -- K3, K6, K9 at Dh = 512: exactness ----------------------------------------------
    g, dh = t * b * LM_HEADS, LM_DH
    binary = lambda shape: (torch.rand(shape, generator=gen) > 0.5).float().to(dev)
    q, k, v = (binary((g, s, dh)) for _ in range(3))
    labels = []
    for label, qs, ks, vs, causal in [("main path N=M=32", q, k, v, True),
                                      *_lm_ssa_sets(gen, dev)]:
        want = ssa_ref(qs, ks, vs, scale=0.125, causal=causal)
        got = ssa_ops.ssa_fwd(qs, ks, vs, scale=0.125, causal=causal)
        check(torch.equal(got, want), f"K3 {label} causal={causal}: not equal to the plain "
              "version")
        # the packed kernels on the same spikes, as T = 4 planes of one word: q/k/v of
        # G = 4 * B * H folds are the planes of B * H folds
        gw = qs.shape[0] // t if qs.shape[0] % t == 0 else None
        if gw is not None:
            words = [pack(x.reshape(t, gw, x.shape[1], x.shape[2])) for x in (qs, ks, vs)]
            live = ssa_ops._plane_liveness(*words, t)
            got6 = ssa_ops.packed_ssa_fwd(*words, t=t, scale=0.125, causal=causal)
            got9 = ssa_ops.sparse_packed_ssa_fwd(*words, live, t=t, scale=0.125, causal=causal)
            check(torch.equal(got6.reshape(want.shape), want), f"K6 {label} causal={causal}: "
                  "not equal to the plain version")
            check(torch.equal(got9, got6), f"K9 {label} causal={causal}: not equal to K6")
            check(torch.equal(got9, sparse_packed_ssa_ref(*words, live, t=t, scale=0.125,
                                                          causal=causal)),
                  f"K9 {label} causal={causal}: not equal to the plain version")
        else:     # one fold (the 2^24 edge): the same spikes in every plane
            words = [pack(x[None].expand((t,) + tuple(x.shape))) for x in (qs, ks, vs)]
            live = ssa_ops._plane_liveness(*words, t)
            got6 = ssa_ops.packed_ssa_fwd(*words, t=t, scale=0.125, causal=causal)
            got9 = ssa_ops.sparse_packed_ssa_fwd(*words, live, t=t, scale=0.125, causal=causal)
            check(all(torch.equal(got6[i], want) for i in range(t)) and torch.equal(got9, got6),
                  f"K6/K9 {label}: not equal to the plain version")
            check(want.max().item() == (2 ** 24 - dh) * 0.125, f"{label}: largest output "
                  f"{want.max().item()}")
        labels.append(f"{label}{' causal' if causal else ''}")
        del want, got, got6, got9, words, live
    log(f"K3, K6, K9 at Dh={dh}: torch.equal the plain versions (K9 also K6) on "
        + "; ".join(labels))
    past = 2 ** 24 // dh            # one key more: two key ranges (ref.key_range)
    kv = torch.ones((1, past, dh), device=dev)
    words = [pack(x[None]) for x in (kv[:, :3], kv, kv)]
    at_edge = {"K3": (ssa_ops.ssa_fwd(kv[:, :3], kv, kv, scale=0.125),
                      ssa_ref(kv[:, :3], kv, kv, scale=0.125)),
               "K6": (ssa_ops.packed_ssa_fwd(*words, t=1, scale=0.125),
                      packed_ssa_ref(*words, t=1, scale=0.125))}
    for name, (got, want) in at_edge.items():
        check(torch.equal(got, want) and got.max().item() == 2 ** 24 * 0.125,
              f"{name} at M * Dh = 2^24 (Dh={dh}): not equal to the plain version or "
              f"largest output {got.max().item()}")
    log(f"  one key more (M={past}, M*Dh = 2^24, two key ranges): K3 and K6 taken, "
        "torch.equal the plain versions, every output 2^24 * 0.125")
    del kv, words, at_edge

    # -- K3, K6, K9 timed ------------------------------------------------------------------
    def ssa_case(rep, label, count, qs, ks, vs, causal=True):
        n, m = qs.shape[1], ks.shape[1]
        pairs = n * (n + 1) // 2 if causal else n * m
        mask = torch.tril if causal else (lambda x: x)
        plain = lambda: ssa_ref(qs, ks, vs, scale=0.125, causal=causal)
        rep.add(label, count, 0.0, time_ms(lambda: ssa_ops.ssa_fwd(qs, ks, vs, scale=0.125,
                                                                   causal=causal)),
                time_ms(plain, reps=5), 4 * 4 * qs.shape[0] * n * dh,
                4 * qs.shape[0] * pairs * dh,
                library_ms=time_ms(lambda: torch.bmm(mask(torch.bmm(qs, ks.transpose(1, 2))),
                                                     vs) * 0.125),
                library_tc_ms=library_tc_ms(qs, ks, vs, 0.125, plain(), f"K3{suffix} {label}",
                                            causal=causal))

    def packed_case(rep, key, label, count, qs, ks, vs, gated):
        """K6 (K9 where ``gated``) on the words of dense causal spikes (T * gw,
        n, Dh): T = t planes of gw folds, against its plain version, its bound
        (the live planes' causal triangle) and the two library calls on the
        dense operands."""
        gw_, n = qs.shape[0] // t, qs.shape[1]
        words = [pack(x.reshape(t, gw_, n, dh)) for x in (qs, ks, vs)]
        live = ssa_ops._plane_liveness(*words, t)
        if gated:
            run = lambda: ssa_ops.sparse_packed_ssa_fwd(*words, live, t=t, scale=0.125,
                                                        causal=True)
            plain = lambda: sparse_packed_ssa_ref(*words, live, t=t, scale=0.125, causal=True)
            n_live = int((live != 0).sum())
        else:
            run = lambda: ssa_ops.packed_ssa_fwd(*words, t=t, scale=0.125, causal=True)
            plain = lambda: packed_ssa_ref(*words, t=t, scale=0.125, causal=True)
            n_live = gw_ * t
        rep.add(label, count, 0.0, time_ms(run), time_ms(plain, reps=5),
                4 * 3 * gw_ * n * dh + 4 * t * gw_ * n * dh, 4 * n_live * (n * (n + 1) // 2) * dh,
                library_ms=time_ms(lambda: torch.bmm(torch.tril(torch.bmm(
                    qs, ks.transpose(1, 2))), vs) * 0.125),
                library_tc_ms=library_tc_ms(qs, ks, vs, 0.125, plain().reshape(t * gw_, n, dh),
                                            f"{key}{suffix} {label}", causal=True))

    gw = b * LM_HEADS
    packed_keys = (("K6", "packed_ssa", 164, False), ("K9", "sparse_packed_ssa", 139, True))
    rep = KernelReport(f"ssa{suffix}", src.format("spiking_attention", "ssa"),
                       tpu.format("spiking_attention", 62))
    ssa_case(rep, f"G={g} N={s} Dh={dh} causal", layers, q, k, v)
    reports["K3"] = rep
    for key, name, line, gated in packed_keys:
        rep = KernelReport(f"{name}{suffix}", src.format("spiking_attention", "ssa"),
                           tpu.format("spiking_attention", line))
        packed_case(rep, key, f"G={gw} N={s} Dh={dh} T={t} causal", layers, q, k, v, gated)
        reports[key] = rep
    del q, k, v
    # longer prompts in every slot: the same spikes through K3 and, as T = 4 planes of
    # the words, K6 and K9
    longer = {"K3": KernelReport("ssa longer prompts", reports["K3"].entry["source"],
                                 reports["K3"].entry["replaces"])}
    for key, name, _, _ in packed_keys:
        longer[key] = KernelReport(f"{name} longer prompts", reports[key].entry["source"],
                                   reports[key].entry["replaces"])
    for n in (512, 2048):
        qs, ks, vs = (binary((g, n, dh)) for _ in range(3))
        ssa_case(longer["K3"], f"G={g} N={n} Dh={dh} causal (a {n}-token prompt)", 1, qs, ks, vs)
        for key, _, _, gated in packed_keys:
            packed_case(longer[key], key, f"G={gw} N={n} Dh={dh} T={t} causal (a {n}-token "
                        "prompt)", 1, qs, ks, vs, gated)
        del qs, ks, vs

    # -- K1 and K4: the LIF and its pack epilogue ------------------------------------------
    lif_cases = [(b * s * d, False, 1 + 4 * layers), (b * s * d, True, 2 * layers),
                 (b * s * f, False, layers)]
    big = b * s * f
    drive = torch.randn((t, big), generator=gen).to(dev)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8      # membranes exactly on theta too
    skip = (torch.rand((t, big), generator=gen) > 0.5).float().to(dev)
    skip_words = pack(skip)
    for key, name, line, packed in (("K1", "lif_parallel", 144, False),
                                    ("K4", "lif_pack", 174, True)):
        rep = KernelReport(f"{name}{suffix}", src.format("lif_parallel", "lif_parallel"),
                           tpu.format("lif_parallel", line))
        for n, iand, count in lif_cases:
            x = drive[:, :n].contiguous()
            if packed:
                sk = skip_words[:, :n].contiguous() if iand else None
                run = lambda: lif_ops.lif_parallel_pack_fwd(x, chain_len=t, lam=0.25, theta=0.5,
                                                            reset="hard", skip_words=sk)
                plain = lambda: lif_pack_ref(x, chain_len=t, skip_words=sk)
                nbytes = 4 * t * n + 4 * n * (2 if iand else 1)
            else:
                sk = skip[:, :n].contiguous() if iand else None
                run = lambda: lif_ops.lif_parallel_fwd(x, chain_len=t, lam=0.25, theta=0.5,
                                                       reset="hard", skip=sk)
                plain = lambda: tlif.lif_parallel(x, iand_skip=sk)
                nbytes = 4 * t * n * (3 if iand else 2)
            check(torch.equal(run(), plain()), f"{name} N={n} iand={iand}: not equal to "
                  "the plain version")
            rep.add(f"N={n} iand={iand}", count, 0.0, time_ms(run), time_ms(plain), nbytes,
                    5 * t * n, peak=F32_FLOP_PER_S)
        reports[key] = rep
    del drive, skip, skip_words

    # -- K2, K5, K8: the spike GEMMs ----------------------------------------------------
    gemm_cases = [(d, d, 4 * layers), (d, f, layers), (f, d, layers)]
    weights = {(kk, c): (torch.randn((kk, c), generator=gen) * kk ** -0.5).to(dev)
               for kk, c, _ in gemm_cases}

    def gemm_report(key, name, line, rows, regime):
        rep = KernelReport(f"{name}{suffix}{regime}", src.format("spike_matmul", "spike_matmul"),
                           tpu.format("spike_matmul", line))
        for kk, c, count in gemm_cases:
            w = weights[(kk, c)]
            if key == "K2":
                x = (torch.rand((rows, kk), generator=gen) > 0.5).float().to(dev)
                run = lambda: mm_ops.spike_matmul_fwd(x, w)
                plain = lambda: mm_ops.spike_matmul_ref(x, w)
                unpacked, nbytes = x, 4 * (rows * kk + kk * c + rows * c)
                flops = GEMM_PIECES * 2 * rows * kk * c
            else:
                xw = pack((torch.rand((t, rows, kk), generator=gen) > 0.5).float().to(dev))[0]
                unpacked = packing.unpack(packing.PackedSpikes(xw[None], t)).reshape(-1, kk)
                nbytes = 4 * (rows * kk + kk * c + t * rows * c)
                flops = GEMM_PIECES * 2 * t * rows * kk * c
                if key == "K5":
                    run = lambda: mm_ops.packed_spike_matmul_fwd(xw, w, t=t)
                    plain = lambda: packed_spike_matmul_ref(xw, w, t=t)
                else:
                    tiles = mm_ops._occ_to_grid_tiles(None, xw)
                    run = lambda: mm_ops.sparse_packed_spike_matmul_fwd(xw, w, tiles, t=t)
                    plain = lambda: sparse_packed_spike_matmul_ref(xw, w, tiles, t=t)
            got, want = run(), plain()
            err = (got - want).abs().max().item()
            check(bool(torch.allclose(got, want, **GEMM_TOL)),
                  f"{name} {rows}x{kk}x{c}: max abs err {err:.3g} outside {GEMM_TOL}")
            if key != "K2":
                check(torch.equal(got.reshape(-1, c), mm_ops.spike_matmul_fwd(unpacked, w)),
                      f"{name} {rows}x{kk}x{c}: not equal to K2 on the unpacked operand")
            rep.add(f"{rows}x{kk}x{c}", count, err, time_ms(run), time_ms(plain),
                    nbytes, flops, library_ms=time_ms(lambda: torch.matmul(unpacked, w)),
                    library_tc_ms=matmul_tf32_ms(unpacked, w))
            del got, want
        return rep

    reports["K2"] = gemm_report("K2", "spike_matmul", 164, t * b * s, "")
    reports["K2 decode"] = gemm_report("K2", "spike_matmul", 164, t * b, " decode")
    reports["K5"] = gemm_report("K5", "packed_spike_matmul", 136, b * s, "")
    reports["K8"] = gemm_report("K8", "sparse_packed_spike_matmul", 101, b * s, "")
    step = reports["K2 decode"].entry
    head_bytes = 4 * LM_D * LM_VOCAB
    head_ms = bound_ms(head_bytes, 2 * b * LM_D * LM_VOCAB, F32_FLOP_PER_S)[0]
    weight_bytes = 4 * sum(kk * c * n for kk, c, n in gemm_cases)
    log(f"K2 per decode step ({t * b} rows, {6 * layers} launches): {step['ms']:.3f} ms against "
        f"a {step['bound_ms']:.3f} ms bound ({step['bound_by']}: {weight_bytes / 1e9:.2f} GB of "
        f"f32 weights); the head's f32 GEMM (torch.matmul, {head_bytes / 1e9:.2f} GB) adds a "
        f"{head_ms:.3f} ms bound")
    return reports


def _admission_kernels(dev, gen):
    """The LIF and GEMM kernels at the shapes phase 7 adds (K3, K6 and K9 are
    in :func:`_lm_ssa_sets`): batch-1 admissions and chunk buckets
    (:func:`_admission_lens` tokens) and the packed GEMMs of the LM_SLOTS-slot
    step.  K1/K4 (with the occupancy map) at those token counts ``torch.equal``
    their plain versions; K2 at T*N rows and K5/K8 at N rows within GEMM_TOL of
    theirs, K5 and K8 (some tiles dead, the ragged last row group among them)
    ``torch.equal`` K2 on the unpacked operand, and each kernel's first rows
    ``torch.equal`` the same rows at the largest row count (paging relies on
    rows being independent)."""
    from repro_torch.core import lif as tlif
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.lif_parallel.ref import lif_pack_ref
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spike_matmul.ref import (
        packed_spike_matmul_ref, sparse_packed_spike_matmul_ref)

    t = 4
    rows = sorted(set(_admission_lens()) | {LM_SLOTS})
    binary = lambda shape: (torch.rand(shape, generator=gen) > 0.5).float().to(dev)
    pack = lambda x: packing.pack(x).words

    # -- K1 and K4 (with its occupancy map) at the token counts of one sequence --------
    for n in rows:
        for width, iand in ((LM_D, False), (LM_D, True), (LM_FF, False)):
            drive = torch.randn((t, n * width), generator=gen).to(dev)
            drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8
            skip = binary((t, n * width)) if iand else None
            got = lif_ops.lif_parallel_fwd(drive, chain_len=t, lam=0.25, theta=0.5,
                                           reset="hard", skip=skip)
            check(torch.equal(got, tlif.lif_parallel(drive, iand_skip=skip)),
                  f"K1 {n}x{width} iand={iand}: not equal to the plain version")
            sk = pack(skip) if iand else None
            words, occ = lif_ops.lif_parallel_pack_fwd(drive, chain_len=t, lam=0.25, theta=0.5,
                                                       reset="hard", skip_words=sk,
                                                       occ_cols=width)
            ref = lif_pack_ref(drive, chain_len=t, skip_words=sk)
            check(torch.equal(words, ref) and torch.equal(
                occ, packing.occupancy_map(ref.reshape(1, n, width))),
                f"K4 {n}x{width} iand={iand}: words or occupancy map not equal to the plain "
                "version")
    log(f"  K1, K4 (+ occupancy map) at {rows} tokens of width {LM_D} (iand off/on) and "
        f"{LM_FF}: torch.equal the plain versions")

    # -- K2, K5, K8 at few, ragged rows --------------------------------------------------
    top = max(rows)
    errs = []
    for kk, c in ((LM_D, LM_D), (LM_D, LM_FF), (LM_FF, LM_D)):
        w = (torch.randn((kk, c), generator=gen) * kk ** -0.5).to(dev)
        spikes = binary((t, top, kk))
        spikes[:, :, 128:384] = 0.0                  # dead feature tiles in every row group
        spikes[:, 64:, :1024] = 0.0                  # and in the ragged last group
        full2 = mm_ops.spike_matmul_fwd(spikes.reshape(-1, kk), w)
        xw_all = pack(spikes)[0]
        full5 = mm_ops.packed_spike_matmul_fwd(xw_all, w, t=t)
        for m in rows:
            x = spikes[:, :m].reshape(t * m, kk)
            got2 = mm_ops.spike_matmul_fwd(x, w)
            want2 = mm_ops.spike_matmul_ref(x, w)
            errs.append((got2 - want2).abs().max().item())
            check(bool(torch.allclose(got2, want2, **GEMM_TOL)),
                  f"K2 {t * m}x{kk}x{c}: max abs err {errs[-1]:.3g} outside {GEMM_TOL}")
            xw = xw_all[:m].contiguous()
            tiles = mm_ops._occ_to_grid_tiles(
                packing.occupancy_map(xw.reshape(1, m, kk))[0], xw)
            got5 = mm_ops.packed_spike_matmul_fwd(xw, w, t=t)
            got8 = mm_ops.sparse_packed_spike_matmul_fwd(xw, w, tiles, t=t)
            check(bool(torch.allclose(got5, packed_spike_matmul_ref(xw, w, t=t), **GEMM_TOL))
                  and bool(torch.allclose(got8, sparse_packed_spike_matmul_ref(
                      xw, w, tiles, t=t), **GEMM_TOL)),
                  f"K5/K8 {m}x{kk}x{c}: outside {GEMM_TOL} of the plain versions")
            check(torch.equal(got5.reshape(-1, c), got2) and torch.equal(got8, got5),
                  f"K5/K8 {m}x{kk}x{c}: not equal to K2 on the unpacked operand")
            check(torch.equal(full2.reshape(t, top, c)[:, :m], got2.reshape(t, m, c))
                  and torch.equal(full5[:, :m], got5),
                  f"K2/K5 {m} rows x{kk}x{c}: rows differ from the same rows at {top}")
        dead = int((tiles == 0).sum()), tiles.numel()
        del w, spikes, full2, xw_all, full5
    log(f"  K2 at {[t * m for m in rows]} rows, K5/K8 at {rows} rows x {LM_D}/{LM_FF} (K8 "
        f"gated, {dead[0]} of {dead[1]} tiles dead at {top} rows): within {GEMM_TOL} of the "
        f"plain versions (max abs err {max(errs):.3g}), K5 == K8 == K2 on the unpacked "
        f"operand, and each row torch.equal the same row at {top} rows")


def _lif_backward(dev, gen):
    """K7 against its plain version (eager autograd of the plain chain) at
    the six LIF shapes of the 8-384 training batch (B=16, T=4), chain_len
    1/2/4 and both resets, ``torch.equal``; timed at chain_len T, hard
    reset, weighted by the launches of one training step."""
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.lif_parallel.ref import lif_parallel_ref_grad

    t, b, ntok, d, hid = 4, TRAIN_BATCH, 196, 384, 1536
    rep = KernelReport("lif_parallel_bwd",
                       "src/repro_torch/kernels/lif_parallel/csrc/lif_parallel.cu",
                       "src/repro/kernels/lif_parallel/kernel.py:211")
    shapes = [("tok0", b * 112 * 112 * 48, 1), ("tok1", b * 56 * 56 * 96, 1),
              ("tok2", b * 28 * 28 * 192, 1), ("tok3", b * ntok * d, 1),
              ("block q/k/v/attn/proj/fc2", b * ntok * d, 6 * 8),
              ("block fc1", b * ntok * hid, 8)]
    big = max(n for _, n, _ in shapes)
    drive = torch.randn((t, big), generator=gen).to(dev)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8   # membranes on theta and the boxcar edges
    cot = torch.randn((t, big), generator=gen).to(dev)
    for label, n, count in shapes:
        x, g = drive[:, :n].contiguous(), cot[:, :n].contiguous()
        for reset in ("hard", "soft"):
            for chain in (1, 2, 4):
                got = lif_ops.lif_parallel_bwd(x, g, chain_len=chain, lam=0.25, theta=0.5,
                                               reset=reset)
                want = lif_parallel_ref_grad(x, g, chain_len=chain, reset=reset)
                if not torch.equal(got, want):
                    bad = (got != want).nonzero()
                    ti, ni = bad[0].tolist()
                    fail(f"K7 {label} N={n} reset={reset} chain_len={chain}: {len(bad)} of "
                         f"{got.numel()} differ, max abs {(got - want).abs().max().item():.3g}; "
                         f"first at t={ti}, n={ni}: kernel {got[ti, ni].item()!r} plain "
                         f"{want[ti, ni].item()!r}, drive {x[:, ni].tolist()}, g "
                         f"{g[:, ni].tolist()}")
                del got, want
        run = lambda: lif_ops.lif_parallel_bwd(x, g, chain_len=t, lam=0.25, theta=0.5,
                                               reset="hard")
        plain = lambda: lif_parallel_ref_grad(x, g, chain_len=t)
        rep.add(f"{label} N={n}", count, 0.0, time_ms(run), time_ms(plain, reps=5),
                12 * t * n, 20 * t * n, peak=F32_FLOP_PER_S)
    log(f"K7 lif_parallel_bwd: torch.equal its plain version at {len(shapes)} shapes x "
        f"reset x chain_len 1/2/4; per training step (B={b}) kernel "
        f"{rep.entry['ms']:.3f} ms, plain {rep.entry['plain_ms']:.3f} ms, bound "
        f"{rep.entry['bound_ms']:.3f} ms")
    del drive, cot
    return rep


def _packed_kernels(dev, gen):
    """K4-K6 at the packed path's shapes (8-384, slot batch 8, T=4: one word
    per neuron)."""
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.lif_parallel.ref import lif_pack_ref
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spike_matmul.ref import packed_spike_matmul_ref
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import packed_ssa_ref

    t, b, ntok, d, hid, heads = 4, SLOTS, 196, 384, 1536, 12
    words = lambda shape: packing.pack(
        (torch.rand((t,) + shape, generator=gen) > 0.5).float()).words.to(dev)
    unpack = lambda w: packing.unpack(packing.PackedSpikes(w, t))
    reports = {}

    # -- K4: LIF with the pack epilogue (+IAND) ----------------------------
    rep = KernelReport("lif_pack", "src/repro_torch/kernels/lif_parallel/csrc/lif_parallel.cu",
                       "src/repro/kernels/lif_parallel/kernel.py:174")
    big = b * 112 * 112 * 48
    drive = torch.randn((t, big), generator=gen).to(dev)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8      # membranes exactly on theta too
    skip = words((big,))
    for iand in (False, True):
        for reset in ("hard", "soft"):
            for chain in (1, 2, 4):
                sk = skip if iand else None
                got = lif_ops.lif_parallel_pack_fwd(drive, chain_len=chain, lam=0.25,
                                                    theta=0.5, reset=reset, skip_words=sk)
                want = lif_pack_ref(drive, chain_len=chain, reset=reset, skip_words=sk)
                if not torch.equal(got, want):
                    fail(f"lif_pack iand={iand} reset={reset} chain_len={chain}: "
                         f"{(got != want).sum().item()} word mismatches")
    log(f"K4 lif_pack: torch.equal at N={big} for iand x reset x chain_len 1/2/4")
    cases = [(b * 112 * 112 * 48, False, 1), (b * 56 * 56 * 96, False, 1 + 8),
             (b * 28 * 28 * 192, False, 1), (b * ntok * d, False, 1 + 4 * 8),
             (b * ntok * d, True, 2 * 8)]
    for n, iand, count in cases:
        x, sk = drive[:, :n].contiguous(), (skip[:, :n].contiguous() if iand else None)
        run = lambda: lif_ops.lif_parallel_pack_fwd(x, chain_len=t, lam=0.25, theta=0.5,
                                                    reset="hard", skip_words=sk)
        plain = lambda: lif_pack_ref(x, chain_len=t, skip_words=sk)
        if not torch.equal(run(), plain()):
            fail(f"lif_pack N={n} iand={iand}: not equal to the plain version")
        nbytes = 4 * t * n + 4 * n * (2 if iand else 1)
        rep.add(f"N={n} iand={iand}", count, 0.0, time_ms(run), time_ms(plain), nbytes,
                5 * t * n, peak=F32_FLOP_PER_S)
    reports["K4"] = rep
    del drive, skip

    # -- K5: packed spike GEMM --------------------------------------------
    rep = KernelReport("packed_spike_matmul",
                       "src/repro_torch/kernels/spike_matmul/csrc/spike_matmul.cu",
                       "src/repro/kernels/spike_matmul/kernel.py:136")
    m_blk = b * ntok
    cases = [(b * 112 * 112, 9 * 48, 96, 1), (b * 56 * 56, 9 * 96, 192, 1),
             (b * 28 * 28, 9 * 192, 384, 1), (m_blk, d, d, 4 * 8),
             (m_blk, d, hid, 8), (m_blk, hid, d, 8)]
    for m, k, c, count in cases:
        xw = words((m, k))[0]
        w = ((torch.rand((k, c), generator=gen) * 2 - 1) / k ** 0.5).to(dev)
        run = lambda: mm_ops.packed_spike_matmul_fwd(xw, w, t=t)
        plain = lambda: packed_spike_matmul_ref(xw, w, t=t)
        got, want = run(), plain()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **GEMM_TOL):
            fail(f"packed_spike_matmul {m}x{k}x{c}: max abs err {err:.3g} outside {GEMM_TOL}")
        dense = unpack(xw[None]).reshape(t * m, k)
        same_as_k2 = torch.equal(got.reshape(t * m, c), mm_ops.spike_matmul_fwd(dense, w))
        log(f"  packed_spike_matmul {m}x{k}x{c} T={t}: max abs err {err:.3g} "
            f"(tolerance {GEMM_TOL}); equal to K2 on the unpacked operand: {same_as_k2}")
        if not same_as_k2:
            fail(f"packed_spike_matmul {m}x{k}x{c}: differs from K2 on the unpacked operand")
        rep.add(f"{m}x{k}x{c}", count, err, time_ms(run), time_ms(plain),
                4 * (m * k + k * c + t * m * c), GEMM_PIECES * 2 * t * m * k * c,
                library_ms=time_ms(lambda: torch.matmul(dense, w)),
                library_tc_ms=matmul_tf32_ms(dense, w))
        del xw, w, got, want, dense
    log("  K5 library_ms is torch.matmul on the unpacked (T*M, K) f32 operand, "
        "library_tc_ms the same with TF32 allowed")
    reports["K5"] = rep

    # -- K6: packed SSA ----------------------------------------------------
    rep = KernelReport("packed_ssa", "src/repro_torch/kernels/spiking_attention/csrc/ssa.cu",
                       "src/repro/kernels/spiking_attention/kernel.py:164")
    g, dh = b * heads, d // heads
    qw, kw, vw = (words((g, ntok, dh)) for _ in range(3))
    for causal in (False, True):
        got = ssa_ops.packed_ssa_fwd(qw, kw, vw, t=t, scale=0.125, causal=causal)
        if not torch.equal(got, packed_ssa_ref(qw, kw, vw, t=t, scale=0.125, causal=causal)):
            fail(f"packed_ssa causal={causal}: not equal to the plain version")
    for steps in (33, 40):     # two words per spike: every group of planes of both words
        qs, ks, vs = (packing.pack((torch.rand((steps, g, 64, dh), generator=gen) > 0.5)
                                   .float()).words.to(dev) for _ in range(3))
        for causal in (False, True):
            if not torch.equal(ssa_ops.packed_ssa_fwd(qs, ks, vs, t=steps, scale=0.125,
                                                      causal=causal),
                               packed_ssa_ref(qs, ks, vs, t=steps, scale=0.125, causal=causal)):
                fail(f"packed_ssa T={steps} causal={causal}: not equal to the plain version")
    log(f"K6 packed_ssa: torch.equal at G={g}, N={ntok}, Dh={dh}, T={t}, and at N=64 with "
        "T=33 and 40 (two words), causal and not")
    run = lambda: ssa_ops.packed_ssa_fwd(qw, kw, vw, t=t, scale=0.125)
    plain = lambda: packed_ssa_ref(qw, kw, vw, t=t, scale=0.125)
    q, k, v = (unpack(x).reshape(t * g, ntok, dh) for x in (qw, kw, vw))
    library = lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v) * 0.125
    rep.add(f"G={g} N={ntok} Dh={dh} T={t}", 8, 0.0, time_ms(run), time_ms(plain),
            4 * 3 * g * ntok * dh + 4 * t * g * ntok * dh, 4 * t * g * ntok * ntok * dh,
            library_ms=time_ms(library), peak=TC_FLOP_PER_S,
            library_tc_ms=library_tc_ms(q, k, v, 0.125, plain().reshape(t * g, ntok, dh),
                                        "K6"))
    log("  K6 library_ms is two torch.bmm on the unpacked f32 operands, library_tc_ms "
        "two f16 torch.bmm with f32 output on them")
    reports["K6"] = rep
    reports.update(_sparse_kernels(dev, gen))
    _gemm_exactness(dev, gen)
    return reports


def _one_hot_ulps(dev, k, c, w, t=4):
    """Largest error of K2, K5 and K8 on one-hot rows, in units in the last
    place of the weight each row selects: plane p's row r selects w's row
    (r + 7p) % k, so every weight is read once per plane."""
    from repro_torch.core import packing
    from repro_torch.kernels.spike_matmul import ops as mm_ops

    idx = ((torch.arange(k)[None] + 7 * torch.arange(t)[:, None]) % k).to(dev)
    planes = torch.nn.functional.one_hot(idx, k).float()
    xw = packing.pack(planes).words[0]
    want = w[idx]
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"), device=dev)) - want.abs()
    ulps = lambda got: ((got.reshape(want.shape) - want).abs() / ulp).max().item()
    tiles = mm_ops._occ_to_grid_tiles(None, xw)
    return {"K2": ulps(mm_ops.spike_matmul_fwd(planes.reshape(t * k, k), w)),
            "K5": ulps(mm_ops.packed_spike_matmul_fwd(xw, w, t=t)),
            "K8": ulps(mm_ops.sparse_packed_spike_matmul_fwd(xw, w, tiles, t=t))}


def _gemm_exactness(dev, gen):
    """What GEMM_TOL cannot see.  At each main-path (K, C): K2, K5 and K8 on
    one-hot rows give the selected weights within ONE_HOT_ULPS (every piece
    counts); K2 on integer operands up to ADD_STREAM_MAX within GEMM_TOL (the
    residual='add' configs).  Then the two control builds of the GEMM library:
    the hi+mid one must fail the one-hot check, the hi-only one it and
    GEMM_TOL; their readings are logged beside the sound ones."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.spike_matmul import ops as mm_ops

    shapes = [(9 * 48, 96), (9 * 96, 192), (9 * 192, 384), (384, 384), (384, 1536),
              (1536, 384)]
    operands = []
    for k, c in shapes:
        w = ((torch.rand((k, c), generator=gen) * 2 - 1) / k ** 0.5).to(dev)
        x = (torch.rand((4096, k), generator=gen) > 0.5).float().to(dev)
        counts = torch.randint(0, ADD_STREAM_MAX + 1, (4096, k), generator=gen).float().to(dev)
        operands.append((k, c, w, x, counts))

    def reading():
        out = {}
        for k, c, w, x, counts in operands:
            want = mm_ops.spike_matmul_ref(x, w)
            got = mm_ops.spike_matmul_fwd(x, w)
            want_n = mm_ops.spike_matmul_ref(counts, w)
            got_n = mm_ops.spike_matmul_fwd(counts, w)
            out[(k, c)] = {"one_hot_ulps": _one_hot_ulps(dev, k, c, w),
                           "err": (got - want).abs().max().item(),
                           "in_tol": bool(torch.allclose(got, want, **GEMM_TOL)),
                           "counts_err": (got_n - want_n).abs().max().item(),
                           "counts_in_tol": bool(torch.allclose(got_n, want_n, **GEMM_TOL))}
        return out

    def show(label, r):
        for (k, c), v in r.items():
            log(f"  {label} K={k} C={c}: one-hot rows off by at most "
                + ", ".join(f"{key} {u:.3g}" for key, u in v["one_hot_ulps"].items())
                + f" ulp; 4096 random spike rows max abs err {v['err']:.3g} (within "
                f"GEMM_TOL: {v['in_tol']}); counts 0..{ADD_STREAM_MAX} max abs err "
                f"{v['counts_err']:.3g} (within GEMM_TOL: {v['counts_in_tol']})")

    sound = reading()
    show("GEMM", sound)
    for (k, c), v in sound.items():
        worst = max(v["one_hot_ulps"].values())
        if worst > ONE_HOT_ULPS:
            fail(f"GEMM K={k} C={c}: one-hot rows off by {worst:.3g} ulp > {ONE_HOT_ULPS}")
        if not (v["in_tol"] and v["counts_in_tol"]):
            fail(f"GEMM K={k} C={c}: outside {GEMM_TOL} on spikes or counts")
    log(f"K2, K5, K8: one-hot rows within {ONE_HOT_ULPS} ulp of the weights at the six "
        f"main-path (K, C); K2 within GEMM_TOL on counts 0..{ADD_STREAM_MAX}")
    for control in _build.CONTROLS:
        with _build.substitute("spike_matmul", control):
            r = reading()
        show(f"control {control}", r)
        caught = [max(v["one_hot_ulps"].values()) > ONE_HOT_ULPS for v in r.values()]
        check(all(caught), f"{control}: the one-hot check misses it at "
              f"{[kc for kc, hit in zip(r, caught) if not hit]}")
        if control == E2E_CONTROL:
            check(not any(v["in_tol"] for v in r.values()),
                  f"{control}: GEMM_TOL does not catch it at every shape")


def _sparse_kernels(dev, gen):
    """K4's occupancy epilogue, K8 and K9 at the sparse path's shapes (8-384,
    slot batch 8, T=4), each gated kernel on three operand sets: 50%-random
    words (nothing dead: the gating's overhead), half the tiles or planes
    dead, and all zero.  K8/K9 and their plain versions are timed here per
    set; the JSON line takes their numbers from the live model (phase 3)."""
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spike_matmul.ref import sparse_packed_spike_matmul_ref
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import sparse_packed_ssa_ref

    t, b, ntok, d, hid, heads = 4, SLOTS, 196, 384, 1536, 12
    words = lambda shape: packing.pack(
        (torch.rand((t,) + shape, generator=gen) > 0.5).float()).words.to(dev)
    reports = {}

    # -- K4's occupancy epilogue ----------------------------------------------
    drive = torch.randn((t, b * 112 * 112 * 48), generator=gen).to(dev)
    skip = words((b * ntok * d,))[0][None]
    with_occ = without = 0.0
    for rows, cols, iand, count in [(b * 112 * 112, 48, False, 1), (b * 56 * 56, 96, False, 1),
                                    (b * 28 * 28, 192, False, 1), (b * ntok, d, False, 1 + 4 * 8),
                                    (b * ntok, hid, False, 8), (b * ntok, d, True, 2 * 8)]:
        x = drive[:, :rows * cols].reshape(t, rows, cols).clone()
        x[:, ::3] -= 9.0                            # every third row silent: zero tiles too
        x = x.reshape(t, rows * cols)
        sk = skip if iand else None
        kw = dict(chain_len=t, lam=0.25, theta=0.5, reset="hard", skip_words=sk)
        got, occ = lif_ops.lif_parallel_pack_fwd(x, occ_cols=cols, **kw)
        if not torch.equal(got, lif_ops.lif_parallel_pack_fwd(x, **kw)):
            fail(f"lif_pack occupancy epilogue {rows}x{cols}: words differ")
        if not torch.equal(occ, packing.occupancy_map(got.reshape(1, rows, cols))):
            fail(f"lif_pack occupancy epilogue {rows}x{cols}: map differs from occupancy_map")
        ms_occ = time_ms(lambda: lif_ops.lif_parallel_pack_fwd(x, occ_cols=cols, **kw))
        ms = time_ms(lambda: lif_ops.lif_parallel_pack_fwd(x, **kw))
        with_occ, without = with_occ + count * ms_occ, without + count * ms
        log(f"  lif_pack {rows}x{cols} iand={iand} x{count}/forward: map torch.equal "
            f"occupancy_map ({int((occ == 0).sum())} of {occ.numel()} tiles zero); "
            f"{ms_occ:.4f} ms with the occupancy epilogue, {ms:.4f} ms without")
    log(f"K4 occupancy epilogue: {with_occ:.3f} ms per forward with it, {without:.3f} ms "
        "without")
    del drive, skip

    # -- K8: occupancy-gated packed GEMM ---------------------------------------
    rep = KernelReport("sparse_packed_spike_matmul",
                       "src/repro_torch/kernels/spike_matmul/csrc/spike_matmul.cu",
                       "src/repro/kernels/spike_matmul/kernel.py:101")
    for m, k, c, count in [(b * 112 * 112, 9 * 48, 96, 1), (b * 56 * 56, 9 * 96, 192, 1),
                           (b * 28 * 28, 9 * 192, 384, 1), (b * ntok, d, d, 4 * 8),
                           (b * ntok, d, hid, 8), (b * ntok, hid, d, 8)]:
        xw = words((m, k))[0]
        w = ((torch.rand((k, c), generator=gen) * 2 - 1) / k ** 0.5).to(dev)
        mt, kt = mm_ops.grid_tiles_shape(m, k)
        checker = ((torch.arange(mt, device=dev)[:, None] + torch.arange(kt, device=dev))
                   % 2).bool()                                  # every second tile dead
        dead = checker.repeat_interleave(64, 0)[:m].repeat_interleave(128, 1)[:, :k]
        packed_ms = time_ms(lambda: mm_ops.packed_spike_matmul_fwd(xw, w, t=t))
        line = []
        for label, x in (("random", xw), ("half-dead", torch.where(dead, 0, xw)),
                         ("zero", torch.zeros_like(xw))):
            occ = packing.occupancy_map(x)
            tiles = mm_ops._occ_to_grid_tiles(occ, x)
            if not torch.equal(tiles, mm_ops._occ_to_grid_tiles(None, x)):
                fail(f"K8 {m}x{k}x{c} {label}: tile counts from the map and from the "
                     "words differ")
            got = mm_ops.sparse_packed_spike_matmul_fwd(x, w, tiles, t=t)
            want = mm_ops.packed_spike_matmul_fwd(x, w, t=t)
            if not torch.equal(got, want):
                fail(f"K8 {m}x{k}x{c} {label}: not equal to K5")
            plain = sparse_packed_spike_matmul_ref(x, w, tiles, t=t)
            err = (got - plain).abs().max().item()
            if not torch.allclose(got, plain, **GEMM_TOL):
                fail(f"K8 {m}x{k}x{c} {label}: max abs err {err:.3g} vs plain outside "
                     f"{GEMM_TOL}")
            rep.entry["max_abs_err"] = max(rep.entry["max_abs_err"], err)
            ms = time_ms(lambda: mm_ops.sparse_packed_spike_matmul_fwd(x, w, tiles, t=t))
            plain_ms = time_ms(lambda: sparse_packed_spike_matmul_ref(x, w, tiles, t=t),
                               reps=5)
            line.append(f"{label} ({(tiles == 0).float().mean().item():.0%} tiles dead) "
                        f"{ms:.4f} ms, plain {plain_ms:.4f}, err {err:.3g}")
        log(f"  K8 {m}x{k}x{c} x{count}/forward, torch.equal K5 on every set; K5 "
            f"{packed_ms:.4f} ms; " + "; ".join(line))
        del xw, w, dead
    reports["K8"] = rep

    # -- K9: plane-gated packed SSA --------------------------------------------
    rep = KernelReport("sparse_packed_ssa", "src/repro_torch/kernels/spiking_attention/csrc/ssa.cu",
                       "src/repro/kernels/spiking_attention/kernel.py:139")
    g, dh = b * heads, d // heads
    qw, kw, vw = (words((g, ntok, dh)) for _ in range(3))
    half = qw.clone()
    half[0, 1::2] &= ~(1 << 2)                    # plane 2 of every second fold dead
    packed_ms = time_ms(lambda: ssa_ops.packed_ssa_fwd(qw, kw, vw, t=t, scale=0.125))
    line = []
    for label, q in (("random", qw), ("half-plane-2-dead", half), ("zero", torch.zeros_like(qw))):
        live = ssa_ops._plane_liveness(q, kw, vw, t)
        for causal in (False, True):
            got = ssa_ops.sparse_packed_ssa_fwd(q, kw, vw, live, t=t, scale=0.125, causal=causal)
            if not torch.equal(got, ssa_ops.packed_ssa_fwd(q, kw, vw, t=t, scale=0.125,
                                                           causal=causal)):
                fail(f"K9 {label} causal={causal}: not equal to K6")
            if not torch.equal(got, sparse_packed_ssa_ref(q, kw, vw, live, t=t, scale=0.125,
                                                          causal=causal)):
                fail(f"K9 {label} causal={causal}: not equal to the plain version")
        ms = time_ms(lambda: ssa_ops.sparse_packed_ssa_fwd(q, kw, vw, live, t=t, scale=0.125))
        plain_ms = time_ms(lambda: sparse_packed_ssa_ref(q, kw, vw, live, t=t, scale=0.125),
                           reps=5)
        line.append(f"{label} ({1 - live.float().mean().item():.1%} planes dead) "
                    f"{ms:.4f} ms, plain {plain_ms:.4f}")
    log(f"  K9 G={g} N={ntok} Dh={dh} T={t} x8/forward, torch.equal K6 and the plain "
        f"version on every set, causal and not; K6 {packed_ms:.4f} ms; " + "; ".join(line))
    ones = packing.pack(torch.ones((t, g, ntok, 128))).words.to(dev)
    worst = [("all-ones Dh=128", ones, ones, ones)]
    for n, m in ((ntok, 131), (131, ntok)):
        worst.append((f"ragged Dh=20 N={n} M={m}", words((g, n, 20)), words((g, m, 20)),
                      words((g, m, 20))))
    for label, q, k, v in worst:
        live = ssa_ops._plane_liveness(q, k, v, t)
        for causal in (False, True):
            got = ssa_ops.sparse_packed_ssa_fwd(q, k, v, live, t=t, scale=0.125, causal=causal)
            if not torch.equal(got, ssa_ops.packed_ssa_fwd(q, k, v, t=t, scale=0.125,
                                                           causal=causal)):
                fail(f"K9 {label} causal={causal}: not equal to K6")
            if not torch.equal(got, sparse_packed_ssa_ref(q, k, v, live, t=t, scale=0.125,
                                                          causal=causal)):
                fail(f"K9 {label} causal={causal}: not equal to the plain version")
    log(f"  K9 torch.equal K6 and the plain version on {', '.join(x[0] for x in worst)}, "
        "causal and not")
    del worst, ones
    reports["K9"] = rep
    return reports


def _counters():
    from repro_torch.kernels.lif_parallel.ops import (
        lif_parallel_bwd, lif_parallel_fwd, lif_parallel_pack_fwd)
    from repro_torch.kernels.spike_matmul.ops import (
        packed_spike_matmul_fwd, sparse_packed_spike_matmul_fwd, spike_matmul_fwd)
    from repro_torch.kernels.spiking_attention.ops import (
        packed_ssa_fwd, sparse_packed_ssa_fwd, ssa_fwd)

    return {"K1": lif_parallel_fwd, "K2": spike_matmul_fwd, "K3": ssa_fwd,
            "K4": lif_parallel_pack_fwd, "K5": packed_spike_matmul_fwd, "K6": packed_ssa_fwd,
            "K7": lif_parallel_bwd, "K8": sparse_packed_spike_matmul_fwd,
            "K9": sparse_packed_ssa_fwd}


def _per_forward(num_layers, backend):
    """Launches per forward of each kernel on a kernel route: a LIF per
    tokenizer stage and 7 per block, a GEMM per spike conv stage and 6 per
    block, an SSA per block; the other routes' kernels never launch."""
    counts = (4 + 7 * num_layers, 3 + 6 * num_layers, num_layers)
    want = dict.fromkeys(_counters(), 0)
    want.update(zip(PATHS[backend], counts))
    return want


def _run_counted(label, backend, num_layers, run):
    """``run()`` on a kernel route with every launch counter set to 0 just
    before and read just after; fails unless each kernel of the route
    launched exactly its count per forward and no other kernel did."""
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    served = run()
    launches = {k: f.launches for k, f in counters.items()}
    want = _per_forward(num_layers, backend)
    for key, n in launches.items():
        if n != served["forwards"] * want[key] or (want[key] and n == 0):
            fail(f"{label} {backend}: {key} launched {n} times in {served['forwards']} "
                 f"forwards, expected {want[key]} per forward")
    log(f"{label} backend={backend}: {served['forwards']} forwards (warm-up included), "
        f"launches {launches} = {want} per forward")
    return served, launches


def _check_logits(label, got, want, atol=LOGITS_ATOL):
    """Logits within ``atol`` (``atol=None``: reported only, for a kernel
    plan against a plain plan on a model whose blocks fire, where a spike
    flipped by a reordered f32 sum changes every later layer's input)."""
    check(all(bool(torch.isfinite(x).all()) for x in (got, want)), f"{label}: non-finite logits")
    diff = (got - want).abs().max().item()
    agree = sum(int(a == b) for a, b in zip(got.argmax(-1), want.argmax(-1)))
    limit = f"atol {atol}" if atol is not None else "reported, not limited"
    log(f"logits {label}: max abs diff {diff:.3g} ({limit}), argmax agrees on "
        f"{agree}/{got.shape[0]}")
    if atol is not None:
        check(diff <= atol, f"{label}: logits differ by {diff:.3g} > {atol}")
    return diff


def _e2e_controls(label, logits_fn, want, rows_fn):
    """The end-to-end spike limit against the control builds of the GEMM
    library: on each, ``rows_fn(limit=None)``'s end-to-end spike mismatches
    and ``logits_fn()``'s logits against ``want`` are read.  The hi-only
    build (E2E_CONTROL) must exceed E2E_SPIKE_SHARE; the other readings are
    logged."""
    from repro_torch.kernels import _build

    for control in _build.CONTROLS:
        with _build.substitute("spike_matmul", control), torch.inference_mode():
            got = logits_fn()
            share = rows_fn(f"{label}, GEMM control build {control}", limit=None)
        diff = (got - want).abs().max().item()
        agree = sum(int(a == b) for a, b in zip(got.argmax(-1), want.argmax(-1)))
        log(f"logits {label}, GEMM control build {control}: max abs diff {diff:.3g}, argmax "
            f"agrees on {agree}/{got.shape[0]}")
        if control == E2E_CONTROL:
            check(share > E2E_SPIKE_SHARE, f"{label}: the {control} control reads only "
                  f"{share:.3g} of a layer's spikes <= {E2E_SPIKE_SHARE}: the limit would "
                  "not catch it")


def _check_equal(label, got, want):
    same = torch.equal(got, want)
    log(f"logits {label}: torch.equal {same}" + ("" if same else
        f" (max abs diff {(got - want).abs().max().item():.3g})"))
    check(same, f"{label}: logits not equal")


def _serve_line(label, r, cfg, smi):
    log(f"serve {ARCH} backend={label}: {r['img_per_s']:.2f} img/s, "
        f"{1e3 * r['seconds'] * SLOTS / REQUESTS:.3f} ms per slot batch of {SLOTS} "
        f"({REQUESTS} images, {cfg.img_size}x{cfg.img_size}) on {smi}")


def _mismatch_rows(label, plans, batch, end_to_end=False, limit=MISMATCH_SHARE):
    """Spike mismatches per layer on one slot batch, every layer of the kernel
    plan fed the plain plan's input, or with ``end_to_end`` its own (packed:
    the set bits of ``x ^ y``, and the words that differ); checked against
    ``limit`` (None: reported) and returns the largest share of a layer."""
    from repro_torch.core import packing
    from repro_torch.engine import execute

    ref, plan = plans
    packed = plan.backend.packed
    tok = execute._tokenizer_exec_packed if packed else execute._tokenizer_exec
    blk = execute._block_exec_packed if packed else execute._block_exec
    first = "tokenizer"
    if plan.meta.family == "lm":        # the embedding LIF, then the decoder blocks
        first = "embed"
        tok = lambda meta, p, tokens: execute._lif(
            meta, execute._lm_embed_drive(meta, p, tokens), pack_output=packed)
        blk = lambda meta, bp, x: execute._lm_block_exec(meta, bp, x, packed=packed)
        ref_tok, plan_tok = ref.params["embed"], plan.params["embed"]
    else:
        ref_tok, plan_tok = ref.params["tokenizer"], plan.params["tokenizer"]

    def diff(x, y):
        if not packed:
            return (x != y).sum().item(), 0, x.numel()
        flips = packing.popcount(x.words ^ y.words).sum(dtype=torch.int64).item()
        return flips, (x.words != y.words).sum().item(), x.t * x.words[0].numel()

    with torch.inference_mode():
        x = tok(ref.meta, ref_tok, batch)
        y = tok(plan.meta, plan_tok, batch)
        rows = [(first, *diff(x, y))]
        for i, (rb, cb) in enumerate(zip(ref.params["blocks"], plan.params["blocks"])):
            y = blk(plan.meta, cb, y if end_to_end else x)
            x = blk(ref.meta, rb, x)
            rows.append((f"block{i}", *diff(x, y)))
    words = (lambda w: f" ({w} words)") if packed else (lambda w: "")
    fed = "each plan on its own input" if end_to_end else "each layer fed the plain plan's input"
    worst = max(bad / total for _, bad, _, total in rows)
    log(f"  spike mismatches {label}, {fed}: "
        + ", ".join(f"{name} {bad}{words(w)}/{total}" for name, bad, w, total in rows)
        + f"; largest share {worst:.3g}" + (f" (limit {limit})" if limit is not None else ""))
    if limit is not None:
        check(worst <= limit, f"spike mismatches {label} ({fed}): {worst:.3g} of a layer's "
              f"spikes > {limit}")
    return worst


def _tap_labels(meta):
    labels = [f"tok{i}" for i in range(len(meta.tok_stages))]
    for b in range(meta.num_layers):
        for u in meta.block_units:
            if u.role == "attn_out":
                labels.append(f"block{b}.attn")
            labels.append(f"block{b}.{u.name}")
    return labels


def _spike_rates(plan, batch):
    """Spike rate of every LIF of one forward (``capture_spikes``); fails if a
    LIF inside a block emits no spike."""
    from repro_torch.core import packing
    from repro_torch.engine import execute

    with torch.inference_mode(), execute.capture_spikes() as taps:
        execute.apply(plan, batch)
    labels = _tap_labels(plan.meta)
    if len(taps) != len(labels):
        fail(f"captured {len(taps)} LIF taps, expected {len(labels)}")
    rates = {name: packing.spike_counts(ps).sum().item() / (ps.t * ps.words[0].numel())
             for name, ps in zip(labels, taps)}
    log("  spike rate per LIF (share of neuron-steps that fire): "
        + ", ".join(f"{k} {v:.4%}" for k, v in rates.items() if k.startswith("tok")))
    for b in range(plan.meta.num_layers):
        log(f"    block{b}: " + ", ".join(f"{k.split('.')[1]} {v:.3%}" for k, v in rates.items()
                                          if k.startswith(f"block{b}.")))
    silent = [k for k, v in rates.items() if k.startswith("block") and v == 0]
    if silent:
        fail(f"block LIFs emit no spike on the live model: {silent}")
    block = [v for k, v in rates.items() if k.startswith("block")]
    log(f"  all {len(rates)} LIFs fire; block LIF rates {min(block):.3%}..{max(block):.3%}")
    return rates


def _sparsity(plan, batch):
    from repro_torch.engine import analysis

    with torch.inference_mode():
        rep = analysis.sparsity_report(plan, batch)
    log(f"  sparsity report over {rep['num_taps']} taps: spike_rate {rep['spike_rate']:.4%}, "
        f"word_zero_rate {rep['word_zero_rate']:.4%}, occ_tile_zero_rate "
        f"{rep['occ_tile_zero_rate']:.4%}, token_granule_zero_rate "
        f"{rep['token_granule_zero_rate']:.4%}")
    labels = _tap_labels(plan.meta)
    log("  per tap occ_tile_zero_rate/word_zero_rate: " + ", ".join(
        f"{k} {r['occ_tile_zero_rate']:.3%}/{r['word_zero_rate']:.2%}"
        for k, r in zip(labels, rep["taps"])))
    return rep


def _capture_gated_calls(plan, batch):
    """The operands of every K8 and K9 launch of one forward of a sparse plan,
    recorded by wrapping the two launch sites for that forward."""
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spiking_attention import ops as ssa_ops

    calls = {"K8": [], "K9": []}
    k8, k9 = mm_ops.sparse_packed_spike_matmul_fwd, ssa_ops.sparse_packed_ssa_fwd

    def rec8(xw, w, tiles, *, t):
        calls["K8"].append((xw, w, tiles, t))
        return k8(xw, w, tiles, t=t)

    def rec9(qw, kw, vw, live, *, t, scale, causal=False):
        calls["K9"].append((qw, kw, vw, live, t, scale, causal))
        return k9(qw, kw, vw, live, t=t, scale=scale, causal=causal)

    # each wrapper counts its launches on the attribute of its module-level
    # name, which the recorders stand in for during this forward
    rec8.launches, rec9.launches = k8.launches, k9.launches
    mm_ops.sparse_packed_spike_matmul_fwd, ssa_ops.sparse_packed_ssa_fwd = rec8, rec9
    try:
        with torch.inference_mode():
            from repro_torch import engine

            engine.apply(plan, batch)
    finally:
        mm_ops.sparse_packed_spike_matmul_fwd, ssa_ops.sparse_packed_ssa_fwd = k8, k9
        k8.launches, k9.launches = rec8.launches, rec9.launches
    return calls


def _gated_at_live_data(plan, batch, reports):
    """K8 and K9 timed on the operands of one live forward, beside K5/K6 on the
    same operands, the plain versions and the library calls; their bound is
    the work of the live tiles and planes only."""
    from repro_torch.core import packing
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spike_matmul.ref import sparse_packed_spike_matmul_ref
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import sparse_packed_ssa_ref

    calls = _capture_gated_calls(plan, batch)
    rep = reports["K8"]
    k5_ms = full_bound = 0.0
    live_words = all_words = 0
    for xw, w, tiles, t in calls["K8"]:
        (m, k), c = xw.shape, w.shape[1]
        got = mm_ops.sparse_packed_spike_matmul_fwd(xw, w, tiles, t=t)
        if not torch.equal(got, mm_ops.packed_spike_matmul_fwd(xw, w, t=t)):
            fail(f"K8 at the live data {m}x{k}x{c}: not equal to K5")
        plain = sparse_packed_spike_matmul_ref(xw, w, tiles, t=t)
        err = (got - plain).abs().max().item()
        if not torch.allclose(got, plain, **GEMM_TOL):
            fail(f"K8 at the live data {m}x{k}x{c}: max abs err {err:.3g} vs plain")
        # words inside live (64, 128) tiles: the work K8 cannot skip
        alive = (tiles != 0).repeat_interleave(64, 0)[:m].repeat_interleave(128, 1)[:, :k]
        n_live = int(alive.sum())
        live_words, all_words = live_words + n_live, all_words + m * k
        dense = packing.unpack(packing.PackedSpikes(xw[None], t)).reshape(t * m, k)
        rep.add(f"live {m}x{k}x{c} ({1 - n_live / (m * k):.2%} of words in dead tiles)", 1,
                err, time_ms(lambda: mm_ops.sparse_packed_spike_matmul_fwd(xw, w, tiles, t=t),
                             reps=10),
                time_ms(lambda: sparse_packed_spike_matmul_ref(xw, w, tiles, t=t), reps=5),
                4 * (n_live + k * c + t * m * c), GEMM_PIECES * 2 * t * n_live * c,
                library_ms=time_ms(lambda: torch.matmul(dense, w), reps=5),
                library_tc_ms=matmul_tf32_ms(dense, w, reps=5))
        k5_ms += time_ms(lambda: mm_ops.packed_spike_matmul_fwd(xw, w, t=t), reps=10)
        full_bound += bound_ms(4 * (m * k + k * c + t * m * c),
                               GEMM_PIECES * 2 * t * m * k * c)[0]
        del dense
    log(f"K8 per forward at the live data: {rep.entry['ms']:.3f} ms ({len(calls['K8'])} "
        f"launches) vs K5 {k5_ms:.3f} ms on the same operands; {live_words / all_words:.4%} "
        f"of the words lie in live tiles; bound {rep.entry['bound_ms']:.3f} ms for the live "
        f"tiles, {full_bound:.3f} ms with nothing skipped")

    rep = reports["K9"]
    k6_ms = full_bound = 0.0
    live_planes = all_planes = 0
    for qw, kw, vw, live, t, scale, causal in calls["K9"]:
        _, g, n, dh = qw.shape
        m = kw.shape[2]
        got = ssa_ops.sparse_packed_ssa_fwd(qw, kw, vw, live, t=t, scale=scale, causal=causal)
        if not torch.equal(got, ssa_ops.packed_ssa_fwd(qw, kw, vw, t=t, scale=scale,
                                                       causal=causal)):
            fail("K9 at the live data: not equal to K6")
        if not torch.equal(got, sparse_packed_ssa_ref(qw, kw, vw, live, t=t, scale=scale,
                                                      causal=causal)):
            fail("K9 at the live data: not equal to the plain version")
        n_live = int((live != 0).sum())
        live_planes, all_planes = live_planes + n_live, all_planes + g * t
        q, k, v = (packing.unpack(packing.PackedSpikes(x, t)).reshape(t * g, x.shape[2], dh)
                   for x in (qw, kw, vw))
        rep.add(f"live G={g} N={n} Dh={dh} ({1 - n_live / (g * t):.2%} planes dead)", 1, 0.0,
                time_ms(lambda: ssa_ops.sparse_packed_ssa_fwd(qw, kw, vw, live, t=t,
                                                              scale=scale, causal=causal)),
                time_ms(lambda: sparse_packed_ssa_ref(qw, kw, vw, live, t=t, scale=scale,
                                                      causal=causal), reps=5),
                4 * (g * n * dh + 2 * g * m * dh) + 4 * t * g * n * dh,
                4 * n_live * n * m * dh,
                library_ms=time_ms(lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v)
                                   * scale),
                peak=TC_FLOP_PER_S,
                library_tc_ms=None if causal else library_tc_ms(
                    q, k, v, scale, got.reshape(t * g, n, dh), "K9 at the live data"))
        k6_ms += time_ms(lambda: ssa_ops.packed_ssa_fwd(qw, kw, vw, t=t, scale=scale,
                                                        causal=causal))
        full_bound += bound_ms(4 * (g * n * dh + 2 * g * m * dh) + 4 * t * g * n * dh,
                               4 * t * g * n * m * dh, TC_FLOP_PER_S)[0]
    log(f"K9 per forward at the live data: {rep.entry['ms']:.3f} ms ({len(calls['K9'])} "
        f"launches) vs K6 {k6_ms:.3f} ms on the same operands; {live_planes}/{all_planes} "
        f"(fold, plane) pairs live; bound {rep.entry['bound_ms']:.3f} ms for the live planes, "
        f"{full_bound:.3f} ms with nothing skipped")
    log("  K8 library_ms is torch.matmul on the unpacked operand (library_tc_ms: with TF32 "
        "allowed), K9's two torch.bmm (library_tc_ms: two f16 torch.bmm with f32 output)")


# The kernel of each entry point, by its name in the library (the ungated
# and gated packed SSA are one kernel, told apart by its last template flag;
# past Dh = 128 the three SSA entry points share ssa_wide_tc_kernel, told
# apart by its two flags).
KERNEL_NAMES = {"lif_parallel_kernel": "K1", "spike_matmul_tc_kernel": "K2",
                "ssa_tc_kernel": "K3", "lif_pack_kernel": "K4",
                "packed_spike_matmul_tc_kernel": "K5", "lif_bwd_kernel": "K7",
                "sparse_packed_spike_matmul_tc_kernel": "K8"}


def _hand_kernels(kernels):
    """(K number, name, profiler event) of each of the port's kernels among
    the profiler's CUDA events."""
    ns = "(anonymous namespace)::"
    out = []
    for e in kernels:
        if ns not in e.key or e.key.split(ns)[0] not in ("", "void "):
            continue
        name = e.key.split(ns)[1].split("(")[0]
        base = name.split("<")[0]
        key = KERNEL_NAMES.get(base)
        if base == "packed_ssa_tc_kernel":    # <Dp, P, kGated, kSplit>
            key = "K9" if name.split("<")[1].split(",")[2].strip() == "true" else "K6"
        if base == "ssa_wide_tc_kernel":      # <DQ, kPacked, kGated, kSplit>
            packed, gated = (f.strip() == "true" for f in name.split("<")[1].rstrip(">")
                             .split(",")[1:3])
            key = "K9" if gated else "K6" if packed else "K3"
        if key:
            out.append((key, name, e))
    return out


def _route(plan) -> str:
    b = plan.backend
    return b.kind + "+packed" * b.packed + "+sparse" * b.sparse


def _profile_forward(label, plan, batch, tries=3):
    """One forward of a vision plan under :func:`_profile`."""
    from repro_torch import engine

    step = engine.make_apply_fn(plan)
    want = {k: n for k, n in _per_forward(plan.meta.num_layers, _route(plan)).items() if n}
    return _profile(label, lambda: step(plan.params, batch), want, tries)


def _profile(label, run, want, tries=3, inference=True):
    """One ``run()`` under ``torch.profiler`` (after a warm-up run): the
    device time of every CUDA kernel it ran, their count, and the profiled
    wall time, so that the device's idle share shows.  Returns the device ms
    of each of the port's kernels in that run, by K number.  The profiler at
    times drops part of a run's kernels: a profile whose count of the port's
    launches is not ``want`` is taken again, up to ``tries`` times, and is
    logged as incomplete.  The profiler's schedule traces a warm-up run and
    keeps the run after it (as :func:`_profile_lm_step` does): a profile
    begun right before the run missed its first kernel, the embedding LIF of
    an LM prefill or step, in every attempt; the schedule's step annotations
    are left out of the sums.  ``inference=False`` profiles a run that needs
    autograd (a training step) outside ``torch.inference_mode``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = {}

    def ready(prof):        # the kept run's kernels (the cycle's end clears them)
        kept["kernels"] = [e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and not getattr(e, "is_user_annotation", False)
                           and not e.key.startswith("ProfilerStep")]

    for attempt in range(1, tries + 1):
        with torch.inference_mode(inference):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=ready) as prof:
                for _ in range(2):      # the traced warm-up run, then the kept one
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                    prof.step()
        kernels = kept.pop("kernels", [])
        mine = _hand_kernels(kernels)
        counts = {}
        for key, _, e in mine:
            counts[key] = counts.get(key, 0) + e.count
        if counts == want:
            break
        log(f"  profile {label}: incomplete (launches {counts}, the run makes {want}), "
            f"attempt {attempt} of {tries}")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        log(f"  profile {label}: the profiler saw no device time")
        return {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"  profile {label}: {sum(e.count for e in kernels)} CUDA kernels, device busy "
        f"{busy:.3f} ms of a {wall:.3f} ms profiled run ({1 - busy / wall:.1%} idle); "
        "top: " + ", ".join(f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                            for e in top))
    # the hand kernels' own device time, free of the launch gaps that
    # back-to-back event timing of a short kernel includes
    log(f"  profile {label}, hand kernels' device time per run: " + ", ".join(
        f"{name} ({key}) x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
        for key, name, e in mine))
    if counts != want:
        return {}
    times = {}
    for key, _, e in mine:
        times[key] = times.get(key, 0.0) + e.self_device_time_total / 1e3
    return times


def phase_model(dev, smi, reports):
    """The six backends on the live 8-384 model, then one serve_vision per
    kernel route on the fresh-BN seeded model."""
    from repro_torch import engine
    from repro_torch.launch.serve import live_model, seeded_model, serve_plan, serve_vision

    plans, runs, launches = {}, {}, {}
    for backend in BACKENDS:
        plan, images = live_model(ARCH, REQUESTS, backend, dev)
        plans[backend] = plan
        cfg = plan.cfg
        run = lambda: serve_plan(plan, images, slots=SLOTS, verbose=False)
        if backend in PATHS:
            runs[backend], launches[backend] = _run_counted("live main path", backend,
                                                            cfg.num_layers, run)
        else:
            runs[backend] = run()
        if runs[backend]["logits"].shape != (REQUESTS, cfg.num_classes):
            fail(f"{backend}: logits shape {tuple(runs[backend]['logits'].shape)}")
    stats = engine.plan_stats(plans["cuda+packed+sparse"])
    if stats["lif_dispatches"] != _per_forward(cfg.num_layers, "cuda")["K1"]:
        fail("plan_stats lif_dispatches disagrees with the launch accounting")
    if not (stats["sparse"] and stats["bits_per_spike"] == 32 / cfg.t):
        fail("plan_stats of the sparse plan")
    # The three kernel routes compute bit for bit the same function (K5 ==
    # K2 on the unpacked operand, K8 == K5, K4/K6/K9 give K1/K3's spikes), so
    # their logits are equal; so are the dense and packed plain plans (the
    # packed one unpacks and runs the same ops).  A kernel plan against a
    # plain plan is held layer by layer below: end to end, a spike flipped by
    # another f32 sum order feeds every later layer of a model that fires.
    # The sparse pair differs only in the GEMMs' order (tensor cores against
    # f32 torch.matmul): held end to end below, each plan's spikes on its own
    # activations within E2E_SPIKE_SHARE, which the hi-only control GEMM must
    # exceed, and its logits within E2E_LOGITS_ATOL; the pairs with cuDNN
    # convs are reported.
    logits = {b: r["logits"] for b, r in runs.items()}
    _check_equal("live cuda+packed vs cuda", logits["cuda+packed"], logits["cuda"])
    _check_equal("live cuda+packed+sparse vs cuda+packed", logits["cuda+packed+sparse"],
                 logits["cuda+packed"])
    _check_equal("live torch+packed vs torch", logits["torch+packed"], logits["torch"])
    _check_logits("live torch+packed+sparse vs torch+packed", logits["torch+packed+sparse"],
                  logits["torch+packed"], atol=None)
    _check_logits("live cuda+packed+sparse vs torch+packed+sparse", logits["cuda+packed+sparse"],
                  logits["torch+packed+sparse"], atol=E2E_LOGITS_ATOL)
    for kernels, plain in (("cuda", "torch"), ("cuda+packed", "torch+packed")):
        _check_logits(f"live {kernels} vs {plain}", logits[kernels], logits[plain], atol=None)
    spread = logits["cuda"].std(dim=-1).mean().item()
    log(f"live logits: mean std over the {cfg.num_classes} classes {spread:.4g}")

    served_images = images
    _, images = live_model(ARCH, SLOTS, "torch", dev)
    for plain, kernels in (("torch", "cuda"), ("torch+packed", "cuda+packed"),
                           ("torch+packed+sparse", "cuda+packed+sparse")):
        _mismatch_rows(f"{kernels} vs {plain}", (plans[plain], plans[kernels]), images)
    sparse_pair = (plans["torch+packed+sparse"], plans["cuda+packed+sparse"])
    rows = lambda label, limit: _mismatch_rows(label, sparse_pair, images, end_to_end=True,
                                               limit=limit)
    rows("cuda+packed+sparse vs torch+packed+sparse", E2E_SPIKE_SHARE)
    _e2e_controls("live cuda+packed+sparse vs torch+packed+sparse",
                  lambda: serve_plan(plans["cuda+packed+sparse"], served_images, slots=SLOTS,
                                     verbose=False)["logits"], logits["torch+packed+sparse"],
                  rows)
    _spike_rates(plans["cuda+packed"], images)
    _sparsity(plans["cuda+packed+sparse"], images)
    _gated_at_live_data(plans["cuda+packed+sparse"], images, reports)
    for backend in PATHS:
        times = _profile_forward(f"live {backend}", plans[backend], images)
        for key in PATHS[backend]:           # K4: from the packed route, its first
            if reports[key].entry["device_ms"] is None:
                reports[key].entry["device_ms"] = times.get(key)
    for backend in BACKENDS:
        _serve_line(f"{backend} (live model)", runs[backend], cfg, smi)

    # the fresh-BN seeded model: dead beyond the tokenizer, so the sparse
    # route's reading here is the most that skipping can save on this model;
    # with the blocks silent, kernel and plain plans agree end to end
    dead = {}
    for backend in BACKENDS:
        run = lambda: serve_vision(ARCH, num_requests=REQUESTS, slots=SLOTS, backend=backend,
                                   device=dev, verbose=False)
        if backend in PATHS:
            dead[backend], _ = _run_counted("serve_vision on the fresh-BN seeded model",
                                            backend, cfg.num_layers, run)
        else:
            dead[backend] = run()
    for kernels, plain in (("cuda", "torch"), ("cuda+packed", "torch+packed"),
                           ("cuda+packed+sparse", "torch+packed+sparse")):
        _check_logits(f"fresh-BN seeded model {kernels} vs {plain}", dead[kernels]["logits"],
                      dead[plain]["logits"])
    _check_equal("fresh-BN seeded model cuda+packed+sparse vs cuda+packed",
                 dead["cuda+packed+sparse"]["logits"], dead["cuda+packed"]["logits"])
    for backend in PATHS:
        _serve_line(f"{backend} (fresh-BN seeded model, blocks silent)", dead[backend], cfg, smi)
    for backend in ("cuda+packed", "cuda+packed+sparse"):
        plan, images = seeded_model(ARCH, num_requests=SLOTS, backend=backend, device=dev)
        _profile_forward(f"fresh-BN {backend}", plan, images)
    log("fresh-BN seeded model:")
    _sparsity(plan, images)
    fail_if_any("phase 3")
    forwards = {k: runs[b]["forwards"] for b, keys in PATHS.items() for k in keys}
    totals = {k: launches[b][k] for b, keys in PATHS.items() for k in keys}
    return totals, forwards


def phase_other_configs(dev):
    """Every other vision config at full size, 2 images, on the fresh-BN
    seeded model (kernel plans within atol of the plain plans) and on the
    live model (the kernel routes equal to each other)."""
    from repro_torch import engine
    from repro_torch.configs.spike_iand_former import get_vision_config, list_vision_configs
    from repro_torch.launch.serve import live_model, seeded_model

    counters = _counters()
    for arch in list_vision_configs():
        if arch == ARCH:
            continue
        cfg = get_vision_config(arch)
        backends = ["torch", "cuda"]
        if cfg.residual == "iand":
            backends += ["torch+packed", "cuda+packed", "cuda+packed+sparse"]
        else:
            log(f"{arch}: residual={cfg.residual!r}, so no packed plan (the ADD "
                "residual sums spike trains into non-binary tensors)")
        for weights, build in (("fresh-BN", lambda b: seeded_model(arch, num_requests=2,
                                                                   backend=b, seed=1,
                                                                   device=dev)),
                               ("live", lambda b: live_model(arch, 2, b, dev, seed=1))):
            logits = {}
            for backend in backends:
                plan, images = build(backend)
                before = {k: f.launches for k, f in counters.items()}
                with torch.inference_mode():
                    logits[backend] = engine.apply(plan, images)
                torch.cuda.synchronize(dev)
                grown = {k: f.launches - before[k] for k, f in counters.items()}
                if backend in PATHS:
                    check(grown == _per_forward(cfg.num_layers, backend),
                          f"{arch} {backend}: launches {grown}, expected "
                          f"{_per_forward(cfg.num_layers, backend)}")
            atol = LOGITS_ATOL if weights == "fresh-BN" else None
            for kernels, plain in (("cuda", "torch"), ("cuda+packed", "torch+packed")):
                if kernels in logits:
                    _check_logits(f"{arch} {weights} {kernels} vs {plain} "
                                  f"{tuple(logits[kernels].shape)}", logits[kernels],
                                  logits[plain], atol=atol)
            if "cuda+packed+sparse" in logits:
                _check_equal(f"{arch} {weights} cuda+packed vs cuda", logits["cuda+packed"],
                             logits["cuda"])
                _check_equal(f"{arch} {weights} cuda+packed+sparse vs cuda+packed",
                             logits["cuda+packed+sparse"], logits["cuda+packed"])
    fail_if_any("phase 4")


def _graph_nodes(out) -> dict[str, int]:
    """Count of each autograd node type in the graph behind ``out``."""
    counts: dict[str, int] = {}
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        counts[type(fn).__name__] = counts.get(type(fn).__name__, 0) + 1
        todo.extend(f for f, _ in fn.next_functions)
    return counts


def _tapped_lif_rates(run):
    """``run()`` with every LIF of the model recorded (the dispatch of the
    tokenizer and of the blocks): returns (its result, spike rate per LIF in
    call order)."""
    from repro_torch.core import spikformer as sf
    from repro_torch.core import tokenizer as tok

    rates, orig = [], (sf.lif, tok.lif)

    def tap(drive, **kw):
        out = orig[0](drive, **kw)
        rates.append(out.detach().float().mean())
        return out

    sf.lif = tok.lif = tap
    try:
        result = run()
    finally:
        sf.lif, tok.lif = orig
    return result, [r.item() for r in rates]


def _grad_groups(grads, want, limit=GRAD_REL):
    """Largest |grads - want| / max |want| per leaf, grouped into tokenizer,
    blocks and head (each leaf checked against ``limit`` unless it is None);
    and the leaves where ``grads`` is zero but ``want`` is not."""
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    want = dict(flatten_with_names(want))
    groups, silent = {"tokenizer": 0.0, "blocks": 0.0, "head": 0.0}, []
    for name, g in flatten_with_names(grads):
        w = want[name]
        scale = w.abs().max().item()
        rel = (g - w).abs().max().item() / scale if scale else (g.abs().max().item() or 0.0)
        group = "tokenizer" if "tokenizer" in name else "head" if "head" in name else "blocks"
        groups[group] = max(groups[group], rel)
        if limit is not None:
            check(rel <= limit, f"gradient {name}: {rel:.3g} of its scale > {limit}")
        if bool(((g == 0) & (w != 0)).any()):
            silent.append(name)
    return groups, silent


def _time_train(cfg, params, state, batches, smi, label):
    """ms per SGD step (host clock, each step ending in a device sync) over
    the batches after the first (a warm-up)."""
    from repro_torch.launch import train as ttrain

    times = []
    for image, lab in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _ = ttrain.train_step(params, state, image, lab, cfg, lr=0.05)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(loss)), f"{label}: loss {loss.item()} not finite")
    ms = sum(times[1:]) / len(times[1:])
    log(f"train {ARCH} {label}: {ms:.2f} ms per SGD step, {1e3 * TRAIN_BATCH / ms:.1f} img/s "
        f"(batch {TRAIN_BATCH}, {cfg.img_size}x{cfg.img_size}, mean of {len(times) - 1} steps "
        "after a warm-up; "
        f"steps {', '.join(f'{x:.2f}' for x in times)} ms) on {smi}")
    return ms


def _profile_step(cfg, params, state, image, label):
    """One kernel-route SGD step under ``torch.profiler``: device busy vs
    the profiled wall time, and the kernels that take the time.  Returns
    K7's device ms in the step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as ttrain

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ttrain.train_step(params, state, image, label, cfg, lr=0.05)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        log("  profile train step: the profiler saw no device time")
        return None
    categories = (("K1 lif_parallel_kernel", ("lif_parallel_kernel",)),
                  ("K7 lif_bwd_kernel", ("lif_bwd_kernel",)),
                  ("K3 ssa_tc_kernel", ("ssa_tc_kernel",)),
                  ("cuBLAS GEMM", ("gemm", "Gemm")),
                  ("cuDNN conv", ("cudnn", "conv", "dgrad", "wgrad", "implicit")),
                  ("max pool", ("max_pool", "MaxPool")), ("reductions", ("reduce_kernel",)),
                  ("elementwise", ("elementwise", "Elementwise")))
    mine = dict.fromkeys([c for c, _ in categories] + ["other"], 0.0)
    for e in kernels:
        cat = next((c for c, pats in categories if any(p in e.key for p in pats)), "other")
        mine[cat] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    log(f"  profile train step (kernel route): {sum(e.count for e in kernels)} CUDA kernels, "
        f"device busy {busy:.3f} ms of a {wall:.3f} ms profiled step "
        f"({1 - busy / wall:.1%} idle); " + ", ".join(f"{k} {v:.3f} ms" for k, v in mine.items()))
    log("  top: " + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                              for e in top))
    return sum(e.self_device_time_total for key, _, e in _hand_kernels(kernels)
               if key == "K7") / 1e3


def phase_train(dev, smi):
    """Training of the 8-384 at full width and resolution: the kernel route
    against the plain route on one step, then ``train_spikformer`` counted,
    checkpointed, restored and served.  Returns (K7 launches, steps, K7's
    device ms in one profiled step)."""
    from repro_torch import engine
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.checkpoint import flatten_with_names
    from repro_torch.configs.spike_iand_former import get_vision_config
    from repro_torch.core import spikformer as sf
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train as ttrain

    base = get_vision_config(ARCH)
    kern_cfg = dataclasses.replace(base, use_kernel=True)
    plain_cfg = dataclasses.replace(base, use_kernel=False)
    params, state = sf.init(torch.Generator().manual_seed(0), base, device=dev)
    dcfg = DataConfig(kind="images", global_batch=TRAIN_BATCH, img_size=base.img_size,
                      num_classes=base.num_classes)

    def batch(step):
        b = make_batch(dcfg, step)
        return (torch.from_numpy(b["image"]).to(dev),
                torch.from_numpy(b["label"]).long().to(dev))

    image, label = batch(0)
    kern, rates = _tapped_lif_rates(
        lambda: ttrain.loss_and_grad(params, state, image, label, kern_cfg))
    plain = ttrain.loss_and_grad(params, state, image, label, plain_cfg)
    again = ttrain.loss_and_grad(params, state, image, label, plain_cfg)
    spread, _ = _grad_groups(again[2], plain[2], limit=None)
    log("  plain route run twice, largest |run 2 - run 1| / max|run 1| of a leaf: "
        + ", ".join(f"{k} {v:.3g}" for k, v in spread.items())
        + " (the same calls on the same inputs: what the card's own summation order moves)")
    del again
    same_loss = torch.equal(kern[0], plain[0])
    log(f"train step routes: loss kernel {kern[0].item()!r} plain {plain[0].item()!r}: "
        f"torch.equal {same_loss}; accuracy {kern[1].item():.3f}")
    check(same_loss, "train step: kernel-route loss not equal to the plain route's")
    groups, silent = _grad_groups(kern[2], plain[2])
    log("  gradients, largest |kernel - plain| / max|plain| of a leaf: "
        + ", ".join(f"{k} {v:.3g}" for k, v in groups.items()) + f" (limit {GRAD_REL})")
    check(not silent, f"kernel-route gradient zero where the plain route's is not: {silent}")
    same_state = all(torch.equal(a, b) for (_, a), (_, b) in
                     zip(flatten_with_names(kern[3]), flatten_with_names(plain[3])))
    check(same_state, "train step: new BN state differs between the routes")
    worst = 0.0
    for x, y in zip(kern[4], plain[4]):
        worst = max(worst, (x != y).sum().item() / x.numel())
    log(f"  spikes of the tokenizer and the {base.num_layers} blocks: largest mismatch share "
        f"{worst:.3g} (bound {MISMATCH_SHARE}); BN state torch.equal {same_state}")
    check(worst <= MISMATCH_SHARE, f"train step spikes: mismatch share {worst:.3g}")
    n_lif = 4 + 7 * base.num_layers
    check(len(rates) == n_lif, f"tapped {len(rates)} LIFs, expected {n_lif}")
    log("  train-mode spike rate per LIF: tokenizer " + ", ".join(f"{r:.3%}" for r in rates[:4])
        + "; blocks " + f"{min(rates[4:]):.3%}..{max(rates[4:]):.3%}")
    check(min(rates[4:]) > 0, "a block LIF emits no spike in the train-mode forward")
    with torch.enable_grad():
        flat = [x.detach().requires_grad_(True) for x in ttrain.leaves(params)]
        logits, _ = sf.apply(ttrain.rebuild(params, iter(flat)), state, image, kern_cfg,
                             train=True)
    nodes = _graph_nodes(logits)
    lif_nodes, ssa_nodes = nodes.get("_LifOpBackward", 0), nodes.get("_SsaOpBackward", 0)
    log(f"  kernel-route graph: {lif_nodes} _LifOp and {ssa_nodes} _SsaOp nodes")
    check((lif_nodes, ssa_nodes) == (n_lif, base.num_layers),
          f"graph holds {lif_nodes} _LifOp / {ssa_nodes} _SsaOp, expected {n_lif} / "
          f"{base.num_layers}")
    del kern, plain, logits
    fail_if_any("phase 5 (routes)")

    # the main path: the training entry point, every launch counted
    ckpt_dir = ROOT / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    out = ttrain.train_spikformer(ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, device=dev,
                                  ckpt_dir=ckpt_dir, eval_batches=TRAIN_EVAL, log_every=1)
    launches = {k: f.launches for k, f in counters.items()}
    forwards = TRAIN_STEPS + TRAIN_EVAL
    want = dict.fromkeys(counters, 0)
    want.update(K1=n_lif * forwards, K3=base.num_layers * forwards, K7=n_lif * TRAIN_STEPS)
    log(f"train_spikformer: {TRAIN_STEPS} steps + {TRAIN_EVAL} held-out forwards, launches "
        f"{launches} (expected {want}: per step {n_lif} K1 + {n_lif} K7 + "
        f"{base.num_layers} K3)")
    check(launches == want, f"train_spikformer launches {launches}, expected {want}")
    check(all(np.isfinite(out["losses"])), f"losses {out['losses']} not finite")
    log(f"  losses {out['losses']}, step ms {[round(x, 2) for x in out['step_ms']]}, "
        f"held-out accuracy {out['heldout_acc']:.3f}, all-spike {out['all_spike']}")

    fresh_p, fresh_s = sf.init(torch.Generator().manual_seed(1), base, device=dev)
    restored, manifest = ckpt.restore(ckpt_dir, {"params": fresh_p, "state": fresh_s})
    trained = {"params": out["params"], "state": out["state"]}
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten_with_names(restored), flatten_with_names(trained)))
    log(f"  checkpoint step {manifest['step']}, {len(manifest['leaves'])} leaves: restored "
        f"into fresh trees torch.equal the trained ones: {same}")
    check(same, "restored checkpoint differs from the trained trees")
    images, _ = batch(100_001)
    images = images[:SLOTS]
    plan = engine.compile_plan(fresh_p, fresh_s, base, backend="cuda+packed", device=dev,
                               checkpoint=str(ckpt_dir))
    plans = {b: engine.compile_plan(out["params"], out["state"], base, backend=b, device=dev)
             for b in ("cuda+packed", "torch+packed", "torch+packed+sparse")}
    with torch.inference_mode():
        served = engine.apply(plan, images)
        logits = {b: engine.apply(p, images) for b, p in plans.items()}
        want_logits, _ = sf.apply(out["params"], out["state"], images, plain_cfg)
    _check_equal("restored-checkpoint cuda+packed plan vs the plan of the trained trees",
                 served, logits["cuda+packed"])
    # phase 3's treatment: the trained model's eval forward fires, so the
    # kernel plan against the plain plans is held layer by layer; end to end
    # against torch+packed+sparse (the GEMMs' order alone) within
    # E2E_SPIKE_SHARE and E2E_LOGITS_ATOL, reported against the plans with
    # cuDNN convs (torch+packed, apply)
    _check_logits("restored-checkpoint cuda+packed plan vs torch+packed+sparse", served,
                  logits["torch+packed+sparse"], atol=E2E_LOGITS_ATOL)
    _check_logits("restored-checkpoint cuda+packed plan vs apply(train=False)", served,
                  want_logits, atol=None)
    _check_logits("torch+packed plan vs apply(train=False)", logits["torch+packed"],
                  want_logits, atol=None)
    _mismatch_rows("restored cuda+packed vs torch+packed",
                   (plans["torch+packed"], plan), images)
    _mismatch_rows("restored cuda+packed vs torch+packed+sparse",
                   (plans["torch+packed+sparse"], plan), images)
    rows = lambda label, limit: _mismatch_rows(label, (plans["torch+packed+sparse"], plan),
                                               images, end_to_end=True, limit=limit)
    rows("restored cuda+packed vs torch+packed+sparse", E2E_SPIKE_SHARE)
    _e2e_controls("restored-checkpoint cuda+packed plan vs torch+packed+sparse",
                  lambda: engine.apply(plan, images), logits["torch+packed+sparse"], rows)
    with torch.inference_mode():
        _, rates = _tapped_lif_rates(lambda: sf.apply(out["params"], out["state"], images,
                                                      kern_cfg))
    log(f"  eval-mode spike rate of the trained model: tokenizer "
        + ", ".join(f"{r:.3%}" for r in rates[:4])
        + f"; blocks {min(rates[4:]):.3%}..{max(rates[4:]):.3%}")
    del out, restored, trained, plan, plans, fresh_p, fresh_s

    batches = [batch(10 + i) for i in range(4)]
    ms = {label: _time_train(cfg, params, state, batches, smi, label)
          for label, cfg in (("kernel route", kern_cfg), ("plain route", plain_cfg),
                             ("kernel route again", kern_cfg))}
    log(f"  kernel route / plain route: {ms['kernel route'] / ms['plain route']:.3f}")
    k7_ms = _profile_step(kern_cfg, params, state, *batches[0])
    fail_if_any("phase 5")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches["K7"], TRAIN_STEPS, k7_ms


def _lm_launches(backend, prefills, steps, ordering="quadratic", compiles=0,
                 layers=LM_LAYERS):
    """Launches of each kernel over ``prefills`` prefill forwards (or
    resumable chunks), ``steps`` decode steps and ``compiles`` plan compiles
    on a kernel route: per prefill one LIF for the embedding and 7 a block, 6
    GEMMs a block and (quadratic) one SSA a block; per step the same LIFs and
    GEMMs and no SSA kernel (the O(d^2) state update is plain PyTorch), but on
    the sparse route no embedding LIF (the step gathers the token's train from
    the plan's train table); per sparse compile one K4 per block of
    ``bundling.ROW_BLOCK`` vocabulary rows (the train table); the other
    routes' kernels never launch.  ``layers``: the plan's depth."""
    from repro_torch.core.bundling import ROW_BLOCK

    sparse = backend.endswith("+sparse")
    lif, gemm = 1 + 7 * layers, 6 * layers
    step_lif = lif - sparse
    ssa = layers if ordering == "quadratic" else 0
    table = compiles * -(-LM_VOCAB // ROW_BLOCK) if sparse else 0
    want = dict.fromkeys(_counters(), 0)
    for key, n in zip(PATHS[backend], (prefills * lif + steps * step_lif + table,
                                       (prefills + steps) * gemm, prefills * ssa)):
        want[key] = n
    return want


def _lm_counted(label, backend, run, want_of):
    """``run()`` with every launch counter set to 0 just before and read just
    after; fails unless the counts are ``want_of(run's result)``."""
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want = want_of(out)
    check(launches == want, f"{label} {backend}: launches {launches}, expected {want}")
    log(f"{label} backend={backend}: launches {launches} (expected {want})")
    return out, launches


def _lm_spike_rates(label, taps):
    """Spike share of every LIF of one forward (embedding, then q, k, v, attn,
    proj, fc1, fc2 per block; proj and fc2 carry the AND-NOT join, so theirs is
    the residual stream's); fails if a block LIF emits no spike."""
    from repro_torch.core import packing

    names = ["embed"] + [f"block{i}.{u}" for i in range(LM_LAYERS)
                         for u in ("q", "k", "v", "attn", "proj", "fc1", "fc2")]
    check(len(taps) == len(names), f"captured {len(taps)} LIF taps, expected {len(names)}")
    rates = {n: packing.spike_counts(ps).sum().item() / (ps.t * ps.words[0].numel())
             for n, ps in zip(names, taps)}
    log(f"  {label}: spike rate per LIF of a prefill: embed {rates['embed']:.3%}")
    for i in range(LM_LAYERS):
        log(f"    block{i}: " + ", ".join(f"{k.split('.')[1]} {v:.3%}" for k, v in rates.items()
                                          if k.startswith(f"block{i}.")))
    silent = [k for k, v in rates.items() if k.startswith("block") and v == 0]
    check(not silent, f"{label}: LM block LIFs emit no spike: {silent}")
    block = [v for k, v in rates.items() if k.startswith("block")]
    counts = [packing.spike_counts(ps).sum().item() for ps in taps]
    log(f"  {label}: {len(rates)} LIFs, block LIF rates {min(block):.4%}..{max(block):.3%} "
        f"(the fewest spikes of a LIF: {min(counts)} of {taps[-1].t * taps[-1].words[0].numel()})")


def _lm_routes_equal(label, runs):
    """The three kernel routes' token streams and logits ``torch.equal``."""
    for backend in ("cuda+packed", "cuda+packed+sparse"):
        for key in ("tokens", "logits"):
            same = torch.equal(runs[backend][key], runs["cuda"][key])
            log(f"  {label}: {key} {backend} vs cuda: torch.equal {same}")
            check(same, f"{label} LM {key}: {backend} differs from cuda")


def _first_divergence(a, b):
    """Per request, the first position where two token streams differ (None
    where they agree)."""
    out = []
    for x, y in zip(a, b):
        diff = (x != y).nonzero()
        out.append(int(diff[0]) if len(diff) else None)
    return out


def phase_lm(dev, smi, reports):
    """The spiking LM at full llama3.2-1b width on the card: ``serve_spiking_lm``
    on the three kernel routes (the main path, launches counted) and the
    seeded model's spike rates; then the live LM (``live_lm_params``, every
    block firing) served on the three routes, a linear-ordering prefill,
    prefill plus steps against the full forward, chunked prefill, every LIF
    firing, the kernel route against the plain route, and one profiled
    prefill and decode step per route."""
    from repro_torch import engine
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.engine import execute
    from repro_torch.launch.serve import (
        live_lm_params, serve_lm_plan, serve_spiking_lm, spiking_lm_config)
    from repro_torch.models import spiking_lm as slm

    cfg = spiking_lm_config(LM_ARCH)
    log(f"{LM_ARCH} spiking: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads of Dh {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"T={cfg.spike_t}, {cfg.param_dtype}")
    runs, launches = {}, {}
    for backend in PATHS:
        torch.cuda.reset_peak_memory_stats(dev)
        run = lambda: serve_spiking_lm(LM_ARCH, num_requests=LM_REQUESTS, prompt_len=LM_PROMPT,
                                       max_new=LM_NEW, slots=LM_SLOTS, backend=backend,
                                       device=dev)
        runs[backend], launches[backend] = _lm_counted(
            "serve_spiking_lm", backend, run,
            lambda r: _lm_launches(backend, r["prefills"], r["steps"], compiles=1))
        r = runs[backend]
        check(tuple(r["tokens"].shape) == (LM_REQUESTS, LM_NEW)
              and tuple(r["logits"].shape) == (LM_REQUESTS, LM_NEW, LM_VOCAB),
              f"{backend}: tokens {tuple(r['tokens'].shape)}, logits {tuple(r['logits'].shape)}")
        check(bool(torch.isfinite(r["logits"]).all()), f"{backend}: non-finite logits")
        steps = sorted(r["step_ms"])
        log(f"serve {LM_ARCH} backend={backend}: {r['tok_per_s']:.2f} tok/s ({LM_REQUESTS} "
            f"requests x {LM_NEW} new tokens, prompt {LM_PROMPT}, slots {LM_SLOTS}, "
            f"{r['seconds']:.3f} s); prefill {', '.join(f'{x:.3f}' for x in r['prefill_ms'])} ms; "
            f"decode step median {steps[len(steps) // 2]:.3f} ms (min {steps[0]:.3f}, max "
            f"{steps[-1]:.3f}, {len(steps)} steps); peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB; on {smi}")
    _lm_routes_equal("seeded", runs)
    prompts = make_batch(DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=LM_PROMPT,
                                    global_batch=LM_REQUESTS), 0)["tokens"]
    batch = torch.from_numpy(prompts[:LM_SLOTS]).long().to(dev)
    params = slm.init_spiking_lm(torch.Generator(dev).manual_seed(0), cfg)
    seeded = engine.compile_plan(params, None, cfg, backend="cuda+packed", device=dev)
    del params
    with execute.capture_spikes() as taps:
        logits, _ = engine.prefill(seeded, batch)
    check(torch.equal(logits[:, -1].cpu(), runs["cuda+packed"]["logits"][:LM_SLOTS, 0]),
          "the seeded model's prefill differs from serve_spiking_lm's")
    _lm_spike_rates("seeded model (serve_spiking_lm's weights)", taps)
    del seeded, taps, logits
    fail_if_any("phase 6 (serving)")

    # the live LM: every block fires, so the comparisons below see spikes in
    # every layer
    params = live_lm_params(cfg, dev)
    live_runs = {}
    for backend in PATHS:
        p_ = engine.compile_plan(params, None, cfg, backend=backend, device=dev)
        live_runs[backend], _ = _lm_counted(
            "serve_lm_plan, live LM", backend,
            lambda: serve_lm_plan(p_, prompts, slots=LM_SLOTS, max_new=LM_NEW, verbose=False),
            lambda r: _lm_launches(backend, r["prefills"], r["steps"]))
        del p_
    _lm_routes_equal("live", live_runs)
    plan = engine.compile_plan(params, None, cfg, backend="cuda", device=dev)
    logits_q, state_q = engine.prefill(plan, batch)

    lin = engine.compile_plan(params, None, cfg, backend="cuda", ordering="linear", device=dev)
    (logits_l, state_l), _ = _lm_counted(
        "linear-ordering prefill", "cuda", lambda: engine.prefill(lin, batch),
        lambda _: _lm_launches("cuda", 1, 0, "linear"))
    same = torch.equal(logits_l, logits_q) and all(
        torch.equal(a, b_) for a, b_ in zip(state_l.kv, state_q.kv))
    log(f"  linear-ordering prefill: logits and state torch.equal the quadratic prefill's: {same}")
    check(same, "linear-ordering prefill differs from the quadratic one")
    del lin, logits_l, state_l

    # prefill plus steps against the full forward, on the packed plan so that
    # every LIF's words can be held too; chunked prefill against one-shot
    pplan = engine.compile_plan(params, None, cfg, backend="cuda+packed", device=dev)
    new = live_runs["cuda"]["tokens"][:LM_SLOTS, :4].to(dev)
    seq = torch.cat([batch, new], dim=1)
    with execute.capture_spikes() as full_taps:
        full = engine.apply(pplan, seq)
    with execute.capture_spikes() as pre_taps:
        logits, state = engine.prefill(pplan, batch)
    step_err, words_same = (logits - full[:, :LM_PROMPT]).abs().max().item(), True
    for j in range(new.shape[1]):
        with execute.capture_spikes() as taps:
            step_logits, state = engine.decode_step(pplan, state, new[:, j])
        step_err = max(step_err, (step_logits - full[:, LM_PROMPT + j]).abs().max().item())
        words_same &= all(torch.equal(a.words[:, :, LM_PROMPT + j], b_.words[:, :, 0])
                          for a, b_ in zip(full_taps, taps))
    words_same &= all(torch.equal(a.words[:, :, :LM_PROMPT], b_.words)
                      for a, b_ in zip(full_taps, pre_taps))
    _, whole = engine.prefill(pplan, seq)
    state_same = all(torch.equal(a, b_) for a, b_ in zip(state.kv, whole.kv))
    log(f"  prefill of {LM_PROMPT} + {new.shape[1]} steps vs the full forward on "
        f"{seq.shape[1]} tokens: every LIF's words torch.equal {words_same}, state "
        f"torch.equal {state_same}, logits max abs diff {step_err:.3g} (atol {LM_LOGITS_ATOL})")
    check(words_same and state_same, "prefill plus steps: spikes or state differ from the "
          "full forward")
    check(step_err <= LM_LOGITS_ATOL, f"prefill plus steps: logits differ by {step_err:.3g}")
    chunked = execute.decode_state_init(plan.meta, LM_SLOTS)
    for c0 in range(0, LM_PROMPT, LM_CHUNK):
        _, chunked = engine.prefill_chunk(plan, chunked, batch[:, c0:c0 + LM_CHUNK])
    same = all(torch.equal(a, b_) for a, b_ in zip(chunked.kv, state_q.kv))
    log(f"  chunked prefill ({LM_CHUNK}-token chunks) state torch.equal one-shot's: {same}")
    check(same, "chunked prefill state differs from one-shot prefill's")
    _lm_spike_rates("live LM", pre_taps)
    del full_taps, pre_taps, taps, full, whole, state, chunked

    # the kernel route against the plain route on one slot batch: they differ
    # only in the GEMMs' sum order (the LIF, SSA and normalizer are exact or
    # the same ops)
    plain = engine.compile_plan(params, None, cfg, backend="torch", device=dev)
    del params
    _mismatch_rows("LM prefill cuda vs torch", (plain, plan), batch)
    rows = lambda label, limit: _mismatch_rows(label, (plain, plan), batch, end_to_end=True,
                                               limit=limit)
    rows("LM prefill cuda vs torch", E2E_SPIKE_SHARE)
    with torch.inference_mode():
        want = engine.apply(plain, batch).reshape(-1, LM_VOCAB)
    _check_logits("LM prefill cuda vs torch (per token)", logits_q.reshape(-1, LM_VOCAB), want,
                  atol=None)
    _e2e_controls("LM prefill cuda vs torch (per token)",
                  lambda: engine.apply(plan, batch).reshape(-1, LM_VOCAB), want, rows)
    del want
    ref_run = serve_lm_plan(plain, prompts[:LM_SLOTS], slots=LM_SLOTS, max_new=LM_NEW,
                            verbose=False)
    firsts = _first_divergence(live_runs["cuda"]["tokens"][:LM_SLOTS], ref_run["tokens"])
    diff = (live_runs["cuda"]["logits"][:LM_SLOTS] - ref_run["logits"]).abs()
    agree = [LM_NEW if f is None else f for f in firsts]
    common = max(diff[i, :n].max().item() if n else 0.0 for i, n in enumerate(agree))
    log(f"  greedy streams cuda vs torch, one slot batch: first divergence per request "
        f"{firsts} (None: all {LM_NEW} tokens agree); logits max abs diff over the common "
        f"prefix {common:.3g}")
    del plain, ref_run, diff

    # profiles: one prefill and one decode step per kernel route
    tok = batch[:, -1]
    for backend in PATHS:
        p_ = {"cuda": plan, "cuda+packed": pplan}.get(backend) or engine.compile_plan(
            live_lm_params(cfg, dev), None, cfg, backend=backend, device=dev)
        prefill, step = engine.make_prefill_fn(p_), engine.make_decode_step_fn(p_)
        with torch.inference_mode():
            _, st = prefill(p_.params, batch)
        per_prefill = {k: n for k, n in _lm_launches(backend, 1, 0).items() if n}
        per_step = {k: n for k, n in _lm_launches(backend, 0, 1).items() if n}
        times = _profile(f"LM prefill {backend}", lambda: prefill(p_.params, batch), per_prefill)
        step_times = _profile(f"LM decode step {backend}", lambda: step(p_.params, st, tok),
                              per_step)
        for key in PATHS[backend]:
            if key in reports and reports[key].entry["device_ms"] is None:
                reports[key].entry["device_ms"] = times.get(key)
        if backend == "cuda":
            reports["K2 decode"].entry["device_ms"] = step_times.get("K2")
            bound = reports["K2 decode"].entry["bound_ms"]
            log(f"  K2 device time per decode step {step_times.get('K2', float('nan')):.3f} ms "
                f"against its {bound:.3f} ms byte bound")
        del p_, st
    for key, rep in reports.items():
        backend = next(b for b, keys in PATHS.items() if key.split()[0] in keys)
        per = _lm_launches(backend, 0, 1) if key == "K2 decode" else _lm_launches(backend, 1, 0)
        n = runs[backend]["steps"] if key == "K2 decode" else runs[backend]["prefills"]
        rep.entry["launches_per_forward"] = per[key.split()[0]]
        rep.entry["launches"] = n * per[key.split()[0]]
    del plan, pplan
    _long_prefill(dev, smi, cfg)
    fail_if_any("phase 6")
    return runs["cuda"]


def _long_prefill(dev, smi, cfg):
    """One LONG_PREFILL-token prompt (slot batch 1) through the live LM's
    prefill at full width and depth on the three kernel routes: launches
    counted (one prefill), logits finite and ``torch.equal`` across routes,
    ms per prefill (CUDA events, each of 3 after a warm-up) and the route's
    GEMM, SSA and LIF device ms from one profiled prefill, so that the wide
    SSA kernel's share of a long prompt shows.  Then the kernel route against
    the plain route: spike mismatches layer by layer (each layer fed the
    plain plan's input, within MISMATCH_SHARE) and end to end (within
    E2E_SPIKE_SHARE), and the logits' difference reported."""
    from repro_torch import engine
    from repro_torch.launch.serve import live_lm_params

    params = live_lm_params(cfg, dev)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, LONG_PREFILL))).to(dev)
    label, ref = f"{LONG_PREFILL}-token prefill", None
    for backend in PATHS:
        plan = engine.compile_plan(params, None, cfg, backend=backend, device=dev)
        prefill = engine.make_prefill_fn(plan)
        run = lambda: prefill(plan.params, tokens)
        (logits, _), _ = _lm_counted(label, backend, run, lambda _: _lm_launches(backend, 1, 0))
        check(tuple(logits.shape) == (1, LONG_PREFILL, LM_VOCAB)
              and bool(torch.isfinite(logits).all()), f"{label} {backend}: logits "
              f"{tuple(logits.shape)} not finite or misshapen")
        if ref is None:
            ref = logits
        else:
            check(torch.equal(logits, ref), f"{label} {backend}: logits differ from cuda")
        del logits
        ms = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        per = {k: n for k, n in _lm_launches(backend, 1, 0).items() if n}
        times = _profile(f"{label} {backend}", run, per)
        lif, gemm, ssa = PATHS[backend]
        log(f"{label} ({cfg.num_layers} layers at {LM_ARCH} width, slot batch 1, live LM) "
            f"backend={backend}: ms per prefill {', '.join(f'{x:.3f}' for x in ms)} (median "
            f"{sorted(ms)[1]:.3f}); device ms in one profiled prefill: GEMM {gemm} "
            f"{times.get(gemm, float('nan')):.3f}, SSA {ssa} {times.get(ssa, float('nan')):.3f}, "
            f"LIF {lif} {times.get(lif, float('nan')):.3f}; logits torch.equal across routes; "
            f"on {smi}")
        del plan, prefill, run
    plain = engine.compile_plan(params, None, cfg, backend="torch", device=dev)
    plan = engine.compile_plan(params, None, cfg, backend="cuda", device=dev)
    del params
    pair = f"{label} cuda vs torch"
    _mismatch_rows(pair, (plain, plan), tokens)
    _mismatch_rows(pair, (plain, plan), tokens, end_to_end=True, limit=E2E_SPIKE_SHARE)
    with torch.inference_mode():
        want, _ = engine.make_prefill_fn(plain)(plain.params, tokens)
    _check_logits(f"{pair} (per token)", ref.reshape(-1, LM_VOCAB), want.reshape(-1, LM_VOCAB),
                  atol=None)
    del plain, plan, ref, want


def _ms_stats(seconds):
    xs = sorted(1e3 * x for x in seconds)
    if not xs:
        return "none"
    return (f"median {xs[len(xs) // 2]:.3f} ms, max {xs[-1]:.3f} ms over {len(xs)} "
            "admitting ticks")


def _near_ties(label, plan, prompt, stream):
    """The single-stream decode of ``prompt`` (batch-1 prefill, then batch-1
    steps) teacher-forced on ``stream``: the positions where its argmax is not
    the stream's token, with its top-2 margin there.  Fails at a position
    whose margin exceeds LM_LOGITS_ATOL (no near-tie of the head's f32 GEMM
    can explain the difference)."""
    from repro_torch import engine

    prefill, step = engine.make_prefill_fn(plan), engine.make_decode_step_fn(plan)
    dev = plan.meta.device
    out = []
    with torch.inference_mode():
        logits, st = prefill(plan.params, torch.as_tensor(prompt, device=dev).long()[None])
        row = logits[0, -1]
        for j, tok in enumerate(stream):
            if j:
                logits, st = step(plan.params, st, torch.tensor([stream[j - 1]], device=dev))
                row = logits[0]
            if int(row.argmax()) != tok:
                top2 = torch.topk(row, 2).values
                out.append((j, (top2[0] - top2[1]).item()))
    for j, margin in out:
        check(margin <= LM_LOGITS_ATOL, f"{label}: token {j} differs from the single-stream "
              f"decode, whose top-2 margin there is {margin:.3g} (> {LM_LOGITS_ATOL})")
    return out


def phase_continuous(dev, smi, sync_cuda):
    """Continuous serving of the spiking LM at full llama3.2-1b width
    (``ContinuousScheduler`` through ``serve_continuous_plan``) on the live
    LM: the phase-7 workload (CONT_REQUESTS requests, prompt lengths cycled
    over CONT_LENS, ragged ``max_new``) on the three kernel routes with every
    launch counted, and chunked admission on ``cuda``; the streams equal across
    routes and admissions and each equal its single-stream decode (near-ties
    of the head aside); paging, the uniform workload through
    ``serve_spiking_lm_continuous`` against phase 6's ``serve_spiking_lm``,
    the sparse plan's train table, bundling at the smoke width, and the
    readings: tok/s, occupancy, TTFT, stall per tick, the admission's and the
    step's device time per hand kernel, the scatter's time, slot capacity."""
    from repro_torch import engine
    from repro_torch.core import bundling
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.serve import (
        live_lm_params, serve_continuous_plan, serve_spiking_lm_continuous,
        serving_requests, spiking_lm_config)
    from repro_torch.models import spiking_lm as slm

    cfg = spiking_lm_config(LM_ARCH)
    prompts = make_batch(DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=max(CONT_LENS),
                                    global_batch=CONT_REQUESTS), 0)["tokens"]
    requests = lambda: serving_requests(prompts, prompt_lens=CONT_LENS, max_new=LM_NEW,
                                        max_new_spread=CONT_SPREAD)
    want_tokens = sum(r.max_new for r in requests())
    params = live_lm_params(cfg, dev)
    streams, served = {}, {}

    def serve(label, backend, plan, chunk=None):
        run = lambda: serve_continuous_plan(plan, requests(), slots=LM_SLOTS,
                                            max_pending=CONT_PENDING, prefill_chunk=chunk)
        admissions = "prefill_chunks" if chunk else "admitted"
        (done, st), _ = _lm_counted(
            label, backend, run,
            lambda out: _lm_launches(backend, out[1]["warm_prefill_shapes"]
                                     + out[1][admissions], 1 + out[1]["steps"]))
        check(len(done) == CONT_REQUESTS and st["rejected"] == 0
              and st["new_tokens"] == want_tokens,
              f"{label} {backend}: {len(done)} of {CONT_REQUESTS} done, {st['rejected']} "
              f"rejected, {st['new_tokens']} new tokens (want {want_tokens})")
        ttft = sorted(1e3 * r.first_token_s for r in st["requests"])
        log(f"  {label} {backend}: {st['new_tokens'] / st['wall_s']:.2f} tok/s "
            f"({st['new_tokens']} tokens in {st['wall_s']:.3f} s), {st['steps']} steps, slot "
            f"occupancy {st['slot_occupancy']:.3f}, TTFT p50 {np.percentile(ttft, 50):.1f} ms "
            f"p90 {np.percentile(ttft, 90):.1f} ms, prefill_s {st['prefill_s']:.3f}, decode_s "
            f"{st['decode_s']:.3f}, stall per tick {_ms_stats(st['stall_s'])}, "
            f"{st['warm_prefill_shapes']} warm prefill shapes "
            f"({st['prefill_chunks']} chunks); on {smi}")
        return {rid: list(map(int, toks)) for rid, toks in done}

    for backend in PATHS:
        plan = engine.compile_plan(params, None, cfg, backend=backend, device=dev)
        streams[backend] = serve("continuous", backend, plan)
        if backend == "cuda":
            streams["cuda chunked"] = serve(f"continuous, chunk {CONT_CHUNK}", backend, plan,
                                            chunk=CONT_CHUNK)
            ties = []
            for req in requests():
                ties += _near_ties(f"continuous cuda rid {req.rid}", plan, req.prompt,
                                   streams["cuda"][req.rid])
            log(f"  continuous cuda vs the single-stream decode (batch-1 prefill and steps, "
                f"teacher-forced): {len(ties)} of {want_tokens} tokens differ, at top-2 "
                f"margins {[f'{m:.3g}' for _, m in ties]} (each must be <= {LM_LOGITS_ATOL})")
            _paging(plan, prompts)
            _admission_vs_plain(plan, params, cfg, prompts)
            _slot_capacity(plan, smi)
        if backend.endswith("sparse"):
            words = plan.params["embed"]["train_words"]
            plain = dataclasses.replace(plan, meta=dataclasses.replace(
                plan.meta, backend=engine.Backend("torch", packed=True, sparse=True)))
            same = torch.equal(words, bundling.row_train_table(plain))
            log(f"  sparse plan's train table {tuple(words.shape)} torch.equal the plain "
                f"route's encoding-LIF words on all {words.shape[1]} rows: {same}")
            check(same, "the sparse plan's train table differs from the plain encoding LIF's")
        _profile_admission(backend, plan, prompts)
        del plan
        torch.cuda.empty_cache()
    del params
    for key in ("cuda+packed", "cuda+packed+sparse", "cuda chunked"):
        same = streams[key] == streams["cuda"]
        log(f"  continuous streams {key} vs cuda: equal {same}")
        check(same, f"continuous streams of {key} differ from cuda's")
    fail_if_any("phase 7 (continuous)")

    # the uniform workload of phase 6 through the user's entry point
    run = lambda: serve_spiking_lm_continuous(LM_ARCH, num_requests=LM_REQUESTS,
                                              prompt_len=LM_PROMPT, max_new=LM_NEW,
                                              slots=LM_SLOTS, backend="cuda", device=dev,
                                              return_stats=True)
    (done, st), _ = _lm_counted("serve_spiking_lm_continuous", "cuda", run,
                                lambda out: _lm_launches("cuda", 1 + out[1]["admitted"],
                                                         1 + out[1]["steps"]))
    firsts = []
    for rid, toks in done:
        diff = (torch.from_numpy(toks) != sync_cuda["tokens"][rid]).nonzero()
        if len(diff):
            j = int(diff[0])
            top2 = torch.topk(sync_cuda["logits"][rid, j], 2).values
            firsts.append((rid, j, (top2[0] - top2[1]).item()))
    for rid, j, margin in firsts:
        check(margin <= LM_LOGITS_ATOL, f"uniform workload rid {rid}: token {j} differs from "
              f"serve_spiking_lm's, whose top-2 margin there is {margin:.3g}")
    check(len(done) == LM_REQUESTS, f"uniform workload: {len(done)} of {LM_REQUESTS} done")
    cont_tps = st["new_tokens"] / st["wall_s"]
    log(f"  uniform workload ({LM_REQUESTS} requests, prompt {LM_PROMPT}, {LM_NEW} new, "
        f"{LM_SLOTS} slots, cuda): continuous {cont_tps:.2f} tok/s against synchronous "
        f"{sync_cuda['tok_per_s']:.2f} tok/s (phase 6); {st['steps']} steps, occupancy "
        f"{st['slot_occupancy']:.3f}; streams differ from serve_spiking_lm's in "
        f"{len(firsts)} requests {firsts}; on {smi}")

    # bundling at the smoke width, on the kernel route and the plain route
    scfg = spiking_lm_config(f"{LM_ARCH}_smoke")
    sparams = slm.init_spiking_lm(torch.Generator(dev).manual_seed(0), scfg)
    tokens = torch.arange(scfg.vocab_size, device=dev)[None]
    with torch.inference_mode():
        base = engine.apply(engine.compile_plan(sparams, None, scfg, backend="cuda",
                                                device=dev), tokens)
        exact = engine.apply(engine.compile_plan(sparams, None, scfg, backend="cuda",
                                                 device=dev, bundle=0.0), tokens)
    check(torch.equal(base, exact), "compile_plan(bundle=0.0) changes the smoke logits")
    for budget in (0.0, 1e9):
        infos = {b: bundling.bundle(engine.compile_plan(sparams, None, scfg, backend=b,
                                                        device=dev), budget=budget).meta.bundle
                 for b in ("cuda", "torch")}
        log(f"  bundle {scfg.name} budget {budget:g}: cuda {infos['cuda']}, torch "
            f"{infos['torch']}")
        check((infos["cuda"].radius, infos["cuda"].num_bundles)
              == (infos["torch"].radius, infos["torch"].num_bundles),
              f"bundle(budget={budget}) picks another radius on the kernel route")
    log(f"  compile_plan(bundle=0.0) at {scfg.name}: logits torch.equal the unbundled "
        f"plan's: {torch.equal(base, exact)}")
    fail_if_any("phase 7")


def _slot_capacity(plan, smi):
    """``decode_slot_report`` of the plan: its state bytes per slot and the
    slots the card's free memory buys beside the plan's weights."""
    from repro_torch.engine import analysis

    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(plan.meta.device)
    rep = analysis.decode_slot_report(plan, slots=LM_SLOTS, budget_bytes=free,
                                      prompt_lens=CONT_LENS)
    check(rep["state_bytes_per_slot"] == 268_435_456,
          f"state bytes per slot {rep['state_bytes_per_slot']}, expected 268435456")
    log(f"  decode_slot_report: {rep['state_bytes_per_slot']} B of state per slot, "
        f"{rep['state_bytes_batch']} B at {LM_SLOTS} slots, {rep['bytes_per_step_dense']} B "
        f"per step (dense edges and state); max_slots {rep['max_slots']} in the "
        f"{free} B free of {total} beside the plan (the state alone, no activations); on {smi}")


def _paging(plan, prompts):
    """On the live LM at prompt 32: four batch-1 prefills scattered out of
    order equal a 4-row prefill's kv and pos; one decode step from either
    gives equal logits; gather then scatter round-trips; and the scatter's
    time at full width."""
    from repro_torch import engine

    batch = torch.from_numpy(prompts[:LM_SLOTS, :LM_PROMPT]).long().to(plan.meta.device)
    prefill, step = engine.make_prefill_fn(plan), engine.make_decode_step_fn(plan)
    with torch.inference_mode():
        _, want = prefill(plan.params, batch)
        st = engine.decode_state_batch_init(plan.meta, LM_SLOTS)
        for slot in (2, 0, 3, 1):
            _, row = prefill(plan.params, batch[slot:slot + 1])
            st = engine.decode_state_scatter(st, slot, row, 0)
        same = all(torch.equal(a, b) for a, b in zip(st.kv, want.kv)) and \
            st.pos.tolist() == [LM_PROMPT] * LM_SLOTS
        tok = batch[:, -1]
        logits_equal = torch.equal(step(plan.params, st, tok)[0], step(plan.params, want, tok)[0])
        back = engine.decode_state_scatter(st, 1, engine.decode_state_gather(st, 1), 0)
        round_trip = all(torch.equal(a, b) for a, b in zip(back.kv, st.kv)) and \
            torch.equal(back.pos, st.pos)
        ms = time_ms(lambda: engine.decode_state_scatter(st, 1, row, 0), reps=10, warmup=2)
    log(f"  paging at prompt {LM_PROMPT}: four batch-1 prefills scattered (slots 2, 0, 3, 1) "
        f"torch.equal a {LM_SLOTS}-row prefill's kv and pos: {same}; one decode step's logits "
        f"torch.equal: {logits_equal}; gather then scatter round-trips: {round_trip}")
    log(f"  decode_state_scatter at full width ({2 * sum(x.numel() * 4 for x in st.kv)} B "
        f"copied): {ms:.3f} ms (CUDA events, mean of 10)")
    check(same and logits_equal and round_trip, "paging: scattered state, its step or the "
          "gather round trip differs")


def _admission_vs_plain(plan, params, cfg, prompts):
    """The kernel route's admission shapes held against the plain route on the
    live LM: one batch-1 admission at the longest prompt, each layer fed the
    plain plan's input and each plan on its own, and the same prompt admitted
    in CONT_CHUNK-token chunks (its ragged last chunk among them): the chunked
    state ``torch.equal`` the one-shot state on the kernel route, and the last
    chunk's logits against the plain route's one-shot logits."""
    from repro_torch import engine

    dev = plan.meta.device
    n = max(CONT_LENS)
    prompt = torch.from_numpy(prompts[:1, :n]).long().to(dev)
    plain = engine.compile_plan(params, None, cfg, backend="torch", device=dev)
    label = f"admission (batch 1, {n} tokens) cuda vs torch"
    _mismatch_rows(label, (plain, plan), prompt)
    _mismatch_rows(label, (plain, plan), prompt, end_to_end=True, limit=E2E_SPIKE_SHARE)
    logits, state = engine.prefill(plan, prompt)
    want, _ = engine.prefill(plain, prompt)
    _check_logits(label, logits[0], want[0], atol=E2E_LOGITS_ATOL)
    chunked = engine.decode_state_init(plan.meta, 1)
    sizes = []
    for c0 in range(0, n, CONT_CHUNK):
        last, chunked = engine.prefill_chunk(plan, chunked, prompt[:, c0:c0 + CONT_CHUNK])
        sizes.append(last.shape[1])
    same = all(torch.equal(a, b) for a, b in zip(chunked.kv, state.kv)) and \
        int(chunked.pos) == n
    log(f"  {n}-token admission in chunks {sizes} on cuda: state torch.equal the one-shot "
        f"prefill's: {same}")
    check(same, f"chunked admission ({sizes}): state differs from the one-shot prefill's")
    _check_logits(f"last chunk ({sizes[-1]} tokens) cuda vs the torch route's one-shot "
                  "prefill", last[0], want[0, -sizes[-1]:], atol=E2E_LOGITS_ATOL)
    del plain


def _profile_admission(backend, plan, prompts):
    """One batch-1 admission at the longest prompt and one step of the slot
    batch under ``torch.profiler``: each hand kernel's device time."""
    from repro_torch import engine

    prefill, step = engine.make_prefill_fn(plan), engine.make_decode_step_fn(plan)
    dev = plan.meta.device
    prompt = torch.from_numpy(prompts[:1, :max(CONT_LENS)]).long().to(dev)
    with torch.inference_mode():
        _, st = prefill(plan.params, torch.from_numpy(prompts[:LM_SLOTS, :LM_PROMPT]).long()
                        .to(dev))
    tok = torch.zeros((LM_SLOTS,), dtype=torch.long, device=dev)
    want = lambda p, s: {k: n for k, n in _lm_launches(backend, p, s).items() if n}
    _profile(f"admission (batch 1, {max(CONT_LENS)} tokens) {backend}",
             lambda: prefill(plan.params, prompt), want(1, 0))
    _profile(f"{LM_SLOTS}-slot decode step {backend}", lambda: step(plan.params, st, tok),
             want(0, 1))


# -- the LIF kernels in bf16 (phase 2) ------------------------------------------------

def _lif_bf16(dev, gen):
    """K1 (+IAND), K4 (+IAND) and K7 on bf16 drives at the 8-384 main path's
    LIF shapes (slot batch 8; K7 at the training batch's), each ``torch.equal``
    its plain version in bf16 (every chain_len 1/2/4 x reset x IAND on the
    largest shape), timed per forward (K7 per training step) beside its byte
    bound: 2 bytes an element read or written."""
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.lif_parallel.ref import (
        lif_pack_ref, lif_parallel_ref, lif_parallel_ref_grad)
    from repro_torch.launch.timing import LIF_T as t, VISION_LIFS

    src = "src/repro_torch/kernels/lif_parallel/csrc/lif_parallel.cu"
    tpu = "src/repro/kernels/lif_parallel/kernel.py:{}"
    reps = {"K1": KernelReport("lif_parallel bf16", src, tpu.format(144)),
            "K4": KernelReport("lif_pack bf16", src, tpu.format(174)),
            "K7": KernelReport("lif_parallel_bwd bf16", src, tpu.format(211))}
    fwd_cases = [(SLOTS * n, iand, count) for n, iand, count, _ in VISION_LIFS]
    bwd_cases = [(TRAIN_BATCH * n, count) for n, _, count, _ in VISION_LIFS]
    big = max(n for n, _ in bwd_cases)
    drive = torch.randn((t, big), generator=gen).to(dev)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8      # membranes exactly on theta too
    drive = drive.bfloat16()
    cot = (torch.randn((t, big), generator=gen) * 0.5).to(dev).bfloat16()
    skip = (torch.rand((t, big), generator=gen) > 0.5).to(dev).bfloat16()
    skip_words = packing.pack(skip.float()).words
    n0 = fwd_cases[0][0]
    part = lambda a, n: a[:, :n].contiguous()
    x, sk, skw, g = (part(a, n0) for a in (drive, skip, skip_words, cot))
    bad = []
    for reset in ("hard", "soft"):
        for chain in (1, 2, 4):
            kw = dict(chain_len=chain, lam=0.25, theta=0.5, reset=reset)
            for iand in (False, True):
                if not torch.equal(lif_ops.lif_parallel_fwd(x, skip=sk if iand else None, **kw),
                                   lif_parallel_ref(x, skip=sk if iand else None, **kw)):
                    bad.append(f"K1 reset={reset} chain_len={chain} iand={iand}")
                if not torch.equal(
                        lif_ops.lif_parallel_pack_fwd(x, skip_words=skw if iand else None, **kw),
                        lif_pack_ref(x, skip_words=skw if iand else None, **kw)):
                    bad.append(f"K4 reset={reset} chain_len={chain} iand={iand}")
            if not torch.equal(lif_ops.lif_parallel_bwd(x, g, **kw),
                               lif_parallel_ref_grad(x, g, chain_len=chain, reset=reset)):
                bad.append(f"K7 reset={reset} chain_len={chain}")
    check(not bad, f"bf16 LIF kernels differ from their plain versions: {bad}")
    log(f"K1, K4, K7 in bf16: torch.equal their plain versions (bf16 eager PyTorch) at N={n0} "
        "for reset x chain_len 1/2/4 x IAND")
    kw = dict(chain_len=t, lam=0.25, theta=0.5, reset="hard")
    for n, iand, count in fwd_cases:
        x, sk, skw = part(drive, n), (part(skip, n) if iand else None), (
            part(skip_words, n) if iand else None)
        run = lambda: lif_ops.lif_parallel_fwd(x, skip=sk, **kw)
        plain = lambda: lif_parallel_ref(x, skip=sk, **kw)
        check(torch.equal(run(), plain()), f"K1 bf16 N={n}: not equal to the plain version")
        reps["K1"].add(f"N={n} iand={iand}", count, 0.0, time_ms(run), time_ms(plain),
                       2 * t * n * (3 if iand else 2), 5 * t * n, peak=F32_FLOP_PER_S)
        run = lambda: lif_ops.lif_parallel_pack_fwd(x, skip_words=skw, **kw)
        plain = lambda: lif_pack_ref(x, skip_words=skw, **kw)
        check(torch.equal(run(), plain()), f"K4 bf16 N={n}: not equal to the plain version")
        reps["K4"].add(f"N={n} iand={iand}", count, 0.0, time_ms(run), time_ms(plain),
                       2 * t * n + 4 * n * (2 if iand else 1), 5 * t * n, peak=F32_FLOP_PER_S)
    for n, count in bwd_cases:
        x, g = part(drive, n), part(cot, n)
        run = lambda: lif_ops.lif_parallel_bwd(x, g, **kw)
        plain = lambda: lif_parallel_ref_grad(x, g, chain_len=t)
        check(torch.equal(run(), plain()), f"K7 bf16 N={n}: not equal to the plain version")
        reps["K7"].add(f"N={n}", count, 0.0, time_ms(run), time_ms(plain, reps=5), 6 * t * n,
                       20 * t * n, peak=F32_FLOP_PER_S)
    del drive, cot, skip, skip_words
    return reps


def _lif_bf16_path(dev, gen, reps):
    """The bf16 forms' path: the neuron dispatch ``core.lif.lif`` on the kernel
    route with bf16 drives -- every LIF of one 8-384 forward (slot batch 8;
    dense, then packed) and of one training step's backward (batch 16, by
    autograd through ``lif``) -- with the launch counters set to 0 just
    before and read just after: 60 K1, 60 K4 and 60 K7."""
    from repro_torch.core import packing
    from repro_torch.core.lif import lif
    from repro_torch.launch.timing import LIF_T as t, VISION_LIFS

    per_image = [(n, iand) for n, iand, count, _ in VISION_LIFS for _ in range(count)]
    fwd = [(SLOTS * n, iand) for n, iand in per_image]
    bwd = [TRAIN_BATCH * n for n, _ in per_image]
    drive = torch.randn((t, max(bwd)), generator=gen).to(dev).bfloat16()
    skip = (torch.rand((t, max(n for n, _ in fwd)), generator=gen) > 0.5).to(dev).bfloat16()
    skip_words = packing.PackedSpikes(packing.pack(skip.float()).words, t)
    def forward():
        for n, j in fwd:
            out = lif(drive[:, :n], use_kernel=True, iand_skip=skip[:, :n] if j else None)
            check(out.dtype == torch.bfloat16, f"bf16 lif returned {out.dtype}")
            lif(drive[:, :n], use_kernel=True, pack_output=True,
                iand_skip=packing.PackedSpikes(skip_words.words[:, :n], t) if j else None)

    def step():
        for n in bwd:
            x = drive[:, :n].clone().requires_grad_(True)
            with torch.enable_grad():
                (dx,) = torch.autograd.grad(lif(x, use_kernel=True), x, torch.ones_like(x))
            check(dx.dtype == torch.bfloat16, f"bf16 lif backward returned {dx.dtype}")

    counters = _counters()
    for f in counters.values():
        f.launches = 0
    forward()
    step()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(K1=len(fwd) + len(bwd), K4=len(fwd), K7=len(bwd))
    check(launches == want, f"bf16 lif path: launches {launches}, expected {want}")
    log(f"bf16 lif path (core.lif.lif, kernel route, one 8-384 forward dense and packed and "
        f"one training step's LIFs with their backward): launches {launches}")
    for key, rep in reps.items():
        rep.entry["launches"] = launches[key]
        rep.entry["launches_per_forward"] = launches[key] / (1 + (key == "K1"))
    # device time: K1 and K4 of the forward, K7 of the step (each run profiled
    # after a traced warm-up run, as every route's forward is)
    fwd_ms = _profile("bf16 lif path forward", forward, {"K1": len(fwd), "K4": len(fwd)})
    step_ms = _profile("bf16 lif path step", step, {"K1": len(bwd), "K7": len(bwd)},
                       inference=False)
    for key, times in (("K1", fwd_ms), ("K4", fwd_ms), ("K7", step_ms)):
        reps[key].entry["device_ms"] = times.get(key)
        log(f"  bf16 {key} device ms per {'step' if key == 'K7' else 'forward'} on the path "
            f"{times.get(key, float('nan')):.4f} against a {reps[key].entry['bound_ms']:.4f} "
            f"ms byte bound ({reps[key].entry['bound_ms'] / times.get(key, float('nan')):.1%})")


# -- K1 and K4 over the edges of their design (phase 2) -------------------------------

LIF_EDGE_STEPS = (1, 4, 32, 33, 40)        # one step, the unrolled T, words full and ragged
LIF_EDGE_CHAINS = (1, 2, 3, 4, 8)
LIF_EDGE_N = 8 * 129                       # columns, plus 0...7: every residue of VEC
LIF_EDGE_OCC = (48, 96, 192, 200, 384, 1536, 2048, 130)   # map row widths D
LIF_EDGE_ROWS = 5                          # rows of D: a partial last warp at D = 384


def _lif_edges(dev, gen):
    """K1 and K4 (with and without its occupancy map) ``torch.equal`` their
    plain versions over the edges of the vector design, each call one
    launch: f32 and bf16; T of LIF_EDGE_STEPS (T = 4 the unrolled body, the
    rest the chunked loop); every chain_len of LIF_EDGE_CHAINS that divides T;
    hard and soft reset; IAND off and on; N = LIF_EDGE_N + 0...7 (every
    residue of the 4 f32 and 8 bf16 columns a thread: the wide body where
    N allows it, else the scalar one; the plain versions once on the widest
    drive, each launch held against its first N columns) and a drive (and
    skip) at a one-element offset (the scalar body); then K4's map of LIF_EDGE_ROWS rows
    of each D in LIF_EDGE_OCC (a third of the rows silent: zero tiles), T 4
    and 33, IAND off and on, both dtypes, also at an offset, each map equal
    to ``packing.occupancy_map`` of the plain words.  Logs the bodies taken
    (``ops.forward_body``)."""
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.lif_parallel.ref import lif_pack_ref, lif_parallel_ref

    t0 = time.perf_counter()
    bodies, bad, calls = {}, [], 0
    counters = (lif_ops.lif_parallel_fwd, lif_ops.lif_parallel_pack_fwd)
    before = [f.launches for f in counters]

    def operands(t, n, dtype, offset):
        """A (t, n) drive (a third on the 1/8 grid: membranes on theta), a
        dense skip and skip words, each at ``offset`` elements into its buffer."""
        def at(x):
            buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
            view = buf[offset:].view(x.shape)
            view.copy_(x)
            return view

        drive = torch.randn((t, n), generator=gen).to(dev)
        drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8
        spikes = (torch.rand((t, n), generator=gen) > 0.5).to(dev)
        return (at(drive.to(dtype)), at(spikes.to(dtype)),
                at(packing.pack(spikes.float()).words))

    def body(x, *others, occ_cols=0):
        key = lif_ops.forward_body(x.dtype, x.shape[1], [a.data_ptr() for a in (x, *others)],
                                   occ_cols)
        bodies[key] = bodies.get(key, 0) + 1

    # the plain versions run once on the widest drive: the LIF is independent
    # across columns, so a launch of the first n columns is held against the
    # plain result's first n columns
    widths = [LIF_EDGE_N + r for r in range(8)]
    for dtype in (torch.float32, torch.bfloat16):
        for t in LIF_EDGE_STEPS:
            for chain in (c for c in LIF_EDGE_CHAINS if t % c == 0):
                for offset in (0, 1):
                    ns = widths if offset == 0 else [LIF_EDGE_N]
                    xw, skip, skw = operands(t, ns[-1], dtype, offset)
                    cut = ((lambda a, n: a[:, :n].contiguous()) if offset == 0 else
                           (lambda a, n: a))       # at an offset: the operands as made
                    for reset in ("hard", "soft"):
                        kw = dict(chain_len=chain, lam=0.25, theta=0.5, reset=reset)
                        for iand in (False, True):
                            sk, sw = (skip, skw) if iand else (None, None)
                            spikes = lif_parallel_ref(xw, skip=sk, **kw)
                            words = lif_pack_ref(xw, skip_words=sw, **kw)
                            for n in ns:
                                x = cut(xw, n)
                                skn, swn = (cut(sk, n), cut(sw, n)) if iand else (None, None)
                                label = (f"{dtype} T={t} chain_len={chain} N={n} "
                                         f"offset={offset} {reset} iand={iand}")
                                if not torch.equal(lif_ops.lif_parallel_fwd(x, skip=skn, **kw),
                                                   spikes[:, :n]):
                                    bad.append(f"K1 {label}")
                                if not torch.equal(
                                        lif_ops.lif_parallel_pack_fwd(x, skip_words=swn, **kw),
                                        words[:, :n]):
                                    bad.append(f"K4 {label}")
                                body(x, *([skn] if iand else []))
                                calls += 2
        for d in LIF_EDGE_OCC:
            for t in (4, 33):
                n = LIF_EDGE_ROWS * d
                for offset in (0, 1):
                    x, _, skw = operands(t, n, dtype, offset)
                    x.view(t, LIF_EDGE_ROWS, d)[:, ::3] -= 9.0   # silent rows: zero tiles
                    kw = dict(chain_len=t, lam=0.25, theta=0.5, reset="hard")
                    for iand in (False, True):
                        sw = skw if iand else None
                        words, occ = lif_ops.lif_parallel_pack_fwd(x, skip_words=sw, occ_cols=d,
                                                                   **kw)
                        want = lif_pack_ref(x, skip_words=sw, **kw)
                        if not (torch.equal(words, want) and torch.equal(
                                occ, packing.occupancy_map(want.reshape(-1, LIF_EDGE_ROWS, d)))):
                            bad.append(f"K4+map {dtype} D={d} T={t} offset={offset} iand={iand}")
                        body(x, *([sw] if iand else []), occ_cols=d)
                        calls += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launched = sum(f.launches - b for f, b in zip(counters, before))
    check(launched == (calls if dev.type == "cuda" else 0),
          f"K1/K4 edges: {launched} launches for {calls} calls")
    check(not bad, f"K1/K4 differ from their plain versions at {len(bad)} edge case(s): "
          f"{bad[:12]}")
    log(f"K1, K4 (+ occupancy map) over their edges: {calls} calls, {launched} launches, "
        f"{len(bad)} differ from the plain versions; bodies (vec, map summed in the warp): "
        + ", ".join(f"{k}: {v}" for k, v in sorted(bodies.items()))
        + f"; {time.perf_counter() - t0:.1f} s")


# -- K3, K6, K9 past M * Dh = 2^24 (phase 2) --------------------------------------------

PAST_EDGE_LEN = 2 ** 24 // LM_DH + 256    # 33,024 tokens: key ranges of 32,704 and 320
PAST_EDGE_ROWS = 1024                      # query rows per plain-version chunk


def _near_ones(gen, shape, dev, zero_q=False):
    """Spikes that are almost all ones (the largest sums): one q feature in
    64 at random, or one entry in 512 at random, zero."""
    x = torch.ones(shape, device=dev)
    if zero_q:
        x[..., ::64] = (torch.rand(x[..., ::64].shape, generator=gen) > 0.5).float().to(dev)
    else:
        x[(torch.rand(shape, generator=gen) < 1 / 512).to(dev)] = 0.0
    return x


def _ssa_past_edge(dev, gen):
    """K3, K6 and K9 at the LM's head dim past the 2^24 edge: a causal
    PAST_EDGE_LEN-token prompt of one sequence (K3: G = T*H = 16; K6, K9: G =
    H = 4 folds of T = 4 planes), near-all-ones spikes, so the sums past 2^24
    round.  Every output row is held ``torch.equal`` to the plain version,
    which runs the same key ranges in PAST_EDGE_ROWS-row slices of the queries
    (``q0``) so that its scores fit; the kernel is timed beside the plain
    version's slices and its bound (the causal triangle's operations on the
    tensor cores).  No single PyTorch call computes the function at this size
    (the f16 ``torch.bmm`` pair's scores would take 70 GB): library_ms null."""
    from repro_torch.core import packing
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import (
        key_range, packed_ssa_ref, sparse_packed_ssa_ref, ssa_ref)

    t, h, dh, s = 4, LM_HEADS, LM_DH, PAST_EDGE_LEN
    src = "src/repro_torch/kernels/spiking_attention/csrc/ssa.cu"
    tpu = "src/repro/kernels/spiking_attention/kernel.py:{}"
    q = _near_ones(gen, (t * h, s, dh), dev, zero_q=True)
    k = torch.ones((t * h, s, dh), device=dev)
    v = _near_ones(gen, (t * h, s, dh), dev)
    words = [packing.pack(x.reshape(t, h, s, dh)).words for x in (q, k, v)]
    live = ssa_ops._plane_liveness(*words, t)
    pairs = s * (s + 1) // 2
    cases = {
        "K3": ("ssa", 62, lambda: ssa_ops.ssa_fwd(q, k, v, scale=0.125, causal=True),
               lambda a, b: ssa_ref(q[:, a:b], k, v, causal=True, q0=a),
               4 * 4 * t * h * s * dh),
        "K6": ("packed_ssa", 164,
               lambda: ssa_ops.packed_ssa_fwd(*words, t=t, scale=0.125, causal=True),
               lambda a, b: packed_ssa_ref(words[0][:, :, a:b], *words[1:], t=t, causal=True,
                                           q0=a),
               4 * 3 * h * s * dh + 4 * t * h * s * dh),
        "K9": ("sparse_packed_ssa", 139,
               lambda: ssa_ops.sparse_packed_ssa_fwd(*words, live, t=t, scale=0.125,
                                                     causal=True),
               lambda a, b: sparse_packed_ssa_ref(words[0][:, :, a:b], *words[1:], live, t=t,
                                                  causal=True, q0=a),
               4 * 3 * h * s * dh + 4 * t * h * s * dh)}
    reps, rounded = {}, None
    for key, (name, line, run, plain, nbytes) in cases.items():
        rep = KernelReport(f"{name}@{LM_ARCH} past 2^24", src, tpu.format(line))
        got = run()
        torch.cuda.synchronize()
        if key == "K3":
            got = got.reshape(t, h, s, dh)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        same, plain_ms = True, 0.0
        for a in range(0, s, PAST_EDGE_ROWS):
            b = min(s, a + PAST_EDGE_ROWS)
            start.record()
            want = plain(a, b)
            end.record()
            torch.cuda.synchronize()
            plain_ms += start.elapsed_time(end)
            same &= torch.equal(got[:, :, a:b], want.reshape(t, h, b - a, dh))
            del want
        check(same, f"{key} past 2^24 (N = M = {s}, Dh = {dh}): not equal to the plain version")
        if rounded is None:        # outputs whose sum passed 2^24 (odd ones are rounded)
            rounded = int((got[:, :, 2 ** 24 // dh:] / 0.125 > 2 ** 24).sum())
        ms = time_ms(run, reps=3, warmup=1)
        rep.add(f"G={t * h if key == 'K3' else h} N=M={s} Dh={dh} causal, two key ranges "
                f"({key_range(s, dh)} + {s - key_range(s, dh)})", 1, 0.0, ms, plain_ms,
                nbytes, 4 * t * h * pairs * dh)
        reps[key] = rep
        del got
    log(f"K3, K6, K9 past M*Dh = 2^24 (N = M = {s}, Dh = {dh}, causal, near-all-ones): every "
        f"row torch.equal the plain version (range split, {PAST_EDGE_ROWS}-row slices); "
        f"{rounded} outputs of the rows past {2 ** 24 // dh} keys exceed 2^24 / 0.125")
    check(rounded > 0, "past 2^24: no output passed 2^24, so no range addition rounded")
    del q, k, v, words, live
    return reps


# -- phase 8: a prompt past the 2^24 edge through the LM's prefill ----------------------

LONG_LAYERS = 2     # depth of the long-prompt LM (full llama3.2-1b width)


def phase_long_prompt(dev, smi, past_reps):
    """The spiking LM at llama3.2-1b width, depth cut to LONG_LAYERS, prefills
    one PAST_EDGE_LEN-token prompt (past M * Dh = 2^24 at Dh 512, where the
    quadratic ordering's K3/K6/K9 sum two key ranges) on the three kernel
    routes, every launch counted, and on ``cuda`` with the linear ordering
    (no SSA kernel: the K^T V state in plain PyTorch): logits and state
    ``torch.equal`` across routes and orderings.  Sets the launches of the
    past-edge entries."""
    from repro_torch import engine
    from repro_torch.launch.serve import live_lm_params, spiking_lm_config

    cfg = spiking_lm_config(LM_ARCH).replace(num_layers=LONG_LAYERS)
    params = live_lm_params(cfg, dev)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, PAST_EDGE_LEN))).to(dev)
    ref, launches = None, {}
    for backend, ordering in (("cuda", "linear"), ("cuda", "quadratic"),
                              ("cuda+packed", "quadratic"), ("cuda+packed+sparse", "quadratic")):
        plan = engine.compile_plan(params, None, cfg, backend=backend, ordering=ordering,
                                   device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        counters = _counters()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        logits, state = engine.prefill(plan, tokens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters.items()}
        want = _lm_launches(backend, 1, 0, ordering=ordering, layers=LONG_LAYERS)
        check(got == want, f"long prompt {backend} {ordering}: launches {got}, expected {want}")
        check(tuple(logits.shape) == (1, PAST_EDGE_LEN, LM_VOCAB)
              and bool(torch.isfinite(logits).all()), f"long prompt {backend} {ordering}: "
              f"logits {tuple(logits.shape)} not finite or misshapen")
        if ref is None:
            ref = (logits, state)
            same = "the reference"
        else:
            same = (torch.equal(logits, ref[0]) and int(state.pos) == int(ref[1].pos)
                    and all(torch.equal(a, b) for a, b in zip(state.kv, ref[1].kv)))
            check(same, f"long prompt {backend} {ordering}: logits or state differ from cuda "
                  "linear")
            same = f"torch.equal cuda linear: {same}"
        if ordering == "quadratic":
            launches[backend] = got
        log(f"long prompt ({PAST_EDGE_LEN} tokens, {LONG_LAYERS} layers at {LM_ARCH} width) "
            f"{backend} {ordering}: prefill {seconds:.3f} s ({PAST_EDGE_LEN / seconds:.0f} "
            f"tok/s), launches {got}, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB; logits and state "
            f"{same}; on {smi}")
        del plan, logits, state
    del ref, params
    for key, backend in (("K3", "cuda"), ("K6", "cuda+packed"), ("K9", "cuda+packed+sparse")):
        past_reps[key].entry["launches"] = launches[backend][key]
        past_reps[key].entry["launches_per_forward"] = launches[backend][key]
    fail_if_any("phase 8")


# -- phase 9: the 8-bit bitplane input on the spike GEMM --------------------------------

def phase_bitplane(dev, smi):
    """The paper's bitplane input (Sec. III-A) at the 8-384's encoding conv:
    ``core.encoding.bitplane_conv`` on a slot batch of 224 x 224 uint8 images
    with the kernel route's 3x3 spike conv (K2 on im2col patches of the 8
    planes, one launch, counted) and the live model's folded encoding weights.
    Held against the same function over the plain GEMM (on the encoding
    drive, the output over 255: GEMM_TOL) and reported against the direct
    cuDNN conv of the image (TF32 off); the encoding LIF's spikes (maxpool, T
    = 4) of the two sum orders compared.  Returns K2's report at this shape
    (library_ms: cuDNN on the same 8 B binary planes)."""
    from repro_torch.core import encoding
    from repro_torch.core import nn as cnn
    from repro_torch.core.lif import lif
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.launch.serve import live_model

    plan, _ = live_model(ARCH, SLOTS, "cuda", dev)
    enc = plan.params["tokenizer"][0]                     # {"w": (3, 3, 3, 48), "b": (48,)}
    w, bias = enc["w"], enc["b"]
    cout = w.shape[-1]
    gen = torch.Generator().manual_seed(9)
    image = torch.randint(0, 256, (SLOTS, 224, 224, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
    spike_conv = lambda p, x: mm_ops.conv3x3_op(x, p["w"])
    plain_conv = lambda p, x: mm_ops.spike_matmul_ref(mm_ops._im2col(x, 3), p["w"].reshape(
        -1, cout)).reshape(tuple(x.shape[:3]) + (cout,))
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    got = encoding.bitplane_conv(spike_conv, {"w": w}, image)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want_launches = dict.fromkeys(counters, 0)
    want_launches["K2"] = 1
    check(launches == want_launches, f"bitplane_conv: launches {launches}, expected "
          f"{want_launches}")
    plain = encoding.bitplane_conv(plain_conv, {"w": w}, image)
    direct = cnn.conv_apply({"w": w}, image.float())
    drives = {"bitplane over K2": got / 255 + bias, "bitplane over the plain GEMM":
              plain / 255 + bias, "direct cuDNN conv": cnn.conv_apply(enc, image.float() / 255)}
    err = (drives["bitplane over K2"] - drives["bitplane over the plain GEMM"]).abs().max().item()
    check(bool(torch.allclose(drives["bitplane over K2"], drives["bitplane over the plain GEMM"],
                              **GEMM_TOL)),
          f"bitplane_conv over K2 vs over the plain GEMM: max abs err {err:.3g} on the "
          f"encoding drive, outside {GEMM_TOL}")
    log(f"bitplane_conv ({SLOTS} x 224 x 224 uint8, 8 planes, one K2 launch of "
        f"{8 * SLOTS * 224 * 224} rows x 27 x {cout}): vs the plain GEMM max abs err "
        f"{(got - plain).abs().max().item():.3g} on the output, {err:.3g} on the encoding "
        f"drive (GEMM_TOL); vs the direct cuDNN conv of the image max abs "
        f"{(got - direct).abs().max().item():.3g} (output), "
        f"{(drives['bitplane over K2'] - drives['direct cuDNN conv']).abs().max().item():.3g} "
        "(drive), reported")
    pooled = {k: cnn.maxpool(y) for k, y in drives.items()}
    spikes = {k: lif(y[None].expand((4,) + tuple(y.shape)), use_kernel=True)
              for k, y in pooled.items()}
    total = spikes["direct cuDNN conv"].numel()
    for a, b in (("bitplane over K2", "direct cuDNN conv"),
                 ("bitplane over K2", "bitplane over the plain GEMM"),
                 ("bitplane over the plain GEMM", "direct cuDNN conv")):
        flips = int((spikes[a] != spikes[b]).sum())
        log(f"  encoding LIF spikes, {a} vs {b}: {flips} of {total} differ ({flips / SLOTS:.1f} "
            f"of {total // SLOTS} per image; PERF.md records 123 of 2.4 M for cuDNN vs im2col)")
    planes = encoding.to_bitplanes(image).reshape(-1, 224, 224, 3)
    cols, w2 = mm_ops._im2col(planes, 3), w.reshape(-1, cout).contiguous()
    m = cols.shape[0]
    rep = KernelReport("spike_matmul@bitplane", "src/repro_torch/kernels/spike_matmul/csrc/"
                       "spike_matmul.cu", "src/repro/kernels/spike_matmul/kernel.py:164")
    rep.add(f"{m}x27x{cout} (8 planes x {SLOTS} images)", 1,
            (mm_ops.spike_matmul_fwd(cols, w2) - mm_ops.spike_matmul_ref(cols, w2)).abs()
            .max().item(), time_ms(lambda: mm_ops.spike_matmul_fwd(cols, w2)),
            time_ms(lambda: mm_ops.spike_matmul_ref(cols, w2)),
            4 * (m * 27 + 27 * cout + m * cout), GEMM_PIECES * 2 * m * 27 * cout,
            library_ms=time_ms(lambda: cnn.conv_apply({"w": w}, planes)))
    rep.entry["launches"] = launches["K2"]
    rep.entry["launches_per_forward"] = launches["K2"]
    whole = time_ms(lambda: encoding.bitplane_conv(spike_conv, {"w": w}, image))
    plain_ms = time_ms(lambda: encoding.bitplane_conv(plain_conv, {"w": w}, image))
    one_conv = time_ms(lambda: cnn.conv_apply({"w": w}, image.float()))
    log(f"  bitplane_conv over K2, the whole function (planes, im2col, K2, recombination): "
        f"{whole:.3f} ms; over the plain GEMM {plain_ms:.3f} ms; one direct cuDNN conv of the "
        f"{SLOTS} images (TF32 off) {one_conv:.3f} ms; on {smi}")
    del plan, image, got, plain, direct, drives, pooled, spikes, planes, cols
    fail_if_any("phase 9")
    return rep


# -- phase 10: the graph checks at full width on the kernel routes ----------------------

GRAPH_PROMPTS = (24, 37)   # prompt lengths that collide with no model dim (the reference's)
GRAPH_CHUNK = 5


def _kernel_counts(hist):
    """Hand-kernel launches a recorded call reported, by K number (each
    wrapper reports under its own name)."""
    return {key: hist[f"kernel.{fn.__name__}"] for key, fn in _counters().items()}


def phase_graph_checks(dev):
    """``engine.analysis``'s graph checks on the kernel routes at full width,
    each with the hand-kernel launches the recorder saw held to the route's
    counts: no BatchNorm in the 8-384 deploy graph (the train-mode graph has
    one per BN layer); no RMSNorm layer in the llama3.2-1b plan (the oracle
    forward counts 6 per block + 2); the decode step after a 24-token prompt
    and a 5-token prefill chunk after a 37-token one carry no axis of the
    prompt length (the full re-scoring forward does)."""
    from repro_torch import engine
    from repro_torch.configs.spike_iand_former import get_vision_config
    from repro_torch.core import spikformer as sf
    from repro_torch.engine import analysis
    from repro_torch.launch.serve import live_lm_params, live_model, spiking_lm_config
    from repro_torch.models import spiking_lm as slm

    vcfg = get_vision_config(ARCH)
    for backend in PATHS:
        plan, images = live_model(ARCH, 2, backend, dev)
        fn = engine.make_apply_fn(plan)
        bn = analysis.bn_op_count(fn, plan.params, images)
        seen = _kernel_counts(analysis.op_histogram(fn, plan.params, images))
        want = _per_forward(vcfg.num_layers, backend)
        check(bn == 0 and seen == want, f"8-384 deploy graph {backend}: {bn} BN ops, kernels "
              f"seen {seen}, expected {want}")
        log(f"graph 8-384 deploy {backend}: {bn} BN-signature ops; hand-kernel launches "
            f"recorded {seen}")
        del plan
    params, state = sf.init(torch.Generator().manual_seed(0), vcfg, device=dev)
    bn_train = analysis.bn_op_count(
        lambda p, s_, x: sf.apply(p, s_, x, vcfg, train=True)[0], params, state, images)
    n_bn = 4 + 6 * vcfg.num_layers
    check(bn_train == n_bn, f"train-mode 8-384 graph: {bn_train} BN ops, expected {n_bn}")
    log(f"graph 8-384 train mode (the negative case): {bn_train} BN-signature ops (one per BN "
        f"layer: {n_bn})")
    del params, state, images

    cfg = spiking_lm_config(LM_ARCH)
    params = live_lm_params(cfg, dev)
    rng = np.random.default_rng(10)
    toks = lambda s: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s))).to(dev)
    oracle = analysis.rmsnorm_op_count(
        lambda p, tk: slm.forward(p, {"tokens": tk}, cfg), params, toks(8))
    n_rms = 6 * cfg.num_layers + 2
    check(oracle == n_rms, f"oracle LM forward: {oracle} RMSNorm layers, expected {n_rms}")
    short, long_ = GRAPH_PROMPTS
    for backend in PATHS:
        plan = engine.compile_plan(params, None, cfg, backend=backend, device=dev)
        apply_fn = engine.make_apply_fn(plan)
        rms = analysis.rmsnorm_op_count(apply_fn, plan.params, toks(8))
        step = engine.make_decode_step_fn(plan)
        _, state = engine.prefill(plan, toks(short))
        tok = toks(1)[:, 0]
        dims = analysis.op_dims(step, plan.params, state, tok)
        seen = _kernel_counts(analysis.op_histogram(step, plan.params, state, tok))
        want = _lm_launches(backend, 0, 1)
        chunk = engine.make_prefill_chunk_fn(plan)
        _, state = engine.prefill(plan, toks(long_))
        cdims = analysis.op_dims(chunk, plan.params, state, toks(GRAPH_CHUNK))
        cseen = _kernel_counts(analysis.op_histogram(chunk, plan.params, state,
                                                     toks(GRAPH_CHUNK)))
        cwant = _lm_launches(backend, 1, 0)
        check(rms == 0, f"LM plan {backend}: {rms} RMSNorm layers")
        check(short not in dims and seen == want, f"decode step {backend}: prompt axis "
              f"{short} in its graph {short in dims}, kernels seen {seen}, expected {want}")
        check(long_ not in cdims and GRAPH_CHUNK in cdims and cseen == cwant,
              f"prefill chunk {backend}: prompt axis {long_} in its graph {long_ in cdims}, "
              f"chunk axis {GRAPH_CHUNK in cdims}, kernels seen {cseen}, expected {cwant}")
        log(f"graph {LM_ARCH} {backend}: {rms} RMSNorm layers in the plan; decode step after "
            f"{short} tokens: axis {short} absent ({len(dims)} axis lengths), kernels recorded "
            f"{seen}; {GRAPH_CHUNK}-token chunk after {long_}: axis {long_} absent, "
            f"{GRAPH_CHUNK} present, kernels recorded {cseen}")
        if backend == "cuda":
            full = analysis.op_dims(apply_fn, plan.params, toks(short))
            check(short in full, f"the re-scoring forward over {short} tokens has no "
                  f"{short}-axis: the dims check could not see a prefix")
            log(f"graph {LM_ARCH} negative cases: the oracle forward counts {oracle} RMSNorm "
                f"layers (6 per block, {cfg.num_layers} blocks in a Python loop, + embed + "
                f"final); the full re-scoring forward over {short} tokens carries axis {short}: "
                f"{short in full}")
        del plan, state
    del params
    fail_if_any("phase 10")


# -- phase 11: learning parity on the card -----------------------------------------------

LEARN_CONFIG = dict(embed_dim=48, num_layers=2, num_heads=4, t=4, img_size=16,
                    num_classes=4, residual="iand", tokenizer_pools=(False, False, True, True))
LEARN_STEPS, LEARN_BATCH, LEARN_LR, LEARN_EVAL = 300, 16, 0.05, 20
LEARN_BAND, CHANCE = 0.10, 0.25


def phase_learning(dev, smi):
    """The JAX package's example run (``examples/train_spikformer.py``'s
    config, 300 SGD steps of batch 16 at lr 0.05, 20 held-out batches) on the
    card: ``train_spikformer`` on the kernel route (K1, K7, K3; launches
    counted) and the same steps on the plain route from the same seed.  The
    band: held-out accuracies within LEARN_BAND of each other, both above
    chance by at least half the plain route's margin."""
    from repro_torch.core import spikformer as sf
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train as ttrain

    cfg = sf.SpikformerConfig(**LEARN_CONFIG)
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    kern = ttrain.train_spikformer(cfg, steps=LEARN_STEPS, batch=LEARN_BATCH, lr=LEARN_LR,
                                   device=dev, eval_batches=LEARN_EVAL, verbose=False)
    kern_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    n_lif, forwards = 4 + 7 * cfg.num_layers, LEARN_STEPS + LEARN_EVAL
    want = dict.fromkeys(counters, 0)
    want.update(K1=n_lif * forwards, K3=cfg.num_layers * forwards, K7=n_lif * LEARN_STEPS)
    check(launches == want, f"learning run: launches {launches}, expected {want}")

    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    params, state = sf.init(torch.Generator().manual_seed(0), cfg, device=dev)
    dcfg = DataConfig(kind="images", seed=0, global_batch=LEARN_BATCH, img_size=cfg.img_size,
                      num_classes=cfg.num_classes)

    def data(i):
        b = make_batch(dcfg, i)
        return (torch.from_numpy(b["image"]).to(dev),
                torch.from_numpy(b["label"]).long().to(dev))

    t0 = time.perf_counter()
    for i in range(LEARN_STEPS):
        params, state, loss, _ = ttrain.train_step(params, state, *data(i), plain_cfg, lr=LEARN_LR)
    accs = []
    with torch.no_grad():
        for i in range(LEARN_EVAL):
            image, label = data(100_000 + i)
            logits, _ = sf.apply(params, state, image, plain_cfg, train=False)
            accs.append(float((logits.argmax(-1) == label).float().mean()))
    plain_s = time.perf_counter() - t0
    plain_acc, kern_acc = sum(accs) / len(accs), kern["heldout_acc"]
    floor = CHANCE + (plain_acc - CHANCE) / 2
    check(abs(kern_acc - plain_acc) <= LEARN_BAND and min(kern_acc, plain_acc) >= floor
          and plain_acc > CHANCE, f"learning parity: kernel route {kern_acc:.3f}, plain route "
          f"{plain_acc:.3f} (band {LEARN_BAND}, floor {floor:.3f})")
    log(f"learning parity ({LEARN_STEPS} steps, batch {LEARN_BATCH}, lr {LEARN_LR}, the JAX "
        f"example's config): held-out accuracy kernel route {kern_acc:.4f}, plain route "
        f"{plain_acc:.4f} (band {LEARN_BAND}, floor {floor:.3f}); final loss "
        f"{kern['losses'][-1]:.4f} / {loss.item():.4f}; launches {launches}; "
        f"{kern_s:.1f} s / {plain_s:.1f} s; on {smi}")
    fail_if_any("phase 11")


# -- phase 12: the mesh ------------------------------------------------------------------
#
# Gloo worlds of MESH_RANKS processes spawned on this card (one H100: every
# rank shares cuda:0, so the ranks' times are time-sliced, not a scaling
# figure).  The ranks find the kernels phase 1 built.  References come from
# this process, before the world starts, on the same card and inputs.

MESH_RANKS = 4
VISION_MESHES = ((1, 2), (2, 1), (2, 2))
LM_MESHES = ((1, 2), (2, 2))
MESH_STEPS = 2                  # decode steps after the prefill of the LM check (cut from 4: the 1200 s limit)
MESH_TIMEOUT = 480.0            # seconds the 4-rank world may take
PROBE_TIMEOUT = 90.0


def _digest(x: torch.Tensor) -> str:
    """sha256 of a tensor's bytes: the gathered 1 GiB LM state (and the
    logits) compared with the reference without moving them between
    processes; equal digests are equal bytes, stricter than ``torch.equal``."""
    import hashlib

    return hashlib.sha256(x.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _lm_decode_run(plan, batch, steps=MESH_STEPS):
    """Prefill ``batch`` and greedy-decode ``steps`` tokens: (the prefill's
    and each step's logits, the tokens, the final state)."""
    from repro_torch import engine

    logits, state = engine.prefill(plan, batch)
    outs, tok = [logits], logits[:, -1].argmax(-1)
    toks = [tok]
    for _ in range(steps):
        logits, state = engine.decode_step(plan, state, tok)
        outs.append(logits)
        tok = logits.argmax(-1)
        toks.append(tok)
    return outs, torch.stack(toks), state


def _lm_digests(outs, toks, state):
    """Digests of a decode run's logits and of its final state gathered whole
    (``decode_state_full``), the tokens and the position."""
    from repro_torch import engine

    full = engine.decode_state_full(state)
    return {"logits": [_digest(x) for x in outs], "tokens": toks.cpu(),
            "state": [_digest(kv) for kv in full.kv], "pos": int(full.pos)}


def _mesh_cont_kw(dev):
    """Phase 7's continuous workload, as ``serve_spiking_lm_continuous``
    arguments (the seeded weights of ``_compile_lm_serving``)."""
    return dict(num_requests=CONT_REQUESTS, prompt_len=max(CONT_LENS), prompt_lens=list(CONT_LENS),
                max_new=LM_NEW, max_new_spread=CONT_SPREAD, slots=LM_SLOTS,
                max_pending=CONT_PENDING, backend="cuda", device=dev, verbose=False)


def _gemm_shapes(rec):
    """(weight columns of every spike-GEMM launch, SSA folds of every SSA
    launch) in one recorded call."""
    cols, folds = [], []
    for name, shapes in rec.ops:
        if name.startswith("kernel.") and "matmul" in name:
            cols.append(shapes[1][1])
        elif name.startswith("kernel.") and "ssa" in name:
            folds.append(shapes[0][-3])
    return sorted(cols), folds


def _mesh_rank(rank, lm_batch, device, arch, lm_arch):
    """One rank of the phase-12 world: the live ``arch`` on VISION_MESHES and
    the live ``lm_arch`` on LM_MESHES over the three kernel routes, then
    continuous serving on 2x1; every result a CPU tensor, a digest or a
    number.  On a CPU ``device`` (a rehearsal at smoke width) the wrappers
    run their plain versions, and times are host-clock only."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import engine
    from repro_torch.engine import analysis
    from repro_torch.launch.serve import (
        live_lm_params, live_model, serve_spiking_lm_continuous, spiking_lm_config)

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    counters = _counters()
    out = {"vision": {}, "lm": {}}

    def counted(fn):
        for f in counters.values():
            f.launches = 0
        if not on_card:
            t0 = time.perf_counter()
            result = fn()
            wall = 1e3 * (time.perf_counter() - t0)
            return result, {k: f.launches for k, f in counters.items()}, wall, None
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        return result, {k: f.launches for k, f in counters.items()}, wall, start.elapsed_time(end)

    with torch.inference_mode():
        for route in PATHS:
            for mesh in VISION_MESHES:
                plan, images = live_model(arch, SLOTS, route, dev, mesh=mesh)
                fn = engine.make_apply_fn(plan)
                fn(plan.params, images)                         # warm-up
                logits, launches, wall, device_ms = counted(lambda: fn(plan.params, images))
                rec = analysis.record(fn, plan.params, images)
                edges = [c for c in rec.collectives if c["kind"] == "edge"]
                out["vision"][(route, mesh)] = {
                    "logits": logits.cpu(), "launches": launches, "wall_ms": wall,
                    "device_ms": device_ms, "shapes": _gemm_shapes(rec),
                    "dtypes": sorted({c["dtype"] for c in edges}), "edges": len(edges),
                    "wire_bytes": sum(c["wire_bytes"] for c in edges),
                    "local_mesh": plan.meta.mesh.shape}
                del plan, fn
        cfg = spiking_lm_config(lm_arch)
        params = live_lm_params(cfg, dev)
        batch = lm_batch.to(dev)
        for route in PATHS:
            for mesh in LM_MESHES:
                plan = engine.compile_plan(params, None, cfg, backend=route, device=dev,
                                           mesh=mesh)
                run, launches, wall, device_ms = counted(lambda: _lm_decode_run(plan, batch))
                res = _lm_digests(*run)
                del run
                pre = engine.make_prefill_fn(plan)
                rec = analysis.record(pre, plan.params, batch)
                edges = [c for c in rec.collectives if c["kind"] == "edge"]
                res.update(launches=launches, wall_ms=wall, device_ms=device_ms,
                           shapes=_gemm_shapes(rec), dtypes=sorted({c["dtype"] for c in edges}),
                           edges=len(edges), wire_bytes=sum(c["wire_bytes"] for c in edges))
                out["lm"][(route, mesh)] = res
                del plan, pre, rec
        del params
        if on_card:
            torch.cuda.empty_cache()
        for label, chunk in (("one-shot", None), ("chunked", CONT_CHUNK)):
            t0 = time.perf_counter()
            done = serve_spiking_lm_continuous(lm_arch, mesh="2x1", prefill_chunk=chunk,
                                               **_mesh_cont_kw(dev))
            out[f"cont-{label}"] = ({rid: toks.tolist() for rid, toks in done},
                                    time.perf_counter() - t0)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else None
    return out


def _gloo_cuda_probe(rank):
    """Does this torch build's gloo take CUDA tensors for
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor``?  Each answer is
    the exception's first line, or "takes them" with the result checked.
    The mesh hands gloo its CUDA tensors (``launch.mesh.MeshAxis``), so a
    refusal fails phase 12 before this probe runs.  Then the list-form
    all-gather the mesh uses
    (``launch.mesh.MeshAxis``) of one 8-384 dense edge (4 x 4 x 196 x 768
    f32, 9.6 MB a rank) timed on CUDA tensors and staged through host memory
    by hand, median of 7 after 2 warm-ups."""
    import statistics

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    got = {}
    x = torch.full((4,), rank + 1, dtype=torch.int32, device=dev)
    try:
        o = torch.empty(8, dtype=torch.int32, device=dev)
        dist.all_gather_into_tensor(o, x)
        got["all_gather_into_tensor on CUDA tensors"] = (
            f"takes them (right: {o.tolist() == [1] * 4 + [2] * 4})")
    except Exception as e:  # the answer, reported
        got["all_gather_into_tensor on CUDA tensors"] = (
            f"{type(e).__name__}: {str(e).splitlines()[0][:160]}")
    try:
        o = torch.empty(2, dtype=torch.int32, device=dev)
        dist.reduce_scatter_tensor(o, torch.arange(4, dtype=torch.int32, device=dev))
        got["reduce_scatter_tensor on CUDA tensors"] = (
            f"takes them (right: {o.tolist() == [4 * rank, 4 * rank + 2]})")
    except Exception as e:
        got["reduce_scatter_tensor on CUDA tensors"] = (
            f"{type(e).__name__}: {str(e).splitlines()[0][:160]}")
    edge = torch.rand((4, 4, 196, 768), device=dev)

    def direct():
        out = torch.empty((2,) + tuple(edge.shape), device=dev)
        dist.all_gather(list(out.unbind(0)), edge)
        return out

    def staged():
        host = edge.cpu()
        out = torch.empty((2,) + tuple(edge.shape))
        dist.all_gather(list(out.unbind(0)), host)
        return out.to(dev)

    for label, fn in (("on the CUDA tensors", direct), ("staged through host memory", staged)):
        times = []
        for i in range(9):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
        same = torch.equal(out[rank], edge)
        got[f"all_gather of 9.6 MB {label}"] = (f"{statistics.median(times):.2f} ms (own "
                                                f"block back: {same})")
    return got


def _gemm_columns(dev, gen):
    """K2, K5 and K8 at the column counts a model shard launches them with
    (192 and 96 of the 8-384's 384- and 1536-wide units) and at half the
    rows (a data shard): each launch ``torch.equal`` the matching block of
    the full launch (a column's sum order does not depend on how many
    columns or rows the launch has).  And K4's occupancy map at the local
    widths of a model shard (192) and whole (384), equal to the map
    ``packing.occupancy_map`` recomputes from the words (what
    ``backend.word_allgather`` does where the local width is no multiple of
    OCC_TILE)."""
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.spike_matmul import ops as mm_ops

    t, m = 4, 4 * SLOTS * 196 // 4
    for k, c in ((384, 384), (384, 1536), (1536, 384)):
        spikes = (torch.rand((t, m, k), generator=gen) > 0.7).float().to(dev)
        w = ((torch.rand((k, c), generator=gen) * 2 - 1) / k ** 0.5).to(dev)
        xw = packing.pack(spikes).words[0]
        tiles = mm_ops._occ_to_grid_tiles(None, xw)
        kernels = {
            "K2": (lambda w_, rows=m: mm_ops.spike_matmul_fwd(
                spikes[:, :rows].reshape(-1, k), w_).reshape(t, rows, -1)),
            "K5": (lambda w_, rows=m: mm_ops.packed_spike_matmul_fwd(xw[:rows].contiguous(),
                                                                     w_, t=t)),
            "K8": (lambda w_, rows=m: mm_ops.sparse_packed_spike_matmul_fwd(
                xw[:rows].contiguous(), w_,
                tiles if rows == m else mm_ops._occ_to_grid_tiles(None, xw[:rows].contiguous()),
                t=t))}
        for key, run in kernels.items():
            full = run(w)
            same = []
            for cols in (192, 96):
                for j in range(c // cols):
                    part = run(w[:, j * cols:(j + 1) * cols].contiguous())
                    same.append(torch.equal(part, full[..., j * cols:(j + 1) * cols]))
            half = torch.equal(run(w, m // 2), full[:, :m // 2])
            check(all(same) and half, f"{key} K={k} C={c}: a column block or the half-row "
                  f"launch differs from the full launch ({sum(same)}/{len(same)} blocks equal, "
                  f"half rows {half})")
            # one process on the card: the shard's launch alone, not time-sliced
            w2 = w[:, :c // 2].contiguous()
            times = (time_ms(lambda: run(w)), time_ms(lambda: run(w2)),
                     time_ms(lambda: run(w, m // 2)))
            log(f"  {key} K={k} C={c}: {len(same)} launches at 192 and 96 columns and one at "
                f"{m // 2} of {m} rows torch.equal the full launch's blocks: "
                f"{all(same) and half}; ms full {times[0]:.4f}, {c // 2} columns "
                f"{times[1]:.4f}, half rows {times[2]:.4f}")
    from repro_torch.kernels.spiking_attention import ops as ssa_ops

    # the SSA at a model shard's 6 of 12 heads, the shard alone on the card
    g = t * SLOTS * 12
    q, kk, v = ((torch.rand((g, 196, 32), generator=gen) > 0.5).float().to(dev)
                for _ in range(3))
    full_ms = time_ms(lambda: ssa_ops.ssa_fwd(q, kk, v, scale=0.125))
    qh, kh, vh = (x[:g // 2].contiguous() for x in (q, kk, v))
    shard_ms = time_ms(lambda: ssa_ops.ssa_fwd(qh, kh, vh, scale=0.125))
    log(f"  K3 at G={g} (12 heads) {full_ms:.4f} ms, at G={g // 2} (a shard's 6 heads) "
        f"{shard_ms:.4f} ms")
    drive = torch.randn((t, SLOTS * 196 * 384), generator=gen).to(dev)
    for cols in (192, 384):
        words, occ = lif_ops.lif_parallel_pack_fwd(drive, chain_len=t, lam=0.25, theta=0.5,
                                                   reset="hard", occ_cols=cols)
        want = packing.occupancy_map(words.reshape(words.shape[0], -1, cols))
        same = torch.equal(occ, want)
        check(same, f"K4 occupancy at {cols} columns differs from the recomputed map")
        log(f"  K4 occupancy map of {cols}-wide rows torch.equal packing.occupancy_map of its "
            f"words: {same}")


def _mesh_expected_shapes(route, mesh):
    """(sorted GEMM weight columns, SSA folds) of one 8-384 forward on a
    (data, model) shard: the tokenizer's three spike convs at full width,
    every block unit at its local columns, each SSA on the local heads."""
    d, m = mesh
    cols = sorted([96, 192, 384] + [384 // m] * 5 * 8 + [1536 // m] * 8)
    folds = SLOTS // d * 12 // m * (4 if route == "cuda" else 1)
    return cols, [folds] * 8


def _lm_expected_shapes(route, mesh):
    """One LM prefill on a (data, model) shard: every unit replicated (full
    columns), the SSA on the local heads of the shard's rows."""
    d, m = mesh
    cols = sorted(([LM_D] * 4 + [LM_FF, LM_D]) * LM_LAYERS)
    folds = LM_SLOTS // d * LM_HEADS // m * (4 if route == "cuda" else 1)
    return cols, [folds] * LM_LAYERS


def phase_mesh(dev, smi, arch=ARCH, lm_arch=LM_ARCH):
    """The mesh (``compile_plan(mesh=)``) on a gloo world of MESH_RANKS ranks
    sharing this card: the live 8-384 at slot batch 8 on 1x2, 2x1 and 2x2 and
    the live llama3.2-1b (prefill of 4 x 32 tokens and MESH_STEPS greedy
    steps) on 1x2 and 2x2, on the three kernel routes, each ``torch.equal``
    the single-device plan of its route; every rank's hand-kernel launches
    and their shapes those of its shard; under the packed routes every spike
    edge on the wire int32, and its bytes those the pricers give; then
    ``serve_spiking_lm_continuous(mesh="2x1")`` on phase 7's workload,
    one-shot and chunked, equal to the single-device streams.  With a CPU
    ``dev`` and smoke archs it rehearses the same paths (no launch, shape,
    wire-byte or device-time checks: those hold the full widths on the
    card)."""
    from repro_torch import engine
    from repro_torch.configs.spike_iand_former import get_vision_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.engine import analysis
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.serve import (
        live_lm_params, live_model, serve_spiking_lm_continuous, spiking_lm_config)

    on_card = dev.type == "cuda"
    empty_cache = torch.cuda.empty_cache if on_card else (lambda: None)
    t_phase = time.perf_counter()
    vision_ref = {}
    with torch.inference_mode():
        for route in PATHS:
            plan, images = live_model(arch, SLOTS, route, dev)
            vision_ref[route] = engine.apply(plan, images).cpu()
            del plan
        cfg = spiking_lm_config(lm_arch)
        prompts = make_batch(DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=LM_PROMPT,
                                        global_batch=LM_SLOTS), 0)["tokens"]
        lm_batch = torch.from_numpy(prompts).long()
        params = live_lm_params(cfg, dev)
        lm_ref = {}
        for route in PATHS:
            plan = engine.compile_plan(params, None, cfg, backend=route, device=dev)
            lm_ref[route] = _lm_digests(*_lm_decode_run(plan, lm_batch.to(dev)))
            del plan
        del params
        empty_cache()
        cont_ref = dict(serve_spiking_lm_continuous(lm_arch, **_mesh_cont_kw(dev)))
    empty_cache()
    log(f"  references (single device) in {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    ranks = spawn_world(_mesh_rank, MESH_RANKS, (lm_batch, str(dev), arch, lm_arch),
                        timeout=MESH_TIMEOUT)
    log(f"  {MESH_RANKS}-rank world (gloo, every rank on {dev}) ran in "
        f"{time.perf_counter() - t0:.1f} s; peak memory per rank "
        + ", ".join(f"{r['peak_gib'] or 0:.2f}" for r in ranks) + f" GiB; on {smi}")
    fmt = lambda x: "not measured" if x is None else f"{x:.2f}"

    for route in PATHS:
        for mesh in VISION_MESHES:
            for rank, r in enumerate(ranks):
                got = r["vision"][(route, mesh)]
                label = f"8-384 {route} mesh {mesh[0]}x{mesh[1]} rank {rank}"
                check(got["local_mesh"] == mesh, f"{label}: laid out as {got['local_mesh']}")
                check(torch.equal(got["logits"], vision_ref[route]),
                      f"{label}: logits differ from the single-device plan's")
                if route != "cuda":
                    check(got["dtypes"] in (["int32"], []) and (got["dtypes"] or mesh[1] == 1),
                          f"{label}: wire dtypes {got['dtypes']}")
                if not on_card:
                    continue
                want = _per_forward(8, route)
                check(got["launches"] == want, f"{label}: launches {got['launches']}, "
                      f"expected {want}")
                check(got["shapes"] == _mesh_expected_shapes(route, mesh),
                      f"{label}: kernel shapes {got['shapes']} are not the shard's")
                if not route.endswith("sparse"):    # the sparse route gathers maps too
                    priced = analysis.spike_traffic(get_vision_config(arch), batch=SLOTS,
                                                    backend=route, mesh=mesh)
                    key = ("cross_device_dense_bytes" if route == "cuda"
                           else "cross_device_packed_bytes")
                    check(mesh[0] * got["wire_bytes"] == priced[key],
                          f"{label}: {got['wire_bytes']} wire bytes x {mesh[0]} data shards "
                          f"!= the pricing's {priced[key]}")
            g = ranks[0]["vision"][(route, mesh)]
            log(f"  8-384 {route} {mesh[0]}x{mesh[1]}: logits torch.equal single device on all "
                f"ranks; per rank launches {g['launches']}; {g['edges']} spike edges on the wire "
                f"({g['dtypes']}, {g['wire_bytes']} B per model group); wall / device ms per "
                "rank " + ", ".join(f"{r['vision'][(route, mesh)]['wall_ms']:.2f} / "
                                    f"{fmt(r['vision'][(route, mesh)]['device_ms'])}"
                                    for r in ranks) + " (time-sliced on one card)")
    for route in PATHS:
        ref = lm_ref[route]
        for mesh in LM_MESHES:
            for rank, r in enumerate(ranks):
                got = r["lm"][(route, mesh)]
                label = f"{LM_ARCH} {route} mesh {mesh[0]}x{mesh[1]} rank {rank}"
                same = (got["logits"] == ref["logits"] and got["state"] == ref["state"]
                        and torch.equal(got["tokens"], ref["tokens"]) and got["pos"] == ref["pos"])
                check(same, f"{label}: prefill/step logits, tokens or gathered state differ "
                      "from the single-device plan's")
                if route != "cuda":
                    check(got["dtypes"] == ["int32"], f"{label}: wire dtypes {got['dtypes']}")
                if not on_card:
                    continue
                want = _lm_launches(route, 1, MESH_STEPS)
                check(got["launches"] == want, f"{label}: launches {got['launches']}, "
                      f"expected {want}")
                check(got["shapes"] == _lm_expected_shapes(route, mesh),
                      f"{label}: kernel shapes are not the shard's")
                if not route.endswith("sparse"):    # the sparse route gathers maps too
                    priced = analysis.lm_spike_traffic(cfg, seq_len=LM_PROMPT, batch=LM_SLOTS,
                                                       backend=route, mesh=mesh)
                    key = ("cross_device_dense_bytes" if route == "cuda"
                           else "cross_device_packed_bytes")
                    check(mesh[0] * got["wire_bytes"] == priced[key],
                          f"{label}: {got['wire_bytes']} wire bytes x {mesh[0]} data shards "
                          f"!= the pricing's {priced[key]}")
            g = ranks[0]["lm"][(route, mesh)]
            log(f"  {LM_ARCH} {route} {mesh[0]}x{mesh[1]}: prefill + {MESH_STEPS} steps, logits "
                f"and gathered state torch.equal single device on all ranks; per rank launches "
                f"{g['launches']}; {g['edges']} spike edges per prefill ({g['dtypes']}, "
                f"{g['wire_bytes']} B per model group); wall / device ms per rank "
                + ", ".join(f"{r['lm'][(route, mesh)]['wall_ms']:.1f} / "
                            f"{fmt(r['lm'][(route, mesh)]['device_ms'])}" for r in ranks)
                + " (prefill + steps, time-sliced on one card)")
    want = {rid: toks.tolist() for rid, toks in cont_ref.items()}
    for label in ("one-shot", "chunked"):
        for rank, r in enumerate(ranks):
            streams, seconds = r[f"cont-{label}"]
            check(streams == want, f"continuous 2x1 {label} rank {rank}: streams differ from "
                  "the single-device run")
        log(f"  serve_spiking_lm_continuous(mesh='2x1') {label}: {len(want)} streams equal the "
            "single-device run on all ranks; wall s per rank "
            + ", ".join(f"{r[f'cont-{label}'][1]:.2f}" for r in ranks))
    fail_if_any("phase 12")
    if on_card:
        try:
            probe = spawn_world(_gloo_cuda_probe, 2, timeout=PROBE_TIMEOUT)[0]
        except (RuntimeError, TimeoutError) as e:   # the answer is logged, never relied on
            probe = {"probe": f"the world failed: {str(e).splitlines()[0][:160]}"}
        for op, answer in probe.items():
            log(f"  gloo {op} (torch {torch.__version__}, 2 ranks): {answer}")
    log(f"phase 12 in {time.perf_counter() - t_phase:.1f} s")


# -- phase 13: spiking-LM training, the trained fixture, the optimizer -----------------

LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 64, 3
LM_TRAIN_LR = 0.05              # p - lr * g on the full-width LM (the fixture's 0.5 is for d 64)
FIXTURE_TS = (8, 32)
FIXTURE_PROMPT, FIXTURE_NEW = 16, 8
FIXTURE_ROUTES = ("cuda", "cuda+packed", "cuda+packed+sparse")
# The AdamW update on the card against the CPU: the same elementwise f32
# arithmetic, the clip scale from a global norm summed in another order (an
# ulp): the updated weights and master within ADAMW_TOL, the bf16 moments
# within one bf16 ulp (2^-7 relative), the global norm within GNORM_RTOL.
ADAMW_TOL = dict(rtol=1e-6, atol=1e-6)
GNORM_RTOL = 1e-5


def _lm_train_kernels(dev, gen, cfg):
    """K1, K7 and K3 at the spiking LM's training shapes (T 4, B 4 x S 64
    tokens; the LIFs of d_model and of d_ff drives; the causal SSA over
    G = T*B*H folds of 64 tokens at Dh 512) against their plain versions
    (``torch.equal``), timed per training step beside the bound and the
    library calls.  Returns the three ``@lm-train`` reports."""
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.lif_parallel.ref import lif_parallel_ref, lif_parallel_ref_grad
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import ssa_ref

    t, rows, layers = cfg.spike_t, LM_TRAIN_BATCH * LM_TRAIN_SEQ, cfg.num_layers
    d, f, h = cfg.d_model, cfg.d_ff, cfg.num_heads
    dh = d // h
    src = "src/repro_torch/kernels/{}/csrc/{}.cu"
    tpu = "src/repro/kernels/{}/kernel.py:{}"
    reports = {"K1": KernelReport("lif_parallel@lm-train", src.format("lif_parallel",
                                                                      "lif_parallel"),
                                  tpu.format("lif_parallel", 144)),
               "K7": KernelReport("lif_parallel_bwd@lm-train", src.format("lif_parallel",
                                                                          "lif_parallel"),
                                  tpu.format("lif_parallel", 211)),
               "K3": KernelReport("ssa@lm-train", src.format("spiking_attention", "ssa"),
                                  tpu.format("spiking_attention", 62))}
    # per step: the embedding LIF and six of d_model per block, one of d_ff per block
    cases = [(rows * d, 1 + 6 * layers), (rows * f, layers)]
    big = rows * f
    drive = torch.randn((t, big), generator=gen).to(dev)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8   # membranes on theta and the boxcar edges
    cot = torch.randn((t, big), generator=gen).to(dev)
    for n, count in cases:
        x, g = drive[:, :n].contiguous(), cot[:, :n].contiguous()
        fwd = lambda: lif_ops.lif_parallel_fwd(x, chain_len=t, lam=0.25, theta=0.5, reset="hard")
        bwd = lambda: lif_ops.lif_parallel_bwd(x, g, chain_len=t, lam=0.25, theta=0.5,
                                               reset="hard")
        plain_fwd = lambda: lif_parallel_ref(x, chain_len=t)
        plain_bwd = lambda: lif_parallel_ref_grad(x, g, chain_len=t)
        check(torch.equal(fwd(), plain_fwd()), f"K1@lm-train N={n}: not equal to the plain version")
        check(torch.equal(bwd(), plain_bwd()), f"K7@lm-train N={n}: not equal to the plain version")
        if dev.type != "cuda":
            continue
        reports["K1"].add(f"N={n}", count, 0.0, time_ms(fwd), time_ms(plain_fwd, reps=5),
                          8 * t * n, 5 * t * n, peak=F32_FLOP_PER_S)
        reports["K7"].add(f"N={n}", count, 0.0, time_ms(bwd), time_ms(plain_bwd, reps=5),
                          12 * t * n, 20 * t * n, peak=F32_FLOP_PER_S)
    del drive, cot
    g_folds, s = t * LM_TRAIN_BATCH * h, LM_TRAIN_SEQ
    q, k, v = ((torch.rand((g_folds, s, dh), generator=gen) > 0.5).float().to(dev)
               for _ in range(3))
    run = lambda: ssa_ops.ssa_fwd(q, k, v, scale=0.125, causal=True)
    plain = lambda: ssa_ref(q, k, v, scale=0.125, causal=True)
    want = plain()
    check(torch.equal(run(), want), "K3@lm-train: not equal to the plain version")
    if dev.type == "cuda":
        reports["K3"].add(f"G={g_folds} N=M={s} Dh={dh} causal", layers, 0.0, time_ms(run),
                          time_ms(plain, reps=5), 4 * 4 * g_folds * s * dh,
                          4 * g_folds * (s * (s + 1) // 2) * dh,
                          library_ms=time_ms(lambda: torch.bmm(torch.tril(torch.bmm(
                              q, k.transpose(1, 2))), v) * 0.125),
                          library_tc_ms=library_tc_ms(q, k, v, 0.125, want, "K3@lm-train",
                                                      causal=True))
    log(f"K1, K7 at the LM training shapes (T={t}, N = {rows} x {d} and {rows} x {f}) and K3 "
        f"(G={g_folds}, N=M={s}, Dh={dh}, causal): torch.equal the plain versions")
    return reports


def _leaf_rel(grads, want):
    """Largest |grads - want| / max |want| of each leaf, by name."""
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    want = dict(flatten_with_names(want))
    out = {}
    for name, g in flatten_with_names(grads):
        scale = want[name].abs().max().item()
        out[name] = (g - want[name]).abs().max().item() / scale if scale else g.abs().max().item()
    return out


def _profile_lm_step(params, batch, cfg, tries=3):
    """One kernel-route SGD step of the LM under ``torch.profiler``: device
    busy against the profiled wall, and the device time of K1, K7, K3, the
    cuBLAS GEMMs and the rest.  Returns the hand kernels' device ms by K
    number.  The profiler's schedule runs a warm-up step with tracing on
    and keeps the step after it: a profile begun right before the step
    missed its first kernels (the embedding LIF among them) in three of
    three attempts after phases 1-12.  The schedule's step range and the
    ``record_function`` regions show on the device timeline as annotations,
    not kernels: they are left out of the sums.  A profile that still lacks some of
    the step's launches is taken again, up to ``tries`` times (empty if
    none is complete)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.checkpoint.fixtures import sgd_step

    lifs = 1 + 7 * cfg.num_layers
    want = {"K1": lifs, "K7": lifs, "K3": cfg.num_layers}
    kept = {}

    def ready(prof):        # the kept step's kernels (the cycle's end clears them)
        kept["kernels"] = [e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and not getattr(e, "is_user_annotation", False)
                           and not e.key.startswith("ProfilerStep")]

    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):      # the warm-up step, then the kept one
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sgd_step(params, batch, cfg, lr=LM_TRAIN_LR, use_kernel=True)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                prof.step()
        kernels = kept.pop("kernels", [])
        mine, counts = {}, {}
        for key, _, e in _hand_kernels(kernels):
            mine[key] = mine.get(key, 0.0) + e.self_device_time_total / 1e3
            counts[key] = counts.get(key, 0) + e.count
        if counts == want:
            break
        log(f"  profile LM train step: incomplete (launches {counts}, the step makes {want}), "
            f"attempt {attempt} of {tries}")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        log("  profile LM train step: the profiler saw no device time")
        return {}
    gemm = sum(e.self_device_time_total for e in kernels
               if any(p in e.key for p in ("gemm", "Gemm", "sm90_xmma", "cutlass"))) / 1e3
    rest = busy - gemm - sum(mine.values())
    log(f"  profile LM train step (kernel route, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens): "
        f"{sum(e.count for e in kernels)} CUDA kernels, device busy {busy:.3f} ms of a "
        f"{wall:.3f} ms profiled step ({1 - busy / wall:.1%} idle); K1 {mine.get('K1', 0):.3f} ms "
        f"x{counts.get('K1', 0)}, K7 {mine.get('K7', 0):.3f} ms x{counts.get('K7', 0)}, K3 "
        f"{mine.get('K3', 0):.3f} ms x{counts.get('K3', 0)}, cuBLAS GEMM {gemm:.3f} ms, the rest "
        f"{rest:.3f} ms")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log("  top: " + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                              for e in top))
    return mine if counts == want else {}


def _adamw_full_width(grads, params, dev, smi):
    """One ``make_adamw(OptimizerConfig(state_dtype="bfloat16",
    master_weights=True))`` update of the full-width tree on the card, at the
    schedule's peak (step = warmup_steps), timed; the lm_head leaf held
    against the same update on the CPU: the global norm summed on the CPU
    from a host copy of every gradient, the CPU update of lm_head alone with
    its gradient scaled by that norm's clip factor (and no clip of its own)."""
    from repro_torch.checkpoint.checkpoint import flatten_with_names
    from repro_torch.optim.optimizer import OptimizerConfig, global_norm, make_adamw

    ocfg = OptimizerConfig(state_dtype="bfloat16", master_weights=True)
    opt = make_adamw(ocfg)
    state = opt.init(params)
    step = ocfg.warmup_steps
    _sync(dev)
    t0 = time.perf_counter()
    new_params, new_state = opt.update(grads, state, params, step=step)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    host_grads = {n: g.detach().cpu() for n, g in flatten_with_names(grads)}
    gn = global_norm(host_grads)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    cpu_opt = make_adamw(dataclasses.replace(ocfg, clip_norm=float("inf")))
    head = {"w": params["lm_head"]["w"].cpu()}
    cpu_new, cpu_state = cpu_opt.update({"w": host_grads["['lm_head']/['w']"] * scale},
                                        cpu_opt.init(head), head, step=step)
    got = {"params": new_params["lm_head"]["w"], "master": new_state["master"]["lm_head"]["w"],
           "m": new_state["m"]["lm_head"]["w"], "v": new_state["v"]["lm_head"]["w"]}
    want = {"params": cpu_new["w"], "master": cpu_state["master"]["w"],
            "m": cpu_state["m"]["w"], "v": cpu_state["v"]["w"]}
    errs = {}
    for key, w in want.items():
        g = got[key].cpu().float()
        tol = ADAMW_TOL if key in ("params", "master") else dict(rtol=2 ** -7, atol=0.0)
        errs[key] = (g - w.float()).abs().max().item()
        check(bool(torch.allclose(g, w.float(), **tol)),
              f"AdamW lm_head {key}: card vs CPU max abs err {errs[key]:.3g} outside {tol}")
    gn_rel = abs(new_state["grad_norm"].item() - gn.item()) / gn.item()
    check(gn_rel <= GNORM_RTOL, f"AdamW global norm card {new_state['grad_norm'].item()!r} vs "
          f"CPU {gn.item()!r}")
    moved = (got["params"] - params["lm_head"]["w"]).abs().max().item()
    n = sum(x.numel() for x in host_grads.values())
    log(f"AdamW (bf16 moments, master weights) on the {n:,}-parameter gradient tree: "
        f"{ms:.2f} ms for the update (host clock, synced) on {smi}; global norm "
        f"{gn.item():.6g} (card vs CPU {gn_rel:.2g} relative), lm_head moved by up to "
        f"{moved:.3g}; card vs CPU max abs err " + ", ".join(f"{k} {v:.3g}"
                                                             for k, v in errs.items()))
    return ms


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _greedy_stream(plan, prompt, steps):
    from repro_torch import engine

    with torch.inference_mode():
        logits, state = engine.prefill(plan, prompt)
        tok = logits[:, -1].argmax(-1)
        toks = [tok]
        for _ in range(steps - 1):
            step_logits, state = engine.decode_step(plan, state, tok)
            tok = step_logits.argmax(-1)
            toks.append(tok)
    return torch.stack(toks, dim=1)


def phase_fixture(dev, smi):
    """The trained fixture on this device: ``trained_lm_fixture`` in a fresh
    directory (60 SGD steps of the smoke LM, kernel route on the card),
    learned and memoised; restored at each T of FIXTURE_TS and served on the
    three kernel routes in both orderings, greedy streams ``torch.equal``
    across the routes; its ``sparsity_report`` beside the untrained
    (seeded) model's."""
    from repro_torch import engine
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.fixtures import (
        fixture_config, synthetic_batches, trained_lm_fixture)
    from repro_torch.engine import analysis
    from repro_torch.models.spiking_lm import init_spiking_lm

    fix_dir = ROOT / "build" / "chip_smoke" / "lm_fixture"
    shutil.rmtree(fix_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt_dir, fcfg = trained_lm_fixture(fix_dir, device=dev)
    train_s = time.perf_counter() - t0
    step = ckpt.latest_step(ckpt_dir)
    meta = json.loads((Path(ckpt_dir) / f"step_{step:08d}" / "manifest.json").read_text())["meta"]
    log(f"fixture trained in {train_s:.2f} s ({step} steps of {fcfg.name}, T={fcfg.spike_t}, "
        f"{meta['route']} route on {meta['device']}): loss {meta['loss_first']:.4f} -> "
        f"{meta['loss_last']:.4f}; corpus: {meta['corpus']}")
    check(meta["loss_last"] < meta["loss_first"], "the fixture did not learn")
    mtime = (Path(ckpt_dir) / "LATEST").stat().st_mtime_ns
    trained_lm_fixture(fix_dir, device=dev)
    check((Path(ckpt_dir) / "LATEST").stat().st_mtime_ns == mtime,
          "a second trained_lm_fixture call retrained")
    prompt = synthetic_batches(fcfg, steps=1, batch=LM_TRAIN_BATCH,
                               seq=FIXTURE_PROMPT)[0]["tokens"].long().to(dev)
    routes = FIXTURE_ROUTES if dev.type == "cuda" else ("torch", "torch+packed",
                                                         "torch+packed+sparse")
    for t in FIXTURE_TS:
        cfg_t = fixture_config(spike_t=t)
        skel = init_spiking_lm(torch.Generator(dev).manual_seed(0), cfg_t)
        for ordering in ("linear", "quadratic"):
            streams = {r: _greedy_stream(engine.compile_plan(
                skel, None, cfg_t, backend=r, ordering=ordering, device=dev,
                checkpoint=str(ckpt_dir)), prompt, FIXTURE_NEW) for r in routes}
            same = all(torch.equal(streams[r], streams[routes[0]]) for r in routes)
            log(f"  fixture T={t} {ordering}: greedy streams ({LM_TRAIN_BATCH} prompts of "
                f"{FIXTURE_PROMPT}, {FIXTURE_NEW} tokens) torch.equal across {routes}: {same}; "
                f"first stream {streams[routes[0]][0].tolist()}")
            check(same, f"fixture T={t} {ordering}: greedy streams differ across routes")
        sparse = routes[-1]
        for label, kw in (("trained", dict(checkpoint=str(ckpt_dir))), ("seeded", {})):
            plan = engine.compile_plan(skel, None, cfg_t, backend=sparse, ordering="linear",
                                       device=dev, **kw)
            with torch.inference_mode():
                rep = analysis.sparsity_report(plan, prompt)
            log(f"  sparsity_report T={t} {label} ({sparse}, {LM_TRAIN_BATCH} x {FIXTURE_PROMPT} "
                f"tokens): word zero rate {rep['word_zero_rate']:.4f}, tile zero rate "
                f"{rep['occ_tile_zero_rate']:.4f}, granule zero rate "
                f"{rep['token_granule_zero_rate']:.4f}, spike rate {rep['spike_rate']:.4f}")
    shutil.rmtree(fix_dir, ignore_errors=True)
    return train_s


def phase_lm_train(dev, smi, arch=LM_ARCH):
    """Spiking-LM training at the full width of ``spiking_lm_config(arch)``:
    K1/K7/K3 at its training shapes against their plain versions; one
    ``loss_and_grad`` on the kernel route against the plain route (loss
    ``torch.equal``, each gradient leaf within GRAD_REL of its max); one
    AdamW update of the gradient tree (lm_head against the CPU); then the
    main path, ``train_fixture_params`` for LM_TRAIN_STEPS SGD steps at
    LM_TRAIN_LR on the kernel route with every counter set to 0 just before
    and read just after (113 K1 + 113 K7 + 16 K3 a step); ms per step,
    tokens/s and one profiled step; then the trained fixture
    (:func:`phase_fixture`).  The weights are ``live_lm_params`` (every
    block fires), the tokens the port's fixture corpus at the arch's
    vocabulary.  With a CPU ``dev`` and a smoke arch it rehearses the same
    paths (no counts, times or profile).  Returns the ``@lm-train``
    reports."""
    from repro_torch.checkpoint.fixtures import (
        loss_and_grad, synthetic_batches, train_fixture_params)
    from repro_torch.launch.serve import live_lm_params, spiking_lm_config

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    cfg = spiking_lm_config(arch)
    reports = _lm_train_kernels(dev, torch.Generator().manual_seed(13), cfg)
    fail_if_any("phase 13 (kernels)")
    params = live_lm_params(cfg, dev)
    batches = [{"tokens": b["tokens"].to(dev)} for b in
               synthetic_batches(cfg, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
                                 seq=LM_TRAIN_SEQ)]
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    kern = loss_and_grad(params, batches[0], cfg, use_kernel=True)
    _sync(dev)
    lifs = 1 + 7 * cfg.num_layers
    step_launches = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    if on_card:
        want.update(K1=lifs, K7=lifs, K3=cfg.num_layers)
    check(step_launches == want, f"kernel-route LM step launches {step_launches}, expected {want}")
    plain = loss_and_grad(params, batches[0], cfg)
    same = torch.equal(kern[0], plain[0])
    log(f"LM train step {arch} ({cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads "
        f"of Dh {cfg.d_model // cfg.num_heads}, T {cfg.spike_t}, vocab {cfg.vocab_size}; "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens): loss kernel {kern[0].item()!r} plain "
        f"{plain[0].item()!r}: torch.equal {same}")
    check(same, "LM train step: the kernel-route loss differs from the plain route's")
    rel = _leaf_rel(kern[1], plain[1])
    worst = max(rel, key=rel.get)
    group = lambda part: max(v for k, v in rel.items() if part in k)
    log(f"  gradients, |kernel - plain| / max|plain| per leaf: largest {rel[worst]:.3g} "
        f"({worst}; limit {GRAD_REL}); embed {group('embed'):.3g}, layers {group('layers'):.3g}, "
        f"lm_head {group('lm_head'):.3g}")
    for name, r in rel.items():
        check(r <= GRAD_REL, f"LM gradient {name}: {r:.3g} of its scale > {GRAD_REL}")
    del plain
    adamw_ms = _adamw_full_width(kern[1], params, dev, smi)
    del kern
    fail_if_any("phase 13 (routes)")

    _sync(dev)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    _, losses = train_fixture_params(cfg, device=dev, init=params, batches=batches,
                                     lr=LM_TRAIN_LR)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    if on_card:
        want.update(K1=lifs * LM_TRAIN_STEPS, K7=lifs * LM_TRAIN_STEPS,
                    K3=cfg.num_layers * LM_TRAIN_STEPS)
    check(launches == want, f"train_fixture_params launches {launches}, expected {want}")
    check(all(np.isfinite(losses)), f"LM train losses {losses} not finite")
    ms = 1e3 * wall / LM_TRAIN_STEPS
    tok_s = LM_TRAIN_STEPS * LM_TRAIN_BATCH * LM_TRAIN_SEQ / wall
    log(f"train_fixture_params({arch}, {LM_TRAIN_STEPS} steps, lr {LM_TRAIN_LR}, kernel route): "
        f"losses {losses}, {ms:.2f} ms per step, {tok_s:.1f} tokens/s (host clock, synced, the "
        f"first step included), launches {launches} (expected {want}: per step {lifs} K1 + "
        f"{lifs} K7 + {cfg.num_layers} K3) on {smi}")
    device = _profile_lm_step(params, batches[0], cfg) if on_card else {}
    del params
    for key, rep in reports.items():
        rep.entry["launches"] = launches[key]
        rep.entry["launches_per_forward"] = launches[key] / LM_TRAIN_STEPS
        rep.entry["device_ms"] = device.get(key)
    if on_card:
        log("  @lm-train kernels per step on " + smi + ": " + ", ".join(
            f"{k} {r.entry['ms']:.3f} ms (device {r.entry['device_ms']}), bound "
            f"{r.entry['bound_ms']:.3f} ({r.entry['bound_by']}), plain {r.entry['plain_ms']:.3f}"
            for k, r in reports.items()))
    fail_if_any("phase 13 (training)")
    if on_card:
        torch.cuda.empty_cache()
    fixture_s = phase_fixture(dev, smi)
    fail_if_any("phase 13")
    log(f"phase 13 in {time.perf_counter() - t_phase:.1f} s (the fixture {fixture_s:.1f} s, "
        f"the AdamW update {adamw_ms:.2f} ms)")
    return reports


# -- phase 14: the generic LM families at full width --------------------------------

# The generic decoder of ``models/transformer.py``: llama3.2-1b served as the
# reference's CLI serves by default (LM_REQUESTS requests, prompt LM_PROMPT,
# LM_NEW new tokens, LM_SLOTS slots; f32 parameters from a seed on the card,
# bf16 compute), trained one AdamW step of GEN_TRAIN_BATCH x GEN_TRAIN_SEQ
# tokens (then GEN_TRAIN_STEPS - 1 timed ones); the seven other configs that
# fit one card prefilled on GEN_BATCH x GEN_PREFILL tokens of their modality
# (paligemma: its 256-token image prefix plus GEN_PREFILL text tokens) and
# decoded GEN_DECODE tokens, in f32; the two that do not fit counted on meta.
# No Pallas kernel is on this path (the reference's attention is jnp), so no
# hand kernel may launch in it.
GEN_ARCH = "llama3.2-1b"
GEN_OTHERS = ("qwen1.5-4b", "qwen3-8b", "musicgen-large", "paligemma-3b",
              "granite-moe-3b-a800m", "mamba2-130m", "recurrentgemma-9b")
GEN_META = ("mistral-large-123b", "kimi-k2-1t-a32b")
GEN_TRAIN_BATCH, GEN_TRAIN_SEQ, GEN_TRAIN_STEPS = 4, 512, 3
GEN_BATCH, GEN_PREFILL, GEN_DECODE = 2, 256, 32
# Decode from the cache against the full forward, and the prompt fed step by
# step against the batched prefill, in f32 with TF32 off: the reference's own
# decode-vs-forward bound.
GEN_DECODE_ATOL = 2e-3
# The card against the CPU on the same weights (llama3.2-1b width, GEN_CPU_LAYERS
# layers, f32, TF32 off, 2 x 64 tokens): f32 sums in another order (cuBLAS
# against the CPU's BLAS), 2048- to 8192-term dots.  Logits within
# GEN_CPU_LOGITS_ATOL, each gradient leaf within GEN_CPU_GRAD_REL of its max.
GEN_CPU_LAYERS, GEN_CPU_TOKENS = 2, (2, 64)
GEN_CPU_LOGITS_ATOL = 1e-4
GEN_CPU_GRAD_REL = 1e-4


def _zeroed(counters):
    for c in counters.values():
        c.launches = 0


def _no_hand_kernels(label, counters):
    launches = {k: c.launches for k, c in counters.items()}
    check(not any(launches.values()),
          f"{label}: hand kernels launched {launches} on the generic path (expected none)")


def _max_gap(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _decode_vs_forward(params, cfg, batch, steps, dev):
    """Token-by-token decode of ``steps`` positions from ``cache_init``
    through ``make_serve_step``, against ``forward`` over the same inputs:
    (largest logits gap, ms per step after the first, on the device)."""
    from repro_torch.models import lm, transformer as T

    serve_step = lm.make_serve_step(cfg)
    with torch.no_grad():
        full, _, _ = T.forward(params, batch, cfg)
    b = full.shape[0]
    cache = T.cache_init(cfg, b, steps, device=dev)
    outs, t1 = [], None
    for t in range(steps):
        if "embeds" in batch:
            step_in = {"embeds": batch["embeds"][:, t:t + 1]}
        else:
            step_in = {"token": batch["tokens"][:, t:t + 1]}
        logits, cache = serve_step(params, cache, step_in, t)
        outs.append(logits)
        if t == 0:
            _sync(dev)
            t1 = time.perf_counter()
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t1) / max(steps - 1, 1)
    return _max_gap(torch.cat(outs, dim=1), full), ms


def _generic_batch(cfg, dev, batch, seq, seed=0):
    """``make_batch`` of ``cfg``'s modality on ``dev``: tokens, audio frame
    embeddings with labels, or an image prefix plus ``seq`` text tokens."""
    from repro_torch.data.pipeline import DataConfig, make_batch

    kind = {"text": "tokens"}.get(cfg.modality, cfg.modality)
    p = cfg.num_prefix_tokens if cfg.modality == "vision_stub" else 0
    dcfg = DataConfig(seed=seed, vocab_size=cfg.vocab_size, seq_len=seq + p, global_batch=batch,
                      kind=kind, d_model=cfg.d_model, num_prefix_tokens=p)
    return {k: torch.from_numpy(v).to(dev) for k, v in make_batch(dcfg, 0).items()}


def _generic_serve(dev, smi, arch, counters):
    """``serve(arch)`` through the entry point, then its first slot batch by
    hand in f32 and bf16 compute: the prompt fed through ``make_serve_step``
    against ``make_prefill_step``'s last logits, and decode from the cache
    against ``forward`` over the prompt.  Returns the parameters."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.serve import serve, serve_batch
    from repro_torch.models import lm, transformer as T

    _zeroed(counters)
    done, stats = serve(arch, num_requests=LM_REQUESTS, prompt_len=LM_PROMPT, max_new=LM_NEW,
                        slots=LM_SLOTS, device=dev, return_stats=True)
    _no_hand_kernels(f"serve({arch})", counters)
    cfg = lm.get_config(arch)
    batches = -(-LM_REQUESTS // LM_SLOTS)
    check(len(done) == LM_REQUESTS and all(t.shape == (LM_NEW,) and 0 <= t.min()
                                           and t.max() < cfg.vocab_size for _, t in done),
          f"serve({arch}) returned {[(i, t.shape) for i, t in done]}")
    log(f"serve({arch}, {LM_REQUESTS} requests, prompt {LM_PROMPT}, {LM_NEW} new, {LM_SLOTS} slots; "
        f"{cfg.num_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.param_dtype} "
        f"parameters, {cfg.compute_dtype} compute): prompt feed {stats['prefill_tokens_per_s']:.1f} "
        f"tok/s ({1e3 * stats['prefill_s'] / (batches * LM_PROMPT):.3f} ms a step), decode "
        f"{stats['decode_tokens_per_s']:.1f} tok/s ({1e3 * stats['decode_s'] / (batches * (LM_NEW - 1)):.3f} "
        f"ms a step; host clock, synced) on {smi}")

    params = T.init_lm(0, cfg, device=dev)          # serve()'s weights: the same seed
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=LM_PROMPT,
                      global_batch=LM_REQUESTS)
    prompts = torch.from_numpy(make_batch(dcfg, 0)["tokens"][:LM_SLOTS]).to(dev)
    for cd in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=cd)
        gen, after, _, _ = serve_batch(lm.make_serve_step(c), params, c, prompts, LM_NEW)
        last, _ = lm.make_prefill_step(c)(params, {"tokens": prompts})
        feed_gap = _max_gap(last[:, -1], after)
        dec_gap, step_ms = _decode_vs_forward(params, c, {"tokens": prompts}, LM_PROMPT, dev)
        if cd == "float32":
            check(feed_gap <= GEN_DECODE_ATOL and dec_gap <= GEN_DECODE_ATOL,
                  f"{arch} f32: prompt feed vs prefill {feed_gap:.3g}, decode vs forward "
                  f"{dec_gap:.3g} (limit {GEN_DECODE_ATOL})")
        note = f" (limit {GEN_DECODE_ATOL})" if cd == "float32" else " (reported)"
        if cd == cfg.compute_dtype:     # serve()'s own compute: its first slot batch again
            same = torch.equal(gen.cpu(), torch.from_numpy(np.stack([t for _, t in done[:LM_SLOTS]])))
            check(same, f"{arch}: serve()'s first slot batch differs from serve_batch's on the "
                        "same weights")
            note += f"; serve()'s first slot batch equals these tokens: {same}"
        log(f"  {arch} {cd} compute: prompt fed step by step vs make_prefill_step's last logits "
            f"{feed_gap:.3g}, decode from the cache vs forward over {LM_PROMPT} tokens "
            f"{dec_gap:.3g}{note}, {step_ms:.3f} ms a decode step on {smi}")
    if dev.type == "cuda":          # where a step's time goes: device busy against the wall
        step, prefill = lm.make_serve_step(cfg), lm.make_prefill_step(cfg)
        cache = T.cache_init(cfg, LM_SLOTS, LM_PROMPT + LM_NEW, device=dev)
        _profile(f"generic {arch} decode step ({cfg.compute_dtype}, {LM_SLOTS} slots; {smi})",
                 lambda: step(params, cache, {"token": prompts[:, :1]}, LM_PROMPT), {}, tries=1)
        _profile(f"generic {arch} prefill ({cfg.compute_dtype}, {LM_SLOTS} x {LM_PROMPT} tokens; {smi})",
                 lambda: prefill(params, {"tokens": prompts}), {}, tries=1)
    return params


def _generic_train(dev, smi, cfg, params, counters, seq):
    """One ``make_train_step`` with AdamW on GEN_TRAIN_BATCH x ``seq`` tokens:
    loss finite, every leaf moved; then GEN_TRAIN_STEPS - 1 timed steps."""
    from repro_torch.bridge import leaves
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import lm
    from repro_torch.optim.optimizer import OptimizerConfig, make_optimizer

    opt = make_optimizer(OptimizerConfig(total_steps=10, warmup_steps=0))
    tokens = make_batch(DataConfig(seed=1, vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=GEN_TRAIN_BATCH), 0)["tokens"]
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    step = lm.make_train_step(cfg, opt)
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    _zeroed(counters)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    new, metrics = step(state, batch)
    _sync(dev)
    loss = metrics["loss"].item()
    still = [i for i, (a, b) in enumerate(zip(leaves(params), leaves(new["params"])))
             if torch.equal(a, b)]
    check(np.isfinite(loss), f"{cfg.name} train step: loss {loss}")
    check(not still, f"{cfg.name} train step: leaves {still} did not move")
    state = new
    del new
    t0 = time.perf_counter()
    for _ in range(GEN_TRAIN_STEPS - 1):
        state, metrics = step(state, batch)
    _sync(dev)
    _no_hand_kernels(f"{cfg.name} make_train_step", counters)
    ms = 1e3 * (time.perf_counter() - t0) / max(GEN_TRAIN_STEPS - 1, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    log(f"make_train_step({cfg.name}, AdamW, remat, {GEN_TRAIN_BATCH} x {seq} tokens, "
        f"{cfg.compute_dtype} compute): loss {loss!r} then {metrics['loss'].item()!r}, grad norm "
        f"{metrics['grad_norm'].item():.4g}, every one of {len(leaves(params))} leaves moved: "
        f"{not still}; {ms:.2f} ms a step ({GEN_TRAIN_BATCH * seq * 1e3 / ms:.1f} tokens/s; "
        f"host clock, synced, mean of {GEN_TRAIN_STEPS - 1} after the first), peak "
        f"{peak:.2f} GiB allocated, on {smi}")


def _generic_vs_cpu(dev, smi, cfg):
    """The same 2-layer, full-width f32 weights on the card and on the CPU:
    forward logits and every ``loss_fn`` gradient leaf."""
    from repro_torch import bridge
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import lm, transformer as T

    c = cfg.replace(num_layers=GEN_CPU_LAYERS, compute_dtype="float32")
    params = T.init_lm(7, c, device=dev)
    host = bridge.to_torch(params, "cpu", None)
    b, s = GEN_CPU_TOKENS
    tokens = torch.from_numpy(make_batch(DataConfig(seed=2, vocab_size=c.vocab_size, seq_len=s,
                                                    global_batch=b), 0)["tokens"])
    with torch.no_grad():
        on_card, _, _ = T.forward(params, {"tokens": tokens.to(dev)}, c)
        on_cpu, _, _ = T.forward(host, {"tokens": tokens}, c)
    gap = _max_gap(on_card.cpu(), on_cpu)
    (loss_card, _), g_card = lm.value_and_grad(params, {"tokens": tokens.to(dev)}, c)
    (loss_cpu, _), g_cpu = lm.value_and_grad(host, {"tokens": tokens}, c)
    rel = _leaf_rel(bridge.to_torch(g_card, "cpu", None), g_cpu)
    worst = max(rel, key=rel.get)
    log(f"  {c.name} at {GEN_CPU_LAYERS} layers, f32, card vs CPU on the same weights "
        f"({b} x {s} tokens): logits {gap:.3g} (limit {GEN_CPU_LOGITS_ATOL}; largest "
        f"|logit| {on_cpu.abs().max().item():.3g}), loss {loss_card.item()!r} vs "
        f"{loss_cpu.item()!r}, gradients |card - cpu| / max|cpu| largest {rel[worst]:.3g} "
        f"({worst}; limit {GEN_CPU_GRAD_REL}); {smi} against the host's CPU")
    check(gap <= GEN_CPU_LOGITS_ATOL, f"{c.name}: card vs CPU logits {gap:.3g}")
    for name, r in rel.items():
        check(r <= GEN_CPU_GRAD_REL, f"{c.name}: card vs CPU gradient {name}: {r:.3g}")


def _generic_other(dev, smi, name, counters):
    """One more config at full width in f32: its prefill on its modality's
    batch, decode from the cache against the forward, granite's MoE layer
    against the dense oracle."""
    from repro_torch.models import lm, moe, transformer as T

    cfg = lm.get_config(name).replace(compute_dtype="float32")
    _zeroed(counters)
    t0 = time.perf_counter()
    params = T.init_lm(0, cfg, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n = T.num_params(params)
    batch = _generic_batch(cfg, dev, GEN_BATCH, GEN_PREFILL)
    prefill = lm.make_prefill_step(cfg)
    prefill(params, batch)                        # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    last, cache = prefill(params, batch)
    _sync(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    tokens = sum(v.shape[1] for k, v in batch.items() if k != "labels")
    check(last.shape == (GEN_BATCH, 1, cfg.vocab_size) and bool(torch.isfinite(last).all()),
          f"{name} prefill logits {tuple(last.shape)}, finite {bool(torch.isfinite(last).all())}")
    del cache
    short = {k: v[:, :GEN_DECODE] for k, v in batch.items() if k in ("tokens", "embeds")}
    if cfg.modality == "vision_stub":             # decode feeds text; no image prefix
        short["image_embeds"] = batch["image_embeds"][:, :0]
    # An MoE drops tokens past its capacity, which the forward's groups of
    # GEN_DECODE tokens reach and a decode step's one token never does: the
    # two are compared at a capacity factor of E / k, where nothing drops.
    ample = (cfg.replace(capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
             if cfg.family == "moe" else cfg)
    gap, step_ms = _decode_vs_forward(params, ample, short, GEN_DECODE, dev)
    check(gap <= GEN_DECODE_ATOL, f"{name}: decode vs forward {gap:.3g} > {GEN_DECODE_ATOL}")
    extra = ""
    if cfg.family == "moe":
        p0 = T.layer_params(params["layers"], 0)["moe"]
        x = torch.randn((GEN_BATCH, GEN_PREFILL, cfg.d_model),
                        generator=torch.Generator(dev).manual_seed(3), device=dev)
        with torch.no_grad():
            y, aux = moe.moe_apply(p0, x, ample)
            y_dense = moe.moe_apply_dense(p0, x, ample)
        moe_gap = _max_gap(y, y_dense)
        check(moe_gap <= GEN_CPU_LOGITS_ATOL,
              f"{name}: moe_apply vs moe_apply_dense {moe_gap:.3g} > {GEN_CPU_LOGITS_ATOL}")
        extra = (f"; layer 0's moe_apply (capacity factor {ample.capacity_factor:g}: no drops) vs "
                 f"moe_apply_dense {moe_gap:.3g} (limit {GEN_CPU_LOGITS_ATOL}; |y| max "
                 f"{y.abs().max().item():.3g}), aux {aux.item():.4g}")
    _no_hand_kernels(name, counters)
    log(f"  {name} ({cfg.family}, {cfg.modality}; {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{n / 1e9:.3f} B parameters made in {init_s:.2f} s): prefill of {GEN_BATCH} x {tokens} "
        f"tokens {prefill_ms:.2f} ms, decode {GEN_DECODE} tokens from cache_init {step_ms:.3f} ms "
        f"a step, vs forward {gap:.3g} (limit {GEN_DECODE_ATOL}"
        f"{'; both at capacity factor E / k' if cfg.family == 'moe' else ''}){extra}; f32, "
        f"TF32 off, on {smi}")
    del params, batch, last
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def phase_generic_lm(dev, smi, arch=GEN_ARCH, others=GEN_OTHERS, train_seq=GEN_TRAIN_SEQ):
    """The generic LM families (``models/transformer.py``) at full width:
    :func:`_generic_serve`, :func:`_generic_train` and :func:`_generic_vs_cpu`
    on ``arch``, then :func:`_generic_other` on each of ``others``, and the
    GEN_META configs counted on the meta device.  With a CPU ``dev`` and smoke
    archs it rehearses the same paths."""
    from repro_torch.models import lm, transformer as T

    t_phase = time.perf_counter()
    counters = _counters()
    params = _generic_serve(dev, smi, arch, counters)
    fail_if_any("phase 14 (serve)")
    cfg = lm.get_config(arch)
    _generic_train(dev, smi, cfg, params, counters, train_seq)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fail_if_any("phase 14 (train)")
    _generic_vs_cpu(dev, smi, cfg)
    fail_if_any("phase 14 (card vs CPU)")
    log(f"phase 14 (continued): {len(others)} more configs at full width, f32, one at a time")
    for name in others:
        _generic_other(dev, smi, name, counters)
    fail_if_any("phase 14 (other configs)")
    for name in GEN_META:
        c = lm.get_config(name)
        n = T.num_params(T.init_lm(0, c, device="meta"))
        log(f"  {name}: {n / 1e9:.3f} B parameters ({c.param_dtype}), counted on the meta device "
            f"({n * torch.finfo(getattr(torch, c.param_dtype)).bits / 8 / 2**30:.1f} GiB: more "
            "than one card holds)")
    log(f"phase 14 in {time.perf_counter() - t_phase:.1f} s")


# The generic trainer (``launch/train.py::train``) as its CLI runs it, on
# GEN_ARCH at full width: GT_STEPS AdamW steps of GT_BATCH x GT_SEQ tokens with
# no checkpoint directory, then as many with int8 error-feedback compression
# (the same schedule and data: both runs show the same loss spike at step 3,
# so a run of 6 steps, whose last three straddle it, cannot show a falling
# loss); the restart (GT_RESTART_STEPS uninterrupted against
# stop_after=GT_RESTART_STOP and a resume) and the card against the CPU (the
# first GT_CPU_STEPS losses, GT_CPU_TOKENS) at GT_CUT_LAYERS layers of the
# full width, f32 compute, TF32 off; then the dry run (``launch/dryrun.py``)
# of every arch x cell x production mesh on meta, and its one-device record of
# GT_BATCH x GT_SEQ against the card.  No Pallas kernel is on this path, so no
# hand kernel may launch in it.
GT_STEPS, GT_BATCH, GT_SEQ = 12, 4, 512
GT_CUT_LAYERS, GT_RESTART_STEPS, GT_RESTART_STOP = 2, 8, 4
GT_CPU_STEPS, GT_CPU_TOKENS = 3, (2, 64)
GT_CUT = f"{GEN_ARCH}-{GT_CUT_LAYERS}-layers-f32"
# The restart on the card against the uninterrupted run: the reference's own
# bound (tests/test_train_integration.py).  The embedding gradient is an
# indexed accumulate, whose order CUDA does not fix, so the two runs may part
# by a few ulps.
GT_RESTART_TOL = dict(rtol=1e-5, atol=1e-6)
# train()'s first losses on the card against the CPU from the same weights,
# relative: f32 sums in another order (cuBLAS against the CPU's BLAS), as
# phase 14's GEN_CPU_* bounds, carried through two AdamW updates of lr 3e-4.
GT_CPU_LOSS_RTOL = 1e-4
# The dry run's argument bytes against the card's allocation for the same
# state and batch: the caching allocator rounds each block up (512 B).
GT_ARG_REL = 1e-3
# The compressed run's losses against the plain run's, step by step,
# relative.  Error feedback re-injects each step's int8 rounding into the
# next step, so the two runs part only by that rounding, carried through
# AdamW (the largest gap of the sound runs: 1.64e-3).  A broken compression
# runs as a control and must part by more: one scale for a whole tensor in
# place of one per 256-element block (read 0.248).  A second control, the
# residual never fed back, parts by less than the sound run (read 9.39e-4):
# the loss cannot see the residual in GT_STEPS steps, so its gap is only
# printed.  One step's error feedback on the card is held to its two
# invariants instead (:func:`_gt_feedback_identity`), and train()'s wiring
# of the residual against the JAX package on the CPU
# (tests/test_torch_generic_train.py, where a dropped residual fails).
GT_COMPRESS_GAP = 5e-3


def _gt_train(dev, smi, counters, *, compress):
    """``train(GEN_ARCH)`` at full width for GT_STEPS steps: losses finite and
    falling, no hand kernel; ms a step (median after the first), tokens/s,
    peak GiB.  Returns (median ms, losses, state)."""
    from repro_torch.distributed.fault_tolerance import StepWatchdog
    from repro_torch.launch.train import train
    from repro_torch.models import lm

    wd = StepWatchdog()
    _zeroed(counters)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses = train(GEN_ARCH, steps=GT_STEPS, batch=GT_BATCH, seq_len=GT_SEQ,
                          compress_grads=compress, device=dev, log_every=4, watchdog=wd)
    wall = time.perf_counter() - t0
    label = f"train({GEN_ARCH}{', compress_grads=True' if compress else ''})"
    _no_hand_kernels(label, counters)
    times = list(wd.times)
    ms = 1e3 * float(np.median(times[1:]))
    finite = all(np.isfinite(losses))
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(len(losses) == GT_STEPS and finite, f"{label}: {len(losses)} losses, finite {finite}")
    check(last < first, f"{label}: last-3 mean {last!r} not below first-3 mean {first!r}")
    log(f"{label}, {GT_STEPS} AdamW steps of {GT_BATCH} x {GT_SEQ} tokens (f32 parameters, "
        f"{lm.get_config(GEN_ARCH).compute_dtype} compute): losses {[round(x, 4) for x in losses]}; "
        f"first-3 mean {first:.4f} -> last-3 mean {last:.4f}; {ms:.2f} ms a step (median of "
        f"{len(times) - 1} after the first; host clock, each step ending in its loss read), "
        f"{GT_BATCH * GT_SEQ * 1e3 / ms:.1f} tokens/s, first step {1e3 * times[0]:.1f} ms, "
        f"{wall:.1f} s in all with init; peak {_peak_gib(dev):.2f} GiB allocated; on {smi}")
    return ms, losses, state


def _loss_gap(losses, plain) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(losses, plain))


def _gt_compress_controls(dev, smi, counters, plain, gap):
    """The compressed run's loss gap to the plain run against GT_COMPRESS_GAP,
    and the two controls (each a train() run of GT_STEPS steps with one piece
    of ``distributed/compression.py`` replaced): the gate must fail on the
    wrong scale; the dropped residual's gap is printed."""
    from unittest import mock

    from repro_torch.distributed import compression
    from repro_torch.launch import train as ttrain

    feedback = compression.tree_error_feedback

    def no_feedback(grads, residuals):
        return feedback(grads, compression.init_residuals(grads))

    def one_scale(g):
        flat, _ = compression._pad_to_block(g.to(torch.float32))
        blocks = flat.reshape(-1, compression.BLOCK)
        scale = blocks.abs().amax() / 127.0
        q = torch.clamp(torch.round(blocks / scale.clamp_min(1e-12)), -127, 127)
        return q.to(torch.int8), scale.expand(blocks.shape[0])

    check(gap <= GT_COMPRESS_GAP, f"compress_grads: losses part from the plain run's by {gap:.3g} "
                                  f"relative (limit {GT_COMPRESS_GAP})")
    read = {}
    for name, module, attr, broken in (("one scale a tensor", compression, "compress", one_scale),
                                       ("residual not fed back", ttrain, "tree_error_feedback",
                                        no_feedback)):
        _zeroed(counters)
        with mock.patch.object(module, attr, broken):
            _, losses = ttrain.train(GEN_ARCH, steps=GT_STEPS, batch=GT_BATCH, seq_len=GT_SEQ,
                                     compress_grads=True, device=dev, log_every=100)
        _no_hand_kernels(f"compress_grads control ({name})", counters)
        read[name] = _loss_gap(losses, plain)
        _empty(dev)
    if dev.type == "cuda":      # the readings are the full width's; a CPU rehearsal is smaller
        check(read["one scale a tensor"] > GT_COMPRESS_GAP,
              f"compress_grads control (one scale a tensor): its losses part from the plain run's "
              f"by only {read['one scale a tensor']:.3g}")
    log(f"  compress_grads loss gap to the plain run {gap:.3g} relative (limit "
        f"{GT_COMPRESS_GAP}); the controls: one scale a tensor {read['one scale a tensor']:.3g} "
        f"(must exceed the limit), residual not fed back {read['residual not fed back']:.3g} "
        f"(printed); {smi}")


def _gt_feedback_identity(dev, state):
    """One step's int8 error feedback on the card, at the path's leaves: the
    gradients of batch 0 at the compressed run's last parameters and that
    run's residuals R (nonzero).  With c = g + R in blocks of 256 and s a
    block's max |c| / 127, the estimate and the new residual must carry c
    (g_hat + R' == c to f32 rounding: a residual not fed back misses by R)
    and R' must stay within half a step of its own block (|R'| <= s / 2 to
    rounding: a scale wider than the block's breaks it)."""
    from repro_torch.bridge import leaves
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.compression import BLOCK, _pad_to_block, tree_error_feedback
    from repro_torch.launch.train import data_config_for
    from repro_torch.models import lm

    cfg = lm.get_config(GEN_ARCH)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             make_batch(data_config_for(cfg, GT_BATCH, GT_SEQ, 0), 0).items()}
    _, grads = lm.value_and_grad(state["params"], batch, cfg)
    res = state["ef_residual"]
    g_hat, new_res = tree_error_feedback(grads, res)
    ulp = 2.0 ** -23
    n = missed = wide = nonzero = 0
    for g, r, gh, rn in zip(leaves(grads), leaves(res), leaves(g_hat), leaves(new_res)):
        c, gh, rn = (_pad_to_block(x)[0].reshape(-1, BLOCK) for x in (g.float() + r, gh, rn))
        step = c.abs().amax(dim=1, keepdim=True) / 127.0
        missed += int(((gh + rn - c).abs() > ulp * (c.abs() + step)).sum())
        wide += int((rn.abs() > 0.5 * step + 2 * ulp * c.abs()).sum())
        nonzero += int((r != 0).sum())
        n += g.numel()
    check(missed == 0 and wide == 0,
          f"compress_grads: error feedback on the card: {missed} of {n} elements not carried "
          f"(g_hat + R' != g + R), {wide} residuals past half their block's step")
    log(f"  compress_grads: one step's int8 error feedback on the card, {n} gradient elements, "
        f"{nonzero} nonzero residuals carried in: {missed} not carried, {wide} residuals past half "
        f"their block's step")


def _peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")


def _gt_profile(dev, smi, state):
    """One step of ``train()``'s path under the profiler: the batch's copy to
    the card, ``make_train_step`` (AdamW, the run's own schedule) and the
    loss read; device busy against the profiled wall."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.train import data_config_for
    from repro_torch.models import lm
    from repro_torch.optim.optimizer import OptimizerConfig, make_optimizer

    cfg = lm.get_config(GEN_ARCH)
    opt = make_optimizer(OptimizerConfig(lr=3e-4, total_steps=GT_STEPS,
                                         warmup_steps=max(1, GT_STEPS // 20)))
    step = lm.make_train_step(cfg, opt)
    dcfg = data_config_for(cfg, GT_BATCH, GT_SEQ, 0)

    def run():
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(dcfg, 0).items()}
        _, metrics = step(state, batch)
        float(metrics["loss"])

    _profile(f"train({GEN_ARCH}) step, {GT_BATCH} x {GT_SEQ} tokens ({smi})", run, {}, tries=1,
             inference=False)


def _register_cut():
    """GEN_ARCH at full width, cut to GT_CUT_LAYERS layers, f32 compute, in
    the registry under GT_CUT (``train()`` takes an arch name)."""
    from repro_torch.models import lm

    cfg = lm.get_config(GEN_ARCH).replace(name=GT_CUT, num_layers=GT_CUT_LAYERS,
                                          compute_dtype="float32")
    lm.register(GT_CUT)(lambda: cfg)
    return cfg


def _gt_restart(dev, smi, counters):
    """GT_RESTART_STEPS uninterrupted steps against stop_after=GT_RESTART_STOP
    plus a resume, in a temporary directory; the checkpoint's size and the
    wall time of a save and a restore of that state."""
    import tempfile

    from repro_torch.bridge import leaves
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.train import train

    kw = dict(steps=GT_RESTART_STEPS, batch=GT_BATCH, seq_len=GT_SEQ, device=dev, log_every=100)
    _zeroed(counters)
    full, losses = train(GT_CUT, **kw)
    with tempfile.TemporaryDirectory(prefix="gt_restart_") as d:
        _, first = train(GT_CUT, ckpt_dir=d, stop_after=GT_RESTART_STOP, **kw)
        resumed, rest = train(GT_CUT, ckpt_dir=d, **kw)
        _no_hand_kernels(f"train({GT_CUT}) restart", counters)
        gaps = [_max_gap(a, b) for a, b in zip(leaves(full["params"]), leaves(resumed["params"]))]
        close = all(torch.allclose(b, a, **GT_RESTART_TOL)
                    for a, b in zip(leaves(full["params"]), leaves(resumed["params"])))
        check(close, f"{GT_CUT}: restart vs uninterrupted params beyond {GT_RESTART_TOL} "
                     f"(largest gap {max(gaps):.3g})")
        check(int(resumed["step"]) == GT_RESTART_STEPS, f"{GT_CUT}: resumed to step "
                                                        f"{int(resumed['step'])}")
        _sync(dev)
        t0 = time.perf_counter()
        path = ckpt.save(Path(d) / "timed", GT_RESTART_STEPS, resumed)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in path.iterdir())
        t0 = time.perf_counter()
        back, _ = ckpt.restore(Path(d) / "timed", resumed)
        _sync(dev)
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(resumed)))
        check(same, f"{GT_CUT}: a restored checkpoint differs from the state saved")
    n = sum(x.numel() for x in leaves(full["params"]))
    log(f"  restart ({GT_CUT}, {n / 1e9:.3f} B parameters, {GT_BATCH} x {GT_SEQ} tokens): "
        f"{GT_RESTART_STEPS} uninterrupted steps vs {GT_RESTART_STOP} + stop + resume to "
        f"{GT_RESTART_STEPS}: params within {GT_RESTART_TOL}: {close}, largest gap "
        f"{max(gaps):.3g}; losses {[round(x, 5) for x in losses]} vs "
        f"{[round(x, 5) for x in first + rest]}; checkpoint {size / 2**30:.2f} GiB, save "
        f"{save_s:.2f} s, restore {restore_s:.2f} s (host clock, this machine's disk); on {smi}")


def _gt_vs_cpu(dev, smi):
    """The first GT_CPU_STEPS losses of ``train()`` on the card and on the CPU
    from the same GT_CUT weights."""
    from repro_torch import bridge
    from repro_torch.launch.train import train
    from repro_torch.models import lm, transformer as T

    params = T.init_lm(7, lm.get_config(GT_CUT), device=dev)
    host = bridge.to_torch(params, "cpu", None)
    b, s = GT_CPU_TOKENS
    kw = dict(steps=GT_CPU_STEPS, batch=b, seq_len=s, log_every=100)
    _, on_card = train(GT_CUT, init=params, device=dev, **kw)
    t0 = time.perf_counter()
    _, on_cpu = train(GT_CUT, init=host, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    rel = [abs(a - c) / abs(c) for a, c in zip(on_card, on_cpu)]
    check(max(rel) <= GT_CPU_LOSS_RTOL, f"{GT_CUT}: card vs CPU losses {on_card} vs {on_cpu}")
    log(f"  card vs CPU ({GT_CUT}, same weights, {b} x {s} tokens, f32, TF32 off): losses "
        f"{[repr(x) for x in on_card]} vs {[repr(x) for x in on_cpu]}, relative gaps "
        f"{[f'{r:.3g}' for r in rel]} (limit {GT_CPU_LOSS_RTOL}); the CPU's {GT_CPU_STEPS} "
        f"steps {cpu_s:.1f} s; {smi} against the host's CPU")


# Processes of the dry-run sweep, an (arch, mesh) pair to each (meta only).
# It runs beside phases 8-13, which time nothing on the host clock that the
# sweep's cores would move (started beside phase 2, it slowed phase 3's slot
# batches up to 3x): 3 of the host's 8 cores.
SWEEP_WORKERS = 3


def _dry_sweep():
    """The whole dry-run sweep on meta (every assigned arch and cell, both
    meshes) and its seconds on the host clock: phase 15's records, made in a
    process of its own (``main`` submits it before phase 8)."""
    from repro_torch.configs import ASSIGNED_ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPE_CELLS

    t0 = time.perf_counter()
    records = dryrun.sweep(ASSIGNED_ARCHS, [c.name for c in SHAPE_CELLS], [False, True],
                           verbose=False, workers=SWEEP_WORKERS)
    return records, time.perf_counter() - t0


def _gt_dryrun(dev, smi, sweep):
    """The whole dry-run sweep on meta (``sweep``: the future of
    :func:`_dry_sweep`; counts, SKIP only where ``cell_supported`` says so,
    no FAIL), then the one-device record of the GT_BATCH x GT_SEQ training
    step of GEN_ARCH against the card: its argument bytes against the
    allocation of that state and batch, its temporaries beside the measured
    peak of one step."""
    from repro_torch.configs import ASSIGNED_ARCHS
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import data_config_for
    from repro_torch.models import lm, transformer as T
    from repro_torch.models.config import SHAPE_CELLS, ShapeCell, cell_by_name, cell_supported
    from repro_torch.optim.optimizer import OptimizerConfig, make_optimizer

    t0 = time.perf_counter()
    records, sweep_s = _result(sweep, "phase 15: the dry-run sweep's process")
    wait_s = time.perf_counter() - t0
    n = {st: sum(r["status"] == st for r in records) for st in ("OK", "SKIP", "FAIL")}
    for r in records:
        if r["status"] == "FAIL":
            check(False, f"dry run {r['arch']} x {r['cell']} x {r['mesh']}: {r['error']}")
        if r["status"] == "SKIP":
            ok, _ = cell_supported(lm.get_config(r["arch"]), cell_by_name(r["cell"]))
            check(r["cell"] == "long_500k" and not ok,
                  f"dry run skipped {r['arch']} x {r['cell']} x {r['mesh']}")
        if r["status"] == "OK":
            check(bool(r["collective_bytes_per_device"]) and "collective_note" not in r,
                  f"dry run {r['arch']} x {r['cell']} x {r['mesh']}: no collective bytes")
    slow = sorted((r for r in records if "trace_s" in r), key=lambda r: -r["trace_s"])[:3]
    log(f"  dry run: {len(ASSIGNED_ARCHS)} archs x {len(SHAPE_CELLS)} cells x 2 meshes on meta "
        f"in {SWEEP_WORKERS} processes: "
        f"{n['OK']} OK, {n['SKIP']} SKIP, {n['FAIL']} FAIL in {sweep_s:.1f} s (host clock, "
        f"beside phases 8-15; {wait_s:.1f} s waited for here; the "
        "slowest: " + ", ".join(f"{r['arch']} x {r['cell']} {r['trace_s']:.1f} s" for r in slow)
        + ")")

    cfg = lm.get_config(GEN_ARCH)
    cell = ShapeCell("phase15_train", GT_SEQ, GT_BATCH, "train")
    one = dryrun.AbstractMesh((1, 1), ("data", "model"))
    rec = dryrun.dryrun_cell(GEN_ARCH, cell, mesh=one, save=False, verbose=False)
    check(rec["status"] == "OK", f"dry run of {GEN_ARCH} x {cell}: {rec.get('error')}")
    c, whole = dryrun.build_cell(GEN_ARCH, cell, mesh=one), dryrun.StepRecorder()
    with whole:
        out = c.call()
    del out, c
    check((rec["flops"], rec["bytes_accessed"]) == (whole.flops, whole.bytes),
          f"dry run of {GEN_ARCH} x {cell}: FLOPs and bytes from the traced depths "
          f"{rec['flops']}, {rec['bytes_accessed']} vs the whole step's {whole.flops}, {whole.bytes}")
    _empty(dev)
    base = _allocated(dev)
    params = T.init_lm(0, cfg, device=dev)
    opt = make_optimizer(OptimizerConfig(kind=cfg.opt_kind, b1=cfg.opt_b1,
                                         state_dtype=cfg.opt_state_dtype,
                                         master_weights=cfg.opt_master_weights))
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             make_batch(data_config_for(cfg, GT_BATCH, GT_SEQ, 0), 0).items()}
    _sync(dev)
    held = _allocated(dev) - base
    args = rec["memory"]["argument_size_in_bytes"]
    rel = abs(held - args) / args
    if dev.type == "cuda":
        check(rel <= GT_ARG_REL, f"dry run arguments {args} B vs the card's {held} B ({rel:.3g})")
        torch.cuda.reset_peak_memory_stats()
    out = lm.make_train_step(cfg, opt)(state, batch)
    _sync(dev)
    peak = _peak_gib(dev) * 2**30 - base - held
    del out, state, batch
    temp = rec["memory"]["temp_size_in_bytes"]
    log(f"  dry run of {GEN_ARCH} x {GT_BATCH} x {GT_SEQ} train on one device: arguments "
        f"{args} B against {held} B allocated for that state and batch on the card (gap {rel:.3g}, "
        f"limit {GT_ARG_REL}); temporaries {temp / 2**30:.3f} GiB (extended from traced layers "
        f"{rec['traced_layers']}), {whole.peak / 2**30:.3f} GiB traced at all "
        f"{cfg.num_layers} layers, beside {peak / 2**30:.3f} GiB measured above the arguments at "
        f"the peak of one step (reported); {rec['flops'] / 1e12:.2f} TFLOP, "
        f"{rec['bytes_accessed'] / 2**30:.1f} GiB of operation traffic; {smi}")
    _empty(dev)


def _allocated(dev) -> int:
    return torch.cuda.memory_allocated() if dev.type == "cuda" else 0


def _empty(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def phase_generic_train(dev, smi, sweep):
    """Phase 15: :func:`_gt_train` plain and compressed, a profiled step,
    :func:`_gt_restart`, :func:`_gt_vs_cpu`, :func:`_gt_dryrun` (``sweep``:
    the future of :func:`_dry_sweep`)."""
    t_phase = time.perf_counter()
    counters = _counters()
    ms, losses, state = _gt_train(dev, smi, counters, compress=False)
    if dev.type == "cuda":
        _gt_profile(dev, smi, state)
    del state
    _empty(dev)
    ms_c, losses_c, state = _gt_train(dev, smi, counters, compress=True)
    log(f"  compress_grads: {ms_c:.2f} ms a step against {ms:.2f} plain (+{ms_c - ms:.2f} ms)")
    _gt_feedback_identity(dev, state)
    del state
    _empty(dev)
    _gt_compress_controls(dev, smi, counters, losses, _loss_gap(losses_c, losses))
    fail_if_any("phase 15 (train)")
    _register_cut()
    _gt_restart(dev, smi, counters)
    _empty(dev)
    _gt_vs_cpu(dev, smi)
    fail_if_any("phase 15 (restart, card vs CPU)")
    _gt_dryrun(dev, smi, sweep)
    fail_if_any("phase 15 (dry run)")
    log(f"phase 15 in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phases 16 and 17: the generic LM's SPMD steps on a gloo world; phase 18: the sp preset
# ---------------------------------------------------------------------------

SPMD_RANKS, SPMD_MESH = 4, (2, 2)
SPMD_DEPTH = 2                  # llama3.2-1b's 16 layers cut to 2 (phase 17 shares the time limit)
SPMD_TRAIN = (4, 512)           # batch x tokens of the train steps
SPMD_PREFILL = (4, 32)          # batch x prompt tokens
SPMD_STEPS = 2                  # greedy decode steps after the prefill (cut from 8: the 1200 s limit)
SPMD_SEED = 0
SPMD_TIMEOUT = 600.0
# The sharded steps against the single-device ones on the card, same weights,
# f32 compute, TF32 off: the same sums split over 2 model and 2 data ranks
# and met in gloo's sums.  The loss within SPMD_LOSS_RTOL, grad_norm within
# GEN_CPU_GRAD_REL, logits within GEN_CPU_LOGITS_ATOL, the optimizer states
# and caches within GEN_CPU_GRAD_REL of each leaf's largest magnitude, the
# parameters so wherever the single-device step is well posed (``_posed``,
# from that step's own state) and, elsewhere, AdamW's within
# lr * (1 + weight decay * |p|) of it (its first step is lr * g / (|g| + eps):
# set by the gradient's sign, so a gradient that is zero but for rounding
# turns on rounding noise); Adafactor's ill-posed elements, where the
# factored row x col underflows f32 and the step divides by its clamp, are
# counted and reported.  A greedy token may differ only where the
# single-device top-2 margin of the logits that chose it is at most
# SPMD_MARGIN; a row's logits are compared up to that step.
SPMD_LOSS_RTOL = 1e-5
SPMD_WELL_POSED = 1e-6
SPMD_MARGIN = 1e-4
SPMD_OPT = dict(warmup_steps=0, total_steps=10)   # the default lr 5e-4 from step 0
# (arch, depth kept or None for the whole config, prefill batch x tokens,
# presets run in turn in its one world; phase_spmd's ``presets`` where the
# tuple has three entries).  Phase 16 the dense kind; phase 17 the MoE, SSM
# and hybrid kinds, recurrentgemma first, whose single-device step needs
# most of the card.  llama3.2-1b and granite run under base, fsdp and zero2
# in one world each (under fsdp and zero2 granite's MoE is device-local,
# each rank's experts gathered whole): one world start and one
# single-device reference serve all three presets.
# granite at 2 of its 32 layers and mamba2-130m at 4 of its 24 (cut from 8
# and all: the script's 1200 s limit; every layer of each is of one kind),
# recurrentgemma at one rec, rec, attn_local period with a prompt as
# long as its window, so that the decode steps wrap the ring.  An
# MoE also takes one train step under kimi's Adafactor settings (factored
# second moment, no first moment).
SPMD_PRESETS = ("base", "fsdp", "zero2")
SPMD16 = ((GEN_ARCH, SPMD_DEPTH, SPMD_PREFILL, SPMD_PRESETS),)
SPMD17 = (("recurrentgemma-9b", 3, (2, 2048), ("base",)),
          ("granite-moe-3b-a800m", 2, (4, 32), SPMD_PRESETS), ("mamba2-130m", 4, (4, 32), ("base",)))
SPMD_ADAFACTOR = dict(kind="adafactor", b1=0.0)
# Phase 18: the sp preset is refused before any step: its logits' spec
# ("batch", "seq", "vocab") names ``model`` twice, as the reference's
# NamedSharding refuses it.  Beside the worlds of phases 16 and 17, a process
# of its own records on meta the collective operand bytes of a rank of
# GEN_ARCH's train_4k cell on the production mesh (PRESET_BYTES_MESH) under
# each of SPMD_PRESETS.
PRESET_BYTES_MESH = (16, 16)
# The mesh's psums move an MoE block's input by ulps, so a token whose k-th
# and (k+1)-th router probabilities nearly tie may pick another expert there:
# every rank compares the experts it picked with the single device's.  A step
# in which none flipped is held in full.  Where some did, a train step's loss
# and grad_norm are held within SPMD_FLIP_SHARE token shares a flipped token
# (SPMD_FLIP_SHARE * flipped tokens / tokens; a CPU rehearsal that forced
# flips of 4 tokens of 256 at smoke width moved them by 0.001 and 0.84
# shares) and its
# state is reported: the flip reaches every token of its row through
# attention (that rehearsal moved an expert no flipped token visited by 6% of
# its leaf's scale), and a row of 512 tokens visits every expert.  A prefill
# or decode step holds the rows with no flip.  The smallest top-k gap and
# the count within ROUTER_MARGIN are reported.
SPMD_FLIP_SHARE = 10
ROUTER_MARGIN = 1e-6


def _spmd_cfg(arch, depth=None):
    """``arch`` in f32 compute, cut to ``depth`` layers (None: all)."""
    from repro_torch.models import lm

    cfg = lm.get_config(arch).replace(compute_dtype="float32")
    return cfg if depth is None else cfg.replace(num_layers=depth)


class _CollectiveTally(TorchDispatchMode):
    """The operand bytes of each collective kind a step issues, by HLO name
    (what ``launch.dryrun.StepRecorder`` keeps as ``collectives``), and
    nothing else: every operation passes straight through, so the timed step
    pays one Python call an operation and no bookkeeping."""

    def __init__(self):
        super().__init__()
        self.collectives: dict[str, int] = {}

    def record_collective(self, entry: dict) -> None:
        self.collectives[entry["hlo"]] = self.collectives.get(entry["hlo"], 0) + entry["operand_bytes"]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _spmd_inputs(cfg, train, prefill):
    rng = np.random.default_rng(SPMD_SEED)
    return (rng.integers(0, cfg.vocab_size, train).astype(np.int32),
            rng.integers(0, cfg.vocab_size, prefill).astype(np.int32))


def _to(tree, dev):
    from repro_torch.bridge import leaves, rebuild

    return rebuild(tree, iter(x.to(dev) for x in leaves(tree)))


def _device_of(tree):
    from repro_torch.bridge import leaves

    return leaves(tree)[0].device


def _release(ref: dict) -> None:
    """Drop a rank's references to the parent's tensors before it exits: a
    tensor received by CUDA IPC that a rank still holds at exit is never
    released, and the parent could not free it for the phases after."""
    ref.clear()
    gc.collect()


def _leaf_scale(w):
    """A leaf's largest magnitude (the scale its gaps are taken over)."""
    return w.abs().max().clamp(min=1e-30)


def _top2(lg):
    """Each row's gap between its two largest logits, (B,)."""
    top = lg[:, 0].topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def _lay_cache(cache, full):
    """A prefill's cache laid into a decode cache ``full``: each leaf along
    the first dim where the two differ (the sequence), ``full``'s later
    slots kept; a leaf with no such dim (a state, a ring as long) as it is."""
    from repro_torch.bridge import leaves, rebuild

    def lay(c, f):
        diff = [i for i, (a, b) in enumerate(zip(c.shape, f.shape)) if a != b]
        if not diff:
            return c
        d = diff[0]
        return torch.cat([c, f.narrow(d, c.shape[d], f.shape[d] - c.shape[d])], dim=d)

    return rebuild(full, iter(lay(c, f) for c, f in zip(leaves(cache), leaves(full))))


def _margins(routes):
    """(smallest router top-k margin, routings within ROUTER_MARGIN) of one
    step's routings (``moe.routings()``'s pairs), or None for a model
    without a router."""
    if not routes:
        return None
    every = torch.cat([m.float().flatten() for m, _ in routes])
    return float(every.min()), int((every <= ROUTER_MARGIN).sum())


def _posed(ocfg, v, m):
    """Where the single-device step of one parameter is well posed, from
    that step's own new state (``v``, ``m``: the parameter's second and
    first moments, or their blocks): AdamW's where its first moment says the
    clipped gradient exceeds SPMD_WELL_POSED; Adafactor's factored leaves
    where row x col is a normal f32 (below it the product underflows and
    the step divides by the clamp 1e-30), its unfactored ones where the
    second moment says the gradient exceeds SPMD_WELL_POSED."""
    if ocfg.kind == "adamw":
        return m.abs() > (1 - ocfg.b1) * SPMD_WELL_POSED
    if "row" in v:
        return v["row"][..., None] * v["col"][..., None, :] >= torch.finfo(torch.float32).tiny
    return v["full"] > (1 - ocfg.b2) * SPMD_WELL_POSED ** 2


def _state_scales(ocfg, new):
    """Each state tree's leaf scales of the single-device step's ``new``
    state, the parameters' over their well-posed elements."""
    from repro_torch.bridge import leaves, rebuild
    from repro_torch.optim.optimizer import _leaves_as

    scales = {k: rebuild(v, iter(_leaf_scale(x) for x in leaves(v)))
              for k, v in new.items() if k != "params"}
    params = new["params"]
    moms = _leaves_as(new["m"], params) if "m" in new else [None] * len(leaves(params))
    scales["params"] = rebuild(params, iter(
        _leaf_scale(p.abs().masked_fill_(~_posed(ocfg, v, m), 0.0))
        for p, v, m in zip(leaves(params), _leaves_as(new["v"], params), moms)))
    return scales


def _state_gaps(local, init, ref, specs, mesh, ocfg, posed_specs):
    """This rank's new state (``local``: its parameters and optimizer state
    trees, ``specs`` each tree's specs; ``posed_specs``: the moments' specs
    in the parameters' layout, which :func:`_posed` reads at the parameters'
    blocks) against the same blocks of the single-device one (``ref``, its
    ``scales`` from :func:`_state_scales`):
    each tree's largest gap over the leaf's scale, the parameters' where
    :func:`_posed` says the step is well posed (``gaps``); of the other
    parameter elements whether every one is within AdamW's one-step reach
    lr * (1 + wd * |p|) of the reference (``reach_ok``; Adafactor has none),
    their count (``ill_posed``, of ``elements``), how many lie off the
    reference by more than GEN_CPU_GRAD_REL of the leaf's scale
    (``ill_posed_off``) and their largest gap."""
    from repro_torch.bridge import leaves
    from repro_torch.distributed.sharding import NamedSharding, map_leaves
    from repro_torch.optim.optimizer import _leaves_as

    dev = _device_of(local)
    cut = lambda w, sp: w[NamedSharding(mesh, sp).local_slices(tuple(w.shape))]
    blocks = {k: map_leaves(cut, ref[k], specs[k]) for k in local}
    at_params = {k: map_leaves(cut, ref[k], posed_specs[k]) for k in ("m", "v") if k in ref}
    gaps = {}

    def note(k, err, scale):
        gaps[k] = max(gaps.get(k, 0.0), float(err.max() / scale))

    for k in local:
        if k != "params":
            for g, w, t in zip(leaves(local[k]), leaves(blocks[k]), leaves(ref["scales"][k])):
                note(k, (g - w.to(dev)).abs(), float(t))
            continue
        params = blocks["params"]
        moms = (_leaves_as(at_params["m"], params) if "m" in at_params
                else [None] * len(leaves(params)))
        reach, n_noisy, n_off, n_all, noisy_gap = True, 0, 0, 0, 0.0
        for g, w, t, p0, v, m in zip(leaves(local[k]), leaves(params), leaves(ref["scales"][k]),
                                     leaves(init), _leaves_as(at_params["v"], params), moms):
            err = (g - w.to(dev)).abs()
            posed = (_posed(ocfg, None, m.to(dev)) if ocfg.kind == "adamw"
                     else _posed(ocfg, _to(v, dev), None))
            note(k, torch.where(posed, err, 0.0), float(t))
            if (~posed).any():
                noisy_gap = max(noisy_gap, float(err[~posed].max()))
                n_off += int((err[~posed] > GEN_CPU_GRAD_REL * float(t)).sum())
                if ocfg.kind == "adamw":
                    reach &= bool((err[~posed] <= ocfg.lr * (1 + ocfg.weight_decay
                                                             * p0[~posed].abs()) + 1e-7).all())
            n_noisy, n_all = n_noisy + int((~posed).sum()), n_all + err.numel()
    return dict(gaps=gaps, reach_ok=reach, ill_posed=n_noisy, ill_posed_off=n_off,
                ill_posed_gap=noisy_gap, elements=n_all)


def _flips(mine, want, lo, hi, b, rows_ok=None):
    """This rank's routings (``mine``, the experts of each, (T_local, k),
    in order) against the single device's (``want``, (T, k) over its ``b``
    rows) at this rank's rows lo:hi (only ``rows_ok``, where given): the
    number of token routings whose set of experts differs, and which tokens
    ((hi - lo, T / b) bool) had one; None if the two ran different numbers
    of routings."""
    if len(mine) != len(want):
        return None
    n, toks = 0, torch.zeros((hi - lo, 1), dtype=torch.bool)
    for got, ref in zip(mine, want):
        s = ref.shape[0] // b
        ref = ref[lo * s:hi * s].to(got.device)
        tok = (got.sort(-1).values != ref.sort(-1).values).any(-1).view(hi - lo, s).cpu()
        if rows_ok is not None:
            tok &= rows_ok[:, None]
        n, toks = n + int(tok.sum()), toks | tok
    return n, toks


def _spmd_reference(cfg, dev, tokens, prompts, steps):
    """The single-device steps of one config on ``dev``: a prefill and
    ``steps`` greedy decode steps, an AdamW train step and, for an MoE, an
    Adafactor one from the same weights; each step's routings (experts and
    margins); the initial weights (``init``) that the ranks cut their
    shards from."""
    from repro_torch.models import lm, moe, transformer as T
    from repro_torch.optim.optimizer import OptimizerConfig, make_optimizer

    params = T.init_lm(SPMD_SEED, cfg, device=dev)     # the ranks cut their shards from these
    b, s = prompts.shape
    prompts = torch.from_numpy(prompts).to(dev)
    ref = {"init": params, "margins": {}, "experts": {}, "ms": {}}
    with torch.no_grad():
        with moe.routings() as routes:
            _sync(dev)
            t0 = time.perf_counter()
            logits, cache = lm.make_prefill_step(cfg)(params, {"tokens": prompts})
            _sync(dev)
            ref["ms"]["prefill"] = 1e3 * (time.perf_counter() - t0)
        ref["margins"]["prefill"] = _margins(routes)
        ref["experts"]["prefill"] = [e for _, e in routes]
        ref["prefill"], ref["prefill_cache"] = logits, cache
        c = _lay_cache(cache, T.cache_init(cfg, b, s + steps, device=dev))
        serve, outs, toks, tops, step_routes = lm.make_serve_step(cfg), [], [], [_top2(logits)], []
        tok = logits.argmax(-1).to(torch.int32)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(steps):
            toks.append(tok[:, 0])
            with moe.routings() as routes:
                lg, c = serve(params, c, {"token": tok}, s + i)
            step_routes.append(routes)
            outs.append(lg)
            tops.append(_top2(lg))
            tok = lg.argmax(-1).to(torch.int32)
        _sync(dev)
        ref["ms"]["step"] = 1e3 * (time.perf_counter() - t0) / steps
        ref["margins"]["decode"] = _margins([r for rs in step_routes for r in rs])
        ref["experts"]["decode"] = [[e for _, e in rs] for rs in step_routes]
    # top2[:, i]: the margin of the logits that chose tokens[:, i]
    ref.update(steps=outs, tokens=torch.stack(toks, 1), top2=torch.stack(tops[:steps], 1), cache=c)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    kinds = [("adamw", {})] + ([("adafactor", SPMD_ADAFACTOR)] if cfg.family == "moe" else [])
    for name, kw in kinds:
        ocfg = OptimizerConfig(**SPMD_OPT, **kw)
        opt = make_optimizer(ocfg)
        state = {"params": params, "opt_state": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        with moe.routings() as routes:
            _sync(dev)
            t0 = time.perf_counter()
            new, metrics = lm.make_train_step(cfg, opt)(state, batch)
            _sync(dev)
            ref["ms"][name] = 1e3 * (time.perf_counter() - t0)
        ref["margins"][name] = _margins(routes)
        ref["experts"][name] = [e for _, e in routes]
        del state, routes
        ref[name] = {"params": new["params"], "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     **{k: v for k, v in new["opt_state"].items() if k != "grad_norm"}}
        ref[name]["scales"] = _state_scales(
            ocfg, {k: v for k, v in ref[name].items() if isinstance(v, dict)})
        del new
    ref["peak_gib"] = _peak_gib(dev)
    return ref


SHARED_ALIGN = 64   # bytes: each leaf's offset in the shared buffer


def _to_shared_host(tree):
    """Every tensor of a tree of dicts, lists and tuples copied once into
    one shared host allocation (what a spawned rank maps rather than
    copies, one segment for the whole tree), each leaf a contiguous view of
    it at an offset aligned to SHARED_ALIGN bytes."""
    def walk(x, fn):
        if isinstance(x, dict):
            return {k: walk(v, fn) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, fn) for v in x)
        return fn(x) if isinstance(x, torch.Tensor) else x

    offsets, total = [], 0

    def place(t):
        nonlocal total
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // SHARED_ALIGN) * SHARED_ALIGN
        return t

    walk(tree, place)
    flat = torch.empty(0, dtype=torch.uint8).set_(torch.UntypedStorage._new_shared(max(total, 1)))
    # fault the segment's pages in here, on every core, before the copies from
    # the card: copied into pages not yet faulted in, recurrentgemma's 24.5 GiB
    # reference took 101-138 s on an H100 host, 52-65 s after this
    flat.zero_()
    at = iter(offsets)

    def copy(t):
        o = next(at)
        view = flat[o:o + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
        return view.copy_(t)

    return walk(tree, copy)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def _block_gaps(local, ref, specs, mesh) -> float:
    """The largest gap of this rank's leaves to the same blocks of the
    single-device tree, over each leaf's largest magnitude."""
    from repro_torch.bridge import leaves
    from repro_torch.distributed.sharding import NamedSharding, map_leaves

    block = lambda w, sp: w[NamedSharding(mesh, sp).local_slices(tuple(w.shape))].to(
        leaves(local)[0].device)
    return max((float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp(min=1e-30))
                for g, w in zip(leaves(local), leaves(map_leaves(block, ref, specs)))),
               default=0.0)


def _row_gaps(a, b):
    """Each row's largest gap, (B,) on the CPU."""
    return (a.float() - b.float()).abs().flatten(1).amax(1).cpu()


def _spmd_train(cfg, mesh, spmd, params, batch, ref, ocfg, timed, rows, preset):
    """One sharded train step under ``ocfg`` and the ``preset`` rules from
    this rank's shards, held against the single-device step ``ref``
    (:func:`_state_gaps`): loss, grad_norm, the state's gaps, the routings
    that flipped, the step's ms and collective operand bytes."""
    from repro_torch.launch.dryrun import _opt_specs
    from repro_torch.models import lm
    from repro_torch.optim.optimizer import make_optimizer

    opt = make_optimizer(ocfg)
    state = {"params": params, "opt_state": spmd.opt_init(opt, params),
             "step": torch.zeros((), dtype=torch.int32, device=_device_of(params))}
    (new, metrics), ms, nbytes, mine = timed(
        lambda: lm.make_train_step(cfg, opt, mesh=mesh, preset=preset)(state, batch))
    del state
    _empty(_device_of(params))   # the step's pool back to the card, shared by four ranks
    out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "ms": ms, "bytes": nbytes}
    t0 = time.perf_counter()
    local = {"params": new["params"],
             **{k: v for k, v in new["opt_state"].items() if k != "grad_norm"}}
    ocfg_kind = cfg.replace(opt_kind=ocfg.kind)
    specs = {"params": spmd.specs, **_opt_specs(ocfg_kind, new["opt_state"], spmd.opt_specs,
                                                new["params"])}
    posed_specs = _opt_specs(ocfg_kind, new["opt_state"], spmd.specs, new["params"])
    out["leaves"] = _state_gaps(local, params, ref, specs, mesh, ocfg, posed_specs)
    del local, new
    _empty(_device_of(params))
    lo, hi, b = rows
    flips = _flips(mine, ref["experts"], lo, hi, b)
    out["flips"] = None if flips is None else (flips[0], int(flips[1].sum()))
    out["compare_s"] = time.perf_counter() - t0
    return out


def _spmd_rank(rank, arch, depth, device, ref, tokens, prompts, steps, presets):
    """One rank of a phase 16 or 17 world for one config: under each of
    ``presets`` the parent's initial weights (``ref["init"]``, on the card or
    in shared host memory) cut to this rank's shards of the 2x2 mesh, the
    sharded train step(s), prefill and greedy decode, each under a
    :class:`_CollectiveTally` (its collective operand bytes kept) and
    ``moe.routings()``, and held here against the same block of the
    single-device results ``ref``; the hand kernels' launches of this rank's
    steps.  Returns a dict of each preset's results."""
    t_rank, began = time.perf_counter(), time.time()
    torch.set_num_threads(2)      # 8 cores, 4 ranks: host-side slicing of the reference
    if str(ROOT / "src") not in sys.path:   # the world's ranks take one config after another
        sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = _spmd_cfg(arch, depth)
    mesh = make_host_mesh(SPMD_MESH)
    out = {p: _spmd_preset(cfg, mesh, p, dev, ref, tokens, prompts, steps) for p in presets}
    _release(ref)
    out["rank_s"], out["began"] = time.perf_counter() - t_rank, began
    return out


def _spmd_preset(cfg, mesh, preset, dev, ref, tokens, prompts, steps):
    """One preset's steps on one rank (:func:`_spmd_rank`)."""
    from repro_torch.distributed.sharding import (NamedSharding, gather_tree, sanitized_specs,
                                                  shard_tree)
    from repro_torch.models import lm, moe, transformer as T
    from repro_torch.optim.optimizer import OptimizerConfig

    counters = _counters()
    _zeroed(counters)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spmd = T.spmd_layout(cfg, mesh, preset=preset)
    model = mesh.axis("model")
    t0 = time.perf_counter()
    params = _to(shard_tree(ref["init"], spmd.specs, mesh), dev)
    out = {"setup_s": time.perf_counter() - t0}
    def rows_spec(n):    # a batch dim of n rows, cut like the batch where the axes divide it
        return sanitized_specs((spmd.batch_entry,), torch.empty(n, device="meta"), mesh)

    def span(n):         # this rank's rows of n: (first, last + 1, n)
        sl = NamedSharding(mesh, rows_spec(n)).local_slices((n,))[0]
        return sl.start, sl.stop, n

    cut_rows = lambda x: shard_tree(x, rows_spec(x.shape[0]), mesh)
    batch = {"tokens": cut_rows(torch.from_numpy(tokens)).to(dev)}

    def timed(fn):
        rec = _CollectiveTally()
        _sync(dev)
        t0 = time.perf_counter()
        with rec, moe.routings() as routes:
            result = fn()
        _sync(dev)
        return result, 1e3 * (time.perf_counter() - t0), rec.collectives, [e for _, e in routes]

    out["train_rows"] = span(tokens.shape[0])
    for name, kw in [("adamw", {})] + ([("adafactor", SPMD_ADAFACTOR)] if "adafactor" in ref
                                       else []):
        out[name] = _spmd_train(cfg, mesh, spmd, params, batch,
                                {**ref[name], "experts": ref["experts"][name]},
                                OptimizerConfig(**SPMD_OPT, **kw), timed, out["train_rows"],
                                preset)

    b, s = prompts.shape
    vocab = NamedSharding(mesh, sanitized_specs(
        (spmd.batch_entry, None, "model" if spmd.vocab_split else None),
        torch.empty((b, 1, cfg.vocab_size), device="meta"), mesh))
    cut = lambda want: want[vocab.local_slices(tuple(want.shape))].to(dev)
    lo, hi, _ = span(b)
    whole_vocab = lambda lg: model.all_gather(lg, -1, kind="output") if spmd.vocab_split else lg
    lp = cut_rows(torch.from_numpy(prompts)).to(dev)
    with torch.no_grad():
        (logits, cache), out["prefill_ms"], out["prefill_bytes"], mine = timed(
            lambda: lm.make_prefill_step(cfg, mesh=mesh, preset=preset)(params, {"tokens": lp}))
        f = _flips(mine, ref["experts"]["prefill"], lo, hi, b)
        out["prefill_flips"] = None if f is None else (f[0], f[1].any(-1))
        out["prefill_gaps"] = _row_gaps(logits, cut(ref["prefill"]))
        pspecs = spmd.cache_specs(ref["prefill_cache"])
        out["prefill_cache_gap"] = _block_gaps(cache, ref["prefill_cache"], pspecs, mesh)
        # the prefill's cache laid into a cache of s + steps slots, cut as
        # the serve step takes it
        whole = _lay_cache(gather_tree(cache, pspecs, mesh, kind="state"),
                           T.cache_init(cfg, b, s + steps, device=dev))
        cspecs = spmd.cache_specs(whole)
        cache = shard_tree(whole, cspecs, mesh)
        del whole
        tok = whole_vocab(logits).argmax(-1).to(torch.int32)
        serve = lm.make_serve_step(cfg, mesh=mesh, preset=preset)
        # a row's first step whose input token differs from the single device's
        div = torch.full((hi - lo,), steps)
        toks, gaps, ms, step_bytes, flips = [], [], [], [], (0, torch.zeros(hi - lo, dtype=bool))
        for i in range(steps):
            toks.append(tok[:, 0].cpu())
            differs = toks[-1] != ref["tokens"][lo:hi, i].cpu()
            div = torch.where(differs & (div == steps), torch.full_like(div, i), div)
            (lg, cache), t, nbytes, mine = timed(lambda: serve(params, cache, {"token": tok}, s + i))
            f = _flips(mine, ref["experts"]["decode"][i], lo, hi, b, rows_ok=div > i)
            flips = (None if f is None or flips is None
                     else (flips[0] + f[0], flips[1] | f[1].any(-1)))
            ms.append(t)
            step_bytes.append(nbytes)
            gaps.append(_row_gaps(lg, cut(ref["steps"][i])))
            tok = whole_vocab(lg).argmax(-1).to(torch.int32)
        out["cache_gap"] = (None if bool((div < steps).any())
                            else _block_gaps(cache, ref["cache"], cspecs, mesh))
    out.update(tokens=torch.stack(toks, 1), step_gaps=torch.stack(gaps, 1), step_ms=ms,
               step_bytes=step_bytes, decode_flips=flips, div=div, rows=(lo, hi))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    out["launches"] = {k: c.launches for k, c in counters.items()}
    del params, batch, lp, cache
    _empty(dev)
    return out


def _spmd_checks(label, ranks, ref, want, train_tokens):
    """The checks of every rank's results for one config; returns each
    step's word for the log: held, or what a flipped routing left held."""
    tag = "x".join(map(str, SPMD_MESH))
    held = {}
    for name in ("adamw", "adafactor"):
        if name not in ref:
            continue
        r = ref[name]
        flips = [got[name]["flips"] for got in ranks]
        if any(f is None for f in flips):
            fail(f"{label} {name}: the ranks ran another number of routings than the single device")
        n = sum(f[0] for f in flips)
        # the flipped tokens, counted once: ranks that hold the same rows route alike
        n_tok = sum({got["train_rows"]: got[name]["flips"][1] for got in ranks}.values())
        bound = SPMD_FLIP_SHARE * n_tok / train_tokens
        held[name] = ("held" if n == 0 else
                      f"{n} token routings flipped over the ranks, {n_tok} tokens of "
                      f"{train_tokens}: loss and grad_norm held within {bound:.3g}, the state "
                      "reported")
        for rank, got in enumerate(ranks):
            g, where = got[name], f"{label} {tag} rank {rank} {name}"
            gaps, reach_ok = g["leaves"]["gaps"], g["leaves"]["reach_ok"]
            rel = abs(g["loss"] - r["loss"]) / abs(r["loss"])
            grel = abs(g["grad_norm"] - r["grad_norm"]) / abs(r["grad_norm"])
            if n == 0:
                check(rel <= SPMD_LOSS_RTOL, f"{where}: loss {g['loss']!r} vs {r['loss']!r}")
                check(grel <= GEN_CPU_GRAD_REL,
                      f"{where}: grad_norm {g['grad_norm']!r} vs {r['grad_norm']!r}")
                check(max(gaps.values()) <= GEN_CPU_GRAD_REL and reach_ok,
                      f"{where}: state gaps {gaps} (limit {GEN_CPU_GRAD_REL}), ill-posed "
                      f"elements within one step: {reach_ok}")
            else:
                check(rel <= bound and grel <= bound,
                      f"{where}: loss {rel:.3g}, grad_norm {grel:.3g} off with {n_tok} flipped "
                      f"tokens (limit {bound:.3g})")
            check(g["bytes"] == want[name], f"{where}: collective operand bytes "
                                            f"{g['bytes']} vs record-only {want[name]}")
    n_pre = n_dec = 0
    for rank, got in enumerate(ranks):
        where = f"{label} {tag} rank {rank}"
        check(not any(got["launches"].values()),
              f"{where}: hand kernels launched {got['launches']} on the generic path "
              "(expected none)")
        if got["prefill_flips"] is None or got["decode_flips"] is None:
            fail(f"{where}: the rank ran another number of routings than the single device")
        pre, dec = got["prefill_flips"][1], got["prefill_flips"][1] | got["decode_flips"][1]
        n_pre, n_dec = n_pre + got["prefill_flips"][0], n_dec + got["decode_flips"][0]
        check(bool((got["prefill_gaps"][~pre] <= GEN_CPU_LOGITS_ATOL).all()),
              f"{where}: prefill logits gaps {got['prefill_gaps'].tolist()} (rows with a "
              f"flipped routing: {pre.tolist()})")
        if not pre.any():
            check(got["prefill_cache_gap"] <= GEN_CPU_GRAD_REL,
                  f"{where}: prefill cache gap {got['prefill_cache_gap']:.3g} (relative)")
        lo = got["rows"][0]
        for r in (~dec).nonzero().flatten().tolist():
            d = int(got["div"][r])
            check(bool((got["step_gaps"][r, :d] <= GEN_CPU_LOGITS_ATOL).all()),
                  f"{where}: row {lo + r} decode logits gaps {got['step_gaps'][r, :d].tolist()}")
            if d < got["step_gaps"].shape[1]:
                margin = float(ref["top2"][lo + r, d])
                check(margin <= SPMD_MARGIN, f"{where}: row {lo + r} greedy token {d} differs "
                                             f"at a top-2 margin {margin:.3g} (limit {SPMD_MARGIN})")
        if not dec.any() and got["cache_gap"] is not None:
            check(got["cache_gap"] <= GEN_CPU_GRAD_REL, f"{where}: decode cache gap "
                                                        f"{got['cache_gap']:.3g}")
        check(got["prefill_bytes"] == want["prefill"],
              f"{where}: prefill collective operand bytes {got['prefill_bytes']} vs record-only "
              f"{want['prefill']}")
        check(all(x == want["decode"] for x in got["step_bytes"]),
              f"{where}: decode collective operand bytes {got['step_bytes']} vs record-only "
              f"{want['decode']}")
    held["prefill"] = "held" if n_pre == 0 else f"{n_pre} flipped routings: their rows reported"
    held["decode"] = "held" if n_dec == 0 else f"{n_dec} flipped routings: their rows reported"
    return held


def _preset_collectives(preset):
    """Rank 0's collective operand bytes by kind of GEN_ARCH's train_4k cell
    on a record-only PRESET_BYTES_MESH under ``preset`` (``dryrun.measure``
    on meta)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import record_only_mesh

    return dryrun.measure(GEN_ARCH, "train_4k", mesh=record_only_mesh(PRESET_BYTES_MESH),
                          preset=preset)["collectives"]


def _spmd_sp_refused(arch):
    """The three step builders of ``arch`` under the ``sp`` preset on a
    record-only 2x2 mesh: each must raise ``ValueError`` naming ``model``,
    before any step runs."""
    from repro_torch.launch.mesh import record_only_mesh
    from repro_torch.models import lm
    from repro_torch.optim.optimizer import OptimizerConfig, make_optimizer

    cfg, mesh = _spmd_cfg(arch), record_only_mesh(SPMD_MESH)
    builders = {
        "train": lambda: lm.make_train_step(cfg, make_optimizer(OptimizerConfig()), mesh=mesh,
                                            preset="sp"),
        "prefill": lambda: lm.make_prefill_step(cfg, mesh=mesh, preset="sp"),
        "serve": lambda: lm.make_serve_step(cfg, mesh=mesh, preset="sp")}
    for name, make in builders.items():
        try:
            make()
        except ValueError as e:
            check("duplicate entries for `model`" in str(e),
                  f"{arch} sp {name} step: ValueError without the duplicated axis: {e}")
            log(f"  {arch} sp {name} step refused: {e}")
            continue
        check(False, f"{arch}: the {name} step builder took the sp preset (expected ValueError)")


def _spmd_log(label, ranks, ref, want, train_tokens, steps, tag, phase):
    """One preset's checks of one config (:func:`_spmd_checks`) and its log
    lines: each rank's steps, gaps and times, the collective operand
    bytes."""
    fmt = lambda d: ", ".join(f"{k} {v}" for k, v in sorted(d.items()))
    held = _spmd_checks(label, ranks, ref, want, train_tokens)
    fail_if_any(f"{phase} ({label})")
    log(f"  {label} steps: " + ", ".join(f"{k} {v}" for k, v in held.items()))
    for r, got in enumerate(ranks):
        log(f"  rank {r}: " + ", ".join(
            f"{k} step {got[k]['ms']:.1f} ms (loss gap "
            f"{abs(got[k]['loss'] - ref[k]['loss']) / abs(ref[k]['loss']):.3g}, grad_norm gap "
            f"{abs(got[k]['grad_norm'] - ref[k]['grad_norm']) / abs(ref[k]['grad_norm']):.3g}, "
            "state gaps " + ", ".join(f"{n} {v:.3g}" for n, v in got[k]["leaves"]["gaps"].items())
            + f"; {got[k]['leaves']['ill_posed']} of {got[k]['leaves']['elements']} parameter "
            f"elements ill-posed, {got[k]['leaves']['ill_posed_off']} of them off by more than "
            f"{GEN_CPU_GRAD_REL} of the leaf's scale, largest gap "
            f"{got[k]['leaves']['ill_posed_gap']:.3g}; {got[k]['flips'][1]} tokens' routings "
            "flipped)"
            for k in ("adamw", "adafactor") if k in got)
            + f", prefill {got['prefill_ms']:.1f} ms (logits gap "
            f"{float(got['prefill_gaps'].max()):.3g}, cache {got['prefill_cache_gap']:.3g}), "
            f"decode {np.mean(got['step_ms'][1:]):.2f} ms a step (logits gaps max "
            f"{float(got['step_gaps'].max()):.3g}, cache "
            + ("not compared" if got["cache_gap"] is None else f"{got['cache_gap']:.3g}")
            + ", greedy " + ("equal" if bool((got["div"] == steps).all())
                             else f"diverged at steps {got['div'].tolist()}")
            + "), peak " + ("not measured" if got["peak_gib"] is None
                            else f"{got['peak_gib']:.2f} GiB"))
    log(f"  {label} rank 0: {ranks[0]['setup_s']:.1f} s cutting and moving its shards, "
        + ", ".join(f"{ranks[0][k]['compare_s']:.1f} s comparing its {k} state"
                    for k in ("adamw", "adafactor") if k in ranks[0]))
    log(f"  {label} collective operand bytes per rank (equal to the record-only {tag} "
        f"mesh's on meta): " + "; ".join(f"{k} {fmt(v)}" for k, v in want.items()))


def phase_spmd(dev, smi, configs, phase, world, train=SPMD_TRAIN, steps=SPMD_STEPS,
               presets=("base",)):
    """Phases 16 and 17: the generic LM's sharded steps (``lm.make_*_step(
    mesh=, preset=)``), one config at a time (``configs``: arch, depth, prefill
    shape and, optionally, the config's own presets), f32 compute: the
    single-device steps on this device, then SPMD under each of the config's
    presets (else ``presets``) in turn on ``world``, a 2x2 gloo world of
    SPMD_RANKS ranks sharing it (``launch.mesh.World``: one world takes the
    configs of both phases in turn, each after the ranks released the one
    before), which cut their
    shards from this process's initial weights (on the card, or in shared
    host memory where the ranks need the card: four ranks re-drawing a
    1.7 B tree would not fit the host's 96 GiB), every rank's results held
    against the single-device ones (an MoE step in which a routing flipped
    as ``SPMD_FLIP_SHARE`` says), its collective operand bytes against a
    record-only mesh's on meta; no hand kernel may launch.  With a CPU
    ``dev`` and smoke archs it rehearses the checks."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import record_only_mesh
    from repro_torch.models.config import ShapeCell

    t_phase = time.perf_counter()
    rec_mesh = record_only_mesh(SPMD_MESH)
    tag = "x".join(map(str, SPMD_MESH))
    default_presets = presets
    for arch, depth, prefill, *own in configs:
        presets = own[0] if own else default_presets
        t_cfg = time.perf_counter()
        cfg = _spmd_cfg(arch, depth)
        tokens, prompts = _spmd_inputs(cfg, train, prefill)
        counters = _counters()
        _zeroed(counters)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            log(f"  {arch}: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated on the "
                "card before its steps")
        ref = _spmd_reference(cfg, dev, tokens, prompts, steps)
        _no_hand_kernels(f"{arch} single-device steps", counters)
        _empty(dev)
        margins = ", ".join(f"{k} {'none' if m is None else f'{m[0]:.3g} ({m[1]} within)'}"
                            for k, m in ref["margins"].items())
        log(f"  {arch} on one device ({cfg.num_layers} layers, d {cfg.d_model}, f32): AdamW loss "
            f"{ref['adamw']['loss']!r}, " + ", ".join(f"{k} {v:.1f} ms" for k, v in ref["ms"].items())
            + f" (train {train[0]} x {train[1]}, prefill {prefill[0]} x {prefill[1]}, a decode "
            f"step), peak {ref['peak_gib']:.2f} GiB; router top-k margins: {margins}")

        cells = {"adamw": (ShapeCell(f"{phase}_train", train[1], train[0], "train"), cfg),
                 "prefill": (ShapeCell(f"{phase}_prefill", prefill[1], prefill[0], "prefill"), cfg),
                 "decode": (ShapeCell(f"{phase}_decode", prefill[1] + steps, prefill[0], "decode"),
                            cfg)}
        if "adafactor" in ref:
            cells["adafactor"] = (cells["adamw"][0],
                                  cfg.replace(opt_kind="adafactor", opt_b1=0.0))
        measured = {(p, k): dryrun.measure(arch, c, cfg_override=o, mesh=rec_mesh, preset=p)
                    for p in presets for k, (c, o) in cells.items()}
        want = {p: {k: measured[p, k]["collectives"] for k in cells} for p in presets}
        # the reference stays on the card, shared with the ranks by IPC, where
        # the ranks' train steps (the recorder's temporaries and arguments of
        # a rank, a quarter more for the allocator, 4 GiB for five contexts)
        # fit beside it; else the ranks map it from shared host memory
        need = SPMD_RANKS * 1.25 * max(
            measured[p, k]["peak"] + dryrun.build_cell(arch, cells[k][0], cfg_override=cells[k][1],
                                                       mesh=rec_mesh, preset=p).argument_bytes()
            for p in presets for k in ("adamw", "adafactor") if k in cells) + 4 * 2**30
        on_card = dev.type == "cuda" and need <= torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        if not on_card:
            ref = _to_shared_host(ref)
            _empty(dev)
        log(f"  {arch}: the reference ({_tree_bytes(ref) / 2**30:.1f} GiB) "
            + ("stays on the card" if on_card else
               f"in shared host memory ({time.perf_counter() - t0:.1f} s to copy it there)")
            + f"; the ranks' estimate {need / 2**30:.1f} GiB")
        t0, t0_wall = time.perf_counter(), time.time()
        try:
            ranks = world.run(_spmd_rank, (arch, depth, str(dev), ref, tokens, prompts, steps,
                                           presets), timeout=SPMD_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            fail(f"{phase}: the {SPMD_RANKS}-rank world of {arch} failed: {e}")
        world_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.ipc_collect()
        for preset in presets:
            label = arch if preset == "base" else f"{arch} ({preset})"
            per_rank = [got[preset] for got in ranks]
            _spmd_log(label, per_rank, ref, want[preset], train[0] * train[1], steps, tag,
                      phase)
        log(f"  {arch} rank 0: {ranks[0]['rank_s']:.1f} s in its function, which began "
            f"{ranks[0]['began'] - t0_wall:.1f} s after the call")
        log(f"  {arch}: {SPMD_RANKS}-rank world ({tag} mesh, gloo, every rank on {dev}) in "
            f"{world_s:.1f} s; {arch} in {time.perf_counter() - t_cfg:.1f} s")
        del ref, ranks
        _empty(dev)
    log(f"  {phase} in {time.perf_counter() - t_phase:.1f} s; on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: this smoke test "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[chip_smoke] no src/repro_torch beside {Path(__file__).name}: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    starts: dict[str, float] = {}   # each phase's first stage line, seconds from t0

    def stage(msg: str) -> None:
        at = time.perf_counter() - t0
        starts.setdefault(msg.split()[1].rstrip(":"), at)
        log(f"{msg} (at {at:.1f} s)")

    stage("phase 1: card and build")
    smi, build_s = phase_card_and_build()
    stage("phase 2: kernels vs plain at the spike-iand-former-8-384 main path's shapes")
    reports = phase_kernels(dev, torch.Generator().manual_seed(0))
    stage(f"phase 2 (continued): the kernels at the spiking {LM_ARCH}'s shapes")
    lm_reports = _lm_kernels(dev, torch.Generator().manual_seed(1))
    stage("phase 2 (continued): the kernels at phase 7's admission, chunk and step shapes")
    _admission_kernels(dev, torch.Generator().manual_seed(2))
    stage("phase 2 (continued): K1, K4, K7 on bf16 drives at the 8-384 shapes")
    bf16_reports = _lif_bf16(dev, torch.Generator().manual_seed(3))
    _lif_bf16_path(dev, torch.Generator().manual_seed(4), bf16_reports)
    stage("phase 2 (continued): K1, K4 and K4's map over the edges of their design")
    _lif_edges(dev, torch.Generator().manual_seed(7))
    stage(f"phase 2 (continued): K3, K6, K9 past M * Dh = 2^24 at Dh = {LM_DH}")
    past_reports = _ssa_past_edge(dev, torch.Generator().manual_seed(5))
    stage("phase 2 (continued): K2, K5, K8 at a model shard's columns and a data shard's rows; "
        "K4's occupancy map at a shard's width")
    _gemm_columns(dev, torch.Generator().manual_seed(6))
    fail_if_any("phase 2")
    stage(f"phase 3: serve the live {ARCH} on {', '.join(BACKENDS)}, "
        f"{REQUESTS // SLOTS} slot batches of {SLOTS} each")
    launches, forwards = phase_model(dev, smi, reports)
    stage("phase 4: the other vision configs at full size, live weights, 2 images each")
    phase_other_configs(dev)
    stage(f"phase 5: train {ARCH}, batch {TRAIN_BATCH}, kernel and plain routes")
    torch.cuda.empty_cache()
    launches["K7"], forwards["K7"], reports["K7"].entry["device_ms"] = phase_train(dev, smi)
    stage(f"phase 6: serve the spiking {LM_ARCH} at full width, {LM_REQUESTS} requests, prompt "
        f"{LM_PROMPT}, {LM_NEW} new tokens, {LM_SLOTS} slots")
    torch.cuda.empty_cache()
    sync_cuda = phase_lm(dev, smi, lm_reports)
    stage(f"phase 7: continuous serving of the spiking {LM_ARCH}, {CONT_REQUESTS} requests, "
        f"prompts {CONT_LENS}, {LM_NEW} new tokens (spread {CONT_SPREAD}), {LM_SLOTS} slots")
    torch.cuda.empty_cache()
    phase_continuous(dev, smi, sync_cuda)
    # phase 15's dry-run sweep, on meta in a process of its own beside phases
    # 8-13 (a failure there fails phase 15; an exit before joins the pool)
    background = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    sweep = background.submit(_dry_sweep)
    stage(f"phase 8: a {PAST_EDGE_LEN}-token prompt (past M * Dh = 2^24) through the spiking "
        f"{LM_ARCH}'s prefill, {LONG_LAYERS} layers")
    torch.cuda.empty_cache()
    phase_long_prompt(dev, smi, past_reports)
    stage(f"phase 9: the 8-bit bitplane input of the {ARCH}'s encoding conv on K2")
    torch.cuda.empty_cache()
    bitplane_report = phase_bitplane(dev, smi)
    stage("phase 10: graph checks on the kernel routes at full width")
    torch.cuda.empty_cache()
    phase_graph_checks(dev)
    stage("phase 11: learning parity, the JAX example's training run on both routes")
    phase_learning(dev, smi)
    stage(f"phase 12: the mesh, a gloo world of {MESH_RANKS} ranks on this card")
    torch.cuda.empty_cache()
    phase_mesh(dev, smi)
    stage(f"phase 13: train the spiking {LM_ARCH} at full width ({LM_TRAIN_STEPS} SGD steps of "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens), an AdamW update, the trained fixture")
    torch.cuda.empty_cache()
    train_reports = phase_lm_train(dev, smi)
    stage(f"phase 14: the generic LM families at full width: serve and train {GEN_ARCH}, "
        f"prefill and decode {', '.join(GEN_OTHERS)}")
    torch.cuda.empty_cache()
    phase_generic_lm(dev, smi)
    stage(f"phase 15: the generic trainer: train({GEN_ARCH!r}) at full width ({GT_STEPS} steps of "
        f"{GT_BATCH} x {GT_SEQ} tokens, plain and with compress_grads), the "
        f"restart and card vs CPU at {GT_CUT_LAYERS} layers, the dry run on meta")
    torch.cuda.empty_cache()
    phase_generic_train(dev, smi, sweep)
    background.shutdown()
    from repro_torch.launch.mesh import World

    tag = "x".join(map(str, SPMD_MESH))
    spmd_kw = (f"a train step of {SPMD_TRAIN[0]} x {SPMD_TRAIN[1]} tokens (granite also under "
               f"Adafactor) and {SPMD_STEPS} greedy steps, against the single-device steps")
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        pod = {p: pool.submit(_preset_collectives, p) for p in SPMD_PRESETS}
        stage(f"phase 16: the generic LM's SPMD steps: {GEN_ARCH} at full width, {SPMD_DEPTH} "
              f"layers, on a {tag} gloo world of {SPMD_RANKS} ranks on this card under "
              f"{', '.join(SPMD_PRESETS)} in turn (a train step of {SPMD_TRAIN[0]} x "
              f"{SPMD_TRAIN[1]} tokens, a prefill of {SPMD_PREFILL[0]} x {SPMD_PREFILL[1]}, "
              f"{SPMD_STEPS} greedy steps) against the single-device steps")
        torch.cuda.empty_cache()
        # one world for phases 16 and 17: its ranks start while the parent
        # computes the first single-device reference
        with World(SPMD_RANKS, timeout=SPMD_TIMEOUT) as world:
            phase_spmd(dev, smi, SPMD16, "phase 16", world)
            stage("phase 17: the generic LM's SPMD steps of the MoE, SSM and hybrid kinds on "
                  f"the {tag} gloo world: "
                  + ", ".join(f"{a} ({'all' if d is None else d} layers, prefill {p[0]} x "
                              f"{p[1]}; {', '.join(ps)})" for a, d, p, ps in SPMD17)
                  + f", each {spmd_kw}")
            torch.cuda.empty_cache()
            phase_spmd(dev, smi, SPMD17, "phase 17", world)
        stage("phase 18: the sp preset refused; the collective operand bytes of the presets on "
              "the production mesh")
        _spmd_sp_refused(GEN_ARCH)
        fail_if_any("phase 18 (sp)")
        mesh_tag = "x".join(map(str, PRESET_BYTES_MESH))
        for p, f in pod.items():
            log(f"  {GEN_ARCH} train_4k on the record-only {mesh_tag} mesh ({p}): collective "
                f"operand bytes a rank {_result(f, f'phase 18: the {p} preset bytes')}")
    total = time.perf_counter() - t0
    log(f"all phases passed in {total:.1f} s")
    ends = [*list(starts.values())[1:], total]
    log("seconds: " + json.dumps({"phases": {k: round(e - a, 1) for (k, a), e in
                                             zip(starts.items(), ends)},
                                  "build": {k: round(v, 1) for k, v in build_s.items()},
                                  "total": round(total, 1)}))

    missing = [k for k, rep in {**reports, **{f"{k}@lm": r for k, r in lm_reports.items()},
                                **{f"{k}@lm-train": r for k, r in train_reports.items()},
                                **{f"{k} bf16": r for k, r in bf16_reports.items()}}.items()
               if rep.entry["device_ms"] is None]
    if missing:
        fail(f"no complete profile gave the device time of {missing}")
    for key, rep in reports.items():
        rep.entry["launches"] = launches[key]
        rep.entry["launches_per_forward"] = launches[key] / forwards[key]
    print(smi)
    extra = [*bf16_reports.values(), *past_reports.values(), bitplane_report]
    print(json.dumps({"kernels": [reports[k].entry for k in sorted(reports)]
                      + [lm_reports[k].entry for k in sorted(lm_reports)]
                      + [rep.entry for rep in extra]
                      + [train_reports[k].entry for k in sorted(train_reports)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
