"""On-card smoke run of the PyTorch/CUDA port (repro_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build      nvcc builds csrc/ws_attention.cu, csrc/ws_expert.cu,
              csrc/ws_expert_grad.cu, csrc/ws_unified.cu and the standalone
              csrc/flash_fwd.cu, csrc/decode_attention.cu and csrc/ssd_scan.cu
              for sm_90a from the checkout, one nvcc each, started together.
2. parity     the attention kernel against its plain PyTorch version on
              CPU copies of the same inputs, at the decode shapes of the main path
              (B=4, H=24, Hkv=8, hd=128, S=1024, bk=64, P=8, bf16, K/V read
              through the cache's transposed strides) and one causal flash
              launch (bq=16): lockstep integer arrays bit-equal and `out`
              within ATOL (once traced: the event rings bit-equal too); free
              mode with every task run, `out` within ATOL of the plain
              version's normalised output, and a seeded rewind drill with
              mult == 2.
3. expert     the expert kernel against its plain version on the card at
              kimi-k2's full width (d 7168, f 2048, 384 experts, top-8,
              bt 8, P 8, bf16 weights from seed 0), at a decode routing
              (T=4) and a prefill routing (T=64): lockstep integer arrays
              bit-equal (cost, scan, static), `out` within ATOL; free mode
              runs every tile and its combine equals the plain version's
              normalised one; a rewind drill without thieves gives mult == 2;
              a traced lockstep launch's rings equal the plain walk's.
              Then the attention kernel once at kimi's shape (H 64, Hkv 8,
              hd 112), and the expert kernel's times at the decode routing
              (free mode untraced and traced, and cold on the device with L2
              evicted), its sum(mult)/tiles and largest mult, the tile
              layout (one CTA a program: S 1, the programs the card holds at
              once, shared memory) and the tile-layout floor (every live
              tile's 3 d f weights at 3.35 TB/s).
4. audit      0 atom/red/fence/membar in each kernel's SASS and PTX, in every
              instantiation (untraced and traced, per-slot and half-run) of
              every kernel function; each per-slot function's registers and
              SASS instructions must equal BASELINE_FUNCTIONS (the build
              before half-run steals; ws_attention's, ws_expert's and
              ws_expert_grad's rows the builds of their redesigned tiles),
              and ws_unified has no half-run walk.  The
              standalone kernels' functions (registers, spills, SASS
              instructions) are logged and must be free of those opcodes too;
              every function of csrc/ssd_scan.cu must hold HMMA (its products
              run on tensor cores).
              csrc/probes/cluster_barrier.cu is built and its functions'
              forbidden SASS logged: the hand-offs between a thread-block
              cluster's CTAs (a barrier with release semantics, relaxed,
              and st.async onto a peer's mbarrier), none of which the
              expert kernels use: they run one CTA a program.  Then
              csrc/probes/tagged_handoff.cu, the hand-off ws_unified's
              walker and helpers use (a value and its request's tag in one
              64-bit word, st/ld.relaxed.gpu): its forbidden SASS and PTX
              (none allowed), a stress test (1 producer, SM count - 1
              consumers, PROBE's requests with random __nanosleep; no wrong
              value, no newer tag, no spin past its deadline), the round
              trip to one consumer and to all, and a cooperative launch of
              one 512-thread CTA an SM at the unified kernel's shared memory
              (every CTA resident at once).  ws_unified's rows of
              BASELINE_FUNCTIONS are its redesign's build.
4b. chaos     repro_torch.chaos on free-mode launches: a traced fault-free
              free launch of ws_attention (llama decode shape) and ws_expert
              (kimi-k2 full width, decode routing, the expert phase's
              weights) held to SafetyChecker's free-mode reading; then 2
              seeded FaultPlans each through run_with_faults in lockstep
              (kernel segments bit-equal to the plain walk's, checker clean)
              and in free mode (checker clean).  ws_expert_grad's and
              ws_unified's checks run in their phases (grad, unified,
              unified_moe), which hold their data.
4c. halfrun   half-run Steal (steal_run_cap 2 and 4): ws_attention at the
              parity phase's decode shape and ws_expert at kimi-k2's full
              width (decode and prefill routings, dense and pool layouts):
              traced lockstep bit-equal to the plain walk (rings and EV_RUN
              included), `out` within ATOL; a traced free launch runs every
              task, its output within ATOL of the plain version's normalised
              one, clean under SafetyChecker; HALFRUN_PLAN (a kill, then a
              full head-rewind storm) at cap 4 through both in lockstep
              (segments bit-equal to the plain walk) and free mode; free
              untraced launches at cap 1, 2 and 4 (ms, sum(mult)/tasks,
              max mult, slots scanned per extraction) for the kernels line.
              Then ragged_flash_attention at llama3.2-3b's widths (H 24,
              Hkv 8, hd 128, causal, bq = bk = 32, lengths 1024, 658, 531,
              288, bf16): static, ws and ws cap 4 against
              ragged_attention_ref, their kernel times beside the first
              version's (FIRST_VERSION_MS), the fraction of the bound, and a masked
              F.scaled_dot_product_attention yardstick.  ws_expert_grad's
              half-run checks run in the grad phase (which holds its data).
4d. kernels   the standalone kernels of repro_torch.kernels at full width in
              bf16, each entry point driven once a case with its launch count
              from 0: flash_attention_fwd at gemma3-12b's widths (H 16 over 8,
              hd 256, S 4096, causal, window 1024 and 0) and llama3.2-3b's (H 24
              over 8, hd 128, S 4096), and the flash_attention autograd
              Function at gemma's widths with S 1024; decode_attention at
              gemma's (B 4, S 8192, bk 512, pos 8191 and 4000 on the card,
              window 1024 and 0) and llama's serving cache (S 1024, pos 1000);
              ssd_scan at mamba2-2.7b's (b 2, S 2048, H 80, P 64, N 128,
              chunk 128) and its autograd Function at b 1, S 1024.  Every
              output (flash lse and the final SSD state included) and the
              flash gradients within KULPS bf16 ulps (lse: LSE_ATOL; state:
              STATE_RTOL) of the plain version, flash and decode also of a
              dense fp32 one, the SSD scan's y and state also of the
              sequential fp32 oracle ssd_ref; each fault of KCONTROLS and SSD_CONTROLS (a kv
              block of 16 dropped, a mask edge off by one, a scale 2 % off,
              one step of x dropped) and, for decode, DECODE_CONTROL (the
              last live split dropped) must break those limits.  Kernel,
              plain and masked F.scaled_dot_product_attention times (the SSD
              scan has no library call) and the bound; decode's kernel and
              SDPA, and the SSD scan, also on the device warm and cold (L2
              evicted before each timed launch), the scan with its CTAs, the
              CTAs an SM holds (as cudaOccupancy... reports them), its waves,
              its launches a call and the bytes it allocates beyond its
              outputs (both read around one call); flash_fwd's,
              decode_attention's and ssd_scan's beside their first
              versions'.  No model path may launch them (the ssm phase's
              comparison launch of ssd_scan on a layer's inputs aside).
5. serving    llama3.2-3b at full width (bf16, random weights from a seed),
              2 ContinuousBatcher replicas (4 slots, 1024 positions) behind
              the WorkStealingFrontend; 8 requests all submitted to replica
              0; every request completes, launches == decode steps x 28, and
              decode_step_ws logits agree with the dense decode_step.  Then
              the same requests with jit_ws on (every Put on the device, each
              replica's step captured into a CUDA graph at its first step
              and replayed, the drain counts read once a step): greedy
              streams identical, ws_attention launches == decode steps x 28;
              step p50/p99, tokens/s and launches a step for both settings.
              On one step's caches the captured step (first call, a replay,
              and a replay under torch.cuda.set_sync_debug_mode("error"),
              which must synchronise nothing before the logits are read)
              gives logits bit-equal to the host-Put step's; a replay's
              device time.  Then the crash drill (jit_ws on): 6 of the 8
              requests go to replica 0, which dies at frontend iteration
              CRASH_AT (ReplicaCrashPlan) with 4 in flight and 2 more queued
              on it: crashed 1, readmitted 4, no duplicate completion, the
              queued ones stolen and served by the survivor, every stream
              the uninterrupted run's (up to its crash point exactly; after
              it a difference passes only at a near-tie no wider than twice
              the prefill and decode paths' logit distance there).
6. times      attention kernel ms (free, lockstep) beside the first
              version's, bound and
              the fraction of it reached, plain version, and one
              F.scaled_dot_product_attention call as a yardstick only; the
              free launch again at 16, 32 and 132 programs, and its split
              in device times: every task cut to one key, one task a CTA,
              each CTA on its own round-robin queue (record only).
7. moe        kimi-k2-1t-a32b at full width, depth 2, moe_dispatch="ws"
              (bf16, random weights from seed 0), after the llama weights
              are freed: 2 replicas x 4 slots x 1024 positions, 8 requests
              all submitted to replica 0; every request completes, replica
              1 steals, ws_attention launches == decode steps x 2 and
              ws_expert launches == decode steps x 2 + prefills x 2; one
              decode_step_ws counted alone launches each kernel twice; that
              step's expert launches within ATOL of the plain version on
              their own inputs (a bf16 evaluation must miss ATOL), and its
              fp32 logits within LOGIT_ULP_SLACK one-ulp distances of the
              same step on both plain versions.  Then jit_ws on, as in the
              serving phase: streams identical, ws_attention == steps x 2
              and ws_expert == (steps + prefills) x 2 (the device Put: the
              shared pool on the routing's device), the figures of both
              settings, and the captured step's logits within
              LOGIT_ULP_SLACK one-ulp distances of decode_step_ws's own
              (the combine's index_add_ order is not fixed), a replay
              under the sync debug mode included.
8. grad       the expert backward kernel against its plain version at
              deepseek-v2's full width (d 5120, f 1536, 160 experts top-6,
              bt 8, P 8, bf16 weights from seed 0; 8 x 64 tokens, unit
              cotangents): lockstep integer arrays bit-equal on the
              shared-pool layout (cost, scan) and on dense static queues,
              each column group of `out` within GRAD_RTOL of its scale; free
              mode runs every live tile and prints sum(mult)/tiles; the
              no-thief rewind drill gives mult == 2 with the rows unchanged;
              the forward kernel on the same pool queues, bit-equal too.  The
              cost case is traced (rings bit-equal); a traced free launch and
              one seeded FaultPlan without launch faults (lockstep against
              the plain walk, and free) go through SafetyChecker.  With the
              halfrun phase: the kernel at cap 2 and 4 (lockstep bit-equal
              to the plain walk, a traced free launch checker-clean),
              HALFRUN_PLAN at cap 4, and its cap 1, 2, 4 statistics.
9. train      deepseek-v2-236b at full width cut to 1 layer (5.02 B
              parameters, bf16, AdamW with fp32 states), moe_dispatch and
              moe_grad_dispatch "ws", 8 x 64 tokens, seed 0.  Before the
              optimizer exists: one step's loss and every gradient against
              the same step on the plain versions of both kernels, with
              ws_expert 2 and ws_expert_grad 1 launches; that step's grad
              launch against the plain version on its own inputs (a bf16
              evaluation of the same rows must miss); the grad kernel's
              times at that launch (cold too, sum(mult)/tiles, the tile
              layout and its floor).  Then 3 steps through train() (its
              make_optimizer / make_train_step / make_batch), launches
              counted from 0 (2 and 1 a step), finite losses, step seconds
              and peak device memory printed; the grad kernel's free time
              untraced and traced.
10. sched     the paper's scheduler as the train step's gradient accumulation
              (repro_torch.sched) on the train phase's model (deepseek-v2-236b
              full width, 1 layer, both ws kernels, SCHED): the 8 rows are 8
              microbatch tasks on 4 worker queues of tails [5, 1, 1, 1], a
              round 4 rows x 64 tokens.  schedule_rounds on the card equals
              the CPU's, every mode, sync_every 1 and 3; for every mode one
              step through ws_accumulate_grads against the plain full-batch
              step on the same 8 rows, the loss within STEP_LOSS_ATOL and
              every gradient within STEP_ULP_SLACK one-ulp distances: the
              train phase's (the MoE output moved one bf16 ulp) with, in
              quadrature, sqrt((R - 1) / 12) of the plain gradient moved one
              bf16 ulp (the R rounds are summed in bf16, the parameters'
              dtype, as the reference sums them); the same rounds summed in
              fp32 within STEP_ULP_SLACK of the train phase's distance
              alone (the row-separable loss: the load-balance term is per
              routing group and is left out, row_separable_loss);
              launches = rounds run x STEP_LAUNCHES, the rounds,
              duplicate picks, sum(counts) and seconds printed; ws-wmult
              must pick duplicates, and the no-division control (its
              extracted rows, duplicates kept, each weight 1) must miss.
              Then 3 train(ws_mode="ws-wmult", skew 4) steps: finite losses,
              ws_coverage 1.0, launches = each step's rounds x
              STEP_LAUNCHES, step seconds and peak device memory.
11. unified   llama3.2-3b in fp32 at full width (28 layers, 14.43 GB) through
              the unified step (ws_unified: in lockstep a walker CTA and one
              helper CTA an other SM, H = SM count - 1): one lockstep decode
              step at the serving shape (4 slots x 1024 positions), traced,
              and one with a folded 100-token prompt against the plain
              version (integer arrays and the decode step's rings
              bit-equal, logits, caches and the prompt's k/v within
              UNIFIED_RTOL of their scale), the lockstep step against the
              split fp32 step, free mode's 86 per-stage launches (traced,
              every task run, within UNIFIED_RTOL of lockstep, clean under
              SafetyChecker's free-mode reading); the walker and its
              helpers (_unified_helpers): logits bit-equal at H = 0, 1 and
              the largest H, decode and fold, the walker's requests a step
              equal to unified_kernel.expected_requests and the time it
              waited on them, and a one-CTA (H = 0) step's time; times
              (lockstep, fold, free untraced and traced, beside the first
              version's FIRST_VERSION_MS) and bounds; then
              2 replicas of ContinuousBatcher(unified_step=True) serve 8
              requests (prompts 16-128 tokens) with no degradation and one
              ws_unified launch per step and no other kernel, and their
              greedy streams equal the split engine's (a difference passes
              only at a top-2 near-tie within the tolerance).  Then the
              watchdog (WATCHDOG): one unified batcher serving 4 prompts
              healthy, with EngineFaultPlan(poison_steps=(0, 2)) and with a
              deadline, watchdog_cooldown 2 and slow_steps (1,):
              degradations non-finite x 2 and deadline at step 1, the
              streams the healthy run's, and the launches of every step
              (ws_unified 1 and nothing else on a healthy step, 1 plus the
              split redo's ws_attention on a poisoned one, ws_attention
              alone in the cooldown).
12. unified_moe  kimi-k2-1t-a32b in fp32 at full width cut to 1 layer (77.69
              GB of weights, the experts passed in place), after the llama
              weights are freed, through the MoE half of the unified step
              (router, pool Put, expert tiles, expert combine in ws_unified):
              one lockstep decode step at 4 slots of lengths 1024, 658, 531,
              288 (traced) and one with a folded 64-token prompt against the
              plain version (integer arrays and the decode step's rings
              bit-equal, the routing buffers equal,
              logits, caches and the prompt's k/v within UNIFIED_RTOL of their
              scale; a row whose top-8 is a near-tie within the router's
              rounding is reported and left out), against the split fp32 step
              (ws_attention, ws_expert), free mode's 7 per-stage launches
              (traced; sum(mult)/tasks and the largest mult printed, clean
              under SafetyChecker's free-mode reading), the walker and its
              helpers as in the unified phase, times (beside the first
              version's), bounds from this run's routing and peak memory;
              then 2 replicas of
              ContinuousBatcher(unified_step=True) serve 8 requests (prompts
              8-64 tokens, 8 new tokens) with one ws_unified launch a step,
              no other kernel and no degradation, against the split engine.
13. ckpt      checkpoints (repro_torch.checkpoint) through train(): llama3.2-3b
              bf16 at full width cut to 2 layers, AdamW (CKPT): run A, 6 steps
              saving every 2 and at the last (the newest 3 kept), its last
              save restored onto the card and held to A's final state bit
              for bit; run B, a child process preempted after step 3, must
              exit 17 with step 2 saved; run C resumes at step 3, its losses
              A's within CKPT_LOSS_ATOL.  Bytes, snapshot and background
              write seconds of every save, the restore's seconds.
14. ssm       mamba2-2.7b and zamba2-2.7b in bf16 at full width and depth
              (SSM): the last logits of a prefill of 128 tokens against a
              prefill of 120 and 8 dense decode steps, in fp32 within
              SSM_FP32_TOL and in bf16 within SSM_SLACK times the bf16
              prefill's distance from the fp32 one, which a decode whose
              conv state is not shifted must exceed; 2 replicas x 4 slots
              serving 8 requests twice (the same greedy streams; step
              p50/p99 and tokens/s); 2 train() steps at depth 2 (zamba2 6).
              Then ssd_scan on mamba2's own layer-0 scan inputs from a 4 x
              1024-token prefill against ssd_chunked (the kernels phase's
              limits; device times of both): a comparison launch, outside
              the model path, which runs ssd_chunked as the reference does.
15. families  three more families through their entry points (FAMILIES),
              each freed before the next, bf16, random weights from seed 0.
              deepseek-v2-236b at full width cut to 2 layers,
              moe_dispatch="ws", served: 2 replicas x 4 slots x 1024
              positions, 8 requests all submitted to replica 0, on the
              dense MLA decode step (ws_attention 0, ws_expert a layer in
              every prefill and decode step; one step counted alone: 2,
              each of its expert launches held to the plain version on its
              own inputs within ATOL, the bf16-rows control missing it);
              step p50/p99, tokens/s, peak memory.  pixtral-12b at full
              width and depth: 4 rows of 256 patches and 64-128 text
              tokens, each prefilled alone into its slot (capacity 1280),
              4 decode_step_ws steps with the host Put (40 ws_attention
              launches a step, head dim 160; step 0's last launch held to
              the plain version within ATOL), step 0 against the dense step
              (the ws step at most LOGIT_SLACK times as far from the fp32
              dense step as the bf16 dense step) and, through the captured
              device-Put step, bit-equal to the host Put's (a replay's
              device time).  whisper-base at full width and depth (6 + 6
              layers, the encoder over 1500 frames), then 2 train() steps
              with finite losses.  For each, one row's decode path against
              a prefill of the whole sequence (FAM_FP32_TOL in fp32, which
              the bf16 one-ulp control must miss; LOGIT_SLACK in bf16,
              which a faulty decode must miss; the fp32 side with the
              kernels' plain versions; deepseek's decode path replays the
              prefill's top-6 and counts the flips).
16. windowed  the banded flash path (models/attention.py::_flash_banded) and
              the dense windowed and tied configs (WINDOWED), bf16 unless it
              says fp32, random weights from seed 0, each freed before the
              next.  The attention alone at full width: gemma3-12b's local
              layer (B 1, S 8192, H 16 over 8, hd 256, window 1024) and an
              h2o-danube-1.8b layer (H 32 over 8, hd 80, window 4096),
              flash_ref (banded) against _Flash.apply with qoff 0 (masked)
              on the same inputs: forward and forward + backward ms, peak
              memory, out/dq/dk/dv differences in bf16 (WIN_BF16_ULPS x nb
              bf16 ulps of the scale) and in fp32 (WIN_FP32_TOL, which the
              bf16 one-ulp control must miss).  gemma3-12b at full depth (48
              layers) served by 2 replicas x 4 slots x 3072 positions: 4
              prompts of 1536-3000 tokens (past the local window: the
              banded branch in every local layer of every prefill), 16 new
              tokens each on the dense step (past the window's edge); step
              p50/p99, tokens/s, peak memory; one row's decode path (2048 +
              16) against a longer prefill as the families phase holds it,
              the control a decode that ignores the window.  3 train()
              steps of h2o-danube-1.8b at full depth on 1 x 8192 tokens
              (every layer banded) and 2 of gemma3-12b at depth 6 (one
              local:global period) on 1 x 4096: finite losses, step
              seconds, peak memory.  minicpm-2b (MHA, tied embeddings,
              depth-scaled residuals) at full width and depth served on
              decode_step_ws: ws_attention 40 launches a step (hd 64), one
              step's last launch held to the plain version within ATOL.
              Every kernel's launches on each of these paths.
17. core      repro_torch.core standing alone: every ALGORITHMS entry on
              real threads (ThreadBackend, 1 owner and 7 thieves, 4096
              puts) keeps its family's contract (multiplicity: no process
              extracts a task twice, none lost; exact: each task once;
              idempotent: each at least once), sum(extractions)/tasks
              printed; seeded SimBackend schedules through run_program with
              the property checkers the reference's tests apply to each
              family, and the §7 drill; each queue of the llama3.2-3b
              decode Put built by the device Put (make_queue_state_torch)
              read back and held, field for field, to a PallasWSHost given
              its records by put_segment, which then drains them.

The last three lines are the card (nvidia-smi name, power limit), one JSON
object listing the 7 ported kernels (the megakernels each with its
free-mode times untraced and traced, its checker reports and, but for
ws_unified, its half-run statistics; ws_attention's also the ragged
prefill; ws_unified's the tagged hand-off probe and, per model, its
helpers' readings; the standalone kernels each with its cases; the six
redesigned for this card (REDESIGNED, all seven) marked so; their first
versions' times are printed only in the log lines beside this run's), and {"ok":
true, "device": {...}}.

    python3 chip_smoke.py --phases build,audit,chaos       # the short check of the rings
    python3 chip_smoke.py --phases build,audit,halfrun,grad   # the short check of half-run
    python3 chip_smoke.py --phases build,audit,kernels     # the standalone kernels
    python3 chip_smoke.py --phases build,audit,parity,halfrun,times,kernels
                                                # the redesigned attention kernels
    python3 chip_smoke.py --phases build,audit,unified,unified_moe
                                                # the redesigned unified step
    python3 chip_smoke.py --phases build,serving,unified,ckpt,ssm
                                                # serving faults, checkpoints, the ssm family
    python3 chip_smoke.py --phases build,train,sched   # the scheduler on the training path
    python3 chip_smoke.py --phases build,families      # MLA serving, the vlm and encdec families
    python3 chip_smoke.py --phases build,windowed,core # banded attention, windowed configs, core
    python3 chip_smoke.py --probe                # the tagged hand-off probe alone
    python3 chip_smoke.py --audit-baseline DIR   # another checkout's per-function audit
    python3 chip_smoke.py --expert-ab DIR [DIR ...]
                                                # ws_expert's times, theirs beside ours
    python3 chip_smoke.py --ssd-ab DIR [DIR ...]
                                                # ssd_scan's times, theirs beside ours
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

# fp32 accumulation of identical bf16 inputs in another order: 128-term dot
# products and softmax sums over up to 1024 keys of O(1) values differ by a
# few fp32 ulps of the sums, far below 1e-4.
ATOL = 1e-4
# ws vs dense logits at full width: both run the same bf16 projections and
# MLPs and differ in attention (the kernel's is fp32 end to end, the dense
# path rounds scores and weights to bf16), 28 layers deep with random
# weights.  The yardstick is the same step in fp32: the ws step may stray
# from it at most LOGIT_SLACK times as far as the dense bf16 step does.
LOGIT_SLACK = 2.0

# ws vs plain version of one kimi-k2 step.  Each expert launch of the step
# is held to the plain version on its own inputs within ATOL (both fp32, the
# same math summed in another order; ~1e-6 of |out|), and a bf16 evaluation
# of the same rows, as the dense dispatch's einsums compute experts, must
# miss ATOL (its products and hidden tile round to 2^-9 relative, ~1e-3 of
# |out|).  End to end the two steps cannot be held closer than the bf16
# residual stream allows: a last-bit difference flips the bf16 rounding of a
# few activations, each flipped input of a d-wide projection perturbs its
# outputs by ~sqrt(n/d) ulp and so flips ~sqrt(n*d) of them, and within a
# few rounded products of two layers most elements of the final hidden state
# differ by an ulp, whatever precision the experts use.  So the fp32 logits
# (final norm and unembedding in fp32) are held to LOGIT_ULP_SLACK times the
# distance that moving every element of the plain step's final hidden state
# by one bf16 ulp makes: a saturated cascade reads about 1, and 2 allows
# each element two stacked roundings (one per layer).  Top-k routing is discontinuous: a near-tie flipped
# by a last-bit difference would change a token's experts, which says
# nothing of the kernels, so the plain step replays the ws step's routing
# and the number of top-k sets that would have differed is reported.
LOGIT_ULP_SLACK = 2

SEED = 0
DECODE = dict(B=4, H=24, Hkv=8, hd=128, S=1024, bk=64, P=8)
KIMI_DECODE = dict(B=4, H=64, Hkv=8, hd=112, S=1024, bk=64, P=8)
EXPERT = dict(d=7168, f=2048, E=384, k=8, bt=8, P=8)
EXPERT_T = {"decode": 4, "prefill": 64}
PHASES = ("build", "parity", "expert", "audit", "chaos", "halfrun", "kernels", "serving", "times",
          "moe", "grad", "train", "sched", "unified", "unified_moe", "ckpt", "ssm", "families",
          "windowed", "core")
FLASH = dict(B=2, H=24, Hkv=8, hd=128, S=256, bq=16, bk=64, P=8)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
# Seeded FaultPlans of the chaos checks (FaultPlan.from_seed, P 8): with
# kills, storms, stalls and advisory garbage between them.
CHAOS_SEEDS = (3, 5)
GRAD_CHAOS_SEED = 6            # kills (2, 2) and a full storm, without launch faults

# Half-run Steal: the caps held to the plain walks, the fault plan run at
# cap 4 (a kill, then a full head-rewind storm; no launch faults, so the
# grad kernel takes it too), and the caps of the free-launch statistics.
HALFRUN_CAPS = (2, 4)
HALFRUN_PLAN = dict(seed=3, kills=(1,), storms=1, full_first_storm=True)
HALFRUN_STATS_CAPS = (1, 2, 4)
HALFRUN_STATS_N = 10           # timed launches a cap (ws_expert_grad: 2 of ~3 s, no warm-up)
# The ragged prefill at llama3.2-3b's widths: one causal bf16 batch.
RAGGED = dict(H=24, Hkv=8, hd=128, S=1024, lengths=(1024, 658, 531, 288), bq=32, bk=32, P=8)
# The free decode launch of the times phase also at these program counts,
# for the record (the engine and the reference use P = 8).
TIMES_PROGRAMS = (16, 32, 132)
# The kernels redesigned for this card, and their first versions' times
# (the kernels of commit 5ee879c, for the expert kernels of commit 8da571d,
# for ws_unified of commit 0b68ecc, for ssd_scan of commit 3b379c4: the ranges
# of this script's runs of that kernel on an NVIDIA H100 80GB HBM3, 700.00 W,
# warm; PERF.md §6), printed in the log beside this run's and kept out of the
# kernels line, whose numbers are all this run's.
REDESIGNED = ("ws_attention", "flash_fwd", "decode_attention", "ws_expert", "ws_expert_grad",
              "ws_unified", "ssd_scan")
FIRST_VERSION_MS = {
    "ws_attention free": (6.52, 7.51), "ws_attention lockstep": (37.80, 39.19),
    "ragged prefill static": (1277.1, 1287.0), "ragged prefill ws": (365.9, 468.4),
    "ragged prefill ws_cap4": (431.2, 491.8),
    "flash_fwd gemma3-12b local": (11.07, 11.16), "flash_fwd gemma3-12b global": (26.03, 26.07),
    "flash_fwd llama3.2-3b": (26.02, 26.03),
    "decode_attention gemma3-12b local pos 8191": (0.448, 0.465),
    "decode_attention gemma3-12b global pos 8191": (4.014, 4.022),
    "decode_attention gemma3-12b local pos 4000": (0.753, 0.757),
    "decode_attention gemma3-12b global pos 4000": (2.013, 2.016),
    "decode_attention llama3.2-3b serving cache pos 1000": (0.156, 0.158),
    "ws_expert free": (81.4, 165.2), "ws_expert lockstep": (166.05, 169.5),
    "ws_expert_grad free": (2487.2, 3715.9), "ws_expert_grad lockstep": (4862.1, 4893.6),
    "ws_unified llama lockstep": (675.41, 704.41), "ws_unified llama fold": (4547.85, 4734.68),
    "ws_unified llama free": (293.65, 340.83), "ws_unified kimi lockstep": (277.40, 280.84),
    "ws_unified kimi fold": (1365.15, 1380.70), "ws_unified kimi free": (103.57, 109.27),
    "ssd_scan mamba2-2.7b": (6.81, 6.82),
}


def _first_unified(model):
    """The first ws_unified's times at ``model`` (one CTA in lockstep), for the log."""
    return ", ".join(f"{m} {a}-{b} ms" for m in ("lockstep", "fold", "free")
                     for a, b in [FIRST_VERSION_MS[f"ws_unified {model} {m}"]])

# Checker reports, traced/untraced free-mode times and half-run statistics of
# this run, by kernel (the kernels line carries them), and data a later phase
# reuses.
CHAOS = {}
TRACED = {}
HALFRUN = {}
HELD = {}
HANDOFF = {}   # the tagged hand-off probe's readings (the audit's)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all(_build.KERNELS)
    log(f"[build] {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {_build.BUILD_SECONDS[n]:.2f} s" for n in paths) + ")")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name} ptxas:", line.strip())
    log("[build] card:", card_line())


def _ints(res):
    """The launch's integer arrays, with its event rings when it was traced."""
    names = ("head", "local_head", "taken", "remaining", "clock", "work",
             "steals", "scanned", "mult")
    if res.events is not None:
        names += ("events", "ev_cursor")
    return {n: getattr(res, n).cpu().numpy() for n in names}


def _report(kernel, what, rep):
    """Log one SafetyChecker report and keep it for the kernels line; a
    violation fails the run."""
    entry = dict(what=what, mode=rep.stats["mode"], ok=rep.ok, max_mult=rep.max_mult,
                 mult_per_task=round(rep.stats["mult_per_task"], 4), n_tasks=rep.n_tasks,
                 n_claims=rep.n_claims, dropped=rep.dropped,
                 segments=[sg["kind"] for sg in rep.stats["segments"]],
                 parity=rep.normalized_parity, clauses=rep.stats["clauses"])
    CHAOS.setdefault(kernel, []).append(entry)
    log(f"[chaos] {kernel} {what}: {json.dumps(entry)}")
    if not rep.ok:
        raise AssertionError(f"{kernel} {what}: {[str(v) for v in rep.violations]}")


def _same_segments(name, ck, cp):
    """Two lockstep fault runs, the kernel's and the plain walk's: the same
    segments, start snapshots, streams and integer arrays."""
    if [(sg.kind, sg.budget) for sg in ck.segments] != [(sg.kind, sg.budget) for sg in cp.segments]:
        raise AssertionError(f"{name}: segment sequences differ")
    for i, (a, b) in enumerate(zip(ck.segments, cp.segments)):
        same = (np.array_equal(a.start_head, b.start_head)
                and np.array_equal(a.start_local, b.start_local)
                and np.array_equal(a.stream, b.stream) and a.dropped == b.dropped)
        ia, ib = _ints(a.res), _ints(b.res)
        bad = [n for n in ia if not np.array_equal(ia[n], ib[n])]
        if not same or bad:
            raise AssertionError(f"{name}: segment {i} ({a.kind}) differs from the plain walk's "
                                 f"{bad or 'snapshot/stream'}")


def _chaos_plans(kernel, what, state, launch, plain_launch, check, rounds, seeds,
                 without_launch_faults=False, steal_run_cap=1):
    """Each seeded FaultPlan (or each FaultPlan given in ``seeds``) through
    run_with_faults: in lockstep on the kernel and on the plain walk
    (bit-equal segments, checker clean), and in free mode on the kernel
    (checker clean).  ``launch(mode)`` and ``plain_launch`` are
    run_with_faults launch callables taking ``steal_run_cap``;
    ``check(chaos)`` returns the checker's report."""
    from repro_torch.chaos import FaultPlan, run_with_faults
    from repro_torch.pallas_ws import copy_state

    kw = dict(rounds=rounds, steal_run_cap=steal_run_cap)
    for seed in seeds:
        plan = (seed if isinstance(seed, FaultPlan)
                else FaultPlan.from_seed(seed, n_programs=state.n_programs))
        if without_launch_faults:
            plan = plan.without_launch_faults()
        name = f"{what} plan {plan.seed} (stalls {list(plan.stalls)}, {plan.advisory} " \
               f"advisory, kills {list(plan.kills)}, storms {plan.storms}" \
               + (", a full storm" if plan.full_first_storm else "") \
               + (f", steal_run_cap {steal_run_cap})" if steal_run_cap > 1 else ")")
        ck = run_with_faults(copy_state(state), launch("lockstep"), plan, **kw)
        torch.cuda.synchronize()
        cp = run_with_faults(copy_state(state), plain_launch, plan, **kw)
        _same_segments(f"{kernel} {name}", ck, cp)
        _report(kernel, f"{name} lockstep (segments bit-equal to the plain walk)", check(ck))
        cf = run_with_faults(copy_state(state), launch("free"), plan, mode="free", **kw)
        torch.cuda.synchronize()
        _report(kernel, f"{name} free", check(cf))


def _rounds(mode, rounds):
    """The rounds argument of a timed launch: the lockstep grid, and in free
    mode 0, no budget (a traced free CTA reads a positive one as its budget)."""
    return rounds if mode == "lockstep" else 0


def _with_rings(arrs_list, cap, policy="cost"):
    """Fresh event rings (and a zero carried mult) for launch-ready array
    sets of free-mode launches; returns each set's ring arguments."""
    from repro_torch.pallas_ws import kernel as K
    from repro_torch.wstrace import EVENT_WIDTH

    kind = K.KIND_STEAL_SCAN if policy == "scan" else K.KIND_STEAL_COST
    rings = []
    for a in arrs_list:
        P, n_tasks = a["mult"].shape
        dev = a["mult"].device
        a["events"] = torch.full((P, cap, EVENT_WIDTH), -1, dtype=torch.int32, device=dev)
        a["ev_cursor"] = torch.zeros(P, dtype=torch.int32, device=dev)
        a["mult0"] = torch.zeros(n_tasks, dtype=torch.int32, device=dev)
        rings.append((a["events"].data_ptr(), a["ev_cursor"].data_ptr(), a["mult0"].data_ptr(),
                      cap, kind, K.FREE_STALL_NS))
    return rings


def decode_inputs(rng, dev, c=None):
    c = DECODE if c is None else c
    lengths = rng.integers(16, c["S"] + 1, size=c["B"])
    lengths[0] = c["S"]  # one full-length slot: the skew the thieves erase
    q = torch.from_numpy(rng.standard_normal((c["B"], c["H"], c["hd"]), np.float32))
    # K/V as the serving cache lays them out: [B, S, Hkv, hd], read through a
    # transposed [B, Hkv, S, hd] view exactly as gqa_decode_ws passes them
    k = torch.from_numpy(rng.standard_normal((c["B"], c["S"], c["Hkv"], c["hd"]), np.float32))
    v = torch.from_numpy(rng.standard_normal((c["B"], c["S"], c["Hkv"], c["hd"]), np.float32))
    to = lambda t: t.to(torch.bfloat16).to(dev)  # noqa: E731
    return lengths, to(q), to(k).permute(0, 2, 1, 3), to(v).permute(0, 2, 1, 3)


def _check_lockstep(name, state, q, k, v, **kw):
    from repro_torch.pallas_ws import run_ws_schedule, to_device

    res_k = run_ws_schedule(to_device(state, q.device), q, k, v, mode="lockstep", **kw)
    torch.cuda.synchronize()
    res_p = run_ws_schedule(state, q.cpu(), k.cpu(), v.cpu(), mode="lockstep", **kw)
    ik, ip = _ints(res_k), _ints(res_p)
    for n in ik:
        if not np.array_equal(ik[n], ip[n]):
            raise AssertionError(f"{name}: lockstep {n} differs from the plain version")
    err = float((res_k.out.cpu() - res_p.out).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"{name}: lockstep out max_abs_err {err} > {ATOL}")
    log(f"[parity] {name} lockstep: integer arrays bit-equal, out max_abs_err {err:.3g}")
    return res_p, err


def _check_free(name, state, q, k, v, expect, tasks, **kw):
    from repro_torch.pallas_ws import copy_state, normalized_out, run_ws_schedule, to_device

    B, H, Sq = q.shape[0], q.shape[1], q.shape[2]
    res = run_ws_schedule(to_device(state, q.device), q, k, v, mode="free", **kw)
    torch.cuda.synchronize()
    mult = res.mult[: state.n_tasks].cpu()
    if not bool((mult >= 1).all()):
        raise AssertionError(f"{name}: free mode left {(mult == 0).sum()} tasks unexecuted")
    err = float((res.out.cpu() - expect).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"{name}: free out max_abs_err {err} > {ATOL}")
    log(f"[parity] {name} free: mult in [{int(mult.min())}, {int(mult.max())}], "
        f"out max_abs_err {err:.3g}, clock {res.clock.cpu().tolist()}")

    # rewind drill: resume from the finished launch with every head dragged
    # back to 0 and every local bound wiped; without thieves each task runs
    # exactly once more (mult == 2) and the stored out must not change.
    drill = copy_state(state)
    drill.head = np.zeros_like(drill.head)
    drill.local_head = np.zeros_like(drill.local_head)
    drill.taken = res.taken.cpu().numpy()
    drill.remaining = res.remaining.cpu().numpy()
    kw_static = dict(kw, steal=False)
    first = run_ws_schedule(to_device(state, q.device), q, k, v, mode="free", **kw_static)
    second = run_ws_schedule(to_device(drill, q.device), q, k, v, mode="free",
                             mult=first.mult, **kw_static)
    torch.cuda.synchronize()
    m2 = second.mult[: state.n_tasks].cpu()
    if not bool((m2 == 2).all()):
        raise AssertionError(f"{name}: rewind drill mult in [{int(m2.min())}, {int(m2.max())}], want 2")
    out2 = normalized_out(second, tasks, (B, H, second.out.shape[2]))
    err2 = float((out2.cpu() - expect).abs().max())
    if not err2 <= ATOL:
        raise AssertionError(f"{name}: rewind drill out max_abs_err {err2} > {ATOL}")
    # the same drill with thieves: every task runs at least once more
    second_ws = run_ws_schedule(to_device(drill, q.device), q, k, v, mode="free",
                                mult=res.mult, **kw)
    torch.cuda.synchronize()
    m3 = second_ws.mult[: state.n_tasks].cpu()
    err3 = float((second_ws.out.cpu() - expect).abs().max())
    if not (bool((m3 >= 2).all()) and err3 <= ATOL):
        raise AssertionError(f"{name}: stealing rewind drill mult min {int(m3.min())}, err {err3}")
    log(f"[parity] {name} rewind drill: mult == 2 without thieves (err {err2:.3g}), "
        f"mult in [{int(m3.min())}, {int(m3.max())}] with thieves (err {err3:.3g})")
    return max(err, err2, err3)


def phase_parity(dev):
    from repro_torch.pallas_ws import (
        emit_decode_tasks, emit_flash_tasks, make_queue_state, normalized_out,
        ragged_decode_ref,
    )

    rng = np.random.default_rng(SEED)
    c = DECODE
    lengths, q, k, v = decode_inputs(rng, dev)
    tasks = emit_decode_tasks(lengths, c["H"], c["bk"])
    state = make_queue_state(tasks, c["P"])
    q4 = q[:, :, None, :]
    kw = dict(causal=False, bq=1, bk=c["bk"])
    errs = []
    for steal, policy in ((True, "cost"), (True, "scan"), (False, "cost")):
        res_p, err = _check_lockstep(f"decode steal={steal} {policy}", state, q4, k, v,
                                     steal=steal, steal_policy=policy, **kw)
        errs.append(err)
    # the traced instantiation: its event rings too, bit for bit
    errs.append(_check_lockstep("decode steal=True cost traced (rings)", state, q4, k, v,
                                steal=True, steal_policy="cost", trace=True, **kw)[1])
    expect = normalized_out(res_p, tasks, (c["B"], c["H"], 1))
    errs.append(_check_free("decode", state, q4, k, v, expect, tasks, **kw))
    ref = ragged_decode_ref(q.cpu(), k.cpu(), v.cpu(), lengths).float()
    err_ref = float((expect[:, :, 0] - ref).abs().max())
    # the dense oracle rounds its output to bf16: half an ulp of |out| <= 4
    if not err_ref <= 2 ** -7:
        raise AssertionError(f"plain decode vs dense oracle max_abs_err {err_ref}")
    log(f"[parity] plain decode vs dense oracle (bf16 output) max_abs_err {err_ref:.3g}")

    f = FLASH
    fl = rng.integers(16, f["S"] + 1, size=f["B"])
    fq = torch.from_numpy(rng.standard_normal((f["B"], f["H"], f["S"], f["hd"]), np.float32))
    fk = torch.from_numpy(rng.standard_normal((f["B"], f["Hkv"], f["S"], f["hd"]), np.float32))
    fv = torch.from_numpy(rng.standard_normal((f["B"], f["Hkv"], f["S"], f["hd"]), np.float32))
    fq, fk, fv = (t.to(torch.bfloat16).to(dev) for t in (fq, fk, fv))
    ftasks = emit_flash_tasks(fl, f["H"], f["bq"], f["bk"], causal=True)
    fstate = make_queue_state(ftasks, f["P"])
    fkw = dict(causal=True, bq=f["bq"], bk=f["bk"])
    res_p, err = _check_lockstep("flash causal", fstate, fq, fk, fv, **fkw)
    errs.append(err)
    fexpect = normalized_out(res_p, ftasks, (f["B"], f["H"], res_p.out.shape[2]))
    errs.append(_check_free("flash causal", fstate, fq, fk, fv, fexpect, ftasks, **fkw))
    return max(errs)


# ---------------------------------------------------------------------------
# the expert kernel


@contextmanager
def plain_versions():
    """Route every kernel's wrapper to its plain PyTorch version on the
    card (the comparisons' yardstick; the port itself never does this)."""
    from repro_torch.moe_ws import expert_kernel as X
    from repro_torch.pallas_ws import kernel as K

    saved = K.launch_ws_grid, X.launch_moe_grid, X.launch_moe_grad_grid
    K.launch_ws_grid, X.launch_moe_grid, X.launch_moe_grad_grid = (
        K.plain_ws_grid, X.plain_moe_grid, X.plain_moe_grad_grid)
    try:
        yield
    finally:
        K.launch_ws_grid, X.launch_moe_grid, X.launch_moe_grad_grid = saved


@contextmanager
def routing_tape(record=None, replay=None):
    """Record the router's top-k of each MoE layer, or replay a recording
    (counting the tokens whose own top-k set would have differed).  Yields
    the counts [router calls, flips]; the caller checks the calls, so a
    renamed router cannot leave the tape silently unused."""
    from repro_torch.moe_ws import layer

    orig = layer._router
    tape = iter(replay) if replay is not None else None
    counts = [0, 0]

    def router(x_flat, p, cfg, group_size):
        probs, gates, idx, aux = orig(x_flat, p, cfg, group_size)
        counts[0] += 1
        if record is not None:
            record.append((gates.detach(), idx))
        if tape is not None:
            gates0, idx0 = next(tape)
            differ = (idx.sort(-1).values != idx0.sort(-1).values).any(-1)
            counts[1] += int(differ.sum())
            gates, idx = gates0, idx0
        return probs, gates, idx, aux

    layer._router = router
    try:
        yield counts
    finally:
        layer._router = orig


def expert_weights(dev, c=None):
    """Full-width expert weights wg, wu [E, d, f], wd [E, f, d], bf16, drawn
    slab by slab from seed 0 (the port's init of a MoE layer's experts), at
    kimi-k2's widths unless ``c`` names others."""
    from repro_torch.models.common import dense_init_slabs

    c = EXPERT if c is None else c
    kw = dict(generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    return (dense_init_slabs(c["d"], (c["E"], c["d"], c["f"]), torch.bfloat16, **kw),
            dense_init_slabs(c["d"], (c["E"], c["d"], c["f"]), torch.bfloat16, **kw),
            dense_init_slabs(c["f"], (c["E"], c["f"], c["d"]), torch.bfloat16, **kw))


def routing_draw(rng, T):
    """Top-k routing of T tokens at kimi-k2's widths (k distinct experts each,
    normalised gates) and their fp32 activations: ``(idx, gates, x)``."""
    c = EXPERT
    idx = np.stack([rng.choice(c["E"], c["k"], replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, c["k"])).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    return idx, gates, rng.standard_normal((T, c["d"])).astype(np.float32)


def expert_routing(rng, T):
    """Top-k routing of T tokens (k distinct experts each, normalised gates)
    and their fp32 activations, as the host Put lays them out."""
    from repro_torch.moe_ws import route_to_tasks
    from repro_torch.pallas_ws import make_queue_state

    c = EXPERT
    idx, gates, x = routing_draw(rng, T)
    tasks, routed = route_to_tasks(idx, gates, c["E"], bt=c["bt"])
    ws = make_queue_state(tasks, c["P"], n_queues=c["E"], partition="owner")
    static = make_queue_state(tasks, c["P"], n_queues=c["P"], partition="owner")
    return x, tasks, routed, ws, static


def _moe(state, x, routed, w, *, plain=False, **kw):
    from repro_torch.moe_ws import run_moe_schedule
    from repro_torch.pallas_ws import to_device

    if plain:
        with plain_versions():
            return run_moe_schedule(state, x, routed.tok_idx, *w, bt=EXPERT["bt"], **kw)
    return run_moe_schedule(to_device(state, x.device), x, routed.tok_idx, *w,
                            bt=EXPERT["bt"], **kw)


def _check_expert(name, x, tasks, routed, ws, static, w):
    """Lockstep bit-equality, free-mode completeness and the no-thief rewind
    drill of the expert kernel against its plain version, on the card."""
    from repro_torch.moe_ws import combine_routed
    from repro_torch.pallas_ws import copy_state

    errs = []
    for steal, policy, state in ((True, "cost", ws), (True, "scan", ws), (False, "cost", static)):
        kw = dict(mode="lockstep", steal=steal, steal_policy=policy)
        res_k = _moe(state, x, routed, w, **kw)
        torch.cuda.synchronize()
        res_p = _moe(state, x, routed, w, plain=True, **kw)
        ik, ip = _ints(res_k), _ints(res_p)
        for n in ik:
            if not np.array_equal(ik[n], ip[n]):
                raise AssertionError(f"expert {name} steal={steal} {policy}: lockstep {n} "
                                     "differs from the plain version")
        err = float((res_k.out - res_p.out).abs().max())
        if not err <= ATOL:
            raise AssertionError(f"expert {name}: lockstep out max_abs_err {err} > {ATOL}")
        errs.append(err)
        if steal and policy == "cost":
            expect = combine_routed(routed, tasks, res_p)
        log(f"[expert] {name} steal={steal} {policy} lockstep: integer arrays bit-equal, "
            f"out max_abs_err {err:.3g}, {state.n_tasks} tiles, makespan {res_k.makespan}")

    res = _moe(ws, x, routed, w, mode="free")
    torch.cuda.synchronize()
    mult = res.mult[: ws.n_tasks].cpu()
    if not bool((mult >= 1).all()):
        raise AssertionError(f"expert {name}: free mode left {(mult == 0).sum()} tiles unexecuted")
    err = float((combine_routed(routed, tasks, res) - expect).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"expert {name}: free combine max_abs_err {err} > {ATOL}")
    errs.append(err)
    log(f"[expert] {name} free: mult in [{int(mult.min())}, {int(mult.max())}], "
        f"sum(mult)/tiles {int(mult.sum()) / ws.n_tasks:.2f}, combine max_abs_err {err:.3g}")

    # rewind drill without thieves: resume with every head at 0 and every
    # local bound wiped; each tile runs exactly once more (mult == 2)
    first = _moe(static, x, routed, w, mode="free", steal=False)
    drill = copy_state(static)
    drill.head = np.zeros_like(drill.head)
    drill.local_head = np.zeros_like(drill.local_head)
    drill.taken = first.taken.cpu().numpy()
    drill.remaining = first.remaining.cpu().numpy()
    second = _moe(drill, x, routed, w, mode="free", steal=False, mult=first.mult)
    torch.cuda.synchronize()
    m2 = second.mult[: static.n_tasks].cpu()
    if not bool((m2 == 2).all()):
        raise AssertionError(f"expert {name}: rewind drill mult in "
                             f"[{int(m2.min())}, {int(m2.max())}], want 2")
    err2 = float((combine_routed(routed, tasks, second) - expect).abs().max())
    if not err2 <= ATOL:
        raise AssertionError(f"expert {name}: rewind drill combine max_abs_err {err2} > {ATOL}")
    log(f"[expert] {name} rewind drill: mult == 2 without thieves, combine max_abs_err {err2:.3g}")
    return max(errs + [err2])


def _fresh_arrays(state, mode, n):
    """n launch-ready copies of a device state's mutable arrays."""
    P, n_tasks = state.n_programs, max(1, state.n_tasks)
    dev = state.tasks.device
    arrs = []
    for _ in range(n):
        a = {x: getattr(state, x).clone() for x in ("head", "local_head", "taken", "remaining")}
        a.update(tasks=state.tasks, tail=state.tail)
        if state.pool_off is not None:
            a["pool_off"] = state.pool_off
        for x in ("clock", "work", "steals", "scanned"):
            a[x] = torch.zeros(P, dtype=torch.int32, device=dev)
        a["mult"] = torch.zeros((P, n_tasks) if mode == "free" else (n_tasks,),
                                dtype=torch.int32, device=dev)
        arrs.append(a)
    return arrs


def _l2_evictor(dev):
    """A callable that leaves the 50 MB L2 holding none of a launch's inputs
    and no dirty lines: a write of EVICT_BYTES to one scratch and a read of
    EVICT_BYTES of another (the kernels phase's cold timing)."""
    scratch = [torch.empty(EVICT_BYTES // 4, device=dev) for _ in range(2)]
    scratch[1].zero_()

    def evict():
        scratch[0].fill_(1.0)
        scratch[1].sum()

    return evict


def _free_stats(arrs, n_live):
    """Σmult/tiles (mean over the launches) and the largest mult of free
    launches' arrays (rows [P, n_tasks] of per-program multiplicity)."""
    mult = torch.stack([a["mult"].sum(0)[:n_live] for a in arrs]).double()
    if not bool((mult >= 1).all()):
        raise AssertionError("a free launch left a tile unexecuted")
    return float(mult.sum(1).mean()) / n_live, int(mult.max())


def _tile_layout(dtype, f, grad, P):
    """The tile's layout on the card: programs of one CTA, the CTAs the card
    holds at once, and the tile's shared memory."""
    from repro_torch.moe_ws import expert_kernel as X

    smem, ring_w = X.tile_smem(f, grad=grad)
    resident = X.resident_programs(dtype, f, grad=grad)
    if resident < P:
        raise AssertionError(f"the card holds {resident} programs at once, fewer than P {P}")
    return dict(programs=P, resident_programs=resident,
                smem_bytes=smem, ring_bytes_per_warp=ring_w)


def _expert_times(x, tasks, routed, ws, w):
    from repro_torch.moe_ws import expert_kernel as X
    from repro_torch.pallas_ws import kernel as K
    from repro_torch.pallas_ws import to_device

    c = EXPERT
    dev = x.device
    state = to_device(ws, dev)
    tok = torch.from_numpy(routed.tok_idx).to(dev)
    out = torch.zeros((routed.n_rows, c["d"]), dtype=torch.float32, device=dev)
    times = {}
    for mode, n, traced in (("free", 10, False), ("lockstep", 3, False), ("free", 10, True)):
        rounds = K.default_rounds(ws, True)
        arrs = _fresh_arrays(state, mode, n + 1)
        rings = (_with_rings(arrs, int(np.asarray(ws.tail).sum())) if traced
                 else [K.NO_RING] * (n + 1))

        def launch(i, mode=mode, rounds=rounds, rings=rings):
            X._launch_cuda(arrs[i], x, tok, *w, out, mode=mode, rounds=_rounds(mode, rounds),
                           steal=True,
                           policy="cost", compress=False, bt=c["bt"], n_tasks=ws.n_tasks,
                           ring=rings[i])

        launch(n)  # warm-up
        torch.cuda.synchronize()
        times[mode + ("_traced" if traced else "")] = _event_ms(launch, n)
        if mode == "free" and not traced:
            n_live = int(np.asarray(ws.tail).sum())
            mult_per_tile, max_mult = _free_stats(arrs[:n], n_live)
    # cold device times: each free launch queued behind a sleeping kernel, L2
    # evicted first
    arrs = _fresh_arrays(state, "free", 10)
    cold = _device_spans(lambda i: X._launch_cuda(
        arrs[i], x, tok, *w, out, mode="free", rounds=0, steal=True, policy="cost",
        compress=False, bt=c["bt"], n_tasks=ws.n_tasks), 10, before=_l2_evictor(dev))
    layout = _tile_layout(torch.bfloat16, c["f"], False, c["P"])
    TRACED["ws_expert"] = dict(free_ms_untraced=times["free"], free_ms_traced=times["free_traced"],
                               at="kimi-k2 decode routing", card=card_line())
    _moe(ws, x, routed, w, plain=True, mode="free")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _moe(ws, x, routed, w, plain=True, mode="free")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    T = x.shape[0]
    rows = T * c["k"]                                        # live routed rows
    touched = int((routed.loads > 0).sum())                  # distinct experts
    w_bytes = touched * 3 * c["d"] * c["f"] * 2              # their weights, bf16, once
    io_bytes = T * c["d"] * 4 + routed.n_rows * (c["d"] * 4 + 4) + ws.n_tasks * 8 * 4
    byte_ms = (w_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 6 * rows * c["d"] * c["f"] / BF16_FLOPS * 1e3
    bound_ms = max(byte_ms, ops_ms)
    bound_by = "bytes" if byte_ms >= ops_ms else "operations"
    # the tile-layout floor: every live tile reads its expert's 3 d f weights
    # (bt-row tiles re-read an expert; the bound reads each once)
    floor_ms = (n_live * 3 * c["d"] * c["f"] * 2 + io_bytes) / HBM_BYTES_PER_S * 1e3
    ms_cold = float(np.median(cold))
    log(f"[times] ws_expert decode routing T={T} ({rows} rows over {touched} experts, "
        f"{ws.n_tasks} tiles): kernel free {times['free']:.4f} ms (traced "
        f"{times['free_traced']:.4f} ms; cold device {ms_cold:.4f} ms, range "
        f"{min(cold):.4f}-{max(cold):.4f}), lockstep "
        f"{times['lockstep']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
        f"{w_bytes + io_bytes} B), tile-layout floor {floor_ms:.5f} ms ({n_live} tiles), "
        f"sum(mult)/tiles {mult_per_tile:.3f}, max mult {max_mult}, plain version "
        f"{plain_ms:.2f} ms; {layout}; no single PyTorch "
        "call computes a gathered gated expert FFN, so there is no library time; the first "
        "version (free, lockstep): " + ", ".join(
            f"{a}-{b} ms" for a, b in (FIRST_VERSION_MS[f"ws_expert {m}"]
                                       for m in ("free", "lockstep"))))
    return dict(ms=times["free"], lockstep_ms=times["lockstep"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, ms_cold=ms_cold,
                ms_cold_range=[min(cold), max(cold)], floor_ms=floor_ms,
                mult_per_tile=mult_per_tile, max_mult=max_mult, **layout)


def phase_expert(dev):
    from repro_torch.pallas_ws import emit_decode_tasks, make_queue_state, normalized_out

    c = EXPERT
    t0 = time.perf_counter()
    w = expert_weights(dev)
    torch.cuda.synchronize()
    log(f"[expert] weights E={c['E']} d={c['d']} f={c['f']} bf16 "
        f"({sum(t.numel() for t in w) * 2 / 1e9:.2f} GB) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    errs, decode = [], None
    for name, T in EXPERT_T.items():
        x, tasks, routed, ws, static = expert_routing(rng, T)
        x = torch.from_numpy(x).to(dev)
        errs.append(_check_expert(f"{name} T={T}", x, tasks, routed, ws, static, w))
        if decode is None:
            decode = (x, tasks, routed, ws)
    # the traced instantiation at the decode routing: its rings too
    x, _, routed, ws = decode
    kw = dict(mode="lockstep", steal=True, steal_policy="cost", trace=True)
    res_k = _moe(ws, x, routed, w, **kw)
    torch.cuda.synchronize()
    res_p = _moe(ws, x, routed, w, plain=True, **kw)
    ik, ip = _ints(res_k), _ints(res_p)
    bad = [n for n in ik if not np.array_equal(ik[n], ip[n])]
    err = float((res_k.out - res_p.out).abs().max())
    if bad or not err <= ATOL:
        raise AssertionError(f"expert decode traced lockstep: {bad} differ, out err {err}")
    errs.append(err)
    log(f"[expert] decode traced lockstep: integer arrays and event rings "
        f"({int(res_k.ev_cursor.sum())} events) bit-equal to the plain walk's, out "
        f"max_abs_err {err:.3g}")

    # the attention kernel once at kimi's shape (hd 112 is no multiple of 32)
    k_ = KIMI_DECODE
    lengths, q, k, v = decode_inputs(rng, dev, k_)
    atasks = emit_decode_tasks(lengths, k_["H"], k_["bk"])
    astate = make_queue_state(atasks, k_["P"])
    q4 = q[:, :, None, :]
    kw = dict(causal=False, bq=1, bk=k_["bk"])
    res_p, err = _check_lockstep("kimi decode steal=True cost", astate, q4, k, v,
                                 steal=True, steal_policy="cost", **kw)
    expect = normalized_out(res_p, atasks, (k_["B"], k_["H"], 1))
    attn_err = max(err, _check_free("kimi decode", astate, q4, k, v, expect, atasks, **kw))

    times = _expert_times(*decode, w)
    HELD["expert"] = (w, decode)  # the chaos phase's ws_expert checks reuse them
    del w, decode
    return dict(max_abs_err=max(errs), attn_err=attn_err, **times)


# Every per-slot kernel function, pinned: ptxas registers and SASS
# instructions, by _build.function_key of the function's name.  The
# ws_unified rows are the build before half-run steals (the kernels of
# commit 5fee79a), the ws_attention rows the build of its redesigned tile,
# the ws_expert and ws_expert_grad rows the build of their redesigned tiles
# (csrc/ws_expert_mma.cuh), the ws_unified rows that of its walker and
# helpers, each measured on an NVIDIA H100 80GB HBM3
# (700.00 W; nvcc of CUDA 12.8) by this script's audit on that tree
# (`python3 chip_smoke.py --audit-baseline DIR` with the tree unpacked in
# DIR prints the same table).  The per-slot (cap 1) instantiations must
# keep them: a scheduler edit shows in every row.
BASELINE_FUNCTIONS = {
    "void ws_expert_free_kernel<__nv_bfloat16, true>(WSQueues, ExpertArgs)":
        (242, 4216),
    "void ws_expert_free_kernel<__nv_bfloat16>(WSQueues, ExpertArgs)":
        (242, 4024),
    "void ws_expert_free_kernel<float, true>(WSQueues, ExpertArgs)":
        (128, 2736),
    "void ws_expert_free_kernel<float>(WSQueues, ExpertArgs)":
        (128, 2544),
    "void ws_expert_grad_free_kernel<__nv_bfloat16, true>(WSQueues, GradArgs)":
        (255, 9928),
    "void ws_expert_grad_free_kernel<__nv_bfloat16>(WSQueues, GradArgs)":
        (255, 9672),
    "void ws_expert_grad_free_kernel<float, true>(WSQueues, GradArgs)":
        (201, 5640),
    "void ws_expert_grad_free_kernel<float>(WSQueues, GradArgs)":
        (197, 4552),
    "void ws_expert_grad_lockstep_kernel<__nv_bfloat16, true>(WSQueues, GradArgs)":
        (255, 19776),
    "void ws_expert_grad_lockstep_kernel<__nv_bfloat16>(WSQueues, GradArgs)":
        (255, 19552),
    "void ws_expert_grad_lockstep_kernel<float, true>(WSQueues, GradArgs)":
        (254, 10584),
    "void ws_expert_grad_lockstep_kernel<float>(WSQueues, GradArgs)":
        (254, 10432),
    "void ws_expert_lockstep_kernel<__nv_bfloat16, true>(WSQueues, ExpertArgs)":
        (255, 6752),
    "void ws_expert_lockstep_kernel<__nv_bfloat16>(WSQueues, ExpertArgs)":
        (255, 6592),
    "void ws_expert_lockstep_kernel<float, true>(WSQueues, ExpertArgs)":
        (141, 4696),
    "void ws_expert_lockstep_kernel<float>(WSQueues, ExpertArgs)":
        (141, 4544),
    "void ws_free_kernel<__nv_bfloat16, true>(WSQueues, AttnArgs)":
        (206, 7272),
    "void ws_free_kernel<__nv_bfloat16>(WSQueues, AttnArgs)":
        (196, 7088),
    "void ws_free_kernel<float, true>(WSQueues, AttnArgs)":
        (127, 4192),
    "void ws_free_kernel<float>(WSQueues, AttnArgs)":
        (120, 3992),
    "void ws_lockstep_kernel<__nv_bfloat16, true>(WSQueues, AttnArgs)":
        (206, 12064),
    "void ws_lockstep_kernel<__nv_bfloat16>(WSQueues, AttnArgs)":
        (206, 11936),
    "void ws_lockstep_kernel<float, true>(WSQueues, AttnArgs)":
        (128, 5928),
    "void ws_lockstep_kernel<float>(WSQueues, AttnArgs)":
        (128, 5848),
    "void ws_unified_free<true>(WSQueues, UArgs, Hand)":
        (128, 62496),
    "void ws_unified_lockstep<true>(WSQueues, UArgs, Hand)":
        (128, 68016),
    "ws_unified_free(WSQueues, UArgs, Hand)":
        (128, 62296),
    "ws_unified_lockstep(WSQueues, UArgs, Hand)":
        (128, 69856),
}


def _log_functions(tag, name, fns, baseline=None):
    """Log each kernel function's registers and SASS instructions, beside
    ``baseline``'s where given; returns the recorded functions that differ."""
    from repro_torch import _build

    differ = []
    for f in sorted(fns, key=lambda f: (fns[f].get("traced", False), f)):
        st = fns[f]
        line = (f"[{tag}] {name} {'traced  ' if st.get('traced') else 'untraced'} {f}: "
                f"{st['registers']} registers, {st['spill_stores']} B spill stores, "
                f"{st.get('sass_instructions')} SASS instructions, forbidden SASS "
                f"{st.get('forbidden_sass')}")
        if baseline is not None:
            b = baseline.get(_build.function_key(f))
            if b is None:
                line += "; pinned: not there"
            else:
                same = b == (st["registers"], st.get("sass_instructions"))
                line += (f"; pinned: {b[0]} registers, {b[1]} SASS instructions"
                         + (" (the same)" if same else " (DIFFERS)"))
                if not same:
                    differ.append(f)
        log(line)
    return differ


def phase_audit(dev):
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import _build

    with ThreadPoolExecutor(2 * len(_build.KERNELS)) as pool:
        audits = dict(zip(_build.KERNELS, pool.map(_build.fence_audit, _build.KERNELS)))
        stats = dict(zip(_build.KERNELS, pool.map(_build.function_stats, _build.KERNELS)))
    for name, audit in audits.items():
        log(f"[audit] {name}: kernels {audit['sass_kernels']}, {audit['sass_instructions']} "
            f"SASS instructions; forbidden SASS {audit['sass']}, forbidden PTX {audit['ptx']}")
        if audit["sass"] or audit["ptx"]:
            raise AssertionError(f"{name} is not fence-free")
        if not audit["sass_kernels"]:
            raise AssertionError(f"cuobjdump found no kernel in {name}")
        fns = stats[name]
        if name not in _build.WS_KERNELS:  # a standalone kernel: no scheduler, no ring
            _log_functions("audit", name, fns)
            bad = {f: st["forbidden_sass"] for f, st in fns.items() if st["forbidden_sass"]}
            if bad or any(st["traced"] for st in fns.values()):
                raise AssertionError(f"{name}: forbidden SASS {bad} or a traced function in "
                                     f"{sorted(fns)}")
            if name == "ssd_scan":  # every product on tensor cores
                hmma = {f: st["hmma"] for f, st in fns.items()}
                log(f"[audit] ssd_scan HMMA instructions by function {hmma}")
                if not all(hmma.values()):
                    raise AssertionError(f"ssd_scan: a function without HMMA: {hmma}")
            continue
        differ = _log_functions("audit", name, fns, BASELINE_FUNCTIONS)
        if differ:
            raise AssertionError(f"{name}: the per-slot functions {differ} changed registers "
                                 "or SASS instructions")
        n_traced = sum(st["traced"] for st in fns.values())
        if not n_traced or 2 * n_traced != len(fns):
            raise AssertionError(f"{name}: want an untraced and a traced instantiation of "
                                 f"every kernel function: {sorted(fns)}")
        bad = {f: st["forbidden_sass"] for f, st in fns.items() if st["forbidden_sass"]}
        if bad:
            raise AssertionError(f"{name}: forbidden SASS in {bad}")
        n_run = sum("_run_kernel" in f for f in fns)
        if n_run != (0 if name == "ws_unified" else len(fns) // 2):
            raise AssertionError(f"{name}: want a half-run instantiation beside each per-slot "
                                 f"one (none in ws_unified): {sorted(fns)}")
    keys = {_build.function_key(f) for fns in stats.values() for f in fns}
    missing = sorted(set(BASELINE_FUNCTIONS) - keys)
    if missing:
        raise AssertionError(f"the build lacks the per-slot functions {missing}")
    # why a program of the expert kernels is one CTA: the hand-offs between
    # a cluster's CTAs that a cluster-wide tile would need
    probe = _build.function_stats("cluster_barrier", _build.CSRC / "probes")
    probe = {f.split("(")[0]: st["forbidden_sass"] for f, st in probe.items()}
    log(f"[audit] csrc/probes/cluster_barrier.cu (not a kernel of the port): forbidden SASS "
        f"by function {probe}; the expert kernels run one CTA a program")
    # why ws_unified's walker may hand its products to helper CTAs: the
    # tagged hand-off, fence-free, stressed, timed, and every CTA resident
    rep = tagged_handoff_probe(dev)
    HANDOFF.update(rep)
    log("[audit] csrc/probes/tagged_handoff.cu (not a kernel of the port): "
        + json.dumps(rep))
    if not rep["ok"]:
        raise AssertionError(f"the tagged hand-off probe failed: {rep}")
    return stats


# The tagged hand-off probe (csrc/probes/tagged_handoff.cu): the stress
# test's threads a CTA, tagged words and requests, the round trips timed,
# and the deadline of every spin.  The co-residency launch holds each CTA
# the unified kernel's shared memory for its products.
PROBE = dict(threads=128, words=512, requests=100_000, roundtrips=20_000, deadline_s=2.0)


def tagged_handoff_probe(dev, smem=None):
    """Build csrc/probes/tagged_handoff.cu and run its three checks on the
    card: the stress test (1 producer, SM count - 1 consumers), the round
    trip to one consumer and to all of them, and a cooperative launch of
    one CTA an SM at 512 threads and ``smem`` bytes.  Returns the readings
    and ``ok``: no wrong value, no newer tag, no spin past its deadline,
    every CTA resident on its own SM, and no forbidden opcode."""
    import ctypes

    from repro_torch import _build
    from repro_torch.pallas_ws import unified_kernel

    smem = unified_kernel.SMEM_BYTES if smem is None else smem
    probes = _build.CSRC / "probes"
    lib = ctypes.CDLL(str(_build.build("tagged_handoff", probes)))
    audit = _build.fence_audit("tagged_handoff", probes)
    fns = _build.function_stats("tagged_handoff", probes)
    P, I, U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.tagged_stress_run.argtypes = [I, I, I, I, U64, ctypes.c_uint, P, P, P]
    lib.tagged_roundtrip_run.argtypes = [I, I, U64, P, P, P]
    lib.tagged_coresident_run.argtypes = [I, I, I, U64, P, P, P, P]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    C = sms - 1
    ws = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dl = int(PROBE["deadline_s"] * 1e9)

    def run(fn, *a, n_out, tail=()):
        out = torch.zeros(n_out, dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = fn(*a, ws.data_ptr(), out.data_ptr(), *tail, stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"tagged_handoff probe: CUDA error {err}")
        return out.cpu().tolist(), time.perf_counter() - t0

    st, st_s = run(lib.tagged_stress_run, C, PROBE["threads"], PROBE["words"],
                   PROBE["requests"], dl, 7, n_out=3 * (C + 1))
    rt1, _ = run(lib.tagged_roundtrip_run, 1, PROBE["roundtrips"], dl, n_out=2)
    rtc, _ = run(lib.tagged_roundtrip_run, C, PROBE["roundtrips"], dl, n_out=2)
    occ = (ctypes.c_int * 2)()
    co, _ = run(lib.tagged_coresident_run, sms, 512, smem, dl, n_out=3,
                tail=(ctypes.cast(occ, P),))
    rep = {
        "consumers": C, "threads": PROBE["threads"], "words": PROBE["words"],
        "requests": PROBE["requests"], "stress_s": round(st_s, 4),
        "wrong_values": sum(st[0::3]), "newer_tags": sum(st[1::3]), "late": sum(st[2::3]),
        "roundtrip_ns_1_consumer": rt1[0], "roundtrip_ns_all_consumers": rtc[0],
        "roundtrip_late": rt1[1] + rtc[1],
        "coresident": {"ctas": sms, "threads": 512, "smem": smem, "arrived": co[0],
                       "distinct_sms": co[1], "late": co[2], "blocks_per_sm": occ[0],
                       "sm_count": occ[1]},
        "forbidden_sass": audit["sass"], "forbidden_ptx": audit["ptx"],
        "forbidden_sass_by_function": {f.split("(")[0]: s["forbidden_sass"]
                                       for f, s in fns.items()},
    }
    rep["ok"] = (not audit["sass"] and not audit["ptx"] and rep["wrong_values"] == 0
                 and rep["newer_tags"] == 0 and rep["late"] == 0 and rep["roundtrip_late"] == 0
                 and co[0] == sms and co[1] == sms and co[2] == 0)
    return rep


def audit_baseline(root) -> None:
    """Build another checkout's kernels (``root``: the repo's layout) into its
    own build/ and print every kernel function's registers and SASS
    instructions, keyed as BASELINE_FUNCTIONS is."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from repro_torch import _build

    csrc = Path(root) / "src" / "repro_torch" / "csrc"
    bdir = Path(root) / "build" / "repro_torch"
    names = [n for n in _build.KERNELS if (csrc / f"{n}.cu").exists()]
    with ThreadPoolExecutor(len(names)) as pool:
        stats = dict(zip(names, pool.map(lambda n: _build.function_stats(n, csrc, bdir), names)))
    table = {}
    for name, fns in stats.items():
        _log_functions("baseline", name, fns)
        for f, st in fns.items():
            table[_build.function_key(f)] = (st["registers"], st["sass_instructions"])
    log("[baseline] " + json.dumps(table, sort_keys=True))


def expert_ab(roots, dev) -> None:
    """ws_expert's times at kimi-k2's decode routing (``_expert_times``: free,
    cold, lockstep, Σmult/tiles) for the builds of other checkouts (``roots``,
    each with the repo's layout) and of this one, in one process: each build
    in turn, then in reverse order, twice.  Free mode's makespan moves by
    whole tiles (~2 ms each), so two builds are compared only within one
    run."""
    import ctypes
    from pathlib import Path
    from unittest import mock

    from repro_torch import _build
    from repro_torch.moe_ws import expert_kernel as X

    libs = {str(r): _build.build("ws_expert", Path(r) / "src" / "repro_torch" / "csrc",
                                 Path(r) / "build" / "repro_torch") for r in roots}
    libs["this checkout"] = _build.build("ws_expert")
    ref = X._kernel_fn()
    fns = {}
    for tag, path in libs.items():
        fns[tag] = ctypes.CDLL(str(path)).ws_expert_launch
        fns[tag].argtypes, fns[tag].restype = ref.argtypes, ref.restype
    w = expert_weights(dev)
    x, tasks, routed, ws, _ = expert_routing(np.random.default_rng(SEED), EXPERT_T["decode"])
    x = torch.from_numpy(x).to(dev)
    rows = {t: [] for t in fns}
    for tag in (list(fns) + list(fns)[::-1]) * 2:
        with mock.patch.object(X, "_kernel_fn", lambda tag=tag: fns[tag]):
            t = _expert_times(x, tasks, routed, ws, w)
        rows[tag].append(t)
        log(f"[ab] {tag}: free {t['ms']:.4f} ms, cold device {t['ms_cold']:.4f} ms, lockstep "
            f"{t['lockstep_ms']:.4f} ms, sum(mult)/tiles {t['mult_per_tile']:.3f}, max mult "
            f"{t['max_mult']}")
    for tag, r in rows.items():
        log(f"[ab] {tag} medians: free {np.median([t['ms'] for t in r]):.4f} ms, cold device "
            f"{np.median([t['ms_cold'] for t in r]):.4f} ms, lockstep "
            f"{np.median([t['lockstep_ms'] for t in r]):.4f} ms ({card_line()})")


def ssd_ab(roots, dev) -> None:
    """ssd_scan's device times at mamba2-2.7b's widths (KSSD, bf16), warm and
    cold (L2 evicted), for the builds of other checkouts (``roots``, each
    with the repo's layout and this one's C entry point) and of this one, in
    one process: each build's y and final state first held to the plain
    version under the kernels phase's limits, then each build in turn and in
    reverse order, twice."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch import _build
    from repro_torch.kernels.ssd_scan.kernel import plain_ssd_scan, ssd_scan

    dirs = {str(r): (Path(r) / "src" / "repro_torch" / "csrc", Path(r) / "build" / "repro_torch")
            for r in roots}
    dirs["this checkout"] = (None, None)
    with ThreadPoolExecutor(len(dirs)) as pool:  # one nvcc each, all started together
        libs = dict(zip(dirs, pool.map(lambda d: _build.build("ssd_scan", *d), dirs.values())))
    cdlls = {tag: ctypes.CDLL(str(path)) for tag, path in libs.items()}
    c = KSSD
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, S, H, P, N, Q = c["b"], c["S"], c["H"], c["P"], c["N"], c["chunk"]
    dt = F.softplus(_randn(gen, (b, S, H), dev, torch.float32)).to(torch.bfloat16)
    A = -torch.exp(_randn(gen, (H,), dev, torch.float32))
    sx = (_randn(gen, (b, S, H, P), dev), dt, A, _randn(gen, (b, S, N), dev),
          _randn(gen, (b, S, N), dev))
    py, pfin = plain_ssd_scan(*sx, chunk=Q)
    checks = _Checks()
    scratch = [torch.empty(EVICT_BYTES // 4, device=dev) for _ in range(2)]
    scratch[1].zero_()

    def evict_l2():
        scratch[0].fill_(1.0)
        scratch[1].sum()

    def run():
        return ssd_scan(*sx, chunk=Q)

    for tag, lib in cdlls.items():
        with mock.patch.object(_build, "load", lambda name, lib=lib: lib):
            y, fin = run()
            torch.cuda.synchronize()
        checks.held(f"ssd_ab {tag} y", y, py)
        checks.held(f"ssd_ab {tag} final state", fin, pfin, "state")
    checks.verdict()
    rows = {t: [] for t in cdlls}
    for tag in (list(cdlls) + list(cdlls)[::-1]) * 2:
        with mock.patch.object(_build, "load", lambda name, lib=cdlls[tag]: lib):
            run()
            warm = _device_ms(lambda _: run(), KTIMED)
            cold = _device_ms(lambda _: run(), KTIMED, before=evict_l2)
        rows[tag].append((warm, cold))
        log(f"[ab] ssd_scan {tag}: device {warm:.4f} ms warm, {cold:.4f} ms cold")
    for tag, r in rows.items():
        log(f"[ab] ssd_scan {tag} medians: device {np.median([w for w, _ in r]):.4f} ms warm, "
            f"{np.median([c_ for _, c_ in r]):.4f} ms cold ({card_line()})")


def _attention_kit(dev):
    """ws_attention at llama3.2-3b's decode shape for the checker: the state,
    inputs, a cap-1 lockstep launch (every tile once: the exact replay's
    oracle), a fault-free traced free launch, run_with_faults launch
    callables and the checker."""
    from types import SimpleNamespace

    from repro_torch.chaos import SafetyChecker
    from repro_torch.pallas_ws import (
        copy_state, emit_decode_tasks, make_queue_state, multiplicity_divisor, run_ws_schedule,
    )

    c = DECODE
    lengths, q, k, v = decode_inputs(np.random.default_rng(SEED), dev)
    tasks = emit_decode_tasks(lengths, c["H"], c["bk"])
    state = make_queue_state(tasks, c["P"])
    q4 = q[:, :, None, :]
    akw = dict(causal=False, bq=1, bk=c["bk"], steal=True, steal_policy="cost")
    shape = (c["B"], c["H"], 1)
    base = run_ws_schedule(copy_state(state), q4, k, v, mode="lockstep", **akw)
    clean = run_ws_schedule(copy_state(state), q4, k, v, mode="free", trace=True, **akw)
    torch.cuda.synchronize()

    def launch(mode):
        def go(st, *, rounds, out, mult, fault_plan, steal_run_cap=1):
            return run_ws_schedule(st, q4, k, v, mode=mode, rounds=rounds, out=out, mult=mult,
                                   trace=True, fault_plan=fault_plan,
                                   steal_run_cap=steal_run_cap, **akw)
        return go

    def plain(st, **a):
        with plain_versions():
            return launch("lockstep")(st, **a)

    def check(ch):
        if ch.mode == "lockstep":  # one tile a row: the exact float replay
            return SafetyChecker().check(
                ch, n_tasks=state.n_tasks, oracle_accumulated=base.out,
                row_mult=multiplicity_divisor(tasks, ch.res.mult.cpu().numpy(), shape))
        return SafetyChecker().check(ch, n_tasks=state.n_tasks, normalized=ch.res.out,
                                     oracle_normalized=clean.out, rtol=0, atol=ATOL)

    return SimpleNamespace(state=state, tasks=tasks, lengths=lengths, q4=q4, k=k, v=v,
                           base=base, clean=clean, launch=launch, plain=plain, check=check,
                           what="llama3.2-3b decode shape")


def _expert_kit(dev):
    """ws_expert at kimi-k2's full width, decode routing, for the checker (the
    expert phase's weights and routing when it ran): as _attention_kit."""
    from types import SimpleNamespace

    from repro_torch.chaos import SafetyChecker
    from repro_torch.moe_ws import row_divisor, run_moe_schedule
    from repro_torch.pallas_ws import copy_state

    if "expert" not in HELD:
        w = expert_weights(dev)
        x, etasks, routed, ws, _ = expert_routing(np.random.default_rng(SEED), EXPERT_T["decode"])
        HELD["expert"] = (w, (torch.from_numpy(x).to(dev), etasks, routed, ws))
    w, (x, etasks, routed, ws) = HELD["expert"]
    ekw = dict(bt=EXPERT["bt"], steal=True, steal_policy="cost")
    base = run_moe_schedule(copy_state(ws), x, routed.tok_idx, *w, mode="lockstep", **ekw)
    clean = run_moe_schedule(copy_state(ws), x, routed.tok_idx, *w, mode="free", trace=True,
                             **ekw)
    torch.cuda.synchronize()

    def launch(mode):
        def go(st, *, rounds, out, mult, fault_plan, steal_run_cap=1):
            return run_moe_schedule(st, x, routed.tok_idx, *w, mode=mode, rounds=rounds,
                                    out=out, mult=mult, trace=True, fault_plan=fault_plan,
                                    steal_run_cap=steal_run_cap, **ekw)
        return go

    def plain(st, **a):
        with plain_versions():
            return launch("lockstep")(st, **a)

    def check(ch):
        if ch.mode == "lockstep":
            return SafetyChecker().check(
                ch, n_tasks=ws.n_tasks, oracle_accumulated=base.out,
                row_mult=row_divisor(etasks, ch.res.mult.cpu().numpy(), routed.n_rows))
        rep = SafetyChecker().check(ch, n_tasks=ws.n_tasks, normalized=ch.res.out,
                                    oracle_normalized=clean.out, rtol=0, atol=ATOL)
        if rep.normalized_parity != "bitwise":  # the same tile's bits, stored again
            raise AssertionError(f"ws_expert free chaos: parity {rep.normalized_parity}")
        return rep

    return SimpleNamespace(state=ws, tasks=etasks, routed=routed, x=x, w=w, base=base,
                           clean=clean, launch=launch, plain=plain, check=check,
                           what="kimi-k2 decode routing")


def phase_chaos(dev):
    """SafetyChecker on free-mode launches of ws_attention (llama3.2-3b's
    decode shape) and ws_expert (kimi-k2's full width, decode routing), and
    CHAOS_SEEDS' fault plans through both in lockstep and in free mode."""
    from repro_torch.chaos import SafetyChecker, single_launch
    from repro_torch.pallas_ws import default_rounds

    t_phase = time.perf_counter()
    for kernel, kit in (("ws_attention", _attention_kit(dev)), ("ws_expert", _expert_kit(dev))):
        _report(kernel, f"fault-free free launch ({kit.what})",
                SafetyChecker().check(single_launch(kit.state, kit.clean),
                                      n_tasks=kit.state.n_tasks, normalized=kit.clean.out,
                                      oracle_normalized=kit.base.out, rtol=0, atol=ATOL))
        _chaos_plans(kernel, kit.what, kit.state, kit.launch, kit.plain, kit.check,
                     default_rounds(kit.state, True), CHAOS_SEEDS)
        del kit
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[chaos] phase {time.perf_counter() - t_phase:.1f} s; card {card_line()}")


# ---------------------------------------------------------------------------
# half-run Steal (steal_run_cap > 1)


def _halfrun_stats(kernel, ds, n_live, launch, at, n=HALFRUN_STATS_N, warm=True):
    """Free untraced launches of one kernel at each of HALFRUN_STATS_CAPS
    (free mode has no rounds budget; every cap gets the same none): ``n``
    timed launches (after a warm-up, with ``warm``), and from those launches' arrays
    Σmult/tasks (mean), the largest mult, and slots scanned per extraction
    (mean).  ``launch(arrs, cap)`` launches over launch-ready arrays of the
    device state ``ds``; ``n_live`` tasks are live."""
    row = {"at": at, "card": card_line(), "launches_per_cap": n}
    for cap in HALFRUN_STATS_CAPS:
        arrs = _fresh_arrays(ds, "free", n + 1)
        if warm:
            launch(arrs[n], cap)
            torch.cuda.synchronize()
        ms = _event_ms(lambda i, cap=cap: launch(arrs[i], cap), n)
        mult = torch.stack([a["mult"].sum(0)[:n_live] for a in arrs[:n]]).double()
        scanned = torch.stack([a["scanned"].sum() for a in arrs[:n]]).double()
        if not bool((mult >= 1).all()):
            raise AssertionError(f"{kernel} cap={cap}: a free launch left a task unexecuted")
        row[f"cap{cap}"] = dict(
            free_ms_untraced=ms, mult_per_task=float(mult.sum(1).mean()) / n_live,
            max_mult=int(mult.max()),
            scanned_per_extraction=float((scanned / mult.sum(1)).mean()))
        log(f"[halfrun] {kernel} free untraced cap={cap} ({at}, {n_live} tasks, {n} launches): "
            f"{ms:.4f} ms, " + ", ".join(f"{k} {v}" for k, v in row[f"cap{cap}"].items()
                                         if k != "free_ms_untraced"))
    return row


def _ragged_prefill(dev):
    """ragged_flash_attention at llama3.2-3b's widths (RAGGED): the static,
    ws and ws cap-4 arms against ragged_attention_ref, their kernel times,
    the bound, and one masked F.scaled_dot_product_attention as a yardstick
    (the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.pallas_ws import (
        emit_flash_tasks, make_queue_state, normalized_out, ragged_attention_ref,
        ragged_flash_attention, run_ws_schedule, to_device,
    )
    from repro_torch.pallas_ws import kernel as K

    r = RAGGED
    lengths = np.array(r["lengths"])
    B, S, H, Hkv, hd = len(lengths), r["S"], r["H"], r["Hkv"], r["hd"]
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(torch.bfloat16).to(dev)
               for shape in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
    ref32 = ragged_attention_ref(q.float(), k.float(), v.float(), lengths)  # the same bf16 values
    ref16 = ragged_attention_ref(q, k, v, lengths)
    # both round fp32 results that differ in the last bits to bf16: a flip
    # costs one bf16 ulp of |out|
    ulp16 = float(ref32.abs().max()) * 2.0 ** -8
    tasks = emit_flash_tasks(lengths, H, r["bq"], r["bk"], causal=True)
    state = make_queue_state(tasks, r["P"])
    ds = to_device(state, dev)
    sq_out = -(-S // r["bq"]) * r["bq"]
    out = torch.zeros((B, H, sq_out, hd), dtype=torch.float32, device=dev)
    arms = {}
    for name, schedule, cap in (("static", "static", 1), ("ws", "ws", 1), ("ws_cap4", "ws", 4)):
        steal = schedule == "ws"
        kw = dict(causal=True, bq=r["bq"], bk=r["bk"], steal=steal, steal_run_cap=cap)
        res = run_ws_schedule(to_device(state, dev), q, k, v, **kw)  # the bf16 instantiation
        got = normalized_out(res, tasks, (B, H, sq_out))[:, :, :S]
        err = float((got - ref32).abs().max())
        o16 = ragged_flash_attention(q, k, v, lengths, schedule=schedule, steal_run_cap=cap,
                                     n_programs=r["P"], bq=r["bq"], bk=r["bk"])
        err16 = float((o16.float() - ref16.float()).abs().max())
        torch.cuda.synchronize()
        if not (err <= ATOL and err16 <= ulp16):
            raise AssertionError(f"ragged prefill {name}: fp32 out err {err} (> {ATOL}?), "
                                 f"entry point bf16 err {err16} (> {ulp16}?)")
        n = 3
        arrs = _fresh_arrays(ds, "free", n + 1)

        def launch(i, steal=steal, cap=cap):
            K._launch_cuda(arrs[i], q, k, v, out, mode="free", rounds=0, steal=steal,
                           policy="cost", compress=not steal, causal=True, bq=r["bq"],
                           bk=r["bk"], scale=hd ** -0.5, g=H // Hkv, n_tasks=state.n_tasks,
                           run_cap=cap)

        launch(n)  # warm-up
        torch.cuda.synchronize()
        ms = _event_ms(launch, n)
        mult = arrs[0]["mult"].sum(0)
        arms[name] = dict(ms=ms, max_abs_err=err, entry_point_bf16_err=err16,
                          mult_per_task=int(mult.sum()) / state.n_tasks)
        log(f"[halfrun] ragged prefill {name}: kernel {ms:.3f} ms (free), fp32 out max_abs_err "
            f"{err:.3g} (<= {ATOL}), ragged_flash_attention (bf16) vs bf16 oracle {err16:.3g} "
            f"(<= one bf16 ulp {ulp16:.3g}), sum(mult)/tasks {arms[name]['mult_per_task']:.3f}")

    kpos = torch.arange(S, device=dev)
    ln = torch.as_tensor(lengths, device=dev)[:, None, None, None]
    mask = (kpos[None, :] <= kpos[:, None]) & (kpos[None, :] < ln) & (kpos[:, None] < ln)
    k_rep, v_rep = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))

    def sdpa(_):
        F.scaled_dot_product_attention(q, k_rep, v_rep, attn_mask=mask)

    sdpa(0)
    torch.cuda.synchronize()
    library_ms = _event_ms(sdpa, 5)
    live = int(lengths.sum())
    pairs = int(sum(ln_ * (ln_ + 1) // 2 for ln_ in lengths.tolist()))  # causal (q, k) pairs
    nbytes = (live * H * hd * 2 + 2 * live * Hkv * hd * 2   # q, k, v live rows, bf16, once
              + live * H * hd * 4 + state.n_tasks * 8 * 4)  # out rows fp32, task records
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * pairs * H * hd / BF16_FLOPS * 1e3
    row = dict(lengths=list(map(int, lengths)), H=H, Hkv=Hkv, hd=hd, bq=r["bq"], bk=r["bk"],
               n_tasks=state.n_tasks, arms=arms, bound_ms=max(byte_ms, ops_ms),
               bound_by="bytes" if byte_ms >= ops_ms else "operations", library_ms=library_ms,
               card=card_line())
    log(f"[halfrun] ragged prefill bound {row['bound_ms']:.5f} ms ({row['bound_by']}: {nbytes} B, "
        f"{4 * pairs * H * hd} operations), masked SDPA yardstick {library_ms:.3f} ms")
    for name, arm in arms.items():
        lo, hi = FIRST_VERSION_MS[f"ragged prefill {name}"]
        log(f"[halfrun] ragged prefill {name}: {arm['ms']:.3f} ms (first version: {lo}-{hi} ms), "
            f"{row['bound_ms'] / arm['ms']:.4f} of the bound, {arm['ms'] / library_ms:.1f}x "
            "masked SDPA")
    return row


def phase_halfrun(dev):
    """Half-run Steal on the card: ws_attention (llama3.2-3b decode shape)
    and ws_expert (kimi-k2 full width, decode and prefill routings, dense
    and pool layouts) at HALFRUN_CAPS, lockstep bit-equal to the plain walk
    (rings included) and free mode clean under SafetyChecker; HALFRUN_PLAN
    through both at cap 4; the free launches' statistics at cap 1, 2, 4;
    and the ragged prefill.  ws_expert_grad's checks run in the grad phase."""
    from repro_torch.chaos import FaultPlan, SafetyChecker, single_launch
    from repro_torch.moe_ws import (
        combine_routed, expert_rounds_bound, route_to_tasks, route_to_tasks_pool,
    )
    from repro_torch.moe_ws import expert_kernel as X
    from repro_torch.moe_ws.layer import _normalised
    from repro_torch.pallas_ws import (
        default_rounds, make_pool_queue_state, make_queue_state, normalized_out, run_ws_schedule,
        to_device,
    )
    from repro_torch.pallas_ws import kernel as K
    from repro_torch.wstrace import EV_RUN

    t_phase = time.perf_counter()
    plan = FaultPlan(**HALFRUN_PLAN)
    c = DECODE
    errs = {"ws_attention": [], "ws_expert": []}
    kit = _attention_kit(dev)
    kw = dict(causal=False, bq=1, bk=c["bk"])
    n_tasks = kit.state.n_tasks
    for cap in HALFRUN_CAPS:
        res_p, err = _check_lockstep(f"half-run cap={cap} decode traced", kit.state, kit.q4,
                                     kit.k, kit.v, steal=True, steal_policy="cost",
                                     steal_run_cap=cap, trace=True, **kw)
        in_runs = int((res_p.events[..., EV_RUN] > 1).sum())
        expect = normalized_out(res_p, kit.tasks, (c["B"], c["H"], 1)).to(dev)
        free = run_ws_schedule(to_device(kit.state, dev), kit.q4, kit.k, kit.v, mode="free",
                               trace=True, steal_run_cap=cap, **kw)
        torch.cuda.synchronize()
        err_f = float((free.out - expect).abs().max())
        if not (bool((free.mult[:n_tasks] >= 1).all()) and err_f <= ATOL):
            raise AssertionError(f"ws_attention half-run cap={cap} free: err {err_f}")
        errs["ws_attention"] += [err, err_f]
        _report("ws_attention", f"half-run cap={cap} free launch ({kit.what}; lockstep: "
                f"{in_runs} of {n_tasks} events in runs)",
                SafetyChecker().check(single_launch(kit.state, free), n_tasks=n_tasks,
                                      normalized=free.out, oracle_normalized=expect,
                                      rtol=0, atol=ATOL))
    _chaos_plans("ws_attention", kit.what, kit.state, kit.launch, kit.plain, kit.check,
                 default_rounds(kit.state, True, steal_run_cap=4), (plan,), steal_run_cap=4)
    ds = to_device(kit.state, dev)
    aout = torch.zeros((c["B"], c["H"], 1, c["hd"]), dtype=torch.float32, device=dev)

    def a_go(arrs, cap):
        K._launch_cuda(arrs, kit.q4, kit.k, kit.v, aout, mode="free", rounds=0, steal=True,
                       policy="cost", compress=False, causal=False, bq=1, bk=c["bk"],
                       scale=c["hd"] ** -0.5, g=c["H"] // c["Hkv"], n_tasks=n_tasks, run_cap=cap)

    HALFRUN["ws_attention"] = _halfrun_stats("ws_attention", ds, n_tasks, a_go, kit.what)
    del kit, ds, aout
    HALFRUN["ragged_prefill"] = _ragged_prefill(dev)

    ek = _expert_kit(dev)
    e = EXPERT
    rng = np.random.default_rng(SEED)  # the expert phase's routings, in its order
    for name, T in EXPERT_T.items():
        idx, gates, xh = routing_draw(rng, T)
        x = torch.from_numpy(xh).to(dev)
        tasks, routed = route_to_tasks(idx, gates, e["E"], bt=e["bt"])
        ws = make_queue_state(tasks, e["P"], n_queues=e["E"], partition="owner")
        records, tail, pool_off, prouted = route_to_tasks_pool(idx, gates, e["E"], bt=e["bt"])
        pool = make_pool_queue_state(records, tail, pool_off, prouted.loads, e["P"],
                                     n_tasks=records.shape[0])
        for layout, st, rt, tl in (("dense", ws, routed, tasks), ("pool", pool, prouted, None)):
            n_live = int(np.asarray(st.tail).sum()) if st.pool else st.n_tasks
            for cap in HALFRUN_CAPS:
                what = f"{name} T={T} {layout} cap={cap}"
                rounds = (expert_rounds_bound(idx.size, e["bt"], e["E"], e["P"], True,
                                              steal_run_cap=cap) if st.pool else None)
                kwl = dict(mode="lockstep", steal=True, steal_policy="cost", steal_run_cap=cap,
                           rounds=rounds, trace=True)
                res_k = _moe(st, x, rt, ek.w, **kwl)
                torch.cuda.synchronize()
                res_p = _moe(st, x, rt, ek.w, plain=True, **kwl)
                ik, ip = _ints(res_k), _ints(res_p)
                bad = [n for n in ik if not np.array_equal(ik[n], ip[n])]
                err = float((res_k.out - res_p.out).abs().max())
                if bad or not err <= ATOL:
                    raise AssertionError(f"ws_expert half-run {what} lockstep: {bad} differ, "
                                         f"out err {err}")
                in_runs = int((res_p.events[..., EV_RUN] > 1).sum())
                expect = _normalised(res_p, rt, tl, e["bt"])
                free = _moe(st, x, rt, ek.w, mode="free", steal_run_cap=cap, trace=True)
                torch.cuda.synchronize()
                mult = free.mult.cpu()
                err_f = float((combine_routed(rt, tl, free, bt=e["bt"])
                               - combine_routed(rt, tl, res_p, bt=e["bt"])).abs().max())
                if not (bool((mult[:n_live] >= 1).all()) and bool((mult[n_live:] == 0).all())
                        and err_f <= ATOL):
                    raise AssertionError(f"ws_expert half-run {what} free: combine err {err_f}")
                errs["ws_expert"] += [err, err_f]
                log(f"[halfrun] ws_expert {what} lockstep: integer arrays and rings bit-equal "
                    f"({in_runs} events in runs), out max_abs_err {err:.3g}; free combine "
                    f"max_abs_err {err_f:.3g}")
                _report("ws_expert", f"half-run {what} free launch ({ek.what.split()[0]})",
                        SafetyChecker().check(single_launch(st, free), n_tasks=n_live,
                                              normalized=free.out, oracle_normalized=expect,
                                              rtol=0, atol=ATOL))
    _chaos_plans("ws_expert", ek.what, ek.state, ek.launch, ek.plain, ek.check,
                 default_rounds(ek.state, True, steal_run_cap=4), (plan,), steal_run_cap=4)
    ds = to_device(ek.state, dev)
    tok = torch.from_numpy(ek.routed.tok_idx).to(dev)
    eout = torch.zeros((ek.routed.n_rows, e["d"]), dtype=torch.float32, device=dev)

    def e_go(arrs, cap):
        X._launch_cuda(arrs, ek.x, tok, *ek.w, eout, mode="free", rounds=0, steal=True,
                       policy="cost", compress=False, bt=e["bt"], n_tasks=ek.state.n_tasks,
                       run_cap=cap)

    HALFRUN["ws_expert"] = _halfrun_stats("ws_expert", ds, ek.state.n_tasks, e_go, ek.what)
    del ek, ds, eout
    gc.collect()
    torch.cuda.empty_cache()
    errs = {k: max(v) for k, v in errs.items()}
    log(f"[halfrun] phase {time.perf_counter() - t_phase:.1f} s, max_abs_err {errs}; "
        f"card {card_line()}")
    return errs


def _grad_halfrun(pool, x, gy, routed, w, n_live, expect, free_out):
    """ws_expert_grad at HALFRUN_CAPS on the grad phase's pool queues:
    lockstep bit-equal to the plain walk (rings included), a traced free
    launch within GRAD_RTOL of the plain version's normalised block
    (``expect``) and clean under SafetyChecker against the per-slot free
    launch's block (``free_out``: the same tile math), and the free
    launches' statistics at cap 1, 2, 4."""
    from repro_torch.chaos import SafetyChecker, single_launch
    from repro_torch.moe_ws import expert_rounds_bound
    from repro_torch.moe_ws import expert_kernel as X
    from repro_torch.pallas_ws import to_device
    from repro_torch.wstrace import EV_RUN

    c = GRAD
    d, f = c["d"], c["f"]
    t0 = time.perf_counter()
    errs = []
    for cap in HALFRUN_CAPS:
        rounds = expert_rounds_bound(c["T"] * c["k"], c["bt"], c["E"], c["P"], True,
                                     steal_run_cap=cap)
        kw = dict(steal=True, steal_policy="cost", rounds=rounds, trace=True, steal_run_cap=cap)
        res_k = _grad_run(pool, x, gy, routed, w, mode="lockstep", **kw)
        torch.cuda.synchronize()
        res_p = _grad_run(pool, x, gy, routed, w, mode="lockstep", plain=True, **kw)
        ik, ip = _ints(res_k), _ints(res_p)
        bad = [n for n in ik if not np.array_equal(ik[n], ip[n])]
        if bad:
            raise AssertionError(f"ws_expert_grad half-run cap={cap} lockstep: {bad} differ")
        a, r = _check_grad_block(f"ws_expert_grad half-run cap={cap} lockstep", res_k.out,
                                 res_p.out, d, f)
        free = _grad_run(pool, x, gy, routed, w, mode="free", steal_run_cap=cap, trace=True)
        torch.cuda.synchronize()
        mult = free.mult.cpu()
        if not (bool((mult[:n_live] >= 1).all()) and bool((mult[n_live:] == 0).all())):
            raise AssertionError(f"ws_expert_grad half-run cap={cap} free left a tile")
        af, rf = _check_grad_block(f"ws_expert_grad half-run cap={cap} free", free.out, expect,
                                   d, f)
        errs += [a, af]
        in_runs = int((res_p.events[..., EV_RUN] > 1).sum())
        log(f"[halfrun] ws_expert_grad cap={cap} lockstep: integer arrays and rings bit-equal "
            f"({in_runs} events in runs), out max_abs_err {a:.3g} (group-relative {r:.3g}); "
            f"free max_abs_err {af:.3g} (group-relative {rf:.3g})")
        _report("ws_expert_grad", f"half-run cap={cap} free launch (deepseek-v2 train routing)",
                SafetyChecker().check(single_launch(pool, free), n_tasks=n_live,
                                      normalized=free.out, oracle_normalized=free_out,
                                      rtol=GRAD_RTOL, atol=ATOL))
    dev = x.device
    ds = to_device(pool, dev)
    tok = torch.from_numpy(np.asarray(routed.tok_idx, dtype=np.int32)).to(dev)
    gr = torch.from_numpy(np.asarray(routed.gates, dtype=np.float32)).to(dev)
    out = torch.zeros((tok.shape[0], X.grad_out_width(d, f)), dtype=torch.float32, device=dev)

    def g_go(arrs, cap):
        X._launch_grad_cuda(arrs, x, gy, tok, gr, *w, out, mode="free", rounds=0, steal=True,
                            policy="cost", compress=False, bt=c["bt"], n_tasks=pool.n_tasks,
                            run_cap=cap)

    HALFRUN["ws_expert_grad"] = _halfrun_stats("ws_expert_grad", ds, n_live, g_go,
                                               "deepseek-v2 train routing", n=2, warm=False)
    log(f"[halfrun] ws_expert_grad checks {time.perf_counter() - t0:.1f} s")
    return max(errs)


def _streams(done):
    return {rid: list(r.out) for rid, r in done.items()}


def _serve_jit(tag, params, cfg, prompts, max_new, want):
    """The serving run again with ``jit_ws=True`` (every Put on the device,
    each replica's step captured at its first step and replayed): the same
    greedy streams as the run without it (``want``), ws_attention launches
    == decode steps x layers (and ws_expert == (steps + prefills) x layers
    on a MoE model), and its step and throughput figures."""
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    front = WorkStealingFrontend(
        lambda: ContinuousBatcher(params, cfg, slots=4, capacity=1024, jit_ws=True),
        n_replicas=2)
    for rid, p in enumerate(prompts):
        front.submit(0, Request(rid=rid, tokens=p, max_new=max_new))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = front.run(max_iters=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launches[n] for n in ("ws_attention", "ws_expert", "ws_expert_grad",
                                       "ws_unified")}
    stats = front.stats()
    steps = sum(s["steps"] for s in stats["batchers"])
    prefills = sum(s["admitted"] for s in stats["batchers"])
    L = cfg.n_layers
    got = _streams(done)
    if got != want:
        diff = sorted(r for r in want if got.get(r) != want[r])
        raise AssertionError(f"[{tag}] jit_ws streams differ from the eager step's on {diff}")
    want_exp = (steps + prefills) * L if cfg.family == "moe" else 0
    if (counts["ws_attention"] != steps * L or counts["ws_expert"] != want_exp
            or counts["ws_expert_grad"] or counts["ws_unified"]):
        raise AssertionError(f"[{tag}] jit_ws launches {counts} over {steps} steps and "
                             f"{prefills} prefills of {L} layers")
    if not all(b._jit is not None and b._jit._graph is not None for b in front.batchers):
        raise AssertionError(f"[{tag}] a replica served without its captured step")
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    first = [b.metrics.step_latency_s[0] * 1e3 for b in front.batchers]
    tokens = sum(len(r.out) for r in done.values())
    out = {
        "wall_s": wall, "new_tokens": tokens, "tokens_per_s": tokens / wall,
        "decode_steps": steps, "prefills": prefills,
        "step_ms_p50": float(np.percentile(lat, 50)),
        "step_ms_p99": float(np.percentile(lat, 99)),
        "first_step_ms": first, "stolen": stats["totals"]["stolen"],
        "launches": counts,
        "launches_per_decode_step": {"ws_attention": counts["ws_attention"] / steps,
                                     "ws_expert": (counts["ws_expert"] - want_exp) / steps
                                     + L * (cfg.family == "moe")},
    }
    log(f"[{tag}] jit_ws on: {len(done)} requests, {tokens} new tokens in {wall:.2f} s "
        f"({tokens / wall:.2f} tokens/s incl. prefill); {steps} decode steps, step p50 "
        f"{out['step_ms_p50']:.2f} ms p99 {out['step_ms_p99']:.2f} ms (each replica's first, "
        f"with its capture: {', '.join(f'{x:.1f}' for x in first)} ms); launches {counts} "
        f"({counts['ws_attention'] / steps:.1f} ws_attention a step); streams equal to "
        f"jit_ws off")
    del front
    gc.collect()
    return out


def _jit_step_checks(tag, params, cfg, caches, tok, pos, want, tol):
    """The captured step on a batcher's ``caches`` against one host-Put step's
    logits ``want`` [B, V] on the same caches: the first call (eager, then
    the capture), a replay, and a replay under
    ``torch.cuda.set_sync_debug_mode("error")`` (nothing may synchronise
    before the logits are read), each on a copy restored in place; within
    ``tol`` (0: bit-equal).  Also a replay's device time."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import Caches
    from repro_torch.serving import jit_decode_step_ws

    V = cfg.vocab_size
    step = jit_decode_step_ws(cfg)
    mine = Caches(kv=KVCache(caches.kv.k.clone(), caches.kv.v.clone()))
    errs = []
    for i, what in enumerate(("first call", "replay", "replay, sync debug mode 'error'")):
        mine.kv.k.copy_(caches.kv.k)
        mine.kv.v.copy_(caches.kv.v)
        torch.cuda.synchronize()
        if i == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            lg, _ = step(params, mine, tok, pos)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        lg = lg[:, :V]
        step.check_drained()
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"[{tag}] jit_ws logits ({what}) not finite")
        errs.append(float((lg - want).abs().max()))
        if not errs[-1] <= tol:
            raise AssertionError(f"[{tag}] jit_ws logits ({what}) differ from the host-Put "
                                 f"step's by {errs[-1]} > {tol}")
    replay_ms = _device_ms(lambda _: step._graph.replay(), 10)
    split = _replay_split(step)
    log(f"[{tag}] jit_ws step on the batcher's caches against the host-Put step: max |logit "
        f"diff| first call {errs[0]:.4g}, replay {errs[1]:.4g}, replay under sync debug mode "
        f"'error' {errs[2]:.4g} (<= {tol:.4g}{', bit-equal' if tol == 0 else ''}; nothing "
        f"synchronised); a replay's device time {replay_ms:.3f} ms; its kernels by group "
        f"(torch.profiler, one replay): {json.dumps(split)}")
    del step, mine
    gc.collect()
    return {"logit_err_vs_host_put": errs, "logit_tol": tol, "sync_free_replay": True,
            "replay_device_ms": replay_ms, "replay_split": split}


def _replay_split(step):
    """One replay's kernels under torch.profiler, summed by group: the ws
    megakernels, GEMMs (cuBLAS/CUTLASS names) and the rest, each with its
    kernel count; ``None`` where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step._graph.replay()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if not us:
            continue
        name = e.key.lower()
        g = ("ws_kernels" if name.startswith(("ws_", "void ws_")) else
             "gemm" if any(w in name for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma")) else
             "other")
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + us / 1e3, n + e.count)
    if not groups:
        return None
    return {g: {"ms": ms, "kernels": n} for g, (ms, n) in sorted(groups.items())}


def phase_serving(dev):
    from repro_torch.configs.llama3_2_3b import CONFIG
    from repro_torch.models import decode_step, decode_step_ws, init_params
    from repro_torch.models.model import Caches
    from repro_torch.models.attention import KVCache
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    cfg = CONFIG
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serving] {cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.dtype}) "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 769, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]
    max_new = 16
    front = WorkStealingFrontend(
        lambda: ContinuousBatcher(params, cfg, slots=4, capacity=1024), n_replicas=2)
    for rid, p in enumerate(prompts):
        front.submit(0, Request(rid=rid, tokens=p, max_new=max_new))

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = front.run(max_iters=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launches, n_exp = launches["ws_attention"], launches["ws_expert"]
    n_grad, n_uni = launches["ws_expert_grad"], launches["ws_unified"]

    stats = front.stats()
    steps = sum(s["steps"] for s in stats["batchers"])
    if sorted(done) != list(range(len(prompts))) or front.rejected:
        raise AssertionError(f"completed {sorted(done)}, rejected {sorted(front.rejected)}")
    for r in done.values():
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid} produced {r.out}")
    if n_launches != steps * cfg.n_layers or n_launches == 0:
        raise AssertionError(f"ws_attention launches {n_launches} != {steps} steps x {cfg.n_layers}")
    if n_exp != 0 or n_grad != 0 or n_uni != 0:
        raise AssertionError(f"the split path launched ws_expert {n_exp}, ws_expert_grad "
                             f"{n_grad} and ws_unified {n_uni} times")
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    stolen = stats["totals"]["stolen"]
    if stolen == 0:
        raise AssertionError("replica 1 stole nothing")
    tokens = sum(len(r.out) for r in done.values())
    serving = {
        "requests": len(done), "prompt_tokens": int(lens.sum()), "new_tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall, "decode_steps": steps,
        "step_ms_p50": float(np.percentile(lat, 50)),
        "step_ms_p99": float(np.percentile(lat, 99)),
        "stolen": stolen, "launches": n_launches, "ws_expert_launches": n_exp,
        "ws_expert_grad_launches": n_grad, "ws_unified_launches": n_uni,
        "per_replica": stats["per_replica"],
    }
    log(f"[serving] {len(done)} requests, {tokens} new tokens in {wall:.2f} s "
        f"({tokens / wall:.2f} tokens/s incl. prefill); {steps} decode steps, "
        f"step p50 {serving['step_ms_p50']:.2f} ms p99 {serving['step_ms_p99']:.2f} ms; "
        f"stolen {stolen}; ws_attention launches {n_launches} == {steps} x {cfg.n_layers} "
        f"({n_launches / steps:.1f} a step), ws_expert launches {n_exp}")
    serving["launches_per_decode_step"] = {"ws_attention": n_launches / steps,
                                           "ws_expert": 0.0}
    serving["jit_ws"] = _serve_jit("serving", params, cfg, prompts, max_new, _streams(done))
    serving["crash"] = _serve_crash(params, cfg, prompts, max_new, _streams(done))

    # ws vs dense logits on the same caches: four prompts in a fresh batcher
    b = ContinuousBatcher(params, cfg, slots=4, capacity=1024)
    for rid in range(4):
        assert b.admit(Request(rid=rid, tokens=prompts[rid], max_new=max_new))
    tok = torch.tensor([[r.out[-1]] for r in b.live], device=dev)
    pos = b.pos.copy()

    def clone():
        return Caches(kv=KVCache(b.caches.kv.k.clone(), b.caches.kv.v.clone()))

    V = cfg.vocab_size
    lg_ws = decode_step_ws(params, cfg, clone(), tok, pos)[0][:, :V]
    lg_dense = decode_step(params, cfg, clone(), tok, pos)[0][:, :V]
    if tuple(lg_ws.shape) != (4, V) or not bool(torch.isfinite(lg_ws).all()):
        raise AssertionError(f"ws logits {tuple(lg_ws.shape)} not finite")
    # fp32 yardstick: the same weights and caches widened to fp32, dense step
    params32 = _map(params, lambda t: t.float())
    caches32 = Caches(kv=KVCache(b.caches.kv.k.float(), b.caches.kv.v.float()))
    lg_ref = decode_step(params32, cfg.replace(dtype="float32"), caches32, tok, pos)[0][:, :V]
    torch.cuda.synchronize()
    del params32, caches32
    err_ws = float((lg_ws - lg_ref).abs().max())
    err_dense = float((lg_dense - lg_ref).abs().max())
    diff = float((lg_ws - lg_dense).abs().max())
    scale = float(lg_ref.abs().max())
    agree = int((lg_ws.argmax(-1) == lg_dense.argmax(-1)).sum())
    log(f"[serving] logits vs the fp32 step (max |logit| {scale:.4g}): ws {err_ws:.4g}, "
        f"dense bf16 {err_dense:.4g} (ws <= {LOGIT_SLACK} x dense); ws vs dense "
        f"{diff:.4g}; argmax agree {agree}/4")
    if not err_ws <= LOGIT_SLACK * err_dense:
        raise AssertionError("ws logits stray further from the fp32 step than the dense step's")
    # the captured step on the same caches: bit-equal to the host-Put step
    serving["jit_ws"].update(_jit_step_checks("serving", params, cfg, b.caches, tok, pos,
                                              lg_ws, 0.0))
    del b, params
    torch.cuda.empty_cache()
    serving.update(logit_err_ws=err_ws, logit_err_dense=err_dense, logit_ws_vs_dense=diff,
                   logit_scale=scale, argmax_agree=agree)
    return serving, n_launches


# ---------------------------------------------------------------------------
# MoE serving


@contextmanager
def expert_launches(on_launch):
    """Call ``on_launch(state, args, kwargs, res)`` after every expert launch
    the MoE layers make.  The callers check that it ran once per counted
    launch, so a renamed hook cannot pass unseen."""
    from repro_torch.moe_ws import layer

    orig = layer.run_moe_schedule

    def run(state, *a, **kw):
        res = orig(state, *a, **kw)
        on_launch(state, a, kw, res)
        return res

    layer.run_moe_schedule = run
    try:
        yield
    finally:
        layer.run_moe_schedule = orig


@contextmanager
def attention_launches(on_launch):
    """Call ``on_launch((state, args, kwargs, res))`` after every attention
    launch of the ws decode step (``ragged.run_ws_schedule``)."""
    from repro_torch.pallas_ws import ragged

    orig = ragged.run_ws_schedule

    def run(state, *a, **kw):
        res = orig(state, *a, **kw)
        on_launch((state, a, kw, res))
        return res

    ragged.run_ws_schedule = run
    try:
        yield
    finally:
        ragged.run_ws_schedule = orig


def _hold_attention_launch(tag, rec, n):
    """One recorded attention launch ``(state, args, kwargs, res)`` of a ws
    decode step of ``n`` launches (the caller checks that the step made
    them) against the plain version on the same q and cache within ATOL,
    both outputs normalised by their multiplicities."""
    from repro_torch.pallas_ws.kernel import run_ws_schedule
    from repro_torch.pallas_ws.ragged import normalized_out

    st, args, kw, res = rec
    with plain_versions():
        res_p = run_ws_schedule(st, *args, **kw)
    q = args[0]
    shape = (q.shape[0], q.shape[1], 1)
    got, want = (normalized_out(r, st.task_list, shape)[:, :, 0] for r in (res, res_p))
    err = float((got - want).abs().max())
    log(f"[{tag}] launch {n} of the step (q {tuple(q.shape)}, cache {tuple(args[1].shape)}, "
        f"{q.dtype}, {res.mode} mode) against the plain version: out max_abs_err {err:.3g} "
        f"(<= ATOL {ATOL}; max |out| {float(want.abs().max()):.4g})")
    if not err <= ATOL:
        raise AssertionError(f"[{tag}] the attention launch differs from the plain version by "
                             f"{err} > {ATOL}")
    return dict(max_abs_err=err, hd=int(q.shape[-1]), mode=res.mode)


def _hold_expert_launches(tag, recorded):
    """Each recorded expert launch ``(state, args, kwargs, res)`` against the
    plain version on its own inputs within ATOL, and the same rows in bf16
    (:func:`bf16_rows`) as the control that must miss ATOL.  Returns (the
    largest launch error, the smallest control error)."""
    from repro_torch.moe_ws import run_moe_schedule

    launch_err, control_err = 0.0, float("inf")
    for st, args, kw, res in recorded:
        with plain_versions():
            res_p = run_moe_schedule(st, *args, **kw)
        ctl = bf16_rows(st, args[0].float(), *args[1:], kw["bt"])
        launch_err = max(launch_err, float((res.out - res_p.out).abs().max()))
        control_err = min(control_err, float((ctl - res_p.out).abs().max()))
    log(f"[{tag}] the step's {len(recorded)} expert launches against the plain version on "
        f"their own inputs: out max_abs_err {launch_err:.3g} (<= ATOL {ATOL}); the same rows "
        f"with bf16 products (the dense dispatch's arithmetic) {control_err:.3g} (> ATOL)")
    if not launch_err <= ATOL:
        raise AssertionError(f"[{tag}] served expert launches differ from the plain version "
                             f"by {launch_err} > {ATOL}")
    if not control_err > ATOL:
        raise AssertionError(f"[{tag}] the bf16 control came within ATOL ({control_err}): the "
                             "launch check cannot tell fp32 from bf16 expert math")
    return launch_err, control_err


def bf16_rows(state, x, tok_idx, wg, wu, wd, bt):
    """The routed rows of one expert launch computed as the dense dispatch's
    einsums compute experts: bf16 operands, bf16 products and hidden tile.
    The control that the fp32 comparison of a launch must reject."""
    from repro_torch.pallas_ws.tasks import F_E, F_RL, F_RS

    bf16 = torch.bfloat16
    tok = torch.as_tensor(np.asarray(tok_idx), dtype=torch.int64, device=x.device)
    out = torch.zeros((tok.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    for q in range(state.n_queues):
        for rec in state.tasks[q, : int(state.tail[q])]:
            e, rs, rl = int(rec[F_E]), int(rec[F_RS]), int(rec[F_RL])
            xb = x[tok[rs:rs + rl]].to(bf16)
            hb = torch.nn.functional.silu(xb @ wg[e].to(bf16)) * (xb @ wu[e].to(bf16))
            out[rs:rs + rl] = (hb @ wd[e].to(bf16)).float()
    return out


def fp32_logits(params, cfg, h, chunk=16384):
    """Logits of a final residual stream h [B, 1, d] with the final norm and
    the unembedding in fp32 (the model rounds both to bf16)."""
    from repro_torch.models.common import rms_norm
    from repro_torch.models.model import _unembed_matrix

    hn = rms_norm(h[:, 0].float(), params["final_norm"], cfg.norm_eps)
    U = _unembed_matrix(params, cfg)
    V = cfg.vocab_size
    return torch.cat([hn @ U[:, i:min(i + chunk, V)].float() for i in range(0, V, chunk)], 1)


def one_ulp(h, seed):
    """h with every nonzero element moved one ulp of its dtype (bf16 on the
    card) up or down in magnitude, the direction drawn from ``seed``."""
    itype = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[h.dtype]
    g = torch.Generator(device=h.device).manual_seed(seed)
    step = torch.randint(0, 2, h.shape, generator=g, device=h.device).to(itype) * 2 - 1
    bits = h.contiguous().view(itype)
    return torch.where(h != 0, (bits + step).view(h.dtype), h)


def phase_moe(dev):
    from repro_torch.configs.kimi_k2_1t_a32b import CONFIG
    from repro_torch.models import decode_hidden, decode_hidden_ws, decode_step_ws, init_params
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import Caches
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] device memory in use before init: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    cfg = CONFIG.replace(n_layers=2, moe_dispatch="ws")
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[moe] {cfg.name} depth {L} (of {CONFIG.n_layers}) at full width: "
        f"{n_params / 1e9:.3f} B parameters, {n_bytes / 2**30:.2f} GiB ({cfg.dtype}, router "
        f"fp32) initialised in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB in use")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(8, 65, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]
    max_new = 8
    front = WorkStealingFrontend(
        lambda: ContinuousBatcher(params, cfg, slots=4, capacity=1024), n_replicas=2)
    for rid, p in enumerate(prompts):
        front.submit(0, Request(rid=rid, tokens=p, max_new=max_new))

    dup = []
    with expert_launches(lambda st, a, kw, res: dup.append(
            (int(res.mult[: st.n_tasks].sum()), st.n_tasks))):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = front.run(max_iters=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_attn, n_exp = launches["ws_attention"], launches["ws_expert"]
        n_grad, n_uni = launches["ws_expert_grad"], launches["ws_unified"]

    stats = front.stats()
    steps = sum(s["steps"] for s in stats["batchers"])
    prefills = sum(s["admitted"] for s in stats["batchers"])
    if sorted(done) != list(range(len(prompts))) or front.rejected:
        raise AssertionError(f"completed {sorted(done)}, rejected {sorted(front.rejected)}")
    for r in done.values():
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid} produced {r.out}")
    if n_attn != steps * L or n_attn == 0:
        raise AssertionError(f"ws_attention launches {n_attn} != {steps} steps x {L}")
    if n_exp != (steps + prefills) * L or n_exp == 0:
        raise AssertionError(f"ws_expert launches {n_exp} != ({steps} steps + "
                             f"{prefills} prefills) x {L}")
    if len(dup) != n_exp:
        raise AssertionError(f"the launch hook saw {len(dup)} of {n_exp} expert launches")
    if n_grad != 0 or n_uni != 0:
        raise AssertionError(f"serving launched ws_expert_grad {n_grad} and ws_unified "
                             f"{n_uni} times")
    stolen = stats["totals"]["stolen"]
    if stolen == 0:
        raise AssertionError("replica 1 stole nothing")
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    tokens = sum(len(r.out) for r in done.values())
    duplication = sum(m for m, _ in dup) / sum(n for _, n in dup)
    serving = {
        "model": f"{cfg.name} (depth {L})", "requests": len(done),
        "prompt_tokens": int(lens.sum()), "new_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "decode_steps": steps, "prefills": prefills,
        "step_ms_p50": float(np.percentile(lat, 50)),
        "step_ms_p99": float(np.percentile(lat, 99)),
        "stolen": stolen, "ws_attention_launches": n_attn, "ws_expert_launches": n_exp,
        "ws_expert_grad_launches": n_grad, "ws_unified_launches": n_uni,
        "expert_duplication": duplication, "per_replica": stats["per_replica"],
    }
    log(f"[moe] {len(done)} requests, {tokens} new tokens in {wall:.2f} s "
        f"({tokens / wall:.2f} tokens/s incl. prefill); {steps} decode steps, {prefills} "
        f"prefills, step p50 {serving['step_ms_p50']:.2f} ms p99 "
        f"{serving['step_ms_p99']:.2f} ms; stolen {stolen}; ws_attention launches {n_attn} "
        f"== {steps} x {L}; ws_expert launches {n_exp} == ({steps} + {prefills}) x {L}; "
        f"free-mode expert duplication sum(mult)/tiles {duplication:.3f}")
    serving["launches_per_decode_step"] = {"ws_attention": n_attn / steps,
                                           "ws_expert": (n_exp - prefills * L) / steps}
    serving["jit_ws"] = _serve_jit("moe", params, cfg, prompts, max_new, _streams(done))

    # one decode step of four admitted prompts, on copies of the same caches
    b = ContinuousBatcher(params, cfg, slots=4, capacity=1024)
    for rid in range(4):
        assert b.admit(Request(rid=rid, tokens=prompts[rid], max_new=max_new))
    tok = torch.tensor([[r.out[-1]] for r in b.live], device=dev)
    pos = b.pos.copy()

    def clone():
        return Caches(kv=KVCache(b.caches.kv.k.clone(), b.caches.kv.v.clone()))

    # launches of one decode_step_ws call, counted from 0
    V = cfg.vocab_size
    reset_launches()
    lg_step = decode_step_ws(params, cfg, clone(), tok, pos)[0][:, :V]
    torch.cuda.synchronize()
    per_step = {n: launches[n] for n in ("ws_attention", "ws_expert", "ws_expert_grad")}
    if per_step != {"ws_attention": L, "ws_expert": L, "ws_expert_grad": 0}:
        raise AssertionError(f"one decode_step_ws launched {per_step}, want {L} of each "
                             "forward kernel and no ws_expert_grad")
    if tuple(lg_step.shape) != (4, V) or not bool(torch.isfinite(lg_step).all()):
        raise AssertionError(f"ws logits {tuple(lg_step.shape)} not finite")

    # the same step again with its expert launches recorded and its routing
    # taped, then on both plain versions replaying that routing, then the
    # dense (capacity-dropping, bf16 experts) step
    tape, recorded = [], []
    with expert_launches(lambda *r: recorded.append(r)), \
            routing_tape(record=tape) as rec_counts:
        h_ws = decode_hidden_ws(params, cfg, clone(), tok, pos)[0]
    with plain_versions(), routing_tape(replay=tape) as rep_counts:
        h_plain = decode_hidden_ws(params, cfg, clone(), tok, pos)[0]
    h_dense = decode_hidden(params, cfg.replace(moe_dispatch="dense"), clone(), tok, pos)[0]
    torch.cuda.synchronize()
    if not (len(recorded) == len(tape) == rec_counts[0] == rep_counts[0] == L):
        raise AssertionError(f"hooks: {len(recorded)} launches, {len(tape)} taped and "
                             f"{rep_counts[0]} replayed routings, want {L}")

    launch_err, control_err = _hold_expert_launches("moe", recorded)

    # end to end: logits with the final norm and unembedding in fp32
    lg_ws, lg_plain, lg_dense = (fp32_logits(params, cfg, h) for h in (h_ws, h_plain, h_dense))
    lg_ulp = fp32_logits(params, cfg, one_ulp(h_plain, SEED))
    err = float((lg_ws - lg_plain).abs().max())
    err_dense = float((lg_dense - lg_plain).abs().max())
    err_ulp = float((lg_ulp - lg_plain).abs().max())
    scale = float(lg_plain.abs().max())
    agree_plain = int((lg_ws.argmax(-1) == lg_plain.argmax(-1)).sum())
    agree_dense = int((lg_ws.argmax(-1) == lg_dense.argmax(-1)).sum())
    agree_step = int((lg_step.argmax(-1) == lg_ws.argmax(-1)).sum())
    tol = LOGIT_ULP_SLACK * err_ulp
    log(f"[moe] fp32 logits vs the plain-version step (max |logit| {scale:.4g}): ws "
        f"{err:.4g} (<= {tol:.4g} = {LOGIT_ULP_SLACK} x {err_ulp:.4g}, the plain step's "
        f"final hidden state moved one bf16 ulp per element), argmax agree {agree_plain}/4, "
        f"top-k sets that would have differed {rep_counts[1]}/{4 * L}; dense decode_step "
        f"{err_dense:.4g} ({err_dense / err_ulp:.3g} one-ulp distances against ws's "
        f"{err / err_ulp:.3g}), argmax agree with ws {agree_dense}/4; decode_step_ws's own "
        f"(bf16) logits argmax agree {agree_step}/4")
    if not err <= tol:
        raise AssertionError(f"ws logits differ from the plain-version step by {err} > {tol}")
    # the captured step on the same caches against decode_step_ws's own logits,
    # within LOGIT_ULP_SLACK one-ulp distances of that logits function (the
    # combine's index_add_ order is not fixed)
    from repro_torch.models.model import _logits

    step_ulp = float((_logits(params, cfg, one_ulp(h_ws, SEED)) - _logits(params, cfg, h_ws))
                     [:, :V].abs().max())
    serving["jit_ws"].update(_jit_step_checks("moe", params, cfg, b.caches, tok, pos, lg_step,
                                              LOGIT_ULP_SLACK * step_ulp))
    serving.update(ws_expert_launches_per_decode_step=per_step["ws_expert"],
                   ws_attention_launches_per_decode_step=per_step["ws_attention"],
                   ws_expert_grad_launches_per_decode_step=per_step["ws_expert_grad"],
                   launch_err=launch_err, launch_bf16_control_err=control_err,
                   logit_err_ws_vs_plain=err, logit_tol=tol, logit_one_ulp=err_ulp,
                   logit_err_dense_vs_plain=err_dense, logit_scale=scale,
                   argmax_agree_plain=agree_plain, argmax_agree_dense=agree_dense,
                   routing_flips=rep_counts[1])
    del b, front, params, recorded
    gc.collect()
    torch.cuda.empty_cache()
    return serving


# ---------------------------------------------------------------------------
# training: the expert backward kernel and the deepseek-v2 train step


# deepseek-v2 at full width: d 5120, f 1536, 160 experts top-6; T = 8 x 64
# tokens, the train step's batch
GRAD = dict(d=5120, f=1536, E=160, k=6, bt=8, P=8, T=512)
# A grad block [dx | du | dv | h | dgate] is held column group by column
# group, each to GRAD_RTOL of the group's own largest magnitude: the groups
# span six orders of magnitude (in the train step h is O(10) and the
# cotangent groups O(1e-5); with unit cotangents dgate sums 5120 products
# and reaches ~170), and fp32 sums of the same products in another order
# differ by ~1e-6 of the group's scale.  A bf16-product evaluation misses by
# ~1e-3 of it, in every group.
GRAD_RTOL = 1e-4
# The train step against the same step on the plain versions.  The model
# is bf16: a last-bit difference of one expert row flips the bf16 rounding
# of an activation, and within a few rounded d-wide products almost every
# element of the step's gradients differs by an ulp; reductions over the
# 512 tokens with cancelling terms (the norm weights' gradients) read that
# as ~0.6% of their norm on an H100.  So each parameter's
# gradient is held to STEP_ULP_SLACK times the distance that moving every
# element of the MoE layer's output one bf16 ulp makes in the plain step
# (the saturated cascade itself); the loss within 1e-3 (the reference's
# drop-free ws-vs-dense trajectory bound).
STEP_ULP_SLACK = 2
STEP_LOSS_ATOL = 1e-3
# Launches of one train step of the 1-layer model: ws_expert in the forward
# and again in the remat replay, ws_expert_grad once, and no ws_attention
# (MLA trains on flash_ref, plain ops in the reference as here).
STEP_LAUNCHES = {"ws_attention": 0, "ws_expert": 2, "ws_expert_grad": 1, "ws_unified": 0}


def grad_group_errs(a, b, d, f):
    """Per column group of the grad block: max |a - b| / max |b|."""
    groups = (("dx", slice(0, d)), ("du", slice(d, d + f)), ("dv", slice(d + f, d + 2 * f)),
              ("h", slice(d + 2 * f, d + 3 * f)), ("dgate", slice(d + 3 * f, d + 3 * f + 1)))
    return {n: float((a[:, sl] - b[:, sl]).abs().max())
            / max(float(b[:, sl].abs().max()), 1e-30) for n, sl in groups}


def _check_grad_block(name, a, b, d, f):
    errs = grad_group_errs(a, b, d, f)
    worst = max(errs.values())
    if not worst <= GRAD_RTOL:
        raise AssertionError(f"{name}: grad block differs from the plain version by "
                             f"{errs} (relative to each group's scale) > {GRAD_RTOL}")
    return float((a - b).abs().max()), worst


def _grad_run(state, x, gy, routed, w, *, plain=False, **kw):
    from repro_torch.moe_ws import run_moe_grad_schedule
    from repro_torch.pallas_ws import to_device

    if plain:
        with plain_versions():
            return run_moe_grad_schedule(state, x, gy, routed.tok_idx, routed.gates, *w,
                                         bt=GRAD["bt"], **kw)
    return run_moe_grad_schedule(to_device(state, x.device), x, gy, routed.tok_idx,
                                 routed.gates, *w, bt=GRAD["bt"], **kw)


def phase_grad(dev, halfrun=False):
    """ws_expert_grad against its plain version at deepseek-v2 full width:
    lockstep on the pool layout (cost, scan) and on dense static queues,
    free mode, the no-thief rewind drill; then ws_expert on pool queues.
    ``halfrun``: the kernel's half-run checks and statistics too."""
    from repro_torch.moe_ws import expert_rounds_bound, route_to_tasks, route_to_tasks_pool
    from repro_torch.moe_ws.layer import _normalised
    from repro_torch.pallas_ws import copy_state, make_pool_queue_state, make_queue_state

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[grad] device memory in use before: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    c = GRAD
    d, f = c["d"], c["f"]
    t0 = time.perf_counter()
    w = expert_weights(dev, GRAD)
    torch.cuda.synchronize()
    log(f"[grad] deepseek-v2 expert weights E={c['E']} d={d} f={f} bf16 "
        f"({sum(t.numel() for t in w) * 2 / 1e9:.2f} GB) drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    idx = np.stack([rng.choice(c["E"], c["k"], replace=False) for _ in range(c["T"])])
    gates = rng.uniform(0.1, 1.0, (c["T"], c["k"])).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    x = torch.from_numpy(rng.standard_normal((c["T"], d)).astype(np.float32)).to(dev)
    gy = torch.from_numpy(rng.standard_normal((c["T"], d)).astype(np.float32)).to(dev)
    records, tail, pool_off, routed = route_to_tasks_pool(idx, gates, c["E"], bt=c["bt"])
    pool = make_pool_queue_state(records, tail, pool_off, routed.loads, c["P"],
                                 n_tasks=records.shape[0])
    tasks, hrouted = route_to_tasks(idx, gates, c["E"], bt=c["bt"])
    static = make_queue_state(tasks, c["P"], n_queues=c["P"], partition="owner")
    rounds = expert_rounds_bound(idx.size, c["bt"], c["E"], c["P"], True)
    n_live = int(tail.sum())
    log(f"[grad] routing T={c['T']} top-{c['k']}: {idx.size} rows, {n_live} live tiles in a "
        f"pool of {records.shape[0]}, {int((routed.loads > 0).sum())} experts touched")

    abs_errs, rel_errs = [], []
    # the cost case runs the traced instantiation: its rings are compared too
    cases = ((pool, routed, dict(steal=True, steal_policy="cost", rounds=rounds, trace=True)),
             (pool, routed, dict(steal=True, steal_policy="scan", rounds=rounds)),
             (static, hrouted, dict(steal=False)))
    for state, rt, kw in cases:
        name = (f"{'pool' if state.pool else 'dense'} steal={kw['steal']} "
                f"{kw.get('steal_policy', 'cost')}" + (" traced" if kw.get("trace") else ""))
        t0 = time.perf_counter()
        res_k = _grad_run(state, x, gy, rt, w, mode="lockstep", **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        res_p = _grad_run(state, x, gy, rt, w, mode="lockstep", plain=True, **kw)
        ik, ip = _ints(res_k), _ints(res_p)
        for n in ik:
            if not np.array_equal(ik[n], ip[n]):
                raise AssertionError(f"ws_expert_grad {name}: lockstep {n} differs from the "
                                     "plain version")
        a, r = _check_grad_block(f"ws_expert_grad {name} lockstep", res_k.out, res_p.out, d, f)
        abs_errs.append(a)
        rel_errs.append(r)
        if state.pool and kw["steal_policy"] == "cost":
            expect = _normalised(res_p, routed, None, c["bt"])
            oracle = res_k.out  # the fault-free lockstep accumulation, every tile once
        if not state.pool:
            expect_static = _normalised(res_p, hrouted, tasks, c["bt"])
        log(f"[grad] ws_expert_grad {name} lockstep: integer arrays bit-equal, out max_abs_err "
            f"{a:.3g}, max group-relative err {r:.3g} (<= {GRAD_RTOL}), {ms:.1f} ms")

    res = _grad_run(pool, x, gy, routed, w, mode="free")
    torch.cuda.synchronize()
    mult = res.mult[:n_live].cpu()
    if not (bool((mult >= 1).all()) and bool((res.mult[n_live:] == 0).all())):
        raise AssertionError(f"ws_expert_grad free: {(mult == 0).sum()} live tiles unexecuted "
                             "or a dead pool slot executed")
    a, r = _check_grad_block("ws_expert_grad free", res.out, expect, d, f)
    abs_errs.append(a)
    rel_errs.append(r)
    duplication = int(mult.sum()) / n_live
    log(f"[grad] ws_expert_grad free (pool): mult in [{int(mult.min())}, {int(mult.max())}], "
        f"sum(mult)/tiles {duplication:.2f}, out max_abs_err {a:.3g}, group-relative {r:.3g}")
    _grad_chaos(pool, x, gy, routed, w, rounds, n_live, oracle, res.out, halfrun)
    halfrun_err = (_grad_halfrun(pool, x, gy, routed, w, n_live, expect, res.out) if halfrun
                   else None)

    # rewind drill without thieves: resume with every head at 0 and every
    # local bound wiped; each tile runs exactly once more (mult == 2) and its
    # stored rows do not change
    first = _grad_run(static, x, gy, hrouted, w, mode="free", steal=False)
    drill = copy_state(static)
    drill.head = np.zeros_like(drill.head)
    drill.local_head = np.zeros_like(drill.local_head)
    drill.taken = first.taken.cpu().numpy()
    drill.remaining = first.remaining.cpu().numpy()
    second = _grad_run(drill, x, gy, hrouted, w, mode="free", steal=False, mult=first.mult,
                       out=first.out)
    torch.cuda.synchronize()
    m2 = second.mult[: static.n_tasks].cpu()
    if not bool((m2 == 2).all()):
        raise AssertionError(f"ws_expert_grad rewind drill mult in [{int(m2.min())}, "
                             f"{int(m2.max())}], want 2")
    a, r = _check_grad_block("ws_expert_grad rewind drill", second.out, expect_static, d, f)
    abs_errs.append(a)
    rel_errs.append(r)
    log(f"[grad] ws_expert_grad rewind drill: mult == 2 without thieves, rows unchanged "
        f"(max_abs_err {a:.3g}, group-relative {r:.3g})")

    # the forward kernel on the same pool queues
    fwd = []
    for plain in (False, True):
        if plain:
            with plain_versions():
                fwd.append(_moe_pool(pool, x, routed, w, rounds))
        else:
            fwd.append(_moe_pool(pool, x, routed, w, rounds))
        torch.cuda.synchronize()
    ik, ip = _ints(fwd[0]), _ints(fwd[1])
    for n in ik:
        if not np.array_equal(ik[n], ip[n]):
            raise AssertionError(f"ws_expert on pool queues: lockstep {n} differs")
    fwd_err = float((fwd[0].out - fwd[1].out).abs().max())
    if not fwd_err <= ATOL:
        raise AssertionError(f"ws_expert on pool queues: out max_abs_err {fwd_err} > {ATOL}")
    log(f"[grad] ws_expert on pool queues lockstep: integer arrays bit-equal, out max_abs_err "
        f"{fwd_err:.3g}")
    del w, res, first, second, fwd, x, gy
    gc.collect()
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(abs_errs), max_group_rel_err=max(rel_errs),
                free_duplication=duplication, pool_fwd_err=fwd_err,
                halfrun_max_abs_err=halfrun_err)


def _grad_chaos(pool, x, gy, routed, w, rounds, n_live, oracle, free_out, halfrun=False):
    """SafetyChecker on a traced free launch of ws_expert_grad, then the
    seeded plan GRAD_CHAOS_SEED without launch faults (the grad schedule
    takes none) in lockstep against the plain walk and in free mode; with
    ``halfrun``, HALFRUN_PLAN at cap 4 the same way."""
    from repro_torch.chaos import FaultPlan, SafetyChecker, single_launch
    from repro_torch.moe_ws import expert_rounds_bound, run_moe_grad_schedule
    from repro_torch.moe_ws.layer import _row_divisor
    from repro_torch.pallas_ws import copy_state

    t0 = time.perf_counter()
    kw = dict(bt=GRAD["bt"], steal=True, steal_policy="cost")

    def launch(mode):
        def go(st, *, rounds, out, mult, fault_plan, steal_run_cap=1):
            return run_moe_grad_schedule(st, x, gy, routed.tok_idx, routed.gates, *w, mode=mode,
                                         rounds=rounds, out=out, mult=mult, trace=True,
                                         steal_run_cap=steal_run_cap, **kw)
        return go

    def plain(st, **a):
        with plain_versions():
            return launch("lockstep")(st, **a)

    def check(ch):
        if ch.mode == "lockstep":
            return SafetyChecker().check(ch, n_tasks=n_live, oracle_accumulated=oracle,
                                         row_mult=_row_divisor(routed, None, ch.res, GRAD["bt"]))
        return SafetyChecker().check(ch, n_tasks=n_live, normalized=ch.res.out,
                                     oracle_normalized=free_out, rtol=GRAD_RTOL, atol=ATOL)

    clean = launch("free")(copy_state(pool), rounds=None, out=None, mult=None, fault_plan=None)
    torch.cuda.synchronize()
    _report("ws_expert_grad", "fault-free free launch (deepseek-v2 train routing)",
            check(single_launch(pool, clean)))
    _chaos_plans("ws_expert_grad", "deepseek-v2 train routing", pool, launch, plain, check,
                 rounds, (GRAD_CHAOS_SEED,), without_launch_faults=True)
    if halfrun:
        c = GRAD
        _chaos_plans("ws_expert_grad", "deepseek-v2 train routing", pool, launch, plain, check,
                     expert_rounds_bound(c["T"] * c["k"], c["bt"], c["E"], c["P"], True,
                                         steal_run_cap=4),
                     (FaultPlan(**HALFRUN_PLAN),), without_launch_faults=True, steal_run_cap=4)
    log(f"[grad] chaos checks {time.perf_counter() - t0:.1f} s")


def _moe_pool(state, x, routed, w, rounds):
    from repro_torch.moe_ws import run_moe_schedule
    from repro_torch.pallas_ws import to_device

    return run_moe_schedule(to_device(state, x.device), x, routed.tok_idx, *w, bt=GRAD["bt"],
                            mode="lockstep", rounds=rounds)


@contextmanager
def moe_output_moved_one_ulp(seed):
    """Every MoE layer's output moved one bf16 ulp per element (``one_ulp``),
    a constant shift the gradient flows through unchanged."""
    import repro_torch.moe_ws as M

    orig = M.moe_ffn_ws

    def moved(*a, **kw):
        y, aux = orig(*a, **kw)
        yd = y.detach()
        return y + (one_ulp(yd, seed) - yd), aux

    M.moe_ffn_ws = moved
    try:
        yield
    finally:
        M.moe_ffn_ws = orig


@contextmanager
def grad_launches(on_launch):
    """Call ``on_launch(state, args, kwargs, res)`` after every backward
    expert launch the MoE layers make (the callers count them)."""
    from repro_torch.moe_ws import layer

    orig = layer.run_moe_grad_schedule

    def run(state, *a, **kw):
        res = orig(state, *a, **kw)
        on_launch(state, a, kw, res)
        return res

    layer.run_moe_grad_schedule = run
    try:
        yield
    finally:
        layer.run_moe_grad_schedule = orig


def bf16_grad_rows(state, x, gy, tok_idx, gate_rows, wg, wu, wd, bt):
    """The grad block of one launch's live tiles with bf16 operands and
    products: the control the fp32 comparison must reject."""
    from repro_torch.pallas_ws.tasks import BOTTOM, F_E, F_OP, F_RL, F_RS, TASK_WIDTH

    bf16 = torch.bfloat16
    dev = wg.device
    tok = torch.as_tensor(np.asarray(tok_idx), dtype=torch.int64, device=dev)
    gr = torch.as_tensor(np.asarray(gate_rows), dtype=torch.float32, device=dev)
    d, f = wg.shape[1], wg.shape[2]
    out = torch.zeros((tok.shape[0], d + 3 * f + 1), dtype=torch.float32, device=dev)
    recs = np.asarray(state.tasks).reshape(-1, TASK_WIDTH)
    for rec in recs[recs[:, F_OP] != BOTTOM]:
        e, rs, rl = int(rec[F_E]), int(rec[F_RS]), int(rec[F_RL])
        t = tok[rs:rs + rl]
        xb, cb = x[t].to(bf16), gy[t].to(bf16)
        wgb, wub, wdb = wg[e].to(bf16), wu[e].to(bf16), wd[e].to(bf16)
        u, v = xb @ wgb, xb @ wub
        sig = torch.sigmoid(u)
        s = u * sig
        h = s * v
        dgate = (cb * (h @ wdb)).sum(-1, keepdim=True)
        dh = (gr[rs:rs + rl, None].to(bf16) * cb) @ wdb.T
        dv = dh * s
        du = dh * v * (sig * (1 + u * (1 - sig)))
        out[rs:rs + rl] = torch.cat([du @ wgb.T + dv @ wub.T, du, dv, h, dgate], 1).float()
    return out


def _grad_times(state, args, kw):
    """ws_expert_grad's kernel time (free, lockstep) at one recorded launch
    of the train step, its bound, and the plain version's time."""
    from repro_torch.moe_ws import expert_kernel as X
    from repro_torch.moe_ws import run_moe_grad_schedule
    from repro_torch.pallas_ws import kernel as K
    from repro_torch.pallas_ws import to_device

    x_in, gy, tok_idx, gate_rows, wg, wu, wd = args
    dev = wg.device
    x = x_in.float().contiguous()
    tok = torch.from_numpy(np.asarray(tok_idx, dtype=np.int32)).to(dev)
    gr = torch.from_numpy(np.asarray(gate_rows, dtype=np.float32)).to(dev)
    T, d = x.shape
    f = wg.shape[2]
    W = X.grad_out_width(d, f)
    out = torch.zeros((tok.shape[0], W), dtype=torch.float32, device=dev)
    ds = to_device(state, dev)
    times = {}
    for mode, n, traced in (("free", 3, False), ("lockstep", 1, False), ("free", 2, True)):
        arrs = _fresh_arrays(ds, mode, n + 1)
        rings = (_with_rings(arrs, int(np.asarray(state.tail).sum())) if traced
                 else [K.NO_RING] * (n + 1))

        def launch(i, mode=mode, rings=rings):
            X._launch_grad_cuda(arrs[i], x, gy, tok, gr, wg, wu, wd, out, mode=mode,
                                rounds=_rounds(mode, kw["rounds"]), steal=True, policy="cost",
                                compress=False, bt=kw["bt"], n_tasks=state.n_tasks,
                                ring=rings[i])

        if mode == "free" and not traced:
            launch(n)  # warm-up
            torch.cuda.synchronize()
        times[mode + ("_traced" if traced else "")] = _event_ms(launch, n)
        if mode == "free" and not traced:
            n_live = int(np.asarray(state.tail).sum())
            mult_per_tile, max_mult = _free_stats(arrs[:n], n_live)
    # cold device times: each free launch queued behind a sleeping kernel, L2
    # evicted first
    arrs = _fresh_arrays(ds, "free", 3)
    cold = _device_spans(lambda i: X._launch_grad_cuda(
        arrs[i], x, gy, tok, gr, wg, wu, wd, out, mode="free", rounds=0, steal=True,
        policy="cost", compress=False, bt=kw["bt"], n_tasks=state.n_tasks), 3,
        before=_l2_evictor(dev))
    layout = _tile_layout(wg.dtype, f, True, state.n_programs)
    TRACED["ws_expert_grad"] = dict(free_ms_untraced=times["free"],
                                    free_ms_traced=times["free_traced"],
                                    at="deepseek-v2 train step routing", card=card_line())
    # the forward kernel at the same routing, for the step's breakdown
    fwd_out = torch.zeros((tok.shape[0], d), dtype=torch.float32, device=dev)
    arrs = _fresh_arrays(ds, "free", 3)

    def fwd(i):
        X._launch_cuda(arrs[i], x, tok, wg, wu, wd, fwd_out, mode="free", rounds=0, steal=True,
                       policy="cost", compress=False, bt=kw["bt"], n_tasks=state.n_tasks)

    fwd(2)  # warm-up
    torch.cuda.synchronize()
    fwd_ms = _event_ms(fwd, 2)
    with plain_versions():
        run_moe_grad_schedule(state, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_moe_grad_schedule(state, *args, **kw)
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    rows = int(np.asarray(state.remaining).sum())        # live routed rows
    touched = int((np.asarray(state.tail) > 0).sum())    # experts with tiles
    w_bytes = touched * 3 * d * f * wg.element_size()    # their weights, once
    io_bytes = (2 * T * d * 4 + tok.shape[0] * (W * 4 + 8)
                + int(np.asarray(state.tasks).size) * 4)  # x, gy, out block, tok/gates, records
    byte_ms = (w_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 12 * rows * d * f / BF16_FLOPS * 1e3         # u, v, yhat, dh: 2df each; dx 4df
    bound_ms = max(byte_ms, ops_ms)
    bound_by = "bytes" if byte_ms >= ops_ms else "operations"
    # the tile-layout floor: every live tile reads its expert's 3 d f weights
    # once (the design reads wg and wu twice: 5 d f a tile)
    w_tile = d * f * wg.element_size()
    floor_ms = (n_live * 3 * w_tile + io_bytes) / HBM_BYTES_PER_S * 1e3
    design_floor_ms = (n_live * 5 * w_tile + io_bytes) / HBM_BYTES_PER_S * 1e3
    ms_cold = float(np.median(cold))
    log(f"[times] ws_expert_grad at the train step's routing ({rows} rows over {touched} "
        f"experts, {n_live} tiles): kernel free {times['free']:.4f} "
        f"ms (traced {times['free_traced']:.4f} ms; cold device {ms_cold:.4f} ms, range "
        f"{min(cold):.4f}-{max(cold):.4f}), lockstep {times['lockstep']:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}: {w_bytes + io_bytes} B; operations {ops_ms:.5f} ms), "
        f"tile-layout floor {floor_ms:.5f} ms (5 d f a tile: {design_floor_ms:.5f} ms), "
        f"sum(mult)/tiles {mult_per_tile:.3f}, max mult {max_mult}, plain version "
        f"{plain_ms:.2f} ms; {layout}; "
        "no single PyTorch call computes the gathered expert FFN's transpose, so there is "
        f"no library time; ws_expert free at the same routing {fwd_ms:.4f} ms; the first "
        "version (free, lockstep): " + ", ".join(
            f"{a}-{b} ms" for a, b in (FIRST_VERSION_MS[f"ws_expert_grad {m}"]
                                       for m in ("free", "lockstep"))))
    return dict(ms=times["free"], lockstep_ms=times["lockstep"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, ms_cold=ms_cold,
                ms_cold_range=[min(cold), max(cold)], floor_ms=floor_ms,
                design_floor_ms=design_floor_ms, mult_per_tile=mult_per_tile,
                max_mult=max_mult, **layout, ws_expert_free_ms_at_train_routing=fwd_ms)


def phase_train(dev):
    """deepseek-v2 at full width, 1 layer, both ws kernels: one step's loss
    and grads against the plain-version step, each grad launch against the
    plain version (bf16 control), then 3 optimizer steps through train()."""
    from repro_torch.configs.deepseek_v2_236b import CONFIG
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import loss_and_grads, train_policy
    from repro_torch.launch.train import train
    from repro_torch.models import ShapeConfig, init_params
    from repro_torch.moe_ws import run_moe_grad_schedule
    from repro_torch.optim import tree_leaves
    from repro_torch.pallas_ws import launches, reset_launches

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] device memory in use before init: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    cfg = CONFIG.replace(n_layers=1, moe_dispatch="ws", moe_grad_dispatch="ws")
    rows, seq = 8, 64
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[train] {cfg.name} depth 1 (of {CONFIG.n_layers}) at full width: {n_params / 1e9:.3f} "
        f"B parameters (param_count {cfg.param_count() / 1e9:.3f} B, policy "
        f"{train_policy(cfg)}), {n_bytes / 1e9:.2f} GB, initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, ShapeConfig("custom", "train", seq, rows), 0, n_rows=rows, seed=SEED).items()}

    # one step's loss and grads on the kernels, its grad launch recorded
    recorded, routes = [], []
    with grad_launches(lambda *r: recorded.append(r)), routing_tape(record=routes) as n_routes:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_k, _, g_k = loss_and_grads(params, cfg, batch)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        per_step = {n: launches[n] for n in STEP_LAUNCHES}
    if per_step != STEP_LAUNCHES or len(recorded) != 1:
        raise AssertionError(f"one loss_and_grads launched {per_step} (hook saw "
                             f"{len(recorded)}), want {STEP_LAUNCHES}: ws_expert forward and "
                             "remat replay, no ws_attention (MLA trains on flash_ref)")
    routes_p, routes_u = [], []
    with plain_versions(), routing_tape(record=routes_p) as n_routes_p:
        loss_p, _, g_p = loss_and_grads(params, cfg, batch)
    # the yardstick: the plain step with the MoE output moved one bf16 ulp
    with plain_versions(), routing_tape(record=routes_u) as n_routes_u, \
            moe_output_moved_one_ulp(SEED):
        loss_u, _, g_u = loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    # the router runs in the layer's forward and again in its remat replay
    if not (len(routes) == n_routes[0] == n_routes_p[0] == n_routes_u[0] == 2):
        raise AssertionError(f"router calls {n_routes[0]}, {n_routes_p[0]}, {n_routes_u[0]} "
                             f"({len(routes)} taped), want 2 a step: forward and remat replay")
    for rr in (routes_p, routes_u):
        if not all(torch.equal(a[1], b[1]) for a, b in zip(routes, rr)):
            raise AssertionError("a plain-version step routed differently")
    loss_err = abs(float(loss_k) - float(loss_p))
    yard = {n: float((u.float() - p.float()).norm())
            for n, u, p in zip(_paths(g_p), tree_leaves(g_u), tree_leaves(g_p))}
    worst, worst_name, worst_rel = _ulp_distances(g_k, g_p, yard)
    log(f"[train] one step on both ws kernels in {grad_s:.2f} s (launches {per_step}): loss {float(loss_k):.6f}, plain-version step {float(loss_p):.6f} (|diff| "
        f"{loss_err:.3g} <= {STEP_LOSS_ATOL}; the one-ulp move {abs(float(loss_u) - float(loss_p)):.3g}); "
        f"gradients: worst {worst_name} at {worst:.3g} one-ulp distances (<= {STEP_ULP_SLACK}), "
        f"largest distance {worst_rel:.3g} of a gradient's norm")
    if not (loss_err <= STEP_LOSS_ATOL and worst <= STEP_ULP_SLACK):
        raise AssertionError("the train step differs from the plain-version step")
    del g_p, g_k, g_u

    # the step's grad launch against the plain version on its own inputs,
    # and the same rows with bf16 products as the control that must fail
    st, args, kw, res = recorded[0]
    d, f = cfg.d_model, cfg.moe_d_ff
    with plain_versions(), torch.no_grad():
        res_p = run_moe_grad_schedule(st, *args, **kw)
        ctl = grad_group_errs(bf16_grad_rows(st, args[0].float(), *args[1:], kw["bt"]),
                              res_p.out, d, f)
    launch_abs, launch_rel = _check_grad_block("the train step's ws_expert_grad launch",
                                               res.out, res_p.out, d, f)
    log(f"[train] the step's ws_expert_grad launch against the plain version on its own "
        f"inputs: max_abs_err {launch_abs:.3g}, group-relative {launch_rel:.3g} (<= "
        f"{GRAD_RTOL}); the same rows with bf16 products, group-relative "
        + ", ".join(f"{n} {e:.3g}" for n, e in ctl.items()) + f" (each > {GRAD_RTOL})")
    if not min(ctl.values()) > GRAD_RTOL:
        raise AssertionError(f"the bf16 control came within {GRAD_RTOL} ({ctl}): the launch "
                             "check cannot tell fp32 from bf16 expert math")
    with torch.no_grad():
        times = _grad_times(st, args, kw)
    del recorded, res, res_p, st, args
    gc.collect()
    torch.cuda.empty_cache()

    # 3 optimizer steps through the port's train(), counted from 0
    snaps, step_s, metrics, peaks = [], [], [], []

    def on_step(step, state, m, seconds):
        snaps.append({n: launches[n] for n in STEP_LAUNCHES})
        step_s.append(seconds)
        metrics.append(m)
        peaks.append(torch.cuda.max_memory_allocated())

    in_use = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, losses = train("deepseek-v2-236b", smoke=False, n_layers=1, steps=3, rows=rows,
                      seq=seq, moe_dispatch="ws", moe_grad_dispatch="ws", seed=SEED,
                      device=dev, params=params, on_step=on_step, log_every=1)
    totals = {n: launches[n] for n in STEP_LAUNCHES}
    peak = max(peaks)
    steps = [{n: b[n] - (a[n] if a else 0) for n in b} for a, b in zip([None] + snaps, snaps)]
    if any(s != STEP_LAUNCHES for s in steps):
        raise AssertionError(f"launches per train step {steps}, want {STEP_LAUNCHES}")
    if len(losses) != 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    log(f"[train] 3 steps: losses {losses}, step seconds {[round(s, 3) for s in step_s]}, "
        f"peak device memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB; {in_use / 1e9:.2f} GB "
        f"in use before train()), launches per step "
        f"{steps[0]}, total {totals}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(model=f"{cfg.name} (depth 1, train)", losses=losses, step_s=step_s,
                peak_bytes=peak, step_peak_bytes=peaks, in_use_before_bytes=in_use, loss_vs_plain=loss_err, grad_vs_plain_ulp_distances=worst,
                grad_vs_plain_rel=worst_rel,
                one_step_s=grad_s, launches=totals, launches_per_step=steps[0],
                launch_abs_err=launch_abs, launch_rel_err=launch_rel,
                launch_bf16_control_rel=min(ctl.values()), grad_times=times,
                ce=[m["ce"] for m in metrics], aux=[m["aux"] for m in metrics])


# ---------------------------------------------------------------------------
# the paper's scheduler as the train step's gradient accumulation


# deepseek-v2 at full width cut to 1 layer, both ws kernels, as the train
# phase; the step's 8 rows are 8 microbatch tasks of 1 row (64 tokens) on 4
# worker queues, so a round is 4 rows x 64 tokens.  TAILS is the reference's
# skewed case (tests/test_launch.py); the trainer draws its tails from
# _skewed_tails at SKEW.
SCHED = dict(rows=8, seq=64, n_workers=4, tails=(5, 1, 1, 1), train_steps=3, skew=4.0)


@contextmanager
def row_separable_loss():
    """The loss without the MoE load-balance term (AUX_LOSS_W 0).  That term
    is computed over a routing group (a round's 4 rows, or the step's 8), so
    no schedule of rows reproduces the full batch's; the cross entropy is a
    sum over rows, which the 1/count weights make exact."""
    from repro_torch.models import model as M

    orig = M.AUX_LOSS_W
    M.AUX_LOSS_W = 0.0
    try:
        yield
    finally:
        M.AUX_LOSS_W = orig


def _ulp_distances(got, want, yard):
    """(worst ratio, its parameter, worst distance / norm): each gradient's
    distance from ``want`` in units of ``yard`` (the one-ulp distances)."""
    from repro_torch.optim import tree_leaves

    worst, name, rel = -1.0, None, 0.0
    for n, a, b in zip(_paths(want), tree_leaves(got), tree_leaves(want)):
        b32 = b.float()
        dist = float((a.float() - b32).norm())
        rel = max(rel, dist / max(float(b32.norm()), 1e-30))
        ratio = dist / max(yard[n], 1e-30)
        if ratio > worst:
            worst, name = ratio, n
    return worst, name, rel


def _rounds_run(assignment) -> int:
    """Rounds with at least one pick: the rounds ws_accumulate_grads runs."""
    return int((assignment >= 0).any(dim=1).sum())


def phase_sched(dev):
    """deepseek-v2 at full width, 1 layer, both ws kernels, its step's
    gradients accumulated by the work-stealing rounds (repro_torch.sched):
    the schedule on the card against the CPU; each mode's step against the
    plain full-batch step (the row-separable loss), the no-division control;
    launches a round; then 3 train(ws_mode="ws-wmult") steps."""
    from repro_torch.configs.deepseek_v2_236b import CONFIG
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import _skewed_tails, train
    from repro_torch.models import ShapeConfig, init_params, loss_fn
    from repro_torch.optim import tree_leaves
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.sched import MODES, schedule_rounds, ws_accumulate_grads
    from repro_torch.sched.accumulate import default_max_rounds

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sched] device memory in use before init: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    c = SCHED
    cfg = CONFIG.replace(n_layers=1, moe_dispatch="ws", moe_grad_dispatch="ws")
    rows, seq, n_w = c["rows"], c["seq"], c["n_workers"]
    n_tasks = rows  # one row a task
    params = init_params(cfg, seed=SEED, device=dev)
    flat = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, ShapeConfig("custom", "train", seq, rows), 0, n_rows=rows, seed=SEED).items()}
    tasks = {k: v.reshape((n_tasks, 1) + v.shape[1:]) for k, v in flat.items()}
    tails = torch.tensor(c["tails"])
    phase_launches = dict.fromkeys(STEP_LAUNCHES, 0)
    phase_rounds = 0  # the rounds behind phase_launches

    # the schedule on the card, every mode, against the same call on the CPU
    sched = {}
    for mode in MODES:
        mr = default_max_rounds(n_tasks, n_w, mode)
        for sync_every in (1, 3):
            cpu = schedule_rounds(tails, n_w, mode, sync_every, mr, n_tasks)
            card = schedule_rounds(tails.to(dev), n_w, mode, sync_every, mr, n_tasks)
            if not all(a.device == dev or a.device.type == dev.type for a in card):
                raise AssertionError(f"{mode}: the schedule left the card")
            if not all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)):
                raise AssertionError(f"{mode}, sync_every {sync_every}: the schedule on the "
                                     f"card differs from the CPU's: {cpu} {card}")
            if sync_every == 1:
                sched[mode] = cpu
    log(f"[sched] the schedule on the card equals the CPU's for every mode at sync_every 1 "
        f"and 3 (tails {list(c['tails'])}, {n_w} workers)")

    def flat_loss(p, fl, row_w):
        return loss_fn(p, cfg, fl, row_weights=row_w)[0]

    def ws_step(mode, acc_dtype=None):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, aux = ws_accumulate_grads(flat_loss, params, tasks, tails, n_workers=n_w,
                                               mode=mode, flat_loss=True, acc_dtype=acc_dtype)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {n: launches[n] for n in STEP_LAUNCHES}
        for n in got:
            phase_launches[n] += got[n]
        return loss, grads, aux, secs, got

    modes = {}
    with row_separable_loss():
        with plain_versions():
            loss_p, _, g_p = loss_and_grads(params, cfg, flat)
        with plain_versions(), moe_output_moved_one_ulp(SEED):
            loss_u, _, g_u = loss_and_grads(params, cfg, flat)
        # the cascade: a gradient's distance when the MoE output moves one
        # bf16 ulp (the train phase's one-ulp distance); acc_ulp: every
        # element of the plain gradient moved one bf16 ulp.  The step sums
        # its R rounds in bf16, the parameters' dtype (the reference's
        # zeros_like(params)): each of the R - 1 additions rounds every
        # element once, within half an ulp (rms ulp / sqrt(12)), independent
        # of each other and of the cascade, so the yardstick of an R-round
        # step adds sqrt((R - 1) / 12) acc_ulp to the cascade in quadrature.
        # The same rounds summed in fp32 (acc_dtype) are held to the cascade
        # alone: what the rounds' kernels compute, without the bf16 sum.
        cascade = {n: float((u.float() - p.float()).norm())
                   for n, u, p in zip(_paths(g_p), tree_leaves(g_u), tree_leaves(g_p))}
        acc_ulp = {n: float((one_ulp(p, SEED).float() - p.float()).norm())
                   for n, p in zip(_paths(g_p), tree_leaves(g_p))}

        def yard_for(rounds):
            return {n: float(np.hypot(cascade[n], np.sqrt((rounds - 1) / 12) * acc_ulp[n]))
                    for n in cascade}

        loss_yard = abs(float(loss_u) - float(loss_p))
        del g_u
        missed = []  # every mode is read before a miss is raised
        for mode in MODES:
            assignment, counts, _ = sched[mode]
            rounds = _rounds_run(assignment)
            dup = int(counts.sum() - (counts > 0).sum())
            want = {n: rounds * STEP_LAUNCHES[n] for n in STEP_LAUNCHES}
            loss_k, g_k, aux, secs, got = ws_step(mode)
            if got != want:
                raise AssertionError(f"{mode}: launches {got}, want {rounds} rounds x "
                                     f"{STEP_LAUNCHES}")
            if not (torch.equal(aux["counts"].cpu(), counts) and float(aux["coverage"]) == 1.0):
                raise AssertionError(f"{mode}: counts {aux['counts']}, coverage {aux['coverage']}")
            worst, name, rel = _ulp_distances(g_k, g_p, yard_for(rounds))
            worst_c, name_c, _ = _ulp_distances(g_k, g_p, cascade)
            loss_err = abs(float(loss_k) - float(loss_p))
            del g_k
            _, g_w, _, secs_w, got_w = ws_step(mode, acc_dtype=torch.float32)
            if got_w != want:
                raise AssertionError(f"{mode}, fp32 accumulator: launches {got_w}, want {want}")
            worst_w, name_w, _ = _ulp_distances(g_w, g_p, cascade)
            del g_w
            phase_rounds += 2 * rounds
            log(f"[sched] {mode}: {rounds} rounds run, {dup} duplicate picks, sum(counts) "
                f"{int(counts.sum())} for {n_tasks} tasks, {secs:.2f} s, launches {got}; loss "
                f"{float(loss_k):.6f} against the plain full-batch step's {float(loss_p):.6f} "
                f"(|diff| {loss_err:.3g} <= {STEP_LOSS_ATOL}; the one-ulp move {loss_yard:.3g}); "
                f"gradients: worst {name} at {worst:.3g} one-ulp distances of {rounds} bf16 "
                f"rounds (<= {STEP_ULP_SLACK}; against the cascade alone {name_c} at "
                f"{worst_c:.3g}), largest distance {rel:.3g} of a gradient's norm; the rounds "
                f"summed in fp32 ({secs_w:.2f} s): worst {name_w} at {worst_w:.3g} of the "
                f"cascade alone (<= {STEP_ULP_SLACK})")
            if not (loss_err <= STEP_LOSS_ATOL and worst <= STEP_ULP_SLACK
                    and worst_w <= STEP_ULP_SLACK):
                missed.append(mode)
            modes[mode] = dict(rounds=rounds, duplicate_picks=dup, sum_counts=int(counts.sum()),
                               seconds=secs, launches=got, loss_vs_plain=loss_err,
                               grad_vs_plain_ulp_distances=worst,
                               grad_vs_plain_cascade_distances=worst_c, grad_vs_plain_rel=rel,
                               fp32_acc_cascade_distances=worst_w, fp32_acc_seconds=secs_w)
        if missed:
            raise AssertionError(f"{missed}: the ws step differs from the full-batch step")
        if modes["ws-wmult"]["duplicate_picks"] <= 0:
            raise AssertionError("ws-wmult picked no duplicate at tails "
                                 f"{list(c['tails'])}: the check cannot see the 1/count division")
        # the control: the extracted rows with their duplicates, each weight 1
        # (a scheduler without the multiplicity division), as plain steps of
        # n_w rows (a routing group holds at most 1024 tokens), each weighted
        # by its share of the rows: the loss is a sum over rows
        assignment = sched["ws-wmult"][0]
        picked = assignment[assignment >= 0].to(torch.int64)
        g_c, loss_c = None, 0.0
        for part in picked.split(n_w):
            share = part.numel() / picked.numel()
            with plain_versions():
                lc, _, gc_ = loss_and_grads(
                    params, cfg, {k: v.index_select(0, part.to(dev)) for k, v in flat.items()})
            loss_c += share * float(lc)
            if g_c is None:
                g_c = [g.mul_(share) for g in tree_leaves(gc_)]
            else:
                for a, g in zip(g_c, tree_leaves(gc_)):
                    a.add_(g, alpha=share)
            del gc_
        # against the loosest mode's yardstick
        it = iter(g_c)
        ctl, ctl_name, ctl_rel = _ulp_distances(
            _map(g_p, lambda _: next(it)), g_p, yard_for(max(m["rounds"] for m in modes.values())))
        del g_c, it
        log(f"[sched] control (ws-wmult's {picked.numel()} extracted rows, duplicates kept, "
            f"each weight 1): worst {ctl_name} at {ctl:.3g} one-ulp distances (must be > "
            f"{STEP_ULP_SLACK}), largest distance {ctl_rel:.3g} of a gradient's norm, loss "
            f"{loss_c:.6f}")
        if not ctl > STEP_ULP_SLACK:
            raise AssertionError(f"the no-division control came within {STEP_ULP_SLACK} one-ulp "
                                 "distances: the check cannot see the 1/count correction")
        del g_p
    gc.collect()
    torch.cuda.empty_cache()

    # 3 optimizer steps through train(ws_mode="ws-wmult"), counted from 0
    snaps, step_s, metrics, peaks = [], [], [], []

    def on_step(step, state, m, seconds):
        snaps.append({n: launches[n] for n in STEP_LAUNCHES})
        step_s.append(seconds)
        metrics.append(m)
        peaks.append(torch.cuda.max_memory_allocated())

    in_use = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, losses = train("deepseek-v2-236b", smoke=False, n_layers=1, steps=c["train_steps"],
                      rows=rows, seq=seq, moe_dispatch="ws", moe_grad_dispatch="ws",
                      ws_mode="ws-wmult", n_workers=n_w, skew=c["skew"], seed=SEED, device=dev,
                      params=params, on_step=on_step, log_every=1)
    for n in STEP_LAUNCHES:
        phase_launches[n] += launches[n]
    steps = [{n: b[n] - (a[n] if a else 0) for n in b} for a, b in zip([None] + snaps, snaps)]
    rounds = [_rounds_run(schedule_rounds(
        torch.from_numpy(_skewed_tails(n_tasks, n_w, s, c["skew"])), n_w, "ws-wmult", 1,
        default_max_rounds(n_tasks, n_w, "ws-wmult"), n_tasks)[0]) for s in range(len(steps))]
    want = [{n: r * STEP_LAUNCHES[n] for n in STEP_LAUNCHES} for r in rounds]
    phase_rounds += sum(rounds)
    cov = [m["ws_coverage"] for m in metrics]
    if steps != want:
        raise AssertionError(f"launches per ws train step {steps}, want {want} ({rounds} rounds)")
    if len(losses) != c["train_steps"] or not all(np.isfinite(losses)) or cov != [1.0] * len(cov):
        raise AssertionError(f"ws train losses {losses}, coverage {cov}")
    peak = max(peaks)
    log(f"[sched] {len(losses)} train(ws_mode='ws-wmult', skew {c['skew']}) steps: losses "
        f"{losses}, ws_coverage {cov}, extractions {[m['ws_extractions'] for m in metrics]}, "
        f"rounds {rounds}, step seconds {[round(s, 3) for s in step_s]}, peak device memory "
        f"{peak / 1e9:.2f} GB ({in_use / 1e9:.2f} GB in use before train()), launches per step "
        f"{steps}")
    per_round = {n: phase_launches[n] / phase_rounds for n in STEP_LAUNCHES}
    log(f"[sched] launches a round, counted: {per_round} ({phase_launches} in {phase_rounds} "
        f"rounds)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(model=f"{cfg.name} (depth 1, ws_mode train)", modes=modes,
                control_ulp_distances=ctl, losses=losses,
                step_s=step_s, rounds=rounds, ws_coverage=cov, peak_bytes=peak,
                step_peak_bytes=peaks, in_use_before_bytes=in_use, launches=phase_launches,
                launches_per_step=steps, launches_per_round=per_round)


# ---------------------------------------------------------------------------
# the unified engine step


# llama3.2-3b in fp32 at full width, all 28 layers (14.43 GB), at the serving
# decode shape: 4 slots of 1024 positions, the live lengths of decode_inputs,
# and a folded prompt of 100 tokens (ragged q blocks of 32).  Serving prompts
# are 16-128 tokens: a fold is a GEMM over every weight on ONE SM (8 rows a
# weight read), seconds per prompt where the split path's prefill is cuBLAS.
UNIFIED = dict(B=4, cap=1024, Lp=100, P=8, requests=8, prompt_lens=(16, 129), max_new=8)
# Kernel against plain version, and against the split fp32 step: the same
# fp32 math summed in another order (k-slices of 4 or 2 and 8-row blocks in
# the kernel, ATen's own blocking in the plain and split steps) over
# 3072- and 8192-term dot products, 28 layers deep.  A few ulps a product,
# compounding through the residual stream, stays far below 1e-4 of the
# largest logit; a wrong phase (a missing residual, an unnormalised tile, a
# mis-roped row) moves logits by O(1).
UNIFIED_RTOL = 1e-4
FP32_FLOPS = 67e12             # H100 SXM dense fp32 outside the tensor cores


def _rel(a, b):
    """max |a - b| over max(1, max |b|)."""
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


def _unified_bound(params, cfg, lengths, R, n_logit_rows, Lp):
    """The least time of one unified step: every weight read once, the live
    K/V rows read once, the new rows and the logits written once (bytes); its
    products over the fp32 peak (operations)."""
    d, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    Hkv, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    layer = sum(t.numel() for t in _leaves(params["layers"]))
    unembed = params["unembed"].numel()
    live = int(np.sum(lengths))
    kv_row = 2 * Hkv * hd * 4 * L
    by = ((layer + unembed + d) * 4 + R * d * 4 + live * kv_row + R * kv_row
          + n_logit_rows * V * 4)
    ops = (2 * layer * R + 2 * unembed * n_logit_rows + 4 * live * H * hd * L
           + 2 * Lp * Lp * H * hd * L)
    byte_ms, ops_ms = by / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return max(byte_ms, ops_ms), ("bytes" if byte_ms >= ops_ms else "operations"), by, ops


def _families(rep, state=None):
    """Extractions and their tile-slot costs per task family of a traced
    unified launch (a report, or a result and its state)."""
    from repro_torch.pallas_ws.tasks import family_of
    from repro_torch.wstrace import EV_COST, EV_OP, WSTrace

    res, state = (rep.res, rep.state) if state is None else (rep, state)
    ev = WSTrace.from_run(state, res).events
    out = {}
    for op in np.unique(ev[:, EV_OP]):
        mine = ev[ev[:, EV_OP] == op]
        n, cost = out.get(family_of(int(op)).name, (0, 0))
        out[family_of(int(op)).name] = (n + len(mine), cost + int(mine[:, EV_COST].sum()))
    return {f: f"{n} events, {cost} tile-slots" for f, (n, cost) in sorted(out.items())}


def _check_unified_free(model, rep, logits, lockstep_logits):
    """A traced free step (one launch a stage) under SafetyChecker's
    free-mode reading, its logits against lockstep's."""
    from repro_torch.chaos import SafetyChecker, single_launch

    scale = max(1.0, float(lockstep_logits.abs().max()))
    report = SafetyChecker().check(single_launch(rep.state, rep.res), n_tasks=rep.n_tasks,
                                   normalized=logits, oracle_normalized=lockstep_logits,
                                   rtol=0, atol=UNIFIED_RTOL * scale)
    _report("ws_unified", f"fault-free free step ({model}, {rep.launches} launches, "
            f"{len(rep.trace_stream)} events: {_families(rep)})", report)


def _unified_helpers(tag, params, cfg, caches, tok, pos, ptok, run):
    """The walker and its helpers: each step (decode, and with the fold) at
    H = 0 (one CTA), 1 and the largest H, its logits (and the prompt's)
    bit-equal across H; at the largest H the walker's requests (against
    unified_kernel.expected_requests) and the time it waited on them, and
    the step's time at H = 0 (the one-CTA fallback, for the record)."""
    from repro_torch.models.unified import plan_step, run_step
    from repro_torch.pallas_ws import unified_kernel as U

    dev = tok.device
    top = torch.cuda.get_device_properties(dev).multi_processor_count - 1
    rep = {"helpers": top, "helpers_tested": [0, 1, top]}
    for name, kw in (("decode", {}), ("fold", dict(prefill_tokens=ptok))):
        outs, requests = [], []
        for H in (0, 1, top):
            plan = plan_step(params, cfg, caches(), tok, pos, **kw)
            res, _ = run_step(params, cfg, plan, mode="lockstep", plain=False, helpers=H, **run)
            outs.append(plan.bufs["logits"].clone())
            if "logp" in plan.bufs:
                outs[-1] = torch.cat([outs[-1], plan.bufs["logp"]])
            st = U.last_stats(dev)
            requests.append(st["requests"])
            if H == top:
                # the routing buffers hold the last layer's: a deeper MoE
                # step's requests cannot be counted from them
                if plan.g.E and plan.g.L != 1:
                    raise AssertionError(f"{tag}: the walker's requests are counted from one "
                                         f"layer's routing, and this MoE step has {plan.g.L}")
                rl = [plan.bufs["rl"].cpu()] if plan.g.E else []
                want = U.expected_requests(plan.g, res.mult.cpu().numpy(), rl)
                rep[f"{name}_walker_wait_ms"] = st["wait_ns"] / 1e6
                rep[f"{name}_walker_ms"] = st["walk_ns"] / 1e6
                rep[f"{name}_walker_split_ms"] = {
                    k: st[f"{k}_ns"] / 1e6 for k in ("attention", "expert", "glue")}
                rep[f"{name}_walker_split_ms"]["scheduler"] = (
                    st["walk_ns"] - st["attention_ns"] - st["expert_ns"] - st["glue_ns"]) / 1e6
                rep[f"{name}_helper1_strips_ms"] = st["helper_ns"] / 1e6
            del plan, res
        if requests != [0, want, want]:
            raise AssertionError(f"{tag} {name}: the walker posted {requests} requests at "
                                 f"H = 0, 1, {top}; want 0, {want}, {want}")
        rep[f"{name}_requests"] = want
        same = all(torch.equal(o, outs[0]) for o in outs[1:])
        rep[f"{name}_bit_equal_across_helpers"] = same
        if not same:
            raise AssertionError(f"{tag} {name}: logits differ across H = 0, 1, {top}")
    plan = plan_step(params, cfg, caches(), tok, pos)

    def one_cta(_):
        for b in ("att", "attp", "yr"):
            if b in plan.bufs:
                plan.bufs[b].zero_()
        run_step(params, cfg, plan, mode="lockstep", plain=False, helpers=0, **run)

    one_cta(0)
    torch.cuda.synchronize()
    rep["one_cta_ms"] = _event_ms(one_cta, 2)
    log(f"[{tag}] walker and {top} helpers: logits bit-equal at H = 0, 1, {top} (decode and "
        f"fold); the walker posted {rep['decode_requests']} requests a decode step "
        f"(expected_requests), {rep['fold_requests']} with the fold, and waited on them "
        f"{rep['decode_walker_wait_ms']:.3f} of {rep['decode_walker_ms']:.3f} ms "
        f"({rep['fold_walker_wait_ms']:.3f} of {rep['fold_walker_ms']:.3f} ms with the fold); "
        f"the walk by body (ms, waits in glue and expert): decode "
        f"{rep['decode_walker_split_ms']}, fold {rep['fold_walker_split_ms']}; helper 1 on "
        f"its strips {rep['decode_helper1_strips_ms']:.3f} ms (fold "
        f"{rep['fold_helper1_strips_ms']:.3f}); "
        f"one CTA (H = 0) takes {rep['one_cta_ms']:.2f} ms a decode step")
    del plan
    return rep


def phase_unified(dev):
    """llama3.2-3b in fp32 at full width through the unified step: kernel
    against plain version (decode and a folded prompt), against the split
    fp32 step, free mode's per-stage launches, times, then 2 replicas of the
    unified engine serving 8 requests against the split engine's streams."""
    from repro_torch.configs.llama3_2_3b import CONFIG
    from repro_torch.models import (
        Caches, KVCache, decode_step_unified, decode_step_ws, init_params,
        plain_decode_step_unified,
    )
    from repro_torch.models.unified import plan_step, run_step
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    gc.collect()
    torch.cuda.empty_cache()
    c = UNIFIED
    cfg = CONFIG.replace(dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[unified] {cfg.name} fp32: {n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB; "
        f"param_count(), without the norms, {cfg.param_count():,}), initialised in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(16, c["cap"] + 1, size=c["B"])
    lengths[0] = c["cap"]
    pos = lengths - 1
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (c["B"], 1))).to(dev)
    ptok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, c["Lp"]))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (cfg.n_layers, c["B"], c["cap"], cfg.n_kv_heads, cfg.hd)
    k0 = torch.randn(shape, generator=gen, device=dev)
    v0 = torch.randn(shape, generator=gen, device=dev)

    def caches():
        return Caches(kv=KVCache(k0.clone(), v0.clone()))

    V = cfg.vocab_size
    errs, out = [], {}
    for fold in (False, True):
        # the decode step runs traced: its one ring stream is compared too
        kw = dict(prefill_tokens=ptok) if fold else dict(trace=True)
        name = "fold" if fold else "decode"
        lk, ck, rk = decode_step_unified(params, cfg, caches(), tok, pos, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, cp, rp = plain_decode_step_unified(params, cfg, caches(), tok, pos, **kw)
        torch.cuda.synchronize()
        out[f"plain_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        ik, ip = _ints(rk.res), _ints(rp.res)
        for n in ik:
            if not np.array_equal(ik[n], ip[n]):
                raise AssertionError(f"unified {name}: lockstep {n} differs from the plain version")
        e = {"logits": _rel(lk, lp), "kc": _rel(ck.kv.k, cp.kv.k), "vc": _rel(ck.kv.v, cp.kv.v)}
        if fold:
            e.update(prefill_logits=_rel(rk.prefill_logits, rp.prefill_logits),
                     prefill_k=_rel(rk.prefill_kv.k, rp.prefill_kv.k),
                     prefill_v=_rel(rk.prefill_kv.v, rp.prefill_kv.v))
        abs_err = float((lk - lp).abs().max())
        errs.append(abs_err)
        if not (max(e.values()) <= UNIFIED_RTOL and bool(torch.isfinite(lk[:, :V]).all())):
            raise AssertionError(f"unified {name} against the plain version: {e} > {UNIFIED_RTOL}")
        log(f"[unified] {name} step (lengths {lengths.tolist()}"
            + (f", prompt {c['Lp']} tokens" if fold else "") + f", {rk.n_tasks} tasks, "
            f"{rk.rounds} rounds, {rk.launches} launch): integer arrays "
            + ("" if fold else f"and the traced ring ({len(rk.trace_stream)} events: "
               f"{_families(rk)}) ")
            + "bit-equal to the plain version; relative errors "
            + ", ".join(f"{n} {v:.3g}" for n, v in e.items())
            + f" (<= {UNIFIED_RTOL}); logits max_abs_err {abs_err:.3g}")
        del ck, cp, rk, rp
    ls, _ = decode_step_ws(params, cfg, caches(), tok, pos)
    lu, _, _ = decode_step_unified(params, cfg, caches(), tok, pos)
    split_err = _rel(lu, ls)
    log(f"[unified] against the split fp32 step (decode_step_ws, ws_attention): relative "
        f"logit error {split_err:.3g} (<= {UNIFIED_RTOL}), argmax agree "
        f"{int((lu[:, :V].argmax(-1) == ls[:, :V].argmax(-1)).sum())}/{c['B']}")
    if not split_err <= UNIFIED_RTOL:
        raise AssertionError("the unified step strays from the split step")
    lf, _, rf = decode_step_unified(params, cfg, caches(), tok, pos, mode="free", trace=True)
    torch.cuda.synchronize()
    mult = rf.res.mult[:rf.n_tasks].cpu()
    free_err = _rel(lf, lu)
    _check_unified_free("llama3.2-3b fp32", rf, lf[:, :V], lu[:, :V])
    log(f"[unified] free mode: {rf.launches} per-stage launches, every task run (mult in "
        f"[{int(mult.min())}, {int(mult.max())}], sum(mult)/tasks "
        f"{float(mult.sum()) / rf.n_tasks:.3f}), logits within {free_err:.3g} of lockstep")
    if rf.launches != 2 + 3 * cfg.n_layers or not bool((mult >= 1).all()) \
            or not free_err <= UNIFIED_RTOL:
        raise AssertionError("free-mode per-stage launches failed")

    run = dict(steal=True, steal_policy="cost", n_programs=c["P"])
    hx = _unified_helpers("unified", params, cfg, caches, tok, pos, ptok, run)

    # times: the step's launches alone (plan built outside), the attention
    # buffers zeroed before each lockstep launch (tiles accumulate there)
    times = {}
    for name, kw, mode, n in (("ms", {}, "lockstep", 3), ("fold_ms", dict(prefill_tokens=ptok),
                                                          "lockstep", 2),
                              ("free_ms", {}, "free", 3), ("free_traced_ms", {}, "free", 3)):
        plan = plan_step(params, cfg, caches(), tok, pos, **kw)

        def step(_, plan=plan, mode=mode, traced=name == "free_traced_ms"):
            plan.bufs["att"].zero_()
            if "attp" in plan.bufs:
                plan.bufs["attp"].zero_()
            run_step(params, cfg, plan, mode=mode, trace=traced, **run)

        step(0)
        torch.cuda.synchronize()
        times[name] = _event_ms(step, n)
        del plan
    cs = caches()
    decode_step_ws(params, cfg, cs, tok, pos)
    torch.cuda.synchronize()
    times["split_step_ms"] = _event_ms(lambda _: decode_step_ws(params, cfg, cs, tok, pos), 5)
    del cs
    bound, bound_by, by, ops = _unified_bound(params, cfg, lengths, c["B"], c["B"], 0)
    fbound, fbound_by, fby, fops = _unified_bound(params, cfg, lengths, c["B"] + c["Lp"],
                                                  c["B"] + 1, c["Lp"])
    TRACED.setdefault("ws_unified", {})["llama3.2-3b fp32"] = dict(
        free_ms_untraced=times["free_ms"], free_ms_traced=times["free_traced_ms"],
        at="a free step, 86 launches, the traced one with its rings merged on the host",
        card=card_line())
    log(f"[times] ws_unified lockstep decode step {times['ms']:.2f} ms (1 launch), with a "
        f"{c['Lp']}-token fold {times['fold_ms']:.2f} ms, free mode {times['free_ms']:.2f} ms "
        f"(traced {times['free_traced_ms']:.2f} ms) ({rf.launches} launches); bound {bound:.4f} ms ({bound_by}: {by} B, {ops} flops), "
        f"fold bound {fbound:.4f} ms ({fbound_by}: {fby} B, {fops} flops); plain version "
        f"{out['plain_decode_ms']:.1f} ms (fold {out['plain_fold_ms']:.1f} ms); split fp32 "
        f"step (decode_step_ws) {times['split_step_ms']:.2f} ms; no single PyTorch call "
        "computes an engine step, so there is no library time; first version "
        + _first_unified("llama"))

    # serving: 2 replicas of the unified engine, then the split engine, on
    # the same requests
    lens = rng.integers(*c["prompt_lens"], size=c["requests"])
    prompts = [rng.integers(0, V, size=int(n)).astype(np.int32) for n in lens]

    def serve(unified):
        front = WorkStealingFrontend(lambda: ContinuousBatcher(
            params, cfg, slots=c["B"], capacity=c["cap"], unified_step=unified), n_replicas=2)
        for rid, p in enumerate(prompts):
            front.submit(0, Request(rid=rid, tokens=p, max_new=c["max_new"]))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = front.run(max_iters=1000)
        torch.cuda.synchronize()
        counts = {n: launches[n] for n in launches}
        return front, done, time.perf_counter() - t0, counts

    front, done, wall, counts = serve(True)
    stats = front.stats()
    steps = sum(s["steps"] for s in stats["batchers"])
    if sorted(done) != list(range(len(prompts))) or front.rejected:
        raise AssertionError(f"completed {sorted(done)}, rejected {sorted(front.rejected)}")
    for r in done.values():
        if len(r.out) != c["max_new"] or not all(0 <= t < V for t in r.out):
            raise AssertionError(f"request {r.rid} produced {r.out}")
    degr = [b.degradations for b in front.batchers]
    if any(degr):
        raise AssertionError(f"unified steps fell back to the split path: {degr}")
    if counts != {"ws_attention": 0, "ws_expert": 0, "ws_expert_grad": 0, "ws_unified": steps} \
            or steps == 0:
        raise AssertionError(f"launches {counts}, want ws_unified == {steps} steps and no other")
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    tokens = sum(len(r.out) for r in done.values())
    serving = {
        "model": f"{cfg.name} fp32 unified", "requests": len(done),
        "prompt_tokens": int(lens.sum()), "new_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "steps": steps, "launches_per_step": 1,
        "step_ms_p50": float(np.percentile(lat, 50)),
        "step_ms_p99": float(np.percentile(lat, 99)),
        "stolen": stats["totals"]["stolen"], "launches": counts,
    }
    log(f"[unified] serving: {len(done)} requests ({int(lens.sum())} prompt tokens), {tokens} "
        f"new tokens in {wall:.2f} s ({tokens / wall:.2f} tokens/s incl. folded prefills); "
        f"{steps} unified steps, 1 launch each (ws_unified {counts['ws_unified']}, no other "
        f"kernel), step p50 {serving['step_ms_p50']:.2f} ms p99 {serving['step_ms_p99']:.2f} ms; "
        f"stolen {serving['stolen']}; degradations none")
    del front
    _, done_s, wall_s, _ = serve(False)
    split_streams = _streams(done_s)
    differ = _fp32_streams_held("unified", params, cfg, prompts, _streams(done),
                                split_streams, "the split engine")
    log(f"[unified] greedy streams: {len(done) - differ}/{len(done)} equal to the split "
        f"engine's ({wall_s:.2f} s)")
    serving.update(split_wall_s=wall_s, streams_equal=len(done) - differ)
    del k0, v0
    gc.collect()
    torch.cuda.empty_cache()
    serving["watchdog"] = _watchdog_drills(params, cfg, prompts[:c["B"]], c)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs), split_rel_err=split_err, free_rel_err=free_err,
                free_launches_per_step=rf.launches,
                free_mult_per_task=float(mult.sum()) / rf.n_tasks, bound_ms=bound,
                bound_by=bound_by, fold_bound_ms=fbound, fold_bound_by=fbound_by,
                plain_ms=out["plain_decode_ms"], plain_fold_ms=out["plain_fold_ms"],
                library_ms=None, handoff=hx, **times), serving


# kimi-k2 in fp32 at full width, cut to 1 layer (77.69 GB of weights): 4
# slots of 1024 positions at fixed ragged lengths, a 64-token fold, and
# serving prompts of 8-64 tokens.
UNIFIED_MOE = dict(B=4, cap=1024, lengths=(1024, 658, 531, 288), Lp=64, P=8, requests=8,
                   prompt_lens=(8, 65), max_new=8)
# A top-8 choice whose margin over the 9th probability is under this share
# of the 8th is a near-tie: the kernel's and the plain version's router
# logits, the same 7168-term fp32 products summed in another order, may
# order it either way.
NEAR_TIE = 1e-5


def _moe_bound(params, cfg, lengths, R, n_logit_rows, Lp, experts):
    """The least time of one MoE unified step: every weight but the routed
    experts read once, the weights of the ``experts`` this step's tokens chose
    read once, the live K/V rows read once, the new rows and the logits
    written once (bytes); its products over the fp32 peak (operations)."""
    d, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    Hkv, hd, H, k = cfg.n_kv_heads, cfg.hd, cfg.n_heads, cfg.top_k
    moe = params["layers"]["moe"]
    expert = moe["we_g"][0, 0].numel() * 3
    dense = sum(t.numel() for t in _leaves(params["layers"])) - expert * cfg.n_experts * L
    unembed = params["unembed"].numel()
    live = int(np.sum(lengths))
    kv_row = 2 * Hkv * hd * 4 * L
    by = ((dense + expert * experts + unembed + d) * 4 + R * d * 4 + live * kv_row
          + R * kv_row + n_logit_rows * V * 4)
    ops = (2 * dense * R + 2 * expert * R * k + 2 * unembed * n_logit_rows
           + 4 * live * H * hd * L + 2 * Lp * Lp * H * hd * L)
    byte_ms, ops_ms = by / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return max(byte_ms, ops_ms), ("bytes" if byte_ms >= ops_ms else "operations"), by, ops


def _plain_routing(params, cfg, xf):
    """The plain router on the rows of ``xf`` (layer 0): each row's top-k
    experts in ascending order, and whether its top-k boundary is a
    near-tie (the k-th probability within NEAR_TIE of the next)."""
    from repro_torch.models.moe import router_topk

    k = cfg.top_k
    probs, _, idx, _ = router_topk(xf[None], {"router": params["layers"]["moe"]["router"][0]},
                                   cfg)
    top = torch.sort(probs[0], dim=-1, descending=True).values
    tie = (top[:, k - 1] - top[:, k]) < NEAR_TIE * top[:, k - 1]
    return torch.sort(idx[0], dim=-1).values.cpu(), tie.cpu()


def phase_unified_moe(dev):
    """kimi-k2 in fp32 at full width (1 layer) through the unified step: the
    kernel against its plain version (decode and a 64-token fold, routing
    buffers included), against the split fp32 step, free mode, times, then 2
    replicas of the unified engine serving 8 requests."""
    from repro_torch.configs.kimi_k2_1t_a32b import CONFIG
    from repro_torch.models import Caches, KVCache, decode_step_unified, decode_step_ws, \
        init_params, prefill
    from repro_torch.models.unified import plan_step, run_step
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = UNIFIED_MOE
    cfg = CONFIG.replace(n_layers=1, dtype="float32", moe_dispatch="ws")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[unified_moe] {cfg.name} depth 1 (of {CONFIG.n_layers}) in fp32 at full width: "
        f"{n_bytes / 1e9:.2f} GB of weights ({n_bytes / 2**30:.2f} GiB), initialised in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"in use of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB")

    rng = np.random.default_rng(SEED)
    lengths = np.asarray(c["lengths"])
    pos = lengths - 1
    V = cfg.vocab_size
    tok = torch.from_numpy(rng.integers(0, V, (c["B"], 1))).to(dev)
    ptok = torch.from_numpy(rng.integers(0, V, (1, c["Lp"]))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (cfg.n_layers, c["B"], c["cap"], cfg.n_kv_heads, cfg.hd)
    k0 = torch.randn(shape, generator=gen, device=dev)
    v0 = torch.randn(shape, generator=gen, device=dev)

    def caches():
        return Caches(kv=KVCache(k0.clone(), v0.clone()))

    run = dict(steal=True, steal_policy="cost", n_programs=c["P"])
    errs, out, flipped = [], {}, {}
    for fold in (False, True):
        kw = dict(prefill_tokens=ptok) if fold else {}
        name = "fold" if fold else "decode"
        traced = not fold  # the decode step's ring stream is compared too
        plan_k = plan_step(params, cfg, caches(), tok, pos, **kw)
        res_k, _ = run_step(params, cfg, plan_k, mode="lockstep", plain=False, trace=traced,
                            **run)
        plan_p = plan_step(params, cfg, caches(), tok, pos, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_p, _ = run_step(params, cfg, plan_p, mode="lockstep", plain=True, trace=traced,
                            **run)
        torch.cuda.synchronize()
        out[f"plain_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        ik, ip = _ints(res_k), _ints(res_p)
        for n in ik:
            if not np.array_equal(ik[n], ip[n]):
                raise AssertionError(f"unified_moe {name}: lockstep {n} differs from the plain "
                                     "version")
        bk, bp, g = plan_k.bufs, plan_p.bufs, plan_k.g
        # routing: the kernel's top-8 sets against the plain version's
        sel_p, ties = _plain_routing(params, cfg, bp["xf"])
        differ = (torch.sort(bk["sidx"], dim=-1).values.cpu() != sel_p).any(-1)
        if bool((differ & ~ties).any()):
            raise AssertionError(f"unified_moe {name}: the kernel routes rows "
                                 f"{torch.nonzero(differ & ~ties).flatten().tolist()} otherwise "
                                 "than the plain version, with no near-tie")
        flipped[name] = torch.nonzero(differ).flatten().tolist()
        if not flipped[name]:
            for n in ("tok", "e", "rl"):
                if not torch.equal(bk[n], bp[n]):
                    raise AssertionError(f"unified_moe {name}: routing buffer {n} differs")
            gate_err = float((bk["gate"] - bp["gate"]).abs().max())
            if not gate_err <= UNIFIED_RTOL:
                raise AssertionError(f"unified_moe {name}: gates differ by {gate_err}")
        keep = [r for r in range(g.B) if r not in flipped[name]]
        e = {"logits": _rel(bk["logits"][keep], bp["logits"][keep]),
             "kc": _rel(bk["kc"], bp["kc"]), "vc": _rel(bk["vc"], bp["vc"])}
        if fold:
            e.update(prefill_k=_rel(bk["kp"], bp["kp"]), prefill_v=_rel(bk["vp"], bp["vp"]))
            if g.R - 1 not in flipped[name]:
                e["prefill_logits"] = _rel(bk["logp"], bp["logp"])
        abs_err = float((bk["logits"][keep] - bp["logits"][keep]).abs().max())
        errs.append(abs_err)
        if not (max(e.values()) <= UNIFIED_RTOL
                and bool(torch.isfinite(bk["logits"][:, :V]).all())):
            raise AssertionError(f"unified_moe {name} against the plain version: {e} > "
                                 f"{UNIFIED_RTOL}")
        live = int((bk["rl"] > 0).sum())
        log(f"[unified_moe] {name} step (lengths {lengths.tolist()}"
            + (f", prompt {c['Lp']} tokens" if fold else "") + f", {g.n_tasks} tasks, "
            f"{plan_k.rounds} rounds, 1 launch; {live} live of {g.pool_dec + g.pool_pre} pool "
            f"tiles): integer arrays "
            + (f"and the traced ring ({int(res_k.ev_cursor.sum())} events: "
               f"{_families(res_k, plan_k.state)}) " if traced else "")
            + "bit-equal to the plain version; routing (tok, e, rl, gate) "
            + ("equal" if not flipped[name] else f"differs at near-tie rows {flipped[name]}, "
               "left out of the logit comparison")
            + "; relative errors " + ", ".join(f"{n} {v:.3g}" for n, v in e.items())
            + f" (<= {UNIFIED_RTOL}); logits max_abs_err {abs_err:.3g}")
        out[f"experts_{name}"] = len(set(bk["e"][bk["rl"] > 0].tolist()))
        if not fold:
            lu = bk["logits"].clone()
        del plan_k, plan_p, res_k, res_p, bk, bp
    ls, _ = decode_step_ws(params, cfg, caches(), tok, pos)
    keep = [r for r in range(c["B"]) if r not in flipped["decode"]]
    split_err = _rel(lu[keep], ls[keep])
    log(f"[unified_moe] against the split fp32 step (decode_step_ws: ws_attention, ws_expert): "
        f"relative logit error {split_err:.3g} (<= {UNIFIED_RTOL}), argmax agree "
        f"{int((lu[:, :V].argmax(-1) == ls[:, :V].argmax(-1)).sum())}/{c['B']}")
    if not split_err <= UNIFIED_RTOL:
        raise AssertionError("the unified MoE step strays from the split step")
    lf, _, rf = decode_step_unified(params, cfg, caches(), tok, pos, mode="free", trace=True)
    torch.cuda.synchronize()
    mult = rf.res.mult[:rf.n_tasks].cpu()
    free_err = _rel(lf[keep], lu[keep])
    _check_unified_free("kimi-k2 fp32 depth 1", rf, lf[keep, :V], lu[keep, :V])
    log(f"[unified_moe] free mode: {rf.launches} per-stage launches, every task run (mult in "
        f"[{int(mult.min())}, {int(mult.max())}], sum(mult)/tasks "
        f"{float(mult.sum()) / rf.n_tasks:.3f}), logits within {free_err:.3g} of lockstep")
    if rf.launches != 2 + 5 * cfg.n_layers or not bool((mult >= 1).all()) \
            or not free_err <= UNIFIED_RTOL:
        raise AssertionError("free-mode per-stage launches failed")
    hx = _unified_helpers("unified_moe", params, cfg, caches, tok, pos, ptok, run)

    # times: the step's launches alone (plan built outside), the tile buffers
    # zeroed before each lockstep launch (tiles accumulate there)
    times = {}
    for name, kw, mode, n in (("ms", {}, "lockstep", 3),
                              ("fold_ms", dict(prefill_tokens=ptok), "lockstep", 2),
                              ("free_ms", {}, "free", 3), ("free_traced_ms", {}, "free", 3)):
        plan = plan_step(params, cfg, caches(), tok, pos, **kw)

        def step(_, plan=plan, mode=mode, traced=name == "free_traced_ms"):
            for b in ("att", "attp", "yr"):
                if b in plan.bufs:
                    plan.bufs[b].zero_()
            run_step(params, cfg, plan, mode=mode, trace=traced, **run)

        step(0)
        torch.cuda.synchronize()
        times[name] = _event_ms(step, n)
        del plan
    cs = caches()
    decode_step_ws(params, cfg, cs, tok, pos)
    torch.cuda.synchronize()
    times["split_step_ms"] = _event_ms(lambda _: decode_step_ws(params, cfg, cs, tok, pos), 5)
    del cs
    TRACED.setdefault("ws_unified", {})["kimi-k2 fp32 depth 1"] = dict(
        free_ms_untraced=times["free_ms"], free_ms_traced=times["free_traced_ms"],
        at="a free step, 7 launches, the traced one with its rings merged on the host",
        card=card_line())
    experts_dec, experts_fold = out["experts_decode"], out["experts_fold"]
    bound, bound_by, by, ops = _moe_bound(params, cfg, lengths, c["B"], c["B"], 0, experts_dec)
    fbound, fbound_by, fby, fops = _moe_bound(params, cfg, lengths, c["B"] + c["Lp"],
                                              c["B"] + 1, c["Lp"], experts_fold)
    log(f"[times] ws_unified kimi-k2 fp32 lockstep decode step {times['ms']:.2f} ms (1 launch, "
        f"{experts_dec} experts chosen), with a {c['Lp']}-token fold {times['fold_ms']:.2f} ms "
        f"({experts_fold} experts), free mode {times['free_ms']:.2f} ms (traced "
        f"{times['free_traced_ms']:.2f} ms) ({rf.launches} "
        f"launches); bound {bound:.4f} ms ({bound_by}: {by} B, {ops} flops), fold bound "
        f"{fbound:.4f} ms ({fbound_by}: {fby} B, {fops} flops); plain version "
        f"{out['plain_decode_ms']:.1f} ms (fold {out['plain_fold_ms']:.1f} ms); split fp32 "
        f"step (decode_step_ws) {times['split_step_ms']:.2f} ms; no single PyTorch call "
        "computes an engine step, so there is no library time; first version "
        + _first_unified("kimi"))

    # serving: 2 replicas of the unified engine, then the split engine, on
    # the same requests
    lens = rng.integers(*c["prompt_lens"], size=c["requests"])
    prompts = [rng.integers(0, V, size=int(n)).astype(np.int32) for n in lens]

    def serve(unified):
        front = WorkStealingFrontend(lambda: ContinuousBatcher(
            params, cfg, slots=c["B"], capacity=c["cap"], unified_step=unified), n_replicas=2)
        for rid, p in enumerate(prompts):
            front.submit(0, Request(rid=rid, tokens=p, max_new=c["max_new"]))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = front.run(max_iters=1000)
        torch.cuda.synchronize()
        counts = {n: launches[n] for n in launches}
        return front, done, time.perf_counter() - t0, counts

    front, done, wall, counts = serve(True)
    stats = front.stats()
    steps = sum(s["steps"] for s in stats["batchers"])
    if sorted(done) != list(range(len(prompts))) or front.rejected:
        raise AssertionError(f"completed {sorted(done)}, rejected {sorted(front.rejected)}")
    for r in done.values():
        if len(r.out) != c["max_new"] or not all(0 <= t < V for t in r.out):
            raise AssertionError(f"request {r.rid} produced {r.out}")
    degr = [b.degradations for b in front.batchers]
    if any(degr):
        raise AssertionError(f"unified steps fell back to the split path: {degr}")
    if counts != {"ws_attention": 0, "ws_expert": 0, "ws_expert_grad": 0, "ws_unified": steps} \
            or steps == 0:
        raise AssertionError(f"launches {counts}, want ws_unified == {steps} steps and no other")
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    tokens = sum(len(r.out) for r in done.values())
    serving = {
        "model": f"{cfg.name} depth 1 fp32 unified", "requests": len(done),
        "prompt_tokens": int(lens.sum()), "new_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "steps": steps, "launches_per_step": 1,
        "step_ms_p50": float(np.percentile(lat, 50)),
        "step_ms_p99": float(np.percentile(lat, 99)),
        "stolen": stats["totals"]["stolen"], "launches": counts,
    }
    log(f"[unified_moe] serving: {len(done)} requests ({int(lens.sum())} prompt tokens), "
        f"{tokens} new tokens in {wall:.2f} s ({tokens / wall:.2f} tokens/s incl. folded "
        f"prefills); {steps} unified steps, 1 launch each (ws_unified {counts['ws_unified']}, "
        f"no other kernel), step p50 {serving['step_ms_p50']:.2f} ms p99 "
        f"{serving['step_ms_p99']:.2f} ms; stolen {serving['stolen']}; degradations none")
    del front
    _, done_s, wall_s, _ = serve(False)
    differ = 0
    for rid, r in sorted(done.items()):
        want = done_s[rid].out
        if r.out == want:
            continue
        differ += 1
        j = next(i for i, (a, b) in enumerate(zip(r.out, want)) if a != b)
        seq = np.concatenate([prompts[rid], np.asarray(want[:j], np.int32)])
        lg, _ = prefill(params, cfg, {"tokens": torch.from_numpy(seq).to(dev)[None].long()},
                        capacity=len(seq))
        top = torch.topk(lg[0, :V], 2).values
        gap, limit = float(top[0] - top[1]), 2 * UNIFIED_RTOL * max(1.0, float(lg.abs().max()))
        log(f"[unified_moe] request {rid} differs from the split engine first at token {j}: "
            f"top-2 logit gap {gap:.3g} (a near-tie flips when under {limit:.3g})")
        if not gap < limit:
            raise AssertionError(f"request {rid}: unified and split streams differ at token {j} "
                                 f"with a top-2 gap of {gap} >= {limit}")
    peak = torch.cuda.max_memory_allocated()
    seconds = time.perf_counter() - t_phase
    log(f"[unified_moe] greedy streams: {len(done) - differ}/{len(done)} equal to the split "
        f"engine's ({wall_s:.2f} s); peak device memory {peak / 1e9:.2f} GB "
        f"({peak / 2**30:.2f} GiB); phase {seconds:.1f} s")
    serving.update(split_wall_s=wall_s, streams_equal=len(done) - differ,
                   peak_memory_gb=peak / 1e9)
    del params, k0, v0
    gc.collect()
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs), split_rel_err=split_err, free_rel_err=free_err,
                free_launches_per_step=rf.launches,
                free_mult_per_task=float(mult.sum()) / rf.n_tasks, free_max_mult=int(mult.max()),
                bound_ms=bound, bound_by=bound_by, fold_bound_ms=fbound,
                fold_bound_by=fbound_by, plain_ms=out["plain_decode_ms"],
                plain_fold_ms=out["plain_fold_ms"], near_tie_rows=flipped,
                peak_memory_gb=peak / 1e9, seconds=seconds, handoff=hx, **times), serving


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + k + "/")
    else:
        yield prefix.rstrip("/")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _event_ms(fn, n):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


SLEEP_CYCLES = 2_000_000        # ~1 ms: outlasts the host's enqueue of any timed call


def _device_spans(fn, n, before=None):
    """Device ms of each of ``n`` calls ``fn(i)``: each call waits behind a
    sleeping kernel, so the host's launch time is never in the span;
    ``before()`` (if given) runs ahead of the sleep, outside the span."""
    spans = []
    for i in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(i)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return [s_.elapsed_time(e_) for s_, e_ in spans]


def _device_ms(fn, n, before=None):
    """Median of :func:`_device_spans`."""
    return float(np.median(_device_spans(fn, n, before)))


def phase_times(dev):
    import torch.nn.functional as F

    from repro_torch.pallas_ws import (
        decode_queue_state, plain_ws_grid, to_device,
    )
    from repro_torch.pallas_ws import kernel as K

    c = DECODE
    lengths, q, k, v = decode_inputs(np.random.default_rng(SEED), dev)
    state = to_device(decode_queue_state(lengths, c["H"], c["S"], n_programs=c["P"],
                                         bk=c["bk"]), dev)
    q4 = q[:, :, None, :]
    out = torch.zeros((c["B"], c["H"], 1, c["hd"]), dtype=torch.float32, device=dev)
    n_tasks = state.n_tasks
    times = {}
    for mode, traced in (("free", False), ("lockstep", False), ("free", True)):
        rounds = K.default_rounds(decode_queue_state(lengths, c["H"], c["S"],
                                                     n_programs=c["P"], bk=c["bk"]), True)
        n = 20 if mode == "free" else 3
        arrs = _fresh_arrays(state, mode, n + 2)
        rings = (_with_rings(arrs, int(state.tail.sum())) if traced
                 else [K.NO_RING] * (n + 2))

        def launch(i, mode=mode, rounds=rounds, rings=rings):
            K._launch_cuda(arrs[i], q4, k, v, out, mode=mode, rounds=_rounds(mode, rounds),
                           steal=True,
                           policy="cost", compress=False, causal=False, bq=1, bk=c["bk"],
                           scale=c["hd"] ** -0.5, g=c["H"] // c["Hkv"], n_tasks=n_tasks,
                           ring=rings[i])

        launch(n)      # warm-up
        launch(n + 1)
        torch.cuda.synchronize()
        times[mode + ("_traced" if traced else "")] = _event_ms(launch, n)
    TRACED["ws_attention"] = dict(free_ms_untraced=times["free"],
                                  free_ms_traced=times["free_traced"],
                                  at="llama3.2-3b decode shape", card=card_line())

    def plain(_):
        plain_ws_grid(state, q4, k, v, torch.zeros_like(out), bq=1, bk=c["bk"],
                      causal=False, scale=c["hd"] ** -0.5, mode="free")

    plain(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain(1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    mask = (torch.arange(c["S"], device=dev)[None, :] < torch.as_tensor(lengths, device=dev)[:, None])
    mask = mask[:, None, None, :]
    g = c["H"] // c["Hkv"]
    k_rep, v_rep = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)

    def sdpa(_):
        F.scaled_dot_product_attention(q4, k_rep, v_rep, attn_mask=mask)

    sdpa(0)
    torch.cuda.synchronize()
    library_ms = _event_ms(sdpa, 20)

    live = int(np.asarray(lengths).sum())
    kv_bytes = 2 * live * c["Hkv"] * c["hd"] * 2            # K and V, bf16, each row once
    io_bytes = c["B"] * c["H"] * c["hd"] * (2 + 4)          # q in (bf16), out (fp32)
    task_bytes = n_tasks * 8 * 4
    byte_ms = (kv_bytes + io_bytes + task_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * live * c["H"] * c["hd"] / BF16_FLOPS * 1e3
    bound_ms = max(byte_ms, ops_ms)
    log(f"[times] decode B={c['B']} H={c['H']} S={c['S']} lengths {list(map(int, lengths))}: "
        f"kernel free {times['free']:.4f} ms (traced {times['free_traced']:.4f} ms), lockstep "
        f"{times['lockstep']:.4f} ms, bound {bound_ms:.5f} ms ({'bytes' if byte_ms >= ops_ms else 'operations'}: "
        f"{kv_bytes + io_bytes + task_bytes} B), plain version {plain_ms:.2f} ms, "
        f"SDPA yardstick {library_ms:.4f} ms")
    first = {m: FIRST_VERSION_MS[f"ws_attention {m}"] for m in ("free", "lockstep")}
    for m in ("free", "lockstep"):
        log(f"[times] ws_attention {m} {times[m]:.4f} ms (first version: {first[m][0]}-"
            f"{first[m][1]} ms, {first[m][0] / times[m]:.1f}x its fastest), "
            f"{bound_ms / times[m]:.4f} of the bound, {times[m] / library_ms:.2f}x SDPA's "
            f"{library_ms:.4f} ms")
    def free_state(lens, P, partition="batch", steal=True, n=20):
        """Free launches of a decode Put: (ms a launch back to back, ms a
        launch on the device alone, sum(mult) / tasks)."""
        st = to_device(decode_queue_state(lens, c["H"], c["S"], n_programs=P,
                                          partition=partition, bk=c["bk"]), dev)
        parrs = _fresh_arrays(st, "free", 2 * n + 2)

        def launch_p(i):
            K._launch_cuda(parrs[i], q4, k, v, out, mode="free", rounds=0, steal=steal,
                           policy="cost", compress=False, causal=False, bq=1, bk=c["bk"],
                           scale=c["hd"] ** -0.5, g=c["H"] // c["Hkv"], n_tasks=st.n_tasks)

        launch_p(2 * n)
        launch_p(2 * n + 1)
        torch.cuda.synchronize()
        ms = _event_ms(launch_p, n)
        dev_ms = _device_ms(lambda i: launch_p(n + i), n)
        mult = torch.stack([a["mult"].sum(0) for a in parrs])
        if not bool((mult >= 1).all()):
            raise AssertionError(f"ws_attention free at P={P} ({partition}, steal {steal}) "
                                 "left a task unexecuted")
        return ms, dev_ms, float(mult.sum()) / (mult.shape[0] * st.n_tasks)

    # the same free launch at other program counts, for the record
    by_programs = {c["P"]: times["free"]}
    for P in TIMES_PROGRAMS:
        by_programs[P] = free_state(lengths, P)[0]
    log("[times] ws_attention free decode by programs (record only): "
        + ", ".join(f"P={P} {ms:.4f} ms" for P, ms in by_programs.items())
        + f"; at P={c['P']} {(kv_bytes + io_bytes) / times['free'] / 1e6 / c['P']:.1f} GB/s "
          "of unique K/V, q and out a CTA")
    # Where the free launch's time goes, for the record: the scheduler and
    # the tile's fixed cost (every task one key), one tile a CTA (P = tasks,
    # round-robin queues, no steals: the launch, one claim and the longest
    # tile), and each CTA walking only its own queue (no steals, no
    # duplicate runs).  Device times, so no host gap between launches counts.
    ones = np.ones_like(np.asarray(lengths))
    split = {}
    for name, args in (("P8", (lengths, c["P"])),
                       ("P8, one key a task", (ones, c["P"])),
                       ("one tile a CTA", (lengths, n_tasks, "round_robin", False)),
                       ("one tile a CTA, one key", (ones, n_tasks, "round_robin", False)),
                       ("P8 own queues, no steals", (lengths, c["P"], "round_robin", False)),
                       ("P8 round robin, steals", (lengths, c["P"], "round_robin", True))):
        _, dev_ms, dup = free_state(*args)
        split[name] = dict(device_ms=dev_ms, mult_per_task=dup)
    log("[times] ws_attention free decode split (device ms a launch, sum(mult)/tasks; "
        "record only): " + ", ".join(f"{n_} {r['device_ms']:.4f} ({r['mult_per_task']:.3f})"
                                     for n_, r in split.items()))
    return dict(ms=times["free"], lockstep_ms=times["lockstep"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes" if byte_ms >= ops_ms else "operations",
                library_ms=library_ms, free_ms_by_programs=by_programs,
                free_split_device_ms=split)


# ---------------------------------------------------------------------------
# the standalone kernels (repro_torch.kernels)

# Full-width shapes of the kernels phase, bf16.  gemma3-12b: 16 heads over 8,
# head dim 256, a 1024 window on 5 of every 6 layers (local) and none on the
# sixth (global); llama3.2-3b: 24 heads over 8, head dim 128; mamba2-2.7b:
# 80 heads of P 64, state N 128, chunk 128.
KFLASH = (
    dict(at="gemma3-12b local", B=1, H=16, Hkv=8, hd=256, S=4096, bq=128, bk=128, window=1024),
    dict(at="gemma3-12b global", B=1, H=16, Hkv=8, hd=256, S=4096, bq=128, bk=128, window=0),
    dict(at="llama3.2-3b", B=1, H=24, Hkv=8, hd=128, S=4096, bq=128, bk=128, window=0),
)
KFLASH_GRAD = dict(at="gemma3-12b global, backward", B=1, H=16, Hkv=8, hd=256, S=1024, bq=128,
                   bk=128, window=0)
KDECODE = (
    dict(at="gemma3-12b local", B=4, H=16, Hkv=8, hd=256, S=8192, bk=512, pos=8191, window=1024),
    dict(at="gemma3-12b global", B=4, H=16, Hkv=8, hd=256, S=8192, bk=512, pos=8191, window=0),
    dict(at="gemma3-12b local", B=4, H=16, Hkv=8, hd=256, S=8192, bk=512, pos=4000, window=1024),
    dict(at="gemma3-12b global", B=4, H=16, Hkv=8, hd=256, S=8192, bk=512, pos=4000, window=0),
    dict(at="llama3.2-3b serving cache", B=4, H=24, Hkv=8, hd=128, S=1024, bk=512, pos=1000,
         window=0),
)
KSSD = dict(at="mamba2-2.7b", b=2, S=2048, H=80, P=64, N=128, chunk=128)
KSSD_GRAD = dict(KSSD, at="mamba2-2.7b, backward", b=1, S=1024)
# Limits of the kernels phase.  A bf16 output (out, y, a gradient) is fp32
# arithmetic summed in another order than the plain version's, then rounded
# once: each element may differ from the plain value by KULPS bf16 ulps of
# that value, plus KATOL x max|plain| for elements that fp32 rounding moves
# near zero.  lse is fp32: LSE_ATOL abs.  The final SSD state is fp32:
# STATE_RTOL x |want| plus KATOL x max|want|.  Each limit sits above the
# card's readings and below the faults of KCONTROLS, which must fail it.
KULPS = 2
KATOL = 1e-4
LSE_ATOL = 1e-4
STATE_RTOL = 1e-3
KTIMED = 10                     # timed launches a kernel (median of CUDA-event pairs)
# Decode's kernel and SDPA also get device times (_device_ms: the host's
# enqueue, ~0.1 ms through the Python wrapper, kept out of the span), warm
# (L2 holds the inputs of the launches before) and cold: before each timed
# launch a write of EVICT_BYTES to one scratch and a read of EVICT_BYTES of
# another leave the 50 MB L2 holding none of the inputs and no dirty lines.
EVICT_BYTES = 128 << 20


def _ms_or_none(ms):
    return "none" if ms is None else f"{ms:.4f} ms"


def _median_ms(fn, n=KTIMED, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(n)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def _limit(want, kind):
    """Per-element limit on |got - want| (``kind``: "bf16", "lse", "state")."""
    if kind == "lse":
        return torch.full_like(want, LSE_ATOL)
    floor = KATOL * float(want.abs().max())
    if kind == "state":
        return STATE_RTOL * want.abs() + floor
    _, e = torch.frexp(want)                     # |want| in [2^(e-1), 2^e): ulp 2^(e-8)
    ulp = torch.where(want == 0, torch.zeros_like(want), torch.exp2((e - 8).float()))
    return KULPS * ulp + floor


def _reading(got, want, kind):
    """(max |got - want|, max over elements of |got - want| / limit)."""
    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        return float("inf"), float("inf")
    err = (got - want).abs()
    return float(err.max()), float((err / _limit(want, kind)).max())


class _Checks:
    """The kernels phase's comparisons: every disagreement and every control
    that passes is gathered, and :meth:`verdict` raises on any of them."""

    def __init__(self):
        self.faults = []

    def held(self, name, got, want, kind="bf16"):
        """max |got - want|; a fault unless every element is within its limit."""
        err, ratio = _reading(got, want, kind)
        log(f"[kernels] {name}: max |err| {err:.3g}, {ratio:.3g} of the {kind} limit")
        if not ratio <= 1:
            self.faults.append(f"{name}: max |err| {err:.3g} is {ratio:.3g} x the {kind} limit")
        return err

    def control(self, name, pairs):
        """A wrong version of the plain one: over its (got, wrong, kind)
        pairs the kernel must break a limit.  Returns the largest err/limit."""
        ratio = max(_reading(g, w, kind)[1] for g, w, kind in pairs)
        log(f"[kernels] control {name}: {ratio:.3g} x the limit (must exceed 1)")
        if not ratio > 1:
            self.faults.append(f"control {name} passed: {ratio:.3g} x the limit")
        return ratio

    def verdict(self):
        if self.faults:
            raise AssertionError("kernels phase: " + "; ".join(self.faults))


def _dense_attention(q, k, v, valid, scale):
    """Softmax attention in fp32 over a visibility mask ``valid`` that
    broadcasts to [.., Sq, Sk], the kv heads repeated for GQA: (out, lse).
    The controls' wrong versions (and a second, independent reference)."""
    G = q.shape[1] // k.shape[1]
    kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    s = s.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), vf)
    return out, lse


def _visible(qpos, kpos, window, edge=0, drop=None):
    """[Sq, Sk] mask: key <= query + ``edge``, within ``window`` (0: none),
    keys ``drop`` = (start, stop) hidden."""
    d = qpos[:, None] - kpos[None, :]
    valid = d >= -edge
    if window > 0:
        valid &= d < window
    if drop is not None:
        valid &= (kpos[None, :] < drop[0]) | (kpos[None, :] >= drop[1])
    return valid


# Faults the limits must see, each the plain version made wrong in one way:
# one kv block of 16 keys dropped, the window's (or, with none, the causal)
# edge moved by one key, the softmax scale 2 % off; for the SSD scan A 2 %
# off and one step of x dropped.
KCONTROLS = ("kv block of 16 dropped", "mask edge off by one", "softmax scale 2% off")
# and for decode the merge with its last live split dropped (the keys of
# that split hidden from the dense version)
DECODE_CONTROL = "last live split dropped"
SSD_CONTROLS = ("A 2% off", "one step of x dropped")


def _bound(nbytes, ops):
    byte_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    return max(byte_ms, ops_ms), "bytes" if byte_ms >= ops_ms else "operations"


def _randn(gen, shape, dev, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def _causal_pairs(S, window):
    """(q, k) pairs a causal mask with ``window`` (0: none) leaves visible:
    the products this run needs."""
    qpos = np.arange(S)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    return int((qpos - lo + 1).sum())


def phase_kernels(dev):
    """The three standalone kernels of repro_torch.kernels at full width in
    bf16.  First every entry point is driven once a case with the launch
    counts from 0 (the phase is their only path: no model calls them); then
    every output is held to the plain version and to a dense fp32 one, each
    fault of KCONTROLS / SSD_CONTROLS must break the same limits, and the
    kernel, the plain version and the SDPA yardstick are timed (CUDA events,
    median of KTIMED) beside the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, reset_launches, ssd_scan
    from repro_torch.kernels import launches as klaunches
    from repro_torch.kernels.decode_attention.kernel import _split as decode_split
    from repro_torch.kernels.decode_attention.kernel import device_cut, \
        plain_decode_attention, sm_count
    from repro_torch.kernels.decode_attention.kernel import smem_bytes as decode_smem
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, \
        plain_flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import smem_bytes as flash_smem
    from repro_torch.kernels.flash_attention.ops import plain_flash_attention
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.kernel import plain_ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan as ssd_fwd
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    checks = _Checks()

    def drive(fn):
        out = fn()
        torch.cuda.synchronize()
        return out

    def with_grads(fn, xs, cot, **kw):
        xs = [t.clone().requires_grad_(True) for t in xs]
        out = fn(*xs, **kw)
        return (out, *torch.autograd.grad(out, xs, cot))

    def ssd_inputs(c):
        b, S, H, P, N = c["b"], c["S"], c["H"], c["P"], c["N"]
        dt = F.softplus(_randn(gen, (b, S, H), dev, torch.float32)).to(torch.bfloat16)
        A = -torch.exp(_randn(gen, (H,), dev, torch.float32))
        return (_randn(gen, (b, S, H, P), dev), dt, A, _randn(gen, (b, S, N), dev),
                _randn(gen, (b, S, N), dev))

    # -- every entry point once a case, launches counted from 0
    reset_launches()
    flash = []
    for c in KFLASH:
        q, k, v = (_randn(gen, (c["B"], h, c["S"], c["hd"]), dev)
                   for h in (c["H"], c["Hkv"], c["Hkv"]))
        kw = dict(causal=True, window=c["window"], bq=c["bq"], bk=c["bk"])
        flash.append((c, (q, k, v), kw, drive(lambda: flash_attention_fwd(q, k, v, **kw))))
    g = KFLASH_GRAD
    fg_in = [_randn(gen, (g["B"], h, g["S"], g["hd"]), dev) for h in (g["H"], g["Hkv"], g["Hkv"])]
    fg_do = _randn(gen, (g["B"], g["H"], g["S"], g["hd"]), dev)
    fg_kw = dict(causal=True, window=g["window"], bq=g["bq"], bk=g["bk"])
    fg = drive(lambda: with_grads(flash_attention, fg_in, fg_do, **fg_kw))
    decode = []
    for c in KDECODE:
        q = _randn(gen, (c["B"], c["H"], c["hd"]), dev)
        k, v = (_randn(gen, (c["B"], c["Hkv"], c["S"], c["hd"]), dev) for _ in range(2))
        pos = torch.tensor([c["pos"]], dtype=torch.int32, device=dev)  # stays on the card
        kw = dict(window=c["window"], bk=c["bk"])
        decode.append((c, (q, k, v, pos), kw, drive(lambda: decode_attention(q, k, v, pos, **kw))))
    sx = ssd_inputs(KSSD)
    s_out = drive(lambda: ssd_fwd(*sx, chunk=KSSD["chunk"]))
    sg_in = ssd_inputs(KSSD_GRAD)
    sg_dy = _randn(gen, tuple(sg_in[0].shape), dev)
    sg = drive(lambda: with_grads(ssd_scan, sg_in, sg_dy, chunk=KSSD_GRAD["chunk"]))
    counts = dict(klaunches)
    want = {"flash_fwd": len(KFLASH) + 1, "decode_attention": len(KDECODE), "ssd_scan": 2}
    if counts != want:
        raise AssertionError(f"kernels phase launches {counts}, want {want}")
    log(f"[kernels] entry points driven once a case: launches {counts}")

    # -- held to the plain versions, timed, bounded
    scratch = None

    def evict_l2():
        scratch[0].fill_(1.0)
        scratch[1].sum()

    def case(name, c, shape, err, fn, plain, lib, nbytes, ops, smem, want_lib=None,
             cold=False):
        """``ms`` and ``library_ms`` keep the host's enqueue in the span;
        with ``cold`` the kernel and library also get device times, warm
        (``ms_device``, ``library_ms_device``) and cold (``ms_cold``, the
        kernel's fastest and slowest in ``ms_cold_range``,
        ``library_ms_cold``)."""
        bound_ms, bound_by = _bound(nbytes, ops)
        row = dict(at=c["at"], shape=shape, max_abs_err=err, ms=_median_ms(fn))
        if cold:
            row["ms_device"] = _device_ms(lambda _: fn(), KTIMED)
        row.update(plain_ms=_median_ms(plain, n=3, warm=1), bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, operations=ops,
                   library_ms=None if lib is None else _median_ms(lib), smem_bytes=smem)
        if cold:
            spans = _device_spans(lambda _: fn(), KTIMED, before=evict_l2)
            row.update(library_ms_device=None if lib is None else
                       _device_ms(lambda _: lib(), KTIMED),
                       ms_cold=float(np.median(spans)),
                       ms_cold_range=(min(spans), max(spans)),
                       library_ms_cold=None if lib is None else
                       _device_ms(lambda _: lib(), KTIMED, before=evict_l2))
            row["bound_fraction_cold"] = bound_ms / row["ms_cold"]
        if lib is not None:  # the yardstick computes the same function (recorded, not held)
            row["library_max_abs_err"] = float((lib().float().reshape(want_lib.shape)
                                                - want_lib.float()).abs().max())
        log(f"[kernels] {name} {c['at']} {shape}: max |err| {err:.3g} vs plain; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, library "
            + ("none" if lib is None else f"{row['library_ms']:.4f} ms")
            + (f"; device warm: kernel {row['ms_device']:.4f} ms, library "
               f"{_ms_or_none(row['library_ms_device'])}; device cold: kernel "
               f"{row['ms_cold']:.4f} ms ({row['ms_cold_range'][0]:.4f}-"
               f"{row['ms_cold_range'][1]:.4f}), library {_ms_or_none(row['library_ms_cold'])}, "
               f"{row['bound_fraction_cold']:.4f} of the bound" if cold else "")
            + f", bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B, {ops} operations); "
            f"{smem} B shared memory a CTA")
        return row

    def controls(at, got, scale, dense, edge_kw, mid):
        """KCONTROLS on one attention case; ``dense(**mask_kw, scale=)`` is
        the case's dense fp32 version."""
        out = {}
        for name, kw in zip(KCONTROLS, (dict(drop=(mid, mid + 16)), edge_kw, {})):
            wrong = dense(**kw, scale=scale * (1.02 if name.startswith("softmax") else 1))
            out[name] = checks.control(f"{at}: {name}", [(g_, w_, kd) for g_, w_, kd in
                                                         zip(got, wrong, ("bf16", "lse"))])
            del wrong
        return out

    entries = {}
    rows = []
    for c, (q, k, v), kw, (out, lse) in flash:
        B, H, Hkv, hd, S, w = c["B"], c["H"], c["Hkv"], c["hd"], c["S"], c["window"]
        at = f"flash {c['at']}"
        pout, plse = plain_flash_attention_fwd(q, k, v, **kw)
        err = checks.held(f"{at} out", out, pout)
        lse_err = checks.held(f"{at} lse", lse, plse, "lse")
        del pout, plse
        p_ = torch.arange(S, device=dev)

        def dense(scale, window=w, **mask_kw):
            return _dense_attention(q, k, v, _visible(p_, p_, window, **mask_kw), scale)

        dout, dlse = dense(hd ** -0.5)
        dense_err = max(checks.held(f"{at} out vs dense fp32", out, dout),
                        checks.held(f"{at} lse vs dense fp32", lse, dlse, "lse"))
        del dout, dlse
        ctl = controls(at, (out, lse), hd ** -0.5, dense,
                       dict(window=w + 1) if w > 0 else dict(edge=1), S // 2)
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        if w > 0:
            mask = _visible(p_, p_, w)
            lib = lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)  # noqa: E731
        else:
            lib = lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True)  # noqa: E731
        rows.append(case(
            "flash_fwd", c, dict(B=B, H=H, Hkv=Hkv, hd=hd, S=S, causal=True, window=w,
                                 bq=c["bq"], bk=c["bk"]),
            err, lambda: flash_attention_fwd(q, k, v, **kw),
            lambda: plain_flash_attention_fwd(q, k, v, **kw), lib,
            2 * (2 * B * H * S * hd + 2 * B * Hkv * S * hd) + 4 * B * H * S,
            4 * B * H * hd * _causal_pairs(S, w), flash_smem(hd), out))
        rows[-1].update(lse_max_abs_err=lse_err, dense_max_abs_err=dense_err, controls=ctl)
        lo, hi = FIRST_VERSION_MS[f"flash_fwd {c['at']}"]
        log(f"[kernels] flash_fwd {c['at']}: {rows[-1]['ms']:.4f} ms (first version: {lo}-{hi} ms), "
            f"{rows[-1]['ms'] / rows[-1]['library_ms']:.2f}x SDPA's "
            f"{rows[-1]['library_ms']:.4f} ms, {rows[-1]['bound_ms'] / rows[-1]['ms']:.4f} of "
            "the bound")
    want_g = with_grads(plain_flash_attention, fg_in, fg_do, **fg_kw)
    gerr = max(checks.held(f"flash backward {n}", a, b)
               for n, a, b in zip(("out", "dq", "dk", "dv"), fg, want_g))
    log(f"[kernels] flash_attention autograd at {KFLASH_GRAD}: out, dq, dk, dv max |err| "
        f"{gerr:.3g} vs the same Function over the plain forward")
    entries["flash_fwd"] = dict(rows[0], cases=rows, grad_max_abs_err=gerr,
                                max_abs_err=max(r["max_abs_err"] for r in rows),
                                lse_max_abs_err=max(r["lse_max_abs_err"] for r in rows))

    rows = []
    scratch = [torch.empty(EVICT_BYTES // 4, device=dev) for _ in range(2)]
    scratch[1].zero_()
    for c, (q, k, v, pos), kw, out in decode:
        B, H, Hkv, hd, S, w, P_ = c["B"], c["H"], c["Hkv"], c["hd"], c["S"], c["window"], c["pos"]
        at = f"decode {c['at']} pos {P_}"
        pout = plain_decode_attention(q, k, v, pos, **kw)
        err = checks.held(at, out, pout)
        kpos = torch.arange(S, device=dev)
        qpos = torch.tensor([P_], device=dev)

        def dense(scale, window=w, **mask_kw):
            o, _ = _dense_attention(q[:, :, None], k, v,
                                    _visible(qpos, kpos, window, **mask_kw), scale)
            return (o[:, :, 0],)

        dense_err = checks.held(f"{at} vs dense fp32", out, dense(hd ** -0.5)[0])
        lo = max(0, P_ - w + 1) if w > 0 else 0
        ctl = controls(at, (out,), hd ** -0.5, dense,
                       dict(window=w + 1) if w > 0 else dict(edge=-1), (lo + P_) // 2)
        chunk, n_split = decode_split(S, min(c["bk"], S), w, B, Hkv, sm_count(dev))
        first, c_dev, last_key = device_cut(P_, S, w, n_split)
        c_dev, last_key = int(c_dev), int(last_key)
        last = int(first[first <= last_key][-1])     # first key of the last live split
        ctl[DECODE_CONTROL] = checks.control(
            f"{at}: {DECODE_CONTROL} (keys {last}..{last_key}, splits of {c_dev})",
            [(out, dense(hd ** -0.5, drop=(last, S))[0], "bf16")])
        mask = _visible(qpos, kpos, w)[None, None]
        live = int(mask.sum())
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        q4 = q[:, :, None, :]
        rows.append(case(
            "decode_attention", c, dict(B=B, H=H, Hkv=Hkv, hd=hd, S=S, bk=c["bk"], pos=P_,
                                        window=w),
            err, lambda: decode_attention(q, k, v, pos, **kw),
            lambda: plain_decode_attention(q, k, v, pos, **kw),
            lambda: F.scaled_dot_product_attention(q4, kr, vr, attn_mask=mask),
            2 * (2 * B * H * hd + 2 * B * Hkv * live * hd) + 4, 4 * B * H * hd * live,
            decode_smem(hd, q.dtype, H // Hkv), pout, cold=True))
        rows[-1].update(dense_max_abs_err=dense_err, controls=ctl, n_split=n_split,
                        split_keys=c_dev)
        r = rows[-1]
        lo_, hi_ = FIRST_VERSION_MS[f"decode_attention {c['at']} pos {P_}"]
        log(f"[kernels] decode_attention {c['at']} pos {P_}: {r['ms']:.4f} ms with the host's "
            f"enqueue (first version, the same way: {lo_}-{hi_} ms); device {r['ms_device']:.4f}"
            f" warm, {r['ms_cold']:.4f} cold; SDPA device {r['library_ms_device']:.4f} warm, "
            f"{r['library_ms_cold']:.4f} cold ({r['ms_cold'] / r['library_ms_cold']:.2f}x cold);"
            f" {r['bound_fraction_cold']:.4f} of the bound cold; {n_split} splits of {c_dev} "
            f"keys (at most {chunk})")
    del scratch
    entries["decode_attention"] = dict(rows[0], cases=rows,
                                       max_abs_err=max(r["max_abs_err"] for r in rows))

    c = KSSD
    b, S, H, P, N, Q = c["b"], c["S"], c["H"], c["P"], c["N"], c["chunk"]
    y, fin = s_out
    py, pfin = plain_ssd_scan(*sx, chunk=Q)
    err = checks.held("ssd y", y, py)
    state_err = checks.held("ssd final state", fin, pfin, "state")
    log(f"[kernels] ssd_scan max |state| {float(pfin.abs().max()):.3g}, max |y| "
        f"{float(py.float().abs().max()):.3g}")
    del py, pfin
    oy, ofin = ssd_ref(*(t.float() for t in sx))    # the sequential fp32 oracle
    oracle_err = max(checks.held("ssd y vs the sequential oracle", y, oy),
                     checks.held("ssd final state vs the sequential oracle", fin, ofin, "state"))
    del oy, ofin
    x32, dt32, A32, B32, C32 = (t.float() for t in sx)
    x_drop = x32.clone()
    x_drop[:, S // 2 + 5] = 0
    ssd_ctl = {}
    for name, args in zip(SSD_CONTROLS, ((x32, dt32, A32 * 1.02, B32, C32),
                                         (x_drop, dt32, A32, B32, C32))):
        wy, wfin = plain_ssd_scan(*args, chunk=Q)
        ssd_ctl[name] = checks.control(f"ssd {name}", [(y, wy, "bf16"), (fin, wfin, "state")])
    del x32, dt32, B32, C32, x_drop, wy, wfin
    tri = Q * (Q + 1) // 2
    ssd_smem = ssd_kernel.smem_bytes(*ssd_kernel.plan(Q, N, torch.bfloat16), torch.bfloat16)
    scratch = [torch.empty(EVICT_BYTES // 4, device=dev) for _ in range(2)]
    scratch[1].zero_()
    row = case("ssd_scan", c, dict(b=b, S=S, H=H, P=P, N=N, chunk=Q), err,
               lambda: ssd_fwd(*sx, chunk=Q), lambda: plain_ssd_scan(*sx, chunk=Q), None,
               2 * (2 * b * S * H * P + b * S * H + 2 * b * S * N) + 4 * H + 4 * b * H * P * N,
               2 * (tri * N + tri * P + 2 * Q * P * N) * b * H * (S // Q), ssd_smem, cold=True)
    del scratch
    # one call's launches (the count's change) and the device memory it asks
    # the allocator for beyond its outputs (bytes requested, before the
    # allocator's rounding), the CTAs an SM holds as the card reports them for
    # the instantiation the launch picks, and the waves from those
    torch.cuda.synchronize()

    def requested():
        st = torch.cuda.memory_stats(dev)
        return st["requested_bytes.all.allocated"], st["allocation.all.allocated"]

    n0, (m0, a0) = klaunches["ssd_scan"], requested()
    one = drive(lambda: ssd_fwd(*sx, chunk=Q))
    per_call = klaunches["ssd_scan"] - n0
    m1, a1 = requested()
    extra = m1 - m0 - sum(t.numel() * t.element_size() for t in one)
    del one
    grid = ssd_kernel.grid(b, H, P)
    ctas = int(np.prod(grid))
    resident = ssd_kernel.occupancy(Q, N, sx[4])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row.update(grid=list(grid), ctas=ctas, threads=32 * ssd_kernel.WARPS,
               resident_per_sm_measured=resident, waves=ctas / (sms * resident),
               intermediate_bytes_measured=extra, allocations_per_call_measured=a1 - a0,
               launches_per_call_measured=per_call,
               oracle_max_abs_err=oracle_err,
               plan=list(ssd_kernel.plan(Q, N, torch.bfloat16, sx[4].data_ptr() % 4 == 0)),
               bound_fraction_warm=row["bound_ms"] / row["ms_device"])
    lo, hi = FIRST_VERSION_MS[f"ssd_scan {c['at']}"]
    log(f"[kernels] ssd_scan {c['at']}: {per_call} launch(es) a call, device "
        f"{row['ms_device']:.4f} ms warm, "
        f"{row['ms_cold']:.4f} cold ({row['ms_cold_range'][0]:.4f}-{row['ms_cold_range'][1]:.4f})"
        f" (first version: {lo}-{hi} ms), {row['ms']:.4f} with the host's enqueue; plain "
        f"{row['plain_ms']:.3f} ms; {row['bound_fraction_warm']:.4f} of the "
        f"{row['bound_ms']:.5f} ms bound warm, {row['bound_fraction_cold']:.4f} cold; grid "
        f"{grid[0]} x {grid[1]} = {ctas} CTAs of {32 * ssd_kernel.WARPS} threads, {resident} "
        f"an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor; {ssd_smem} B shared memory a "
        f"CTA), {row['waves']:.3f} waves on {sms} SMs; chunk and tile of N {row['plan']}; "
        f"{a1 - a0} allocations a call, {extra} B requested beyond y and the state")
    # the Function's backward recomputes ssd_chunked in torch ops and runs no
    # kernel: its y is held, its gradients only checked for shape and finiteness
    gy = checks.held("ssd autograd y", sg[0], plain_ssd_scan(*sg_in, chunk=KSSD_GRAD["chunk"])[0])
    for n, gr, x_ in zip(("dx", "ddt", "dA", "dB", "dC"), sg[1:], sg_in):
        if gr.shape != x_.shape or not torch.isfinite(gr).all():
            checks.faults.append(f"ssd autograd {n}: shape {tuple(gr.shape)} or non-finite")
    entries["ssd_scan"] = dict(row, state_max_abs_err=state_err, autograd_y_max_abs_err=gy,
                               controls=ssd_ctl)
    checks.verdict()
    for name, e in entries.items():
        e["launches"] = counts[name]
    log(f"[kernels] limits: {KULPS} bf16 ulps + {KATOL} x max|want|; lse {LSE_ATOL} abs; "
        f"state {STATE_RTOL} x |want| + {KATOL} x max|want|")
    log(f"[kernels] phase {time.perf_counter() - t_phase:.1f} s; card: {card_line()}")
    return entries


# ---------------------------------------------------------------------------
# serving faults: a replica crash under jit_ws, the unified step's watchdog


# The serving phase's crash drill: 6 of its 8 requests go to replica 0, the
# frontend runs CRASH_AT iterations (replica 0 admits 4, replica 1 steals 2),
# the last 2 are queued on replica 0, and replica 0 dies at iteration
# CRASH_AT with 4 requests in flight and 2 queued.
CRASH_AT = 2
CRASH_LATE = 2
# The unified phase's watchdog drills: one batcher of UNIFIED's 4 slots
# serving the first 4 prompts; a deadline that only the injected latency
# (EngineFaultPlan's 1e9 s) can pass.
WATCHDOG = dict(poison_steps=(0, 2), slow_steps=(1,), cooldown=2, deadline_s=60.0)


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def _last_logits(params, cfg, seq):
    """The prefill logits [V] at the last position of ``seq``."""
    dev = params["embed"].device
    from repro_torch.models import prefill

    lg, _ = prefill(params, cfg, {"tokens": torch.from_numpy(np.asarray(seq)).to(dev)[None]
                                  .long()}, capacity=len(seq))
    return lg[0, :cfg.vocab_size]


def _below_top(lg, *tokens):
    """How far below the largest logit each token's logit lies."""
    top = float(lg.max())
    return [top - float(lg[t]) for t in tokens]


def _fp32_streams_held(tag, params, cfg, prompts, got, want, what):
    """Greedy streams of an fp32 model on two paths, ``got`` against ``want``
    ({rid: tokens}): a difference passes only at a near-tie of the prefill
    logits at its first differing token (both streams' tokens within 2 x
    UNIFIED_RTOL x max(1, max |logit|) of the largest logit).  Returns the
    number of streams that differ."""
    differ = 0
    for rid in sorted(want):
        g, w = list(got[rid]), list(want[rid])
        if g == w:
            continue
        differ += 1
        j = _first_diff(g, w)
        if j >= min(len(g), len(w)):
            raise AssertionError(f"[{tag}] request {rid}: {len(g)} tokens against {len(w)}")
        lg = _last_logits(params, cfg, np.concatenate([prompts[rid], np.asarray(w[:j], np.int32)]))
        gap = max(_below_top(lg, g[j], w[j]))
        limit = 2 * UNIFIED_RTOL * max(1.0, float(lg.abs().max()))
        log(f"[{tag}] request {rid} differs from {what} first at token {j}: tokens {g[j]} and "
            f"{w[j]} within {gap:.3g} of the largest logit (a near-tie flips when under "
            f"{limit:.3g})")
        if not gap < limit:
            raise AssertionError(f"[{tag}] request {rid}: the streams differ at token {j}, a "
                                 f"token {gap} below the largest logit >= {limit}")
    return differ


def _resumed_streams_held(tag, params, cfg, prompts, got, want, resumed_at):
    """A crash drill's streams ``got`` against the uninterrupted run's
    ``want``.  A request not in flight at the crash ran the same path: equal.
    A resumed one (``resumed_at[rid]`` tokens emitted before the crash) is
    equal up to there; after it its tokens come from a prefill over the
    prompt and the emitted tokens where the uninterrupted run decoded, two
    bf16 paths.  So a difference at token j passes only where both tokens'
    prefill-path logits there lie within twice the distance between the two
    paths' logits at j (max |prefill - decode_step_ws|) of the largest one
    (bf16 logits tie exactly, often among more than two tokens).  Returns
    per request the first differing token (or None) and, where one differs,
    how far below the largest logit the two tokens lie and the paths'
    distance."""
    from repro_torch.models import decode_step_ws, prefill

    dev = params["embed"].device
    out = {}
    for rid in sorted(want):
        g, w = list(got[rid]), list(want[rid])
        if len(g) != len(w):
            raise AssertionError(f"[{tag}] request {rid}: {len(g)} tokens, want {len(w)}")
        j = _first_diff(g, w)
        if j == len(w):
            out[rid] = None
            continue
        m = resumed_at.get(rid)
        if m is None or j < m:
            raise AssertionError(f"[{tag}] request {rid} differs at token {j} "
                                 f"({'not resumed' if m is None else f'resumed after {m}'}): "
                                 f"{g} against {w}")
        seq = np.concatenate([prompts[rid], np.asarray(w[:j], np.int32)])
        lg_p = _last_logits(params, cfg, seq)
        _, caches = prefill(params, cfg, {"tokens": torch.from_numpy(seq[:-1]).to(dev)[None]
                                          .long()}, capacity=len(seq))
        lg_d = decode_step_ws(params, cfg, caches, torch.tensor([[int(seq[-1])]], device=dev),
                              np.array([len(seq) - 1]))[0][0, :cfg.vocab_size]
        dist = float((lg_p - lg_d).abs().max())
        below = _below_top(lg_p, g[j], w[j])
        log(f"[{tag}] request {rid} (resumed after {m} tokens) differs from the uninterrupted "
            f"stream first at token {j}: tokens {g[j]} and {w[j]} {below[0]:.4g} and "
            f"{below[1]:.4g} below the largest prefill-path logit, the paths' logits {dist:.4g} "
            f"apart (passes within {2 * dist:.4g})")
        if not max(below) <= 2 * dist:
            raise AssertionError(f"[{tag}] request {rid}: the resumed stream differs at token {j} "
                                 f"with a token {max(below)} below the largest logit > 2 x {dist}")
        out[rid] = dict(token=j, below_top=below, path_distance=dist)
    return out


def _serve_crash(params, cfg, prompts, max_new, want):
    """The serving phase's requests again under ``jit_ws`` with replica 0
    killed at iteration CRASH_AT (ReplicaCrashPlan), 4 requests in flight on
    it and CRASH_LATE queued: crashed == 1, readmitted == the in-flight
    count, no duplicate completion, every request completed with max_new
    tokens, the queued ones stolen and served by the survivor, and every
    stream the uninterrupted run's (``want``) as _resumed_streams_held
    reads it."""
    from repro_torch.chaos import ReplicaCrashPlan
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    front = WorkStealingFrontend(
        lambda: ContinuousBatcher(params, cfg, slots=4, capacity=1024, jit_ws=True),
        n_replicas=2, crash_plan=ReplicaCrashPlan({0: CRASH_AT}))
    early = len(prompts) - CRASH_LATE
    for rid in range(early):
        front.submit(0, Request(rid=rid, tokens=prompts[rid], max_new=max_new))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CRASH_AT):
        front.run_iteration()
    inflight = {r.rid: len(r.out) for r in front.batchers[0].live if r is not None}
    for rid in range(early, len(prompts)):  # queued on replica 0 when it dies
        front.submit(0, Request(rid=rid, tokens=prompts[rid], max_new=max_new))
    done = front.run(max_iters=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launches[n] for n in ("ws_attention", "ws_expert", "ws_expert_grad",
                                       "ws_unified")}
    c, per = front.counters, front.per_replica
    if not inflight:
        raise AssertionError(f"[serving] replica 0 had nothing in flight at iteration {CRASH_AT}")
    if (c["crashed"] != 1 or c["readmitted"] != len(inflight) or c["dup_completed"]
            or front.rejected or front.dead != {0}):
        raise AssertionError(f"[serving] crash counters {c}, dead {front.dead}, in flight "
                             f"{inflight}")
    if sorted(done) != list(range(len(prompts))) or any(len(r.out) != max_new
                                                        for r in done.values()):
        raise AssertionError(f"[serving] crash drill completed {sorted(done)}: "
                             f"{ {rid: len(r.out) for rid, r in done.items()} }")
    if per[0]["admitted"] != len(inflight) or per[0]["completed"] or per[1]["stolen"] < \
            early - len(inflight) + CRASH_LATE:
        raise AssertionError(f"[serving] per replica {per}: replica 0 must admit only its "
                             "in-flight requests, and the survivor steal the queued ones")
    for rid, r in done.items():
        np.testing.assert_array_equal(np.asarray(r.tokens), prompts[rid])
    held = _resumed_streams_held("serving", params, cfg, prompts, _streams(done), want,
                                 inflight)
    equal = sum(v is None for v in held.values())
    tokens = sum(len(r.out) for r in done.values())
    log(f"[serving] crash drill (jit_ws on): replica 0 killed at iteration {CRASH_AT} with "
        f"{len(inflight)} requests in flight ({inflight} tokens emitted) and {CRASH_LATE} "
        f"queued; counters {c}; per replica {per}; {tokens} new tokens in {wall:.2f} s; "
        f"launches {counts}; streams equal to the uninterrupted run's {equal}/{len(done)}"
        + ("" if equal == len(done) else
           f" (the rest near-ties after their resume: { {k: v for k, v in held.items() if v} })"))
    del front
    gc.collect()
    return dict(crash_at=CRASH_AT, inflight=inflight, queued=CRASH_LATE, counters=dict(c),
                per_replica=per, wall_s=wall, new_tokens=tokens, launches=counts,
                streams_equal=equal, differences={k: v for k, v in held.items() if v})


def _watchdog_drills(params, cfg, prompts, c):
    """The unified engine's watchdog at full width (fp32 llama): one batcher
    serving ``prompts`` healthy, then with EngineFaultPlan(poison_steps),
    then with a deadline, cooldown WATCHDOG["cooldown"] and slow_steps.
    Streams equal to the healthy run's (a near-tie as _fp32_streams_held
    reads it); degradations ["non-finite"] x 2 at the poisoned steps, and
    ["deadline"] at the slow one; the launches of every step: a healthy one
    ws_unified 1 and nothing else, a poisoned one ws_unified 1 and the split
    redo's ws_attention (n_layers where a slot decodes), a cooled-down one
    no ws_unified and the split step's ws_attention."""
    from repro_torch.chaos import EngineFaultPlan
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request

    w = WATCHDOG
    L = cfg.n_layers

    def serve(**kw):
        b = ContinuousBatcher(params, cfg, slots=c["B"], capacity=c["cap"], unified_step=True,
                              **kw)
        for rid, p in enumerate(prompts):
            assert b.admit(Request(rid=rid, tokens=p, max_new=c["max_new"]))
        done, steps = [], []
        t0 = time.perf_counter()
        while b.n_live:
            decodes = any(r is not None and r.out and i not in b._pending_slots
                          for i, r in enumerate(b.live))
            reset_launches()
            done += b.step()
            torch.cuda.synchronize()
            steps.append(dict(decodes=decodes, ws_unified=launches["ws_unified"],
                              ws_attention=launches["ws_attention"],
                              other=launches["ws_expert"] + launches["ws_expert_grad"]))
        return {r.rid: list(r.out) for r in done}, b, steps, time.perf_counter() - t0

    healthy, b0, s0, t_h = serve()
    if b0.degradations:
        raise AssertionError(f"[unified] the healthy watchdog run degraded: {b0.degradations}")
    runs = {"poisoned": serve(fault_plan=EngineFaultPlan(poison_steps=w["poison_steps"])),
            "deadline": serve(step_deadline_s=w["deadline_s"], watchdog_cooldown=w["cooldown"],
                              fault_plan=EngineFaultPlan(slow_steps=w["slow_steps"]))}
    want_kinds = {"poisoned": [(s, "non-finite") for s in w["poison_steps"]],
                  "deadline": [(s, "deadline") for s in w["slow_steps"]]}
    redo = {"poisoned": set(w["poison_steps"]),
            "deadline": {s + 1 + k for s in w["slow_steps"] for k in range(w["cooldown"])}}
    out = {"healthy_s": t_h, "steps": len(s0), "requests": len(prompts)}
    for name, (got, b, steps, t) in runs.items():
        kinds = [(d["step"], d["kind"]) for d in b.degradations]
        if kinds != want_kinds[name]:
            raise AssertionError(f"[unified] watchdog {name}: degradations {b.degradations}")
        for i, st in enumerate(steps):
            unified = 0 if (name == "deadline" and i in redo[name]) else 1
            split = L if (i in redo[name] and st["decodes"]) else 0
            if (st["ws_unified"], st["ws_attention"], st["other"]) != (unified, split, 0):
                raise AssertionError(f"[unified] watchdog {name} step {i}: launches {st}, want "
                                     f"ws_unified {unified}, ws_attention {split}")
        differ = _fp32_streams_held("unified", params, cfg, prompts, got, healthy,
                                    f"the healthy run ({name})")
        out[name] = dict(degradations=b.degradations, seconds=t, streams_equal=len(got) - differ,
                         launches_by_step=steps, redone_or_cooled=sorted(redo[name]))
        log(f"[unified] watchdog {name}: degradations {kinds}; steps "
            f"{sorted(redo[name])} on the split path (ws_attention "
            f"{[steps[i]['ws_attention'] for i in sorted(redo[name])]}, ws_unified "
            f"{[steps[i]['ws_unified'] for i in sorted(redo[name])]}), every other step one "
            f"ws_unified launch; {len(steps)} steps in {t:.2f} s (healthy {t_h:.2f} s); streams "
            f"{len(got) - differ}/{len(got)} equal to the healthy run's")
    return out


# ---------------------------------------------------------------------------
# checkpoints: save, preemption and resume through train()


# llama3.2-3b bf16 at full width cut to 2 layers (0.99 B parameters: 1.98 GB
# of bf16 weights, 7.93 GB of AdamW's fp32 states, so 9.9 GB a checkpoint),
# AdamW, 4 x 256 tokens a step: run A takes 6 steps with a save every 2 (and
# at the last), run B (a child process) is preempted after step 3 (exit 17,
# step 2 its last save), run C resumes it at step 3.
CKPT = dict(arch="llama3.2-3b", smoke=False, n_layers=2, steps=6, every=2, preempt_at=3, rows=4,
            seq=256)
# C's losses against A's for steps 3-5: A and B reach step 2 through the same
# steps, so they agree bit for bit unless a kernel on the way sums in an
# order that varies between runs; this allows a last-bit difference in a
# loss of ~12, far below any error of the checkpoint itself.  Bit-equal
# losses are reported as such.
CKPT_LOSS_ATOL = 1e-3


@contextmanager
def _recorded_checkpointers(made):
    """Every AsyncCheckpointer that train() makes, appended to ``made``."""
    from repro_torch.launch import train as train_mod

    orig = train_mod.AsyncCheckpointer

    class Recording(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    train_mod.AsyncCheckpointer = Recording
    try:
        yield
    finally:
        train_mod.AsyncCheckpointer = orig


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def phase_ckpt(dev):
    """Checkpoints at full width: run A through train(ckpt_dir, ckpt_every),
    its last save restored and held to A's final state bit for bit; run B
    preempted in a child process (exit code 17); run C resumed from B's
    last save, its losses against A's.  Bytes written, snapshot and write
    seconds a save, restore seconds."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.launch.train import train
    from repro_torch.pallas_ws import launches, reset_launches

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    c = CKPT
    root = tempfile.mkdtemp(prefix="ckpt-phase-")
    dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
    log(f"[ckpt] {c['arch']} at full width, depth {c['n_layers']}, AdamW; checkpoints "
        f"under {root} ({shutil.disk_usage(root).free / 1e9:.1f} GB free)")
    common = dict(smoke=c["smoke"], n_layers=c["n_layers"], steps=c["steps"], rows=c["rows"],
                  seq=c["seq"], seed=SEED, ckpt_every=c["every"], log_every=1)
    try:
        made = []
        reset_launches()
        with _recorded_checkpointers(made):
            t0 = time.perf_counter()
            state_a, losses_a = train(c["arch"], ckpt_dir=dir_a, device=dev, **common)
            run_a_s = time.perf_counter() - t0
        saves = made[0].records
        want_steps = [s for s in range(c["steps"]) if s % c["every"] == 0 or s == c["steps"] - 1]
        if [r["step"] for r in saves] != want_steps or latest_step(dir_a) != c["steps"] - 1:
            raise AssertionError(f"[ckpt] run A saved {[r['step'] for r in saves]}, latest "
                                 f"{latest_step(dir_a)}, want {want_steps}")
        kept = sorted(os.listdir(dir_a))
        if kept != [f"step_{s:08d}" for s in want_steps[-3:]]:
            raise AssertionError(f"[ckpt] run A kept {kept}, want the newest 3 of {want_steps}")
        # the last save restored onto the card: A's final state, bit for bit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, step = restore(dir_a, state_a, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        n_leaves = n_bytes = 0
        for (path, g), (_, w) in zip(_flatten(got), _flatten(state_a)):
            if isinstance(w, torch.Tensor):
                if g.dtype != w.dtype or not torch.equal(_bits(g), _bits(w.detach())):
                    raise AssertionError(f"[ckpt] restored {path} differs from the saved state")
                n_leaves += 1
                n_bytes += w.numel() * w.element_size()
            elif g != w:
                raise AssertionError(f"[ckpt] restored {path} = {g}, saved {w}")
        if step != c["steps"] - 1:
            raise AssertionError(f"[ckpt] restored step {step}")
        n_params = sum(t.numel() for t in _leaves(state_a["params"]))
        del got, state_a
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(dir_a)
        log(f"[ckpt] run A: {c['steps']} steps in {run_a_s:.1f} s, losses {losses_a}; "
            f"{n_params / 1e9:.3f} B parameters; saves "
            + ", ".join(f"step {r['step']}: {r['bytes'] / 1e9:.2f} GB, snapshot "
                        f"{r['snapshot_s']:.2f} s, background write {r['write_s']:.2f} s"
                        for r in saves)
            + f"; the last save restored in {restore_s:.2f} s: {n_leaves} tensors "
            f"({n_bytes / 1e9:.2f} GB) and the step bit-equal to run A's final state")

        # run B: preempted after step preempt_at in a process of its own
        env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", c["arch"],
               *([] if c["smoke"] else ["--full-config"]), "--device", str(dev),
               "--n-layers", str(c["n_layers"]), "--steps", str(c["steps"]),
               "--rows", str(c["rows"]), "--seq", str(c["seq"]), "--seed", str(SEED),
               "--ckpt-dir", dir_b, "--ckpt-every", str(c["every"]), "--preempt-at",
               str(c["preempt_at"]), "--log-every", "1"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        run_b_s = time.perf_counter() - t0
        losses_b = [json.loads(line.split(" ", 1)[1])["loss"] for line in
                    proc.stdout.splitlines() if line.startswith("[train] {")]
        last_b = max(s for s in want_steps if s <= c["preempt_at"])
        if proc.returncode != 17 or latest_step(dir_b) != last_b:
            raise AssertionError(f"[ckpt] run B exited {proc.returncode} (want 17), latest "
                                 f"save {latest_step(dir_b)} (want {last_b}):\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        log(f"[ckpt] run B (child process): exit code 17 after step {c['preempt_at']} in "
            f"{run_b_s:.1f} s; losses (4 decimals, as logged) {losses_b}; latest save {last_b}")

        # run C: resumed from B's last save
        made.clear()
        with _recorded_checkpointers(made):
            t0 = time.perf_counter()
            _, losses_c = train(c["arch"], ckpt_dir=dir_b, resume=True, device=dev, **common)
            run_c_s = time.perf_counter() - t0
        want_c = losses_a[last_b + 1:]
        diff = max(abs(a - b) for a, b in zip(losses_c, want_c)) if losses_c else float("inf")
        if len(losses_c) != len(want_c) or not diff <= CKPT_LOSS_ATOL:
            raise AssertionError(f"[ckpt] run C losses {losses_c} against run A's {want_c}")
        if not all(abs(a - round(b, 4)) <= 5e-5 + CKPT_LOSS_ATOL
                   for a, b in zip(losses_b, losses_a)):
            raise AssertionError(f"[ckpt] run B's logged losses {losses_b} against A's {losses_a}")
        counts = {n: launches[n] for n in launches}
        log(f"[ckpt] run C: resumed at step {last_b + 1}, {len(losses_c)} steps in "
            f"{run_c_s:.1f} s, losses {losses_c} against run A's {want_c}: "
            + ("bit-equal" if losses_c == want_c else
               f"max |diff| {diff:.3g} (<= {CKPT_LOSS_ATOL}: a kernel summing in an order "
               "that varies between runs)")
            + f"; saves {[r['step'] for r in made[0].records]}; ws launches {counts}; phase "
            f"{time.perf_counter() - t_phase:.1f} s; card: {card_line()}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    from repro_torch.configs import get_config

    dtype = get_config(c["arch"], smoke=c["smoke"]).dtype
    return dict(model=f"{c['arch']} (depth {c['n_layers']}, {dtype}, AdamW)", losses_a=losses_a,
                losses_b_logged=losses_b, losses_c=losses_c, resumed_at=last_b + 1,
                losses_bit_equal=losses_c == want_c, loss_max_abs_diff=diff,
                saves=saves, restore_s=restore_s, restored_bytes=n_bytes,
                run_s=dict(a=run_a_s, b=run_b_s, c=run_c_s), launches=counts)


# ---------------------------------------------------------------------------
# the ssm family: mamba2-2.7b and zamba2-2.7b at full width and depth


# Both bf16 at full width and full depth (64 and 54 layers).  Prefill of
# S + extra tokens against a prefill of S then `extra` dense decode steps (S +
# extra = ssm_chunk: a prompt past the chunk must be a multiple of it);
# serving: 2 replicas x 4 slots x 1024 positions, 8 requests of 16-128 tokens
# (at most ssm_chunk), 16 new tokens each, run twice; training: 2 steps
# through train() at depth 2 (zamba2 at 6, its first shared attention block),
# 4 x 256 tokens.  The scan's model inputs: mamba2's layer 0 in a prefill of
# 4 x 1024 tokens.
SSM = dict(archs=("mamba2-2.7b", "zamba2-2.7b"), smoke=False, S=120, extra=8, slots=4, cap=1024,
           requests=8, prompt_lens=(16, 129), max_new=16, train_steps=2, train_rows=4,
           train_seq=256, train_depth={"mamba2-2.7b": 2, "zamba2-2.7b": 6},
           scan_batch=4, scan_seq=1024)
# Prefill against decode.  fp32: the decode path's last logits within
# SSM_FP32_TOL x max(1, max |logit|) of the prefill's (the reference's
# 2e-3 of tests/test_models_smoke.py).  bf16: the bf16 decode path may stray
# from the fp32 prefill at most SSM_SLACK times as far as the bf16 prefill
# does (both round the same activations to bf16, along other paths);
# the control, a decode whose conv state is not shifted, must stray further.
SSM_FP32_TOL = 2e-3
SSM_SLACK = 2.0


@contextmanager
def _captured_scan(record):
    """The first ssd_chunked call's inputs (x, dt, A, B, C, chunk) into
    ``record`` (the Mamba-2 layer's scan, as the model calls it)."""
    from repro_torch.models import ssm as ssm_mod

    real = ssm_mod.ssd_chunked

    def capture(x, dt, A, B, C, chunk, init_state=None):
        if not record:
            record.extend([t.detach().clone() for t in (x, dt, A, B, C)] + [chunk])
        return real(x, dt, A, B, C, chunk, init_state)

    ssm_mod.ssd_chunked = capture
    try:
        yield
    finally:
        ssm_mod.ssd_chunked = real


@contextmanager
def _conv_state_not_shifted():
    """The control's fault: a decode whose conv state keeps its old window."""
    from repro_torch.models import ssm as ssm_mod

    real = ssm_mod._conv_step

    def stale(x_new, conv_state, w):
        out, _ = real(x_new, conv_state, w)
        return out, conv_state

    ssm_mod._conv_step = stale
    try:
        yield
    finally:
        ssm_mod._conv_step = real


def _ssm_prefill_vs_decode(params, cfg, dev, rng):
    """Last logits of a prefill of S + extra tokens against a prefill of S
    then `extra` decode steps, in bf16 and in fp32 (the weights widened),
    and the control (bf16, conv state not shifted)."""
    from repro_torch.models import decode_step, prefill

    S, extra, V = SSM["S"], SSM["extra"], cfg.vocab_size
    toks = torch.from_numpy(rng.integers(0, V, (1, S + extra))).to(dev)

    def via_decode(p, cfg_):
        _, caches = prefill(p, cfg_, {"tokens": toks[:, :S]}, capacity=S + extra)
        for i in range(S, S + extra):
            lg, caches = decode_step(p, cfg_, caches, toks[:, i:i + 1], i)
        return lg[0, :V]

    def via_prefill(p, cfg_):
        return prefill(p, cfg_, {"tokens": toks}, capacity=S + extra)[0][0, :V]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec16 = via_decode(params, cfg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    pre16 = via_prefill(params, cfg)
    with _conv_state_not_shifted():
        ctl16 = via_decode(params, cfg)
    cfg32 = cfg.replace(dtype="float32")
    params32 = _map(params, lambda t: t.float())
    pre32, dec32 = via_prefill(params32, cfg32), via_decode(params32, cfg32)
    del params32
    torch.cuda.empty_cache()
    scale = max(1.0, float(pre32.abs().max()))
    err32 = float((dec32 - pre32).abs().max())
    err_pre, err_dec, err_ctl = (float((x - pre32).abs().max()) for x in (pre16, dec16, ctl16))
    out = dict(S=S, extra=extra, logit_scale=scale, fp32_decode_vs_prefill=err32,
               fp32_limit=SSM_FP32_TOL * scale, bf16_prefill_vs_fp32=err_pre,
               bf16_decode_vs_fp32=err_dec, bf16_limit=SSM_SLACK * err_pre,
               control_no_conv_shift_vs_fp32=err_ctl, decode_path_s=decode_s,
               argmax_agree=int(dec16.argmax()) == int(pre16.argmax()))
    log(f"[ssm] {cfg.name}: prefill of {S + extra} tokens against prefill of {S} + {extra} "
        f"decode steps: fp32 max |diff| {err32:.4g} (<= {SSM_FP32_TOL} x {scale:.4g}); bf16 "
        f"decode path {err_dec:.4g} from the fp32 prefill, bf16 prefill {err_pre:.4g} (<= "
        f"{SSM_SLACK} x); control (conv state not shifted) {err_ctl:.4g} (must exceed "
        f"{SSM_SLACK * err_pre:.4g}); argmax agree {out['argmax_agree']}")
    if not (err32 <= SSM_FP32_TOL * scale and err_dec <= SSM_SLACK * err_pre):
        raise AssertionError(f"[ssm] {cfg.name}: decode and prefill disagree: {out}")
    if not err_ctl > SSM_SLACK * err_pre:
        raise AssertionError(f"[ssm] {cfg.name}: the control passed: {out}")
    return out


def _ssm_serve(params, cfg, rng):
    """2 replicas x 4 slots behind the frontend, 8 requests, twice: the same
    greedy streams, every request completed, no ws kernel launched."""
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    c = SSM
    lens = rng.integers(*c["prompt_lens"], size=c["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    runs = []
    for _ in range(2):
        front = WorkStealingFrontend(lambda: ContinuousBatcher(
            params, cfg, slots=c["slots"], capacity=c["cap"]), n_replicas=2)
        for rid, p in enumerate(prompts):
            front.submit(0, Request(rid=rid, tokens=p, max_new=c["max_new"]))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = front.run(max_iters=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: launches[n] for n in launches}
        if sorted(done) != list(range(len(prompts))) or front.rejected or any(counts.values()):
            raise AssertionError(f"[ssm] {cfg.name} serving: completed {sorted(done)}, "
                                 f"rejected {sorted(front.rejected)}, launches {counts}")
        if any(len(r.out) != c["max_new"] or not all(0 <= t < cfg.vocab_size for t in r.out)
               for r in done.values()):
            raise AssertionError(f"[ssm] {cfg.name} serving produced {_streams(done)}")
        stats = front.stats()
        lat = np.concatenate([np.asarray(b.metrics.step_latency_s)
                              for b in front.batchers]) * 1e3
        tokens = sum(len(r.out) for r in done.values())
        runs.append(dict(streams=_streams(done), wall_s=wall, new_tokens=tokens,
                         tokens_per_s=tokens / wall,
                         steps=sum(s["steps"] for s in stats["batchers"]),
                         step_ms_p50=float(np.percentile(lat, 50)),
                         step_ms_p99=float(np.percentile(lat, 99)),
                         stolen=stats["totals"]["stolen"]))
        del front
    if runs[0]["streams"] != runs[1]["streams"]:
        raise AssertionError(f"[ssm] {cfg.name}: greedy streams differ between two runs")
    r = runs[1]
    log(f"[ssm] {cfg.name} serving (2 replicas x {c['slots']} slots x {c['cap']} positions, "
        f"{len(prompts)} requests of {int(lens.min())}-{int(lens.max())} tokens, "
        f"{c['max_new']} new each, the dense decode step): {r['new_tokens']} new tokens in "
        f"{r['wall_s']:.2f} s ({r['tokens_per_s']:.2f} tokens/s incl. prefill), {r['steps']} "
        f"steps, step p50 {r['step_ms_p50']:.2f} ms p99 {r['step_ms_p99']:.2f} ms, stolen "
        f"{r['stolen']}; first run {runs[0]['wall_s']:.2f} s, step p50 "
        f"{runs[0]['step_ms_p50']:.2f} ms; greedy streams equal in both runs; no ws kernel")
    return dict({k: v for k, v in r.items() if k != "streams"}, prompt_tokens=int(lens.sum()),
                first_run_wall_s=runs[0]["wall_s"], first_run_step_ms_p50=runs[0]["step_ms_p50"],
                streams_reproducible=True)


def _ssm_step_profile(params, cfg, dev):
    """One dense decode step at the serving shape (4 slots, 1024 positions,
    every slot at position 100) on its own: its wall time (host and
    device, median of 5 after a warm-up) and, under torch.profiler, its
    device kernels: their number, their summed device time, the GEMMs among
    them, and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, init_caches

    c = SSM
    caches = init_caches(cfg, c["slots"], c["cap"], device=dev)
    tok = torch.zeros((c["slots"], 1), dtype=torch.long, device=dev)
    pos = np.full(c["slots"], 100)
    decode_step(params, cfg, caches, tok, pos)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(params, cfg, caches, tok, pos)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_step(params, cfg, caches, tok, pos)
        torch.cuda.synchronize()
    n = gemm_n = 0
    us = gemm_us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = e.cuda_time_total if t is None else t
        if not t:
            continue
        n += e.count
        us += t
        if any(w in e.key.lower() for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
            gemm_n += e.count
            gemm_us += t
    wall = float(np.median(walls))
    out = dict(wall_ms=wall, kernels=n, device_ms=us / 1e3 if n else None,
               gemm_kernels=gemm_n, gemm_ms=gemm_us / 1e3 if n else None,
               idle_share=1 - us / 1e3 / wall if n else None)
    log(f"[ssm] {cfg.name} one decode step (4 slots at position 100): {wall:.2f} ms wall; "
        + (f"{n} device kernels, {us / 1e3:.3f} ms of device time ({gemm_n} GEMMs "
           f"{gemm_us / 1e3:.3f} ms): the device idle {out['idle_share']:.3f} of the step"
           if n else "the profiler saw no device time (not measured)"))
    return out


def _ssm_train(arch, dev):
    from repro_torch.launch.train import train

    c = SSM
    depth = c["train_depth"][arch]
    peaks, step_s = [], []

    def on_step(step, state, m, seconds):
        step_s.append(seconds)
        peaks.append(torch.cuda.max_memory_allocated())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, losses = train(arch, smoke=c["smoke"], n_layers=depth, steps=c["train_steps"],
                      rows=c["train_rows"], seq=c["train_seq"], seed=SEED, device=dev,
                      on_step=on_step, log_every=1)
    if len(losses) != c["train_steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"[ssm] {arch} train losses {losses}")
    log(f"[ssm] {arch} train() at depth {depth}: losses {losses}, step seconds "
        f"{[round(s, 3) for s in step_s]}, peak device memory {max(peaks) / 1e9:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(depth=depth, losses=losses, step_s=step_s, peak_bytes=max(peaks))


def phase_ssm(dev):
    """mamba2-2.7b and zamba2-2.7b (bf16, full width and depth): prefill
    against decode (with the conv-shift control), serving twice, 2 train()
    steps; mamba2's layer-0 scan inputs from a 4 x 1024-token prefill are
    captured for _ssm_scan.  Returns (results, captured inputs)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill

    t_phase = time.perf_counter()
    out, captured = {}, []
    for arch in SSM["archs"]:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch, smoke=SSM["smoke"])
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED, device=dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        log(f"[ssm] {arch}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters "
            f"(param_count {cfg.param_count() / 1e9:.3f} B), {n_bytes / 1e9:.2f} GB, "
            f"initialised in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(SEED)
        res = dict(layers=cfg.n_layers, params=n_params, weight_bytes=n_bytes)
        res["prefill_vs_decode"] = _ssm_prefill_vs_decode(params, cfg, dev, rng)
        res["serving"] = _ssm_serve(params, cfg, rng)
        res["step_profile"] = _ssm_step_profile(params, cfg, dev)
        if arch == "mamba2-2.7b":
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                 (SSM["scan_batch"], SSM["scan_seq"]))).to(dev)
            with _captured_scan(captured), torch.no_grad():
                lg, _ = prefill(params, cfg, {"tokens": toks})
            torch.cuda.synchronize()
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"[ssm] {arch}: the {tuple(toks.shape)} prefill's logits "
                                     "are not finite")
        del params
        res["train"] = _ssm_train(arch, dev)
        out[arch] = res
    log(f"[ssm] phase {time.perf_counter() - t_phase:.1f} s; card: {card_line()}")
    return out, captured


def _ssm_scan(captured):
    """The ssd_scan kernel on mamba2's layer-0 scan inputs from the ssm
    phase's 4 x 1024-token prefill, against ssd_chunked on the same inputs
    (y and the final state, the kernels phase's limits).  fp32: the layer's
    dt is fp32 after softplus and the kernel takes one type for x, dt, B
    and C, so x, B and C (bf16) are widened, exactly.  Device times of
    both."""
    from repro_torch.kernels import launches as klaunches
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan as ssd_fwd
    from repro_torch.models.ssm import ssd_chunked

    x, dt, A, B, C, chunk = captured
    xs = tuple(t.float() for t in (x, dt, A, B, C))
    b, S, H, P = x.shape
    n0 = klaunches["ssd_scan"]
    y, fin = ssd_fwd(*xs, chunk=chunk)
    torch.cuda.synchronize()
    n = klaunches["ssd_scan"] - n0
    if y.is_cuda and n != 1:
        raise AssertionError(f"[ssm] ssd_scan on the model's inputs launched {n} times, want 1")
    ry, rfin = ssd_chunked(*xs, chunk)
    checks = _Checks()
    err = checks.held("ssd_scan on mamba2 layer 0's inputs: y", y, ry)
    state_err = checks.held("ssd_scan on mamba2 layer 0's inputs: final state", fin, rfin,
                            "state")
    checks.verdict()
    k_ms = _device_ms(lambda _: ssd_fwd(*xs, chunk=chunk), KTIMED)
    r_ms = _device_ms(lambda _: ssd_chunked(*xs, chunk), KTIMED)
    out = dict(at="mamba2-2.7b layer 0, prefill inputs", shape=dict(b=b, S=S, H=H, P=P,
               N=B.shape[-1], chunk=chunk), dtype="float32 (x, B, C widened from bf16)",
               launches=n, max_abs_err=err, state_max_abs_err=state_err,
               ms_device=k_ms, ssd_chunked_ms_device=r_ms,
               dt_range=[float(dt.min()), float(dt.max())],
               max_abs_y=float(ry.abs().max()), max_abs_state=float(rfin.abs().max()))
    log(f"[ssm] ssd_scan on mamba2-2.7b layer 0's own scan inputs (b {b}, S {S}, H {H}, P {P}, "
        f"N {B.shape[-1]}, chunk {chunk}, fp32): y max |err| {err:.3g}, state {state_err:.3g} "
        f"against ssd_chunked; device {k_ms:.3f} ms, ssd_chunked {r_ms:.3f} ms; dt in "
        f"[{out['dt_range'][0]:.3g}, {out['dt_range'][1]:.3g}]; {n} launch; card: {card_line()}")
    return out


# ---------------------------------------------------------------------------
# three more families on their entry points: MLA served (deepseek-v2), the
# vlm (pixtral-12b) and the encoder-decoder (whisper-base)


FAMILIES = dict(
    deepseek=dict(depth=2, S=64, extra=4, slots=4, cap=1024, requests=8, prompt_lens=(8, 65),
                  max_new=8),
    pixtral=dict(rows=4, text_lens=(64, 129), cap=1024 + 256, steps=4),
    whisper=dict(S=32, extra=8, train_steps=2, train_rows=4, train_seq=64),
)
# Prefill against decode, one row, the decode path's last logits against a
# prefill of the whole sequence.  fp32 (the weights widened): within
# FAM_FP32_TOL x max(1, max |logit|), and the decode path's final hidden
# state rounded to bf16 and moved one bf16 ulp (the bf16 control) must miss
# that limit, so the check tells fp32 from bf16.  bf16: the decode path may
# stray from the fp32 prefill at most LOGIT_SLACK times as far as the bf16
# prefill does (both round the same activations along other paths); a
# faulty decode (the layers' caches swapped, or positions not offset by the
# patches) must stray further.  The fp32 side runs the kernels' plain
# versions, so the yardstick does not come from a kernel under test.  MoE routing is discontinuous: the decode
# path replays the longer prefill's top-k, and the flips are counted.
FAM_FP32_TOL = 1e-4


def _fam_held(model, params32, cfg32, pre32, h32, pre16, dec16, ctl16, fault, tag="families"):
    """The prefill-against-decode checks of one model (see FAM_FP32_TOL)."""
    V = cfg32.vocab_size
    lg32 = fp32_logits(params32, cfg32, h32)[0, :V]
    ulp = fp32_logits(params32, cfg32, one_ulp(h32.bfloat16(), SEED).float())[0, :V]
    scale = max(1.0, float(pre32.abs().max()))
    limit = FAM_FP32_TOL * scale
    err32, err_ulp = (float((x - pre32).abs().max()) for x in (lg32, ulp))
    err_pre, err_dec, err_ctl = (float((x - pre32).abs().max()) for x in (pre16, dec16, ctl16))
    out = dict(logit_scale=scale, fp32_decode_vs_prefill=err32, fp32_limit=limit,
               bf16_one_ulp_control=err_ulp, bf16_prefill_vs_fp32=err_pre,
               bf16_decode_vs_fp32=err_dec, bf16_limit=LOGIT_SLACK * err_pre,
               control=fault, control_vs_fp32=err_ctl,
               argmax_agree=int(dec16.argmax()) == int(pre16.argmax()))
    log(f"[{tag}] {model}: prefill against decode: fp32 max |diff| {err32:.4g} (<= "
        f"{FAM_FP32_TOL} x {scale:.4g} = {limit:.4g}; the bf16 one-ulp control {err_ulp:.4g} "
        f"must exceed it); bf16 decode path {err_dec:.4g} from the fp32 prefill, bf16 prefill "
        f"{err_pre:.4g} (<= {LOGIT_SLACK} x); control ({fault}) {err_ctl:.4g} (must exceed "
        f"{LOGIT_SLACK * err_pre:.4g}); argmax agree {out['argmax_agree']}")
    if not (err32 <= limit < err_ulp and err_dec <= LOGIT_SLACK * err_pre):
        raise AssertionError(f"[{tag}] {model}: decode and prefill disagree: {out}")
    if not err_ctl > LOGIT_SLACK * err_pre:
        raise AssertionError(f"[{tag}] {model}: the control passed: {out}")
    return out


def _widen(tree):
    """Every tensor of a parameter dict in fp32, in place, one at a time (the
    bf16 copy of each is freed as its fp32 one is made)."""
    for k, v in tree.items():
        tree[k] = _widen(v) if isinstance(v, dict) else v.float()
    return tree


def _fam_init(cfg, full, dev, tag="families"):
    from repro_torch.models import init_params

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{tag}] {cfg.name} depth {cfg.n_layers} (of {full.n_layers}) at full width: "
        f"{n_params / 1e9:.3f} B parameters (param_count {cfg.param_count() / 1e9:.3f} B), "
        f"{n_bytes / 1e9:.2f} GB ({cfg.dtype}), initialised in {time.perf_counter() - t0:.1f} s")
    return params, dict(layers=cfg.n_layers, params=n_params, weight_bytes=n_bytes)


def _fam_deepseek(dev):
    """deepseek-v2 served: MLA decode on the dense step, the expert kernel in
    every MoE layer of every prefill and decode step."""
    from repro_torch.configs.deepseek_v2_236b import CONFIG
    from repro_torch.models import decode_hidden, decode_step, prefill
    from repro_torch.models.attention import MLACache
    from repro_torch.models.model import Caches, _logits
    from repro_torch.pallas_ws import launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    c = FAMILIES["deepseek"]
    cfg = CONFIG.replace(n_layers=c["depth"], moe_dispatch="ws")
    L, V = cfg.n_layers, cfg.vocab_size
    params, out = _fam_init(cfg, CONFIG, dev)
    rng = np.random.default_rng(SEED)

    # 8 requests through 2 replicas, all submitted to replica 0
    lens = rng.integers(*c["prompt_lens"], size=c["requests"])
    prompts = [rng.integers(0, V, size=int(n)).astype(np.int32) for n in lens]
    front = WorkStealingFrontend(lambda: ContinuousBatcher(
        params, cfg, slots=c["slots"], capacity=c["cap"]), n_replicas=2)
    for rid, p in enumerate(prompts):
        front.submit(0, Request(rid=rid, tokens=p, max_new=c["max_new"]))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before = dict(launches)
    t0 = time.perf_counter()
    done = front.run(max_iters=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _since(before)
    stats = front.stats()
    steps = sum(s["steps"] for s in stats["batchers"])
    prefills = sum(s["admitted"] for s in stats["batchers"])
    if sorted(done) != list(range(len(prompts))) or front.rejected:
        raise AssertionError(f"[families] deepseek completed {sorted(done)}, rejected "
                             f"{sorted(front.rejected)}")
    if any(len(r.out) != c["max_new"] or not all(0 <= t < V for t in r.out)
           for r in done.values()):
        raise AssertionError(f"[families] deepseek served {_streams(done)}")
    want = {"ws_attention": 0, "ws_expert": (steps + prefills) * L, "ws_expert_grad": 0,
            "ws_unified": 0}
    if counts != want or any(b.use_ws for b in front.batchers):
        raise AssertionError(f"[families] deepseek serving launched {counts}, want {want} "
                             f"(the dense MLA step, the expert kernel a layer)")
    if stats["totals"]["stolen"] == 0:
        raise AssertionError("[families] deepseek: replica 1 stole nothing")
    peak = torch.cuda.max_memory_allocated()
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    tokens = sum(len(r.out) for r in done.values())
    # one engine step of 4 slots counted alone
    b = ContinuousBatcher(params, cfg, slots=4, capacity=c["cap"])
    for rid in range(4):
        assert b.admit(Request(rid=rid, tokens=prompts[rid], max_new=c["max_new"]))
    before, recorded = dict(launches), []
    with expert_launches(lambda *r: recorded.append(r)):
        b.step()
    torch.cuda.synchronize()
    per_step = _since(before)
    if per_step != {"ws_attention": 0, "ws_expert": L, "ws_expert_grad": 0, "ws_unified": 0}:
        raise AssertionError(f"[families] one deepseek decode step launched {per_step}")
    if len(recorded) != L:
        raise AssertionError(f"[families] the launch hook saw {len(recorded)} of {L} expert "
                             "launches")
    # decode routing at deepseek's widths: each launch against the plain version
    launch_err, control_err = _hold_expert_launches("families deepseek", recorded)
    out["expert_launches"] = dict(max_abs_err=launch_err, bf16_control_err=control_err)
    del b, front, recorded
    out["serving"] = dict(
        requests=len(done), prompt_tokens=int(lens.sum()), new_tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, decode_steps=steps, prefills=prefills,
        step_ms_p50=float(np.percentile(lat, 50)), step_ms_p99=float(np.percentile(lat, 99)),
        stolen=stats["totals"]["stolen"], launches=counts, launches_per_decode_step=per_step,
        peak_bytes=peak)
    log(f"[families] deepseek serving (2 replicas x {c['slots']} slots x {c['cap']} "
        f"positions, the dense MLA step): {len(done)} requests, {tokens} new tokens in "
        f"{wall:.2f} s ({tokens / wall:.2f} tokens/s incl. prefill); {steps} decode steps, "
        f"{prefills} prefills, step p50 {out['serving']['step_ms_p50']:.2f} ms p99 "
        f"{out['serving']['step_ms_p99']:.2f} ms; stolen {stats['totals']['stolen']}; "
        f"launches {counts}; one decode step {per_step} (ws_expert {per_step['ws_expert']} "
        f"a step, want {L}); peak device memory {peak / 1e9:.2f} GB")

    # prefill against decode, the decode path replaying the prefill's routing
    S, extra = c["S"], c["extra"]
    toks = torch.from_numpy(rng.integers(0, V, (1, S + extra))).to(dev)

    def paths(p, cfg_, slip=False):
        tape = []
        with routing_tape(record=tape) as rec:
            pre = prefill(p, cfg_, {"tokens": toks}, capacity=S + extra)[0][0, :V]
        replay = [(g[:S], i[:S]) for g, i in tape] + [
            (g[j:j + 1], i[j:j + 1]) for j in range(S, S + extra) for g, i in tape]
        with routing_tape(replay=replay) as rep:
            _, caches = prefill(p, cfg_, {"tokens": toks[:, :S]}, capacity=S + extra)
            if slip:  # the control: each layer reads and writes the other's cache
                caches = Caches(kv=MLACache(*(t.flip(0).contiguous() for t in caches.kv)))
            for i in range(S, S + extra - 1):
                _, caches = decode_step(p, cfg_, caches, toks[:, i:i + 1], i)
            h = decode_hidden(p, cfg_, caches, toks[:, -1:], S + extra - 1)[0]
        if not (rec[0] == L and rep[0] == L * (1 + extra)):
            raise AssertionError(f"[families] router calls {rec[0]} and {rep[0]}")
        return pre, h, rep[1]

    pre16, h16, flips16 = paths(params, cfg)
    dec16 = _logits(params, cfg, h16)[0, :V]
    _, h_ctl, _ = paths(params, cfg, slip=True)
    ctl16 = _logits(params, cfg, h_ctl)[0, :V]
    params32 = _widen(params)
    del params
    cfg32 = cfg.replace(dtype="float32")
    with plain_versions():
        pre32, h32, flips32 = paths(params32, cfg32)
    torch.cuda.synchronize()
    out["prefill_vs_decode"] = dict(
        S=S, extra=extra, routing_flips_bf16=flips16, routing_flips_fp32=flips32,
        **_fam_held("deepseek-v2-236b", params32, cfg32, pre32, h32, pre16, dec16, ctl16,
                    "the 2 layers' MLA caches swapped"))
    log(f"[families] deepseek: top-6 sets that differed between the decode path and the "
        f"longer prefill (replayed): bf16 {flips16}, fp32 {flips32} of {L * (S + extra)}")
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _fam_pixtral(dev):
    """pixtral-12b at full depth: 4 rows of patches and text, the ws step
    (host Put and the captured device-Put step) against the dense step and
    against a longer prefill."""
    from repro_torch.configs.pixtral_12b import CONFIG
    from repro_torch.models import decode_hidden_ws, decode_step, decode_step_ws, init_caches
    from repro_torch.models import prefill
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import Caches, cache_tensors
    from repro_torch.pallas_ws import launches

    c = FAMILIES["pixtral"]
    cfg = CONFIG
    L, V, n_p, R, cap = cfg.n_layers, cfg.vocab_size, cfg.n_patches, c["rows"], c["cap"]
    params, out = _fam_init(cfg, CONFIG, dev)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    patches = (torch.randn((R, n_p, cfg.d_model), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    text = [torch.from_numpy(rng.integers(0, V, int(n))).to(dev)
            for n in rng.integers(*c["text_lens"], size=R)]

    # each row prefilled alone (patches, then its text) into its slot
    caches = init_caches(cfg, R, cap, device=dev)
    first, pos = [], np.zeros(R, np.int64)
    t0 = time.perf_counter()
    for b in range(R):
        lg, c1 = prefill(params, cfg, {"tokens": text[b][None], "patches": patches[b:b + 1]},
                         capacity=cap)
        for full, one in zip(cache_tensors(caches), cache_tensors(c1)):
            full[:, b] = one[:, 0]
        first.append(int(lg[0, :V].argmax()))
        pos[b] = n_p + len(text[b])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def clone(cc):
        return Caches(kv=KVCache(cc.kv.k.clone(), cc.kv.v.clone()))

    # the ws step (host Put), its tokens fed to the next
    tok0 = torch.tensor(first, device=dev)[:, None]
    ws_c, tok, fed, lgs, per_step, recorded = clone(caches), tok0, [], [], [], []
    for j in range(c["steps"]):
        before = dict(launches)
        with attention_launches(recorded.append) if j == 0 else nullcontext():
            lg, ws_c = decode_step_ws(params, cfg, ws_c, tok, pos + j)
        torch.cuda.synchronize()
        per_step.append(_since(before))
        if j == 0:  # step 0's last launch, before a later step writes the caches
            if len(recorded) != L:
                raise AssertionError(f"[families] the launch hook saw {len(recorded)} of {L} "
                                     "attention launches")
            out["attention_launch"] = _hold_attention_launch("families pixtral",
                                                             recorded[-1], L)
            del recorded
        fed.append(tok)
        lgs.append(lg[:, :V])
        tok = lg[:, :V].argmax(-1, keepdim=True)
    want = {"ws_attention": L, "ws_expert": 0, "ws_expert_grad": 0, "ws_unified": 0}
    if any(s != want for s in per_step):
        raise AssertionError(f"[families] pixtral ws steps launched {per_step}, want {want}")
    if not all(bool(torch.isfinite(x).all()) for x in lgs):
        raise AssertionError("[families] pixtral ws logits not finite")
    del ws_c
    lg_dense0 = decode_step(params, cfg, clone(caches), tok0, pos)[0][:, :V]
    # the device Put: the captured step on the same caches, bit-equal
    out["jit_ws"] = _jit_step_checks("families pixtral", params, cfg, caches, tok0, pos,
                                     lgs[0], 0.0)

    # row 0's longer prefill, and the control: its text decoded at positions
    # not offset by the patches
    long0 = torch.cat([text[0]] + [t[0] for t in fed])[None]
    pre16 = prefill(params, cfg, {"tokens": long0, "patches": patches[:1]},
                    capacity=long0.shape[1] + n_p)[0][0, :V]
    _, c0 = prefill(params, cfg, {"tokens": text[0][None], "patches": patches[:1]},
                    capacity=cap)
    for j in range(c["steps"]):
        ctl, c0 = decode_step_ws(params, cfg, c0, fed[j][:1], np.array([pos[0] - n_p + j]))
    ctl16 = ctl[0, :V]
    del c0

    # fp32: the weights widened in place, the dense step on the caches widened
    params32 = _widen(params)
    del params
    cfg32 = cfg.replace(dtype="float32")
    c32 = Caches(kv=KVCache(caches.kv.k.float(), caches.kv.v.float()))
    del caches
    lg_ref = decode_step(params32, cfg32, c32, tok0, pos)[0][:, :V]
    del c32
    err_ws, err_dense = (float((x - lg_ref).abs().max()) for x in (lgs[0], lg_dense0))
    log(f"[families] pixtral step 0 (4 rows, text {[len(t) for t in text]} tokens after "
        f"{n_p} patches) vs the fp32 dense step (max |logit| {float(lg_ref.abs().max()):.4g}): "
        f"ws {err_ws:.4g}, dense bf16 {err_dense:.4g} (ws <= {LOGIT_SLACK} x dense); argmax "
        f"agree ws/dense {int((lgs[0].argmax(-1) == lg_dense0.argmax(-1)).sum())}/{R}")
    if not err_ws <= LOGIT_SLACK * err_dense:
        raise AssertionError("[families] pixtral ws logits stray further from the fp32 step "
                             "than the dense step's")
    # row 0's decode path in fp32 on the ws step, against its fp32 prefill
    pre32 = prefill(params32, cfg32, {"tokens": long0, "patches": patches[:1].float()},
                    capacity=long0.shape[1] + n_p)[0][0, :V]
    _, c0 = prefill(params32, cfg32, {"tokens": text[0][None], "patches": patches[:1].float()},
                    capacity=cap)
    for j in range(c["steps"] - 1):
        _, c0 = decode_step_ws(params32, cfg32, c0, fed[j][:1], pos[:1] + j)
    j = c["steps"] - 1
    h32 = decode_hidden_ws(params32, cfg32, c0, fed[j][:1], pos[:1] + j)[0]
    out["prefill_vs_decode"] = _fam_held("pixtral-12b", params32, cfg32, pre32, h32, pre16,
                                         lgs[-1][0], ctl16, "positions not offset by the "
                                         "patches")
    out.update(rows=R, text_tokens=[len(t) for t in text], patches=n_p,
               prefill_s=prefill_s, launches_per_step=per_step[0],
               step0_logit_err_ws_vs_fp32=err_ws, step0_logit_err_dense_vs_fp32=err_dense)
    log(f"[families] pixtral: {R} row prefills in {prefill_s:.2f} s; ws_attention "
        f"{per_step[0]['ws_attention']} launches a step (want {L}) at head dim {cfg.hd}; a "
        f"captured step's device time {out['jit_ws']['replay_device_ms']:.3f} ms")
    del params32, c0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _fam_whisper(dev):
    """whisper-base at full width and depth: prefill against decode (the
    encoder over 1500 frames, the cross caches), then 2 train() steps."""
    from repro_torch.configs.whisper_base import CONFIG
    from repro_torch.launch.train import train
    from repro_torch.models import decode_hidden, decode_step, prefill
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import _logits

    c = FAMILIES["whisper"]
    cfg = CONFIG
    V, S, extra = cfg.vocab_size, c["S"], c["extra"]
    params, out = _fam_init(cfg, CONFIG, dev)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = torch.randn((1, cfg.enc_seq_len, cfg.d_model), generator=gen, device=dev) * 0.02
    toks = torch.from_numpy(rng.integers(0, V, (1, S + extra))).to(dev)

    def paths(p, cfg_, slip=False):
        pre = prefill(p, cfg_, {"tokens": toks, "frames": frames}, capacity=S + extra)[0]
        _, caches = prefill(p, cfg_, {"tokens": toks[:, :S], "frames": frames},
                            capacity=S + extra)
        if slip:  # the control: each layer attends another layer's encoder k/v
            caches = caches._replace(cross_kv=KVCache(
                *(t.flip(0).contiguous() for t in caches.cross_kv)))
        for i in range(S, S + extra - 1):
            _, caches = decode_step(p, cfg_, caches, toks[:, i:i + 1], i)
        h = decode_hidden(p, cfg_, caches, toks[:, -1:], S + extra - 1)[0]
        return pre[0, :V], h

    t0 = time.perf_counter()
    pre16, h16 = paths(params, cfg)
    torch.cuda.synchronize()
    paths_s = time.perf_counter() - t0
    dec16 = _logits(params, cfg, h16)[0, :V]
    ctl16 = _logits(params, cfg, paths(params, cfg, slip=True)[1])[0, :V]
    cfg32 = cfg.replace(dtype="float32")
    params32 = _widen(params)
    del params
    pre32, h32 = paths(params32, cfg32)
    out["prefill_vs_decode"] = dict(S=S, extra=extra, enc_seq_len=cfg.enc_seq_len,
                                    both_paths_s=paths_s, **_fam_held(
                                        "whisper-base", params32, cfg32, pre32, h32, pre16,
                                        dec16, ctl16, "the layers' cross caches reversed"))
    del params32
    gc.collect()
    torch.cuda.empty_cache()

    step_s = []
    torch.cuda.reset_peak_memory_stats()
    _, losses = train("whisper-base", smoke=False, steps=c["train_steps"],
                      rows=c["train_rows"], seq=c["train_seq"], seed=SEED, device=dev,
                      on_step=lambda step, st, m, s: step_s.append(s), log_every=1)
    if len(losses) != c["train_steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"[families] whisper train losses {losses}")
    out["train"] = dict(losses=losses, step_s=step_s, rows=c["train_rows"],
                        seq=c["train_seq"], peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[families] whisper-base train(): losses {losses}, step seconds "
        f"{[round(s, 3) for s in step_s]}, peak device memory "
        f"{out['train']['peak_bytes'] / 1e9:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _since(before):
    """The ws kernels' launches since the counts ``before``."""
    from repro_torch.pallas_ws import launches

    return {n: launches[n] - before[n] for n in launches}


def phase_families(dev):
    """deepseek-v2 served (MLA), pixtral-12b (vlm) and whisper-base (encdec),
    each freed before the next; the ws kernels' launches of each, counted
    from 0 just before it."""
    from repro_torch.pallas_ws import launches, reset_launches

    t_phase = time.perf_counter()
    out, by_model = {}, {}
    for name, fn in (("deepseek-v2-236b (depth 2, served)", _fam_deepseek),
                     ("pixtral-12b", _fam_pixtral), ("whisper-base", _fam_whisper)):
        reset_launches()
        t0 = time.perf_counter()
        out[name] = fn(dev)
        out[name]["seconds"] = time.perf_counter() - t0
        by_model[name] = dict(launches)
    out["launches"] = by_model
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[families] phase {out['seconds']:.1f} s ("
        + ", ".join(f"{n.split()[0]} {out[n]['seconds']:.1f} s" for n in by_model)
        + f"); launches by model {json.dumps(by_model)}; card: {card_line()}")
    return out


# ---------------------------------------------------------------------------
# the banded flash path, and the dense windowed and tied configs at full width


WINDOWED = dict(
    attn=(dict(at="gemma3-12b local layer", B=1, S=8192, H=16, Hkv=8, hd=256, window=1024),
          dict(at="h2o-danube-1.8b layer", B=1, S=8192, H=32, Hkv=8, hd=80, window=4096)),
    chunk=1024,
    timed=3,
    gemma_serve=dict(slots=4, cap=3072, prompt_lens=(1536, 2048, 2560, 3000), max_new=16,
                     S=2048, extra=16),
    danube_train=dict(rows=1, seq=8192, steps=3),
    gemma_train=dict(depth=6, rows=1, seq=4096, steps=2),
    minicpm_serve=dict(slots=4, cap=256, requests=4, prompt_lens=(16, 129), max_new=8),
)
# Banded against masked attention on the same inputs.  fp32: within
# WIN_FP32_TOL x max(1, max |masked|) (the same fp32 sums, dk and dv summed
# over the query chunks in another order), and the masked result rounded to
# bf16 and moved one bf16 ulp (the bf16 control) must miss that limit, so
# the check tells fp32 agreement from a bf16 one.  bf16: within WIN_BF16_ULPS
# x nb bf16 ulps of max |masked|, nb the band's width in key chunks (each key
# chunk's dk and dv are the sum of up to nb query chunks' gradients, each
# rounded to bf16 and summed in bf16, where the masked path rounds its fp32
# sum once: about half an ulp a part and a sum).
WIN_FP32_TOL = 1e-5
WIN_BF16_ULPS = 1.0


def _all_launches():
    """Every kernel's launch count: the ws kernels (PERF.md §6 rows 1-5;
    ws_attention is rows 1-2) and the standalone three (rows 6-8)."""
    from repro_torch.kernels import launches as klaunches
    from repro_torch.pallas_ws import launches

    return {**launches, **klaunches}


def _launches_since(before):
    return {n: v - before[n] for n, v in _all_launches().items()}


def _bf16_ulp(x):
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(float(x), 1e-30))) - 7)


def _win_attention(dev, c):
    """The banded path (flash_ref) against the masked one (_Flash.apply with
    qoff 0) on the same seeded inputs: forward and forward + backward ms in
    bf16, peak memory, and the output and gradient differences (see
    WIN_FP32_TOL)."""
    from repro_torch.models import attention as A

    B, S, H, Hkv, hd, w = (c[k] for k in ("B", "S", "H", "Hkv", "hd", "window"))
    chunk = WINDOWED["chunk"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, do = (torch.randn((B, S, H, hd), generator=gen, device=dev) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device=dev) for _ in range(2))
    bc = A._pick_chunk(S, min(chunk, max(w, 16)))
    nq = S // bc
    nb = min(-(-w // bc) + 1, nq)
    pairs = dict(banded=nq * nb, masked=(S // A._pick_chunk(S, chunk)) ** 2)

    def run(path, dtype, grad=True):
        # fresh leaves each call: .to() of an fp32 tensor to fp32 is the tensor
        # itself, whose .grad would gather every call's gradients
        qs, ks, vs = (t.detach().to(dtype, copy=True).requires_grad_(grad) for t in (q, k, v))
        ke, ve = A.expand_kv(ks, H // Hkv), A.expand_kv(vs, H // Hkv)
        if path == "banded":
            out = A.flash_ref(qs, ke, ve, causal=True, window=w, chunk=chunk)
        else:
            out = A._Flash.apply(qs, ke, ve, w, 0, True, chunk)
        if not grad:
            return out
        out.backward(do.to(dtype))
        return [out.detach(), qs.grad, ks.grad, vs.grad]

    res = dict(at=c["at"], shape=dict(B=B, S=S, H=H, Hkv=Hkv, hd=hd, window=w), chunk=bc,
               nb=nb, block_pairs=pairs)
    bf16 = torch.bfloat16
    for path in ("banded", "masked"):
        with torch.no_grad():
            fwd = _median_ms(lambda: run(path, bf16, grad=False), n=WINDOWED["timed"], warm=1)
        both = _median_ms(lambda: run(path, bf16), n=WINDOWED["timed"], warm=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run(path, bf16)
        torch.cuda.synchronize()
        res[path] = dict(fwd_ms=fwd, fwd_bwd_ms=both,
                         peak_bytes=torch.cuda.max_memory_allocated())
    names = ("out", "dq", "dk", "dv")
    got16, want16 = run("banded", bf16), run("masked", bf16)
    got32, want32 = run("banded", torch.float32), run("masked", torch.float32)
    errs = {}
    for name, g16, w16, g32, w32 in zip(names, got16, want16, got32, want32):
        scale16 = float(w16.float().abs().max())
        lim16 = WIN_BF16_ULPS * nb * _bf16_ulp(scale16)
        scale32 = max(1.0, float(w32.abs().max()))
        lim32 = WIN_FP32_TOL * scale32
        ctl = one_ulp(w32.bfloat16(), SEED).float()
        e = dict(bf16=float((g16.float() - w16.float()).abs().max()), bf16_limit=lim16,
                 bf16_bit_equal=bool(torch.equal(g16, w16)),
                 fp32=float((g32 - w32).abs().max()), fp32_limit=lim32,
                 fp32_one_ulp_control=float((ctl - w32).abs().max()))
        errs[name] = e
        if not (e["bf16"] <= lim16 and e["fp32"] <= lim32 < e["fp32_one_ulp_control"]):
            raise AssertionError(f"[windowed] {c['at']}: banded {name} differs from masked: {e}")
    res["errors"] = errs
    del got16, want16, got32, want32
    log(f"[windowed] {c['at']} (B {B}, S {S}, H {H} over {Hkv}, hd {hd}, window {w}): chunk "
        f"{bc}, nb {nb}, block pairs banded {pairs['banded']} / masked {pairs['masked']}; "
        f"bf16 forward {res['banded']['fwd_ms']:.2f} / {res['masked']['fwd_ms']:.2f} ms, "
        f"forward + backward {res['banded']['fwd_bwd_ms']:.2f} / "
        f"{res['masked']['fwd_bwd_ms']:.2f} ms (banded / masked), peak "
        f"{res['banded']['peak_bytes'] / 1e9:.2f} / {res['masked']['peak_bytes'] / 1e9:.2f} GB; "
        + "; ".join(f"{n}: bf16 {e['bf16']:.3g} (<= {e['bf16_limit']:.3g}, bit-equal "
                    f"{e['bf16_bit_equal']}), fp32 {e['fp32']:.3g} (<= {e['fp32_limit']:.3g}; "
                    f"one-ulp control {e['fp32_one_ulp_control']:.3g})" for n, e in errs.items()))
    return res


def _win_gemma_serve(dev):
    """gemma3-12b at full depth served by 2 replicas (prompts past the local
    window: the banded branch in every local layer of every prefill; the
    dense decode step past the window's edge), then one row's decode path
    against a longer prefill (as FAM_FP32_TOL)."""
    from repro_torch.configs.gemma3_12b import CONFIG
    from repro_torch.models import decode_hidden, decode_step, prefill
    from repro_torch.models.model import _logits
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    c = WINDOWED["gemma_serve"]
    cfg = CONFIG
    V = cfg.vocab_size
    params, out = _fam_init(cfg, CONFIG, dev, tag="windowed")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, V, size=n).astype(np.int32) for n in c["prompt_lens"]]
    front = WorkStealingFrontend(lambda: ContinuousBatcher(
        params, cfg, slots=c["slots"], capacity=c["cap"]), n_replicas=2)
    for rid, p in enumerate(prompts):
        front.submit(0, Request(rid=rid, tokens=p, max_new=c["max_new"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _all_launches()
    t0 = time.perf_counter()
    done = front.run(max_iters=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launches_since(before)
    stats = front.stats()
    if sorted(done) != list(range(len(prompts))) or front.rejected:
        raise AssertionError(f"[windowed] gemma completed {sorted(done)}, rejected "
                             f"{sorted(front.rejected)}")
    if any(len(r.out) != c["max_new"] or not all(0 <= t < V for t in r.out)
           for r in done.values()):
        raise AssertionError(f"[windowed] gemma served {_streams(done)}")
    if any(counts.values()) or any(b.use_ws for b in front.batchers):
        raise AssertionError(f"[windowed] gemma serving launched {counts} (the dense step "
                             "launches no kernel of the port)")
    steps = sum(s["steps"] for s in stats["batchers"])
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    tokens = sum(len(r.out) for r in done.values())
    out["serving"] = dict(
        requests=len(done), prompt_tokens=[len(p) for p in prompts], new_tokens=tokens,
        wall_s=wall, tokens_per_s=tokens / wall, decode_steps=steps,
        step_ms_p50=float(np.percentile(lat, 50)), step_ms_p99=float(np.percentile(lat, 99)),
        stolen=stats["totals"]["stolen"], launches=counts,
        peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[windowed] gemma3-12b serving (2 replicas x {c['slots']} slots x {c['cap']} "
        f"positions, prompts {[len(p) for p in prompts]} tokens, window {cfg.window}, the "
        f"dense step): {len(done)} requests, {tokens} new tokens in {wall:.2f} s "
        f"({tokens / wall:.2f} tokens/s incl. prefill); {steps} decode steps, step p50 "
        f"{out['serving']['step_ms_p50']:.2f} ms p99 {out['serving']['step_ms_p99']:.2f} ms; "
        f"stolen {stats['totals']['stolen']}; peak device memory "
        f"{out['serving']['peak_bytes'] / 1e9:.2f} GB")
    del front, done
    gc.collect()
    torch.cuda.empty_cache()

    # one row: prefill of S + extra against prefill of S and extra decode steps
    S, extra = c["S"], c["extra"]
    toks = torch.from_numpy(rng.integers(0, V, (1, S + extra))).to(dev)

    def paths(p, cfg_, control=False):
        pre = None if control else prefill(p, cfg_, {"tokens": toks},
                                           capacity=S + extra)[0][0, :V]
        _, caches = prefill(p, cfg_, {"tokens": toks[:, :S]}, capacity=S + extra)
        dcfg = cfg_.replace(window=0) if control else cfg_  # the control: no window
        for i in range(S, S + extra - 1):
            _, caches = decode_step(p, dcfg, caches, toks[:, i:i + 1], i)
        return pre, decode_hidden(p, dcfg, caches, toks[:, -1:], S + extra - 1)[0]

    pre16, h16 = paths(params, cfg)
    dec16 = _logits(params, cfg, h16)[0, :V]
    ctl16 = _logits(params, cfg, paths(params, cfg, control=True)[1])[0, :V]
    params32 = _widen(params)
    del params
    cfg32 = cfg.replace(dtype="float32")
    pre32, h32 = paths(params32, cfg32)
    out["prefill_vs_decode"] = dict(S=S, extra=extra, **_fam_held(
        "gemma3-12b", params32, cfg32, pre32, h32, pre16, dec16, ctl16,
        "the decode ignoring the local window", tag="windowed"))
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _win_train(arch, dev, c, n_layers=None):
    """``c["steps"]`` train() steps at full width (depth ``n_layers`` if given)
    on rows x seq tokens: finite losses, step seconds, peak memory."""
    from repro_torch.launch.train import train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    _, losses = train(arch, smoke=False, steps=c["steps"], rows=c["rows"], seq=c["seq"],
                      n_layers=n_layers, seed=SEED, device=dev, log_every=1,
                      on_step=lambda step, st, m, s: step_s.append(s))
    torch.cuda.synchronize()
    if len(losses) != c["steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"[windowed] {arch} train losses {losses}")
    out = dict(losses=losses, step_s=step_s, rows=c["rows"], seq=c["seq"], layers=n_layers,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[windowed] {arch} train() at {c['rows']} x {c['seq']} tokens"
        + (f", depth {n_layers}" if n_layers else ", full depth")
        + f": losses {losses}, step seconds {[round(s, 3) for s in step_s]}, peak device "
        f"memory {out['peak_bytes'] / 1e9:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _win_minicpm(dev):
    """minicpm-2b (MHA, tied embeddings, depth-scaled residuals) at full width
    and depth served on decode_step_ws; one step's last attention launch
    (head dim 64) held to the plain version."""
    from repro_torch.configs.minicpm_2b import CONFIG
    from repro_torch.pallas_ws import launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    c = WINDOWED["minicpm_serve"]
    cfg = CONFIG
    L, V = cfg.n_layers, cfg.vocab_size
    params, out = _fam_init(cfg, CONFIG, dev, tag="windowed")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(*c["prompt_lens"], size=c["requests"])
    prompts = [rng.integers(0, V, size=int(n)).astype(np.int32) for n in lens]
    front = WorkStealingFrontend(lambda: ContinuousBatcher(
        params, cfg, slots=c["slots"], capacity=c["cap"]), n_replicas=2)
    for rid, p in enumerate(prompts):
        front.submit(0, Request(rid=rid, tokens=p, max_new=c["max_new"]))
    torch.cuda.synchronize()
    before = _all_launches()
    t0 = time.perf_counter()
    done = front.run(max_iters=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launches_since(before)
    stats = front.stats()
    steps = sum(s["steps"] for s in stats["batchers"])
    if sorted(done) != list(range(len(prompts))) or front.rejected:
        raise AssertionError(f"[windowed] minicpm completed {sorted(done)}")
    if not all(b.use_ws for b in front.batchers):
        raise AssertionError("[windowed] minicpm-2b is not on decode_step_ws")
    want = {n: 0 for n in counts}
    want["ws_attention"] = steps * L
    if counts != want:
        raise AssertionError(f"[windowed] minicpm serving launched {counts}, want {want}")
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    tokens = sum(len(r.out) for r in done.values())
    # one step of 4 slots counted alone, its last attention launch held
    b = ContinuousBatcher(params, cfg, slots=c["slots"], capacity=c["cap"])
    for rid in range(c["slots"]):
        if not b.admit(Request(rid=rid, tokens=prompts[rid % len(prompts)],
                               max_new=c["max_new"])):
            raise AssertionError(f"[windowed] minicpm refused prompt {rid}")
    before, recorded = dict(launches), []
    with attention_launches(recorded.append):
        b.step()
    torch.cuda.synchronize()
    per_step = _since(before)
    if per_step["ws_attention"] != L or len(recorded) != L:
        raise AssertionError(f"[windowed] one minicpm step launched {per_step}, hook saw "
                             f"{len(recorded)} (want {L})")
    out["attention_launch"] = _hold_attention_launch("windowed minicpm", recorded[-1], L)
    del b, recorded, front
    out["serving"] = dict(
        requests=len(done), prompt_tokens=int(lens.sum()), new_tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, decode_steps=steps,
        step_ms_p50=float(np.percentile(lat, 50)), step_ms_p99=float(np.percentile(lat, 99)),
        launches=counts, launches_per_decode_step=per_step)
    log(f"[windowed] minicpm-2b serving (2 replicas x {c['slots']} slots, decode_step_ws, hd "
        f"{cfg.hd}): {len(done)} requests, {tokens} new tokens in {wall:.2f} s; {steps} decode "
        f"steps, step p50 {out['serving']['step_ms_p50']:.2f} ms p99 "
        f"{out['serving']['step_ms_p99']:.2f} ms; ws_attention {per_step['ws_attention']} "
        f"launches a step (want {L})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_windowed(dev):
    """The banded attention against the masked one at gemma3-12b's and
    h2o-danube-1.8b's widths; gemma3-12b served at full depth; h2o-danube
    trained at full depth, gemma3-12b at depth 6; minicpm-2b served on the ws
    step.  Every kernel's launches on each path, counted from 0 just before
    it."""
    t_phase = time.perf_counter()
    out, by_path = {"attention": []}, {}

    def path(name, fn, *a):
        gc.collect()
        torch.cuda.empty_cache()
        before = _all_launches()
        t0 = time.perf_counter()
        res = fn(*a)
        by_path[name] = _launches_since(before)
        res["seconds"] = time.perf_counter() - t0
        return res

    for c in WINDOWED["attn"]:
        out["attention"].append(path(f"attention alone, {c['at']}", _win_attention, dev, c))
    out["gemma3-12b served"] = path("gemma3-12b served", _win_gemma_serve, dev)
    out["h2o-danube-1.8b trained"] = path("h2o-danube-1.8b trained", _win_train,
                                          "h2o-danube-1.8b", dev, WINDOWED["danube_train"])
    g = WINDOWED["gemma_train"]
    out["gemma3-12b trained"] = path("gemma3-12b trained (depth 6)", _win_train, "gemma3-12b",
                                     dev, g, g["depth"])
    out["minicpm-2b served"] = path("minicpm-2b served", _win_minicpm, dev)
    out["launches"] = by_path
    out["seconds"] = time.perf_counter() - t_phase
    for name, n in by_path.items():
        log(f"[windowed] launches on {name}: {json.dumps(n)}")
    log(f"[windowed] phase {out['seconds']:.1f} s; card: {card_line()}")
    return out


# ---------------------------------------------------------------------------
# the paper's shared-memory algorithms (repro_torch.core) and the host shims


CORE = dict(puts=4096, thieves=7, sim_seeds=(0, 1, 2), sim_steps=400,
            layout=dict(B=4, H=24, S=1024, bk=64, P=8, lengths=(1024, 658, 531, 288)))


def _core_drain(name, n, n_thieves, seed):
    """One owner and ``n_thieves`` thieves on real threads (ThreadBackend):
    the owner puts 0..n-1, takes after a put where a seeded draw says so
    (a third of them), then takes to empty; a thief steals until the owner
    is done and it has missed 3 times.  Returns each process's extractions."""
    import threading

    from repro_torch.core import ALGORITHMS, EMPTY

    kw = {"capacity": n + 8} if name in ("pallas-ws", "moe-ws") else {}
    q = ALGORITHMS[name](**kw)
    take_after = np.random.default_rng(seed).random(n) < 1 / 3
    got = {pid: [] for pid in range(n_thieves + 1)}
    stop = threading.Event()

    def owner():
        for i in range(n):
            if not q.put(i):
                raise AssertionError(f"[core] {name}: put {i} refused")
            if take_after[i] and (x := q.take()) is not EMPTY:
                got[0].append(x)
        while (x := q.take()) is not EMPTY:
            got[0].append(x)
        stop.set()

    def thief(pid):
        misses = 0
        while not (stop.is_set() and misses >= 3):
            x = q.steal(pid)
            if x is EMPTY:
                misses += 1
            else:
                got[pid].append(x)
                misses = 0

    threads = [threading.Thread(target=owner)] + [
        threading.Thread(target=thief, args=(p,)) for p in range(1, n_thieves + 1)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # preempt often: real interleavings
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"[core] {name}: a thread did not finish")
    return got


def _core_threads():
    """Every ALGORITHMS entry drains CORE["puts"] tasks with 1 owner and
    CORE["thieves"] thieves; each family's contract holds."""
    from repro_torch.core import ALGORITHMS, EXACT_FAMILY, MULTIPLICITY_FAMILY

    n, res = CORE["puts"], {}
    for name in sorted(ALGORITHMS):
        t0 = time.perf_counter()
        got = _core_drain(name, n, CORE["thieves"], SEED)
        every = [x for xs in got.values() for x in xs]
        lost = n - len(set(every))
        twice = [pid for pid, xs in got.items() if len(xs) != len(set(xs))]
        fam = ("multiplicity" if name in MULTIPLICITY_FAMILY else
               "exact" if name in EXACT_FAMILY else "idempotent")
        ok = (lost == 0 and set(every) <= set(range(n))
              and not (fam == "multiplicity" and twice)
              and not (fam == "exact" and len(every) != n))
        res[name] = dict(family=fam, extractions_per_task=len(every) / n, lost=lost,
                         processes_twice=twice, by_process=[len(xs) for xs in got.values()],
                         seconds=time.perf_counter() - t0)
        if not ok:
            raise AssertionError(f"[core] {name} broke the {fam} family's contract: "
                                 f"{res[name]}")
    log(f"[core] real threads (1 owner + {CORE['thieves']} thieves, {n} puts): "
        "sum(extractions)/tasks "
        + ", ".join(f"{k} {v['extractions_per_task']:.4f}" for k, v in res.items()))
    return res


def _core_program(name):
    """The simulated program of ``name`` (as tests/test_torch_core.py's):
    THE Cilk's Steal holds its lock across steps, and a step granted to a
    second locker would stall the controller, so it gets one thief and an
    owner that only puts."""
    if name == "the-cilk":
        return {0: [("put", i) for i in range(1, 9)], 1: [("steal", None)] * 6}
    prog = {0: [("put", i) for i in range(1, 9)] + [("take", None)] * 5}
    for t in (1, 2, 3):
        prog[t] = [("steal", None)] * 5
    return prog


def _core_sim():
    """Seeded SimBackend schedules through run_program, with the checkers
    the reference's property tests apply to each family, and the §7 drills
    (the idempotent FIFO re-extracts one task many times by one thief; the
    same adversary gets WS-WMULT one extraction a task a process)."""
    from repro_torch.core import ALGORITHMS, EMPTY, EXACT_FAMILY, MULTIPLICITY_FAMILY
    from repro_torch.core import IdempotentFIFO, WSWMult
    from repro_torch.core import simulator as S

    res, checks = {}, 0
    for name in sorted(ALGORITHMS):
        kw = {}
        if name in ("ws-mult", "b-ws-mult"):
            kw = dict(max_register="tree", capacity=64)
        elif name in ("pallas-ws", "moe-ws"):
            kw = dict(capacity=64)
        prog = _core_program(name)
        n_ext = []
        for seed in CORE["sim_seeds"]:
            schedule = np.random.default_rng(seed).integers(
                0, len(prog), CORE["sim_steps"]).tolist()
            rec = S.run_program(lambda b: ALGORITHMS[name](backend=b, **kw), prog, schedule)
            ext = S.extractions(rec)
            n_ext.append(len(ext))
            if name in MULTIPLICITY_FAMILY:
                S.check_no_process_duplicates(rec)
                S.check_no_lost_tasks_fifo(rec)
                S.check_owner_fifo(rec)
                checks += 3
                if name in ("ws-mult", "b-ws-mult"):
                    S.check_pairwise_concurrent_duplicates(rec)
                    checks += 1
            if name == "b-ws-wmult":
                for task in {r.result for r in ext}:
                    kinds = [r.kind for r in ext if r.result == task]
                    if kinds.count("steal") > 1 or kinds.count("take") > 1:
                        raise AssertionError(f"[core] b-ws-wmult extracted {task} by {kinds}")
                checks += 1
            if name in EXACT_FAMILY:
                got = [r.result for r in ext]
                if len(got) != len(set(got)):
                    raise AssertionError(f"[core] {name} duplicated: {sorted(got)}")
                checks += 1
        res[name] = dict(extractions=n_ext)
    # §7: a stalled owner's stale head write
    z = 6
    fifo, ws = IdempotentFIFO(), WSWMult()
    for i in range(1, z + 1):
        fifo.put(i)
        ws.put(i)
    stolen = {"idempotent-fifo": [], "ws-wmult": []}
    for r in range(z, 0, -1):
        h = fifo.head.read(0)
        stolen["idempotent-fifo"] += [x for x in (fifo.steal(1) for _ in range(r))
                                      if x is not EMPTY]
        fifo.head.write(h + 1, 0)
        head = max(ws._local_head(0), ws.Head.read(0))
        if head <= ws.tail:
            stolen["ws-wmult"] += [x for x in (ws.steal(1) for _ in range(r)) if x is not EMPTY]
            ws.Head.write(head + 1, 0)
            ws._head[0] = head + 1
    most = {k: max(v.count(x) for x in set(v)) for k, v in stolen.items()}
    if not (most["idempotent-fifo"] >= z - 1 and most["ws-wmult"] == 1):
        raise AssertionError(f"[core] the §7 drill: one thief's most extractions of a task {most}")
    log(f"[core] simulated schedules: {len(CORE['sim_seeds'])} seeds x {len(res)} algorithms, "
        f"{checks} property checks passed; the §7 drill: one thief re-extracted a task "
        f"{most['idempotent-fifo']} times from the idempotent FIFO, {most['ws-wmult']} from "
        "WS-WMULT")
    return dict(algorithms=res, property_checks=checks, section7_most_by_one_thief=most)


def core_layout(dev):
    """For each program's queue of the llama3.2-3b decode Put (the device Put
    of decode_queue_state at the serving shape), a PallasWSHost given the
    queue's records by put_segment holds the device state's task slots,
    tail, two trailing ⊥ slots, head, remaining and (empty) announcements;
    its host drain extracts every record in order."""
    from repro_torch.core import BOTTOM as HOST_BOTTOM
    from repro_torch.core import EMPTY
    from repro_torch.pallas_ws import PallasWSHost, decode_queue_state
    from repro_torch.pallas_ws.tasks import BOTTOM

    c = CORE["layout"]
    lengths = torch.tensor(c["lengths"], dtype=torch.int64, device=dev)
    st = decode_queue_state(lengths, c["H"], c["S"], n_programs=c["P"], bk=c["bk"])
    tasks, tail, head, rem, taken = (t.cpu().numpy() for t in (
        st.tasks, st.tail, st.head, st.remaining, st.taken))
    n_q, cap, width = tasks.shape
    per_queue = []
    for qi in range(n_q):
        n = int(tail[qi])
        recs = [tuple(int(x) for x in r) for r in tasks[qi, :n]]
        host = PallasWSHost(capacity=cap)
        if not host.put_segment(recs):
            raise AssertionError(f"[core] queue {qi}: put_segment refused {n} records")
        slots = np.array([np.full(width, BOTTOM) if x is HOST_BOTTOM else np.asarray(x)
                          for x in host.tasks.a])
        h_head, h_tail, h_taken = host.snapshot()
        same = dict(
            tasks=bool(np.array_equal(slots, tasks[qi])), tail=h_tail == n,
            trailing_bottom=all(host.tasks.read(s) is HOST_BOTTOM for s in (n, n + 1)),
            head=h_head == int(head[qi]), remaining=host.remaining_estimate() == int(rem[qi]),
            taken=h_taken == {} and bool((taken[qi] == -1).all()))
        drained = []
        while (x := host.take()) is not EMPTY:
            drained.append(x)
        same["drain"] = drained == recs
        per_queue.append(dict(tail=n, remaining=int(rem[qi]), equal=same))
        if not all(same.values()):
            raise AssertionError(f"[core] queue {qi}: the host layout differs from the device "
                                 f"Put's: {same}")
    out = dict(shape=dict(c, capacity=cap, n_queues=n_q), queues=per_queue,
               shared_fields=["tasks", "head", "tail", "remaining", "taken"],
               host_only=["local bounds by process (device: local_head [P, Q])",
                          "faults_injected", "trace events"],
               device_only=["local_head", "n_tasks_hint", "task_list", "pool_off"])
    log(f"[core] layout: the llama3.2-3b decode Put on {dev.type} ({n_q} queues, capacity "
        f"{cap}, tails {[q['tail'] for q in per_queue]}): every queue's PallasWSHost equals "
        "the device state in tasks, head, tail, the two trailing ⊥ slots, remaining and "
        "taken, and drains every record")
    return out


def phase_core(dev):
    """repro_torch.core on real threads and under the simulator, and the host
    shim against the device Put's layout."""
    t0 = time.perf_counter()
    out = dict(threads=_core_threads(), sim=_core_sim(), layout=core_layout(dev))
    out["seconds"] = time.perf_counter() - t0
    log(f"[core] phase {out['seconds']:.1f} s")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases (all by default)")
    ap.add_argument("--audit-baseline", metavar="DIR",
                    help="only build the kernels of the checkout in DIR and print every "
                         "kernel function's registers and SASS instructions")
    ap.add_argument("--probe", action="store_true",
                    help="only build and run csrc/probes/tagged_handoff.cu")
    ap.add_argument("--ssd-ab", metavar="DIR", nargs="+",
                    help="only time ssd_scan at mamba2-2.7b's widths as built from each "
                         "checkout DIR and from this one, alternating, in one process")
    ap.add_argument("--expert-ab", metavar="DIR", nargs="+",
                    help="only time ws_expert at kimi-k2's decode routing as built from each "
                         "checkout DIR and from this one, alternating, in one process")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if args.audit_baseline:
        audit_baseline(args.audit_baseline)
        return 3
    if args.expert_ab:
        expert_ab(args.expert_ab, dev)
        return 3
    if args.ssd_ab:
        ssd_ab(args.ssd_ab, dev)
        return 3
    if args.probe:
        log("[probe] " + json.dumps(tagged_handoff_probe(dev)))
        log("[probe] card: " + card_line())
        return 3
    from repro_torch.kernels import launches as klaunches

    t_all = time.perf_counter()
    seconds = {}  # each phase's wall time, for the [done] line

    def timed(phase, fn, *a, **kw):
        if phase not in phases | {"build"}:
            return None
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", phase_build)
    max_err = timed("parity", phase_parity, dev)
    expert = timed("expert", phase_expert, dev) or {}
    timed("audit", phase_audit, dev)
    timed("chaos", phase_chaos, dev)
    halfrun_err = timed("halfrun", phase_halfrun, dev)
    HELD.clear()
    gc.collect()
    torch.cuda.empty_cache()
    standalone = timed("kernels", phase_kernels, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the standalone kernels' launches on each model path (none wires them in)
    on_path = {}

    def model_path(phase, fn, *a, **kw):
        if phase not in phases:
            return None
        before = dict(klaunches)
        out = timed(phase, fn, *a, **kw)
        on_path[phase] = {n: klaunches[n] - before[n] for n in klaunches}
        return out

    serving, n_launches = model_path("serving", phase_serving, dev) or (None, None)
    times = model_path("times", phase_times, dev) or {}
    moe = model_path("moe", phase_moe, dev)
    grad = model_path("grad", phase_grad, dev, halfrun="halfrun" in phases)
    training = model_path("train", phase_train, dev)
    sched = model_path("sched", phase_sched, dev)
    unified, userving = model_path("unified", phase_unified, dev) or (None, None)
    umoe, umserving = model_path("unified_moe", phase_unified_moe, dev) or (None, None)
    ckpt = model_path("ckpt", phase_ckpt, dev)
    ssm, ssm_inputs = model_path("ssm", phase_ssm, dev) or (None, None)
    # ssd_scan on the ssm phase's own scan inputs: a comparison launch, not
    # the model path's (the Mamba-2 layer runs ssd_chunked, as the reference's)
    ssm_scan = _ssm_scan(ssm_inputs) if ssm_inputs else None
    del ssm_inputs
    families = model_path("families", phase_families, dev)
    windowed = model_path("windowed", phase_windowed, dev)
    core = model_path("core", phase_core, dev)
    stray = {p: n for p, n in on_path.items() if any(n.values())}
    if stray:
        raise AssertionError(f"a model path launched a standalone kernel: {stray}")
    if phases != set(PHASES):
        if standalone:
            log("[kernels] " + json.dumps(standalone))
        log(f"[done] phases {sorted(phases)} passed in {time.perf_counter() - t_all:.1f} s "
            f"({json.dumps(seconds)}); a partial run prints no result")
        return 3
    attention = {
        "name": "ws_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ws_attention.cu",
        "replaces": "src/repro/pallas_ws/kernel.py:334",
        "redesigned": "ws_attention" in REDESIGNED,
        "launches": n_launches,
        "launches_by_path": {"llama3.2-3b": n_launches,
                             moe["model"]: moe["ws_attention_launches"],
                             training["model"]: training["launches"]["ws_attention"],
                             sched["model"]: sched["launches"]["ws_attention"],
                             userving["model"]: userving["launches"]["ws_attention"],
                             umserving["model"]: umserving["launches"]["ws_attention"],
                             **{m: n["ws_attention"] for m, n in families["launches"].items()},
                             **{m: n["ws_attention"] for m, n in windowed["launches"].items()}},
        "launches_per_train_step": training["launches_per_step"]["ws_attention"],
        "launches_per_decode_step_pixtral": families["pixtral-12b"]["launches_per_step"][
            "ws_attention"],
        "launches_per_decode_step_minicpm": windowed["minicpm-2b served"]["serving"][
            "launches_per_decode_step"]["ws_attention"],
        "max_abs_err": max(max_err, expert["attn_err"], halfrun_err["ws_attention"],
                           families["pixtral-12b"]["attention_launch"]["max_abs_err"],
                           windowed["minicpm-2b served"]["attention_launch"]["max_abs_err"]),
        **times,
        **TRACED["ws_attention"],
        "chaos": CHAOS["ws_attention"],
        "halfrun": HALFRUN["ws_attention"],
        "ragged_prefill": HALFRUN["ragged_prefill"],
    }
    expert_line = {
        "name": "ws_expert",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ws_expert.cu",
        "replaces": "src/repro/moe_ws/expert_kernel.py:47",
        "redesigned": "ws_expert" in REDESIGNED,
        "launches": moe["ws_expert_launches"],
        "launches_by_path": {"llama3.2-3b": serving["ws_expert_launches"],
                             moe["model"]: moe["ws_expert_launches"],
                             training["model"]: training["launches"]["ws_expert"],
                             sched["model"]: sched["launches"]["ws_expert"],
                             userving["model"]: userving["launches"]["ws_expert"],
                             umserving["model"]: umserving["launches"]["ws_expert"],
                             **{m: n["ws_expert"] for m, n in families["launches"].items()},
                             **{m: n["ws_expert"] for m, n in windowed["launches"].items()}},
        "launches_per_decode_step": moe["ws_expert_launches_per_decode_step"],
        "launches_per_decode_step_deepseek_served": families[
            "deepseek-v2-236b (depth 2, served)"]["serving"]["launches_per_decode_step"][
            "ws_expert"],
        "launches_per_train_step": training["launches_per_step"]["ws_expert"],
        "launches_per_ws_round": sched["launches_per_round"]["ws_expert"],
        "max_abs_err": max(expert["max_abs_err"], halfrun_err["ws_expert"],
                           families["deepseek-v2-236b (depth 2, served)"]["expert_launches"][
                               "max_abs_err"]),
        **{k: v for k, v in expert.items() if k not in ("max_abs_err", "attn_err")},
        **TRACED["ws_expert"],
        "chaos": CHAOS["ws_expert"],
        "halfrun": HALFRUN["ws_expert"],
    }
    grad_line = {
        "name": "ws_expert_grad",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ws_expert_grad.cu",
        "replaces": "src/repro/moe_ws/expert_kernel.py:87",
        "redesigned": "ws_expert_grad" in REDESIGNED,
        "launches": training["launches"]["ws_expert_grad"],
        "launches_by_path": {"llama3.2-3b": serving["ws_expert_grad_launches"],
                             moe["model"]: moe["ws_expert_grad_launches"],
                             training["model"]: training["launches"]["ws_expert_grad"],
                             sched["model"]: sched["launches"]["ws_expert_grad"],
                             userving["model"]: userving["launches"]["ws_expert_grad"],
                             umserving["model"]: umserving["launches"]["ws_expert_grad"],
                             **{m: n["ws_expert_grad"] for m, n in families["launches"].items()},
                             **{m: n["ws_expert_grad"] for m, n in windowed["launches"].items()}},
        "launches_per_decode_step": moe["ws_expert_grad_launches_per_decode_step"],
        "launches_per_train_step": training["launches_per_step"]["ws_expert_grad"],
        "launches_per_ws_round": sched["launches_per_round"]["ws_expert_grad"],
        "max_abs_err": max(grad["max_abs_err"], training["launch_abs_err"],
                           grad["halfrun_max_abs_err"]),
        "max_group_rel_err": max(grad["max_group_rel_err"], training["launch_rel_err"]),
        **training["grad_times"],
        **TRACED["ws_expert_grad"],
        "chaos": CHAOS["ws_expert_grad"],
        "halfrun": HALFRUN["ws_expert_grad"],
    }
    unified_line = {
        "name": "ws_unified",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ws_unified.cu",
        "replaces": "src/repro/models/unified.py:415",
        "redesigned": "ws_unified" in REDESIGNED,
        "tagged_handoff_probe": {k: v for k, v in HANDOFF.items()
                                 if k != "forbidden_sass_by_function"},
        "launches": userving["launches"]["ws_unified"],
        "launches_by_path": {"llama3.2-3b": serving["ws_unified_launches"],
                             moe["model"]: moe["ws_unified_launches"],
                             training["model"]: training["launches"]["ws_unified"],
                             sched["model"]: sched["launches"]["ws_unified"],
                             userving["model"]: userving["launches"]["ws_unified"],
                             umserving["model"]: umserving["launches"]["ws_unified"],
                             **{m: n["ws_unified"] for m, n in families["launches"].items()},
                             **{m: n["ws_unified"] for m, n in windowed["launches"].items()}},
        "launches_per_step": {"lockstep": 1, "free": unified["free_launches_per_step"],
                              "free_moe": umoe["free_launches_per_step"]},
        **unified,
        "max_abs_err": max(unified["max_abs_err"], umoe["max_abs_err"]),
        "moe_half": {"model": umserving["model"], "library_ms": None, **umoe},
        "free_ms_traced_untraced": TRACED["ws_unified"],
        "chaos": CHAOS["ws_unified"],
    }
    paths = {"serving": "llama3.2-3b", "moe": moe["model"], "train": training["model"],
             "sched": sched["model"],
             "unified": userving["model"], "unified_moe": umserving["model"],
             "ckpt": ckpt["model"], "ssm": "mamba2-2.7b, zamba2-2.7b (ssm phase)",
             "families": "deepseek-v2-236b, pixtral-12b, whisper-base (families phase)",
             "windowed": "gemma3-12b, h2o-danube-1.8b, minicpm-2b (windowed phase)",
             "core": "core phase",
             "times": "times phase", "grad": "grad phase"}
    standalone_lines = [
        {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
         "replaces": replaces,
         "launches": standalone[name]["launches"],
         "launches_by_path": {**{paths[p]: on_path[p][name] for p in paths},
                              "kernels phase": standalone[name]["launches"],
                              **({"ssm phase, mamba2 layer 0's scan inputs":
                                  ssm_scan["launches"]} if name == "ssd_scan" else {})},
         **{k: v for k, v in standalone[name].items() if k != "launches"},
         **({"redesigned": True} if name in REDESIGNED else {}),
         **({"model_inputs": ssm_scan} if name == "ssd_scan" else {}),
         "card": card_line()}
        for name, replaces in (("flash_fwd", "src/repro/kernels/flash_attention/kernel.py:32"),
                               ("decode_attention",
                                "src/repro/kernels/decode_attention/kernel.py:28"),
                               ("ssd_scan", "src/repro/kernels/ssd_scan/kernel.py:27"))]
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s ({json.dumps(seconds)})")
    log("[serving] " + json.dumps(serving))
    log("[moe] " + json.dumps(moe))
    log("[grad] " + json.dumps(grad))
    log("[train] " + json.dumps({k: v for k, v in training.items() if k != "grad_times"}))
    log("[sched] " + json.dumps(sched))
    log("[unified] " + json.dumps(userving))
    log("[unified_moe] " + json.dumps(umserving))
    log("[ckpt] " + json.dumps(ckpt))
    log("[ssm] " + json.dumps(ssm))
    log("[families] " + json.dumps(families))
    log("[windowed] " + json.dumps(windowed))
    log("[core] " + json.dumps(core))
    print(card_line())
    print(json.dumps({"kernels": [attention, expert_line, grad_line, unified_line,
                                  *standalone_lines]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
